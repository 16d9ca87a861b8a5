"""Dry run of the optional GPipe pipeline over the "pod" axis (the
reference's ``repro/launch/dryrun_pipeline.py``): trace a 2-stage
pipelined train loss and its gradient for granite-20b on the (2,16,16)
production mesh, on rank 0 of a fake process group at world size 512
with fake tensors (``launch/dryrun``), and count the activation
hand-offs between the stages (``training/pipeline``'s ``ppermute``, an
``all_to_all_single_autograd``): one a schedule step in the forward, and
one in the backward for each but the last, whose hand-off no stage
reads.

    PYTHONPATH=src python -m repro_torch.launch.dryrun_pipeline
"""
from __future__ import annotations

import contextlib
import time

import torch
from torch._subclasses.fake_tensor import FakeTensorMode

from repro_torch.configs import get_config
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.launch.dryrun import fake_group, tensor_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.traceanalysis import analyze_trace
from repro_torch.models import RunFlags, build_param_specs
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import (ParamSpec, tree_leaves,
                                       tree_map_specs, tree_unflatten)
from repro_torch.training.pipeline import make_pipelined_train_loss

B, S, M = 64, 1024, 4          # global batch, sequence, microbatches


def staged_specs(cfg: ArchConfig, n_stages: int):
    """The parameter specs with the single group's stack cut into
    ``n_stages`` stages ([stages, L / stages, ...], ``split_stage_params``'
    layout)."""
    specs = build_param_specs(cfg)
    gname = cfg.groups[0].name
    L = cfg.groups[0].repeats

    def stage_spec(s: ParamSpec) -> ParamSpec:
        return ParamSpec((n_stages, L // n_stages) + s.shape[1:], s.dtype,
                         ("stage",) + s.axes, s.init)
    specs["groups"] = {gname: {"pos0": tree_map_specs(
        stage_spec, specs["groups"][gname]["pos0"])}}
    return specs


def trace_pipeline(cfg: ArchConfig, mesh: Mesh, *, batch: int, seq: int,
                   micro: int, device: str = "cuda",
                   flags: RunFlags = RunFlags(remat="full")) -> dict:
    """Trace the pipelined loss and its gradient once on rank 0 of
    ``mesh`` (over the caller's process group): every rank holds the
    staged parameters and the batch whole, as the pipeline takes them.
    Returns the report's dict, the trace's detail, the hand-offs the
    schedule implies (``expected_handoffs``) and ``trace_s``."""
    dev = tensor_device(device)
    card = device == "cuda"
    n_stages = mesh.shape["pod"]
    specs = staged_specs(cfg, n_stages)
    loss_fn = make_pipelined_train_loss(cfg, mesh, n_microbatches=micro,
                                        flags=flags)

    def step(params, tokens, labels):
        leaves = [t.requires_grad_() for t in tree_leaves(params)]
        loss = loss_fn(tree_unflatten(params, leaves),
                       {"tokens": tokens, "labels": labels})
        return loss.detach(), torch.autograd.grad(loss, leaves)

    t0 = time.time()
    with FakeTensorMode(), (ops.card_trace() if card and dev == "cpu"
                            else contextlib.nullcontext()):
        params = tree_map_specs(lambda s: torch.empty(
            s.shape, dtype=s.dtype, device=dev), specs)
        tokens, labels = (torch.zeros((batch, seq), dtype=torch.int32,
                                      device=dev) for _ in range(2))
        train = cfg.model_flops_per_token(train=True) * batch * seq
        rep, detail = analyze_trace(
            step, (params, tokens, labels), arch=cfg.name,
            shape=f"pipeline_{batch}x{seq}_m{micro}", mesh_name="multi",
            n_devices=mesh.size, model_flops_global=train, card=card)
    out = rep.to_dict()
    # one hand-off a schedule step in the forward; the transpose of each
    # but the last step's (which no stage reads) in the backward
    steps = micro + n_stages - 1
    out.update(detail, trace_s=time.time() - t0,
               expected_handoffs=2 * steps - 1)
    return out


def main() -> int:
    cfg = get_config("granite-20b")                   # 52L dense: 2x26
    with fake_group(512):
        mesh = make_production_mesh(multi_pod=True,
                                    device_type=tensor_device("cuda"))
        out = trace_pipeline(cfg, mesh, batch=B, seq=S, micro=M)
    handoffs = out["collective_counts"]["all-to-all"]
    print(f"[dryrun-pipeline] granite-20b 2-stage GPipe (M={M}) on "
          f"(2,16,16): traced in {out['trace_s']:.0f}s")
    print(f"  peak {out['peak_device_bytes'] / 2**30:.2f} GiB/dev "
          f"(arguments {out['argument_bytes']:,} B, temp "
          f"{out['temp_bytes']:,}); flops/dev "
          f"{out['flops_per_device']:.3e}, kernels "
          f"{out['kernel_launches']} {out['kernel_routes']}")
    print(f"  collectives: {out['collective_counts']} "
          f"bytes={out['collective_detail']}")
    print(f"  all-to-all hand-offs: {handoffs} (the schedule's "
          f"{out['expected_handoffs']}: the cross-pod activation hand-offs)")
    if not 0 < handoffs == out["expected_handoffs"]:
        raise RuntimeError(f"the pipeline must hand activations between "
                           f"its stages {out['expected_handoffs']} times; "
                           f"counted {out['collective_counts']}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
