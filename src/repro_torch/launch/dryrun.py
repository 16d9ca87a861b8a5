"""Multi-pod dry run: trace every (arch x shape x mesh) cell as the port
would run it on H100s, and record whether it fits and its roofline
terms (the reference's ``repro/launch/dryrun.py``).

Per cell, with no card: a ``fake`` process group at the mesh's world
size (256 for ``single``'s (16, 16), 512 for ``multi``'s (2, 16, 16)),
the production mesh on it, the cell's inputs as fake tensors (shapes,
no data) laid out as ``input_shardings`` on rank 0, and ``jit_cell``'s
step run once on them under the counters of ``launch/traceanalysis``:
FLOPs, bytes, collectives and the peak of live storage of rank 0.  The
trace takes the card's path: every kernel wrapper runs its checks and
allocations and records the launch it would make (``kernels.ops``'
fake branch).  The fake tensors lie on ``cuda`` where PyTorch is built
with CUDA; in a CPU-only build they lie on the CPU and stand for the
card's (``kernels.ops.card_trace``), since autograd and Python indexing
cannot run on fake ``cuda`` tensors there.  ``device="cpu"`` traces the
plain versions instead (the CPU's program).

``jit_cell`` runs each cell in one of two layouts (``steps.layout``),
recorded as ``layout``: ``sharded`` (the train, ``prefill_32k`` and
``decode_32k`` cells of the dense decoders and mixtral-8x22b, whose
serving cells take SERVE_BIG_RULES: each rank holds its blocks of
the state, or of the weights and the KV cache, and computes its share,
as the reference's sharded XLA program does; a serving cell writes its
cache block in place, so its trace holds no ``*_scatter`` clone, and
its decode's log-sum-exp output is one of the kernel's fake
allocations) or ``gathered`` (every other cell: every weight gathered
whole on every rank, so the peak is far above the reference's for the
big archs).  The peak is recorded beside the card's 80 GB.

Every layer and step is traced, except where the model steps a
recurrence token by token in Python over a whole sequence (xLSTM's
sLSTM in training and prefill, its mLSTM state in prefill): a trace
costs about a second a token there, so such a cell is traced at the
three sequence lengths ``STEPPED_LENGTHS`` and each count is carried to
the cell's length by the quadratic through them (exact for counts that
are a polynomial of degree 2 in the length, as these archs' are: the
mLSTM's parallel form is quadratic, the rest linear;
``tests/test_torch_dryrun.py`` checks two more lengths), and the
result says so (``extrapolated_from``).  The peak of live storage is a
maximum over the step, not a polynomial, so such a cell reports none
(``peak_device_bytes``, ``temp_bytes`` and ``fits`` are None).

Results go to ``build/dryrun_results/<arch>_<shape>_<mesh>[_<tag>].json``.

Usage:
    python -m repro_torch.launch.dryrun --arch mixtral-8x22b \\
        --shape train_4k --mesh single [--tag baseline] [--remat full]
    python -m repro_torch.launch.dryrun --all --mesh single   # every cell
    python -m repro_torch.launch.dryrun --list                # cell matrix
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import pathlib
import sys
import time
import traceback
from fractions import Fraction

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor

from repro_torch.configs import ARCHS, get_config
from repro_torch.distributed.sharding import Mesh
from repro_torch.kernels import ops
from repro_torch.launch import steps as steps_lib
from repro_torch.launch.analytic import analytic_bytes_per_device
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.launch.steps import (SHAPES, ShapeSpec, jit_cell,
                                      shape_applicable)
from repro_torch.launch.traceanalysis import (HBM_BW, HBM_BYTES,
                                              PEAK_FLOPS, RooflineReport,
                                              analyze_trace)
from repro_torch.models import RunFlags
from repro_torch.models.config import ArchConfig, Mixer
from repro_torch.models.params import tree_map

RESULTS_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "dryrun_results"

# the ten assigned archs, in the reference's order (qwen2-5-7b is the
# paper-validation extra)
ASSIGNED = ["whisper-base", "deepseek-v2-236b", "mixtral-8x22b",
            "xlstm-125m", "internvl2-26b", "gemma3-1b", "granite-20b",
            "command-r-35b", "minicpm3-4b", "recurrentgemma-9b"]

# the lengths at which a cell whose model steps a recurrence in Python
# is traced (module docstring), and the counts carried from them
STEPPED_LENGTHS = (64, 128, 192)
_COUNTED = ("flops_per_device", "bytes_per_device",
            "collective_bytes_per_device", "argument_bytes", "output_bytes",
            "alias_bytes", "aten_flops", "aten_bytes")


@contextlib.contextmanager
def fake_group(world: int):
    """torch.distributed's default group at world size ``world`` on the
    ``fake`` backend (no peers, no network: every collective completes
    at once), as rank 0; destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tensor_device(device: str) -> str:
    """Where a trace of ``device``'s program puts its fake tensors."""
    if device == "cuda" and not torch.backends.cuda.is_built():
        return "cpu"              # stand-ins for the card's (module doc)
    return device


def _fake_input(s, sh, mesh: Mesh, device: str) -> DTensor:
    """Rank 0's block of a spec leaf laid out as ``sh``, as a fake
    DTensor (the caller's fake mode is active)."""
    local = list(s.shape)
    for dim, entry in enumerate(sh.spec):
        for a in (entry,) if isinstance(entry, str) else entry or ():
            local[dim] //= mesh.shape[a]
    t = torch.empty(local, dtype=s.dtype, device=device)
    return DTensor.from_local(t, mesh.device_mesh, sh.placements,
                              run_check=False, shape=torch.Size(s.shape),
                              stride=torch.empty(s.shape,
                                                 device="meta").stride())


def steps_in_python(cfg: ArchConfig, shape: ShapeSpec) -> bool:
    """Whether the cell's model steps a recurrence token by token in
    Python over the whole sequence (module docstring)."""
    return shape.kind != "decode" and any(
        b.mixer in (Mixer.SLSTM, Mixer.MLSTM)
        for g in cfg.groups for b in g.pattern)


def _extrapolated(traces, lengths, n: int) -> dict:
    """The counts of ``traces`` at ``lengths`` carried to length ``n`` by
    the polynomial through them (Lagrange); what does not grow with the
    length (launches, collective counts) must be equal in all."""
    def fit(ys):
        total = Fraction(0)
        for i, (xi, y) in enumerate(zip(lengths, ys)):
            w = Fraction(1)
            for j, xj in enumerate(lengths):
                if j != i:
                    w *= Fraction(n - xj, xi - xj)
            total += w * int(y)
        return round(total)
    last = traces[-1]
    for k in ("collective_counts", "kernel_launches", "kernel_routes"):
        if any(t[k] != last[k] for t in traces):
            raise ValueError(f"{k} grows with the sequence length: "
                             f"{[t[k] for t in traces]} at {lengths}")
    out = dict(last)
    for k in _COUNTED:
        out[k] = type(last[k])(fit([t[k] for t in traces]))
    out["collective_detail"] = {
        op: fit([t["collective_detail"][op] for t in traces])
        for op in last["collective_detail"]}
    out["kernel_work"] = {
        op: {w: fit([t["kernel_work"][op][w] for t in traces])
             for w in work}
        for op, work in last["kernel_work"].items()}
    out["trace_s"] = sum(t["trace_s"] for t in traces)
    out["extrapolated_from"] = list(lengths)
    out["temp_bytes"] = out["peak_bytes"] = None        # not a polynomial
    return out


def trace_cell(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, *,
               flags: RunFlags = RunFlags(), device: str = "cuda",
               pos=None, mesh_name: str = "", tag: str = "baseline"
               ) -> dict:
    """Trace ``jit_cell``'s step of one cell on ``mesh`` (over the
    caller's process group) once, on rank 0's fake inputs; ``pos``: a
    decode cell's position (default: its cache's last row).  Returns the
    report's dict, the trace's detail and ``trace_s``.  A cell whose
    model steps a recurrence in Python is traced at STEPPED_LENGTHS and
    extrapolated (module docstring)."""
    kw = dict(flags=flags, device=device, pos=pos, mesh_name=mesh_name,
              tag=tag)
    if not steps_in_python(cfg, shape) or \
            shape.seq_len <= STEPPED_LENGTHS[-1]:
        return _trace_once(cfg, shape, mesh, **kw)
    traces = [_trace_once(cfg, dataclasses.replace(shape, seq_len=n),
                          mesh, **kw) for n in STEPPED_LENGTHS]
    out = _extrapolated(traces, STEPPED_LENGTHS, shape.seq_len)
    fields = {f.name: out[f.name]
              for f in dataclasses.fields(RooflineReport)}
    tokens = shape.global_batch * shape.seq_len
    fields.update(shape=shape.name, temp_bytes=0, model_flops_global=cfg.
                  model_flops_per_token(train=shape.kind == "train")
                  * tokens)
    out.update(RooflineReport(**fields).to_dict(), temp_bytes=None,
               peak_device_bytes=None)
    return out


def _trace_once(cfg: ArchConfig, shape: ShapeSpec, mesh: Mesh, *,
                flags: RunFlags, device: str, pos, mesh_name: str,
                tag: str) -> dict:
    dev = tensor_device(device)
    card = device == "cuda"
    specs = steps_lib.input_specs(cfg, shape, flags)
    shards = steps_lib.input_shardings(cfg, shape, mesh, flags)
    train = shape.kind == "train"
    tokens = shape.global_batch * \
        (1 if shape.kind == "decode" else shape.seq_len)
    t0 = time.time()
    with FakeTensorMode(), (ops.card_trace() if card and dev == "cpu"
                            else contextlib.nullcontext()):
        step, _ = jit_cell(cfg, shape, mesh, flags)
        args = [tree_map(lambda s, sh: _fake_input(s, sh, mesh, dev),
                         specs[n], shards[n])
                for n in steps_lib._ARGS[shape.kind]]
        if shape.kind == "decode":
            args[-1] = shape.seq_len - 1 if pos is None else pos
        rep, detail = analyze_trace(
            step, args, arch=cfg.name, shape=shape.name,
            mesh_name=mesh_name, n_devices=mesh.size,
            model_flops_global=cfg.model_flops_per_token(train=train)
            * tokens, tag=tag, card=card)
    out = rep.to_dict()
    out.update(detail, trace_s=time.time() - t0,
               layout=steps_lib.layout(cfg, shape, mesh, flags))
    return out


def run_cell(arch: str, shape_name: str, mesh_name: str, *,
             flags: RunFlags = RunFlags(), tag: str = "baseline",
             verbose: bool = True, device: str = "cuda") -> dict:
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                "tag": tag, "status": "skipped", "reason": why}
    if shape.kind == "train" and flags.grad_accum == 0:
        # auto policy: the >=100B archs need microbatching to fit
        accum = 4 if cfg.param_count() > 1e11 else 1
        flags = dataclasses.replace(flags, grad_accum=accum)
    elif flags.grad_accum == 0:
        flags = dataclasses.replace(flags, grad_accum=1)
    multi = mesh_name == "multi"
    with fake_group(512 if multi else 256):
        mesh = make_production_mesh(
            multi_pod=multi, device_type=tensor_device(device))
        out = trace_cell(cfg, shape, mesh, flags=flags, device=device,
                         mesh_name=mesh_name, tag=tag)
    out["arch"] = arch                       # the cell's name, not cfg's
    ab = analytic_bytes_per_device(cfg, shape, mesh, remat=flags.remat,
                                   flags=flags)
    out["analytic_bytes"] = {k: float(v) for k, v in ab.items()}
    out["memory_floor_s"] = float(ab["total"]) / HBM_BW
    terms = {"compute": out["compute_s"], "memory": out["memory_floor_s"],
             "collective": out["collective_s"]}
    out["dominant_floor"] = max(terms, key=terms.get)
    useful_s = out["model_flops_global"] / (mesh.size * PEAK_FLOPS)
    out["bound_floor_s"] = max(terms.values())
    out["roofline_fraction_floor"] = (useful_s / out["bound_floor_s"]
                                      if out["bound_floor_s"] else 0.0)
    peak = out["peak_device_bytes"]
    out.update(status="ok", device=device, hbm_bytes=HBM_BYTES,
               fits=None if peak is None else peak <= HBM_BYTES,
               flags={"remat": flags.remat, "moe_impl": flags.moe_impl,
                      "scan_unroll": flags.scan_unroll,
                      "grad_accum": flags.grad_accum,
                      "attn_chunk": flags.attn_chunk,
                      "cache_dtype": flags.cache_dtype})
    if verbose:
        gib = "not traced" if peak is None else f"{peak / 2**30:.2f}"
        print(f"[dryrun] {arch} x {shape_name} x {mesh_name} ({tag}): "
              f"layout: {out['layout']} | "
              f"trace {out['trace_s']:.0f}s | {gib} GiB/dev (card "
              f"{HBM_BYTES / 2**30:.1f} GiB) | compute "
              f"{out['compute_s']*1e3:.2f} ms, memory(floor) "
              f"{out['memory_floor_s']*1e3:.2f} ms (traced "
              f"{out['memory_s']*1e3:.0f} ms), collective "
              f"{out['collective_s']*1e3:.2f} ms -> "
              f"{out['dominant_floor']}-bound | useful-FLOP ratio "
              f"{out['useful_flops_ratio']:.2f} | roofline-frac "
              f"{out['roofline_fraction_floor']:.3f}")
        temp = out["temp_bytes"]
        print(f"  memory: arguments {out['argument_bytes']:,} B, outputs "
              f"{out['output_bytes']:,}, temp "
              f"{'not traced' if temp is None else f'{temp:,}'}, "
              f"donated {out['alias_bytes']:,}")
        print(f"  flops/dev={out['flops_per_device']:.3e} (aten "
              f"{out['aten_flops']:.3e}) bytes/dev="
              f"{out['bytes_per_device']:.3e}; kernels "
              f"{out['kernel_launches']} {out['kernel_routes']}")
        print(f"  collectives: {out['collective_counts']} "
              f"bytes={out['collective_detail']}")
    return out


def save_result(res: dict) -> pathlib.Path:
    RESULTS_DIR.mkdir(parents=True, exist_ok=True)
    tag = res.get("tag", "baseline")
    name = f"{res['arch']}_{res['shape']}_{res['mesh']}"
    if tag != "baseline":
        name += f"_{tag}"
    path = RESULTS_DIR / f"{name}.json"
    path.write_text(json.dumps(res, indent=1, default=str))
    return path


def cell_matrix():
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            ok, why = shape_applicable(cfg, shape)
            yield arch, sname, ok, why


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--mesh", choices=["single", "multi"], default="single")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--remat", default="full",
                    choices=["none", "full", "dots"])
    ap.add_argument("--moe-impl", default=None, choices=["onehot", "dense"])
    ap.add_argument("--scan-unroll", type=int, default=1)
    ap.add_argument("--grad-accum", type=int, default=0,
                    help="microbatches per step (0 = auto: 4 for >100B-"
                         "param archs on train shapes, else 1)")
    ap.add_argument("--attn-chunk", type=int, default=1024)
    ap.add_argument("--cache-dtype", default="bf16", choices=["bf16", "int8"])
    ap.add_argument("--moe-group", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="trace the card's program (the kernels' routes) "
                         "or the CPU's (the plain versions)")
    ap.add_argument("--all", action="store_true",
                    help="run every applicable cell on --mesh")
    ap.add_argument("--list", action="store_true")
    ap.add_argument("--force", action="store_true",
                    help="re-run cells that already have results")
    args = ap.parse_args(argv)

    if args.list:
        for arch, sname, ok, why in cell_matrix():
            print(f"{arch:22s} {sname:12s} "
                  f"{'RUN' if ok else 'SKIP: ' + why}")
        return 0

    flags = RunFlags(remat=args.remat, moe_impl=args.moe_impl,
                     scan_unroll=args.scan_unroll,
                     attn_chunk=args.attn_chunk,
                     grad_accum=args.grad_accum,
                     cache_dtype=args.cache_dtype,
                     moe_group=args.moe_group)
    if args.all:
        failures = []
        for arch, sname, ok, why in cell_matrix():
            name = f"{arch}_{sname}_{args.mesh}"
            if args.tag != "baseline":
                name += f"_{args.tag}"
            path = RESULTS_DIR / f"{name}.json"
            if path.exists() and not args.force:
                print(f"[dryrun] {name}: cached")
                continue
            try:
                res = run_cell(arch, sname, args.mesh, flags=flags,
                               tag=args.tag, device=args.device)
            except Exception as e:                      # noqa: BLE001
                traceback.print_exc()
                res = {"arch": arch, "shape": sname, "mesh": args.mesh,
                       "tag": args.tag, "status": "error", "error": str(e)}
                failures.append(name)
            save_result(res)
        if failures:
            print("FAILED cells:", failures)
            return 1
        return 0

    if not (args.arch and args.shape):
        ap.error("--arch and --shape required (or --all/--list)")
    res = run_cell(args.arch, args.shape, args.mesh, flags=flags,
                   tag=args.tag, device=args.device)
    save_result(res)
    return 0 if res["status"] in ("ok", "skipped") else 1


if __name__ == "__main__":
    sys.exit(main())
