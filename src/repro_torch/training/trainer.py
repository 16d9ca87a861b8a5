"""Training loop: data -> train step -> async checkpoints (the
reference's ``repro/training/trainer.py``).

Composes the substrate: the synthetic pipeline (``repro_torch.data``),
the AdamW train step with optional microbatch accumulation and int8
gradient compression (``launch/steps.make_train_step``), and
fault-tolerant resume (``repro_torch.checkpoint``).  The state lives on
``device`` (default the card; a missing card raises).  Weights come
from ``materialize`` with a ``torch.Generator`` seeded by
``TrainConfig.seed``: its streams are not ``jax.random``'s, so the
tests carry the reference's state over for parity.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager, latest_step, \
    restore_pytree
from repro_torch.data import DataCursor, SyntheticLMDataset
from repro_torch.launch.steps import make_train_step
from repro_torch.models.config import ArchConfig
from repro_torch.models.model import RunFlags, build_param_specs
from repro_torch.models.params import materialize, tree_map_specs
from repro_torch.training.optimizer import AdamWConfig, adamw_init_specs

Tree = Any


@dataclasses.dataclass
class TrainConfig:
    steps: int = 200
    batch_size: int = 8
    seq_len: int = 256
    seed: int = 0
    checkpoint_dir: Optional[str] = None
    checkpoint_every: int = 50
    log_every: int = 10
    grad_compression: bool = False
    opt: AdamWConfig = dataclasses.field(default_factory=AdamWConfig)
    flags: RunFlags = dataclasses.field(default_factory=RunFlags)


def init_state(cfg: ArchConfig, seed: int = 0, *, compression: bool = False,
               device: str | torch.device = "cuda") -> Tree:
    specs = build_param_specs(cfg)
    params = materialize(specs, torch.Generator().manual_seed(seed), device)
    mu_s, nu_s = adamw_init_specs(specs)
    zeros = lambda t: tree_map_specs(          # noqa: E731
        lambda s: torch.zeros(s.shape, dtype=s.dtype, device=device), t)
    state = {"params": params, "mu": zeros(mu_s), "nu": zeros(nu_s),
             "step": torch.zeros((), dtype=torch.int32, device=device)}
    if compression:
        state["ef"] = zeros(mu_s)
    return state


def _cursor(index: int, device) -> torch.Tensor:
    return torch.tensor(index, dtype=torch.int32, device=device)


def train(cfg: ArchConfig, tc: TrainConfig,
          log_fn: Callable[[str], None] = print, *,
          device: str | torch.device = "cuda") -> Dict[str, List[float]]:
    """Run the loop; returns the metric history (``loss``,
    ``grad_norm``, ``step_time_s``: the host clock around a step, ending
    in the loss's ``.item()``, which waits for the card)."""
    step_fn = make_train_step(cfg, tc.opt, tc.flags,
                              compression=tc.grad_compression)
    state = init_state(cfg, tc.seed, compression=tc.grad_compression,
                       device=device)
    cursor = DataCursor()

    mgr = None
    if tc.checkpoint_dir:
        mgr = CheckpointManager(tc.checkpoint_dir)
        last = latest_step(tc.checkpoint_dir)
        if last is not None:
            ckpt_tmpl = {"state": state, "cursor": _cursor(0, device)}
            restored = restore_pytree(ckpt_tmpl, tc.checkpoint_dir, last)
            state = restored["state"]
            cursor.batch_index = int(restored["cursor"])
            log_fn(f"[trainer] resumed from step {last} "
                   f"(batch cursor {cursor.batch_index})")

    ds = SyntheticLMDataset(vocab_size=cfg.vocab_size, seq_len=tc.seq_len,
                            batch_size=tc.batch_size, seed=tc.seed)
    history: Dict[str, List[float]] = {"loss": [], "grad_norm": [],
                                       "step_time_s": []}
    it = ds.iterate(cursor)
    start_step = int(state["step"])
    for i in range(start_step, tc.steps):
        batch_np = next(it)
        batch = {k: torch.from_numpy(v).to(device)
                 for k, v in batch_np.items()}
        t0 = time.perf_counter()
        state, metrics = step_fn(state, batch)
        loss = metrics["loss"].item()
        dt = time.perf_counter() - t0
        history["loss"].append(loss)
        history["grad_norm"].append(float(metrics["grad_norm"]))
        history["step_time_s"].append(dt)
        if i % tc.log_every == 0 or i == tc.steps - 1:
            log_fn(f"[trainer] step {i:5d} loss {loss:8.4f} "
                   f"gnorm {float(metrics['grad_norm']):8.3f} "
                   f"{dt*1e3:7.1f} ms")
        if mgr and tc.checkpoint_every and (i + 1) % tc.checkpoint_every == 0:
            mgr.save_async({"state": state,
                            "cursor": _cursor(cursor.batch_index, device)},
                           i + 1)
    if mgr:
        mgr.save_async({"state": state,
                        "cursor": _cursor(cursor.batch_index, device)},
                       tc.steps)
        mgr.close()
    return history
