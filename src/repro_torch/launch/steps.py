"""The step functions (the reference's ``repro/launch/steps.py``,
without the sharded-input specs).

``make_train_step`` returns the training step the reference's trainer
jits: loss and gradients (gradient accumulation over microbatches cut
from the batch's leading axis, summed in float32 over a Python loop
where the reference uses ``lax.scan``), int8 error-feedback compression
of the gradients, then AdamW.  ``make_prefill_step`` /
``make_decode_step`` wrap ``prefill`` / ``decode_step``.  The shape
cells (``SHAPES``) are the reference's.  ``input_specs``, ``jit_cell``
and ``rules_for`` need the sharding rules (``distributed/sharding``),
which are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Tuple

import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import RunFlags, decode_step, prefill, \
    train_loss
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.training.compression import compress_grads
from repro_torch.training.optimizer import AdamWConfig, adamw_update

Tree = Any


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str            # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def value_and_grad(params: Tree, batch: Tree, cfg: ArchConfig,
                   flags: RunFlags) -> Tuple[torch.Tensor, Tree]:
    """(train_loss, its gradient tree) at ``params`` (which need not
    require grad); a parameter the loss does not reach gets zeros, as
    ``jax.grad`` gives."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    loss = train_loss(tree_unflatten(params, leaves), batch, cfg, flags)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(leaves, grads)]
    return loss.detach(), tree_unflatten(params, grads)


def make_train_step(cfg: ArchConfig, opt: AdamWConfig = AdamWConfig(),
                    flags: RunFlags = RunFlags(),
                    compression: bool = False) -> Callable:
    """``train_step(state, batch) -> (new_state, {"loss",
    "grad_norm"})``.  The step donates ``state``, as the reference's
    jitted step does (``donate_argnums=(0,)``): the parameters and
    moments are updated in place and the new state holds them."""
    def train_step(state: Tree, batch: Tree) -> Tuple[Tree, Tree]:
        accum = max(flags.grad_accum, 1)
        if accum == 1:
            loss, grads = value_and_grad(state["params"], batch, cfg, flags)
        else:
            # microbatch gradient accumulation: splits the global batch
            # on the leading axis
            dev = state["step"].device
            n = torch.tensor(accum, dtype=torch.float32, device=dev)
            loss = torch.zeros((), dtype=torch.float32, device=dev)
            grads = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device),
                state["params"])
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                l, g = value_and_grad(state["params"], mb, cfg, flags)
                grads = tree_map(lambda a, b: a + b.to(a.dtype), grads, g)
                loss = loss + l
            loss = loss / n
            grads = tree_map(lambda g: g / n, grads)
        new_ef = None
        if compression:
            # int8 round trip + error feedback before the optimizer
            grads, new_ef = compress_grads(grads, state["ef"])
        new_p, new_mu, new_nu, gnorm = adamw_update(
            state["params"], grads, state["mu"], state["nu"],
            state["step"], opt)
        new_state = {"params": new_p, "mu": new_mu, "nu": new_nu,
                     "step": state["step"] + 1}
        if compression:
            new_state["ef"] = new_ef
        return new_state, {"loss": loss, "grad_norm": gnorm}
    return train_step


def make_prefill_step(cfg: ArchConfig,
                      flags: RunFlags = RunFlags()) -> Callable:
    def prefill_step(params: Tree, batch: Tree, caches: Tree):
        return prefill(params, batch, caches, cfg, flags)
    return prefill_step


def make_decode_step(cfg: ArchConfig,
                     flags: RunFlags = RunFlags()) -> Callable:
    def serve_step(params: Tree, tokens: torch.Tensor, caches: Tree, pos):
        return decode_step(params, tokens, caches, pos, cfg, flags)
    return serve_step
