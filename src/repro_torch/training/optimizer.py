"""AdamW (the reference's ``repro/training/optimizer.py``).

Moments are float32 whatever the parameter dtype.  The arithmetic is the
reference's, operation for operation: the schedule, the clip factor and
the bias corrections are float32 tensors on the parameters' device, as
jnp computes them (never Python floats, and never a divide by a Python
scalar, which PyTorch's CUDA path turns into a multiply by its
reciprocal); leaves are visited in sorted-key order, as
``jax.tree_util`` flattens dicts, so the global norm sums in the
reference's order.  ``adamw_update`` writes the new parameters and
moments into the trees it is given (the reference's jitted step donates
them): one leaf's temporaries at a time instead of a second copy of the
state, which is what lets Qwen2.5-7B's 4-layer cut train 4 rows on one
card.  On a rank's blocks of the state (``launch/steps.jit_cell``'s
sharded body) ``shards`` gives each leaf's process groups of the axes it
is split over: the global norm sums each leaf's squares over its blocks
there, and counts a replicated leaf once.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch.distributed.sharding import reduce_over
from repro_torch.models.params import ParamSpec, tree_leaves, tree_map_specs

Tree = Any


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def adamw_init_specs(param_specs: Tree) -> Tuple[Tree, Tree]:
    """(mu_specs, nu_specs): float32 zeros with the params' logical axes."""
    def f32(s: ParamSpec) -> ParamSpec:
        return ParamSpec(s.shape, torch.float32, s.axes, "zeros")
    return tree_map_specs(f32, param_specs), tree_map_specs(f32, param_specs)


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


def lr_at(step: torch.Tensor, cfg: AdamWConfig) -> torch.Tensor:
    """Linear warmup + cosine decay to min_lr_ratio (float32)."""
    step = torch.as_tensor(step).to(torch.float32)
    dev = step.device
    warm = torch.clamp_max(step / _f32(max(cfg.warmup_steps, 1), dev), 1.0)
    prog = torch.clamp(
        (step - cfg.warmup_steps)
        / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), dev), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
    scale = cfg.min_lr_ratio + (1.0 - cfg.min_lr_ratio) * cos
    return cfg.lr * warm * scale


def global_norm(tree: Tree, shards: Optional[Tree] = None
                ) -> torch.Tensor:
    """The norm of every leaf together; ``shards`` (a tree like
    ``tree``): each leaf's groups to sum its squares over (module
    docstring)."""
    leaves = tree_leaves(tree)
    groups = [()] * len(leaves) if shards is None else tree_leaves(shards)
    return torch.sqrt(sum(reduce_over(torch.sum(x.float() ** 2), g)
                          for x, g in zip(leaves, groups)))


@torch.no_grad()
def adamw_update(
    params: Tree, grads: Tree, mu: Tree, nu: Tree, step: torch.Tensor,
    cfg: AdamWConfig, shards: Optional[Tree] = None,
) -> Tuple[Tree, Tree, Tree, torch.Tensor]:
    """One AdamW step, in place.  Returns (params, mu, nu, grad_norm):
    the trees given, updated.  ``shards``: as ``global_norm``'s."""
    gnorm = global_norm(grads, shards)
    dev = gnorm.device
    clip = torch.clamp_max(_f32(cfg.grad_clip, dev) / (gnorm + 1e-9), 1.0) \
        if cfg.grad_clip > 0 else _f32(1.0, dev)
    step = torch.as_tensor(step, device=dev)
    lr = lr_at(step, cfg)
    t = step.to(torch.float32) + 1.0
    bc1 = 1.0 - torch.pow(_f32(cfg.b1, dev), t)
    bc2 = 1.0 - torch.pow(_f32(cfg.b2, dev), t)

    def upd(p, g, m, v):
        gf = g.float() * clip
        m2 = cfg.b1 * m + (1.0 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1.0 - cfg.b2) * gf * gf
        mhat = m2 / bc1
        vhat = v2 / bc2
        delta = mhat / (torch.sqrt(vhat) + cfg.eps) \
            + cfg.weight_decay * p.float()
        p.copy_(p.float() - lr * delta)
        m.copy_(m2)
        v.copy_(v2)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(mu), tree_leaves(nu)):
        upd(p, g, m, v)
    return params, mu, nu, gnorm
