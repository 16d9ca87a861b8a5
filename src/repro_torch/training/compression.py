"""int8 gradient compression with error feedback (the reference's
``repro/training/compression.py``).

Per-tensor symmetric int8: the scale is the float32 max |x| (at least
1e-12) over 127, q = round-half-to-even(x / scale) clipped to +-127.
The residual of the round trip is kept and added to the next step's
gradient (error feedback).  Bit-equal to the reference: both divides
are by float32 tensors, so PyTorch's CUDA path does not turn them into
a multiply by a reciprocal.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

Tree = Any


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale)."""
    xf = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(xf)), 1e-12) / \
        torch.tensor(127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def compress_grads(grads: Tree, error: Tree) -> Tuple[Tree, Tree]:
    """Apply error feedback + the int8 round trip.  Returns (grads',
    error')."""
    def one(g, e):
        gf = g.float() + e
        q, scale = _quantize(gf)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), gf - deq

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(error))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
