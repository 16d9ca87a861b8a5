"""int8 gradient compression with error feedback (the reference's
``repro/training/compression.py``).

Per-tensor symmetric int8: the scale is the float32 max |x| (at least
1e-12) over 127, q = round-half-to-even(x / scale) clipped to +-127.
The residual of the round trip is kept and added to the next step's
gradient (error feedback).  Bit-equal to the reference: both divides
are by float32 tensors, so PyTorch's CUDA path does not turn them into
a multiply by a reciprocal.  On a rank's block of a gradient
(``launch/steps.jit_cell``'s sharded body) the scale is the whole
gradient's: the block's max |x| is reduced by MAX over the axes the
leaf is split over (``shards``), so every block lands on the reference's
int8 grid.
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import torch

from repro_torch.distributed.sharding import reduce_over
from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten

Tree = Any


def _quantize(x: torch.Tensor, groups: Sequence[Any] = ()
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-tensor int8.  Returns (q, scale).  ``groups``: the
    process groups over which ``x`` is a block of the tensor."""
    xf = x.float()
    amax = reduce_over(torch.amax(torch.abs(xf)), groups, "max")
    scale = torch.clamp_min(amax, 1e-12) / \
        torch.tensor(127.0, dtype=torch.float32, device=x.device)
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def init_error_state(grads: Tree) -> Tree:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads)


@torch.no_grad()
def compress_grads(grads: Tree, error: Tree, shards: Optional[Tree] = None
                   ) -> Tuple[Tree, Tree]:
    """Apply error feedback + the int8 round trip.  Returns (grads',
    error').  ``shards`` (a tree like ``grads``): each leaf's groups of
    the axes it is split over (module docstring)."""
    def one(g, e, groups):
        gf = g.float() + e
        q, scale = _quantize(gf, groups)
        deq = _dequantize(q, scale)
        return deq.to(g.dtype), gf - deq

    leaves = tree_leaves(grads)
    groups = [()] * len(leaves) if shards is None else tree_leaves(shards)
    out = [one(g, e, gr) for g, e, gr in zip(leaves, tree_leaves(error),
                                             groups)]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))
