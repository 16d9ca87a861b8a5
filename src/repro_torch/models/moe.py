"""Mixture-of-Experts FFN: a router and two dispatch strategies.

  * "onehot": GShard capacity-based one-hot dispatch.  Each expert takes
    at most C = max(ceil(S * k * cf / E), 1) tokens a sequence (or a
    dispatch group); queue positions come slot-major, so slot-0
    assignments win, and assignments past C are dropped.  The dispatch
    and combine tensors are [B, S, E, C] in the activation dtype.
  * "dense": every expert computes every token, weighted by its gate.
    Exact (no capacity drops): the oracle for "onehot".

The router is the Switch/GShard one, in float32 on a float32 weight:
softmax, top-k sorted descending, the selected gates renormalised, and
the load-balancing auxiliary loss.  Optional shared experts are a dense
SwiGLU added to the routed output.

This is the reference's ``repro/models/moe.py`` with the same semantics.
The expert products are plain matrix products (``torch.einsum``, cuBLAS
on the card), as the reference computes them outside any Pallas kernel.

In the sharded bodies (``moe_ffn(..., tp=)``, a ``sharding.ModelShards``)
every rank of the model axis routes the same tokens, each dispatch
group whole: the train body gathers its sequence block first, as before
a column-parallel product; the serving body's rows are whole already.
Where the experts dim is split over the axis (expert parallelism) a rank
dispatches to and computes only its experts; where the ffn dim is split
(Mixtral's 8 experts on 16 ranks) it computes its ffn block of every
expert.  Either way its output is a partial sum, which ends in the dense
FFN's collective after ``wo``: one collective a layer.
"""
from __future__ import annotations

import math
from typing import Any, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.config import ArchConfig, MoEConfig
from repro_torch.models.layers import mlp, mlp_spec
from repro_torch.models.params import spec

Tree = Any


def moe_specs(cfg: ArchConfig) -> Tree:
    m = cfg.moe
    d = cfg.d_model
    dt = cfg.param_dtype
    p = {
        "router": spec([d, m.n_experts], ["embed", "experts"], torch.float32),
        "wi_gate": spec([m.n_experts, d, m.d_ff_expert],
                        ["experts", "embed", "ffn"], dt),
        "wi_up": spec([m.n_experts, d, m.d_ff_expert],
                      ["experts", "embed", "ffn"], dt),
        "wo": spec([m.n_experts, m.d_ff_expert, d],
                   ["experts", "ffn", "embed"], dt),
    }
    if m.n_shared_experts > 0:
        p["shared"] = mlp_spec(
            cfg, m.d_ff_shared or m.d_ff_expert * m.n_shared_experts)
    return p


def _router(p: Tree, x: torch.Tensor, m: MoEConfig, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Returns (gates [B,S,k] float32, expert_idx [B,S,k] int64, aux).

    Inside a sharded step body (``sharding.batch_shards()`` set) ``x``
    holds this rank's block of the batch: the dispatch fractions are
    all-reduced to the global batch's, and the probability fractions
    taken as this rank's share of the global mean, so that the ranks'
    aux losses (and their gradients) sum to the reference's.  ``tp``
    (the sharded bodies): ``x`` is the same on every rank of its axis,
    so the dispatch fractions are summed over the batch's other axes
    only (the train body's batch split takes the axis too, so the
    probability shares still sum to the global mean); a router whose
    expert dim is split over the axis is gathered whole before the
    softmax."""
    w = p["router"]
    if tp is not None and w.shape[1] != m.n_experts:
        w = tp.concat(w, 1)
    logits = torch.einsum("bsd,de->bse", x.float(), w)
    probs = torch.softmax(logits, dim=-1)
    gates, idx = torch.topk(probs, m.top_k, dim=-1)     # sorted descending
    gates = gates / torch.clamp_min(gates.sum(-1, keepdim=True), 1e-9)
    # Switch-style load balancing loss (dispatch fraction from slot 0)
    e = m.n_experts
    dispatch_frac = torch.mean(
        F.one_hot(idx[..., 0], e).to(torch.float32), dim=(0, 1))
    prob_frac = torch.mean(probs, dim=(0, 1))
    shards = sharding.batch_shards()
    if shards is not None:
        rows = shards if tp is None else shards.without(tp.axis)
        if rows is not None:
            dispatch_frac = rows.sum(dispatch_frac) / rows.size
        prob_frac = prob_frac / shards.size
    aux = e * torch.sum(dispatch_frac * prob_frac) * m.router_aux_loss
    return gates, idx, aux


def _experts(p: Tree, m: MoEConfig, tp) -> Tuple[int, int]:
    """[lo, hi): the experts this rank computes (its block where the
    experts dim is split over ``tp``'s axis, else all of them)."""
    n = p["wi_gate"].shape[0]
    lo = 0 if n == m.n_experts else tp.index * n
    return lo, lo + n


def _expert_ffn(p: Tree, h: torch.Tensor) -> torch.Tensor:
    """h: [E, B, C, D] -> [E, B, C, D] via per-expert SwiGLU."""
    g = torch.einsum("ebcd,edf->ebcf", h, p["wi_gate"])
    u = torch.einsum("ebcd,edf->ebcf", h, p["wi_up"])
    return torch.einsum("ebcf,efd->ebcd", F.silu(g) * u, p["wo"])


def moe_onehot(p: Tree, x: torch.Tensor, m: MoEConfig, *,
               capacity_factor: Optional[float] = None,
               group_size: Optional[int] = None, tp=None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Capacity-based one-hot dispatch (GShard).  x: [B,S,D].

    ``group_size`` (else ``m.group_size``) splits the sequence into
    independent dispatch groups when it divides S and is below it:
    capacity is then per group, and so are the drops.  ``tp`` (the
    sharded bodies, module docstring): the dispatch and combine of this
    rank's experts only (each expert's queue is its own, so their
    positions and drops are the whole dispatch's), and the output its
    partial sums."""
    b, s, d = x.shape
    g = group_size or m.group_size
    if g and g < s and s % g == 0:
        y, aux = moe_onehot(p, x.reshape(b * (s // g), g, d), m,
                            capacity_factor=capacity_factor, group_size=None,
                            tp=tp)
        return y.reshape(b, s, d), aux
    cf = capacity_factor if capacity_factor is not None else m.capacity_factor
    cap = max(int(math.ceil(s * m.top_k * cf / m.n_experts)), 1)
    gates, idx, aux = _router(p, x, m, tp)

    e = m.n_experts
    lo, hi = _experts(p, m, tp)
    n = hi - lo
    # position of each (token, slot) in its expert's queue, slot-major so
    # that slot-0 assignments take priority (the GShard convention)
    dispatch = torch.zeros((b, s, n, cap), dtype=x.dtype, device=x.device)
    combine = torch.zeros((b, s, n, cap), dtype=x.dtype, device=x.device)
    counts = torch.zeros((b, n), dtype=torch.int64, device=x.device)
    for slot in range(m.top_k):
        onehot_e = F.one_hot(idx[..., slot], e)                 # [B,S,E]
        if n != e:
            onehot_e = onehot_e[..., lo:hi]                     # its experts
        pos = torch.cumsum(onehot_e, dim=1) - 1 + counts[:, None, :]
        counts = counts + onehot_e.sum(dim=1)
        within = (pos < cap) & (onehot_e > 0)
        # overflow goes to column ``cap``, which is cut off: dropped
        pos_oh = F.one_hot(torch.where(within, pos, cap), cap + 1) \
            .to(x.dtype)[..., :cap]
        contrib = onehot_e[..., None].to(x.dtype) * pos_oh
        dispatch = dispatch + contrib
        combine = combine + contrib * \
            gates[..., slot][..., None, None].to(x.dtype)

    expert_in = torch.einsum("bsec,bsd->ebcd", dispatch, x)
    expert_out = _expert_ffn(p, expert_in)
    y = torch.einsum("bsec,ebcd->bsd", combine, expert_out)
    return y, aux


def moe_dense(p: Tree, x: torch.Tensor, m: MoEConfig, tp=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact dense dispatch: all experts on all tokens (the oracle).
    ``tp``: this rank's experts (or ffn blocks), its partial sums."""
    gates, idx, aux = _router(p, x, m, tp)
    full = torch.zeros(x.shape[:2] + (m.n_experts,), dtype=torch.float32,
                       device=x.device)                          # [B,S,E]
    for slot in range(m.top_k):
        full = full + F.one_hot(idx[..., slot], m.n_experts) \
            .to(torch.float32) * gates[..., slot][..., None]
    lo, hi = _experts(p, m, tp)
    if hi - lo != m.n_experts:
        full = full[..., lo:hi]
    g = torch.einsum("bsd,edf->ebsf", x, p["wi_gate"])
    u = torch.einsum("bsd,edf->ebsf", x, p["wi_up"])
    eo = torch.einsum("ebsf,efd->ebsd", F.silu(g) * u, p["wo"])
    y = torch.einsum("bse,ebsd->bsd", full.to(x.dtype), eo)
    return y, aux


def shared_expert(p: Tree, x: torch.Tensor) -> torch.Tensor:
    """The shared experts: one dense SwiGLU of their total width."""
    return mlp(p["shared"], x)


def moe_ffn(p: Tree, x: torch.Tensor, cfg: ArchConfig, *,
            impl: Optional[str] = None,
            group_size: Optional[int] = None, tp=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full MoE FFN: routed experts (+ shared experts if configured).
    Returns (y [B,S,D], the router's auxiliary loss).  ``tp`` (a
    ``sharding.ModelShards``: the sharded bodies, routed experts only;
    module docstring): ``x`` is this rank's sequence block in the train
    body, gathered before the routing, or its rows in the serving body;
    the partial sums of a split experts or ffn dim are reduce-scattered
    back to the block (train) or all-reduced (serving), and where
    neither dim splits every rank computes the whole and keeps its
    block."""
    m = cfg.moe
    impl = impl or m.impl
    if tp is not None:
        if m.n_shared_experts > 0:
            raise ValueError("the sharded bodies run no shared experts")
        x = tp.seq_gather(x)
    if impl == "dense":
        y, aux = moe_dense(p, x, m, tp)
    elif impl == "onehot":
        y, aux = moe_onehot(p, x, m,
                            group_size=group_size or m.group_size or None,
                            tp=tp)
    else:
        raise ValueError(f"unknown moe impl {impl!r}")
    if tp is not None:
        split = tuple(p["wi_gate"].shape[::2]) != (m.n_experts,
                                                   m.d_ff_expert)
        return (tp.seq_scatter(y) if split else tp.own(y)), aux
    if m.n_shared_experts > 0:
        y = y + shared_expert(p, x)
    return y, aux
