"""Shared layers: RMSNorm, SwiGLU MLP, embeddings, the training loss."""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

from repro_torch.distributed import sharding
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import spec

Tree = Any


# -- norms ------------------------------------------------------------------

def rmsnorm_spec(d: int) -> Tree:
    return {"scale": spec([d], ["embed"], torch.float32, "ones")}


def rmsnorm(p: Tree, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    y = xf * torch.rsqrt(torch.mean(xf * xf, -1, keepdim=True) + eps)
    return (y * p["scale"]).to(x.dtype)


# -- MLP --------------------------------------------------------------------

def mlp_spec(cfg: ArchConfig, d_ff: Optional[int] = None) -> Tree:
    d, f = cfg.d_model, d_ff or cfg.d_ff
    dt = cfg.param_dtype
    return {
        "wi_gate": spec([d, f], ["embed", "ffn"], dt),
        "wi_up": spec([d, f], ["embed", "ffn"], dt),
        "wo": spec([f, d], ["ffn", "embed"], dt),
    }


def mlp(p: Tree, x: torch.Tensor, tp=None) -> torch.Tensor:
    """SwiGLU.  ``tp`` (a ``sharding.ModelShards``, given when the ffn
    dim is split over its axis): ``x`` is this rank's sequence block,
    gathered before the column-parallel ``wi_gate`` / ``wi_up`` and
    reduce-scattered after the row-parallel ``wo`` (in the serving body,
    a ``ServeShards``: ``x`` whole, and ``wo``'s partial sums
    all-reduced)."""
    if tp is not None:
        x = tp.seq_gather(x)
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    y = torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["wo"])
    return y if tp is None else tp.seq_scatter(y)


# -- embeddings / head ------------------------------------------------------

def embed_specs(cfg: ArchConfig) -> Tree:
    p = {"table": spec([cfg.vocab_size, cfg.d_model], ["vocab", "embed"],
                       cfg.param_dtype, "embed")}
    if not cfg.tie_embeddings:
        p["head"] = spec([cfg.d_model, cfg.vocab_size], ["embed", "vocab"],
                         cfg.param_dtype)
    return p


def embed(p: Tree, tokens: torch.Tensor, cfg: ArchConfig,
          tp=None) -> torch.Tensor:
    """The tokens' rows of the table, times sqrt(d_model).  ``tp`` (a
    ``sharding.ServeShards``): where the table's vocab rows are split
    over its axis, each rank looks the tokens up in its block, zero for
    a token outside it, and the rows are summed over the axis (exact:
    one nonzero term each), so the table is never gathered whole."""
    table = p["table"]
    if tp is None or table.shape[0] == cfg.vocab_size:
        x = table[tokens]
    else:
        lo, hi = tp.rows(cfg.vocab_size)
        inside = (tokens >= lo) & (tokens < hi)
        x = table[(tokens - lo).clamp(0, hi - lo - 1)]
        x = tp.sum(x.masked_fill(~inside[..., None], 0))
    # the scale is rounded to the activation dtype first, as the
    # reference does: sqrt(3584) in bf16 is not its float32 value
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def unembed(p: Tree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The logits of ``x`` against the head (or the tied table): over a
    block of vocab rows, the block of the logits."""
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["table"])
    return torch.einsum("bsd,dv->bsv", x, p["head"])


# -- loss -------------------------------------------------------------------

class _Picked(torch.autograd.Function):
    """``apply(x, idx)``: ``torch.gather(x, -1, idx)``, whose gradient is
    a zeros tensor of ``x``'s shape with the incoming gradient
    scattered into it in place.  (Autograd's own gather backward takes
    the out-of-place ``scatter_add`` under a tensor subclass, so the dry
    run's fake tensors would hold two [B, S, V] buffers where the card
    holds one.)"""

    @staticmethod
    def forward(ctx, x, idx):
        ctx.save_for_backward(idx)
        ctx.shape = x.shape
        return torch.gather(x, -1, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        return g.new_zeros(ctx.shape).scatter_add_(-1, idx, g), None


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross-entropy.  logits [B,S,V] (any float dtype,
    reduced in float32), labels [B,S] int32 (widened to int64 to index),
    ``mask`` [B,S] optional.

    The label's log-probability is a ``torch.gather`` (``_Picked``); the
    reference takes it as a one-hot product (``repro/models/layers.py``),
    which keeps GSPMD's vocab sharding and sums the same single nonzero
    term.
    The gather saves the [B,S,V] float32 one-hot (2.49 GB a batch row at
    V = 152,064, S = 4,096).  The max is detached, as the reference's
    ``stop_gradient``.

    Inside a sharded step body (``sharding.batch_shards()`` set) the
    tokens are this rank's block of the global batch's (its rows, and in
    the sharded train body its sequence block too), and the result is
    this rank's share of the global mean: the local mean over the number
    of blocks, or the masked sum over the mask's all-reduced count; the
    shares sum to the reference's loss over the whole batch."""
    logits = logits.float()
    m = torch.amax(logits, dim=-1, keepdim=True).detach()
    shifted = logits - m
    lse = torch.log(torch.sum(torch.exp(shifted), dim=-1)) + m[..., 0]
    ll = _Picked.apply(shifted, labels.long()[..., None])[..., 0] + \
        m[..., 0]
    nll = lse - ll
    shards = sharding.batch_shards()
    if mask is not None:
        nll = nll * mask
        count = mask.sum()
        if shards is not None:
            count = shards.sum(count.detach().clone())
        return nll.sum() / torch.clamp_min(count, 1.0)
    if shards is not None:
        return nll.mean() / shards.size
    return nll.mean()
