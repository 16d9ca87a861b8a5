"""Shared layers: RMSNorm, SwiGLU MLP, embeddings.

The training loss (``softmax_xent``) comes with the training slice.
"""
from __future__ import annotations

from typing import Any, Optional

import torch
import torch.nn.functional as F

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


def mlp(p: Tree, x: torch.Tensor) -> torch.Tensor:
    g = torch.einsum("bsd,df->bsf", x, p["wi_gate"])
    u = torch.einsum("bsd,df->bsf", x, p["wi_up"])
    return torch.einsum("bsf,fd->bsd", F.silu(g) * u, p["wo"])


# -- embeddings / head ------------------------------------------------------

def embed_specs(cfg: ArchConfig) -> Tree:
    p = {"table": spec([cfg.vocab_size, cfg.d_model], ["vocab", "embed"],
                       cfg.param_dtype, "embed")}
    if not cfg.tie_embeddings:
        p["head"] = spec([cfg.d_model, cfg.vocab_size], ["embed", "vocab"],
                         cfg.param_dtype)
    return p


def embed(p: Tree, tokens: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    x = p["table"][tokens]
    # the scale is rounded to the activation dtype first, as the
    # reference does: sqrt(3584) in bf16 is not its float32 value
    return x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype,
                            device=x.device)


def unembed(p: Tree, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return torch.einsum("bsd,vd->bsv", x, p["table"])
    return torch.einsum("bsd,dv->bsv", x, p["head"])
