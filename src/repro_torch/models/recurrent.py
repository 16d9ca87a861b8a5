"""The RG-LRU recurrent mixer (RecurrentGemma / Griffin): input and gate
projections, a depthwise causal conv1d, the real-gated linear recurrent
unit, and the gated output projection.

A full-sequence call (prefill) and a one-token call (decode) are the same
function: the state ``{"conv": [B, cw-1, W], "h": [B, W]}`` carries the
last conv inputs and the recurrence's float32 state, and has no time
axis.  The recurrence goes through ``ops.rglru_scan`` (the hand-written
CUDA kernel on the card, its plain version on the CPU); the reference
(``repro/models/recurrent.py``) computes it with an associative scan,
which agrees to float32 rounding.  mLSTM and sLSTM come with the xLSTM
slice.
"""
from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops
from repro_torch.models.config import ArchConfig
from repro_torch.models.params import spec

Tree = Any


def rglru_specs(cfg: ArchConfig) -> Tree:
    d = cfg.d_model
    r = cfg.recurrent
    w = r.lru_width or d
    dt = cfg.param_dtype
    return {
        "w_in": spec([d, w], ["embed", "ffn"], dt),      # recurrence branch
        "w_gate": spec([d, w], ["embed", "ffn"], dt),    # gelu gate branch
        "conv_w": spec([r.conv_width, w], ["conv", "ffn"], dt),
        "conv_b": spec([w], ["ffn"], dt, "zeros"),
        "lambda_param": spec([w], ["ffn"], torch.float32, "ones"),
        "w_rec_gate": spec([w, w], ["ffn", "ffn2"], dt),   # r_t projection
        "b_rec_gate": spec([w], ["ffn"], dt, "zeros"),
        "w_in_gate": spec([w, w], ["ffn", "ffn2"], dt),    # i_t projection
        "b_in_gate": spec([w], ["ffn"], dt, "zeros"),
        "w_out": spec([w, d], ["ffn", "embed"], dt),
    }


_RGLRU_C = 8.0


def _rglru_gates(p: Tree, u: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and b_t (input) of the diagonal recurrence, float32,
    in the reference's order of operations."""
    uf = u.float()
    r_gate = torch.sigmoid(
        torch.einsum("...w,wv->...v", uf, p["w_rec_gate"].float())
        + p["b_rec_gate"].float())
    i_gate = torch.sigmoid(
        torch.einsum("...w,wv->...v", uf, p["w_in_gate"].float())
        + p["b_in_gate"].float())
    log_a = -_RGLRU_C * F.softplus(p["lambda_param"].float()) * r_gate
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp_min(1.0 - a * a, 1e-12)) * (i_gate * uf)
    return a, b


def _conv1d(p: Tree, u: torch.Tensor,
            state: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal temporal conv.  u: [B,S,W]; state: [B,cw-1,W], the
    last cw-1 inputs (zeros for a fresh sequence).  The taps accumulate
    in float32 in tap order, as the reference's loop does (not
    ``F.conv1d``, which sums in another order).  Returns (out in u's
    dtype, new state = the last cw-1 rows of [state; u])."""
    cw = p["conv_w"].shape[0]
    if state is None:
        state = torch.zeros((u.shape[0], cw - 1, u.shape[2]), dtype=u.dtype,
                            device=u.device)
    ext = torch.cat([state, u], dim=1)                   # [B, S+cw-1, W]
    out = torch.zeros(u.shape, dtype=torch.float32, device=u.device)
    for i in range(cw):
        out = out + ext[:, i:i + u.shape[1], :].float() * \
            p["conv_w"][i].float()
    out = out + p["conv_b"].float()
    new_state = ext[:, ext.shape[1] - (cw - 1):, :]
    return out.to(u.dtype), new_state


def rglru_block(
    p: Tree, x: torch.Tensor, *, cfg: ArchConfig,
    state: Optional[Dict[str, torch.Tensor]] = None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Griffin recurrent block.  x: [B,S,D].
    state = {"conv": [B,cw-1,W], "h": [B,W]} or None (fresh sequence).
    Returns (out [B,S,D], new state or None)."""
    u = torch.einsum("bsd,dw->bsw", x, p["w_in"])
    gate = torch.einsum("bsd,dw->bsw", x, p["w_gate"])
    u, new_conv = _conv1d(p, u, state["conv"] if state is not None else None)
    a, b = _rglru_gates(p, u)                            # [B,S,W] float32
    h0 = state["h"] if state is not None else \
        torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    h = ops.rglru_scan(a, b, h0)                         # float32
    # jax.nn.gelu's default is the tanh approximation
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "h": h[:, -1].to(state["h"].dtype)}
    return out, new_state


def rglru_state_spec(cfg: ArchConfig, batch: int) -> Tree:
    """The block's state.  The conv state is in the compute dtype, the
    dtype ``_conv1d`` returns it in (the reference fixes it to bfloat16,
    which its float32 reduced config cannot write back into a slot)."""
    r = cfg.recurrent
    w = r.lru_width or cfg.d_model
    return {
        "conv": spec([batch, r.conv_width - 1, w],
                     ["batch", "conv", "ffn"], cfg.compute_dtype, "zeros"),
        "h": spec([batch, w], ["batch", "ffn"], torch.float32, "zeros"),
    }
