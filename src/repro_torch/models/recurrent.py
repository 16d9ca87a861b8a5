"""Recurrent mixers: the RG-LRU block (RecurrentGemma / Griffin) and
xLSTM's mLSTM (matrix memory) and sLSTM (scalar memory) blocks.

The RG-LRU block: input and gate projections, a depthwise causal
conv1d, the real-gated linear recurrent unit, and the gated output
projection.

A full-sequence call (prefill) and a one-token call (decode) are the same
function: the state ``{"conv": [B, cw-1, W], "h": [B, W]}`` carries the
last conv inputs and the recurrence's float32 state, and has no time
axis.  The recurrence goes through ``ops.rglru_scan`` (the hand-written
CUDA kernel on the card, its plain version on the CPU); the reference
(``repro/models/recurrent.py``) computes it with an associative scan,
which agrees to float32 rounding.  In the sharded bodies (``tp``) a
rank holds a block of the W channels: its gates' partial sums are
reduce-scattered by channel, its conv and scan run on its channels over
the whole sequence, and a serving step writes its state in place.

The xLSTM blocks are the reference's plain computation (they reach no
Pallas kernel): the mLSTM's stabilized parallel form for a full
sequence and its recurrent step for decode, the sLSTM's cell stepped
over time (a Python loop where the reference uses ``lax.scan``).
Their states are float32 whatever the model dtype, with outputs cast
back to it; the mLSTM state is ``C [B,H,K,K]``, ``n [B,H,K]``,
``m [B,H]`` with K = d_model / n_heads.
"""
from __future__ import annotations

import math
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


def _rglru_gates(p: Tree, u: torch.Tensor, tp=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_t (decay) and b_t (input) of the diagonal recurrence, float32,
    in the reference's order of operations.  ``tp`` (the sharded bodies,
    the width split): ``u`` holds this rank's channels and ``p`` its
    rows of ``w_rec_gate`` / ``w_in_gate``, so each product is partial
    sums over every channel, summed and cut to the rank's channels by
    one reduce-scatter (``tp.channel_scatter``) before the bias."""
    uf = u.float()

    def gate(w: str, bias: str) -> torch.Tensor:
        z = torch.einsum("...w,wv->...v", uf, p[w].float())
        if tp is not None:
            z = tp.channel_scatter(z)
        return torch.sigmoid(z + p[bias].float())

    r_gate = gate("w_rec_gate", "b_rec_gate")
    i_gate = gate("w_in_gate", "b_in_gate")
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
    state: Optional[Dict[str, torch.Tensor]] = None, tp=None,
) -> Tuple[torch.Tensor, Optional[Dict[str, torch.Tensor]]]:
    """Full Griffin recurrent block.  x: [B,S,D].
    state = {"conv": [B,cw-1,W], "h": [B,W]} or None (fresh sequence).
    Returns (out [B,S,D], new state or None).

    ``tp`` (a ``sharding.ModelShards``: the sharded bodies, the width W
    over its axis as the rules split "ffn"): ``p`` holds this rank's
    channels -- ``w_in`` / ``w_gate`` by column, the conv, lambda and
    the biases by channel, ``w_rec_gate`` / ``w_in_gate`` and ``w_out``
    by row -- and ``state`` its channels of its rows.  Without a cache
    (train) ``x`` is this rank's sequence block, gathered first; with
    one (serving) its rows, whole.  The gates' partial sums are
    reduce-scattered by channel (``_rglru_gates``); the conv and the
    scan are per channel, so the rank's channels run over the whole
    sequence with no collective; ``w_out``'s partial sums end in
    ``tp.seq_scatter``.  A width that does not split runs whole on
    every rank, which keeps its own rows (``tp.own``).  The serving
    body writes the new state into ``state`` in place (``_state_put``)
    and returns it."""
    if tp is not None:
        x = tp.seq_gather(x)
    u = torch.einsum("bsd,dw->bsw", x, p["w_in"])
    gate = torch.einsum("bsd,dw->bsw", x, p["w_gate"])
    u, new_conv = _conv1d(p, u, state["conv"] if state is not None else None)
    split = tp is not None and \
        u.shape[-1] != (cfg.recurrent.lru_width or cfg.d_model)
    a, b = _rglru_gates(p, u, tp if split else None)     # [B,S,W] float32
    h0 = state["h"] if state is not None else \
        torch.zeros((a.shape[0], a.shape[2]), dtype=torch.float32,
                    device=a.device)
    h = ops.rglru_scan(a, b, h0)                         # float32
    # jax.nn.gelu's default is the tanh approximation
    y = h.to(x.dtype) * F.gelu(gate, approximate="tanh")
    out = torch.einsum("bsw,wd->bsd", y, p["w_out"])
    if tp is not None:
        out = tp.seq_scatter(out) if split else tp.own(out)
    new_state = None
    if state is not None:
        new_state = {"conv": new_conv, "h": h[:, -1].to(state["h"].dtype)}
        if tp is not None:
            new_state = _state_put(state, new_state)
    return out, new_state


def _state_put(state: Dict[str, torch.Tensor],
               new: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Write a block's new state into ``state``'s leaves in place (the
    sharded serving body: this rank's channels of its rows; the
    reference donates the caches).  Returns ``state`` itself."""
    for name, val in new.items():
        state[name].copy_(val)
    return state


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


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def mlstm_specs(cfg: ArchConfig) -> Tree:
    d, h = cfg.d_model, cfg.n_heads
    k = d // h
    dt = cfg.param_dtype
    return {
        "wq": spec([d, h, k], ["embed", "heads", "hdim"], dt),
        "wk": spec([d, h, k], ["embed", "heads", "hdim"], dt),
        "wv": spec([d, h, k], ["embed", "heads", "hdim"], dt),
        "w_i": spec([d, h], ["embed", "heads"], dt),     # exp input gate
        "b_i": spec([h], ["heads"], dt, "zeros"),
        "w_f": spec([d, h], ["embed", "heads"], dt),     # forget gate
        "b_f": spec([h], ["heads"], dt, "zeros"),
        "w_o": spec([d, h, k], ["embed", "heads", "hdim"], dt),  # out gate
        "wo": spec([h, k, d], ["heads", "hdim", "embed"], dt),
    }


def _mlstm_gates(p: Tree, x: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """log input gate and log forget gate, float32: x [..., D] ->
    [..., H] each (the gate sums in x's dtype, as the reference)."""
    log_i = (torch.einsum("...d,dh->...h", x, p["w_i"]) + p["b_i"]).float()
    log_f = F.logsigmoid(
        (torch.einsum("...d,dh->...h", x, p["w_f"]) + p["b_f"]).float())
    return log_i, log_f


def mlstm_parallel(p: Tree, x: torch.Tensor, *, cfg: ArchConfig
                   ) -> torch.Tensor:
    """Stabilized parallel form (xLSTM paper eqs. 24-27), O(S^2) like
    attention; x [B,S,D] -> [B,S,D]."""
    s, d = x.shape[1], x.shape[2]
    k = d // cfg.n_heads
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]) / math.sqrt(k)
    kk = torch.einsum("bsd,dhk->bshk", x, p["wk"])
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"])
    log_i, log_f = _mlstm_gates(p, x)

    # F[t,s] = sum_{j=s+1..t} log_f_j ; D[t,s] = F[t,s] + log_i_s  (s<=t)
    cum = torch.cumsum(log_f, dim=1)                      # [B,S,H]
    fmat = cum[:, :, None, :] - cum[:, None, :, :]        # [B,t,s,H]
    dmat = fmat + log_i[:, None, :, :]
    tidx = torch.arange(s, device=x.device)
    causal = (tidx[None, :, None] >= tidx[None, None, :])[..., None]
    dmat = dmat.masked_fill(~causal, -math.inf)
    m = torch.amax(dmat, dim=2, keepdim=True)             # [B,t,1,H]
    w = torch.exp(dmat - m)                               # [B,t,s,H]
    # float32 scores from float32 operands: bf16 products are exact there
    scores = torch.einsum("bthk,bshk->btsh", q.float(), kk.float()) * w
    denom = torch.maximum(scores.sum(dim=2).abs(),
                          torch.exp(-m[:, :, 0, :]))      # [B,t,H]
    out = torch.einsum("btsh,bshk->bthk", scores, v.float())
    out = out / denom[..., None]
    o = torch.sigmoid(torch.einsum("bsd,dhk->bshk", x, p["w_o"]).float())
    out = (out * o).to(x.dtype)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def mlstm_step(p: Tree, x: torch.Tensor, state: Dict[str, torch.Tensor],
               *, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Recurrent decode step.  x: [B,1,D].
    state: C [B,H,K,K], n [B,H,K], m [B,H] (float32)."""
    if x.shape[1] != 1:
        raise ValueError(f"mlstm_step takes one token, got {x.shape[1]}")
    k = x.shape[2] // cfg.n_heads
    xt = x[:, 0]
    q = torch.einsum("bd,dhk->bhk", xt, p["wq"]) / math.sqrt(k)
    kk = torch.einsum("bd,dhk->bhk", xt, p["wk"])
    v = torch.einsum("bd,dhk->bhk", xt, p["wv"])
    log_i, log_f = _mlstm_gates(p, xt)

    m_prev = state["m"]
    m_new = torch.maximum(log_f + m_prev, log_i)
    f_sc = torch.exp(log_f + m_prev - m_new)[..., None]
    i_sc = torch.exp(log_i - m_new)[..., None]
    kf, vf = kk.float(), v.float()
    c_new = state["C"] * f_sc[..., None] + \
        i_sc[..., None] * kf[..., :, None] * vf[..., None, :]
    n_new = state["n"] * f_sc + i_sc * kf
    qf = q.float()
    num = torch.einsum("bhk,bhkv->bhv", qf, c_new)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", qf, n_new).abs(),
                        torch.exp(-m_new))
    out = num / den[..., None]
    o = torch.sigmoid(torch.einsum("bd,dhk->bhk", xt, p["w_o"]).float())
    out = (out * o).to(x.dtype)
    y = torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None, :]
    return y, {"C": c_new, "n": n_new, "m": m_new}


def mlstm_state_spec(cfg: ArchConfig, batch: int) -> Tree:
    h = cfg.n_heads
    k = cfg.d_model // h
    return {
        "C": spec([batch, h, k, k], ["batch", "heads", "hdim", "hdim2"],
                  torch.float32, "zeros"),
        "n": spec([batch, h, k], ["batch", "heads", "hdim"], torch.float32,
                  "zeros"),
        "m": spec([batch, h], ["batch", "heads"], torch.float32, "zeros"),
    }


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory with block-diagonal recurrence)
# ---------------------------------------------------------------------------

def slstm_specs(cfg: ArchConfig) -> Tree:
    d, h = cfg.d_model, cfg.n_heads
    k = d // h
    dt = cfg.param_dtype
    gates = {}
    for g in ("z", "i", "f", "o"):
        gates[f"w_{g}"] = spec([d, h, k], ["embed", "heads", "hdim"], dt)
        gates[f"r_{g}"] = spec([h, k, k], ["heads", "hdim", "hdim2"], dt)
        gates[f"b_{g}"] = spec([h, k], ["heads", "hdim"], dt, "zeros")
    gates["wo"] = spec([h, k, d], ["heads", "hdim", "embed"], dt)
    return gates


def _slstm_cell(p: Tree, xt: torch.Tensor, st: Dict[str, torch.Tensor]
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One sLSTM timestep.  xt: [B,D]; state h,c,n,m: [B,H,K] float32."""
    hp = st["h"]

    def gate(g):
        wx = torch.einsum("bd,dhk->bhk", xt, p[f"w_{g}"]).float()
        rh = torch.einsum("bhj,hjk->bhk", hp, p[f"r_{g}"].float())
        return wx + rh + p[f"b_{g}"].float()

    z = torch.tanh(gate("z"))
    log_i = gate("i")                      # exponential input gate
    log_f = F.logsigmoid(gate("f"))
    o = torch.sigmoid(gate("o"))
    m_new = torch.maximum(log_f + st["m"], log_i)
    i_sc = torch.exp(log_i - m_new)
    f_sc = torch.exp(log_f + st["m"] - m_new)
    c_new = f_sc * st["c"] + i_sc * z
    n_new = torch.clamp_min(f_sc * st["n"] + i_sc, 1e-6)
    h_new = o * c_new / n_new
    return h_new, {"h": h_new, "c": c_new, "n": n_new, "m": m_new}


def slstm_sequence(p: Tree, x: torch.Tensor, *, cfg: ArchConfig,
                   state: Optional[Dict[str, torch.Tensor]] = None
                   ) -> Tuple[torch.Tensor,
                              Optional[Dict[str, torch.Tensor]]]:
    """The cell stepped over time (prefill, or the training forward
    without a state, where ``n`` starts at 1e-6).  x: [B,S,D]."""
    b = x.shape[0]
    h, k = cfg.n_heads, cfg.d_model // cfg.n_heads
    st = state
    if st is None:
        z = torch.zeros((b, h, k), dtype=torch.float32, device=x.device)
        st = {"h": z, "c": z, "n": z + 1e-6, "m": z}
    st = {n: v.float() for n, v in st.items()}
    hs = []
    for t in range(x.shape[1]):
        h_new, st = _slstm_cell(p, x[:, t], st)
        hs.append(h_new)
    hs = torch.stack(hs, dim=1).to(x.dtype)               # [B,S,H,K]
    y = torch.einsum("bshk,hkd->bsd", hs, p["wo"])
    new_state = None
    if state is not None:
        new_state = {n: v.to(state[n].dtype) for n, v in st.items()}
    return y, new_state


def slstm_step(p: Tree, x: torch.Tensor, state: Dict[str, torch.Tensor],
               *, cfg: ArchConfig
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One decode step.  x: [B,1,D]."""
    st = {n: v.float() for n, v in state.items()}
    h_new, st_new = _slstm_cell(p, x[:, 0], st)
    y = torch.einsum("bhk,hkd->bd", h_new.to(x.dtype), p["wo"])
    return y[:, None, :], {n: v.to(state[n].dtype)
                           for n, v in st_new.items()}


def slstm_state_spec(cfg: ArchConfig, batch: int) -> Tree:
    h, k = cfg.n_heads, cfg.d_model // cfg.n_heads

    def mk(init):
        return spec([batch, h, k], ["batch", "heads", "hdim"],
                    torch.float32, init)
    return {"h": mk("zeros"), "c": mk("zeros"), "n": mk("ones"),
            "m": mk("zeros")}
