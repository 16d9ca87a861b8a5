"""Launch wrapper of the CUDA prefill attention kernels (the port of the
Pallas kernel ``repro/kernels/flash_attention.py``), on three routes
fixed by dtype and head dim (``route``), never by a failure:

* ``"sm90"``: bfloat16 with D in {32, 64, 128, 256},
  ``csrc/flash_attention_sm90.cu`` -- wgmma tensor-core tiles fed by TMA.
  TMA needs 16-byte aligned bases and strides that are multiples of 8
  elements; a view that breaks that is refused (``tma_check``), never
  copied.
* ``"f32tc"``: float32 with D in {32, 64, 128, 256},
  ``csrc/flash_attention_f32.cu`` -- mma.sync tensor-core tiles at float32
  accuracy (three TF32 products a float32 product, never one: float32
  must not round through TF32), K / V staged by cp.async.  It also
  writes each row's log-sum-exp (``flash_attention_lse``) for its
  backward kernel.  Rows are copied in 16-byte pieces, so q, k and v
  need 16-byte aligned bases and strides that are multiples of 4
  elements (``check_16b`` refuses the rest).
* ``"simt"``: every other head dim, in either dtype,
  ``csrc/flash_attention.cu`` -- float32 FMAs.

Every route takes a logit ``softcap`` (the reference's ``c tanh(s / c)``
on the scaled scores, before the mask) and a ``q_offset`` (query row i
at position ``q_offset + i``: a chunk of a prompt against the cache rows
before it); the f32tc backward takes the softcap and no offset.

The wrapper takes CUDA tensors only (``kernels/ops.py`` routes CPU
tensors to ``ref.flash_attention_ref``), checks device, dtype, shape and
the unit stride of the head dim, hands the kernel every other stride (so
permuted views need no copy), allocates the output with
``torch.empty_like(q)`` (same layout as q), launches on the current
stream without synchronising, raises if the launch returns an error, and
adds one to ``LAUNCHES["flash_attention"]`` and one to ``ROUTES[route]``
per launch.

``FlashAttention`` is the kernel with a gradient (``ops.flash_attention``
on the card).  On the f32tc route its forward is ``flash_attention_lse``
and its backward ``flash_attention_bwd``: the hand-written deterministic
FlashAttention-2 backward (``csrc/flash_attention_f32_bwd.cu``, three
launches, no float atomics, so two calls are bit-equal), which adds one
to ``LAUNCHES["flash_attention_bwd"]`` a call and holds no [B,H,S,T]
tensor.  On the sm90 and simt routes the forward is the kernel and the
backward recomputes the plain version (``ref.flash_attention_ref``) from
the saved q, k, v and differentiates it: that holds the [B,H,S,T]
float32 scores and softmax weights and their gradients for the duration
of the backward (1.9 GB each at B = 1, H = 28, S = T = 4,096) and
launches no kernel.  The Pallas kernel has no backward (the reference
trains through plain jnp attention), so neither backward is a port.  A
gradient at ``q_offset > 0`` raises on every route (no entry point of
the reference trains at an offset).  There is no fallback: a failure
raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict, Optional, Sequence

import torch

from repro_torch.kernels import _build, ref

# kernel launches since the last reset (ops.reset_launches), and which
# route each took
LAUNCHES: Dict[str, int] = {"flash_attention": 0, "flash_attention_bwd": 0}
ROUTES: Dict[str, int] = {"sm90": 0, "f32tc": 0, "simt": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# (dtype, q, k, v, out, B, H, Hkv, S, T, D, causal, window, q_offset,
# scale, softcap, strides, stream)
_SIG = [_I, _P, _P, _P, _P] + [_I] * 9 + [_F, _F, _P, _P]
# route -> (library, C entry point); both take _SIG
ENTRY = {"sm90": ("flash_attention_sm90", "flash_attention_sm90_fwd"),
         "simt": ("flash_attention", "flash_attention_fwd")}
# the f32tc kernels: forward (q, k, v, out, lse, 6 ints, causal, window,
# q_offset, scale, softcap) and backward (q, k, v, out, lse, dout, delta,
# dq, dk, dv, 6 ints, causal, window, scale, softcap)
F32_FWD = ("flash_attention_f32", "flash_attention_f32_fwd")
F32_BWD = ("flash_attention_f32_bwd", "flash_attention_f32_bwd")
_F32_FWD_SIG = [_P] * 5 + [_I] * 9 + [_F, _F, _P, _P]
_F32_BWD_SIG = [_P] * 10 + [_I] * 8 + [_F, _F, _P, _P]
TC_HEAD_DIMS = (32, 64, 128, 256)     # the sm90 and f32tc routes


def route(dtype: torch.dtype, head_dim: int) -> str:
    """The kernel that takes a prefill of this dtype and head dim."""
    if head_dim in TC_HEAD_DIMS:
        if dtype == torch.bfloat16:
            return "sm90"
        if dtype == torch.float32:
            return "f32tc"
    return "simt"


def check_16b(ts: Sequence[torch.Tensor], names: Sequence[str],
              reader: str) -> None:
    """Raise unless every tensor can be read in 16-byte pieces as it lies:
    a 16-byte aligned base and, in every dimension longer than 1 but the
    last (unit-stride) one, a stride that is a whole number of 16 bytes.
    ``reader`` names the kernel and the loads, for the message."""
    for t, nm in zip(ts, names):
        per = 16 // t.element_size()
        bad = [st for st, n in zip(t.stride()[:-1], t.shape[:-1])
               if n > 1 and st % per]
        if t.data_ptr() % 16 or bad:
            raise ValueError(
                f"{reader} {nm}, which needs a 16-byte aligned base and "
                f"strides that are multiples of {per} elements; got base "
                f"offset {t.data_ptr() % 16} B, strides {t.stride()}")


def tma_check(ts: Sequence[torch.Tensor], names: Sequence[str]) -> None:
    """Raise unless every (bf16) tensor can be read by TMA as it lies."""
    check_16b(ts, names, "flash_attention: the sm90 route reads by TMA")


def c_fn(lib: str, name: str, argtypes):
    fn = getattr(_build.load(lib), name)
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(op: str, ts: Sequence[torch.Tensor], names: Sequence[str],
          ndims: Sequence[int]) -> int:
    """Common checks of the attention wrappers; returns the dtype code."""
    dev = ts[0].device
    if dev.type != "cuda":
        raise ValueError(f"{op}: expected a tensor on a CUDA device, got "
                         f"{dev}")
    if ts[0].dtype not in _DTYPES:
        raise TypeError(f"{op}: expected float32 or bfloat16, got "
                        f"{ts[0].dtype}")
    for t, nm, nd in zip(ts, names, ndims):
        if t.device != dev or t.dtype != ts[0].dtype:
            raise ValueError(f"{op}: {nm} must be {ts[0].dtype} on {dev}, "
                             f"got {t.dtype} on {t.device}")
        if t.dim() != nd:
            raise ValueError(f"{op}: {nm} must be {nd}-D, got shape "
                             f"{tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"{op}: {nm} must have a unit-stride head dim")
        # k and v rows are read as 4-element vectors
        if nm in ("k", "v") and (t.data_ptr() % (4 * t.element_size()) or
                                 any(x % 4 for x in t.stride()[:-1])):
            raise ValueError(f"{op}: {nm} rows must start 4-element "
                             f"aligned (strides {t.stride()})")
    d = ts[0].shape[-1]
    if d % 4 or not 0 < d <= MAX_HEAD_DIM:
        raise ValueError(f"{op}: head dim {d} must be a positive multiple "
                         f"of 4 up to {MAX_HEAD_DIM}")
    return _DTYPES[ts[0].dtype]


def launch(op: str, fn, device: torch.device, strides: Sequence[int],
           *args) -> None:
    """Call the C entry point ``fn(*args, strides, stream)`` on the
    current stream of ``device``; raise on a CUDA error."""
    arr = (ctypes.c_longlong * len(strides))(*strides)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, arr, stream)
    if rc != 0:
        raise RuntimeError(f"{op}: launch failed with error {rc} (a CUDA "
                           f"error below 10000; see the kernel's source "
                           f"for the others)")


def _check_shapes(q, k, v, window, softcap=None, q_offset=0) -> int:
    """The checks common to the forwards and the backward; returns the
    dtype code."""
    code = check("flash_attention", (q, k, v), ("q", "k", "v"), (4, 4, 4))
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"flash_attention: k and v must be [B,Hkv,T,D] "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {hkv} kv heads")
    if window is not None and window <= 0:
        raise ValueError(f"flash_attention: window must be positive, got "
                         f"{window}")
    if softcap is not None and not softcap > 0:
        raise ValueError(f"flash_attention: softcap must be positive or "
                         f"None, got {softcap}")
    if int(q_offset) != q_offset or q_offset < 0:
        raise ValueError(f"flash_attention: q_offset must be an int >= 0, "
                         f"got {q_offset}")
    return code


def _like(q: torch.Tensor) -> torch.Tensor:
    """An empty tensor of q's shape and layout with a unit-stride last
    dim."""
    out = torch.empty_like(q)
    if out.stride(-1) != 1:
        out = torch.empty_like(q, memory_format=torch.contiguous_format)
    return out


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    q_offset: int = 0) -> torch.Tensor:
    """q: [B,H,S,D]; k, v: [B,Hkv,T,D], float32 or bfloat16 alike, any
    strides with a unit-stride D.  Query row i sits at position
    ``q_offset + i`` and key row j at position j; ``causal`` masks
    j > q_offset + i, ``window`` masks q_offset + i - j >= window;
    ``softcap`` c caps each scaled score s at c tanh(s / c) before the
    mask.  Returns [B,H,S,D] in q's dtype and layout."""
    way = route(q.dtype, q.shape[-1])
    if way == "f32tc":
        return flash_attention_lse(q, k, v, causal=causal, window=window,
                                   softcap=softcap, q_offset=q_offset)[0]
    code = _check_shapes(q, k, v, window, softcap, q_offset)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    out = _like(q)
    if out.numel() == 0:
        return out
    if t == 0:
        return out.zero_()
    if way == "sm90":
        tma_check((q, k, v), ("q", "k", "v"))
    strides = [*q.stride(), *k.stride(), *v.stride(), *out.stride()]
    launch("flash_attention", c_fn(*ENTRY[way], _SIG), q.device, strides,
           code, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           b, h, hkv, s, t, d, int(causal), int(window or 0), int(q_offset),
           1.0 / math.sqrt(d), float(softcap or 0.0))
    LAUNCHES["flash_attention"] += 1
    ROUTES[way] += 1
    return out


def flash_attention_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None,
                        q_offset: int = 0):
    """The f32tc route's forward (float32, D in TC_HEAD_DIMS): (out, lse)
    with out as ``flash_attention`` and lse [B,H,S] float32 the natural
    log-sum-exp of each row's scaled, capped, masked scores (-inf, and an
    output of 0, for a row that sees no key)."""
    _check_shapes(q, k, v, window, softcap, q_offset)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if route(q.dtype, d) != "f32tc":
        raise ValueError(f"flash_attention_lse: takes float32 with D in "
                         f"{TC_HEAD_DIMS}, got {q.dtype}, D = {d}")
    check_16b((q, k, v), ("q", "k", "v"),
              "flash_attention: the f32tc route copies 16-byte pieces of")
    out = _like(q)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    if out.numel() == 0:
        return out, lse
    if t == 0:
        return out.zero_(), lse.fill_(-math.inf)
    strides = [*q.stride(), *k.stride(), *v.stride(), *out.stride()]
    launch("flash_attention", c_fn(*F32_FWD, _F32_FWD_SIG), q.device,
           strides, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), b, h, hkv, s, t, d, int(causal),
           int(window or 0), int(q_offset), 1.0 / math.sqrt(d),
           float(softcap or 0.0))
    LAUNCHES["flash_attention"] += 1
    ROUTES["f32tc"] += 1
    return out, lse


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t itself if its rows can be copied in 16-byte pieces, else a
    contiguous copy (an incoming gradient may be expanded or strided)."""
    per = 16 // t.element_size()
    if t.stride(-1) == 1 and t.data_ptr() % 16 == 0 and not any(
            st % per for st, n in zip(t.stride()[:-1], t.shape[:-1])
            if n > 1):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None,
                        softcap: Optional[float] = None):
    """The f32tc route's backward: (dq, dk, dv) of ``flash_attention_lse``
    (at ``q_offset`` 0, with the same ``softcap``) given its (out, lse)
    and the gradient ``dout`` of out; dq in q's layout, dk and dv
    contiguous [B,Hkv,T,D] (summed over each kv head's query heads).
    Deterministic: no float atomics."""
    _check_shapes(q, k, v, window, softcap)
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if route(q.dtype, d) != "f32tc":
        raise ValueError(f"flash_attention_bwd: takes float32 with D in "
                         f"{TC_HEAD_DIMS}, got {q.dtype}, D = {d}")
    if out.shape != q.shape or dout.shape != q.shape or \
            lse.shape != (b, h, s):
        raise ValueError(f"flash_attention_bwd: out and dout must be "
                         f"{tuple(q.shape)} and lse {(b, h, s)}, got "
                         f"{tuple(out.shape)}, {tuple(dout.shape)} and "
                         f"{tuple(lse.shape)}")
    dout, lse = _rows16(dout), lse.contiguous()
    check("flash_attention_bwd", (q, out, dout, lse), ("q", "out", "dout",
                                                       "lse"), (4, 4, 4, 3))
    check_16b((q, k, v, out), ("q", "k", "v", "out"),
              "flash_attention_bwd copies 16-byte pieces of")
    dq = _like(q)
    dk = torch.empty((b, hkv, t, d), dtype=q.dtype, device=q.device)
    dv = torch.empty_like(dk)
    if dq.numel() == 0 or t == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = [*q.stride(), *k.stride(), *v.stride(), *out.stride(),
               *dout.stride(), *dq.stride()]
    launch("flash_attention_bwd", c_fn(*F32_BWD, _F32_BWD_SIG), q.device,
           strides, q.data_ptr(), k.data_ptr(), v.data_ptr(),
           out.data_ptr(), lse.data_ptr(), dout.data_ptr(),
           delta.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(),
           b, h, hkv, s, t, d, int(causal), int(window or 0),
           1.0 / math.sqrt(d), float(softcap or 0.0))
    LAUNCHES["flash_attention_bwd"] += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """``apply(q, k, v, causal, window, softcap=None, q_offset=0)``: on
    the f32tc route the kernel's forward (saving out and lse) and the
    backward kernel; on the others the kernel's forward and the plain
    version's gradient (recomputed from the saved q, k, v).  A gradient
    at ``q_offset > 0`` raises on every route."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, softcap=None, q_offset=0):
        ctx.causal, ctx.window = causal, window
        ctx.softcap, ctx.q_offset = softcap, q_offset
        kw = dict(causal=causal, window=window, softcap=softcap,
                  q_offset=q_offset)
        if route(q.dtype, q.shape[-1]) == "f32tc":
            out, lse = flash_attention_lse(q, k, v, **kw)
            ctx.save_for_backward(q, k, v, out, lse)
            return out
        ctx.save_for_backward(q, k, v)
        return flash_attention(q, k, v, **kw)

    @staticmethod
    def backward(ctx, grad):
        if ctx.q_offset:
            raise NotImplementedError(
                f"flash_attention: no gradient at q_offset {ctx.q_offset} "
                f"(the backward takes query rows at positions 0..S-1; no "
                f"entry point trains at an offset)")
        need = ctx.needs_input_grad[:3]
        saved = ctx.saved_tensors     # unpacked once (remat allows one)
        kw = dict(causal=ctx.causal, window=ctx.window, softcap=ctx.softcap)
        if len(saved) == 5:
            grads = flash_attention_bwd(*saved, grad, **kw)
            return (*(g if n else None for g, n in zip(grads, need)),
                    None, None, None, None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(n)
                   for t, n in zip(saved, need)]
            out = ref.flash_attention_ref(*ins, **kw)
            grads = iter(torch.autograd.grad(
                out, [t for t, n in zip(ins, need) if n], grad))
        return (*(next(grads) if n else None for n in need), None, None,
                None, None)
