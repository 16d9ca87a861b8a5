"""Launch wrapper of the CUDA RG-LRU scan kernels in ``csrc/rglru_scan.cu``
(the port of the Pallas kernel ``repro/kernels/rglru_scan.py``), on two
routes fixed by S alone (``route``), never by a failure:

* ``"serial"`` (S < 2 * CHUNK): one thread a channel walks S; the
  launcher's 3-token prefills and 1-token decode steps take it;
* ``"chunked"``: chunks of CHUNK steps over many blocks with a look-back
  carry, for long prompts.  It needs scratch (``scratch_words``), kept
  here per (device, stream) and zeroed once when allocated: the kernel's
  flags carry a per-call epoch and its ticket counter resets itself, so
  no memset runs between calls.

Same contract as the attention wrappers: CUDA tensors only
(``kernels/ops.py`` routes CPU tensors to ``ref.rglru_scan_ref``),
checked, passed by strides, launched on the current stream without
synchronising, raising on a CUDA error, and counted: one in
``LAUNCHES["rglru_scan"]`` and one in ``ROUTES[route]`` per call.

``RGLRUScan`` is the scan with a gradient (``ops.rglru_scan`` on the
card): an autograd function whose backward is this kernel too, run on
the flipped, one-step-shifted decays and the incoming gradient
(``ref.rglru_scan_backward``), so a training step launches the kernel
in the forward and once more in the backward, on the same route.
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import (FakeTally, c_fn, is_fake,
                                                 launch)

# kernel launches since the last reset (ops.reset_launches), and which
# route each took
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}
ROUTES: Dict[str, int] = {"chunked": 0, "serial": 0}
FAKE = FakeTally(LAUNCHES, ROUTES)

CHUNK = 32                 # time steps a chunk of the chunked kernel
THREADS = 128              # channels a block

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _P, ctypes.c_longlong, _P, _P]

# (device, stream) -> zeroed int32 scratch of the chunked kernel
_SCRATCH: Dict[Tuple[torch.device, int], torch.Tensor] = {}


def route(s: int) -> str:
    """The kernel that takes a scan of ``s`` time steps."""
    return "chunked" if s >= 2 * CHUNK else "serial"


def _align(words: int) -> int:
    return -(-words // 32) * 32


def scratch_words(b: int, s: int, w: int) -> int:
    """32-bit words of scratch the chunked kernel needs for [B,S,W]: the
    ticket (32 words), then per (b, chunk) the flags of each 128-channel
    block (2 words), the aggregates (2 floats a channel) and the last
    state (1 float a channel), each part 128-byte aligned
    (``layout`` in ``csrc/rglru_scan.cu``, which refuses less)."""
    bc = b * -(-s // CHUNK)
    return 32 + _align(2 * bc * -(-w // THREADS)) + _align(2 * bc * w) + \
        _align(bc * w)


def work(b: int, s: int, w: int, itemsize: int = 4) -> Tuple[int, int]:
    """(operations, bytes) of a scan, the yardstick of the kernel table's
    bound: a multiply and an add a step, a and b read and h written
    once, h0 read in float32."""
    return 2 * b * s * w, 3 * b * s * w * itemsize + 4 * b * w


def _fake_scratch(like: torch.Tensor, words: int) -> torch.Tensor:
    """``scratch`` for a fake launch: kept in ``FAKE`` for the trace."""
    if FAKE.scratch is None or FAKE.scratch.numel() < words:
        FAKE.scratch = torch.zeros(words, dtype=torch.int32,
                                   device=like.device)
    return FAKE.scratch


def scratch(device: torch.device, words: int) -> torch.Tensor:
    """This stream's scratch of at least ``words`` words (zeroed when
    allocated; replaced by a larger one when too small)."""
    key = (device, torch.cuda.current_stream(device).cuda_stream)
    buf = _SCRATCH.get(key)
    if buf is None or buf.numel() < words:
        buf = _SCRATCH[key] = torch.zeros(words, dtype=torch.int32,
                                          device=device)
    return buf


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b: [B,S,W], float32 or bfloat16 alike, any strides with a
    unit-stride W; h0: [B,W] in any float dtype (the state is float32).
    Returns h: [B,S,W] in a's dtype, ``h_t = a_t * h_{t-1} + b_t``."""
    if a.device.type != "cuda" and not is_fake(a):
        raise ValueError(f"rglru_scan: expected a tensor on a CUDA device, "
                         f"got {a.device}")
    if a.dtype not in _DTYPES:
        raise TypeError(f"rglru_scan: expected float32 or bfloat16, got "
                        f"{a.dtype}")
    if b.device != a.device or b.dtype != a.dtype:
        raise ValueError(f"rglru_scan: b must be {a.dtype} on {a.device}, "
                         f"got {b.dtype} on {b.device}")
    if a.dim() != 3 or b.shape != a.shape:
        raise ValueError(f"rglru_scan: a and b must be one [B,S,W] shape, "
                         f"got {tuple(a.shape)} and {tuple(b.shape)}")
    bsz, s, w = a.shape
    if h0.shape != (bsz, w) or h0.device != a.device or \
            not h0.is_floating_point():
        raise ValueError(f"rglru_scan: h0 must be a float [B,W] = "
                         f"{(bsz, w)} tensor on {a.device}, got "
                         f"{h0.dtype} {tuple(h0.shape)} on {h0.device}")
    if a.stride(-1) != 1 or b.stride(-1) != 1:
        raise ValueError("rglru_scan: a and b must have a unit-stride W")
    way = route(s)
    out = torch.empty((bsz, s, w), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    h0 = h0.to(torch.float32).contiguous()
    words = scratch_words(bsz, s, w) if way == "chunked" else 0
    if is_fake(a):
        if words:
            _fake_scratch(a, words)
        FAKE.add("rglru_scan", way, work(bsz, s, w, a.element_size()))
        return out
    buf = scratch(a.device, words) if words else None
    strides = [*a.stride()[:2], *b.stride()[:2], *out.stride()[:2]]
    launch("rglru_scan", c_fn("rglru_scan", "rglru_scan_fwd", _SIG),
           a.device, strides, _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
           h0.data_ptr(), out.data_ptr(), bsz, s, w, int(way == "chunked"),
           buf.data_ptr() if buf is not None else None,
           buf.numel() if buf is not None else 0)
    LAUNCHES["rglru_scan"] += 1
    ROUTES[way] += 1
    return out


class RGLRUScan(torch.autograd.Function):
    """``apply(a, b, h0)``: the kernel in both passes, the forward scan
    and the adjoint scan of ``ref.rglru_scan_backward``; saves a, h0
    and h."""

    @staticmethod
    def forward(ctx, a, b, h0):
        h = rglru_scan(a, b, h0)
        ctx.save_for_backward(a, h0, h)
        ctx.b_dtype = b.dtype
        return h

    @staticmethod
    def backward(ctx, grad):
        a, h0, h = ctx.saved_tensors
        da, db, dh0 = ref.rglru_scan_backward(a, h, h0, grad.to(a.dtype),
                                              scan=rglru_scan)
        need_a, need_b, need_h0 = ctx.needs_input_grad
        return (da if need_a else None,
                db.to(ctx.b_dtype) if need_b else None,
                dh0 if need_h0 else None)
