"""Launch wrapper of the CUDA RG-LRU scan kernel in ``csrc/rglru_scan.cu``
(the port of the Pallas kernel ``repro/kernels/rglru_scan.py``).

Same contract as the attention wrappers: CUDA tensors only
(``kernels/ops.py`` routes CPU tensors to ``ref.rglru_scan_ref``),
checked, passed by strides, launched on the current stream without
synchronising, raising on a CUDA error, and counted in
``LAUNCHES["rglru_scan"]``.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from repro_torch.kernels.flash_attention import c_fn, launch

# kernel launches since the last reset (ops.reset_launches)
LAUNCHES: Dict[str, int] = {"rglru_scan": 0}

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_I, _P, _P, _P, _P, _I, _I, _I, _P, _P]


def rglru_scan(a: torch.Tensor, b: torch.Tensor,
               h0: torch.Tensor) -> torch.Tensor:
    """a, b: [B,S,W], float32 or bfloat16 alike, any strides with a
    unit-stride W; h0: [B,W] in any float dtype (the state is float32).
    Returns h: [B,S,W] in a's dtype, ``h_t = a_t * h_{t-1} + b_t``."""
    if a.device.type != "cuda":
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
    out = torch.empty((bsz, s, w), dtype=a.dtype, device=a.device)
    if out.numel() == 0:
        return out
    h0 = h0.to(torch.float32).contiguous()
    strides = [*a.stride()[:2], *b.stride()[:2], *out.stride()[:2]]
    launch("rglru_scan", c_fn("rglru_scan", "rglru_scan_fwd", _SIG),
           a.device, strides, _DTYPES[a.dtype], a.data_ptr(), b.data_ptr(),
           h0.data_ptr(), out.data_ptr(), bsz, s, w)
    LAUNCHES["rglru_scan"] += 1
    return out
