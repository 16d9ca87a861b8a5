"""Launch wrapper of the CUDA decode attention kernel in
``csrc/decode_attention.cu`` (the port of the Pallas kernel
``repro/kernels/decode_attention.py``).

Same contract as ``kernels/flash_attention.py``: CUDA tensors only
(``kernels/ops.py`` routes CPU tensors to ``ref.decode_attention_ref``),
checked, passed by strides, launched on the current stream without
synchronising, raising on a CUDA error, and counted in
``LAUNCHES["decode_attention"]``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Dict

import torch

from repro_torch.kernels.flash_attention import c_fn, check, launch

# kernel launches since the last reset (ops.reset_launches)
LAUNCHES: Dict[str, int] = {"decode_attention": 0}

_P = ctypes.c_void_p
_I = ctypes.c_int
_SIG = [_I, _P, _P, _P, _P, _P] + [_I] * 5 + [ctypes.c_float, _P, _P]


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length) -> torch.Tensor:
    """q: [B,H,D]; k, v: [B,Hkv,T,D] (any strides with a unit-stride D),
    float32 or bfloat16 alike; ``length``: an int or a [B] integer
    tensor, the valid cache rows of each batch row (rows >= length are
    masked, and the kernel reads none past its last valid chunk).
    Returns [B,H,D] in q's dtype."""
    code = check("decode_attention", (q, k, v), ("q", "k", "v"), (3, 4, 4))
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k and v must be [B,Hkv,T,D] "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"decode_attention: {h} query heads do not group "
                         f"over {hkv} kv heads")
    length = torch.as_tensor(length, device=q.device)
    if length.is_floating_point() or length.is_complex():
        raise TypeError(f"decode_attention: length must be integer, got "
                        f"{length.dtype}")
    length = length.to(torch.int32).expand(b).contiguous()
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = [*q.stride(), *k.stride(), *v.stride(), *out.stride()]
    launch("decode_attention", c_fn("decode_attention",
                                    "decode_attention_fwd", _SIG),
           q.device, strides, code, q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length.data_ptr(), out.data_ptr(), b, h, hkv, t, d,
           1.0 / math.sqrt(d))
    LAUNCHES["decode_attention"] += 1
    return out
