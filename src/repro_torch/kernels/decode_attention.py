"""Launch wrapper of the CUDA decode attention kernel in
``csrc/decode_attention.cu`` (the port of the Pallas kernel
``repro/kernels/decode_attention.py``): split-KV over the card's SMs.

``plan`` cuts the cache axis into splits of whole 64-key tiles from the
shapes alone (never from ``length``, which lies on the card: reading it
would synchronise the stream).  With one split the kernel writes the
output itself (route ``"single"``); with more, each block writes its
partial softmax state to float32 scratch allocated here and a combine
pass sums the splits in split order (route ``"split"``), so repeated
calls are bit-equal.  The arithmetic is fixed by dtype and head dim
(``tensor_cores``): bf16 at D in {64, 128, 256} runs ``mma.sync`` tiles
fed by 16-byte ``cp.async`` loads (a view those cannot take is refused,
``vec16_check``), float32 and other D run FP32 FMAs.

Same contract as ``kernels/flash_attention.py``: CUDA tensors only
(``kernels/ops.py`` routes CPU tensors to ``ref.decode_attention_ref``),
checked, passed by strides, launched on the current stream without
synchronising, raising on a CUDA error, and counted: one in
``LAUNCHES["decode_attention"]`` per call, whether it launches one CUDA
kernel or two, and one in ``ROUTES[route]``.  A fake tensor takes the
fake branch of ``kernels/flash_attention.py`` (``FAKE``), planned for
an H100 SXM's ``FAKE_SMS``.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, NamedTuple, Sequence, Tuple

import torch

from repro_torch.kernels.flash_attention import (FakeTally, c_fn, check,
                                                 check_16b, is_fake,
                                                 launch)

# kernel launches since the last reset (ops.reset_launches), and which
# route each took
LAUNCHES: Dict[str, int] = {"decode_attention": 0}
ROUTES: Dict[str, int] = {"split": 0, "single": 0}
FAKE = FakeTally(LAUNCHES, ROUTES)
FAKE_SMS = 132             # an H100 SXM's SMs: the plan of a fake launch

TILE = 64                  # keys a tile; a split is whole tiles
ROWS = 16                  # query heads a block on the tensor-core route
TC_HEAD_DIMS = (64, 128, 256)
STAGES = 3                 # tiles of K and V in flight a block
SMEM_PER_SM = 228 * 1024   # Hopper's shared memory an SM

_P = ctypes.c_void_p
_I = ctypes.c_int
# (dtype, tc, q, k, v, length, out, part_acc, part_ml, B, H, Hkv, T, D,
# splits, chunk, scale, softcap, strides, stream)
_SIG = [_I, _I, _P, _P, _P, _P, _P, _P, _P] + [_I] * 7 + \
    [ctypes.c_float, ctypes.c_float, _P, _P]


class Plan(NamedTuple):
    splits: int     # blocks along the cache axis
    chunk: int      # keys a split: a multiple of TILE, splits * chunk >= T


def tensor_cores(dtype: torch.dtype, head_dim: int) -> bool:
    """Whether a decode of this dtype and head dim runs on the tensor
    cores (bf16 ``mma.sync``); float32 never does (no TF32)."""
    return dtype == torch.bfloat16 and head_dim in TC_HEAD_DIMS


def plan(b: int, h: int, hkv: int, t: int, d: int, sms: int = 132) -> Plan:
    """The split of a [B, Hkv, T, D] cache for ``sms`` SMs: enough splits
    that the grid holds about as many blocks as the card keeps resident
    (two an SM where a block's ring of K/V tiles leaves room for two),
    each split whole tiles, and no split empty.  Uses the shapes alone."""
    smem = (STAGES * 2 * TILE + ROWS) * d * 2       # bf16 ring and queries
    per_sm = max(1, min(2, SMEM_PER_SM // smem))
    blocks = b * hkv * -(-(h // hkv) // ROWS)
    return cut(t, -(-per_sm * sms // blocks))


def cut(t: int, splits: int) -> Plan:
    """A cache of ``t`` rows cut into at most ``splits`` splits of whole
    tiles, as even as the tiles allow and none empty (``plan``'s cut)."""
    tiles = max(1, -(-t // TILE))
    per = -(-tiles // max(1, min(splits, tiles)))
    return Plan(-(-tiles // per), per * TILE)


@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def work(b: int, h: int, hkv: int, n: int, d: int,
         itemsize: int = 2) -> Tuple[int, int]:
    """(operations, bytes) of a decode over ``n`` valid cache rows, the
    yardstick of the kernel table's bound: 4 D operations a (head, row),
    q and out once each and the n rows of k and v."""
    return 4 * b * h * n * d, (2 * b * h * d + 2 * b * hkv * n * d) * itemsize


def vec16_check(ts: Sequence[torch.Tensor], names: Sequence[str]) -> None:
    """Raise unless every tensor can be read by the tensor-core route's
    16-byte ``cp.async`` loads as it lies (``check_16b``)."""
    check_16b(ts, names, "decode_attention: the tensor-core route reads "
              "by 16-byte cp.async loads")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length, *, softcap=None) -> torch.Tensor:
    """q: [B,H,D]; k, v: [B,Hkv,T,D] (any strides with a unit-stride D),
    float32 or bfloat16 alike; ``length``: an int or a [B] integer
    tensor, the valid cache rows of each batch row (rows >= length are
    masked and never read; a row with none attends to nothing and gives
    0); ``softcap`` c caps each scaled score s at c tanh(s / c) before
    the mask.  Returns [B,H,D] in q's dtype."""
    code = check("decode_attention", (q, k, v), ("q", "k", "v"), (3, 4, 4))
    if softcap is not None and not softcap > 0:
        raise ValueError(f"decode_attention: softcap must be positive or "
                         f"None, got {softcap}")
    b, h, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t, d) or v.shape != k.shape:
        raise ValueError(f"decode_attention: k and v must be [B,Hkv,T,D] "
                         f"for q {tuple(q.shape)}, got {tuple(k.shape)} and "
                         f"{tuple(v.shape)}")
    if hkv == 0 or h % hkv:
        raise ValueError(f"decode_attention: {h} query heads do not group "
                         f"over {hkv} kv heads")
    # the rows a fake launch reads: an int length's, else the whole cache
    # (a fake length has no value)
    rows = min(int(length), t) if isinstance(length, int) else t
    length = torch.as_tensor(length, device=q.device)
    if length.is_floating_point() or length.is_complex():
        raise TypeError(f"decode_attention: length must be integer, got "
                        f"{length.dtype}")
    length = length.to(torch.int32).expand(b).contiguous()
    tc = tensor_cores(q.dtype, d)
    if tc:
        vec16_check((k, v), ("k", "v"))
    out = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    pl = plan(b, h, hkv, t, d, FAKE_SMS if is_fake(q) else _sms(q.device))
    acc = ml = None
    if pl.splits > 1:
        acc = torch.empty((b, h, pl.splits, d), dtype=torch.float32,
                          device=q.device)
        ml = torch.empty((b, h, pl.splits, 2), dtype=torch.float32,
                         device=q.device)
    if is_fake(q):
        FAKE.add("decode_attention", "split" if pl.splits > 1 else "single",
                 work(b, h, hkv, rows, d, q.element_size()))
        return out
    strides = [*q.stride(), *k.stride(), *v.stride(), *out.stride()]
    launch("decode_attention", c_fn("decode_attention",
                                    "decode_attention_fwd", _SIG),
           q.device, strides, code, int(tc), q.data_ptr(), k.data_ptr(),
           v.data_ptr(), length.data_ptr(), out.data_ptr(),
           acc.data_ptr() if acc is not None else None,
           ml.data_ptr() if ml is not None else None, b, h, hkv, t, d,
           pl.splits, pl.chunk, 1.0 / math.sqrt(d), float(softcap or 0.0))
    LAUNCHES["decode_attention"] += 1
    ROUTES["split" if pl.splits > 1 else "single"] += 1
    return out
