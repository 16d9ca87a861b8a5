"""The split-KV ``decode_attention`` kernel (``csrc/decode_attention.cu``),
as far as the CPU can reach it:

* its algorithm -- the cache axis cut into splits of whole 64-key tiles
  as the wrapper cuts it (``decode_attention.cut``), each an online
  softmax over the tiles with P rounded to the input dtype, combined in
  split order -- as a plain-torch model (``ref.decode_attention_split_ref``)
  against the JAX package's Pallas kernel in interpret mode, on the same
  numpy inputs, at ``DECODE_SHAPES`` x splits {1, 2, 3, 7} x ragged
  lengths (splits wholly past ``length``, and a row of length 0, where
  the Pallas kernel gives 0): 2e-3 in float32, 2e-2 in bfloat16;
* that this check sees the combine: on peaked scores (queries x4) the
  two wrong combines of ``ref.decode_split_faults`` fail it;
* the wrapper's plan (``decode_attention.plan``): one split at the
  launcher's 48 rows, several at the timed shape, splits of whole tiles
  that cover [0, T) exactly, from the shapes alone;
* what the tensor-core route's 16-byte loads accept (``vec16_check``):
  the model's own decode views at Qwen2.5-7B's and RecurrentGemma-9B's
  heads pass, a view off the 16-byte grid is refused;
* the per-op route counters (``ops.route_counts``).

The kernel itself needs the card; ``chip_smoke.py`` holds it against
``ref.decode_attention_ref`` there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import decode_attention as cuda_decode
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

DECODE_SHAPES = [
    (1, 4, 4, 256, 64),
    (2, 8, 2, 512, 64),
    (4, 8, 1, 1024, 128),
]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _lengths(b, t):
    """Ragged rows: the whole cache, one key, a length 0 row, and a
    length mid-way, so some splits lie wholly past their row's length."""
    pick = [t, 1, 0, t // 3 + 5]
    return np.array(pick[:b] if b > 1 else [t // 3 + 5], np.int32)


def _both(seed, shape, dtype):
    x = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype][1])


@functools.lru_cache(maxsize=None)
def _case(shape, dtype):
    """Inputs and the Pallas kernel's output, once per shape and dtype."""
    b, h, hkv, t, d = shape
    jq, q = _both(0, (b, h, d), dtype)
    jk, k = _both(1, (b, hkv, t, d), dtype)
    jv, v = _both(2, (b, hkv, t, d), dtype)
    lengths = _lengths(b, t)
    want = np.asarray(jops.decode_attention(jq, jk, jv,
                                            jnp.asarray(lengths)),
                      np.float32)
    return q, k, v, torch.from_numpy(lengths), want


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("splits", [1, 2, 3, 7])
def test_split_model_matches_pallas(shape, dtype, splits):
    q, k, v, lengths, want = _case(shape, dtype)
    chunk = cuda_decode.cut(shape[3], splits).chunk
    got = ref.decode_attention_split_ref(q, k, v, lengths, chunk)
    assert got.dtype == q.dtype and got.shape == q.shape
    tol = DTYPES[dtype][2]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)
    # a row of length 0 attends to nothing: exactly 0, as the Pallas kernel
    for i in np.flatnonzero(lengths.numpy() == 0):
        assert float(got[i].float().abs().max()) == 0.0


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_split_model_ignores_entries_past_length(dtype):
    """Garbage past the frontier changes nothing, whatever the split."""
    b, h, hkv, t, d = 1, 4, 2, 256, 64
    _, q = _both(0, (b, h, d), dtype)
    _, k = _both(1, (b, hkv, t, d), dtype)
    _, v = _both(2, (b, hkv, t, d), dtype)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 1e4
    v2[:, :, 100:] = -1e4
    for chunk in (256, 64):
        out1 = ref.decode_attention_split_ref(q, k, v, 100, chunk)
        out2 = ref.decode_attention_split_ref(q, k2, v2, 100, chunk)
        assert torch.equal(out1, out2)


def _within(got, want, tol):
    """The check ``chip_smoke.py`` holds the kernel to:
    |got - want| <= tol + tol |want| everywhere."""
    g, w = got.float(), torch.tensor(want)
    return bool(((g - w).abs() <= tol + tol * w.abs()).all())


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("fault", ["equal weights", "no rescale"])
def test_a_wrong_combine_fails_the_check_on_peaked_scores(shape, dtype,
                                                          fault):
    """Queries x4 make the softmax peaked, so a row's output is its top
    keys' values and the splits weigh very differently: the split model
    passes the check against the Pallas kernel, a wrong combine of the
    same partials does not.  Rows of length 0 (the plain version's NaN)
    are left out, as the card's check compares them with 0 apart."""
    b, h, hkv, t, d = shape
    jq, q = _both(0, (b, h, d), dtype)
    jq, q = jq * 4, q * 4
    jk, k = _both(1, (b, hkv, t, d), dtype)
    jv, v = _both(2, (b, hkv, t, d), dtype)
    lengths = np.maximum(_lengths(b, t), 1)
    want = np.asarray(jops.decode_attention(jq, jk, jv,
                                            jnp.asarray(lengths)),
                      np.float32)
    tol = DTYPES[dtype][2]
    chunk = cuda_decode.cut(t, 4).chunk
    parts = ref.decode_split_partials(q, k, v, torch.from_numpy(lengths),
                                      chunk)
    assert _within(ref.decode_split_combine(*parts, q.dtype), want, tol)
    assert not _within(ref.decode_split_faults(*parts, q.dtype)[fault],
                       want, tol)


@pytest.mark.parametrize("t,splits", [(48, 1), (48, 5), (256, 3),
                                      (257, 4), (4096, 16), (2049, 33),
                                      (2048, 7), (1, 3)])
def test_cut_is_whole_tiles_covering_the_cache(t, splits):
    pl = cuda_decode.cut(t, splits)
    assert pl.chunk % cuda_decode.TILE == 0
    assert 1 <= pl.splits <= splits
    _covers(pl, t)


def _covers(pl, t):
    """The splits' ranges [s * chunk, min((s + 1) * chunk, T)) cover
    [0, T) once each, none empty."""
    ranges = [(s * pl.chunk, min((s + 1) * pl.chunk, t))
              for s in range(pl.splits)]
    assert ranges[0][0] == 0 and ranges[-1][1] == t
    assert all(lo < hi for lo, hi in ranges)
    assert all(x[1] == y[0] for x, y in zip(ranges, ranges[1:]))


@pytest.mark.parametrize("shape", [
    (4, 28, 4, 48, 128),       # the Qwen launcher's decode step
    (4, 16, 1, 48, 256),       # the RecurrentGemma launcher's
    (4, 28, 4, 4096, 128),     # DECODE_TIMED
    (4, 16, 1, 2048, 256),     # RecurrentGemma's decode over its window
    (1, 28, 4, 2049, 128),     # a Qwen step at a 2048-row context
    (1, 4, 4, 256, 64), (2, 8, 2, 512, 64), (4, 8, 1, 1024, 128),
    (2, 8, 2, 100, 64), (1, 28, 4, 65, 128), (3, 56, 8, 131072, 128),
])
def test_plan_splits_cover_the_cache_in_whole_tiles(shape):
    b, h, hkv, t, d = shape
    pl = cuda_decode.plan(b, h, hkv, t, d)
    assert pl.chunk % cuda_decode.TILE == 0 and pl.chunk >= 64
    assert pl.splits * pl.chunk >= t > (pl.splits - 1) * pl.chunk
    _covers(pl, t)
    blocks = b * hkv * -(-(h // hkv) // cuda_decode.ROWS)
    # never more blocks than two an SM
    assert pl.splits == 1 or blocks * pl.splits <= 2 * 132 + blocks


def test_plan_one_split_at_the_launchers_rows_many_at_the_timed_shape():
    assert cuda_decode.plan(4, 28, 4, 48, 128).splits == 1
    assert cuda_decode.plan(4, 16, 1, 48, 256).splits == 1
    timed = cuda_decode.plan(4, 28, 4, 4096, 128)
    assert timed.splits > 1
    # about two blocks an SM at the timed shape (16 (b, kv head) pairs)
    assert 132 <= 16 * timed.splits <= 2 * 132
    assert cuda_decode.plan(4, 16, 1, 2048, 256).splits > 1
    # fewer SMs, fewer splits; the plan reads no tensor
    assert cuda_decode.plan(4, 28, 4, 4096, 128, sms=16).splits < \
        timed.splits


@pytest.mark.parametrize("dtype,d,want", [
    (torch.bfloat16, 64, True), (torch.bfloat16, 128, True),
    (torch.bfloat16, 256, True), (torch.bfloat16, 32, False),
    (torch.bfloat16, 96, False), (torch.float32, 128, False),
    (torch.float32, 256, False),
])
def test_tensor_cores_by_dtype_and_head_dim(dtype, d, want):
    assert cuda_decode.tensor_cores(dtype, d) is want


def _decode_views(arch, off, cache_len):
    """The k, v views ``gqa_attention`` hands ``ops.decode_attention`` in
    a bfloat16 decode step at offset ``off`` at the arch's full width."""
    cfg = get_config(arch)
    g = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(sp.shape, generator=g) * 0.02).to(torch.bfloat16)
         for k, sp in attn.gqa_specs(cfg).items()}
    x = torch.randn((2, 1, cfg.d_model), generator=g).to(torch.bfloat16)
    shape = (2, cache_len, cfg.n_kv_heads, cfg.head_dim_)
    cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
             "v": torch.zeros(shape, dtype=torch.bfloat16)}
    seen = []
    real = ops.decode_attention

    def spy(q, k, v, length):
        seen.append((q, k, v))
        return real(q, k, v, length)

    window = cfg.groups[0].pattern[-1].window
    ops.decode_attention = spy
    try:
        attn.gqa_attention(p, x, torch.full((2, 1), off), cfg=cfg,
                           cache=cache, cache_offset=off, window=window)
    finally:
        ops.decode_attention = real
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("arch,off,cache_len", [
    ("qwen2-5-7b", 5, 48), ("qwen2-5-7b", 2048, 2064),
    ("recurrentgemma-9b", 5, 48), ("recurrentgemma-9b", 2100, 2112),
])
def test_vec16_check_passes_the_models_decode_views(arch, off, cache_len):
    q, k, v = _decode_views(arch, off, cache_len)
    cfg = get_config(arch)
    assert k.shape[1] == cfg.n_kv_heads and k.shape[-1] == cfg.head_dim_
    assert not k.is_contiguous() or cfg.n_kv_heads == 1
    assert cuda_decode.tensor_cores(q.dtype, q.shape[-1])
    cuda_decode.vec16_check((k, v), ("k", "v"))


@pytest.mark.parametrize("bad", ["base", "stride"])
def test_vec16_check_refuses_a_view_it_cannot_load(bad):
    b, hkv, t, d = 1, 2, 16, 128
    if bad == "base":       # starts 4 elements (8 bytes) into its buffer
        buf = torch.zeros(b * hkv * t * d + 4, dtype=torch.bfloat16)
        k = buf[4:].view(b, hkv, t, d)
    else:                   # rows 4 elements apart from a 16-byte multiple
        k = torch.zeros((b, hkv, t, d + 4), dtype=torch.bfloat16)[..., :d]
    ok = torch.zeros((b, hkv, t, d), dtype=torch.bfloat16)
    cuda_decode.vec16_check((ok, ok), ("k", "v"))
    with pytest.raises(ValueError, match="16-byte"):
        cuda_decode.vec16_check((k, ok), ("k", "v"))


def test_route_counts_per_op_are_zero_on_the_cpu_and_reset():
    """``route_counts()`` keeps its output; the decode and scan routes
    count only on the card and are zeroed by ``reset_launches()``."""
    cuda_decode.ROUTES["split"] += 2
    ops.reset_launches()
    assert ops.route_counts() == {"sm90": 0, "f32tc": 0, "simt": 0}
    assert ops.route_counts("decode_attention") == {"split": 0, "single": 0}
    assert ops.route_counts("rglru_scan") == {"chunked": 0, "serial": 0}
    q = torch.zeros((2, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 2, 300, 64), dtype=torch.bfloat16)
    out = ops.decode_attention(q, k, k, torch.tensor([300, 7]))
    assert out.shape == q.shape
    assert ops.route_counts("decode_attention") == {"split": 0, "single": 0}
    assert ops.launch_counts()["decode_attention"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_decode.decode_attention(q, k, k, 3)


def test_cpu_decode_gives_zero_on_an_empty_row_as_the_reference():
    """``ops.decode_attention`` on the CPU at ``length = [0, 5]`` against
    the reference's default dispatch (its Pallas kernel, which gives
    ``acc / max(l, 1e-20)`` = 0 on an empty row): row 0 exactly 0 (the
    plain version alone gives NaN there), row 1 within 2e-3."""
    rng = np.random.default_rng(0)
    q = rng.standard_normal((2, 4, 64)).astype(np.float32)
    k = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    v = rng.standard_normal((2, 2, 256, 64)).astype(np.float32)
    lengths = np.array([0, 5], np.int32)
    want = np.asarray(jops.decode_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(lengths)), np.float32)
    got = ops.decode_attention(*(torch.from_numpy(x) for x in
                                 (q, k, v, lengths))).numpy()
    assert np.all(want[0] == 0.0)
    assert np.all(got[0] == 0.0) and not np.signbit(got[0]).any()
    np.testing.assert_allclose(got[1], want[1], rtol=2e-3, atol=2e-3)
    plain = ref.decode_attention_ref(*(torch.from_numpy(x) for x in
                                       (q, k, v, lengths)))
    assert torch.isnan(plain[0]).all()          # the yardstick is unchanged
