"""The sm90 route of the port's ``flash_attention`` (wgmma tiles fed by
TMA, ``csrc/flash_attention_sm90.cu``), as far as the CPU can reach it:

* which kernel takes a call (``route``: dtype and head dim, nothing else);
* what TMA accepts (``tma_check``): the model's own full-width prefill
  views at Qwen2.5-7B's and RecurrentGemma-9B's heads pass, a view that
  starts 4 elements into its buffer is refused, never copied;
* that the kernel's rounding keeps the contract: a plain-torch model of
  it (scores and softmax in float32, P rounded to bfloat16 per K/V tile
  of 128 keys, 64 at D = 256, before P V) against the JAX package's
  Pallas kernel in interpret mode, in bfloat16, within 2e-2.

The kernel itself needs the card; ``chip_smoke.py`` holds it against
``ref.flash_attention_ref`` there.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_attention as jflash
from repro.kernels import ops as jops
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

BF16_TOL = 2e-2

# (B, H, Hkv, S, D): the reference's FLASH_SHAPES, RecurrentGemma's heads
# (16 over 1, D = 256), and a ragged S (Pallas then runs 100-row blocks)
MODEL_SHAPES = [
    (1, 4, 4, 128, 64),
    (2, 8, 2, 256, 64),
    (1, 4, 1, 256, 128),
    (2, 2, 2, 512, 32),
    (1, 16, 1, 256, 256),
    (1, 4, 2, 300, 128),
]


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 32, "f32tc"), (torch.float32, 64, "f32tc"),
    (torch.float32, 128, "f32tc"), (torch.float32, 256, "f32tc"),
    (torch.bfloat16, 32, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 256, "sm90"),
    (torch.bfloat16, 16, "simt"), (torch.bfloat16, 48, "simt"),
    (torch.bfloat16, 96, "simt"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert cuda_flash.route(dtype, d) == want


def _attention_views(arch, s, cache_len):
    """The q, k, v views ``gqa_attention`` hands ``ops.flash_attention``
    in a bfloat16 prefill of ``s`` tokens at the arch's full width (into
    a ``cache_len``-row cache, or with no cache when it is None)."""
    cfg = get_config(arch)
    g = torch.Generator().manual_seed(0)
    p = {k: (torch.randn(sp.shape, generator=g) * 0.02).to(torch.bfloat16)
         for k, sp in attn.gqa_specs(cfg).items()}
    x = torch.randn((1, s, cfg.d_model), generator=g).to(torch.bfloat16)
    pos = torch.arange(s)[None]
    cache = None
    if cache_len is not None:
        shape = (1, cache_len, cfg.n_kv_heads, cfg.head_dim_)
        cache = {"k": torch.zeros(shape, dtype=torch.bfloat16),
                 "v": torch.zeros(shape, dtype=torch.bfloat16)}
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        attn.gqa_attention(p, x, pos, cfg=cfg, cache=cache, cache_offset=0)
    finally:
        ops.flash_attention = real
    assert len(seen) == 1
    return seen[0]


@pytest.mark.parametrize("arch", ["qwen2-5-7b", "recurrentgemma-9b"])
@pytest.mark.parametrize("s,cache_len", [(3, 48), (5, None)])
def test_tma_check_passes_the_models_prefill_views(arch, s, cache_len):
    q, k, v = _attention_views(arch, s, cache_len)
    cfg = get_config(arch)
    assert q.shape == (1, cfg.n_heads, s, cfg.head_dim_)
    assert k.shape[1] == cfg.n_kv_heads
    assert not q.is_contiguous()            # a permuted view, not a copy
    assert cuda_flash.route(q.dtype, q.shape[-1]) == "sm90"
    cuda_flash.tma_check((q, k, v), ("q", "k", "v"))


@pytest.mark.parametrize("bad", ["base", "stride"])
def test_tma_check_refuses_a_view_it_cannot_load(bad):
    b, h, s, d = 1, 4, 16, 128
    if bad == "base":       # starts 4 elements (8 bytes) into its buffer
        buf = torch.zeros(b * h * s * d + 4, dtype=torch.bfloat16)
        q = buf[4:].view(b, h, s, d)
    else:                   # rows 4 elements apart from a 16-byte multiple
        q = torch.zeros((b, h, s, d + 4), dtype=torch.bfloat16)[..., :d]
    ok = torch.zeros((b, h, s, d), dtype=torch.bfloat16)
    cuda_flash.tma_check((ok, ok, ok), ("q", "k", "v"))
    with pytest.raises(ValueError, match="TMA"):
        cuda_flash.tma_check((q, ok, ok), ("q", "k", "v"))


def sm90_rounding_model(q, k, v, *, causal=True, window=None):
    """The sm90 kernel's arithmetic in plain torch: per K/V tile of BN
    keys, scores in float32, online softmax in float32 with masked keys
    at probability 0, P rounded to bfloat16 before P V, float32
    accumulation, out = acc / max(l, 1e-20) in bfloat16."""
    b, h, s, d = q.shape
    t = k.shape[2]
    bn = 64 if d > 128 else 128
    g = h // k.shape[1]
    qf = q.float()
    kf = k.float().repeat_interleave(g, dim=1)
    vf = v.float().repeat_interleave(g, dim=1)
    m = torch.full((b, h, s, 1), -math.inf)
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    qi = torch.arange(s)[:, None]
    for n0 in range(0, t, bn):
        kt, vt = kf[:, :, n0:n0 + bn], vf[:, :, n0:n0 + bn]
        sc = qf @ kt.transpose(-1, -2) / math.sqrt(d)
        kj = torch.arange(n0, n0 + kt.shape[2])[None, :]
        ok = torch.ones((s, kt.shape[2]), dtype=torch.bool)
        if causal:
            ok &= kj <= qi
        if window is not None:
            ok &= qi - kj < window
        sc = sc.masked_fill(~ok, -math.inf)
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        p = torch.exp(sc - m_use)
        alpha = torch.exp(m - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + p.to(torch.bfloat16).float() @ vt
        m = m_new
    return (acc / l.clamp_min(1e-20)).to(torch.bfloat16)


def _both(seed, shape):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        torch.bfloat16)


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("shape", MODEL_SHAPES)
@pytest.mark.parametrize("window", [None, 64])
def test_rounding_model_matches_pallas_in_bf16(shape, window):
    b, h, hkv, s, d = shape
    jq, q = _both(0, (b, h, s, d))
    jk, k = _both(1, (b, hkv, s, d))
    jv, v = _both(2, (b, hkv, s, d))
    if s % 128:      # Pallas asserts that its blocks divide S
        want = jflash.flash_attention(jq, jk, jv, causal=True, window=window,
                                      bq=100, bk=100, interpret=True)
    else:
        want = jops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = sm90_rounding_model(q, k, v, causal=True, window=window)
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    _close(got, want)


@pytest.mark.parametrize("heads", [(28, 4, 128), (16, 1, 256)])
def test_rounding_model_matches_pallas_on_the_launchers_prefill(heads):
    """A 3-token prompt against a 48-row cache, read through [B,T,Hkv,D]
    views, at Qwen2.5-7B's and RecurrentGemma-9B's heads."""
    h, hkv, d = heads
    jq, q = _both(3, (1, 3, h, d))
    jk, k = _both(4, (1, 48, hkv, d))
    jv, v = _both(5, (1, 48, hkv, d))
    want = jops.flash_attention(jnp.swapaxes(jq, 1, 2),
                                jnp.swapaxes(jk, 1, 2),
                                jnp.swapaxes(jv, 1, 2), causal=True)
    got = sm90_rounding_model(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True)
    _close(got, want)


def test_routes_count_on_the_card_only_and_reset():
    """The CPU path runs the plain version and counts no route; reset
    zeroes the route counts with the launch counts."""
    cuda_flash.ROUTES["sm90"] += 3
    ops.reset_launches()
    assert ops.route_counts() == {"sm90": 0, "f32tc": 0, "simt": 0}
    q = torch.zeros((1, 2, 8, 64), dtype=torch.bfloat16)
    ops.flash_attention(q, q, q, causal=True)
    assert ops.route_counts() == {"sm90": 0, "f32tc": 0, "simt": 0}
    assert ops.launch_counts()["flash_attention"] == 0
