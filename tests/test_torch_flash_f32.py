"""The f32tc route of the port's ``flash_attention`` (float32 on the tensor
cores at float32 accuracy, ``csrc/flash_attention_f32.cu``, with the
hand-written backward ``csrc/flash_attention_f32_bwd.cu``), as far as the
CPU reaches it: the kernels run only on the card (``chip_smoke.py``
phases 5 and 18 hold them there against the plain versions below).

* ``ref.flash_attention_lse_ref`` (the forward's plain version): its out
  against the JAX package's Pallas kernel in interpret mode, its lse
  against ``torch.logsumexp`` of the masked, scaled scores, within 1e-5
  of each output's max (float32);
* ``ref.flash_attention_bwd_ref`` (the backward's plain version,
  FlashAttention-2's equations): against ``jax.vjp`` of the reference's
  ``flash_attention_ref`` within 1e-5 of each gradient's max in float32
  and 1e-12 in float64 (``jax.enable_x64``), and against
  ``torch.autograd`` through the port's ``flash_attention_ref``;
* causal, windowed and non-causal masks, GQA groups of 1, 4 and 7,
  ragged S != T, and a row that sees no key;
* ``route``: float32 at D in {32, 64, 128, 256} to f32tc, bfloat16 there
  to sm90, every other head dim to simt;
* ``FlashAttention`` with both kernel entry points replaced by their
  plain versions gives the gradients of ``flash_attention_ref``; two
  planted backward faults (Delta dropped; dK / dV of one query head of
  the group) miss that check.

Inputs are made by numpy from a seed.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import chip_smoke
from repro.kernels import flash_attention as jflash
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as attn

TOL32 = 1e-5
TOL64 = 1e-12

# (B, H, Hkv, S, T, D, causal, window): groups of 1, 4 and 7, the three
# masks, ragged S != T both ways; every row sees a key
SHAPES = [
    (1, 4, 4, 32, 32, 32, True, None),
    (2, 8, 2, 24, 40, 32, True, 6),
    (1, 7, 1, 40, 24, 32, True, None),
    (2, 4, 1, 32, 32, 32, False, None),
    (1, 7, 1, 24, 40, 32, False, None),
    (1, 8, 2, 40, 40, 32, True, 9),
]
IDS = [f"B{b}H{h}Hkv{hk}S{s}T{t}D{d}{'c' if c else 'n'}{w or ''}"
       for b, h, hk, s, t, d, c, w in SHAPES]


def _np(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _inputs(shape, seed=0, dtype=np.float32):
    b, h, hkv, s, t, d, _, _ = shape
    rng = np.random.default_rng(seed)
    return tuple(_np(rng, sh).astype(dtype) for sh in (
        (b, h, s, d), (b, hkv, t, d), (b, hkv, t, d), (b, h, s, d)))


def _rel_max(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _visible(s, t, causal, window):
    i, j = np.arange(s)[:, None], np.arange(t)[None, :]
    ok = np.ones((s, t), bool)
    if causal:
        ok &= j <= i
    if window is not None:
        ok &= i - j < window
    return ok


def _scores(q, k, causal, window):
    """Masked, scaled scores [B,H,S,T] written out in float64."""
    b, h, s, d = q.shape
    kk = np.repeat(k.astype(np.float64), h // k.shape[1], axis=1)
    sc = np.einsum("bhsd,bhtd->bhst", q.astype(np.float64), kk) / math.sqrt(d)
    return np.where(_visible(s, k.shape[2], causal, window), sc, -np.inf)


def _attention_any_rows(q, k, v, causal, window):
    """Softmax attention in q's dtype, written so autograd stays finite
    where a row sees no key (its output 0)."""
    h, s, d = q.shape[1:]
    g = h // k.shape[1]
    kk, vv = k.repeat_interleave(g, 1), v.repeat_interleave(g, 1)
    ok = torch.from_numpy(_visible(s, k.shape[2], causal, window))
    empty = ~ok.any(-1, keepdim=True)
    sc = (q @ kk.transpose(-1, -2) / math.sqrt(d)).masked_fill(~ok, -math.inf)
    w = torch.softmax(sc.masked_fill(empty, 0), -1).masked_fill(empty, 0)
    return w @ vv


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_lse_ref_out_matches_the_pallas_kernel(shape):
    q, k, v, _ = _inputs(shape, seed=1)
    causal, window = shape[6], shape[7]
    out, _ = ref.flash_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    want = jflash.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=causal,
                                  window=window, interpret=True)
    assert out.dtype == torch.float32
    assert _rel_max(out.numpy(), np.asarray(want)) <= TOL32


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_lse_ref_is_the_logsumexp_of_the_masked_scores(shape):
    q, k, v, _ = _inputs(shape, seed=2)
    causal, window = shape[6], shape[7]
    _, lse = ref.flash_attention_lse_ref(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, window=window)
    want = torch.logsumexp(torch.from_numpy(_scores(q, k, causal, window)),
                           dim=-1)
    assert lse.shape == q.shape[:3] and lse.dtype == torch.float32
    assert _rel_max(lse.numpy(), want.numpy()) <= TOL32


def _bwd_ref(q, k, v, dout, causal, window):
    """``flash_attention_bwd_ref`` on the forward plain version's out and
    lse (numpy in, torch out)."""
    q, k, v, dout = (torch.from_numpy(x) for x in (q, k, v, dout))
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    return ref.flash_attention_bwd_ref(q, k, v, out, lse, dout,
                                       causal=causal, window=window)


def _jax_vjp(q, k, v, dout, causal, window):
    out, vjp = jax.vjp(lambda q, k, v: jref.flash_attention_ref(
        q, k, v, causal=causal, window=window), jnp.asarray(q),
        jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp(jnp.asarray(dout, out.dtype))]


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_ref_matches_jax_vjp_of_the_reference_float32(shape):
    q, k, v, dout = _inputs(shape, seed=3)
    causal, window = shape[6], shape[7]
    got = _bwd_ref(q, k, v, dout, causal, window)
    want = _jax_vjp(q, k, v, dout, causal, window)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_max(g.numpy(), w) <= TOL32


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_ref_matches_jax_vjp_of_the_reference_float64(shape,
                                                           monkeypatch):
    """The reference casts its operands to float32 (``astype(jnp.float32)``);
    under x64 that name is pointed at float64 for the call, so its own
    formula runs in float64, as the plain version does for float64
    inputs."""
    q, k, v, dout = _inputs(shape, seed=4, dtype=np.float64)
    causal, window = shape[6], shape[7]
    got = _bwd_ref(q, k, v, dout, causal, window)
    with jax.enable_x64(True):
        monkeypatch.setattr(jnp, "float32", jnp.float64)
        want = _jax_vjp(q, k, v, dout, causal, window)
        monkeypatch.undo()
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and w.dtype == np.float64
        assert _rel_max(g.numpy(), w) <= TOL64


def _autograd(q, k, v, dout, causal, window):
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    out = ref.flash_attention_ref(*ins, causal=causal, window=window)
    return torch.autograd.grad(out, ins, torch.from_numpy(dout))


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_bwd_ref_matches_torch_autograd_of_the_plain_version(shape):
    q, k, v, dout = _inputs(shape, seed=5)
    causal, window = shape[6], shape[7]
    got = _bwd_ref(q, k, v, dout, causal, window)
    want = _autograd(q, k, v, dout, causal, window)
    for g, w in zip(got, want):
        assert _rel_max(g.numpy(), w.numpy()) <= TOL32


@settings(deadline=None, max_examples=25)
@given(b=st.integers(1, 2), hkv=st.integers(1, 2),
       group=st.sampled_from([1, 4, 7]), s=st.integers(1, 20),
       t=st.integers(1, 20), d=st.sampled_from([4, 8]),
       causal=st.booleans(), window=st.sampled_from([None, 1, 3, 8]),
       seed=st.integers(0, 2**16))
def test_bwd_ref_matches_autograd_property(b, hkv, group, s, t, d, causal,
                                           window, seed):
    """Any shape in float64, rows that see no key included: there the
    plain version's out is 0 and lse -inf, and the row adds 0 to every
    gradient; held against autograd through softmax attention written
    out in float64 (``_attention_any_rows``)."""
    shape = (b, hkv * group, hkv, s, t, d, causal, window)
    q, k, v, dout = _inputs(shape, seed=seed, dtype=np.float64)
    empty = np.isinf(_scores(q, k, causal, window)).all(-1)
    qt, kt, vt = (torch.from_numpy(x) for x in (q, k, v))
    out, lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=causal,
                                           window=window)
    assert bool((torch.isinf(lse) == torch.from_numpy(empty)).all())
    assert bool((out[torch.from_numpy(empty)] == 0).all())
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, lse,
                                      torch.from_numpy(dout),
                                      causal=causal, window=window)
    assert all(bool(torch.isfinite(g).all()) for g in got)
    assert bool((got[0][torch.from_numpy(empty)] == 0).all())
    ins = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(
        _attention_any_rows(*ins, causal, window), ins,
        torch.from_numpy(dout))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("dtype,d,want", [
    (torch.float32, 32, "f32tc"), (torch.float32, 64, "f32tc"),
    (torch.float32, 128, "f32tc"), (torch.float32, 256, "f32tc"),
    (torch.bfloat16, 32, "sm90"), (torch.bfloat16, 64, "sm90"),
    (torch.bfloat16, 128, "sm90"), (torch.bfloat16, 256, "sm90"),
    (torch.float32, 16, "simt"), (torch.float32, 48, "simt"),
    (torch.float32, 96, "simt"), (torch.bfloat16, 16, "simt"),
    (torch.bfloat16, 96, "simt"),
])
def test_route_by_dtype_and_head_dim(dtype, d, want):
    assert fmod.route(dtype, d) == want


@pytest.fixture
def plain_entry_points(monkeypatch):
    """Both f32tc entry points replaced by their plain versions, so
    ``FlashAttention`` runs on the CPU as on the card."""
    monkeypatch.setattr(fmod, "flash_attention_lse",
                        ref.flash_attention_lse_ref)
    monkeypatch.setattr(fmod, "flash_attention_bwd",
                        ref.flash_attention_bwd_ref)


def _function_grads(q, k, v, r, causal, window):
    return chip_smoke._flash_grads(
        lambda q, k, v, causal, window: fmod.FlashAttention.apply(
            q, k, v, causal, window), q, k, v, r, causal, window)


@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_function_gives_the_plain_versions_gradients(plain_entry_points,
                                                     shape):
    q, k, v, r = (torch.from_numpy(x) for x in _inputs(shape, seed=6))
    causal, window = shape[6], shape[7]
    assert fmod.route(q.dtype, q.shape[-1]) == "f32tc"
    want = chip_smoke._flash_grads(ref.flash_attention_ref, q, k, v, r,
                                   causal, window)
    got = _function_grads(q, k, v, r, causal, window)
    # dk, dv come back [B,Hkv,T,D]: summed over each kv head's group
    assert [g.shape for g in got] == [q.shape, k.shape, v.shape]
    ok, worst = chip_smoke._grad_check(got, want, TOL32)
    assert ok, worst
    # a gradient asked for only some inputs
    k2 = k.clone().requires_grad_()
    out = fmod.FlashAttention.apply(q, k2, v, causal, window)
    (dk,) = torch.autograd.grad((out ** 2 * r).sum(), k2)
    assert _rel_max(dk.numpy(), want[1].numpy()) <= TOL32


@pytest.mark.parametrize("shape", [SHAPES[1], SHAPES[2], SHAPES[5]],
                         ids=[IDS[1], IDS[2], IDS[5]])
def test_planted_backward_faults_miss_the_check(plain_entry_points, shape):
    q, k, v, r = (torch.from_numpy(x) for x in _inputs(shape, seed=7))
    causal, window = shape[6], shape[7]
    want = chip_smoke._flash_grads(ref.flash_attention_ref, q, k, v, r,
                                   causal, window)
    assert chip_smoke._grad_check(
        _function_grads(q, k, v, r, causal, window), want, TOL32)[0]
    out, lse = ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                           window=window)
    dout = 2 * out * r
    faults = ref.flash_attention_bwd_faults(q, k, v, out, lse, dout,
                                            causal=causal, window=window)
    assert set(faults) == {"delta dropped", "one head of the group"}
    for name, got in faults.items():
        ok, worst = chip_smoke._grad_check(got, want,
                                           chip_smoke.GRAD_TOL["float32"])
        assert not ok, (name, worst)


def test_entry_points_take_cuda_tensors_only():
    """No fallback: on a CPU tensor the kernels' wrappers raise (``ops``
    sends CPU tensors to the plain versions before they are reached)."""
    q = torch.zeros((1, 2, 8, 64))
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention_lse(q, q, q)
    with pytest.raises(ValueError, match="CUDA"):
        fmod.flash_attention_bwd(q, q, q, q, torch.zeros((1, 2, 8)), q)


def test_backward_launches_count_apart_and_reset():
    fmod.LAUNCHES["flash_attention_bwd"] += 2
    fmod.ROUTES["f32tc"] += 1
    ops.reset_launches()
    assert ops.launch_counts()["flash_attention_bwd"] == 0
    assert ops.route_counts() == {"sm90": 0, "f32tc": 0, "simt": 0}


@pytest.mark.parametrize("arch", ["qwen2-5-7b", "recurrentgemma-9b"])
def test_the_models_float32_prefill_views_pass_the_16_byte_check(arch):
    """The views ``gqa_attention`` hands the kernel in a float32 prefill
    at the arch's full width are read in 16-byte pieces as they lie."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    g = torch.Generator().manual_seed(0)
    p = {n: torch.randn(sp.shape, generator=g) * 0.02
         for n, sp in attn.gqa_specs(cfg).items()}
    x = torch.randn((1, 5, cfg.d_model), generator=g)
    seen = []
    real = ops.flash_attention

    def spy(q, k, v, **kw):
        seen.append((q, k, v))
        return real(q, k, v, **kw)

    ops.flash_attention = spy
    try:
        attn.gqa_attention(p, x, torch.arange(5)[None], cfg=cfg,
                           cache=None, cache_offset=0)
    finally:
        ops.flash_attention = real
    (q, k, v), = seen
    assert q.dtype == torch.float32 and not q.is_contiguous()
    assert fmod.route(q.dtype, q.shape[-1]) == "f32tc"
    fmod.check_16b((q, k, v), ("q", "k", "v"), "f32tc")
