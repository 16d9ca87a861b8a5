"""The attention logit softcap and the query offset in the port's
attention kernels (their plain PyTorch versions, which the CPU path
runs) and in its model, against the JAX package on the CPU.

The reference caps the scaled float32 scores as ``c * tanh(s / c)``
before the mask and the softmax (``repro/models/attention.py``
``_sdpa``), and a step at a cache offset masks by absolute positions and
``valid_upto`` (``_sdpa_chunked``).  The port's kernels take the cap and
a query offset (query row i at position ``q_offset + i`` of the cache
rows they are handed).

Contract: the plain versions (``ref.flash_attention_ref`` /
``flash_attention_lse_ref`` / ``decode_attention_ref`` /
``decode_attention_split_ref``) with the cap and the offset against the
reference's ``_sdpa_chunked`` on the same numpy inputs, within 2e-5 in
float32 and, in float64, 1e-6 relative and a bound derived per output
element from the reference's float32 scores (``preferred_element_type``
keeps them float32 even then: ``_f64_bound``); the plain backward with the cap
(``ref.flash_attention_bwd_ref``) equal to ``torch.autograd`` through
the plain forward within 1e-10 in float64; the planted faults of
``chip_smoke.py`` phase 23 (the cap dropped, the cap after the mask, the
offset ignored, the backward without the cap's derivative) at least 10x
farther than the bound; the port's ``gqa_attention`` and ``train_loss``
gradients with ``attn_logit_softcap`` set on both sides against the
reference's within 1e-4 (float32; gradients at the d_model fan-in law,
as ``tests/test_torch_train_loss.py``); and ``FlashAttention`` (the
card's autograd function, its raw wrappers replaced by the plain
versions) refusing a gradient at ``q_offset > 0``.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import RunFlags as JRunFlags
from repro.models import attention as jattn
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.models.model import train_loss as jtrain_loss
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ops, ref
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import RunFlags
from repro_torch.models import attention as attn
from repro_torch.models.params import leaves_with_paths

try:
    from hypothesis import example, given, settings, strategies as st
except ImportError:                                      # pragma: no cover
    from _hypothesis_shim import given, settings, st

    def example(*_args, **_kwargs):
        return lambda fn: fn

TOL = {"float32": 2e-5, "float64": 1e-6}
EPS32 = float(np.finfo(np.float32).eps)
# b, heads, s, off, d, window, softcap, float64, seed: a draw whose float64
# error (2.9e-6) the reference's float32 scores put over TOL["float64"]
PINNED = (1, (4, 4), 1, 6, 8, None, 50.0, True, 0)
CAPS = (None, 5.0, 50.0)


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _reference(q, k, v, off, window, causal, softcap, dtype):
    """The reference's attention of q [B,S,H,D] at positions off..off+S-1
    against the cache k, v [B,T,Hkv,D] (rows past the frontier off + S - 1
    invalid), in ``dtype``; [B,S,H,D] numpy."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    jd = jnp.float64 if dtype == "float64" else jnp.float32
    qj = jnp.asarray(q, jd).reshape(b, s, hkv, h // hkv, d)
    pos_q = (off + jnp.arange(s))[None]
    pos_k = jnp.arange(k.shape[1])[None]
    out = jattn._sdpa_chunked(
        qj, jnp.asarray(k, jd), jnp.asarray(v, jd), pos_q, pos_k, window,
        causal, softcap=softcap,
        valid_upto=jnp.asarray(off + s - 1, jnp.int32) if causal else None)
    return np.asarray(out, np.float64).reshape(b, s, h, d)


def _port(q, k, v, off, window, causal, softcap, dtype):
    """The port's plain version on the rows the model hands the kernel:
    [lo, off + S) of the cache with q_offset = off - lo."""
    s = q.shape[1]
    lo = 0 if window is None or not causal else max(0, off + 1 - window)
    hi = off + s if causal else k.shape[1]
    td = torch.float64 if dtype == "float64" else torch.float32
    qt = torch.from_numpy(q).to(td).transpose(1, 2)
    kt = torch.from_numpy(k[:, lo:hi]).to(td).transpose(1, 2)
    vt = torch.from_numpy(v[:, lo:hi]).to(td).transpose(1, 2)
    kw = dict(causal=causal, window=window, softcap=softcap,
              q_offset=off - lo if causal else 0)
    if dtype == "float64":
        out = ref.flash_attention_lse_ref(qt, kt, vt, **kw)[0]
    else:
        out = ref.flash_attention_ref(qt, kt, vt, **kw)
    return out.transpose(1, 2).double().numpy()


def _f64_bound(q, k, v, off, window):
    """The float64 bound of one draw, an absolute bound for each output
    element (the relative one stays TOL["float64"]).  The reference's
    scores are float32 even under x64 (``preferred_element_type``), and
    so is its softmax; only the product with v is float64.  Take each
    float32 score of a query as off by at most delta = eps32 max|s|, the
    largest of its visible scaled scores s = q.k / sqrt(d) (before the
    cap, which moves a score by no more than the cap's input moves).
    Moving every score by at most delta scales each softmax weight by a
    factor within e^(+-2 delta), so the weights move by at most
    e^(2 delta) - 1 ~ 2 delta in sum; as they still sum to 1, an output
    column moves by at most 2 delta max_j |v_j - c| for any c, which at
    c the midrange of its visible v_j is delta (max_j v_j - min_j v_j).
    The float32 softmax's own rounding goes into 1e-6: bound = 1e-6 +
    eps32 max|s| (max_j v_j - min_j v_j), each maximum over the keys the
    query sees.  That is at most the 1e-6 + 2 eps32 max|s| max|v| of
    the whole draw, since a column's range is at most 2 max|v|."""
    b, s, h, d = q.shape
    t, hkv = k.shape[1], k.shape[2]
    kk = np.repeat(k, h // hkv, axis=2).astype(np.float64)
    vv = np.repeat(v, h // hkv, axis=2).astype(np.float64)
    scores = np.einsum("bshd,bthd->bsht", q.astype(np.float64), kk) / \
        math.sqrt(d)
    pos = off + np.arange(s)[:, None]
    key = np.arange(t)[None]
    seen = key <= pos                                          # [S, T]
    if window is not None:
        seen = seen & (key > pos - window)
    smax = np.where(seen[None, :, None], np.abs(scores), 0.0).max(-1)
    m = seen[None, :, :, None, None]                           # [1,S,T,1,1]
    spread = np.where(m, vv[:, None], -np.inf).max(2) - \
        np.where(m, vv[:, None], np.inf).min(2)               # [B,S,H,D]
    return TOL["float64"] + EPS32 * smax[..., None] * spread


def _f64_close(got, want, q, k, v, off, window):
    """Whether every element of ``got`` lies within the float64 bounds of
    ``want``: TOL["float64"] relative and ``_f64_bound`` absolute."""
    return bool((np.abs(got - want) <= TOL["float64"] * np.abs(want) +
                 _f64_bound(q, k, v, off, window)).all())


def _draw(b, heads, s, off, d, seed):
    """q, k, v of a draw: ``s`` queries at cache offset ``off`` against a
    cache of ``off + s + 5`` rows."""
    h, hkv = heads
    rng = np.random.default_rng(seed)
    t = off + s + 5
    return (_normal(rng, (b, s, h, d), 2.0), _normal(rng, (b, t, hkv, d), 2.0),
            _normal(rng, (b, t, hkv, d)))


@settings(max_examples=25, deadline=None)
@given(st.integers(1, 2), st.sampled_from([(4, 4), (4, 2), (6, 1)]),
       st.integers(1, 9), st.integers(0, 20), st.sampled_from([8, 16]),
       st.sampled_from([None, 3, 7]), st.sampled_from(CAPS),
       st.booleans(), st.integers(0, 2 ** 16))
@example(*PINNED)
def test_plain_flash_matches_reference_sdpa(b, heads, s, off, d, window,
                                            softcap, float64, seed):
    """A chunk of ``s`` queries at cache offset ``off`` against a cache
    of ``off + s + 5`` rows (five past the frontier), causal and windowed,
    capped or not, in float32 (within TOL) and float64 (within
    TOL["float64"] relative and the draw's ``_f64_bound`` absolute: the
    reference's float32 scores, not the port, set the float64 gap)."""
    q, k, v = _draw(b, heads, s, off, d, seed)
    dtype = "float64" if float64 else "float32"
    with jax.enable_x64(float64):
        want = _reference(q, k, v, off, window, True, softcap, dtype)
    got = _port(q, k, v, off, window, True, softcap, dtype)
    if float64:
        assert _f64_close(got, want, q, k, v, off, window), \
            float(np.abs(got - want).max())
    else:
        np.testing.assert_allclose(got, want, rtol=TOL[dtype],
                                   atol=TOL[dtype])


@pytest.mark.parametrize("fault", ["cap dropped", "mask one row late",
                                   "scores x (1 + 1e-5)"])
def test_float64_bound_sees_the_planted_faults(fault):
    """On the pinned draw (whose float64 gap, 2.9e-6, is 0.43 of its
    bound where nearest) the port passes the derived float64 bound and a
    wrong port misses it: its float64 plain version with the cap
    dropped, with the causal mask one row late (the query also seeing
    the row after it), or with every scaled score 1e-5 too large (q
    scaled by 1 + 1e-5; it misses by about 3x; the shares:
    ``tools/f64_bound_margin.py``)."""
    b, heads, s, off, d, window, softcap, _, seed = PINNED
    q, k, v = _draw(b, heads, s, off, d, seed)
    with jax.enable_x64(True):
        want = _reference(q, k, v, off, window, True, softcap, "float64")
    got = _port(q, k, v, off, window, True, softcap, "float64")
    assert _f64_close(got, want, q, k, v, off, window)
    if fault == "cap dropped":
        bad = _port(q, k, v, off, window, True, None, "float64")
    elif fault == "mask one row late":
        bad = _port(q, k, v, off + 1, window, True, softcap, "float64")
    else:
        bad = _port(q * (1 + 1e-5), k, v, off, window, True, softcap,
                    "float64")
    assert not _f64_close(bad, want, q, k, v, off, window), (
        fault, float(np.abs(bad - want).max()))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("softcap", CAPS)
def test_plain_cross_attention_matches_reference(dtype, softcap):
    """Non-causal (cross-attention: every encoder row visible), S != T."""
    rng = np.random.default_rng(1)
    q, k, v = (_normal(rng, (2, 3, 4, 16), 2.0),
               _normal(rng, (2, 40, 2, 16), 2.0), _normal(rng, (2, 40, 2, 16)))
    with jax.enable_x64(dtype == "float64"):
        want = _reference(q, k, v, 0, None, False, softcap, dtype)
    got = _port(q, k, v, 0, None, False, softcap, dtype)
    np.testing.assert_allclose(got, want, rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("softcap", CAPS)
def test_plain_decode_matches_reference(dtype, softcap):
    """One token at position L - 1 over the first L of T cache rows, per
    batch row (the reference masks past ``valid_upto``); the split
    algorithm's model with the cap equals the plain decode."""
    rng = np.random.default_rng(2)
    b, h, hkv, t, d = 3, 8, 2, 200, 32
    q = _normal(rng, (b, 1, h, d), 2.0)
    k, v = _normal(rng, (b, t, hkv, d)), _normal(rng, (b, t, hkv, d))
    lengths = [200, 77, 1]
    td = torch.float64 if dtype == "float64" else torch.float32
    qt = torch.from_numpy(q[:, 0]).to(td)
    kt, vt = (torch.from_numpy(x).to(td).transpose(1, 2) for x in (k, v))
    got = ref.decode_attention_ref(qt, kt, vt, torch.tensor(lengths),
                                   softcap=softcap)
    for i, n in enumerate(lengths):
        with jax.enable_x64(dtype == "float64"):
            want = _reference(q[i:i + 1], k[i:i + 1], v[i:i + 1], n - 1,
                              None, True, softcap, dtype)
        np.testing.assert_allclose(got[i].double().numpy(), want[0, 0],
                                   rtol=TOL[dtype], atol=TOL[dtype])
    split = ref.decode_attention_split_ref(qt.float(), kt.float(),
                                           vt.float(), torch.tensor(lengths),
                                           64, softcap=softcap)
    np.testing.assert_allclose(split.numpy(), got.float().numpy(),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
@pytest.mark.parametrize("softcap", [2.0, 50.0])
def test_plain_backward_with_cap_matches_autograd(causal, window, softcap):
    """``ref.flash_attention_bwd_ref`` (FlashAttention-2's equations with
    dS times 1 - (Sc / c)^2) against autograd through the plain forward,
    float64, GQA; the backward without the cap's derivative misses."""
    rng = np.random.default_rng(3)
    q, k, v, r = (torch.from_numpy(_normal(rng, shape, sc)).double()
                  for shape, sc in (((2, 6, 20, 16), 3.0),
                                    ((2, 2, 20, 16), 3.0),
                                    ((2, 2, 20, 16), 1.0),
                                    ((2, 6, 20, 16), 1.0)))
    kw = dict(causal=causal, window=window, softcap=softcap)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    out, lse = ref.flash_attention_lse_ref(*ins, **kw)
    want = torch.autograd.grad(out, ins, r)
    got = ref.flash_attention_bwd_ref(q, k, v, out.detach(), lse.detach(), r,
                                      **kw)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-10,
                                   atol=1e-10)
    fault = ref.flash_attention_bwd_faults(q, k, v, out.detach(),
                                           lse.detach(), r, **kw)
    miss = max(float((f - w).abs().max()) for f, w in
               zip(fault["no cap derivative"], want))
    assert miss > 1e-3, miss


@pytest.mark.parametrize("window", [None, 6])
@pytest.mark.parametrize("softcap,scale,misses", [
    (5.0, 1.0, ("cap after the mask", "cap dropped", "offset ignored")),
    (50.0, 8.0, ("cap dropped", "offset ignored"))])
def test_planted_faults_miss(window, softcap, scale, misses):
    """Phase 23's planted forward faults lie far outside the float32
    tolerance of the checks they must fail, in the cases that can see
    them: at a cap of 5 on unit-normal queries all three (a masked key
    capped to -5 leaks e^-5 of a weight); at Gemma 2's 50 the queries
    are scaled x8 so that the cap binds (the masked keys' -50 leaks
    nothing there)."""
    rng = np.random.default_rng(4)
    q = torch.from_numpy(_normal(rng, (1, 4, 24, 16), scale))
    k = torch.from_numpy(_normal(rng, (1, 2, 40, 16)))
    v = torch.from_numpy(_normal(rng, (1, 2, 40, 16)))
    kw = dict(causal=True, window=window, softcap=softcap, q_offset=4)
    want = ref.flash_attention_ref(q, k, v, **kw)
    faults = ref.flash_attention_faults(q, k, v, **kw)
    assert sorted(faults) == ["cap after the mask", "cap dropped",
                              "offset ignored"]
    for name in misses:
        assert float((faults[name] - want).abs().max()) > 10 * 2e-3, name
    dq = torch.from_numpy(_normal(rng, (3, 8, 16)))
    dk, dv = (torch.from_numpy(_normal(rng, (3, 2, 50, 16)))
              for _ in range(2))
    length = torch.tensor([50, 20, 3])
    right = ref.decode_attention_ref(dq, dk, dv, length, softcap=5.0)
    for name, wrong in ref.decode_attention_faults(dq, dk, dv, length,
                                                   softcap=5.0).items():
        assert float((wrong - right).abs().max()) > 10 * 2e-3, name


def test_ops_take_the_cap_and_the_offset_on_the_cpu():
    """``ops`` on CPU tensors: the plain versions with the same
    arguments; a non-positive cap or a negative offset raises."""
    rng = np.random.default_rng(5)
    q = torch.from_numpy(_normal(rng, (1, 4, 5, 16), 4.0))
    k = torch.from_numpy(_normal(rng, (1, 2, 12, 16)))
    v = torch.from_numpy(_normal(rng, (1, 2, 12, 16)))
    got = ops.flash_attention(q, k, v, window=4, softcap=3.0, q_offset=7)
    want = ref.flash_attention_ref(q, k, v, window=4, softcap=3.0,
                                   q_offset=7)
    assert torch.equal(got, want)
    got = ops.decode_attention(q[:, :, 0], k, v, 9, softcap=3.0)
    want = ref.decode_attention_ref(q[:, :, 0], k, v, 9, softcap=3.0)
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="softcap"):
        ops.flash_attention(q, k, v, softcap=0.0)
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v, q_offset=-1)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The raw wrappers replaced by the plain versions: the autograd
    function runs as on the card."""
    monkeypatch.setattr(fmod, "flash_attention", ref.flash_attention_ref)
    monkeypatch.setattr(fmod, "flash_attention_lse",
                        ref.flash_attention_lse_ref)
    monkeypatch.setattr(fmod, "flash_attention_bwd",
                        ref.flash_attention_bwd_ref)


@pytest.mark.parametrize("d", [16, 32])      # the simt and f32tc routes
def test_flash_function_gradients_with_cap(plain_kernels, d):
    """``FlashAttention`` with a cap: the gradients of the plain version
    (recomputed on the simt route, the backward's plain model on f32tc);
    at ``q_offset > 0`` its forward runs and a gradient raises."""
    rng = np.random.default_rng(6)
    q, k, v, r = (torch.from_numpy(_normal(rng, shape, sc))
                  for shape, sc in (((1, 4, 9, d), 3.0), ((1, 2, 9, d), 3.0),
                                    ((1, 2, 9, d), 1.0), ((1, 4, 9, d), 1.0)))
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    want = torch.autograd.grad(ref.flash_attention_ref(
        *ins, causal=True, window=4, softcap=4.0), ins, r)
    ins = [x.clone().requires_grad_() for x in (q, k, v)]
    got = torch.autograd.grad(fmod.FlashAttention.apply(
        *ins, True, 4, 4.0, 0), ins, r)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)
    out = fmod.FlashAttention.apply(*ins, True, 4, 4.0, 3)
    assert torch.equal(out.detach(), ref.flash_attention_ref(
        q, k, v, window=4, softcap=4.0, q_offset=3))
    with pytest.raises(NotImplementedError, match="q_offset 3"):
        torch.autograd.grad(out, ins, r)


def _jweights(arch, fan_in=False):
    jcfg = jget_reduced(arch)
    tree = jax.tree_util.tree_map(np.asarray, jmaterialize(
        jbuild_param_specs(jcfg), jax.random.PRNGKey(0)))
    if fan_in:
        specs = jbuild_param_specs(jcfg)

        def scale(t, sp):
            if isinstance(t, dict):
                return {n: scale(x, sp[n]) for n, x in t.items()}
            if sp.axes[-3:-1] in (("embed", "heads"), ("embed", "kv_heads")):
                return t * np.float32((t.shape[-2] / t.shape[-3]) ** 0.5)
            return t
        tree = scale(tree, specs)
    return jcfg, tree


@pytest.mark.parametrize("arch,window", [("qwen2-5-7b", None),
                                         ("gemma3-1b", 4)])
@pytest.mark.parametrize("softcap", [5.0, 50.0])
def test_gqa_attention_with_cap_matches_reference(arch, window, softcap):
    """The port's ``gqa_attention`` against the reference's with
    ``attn_logit_softcap`` replaced on both configs: a 12-token prefill
    into a 20-row cache, then a 5-token step at offset 12 (the port's
    multi-token path) and a 1-token step at 17 (decode)."""
    jcfg, tree = _jweights(arch)
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=softcap)
    cfg = dataclasses.replace(get_reduced(arch), attn_logit_softcap=softcap)
    params = params_from_numpy(cfg, tree, "cpu")
    jp = tree["groups"]["main"]["pos0"]["attn"]
    p = params["groups"]["main"]["pos0"]["attn"]
    jp = {n: x[0] for n, x in jp.items()}
    p = {n: x[0] for n, x in p.items()}
    rng = np.random.default_rng(7)
    hkv, hd = cfg.n_kv_heads, cfg.head_dim_
    cache = {n: torch.zeros((1, 20, hkv, hd)) for n in ("k", "v")}
    jcache = {n: jnp.zeros((1, 20, hkv, hd)) for n in ("k", "v")}
    for off, s in ((0, 12), (12, 5), (17, 1)):
        x = _normal(rng, (1, s, cfg.d_model))
        pos = off + np.arange(s)[None]
        want, jcache = jattn.gqa_attention(
            {n: jnp.asarray(a) for n, a in jp.items()}, jnp.asarray(x),
            jnp.asarray(pos), cfg=jcfg, window=window, cache=jcache,
            cache_offset=jnp.int32(off))
        got, cache = attn.gqa_attention(
            p, torch.from_numpy(x), torch.from_numpy(pos), cfg=cfg,
            window=window, cache=cache, cache_offset=off)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{off}, {s}")


_JIT = {}


@pytest.mark.parametrize("arch", ["qwen2-5-7b", "gemma3-1b"])
def test_train_loss_grads_with_cap_match_reference(arch):
    """``train_loss`` and every gradient leaf with
    ``attn_logit_softcap = 5.0`` on both sides (at the d_model fan-in
    law) against ``jax.value_and_grad`` of the reference: loss within
    1e-5 relative, each leaf within 1e-4 of its max |g| plus 1e-7."""
    jcfg, tree = _jweights(arch, fan_in=True)
    jcfg = dataclasses.replace(jcfg, attn_logit_softcap=5.0)
    cfg = dataclasses.replace(get_reduced(arch), attn_logit_softcap=5.0)
    rng = np.random.default_rng(8)
    batch = {n: rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)
             for n in ("tokens", "labels")}
    if arch not in _JIT:
        _JIT[arch] = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain_loss(p, b, jcfg, JRunFlags(remat="full"))))
    jl, jg = _JIT[arch](jax.tree_util.tree_map(jnp.asarray, tree),
                        {n: jnp.asarray(x) for n, x in batch.items()})
    want = {jax.tree_util.keystr(k): np.asarray(x) for k, x in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    loss, grads = value_and_grad(
        params_from_numpy(cfg, tree, "cpu"),
        {n: torch.from_numpy(x) for n, x in batch.items()}, cfg,
        RunFlags(remat="full"))
    assert abs(float(loss) - float(jl)) <= 1e-5 * abs(float(jl))
    got = dict(leaves_with_paths(grads))
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        err = np.abs(g.numpy() - w).max()
        assert err <= 1e-4 * np.abs(w).max() + 1e-7, (path, err)
    # the cap binds: the uncapped port misses the bound on some leaf
    _, base = value_and_grad(
        params_from_numpy(get_reduced(arch), tree, "cpu"),
        {n: torch.from_numpy(x) for n, x in batch.items()},
        get_reduced(arch), RunFlags(remat="full"))
    miss = max(np.abs(g.numpy() - want[path]).max() /
               (1e-4 * np.abs(want[path]).max() + 1e-7)
               for path, g in leaves_with_paths(base))
    assert miss > 10, miss
