"""The port's MLA (multi-head latent attention, ``models/attention.py``)
against the JAX package's at reduced minicpm3-4b, on the reference's own
weights carried over through ``convert.params_from_numpy``.

Contract: ``mla_project``, the naive (prefill) path and the absorbed
(decode) path each within 1e-4 of the reference in float32 (the
absorbed path also for a multi-token step at a nonzero offset, and with
its cache written); the naive and absorbed paths within 1e-4 of each
other at the same positions; in bfloat16 (with a bfloat16 and with a
float32 cache, the engine's) within 2e-2 of the reference's bfloat16,
whose scores are float32.  The naive path is query-chunked by
``chunk_q`` as the reference's (whole where ``chunk_q`` does not divide
S or is not below it): within the same bounds of the reference's at the
same ``chunk_q`` and of its own whole path, and a chunk's scores are its
working set.
"""
import dataclasses

import _torch_spmd
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import attention as jattn
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import attention as attn

ARCH = "minicpm3-4b"
TOL = 1e-4
BF16_TOL = 2e-2


def _layer0(tree):
    return {k: v[0] for k, v in tree["groups"]["main"]["pos0"]["attn"]
            .items()}


def _weights(dtype):
    """Layer 0's MLA weights of the reduced config in ``dtype`` (norm
    scales float32), for both packages, and both configs."""
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    jcfg = dataclasses.replace(jget_reduced(ARCH), param_dtype=jdt,
                               compute_dtype=jdt)
    cfg = dataclasses.replace(get_reduced(ARCH), param_dtype=dtype,
                              compute_dtype=dtype)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")
    return jcfg, _layer0(jp), cfg, _layer0(params)


@pytest.fixture(scope="module")
def f32():
    return _weights(torch.float32)


@pytest.fixture(scope="module")
def bf16():
    return _weights(torch.bfloat16)


def _x(cfg, b, s, seed, dtype=torch.float32):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype({torch.float32: jnp.float32,
                                torch.bfloat16: jnp.bfloat16}[dtype])
    return jx, torch.from_numpy(x).to(dtype)


def _pos(b, s, off=0):
    p = np.broadcast_to(off + np.arange(s)[None], (b, s))
    return jnp.asarray(p, jnp.int32), torch.from_numpy(p.copy())


def _cache(cfg, b, t, filled, seed, dtype=torch.float32):
    """An MLA cache of ``t`` rows, the first ``filled`` random (earlier
    tokens' latents), the rest zeros, for both packages."""
    rng = np.random.default_rng(seed)
    m = cfg.mla
    out = {}
    for name, width in (("c_kv", m.kv_lora_rank),
                        ("k_rope", m.qk_rope_head_dim)):
        a = np.zeros((b, t, width), np.float32)
        a[:, :filled] = rng.standard_normal((b, filled, width))
        out[name] = a
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    return ({k: jnp.asarray(v).astype(jdt) for k, v in out.items()},
            {k: torch.from_numpy(v).to(dtype) for k, v in out.items()})


def _close(got, want, tol, label=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def test_mla_project_matches_reference(f32):
    jcfg, jp, cfg, p = f32
    jx, x = _x(cfg, 2, 7, 0)
    jpos, pos = _pos(2, 7, 3)
    want = jattn.mla_project(jp, jx, jpos, jcfg, 10_000.0)
    got = attn.mla_project(p, x, pos, cfg, 10_000.0)
    for name, g, w in zip(("q_nope", "q_rope", "c_kv", "k_rope"), got,
                          want):
        assert tuple(g.shape) == w.shape
        _close(g, w, TOL, name)


def test_mla_naive_matches_reference(f32):
    jcfg, jp, cfg, p = f32
    jx, x = _x(cfg, 2, 9, 1)
    jpos, pos = _pos(2, 9)
    want = jattn.mla_attention_naive(jp, jx, jpos, cfg=jcfg)
    got, none = attn.mla_attention_naive(p, x, pos, cfg=cfg)
    assert none is None
    _close(got, want, TOL)


@pytest.mark.parametrize("s,off", [(1, 5), (3, 4)],
                         ids=["one-token", "three-tokens"])
def test_mla_absorbed_matches_reference(f32, s, off):
    """A decode step against a cache of 12 rows whose first ``off`` hold
    earlier latents: the output and the written cache; a 3-token step at
    a nonzero offset is legal, as in the reference."""
    jcfg, jp, cfg, p = f32
    jx, x = _x(cfg, 2, s, 2)
    jpos, pos = _pos(2, s, off)
    jc, c = _cache(cfg, 2, 12, off, 3)
    want, jnc = jattn.mla_attention_absorbed(jp, jx, jpos, cfg=jcfg,
                                             cache=jc, cache_offset=off)
    got, nc = attn.mla_attention_absorbed(p, x, pos, cfg=cfg, cache=c,
                                          cache_offset=off)
    _close(got, want, TOL)
    for name in ("c_kv", "k_rope"):
        _close(nc[name], jnc[name], TOL, name)


def test_mla_naive_and_absorbed_agree(f32):
    """The same prompt: the naive prefill (its cache written) against
    the absorbed path over all of it at offset 0, and against an
    absorbed step of the last token on the naive prefill's cache of the
    others."""
    _, _, cfg, p = f32
    s = 8
    _, x = _x(cfg, 2, s, 4)
    _, pos = _pos(2, s)
    _, empty = _cache(cfg, 2, s + 2, 0, 5)
    naive, cache = attn.mla_attention_naive(p, x, pos, cfg=cfg, cache=empty)
    absorbed, cache2 = attn.mla_attention_absorbed(
        p, x, pos, cfg=cfg, cache=empty, cache_offset=0)
    _close(absorbed, naive.numpy(), TOL)
    for name in ("c_kv", "k_rope"):
        assert torch.equal(cache[name], cache2[name])
    _, head = attn.mla_attention_naive(p, x[:, :-1], pos[:, :-1], cfg=cfg,
                                       cache=empty)
    last, _ = attn.mla_attention_absorbed(p, x[:, -1:], pos[:, -1:],
                                          cfg=cfg, cache=head,
                                          cache_offset=s - 1)
    _close(last, naive[:, -1:].numpy(), TOL)


@pytest.mark.parametrize("cache_dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16-cache", "f32-cache"])
def test_mla_bf16_matches_reference(bf16, cache_dtype):
    """bf16 weights and activations: the naive path, and the absorbed
    step against a bf16 cache or the engine's float32 one (jax's
    promotion makes the context float32 there), within 2e-2 of the
    reference's bf16."""
    jcfg, jp, cfg, p = bf16
    jx, x = _x(cfg, 2, 6, 6, torch.bfloat16)
    jpos, pos = _pos(2, 6)
    want = jattn.mla_attention_naive(jp, jx, jpos, cfg=jcfg)
    got, _ = attn.mla_attention_naive(p, x, pos, cfg=cfg)
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL, "naive")
    jx, x = _x(cfg, 2, 1, 7, torch.bfloat16)
    jpos, pos = _pos(2, 1, 6)
    jc, c = _cache(cfg, 2, 10, 6, 8, cache_dtype)
    want, jnc = jattn.mla_attention_absorbed(jp, jx, jpos, cfg=jcfg,
                                             cache=jc, cache_offset=6)
    got, nc = attn.mla_attention_absorbed(p, x, pos, cfg=cfg, cache=c,
                                          cache_offset=6)
    assert got.dtype == torch.bfloat16 and nc["c_kv"].dtype == cache_dtype
    _close(got, want, BF16_TOL, "absorbed")
    for name in ("c_kv", "k_rope"):
        _close(nc[name], jnc[name], BF16_TOL, name)


def test_mla_cache_spec_matches_reference():
    cfg, jcfg = get_reduced(ARCH), jget_reduced(ARCH)
    got = attn.mla_cache_spec(cfg, 3, 16, torch.float32)
    want = jattn.mla_cache_spec(jcfg, 3, 16, jnp.float32)
    assert {k: (v.shape, v.axes, v.init) for k, v in got.items()} == \
        {k: (v.shape, v.axes, v.init) for k, v in want.items()}


@pytest.mark.parametrize("dtype,s,chunk", [
    ("f32", 32, 8), ("f32", 30, 8), ("f32", 32, 32), ("f32", 16, 64),
    ("bf16", 32, 8)],
    ids=["chunked", "chunk-does-not-divide", "one-chunk", "chunk-above-s",
         "bf16-chunked"])
def test_mla_chunked_naive_matches_reference(f32, bf16, dtype, s, chunk):
    """The naive path at ``chunk_q=chunk``: chunked where the chunk
    divides S and lies below it (4 chunks of 8 at S = 32), else whole,
    both as the reference's rule says; against the reference's
    ``mla_attention_naive`` at the same ``chunk_q`` and against the
    port's whole path (``chunk_q`` = S), within 1e-4 in float32, 2e-2
    in bfloat16."""
    jcfg, jp, cfg, p = f32 if dtype == "f32" else bf16
    tdt, tol = ((torch.float32, TOL) if dtype == "f32" else
                (torch.bfloat16, BF16_TOL))
    jx, x = _x(cfg, 2, s, 9, tdt)
    jpos, pos = _pos(2, s)
    want = jattn.mla_attention_naive(jp, jx, jpos, cfg=jcfg, chunk_q=chunk)
    got, _ = attn.mla_attention_naive(p, x, pos, cfg=cfg, chunk_q=chunk)
    whole, _ = attn.mla_attention_naive(p, x, pos, cfg=cfg, chunk_q=s)
    assert got.dtype == tdt
    _close(got, want, tol, "reference")
    _close(got, whole.float().numpy(), tol, "whole")


def test_mla_chunk_is_the_working_set(f32):
    """At S = 32 and ``chunk_q`` 8 no [B, H, 32, 32] score tensor is
    made, only [B, H, 8, 32] ones; the whole path makes them (so the
    check can fail)."""
    _, _, cfg, p = f32
    _, x = _x(cfg, 2, 32, 10)
    _, pos = _pos(2, 32)
    seen = {}
    for chunk in (8, 32):
        with _torch_spmd._Allocations() as mode:
            attn.mla_attention_naive(p, x, pos, cfg=cfg, chunk_q=chunk)
        seen[chunk] = set(mode.shapes)
    h = cfg.n_heads
    assert (2, h, 32, 32) not in seen[8] and (2, h, 8, 32) in seen[8]
    assert (2, h, 32, 32) in seen[32]
