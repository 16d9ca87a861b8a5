"""The port's encoder tower and cross-attention (``models/model._encode``,
``models/blocks.cross_kv``, ``models/attention.gqa_attention``'s
``kv_override``) against the JAX package's at reduced whisper-base, on
the reference's own weights carried over through
``convert.params_from_numpy``.

Contract, float32, 1e-4: the cross-attention output of a prefill (a
non-causal ``flash_attention`` of S queries against the T encoder rows)
and of a decode step (``decode_attention`` over all T rows) equals the
reference's ``gqa_attention(kv_override=...)``, whose query is not
roped (so the output does not depend on the positions), and the cache
passes through; ``cross_kv`` and the bidirectional ``_encode`` equal
the reference's.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import RunFlags as JRunFlags
from repro.models import attention as jattn
from repro.models import blocks as jblocks
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.models import model as jmodel
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import RunFlags
from repro_torch.models import attention as attn
from repro_torch.models import blocks
from repro_torch.models import model

ARCH = "whisper-base"
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    jcfg = jget_reduced(ARCH)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    return jcfg, jp, cfg, params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jp), "cpu")


def _layer0(tree):
    """Decoder layer 0's block parameters."""
    if isinstance(tree, dict):
        return {k: _layer0(v) for k, v in tree.items()}
    return tree[0]


def _arrays(shape, seed):
    a = np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)
    return jnp.asarray(a), torch.from_numpy(a)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("s,off", [(5, 0), (1, 9)],
                         ids=["prefill", "decode-step"])
def test_cross_attention_matches_reference(weights, s, off):
    """Cross-attention of ``s`` queries at positions ``off``.. against
    the T = 8 encoder rows: equal to the reference's, unchanged when the
    positions move (q is not roped), the cache passed through."""
    jcfg, jp, cfg, params = weights
    jblk, blk = _layer0(jp["groups"]["dec"]["pos0"]), \
        _layer0(params["groups"]["dec"]["pos0"])
    t, hkv, hd = cfg.encoder.source_len, cfg.n_kv_heads, cfg.head_dim_
    jx, x = _arrays((2, s, cfg.d_model), 0)
    jek, ek = _arrays((2, t, hkv, hd), 1)
    jev, ev = _arrays((2, t, hkv, hd), 2)
    pos = np.broadcast_to(off + np.arange(s)[None], (2, s))
    want, _ = jattn.gqa_attention(jblk["cross"], jx, jnp.asarray(pos),
                                  cfg=jcfg, causal=False,
                                  kv_override=(jek, jev))
    marker = {"kept": torch.zeros(1)}
    got, passed = attn.gqa_attention(
        blk["cross"], x, torch.from_numpy(pos.copy()), cfg=cfg,
        causal=False, cache=marker, cache_offset=off,
        kv_override=(ek, ev))
    assert passed is marker
    _close(got, want)
    moved, _ = attn.gqa_attention(
        blk["cross"], x, torch.from_numpy(pos + 40), cfg=cfg, causal=False,
        cache_offset=off, kv_override=(ek, ev))
    assert torch.equal(moved, got)


def test_cross_kv_matches_reference(weights):
    jcfg, jp, cfg, params = weights
    jblk, blk = _layer0(jp["groups"]["dec"]["pos0"]), \
        _layer0(params["groups"]["dec"]["pos0"])
    jenc, enc = _arrays((2, cfg.encoder.source_len, cfg.d_model), 3)
    for got, want in zip(blocks.cross_kv(blk, enc),
                         jblocks.cross_kv(jblk, jenc)):
        _close(got, want)


def test_encode_matches_reference(weights):
    """The bidirectional encoder tower over 8 source frames: roped
    self-attention with no causal mask (a non-causal
    ``flash_attention`` a layer), dense FFN, final norm."""
    jcfg, jp, cfg, params = weights
    jsrc, src = _arrays((2, cfg.encoder.source_len, cfg.d_model), 4)
    want = jmodel._encode(jp, jcfg, jsrc, JRunFlags(remat="none"))
    got = model._encode(params, cfg, src, RunFlags(remat="none"))
    assert got.shape == want.shape
    _close(got, want)
    # bidirectional: the first frame's output depends on the last frame
    late = src.clone()
    late[:, -1] += 1.0
    again = model._encode(params, cfg, late, RunFlags(remat="none"))
    assert not torch.allclose(again[:, 0], got[:, 0])


def test_encoder_param_and_cache_specs_match_reference(weights):
    """The encoder subtree of the parameters and the decoder blocks'
    cross K/V cache rows of ``source_len``."""
    jcfg, _, cfg, _ = weights

    def shapes(tree):
        if isinstance(tree, dict):
            return {k: shapes(v) for k, v in tree.items()}
        return (tuple(tree.shape), tuple(tree.axes), tree.init)

    assert shapes(model.build_param_specs(cfg)["encoder"]) == \
        shapes(jmodel.build_param_specs(jcfg)["encoder"])
    assert shapes(model.build_cache_specs(cfg, 3, 16, torch.float32)) == \
        shapes(jmodel.build_cache_specs(jcfg, 3, 16, jnp.float32))
