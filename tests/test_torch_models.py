"""The port's model stack (config, params, layers, GQA attention with its
KV cache, the RG-LRU block with its state, prefill / decode) against the
JAX package at reduced Qwen2.5-7B and reduced RecurrentGemma-9B, with
the reference's own weights carried over through
``convert.params_from_numpy``.

Contract: prefill and decode logits (and every cache and state leaf)
within 1e-4 of the reference (float32), windowed decode included;
decode consistent with the cache-free forward (the reference's
teacher-forcing bound, 2e-3); the full configs' parameter counts and
checkpoint bytes equal to the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.models import BlockSpec as JBlockSpec
from repro.models import FFN as JFFN
from repro.models import MLAConfig as JMLAConfig
from repro.models import Mixer as JMixer
from repro.models import RunFlags as JRunFlags
from repro.models import ScanGroup as JScanGroup
from repro.models import build_cache_specs as jbuild_cache_specs
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import materialize as jmaterialize
from repro.models import param_bytes as jparam_bytes
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import (BlockSpec, FFN, Mixer, MLAConfig, RunFlags,
                                ScanGroup, build_cache_specs,
                                build_param_specs, decode_step, materialize,
                                param_bytes, param_count, prefill)
from repro_torch.models.layers import rmsnorm, unembed
from repro_torch.models.model import _prepare_inputs, _run_groups, \
    build_meta

ARCH = "qwen2-5-7b"
RG = "recurrentgemma-9b"
JFLAGS = JRunFlags(remat="none")
FLAGS = RunFlags(remat="none")


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def weights():
    """The reference's reduced-Qwen weights, and the port's copy."""
    jcfg = jget_reduced(ARCH)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    return jcfg, jp, cfg, params_from_numpy(cfg, _np_tree(jp), "cpu")


def test_registry_and_config_match_reference():
    assert ARCHS == [ARCH, RG, "gemma3-1b", "granite-20b", "command-r-35b",
                     "internvl2-26b", "mixtral-8x22b", "minicpm3-4b",
                     "deepseek-v2-236b", "whisper-base", "xlstm-125m"]
    for ours, theirs in ((get_config(ARCH), jget_config(ARCH)),
                         (get_reduced(ARCH), jget_reduced(ARCH))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        for key in ("param_dtype", "compute_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                np.dtype(b.pop(key)).name
        assert a == b
    full = get_config(ARCH)
    assert param_count(build_param_specs(full)) == \
        jget_config(ARCH).param_count() == full.param_count()
    assert param_bytes(build_param_specs(full)) == \
        jparam_bytes(jbuild_param_specs(jget_config(ARCH)))


def test_recurrentgemma_config_matches_reference():
    """38 layers (26 RG-LRU, 12 local attention), tied embeddings:
    parameter count and bf16 checkpoint bytes equal to the reference's."""
    for ours, theirs in ((get_config(RG), jget_config(RG)),
                         (get_reduced(RG), jget_reduced(RG))):
        a, b = dataclasses.asdict(ours), dataclasses.asdict(theirs)
        for key in ("param_dtype", "compute_dtype"):
            assert str(a.pop(key)).split(".")[-1] == \
                np.dtype(b.pop(key)).name
        assert a == b
    full = get_config(RG)
    mixers = [blk.mixer for g in full.groups for _ in range(g.repeats)
              for blk in g.pattern]
    assert mixers.count(Mixer.RGLRU) == 26 and mixers.count(Mixer.ATTN) == 12
    assert param_count(build_param_specs(full)) == \
        jget_config(RG).param_count() == full.param_count()
    assert param_bytes(build_param_specs(full)) == \
        jparam_bytes(jbuild_param_specs(jget_config(RG))) == 18_793_660_416


def _assert_leaves_close(jtree, tree, tol=1e-4):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def test_recurrentgemma_prefill_and_decode_match_reference():
    """Reduced RecurrentGemma (RG-LRU, RG-LRU, local attention with
    window 8, then two RG-LRU): a batch-2 12-token prefill, past the
    window, then 8 greedy decode steps; logits and every cache and state
    leaf within 1e-4 of the reference's ``prefill`` / ``decode_step``."""
    jcfg, cfg = jget_reduced(RG), get_reduced(RG)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jp), "cpu")
    B, S, T = 2, 12, 24
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    jc = jmaterialize(jbuild_cache_specs(jcfg, B, T, jnp.float32),
                      jax.random.PRNGKey(0))
    caches = caches_from_numpy(_np_tree(jc), "cpu")
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                      jcfg, JFLAGS)
    tl, caches = prefill(params, {"tokens": torch.from_numpy(toks)}, caches,
                         cfg, FLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _assert_leaves_close(jc, caches)
    for pos in range(S, S + 8):
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        assert nxt.tolist() == torch.argmax(tl, -1)[:, None].tolist()
        jl, jc = jdecode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                              jnp.int32(pos), jcfg, JFLAGS)
        tl, caches = decode_step(params, torch.from_numpy(nxt), caches, pos,
                                 cfg, FLAGS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    _assert_leaves_close(jc, caches)


def test_params_carry_over_exactly(weights):
    jcfg, jp, cfg, params = weights
    wq = params["groups"]["main"]["pos0"]["attn"]["wq"]
    assert wq.shape == (2, 64, 4, 16) and wq.dtype == torch.float32
    np.testing.assert_array_equal(
        wq.numpy(), np.asarray(jp["groups"]["main"]["pos0"]["attn"]["wq"]))
    bad = _np_tree(jp)
    bad["embed"]["head"] = bad["embed"]["head"][:, :-1]
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(cfg, bad, "cpu")


@pytest.mark.parametrize("cache_dtype", ["f32", "int8"])
def test_prefill_and_decode_match_reference(weights, cache_dtype):
    """Reduced Qwen: a batch-2 prefill into a longer cache, then 4 greedy
    decode steps; logits within 1e-4 of the reference at every step."""
    jcfg, jp, cfg, params = weights
    jdt, dt = {"f32": (jnp.float32, torch.float32),
               "int8": (jnp.int8, torch.int8)}[cache_dtype]
    B, S, T = 2, 7, 16
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (B, S))
    jc = jmaterialize(jbuild_cache_specs(jcfg, B, T, jdt),
                      jax.random.PRNGKey(0))
    caches = caches_from_numpy(_np_tree(jc), "cpu")
    assert jax.tree_util.tree_structure(jc) == \
        jax.tree_util.tree_structure(materialize(
            build_cache_specs(cfg, B, T, dt), torch.Generator(), "cpu"))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                      jcfg, JFLAGS)
    tl, caches = prefill(params, {"tokens": torch.from_numpy(toks)}, caches,
                         cfg, FLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for pos in range(S, S + 4):
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        assert nxt.tolist() == torch.argmax(tl, -1)[:, None].tolist()
        jl, jc = jdecode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                              jnp.int32(pos), jcfg, JFLAGS)
        tl, caches = decode_step(params, torch.from_numpy(nxt), caches, pos,
                                 cfg, FLAGS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    for path, leaf in jax.tree_util.tree_flatten_with_path(jc)[0]:
        got = caches
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   rtol=1e-4, atol=1e-4)


def test_decode_matches_teacher_forcing(weights):
    """Greedy decode logits must match the cache-free forward run on the
    same (prompt + generated) tokens: the cache path is consistent."""
    _, _, cfg, params = weights
    B, S = 1, 6
    tok = torch.from_numpy(
        np.random.default_rng(1).integers(0, cfg.vocab_size, (B, S)))
    caches = materialize(build_cache_specs(cfg, B, S + 3, torch.float32),
                         torch.Generator(), "cpu")
    logits, caches = prefill(params, {"tokens": tok}, caches, cfg, FLAGS)
    t1 = torch.argmax(logits, -1)[:, None]
    logits_dec, _ = decode_step(params, t1, caches, S, cfg, FLAGS)

    full = torch.cat([tok, t1], dim=1)
    x, positions, _ = _prepare_inputs(params, cfg, {"tokens": full})
    h, _, _ = _run_groups(params, cfg.groups, cfg, x, positions,
                          build_meta(cfg))
    h = rmsnorm(params["final_norm"], h[:, -1:, :], cfg.norm_eps)
    want = unembed(params["embed"], h, cfg)[:, 0, :]
    np.testing.assert_allclose(logits_dec.numpy(), want.numpy(), rtol=2e-3,
                               atol=2e-3)


def test_materialize_init_laws_and_independent_streams():
    cfg = get_reduced(ARCH)
    specs = build_param_specs(cfg)
    a = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    b = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    c = materialize(specs, torch.Generator().manual_seed(1), "cpu")
    wi = a["groups"]["main"]["pos0"]["ffn"]["wi_gate"]       # [2, 64, 128]
    assert torch.equal(wi, b["groups"]["main"]["pos0"]["ffn"]["wi_gate"])
    assert not torch.equal(wi, c["groups"]["main"]["pos0"]["ffn"]["wi_gate"])
    assert abs(float(wi.std()) - 64 ** -0.5) < 0.01          # fan-in law
    assert abs(float(a["embed"]["table"].std()) - 1.0) < 0.05  # embed law
    assert torch.equal(a["final_norm"]["scale"], torch.ones(64))
    # one stream per leaf: dropping a leaf reshuffles no other
    del specs["embed"]["head"]
    d = materialize(specs, torch.Generator().manual_seed(0), "cpu")
    assert torch.equal(d["embed"]["table"], a["embed"]["table"])
    assert not torch.equal(wi[0], wi[1])                 # layers differ


def test_cases_without_a_kernel_raise(weights):
    """The cases that once raised for want of a kernel path are computed
    through the kernels now and match the reference: a logit softcap
    (prefill and a decode step) and a multi-token step at a nonzero
    cache offset (chunked prefill, ``decode_step`` of 3 tokens at 3).
    Windowed decode has its kernel path too (a view of the window's
    cache rows): it matches the reference's masked decode.  The blocks
    that once raised at build time (mLSTM, MLA, no FFN) build now, with
    the reference's parameter trees."""
    jcfg, jp, cfg, params = weights
    toks = torch.tensor([[1, 2, 3]])
    jtoks = jnp.asarray(toks.numpy(), jnp.int32)
    caches = materialize(build_cache_specs(cfg, 1, 8, torch.float32),
                         torch.Generator(), "cpu")
    capped = dataclasses.replace(cfg, attn_logit_softcap=30.0)
    jcapped = dataclasses.replace(jcfg, attn_logit_softcap=30.0)
    jcc = jmaterialize(jbuild_cache_specs(jcapped, 1, 8, jnp.float32),
                       jax.random.PRNGKey(0))
    tl, cc = prefill(params, {"tokens": toks}, caches, capped, FLAGS)
    jl, jcc = jprefill(jp, {"tokens": jtoks}, jcc, jcapped, JFLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    tl, _ = decode_step(params, torch.full((1, 1), 7), cc, 3, capped,
                        FLAGS)
    jl, _ = jdecode_step(jp, jnp.full((1, 1), 7, jnp.int32), jcc,
                         jnp.int32(3), jcapped, JFLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    blk = BlockSpec(Mixer.ATTN, FFN.DENSE, window=4)
    windowed = dataclasses.replace(cfg, groups=(ScanGroup("main", 2,
                                                          (blk,)),))
    jwindowed = dataclasses.replace(jcfg, groups=(JScanGroup(
        "main", 2, (JBlockSpec(JMixer.ATTN, JFFN.DENSE, window=4),)),))
    tl, c2 = prefill(params, {"tokens": toks}, caches, windowed, FLAGS)
    jc = jmaterialize(jbuild_cache_specs(jwindowed, 1, 8, jnp.float32),
                      jax.random.PRNGKey(0))
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks.numpy(), jnp.int32)},
                      jc, jwindowed, JFLAGS)
    cw = c2
    for pos, tok in zip(range(3, 8), (7, 1, 9, 4, 2)):   # window bites at 4
        jl, jc = jdecode_step(jp, jnp.full((1, 1), tok, jnp.int32), jc,
                              jnp.int32(pos), jwindowed, JFLAGS)
        tl, cw = decode_step(params, torch.full((1, 1), tok), cw, pos,
                             windowed, FLAGS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    jc = jmaterialize(jbuild_cache_specs(jcfg, 1, 8, jnp.float32),
                      jax.random.PRNGKey(0))
    _, jc = jprefill(jp, {"tokens": jtoks}, jc, jcfg, JFLAGS)
    _, c3 = prefill(params, {"tokens": toks}, caches, cfg, FLAGS)
    tl, _ = decode_step(params, toks, c3, 3, cfg, FLAGS)
    jl, _ = jdecode_step(jp, jtoks, jc, jnp.int32(3), jcfg, JFLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    mla = MLAConfig(q_lora_rank=32, kv_lora_rank=16, qk_nope_head_dim=16,
                    qk_rope_head_dim=8, v_head_dim=16)
    for mixer, ffn in ((Mixer.MLSTM, FFN.DENSE), (Mixer.MLA, FFN.DENSE),
                       (Mixer.ATTN, FFN.NONE)):
        other = dataclasses.replace(
            cfg, groups=(ScanGroup("main", 2, (BlockSpec(mixer, ffn),)),),
            mla=mla)
        jother = dataclasses.replace(
            jcfg, groups=(JScanGroup("main", 2, (JBlockSpec(
                JMixer(mixer.value), JFFN(ffn.value)),)),),
            mla=JMLAConfig(**dataclasses.asdict(mla)))
        got = build_param_specs(other)["groups"]["main"]["pos0"]
        want = jbuild_param_specs(jother)["groups"]["main"]["pos0"]
        assert {k: sorted(v) for k, v in got.items()} == \
            {k: sorted(v) for k, v in want.items()}, (mixer, ffn)
