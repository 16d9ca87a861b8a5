"""Multi-token steps at a cache offset (chunked prefill through
``decode_step``) in the port's model, against the JAX package on the CPU.

The reference's ``decode_step`` takes tokens [B, C] at any ``pos``: the
positions are ``pos + arange(C)``, and its GQA reads the cache back and
masks by causality and the write frontier.  The port's GQA hands the
cache rows the step may see to ``flash_attention`` with a query offset
(``models/attention.py``); MLA steps ``C`` tokens in its absorbed form,
the RG-LRU block carries its conv and scan state, and whisper's
cross-attention takes the ``C`` queries against every encoder row.

Contract, float32 at the reduced configs with the reference's weights
carried over: a prompt prefilled, then two ``decode_step``s of several
tokens and one of one token, each step's logits within 1e-4 (rtol and
atol) of the reference's on qwen2-5-7b (also with an int8 cache, and
with ``attn_logit_softcap`` set on both sides), gemma3-1b (its 8-token
window crossed inside the chunks; also capped), recurrentgemma-9b,
whisper-base and minicpm3-4b; the port's chunked prefill within 1e-4 of
its one-shot prefill (the last logits and every cache row written);
xLSTM refusing a step of more than one token, as the reference does.

With an int8 cache the steps start from the reference's own quantized
prefill cache (``convert.caches_from_numpy``): a K or V element within
an ulp of a rounding boundary of the int8 grid rounds to another level
in the two packages (the reference is compiled at XLA optimisation
level 0 under these tests), which moves this config's prefill logits by
~3e-3; the prefill into an int8 cache is ``test_torch_configs.py``'s.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import RunFlags as JRunFlags
from repro.models import build_cache_specs as jbuild_cache_specs
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import materialize as jmaterialize
from repro.models import prefill as jprefill
from repro_torch.configs import get_reduced
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import (RunFlags, build_cache_specs, decode_step,
                                materialize, prefill)
from repro_torch.models.params import leaves_with_paths

JFLAGS = JRunFlags(remat="none")
FLAGS = RunFlags(remat="none")
PROMPT, CHUNKS, CACHE = 6, (5, 4, 1), 20
_W = {}


def _setup(arch, softcap=None):
    """(jcfg, jp, cfg, params) with the reference's weights carried over;
    ``softcap`` replaced on both configs."""
    if arch not in _W:
        jcfg = jget_reduced(arch)
        jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
        tree = jax.tree_util.tree_map(np.asarray, jp)
        _W[arch] = jcfg, jp, tree
    jcfg, jp, tree = _W[arch]
    cfg = get_reduced(arch)
    if softcap is not None:
        jcfg = dataclasses.replace(jcfg, attn_logit_softcap=softcap)
        cfg = dataclasses.replace(cfg, attn_logit_softcap=softcap)
    return jcfg, jp, cfg, params_from_numpy(cfg, tree, "cpu")


def _batch(cfg, tokens):
    rng = np.random.default_rng(1)
    out = {"tokens": tokens}
    if cfg.encoder is not None:
        out["source_embeds"] = 0.5 * rng.standard_normal(
            (tokens.shape[0], cfg.encoder.source_len,
             cfg.d_model)).astype(np.float32)
    return out


def _tokens(cfg, n, b=2):
    return np.random.default_rng(0).integers(
        0, cfg.vocab_size, (b, n)).astype(np.int32)


@pytest.mark.parametrize("arch,softcap,cache_dtype,prompt", [
    ("qwen2-5-7b", None, "float32", PROMPT),
    ("qwen2-5-7b", None, "int8", PROMPT),
    ("qwen2-5-7b", 5.0, "float32", PROMPT),
    ("gemma3-1b", None, "float32", PROMPT),
    ("gemma3-1b", 5.0, "float32", PROMPT),
    ("gemma3-1b", None, "float32", 140),
    ("recurrentgemma-9b", None, "float32", PROMPT),
    ("whisper-base", None, "float32", PROMPT),
    ("minicpm3-4b", None, "float32", PROMPT)])
def test_multi_token_steps_match_reference(arch, softcap, cache_dtype,
                                           prompt):
    """Prefill of ``prompt`` tokens, then steps of 5, 4 and 1 tokens
    (gemma3's and recurrentgemma's 8-token windows crossed inside a
    chunk; after a 140-token prompt gemma3's windowed steps read a cache
    view from row 128, where the window's first row, 133, is rounded
    down to), both packages, logits of every call compared."""
    jcfg, jp, cfg, params = _setup(arch, softcap)
    toks = _tokens(cfg, prompt + sum(CHUNKS))
    cache = prompt + sum(CHUNKS) + 4
    jd, td = {"float32": (jnp.float32, torch.float32),
              "int8": (jnp.int8, torch.int8)}[cache_dtype]
    jc = jmaterialize(jbuild_cache_specs(jcfg, 2, cache, jd),
                      jax.random.PRNGKey(0))
    caches = materialize(build_cache_specs(cfg, 2, cache, td),
                         torch.Generator(), "cpu")
    batch = _batch(cfg, toks[:, :prompt])
    jl, jc = jprefill(jp, {k: jnp.asarray(v) for k, v in batch.items()}, jc,
                      jcfg, JFLAGS)
    tl, caches = prefill(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()}, caches, cfg,
                         FLAGS)
    if cache_dtype == "int8":
        caches = caches_from_numpy(jax.tree_util.tree_map(np.asarray, jc),
                                   "cpu")
    else:
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    pos = prompt
    for c in CHUNKS:
        step = toks[:, pos:pos + c]
        jl, jc = jdecode_step(jp, jnp.asarray(step), jc, jnp.int32(pos),
                              jcfg, JFLAGS)
        tl, caches = decode_step(params, torch.from_numpy(step), caches, pos,
                                 cfg, FLAGS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4, err_msg=f"{arch} step at {pos}")
        pos += c


@pytest.mark.parametrize("arch", ["qwen2-5-7b", "gemma3-1b",
                                  "recurrentgemma-9b", "minicpm3-4b"])
def test_chunked_prefill_equals_one_shot(arch):
    """The port alone: a 15-token prompt prefilled at once, and
    prefilled as 6 tokens then ``decode_step``s of 5 and 4: the last
    logits and every cache leaf within 1e-4."""
    _, _, cfg, params = _setup(arch)
    n = PROMPT + CHUNKS[0] + CHUNKS[1]
    toks = torch.from_numpy(_tokens(cfg, n))
    fresh = materialize(build_cache_specs(cfg, 2, CACHE, torch.float32),
                        torch.Generator(), "cpu")
    want, wc = prefill(params, {"tokens": toks}, fresh, cfg, FLAGS)
    got, gc = prefill(params, {"tokens": toks[:, :PROMPT]}, fresh, cfg,
                      FLAGS)
    pos = PROMPT
    for c in CHUNKS[:2]:
        got, gc = decode_step(params, toks[:, pos:pos + c], gc, pos, cfg,
                              FLAGS)
        pos += c
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-4)
    for (path, g), (_, w) in zip(leaves_with_paths(gc),
                                 leaves_with_paths(wc)):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4, err_msg=path)


def test_xlstm_refuses_a_multi_token_step():
    """xLSTM's mLSTM step takes one token in both packages (the
    reference asserts it; the port raises)."""
    jcfg, jp, cfg, params = _setup("xlstm-125m")
    toks = _tokens(cfg, 5, b=1)
    jc = jmaterialize(jbuild_cache_specs(jcfg, 1, 8, jnp.float32),
                      jax.random.PRNGKey(0))
    caches = materialize(build_cache_specs(cfg, 1, 8, torch.float32),
                         torch.Generator(), "cpu")
    _, jc = jprefill(jp, {"tokens": jnp.asarray(toks[:, :3])}, jc, jcfg,
                     JFLAGS)
    _, caches = prefill(params, {"tokens": torch.from_numpy(toks[:, :3])},
                        caches, cfg, FLAGS)
    with pytest.raises(AssertionError):
        jdecode_step(jp, jnp.asarray(toks[:, 3:]), jc, jnp.int32(3), jcfg,
                     JFLAGS)
    with pytest.raises(ValueError, match="one token"):
        decode_step(params, torch.from_numpy(toks[:, 3:]), caches, 3, cfg,
                    FLAGS)
    # one token still steps
    decode_step(params, torch.from_numpy(toks[:, 3:4]), caches, 3, cfg,
                FLAGS)
