"""The port's dense, vision-language and MoE configs (gemma3-1b,
granite-20b, command-r-35b, internvl2-26b, mixtral-8x22b), its MLA
configs (minicpm3-4b, deepseek-v2-236b), the encoder-decoder
whisper-base and xlstm-125m against the JAX package, with the
reference's own weights carried over through
``convert.params_from_numpy``.

Contract: each config's dataclasses equal the reference's (full and
reduced), and the full config's parameter count and bf16 checkpoint
bytes equal the reference's; a reduced prefill and greedy decode steps
give logits and every cache leaf within 1e-4 of the reference's
``prefill`` / ``decode_step`` (gemma3's prompt past its reduced window,
internvl2 with its prefix embeddings, whisper with its source frame
embeddings); the int8 KV cache stays close to the float32 one on
reduced command-r, as the reference's own test requires; the launcher
prints the reference launcher's lines, and raises the reference
launcher's ``KeyError`` for internvl2 and whisper.
"""
import contextlib
import dataclasses
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.models import RunFlags as JRunFlags
from repro.models import build_cache_specs as jbuild_cache_specs
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import materialize as jmaterialize
from repro.models import param_bytes as jparam_bytes
from repro.models import prefill as jprefill
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import (RunFlags, build_cache_specs,
                                build_param_specs, decode_step, materialize,
                                param_bytes, param_count, prefill)

JFLAGS = JRunFlags(remat="none")
FLAGS = RunFlags(remat="none")

# arch: (parameters, bf16 checkpoint bytes) of the full config
FULL = {
    "gemma3-1b": (999_812_736, 1_999_747_584),
    "granite-20b": (28_167_493_632, 56_336_277_504),
    "command-r-35b": (32_380_690_432, 64_762_707_968),
    "internvl2-26b": (19_861_260_288, 39_723_712_512),
    "mixtral-8x22b": (140_630_071_296, 281_267_036_160),
    "minicpm3-4b": (4_261_902_848, 8_524_572_672),
    "deepseek-v2-236b": (239_375_569_920, 478_850_928_640),
    "whisper-base": (109_749_248, 219_531_264),
    "xlstm-125m": (77_627_184, 155_274_336),
}
NEW = tuple(FULL)
SLICE8 = NEW[:5]


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _fields(cfg, reference):
    """The config's fields, its dtypes by name (torch's or the
    reference's jnp dtypes)."""
    d = dataclasses.asdict(cfg)
    for key in ("param_dtype", "compute_dtype"):
        d[key] = np.dtype(d[key]).name if reference else \
            str(d[key]).split(".")[-1]
    return d


def test_registry_holds_the_seven_archs():
    assert ARCHS[:7] == ["qwen2-5-7b", "recurrentgemma-9b", *SLICE8]


def test_registry_holds_the_eleven_archs():
    """Every arch the reference can build, the last four after slice 8's
    seven."""
    assert ARCHS == ["qwen2-5-7b", "recurrentgemma-9b", *NEW]
    assert sorted(ARCHS) == sorted(JARCHS)


@pytest.mark.parametrize("arch", NEW)
def test_config_matches_reference(arch):
    for ours, theirs in ((get_config(arch), jget_config(arch)),
                         (get_reduced(arch), jget_reduced(arch))):
        assert _fields(ours, False) == _fields(theirs, True)
    n, nbytes = FULL[arch]
    full = get_config(arch)
    assert param_count(build_param_specs(full)) == full.param_count() == \
        jget_config(arch).param_count() == n
    assert param_bytes(build_param_specs(full)) == \
        jparam_bytes(jbuild_param_specs(jget_config(arch))) == nbytes


def _assert_leaves_close(jtree, tree, tol=1e-4):
    for path, leaf in jax.tree_util.tree_flatten_with_path(jtree)[0]:
        got = tree
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(leaf, np.float32),
                                   rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(path))


def _batches(cfg, b, s, seed):
    """The same prompt (and prefix or source frame embeddings) for both
    packages."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (b, s))
    jb = {"tokens": jnp.asarray(toks, jnp.int32)}
    tb = {"tokens": torch.from_numpy(toks)}
    if cfg.n_prefix_embeddings:
        pre = (0.01 * rng.standard_normal(
            (b, cfg.n_prefix_embeddings, cfg.d_model))).astype(np.float32)
        jb["prefix_embeds"] = jnp.asarray(pre)
        tb["prefix_embeds"] = torch.from_numpy(pre)
    if cfg.encoder is not None:
        src = rng.standard_normal(
            (b, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
        jb["source_embeds"] = jnp.asarray(src)
        tb["source_embeds"] = torch.from_numpy(src)
    return jb, tb


@pytest.mark.parametrize("arch", NEW)
def test_prefill_and_decode_match_reference(arch):
    """Reduced config: a batch-2 12-token prompt (past gemma3's reduced
    window of 8; after internvl2's 4 prefix embeddings; whisper's against
    8 source frames) prefilled into a longer cache, then 5 greedy decode
    steps at ``pos = S + n_prefix``; logits at every step and every cache
    leaf (KV, MLA latents, cross K/V, xLSTM states) within 1e-4."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jp), "cpu")
    B, S = 2, 12
    T = S + cfg.n_prefix_embeddings + 8
    jb, tb = _batches(cfg, B, S, 0)
    jc = jmaterialize(jbuild_cache_specs(jcfg, B, T, jnp.float32),
                      jax.random.PRNGKey(0))
    caches = caches_from_numpy(_np_tree(jc), "cpu")
    jl, jc = jprefill(jp, jb, jc, jcfg, JFLAGS)
    tl, caches = prefill(params, tb, caches, cfg, FLAGS)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    _assert_leaves_close(jc, caches)
    start = S + cfg.n_prefix_embeddings
    for pos in range(start, start + 5):
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        assert nxt.tolist() == torch.argmax(tl, -1)[:, None].tolist()
        jl, jc = jdecode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                              jnp.int32(pos), jcfg, JFLAGS)
        tl, caches = decode_step(params, torch.from_numpy(nxt), caches, pos,
                                 cfg, FLAGS)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    _assert_leaves_close(jc, caches)


def test_prefix_embeddings_change_the_logits():
    """internvl2's prefix embeddings reach the model: other embeddings,
    other logits; the prefix rows fill the first cache rows."""
    cfg = get_reduced("internvl2-26b")
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    _, tb = _batches(cfg, 1, 5, 1)
    n = cfg.n_prefix_embeddings
    outs = []
    for scale in (1.0, 2.0):
        caches = materialize(build_cache_specs(cfg, 1, n + 8, torch.float32),
                             torch.Generator(), "cpu")
        batch = dict(tb, prefix_embeds=tb["prefix_embeds"] * scale)
        logits, caches = prefill(params, batch, caches, cfg, FLAGS)
        k = caches["main"]["pos0"]["attn"]["k"]          # [L, B, T, Hkv, D]
        assert bool((k[:, :, :n + 5] != 0).any(-1).any(-1).all())
        assert bool((k[:, :, n + 5:] == 0).all())
        outs.append(logits)
    assert not torch.allclose(outs[0], outs[1])
    with pytest.raises(KeyError, match="prefix_embeds"):
        prefill(params, {"tokens": tb["tokens"]}, caches, cfg, FLAGS)


def test_int8_kv_cache_decode_close_to_float32():
    """Reduced command-r: the int8 KV cache (per-(token, head) scales)
    keeps decode logits argmax-identical to the float32 cache and
    correlated above 0.995 (the reference's own test), and its logits
    within 1e-4 of the reference's int8 run."""
    arch = "command-r-35b"
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jp), "cpu")
    B, S = 2, 8
    jb, tb = _batches(cfg, B, S, 2)

    def step(dt, tok=None):
        caches = materialize(build_cache_specs(cfg, B, S + 2, dt),
                             torch.Generator(), "cpu")
        logits, caches = prefill(params, tb, caches, cfg, FLAGS)
        tok = torch.argmax(logits, -1)[:, None] if tok is None else tok
        return decode_step(params, tok, caches, S, cfg, FLAGS)[0], tok

    out = {}
    out["f32"], tok = step(torch.float32)
    out["int8"], _ = step(torch.int8, tok)
    jc = jmaterialize(jbuild_cache_specs(jcfg, B, S + 2, jnp.int8),
                      jax.random.PRNGKey(0))
    _, jc = jprefill(jp, jb, jc, jcfg, JFLAGS)
    jl, _ = jdecode_step(jp, jnp.asarray(tok.numpy(), jnp.int32), jc,
                         jnp.int32(S), jcfg, JFLAGS)
    np.testing.assert_allclose(out["int8"].numpy(), np.asarray(jl),
                               rtol=1e-4, atol=1e-4)
    corr = np.corrcoef(out["f32"].numpy().ravel(),
                       out["int8"].numpy().ravel())[0, 1]
    assert corr > 0.995
    assert torch.equal(torch.argmax(out["f32"], -1),
                       torch.argmax(out["int8"], -1))


def _lines(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue().splitlines()


@pytest.mark.parametrize("arch", ["gemma3-1b", "granite-20b",
                                  "command-r-35b", "mixtral-8x22b",
                                  "minicpm3-4b", "deepseek-v2-236b",
                                  "xlstm-125m"])
def test_launcher_energy_lines_match_reference(arch):
    argv = ["--arch", arch, "--reduced", "--hours", "1"]
    got = _lines(serve.main, argv, device="cpu")
    assert len(got) == 2 and "requests" in got[1]
    assert got == _lines(jserve.main, argv)


def test_launcher_cannot_serve_internvl2_as_the_reference():
    """The reference launcher's requests carry no prefix embeddings, so
    its first prefill raises ``KeyError('prefix_embeds')``; the port's
    launcher raises the same."""
    argv = ["--arch", "internvl2-26b", "--reduced", "--hours", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(KeyError, match="prefix_embeds"):
            jserve.main(argv)
        with pytest.raises(KeyError, match="prefix_embeds"):
            serve.main(argv, device="cpu")


def test_launcher_cannot_serve_whisper_as_the_reference():
    """The launcher's requests carry no source frame embeddings, so the
    reference launcher's first prefill raises ``KeyError('source_embeds')``
    in its encoder; the port's launcher raises the same (whisper is
    served through ``ServingEngine`` with the frames as extras,
    ``tests/test_torch_serving.py``)."""
    argv = ["--arch", "whisper-base", "--reduced", "--hours", "1"]
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(KeyError, match="source_embeds"):
            jserve.main(argv)
        with pytest.raises(KeyError, match="source_embeds"):
            serve.main(argv, device="cpu")
