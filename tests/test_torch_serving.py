"""The port's serving path (``ServingEngine`` and ``launch.serve``)
against the JAX package at reduced Qwen2.5-7B and reduced
RecurrentGemma-9B, with the reference's own weights carried over through
``convert.params_from_numpy``.

Contract: on every slot case of ``tests/test_serving.py`` (deterministic
generation, slot isolation, exhaustion, release-and-reuse, admission
under a full pool, interleaving) the port's greedy tokens equal the
reference engine's, on reduced Qwen and on reduced Mixtral (MoE); the
launcher prints the same lines (requests, cold starts, Wh, parking-tax
Wh, added latency) as the reference launcher.
On reduced whisper-base, with each request's source frame embeddings
passed as ``admit``'s extras, the port's tokens equal the reference
engine's (slots at different positions, a slot reused with other
frames).
The reference engine cannot serve reduced RecurrentGemma (its bfloat16
conv-state slots refuse the float32 state its block returns), so there
the port's engine is held against a chain of the reference's
``prefill`` / ``decode_step``, and its launcher against the reference's
``ModelManager`` replaying the same arrivals.
"""
import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.core import PROFILES as JPROFILES
from repro.core import loader_from_checkpoint as jloader_from_checkpoint
from repro.core import traffic as jtraffic
from repro.core.scheduler import Breakeven as JBreakeven
from repro.launch import serve as jserve
from repro.models import RunFlags as JRunFlags
from repro.models import build_cache_specs as jbuild_cache_specs
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import materialize as jmaterialize
from repro.models import param_bytes as jparam_bytes
from repro.models import prefill as jprefill
from repro.serving import ModelManager as JModelManager
from repro.serving import ServingEngine as JServingEngine
from repro.serving import SimClock as JSimClock
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import RunFlags
from repro_torch.serving import ServingEngine

ARCH = "qwen2-5-7b"
RG = "recurrentgemma-9b"
MOE = "mixtral-8x22b"
WHISPER = "whisper-base"


def _engines(arch):
    """The reference engine and the port's, on the same weights."""
    jcfg = jget_reduced(arch)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    cfg = get_reduced(arch)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return (JServingEngine(jcfg, jp, max_batch=3, max_len=32,
                           flags=JRunFlags(remat="none")),
            ServingEngine(cfg, params, max_batch=3, max_len=32,
                          flags=RunFlags(remat="none"), device="cpu"))


@pytest.fixture(scope="module")
def engines():
    return _engines(ARCH)


@pytest.fixture(scope="module")
def moe_engines():
    return _engines(MOE)


def _deterministic(engine):
    r1 = engine.generate([1, 2, 3], max_new=5)
    r2 = engine.generate([1, 2, 3], max_new=5)
    assert r1.tokens == r2.tokens and len(r1.tokens) == 5
    return r1.tokens


def _slots_isolated(engine):
    alone = engine.generate([4, 5, 6, 7], max_new=4).tokens
    s1 = engine.admit([4, 5, 6, 7])
    s2 = engine.admit([9, 8])
    toks = [int(engine._slot_last[s1])]
    for _ in range(3):
        toks.append(engine.step()[s1])
    engine.release(s1)
    engine.release(s2)
    assert toks == alone
    return toks


def _exhaustion(engine):
    slots = [engine.admit([1]) for _ in range(len(engine.free_slots()))]
    with pytest.raises(RuntimeError):
        engine.admit([2])
    last = [int(engine._slot_last[s]) for s in slots]
    for s in slots:
        engine.release(s)
    return last


def _release_then_reuse(engine):
    fresh = engine.generate([4, 5, 6], max_new=4).tokens
    s0 = engine.admit([9, 8, 7, 6, 5])           # pollute slot 0's cache
    engine.step()
    engine.release(s0)
    assert engine.free_slots()[0] == s0          # lowest-free reuse
    again = engine.generate([4, 5, 6], max_new=4)
    assert again.request_id == s0 and again.tokens == fresh
    return fresh


def _admit_when_full(engine):
    alone = engine.generate([11, 12, 13], max_new=4).tokens
    keep = engine.admit([11, 12, 13])
    others = [engine.admit([2, 3]) for _ in range(len(engine.free_slots()))]
    with pytest.raises(RuntimeError):
        engine.admit([7])
    engine.release(others[0])
    others[0] = engine.admit([5, 4, 3, 2])       # slot churn under load
    toks = [int(engine._slot_last[keep])]
    for _ in range(3):
        toks.append(engine.step()[keep])
    for s in [keep] + others:
        engine.release(s)
    assert toks == alone
    return toks


def _interleaved(engine):
    solo_bg = engine.generate([21, 22, 23], max_new=5).tokens
    solo_fg = engine.generate([31, 32], max_new=4).tokens
    bg = engine.admit([21, 22, 23])
    toks = [int(engine._slot_last[bg])]
    fg = engine.generate([31, 32], max_new=4)    # 3 step() calls inside
    assert fg.tokens == solo_fg
    assert int(engine._slot_pos[bg]) == 3 + 3
    assert int(engine._slot_last[bg]) == solo_bg[3]
    toks.append(engine.step()[bg])
    engine.release(bg)
    assert toks == [solo_bg[0], solo_bg[4]]
    return solo_bg + solo_fg + toks


CASES = (_deterministic, _slots_isolated, _exhaustion, _release_then_reuse,
         _admit_when_full, _interleaved)


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.strip("_"))
def test_engine_tokens_match_reference(engines, case):
    jeng, eng = engines
    assert case(eng) == case(jeng)


@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__.strip("_"))
def test_moe_engine_tokens_match_reference(moe_engines, case):
    """Reduced Mixtral: a 1-5 token prompt dispatches at capacity
    max(ceil(S * 2 * 2.0 / 4), 1), a decode step at 1 a sequence."""
    jeng, eng = moe_engines
    assert case(eng) == case(jeng)


def _whisper_requests(engine, frames):
    """Two requests with their own frames decode together from different
    positions; the first is released and a third, with other frames,
    takes its slot (its cross K/V rows overwritten) beside the second."""
    first = engine.admit([1, 2, 3], extras={"source_embeds": frames[0]})
    second = engine.admit([4, 5], extras={"source_embeds": frames[1]})
    toks = {s: [int(engine._slot_last[s])] for s in (first, second)}
    for _ in range(3):
        for s, tok in engine.step().items():
            toks[s].append(tok)
    engine.release(first)
    third = engine.admit([6, 7, 8, 9], extras={"source_embeds": frames[2]})
    assert third == first
    out = [toks[first], toks[second]]
    toks = {s: [int(engine._slot_last[s])] for s in (second, third)}
    for _ in range(3):
        for s, tok in engine.step().items():
            toks[s].append(tok)
    for s in (second, third):
        engine.release(s)
    with pytest.raises(KeyError, match="source_embeds"):
        engine.generate([1, 2, 3])      # no frames: the encoder has none
    engine.release(0)
    return out + [toks[second], toks[third]]


def test_whisper_engine_tokens_match_reference():
    """Reduced whisper (8 source frames): each request's frames [1, 8,
    64] from a seed, as ``admit``'s extras; the port's greedy tokens
    equal the reference engine's."""
    jeng, eng = _engines(WHISPER)
    rng = np.random.default_rng(3)
    frames = [rng.standard_normal((1, 8, 64)).astype(np.float32)
              for _ in range(3)]
    got = _whisper_requests(eng, frames)
    assert got == _whisper_requests(jeng, frames)
    assert len({tuple(t) for t in got}) > 1


def _lines(main, argv, **kw):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv, **kw) == 0
    return buf.getvalue().splitlines()


def test_launcher_energy_lines_match_reference():
    argv = ["--arch", ARCH, "--reduced", "--hours", "1"]
    got = _lines(serve.main, argv, device="cpu")
    want = _lines(jserve.main, argv)
    assert len(got) == 2 and "requests" in got[1]
    assert got == want


def _reference_chain(jcfg, jp, prompt, n, max_len):
    """Greedy tokens of one prompt through the reference's ``prefill``
    then ``decode_step``, batch 1."""
    flags = JRunFlags(remat="none")
    jc = jmaterialize(jbuild_cache_specs(jcfg, 1, max_len, jnp.float32),
                      jax.random.PRNGKey(0))
    logits, jc = jprefill(jp, {"tokens": jnp.asarray([prompt], jnp.int32)},
                          jc, jcfg, flags)
    toks = [int(jnp.argmax(logits[0]))]
    for pos in range(len(prompt), len(prompt) + n - 1):
        logits, jc = jdecode_step(jp, jnp.asarray([[toks[-1]]], jnp.int32),
                                  jc, jnp.int32(pos), jcfg, flags)
        toks.append(int(jnp.argmax(logits[0])))
    return toks


def test_recurrentgemma_engine_matches_reference_chain():
    """Two slots at different positions (one prompt past the window of
    8, one short), stepped together: each slot's greedy tokens equal the
    reference's prefill/decode chain of its prompt alone."""
    jcfg, cfg = jget_reduced(RG), get_reduced(RG)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    eng = ServingEngine(cfg, params, max_batch=2, max_len=32,
                        flags=RunFlags(remat="none"), device="cpu")
    prompts = (list(range(40, 52)), [7, 8, 9])
    slots = [eng.admit(pr) for pr in prompts]
    toks = {s: [int(eng._slot_last[s])] for s in slots}
    for _ in range(6):
        for s, tok in eng.step().items():
            toks[s].append(tok)
    assert [int(eng._slot_pos[s]) for s in slots] == [18, 9]
    for s, pr in zip(slots, prompts):
        assert toks[s] == _reference_chain(jcfg, jp, pr, 7, 32)


def _reference_manager_lines(arch, hours):
    """The launcher's two lines from the reference's ``ModelManager``
    replaying its arrivals with its loader and Breakeven policy, serving
    no compute (the figures come from the simulated clock)."""
    cfg = jget_reduced(arch)
    profile = JPROFILES["h100"]
    full_bytes = jparam_bytes(jbuild_param_specs(jget_config(arch)))
    loader = jloader_from_checkpoint(arch, full_bytes, profile)
    policy = JBreakeven(loader, profile)
    mm = JModelManager(profile, clock=JSimClock())
    mm.register(cfg.name, policy=policy, loader=loader, load_fn=lambda: None)
    arrivals = [a for a in jtraffic.PATTERNS["bursty"](seed=0)
                if a < hours * 3600.0]
    mm.handle_request(cfg.name, work_fn=lambda e: None)
    for a in arrivals:
        mm._advance_with_evictions(max(float(a), mm.clock()))
        mm.handle_request(cfg.name, work_fn=lambda e: None)
    mm._advance_with_evictions(hours * 3600.0)
    m = mm.models[cfg.name]
    wh = mm.meter.totals()
    return [f"[serve] {cfg.name} on {profile.name}: checkpoint "
            f"{full_bytes/2**30:.1f} GiB -> t_load {loader.t_load_s:.1f}s, "
            f"parking tax {profile.dvfs_step_w:.1f} W",
            f"[serve] {policy.name}: {m.requests} requests, "
            f"{m.cold_starts} cold starts, energy {wh['total']:.1f} Wh "
            f"(parking tax {mm.meter.parking_tax_wh():.1f} Wh), "
            f"mean added latency {m.added_latency_s/max(m.requests,1):.2f} s"]


def test_recurrentgemma_launcher_matches_reference_manager():
    got = _lines(serve.main, ["--arch", RG, "--reduced", "--hours", "1"],
                 device="cpu")
    assert "requests" in got[1] and "recurrentgemma-reduced" in got[0]
    assert got == _reference_manager_lines(RG, 1.0)
    # the replay is the launcher's own: on Qwen (which the reference
    # launcher serves, see above) it prints the launcher's lines
    assert _reference_manager_lines(ARCH, 1.0) == _lines(
        serve.main, ["--arch", ARCH, "--reduced", "--hours", "1"],
        device="cpu")


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--reduced", "--hours", "1"])
