"""The port's serving path (``ServingEngine`` and ``launch.serve``)
against the JAX package at reduced Qwen2.5-7B, with the reference's own
weights carried over through ``convert.params_from_numpy``.

Contract: on every slot case of ``tests/test_serving.py`` (deterministic
generation, slot isolation, exhaustion, release-and-reuse, admission
under a full pool, interleaving) the port's greedy tokens equal the
reference engine's; the launcher prints the same lines (requests, cold
starts, Wh, parking-tax Wh, added latency) as the reference launcher.
"""
import contextlib
import io

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.launch import serve as jserve
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.serving import ServingEngine as JServingEngine
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import RunFlags
from repro_torch.serving import ServingEngine

ARCH = "qwen2-5-7b"


@pytest.fixture(scope="module")
def engines():
    """The reference engine and the port's, on the same weights."""
    jcfg = jget_reduced(ARCH)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
    return (JServingEngine(jcfg, jp, max_batch=3, max_len=32,
                           flags=JRunFlags(remat="none")),
            ServingEngine(cfg, params, max_batch=3, max_len=32,
                          flags=RunFlags(remat="none"), device="cpu"))


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


@pytest.mark.parametrize("case", [_deterministic, _slots_isolated,
                                  _exhaustion, _release_then_reuse,
                                  _admit_when_full, _interleaved],
                         ids=lambda f: f.__name__.strip("_"))
def test_engine_tokens_match_reference(engines, case):
    jeng, eng = engines
    assert case(eng) == case(jeng)


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


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_reduced(ARCH)
    with pytest.raises(RuntimeError, match="CUDA"):
        ServingEngine(cfg, {})
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", ARCH, "--reduced", "--hours", "1"])
