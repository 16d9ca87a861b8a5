"""Gradients through the port's kernels, on the CPU's stand-ins.

On the card ``ops.flash_attention`` and ``ops.rglru_scan`` go through
autograd functions (``kernels/flash_attention.FlashAttention``: the
kernel's forward and, on the sm90 and simt routes, the plain version's
recomputed gradient -- the f32tc route's backward kernel is held in
``test_torch_flash_f32.py``;
``kernels/rglru_scan.RGLRUScan``: the kernel in both passes, the backward
being ``ref.rglru_scan_backward`` on the flipped, shifted sequences).
The kernels run only on the card (``chip_smoke.py`` phase 18); here the
raw wrappers are replaced by their plain versions so the functions'
plumbing and the scan's backward formula run on the CPU.

Contract: the formula with ``ref.rglru_scan_ref`` as its scan equals
``torch.autograd`` through the plain scan within 1e-5 (float32, h0
nonzero); both functions' gradients equal the plain versions'; the
planted faults of phase 18 (the bare kernel with no autograd; the scan
backward without the one-step shift of ``a``) miss phase 18's check.
"""
import numpy as np
import pytest
import torch

import chip_smoke
from repro_torch.kernels import flash_attention as fmod
from repro_torch.kernels import ref
from repro_torch.kernels import rglru_scan as rmod


def _t(rng, shape, lo=None):
    x = rng.standard_normal(shape).astype(np.float32)
    if lo is not None:                   # decays in (lo, 1)
        x = lo + (1 - lo) / (1 + np.exp(-x))
    return torch.from_numpy(x)


def _scan_inputs(b=2, s=37, w=24, seed=0):
    rng = np.random.default_rng(seed)
    return (_t(rng, (b, s, w), lo=0.5), _t(rng, (b, s, w)), _t(rng, (b, w)),
            _t(rng, (b, s, w)))


@pytest.fixture
def plain_kernels(monkeypatch):
    """The raw wrappers replaced by the plain versions (as the CPU has no
    kernel): the autograd functions run as on the card.  The f32tc
    route's entry points (float32 at D in 32-256) get theirs too; the
    shapes here (D = 16) take the simt route's plain recompute, and
    ``test_torch_flash_f32.py`` runs the f32tc wiring."""
    monkeypatch.setattr(fmod, "flash_attention", ref.flash_attention_ref)
    monkeypatch.setattr(fmod, "flash_attention_lse",
                        ref.flash_attention_lse_ref)
    monkeypatch.setattr(fmod, "flash_attention_bwd",
                        ref.flash_attention_bwd_ref)
    monkeypatch.setattr(rmod, "rglru_scan", ref.rglru_scan_ref)


@pytest.mark.parametrize("s", [1, 2, 37])
def test_scan_backward_formula_matches_autograd(s):
    a, b, h0, r = _scan_inputs(s=s)
    want = chip_smoke._scan_grads(ref.rglru_scan_ref, a, b, h0, r)
    got = chip_smoke._scan_grads_by(ref.rglru_scan_backward,
                                    ref.rglru_scan_ref, a, b, h0, r)
    assert bool(h0.abs().min() > 0)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_scan_function_gradients_equal_the_plain_versions(plain_kernels):
    a, b, h0, r = _scan_inputs()
    want = chip_smoke._scan_grads(ref.rglru_scan_ref, a, b, h0, r)
    got = chip_smoke._scan_grads(rmod.RGLRUScan.apply, a, b, h0, r)
    ok, worst = chip_smoke._grad_check(got, want, 1e-5)
    assert ok, worst
    # a gradient asked for only some inputs (h0 a constant)
    a2 = a.clone().requires_grad_()
    h = rmod.RGLRUScan.apply(a2, b, h0)
    (da,) = torch.autograd.grad((h ** 2 * r).sum(), a2)
    np.testing.assert_allclose(da.numpy(), want[0].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 5),
                                           (False, None)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_function_gradients_equal_the_plain_versions(
        plain_kernels, causal, window, dtype):
    rng = np.random.default_rng(1)
    q = _t(rng, (1, 4, 12, 16)).to(dtype)
    k = _t(rng, (1, 2, 12, 16)).to(dtype)
    v = _t(rng, (1, 2, 12, 16)).to(dtype)
    r = _t(rng, (1, 4, 12, 16))
    want = chip_smoke._flash_grads(ref.flash_attention_ref, q, k, v, r,
                                   causal, window)
    got = chip_smoke._flash_grads(
        lambda q, k, v, causal, window: fmod.FlashAttention.apply(
            q, k, v, causal, window), q, k, v, r, causal, window)
    assert [g.dtype for g in got] == [dtype] * 3
    ok, worst = chip_smoke._grad_check(got, want, 0.0)
    assert ok, worst


def test_planted_faults_miss_the_gradient_check():
    rng = np.random.default_rng(2)
    q, k, v, r = (_t(rng, (1, 4, 12, 16)), _t(rng, (1, 2, 12, 16)),
                  _t(rng, (1, 2, 12, 16)), _t(rng, (1, 4, 12, 16)))
    want = chip_smoke._flash_grads(ref.flash_attention_ref, q, k, v, r,
                                   True, None)

    def bare(q, k, v, **kw):            # the kernel with no autograd
        return ref.flash_attention_ref(q, k, v, **kw).detach()

    ok, worst = chip_smoke._grad_check(
        chip_smoke._flash_grads(bare, q, k, v, r, True, None), want,
        chip_smoke.GRAD_TOL["float32"])
    assert not ok and worst == float("inf")
    # a zero gradient is as wrong as a missing one
    zero = [torch.zeros_like(w) for w in want]
    assert not chip_smoke._grad_check(zero, want, 1.0)[0]

    a, b, h0, r = _scan_inputs()
    want = chip_smoke._scan_grads(ref.rglru_scan_ref, a, b, h0, r)
    unshifted = chip_smoke._scan_grads_by(
        ref.rglru_scan_backward_unshifted, ref.rglru_scan_ref, a, b, h0, r)
    ok, worst = chip_smoke._grad_check(unshifted, want,
                                       chip_smoke.SCAN_GRAD_TOL)
    assert not ok and worst > 100 * chip_smoke.SCAN_GRAD_TOL
