"""The port's RG-LRU path against the JAX package: the plain version of
the ``rglru_scan`` kernel (which the CPU path runs) against the Pallas
kernel in interpret mode and the jnp oracle, and the RG-LRU block
(gates, conv, recurrence, gated output) against the reference's
``repro/models/recurrent.py`` on the same numpy weights and inputs.

Contract: the scan within 1e-4 in float32 and 3e-2 in bfloat16 on the
reference's three shapes (its ``tests/test_kernels.py`` sweep), the
carried ``h0`` decaying as ``0.9**S``; the gates and the conv within
1e-6; the block's output and state within 1e-5 over a 12-token fresh
sequence and a 1-token step that continues it.  The reference folds h0
into the first input and runs an associative scan, the port runs the
serial recurrence: the two agree to float32 rounding, not bit for bit.
The CUDA kernel itself needs the card; ``chip_smoke.py`` holds it
against the plain version there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import recurrent as jrec
from repro_torch.configs import get_reduced
from repro_torch.kernels import ops
from repro_torch.kernels import rglru_scan as cuda_rglru
from repro_torch.models import recurrent as rec

ARCH = "recurrentgemma-9b"
SHAPES = [(1, 128, 128), (2, 256, 256), (3, 384, 128)]     # (B, S, W)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(x, dtype="f32"):
    """The same values as a jax array and a torch tensor of one dtype
    (bf16 rounding happens once, in jax, and carries over exactly)."""
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype][1])


def _scan_inputs(shape, seed=0):
    b, s, w = shape
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32),
            rng.standard_normal((b, s, w)).astype(np.float32),
            rng.standard_normal((b, w)).astype(np.float32))


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_rglru_scan_ref_matches_pallas(shape, dtype):
    a, b, h0 = _scan_inputs(shape)
    (ja, ta), (jb, tb), (jh, th) = (_both(x, dtype) for x in (a, b, h0))
    want = jops.rglru_scan(ja, jb, jh)
    got = ops.rglru_scan(ta, tb, th)
    assert got.dtype == ta.dtype and got.shape == ta.shape
    _close(got, want, DTYPES[dtype][2])


def test_rglru_scan_carries_h0():
    b, s, w = 1, 128, 128
    a = torch.full((b, s, w), 0.9)
    h = ops.rglru_scan(a, torch.zeros((b, s, w)), torch.ones((b, w)))
    np.testing.assert_allclose(h[:, 0].numpy(), 0.9, rtol=1e-5)
    np.testing.assert_allclose(h[:, -1].numpy(), 0.9 ** s, rtol=1e-3)
    want = jops.rglru_scan(jnp.full((b, s, w), 0.9), jnp.zeros((b, s, w)),
                           jnp.ones((b, w)))
    _close(h, want, 1e-4)


@pytest.mark.parametrize("shape", [(1, 3, 64), (4, 1, 4096)])
def test_rglru_scan_ragged_shapes(shape):
    """The serving path's shapes (a 3-token prefill, a 4-row decode
    step), which the Pallas kernel's block asserts refuse: the jnp
    oracle is the target."""
    a, b, h0 = _scan_inputs(shape, seed=1)
    want = jref.rglru_scan_ref(jnp.asarray(a), jnp.asarray(b),
                               jnp.asarray(h0))
    got = ops.rglru_scan(*map(torch.from_numpy, (a, b, h0)))
    _close(got, want, 1e-4)


def _block_weights(cfg, seed=0):
    """Random numpy weights for every leaf of the RG-LRU block (biases and
    lambda included, so no term of the gates is trivially zero)."""
    rng = np.random.default_rng(seed)
    out = {}
    for name, s in rec.rglru_specs(cfg).items():
        scale = 1.0 if len(s.shape) == 1 else s.shape[0] ** -0.5
        out[name] = (rng.standard_normal(s.shape) * scale).astype(np.float32)
    return out


def _trees(w):
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def test_gates_and_conv_match_reference():
    cfg = get_reduced(ARCH)
    jp, p = _trees(_block_weights(cfg))
    rng = np.random.default_rng(2)
    u = rng.standard_normal((2, 12, 64)).astype(np.float32)
    state = rng.standard_normal((2, 3, 64)).astype(np.float32)
    ja, jb = jrec._rglru_gates(jp, jnp.asarray(u))
    a, b = rec._rglru_gates(p, torch.from_numpy(u))
    assert a.dtype == b.dtype == torch.float32
    np.testing.assert_allclose(a.numpy(), np.asarray(ja), rtol=0, atol=1e-6)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), rtol=0, atol=1e-6)
    for st in (None, state):
        jo, jst = jrec._conv1d(jp, jnp.asarray(u),
                               None if st is None else jnp.asarray(st))
        o, nst = rec._conv1d(p, torch.from_numpy(u),
                             None if st is None else torch.from_numpy(st))
        np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(nst.numpy(), np.asarray(jst))


def test_rglru_block_matches_reference():
    """A 12-token fresh sequence from a zero state, then a 1-token step
    that continues it: output and state within 1e-5 of the reference."""
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    jp, p = _trees(_block_weights(cfg, seed=3))
    rng = np.random.default_rng(4)
    b, w = 2, cfg.recurrent.lru_width
    jstate = {"conv": jnp.zeros((b, 3, w), jnp.float32),
              "h": jnp.zeros((b, w), jnp.float32)}
    state = {"conv": torch.zeros((b, 3, w)), "h": torch.zeros((b, w))}
    for s in (12, 1):
        x = rng.standard_normal((b, s, cfg.d_model)).astype(np.float32)
        jy, jstate = jrec.rglru_block(jp, jnp.asarray(x), cfg=jcfg,
                                      state=jstate)
        y, state = rec.rglru_block(p, torch.from_numpy(x), cfg=cfg,
                                   state=state)
        np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                                   atol=1e-5)
        for k in ("conv", "h"):
            assert state[k].dtype == torch.float32
            np.testing.assert_allclose(state[k].numpy(),
                                       np.asarray(jstate[k]), rtol=1e-5,
                                       atol=1e-5)
    # without a state the block is the fresh-sequence forward
    x = rng.standard_normal((b, 5, cfg.d_model)).astype(np.float32)
    jy, _ = jrec.rglru_block(jp, jnp.asarray(x), cfg=jcfg)
    y, none = rec.rglru_block(p, torch.from_numpy(x), cfg=cfg)
    assert none is None
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-5,
                               atol=1e-5)


def test_state_spec_conv_dtype_is_the_compute_dtype():
    from repro_torch.configs import get_config
    for cfg in (get_config(ARCH), get_reduced(ARCH)):
        st = rec.rglru_state_spec(cfg, 2)
        assert st["conv"].dtype == cfg.compute_dtype
        assert st["conv"].shape == (2, 3, cfg.recurrent.lru_width)
        assert st["h"].dtype == torch.float32


def test_cpu_path_never_launches_and_wrapper_refuses_cpu():
    """The CPU path runs the plain version and counts no launch; the CUDA
    wrapper refuses a CPU tensor instead of computing on it."""
    a, b, h0 = map(torch.from_numpy, _scan_inputs((1, 4, 8)))
    ops.reset_launches()
    ops.rglru_scan(a, b, h0)
    assert ops.launch_counts()["rglru_scan"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_rglru.rglru_scan(a, b, h0)
