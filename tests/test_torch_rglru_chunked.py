"""The chunked ``rglru_scan`` kernel (``csrc/rglru_scan.cu``), as far as
the CPU can reach it:

* its algorithm -- per-chunk aggregates (A = prod a_t, B = the scan from
  0), each chunk's carry from h0 or an earlier chunk's last state with the
  aggregates between folded in order, then a step-by-step rescan -- as a
  plain-torch model (``ref.rglru_scan_chunked_ref``) against the JAX
  package's Pallas kernel in interpret mode, on the same numpy inputs, at
  the reference's three shapes x chunk lengths {1, 7, 64, S} (1 and 7
  take the carry from earlier chunks' last states as well as from h0):
  1e-4 in float32, 3e-2 in bfloat16;
* the carry's drift over a long prompt: a channel with a = 0.9999 over
  2048 steps;
* which kernel takes a scan (``rglru_scan.route``: S alone), and the
  scratch the chunked kernel is given (``scratch_words``).

The kernels themselves need the card; ``chip_smoke.py`` holds both
routes against ``ref.rglru_scan_ref`` there.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref
from repro_torch.kernels import rglru_scan as cuda_rglru

SHAPES = [(1, 128, 128), (2, 256, 256), (3, 384, 128)]     # (B, S, W)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-4),
          "bf16": (jnp.bfloat16, torch.bfloat16, 3e-2)}


def _both(x, dtype):
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype][1])


@functools.lru_cache(maxsize=None)
def _case(shape, dtype):
    """Inputs and the Pallas kernel's output, once per shape and dtype."""
    b, s, w = shape
    rng = np.random.default_rng(sum(shape))
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    h0 = rng.standard_normal((b, w)).astype(np.float32)
    (ja, ta), (jb, tb), (jh, th) = (_both(v, dtype) for v in (a, x, h0))
    want = np.asarray(jops.rglru_scan(ja, jb, jh), np.float32)
    return ta, tb, th, want


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("ct", [1, 7, 64, "S"])
def test_chunked_model_matches_pallas(shape, dtype, ct):
    a, b, h0, want = _case(shape, dtype)
    ct = shape[1] if ct == "S" else ct
    got = ref.rglru_scan_chunked_ref(a, b, h0, ct)
    assert got.dtype == a.dtype and got.shape == a.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_chunked_model_carry_drift_over_a_long_prompt(dtype):
    """One channel with a = 0.9999 at every one of 2048 steps carries h0
    and every b through 64 chunks of 32: against the Pallas kernel, and
    against 0.9999**t h0 where b is 0."""
    b, s, w = 1, 2048, 128
    rng = np.random.default_rng(7)
    a = rng.uniform(0.5, 0.999, (b, s, w)).astype(np.float32)
    x = rng.standard_normal((b, s, w)).astype(np.float32)
    a[:, :, 3] = 0.9999
    x[:, :, 5] = 0.0
    a[:, :, 5] = 0.9999
    h0 = np.ones((b, w), np.float32)
    (ja, ta), (jb, tb), (jh, th) = (_both(v, dtype) for v in (a, x, h0))
    want = np.asarray(jops.rglru_scan(ja, jb, jh), np.float32)
    got = ref.rglru_scan_chunked_ref(ta, tb, th, cuda_rglru.CHUNK)
    _close(got, want, DTYPES[dtype][2])
    # 0.9999 as the dtype holds it (bfloat16 rounds it to 1)
    abar = float(ta[0, 0, 5])
    decay = abar ** np.arange(1, s + 1, dtype=np.float64)
    _close(got[0, :, 5], decay.astype(np.float32), DTYPES[dtype][2])


@pytest.mark.parametrize("s,want", [
    (1, "serial"), (3, "serial"), (48, "serial"), (63, "serial"),
    (64, "chunked"), (300, "chunked"), (2048, "chunked"),
])
def test_route_by_sequence_length(s, want):
    """The launcher's [1, 3, 4096] prefills and [4, 1, 4096] decode
    steps take the serial kernel; a 300-token prompt the chunked one."""
    assert cuda_rglru.route(s) == want


@pytest.mark.parametrize("shape", [(1, 2048, 4096), (4, 1, 4096),
                                   (3, 65, 130), (1, 300, 4096)])
def test_scratch_words_cover_every_part(shape):
    """Ticket, flags (2 a chunk and 128-channel block), aggregates (2
    floats a channel and chunk) and last states (1), each 128-byte
    aligned."""
    b, s, w = shape
    chunks = -(-s // cuda_rglru.CHUNK)
    blocks = -(-w // cuda_rglru.THREADS)
    words = cuda_rglru.scratch_words(b, s, w)
    assert words % 32 == 0
    assert words >= 32 + 2 * b * chunks * blocks + 3 * b * chunks * w
    assert words < 32 + 2 * b * chunks * blocks + 3 * b * chunks * w + 96


def test_cpu_path_counts_no_route():
    """The CPU path runs the plain version at any S and counts neither a
    launch nor a route; the wrapper refuses a CPU tensor."""
    ops.reset_launches()
    a = torch.full((1, 100, 8), 0.9)
    h = ops.rglru_scan(a, torch.zeros_like(a), torch.ones((1, 8)))
    assert float(h[0, -1, 0]) == pytest.approx(0.9 ** 100, rel=1e-5)
    assert ops.route_counts("rglru_scan") == {"chunked": 0, "serial": 0}
    assert ops.launch_counts()["rglru_scan"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_rglru.rglru_scan(a, a, torch.ones((1, 8)))
