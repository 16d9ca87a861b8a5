"""The port's attention kernels (their plain PyTorch versions, which the
CPU path runs) against the JAX package: its Pallas kernels in interpret
mode and its jnp oracles, on the same numpy inputs.

Contract (the port's side of ``tests/test_kernels.py``'s attention
sweeps): 2e-3 in float32 and 2e-2 in bfloat16 over ``FLASH_SHAPES`` x
window {None, 64} and ``DECODE_SHAPES``; cache rows past ``length``
are ignored (1e-5).  The CUDA kernels themselves need the card;
``chip_smoke.py`` holds them against these plain versions there.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as jattn
from repro_torch.kernels import decode_attention as cuda_decode
from repro_torch.kernels import flash_attention as cuda_flash
from repro_torch.kernels import ops
from repro_torch.models import attention as attn

FLASH_SHAPES = [
    # (B, H, Hkv, S, D)
    (1, 4, 4, 128, 64),      # MHA
    (2, 8, 2, 256, 64),      # GQA 4:1
    (1, 4, 1, 256, 128),     # MQA
    (2, 2, 2, 512, 32),      # long-ish
]

DECODE_SHAPES = [
    (1, 4, 4, 256, 64),
    (2, 8, 2, 512, 64),
    (4, 8, 1, 1024, 128),
]

DTYPES = {"f32": (jnp.float32, torch.float32, 2e-3),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _normal(seed, shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _both(x, dtype):
    """The same values as a jax array and a torch tensor of one dtype
    (bf16 rounding happens once, in jax, and carries over exactly)."""
    jx = jnp.asarray(x).astype(DTYPES[dtype][0])
    return jx, torch.from_numpy(np.array(jx.astype(jnp.float32))).to(
        DTYPES[dtype][1])


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("shape", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 64])
def test_flash_attention_ref_matches_pallas(shape, dtype, window):
    b, h, hkv, s, d = shape
    jq, q = _both(_normal(0, (b, h, s, d)), dtype)
    jk, k = _both(_normal(1, (b, hkv, s, d)), dtype)
    jv, v = _both(_normal(2, (b, hkv, s, d)), dtype)
    want = jops.flash_attention(jq, jk, jv, causal=True, window=window)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("shape", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_decode_attention_ref_matches_pallas(shape, dtype):
    b, h, hkv, t, d = shape
    jq, q = _both(_normal(0, (b, h, d)), dtype)
    jk, k = _both(_normal(1, (b, hkv, t, d)), dtype)
    jv, v = _both(_normal(2, (b, hkv, t, d)), dtype)
    lengths = np.random.default_rng(0).integers(1, t, size=b).astype(
        np.int32)
    want = jops.decode_attention(jq, jk, jv, jnp.asarray(lengths))
    got = ops.decode_attention(q, k, v, torch.from_numpy(lengths))
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, want, DTYPES[dtype][2])


def test_decode_ignores_entries_past_length():
    """Garbage beyond the frontier must not affect the output."""
    b, h, hkv, t, d = 1, 4, 2, 256, 64
    q = torch.from_numpy(_normal(0, (b, h, d)))
    k = torch.from_numpy(_normal(1, (b, hkv, t, d)))
    v = torch.from_numpy(_normal(2, (b, hkv, t, d)))
    out1 = ops.decode_attention(q, k, v, torch.tensor([100]))
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 100:] = 1e4
    v2[:, :, 100:] = -1e4
    out2 = ops.decode_attention(q, k2, v2, torch.tensor([100]))
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), atol=1e-5)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("window", [None, 2])
def test_flash_ref_ragged_cache_readback(dtype, window):
    """The launcher's prefill: a 3-token prompt against a 48-row cache
    read back through a permuted [B,T,Hkv,D] view (Pallas asserts block
    divisibility here, so the jnp oracle is the target)."""
    b, h, hkv, s, t, d = 1, 28, 4, 3, 48, 128
    jq, q = _both(_normal(3, (b, h, s, d)), dtype)
    jk, k = _both(_normal(4, (b, t, hkv, d)), dtype)
    jv, v = _both(_normal(5, (b, t, hkv, d)), dtype)
    want = jref.flash_attention_ref(jq, jnp.swapaxes(jk, 1, 2),
                                    jnp.swapaxes(jv, 1, 2), causal=True,
                                    window=window)
    got = ops.flash_attention(q, k.transpose(1, 2), v.transpose(1, 2),
                              causal=True, window=window)
    _close(got, want, DTYPES[dtype][2])


@pytest.mark.parametrize("theta", [10_000.0, 1_000_000.0])
def test_rope_matches_reference(theta):
    x = _normal(6, (2, 40, 4, 128))
    pos = np.broadcast_to(np.arange(40) + 7, (2, 40))
    want = jattn.rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = attn.rope(torch.from_numpy(x), torch.from_numpy(pos.copy()),
                    theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("window", [None, 3])
@pytest.mark.parametrize("causal", [True, False])
def test_mask_matches_reference(window, causal):
    pq = np.arange(5, 9)[None]
    pk = np.arange(12)[None]
    want = jattn._mask(jnp.asarray(pq), jnp.asarray(pk), window, causal)
    got = attn._mask(torch.from_numpy(pq), torch.from_numpy(pk), window,
                     causal)
    assert got.numpy().tolist() == np.asarray(want).tolist()


def test_cpu_tensors_take_plain_versions_and_never_launch():
    """The CPU path runs the plain versions and counts no launch; the
    CUDA wrappers refuse a CPU tensor instead of computing on it."""
    q = torch.from_numpy(_normal(0, (1, 4, 8, 16)))
    k = torch.from_numpy(_normal(1, (1, 2, 8, 16)))
    ops.reset_launches()
    ops.flash_attention(q, k, k, causal=True)
    ops.decode_attention(q[:, :, 0], k, k, 3)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 0 and counts["decode_attention"] == 0
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_flash.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="CUDA device"):
        cuda_decode.decode_attention(q[:, :, 0], k, k, 3)
