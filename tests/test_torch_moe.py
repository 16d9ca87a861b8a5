"""The port's MoE FFN (``models/moe.py``) against the JAX package's
(``repro/models/moe.py``), on reduced Mixtral-8x22B weights drawn by the
reference and carried over through ``convert.params_from_numpy``.

Contract: ``moe_onehot`` (capacity drops included), ``moe_dense``, the
grouped dispatch and the shared expert give outputs and the router's
auxiliary loss within 1e-5 of the reference in float32 and 2e-2 in
bfloat16; the reference's own MoE properties hold on the port (onehot
equals dense, and grouping equals no grouping, at a capacity that drops
nothing); ``RunFlags.moe_impl`` / ``moe_group`` reach the FFN; a reduced
Mixtral with a shared expert prefills and decodes within 1e-4 of the
reference.  (The serving engine on reduced Mixtral is held against the
reference engine in ``tests/test_torch_serving.py``.)
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
from repro.models.moe import moe_dense as jmoe_dense
from repro.models.moe import moe_ffn as jmoe_ffn
from repro.models.moe import moe_onehot as jmoe_onehot
from repro_torch.configs import get_reduced
from repro_torch.convert import caches_from_numpy, params_from_numpy
from repro_torch.models import (MoEConfig, RunFlags, build_param_specs,
                                decode_step, materialize, moe_dense, moe_ffn,
                                moe_onehot, prefill)
from repro_torch.models.moe import _router

ARCH = "mixtral-8x22b"
JFLAGS = JRunFlags(remat="none")
FLAGS = RunFlags(remat="none")
TOL = {"float32": 1e-5, "bfloat16": 2e-2}


def _np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _configs(dtype="float32", **moe):
    """Reduced Mixtral in both packages, with ``moe`` overriding its MoE
    fields and ``dtype`` its parameter and compute dtypes."""
    jcfg, cfg = jget_reduced(ARCH), get_reduced(ARCH)
    jd, td = {"float32": (jnp.float32, torch.float32),
              "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    jcfg = dataclasses.replace(
        jcfg, moe=dataclasses.replace(jcfg.moe, **moe), param_dtype=jd,
        compute_dtype=jd)
    cfg = dataclasses.replace(
        cfg, moe=dataclasses.replace(cfg.moe, **moe), param_dtype=td,
        compute_dtype=td)
    return jcfg, cfg


def _layer(dtype="float32", b=2, s=16, seed=0, **moe):
    """Layer 0's MoE FFN weights of the reference's reduced Mixtral and
    the port's copy, and one input [b, s, d] from a numpy seed."""
    jcfg, cfg = _configs(dtype, **moe)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    tp = params_from_numpy(cfg, _np_tree(jp), "cpu")
    jffn = jax.tree_util.tree_map(lambda a: a[0],
                                  jp["groups"]["main"]["pos0"]["ffn"])
    tffn = {k: v[0] if not isinstance(v, dict) else
            {n: w[0] for n, w in v.items()}
            for k, v in tp["groups"]["main"]["pos0"]["ffn"].items()}
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.compute_dtype)
    tx = torch.from_numpy(x).to(cfg.compute_dtype)
    return jcfg, cfg, jffn, tffn, jx, tx


def _close(got, want, dtype):
    tol = TOL[dtype]
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _drops(p, x, m, cf):
    """Assignments a capacity-``cf`` one-hot dispatch of x drops."""
    _, idx, _ = _router(p, x, m)
    cap = max(int(np.ceil(x.shape[1] * m.top_k * cf / m.n_experts)), 1)
    counts = torch.nn.functional.one_hot(idx, m.n_experts).sum(dim=(1, 2))
    return int((counts - cap).clamp_min(0).sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_onehot_matches_reference(cf, dtype):
    """Capacity factor 0.5 drops assignments (asserted), 4.0 none."""
    jcfg, cfg, jp, p, jx, x = _layer(dtype)
    jy, jaux = jmoe_onehot(jp, jx, jcfg.moe, capacity_factor=cf)
    y, aux = moe_onehot(p, x, cfg.moe, capacity_factor=cf)
    assert y.dtype == x.dtype and y.shape == x.shape
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)
    dropped = _drops(p, x, cfg.moe, cf)
    assert (dropped > 0) == (cf < 1), dropped


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_matches_reference(dtype):
    jcfg, cfg, jp, p, jx, x = _layer(dtype)
    jy, jaux = jmoe_dense(jp, jx, jcfg.moe)
    y, aux = moe_dense(p, x, cfg.moe)
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_grouped_dispatch_matches_reference(dtype):
    """``group_size=8`` splits each 32-token sequence into four dispatch
    groups, with capacity (and drops, at the config's factor 2.0 and at
    0.5) per group."""
    jcfg, cfg, jp, p, jx, x = _layer(dtype, s=32)
    for cf in (None, 0.5):
        jy, jaux = jmoe_onehot(jp, jx, jcfg.moe, capacity_factor=cf,
                               group_size=8)
        y, aux = moe_onehot(p, x, cfg.moe, capacity_factor=cf, group_size=8)
        _close(y, jy, dtype)
        np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("impl", ["onehot", "dense"])
def test_shared_expert_matches_reference(impl, dtype):
    """A reduced config with one shared expert (DeepSeek's layout): the
    routed output plus the shared SwiGLU, through ``moe_ffn``."""
    jcfg, cfg, jp, p, jx, x = _layer(dtype, n_shared_experts=1)
    assert set(p["shared"]) == {"wi_gate", "wi_up", "wo"}
    jy, jaux = jmoe_ffn(jp, jx, jcfg, impl=impl)
    y, aux = moe_ffn(p, x, cfg, impl=impl)
    _close(y, jy, dtype)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


def _port_layer(**moe):
    cfg = dataclasses.replace(get_reduced(ARCH), moe=MoEConfig(**moe))
    p = materialize(build_param_specs(cfg), torch.Generator().manual_seed(0),
                    "cpu")["groups"]["main"]["pos0"]["ffn"]
    return cfg, {k: v[0] for k, v in p.items()}


def test_moe_onehot_matches_dense_at_high_capacity():
    """With capacity >= S*k/E guaranteed no drops, onehot == dense (the
    reference's test, on the port)."""
    cfg, p = _port_layer(n_experts=4, top_k=2, d_ff_expert=32,
                         capacity_factor=4.0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (2, 16, cfg.d_model)).astype(np.float32))
    y1, aux1 = moe_ffn(p, x, cfg, impl="onehot")
    y2, aux2 = moe_ffn(p, x, cfg, impl="dense")
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(float(aux1), float(aux2), rtol=1e-5)


def test_moe_grouping_matches_ungrouped_at_high_capacity():
    """Dispatch grouping preserves the result when capacity guarantees
    no drops (the reference's test, on the port)."""
    cfg, p = _port_layer(n_experts=4, top_k=2, d_ff_expert=32,
                         capacity_factor=8.0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 32, cfg.d_model)).astype(np.float32))
    y1, _ = moe_ffn(p, x, cfg, impl="onehot")
    y2, _ = moe_ffn(p, x, cfg, impl="onehot", group_size=8)
    np.testing.assert_allclose(y1.numpy(), y2.numpy(), rtol=2e-4, atol=2e-4)


def _model_run(jcfg, cfg, jflags, flags, B=2, S=12, steps=4):
    """A reduced prefill and ``steps`` greedy decode steps in both
    packages on the reference's weights; logits within 1e-4."""
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, _np_tree(jp), "cpu")
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (B, S))
    jc = jmaterialize(jbuild_cache_specs(jcfg, B, S + steps, jnp.float32),
                      jax.random.PRNGKey(0))
    caches = caches_from_numpy(_np_tree(jc), "cpu")
    jl, jc = jprefill(jp, {"tokens": jnp.asarray(toks, jnp.int32)}, jc,
                      jcfg, jflags)
    tl, caches = prefill(params, {"tokens": torch.from_numpy(toks)}, caches,
                         cfg, flags)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for pos in range(S, S + steps):
        nxt = np.array(jnp.argmax(jl, -1))[:, None]
        assert nxt.tolist() == torch.argmax(tl, -1)[:, None].tolist()
        jl, jc = jdecode_step(jp, jnp.asarray(nxt, jnp.int32), jc,
                              jnp.int32(pos), jcfg, jflags)
        tl, caches = decode_step(params, torch.from_numpy(nxt), caches, pos,
                                 cfg, flags)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    return tl


def test_shared_expert_model_matches_reference():
    jcfg, cfg = _configs(n_shared_experts=1)
    _model_run(jcfg, cfg, JFLAGS, FLAGS)


@pytest.mark.parametrize("impl,group", [("dense", 0), ("onehot", 4)])
def test_run_flags_reach_the_moe_ffn(impl, group):
    """``RunFlags.moe_impl`` and ``moe_group`` override the config (at
    capacity factor 0.5, where grouping and the dense oracle each give
    another result than the config's one-group onehot dispatch)."""
    jcfg, cfg = _configs(capacity_factor=0.5)
    jflags = dataclasses.replace(JFLAGS, moe_impl=impl, moe_group=group)
    flags = dataclasses.replace(FLAGS, moe_impl=impl, moe_group=group)
    got = _model_run(jcfg, cfg, jflags, flags)
    plain = _model_run(jcfg, cfg, JFLAGS, FLAGS)
    assert not torch.allclose(got, plain, rtol=1e-3, atol=1e-3)
