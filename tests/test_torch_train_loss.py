"""The port's training loss and train step against the JAX package, on
the CPU, at every reduced arch, with the reference's own weights carried
over (``build_param_specs`` -> ``materialize(PRNGKey(0))`` ->
``convert.params_from_numpy``) and the same numpy batch on both sides.

Contract: ``train_loss`` within 1e-5 relative and each gradient leaf
within 1e-4 of that leaf's max |g| plus 1e-7 (reference
``jax.value_and_grad`` against the port's ``torch.autograd``; the MoE
router's auxiliary loss included); three ``make_train_step`` steps
(``warmup_steps=0``, ``grad_accum=2``, compression on) with params, mu,
nu and ef within rtol 1e-5, atol 1e-7; ``remat="full"`` and ``"dots"`` equal to
``"none"``, recomputing each layer's kernels once, and ``"dots"``
against the reference's ``"dots"``.

The gradient bound is held at two inits of the same weights.  At the
d_model fan-in law (every [d_model, heads, head_dim] projection scaled
from the reference's std 1/sqrt(heads) to 1/sqrt(d_model), as
``chip_smoke._fan_in_d_model``) for all eleven.  At the reference's own
init law for the six whose reference gradients reproduce within the
bound there (``REPRODUCIBLE``): for gemma3-1b, whisper-base,
xlstm-125m, granite-20b and recurrentgemma-9b a 1e-7 relative
perturbation of the reference's own weights moves its own gradient by
1.3-4.2 times the bound (``tools/grad_conditioning.py``), so no float32
implementation could be held to it; there every leaf is held finite and
nonzero where the reference's is, and the loss to 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import get_reduced as jget_reduced
from repro.launch.steps import make_train_step as jmake_train_step
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.models.model import train_loss as jtrain_loss
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro.training.trainer import init_state as jinit_state
from repro_torch.configs import ARCHS, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import ops
from repro_torch.launch.steps import make_train_step, value_and_grad
from repro_torch.models import RunFlags
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.training.optimizer import AdamWConfig

REPRODUCIBLE = ("qwen2-5-7b", "command-r-35b", "internvl2-26b",
                "mixtral-8x22b", "minicpm3-4b", "deepseek-v2-236b")
_JIT = {}
LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-7


def _fan_in_d_model(tree, specs):
    """Every [d_model, heads, head_dim] projection scaled from the
    reference's init law (std 1/sqrt(heads)) to 1/sqrt(d_model)."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _fan_in_d_model(v, specs[k])
        elif specs[k].axes[-3:-1] in (("embed", "heads"),
                                      ("embed", "kv_heads")):
            out[k] = v * np.float32((v.shape[-2] / v.shape[-3]) ** 0.5)
        else:
            out[k] = v
    return out


def _weights(arch, fan_in_d_model=False):
    """(jcfg, cfg, the reference's weights as numpy)."""
    jcfg = jget_reduced(arch)
    tree = jax.tree_util.tree_map(np.asarray, jmaterialize(
        jbuild_param_specs(jcfg), jax.random.PRNGKey(0)))
    if fan_in_d_model:
        tree = _fan_in_d_model(tree, jbuild_param_specs(jcfg))
    return jcfg, get_reduced(arch), tree


def _batch(cfg, b=2, s=16, seed=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.encoder is not None:
        out["source_embeds"] = 0.01 * rng.standard_normal(
            (b, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
    if cfg.n_prefix_embeddings:
        out["prefix_embeds"] = 0.01 * rng.standard_normal(
            (b, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
    return out


def _both(arch, fan_in_d_model=False, remat="full"):
    """(reference loss, grads by keystr path, port loss, port grads)."""
    jcfg, cfg, tree = _weights(arch, fan_in_d_model)
    batch = _batch(cfg)
    if (arch, remat) not in _JIT:
        _JIT[arch, remat] = jax.jit(jax.value_and_grad(
            lambda p, b: jtrain_loss(p, b, jcfg, JRunFlags(remat=remat))))
    jl, jg = _JIT[arch, remat](jax.tree_util.tree_map(jnp.asarray, tree),
                               {k: jnp.asarray(v) for k, v in batch.items()})
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jg)[0]}
    loss, grads = value_and_grad(
        params_from_numpy(cfg, tree, "cpu"),
        {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
        RunFlags(remat=remat))
    return float(jl), want, float(loss), dict(leaves_with_paths(grads))


def _hold(jl, want, loss, got, bound=True):
    assert abs(loss - jl) <= LOSS_REL * abs(jl), (loss, jl)
    assert sorted(got) == sorted(want)
    for path, g in got.items():
        w = want[path]
        assert bool(torch.isfinite(g).all()), path
        assert bool(g.any()) == bool(np.any(w)), path
        if bound:
            err = np.abs(g.numpy() - w).max()
            tol = GRAD_REL * np.abs(w).max() + GRAD_ABS
            assert err <= tol, (path, err, tol)


def test_every_reference_arch_is_covered():
    assert sorted(ARCHS) == sorted(JARCHS) and len(ARCHS) == 11
    assert set(REPRODUCIBLE) < set(ARCHS)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch):
    _hold(*_both(arch, fan_in_d_model=True))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_at_reference_init(arch):
    _hold(*_both(arch), bound=arch in REPRODUCIBLE)


def test_moe_aux_loss_reaches_the_loss():
    """Mixtral's router aux loss is part of the loss the parity holds:
    without it the port would miss the reference by far more than 1e-5."""
    from repro_torch.models import blocks
    _, cfg, tree = _weights("mixtral-8x22b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    params = params_from_numpy(cfg, tree, "cpu")
    loss, _ = value_and_grad(params, batch, cfg, RunFlags())
    real = blocks.moe_lib.moe_ffn
    try:
        blocks.moe_lib.moe_ffn = lambda *a, **kw: (real(*a, **kw)[0],
                                                   torch.zeros(()))
        no_aux, _ = value_and_grad(params, batch, cfg, RunFlags())
    finally:
        blocks.moe_lib.moe_ffn = real
    assert float(loss - no_aux) > 100 * LOSS_REL * float(loss)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "whisper-base"])
def test_remat_full_equals_none_and_recomputes_each_layer(arch, monkeypatch):
    """``remat="full"`` (two scan groups; an encoder and cross-attention)
    gives the same loss and gradients as ``"none"``, and runs each
    layer's attention and scan twice (forward and recompute), as the
    card's launch counts (``chip_smoke.py`` phases 19-20) expect."""
    runs = _counted_runs(arch, ("none", "full"), monkeypatch)
    _same_runs(runs["full"], runs["none"])
    assert runs["full"][2] == {k: 2 * n for k, n in runs["none"][2].items()}
    assert runs["none"][2]["flash_attention"] > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_dots_matches_reference_dots(arch):
    """``remat="dots"`` (the matrix products' outputs saved, the rest
    recomputed) against the reference's ``jax.value_and_grad`` under its
    ``checkpoint_dots`` policy, at the d_model fan-in law, within the
    bounds above."""
    _hold(*_both(arch, fan_in_d_model=True, remat="dots"))


def _counted_runs(arch, remats, monkeypatch):
    """{remat: (loss, grads, the ops calls of one value_and_grad)}."""
    _, cfg, tree = _weights(arch)
    params = params_from_numpy(cfg, tree, "cpu")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    calls = {"flash_attention": 0, "rglru_scan": 0}
    for name in calls:
        real = getattr(ops, name)

        def counted(*a, _real=real, _name=name, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ops, name, counted)
    runs = {}
    for remat in remats:
        for k in calls:
            calls[k] = 0
        loss, grads = value_and_grad(params, batch, cfg,
                                     RunFlags(remat=remat))
        runs[remat] = (loss, grads, dict(calls))
    return runs


def _same_runs(a, b):
    assert float(a[0]) == float(b[0])
    for (p, x), (_, y) in zip(leaves_with_paths(a[1]),
                              leaves_with_paths(b[1])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-6,
                                   atol=1e-9, err_msg=p)


def test_remat_dots_equals_none_and_recomputes_each_layer(monkeypatch):
    """``"dots"`` gives ``"none"``'s loss and gradients (rtol 1e-6) on
    RecurrentGemma's two groups, and runs each layer's attention and scan
    twice, as ``"full"`` does: the kernels are no aten matrix product,
    so the policy recomputes them (the card's launch counts,
    ``chip_smoke.py`` phase 22, expect the same)."""
    runs = _counted_runs("recurrentgemma-9b", ("none", "dots"), monkeypatch)
    _same_runs(runs["dots"], runs["none"])
    assert runs["dots"][2] == {k: 2 * n for k, n in runs["none"][2].items()}
    assert runs["none"][2]["flash_attention"] > 0
    assert runs["none"][2]["rglru_scan"] > 0


def test_unknown_remat_raises():
    _, cfg, tree = _weights("qwen2-5-7b")
    batch = {k: torch.from_numpy(v) for k, v in _batch(cfg).items()}
    with pytest.raises(ValueError, match="remat"):
        value_and_grad(params_from_numpy(cfg, tree, "cpu"), batch, cfg,
                       RunFlags(remat="all"))


def _reference_state(jcfg, cfg, compression):
    """The reference's ``init_state`` and the port's copy of it."""
    jstate = jinit_state(jcfg, 0, compression=compression)
    keys = ("mu", "nu", "ef") if compression else ("mu", "nu")
    state = {
        "params": params_from_numpy(cfg, jax.tree_util.tree_map(
            np.asarray, jstate["params"]), "cpu"),
        **{k: tree_map(lambda a: torch.from_numpy(np.array(a)),
                       jax.tree_util.tree_map(np.asarray, jstate[k]))
           for k in keys},
        "step": torch.zeros((), dtype=torch.int32)}
    return jstate, state, ("params",) + keys


def _three_steps(compression, opt_kw, check, jit=True):
    arch = "qwen2-5-7b"
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jstate, state, keys = _reference_state(jcfg, cfg, compression)
    jstep = jmake_train_step(jcfg, JAdamWConfig(**opt_kw),
                             JRunFlags(grad_accum=2),
                             compression=compression)
    jstep = jax.jit(jstep) if jit else jstep
    step = make_train_step(cfg, AdamWConfig(**opt_kw),
                           RunFlags(grad_accum=2), compression=compression)
    for i in range(3):
        batch = _batch(cfg, b=4, s=16, seed=10 + i)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                    for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
        for name in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[name]), float(jm[name]),
                                       rtol=1e-5)
    assert int(state["step"]) == int(jstate["step"]) == 3
    for key in keys:
        if key not in check:
            continue
        want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
                jax.tree_util.tree_flatten_with_path(jstate[key])[0]}
        for path, t in leaves_with_paths(state[key]):
            np.testing.assert_allclose(t.numpy(), want[path], rtol=1e-5,
                                       atol=1e-7, err_msg=f"{key}{path}")


def _linear_loss(jax_side):
    """A loss linear in every parameter, sum_leaf sum(p * c_leaf) * w(mb),
    with w the microbatch's token sum x 1e-3: its gradient c_leaf * w is
    one float32 product, the same bits in both packages."""
    rng = np.random.default_rng(3)
    consts = {}

    def const(path, shape):
        if path not in consts:
            consts[path] = rng.standard_normal(shape).astype(np.float32)
        return consts[path]

    if jax_side:
        def loss(params, batch, cfg, flags):
            w = jnp.sum(batch["tokens"]).astype(jnp.float32) * 1e-3
            flat = jax.tree_util.tree_flatten_with_path(params)[0]
            return sum(jnp.sum(p * (jnp.asarray(const(
                jax.tree_util.keystr(k), p.shape)) * w)) for k, p in flat)
    else:
        def loss(params, batch, cfg, flags):
            w = batch["tokens"].sum().to(torch.float32) * 1e-3
            return sum(torch.sum(p * (torch.from_numpy(const(
                k, tuple(p.shape))) * w))
                for k, p in leaves_with_paths(params))
    return loss


def test_make_train_step_matches_reference(monkeypatch):
    """Three steps with warmup 0, two microbatches and int8 error-feedback
    compression: params, mu, nu and ef within rtol 1e-5, atol 1e-7.  The
    loss is linear in the parameters on both sides (``_linear_loss``), so
    both steps compress the same gradient bits: with the model's float32
    gradients (within 1e-4 of each other, above) an element near an int8
    rounding boundary takes a different code (1/127 of the tensor's max),
    and no tolerance of 1e-5 could hold.  The reference step runs op by
    op: under ``jax.jit`` XLA fuses the int8 round trip and its codes
    and residuals differ from its own op-by-op run's, which the port's
    match bit for bit (``tests/test_torch_training.py``)."""
    from repro.launch import steps as jsteps
    from repro_torch.launch import steps
    monkeypatch.setattr(jsteps, "train_loss", _linear_loss(True))
    monkeypatch.setattr(steps, "train_loss", _linear_loss(False))
    _three_steps(True, dict(lr=1e-2, warmup_steps=0, total_steps=10),
                 ("params", "mu", "nu", "ef"), jit=False)


def test_make_train_step_on_the_model_matches_reference():
    """The same three steps on the model's own loss, without compression,
    at the default learning rate: loss, grad norm and params within rtol
    1e-5, atol 1e-7 (the moments carry the gradients' own 1e-4 gap)."""
    _three_steps(False, dict(warmup_steps=0, total_steps=10), ("params",))
