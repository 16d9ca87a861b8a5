"""The port's xLSTM blocks (``models/recurrent.py`` mLSTM and sLSTM,
``models/blocks._mlstm_state_from_sequence``) against the JAX package's
at reduced xlstm-125m, on the reference's own weights carried over
through ``convert.params_from_numpy``.

Contract, float32, 1e-4: ``mlstm_parallel``, ``mlstm_step`` (from a
random state), the prefill state fold, ``slstm_sequence`` (fresh, where
``n`` starts at 1e-6, and from the state spec's, where it starts at 1)
and ``slstm_step`` equal the reference's, states included; the mLSTM's
parallel form equals its recurrent form stepped from the zero state
(the stabilizer cancels), and ``slstm_sequence`` equals ``slstm_step``
stepped over the same tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jget_reduced
from repro.models import blocks as jblocks
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.models import recurrent as jrec
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.models import blocks
from repro_torch.models import recurrent as rec
from repro_torch.models.params import materialize

ARCH = "xlstm-125m"
TOL = 1e-4


@pytest.fixture(scope="module")
def weights():
    """Layer 0's mLSTM (pos0) and sLSTM (pos1) weights, both packages."""
    jcfg = jget_reduced(ARCH)
    jp = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    cfg = get_reduced(ARCH)
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")

    def layer0(tree, pos, key):
        return {k: v[0] for k, v in tree["groups"]["main"][pos][key].items()}

    return (jcfg, cfg,
            {"mlstm": layer0(jp, "pos0", "mlstm"),
             "slstm": layer0(jp, "pos1", "slstm")},
            {"mlstm": layer0(params, "pos0", "mlstm"),
             "slstm": layer0(params, "pos1", "slstm")})


def _x(cfg, b, s, seed):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x)


def _state(spec_fn, cfg, b, seed, positive=("n",)):
    """A random float32 state with the spec's shapes (``n`` positive, as
    a stepped state's is), for both packages."""
    rng = np.random.default_rng(seed)
    st = {}
    for name, s in spec_fn(cfg, b).items():
        a = rng.standard_normal(s.shape).astype(np.float32)
        st[name] = np.abs(a) + 0.5 if name in positive else a
    return ({k: jnp.asarray(v) for k, v in st.items()},
            {k: torch.from_numpy(v) for k, v in st.items()})


def _close(got, want, tol=TOL, label=""):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=label)


def _states_close(got, want, label=""):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == torch.float32, (label, k)
        _close(got[k], want[k], label=f"{label} {k}")


def test_mlstm_parallel_matches_reference(weights):
    jcfg, cfg, jp, p = weights
    jx, x = _x(cfg, 2, 9, 0)
    _close(rec.mlstm_parallel(p["mlstm"], x, cfg=cfg),
           jrec.mlstm_parallel(jp["mlstm"], jx, cfg=jcfg))


def test_mlstm_step_matches_reference(weights):
    jcfg, cfg, jp, p = weights
    jx, x = _x(cfg, 2, 1, 1)
    jst, st = _state(rec.mlstm_state_spec, cfg, 2, 2)
    jy, jnew = jrec.mlstm_step(jp["mlstm"], jx, jst, cfg=jcfg)
    y, new = rec.mlstm_step(p["mlstm"], x, st, cfg=cfg)
    _close(y, jy)
    _states_close(new, jnew, "mlstm_step")
    with pytest.raises(ValueError, match="one token"):
        rec.mlstm_step(p["mlstm"], torch.cat([x, x], 1), st, cfg=cfg)


def test_mlstm_state_from_sequence_matches_reference(weights):
    """The prefill's fold of a 7-token sequence into the state, from the
    state spec's zeros."""
    jcfg, cfg, jp, p = weights
    jx, x = _x(cfg, 2, 7, 3)
    st0 = materialize(rec.mlstm_state_spec(cfg, 2), torch.Generator(),
                      "cpu")
    jst0 = {k: jnp.asarray(v.numpy()) for k, v in st0.items()}
    _states_close(
        blocks._mlstm_state_from_sequence(p["mlstm"], x, st0, cfg),
        jblocks._mlstm_state_from_sequence(jp["mlstm"], jx, jst0, jcfg),
        "fold")


def test_mlstm_parallel_equals_stepped(weights):
    """The stabilized parallel form against ``mlstm_step`` token by
    token from the zero state: the same function, to float32 rounding."""
    _, cfg, _, p = weights
    _, x = _x(cfg, 2, 11, 4)
    st = materialize(rec.mlstm_state_spec(cfg, 2), torch.Generator(), "cpu")
    ys = []
    for t in range(x.shape[1]):
        y, st = rec.mlstm_step(p["mlstm"], x[:, t:t + 1], st, cfg=cfg)
        ys.append(y)
    _close(torch.cat(ys, 1), rec.mlstm_parallel(p["mlstm"], x, cfg=cfg)
           .numpy())


@pytest.mark.parametrize("start", ["fresh", "spec", "random"])
def test_slstm_sequence_matches_reference(weights, start):
    """Without a state (``n`` from 1e-6, no state returned), from the
    state spec's (``n`` from 1) and from a random state."""
    jcfg, cfg, jp, p = weights
    jx, x = _x(cfg, 2, 6, 5)
    if start == "fresh":
        jst = st = None
    elif start == "spec":
        st = materialize(rec.slstm_state_spec(cfg, 2), torch.Generator(),
                         "cpu")
        assert bool((st["n"] == 1).all())
        jst = {k: jnp.asarray(v.numpy()) for k, v in st.items()}
    else:
        jst, st = _state(rec.slstm_state_spec, cfg, 2, 6)
    jy, jnew = jrec.slstm_sequence(jp["slstm"], jx, cfg=jcfg, state=jst)
    y, new = rec.slstm_sequence(p["slstm"], x, cfg=cfg, state=st)
    _close(y, jy)
    if st is None:
        assert new is None and jnew is None
    else:
        _states_close(new, jnew, "slstm_sequence")


def test_slstm_step_matches_reference(weights):
    jcfg, cfg, jp, p = weights
    jx, x = _x(cfg, 2, 1, 7)
    jst, st = _state(rec.slstm_state_spec, cfg, 2, 8)
    jy, jnew = jrec.slstm_step(jp["slstm"], jx, jst, cfg=jcfg)
    y, new = rec.slstm_step(p["slstm"], x, st, cfg=cfg)
    _close(y, jy)
    _states_close(new, jnew, "slstm_step")


def test_slstm_sequence_equals_stepped(weights):
    _, cfg, _, p = weights
    _, x = _x(cfg, 2, 6, 9)
    _, st0 = _state(rec.slstm_state_spec, cfg, 2, 10)
    y, fin = rec.slstm_sequence(p["slstm"], x, cfg=cfg, state=st0)
    st, ys = st0, []
    for t in range(x.shape[1]):
        yt, st = rec.slstm_step(p["slstm"], x[:, t:t + 1], st, cfg=cfg)
        ys.append(yt)
    _close(torch.cat(ys, 1), y.numpy())
    for k in fin:
        _close(st[k], fin[k].numpy(), label=k)


def test_xlstm_state_specs_match_reference(weights):
    jcfg, cfg, _, _ = weights
    for ours, theirs in ((rec.mlstm_state_spec, jrec.mlstm_state_spec),
                         (rec.slstm_state_spec, jrec.slstm_state_spec)):
        got, want = ours(cfg, 3), theirs(jcfg, 3)
        assert {k: (v.shape, v.axes, v.init) for k, v in got.items()} == \
            {k: (v.shape, v.axes, v.init) for k, v in want.items()}
        assert all(v.dtype == torch.float32 for v in got.values())
