"""The port's GPipe pipeline against the JAX package and its own plain
stack, on the CPU.

The reference's three cases (``tests/test_pipeline.py``) on the port:
the one-stage pipelined loss within rel 1e-4 of the reference's
``train_loss`` and of its own one-stage pipelined loss on the same
weights, the gradient flowing, and the stage split's shapes.  The
reference's ``test_pipeline_grad_flows`` fails (``ShardingTypeError``),
so the port's pipelined gradient is held against the port's own
``train_loss`` gradient, within 1e-5 of each leaf's max; two stages run
as two gloo processes (``_torch_spmd``).
"""
import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

import _torch_spmd
from repro.configs import get_reduced as jget_reduced
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import materialize as jmaterialize
from repro.models import train_loss as jtrain_loss
from repro.training.pipeline import \
    make_pipelined_train_loss as jmake_pipelined_train_loss
from repro.training.pipeline import split_stage_params as jsplit_stage_params
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import Mesh
from repro_torch.launch.steps import value_and_grad
from repro_torch.models import RunFlags, build_param_specs, materialize
from repro_torch.models.params import (leaves_with_paths, tree_leaves,
                                       tree_unflatten)
from repro_torch.training.pipeline import (make_pipelined_train_loss,
                                           split_stage_params)

FLAGS = RunFlags(remat="none")


@pytest.fixture
def pod1():
    """A ("pod",) mesh of one rank on an in-process gloo group."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield Mesh(init_device_mesh("cpu", (1,), mesh_dim_names=("pod",)))
    finally:
        dist.destroy_process_group()


def test_single_stage_pipeline_matches_plain_stack(pod1):
    """The reference's weights carried over: the port's one-stage
    pipelined loss within rel 1e-4 of the reference's ``train_loss`` and
    of the reference's own one-stage pipelined loss."""
    arch = "granite-20b"
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jparams = jmaterialize(jbuild_param_specs(jcfg), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree_util.tree_map(np.asarray,
                                                           jparams), "cpu")
    B, S, M = 4, 16, 2
    tok = np.random.default_rng(1).integers(0, cfg.vocab_size,
                                            (B, S)).astype(np.int32)
    loss_fn = make_pipelined_train_loss(cfg, pod1, n_microbatches=M,
                                        flags=FLAGS)
    got = float(loss_fn(split_stage_params(params, cfg, n_stages=1),
                        {"tokens": torch.from_numpy(tok),
                         "labels": torch.from_numpy(tok)}))
    jbatch = {"tokens": jax.numpy.asarray(tok),
              "labels": jax.numpy.asarray(tok)}
    want = float(jtrain_loss(jparams, jbatch, jcfg, JRunFlags(remat="none")))
    jmesh = jax.make_mesh((1,), ("pod",))
    jloss_fn = jmake_pipelined_train_loss(jcfg, jmesh, n_microbatches=M,
                                          flags=JRunFlags(remat="none"))
    with jmesh:
        jgot = float(jloss_fn(jsplit_stage_params(jparams, jcfg, 1), jbatch))
    assert got == pytest.approx(want, rel=1e-4)
    assert got == pytest.approx(jgot, rel=1e-4)


def test_pipeline_grad_flows(pod1):
    """The one-stage pipelined gradient against ``train_loss``'s on the
    port (the reference's own case fails with ``ShardingTypeError``):
    every leaf within 1e-5 of its max, finite, and the loss too."""
    cfg = get_reduced("granite-20b")
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    tok = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 16)).astype(np.int32))
    batch = {"tokens": tok, "labels": tok}
    staged = split_stage_params(params, cfg, n_stages=1)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(staged)]
    loss_fn = make_pipelined_train_loss(cfg, pod1, n_microbatches=2,
                                        flags=FLAGS)
    loss = loss_fn(tree_unflatten(staged, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    want_loss, want = value_and_grad(params, batch, cfg, FLAGS)
    assert float(loss.detach()) == pytest.approx(float(want_loss), rel=1e-5)
    gn = sum(float((g.float() ** 2).sum()) for g in grads)
    assert np.isfinite(gn) and gn > 0
    for (path, w), g in zip(leaves_with_paths(
            split_stage_params(want, cfg, n_stages=1)), grads):
        err = float((g - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (path, err)


def test_stage_split_shapes():
    cfg = get_reduced("granite-20b")            # 2 layers
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    staged = split_stage_params(params, cfg, n_stages=2)
    leaf = tree_leaves(staged["groups"]["main"]["pos0"])[0]
    assert leaf.shape[0] == 2 and leaf.shape[1] == 1
    with pytest.raises(ValueError):
        split_stage_params(params, cfg, n_stages=3)
    rg = get_reduced("recurrentgemma-9b")       # two groups
    with pytest.raises(ValueError, match="single-group"):
        split_stage_params({}, rg, n_stages=1)


def test_two_stage_pipeline_matches_train_loss(tmp_path):
    """Two stages as two gloo processes, 2 microbatches: on each rank the
    loss within rel 1e-5 of ``train_loss`` and every gradient leaf within
    1e-5 of its max (``_torch_spmd.pipeline_two_stages``)."""
    _torch_spmd.spawn("pipeline_two_stages", 2, tmp_path, timeout=180)
