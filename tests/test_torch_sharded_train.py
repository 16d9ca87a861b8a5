"""The sharded train body (``launch/steps.jit_cell``'s ``"sharded"``
layout: FSDP over "data", tensor parallelism over "model", the residual
split by rows and sequence) of the four dense decoders, on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_train``)
every (mesh, arch, variant) case of ``_torch_spmd.MESHES`` x ``DENSE`` x
``VARIANTS`` is held against the unsharded ``make_train_step`` on the
same state: the loss and grad norm of two steps and every param and
moment within rtol 1e-5 (with and without two microbatches), each
rank's state exactly its block of ``input_shardings``; with int8
compression each scale within rtol 1e-6 and at most 0.1 % of the codes
one step off, where a rank's own max |g| misses.  Reduced gemma3's 2
heads on (1, 4) take the replicated-heads route, reduced granite's and
command-r's K/V heads the replicated-K/V route.  The weights are at the
d_model fan-in law (``_torch_spmd.fan_in_d_model``).  At world size 1
the cell is held against the reference's own ``jit_cell``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_spmd
from _torch_spmd import DENSE, MESHES, VARIANTS
from test_torch_train_loss import _fan_in_d_model
from repro.configs import get_reduced as jget_reduced
from repro.launch import steps as jsteps
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models.params import materialize as jmaterialize
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import SHAPES, ShapeSpec, jit_cell
from repro_torch.models import RunFlags
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.training.optimizer import AdamWConfig

CASES = [(world, data, model, arch, variant)
         for world in sorted(MESHES) for data, model in MESHES[world]
         for arch in DENSE for variant in VARIANTS]


class FakeMesh:
    """Just axis_names + shape, enough for partition_spec resolution."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> each rank's outcome a case, the job run once a world."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"sharded_train_{world}")
            _torch_spmd.spawn("sharded_train", world, tmp, timeout=300)
            done[world] = [json.loads((tmp / f"sharded_train.{r}.json")
                                      .read_text()) for r in range(world)]
        return done[world]
    return get


@pytest.mark.parametrize(
    "world,data,model,arch,variant", CASES,
    ids=[f"{d}x{m}-{a}-{v}" for _, d, m, a, v in CASES])
def test_sharded_train_matches_the_unsharded_step(runs, world, data, model,
                                                  arch, variant):
    name = f"{data}x{model}-{arch}-{variant}"
    for rank, res in enumerate(runs(world)):
        assert res[name] == "ok", (rank, res[name])


def test_layout_is_chosen_from_the_config():
    """The dense decoders' and mixtral-8x22b's train, prefill_32k and
    decode_32k cells are sharded on both production meshes (the serving
    ones: ``tests/test_torch_sharded_serve.py``, Mixtral's:
    ``tests/test_torch_sharded_moe.py``); every other arch's cells and
    their long_500k are gathered, and so is a train cell whose sequence
    does not split over "model"."""
    for arch in ARCHS:
        cfg = get_config(arch)
        for mesh in (FakeMesh({"data": 16, "model": 16}),
                     FakeMesh({"pod": 2, "data": 16, "model": 16})):
            for sname, shape in SHAPES.items():
                want = "sharded" if (arch in DENSE + ("mixtral-8x22b",)
                                     and sname != "long_500k") \
                    else "gathered"
                assert steps.layout(cfg, shape, mesh) == want, (arch, sname)
    cfg = get_reduced("granite-20b")
    odd = ShapeSpec("t", "train", 30, 4)
    assert steps.layout(cfg, odd, FakeMesh({"data": 2, "model": 4})) == \
        "gathered"
    assert steps.layout(cfg, odd, FakeMesh({"data": 2, "model": 1})) == \
        "sharded"
    # rows that do not split over "data" would repeat a data rank's
    # gradient in every FSDP reduce-scatter
    assert steps.layout(cfg, ShapeSpec("t", "train", 32, 3),
                        FakeMesh({"data": 2, "model": 2})) == "gathered"


@pytest.fixture
def gloo1():
    """A one-rank gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


OPT = dict(warmup_steps=0, total_steps=10)


@pytest.mark.parametrize("arch", DENSE)
def test_sharded_cell_matches_reference_jit_cell(arch, gloo1):
    """The reference's ``jit_cell`` train step and the port's sharded
    one at world size 1 on the same carried-over state at the d_model
    fan-in law: loss and grad norm within rtol 1e-5, params within rtol
    1e-5, atol 1e-7, over two steps (the first at learning rate 0)."""
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jshape = jsteps.ShapeSpec("tiny_train", "train", 32, 2)
    shape = ShapeSpec("tiny_train", "train", 32, 2)
    assert steps.layout(cfg, shape, gloo1) == "sharded"
    jstate = jax.tree_util.tree_map(np.asarray, jmaterialize(
        jsteps.input_specs(jcfg, jshape)["state"], jax.random.PRNGKey(0)))
    jstate["params"] = _fan_in_d_model(jstate["params"],
                                       jbuild_param_specs(jcfg))
    state = {"params": params_from_numpy(cfg, jstate["params"], "cpu"),
             **{k: tree_map(lambda a: torch.from_numpy(np.array(a)),
                            jstate[k]) for k in ("mu", "nu")},
             "step": torch.zeros((), dtype=torch.int32)}
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jf, _ = jsteps.jit_cell(jcfg, jshape, jmesh,
                            flags=JRunFlags(remat="full"),
                            opt=JAdamWConfig(**OPT))
    step, _ = jit_cell(cfg, shape, gloo1, RunFlags(remat="full"),
                       AdamWConfig(**OPT))
    jst = jax.tree_util.tree_map(jnp.asarray, jstate)
    rng = np.random.default_rng(20)
    for i in range(2):
        tok = rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int32)
        with jmesh:
            jst, jm = jf(jst, {"tokens": jnp.asarray(tok),
                               "labels": jnp.asarray(tok)})
        state, m = step(state, {"tokens": torch.from_numpy(tok),
                                "labels": torch.from_numpy(tok)})
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k].full_tensor()),
                                       float(jm[k]), rtol=1e-5)
    want = {jax.tree_util.keystr(k): np.asarray(v) for k, v in
            jax.tree_util.tree_flatten_with_path(jst["params"])[0]}
    for path, t in leaves_with_paths(state["params"]):
        np.testing.assert_allclose(t.full_tensor().float().numpy(),
                                   want[path].astype(np.float32),
                                   rtol=1e-5, atol=1e-7, err_msg=path)


@pytest.mark.parametrize("heads,kv,model", [(48, 12, 16), (64, 8, 16),
                                            (48, 1, 16), (4, 2, 4)])
def test_local_kv_heads_follow_the_query_heads(heads, kv, model):
    """``attention._tp_kv`` with the query heads split over "model" and
    the K/V heads replicated: under the kernel's grouping of the local
    heads (query head i reads K/V head i // (local heads / local K/V
    heads)) every query head reads the K/V head the unsharded GQA gives
    it, h // (heads / kv): one a group where the local heads share them
    evenly (granite, command-r), else one a query head."""
    from types import SimpleNamespace

    from repro_torch.models.attention import _tp_kv
    cfg = SimpleNamespace(n_heads=heads, n_kv_heads=kv)
    hl = heads // model
    code = torch.arange(kv, dtype=torch.float32)[None, :, None]
    p = {"wq": torch.zeros(2, hl, 1), "wk": code.expand(2, kv, 1),
         "wv": code.expand(2, kv, 1)}
    for index in range(model):
        wk, wv = _tp_kv(p, cfg, SimpleNamespace(index=index))
        assert torch.equal(wk, wv) and hl % wk.shape[1] == 0
        got = [int(wk[0, i // (hl // wk.shape[1]), 0]) for i in range(hl)]
        assert got == [(index * hl + i) // (heads // kv)
                       for i in range(hl)], (index, got)
