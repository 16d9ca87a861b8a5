"""The port's sharding rules, meshes and ``jit_cell`` cells against the
JAX package, on the CPU.

The rules are pure logic over axis names and sizes: ``partition_spec``
must give the reference's spec, compared as tuples, on every spec of
every cell of the eleven full configs, under all five rule sets, on the
reference tests' ``FakeMesh`` shapes and small ones.  ``jit_cell``'s
cells run at world size 1 on an in-process gloo group (bit-equal to
``make_*_step``, and within ``test_make_train_step_matches_reference``'s
bounds of the reference's own ``jit_cell`` step on the same weights),
and at world sizes 2 and 4 as gloo processes (``_torch_spmd``) against
the unsharded step within rtol 1e-5.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

import _torch_spmd
from test_torch_train_loss import _fan_in_d_model
from repro.configs import get_config as jget_config
from repro.configs import get_reduced as jget_reduced
from repro.distributed import sharding as jsharding
from repro.launch import steps as jsteps
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models.params import is_spec as jis_spec
from repro.models.params import materialize as jmaterialize
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import ARCHS, get_config, get_reduced
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import sharding
from repro_torch.distributed.sharding import (TRAIN_RULES, PartitionSpec,
                                              partition_spec)
from repro_torch.kernels import ops
from repro_torch.launch import steps
from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
from repro_torch.launch.steps import (SHAPES, ShapeSpec, input_specs,
                                      jit_cell, rules_for, shape_applicable)
from repro_torch.models import RunFlags, materialize
from repro_torch.models.params import abstract, leaves_with_paths, tree_map
from repro_torch.training.optimizer import AdamWConfig


class FakeMesh:
    """Just axis_names + shape, enough for partition_spec resolution."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESH = FakeMesh({"data": 16, "model": 16})
MESH3 = FakeMesh({"pod": 2, "data": 16, "model": 16})
MESHES = (MESH, MESH3, FakeMesh({"data": 2, "model": 2}),
          FakeMesh({"data": 4, "model": 1}),
          FakeMesh({"pod": 2, "data": 2, "model": 1}))
RULE_SETS = ("TRAIN_RULES", "SERVE_RULES", "LONG_SERVE_RULES",
             "SERVE_BIG_RULES", "LONG_SERVE_BIG_RULES")


@pytest.fixture
def gloo1():
    """A one-rank gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


# -- the reference's six logic cases (tests/test_sharding.py) ---------------

def test_divisibility_fallback():
    # 48 heads shard over model=16; 8 do not; 1 does not
    assert partition_spec(("embed", "heads", "hdim"), (6144, 48, 128),
                          TRAIN_RULES, MESH) == \
        PartitionSpec("data", "model", None)
    assert partition_spec(("embed", "heads", "hdim"), (512, 8, 64),
                          TRAIN_RULES, MESH) == \
        PartitionSpec("data", None, None)


def test_no_axis_reuse_within_tensor():
    # experts takes model; ffn then cannot reuse it
    ps = partition_spec(("experts", "embed", "ffn"), (160, 5120, 1536),
                        TRAIN_RULES, MESH)
    assert ps == PartitionSpec("model", "data", None)


def test_pod_axis_multipod_batch():
    ps = partition_spec(("batch", "seq"), (256, 4096), TRAIN_RULES, MESH3)
    assert ps == PartitionSpec(("pod", "data"), "model")
    # batch=1 long decode: falls through to replicated batch
    ps1 = partition_spec(("batch", "seq"), (1, 1), TRAIN_RULES, MESH3)
    assert ps1 == PartitionSpec(None, None)


def test_big_arch_serve_rules_shard_weights():
    big = get_config("deepseek-v2-236b")
    small = get_config("gemma3-1b")
    assert rules_for(SHAPES["decode_32k"], big)["embed"] == [("data",)]
    assert rules_for(SHAPES["decode_32k"], small)["embed"] == []


def test_skip_rules():
    assert not shape_applicable(get_config("command-r-35b"),
                                SHAPES["long_500k"])[0]
    assert shape_applicable(get_config("xlstm-125m"),
                            SHAPES["long_500k"])[0]
    assert shape_applicable(get_config("mixtral-8x22b"),
                            SHAPES["long_500k"])[0]


def test_input_specs_cover_all_cells():
    for arch in ARCHS:
        cfg = get_config(arch)
        for sname, shape in SHAPES.items():
            if not shape_applicable(cfg, shape)[0]:
                continue
            leaves = [s for _, s in leaves_with_paths(
                input_specs(cfg, shape))]
            assert leaves, (arch, sname)
            for leaf in leaves:
                assert all(d > 0 for d in leaf.shape), (arch, sname, leaf)


# -- parity with the reference on the full configs --------------------------

def test_rule_sets_are_the_reference_s():
    for name in RULE_SETS:
        assert getattr(sharding, name) == getattr(jsharding, name), name


def _jspecs(tree):
    return {jax.tree_util.keystr(p): s for p, s in
            jax.tree_util.tree_flatten_with_path(tree, is_leaf=jis_spec)[0]}


def _cells(arch):
    """(shape name, the port's input specs, the reference's) of every
    applicable cell of the full config."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sname, shape in SHAPES.items():
        if shape_applicable(cfg, shape)[0]:
            yield (sname, input_specs(cfg, shape),
                   jsteps.input_specs(jcfg, jsteps.SHAPES[sname]))


@pytest.mark.parametrize("arch", ARCHS)
def test_partition_spec_matches_reference(arch):
    """Every param, cache, batch and state spec of every cell, under all
    five rule sets, on five meshes: the same entries as the reference's
    ``PartitionSpec``."""
    n = 0
    for sname, specs, jspecs in _cells(arch):
        want = _jspecs(jspecs)
        for path, s in leaves_with_paths(specs):
            for mesh in MESHES:
                for name in RULE_SETS:
                    got = partition_spec(s.axes, s.shape,
                                         getattr(sharding, name), mesh)
                    ref = jsharding.partition_spec(
                        want[path].axes, want[path].shape,
                        getattr(jsharding, name), mesh)
                    assert tuple(got) == tuple(ref), (sname, path, name,
                                                      mesh.shape)
                    n += 1
    assert n > 1000


def _dtype_name(dt):
    return str(dt).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    """``shape_applicable``, ``rules_for`` and ``input_specs`` on every
    (arch, shape) cell: shape, dtype name, axes and init of every leaf."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sname, shape in SHAPES.items():
        jshape = jsteps.SHAPES[sname]
        assert shape == ShapeSpec(jshape.name, jshape.kind, jshape.seq_len,
                                  jshape.global_batch)
        assert shape_applicable(cfg, shape) == \
            jsteps.shape_applicable(jcfg, jshape)
        assert rules_for(shape, cfg) == jsteps.rules_for(jshape, jcfg)
    for sname, specs, jspecs in _cells(arch):
        want = _jspecs(jspecs)
        got = dict(leaves_with_paths(specs))
        assert sorted(got) == sorted(want), sname
        for path, s in got.items():
            w = want[path]
            assert (s.shape, _dtype_name(s.dtype), s.axes, s.init) == \
                (tuple(w.shape), jnp.dtype(w.dtype).name, tuple(w.axes),
                 w.init), (sname, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_abstract_inputs_match_reference(arch):
    """``abstract_inputs``: meta tensors (no storage) of the reference's
    ``ShapeDtypeStruct`` shapes and dtypes."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for sname, shape in SHAPES.items():
        if not shape_applicable(cfg, shape)[0]:
            continue
        got = steps.abstract_inputs(cfg, shape)
        want = jsteps.abstract_inputs(jcfg, jsteps.SHAPES[sname])
        for key in got:
            w = {jax.tree_util.keystr(p): a for p, a in
                 jax.tree_util.tree_flatten_with_path(want[key])[0]}
            for path, t in leaves_with_paths(got[key]):
                assert t.is_meta, (sname, key, path)
                assert (tuple(t.shape), _dtype_name(t.dtype)) == \
                    (tuple(w[path].shape), jnp.dtype(w[path].dtype).name)
    specs = input_specs(cfg, SHAPES["train_4k"])["state"]["params"]
    assert tree_map(lambda s: s.shape, specs) == tree_map(
        lambda t: tuple(t.shape), abstract(specs))


# -- DTensor placements, hints, meshes ---------------------------------------

def test_placements_follow_the_spec_and_the_mesh_order(gloo1):
    mesh = make_host_mesh(device_type="cpu")
    assert mesh.shape == {"data": 1, "model": 1}
    fake = sharding.Mesh.__new__(sharding.Mesh)
    fake.axis_names, fake.shape = ("pod", "data", "model"), {
        "pod": 2, "data": 2, "model": 2}
    assert sharding.placements(PartitionSpec(("pod", "data"), "model"),
                               fake) == (Shard(0), Shard(0), Shard(1))
    assert sharding.placements(PartitionSpec(None, None), fake) == \
        (Replicate(),) * 3
    with pytest.raises(ValueError, match="axis order"):
        sharding.placements(PartitionSpec(("data", "pod")), fake)
    # an ad-hoc tree: logical axes beside meta tensors
    tree = sharding.shardings_for_tree(
        {"h": ("batch", "seq", None)},
        {"h": torch.empty((256, 4096, 8), device="meta")}, TRAIN_RULES,
        MESH3)
    assert tree["h"].spec == PartitionSpec(("pod", "data"), "model", None)


def test_shard_hint_is_a_no_op_outside_its_context(gloo1):
    x = torch.randn(4, 8)
    assert sharding.shard_hint(x, ("batch", None)) is x
    d = DTensor.from_local(x, gloo1.device_mesh, [Replicate(), Replicate()])
    assert sharding.shard_hint(d, ("batch", None)) is d
    with sharding.activation_sharding(gloo1, TRAIN_RULES):
        assert sharding.shard_hint(x, ("batch", None)) is x
        h = sharding.shard_hint(d, ("batch", None))
        assert isinstance(h, DTensor) and torch.equal(h.full_tensor(), x)


def test_meshes_need_the_card_unless_asked_for_the_cpu(gloo1):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        make_host_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_production_mesh()


def test_production_meshes_on_a_fake_group():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    for multi_pod, shape in ((False, {"data": 16, "model": 16}),
                             (True, {"pod": 2, "data": 16, "model": 16})):
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)
        try:
            mesh = make_production_mesh(multi_pod=multi_pod,
                                        device_type="cpu")
            assert mesh.shape == shape and mesh.axis_names == tuple(shape)
            # the host mesh clamps to the world size, as the reference
            # clamps to its device count
            assert make_host_mesh(data=64, model=64,
                                  device_type="cpu").shape == \
                {"data": 64, "model": (512 if multi_pod else 256) // 64}
        finally:
            dist.destroy_process_group()


# -- jit_cell at world size 1 -------------------------------------------------

OPT = dict(warmup_steps=0, total_steps=10)
TINY = ShapeSpec("tiny_train", "train", 32, 2)


def _tokens(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_jit_cell_train_is_bit_equal_to_make_train_step(gloo1):
    cfg = get_reduced("granite-20b")
    flags = RunFlags(remat="full")
    step, args = jit_cell(cfg, TINY, gloo1, flags, AdamWConfig(**OPT))
    assert all(t.is_meta for a in args for _, t in leaves_with_paths(a))
    ref = steps.make_train_step(cfg, AdamWConfig(**OPT), flags)

    def state():
        return materialize(input_specs(cfg, TINY)["state"],
                           torch.Generator().manual_seed(0), "cpu")

    got, want = state(), state()
    for i in range(3):
        batch = {k: torch.from_numpy(_tokens(cfg, 2, 32, 10 + i))
                 for k in ("tokens", "labels")}
        got, gm = step(got, batch)
        want, wm = ref(want, batch)
        assert isinstance(gm["loss"], DTensor)
        for k in ("loss", "grad_norm"):
            assert torch.equal(gm[k].full_tensor(), wm[k]), (i, k)
    assert int(got["step"].full_tensor()) == 3
    for (path, g), (_, w) in zip(leaves_with_paths(got),
                                 leaves_with_paths(want)):
        assert isinstance(g, DTensor), path
        assert torch.equal(g.full_tensor(), w), path


def test_jit_cell_train_matches_reference_jit_cell(gloo1):
    """The reference's ``jit_cell`` train step (``tests/test_sharding.py``
    runs it here) and the port's on the same carried-over state: loss,
    grad norm and params within rtol 1e-5, atol 1e-7, over two steps
    (the first at learning rate 0, the schedule's).  The weights are at
    the d_model fan-in law, where granite's reference gradients
    reproduce (``test_torch_train_loss``)."""
    arch = "granite-20b"
    jcfg, cfg = jget_reduced(arch), get_reduced(arch)
    jshape = jsteps.ShapeSpec("tiny_train", "train", 32, 2)
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
    step, _ = jit_cell(cfg, TINY, gloo1, RunFlags(remat="full"),
                       AdamWConfig(**OPT))
    jst = jax.tree_util.tree_map(jnp.asarray, jstate)
    for i in range(2):
        tok = _tokens(cfg, 2, 32, 20 + i)
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


def test_jit_cell_serving_cells_equal_make_steps(gloo1):
    """The prefill and decode cells (SERVE rules) bit-equal to
    ``make_prefill_step`` / ``make_decode_step``, the caches written
    into the inputs (donated)."""
    cfg = get_reduced("granite-20b")
    pre = ShapeSpec("tiny_prefill", "prefill", 16, 2)
    dec = ShapeSpec("tiny_decode", "decode", 32, 2)
    params = materialize(input_specs(cfg, pre)["params"],
                         torch.Generator().manual_seed(0), "cpu")
    batch = {"tokens": torch.from_numpy(_tokens(cfg, 2, 16, 1))}
    caches = materialize(input_specs(cfg, pre)["caches"],
                         torch.Generator().manual_seed(1), "cpu")
    want, want_c = steps.make_prefill_step(cfg)(
        params, batch, tree_map(torch.clone, caches))
    step, _ = jit_cell(cfg, pre, gloo1)
    got, got_c = step(params, batch, caches)
    assert torch.equal(got.full_tensor(), want)
    for (path, g), (_, w), (_, c) in zip(leaves_with_paths(got_c),
                                         leaves_with_paths(want_c),
                                         leaves_with_paths(caches)):
        assert torch.equal(g.full_tensor(), w), path
        assert torch.equal(c, w), path          # donated: written in place
    caches = materialize(input_specs(cfg, dec)["caches"],
                         torch.Generator().manual_seed(2), "cpu")
    tok = torch.from_numpy(_tokens(cfg, 2, 1, 3))
    want, _ = steps.make_decode_step(cfg)(params, tok,
                                          tree_map(torch.clone, caches), 20)
    step, args = jit_cell(cfg, dec, gloo1)
    assert [tuple(a.shape) for a in args[1:2]] == [(2, 1)]
    got, _ = step(params, tok, caches, torch.tensor(20, dtype=torch.int32))
    assert torch.equal(got.full_tensor(), want)


def test_a_dtensor_never_reaches_a_kernel_wrapper(gloo1):
    q = torch.randn(1, 2, 8, 16)
    d = DTensor.from_local(q, gloo1.device_mesh, [Replicate(), Replicate()])
    for call in (lambda: ops.flash_attention(d, d, d),
                 lambda: ops.decode_attention(d[:, :, 0], d, d,
                                              torch.tensor([8])),
                 lambda: ops.rglru_scan(d[0], d[0], d[0, :, 0])):
        with pytest.raises(TypeError, match="DTensor"):
            call()


# -- sharded steps at world sizes 2 and 4 (gloo processes) -------------------

@pytest.mark.parametrize("world", [2, 4])
def test_sharded_steps_match_the_unsharded_step(world, tmp_path):
    """Meshes {data: 2, model: 1} and {data: 2, model: 2}: the train cells
    of reduced granite-20b and mixtral-8x22b (loss, grad norm, params and
    moments after two steps within rtol 1e-5 of the unsharded step; each
    rank's local shard the block its spec assigns; Mixtral's loss missing
    without the router's global statistics), the serving cells, and a
    DTensor refused by ``ops``."""
    _torch_spmd.spawn("sharded_steps", world, tmp_path, timeout=240)


@pytest.fixture(scope="module")
def reblocked(tmp_path_factory):
    """world -> each rank's outcome a ``_torch_spmd.REBLOCK_CASES`` case,
    the job run once a world."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"reblock_{world}")
            _torch_spmd.spawn("reblock", world, tmp, timeout=120)
            done[world] = [json.loads((tmp / f"reblock.{r}.json")
                                      .read_text()) for r in range(world)]
        return done[world]
    return get


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("case", _torch_spmd.REBLOCK_CASES)
def test_reblock_moves_each_row_to_its_rank(reblocked, world, case):
    """``ModelShards.reblock`` at world sizes 2 and 4 (gloo processes):
    a VLM's [prefix block; token block] to its residual's blocks and the
    residual's token rows back to the tokens' blocks, random uneven runs
    (a rank's rows in up to three), and ranks that hold no row: each
    rank's result exactly the rows its destination block names, its
    gradient exactly the rows of the upstream gradient its source block
    names, by one all-to-all each way
    (``_torch_spmd._reblock_case``)."""
    for rank, res in enumerate(reblocked(world)):
        assert res[case] == "ok", (rank, res[case])
