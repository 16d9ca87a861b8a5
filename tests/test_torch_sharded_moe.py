"""The sharded bodies of a decoder of attention + routed MoE FFN blocks
(``launch/steps.jit_cell``'s ``"sharded"`` layout for mixtral-8x22b's
train, prefill and decode cells) on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_moe``,
the two spawns run side by side) every (mesh, config, case) of
``_torch_spmd.MESHES`` x ``MOE`` x ``MOE_TRAIN`` / ``MOE_SERVE`` is held
against the unsharded ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on the same inputs.  ``MOE`` is reduced Mixtral,
whose 4 experts split over "model" at 2 and 4 ranks (expert
parallelism), and a 3-expert variant, whose experts do not divide
"model", so each expert's ffn is split instead.  Train: loss and grad
norm of two steps, every param and moment within rtol 1e-5, each rank's
state exactly its blocks; with two microbatches, with the dense
dispatch, with dispatch groups of 16 tokens at S = 32 (spanning two
ranks' sequence blocks at model 4), and with a capacity factor at which
tokens drop.  Serving: prefill, and
decode in the first block, at the last row of a block and in the last
block, under SERVE_RULES and under SERVE_BIG_RULES (substituted for
``rules_for``'s choice: the reduced weights would replicate), the
logits and float32 caches within rtol 1e-5, bf16 caches by
``_torch_spmd.bf16_close``; rank 0's whole logits and caches are also
held against the JAX package's ``prefill`` / ``decode_step``, and rank
0's losses, grad norms, params and moments of each train case against
the JAX package's ``jit_cell`` on a (1, 1) mesh.  The
planted faults of ``_torch_spmd.MOE_FAULTS`` (each sequence block
routed on its own, the aux loss counted once a model rank, the experts'
partial sums left unreduced) must miss the same bounds.  The weights are
at the d_model fan-in law (``_torch_spmd.fan_in_d_model``).

Without processes: ``steps.layout`` of Mixtral's production cells, the
routes ``partition_spec`` picks for the experts on the test and
production meshes, rank 0's blocks of ``decode_32k`` at full width
against the analytic floor, and both configs' train cells at world size
1 against the reference's own ``jit_cell``.
"""
import concurrent.futures
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_spmd
from _torch_spmd import (MESHES, MOE, MOE_FAULTS, MOE_SERVE, MOE_TRAIN,
                         THREE_EXPERTS, bf16_close, serve_positions)
from test_torch_train_loss import _fan_in_d_model
from repro.configs import get_reduced as jget_reduced
from repro.launch import steps as jsteps
from repro.models import RunFlags as JRunFlags
from repro.models import build_param_specs as jbuild_param_specs
from repro.models import decode_step as jdecode_step
from repro.models import prefill as jprefill
from repro.models.params import materialize as jmaterialize
from repro.training.optimizer import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import (SERVE_BIG_RULES, TRAIN_RULES,
                                              entry_axes, partition_spec)
from repro_torch.launch import steps
from repro_torch.launch.analytic import analytic_bytes_per_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.launch.steps import (SHAPES, ShapeSpec, input_shardings,
                                      input_specs, jit_cell)
from repro_torch.models import RunFlags
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.training.optimizer import AdamWConfig

MESH_LIST = [(world, data, model) for world in sorted(MESHES)
             for data, model in MESHES[world]]
CASES = [(w, d, m, arch, case) for w, d, m in MESH_LIST for arch in MOE
         for case in MOE_TRAIN + MOE_SERVE]
FAULTS = [(w, d, m, arch, fault) for w, d, m in MESH_LIST if m > 1
          for arch in MOE for fault in MOE_FAULTS]
SERVED = [c for c in CASES if c[-1] in MOE_SERVE]
TRAINED = [c for c in CASES if c[-1] in MOE_TRAIN]


def _ids(cases):
    return [f"{d}x{m}-{a}-{c}" for _, d, m, a, c in cases]


class FakeMesh:
    """Just axis_names + shape, enough for partition_spec resolution."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)
        self.size = math.prod(self.shape.values())


SINGLE = FakeMesh({"data": 16, "model": 16})
MULTI = FakeMesh({"pod": 2, "data": 16, "model": 16})


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (the job's folder, each rank's outcome a case): both
    worlds' jobs started together, once, and the JAX package's train
    references computed while they run."""
    tmp = {w: tmp_path_factory.mktemp(f"sharded_moe_{w}") for w in MESHES}
    with concurrent.futures.ThreadPoolExecutor(len(tmp)) as pool:
        jobs = [pool.submit(_torch_spmd.spawn, "sharded_moe", w, t,
                            timeout=300) for w, t in tmp.items()]
        # the JAX package's train steps meanwhile (cached for the tests)
        for arch in MOE:
            for variant in MOE_TRAIN:
                _reference_train(arch, variant)
        for f in jobs:
            f.result()
    return {w: (t, [json.loads((t / f"sharded_moe.{r}.json").read_text())
                    for r in range(w)]) for w, t in tmp.items()}


@pytest.mark.parametrize("world,data,model,arch,case", CASES,
                         ids=_ids(CASES))
def test_sharded_moe_matches_the_unsharded_steps(runs, world, data, model,
                                                 arch, case):
    name = f"{data}x{model}-{arch}-{case}"
    for rank, res in enumerate(runs[world][1]):
        assert res[name] == "ok", (rank, res[name])


@pytest.mark.parametrize("world,data,model,arch,fault", FAULTS,
                         ids=_ids(FAULTS))
def test_planted_moe_faults_miss(runs, world, data, model, arch, fault):
    """Each planted fault's step lands farther than 10 x rtol 1e-5 from
    the unsharded step (``_torch_spmd._moe_fault_case``)."""
    name = f"{data}x{model}-{arch}-{fault}"
    for rank, res in enumerate(runs[world][1]):
        assert res[name] == "ok", (rank, res[name])


def _jreduced(name):
    """The JAX package's config of ``_torch_spmd.reduced(name)``."""
    if name != THREE_EXPERTS:
        return jget_reduced(name)
    cfg = jget_reduced("mixtral-8x22b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=3))


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype])


@functools.lru_cache(maxsize=None)
def _reference_serving(arch, prefill, bf16, pos):
    """The JAX package's ``prefill`` / ``decode_step`` on a case's inputs
    (``_torch_spmd.serve_inputs``): the logits and {path: cache leaf},
    float32 numpy."""
    _, _, params, first, caches, _ = _torch_spmd.serve_inputs(
        arch, prefill, torch.bfloat16 if bf16 else torch.float32, pos)
    jcfg = _jreduced(arch)
    jp, jc = tree_map(_jnp, params), tree_map(_jnp, caches)
    if prefill:
        logits, out = jprefill(jp, {"tokens": jnp.asarray(
            first["tokens"].numpy())}, jc, jcfg, JRunFlags())
    else:
        logits, out = jdecode_step(jp, jnp.asarray(first.numpy()), jc, pos,
                                   jcfg, JRunFlags())
    return np.asarray(logits, np.float32), {
        jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
        for k, v in jax.tree_util.tree_flatten_with_path(out)[0]}


OPT = dict(warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def _reference_train(arch, variant):
    """The JAX package's ``jit_cell`` train step on a (1, 1) mesh with a
    MOE_TRAIN variant's config and flags (``_torch_spmd.moe_train_cfg``),
    two steps from the port's ``_torch_spmd.train_state`` on
    ``_torch_spmd._batch(cfg, 4, 32, 10 + i)``, as the gloo job runs
    them: the losses and grad norms, and {path: leaf} of the params and
    moments, float32 numpy."""
    cfg, flags = _torch_spmd.moe_train_cfg(arch, variant)
    jcfg = _jreduced(arch)
    jcfg = dataclasses.replace(jcfg, moe=dataclasses.replace(
        jcfg.moe, capacity_factor=cfg.moe.capacity_factor))
    jflags = JRunFlags(remat=flags.remat, grad_accum=flags.grad_accum,
                       moe_impl=flags.moe_impl, moe_group=flags.moe_group)
    jshape = jsteps.ShapeSpec("tiny_train", "train", 32, 4)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jf, _ = jsteps.jit_cell(jcfg, jshape, jmesh, flags=jflags,
                            opt=JAdamWConfig(**OPT))
    jst = tree_map(lambda t: jnp.asarray(t.numpy()),
                   _torch_spmd.train_state(cfg))
    out = {"loss": [], "grad_norm": []}
    for i in range(2):
        batch = _torch_spmd._batch(cfg, 4, 32, 10 + i)
        with jmesh:
            jst, jm = jf(jst, {k: jnp.asarray(v.numpy())
                               for k, v in batch.items()})
        for k in ("loss", "grad_norm"):
            out[k].append(float(jm[k]))
    for key in ("params", "mu", "nu"):
        out[key] = {jax.tree_util.keystr(k): np.asarray(v, np.float32)
                    for k, v in
                    jax.tree_util.tree_flatten_with_path(jst[key])[0]}
    return out


@pytest.mark.parametrize("world,data,model,arch,case", TRAINED,
                         ids=_ids(TRAINED))
def test_sharded_moe_train_matches_the_jax_reference(runs, world, data,
                                                     model, arch, case):
    """Each gloo train case's two steps (rank 0's losses, grad norms and
    whole params and moments, saved by the job) against the JAX
    package's ``jit_cell`` on a (1, 1) mesh from the same state on the
    same batches: each within rtol 1e-5 of its max.  The unsharded
    port step is the job's own witness."""
    name = f"{data}x{model}-{arch}-{case}"
    tmp, res = runs[world]
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"train.{name}.pt")
    want = _reference_train(arch, case)
    for k in ("loss", "grad_norm"):
        for i, (g, w) in enumerate(zip(got[k], want[k], strict=True)):
            _torch_spmd._close(torch.tensor(g), torch.tensor(w),
                               f"{name} step {i} {k}")
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key]), (name, key)
        for path, g in got[key].items():
            _torch_spmd._close(g, torch.from_numpy(want[key][path].copy()),
                               f"{name} {key}{path}")


@pytest.mark.parametrize("world,data,model,arch,case", SERVED,
                         ids=_ids(SERVED))
def test_sharded_moe_serving_matches_the_jax_reference(runs, world, data,
                                                       model, arch, case):
    """Each gloo serving case's whole logits and caches (rank 0's, saved
    by the job) against the JAX package's ``prefill`` / ``decode_step``
    on the same weights, tokens and caches: the logits and float32
    caches within rtol 1e-5 of each leaf's max, bf16 caches by
    ``bf16_close`` against the unsharded port's float32 K/V."""
    name = f"{data}x{model}-{arch}-{case}"
    tmp, res = runs[world]
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"serve.{name}.pt")
    kind = case.split("-", 1)[1]
    prefill = kind.startswith("prefill")
    pos = None if prefill else serve_positions(model)[kind]
    jlog, jcaches = _reference_serving(arch, prefill, kind.endswith("bf16"),
                                       pos)
    _torch_spmd._close(got["logits"], torch.from_numpy(jlog.copy()),
                       f"{name} logits")
    assert set(got["caches"]) == set(jcaches), name
    for path, g in got["caches"].items():
        w = torch.from_numpy(jcaches[path].copy())
        if got["wide"] is None:
            _torch_spmd._close(g, w, f"{name} cache{path}")
        else:
            bf16_close(g, w.bfloat16(), got["wide"][path],
                       f"{name} cache{path}")


def test_layout_of_the_moe_cells():
    """mixtral-8x22b's train_4k, prefill_32k and decode_32k cells are
    sharded on both production meshes (serving under SERVE_BIG_RULES:
    its 140.6e9 weights do not replicate over "data"), its long_500k
    and int8-cache cells gathered; both reduced configs' cells are
    sharded on every test mesh, under either serving rule set; a decoder
    with shared experts stays gathered."""
    cfg = get_config("mixtral-8x22b")
    int8 = RunFlags(cache_dtype="int8")
    for mesh in (SINGLE, MULTI):
        for sname, shape in SHAPES.items():
            want = "gathered" if sname == "long_500k" else "sharded"
            assert steps.layout(cfg, shape, mesh) == want, sname
            if shape.kind != "train":
                assert steps.layout(cfg, shape, mesh, int8) == "gathered"
    assert steps.rules_for(SHAPES["decode_32k"], cfg) is SERVE_BIG_RULES
    for arch in MOE:
        small = _torch_spmd.reduced(arch)
        for _, data, model in MESH_LIST:
            mesh = FakeMesh({"data": data, "model": model})
            for shape in (ShapeSpec("t", "train", 32, 4),
                          ShapeSpec("p", "prefill", 16, 4),
                          ShapeSpec("d", "decode", 32, 4)):
                assert steps.layout(small, shape, mesh) == "sharded"
                with _torch_spmd.serve_big_rules():
                    assert steps.layout(small, shape, mesh) == "sharded"
    shared = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_shared_experts=1))
    assert steps.layout(shared, SHAPES["train_4k"], SINGLE) == "gathered"


@pytest.mark.parametrize("arch,data,model,route", [
    ("mixtral-8x22b", 1, 4, "experts"), ("mixtral-8x22b", 2, 2, "experts"),
    (THREE_EXPERTS, 1, 4, "ffn"), (THREE_EXPERTS, 2, 2, "ffn")])
def test_the_expert_route_follows_the_rules(arch, data, model, route):
    """Which dim of the experts' weights "model" splits, under
    TRAIN_RULES and SERVE_BIG_RULES: the experts where they divide the
    axis (the router's expert dim with them), else each expert's ffn
    (the router replicated over "model")."""
    cfg = _torch_spmd.reduced(arch)
    mesh = FakeMesh({"data": data, "model": model})
    m = cfg.moe
    emb = "data" if data > 1 else None
    for rules in (TRAIN_RULES, SERVE_BIG_RULES):
        wi = partition_spec(("experts", "embed", "ffn"),
                            (m.n_experts, cfg.d_model, m.d_ff_expert),
                            rules, mesh)
        router = partition_spec(("embed", "experts"),
                                (cfg.d_model, m.n_experts), rules, mesh)
        if route == "experts":
            assert tuple(wi) == ("model", emb, None)
            assert tuple(router) == (emb, "model")
        else:
            assert tuple(wi) == (None, emb, "model")
            assert tuple(router) == (emb, None)


def _local(spec, sh, mesh):
    shape = list(spec.shape)
    for dim, entry in enumerate(sh.spec):
        for a in entry_axes(entry):
            shape[dim] //= mesh.shape[a]
    return tuple(shape)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_full_width_blocks(shape_name):
    """Rank 0's blocks of mixtral-8x22b at full width on (16, 16): each
    expert's ffn split over "model" (8 experts do not divide 16) and
    "embed" over "data" in training and, under SERVE_BIG_RULES, in
    serving; 3 of the 48 query heads; the router's experts whole.  At
    decode_32k the rank's bytes of the weights and the cache are the
    analytic floor's."""
    cfg, shape = get_config("mixtral-8x22b"), SHAPES[shape_name]
    specs, sh = input_specs(cfg, shape), input_shardings(cfg, shape, SINGLE)
    key = "state" if shape.kind == "train" else "params"
    params = specs[key]["params"] if key == "state" else specs[key]
    shards = sh[key]["params"] if key == "state" else sh[key]
    local = {p: _local(s, h, SINGLE) for (p, s), (_, h) in zip(
        leaves_with_paths(params), leaves_with_paths(shards))}
    ffn = "['groups']['main']['pos0']['ffn']"
    attn = "['groups']['main']['pos0']['attn']"
    assert local[ffn + "['wi_gate']"] == (56, 8, 384, 1024)
    assert local[ffn + "['wo']"] == (56, 8, 1024, 384)
    assert local[ffn + "['router']"] == (56, 384, 8)
    assert local[attn + "['wq']"] == (56, 384, 3, 128)
    assert local["['embed']['table']"] == (2048, 384)
    if shape.kind == "train":
        return
    floor = analytic_bytes_per_device(cfg, shape, SINGLE)
    for name in ("params", "caches"):
        total = sum(math.prod(_local(s, h, SINGLE)) * s.dtype.itemsize
                    for (_, s), (_, h) in zip(leaves_with_paths(specs[name]),
                                              leaves_with_paths(sh[name])))
        assert total == floor["params" if name == "params" else "cache"]


@pytest.fixture
def gloo1():
    """A one-rank gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", MOE)
def test_sharded_moe_train_matches_reference_jit_cell(arch, gloo1):
    """The reference's ``jit_cell`` train step and the port's sharded
    one at world size 1 on the same carried-over state at the d_model
    fan-in law: loss and grad norm within rtol 1e-5, params within rtol
    1e-5, atol 1e-7, over two steps (the first at learning rate 0)."""
    jcfg, cfg = _jreduced(arch), _torch_spmd.reduced(arch)
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
    rng = np.random.default_rng(21)
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
