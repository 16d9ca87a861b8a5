"""The sharded bodies of a decoder of MLA + MoE FFN blocks with shared
experts, or of MLA + dense FFN blocks whose heads replicate over "model"
(``launch/steps.jit_cell``'s ``"sharded"`` layout for deepseek-v2-236b's
and minicpm3-4b's train, prefill and decode cells) on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_mla``,
the two spawns run side by side) every (mesh, config, case) of
``_torch_spmd.MESHES`` x ``MLA`` x ``mla_cases`` is held against the
unsharded ``make_train_step`` / ``make_prefill_step`` /
``make_decode_step`` on the same inputs.  ``MLA`` is reduced
deepseek-v2 (4 MLA heads, 8 routed experts and 1 shared expert, all
split over "model" at 2 and 4 ranks), a 3-expert variant, whose
routed experts do not divide "model", so each expert's ffn is split and
its partial sums add to the shared expert's before the collective, and
``MINICPM3``, reduced minicpm3-4b with 3 heads and 257 vocab rows, which
no test mesh's "model" axis splits, as 16 does not split the full
width's 40 and 73,448 (every rank runs all heads, the train queries on
its own rows against the gathered latents; its serving cases under
SERVE_RULES alone, its faults but "shared-unreduced").
Train: loss and grad norm of two steps, every param and moment within
rtol 1e-5, each rank's state exactly its blocks, with MLA's query
chunk above S (whole) and at 8 (4 chunks).  Serving: prefill (whole,
chunked by 8, and into a bf16 cache), and decode in the first block, at
the last row of a block and in the last block, under SERVE_RULES and
under SERVE_BIG_RULES (deepseek-v2-236b's; substituted for
``rules_for``'s choice, since the reduced weights would replicate): the
logits and float32 caches within rtol 1e-5, bf16 caches by
``_torch_spmd.bf16_close``; a decode into a bf16 cache, whose merged
path keeps the softmax weights float32 where the unsharded step (as the
JAX package) rounds them to bf16, within rtol 1e-5 plus twice the
distance that rounding alone puts between the unsharded step and its
witness (``_torch_spmd.weights_close``); and a decode step's caches
written in place, each rank holding its blocks and making no tensor of
the latent cache's whole length.  Rank 0's whole logits and caches are
also held against the JAX package's ``prefill`` / ``decode_step``, and
its losses, grad
norms, params and moments of each train case against the JAX package's
``jit_cell`` on a (1, 1) mesh.  The planted faults of
``_torch_spmd.MLA_FAULTS`` (a block past the write frontier merged as a
uniform average of its rows, the shared experts' partial sums left
unreduced, the latent cache held whole on every model rank; on a bf16
cache the first and the blocks' contexts averaged) must miss the same
bounds.  The weights are at the d_model fan-in law
(``_torch_spmd.fan_in_d_model``).

Without processes: ``steps.layout`` of deepseek-v2-236b's and
minicpm3-4b's production cells, rank 0's blocks of both at full width
against the analytic floor, reduced deepseek-v2's train cell at world
size 1 against the reference's own ``jit_cell``, and ``MINICPM3``'s
sharded train step traced on a fake group of 4 against the planted
queries on every row (``chip_smoke._mla_every_row``).
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
import chip_smoke
from _torch_spmd import (MESHES, MINICPM3, MLA, MLA_SERVE, MLA_THREE_EXPERTS,
                         MLA_TRAIN, bf16_close, mla_cases, serve_positions)
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
from repro_torch.distributed.sharding import (SERVE_BIG_RULES, SERVE_RULES,
                                              entry_axes)
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
CASES = [(w, d, m, arch, case) for w, d, m in MESH_LIST for arch in MLA
         for case in mla_cases(arch)[0]]
FAULTS = [(w, d, m, arch, fault) for w, d, m in MESH_LIST if m > 1
          for arch in MLA for fault in mla_cases(arch)[1]]
SERVED = [c for c in CASES if c[-1] in MLA_SERVE
          and not c[-1].endswith("memory")]
TRAINED = [c for c in CASES if c[-1] in MLA_TRAIN]


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
    tmp = {w: tmp_path_factory.mktemp(f"sharded_mla_{w}") for w in MESHES}
    with concurrent.futures.ThreadPoolExecutor(len(tmp)) as pool:
        jobs = [pool.submit(_torch_spmd.spawn, "sharded_mla", w, t,
                            timeout=300) for w, t in tmp.items()]
        # the JAX package's train steps meanwhile (cached for the tests)
        for arch in MLA:
            for variant in MLA_TRAIN:
                _reference_train(arch, variant)
        for f in jobs:
            f.result()
    return {w: (t, [json.loads((t / f"sharded_mla.{r}.json").read_text())
                    for r in range(w)]) for w, t in tmp.items()}


@pytest.mark.parametrize("world,data,model,arch,case", CASES,
                         ids=_ids(CASES))
def test_sharded_mla_matches_the_unsharded_steps(runs, world, data, model,
                                                 arch, case):
    name = f"{data}x{model}-{arch}-{case}"
    for rank, res in enumerate(runs[world][1]):
        assert res[name] == "ok", (rank, res[name])


@pytest.mark.parametrize("world,data,model,arch,fault", FAULTS,
                         ids=_ids(FAULTS))
def test_planted_mla_faults_miss(runs, world, data, model, arch, fault):
    """Each planted fault's step lands farther than 10 x rtol 1e-5 from
    the unsharded step, or fails the blocks check
    (``_torch_spmd._mla_fault_case``)."""
    name = f"{data}x{model}-{arch}-{fault}"
    for rank, res in enumerate(runs[world][1]):
        assert res[name] == "ok", (rank, res[name])


def _jreduced(name):
    """The JAX package's config of ``_torch_spmd.reduced(name)``."""
    if name == MINICPM3:
        return _torch_spmd.minicpm3_variant(jget_reduced("minicpm3-4b"))
    if name != MLA_THREE_EXPERTS:
        return jget_reduced(name)
    cfg = jget_reduced("deepseek-v2-236b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=3))


def _jflags(flags):
    return JRunFlags(remat=flags.remat, attn_chunk=flags.attn_chunk)


_JNP = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def _jnp(t):
    return jnp.asarray(t.float().numpy()).astype(_JNP[t.dtype])


@functools.lru_cache(maxsize=None)
def _reference_serving(arch, kind, pos):
    """The JAX package's ``prefill`` / ``decode_step`` on a case's inputs
    (``_torch_spmd.serve_inputs``, the case's query chunk): the logits
    and {path: cache leaf}, float32 numpy."""
    prefill = kind.startswith("prefill")
    _, _, params, first, caches, _ = _torch_spmd.serve_inputs(
        arch, prefill, torch.bfloat16 if kind.endswith("bf16")
        else torch.float32, pos)
    jcfg, jflags = _jreduced(arch), _jflags(_torch_spmd.mla_flags(kind))
    jp, jc = tree_map(_jnp, params), tree_map(_jnp, caches)
    if prefill:
        logits, out = jprefill(jp, {"tokens": jnp.asarray(
            first["tokens"].numpy())}, jc, jcfg, jflags)
    else:
        logits, out = jdecode_step(jp, jnp.asarray(first.numpy()), jc, pos,
                                   jcfg, jflags)
    return np.asarray(logits, np.float32), {
        jax.tree_util.keystr(k): np.asarray(v.astype(jnp.float32))
        for k, v in jax.tree_util.tree_flatten_with_path(out)[0]}


OPT = dict(warmup_steps=0, total_steps=10)


@functools.lru_cache(maxsize=None)
def _reference_train(arch, variant):
    """The JAX package's ``jit_cell`` train step on a (1, 1) mesh with an
    MLA_TRAIN variant's config and flags, two steps from the port's
    ``_torch_spmd.train_state`` on ``_torch_spmd._batch(cfg, 4, 32, 10 +
    i)``, as the gloo job runs them: the losses and grad norms, and
    {path: leaf} of the params and moments, float32 numpy."""
    cfg = _torch_spmd.reduced(arch)
    jshape = jsteps.ShapeSpec("tiny_train", "train", 32, 4)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jf, _ = jsteps.jit_cell(_jreduced(arch), jshape, jmesh,
                            flags=_jflags(_torch_spmd.mla_flags(variant)),
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
def test_sharded_mla_train_matches_the_jax_reference(runs, world, data,
                                                     model, arch, case):
    """Each gloo train case's two steps (rank 0's losses, grad norms and
    whole params and moments, saved by the job) against the JAX
    package's ``jit_cell`` on a (1, 1) mesh from the same state on the
    same batches at the same query chunk: each within rtol 1e-5 of its
    max.  The unsharded port step is the job's own witness."""
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
def test_sharded_mla_serving_matches_the_jax_reference(runs, world, data,
                                                       model, arch, case):
    """Each gloo serving case's whole logits and caches (rank 0's, saved
    by the job) against the JAX package's ``prefill`` / ``decode_step``
    on the same weights, tokens and caches at the same query chunk: the
    logits and float32 caches within rtol 1e-5 of each leaf's max, bf16
    caches by ``bf16_close`` against the unsharded port's float32
    latents; a decode on a bf16 cache, logits and caches within the
    weights' band (``_torch_spmd.weights_close``)."""
    name = f"{data}x{model}-{arch}-{case}"
    tmp, res = runs[world]
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"serve.{name}.pt")
    kind = case.split("-", 1)[1]
    pos = None if kind.startswith("prefill") else \
        serve_positions(model)[kind]
    jlog, jcaches = _reference_serving(arch, kind, pos)
    band = got["band"]
    if band is not None:
        _torch_spmd.weights_close(got["logits"], torch.from_numpy(
            jlog.copy()), band["logits"], f"{name} logits")
    else:
        _torch_spmd._close(got["logits"], torch.from_numpy(jlog.copy()),
                           f"{name} logits")
    assert set(got["caches"]) == set(jcaches), name
    for path, g in got["caches"].items():
        w = torch.from_numpy(jcaches[path].copy())
        if band is not None:
            _torch_spmd.weights_close(g, w, band[path], f"{name} cache{path}")
        elif got["wide"] is None:
            _torch_spmd._close(g, w, f"{name} cache{path}")
        else:
            bf16_close(g, w.bfloat16(), got["wide"][path],
                       f"{name} cache{path}")


def test_layout_of_the_mla_cells():
    """deepseek-v2-236b's and minicpm3-4b's train_4k, prefill_32k and
    decode_32k cells are sharded on both production meshes (deepseek's
    128 MLA heads divide 16, its serving under SERVE_BIG_RULES;
    minicpm3-4b's 40 replicate over "model", its serving under
    SERVE_RULES), their long_500k cells (which the matrix skips) and
    int8-cache cells gathered; the reduced configs' cells are sharded
    on every test mesh and on a "model" axis of 3, under either serving
    rule set, whether their heads divide "model" (reduced minicpm3-4b's
    own 4 on 2 and 4) or replicate (the ``MINICPM3`` variant's 3)."""
    big, mini = get_config("deepseek-v2-236b"), get_config("minicpm3-4b")
    int8 = RunFlags(cache_dtype="int8")
    for mesh in (SINGLE, MULTI):
        for sname, shape in SHAPES.items():
            want = "gathered" if sname == "long_500k" else "sharded"
            for cfg in (big, mini):
                assert steps.layout(cfg, shape, mesh) == want, (cfg.name,
                                                                sname)
                if shape.kind != "train":
                    assert steps.layout(cfg, shape, mesh, int8) == \
                        "gathered"
    for sname in ("prefill_32k", "decode_32k"):
        assert steps.rules_for(SHAPES[sname], big) is SERVE_BIG_RULES
        assert steps.rules_for(SHAPES[sname], mini) is SERVE_RULES
    for arch in MLA + ("minicpm3-4b",):
        small = _torch_spmd.reduced(arch)
        for _, data, model in MESH_LIST + [(0, 1, 3)]:
            mesh = FakeMesh({"data": data, "model": model})
            for shape in (ShapeSpec("t", "train", 24, 4),
                          ShapeSpec("p", "prefill", 24, 4),
                          ShapeSpec("d", "decode", 24, 4)):
                assert steps.layout(small, shape, mesh) == "sharded"
                with _torch_spmd.serve_big_rules():
                    assert steps.layout(small, shape, mesh) == "sharded"


def _local(spec, sh, mesh):
    shape = list(spec.shape)
    for dim, entry in enumerate(sh.spec):
        for a in entry_axes(entry):
            shape[dim] //= mesh.shape[a]
    return tuple(shape)


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_full_width_blocks(shape_name):
    """Rank 0's blocks of deepseek-v2-236b at full width on (16, 16): 8
    of the 128 MLA heads, the "lora" weights whole but for "embed" over
    "data", 10 of the 160 routed experts and the router's expert dim with
    them, the shared experts' ffn split over "model", in training and,
    under SERVE_BIG_RULES, in serving; at decode_32k 8 rows and 2,048 of
    the latent cache's 32,768 rows, and the rank's bytes of the weights
    and the cache the analytic floor's."""
    cfg, shape = get_config("deepseek-v2-236b"), SHAPES[shape_name]
    specs, sh = input_specs(cfg, shape), input_shardings(cfg, shape, SINGLE)
    key = "state" if shape.kind == "train" else "params"
    params = specs[key]["params"] if key == "state" else specs[key]
    shards = sh[key]["params"] if key == "state" else sh[key]
    local = {p: _local(s, h, SINGLE) for (p, s), (_, h) in zip(
        leaves_with_paths(params), leaves_with_paths(shards))}
    ffn = "['groups']['main']['pos0']['ffn']"
    attn = "['groups']['main']['pos0']['attn']"
    assert local[attn + "['wq_a']"] == (60, 320, 1536)
    assert local[attn + "['q_norm']"] == (60, 1536)
    assert local[attn + "['wq_b']"] == (60, 1536, 8, 192)
    assert local[attn + "['wkv_a']"] == (60, 320, 576)
    assert local[attn + "['wk_b']"] == (60, 512, 8, 128)
    assert local[attn + "['wv_b']"] == (60, 512, 8, 128)
    assert local[attn + "['wo']"] == (60, 8, 128, 320)
    assert local[ffn + "['router']"] == (60, 320, 10)
    assert local[ffn + "['wi_gate']"] == (60, 10, 320, 1536)
    assert local[ffn + "['wo']"] == (60, 10, 1536, 320)
    assert local[ffn + "['shared']['wi_gate']"] == (60, 320, 192)
    assert local[ffn + "['shared']['wo']"] == (60, 192, 320)
    if shape.kind == "train":
        return
    caches = {p: _local(s, h, SINGLE) for (p, s), (_, h) in zip(
        leaves_with_paths(specs["caches"]), leaves_with_paths(sh["caches"]))}
    cache = "['main']['pos0']['attn']"
    assert caches[cache + "['c_kv']"] == (60, 8, 2048, 512)
    assert caches[cache + "['k_rope']"] == (60, 8, 2048, 64)
    floor = analytic_bytes_per_device(cfg, shape, SINGLE)
    for name in ("params", "caches"):
        total = sum(math.prod(_local(s, h, SINGLE)) * s.dtype.itemsize
                    for (_, s), (_, h) in zip(leaves_with_paths(specs[name]),
                                              leaves_with_paths(sh[name])))
        assert total == floor["params" if name == "params" else "cache"]


# rank (0, 0)'s blocks of minicpm3-4b on (16, 16): train under
# TRAIN_RULES ("embed" over "data", the 40 heads and 73,448 vocab rows
# replicated over "model", the ffn's 6,400 over it), decode_32k under
# SERVE_RULES (the heads' dims over "model": 96 / 16 and 64 / 16, the
# latent cache's length over "model", 8 of its 128 rows over "data")
MINI_BLOCKS = {
    "train_4k": {"wq_a": (62, 160, 768), "q_norm": (62, 768),
                 "wq_b": (62, 768, 40, 96), "wkv_a": (62, 160, 288),
                 "kv_norm": (62, 256), "wk_b": (62, 256, 40, 64),
                 "wv_b": (62, 256, 40, 64), "wo": (62, 40, 64, 160),
                 "ffn wi_gate": (62, 160, 400), "ffn wi_up": (62, 160, 400),
                 "ffn wo": (62, 400, 160), "table": (73448, 160),
                 "head": (160, 73448)},
    "decode_32k": {"wq_a": (62, 2560, 768), "q_norm": (62, 768),
                   "wq_b": (62, 768, 40, 6), "wkv_a": (62, 2560, 288),
                   "kv_norm": (62, 256), "wk_b": (62, 256, 40, 4),
                   "wv_b": (62, 256, 40, 4), "wo": (62, 40, 4, 2560),
                   "ffn wi_gate": (62, 2560, 400),
                   "ffn wi_up": (62, 2560, 400), "ffn wo": (62, 400, 2560),
                   "table": (73448, 2560), "head": (2560, 73448),
                   "c_kv": (62, 8, 2048, 256), "k_rope": (62, 8, 2048, 32)}}


def _mini_path(name):
    if name in ("table", "head"):
        return f"['embed']['{name}']"
    if name in ("c_kv", "k_rope"):
        return f"['main']['pos0']['attn']['{name}']"
    part, _, leaf = name.rpartition(" ")
    return f"['groups']['main']['pos0']['{part or 'attn'}']['{leaf}']"


@pytest.mark.parametrize("shape_name", ["train_4k", "decode_32k"])
def test_minicpm3_full_width_blocks(shape_name):
    """Rank 0's blocks of minicpm3-4b at full width on (16, 16)
    (``MINI_BLOCKS``), and its bytes the analytic floor's: the params
    and, in training, the moments; in serving, the params and the
    latent cache."""
    cfg, shape = get_config("minicpm3-4b"), SHAPES[shape_name]
    specs, sh = input_specs(cfg, shape), input_shardings(cfg, shape, SINGLE)
    train = shape.kind == "train"
    trees = {"params": (specs["state"]["params"], sh["state"]["params"]),
             "optimizer": tuple((specs["state"][k], sh["state"][k])
                                for k in ("mu", "nu"))} if train else \
        {"params": (specs["params"], sh["params"]),
         "cache": ((specs["caches"], sh["caches"]),)}
    local = {p: _local(s, h, SINGLE) for (p, s), (_, h) in zip(
        leaves_with_paths(trees["params"][0]),
        leaves_with_paths(trees["params"][1]))}
    if not train:
        local.update({p: _local(s, h, SINGLE) for (p, s), (_, h) in zip(
            leaves_with_paths(specs["caches"]),
            leaves_with_paths(sh["caches"]))})
    for name, want in MINI_BLOCKS[shape_name].items():
        assert local[_mini_path(name)] == want, name

    def nbytes(spec_tree, shard_tree):
        return sum(math.prod(_local(s, h, SINGLE)) * s.dtype.itemsize
                   for (_, s), (_, h) in zip(leaves_with_paths(spec_tree),
                                             leaves_with_paths(shard_tree)))

    floor = analytic_bytes_per_device(cfg, shape, SINGLE)
    assert nbytes(*trees["params"]) == floor["params"]
    key = "optimizer" if train else "cache"
    assert sum(nbytes(*t) for t in trees[key]) == floor[key]


def test_replicated_mla_train_queries_on_the_rank_rows():
    """``MINICPM3``'s sharded train step (3 heads, replicated over
    "model") traced on a fake {data: 1, model: 4} group at S = 256: its
    peak lies below the
    trace with the planted fault ``chip_smoke._mla_every_row`` (the
    residual's whole sequence gathered and every head's queries run on
    all 256 rows, the rank keeping its block), which no gloo value test
    can see."""
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh
    cfg = _torch_spmd.reduced(MINICPM3)
    shape = ShapeSpec("t", "train", 256, 4)
    with dryrun.fake_group(4):
        mesh = make_host_mesh(data=1, model=4, device_type="cpu")
        good = dryrun.trace_cell(cfg, shape, mesh, device="cpu")
        with chip_smoke._mla_every_row():
            bad = dryrun.trace_cell(cfg, shape, mesh, device="cpu")
    assert good["layout"] == bad["layout"] == "sharded"
    assert good["peak_device_bytes"] < bad["peak_device_bytes"], (
        good["peak_device_bytes"], bad["peak_device_bytes"])


@pytest.fixture
def gloo1():
    """A one-rank gloo group over an in-process store, torn down after."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_host_mesh(device_type="cpu")
    finally:
        dist.destroy_process_group()


def test_sharded_mla_train_matches_reference_jit_cell(gloo1):
    """The reference's ``jit_cell`` train step and the port's sharded
    one at world size 1 on the same carried-over state of reduced
    deepseek-v2 at the d_model fan-in law, MLA's query chunk 8 at S =
    32: loss and grad norm within rtol 1e-5, params within rtol 1e-5,
    atol 1e-7, over two steps (the first at learning rate 0)."""
    jcfg, cfg = _jreduced(MLA[0]), _torch_spmd.reduced(MLA[0])
    jshape = jsteps.ShapeSpec("tiny_train", "train", 32, 2)
    shape = ShapeSpec("tiny_train", "train", 32, 2)
    flags = _torch_spmd.mla_flags("chunk8")
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
    jf, _ = jsteps.jit_cell(jcfg, jshape, jmesh, flags=_jflags(flags),
                            opt=JAdamWConfig(**OPT))
    step, _ = jit_cell(cfg, shape, gloo1, flags, AdamWConfig(**OPT))
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
