"""The sharded train body (``launch/steps.jit_cell``'s ``"sharded"``
layout: FSDP over "data", tensor parallelism over "model", the residual
split by rows and sequence) of the four dense decoders, of
internvl2-26b (a VLM: its residual split as the concatenated [prefix;
tokens] sequence, re-blocked from and to the tokens' blocks) and of
recurrentgemma-9b (its RG-LRU channels over "model", the gates' partial
sums reduce-scattered by channel), on the CPU.

At world sizes 2 and 4 (gloo processes, ``_torch_spmd.sharded_train``)
every (mesh, arch, variant) case of ``_torch_spmd.MESHES`` x ``DENSE`` x
``VARIANTS`` is held against the unsharded ``make_train_step`` on the
same state: the loss and grad norm of two steps and every param and
moment within rtol 1e-5 (with and without two microbatches), each
rank's state exactly its block of ``input_shardings``; with int8
compression each scale within rtol 1e-6 and at most 0.1 % of the codes
one step off, where a rank's own max |g| misses (reduced
recurrentgemma's scales within 1e-6 plus twice the distance its
unsharded step's own scales move when its channels are summed in
another order, ``_torch_spmd.scale_band``).  Reduced gemma3's 2
heads on (1, 4) take the replicated-heads route, reduced granite's and
command-r's K/V heads the replicated-K/V route.  The weights are at the
d_model fan-in law (``_torch_spmd.fan_in_d_model``).  Reduced
internvl2 runs 4 prefix rows and 28 tokens, so that its residual's
blocks (16, 8 rows) are not its tokens' (14, 7) and every rank moves
rows; its planted faults (``_torch_spmd.VLM_FAULTS``: the prefix
concatenated per rank; the loss over the residual's blocks, ranks
weighed alike) must miss, and so must reduced recurrentgemma's
(``_torch_spmd.RG_FAULTS``: the gates' partial sums unreduced, another
rank's channels kept, the conv and scan run on each rank's sequence
block from a zero state).  Rank 0's two steps of both archs' plain and
two-microbatch cases are also held against the reference's
``jit_cell`` on a (1, 1) mesh.  Whisper-base runs as
``_torch_spmd.WHISPER``, reduced whisper with 3 heads of 16 dims and 7
frames (``whisper_variant``), which no test mesh's "model" axis
divides, as whisper-base's 8 heads and 1,500 frames on 16: every model
rank runs the encoder on all frames of its rows (its ffn over "model",
ending in an all-reduce with an all-reduce gradient) and the
cross-attention of its decoder rows against them; its planted faults
(``_torch_spmd.ENC_FAULTS``: the encoder output's gradient all-reduced
at the boundary, the encoder's ffn summed with no gradient collective)
must miss, and its rank 0's plain and two-microbatch cases (the second
cuts the tokens' sequence and not the frames) are held against the
reference's ``jit_cell`` too.  At world size 1 the cell is held
against the reference's own ``jit_cell``.
"""
import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_spmd
from _torch_spmd import (ARCH_OF, DENSE, JAX_HELD, MESHES, RG, VARIANTS,
                         WHISPER, reduced, train_faults, train_len,
                         whisper_variant)
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

VLM = "internvl2-26b"
CASES = [(world, data, model, arch, variant)
         for world in sorted(MESHES) for data, model in MESHES[world]
         for arch in DENSE for variant in VARIANTS + (
             train_faults(arch) if model > 1 else ())]
JAX_CASES = [(world, data, model, arch, variant)
             for world, data, model, arch, variant in CASES
             if arch in JAX_HELD and variant in ("plain", "accum2")]


class FakeMesh:
    """Just axis_names + shape, enough for partition_spec resolution."""
    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


def jreduced(name):
    """The JAX package's config of ``_torch_spmd.reduced(name)``."""
    if name == WHISPER:
        return whisper_variant(jget_reduced("whisper-base"))
    return jget_reduced(name)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """world -> (the job's folder, each rank's outcome a case), the job
    run once a world."""
    done = {}

    def get(world):
        if world not in done:
            tmp = tmp_path_factory.mktemp(f"sharded_train_{world}")
            _torch_spmd.spawn("sharded_train", world, tmp, timeout=300)
            done[world] = tmp, [json.loads((tmp / f"sharded_train.{r}.json")
                                           .read_text())
                                for r in range(world)]
        return done[world]
    return get


@pytest.mark.parametrize(
    "world,data,model,arch,variant", CASES,
    ids=[f"{d}x{m}-{a}-{v}" for _, d, m, a, v in CASES])
def test_sharded_train_matches_the_unsharded_step(runs, world, data, model,
                                                  arch, variant):
    name = f"{data}x{model}-{arch}-{variant}"
    for rank, res in enumerate(runs(world)[1]):
        assert res[name] == "ok", (rank, res[name])


@functools.lru_cache(maxsize=None)
def _reference_train(arch, variant):
    """The JAX package's ``jit_cell`` train step of reduced ``arch`` on
    a (1, 1) mesh (``variant``: "plain", or "accum2", two microbatches),
    two steps from the port's ``_torch_spmd.train_state`` on
    ``_torch_spmd._batch(cfg, 4, train_len(cfg), 10 + i)`` (a VLM's
    prefix embeddings included), as the gloo job runs them: the losses
    and grad norms, and {path: leaf} of the params and moments, float32
    numpy."""
    cfg = reduced(arch)
    seq = train_len(cfg)
    jshape = jsteps.ShapeSpec("tiny_train", "train", seq, 4)
    jmesh = jax.make_mesh((1, 1), ("data", "model"))
    jflags = JRunFlags(remat="full",
                       grad_accum=2 if variant == "accum2" else 1)
    jf, _ = jsteps.jit_cell(jreduced(arch), jshape, jmesh, flags=jflags,
                            opt=JAdamWConfig(**OPT))
    jst = tree_map(lambda t: jnp.asarray(t.numpy()),
                   _torch_spmd.train_state(cfg))
    out = {"loss": [], "grad_norm": []}
    for i in range(2):
        batch = _torch_spmd._batch(cfg, 4, seq, 10 + i)
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


def _jax_held(runs, world, data, model, arch, variant, rtol=1e-5):
    """Rank 0's two steps of a gloo case of ``arch`` (its losses, grad
    norms and whole params and moments, saved by the job) against the
    JAX package's ``jit_cell`` on a (1, 1) mesh from the same state on
    the same batches: each within ``rtol`` of its max."""
    name = f"{data}x{model}-{arch}-{variant}"
    tmp, res = runs(world)
    assert all(r[name] == "ok" for r in res), name
    got = torch.load(tmp / f"train.{name}.pt")
    want = _reference_train(arch, variant)
    for k in ("loss", "grad_norm"):
        for i, (g, w) in enumerate(zip(got[k], want[k], strict=True)):
            _torch_spmd._close(torch.tensor(g), torch.tensor(w),
                               f"{name} step {i} {k}", rtol)
    for key in ("params", "mu", "nu"):
        assert set(got[key]) == set(want[key]), (name, key)
        for path, g in got[key].items():
            _torch_spmd._close(g, torch.from_numpy(want[key][path].copy()),
                               f"{name} {key}{path}", rtol)


VLM_CASES = [c[:3] + c[4:] for c in JAX_CASES if c[3] == VLM]
RG_CASES = [c[:3] + c[4:] for c in JAX_CASES if c[3] == RG]
WHISPER_CASES = [c[:3] + c[4:] for c in JAX_CASES if c[3] == WHISPER]


@pytest.mark.parametrize(
    "world,data,model,variant", VLM_CASES,
    ids=[f"{d}x{m}-{VLM}-{v}" for _, d, m, v in VLM_CASES])
def test_sharded_vlm_train_matches_the_jax_reference(runs, world, data,
                                                     model, variant):
    """Each gloo internvl2 case's rank 0 against the JAX package
    (``_jax_held``)."""
    _jax_held(runs, world, data, model, VLM, variant)


@pytest.mark.parametrize(
    "world,data,model,variant", RG_CASES,
    ids=[f"{d}x{m}-{RG}-{v}" for _, d, m, v in RG_CASES])
def test_sharded_recurrent_train_matches_the_jax_reference(runs, world, data,
                                                           model, variant):
    """Each gloo recurrentgemma case's rank 0 against the JAX package
    (``_jax_held``; the reference's ``jit_cell`` runs this train cell
    under JAX 0.9) within rtol 1e-4: the port's unsharded step already
    lies 8.0e-6 of the leaf's max from the reference on an RG-LRU conv
    bias (its zero-initialized biases take their AdamW steps from
    near-zero gradients), and the sharded one within 1e-5 of that
    step."""
    _jax_held(runs, world, data, model, RG, variant, 1e-4)


@pytest.mark.parametrize(
    "world,data,model,variant", WHISPER_CASES,
    ids=[f"{d}x{m}-{WHISPER}-{v}" for _, d, m, v in WHISPER_CASES])
def test_sharded_whisper_train_matches_the_jax_reference(runs, world, data,
                                                         model, variant):
    """Each gloo whisper case's rank 0 against the JAX package
    (``_jax_held``; the frames in the batch)."""
    _jax_held(runs, world, data, model, WHISPER, variant)


def test_layout_is_chosen_from_the_config():
    """The dense decoders' (internvl2-26b's too) and mixtral-8x22b's
    train, prefill_32k, decode_32k and long_500k cells are sharded on
    both production meshes (the serving ones:
    ``tests/test_torch_sharded_serve.py``, Mixtral's:
    ``tests/test_torch_sharded_moe.py``, long_500k's:
    ``tests/test_torch_sharded_long.py``; the matrix runs internvl2's
    long_500k not at all, ``shape_applicable``), and deepseek-v2-236b's
    and minicpm3-4b's (its 40 MLA heads replicated over "model") but
    long_500k (``tests/test_torch_sharded_mla.py``), and
    recurrentgemma-9b's four (a DENSE arch: its RG-LRU blocks split by
    channel) and whisper-base's (its 8 heads and 1,500 frames split over
    no "model" rank: the matrix runs its long_500k not at all); every
    other arch's cells are gathered -- xlstm-125m's (mLSTM and sLSTM
    blocks) -- and so is a train
    cell whose sequence does not split over "model", or whose tokens
    split and whose residual (the prefix rows in front of them) does
    not, or the reverse, or an encoder-decoder whose heads or frames a
    "model" rank splits (reduced whisper-base's own 4 heads and 8
    frames on 2 or 4 ranks, not on 1; the variant's 3 heads and 7
    frames on none)."""
    assert RG in DENSE and WHISPER in DENSE
    sharded = tuple(ARCH_OF.get(a, a) for a in DENSE) + ("mixtral-8x22b",)
    for sname, shape in SHAPES.items():
        assert steps.layout(get_config("xlstm-125m"), shape, FakeMesh(
            {"data": 16, "model": 16})) == "gathered", sname
    for arch in ARCHS:
        cfg = get_config(arch)
        for mesh in (FakeMesh({"data": 16, "model": 16}),
                     FakeMesh({"pod": 2, "data": 16, "model": 16})):
            for sname, shape in SHAPES.items():
                want = "sharded" if arch in sharded \
                    or arch in ("deepseek-v2-236b", "minicpm3-4b") \
                    and sname != "long_500k" else "gathered"
                assert steps.layout(cfg, shape, mesh) == want, (arch, sname)
    train = ShapeSpec("t", "train", 32, 4)
    for model in (1, 2, 4):
        mesh = FakeMesh({"data": 4 // model, "model": model})
        assert steps.layout(get_reduced("whisper-base"), train, mesh) == (
            "sharded" if model == 1 else "gathered"), model
        assert steps.layout(reduced(WHISPER), train, mesh) == "sharded"
    # 4 heads but frames that no "model" axis divides, and the reverse
    own, var = get_reduced("whisper-base"), reduced(WHISPER)
    for cfg in (dataclasses.replace(own, encoder=var.encoder),
                dataclasses.replace(var, encoder=own.encoder)):
        assert steps.layout(cfg, train, FakeMesh(
            {"data": 1, "model": 2})) == "gathered"
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
    # reduced internvl2's 4 prefix rows: 28 tokens and 32 residual rows
    # split over 4 ranks, not over 8 (the tokens), nor 32 tokens and 36
    # rows over 8 (the residual)
    vlm = get_reduced(VLM)
    for seq, model, want in ((28, 4, "sharded"), (28, 8, "gathered"),
                             (32, 8, "gathered"), (30, 2, "sharded")):
        assert steps.layout(vlm, ShapeSpec("t", "train", seq, 4),
                            FakeMesh({"data": 1, "model": model})) == \
            want, (seq, model)


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
    1e-5, atol 1e-7, over two steps (the first at learning rate 0); a
    VLM's batch with its prefix embeddings, an encoder-decoder's with its
    frames."""
    jcfg, cfg = jreduced(arch), reduced(arch)
    seq = train_len(cfg)
    jshape = jsteps.ShapeSpec("tiny_train", "train", seq, 2)
    shape = ShapeSpec("tiny_train", "train", seq, 2)
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
        tok = rng.integers(0, cfg.vocab_size, (2, seq)).astype(np.int32)
        batch = {"tokens": tok, "labels": tok}
        if cfg.n_prefix_embeddings:
            batch["prefix_embeds"] = rng.standard_normal(
                (2, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32)
        if cfg.encoder is not None:
            batch["source_embeds"] = rng.standard_normal(
                (2, cfg.encoder.source_len, cfg.d_model)).astype(np.float32)
        with jmesh:
            jst, jm = jf(jst, {k: jnp.asarray(v) for k, v in batch.items()})
        state, m = step(state, {k: torch.from_numpy(v)
                                for k, v in batch.items()})
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
