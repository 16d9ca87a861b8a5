"""Multi-process checks of the port's sharded steps and pipeline on the
CPU: ``spawn(job, world, tmp_path, timeout)`` starts ``world`` gloo
processes over a ``FileStore`` (no network), each runs ``JOBS[job]``,
and a failure in any rank fails the caller.  This module imports no
JAX, so each spawned process starts with torch alone.
"""
import contextlib
import dataclasses
import json
import math
import pathlib
import time

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp
import torch.utils._python_dispatch

from repro_torch.configs import get_reduced
from repro_torch.distributed.sharding import entry_axes, reduce_over
from repro_torch.models import RunFlags, materialize
from repro_torch.models.params import leaves_with_paths, tree_map
from repro_torch.training.optimizer import AdamWConfig

OPT = AdamWConfig(warmup_steps=0, total_steps=10)
FLAGS = RunFlags(remat="full")
RTOL = 1e-5


def _batch(cfg, b, s, seed):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                                .astype(np.int32))
            for k in ("tokens", "labels")}


def _close(got, want, label, rtol=RTOL):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max()) if got.numel() else 0.0
    scale = float(want.abs().max()) if want.numel() else 0.0
    assert err <= rtol * scale, (label, err, scale)


def block(full, spec, mesh):
    """The block of ``full`` the reference's spec assigns to this rank:
    a dimension split over axes (a1, a2, ...) is cut into prod(sizes)
    equal runs and this rank takes run sum_i coord(a_i) x (sizes after
    a_i), major to minor."""
    dm = mesh.device_mesh
    out = full
    for dim, entry in enumerate(spec):
        axes = entry_axes(entry)
        if not axes:
            continue
        n = math.prod(mesh.shape[a] for a in axes)
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + dm.get_local_rank(a)
        size = full.shape[dim] // n
        out = out.narrow(dim, idx * size, size)
    return out


def _check_blocks(tree, shardings, mesh, label):
    for (path, d), (_, sh) in zip(leaves_with_paths(tree),
                                  leaves_with_paths(shardings)):
        assert torch.equal(d.to_local(), block(d.full_tensor(), sh.spec,
                                               mesh)), (label, path)


def fan_in_d_model(params, specs):
    """Every [d_model, heads, head_dim] projection scaled, in place, from
    the reference's init law (std 1/sqrt(heads)) to 1/sqrt(d_model).  At
    the reference's law the float32 step is chaotic (ROADMAP.md,
    "Reference failures"): the sharded layout's other summation order
    alone moves reduced granite's gradients by ~1e-5 of their max, and
    AdamW's second step turns a gradient that small into a whole
    learning-rate step of either sign.  At this law they move ~5e-7."""
    for key, sub in params.items():
        if isinstance(sub, dict):
            fan_in_d_model(sub, specs[key])
        elif specs[key].axes[-3:-1] in (("embed", "heads"),
                                        ("embed", "kv_heads")):
            sub.mul_((sub.shape[-2] / sub.shape[-3]) ** 0.5)
    return params


def train_state(cfg, compression=False):
    """The train cell's state from seed 0 at the d_model fan-in law."""
    from repro_torch.launch.steps import train_state_specs
    from repro_torch.models import build_param_specs
    st = materialize(train_state_specs(cfg, compression=compression),
                     torch.Generator().manual_seed(0), "cpu")
    fan_in_d_model(st["params"], build_param_specs(cfg))
    return st


def _train_cell(arch, mesh):
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_train_step)
    from repro_torch.models import moe
    cfg = get_reduced(arch)
    shape = ShapeSpec("tiny_train", "train", 32, 4)

    def state():
        return train_state(cfg)

    step, _ = jit_cell(cfg, shape, mesh, FLAGS, OPT)
    ref = make_train_step(cfg, OPT, FLAGS)
    got, want = state(), state()
    for i in range(2):
        batch = _batch(cfg, 4, 32, 10 + i)
        got, gm = step(got, batch)
        want, wm = ref(want, batch)
        for k in ("loss", "grad_norm"):
            _close(gm[k].full_tensor(), wm[k], f"{arch} step {i} {k}")
    for key in ("params", "mu", "nu"):
        for (path, g), (_, w) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            _close(g.full_tensor(), w, f"{arch} {key}{path}")
    _check_blocks(got, input_shardings(cfg, shape, mesh)["state"], mesh,
                  arch)
    if cfg.moe is None:
        return
    # the router's statistics must be the global batch's: with each rank's
    # own fractions (and no share) the loss misses the unsharded one
    real = moe.sharding
    moe.sharding = type("NoShards", (), {"batch_shards": staticmethod(
        lambda: None)})
    try:
        step, _ = jit_cell(cfg, shape, mesh, FLAGS, OPT)
        _, gm = step(state(), _batch(cfg, 4, 32, 10))
    finally:
        moe.sharding = real
    _, wm = make_train_step(cfg, OPT, FLAGS)(state(), _batch(cfg, 4, 32, 10))
    miss = abs(float(gm["loss"].full_tensor()) - float(wm["loss"]))
    assert miss > 10 * RTOL * abs(float(wm["loss"])), miss


def _serve_cells(mesh):
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          input_specs, jit_cell,
                                          make_decode_step,
                                          make_prefill_step)
    cfg = get_reduced("granite-20b")
    pre = ShapeSpec("tiny_prefill", "prefill", 16, 4)
    dec = ShapeSpec("tiny_decode", "decode", 32, 4)
    params = materialize(input_specs(cfg, pre)["params"],
                         torch.Generator().manual_seed(0), "cpu")
    tokens = _batch(cfg, 4, 16, 3)["tokens"]
    caches = materialize(input_specs(cfg, pre)["caches"],
                         torch.Generator().manual_seed(1), "cpu")
    want, want_c = make_prefill_step(cfg)(params, {"tokens": tokens},
                                          tree_map(torch.clone, caches))
    wide = bf16_witness(make_prefill_step(cfg), params, {"tokens": tokens},
                        caches, want_c)
    step, _ = jit_cell(cfg, pre, mesh)
    got, got_c = step(params, {"tokens": tokens}, caches)
    _close(got.full_tensor(), want, "prefill logits")
    _check_blocks(got_c, input_shardings(cfg, pre, mesh)["caches"], mesh,
                  "prefill caches")
    for (path, g), (_, w), (_, x) in zip(leaves_with_paths(got_c),
                                         leaves_with_paths(want_c),
                                         leaves_with_paths(wide)):
        # bf16 caches: the sharded body's K/V (its own summation order,
        # within rtol 1e-5) may round to the other neighbour at an edge
        bf16_close(g.full_tensor(), w, x, f"prefill cache{path}")
    caches = materialize(input_specs(cfg, dec)["caches"],
                         torch.Generator().manual_seed(2), "cpu")
    tok = _batch(cfg, 4, 1, 4)["tokens"]
    want, _ = make_decode_step(cfg)(params, tok, tree_map(torch.clone,
                                                          caches), 20)
    step, _ = jit_cell(cfg, dec, mesh)
    got, _ = step(params, tok, caches, 20)
    _close(got.full_tensor(), want, "decode logits")


def _dtensor_refused(mesh):
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops
    q = torch.randn(1, 2, 8, 16)
    dq = distribute_tensor(q, mesh.device_mesh,
                           [Replicate()] * mesh.device_mesh.ndim)
    try:
        ops.flash_attention(dq, dq, dq)
    except TypeError as e:
        assert "DTensor" in str(e)
    else:
        raise AssertionError("a DTensor reached the flash kernel wrapper")


def sharded_steps(rank, world):
    """The train cells of reduced granite-20b and mixtral-8x22b on a
    {data: 2, model: world / 2} mesh against the unsharded step, the
    serving cells of granite, and a DTensor refused by ``ops``."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=2, model=world // 2, device_type="cpu")
    assert mesh.shape == {"data": 2, "model": world // 2}
    for arch in ("granite-20b", "mixtral-8x22b"):
        _train_cell(arch, mesh)
    _serve_cells(mesh)
    _dtensor_refused(mesh)


def pipeline_two_stages(rank, world):
    """GPipe over 2 stages of reduced granite-20b against ``train_loss``:
    loss within rel 1e-5, every gradient leaf within 1e-5 of its max."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.distributed.sharding import Mesh
    from repro_torch.launch.steps import value_and_grad
    from repro_torch.models import build_param_specs
    from repro_torch.models.params import tree_leaves, tree_unflatten
    from repro_torch.training.pipeline import (make_pipelined_train_loss,
                                               split_stage_params)
    cfg = get_reduced("granite-20b")
    flags = RunFlags(remat="none")
    mesh = Mesh(init_device_mesh("cpu", (world,), mesh_dim_names=("pod",)))
    params = materialize(build_param_specs(cfg),
                         torch.Generator().manual_seed(0), "cpu")
    batch = _batch(cfg, 4, 16, 1)
    want_loss, want = value_and_grad(params, batch, cfg, flags)
    staged = split_stage_params(params, cfg, n_stages=world)
    leaves = [t.detach().requires_grad_() for t in tree_leaves(staged)]
    loss_fn = make_pipelined_train_loss(cfg, mesh, n_microbatches=2,
                                        flags=flags)
    loss = loss_fn(tree_unflatten(staged, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    got = split_stage_params(want, cfg, n_stages=world)   # same layout
    assert abs(float(loss.detach()) - float(want_loss)) <= RTOL * abs(
        float(want_loss)), (float(loss), float(want_loss))
    for (path, w), g in zip(leaves_with_paths(got), grads):
        _close(g, w, f"pipeline grad{path}")


# the sharded train body: the dense decoders, the meshes (data, model) of
# each world size, and the variants held against the unsharded step
DENSE = ("qwen2-5-7b", "gemma3-1b", "granite-20b", "command-r-35b")
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
VARIANTS = ("plain", "accum2", "compression")
SCALE_RTOL = 1e-6          # the int8 scales
CODE_SHARE = 1e-3          # the int8 codes that may differ, by one step


def _state_bytes(got, shardings, mesh, label):
    """Each rank holds its block of every state leaf and no more."""
    for (path, d), (_, sh) in zip(leaves_with_paths(got),
                                  leaves_with_paths(shardings)):
        local = d.to_local()
        shape = list(d.shape)
        for dim, entry in enumerate(sh.spec):
            for a in entry_axes(entry):
                shape[dim] //= mesh.shape[a]
        assert list(local.shape) == shape and \
            local.untyped_storage().nbytes() == \
            math.prod(shape) * local.element_size(), (label, path)


def _quantized(real, into):
    """``real`` (``compression._quantize``) recording each call's (q,
    scale)."""
    def spy(x, groups=()):
        q, scale = real(x, groups)
        into.append((q.clone(), float(scale)))
        return q, scale
    return spy


def _sharded_case(arch, mesh, variant):
    """One train cell of the sharded body against ``make_train_step``,
    two steps: the losses, and each rank's state its blocks; without
    compression the grad norms and every param and moment within rtol
    1e-5; with it each int8 scale within SCALE_RTOL and at most
    CODE_SHARE of the codes off, each by one step (the summation order
    may move a gradient across a rounding edge, and a code one step off
    moves that element's update by a 127th of the leaf's max), while a
    rank's own max |g| (the scale not reduced over the shards) misses
    the scale bound."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_train_step)
    from repro_torch.training import compression as comp
    cfg = get_reduced(arch)
    shape = ShapeSpec("tiny_train", "train", 32, 4)
    flags = RunFlags(remat="full", grad_accum=2 if variant == "accum2"
                     else 1)
    packed = variant == "compression"
    assert steps.layout(cfg, shape, mesh, flags) == "sharded"
    step, _ = jit_cell(cfg, shape, mesh, flags, OPT, compression=packed)
    ref = make_train_step(cfg, OPT, flags, compression=packed)
    got, want = train_state(cfg, packed), train_state(cfg, packed)
    mine, theirs = [], []
    real = comp._quantize
    for i in range(2):
        batch = _batch(cfg, 4, 32, 10 + i)
        comp._quantize = _quantized(real, mine)
        try:
            got, gm = step(got, batch)
            comp._quantize = _quantized(real, theirs)
            want, wm = ref(want, batch)
        finally:
            comp._quantize = real
        for k in ("loss",) if packed else ("loss", "grad_norm"):
            _close(gm[k].full_tensor(), wm[k], f"{arch} step {i} {k}")
    for key in () if packed else got:
        for (path, g), (_, w) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            _close(g.full_tensor(), w, f"{arch} {key}{path}")
    shardings = input_shardings(cfg, shape, mesh)["state"]
    if packed:
        shardings = dict(shardings, ef=shardings["params"])
    _check_blocks(got, shardings, mesh, arch)
    _state_bytes(got, shardings, mesh, arch)
    if not packed:
        return
    # the int8 codes and scales, leaf by leaf (the params' order, twice)
    specs = [sh.spec for _, sh in leaves_with_paths(shardings["params"])]
    specs = specs * 2
    assert len(mine) == len(theirs) == len(specs)
    off = total = 0
    for (q, sc), (wq, wsc), spec in zip(mine, theirs, specs):
        assert abs(sc - wsc) <= SCALE_RTOL * abs(wsc), (arch, sc, wsc)
        d = (q.int() - block(wq, spec, mesh).int()).abs()
        assert int(d.max()) <= 1, (arch, int(d.max()))
        off += int((d > 0).sum())
        total += d.numel()
    assert off <= CODE_SHARE * total, (arch, off, total)
    # planted fault: each rank's own max |g| as the scale
    own = []
    comp.reduce_over = lambda t, groups, op="sum": t
    comp._quantize = _quantized(real, own)
    try:
        jit_cell(cfg, shape, mesh, flags, OPT, compression=True)[0](
            train_state(cfg, True), _batch(cfg, 4, 32, 10))
    finally:
        comp.reduce_over, comp._quantize = reduce_over, real
    missed = any(abs(sc - wsc) > SCALE_RTOL * abs(wsc)
                 for (_, sc), (_, wsc) in zip(own, theirs))
    assert missed, f"{arch}: a rank's own max |g| passes the scale bound"


def sharded_train(rank, world):
    """Every (mesh, arch, variant) case of MESHES[world] x DENSE x
    VARIANTS; each rank writes its outcome a case to
    ``OUT / sharded_train.<rank>.json`` (the test reads them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in DENSE:
            for variant in VARIANTS:
                name = f"{data}x{model}-{arch}-{variant}"
                try:
                    _sharded_case(arch, mesh, variant)
                    res[name] = "ok"
                except Exception as e:              # noqa: BLE001
                    res[name] = f"{type(e).__name__}: {e}"
    (OUT / f"sharded_train.{rank}.json").write_text(json.dumps(res))


# the sharded serving body: the cases of each (mesh, arch), the cells'
# shapes (a cache of SERVE_LEN rows; a prompt of PROMPT_LEN tokens)
SERVE_CASES = ("prefill", "prefill-bf16", "decode-first", "decode-hi-1",
               "decode-hi", "decode-last", "decode-bf16", "memory")
PROMPT_LEN = 16
SERVE_LEN = 32
SERVE_ROWS = 4
# the elements of a bf16 cache leaf that may differ between two writers:
# at most 2 seen in any leaf of these tests (of 1,024-4,096), and 2 more
BF16_OFF = 4


def serve_positions(model):
    """The decode cases' positions on a mesh of ``model`` "model" ranks
    (blocks of b = SERVE_LEN / model rows): in the first block, at the
    last row of block 0 (hi - 1) and the first of block 1 (hi; with one
    block, the row before the last), in the last block."""
    b = SERVE_LEN // model
    return {"decode-first": 3, "decode-hi-1": b - 1,
            "decode-hi": b if b < SERVE_LEN else SERVE_LEN - 2,
            "decode-last": SERVE_LEN - 3, "decode-bf16": SERVE_LEN - 3}


def _filled(specs, seed, dtype):
    """Caches of ``specs`` filled from seed ``seed`` (unit normals) in
    ``dtype``: a decode reads rows written before it."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: torch.from_numpy(rng.standard_normal(
        s.shape).astype(np.float32)).to(dtype), specs)


def bf16_close(got, want, wide, label):
    """Two bf16 cache leaves, ``got`` and ``want``, written from float32
    K/V that agree within rtol 1e-5 of the leaf's max, against ``wide``,
    the float32 K/V ``want`` was written from (``bf16_witness``): each
    element of both is the bf16 rounding of a value within 1e-5 of the
    leaf's max of its float32 value, so an element that far from a
    rounding midpoint equals bf16(wide) bit for bit and one nearer may
    take either neighbour; and at most BF16_OFF elements of the leaf
    differ."""
    tol = RTOL * float(wide.abs().max())
    lo, hi = (wide - tol).bfloat16(), (wide + tol).bfloat16()
    for t in (got, want):
        assert bool(((lo <= t) & (t <= hi)).all()), (label, int(
            ((t < lo) | (t > hi)).sum()))
    off = int((got != want).sum())
    assert off <= BF16_OFF, (label, off, want.numel())


def bf16_witness(step, params, first, caches, want, *rest):
    """The float32 K/V an unsharded ``step`` wrote into bf16 caches: the
    step again on ``caches`` widened to float32, every cache read
    rounded to bf16 as the bf16 cache gives it, so each product is the
    bf16 run's.  Checks that these caches round to ``want`` (the bf16
    run's new caches) bit for bit, and returns them."""
    from repro_torch.models import attention
    real = attention._kv_read
    attention._kv_read = lambda c, n, dt: real(c, n, torch.float32) \
        .bfloat16().to(dt)
    try:
        _, wide = step(params, first, tree_map(lambda c: c.float(), caches),
                       *rest)
    finally:
        attention._kv_read = real
    for (path, x), (_, w) in zip(leaves_with_paths(wide),
                                 leaves_with_paths(want)):
        assert torch.equal(x.bfloat16(), w), ("witness", path)
    return wide


def _serve_params(cfg, specs):
    """The weights from seed 0 at the d_model fan-in law
    (``fan_in_d_model``).  At the reference's law reduced gemma3-1b's
    float32 prefill grows its rounding about 8x a layer: its third
    layer's K lies 1.8e-5 of the leaf's max from the float64 step in
    the port and 7.4e-6 in the JAX package, so the two miss each other's
    rtol 1e-5 unsharded already (``tools/serve_conditioning.py``)."""
    return fan_in_d_model(materialize(specs, torch.Generator().manual_seed(0),
                                      "cpu"), specs)


class _Allocations(torch.utils._python_dispatch.TorchDispatchMode):
    """The shapes of the tensors the ops make in new storage (no view,
    no output that is an input's storage)."""

    def __init__(self):
        super().__init__()
        self.shapes = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.is_view:
            return out
        held = {a.untyped_storage()._cdata for a in
                torch.utils._pytree.tree_leaves((args, kwargs))
                if isinstance(a, torch.Tensor)}
        for t in torch.utils._pytree.tree_leaves(out):
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage()._cdata not in held:
                self.shapes.append(tuple(t.shape))
        return out


def _serve_memory(cfg, mesh, dec):
    """A decode step: each rank holds its block of every weight and cache
    leaf, writes its cache in place (the step's caches are the ones it
    was handed, same storage, and it makes no tensor of a stacked cache
    leaf's shape: no restack), and makes no tensor with the cache's
    whole length or the whole table where "model" splits them; an
    out-of-place writer (``slice_scatter`` and a restack, the gathered
    body's) fails those checks."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.steps import input_shardings, input_specs, \
        jit_cell
    from repro_torch.models import attention
    specs = input_specs(cfg, dec)
    sh = input_shardings(cfg, dec, mesh)
    params = tree_map(distribute, _serve_params(cfg, specs["params"]),
                      sh["params"])
    tok = _batch(cfg, SERVE_ROWS, 1, 4)["tokens"]
    model = mesh.shape["model"]
    stacked = {tuple(block(torch.empty(c.shape, device="meta"), s.spec,
                           mesh).shape)
               for (_, c), (_, s) in zip(leaves_with_paths(specs["caches"]),
                                         leaves_with_paths(sh["caches"]))}
    whole = set() if model == 1 else {
        (SERVE_LEN, cfg.n_kv_heads, cfg.head_dim_),
        (cfg.vocab_size, cfg.d_model), (cfg.d_model, cfg.vocab_size)}

    def run(pos):
        caches = tree_map(distribute, _filled(specs["caches"], 5,
                                              torch.float32), sh["caches"])
        held = [c.to_local().untyped_storage()._cdata
                for _, c in leaves_with_paths(caches)]
        step, _ = jit_cell(cfg, dec, mesh)
        with _Allocations() as seen:
            _, got = step(params, tok, caches, pos)
        same = [c.to_local().untyped_storage()._cdata
                for _, c in leaves_with_paths(got)] == held
        big = [s for s in seen.shapes
               if s in stacked or s[-3:] in whole or s[-2:] in whole]
        return same and not big, big, got

    # every run's collectives before any check raises, so the ranks stay
    # in step
    runs = {pos: run(pos) for pos in serve_positions(model).values()}
    real = attention._kv_put

    def out_of_place(cache, kv, lo, off):
        t, s = cache["k"].shape[1], kv["k"].shape[1]
        a, e = max(lo, off), min(lo + t, off + s)
        return {n: torch.slice_scatter(
            cache[n], kv[n][:, a - off:max(e, a) - off].to(cache[n].dtype),
            1, a - lo, max(e, a) - lo) for n in cache}

    attention._kv_put = out_of_place
    try:
        fault, _, _ = run(serve_positions(model)["decode-last"])
    finally:
        attention._kv_put = real
    for pos, (ok, big, got) in runs.items():
        assert ok, (pos, big)
        _state_bytes(got, sh["caches"], mesh, "caches")
    _state_bytes(params, sh["params"], mesh, "params")
    assert not fault, "an out-of-place cache write passes the in-place check"


def reduced(name):
    """A reduced config by name: an arch's (``get_reduced``), or
    ``THREE_EXPERTS``, reduced Mixtral with 3 experts."""
    if name != THREE_EXPERTS:
        return get_reduced(name)
    cfg = get_reduced("mixtral-8x22b")
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=3))


def serve_inputs(arch, prefill, dtype, pos=None):
    """A serving case's inputs, the same in every process: (cfg, shape,
    params, first, caches, rest), the step called as ``step(params,
    first, caches, *rest)``: a prompt of PROMPT_LEN tokens into a cache
    of PROMPT_LEN rows, or a token at ``pos`` of a cache of SERVE_LEN
    rows, SERVE_ROWS rows of batch; caches in ``dtype`` from seed 2."""
    from repro_torch.launch.steps import ShapeSpec, input_specs
    cfg = reduced(arch)
    shape = ShapeSpec("tiny_prefill", "prefill", PROMPT_LEN, SERVE_ROWS) \
        if prefill else ShapeSpec("tiny_decode", "decode", SERVE_LEN,
                                  SERVE_ROWS)
    specs = input_specs(cfg, shape)
    params = _serve_params(cfg, specs["params"])
    caches = _filled(specs["caches"], 2, dtype)
    if prefill:
        first = {"tokens": _batch(cfg, SERVE_ROWS, PROMPT_LEN, 3)["tokens"]}
        return cfg, shape, params, first, caches, ()
    return (cfg, shape, params, _batch(cfg, SERVE_ROWS, 1, 4)["tokens"],
            caches, (pos,))


def _serve_case(arch, mesh, case, name):
    """One case of the sharded serving body against ``make_prefill_step``
    / ``make_decode_step`` on the same inputs: the logits and every
    float32 cache leaf within rtol 1e-5 of each leaf's max, a bf16 one
    by ``bf16_close``, each rank's caches its blocks (``SERVE_CASES``; a
    "-bf16" case with a bf16 cache, the rest float32).  Rank 0 saves
    the whole logits and caches (and the bf16 witness) to
    ``OUT / serve.<name>.pt`` for the test's comparison with the JAX
    package."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_decode_step,
                                          make_prefill_step)
    cfg = reduced(arch)
    pre = ShapeSpec("tiny_prefill", "prefill", PROMPT_LEN, SERVE_ROWS)
    dec = ShapeSpec("tiny_decode", "decode", SERVE_LEN, SERVE_ROWS)
    for shape in (pre, dec):
        assert steps.layout(cfg, shape, mesh) == "sharded"
    if case == "memory":
        return _serve_memory(cfg, mesh, dec)
    dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
    prefill = case.startswith("prefill")
    pos = None if prefill else serve_positions(mesh.shape["model"])[case]
    cfg, shape, params, first, caches, rest = serve_inputs(arch, prefill,
                                                          dtype, pos)
    ref = (make_prefill_step if prefill else make_decode_step)(cfg)
    want, want_c = ref(params, first, tree_map(torch.clone, caches), *rest)
    wide = None if dtype == torch.float32 else bf16_witness(
        ref, params, first, caches, want_c, *rest)
    got, got_c = jit_cell(cfg, shape, mesh)[0](params, first, caches, *rest)
    logits = got.full_tensor()
    whole = {path: g.full_tensor() for path, g in leaves_with_paths(got_c)}
    _close(logits, want, f"{arch} {case} logits")
    for path, w in leaves_with_paths(want_c):
        if wide is None:
            _close(whole[path], w, f"{arch} {case} cache{path}")
        else:
            bf16_close(whole[path], w, dict(leaves_with_paths(wide))[path],
                       f"{arch} {case} cache{path}")
    _check_blocks(got_c, input_shardings(cfg, shape, mesh)["caches"], mesh,
                  f"{arch} {case}")
    if dist.get_rank() == 0:
        torch.save({"logits": logits, "caches": whole, "wide": None
                    if wide is None else dict(leaves_with_paths(wide))},
                   OUT / f"serve.{name}.pt")


def sharded_serve(rank, world):
    """Every (mesh, arch, case) of MESHES[world] x DENSE x SERVE_CASES;
    each rank writes its outcome a case to
    ``OUT / sharded_serve.<rank>.json`` (the test reads them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in DENSE:
            for case in SERVE_CASES:
                name = f"{data}x{model}-{arch}-{case}"
                try:
                    _serve_case(arch, mesh, case, name)
                    res[name] = "ok"
                except Exception as e:              # noqa: BLE001
                    res[name] = f"{type(e).__name__}: {e}"
    (OUT / f"sharded_serve.{rank}.json").write_text(json.dumps(res))


# the sharded MoE bodies: reduced Mixtral, whose 4 experts split over
# "model" (expert parallelism), and THREE_EXPERTS, whose experts do not
# divide "model" at 2 or 4 ranks, so each expert's ffn is split instead
THREE_EXPERTS = "mixtral-3-experts"
MOE = ("mixtral-8x22b", THREE_EXPERTS)
# train variants: two microbatches; the exact dense dispatch
# (``RunFlags.moe_impl``); dispatch groups of 16 tokens at S = 32 (a
# group spans two ranks' sequence blocks at model 4); one group a row;
# the last two at capacity factor DROP_CF, where the pigeonhole drops
# tokens (64 assignments a row on 4 experts of capacity 8, or on 3 of
# 11; 32 a group on 4 of capacity 4)
MOE_TRAIN = ("plain", "accum2", "dense", "group16", "drop")
DROP_CF = 0.5
# serving cases (prefill, decode at a position of serve_positions) under
# SERVE_RULES ("serve-") and SERVE_BIG_RULES ("big-"), which the job
# substitutes for rules_for's choice (the reduced config's weights are
# small enough to replicate over "data")
MOE_SERVE = tuple(f"{r}-{c}" for r in ("serve", "big") for c in (
    "prefill", "decode-first", "decode-hi-1", "decode-last")) + (
    "big-prefill-bf16", "big-decode-bf16")
# planted faults (meshes with a "model" axis of more than one rank): each
# rank's sequence block routed on its own; the aux loss counted once a
# model rank; the experts' partial sums left unreduced (train, and a
# decode step)
MOE_FAULTS = ("blockwise", "aux-per-rank", "unreduced", "unreduced-decode")


def moe_train_cfg(arch, variant):
    """The config of a MOE_TRAIN variant (capacity DROP_CF where it
    drops tokens) and its flags."""
    cfg = reduced(arch)
    if variant in ("group16", "drop"):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, capacity_factor=DROP_CF))
    return cfg, RunFlags(remat="full",
                         grad_accum=2 if variant == "accum2" else 1,
                         moe_impl="dense" if variant == "dense" else None,
                         moe_group=16 if variant == "group16" else 0)


@contextlib.contextmanager
def serve_big_rules():
    """``steps.rules_for`` choosing SERVE_BIG_RULES for every serving
    cell (TRAIN_RULES for a train cell)."""
    from repro_torch.distributed.sharding import SERVE_BIG_RULES, TRAIN_RULES
    from repro_torch.launch import steps
    real = steps.rules_for
    steps.rules_for = lambda shape, cfg=None: \
        TRAIN_RULES if shape.kind == "train" else SERVE_BIG_RULES
    try:
        yield
    finally:
        steps.rules_for = real


def _moe_train_case(arch, mesh, variant, name):
    """One MOE_TRAIN case of the sharded train body against
    ``make_train_step``, two steps from ``train_state`` on
    ``_batch(cfg, 4, 32, 10 + i)``: the losses and grad norms, every
    param and moment within rtol 1e-5, each rank's state its blocks.
    Rank 0 saves the losses, grad norms and whole params and moments to
    ``OUT / train.<name>.pt`` for the test's comparison with the JAX
    package."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_train_step)
    cfg, flags = moe_train_cfg(arch, variant)
    shape = ShapeSpec("tiny_train", "train", 32, 4)
    assert steps.layout(cfg, shape, mesh, flags) == "sharded"
    step, _ = jit_cell(cfg, shape, mesh, flags, OPT)
    ref = make_train_step(cfg, OPT, flags)
    got, want = train_state(cfg), train_state(cfg)
    saved = {"loss": [], "grad_norm": []}
    for i in range(2):
        batch = _batch(cfg, 4, 32, 10 + i)
        got, gm = step(got, batch)
        want, wm = ref(want, batch)
        for k in ("loss", "grad_norm"):
            saved[k].append(float(gm[k].full_tensor()))
            _close(gm[k].full_tensor(), wm[k], f"{arch} step {i} {k}")
    for key in ("params", "mu", "nu"):
        saved[key] = {}
        for (path, g), (_, w) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            saved[key][path] = g.full_tensor()
            _close(saved[key][path], w, f"{arch} {key}{path}")
    shardings = input_shardings(cfg, shape, mesh)["state"]
    _check_blocks(got, shardings, mesh, arch)
    _state_bytes(got, shardings, mesh, arch)
    if dist.get_rank() == 0:
        torch.save(saved, OUT / f"train.{name}.pt")


class _Unreduced:
    """A planted fault's ``ModelShards``: the experts' partial sums not
    reduced over the model axis (the rank's block of its own)."""

    def __init__(self, tp):
        self._tp = tp

    def __getattr__(self, name):
        return getattr(self._tp, name)

    def seq_scatter(self, y):
        return self._tp.own(y)


@contextlib.contextmanager
def moe_fault(name):
    """A planted fault of the sharded MoE (MOE_FAULTS), patched into
    ``models/moe``: "blockwise" routes each rank's sequence block as a
    dispatch group of its own; "aux-per-rank" counts the router's aux
    loss once a model rank; "unreduced" (and "unreduced-decode") leave
    the experts' partial sums unreduced."""
    from repro_torch.models import moe
    real_ffn, real_router = moe.moe_ffn, moe._router

    def blockwise(p, x, cfg, *, impl=None, group_size=None, tp=None):
        return real_ffn(p, x, cfg, impl=impl, tp=tp, group_size=(
            group_size if tp is None else x.shape[1]))

    def per_rank(p, x, m, tp=None):
        gates, idx, aux = real_router(p, x, m, tp)
        return gates, idx, aux * (1 if tp is None else tp.size)

    def unreduced(p, x, cfg, *, tp=None, **kw):
        return real_ffn(p, x, cfg, tp=None if tp is None else
                        _Unreduced(tp), **kw)

    if name == "blockwise":
        moe.moe_ffn = blockwise
    elif name == "aux-per-rank":
        moe._router = per_rank
    else:
        moe.moe_ffn = unreduced
    try:
        yield
    finally:
        moe.moe_ffn, moe._router = real_ffn, real_router


def _moe_fault_case(arch, mesh, fault):
    """A planted fault must miss: one train step of the "drop" variant
    (its loss or grad norm), or a decode step at the last row (its
    logits), farther than 10 x rtol from the unsharded step's."""
    from repro_torch.launch.steps import (ShapeSpec, jit_cell,
                                          make_decode_step, make_train_step)
    if fault == "unreduced-decode":
        cfg, shape, params, tok, caches, rest = serve_inputs(
            arch, False, torch.float32, SERVE_LEN - 3)
        want, _ = make_decode_step(cfg)(params, tok, tree_map(torch.clone,
                                                              caches), *rest)
        with moe_fault(fault):
            got, _ = jit_cell(cfg, shape, mesh)[0](params, tok, caches, *rest)
        got = got.full_tensor()
        miss = float((got - want).abs().max()) / float(want.abs().max())
    else:
        cfg, flags = moe_train_cfg(arch, "drop")
        shape = ShapeSpec("tiny_train", "train", 32, 4)
        batch = _batch(cfg, 4, 32, 10)
        _, wm = make_train_step(cfg, OPT, flags)(train_state(cfg), batch)
        with moe_fault(fault):
            _, gm = jit_cell(cfg, shape, mesh, flags, OPT)[0](
                train_state(cfg), batch)
        miss = max(abs(float(gm[k].full_tensor()) - float(wm[k]))
                   / abs(float(wm[k])) for k in ("loss", "grad_norm"))
    assert miss > 10 * RTOL, f"{fault} passes: {miss}"


def sharded_moe(rank, world):
    """Every (mesh, arch, case) of MESHES[world] x MOE x (MOE_TRAIN,
    MOE_SERVE, and MOE_FAULTS where "model" has more than one rank);
    each rank writes its outcome a case to ``OUT /
    sharded_moe.<rank>.json``, rank 0 a train case's losses, grad norms
    and whole state to ``OUT / train.<name>.pt`` and a serving case's
    whole logits and caches to ``OUT / serve.<name>.pt`` (the test reads
    them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in MOE:
            cases = MOE_TRAIN + MOE_SERVE + (MOE_FAULTS if model > 1
                                             else ())
            for case in cases:
                name = f"{data}x{model}-{arch}-{case}"
                big = case.startswith("big-")
                try:
                    if case in MOE_TRAIN:
                        _moe_train_case(arch, mesh, case, name)
                    elif case in MOE_FAULTS:
                        _moe_fault_case(arch, mesh, case)
                    else:
                        with serve_big_rules() if big else \
                                contextlib.nullcontext():
                            _serve_case(arch, mesh, case.split("-", 1)[1],
                                        name)
                    res[name] = "ok"
                except Exception as e:              # noqa: BLE001
                    res[name] = f"{type(e).__name__}: {e}"
    (OUT / f"sharded_moe.{rank}.json").write_text(json.dumps(res))


JOBS = {"sharded_steps": sharded_steps,
        "pipeline_two_stages": pipeline_two_stages,
        "sharded_train": sharded_train,
        "sharded_serve": sharded_serve,
        "sharded_moe": sharded_moe}
OUT = pathlib.Path(".")


def _run(rank, world, store, job):
    global OUT
    OUT = pathlib.Path(store).parent
    torch.set_num_threads(1)
    dist.init_process_group("gloo", store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    try:
        JOBS[job](rank, world)
    finally:
        dist.destroy_process_group()


def spawn(job, world, tmp_path, timeout):
    """Run ``JOBS[job]`` on ``world`` gloo processes; raise if any fails
    or if they have not all finished within ``timeout`` seconds."""
    ctx = mp.start_processes(_run, args=(world, str(tmp_path / "store"),
                                         job),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=1.0):
        if time.monotonic() > deadline:
            for p in ctx.processes:
                p.kill()
            raise TimeoutError(f"{job} at world size {world}: not done "
                               f"after {timeout} s")
