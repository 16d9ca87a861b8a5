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
from repro_torch.models.params import leaves_with_paths, tree_leaves, \
    tree_map
from repro_torch.training.optimizer import AdamWConfig

OPT = AdamWConfig(warmup_steps=0, total_steps=10)
FLAGS = RunFlags(remat="full")
RTOL = 1e-5


def _batch(cfg, b, s, seed):
    """Tokens and labels [b, s] from seed ``seed``, and for a VLM its
    prefix embeddings [b, n_prefix, d_model], for an encoder-decoder its
    frames [b, source_len, d_model] (unit normals) from the same stream
    after them."""
    rng = np.random.default_rng(seed)
    out = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (b, s))
                               .astype(np.int32))
           for k in ("tokens", "labels")}
    if cfg.n_prefix_embeddings:
        out["prefix_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.n_prefix_embeddings, cfg.d_model)).astype(np.float32))
    if cfg.encoder is not None:
        out["source_embeds"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.encoder.source_len, cfg.d_model)).astype(np.float32))
    return out


# the residual's rows in the tiny train cells: a VLM's tokens are fewer by
# its prefix (reduced internvl2: 4 + 28, so that at model 2 and 4 the
# residual's blocks of 16 and 8 rows are not the tokens' of 14 and 7, and
# the re-blocking moves rows on every rank)
TRAIN_ROWS = 32


def train_len(cfg):
    """The tokens of a tiny train cell of ``cfg``."""
    return TRAIN_ROWS - cfg.n_prefix_embeddings


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


# the sharded train body: the dense decoders (and recurrentgemma-9b's RG-LRU
# and local-attention blocks), the meshes (data, model) of each world
# size, and the variants held against the unsharded step
RG = "recurrentgemma-9b"
WHISPER = "whisper-3-heads"        # ``whisper_variant``
DENSE = ("qwen2-5-7b", "gemma3-1b", "granite-20b", "command-r-35b",
         "internvl2-26b", RG, WHISPER)
# the production arch each of DENSE stands for
ARCH_OF = {WHISPER: "whisper-base"}
MESHES = {2: ((1, 2), (2, 1)), 4: ((2, 2), (1, 4))}
VARIANTS = ("plain", "accum2", "compression")
SCALE_RTOL = 1e-6          # the int8 scales
SCALE_BAND = 2             # x the flipped-channel witness's distance
# the archs whose rank-0 train cases are held against the JAX package's
# ``jit_cell`` too (their whole state saved by the job)
JAX_HELD = ("internvl2-26b", RG, WHISPER)
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


def _recurrent(cfg):
    from repro_torch.models import Mixer
    return any(b.mixer == Mixer.RGLRU for g in cfg.groups for b in g.pattern)


def _channels_flipped(state, specs):
    """``state`` with every "ffn" and "ffn2" dim reversed: the same model
    (the RG-LRU's and the FFN's channels are summed over or taken one by
    one), whose products sum the channels in another order."""
    def flip(t, s):
        for dim, ax in enumerate(s.axes):
            if ax in ("ffn", "ffn2"):
                t = t.flip(dim)
        return t.contiguous()
    return tree_map(flip, state, specs)


def scale_band(cfg, flags, theirs):
    """SCALE_BAND x the largest relative distance between an int8 scale
    of the unsharded compressed step's two steps (``theirs``) and the
    same steps' from the channel-flipped state (``_channels_flipped``: a
    scale is a leaf's max |g|, which the flip does not move, so the
    distance is the step's rounding alone).  Reduced recurrentgemma's
    moved 6.5e-7 so, more than half SCALE_RTOL: the sharded layout sums
    the same products in another order too (its gates' partial sums
    reduced over the ranks)."""
    from repro_torch.launch.steps import make_train_step, train_state_specs
    from repro_torch.training import compression as comp
    real, flipped = comp._quantize, []
    st = _channels_flipped(train_state(cfg, True),
                           train_state_specs(cfg, compression=True))
    step = make_train_step(cfg, OPT, flags, compression=True)
    comp._quantize = _quantized(real, flipped)
    try:
        for i in range(2):
            st, _ = step(st, _batch(cfg, 4, train_len(cfg), 10 + i))
    finally:
        comp._quantize = real
    assert len(flipped) == len(theirs)
    return SCALE_BAND * max(abs(f - w) / abs(w) for (_, f), (_, w) in
                            zip(flipped, theirs))


def _sharded_case(arch, mesh, variant):
    """One train cell of the sharded body against ``make_train_step``,
    two steps: the losses, and each rank's state its blocks; without
    compression the grad norms and every param and moment within rtol
    1e-5; with it each int8 scale within SCALE_RTOL and at most
    CODE_SHARE of the codes off, each by one step (the summation order
    may move a gradient across a rounding edge, and a code one step off
    moves that element's update by a 127th of the leaf's max), while a
    rank's own max |g| (the scale not reduced over the shards) misses
    the scale bound.  A config with RG-LRU blocks holds its scales
    within SCALE_RTOL plus ``scale_band``: its unsharded step's own
    scales move farther than half SCALE_RTOL under another order of
    its sums alone."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_train_step)
    from repro_torch.training import compression as comp
    cfg = reduced(arch)
    seq = train_len(cfg)
    shape = ShapeSpec("tiny_train", "train", seq, 4)
    flags = RunFlags(remat="full", grad_accum=2 if variant == "accum2"
                     else 1)
    packed = variant == "compression"
    assert steps.layout(cfg, shape, mesh, flags) == "sharded"
    step, _ = jit_cell(cfg, shape, mesh, flags, OPT, compression=packed)
    ref = make_train_step(cfg, OPT, flags, compression=packed)
    got, want = train_state(cfg, packed), train_state(cfg, packed)
    mine, theirs = [], []
    saved = {"loss": [], "grad_norm": []}
    real = comp._quantize
    for i in range(2):
        batch = _batch(cfg, 4, seq, 10 + i)
        comp._quantize = _quantized(real, mine)
        try:
            got, gm = step(got, batch)
            comp._quantize = _quantized(real, theirs)
            want, wm = ref(want, batch)
        finally:
            comp._quantize = real
        for k in ("loss",) if packed else ("loss", "grad_norm"):
            saved[k].append(float(gm[k].full_tensor()))
            _close(gm[k].full_tensor(), wm[k], f"{arch} step {i} {k}")
    for key in () if packed else got:
        saved[key] = {}
        for (path, g), (_, w) in zip(leaves_with_paths(got[key]),
                                     leaves_with_paths(want[key])):
            saved[key][path] = g.full_tensor()
            _close(saved[key][path], w, f"{arch} {key}{path}")
    shardings = input_shardings(cfg, shape, mesh)["state"]
    if packed:
        shardings = dict(shardings, ef=shardings["params"])
    _check_blocks(got, shardings, mesh, arch)
    _state_bytes(got, shardings, mesh, arch)
    if arch in JAX_HELD and not packed and dist.get_rank() == 0:
        saved.pop("step")
        torch.save(saved, OUT / f"train.{mesh.shape['data']}x"
                   f"{mesh.shape['model']}-{arch}-{variant}.pt")
    if not packed:
        return
    # the int8 codes and scales, leaf by leaf (the params' order, twice)
    specs = [sh.spec for _, sh in leaves_with_paths(shardings["params"])]
    specs = specs * 2
    assert len(mine) == len(theirs) == len(specs)
    rtol = SCALE_RTOL + (scale_band(cfg, flags, theirs) if _recurrent(cfg)
                         else 0.0)
    off = total = 0
    for (q, sc), (wq, wsc), spec in zip(mine, theirs, specs):
        assert abs(sc - wsc) <= rtol * abs(wsc), (arch, sc, wsc, rtol)
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
            train_state(cfg, True), _batch(cfg, 4, seq, 10))
    finally:
        comp.reduce_over, comp._quantize = reduce_over, real
    missed = any(abs(sc - wsc) > rtol * abs(wsc)
                 for (_, sc), (_, wsc) in zip(own, theirs))
    assert missed, f"{arch}: a rank's own max |g| passes the scale bound"


# planted faults of a VLM's sharded train body (meshes with a "model"
# axis of more than one rank): each rank's residual its own [prefix
# block; token block], its prefix rows dropped for the loss (no
# re-blocking); the loss over the token rows of the residual's blocks,
# the labels cut to match, each rank's mean weighed alike though the
# ranks hold different numbers of tokens
VLM_FAULTS = ("per-rank-concat", "residual-block-loss")


@contextlib.contextmanager
def vlm_fault(name):
    """A planted fault of VLM_FAULTS, patched into ``models/model``."""
    from repro_torch.distributed import sharding
    from repro_torch.models import model
    real_in, real_out, real_xent = model._prefix_in, model._prefix_out, \
        model.softmax_xent

    def per_rank_out(x, n_prefix, seq, tp):
        return x[:, n_prefix // tp.size:]

    rows = {}

    def residual_rows(x, n_prefix, seq, tp):
        lo, hi = tp.index * x.shape[1], (tp.index + 1) * x.shape[1]
        rows["tokens"] = max(lo, n_prefix) - n_prefix, hi - n_prefix
        return x[:, max(n_prefix - lo, 0):]

    def residual_labels(logits, labels, mask=None):
        lo, hi = rows["tokens"]
        whole = sharding.model_shards().concat(labels, 1)
        return real_xent(logits, whole[:, lo:hi], mask)

    if name == "per-rank-concat":
        model._prefix_in = lambda pre, x, tp: torch.cat([pre, x], dim=1)
        model._prefix_out = per_rank_out
    else:
        model._prefix_out = residual_rows
        model.softmax_xent = residual_labels
    try:
        yield
    finally:
        model._prefix_in, model._prefix_out, model.softmax_xent = \
            real_in, real_out, real_xent


# planted faults of the sharded RG-LRU block (meshes with a "model" axis of
# more than one rank): its gates' partial sums used unreduced (each
# rank's own rows' share of its channels); the reduced sums of another
# rank's channels kept; the conv and the scan run on each rank's
# sequence block from a zero state (another recurrence)
RG_FAULTS = ("gates-unreduced", "wrong-block", "blockwise-scan")


@contextlib.contextmanager
def rg_fault(name, size):
    """A planted fault of RG_FAULTS on a "model" axis of ``size`` ranks,
    patched into ``ModelShards.channel_scatter`` or
    ``models/recurrent``."""
    import types

    from repro_torch.distributed.sharding import ModelShards
    from repro_torch.models import recurrent
    real_cs, real_conv, real_ops = ModelShards.channel_scatter, \
        recurrent._conv1d, recurrent.ops

    def unreduced(self, x):
        n = x.shape[-1] // self.size
        return x.narrow(-1, self.index * n, n).contiguous()

    def wrong_block(self, x):
        n = x.shape[-1] // self.size
        whole = self.concat(real_cs(self, x), x.dim() - 1)
        return whole.narrow(-1, (self.index + 1) % self.size * n,
                            n).contiguous()

    def conv(p, u, state=None):
        outs = [real_conv(p, blk) for blk in u.chunk(size, 1)]
        return torch.cat([o for o, _ in outs], 1), outs[-1][1]

    def scan(a, b, h0):
        return torch.cat([real_ops.rglru_scan(x, y, torch.zeros_like(h0))
                          for x, y in zip(a.chunk(size, 1),
                                          b.chunk(size, 1))], 1)

    if name == "gates-unreduced":
        ModelShards.channel_scatter = unreduced
    elif name == "wrong-block":
        ModelShards.channel_scatter = wrong_block
    else:
        recurrent._conv1d = conv
        recurrent.ops = types.SimpleNamespace(rglru_scan=scan)
    try:
        yield
    finally:
        ModelShards.channel_scatter = real_cs
        recurrent._conv1d, recurrent.ops = real_conv, real_ops


# planted faults of an encoder-decoder's sharded train body (meshes with a
# "model" axis of more than one rank): the encoder output's gradient
# all-reduced over "model" where the encoder meets the cross-attention
# (each model rank's gradient of the frames is its decoder rows' part,
# which ``reduce_grads`` already sums for the encoder's replicated
# leaves: summed here too, they count each part "model"-size times); the
# encoder's row-parallel ffn's partial sums all-reduced with no gradient
# collective (the serving body's ``sum``: the rank's ffn columns then
# take their gradient from its own rows' part alone)
ENC_FAULTS = ("enc-grad-reduced", "enc-ffn-sum-no-grad")


class _GradReduced(torch.autograd.Function):
    """``apply(t, group)``: ``t``; its gradient summed over ``group``."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumNoGrad(torch.autograd.Function):
    """``apply(t, group)``: ``t`` summed over ``group``; its gradient as
    it comes."""

    @staticmethod
    def forward(ctx, t, group):
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


@contextlib.contextmanager
def enc_fault(name):
    """A planted fault of ENC_FAULTS, patched into ``models/model`` or
    ``ModelShards.seq_scatter``."""
    from repro_torch.distributed.sharding import ModelShards
    from repro_torch.models import model
    real_enc, real_scatter = model._encode, ModelShards.seq_scatter

    def encode(params, cfg, source, flags, train=False, tp=None):
        out = real_enc(params, cfg, source, flags, train, tp)
        return _GradReduced.apply(out, tp._group(tp.axis))

    def scatter(self, x):
        if self.split_seq or self.size == 1:
            return real_scatter(self, x)
        return _SumNoGrad.apply(x, self._group(self.axis))

    if name == "enc-grad-reduced":
        model._encode = encode
    else:
        ModelShards.seq_scatter = scatter
    try:
        yield
    finally:
        model._encode, ModelShards.seq_scatter = real_enc, real_scatter


def _train_fault_case(arch, mesh, fault):
    """A planted fault (VLM_FAULTS, RG_FAULTS, ENC_FAULTS) must miss: one
    train step's loss or grad norm farther than 10 x rtol from the
    unsharded step's."""
    from repro_torch.launch.steps import ShapeSpec, jit_cell, make_train_step
    cfg = reduced(arch)
    shape = ShapeSpec("tiny_train", "train", train_len(cfg), 4)
    batch = _batch(cfg, 4, train_len(cfg), 10)
    _, wm = make_train_step(cfg, OPT, FLAGS)(train_state(cfg), batch)
    with vlm_fault(fault) if fault in VLM_FAULTS else \
            enc_fault(fault) if fault in ENC_FAULTS else \
            rg_fault(fault, mesh.shape["model"]):
        _, gm = jit_cell(cfg, shape, mesh, FLAGS, OPT)[0](train_state(cfg),
                                                          batch)
    miss = max(abs(float(gm[k].full_tensor()) - float(wm[k]))
               / abs(float(wm[k])) for k in ("loss", "grad_norm"))
    assert miss > 10 * RTOL, f"{fault} passes: {miss}"


def train_faults(arch):
    """The planted train faults of ``arch``: VLM_FAULTS with a prefix,
    RG_FAULTS with RG-LRU blocks, ENC_FAULTS with an encoder."""
    cfg = reduced(arch)
    return VLM_FAULTS if cfg.n_prefix_embeddings else \
        RG_FAULTS if _recurrent(cfg) else \
        ENC_FAULTS if cfg.encoder is not None else ()


def sharded_train(rank, world):
    """Every (mesh, arch, variant) case of MESHES[world] x DENSE x
    VARIANTS, and ``train_faults`` on the meshes whose "model" axis has
    more than one rank; each rank writes its outcome a case to ``OUT /
    sharded_train.<rank>.json`` (the test reads them), rank 0 a JAX_HELD
    arch's train case's losses, grad norms and whole params and moments
    to ``OUT / train.<name>.pt``."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in DENSE:
            faults = train_faults(arch) if model > 1 else ()
            for variant in VARIANTS + faults:
                name = f"{data}x{model}-{arch}-{variant}"
                try:
                    if variant in faults:
                        _train_fault_case(arch, mesh, variant)
                    else:
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
    """Caches of ``specs`` filled from seed ``seed`` (unit normals), the
    KV (or latent) leaves, which have a length, in ``dtype`` and an
    RG-LRU layer's state in its spec's: a decode reads rows written
    before it."""
    rng = np.random.default_rng(seed)
    return tree_map(lambda s: torch.from_numpy(rng.standard_normal(
        s.shape).astype(np.float32)).to(
            dtype if "kv_len" in s.axes else s.dtype), specs)


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
    run's new caches; an RG-LRU layer's float32 state equals it) bit for
    bit, and returns them."""
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
        assert torch.equal(x.to(w.dtype), w), ("witness", path)
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


def _serve_memory(cfg, mesh, dec, rows=SERVE_ROWS, positions=None):
    """A decode step of ``rows`` rows at each of ``positions`` (default:
    ``serve_positions``'s): each rank holds its block of every weight and
    cache leaf, writes its cache in place (the step's caches are the
    ones it was handed, same storage, and it makes no tensor of a
    stacked cache leaf's shape: no restack), and makes no tensor with
    the cache's whole length where its length is split, nor the whole
    table where "model" splits it; an out-of-place writer
    (``slice_scatter`` and a restack, the gathered body's; an RG-LRU
    layer's new state returned, not written) at "decode-last" fails
    those checks."""
    from repro_torch.distributed.sharding import distribute
    from repro_torch.launch.steps import input_shardings, input_specs, \
        jit_cell
    from repro_torch.models import attention, recurrent
    specs = input_specs(cfg, dec)
    sh = input_shardings(cfg, dec, mesh)
    params = tree_map(distribute, _serve_params(cfg, specs["params"]),
                      sh["params"])
    tok = _batch(cfg, rows, 1, 4)["tokens"]
    model = mesh.shape["model"]
    positions = positions or serve_positions(model)
    # the stacked shapes of the leaves with a length (a one-layer stack
    # of an RG-LRU state at one token is the [1, B, W] batch of an
    # einsum's product too; the storage check holds the state)
    stacked = {tuple(block(torch.empty(c.shape, device="meta"), s.spec,
                           mesh).shape)
               for (_, c), (_, s) in zip(leaves_with_paths(specs["caches"]),
                                         leaves_with_paths(sh["caches"]))
               if "kv_len" in c.axes}
    # the first leaf with a length (an RG-LRU layer's state has none)
    kv_sh = next(h for c, h in zip(tree_leaves(specs["caches"]),
                                   tree_leaves(sh["caches"]))
                 if "kv_len" in c.axes)
    kv = kv_sh.spec[2]
    # a K/V row, or the rank's rows of a latent row (a [rows, length]
    # tail alone would match the reduced configs' weights)
    per = rows // math.prod(mesh.shape[a] for a in entry_axes(
        kv_sh.spec[1]))
    tails = [(dec.seq_len, cfg.n_kv_heads, cfg.head_dim_)] if \
        cfg.mla is None else [(per, dec.seq_len, w) for w in (
            cfg.mla.kv_lora_rank, cfg.mla.qk_rope_head_dim)]
    whole = set() if math.prod(mesh.shape[a] for a in entry_axes(kv)) == 1 \
        else set(tails)
    if model > 1:
        whole |= {(cfg.vocab_size, cfg.d_model), (cfg.d_model,
                                                  cfg.vocab_size)}

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
        big = [s for s in seen.shapes if s in stacked or any(
            s[-len(w):] == w for w in whole)]
        return same and not big, big, got

    # every run's collectives before any check raises, so the ranks stay
    # in step
    runs = {pos: run(pos) for pos in positions.values()}
    real = attention._kv_put

    def out_of_place(cache, kv, lo, off):
        first = next(iter(kv))
        t, s = cache[first].shape[1], kv[first].shape[1]
        a, e = max(lo, off), min(lo + t, off + s)
        return {n: torch.slice_scatter(
            cache[n], kv[n][:, a - off:max(e, a) - off].to(cache[n].dtype),
            1, a - lo, max(e, a) - lo) for n in kv}

    real_state = recurrent._state_put
    attention._kv_put = out_of_place
    recurrent._state_put = lambda state, new: {
        n: v.to(state[n].dtype) for n, v in new.items()}
    try:
        fault, _, _ = run(positions["decode-last"])
    finally:
        attention._kv_put, recurrent._state_put = real, real_state
    for pos, (ok, big, got) in runs.items():
        assert ok, (pos, big)
        _state_bytes(got, sh["caches"], mesh, "caches")
    _state_bytes(params, sh["params"], mesh, "params")
    assert not fault, "an out-of-place cache write passes the in-place check"


def whisper_variant(cfg):
    """Reduced whisper-base (``cfg``: the port's or the JAX package's)
    laid out as the full width is on every test mesh: 3 heads and 3 K/V
    heads of 16 dims and 7 frames, which no "model" axis of 2 or 4
    divides (its own 4 heads and 8 frames split there), so that every
    model rank runs all heads and frames and the cross cache splits by
    head dim alone (whisper-base: 8 heads, 1,500 frames on 16)."""
    return dataclasses.replace(
        cfg, name=WHISPER, n_heads=3, n_kv_heads=3, head_dim=16,
        encoder=dataclasses.replace(cfg.encoder, source_len=7))


def minicpm3_variant(cfg):
    """Reduced minicpm3-4b (``cfg``: the port's or the JAX package's)
    laid out as the full width is on every test mesh: 3 MLA heads and
    257 vocab rows, which no "model" axis of 2 or 4 divides (its own 4
    heads and 256 rows split there), so that every model rank runs all
    heads and holds the whole table, while the heads' dims (24 and 16)
    and the ffn (128) split under SERVE_RULES (minicpm3-4b: 40 heads and
    73,448 rows on 16; head dims 96 and 64, ffn 6,400)."""
    return dataclasses.replace(cfg, name=MINICPM3, n_heads=3, n_kv_heads=3,
                               vocab_size=257)


def reduced(name):
    """A reduced config by name: an arch's (``get_reduced``), or
    ``THREE_EXPERTS`` / ``MLA_THREE_EXPERTS``, reduced Mixtral / reduced
    deepseek-v2 with 3 routed experts, or ``WHISPER``
    (``whisper_variant``), or ``MINICPM3`` (``minicpm3_variant``)."""
    if name == WHISPER:
        return whisper_variant(get_reduced("whisper-base"))
    if name == MINICPM3:
        return minicpm3_variant(get_reduced("minicpm3-4b"))
    base = {THREE_EXPERTS: "mixtral-8x22b",
            MLA_THREE_EXPERTS: "deepseek-v2-236b"}.get(name)
    if base is None:
        return get_reduced(name)
    cfg = get_reduced(base)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                            n_experts=3))


def serve_inputs(arch, prefill, dtype, pos=None):
    """A serving case's inputs, the same in every process: (cfg, shape,
    params, first, caches, rest), the step called as ``step(params,
    first, caches, *rest)``: a prompt of PROMPT_LEN tokens into a cache
    of PROMPT_LEN rows, or a token at ``pos`` of a cache of SERVE_LEN
    rows, SERVE_ROWS rows of batch; caches in ``dtype`` from seed 2.  A
    VLM's prompt carries its prefix embeddings too (``_batch``), and its
    prefill cache their rows as well."""
    from repro_torch.launch.steps import ShapeSpec, input_specs
    cfg = reduced(arch)
    shape = ShapeSpec("tiny_prefill", "prefill", PROMPT_LEN, SERVE_ROWS) \
        if prefill else ShapeSpec("tiny_decode", "decode", SERVE_LEN,
                                  SERVE_ROWS)
    specs = input_specs(cfg, shape)
    params = _serve_params(cfg, specs["params"])
    caches = _filled(specs["caches"], 2, dtype)
    if prefill:
        first = _batch(cfg, SERVE_ROWS, PROMPT_LEN, 3)
        first.pop("labels")
        return cfg, shape, params, first, caches, ()
    return (cfg, shape, params, _batch(cfg, SERVE_ROWS, 1, 4)["tokens"],
            caches, (pos,))


def _serve_case(arch, mesh, case, name, flags=RunFlags()):
    """One case of the sharded serving body against ``make_prefill_step``
    / ``make_decode_step`` on the same inputs: the logits and every
    float32 cache leaf within rtol 1e-5 of each leaf's max, a bf16 one
    by ``bf16_close``, each rank's caches its blocks (``SERVE_CASES``; a
    "-bf16" case with a bf16 cache, the rest float32).  Rank 0 saves
    the whole logits and caches (and the bf16 witness) to
    ``OUT / serve.<name>.pt`` for the test's comparison with the JAX
    package.  ``flags``: both steps' ``RunFlags``."""
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
    ref = (make_prefill_step if prefill else make_decode_step)(cfg, flags)
    want, want_c = ref(params, first, tree_map(torch.clone, caches), *rest)
    # the MLA decode on a bf16 cache: held by the weights' band
    merged = cfg.mla is not None and not prefill and \
        dtype == torch.bfloat16
    wide = None if dtype == torch.float32 or merged else bf16_witness(
        ref, params, first, caches, want_c, *rest)
    band = None
    if merged:
        w_log, w_c = mla_weights_witness(ref, params, first, caches, *rest)
        band = {"logits": weights_band(want, w_log), **{
            path: weights_band(w, x) for (path, w), (_, x) in zip(
                leaves_with_paths(want_c), leaves_with_paths(w_c))}}
    got, got_c = jit_cell(cfg, shape, mesh, flags)[0](params, first, caches,
                                                      *rest)
    logits = got.full_tensor()
    whole = {path: g.full_tensor() for path, g in leaves_with_paths(got_c)}
    if merged:
        weights_close(logits, want, band["logits"], f"{arch} {case} logits")
    else:
        _close(logits, want, f"{arch} {case} logits")
    for path, w in leaves_with_paths(want_c):
        if merged:
            weights_close(whole[path], w, band[path],
                          f"{arch} {case} cache{path}")
        elif wide is None or w.dtype == torch.float32:
            _close(whole[path], w, f"{arch} {case} cache{path}")
        else:
            bf16_close(whole[path], w, dict(leaves_with_paths(wide))[path],
                       f"{arch} {case} cache{path}")
    _check_blocks(got_c, input_shardings(cfg, shape, mesh)["caches"], mesh,
                  f"{arch} {case}")
    if dist.get_rank() == 0:
        torch.save({"logits": logits, "caches": whole, "wide": None
                    if wide is None else dict(leaves_with_paths(wide)),
                    "band": band}, OUT / f"serve.{name}.pt")


# a planted fault of a VLM's sharded prefill: the cache written at the
# tokens' positions, without the prefix's shift (the token rows from row
# 0, the prefix rows not written)
PREFIX_FAULT = "prefix-unshifted"


def _prefix_fault_case(arch, mesh):
    """The prefill with PREFIX_FAULT must miss: a cache leaf farther than
    10 x rtol of its max from the unsharded step's."""
    from repro_torch.launch.steps import jit_cell, make_prefill_step
    from repro_torch.models import attention
    cfg, shape, params, first, caches, _ = serve_inputs(arch, True,
                                                        torch.float32)
    _, want = make_prefill_step(cfg)(params, first,
                                     tree_map(torch.clone, caches))
    real, n = attention._kv_put, cfg.n_prefix_embeddings
    attention._kv_put = lambda cache, kv, lo, off: real(
        cache, {k: v[:, n:] for k, v in kv.items()}, lo, off)
    try:
        _, got = jit_cell(cfg, shape, mesh)[0](params, first, caches)
    finally:
        attention._kv_put = real
    miss = max(float((g.full_tensor() - w).abs().max() / w.abs().max())
               for (_, g), (_, w) in zip(leaves_with_paths(got),
                                         leaves_with_paths(want)))
    assert miss > 10 * RTOL, f"{PREFIX_FAULT} passes: {miss}"


# a planted fault of an encoder-decoder's sharded decode (meshes with a
# "model" axis of more than one rank): the cross-attention read from the
# rank's head-dim block of its cache, not gathered whole (the query's
# block of dims scored against it, the outputs' blocks concatenated
# over "model")
CROSS_FAULT = "cross-local"


def serve_faults(arch, model):
    """The planted serving faults of ``arch`` on a "model" axis of
    ``model`` ranks: PREFIX_FAULT with a prefix, CROSS_FAULT with an
    encoder where "model" splits the cross cache's head dim."""
    cfg = reduced(arch)
    return (PREFIX_FAULT,) if cfg.n_prefix_embeddings else \
        (CROSS_FAULT,) if cfg.encoder is not None and model > 1 else ()


def _cross_fault_case(arch, mesh):
    """The decode with CROSS_FAULT must miss: the logits farther than 10
    x rtol of their max from the unsharded step's."""
    from repro_torch.kernels import ops
    from repro_torch.launch.steps import jit_cell, make_decode_step
    from repro_torch.models import attention
    pos = serve_positions(mesh.shape["model"])["decode-last"]
    cfg, shape, params, first, caches, rest = serve_inputs(
        arch, False, torch.float32, pos)
    want, _ = make_decode_step(cfg)(params, first,
                                    tree_map(torch.clone, caches), *rest)
    real = attention.serve_cross_attention

    def local(p, x, kv, *, cfg, cache, off, tp):
        n = kv[0].shape[-1]
        q = tp.dim_block(torch.einsum("bsd,dhk->bshk", x, p["wq"]), n)
        k, v = (t.to(q.dtype).transpose(1, 2) for t in kv)
        length = torch.full((q.shape[0],), k.shape[2], dtype=torch.int32)
        out = tp.concat(ops.decode_attention(q[:, 0], k, v, length), 2)
        return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None], cache

    attention.serve_cross_attention = local
    try:
        got, _ = jit_cell(cfg, shape, mesh)[0](params, first, caches, *rest)
    finally:
        attention.serve_cross_attention = real
    miss = float((got.full_tensor() - want).abs().max() / want.abs().max())
    assert miss > 10 * RTOL, f"{CROSS_FAULT} passes: {miss}"


def sharded_serve(rank, world):
    """Every (mesh, arch, case) of MESHES[world] x DENSE x SERVE_CASES,
    and ``serve_faults``; each rank writes its outcome a case to ``OUT /
    sharded_serve.<rank>.json`` (the test reads them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in DENSE:
            faults = serve_faults(arch, model)
            for case in SERVE_CASES + faults:
                name = f"{data}x{model}-{arch}-{case}"
                try:
                    if case == PREFIX_FAULT:
                        _prefix_fault_case(arch, mesh)
                    elif case == CROSS_FAULT:
                        _cross_fault_case(arch, mesh)
                    else:
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
def serve_big_rules(big=None):
    """``steps.rules_for`` choosing ``big`` (default SERVE_BIG_RULES) for
    every serving cell (TRAIN_RULES for a train cell)."""
    from repro_torch.distributed.sharding import SERVE_BIG_RULES, TRAIN_RULES
    from repro_torch.launch import steps
    big = SERVE_BIG_RULES if big is None else big
    real = steps.rules_for
    steps.rules_for = lambda shape, cfg=None: \
        TRAIN_RULES if shape.kind == "train" else big
    try:
        yield
    finally:
        steps.rules_for = real


def _moe_train_case(cfg, flags, mesh, name):
    """One train case (a MOE_TRAIN or MLA_TRAIN variant's config and
    flags) of the sharded train body against ``make_train_step``, two
    steps from ``train_state`` on ``_batch(cfg, 4, 32, 10 + i)``: the
    losses and grad norms, every param and moment within rtol 1e-5,
    each rank's state its blocks.  Rank 0 saves the losses, grad norms
    and whole params and moments to ``OUT / train.<name>.pt`` for the
    test's comparison with the JAX package."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_train_step)
    arch = name
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
                        _moe_train_case(*moe_train_cfg(arch, case), mesh,
                                        name)
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


# the long-context decode cells (one row, the cache's length split over
# every mesh axis: LONG_SERVE_RULES, and LONG_SERVE_BIG_RULES, which the
# job substitutes for rules_for's choice as ``serve_big_rules`` does):
# reduced gemma3-1b and reduced recurrentgemma (its RG-LRU state split by
# channel over "model", repeated over "data") under the first, reduced
# Mixtral under both; a cache
# of LONG_LEN rows, filled up to the position by the unsharded prefill,
# then two tokens stepped in a row (the second reads the row the first
# wrote in place)
LONG_LEN = 48
LONG = (("gemma3-1b", "long"), ("mixtral-8x22b", "long"),
        ("mixtral-8x22b", "long-big"), (RG, "long"))
LONG_CASES = ("decode-first", "decode-hi-1", "decode-hi", "decode-last",
              "decode-last-bf16", "memory")
# planted faults, each on the meshes where it must show: the partials
# merged over "model" alone (the "data" blocks dropped); the length
# block indexed model-major (the token written to and read from another
# rank's block); the one-block shortcut taken when "model" has one rank
LONG_FAULTS = {"merge-model": ((2, 1), (2, 2)), "model-major": ((2, 2),),
               "model-shortcut": ((2, 1),)}


def long_positions(blocks):
    """The long cases' positions on a cache of LONG_LEN rows cut into
    ``blocks`` length blocks of b rows: in the first block, at the last
    row of block 0 and the first of block 1, and in the last block (the
    reduced window of 8 then straddles two blocks, and some blocks lie
    wholly before it or past the token)."""
    b = LONG_LEN // blocks
    return {"decode-first": 3, "decode-hi-1": b - 1, "decode-hi": b,
            "decode-last": LONG_LEN - 3, "decode-last-bf16": LONG_LEN - 3}


def long_shape():
    from repro_torch.launch.steps import ShapeSpec
    return ShapeSpec("long", "decode", LONG_LEN, 1)


def long_rules(rules):
    """``steps.rules_for`` as it is ("long"), or choosing
    LONG_SERVE_BIG_RULES for every serving cell ("long-big")."""
    from repro_torch.distributed.sharding import LONG_SERVE_BIG_RULES
    return serve_big_rules(LONG_SERVE_BIG_RULES) if rules == "long-big" \
        else contextlib.nullcontext()


def long_inputs(arch, pos, dtype):
    """A long case's inputs, the same in every process: (cfg, params,
    caches, tokens): the weights from seed 0 at the d_model fan-in law,
    caches of LONG_LEN rows in ``dtype`` from seed 2 whose rows [0, pos)
    the unsharded prefill of a ``pos``-token prompt (seed 3) wrote, and
    the two tokens [1, 2] stepped at ``pos`` and ``pos + 1`` (seed 4)."""
    from repro_torch.launch.steps import input_specs, make_prefill_step
    cfg = reduced(arch)
    specs = input_specs(cfg, long_shape())
    params = _serve_params(cfg, specs["params"])
    caches = _filled(specs["caches"], 2, dtype)
    prompt = {"tokens": _batch(cfg, 1, pos, 3)["tokens"]}
    _, caches = make_prefill_step(cfg)(params, prompt, caches)
    return cfg, params, caches, _batch(cfg, 1, 2, 4)["tokens"]


def _long_case(arch, rules, mesh, case, name):
    """One long case of the sharded decode body against
    ``make_decode_step``, two steps in a row from ``long_inputs``: each
    step's logits and every float32 cache leaf within rtol 1e-5 of each
    leaf's max, a bf16 one by ``bf16_close``, each rank's caches its
    blocks.  Rank 0 saves both steps' whole logits and caches (and the
    bf16 witnesses) to ``OUT / long.<name>.pt`` for the test's
    comparison with the JAX package."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (input_shardings, jit_cell,
                                          make_decode_step)
    shape = long_shape()
    blocks = mesh.shape["data"] * mesh.shape["model"]
    with long_rules(rules):
        assert steps.layout(reduced(arch), shape, mesh) == "sharded"
        if case == "memory":
            return _serve_memory(reduced(arch), mesh, shape, 1,
                                 long_positions(blocks))
        dtype = torch.bfloat16 if case.endswith("bf16") else torch.float32
        pos = long_positions(blocks)[case]
        cfg, params, caches, tok = long_inputs(arch, pos, dtype)
        ref = make_decode_step(cfg)
        step, _ = jit_cell(cfg, shape, mesh)
        want_c, got_c, saved = caches, caches, []
        for i in range(2):
            t = tok[:, i:i + 1]
            want, new_c = ref(params, t, tree_map(torch.clone, want_c),
                              pos + i)
            wide = None if dtype == torch.float32 else bf16_witness(
                ref, params, t, want_c, new_c, pos + i)
            want_c = new_c
            got, got_c = step(params, t, got_c, pos + i)
            logits = got.full_tensor()
            # copies: a replicated leaf's full tensor is its local one,
            # which the next step writes in place
            whole = {path: g.full_tensor().clone()
                     for path, g in leaves_with_paths(got_c)}
            label = f"{name} step {i}"
            _close(logits, want, f"{label} logits")
            for path, w in leaves_with_paths(want_c):
                if wide is None or w.dtype == torch.float32:
                    _close(whole[path], w, f"{label} cache{path}")
                else:
                    bf16_close(whole[path], w,
                               dict(leaves_with_paths(wide))[path],
                               f"{label} cache{path}")
            _check_blocks(got_c, input_shardings(cfg, shape, mesh)["caches"],
                          mesh, label)
            saved.append({"logits": logits, "caches": whole,
                          "wide": None if wide is None else
                          dict(leaves_with_paths(wide))})
    if dist.get_rank() == 0:
        torch.save(saved, OUT / f"long.{name}.pt")


def _replaced(fn, *edits):
    """``fn``, a function of ``models/attention``, compiled anew with
    each (old, new) text of its source replaced (a planted fault, or a
    witness's casts)."""
    import inspect
    import textwrap

    from repro_torch.models import attention
    src = textwrap.dedent(inspect.getsource(fn))
    for old, new in edits:
        assert old in src, old
        src = src.replace(old, new)
    scope = dict(vars(attention))
    exec(compile(src, attention.__file__, "exec"), scope)
    return scope[fn.__name__]


def _serve_source(old, new):
    """``attention._serve_attention`` with the text ``old`` of its source
    replaced by ``new`` (a planted fault)."""
    from repro_torch.models import attention
    return _replaced(attention._serve_attention, (old, new))


@contextlib.contextmanager
def long_fault(name):
    """A planted fault of LONG_FAULTS, patched into
    ``distributed/sharding.ServeShards`` or ``models/attention``."""
    from repro_torch.distributed.sharding import ServeShards
    from repro_torch.models import attention
    real_merge, real_rows = ServeShards.merge, ServeShards.kv_rows
    real_attn = attention._serve_attention

    def merge_model(self, out, lse):
        axes = self.kv_axes
        self.kv_axes = tuple(a for a in axes if a == self.axis)
        try:
            return real_merge(self, out, lse)
        finally:
            self.kv_axes = axes

    def model_major(self, n):
        b = n // self.kv_size
        dm = self.mesh.device_mesh
        idx = 0
        for a in reversed(self.kv_axes):
            idx = idx * self.mesh.shape[a] + dm.get_local_rank(a)
        return idx * b, (idx + 1) * b

    if name == "merge-model":
        ServeShards.merge = merge_model
    elif name == "model-major":
        ServeShards.kv_rows = model_major
    else:
        attention._serve_attention = _serve_source(
            "if tp.kv_size == 1:", "if tp.size == 1:")
    try:
        yield
    finally:
        ServeShards.merge, ServeShards.kv_rows = real_merge, real_rows
        attention._serve_attention = real_attn


def _long_fault_case(arch, rules, mesh, fault):
    """A planted fault's miss on this rank: one decode step of the
    sharded body under ``fault`` (at the first row of block 1 for
    "model-major", so the token's row is another rank's; else at
    "decode-last", where the global layers see every block), its logits'
    and caches' largest distance from the unsharded step's over each
    one's max (the test requires the largest over the ranks to exceed
    10 x rtol)."""
    from repro_torch.launch.steps import jit_cell, make_decode_step
    blocks = mesh.shape["data"] * mesh.shape["model"]
    pos = long_positions(blocks)["decode-hi" if fault == "model-major"
                                 else "decode-last"]
    cfg, params, caches, tok = long_inputs(arch, pos, torch.float32)
    want, want_c = make_decode_step(cfg)(params, tok[:, :1],
                                         tree_map(torch.clone, caches), pos)
    with long_rules(rules), long_fault(fault):
        got, got_c = jit_cell(cfg, long_shape(), mesh)[0](
            params, tok[:, :1], caches, pos)

    def miss(g, w):
        return float((g - w).abs().max()) / float(w.abs().max())
    return max([miss(got.full_tensor(), want)] + [
        miss(g.full_tensor(), w) for (_, g), (_, w) in zip(
            leaves_with_paths(got_c), leaves_with_paths(want_c))])


def sharded_long(rank, world):
    """Every (mesh, config, case) of MESHES[world] x LONG x LONG_CASES,
    and the LONG_FAULTS of each mesh; each rank writes its outcome a
    case ("ok", an error, or a fault's miss) to ``OUT /
    sharded_long.<rank>.json`` (the test reads them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch, rules in LONG:
            for case in LONG_CASES:
                name = f"{data}x{model}-{arch}-{rules}-{case}"
                try:
                    _long_case(arch, rules, mesh, case, name)
                    res[name] = "ok"
                except Exception as e:              # noqa: BLE001
                    res[name] = f"{type(e).__name__}: {e}"
            if rules == "long-big" or arch == "gemma3-1b":
                for fault, meshes in LONG_FAULTS.items():
                    if (data, model) in meshes:
                        name = f"{data}x{model}-{arch}-{rules}-{fault}"
                        try:
                            res[name] = _long_fault_case(arch, rules, mesh,
                                                         fault)
                        except Exception as e:      # noqa: BLE001
                            res[name] = f"{type(e).__name__}: {e}"
    (OUT / f"sharded_long.{rank}.json").write_text(json.dumps(res))


# the sharded MLA bodies (deepseek-v2's and minicpm3-4b's cells): reduced
# deepseek-v2, whose 4 MLA heads and 8 routed experts split over "model"
# at 2 and 4 ranks and whose shared expert's ffn splits too,
# MLA_THREE_EXPERTS, whose 3 routed experts do not divide "model", so
# each expert's ffn is split and the routed and shared ffn blocks both
# add before the collective, and MINICPM3 (``minicpm3_variant``), whose
# 3 MLA heads replicate over "model" before a dense FFN
MLA_THREE_EXPERTS = "deepseek-3-experts"
MINICPM3 = "minicpm3-3-heads"
MLA = ("deepseek-v2-236b", MLA_THREE_EXPERTS, MINICPM3)
MLA_CHUNK = 8              # the "chunk8" cases' query chunk: S = 32 in 4
MLA_TRAIN = ("plain", "chunk8")
# serving cases under SERVE_RULES ("serve-", the reduced config's own) and
# SERVE_BIG_RULES ("big-", deepseek-v2-236b's): prefill, decode in the
# first block, at a block's last row and in the last block
# (serve_positions), a prefill chunked by MLA_CHUNK, a bf16 cache's
# prefill, and the in-place, blocks-only memory check (``_serve_memory``)
MLA_SERVE = tuple(f"{r}-{c}" for r in ("serve", "big") for c in (
    "prefill", "decode-first", "decode-hi-1", "decode-last",
    "decode-bf16")) + (
    "big-prefill-chunk8", "big-prefill-bf16", "big-memory")
# planted faults (meshes with a "model" axis of more than one rank): a
# length block past the write frontier merged as a uniform average of
# its rows; the shared experts' partial sums left unreduced; the latent
# cache held whole on every model rank; on a bf16 cache, the first
# again and the blocks' contexts averaged (``ref.decode_merge_faults``'
# "blocks averaged"), each against the weights' bound (``weights_close``)
MLA_FAULTS = ("uniform", "shared-unreduced", "cache-whole", "uniform-bf16",
              "averaged-bf16")


def mla_cases(arch):
    """(cases, faults) of an MLA config: MLA_TRAIN + MLA_SERVE and
    MLA_FAULTS; MINICPM3's serving cases under SERVE_RULES alone (as
    minicpm3-4b takes them) and the faults of a dense MLA model (no
    shared experts)."""
    if arch != MINICPM3:
        return MLA_TRAIN + MLA_SERVE, MLA_FAULTS
    return (MLA_TRAIN + tuple(c for c in MLA_SERVE if c.startswith("serve-")),
            tuple(f for f in MLA_FAULTS if f != "shared-unreduced"))


# the sharded MLA decode on a bf16 cache against the unsharded step: this
# many times the distance the softmax weights' rounding alone puts
# between the unsharded step and its witness (``weights_close``)
WEIGHTS_BAND = 2


def mla_weights_witness(step, params, tok, caches, *rest):
    """The unsharded decode ``step`` of an MLA config on bf16 ``caches``
    with the casts of the merged path (``attention._serve_mla``): the
    absorbed attention's softmax weights kept float32 and its latent
    context rounded to the cache's dtype once, where
    ``attention._mla_absorbed`` (as the JAX package) rounds the weights
    to the cache's dtype first.  Returns its (logits, caches)."""
    from repro_torch.models import attention
    real = attention._mla_absorbed
    attention._mla_absorbed = _replaced(real, (
        'torch.einsum("bhst,btr->bshr", w.to(c_kv.dtype), c_kv)',
        'torch.einsum("bhst,btr->bshr", w, c_kv.float()).to(c_kv.dtype)'))
    try:
        return step(params, tok, tree_map(torch.clone, caches), *rest)
    finally:
        attention._mla_absorbed = real


def weights_band(want, wide):
    """WEIGHTS_BAND x the largest distance between a leaf of the
    unsharded step (``want``) and of its witness (``wide``,
    ``mla_weights_witness``)."""
    return WEIGHTS_BAND * float((wide.float() - want.float()).abs().max())


def weights_close(got, want, band, label):
    """A leaf of the sharded MLA decode on a bf16 cache against the
    unsharded step's: within rtol 1e-5 of the leaf's max plus ``band``
    (``weights_band``).  The merged path keeps the softmax weights
    float32 where the unsharded step rounds them to bf16, and its own
    summation order may put a latent context element, rounded to bf16,
    on the other neighbour: perturbations of the context of the same
    kind, each seen to move a leaf at most 1.12 times as far as the
    weights' rounding alone (reduced deepseek-v2 and its 3-expert
    variant at the test meshes)."""
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    tol = RTOL * float(want.abs().max()) + band
    assert err <= tol, (label, err, tol)


def mla_flags(case):
    """The flags of an MLA case: MLA_CHUNK as the query chunk in a
    "chunk8" case."""
    return RunFlags(remat="full",
                    attn_chunk=MLA_CHUNK if "chunk8" in case else 1024)


def _uniform_partial(q_c, q_rope, block, n, cfg):
    """``attention._mla_partial`` with a planted fault: the block's rows
    past the token masked by ``_softmax_masked`` (a block with none
    visible: a uniform average of its rows) and its log-sum-exp over
    every row."""
    from repro_torch.models import attention
    c_kv, k_rope = block["c_kv"], block["k_rope"]
    scores = attention._mla_scores(q_c, q_rope, c_kv.to(q_c.dtype),
                                   k_rope.to(q_rope.dtype), cfg)
    seen = torch.arange(c_kv.shape[1]) < n
    w = attention._softmax_masked(scores, seen.expand(
        c_kv.shape[0], 1, c_kv.shape[1]))[:, :, 0]
    return (torch.einsum("bht,btr->bhr", w, c_kv.float()),
            torch.logsumexp(scores[:, :, 0], -1))


def _mla_fault_case(arch, mesh, fault):
    """A planted fault must miss: "uniform" a decode step in the first
    block (the later blocks lie past the frontier; its logits),
    "shared-unreduced" a train step (its loss or grad norm), each
    farther than 10 x rtol from the unsharded step's; "cache-whole" (the
    cache's length split over no axis, the body otherwise as it is) the
    check that each rank holds its block of the caches."""
    from repro_torch.launch import steps
    from repro_torch.launch.steps import (ShapeSpec, input_shardings,
                                          jit_cell, make_decode_step,
                                          make_train_step)
    from repro_torch.models import attention, moe
    if fault == "shared-unreduced":
        cfg = reduced(arch)
        real = moe.moe_ffn

        def unreduced(p, x, c, *, tp=None, **kw):
            if tp is None:
                return real(p, x, c, **kw)
            routed = dataclasses.replace(c, moe=dataclasses.replace(
                c.moe, n_shared_experts=0))
            y, aux = real(p, x, routed, tp=tp, **kw)
            return y + tp.own(moe.shared_expert(p, tp.seq_gather(x))), aux
        shape = ShapeSpec("tiny_train", "train", 32, 4)
        batch = _batch(cfg, 4, 32, 10)
        _, wm = make_train_step(cfg, OPT, FLAGS)(train_state(cfg), batch)
        moe.moe_ffn = unreduced
        try:
            _, gm = jit_cell(cfg, shape, mesh, FLAGS, OPT)[0](
                train_state(cfg), batch)
        finally:
            moe.moe_ffn = real
        miss = max(abs(float(gm[k].full_tensor()) - float(wm[k]))
                   / abs(float(wm[k])) for k in ("loss", "grad_norm"))
        assert miss > 10 * RTOL, f"{fault} passes: {miss}"
        return
    pos = serve_positions(mesh.shape["model"])[
        "decode-first" if fault.startswith("uniform") else "decode-last"]
    if fault.endswith("-bf16"):
        return _mla_bf16_fault_case(arch, mesh, fault, pos)
    cfg, shape, params, tok, caches, rest = serve_inputs(
        arch, False, torch.float32, pos)
    if fault == "uniform":
        want, _ = make_decode_step(cfg)(params, tok, tree_map(torch.clone,
                                                              caches), *rest)
        real = attention._mla_partial
        attention._mla_partial = _uniform_partial
        try:
            got, _ = jit_cell(cfg, shape, mesh)[0](params, tok, caches, *rest)
        finally:
            attention._mla_partial = real
        got = got.full_tensor()
        miss = float((got - want).abs().max()) / float(want.abs().max())
        assert miss > 10 * RTOL, f"{fault} passes: {miss}"
        return
    blocks = input_shardings(cfg, shape, mesh)["caches"]
    rules_for, layout = steps.rules_for, steps.layout
    # (k_rope's "hdim" would take "model" once its length does not)
    steps.rules_for = lambda sh, c=None: dict(rules_for(sh, c), kv_len=[],
                                              hdim=[])
    steps.layout = lambda *args, **kw: "sharded"
    try:
        _, got_c = jit_cell(cfg, shape, mesh)[0](params, tok, caches, *rest)
    finally:
        steps.rules_for, steps.layout = rules_for, layout
    try:
        _state_bytes(got_c, blocks, mesh, "caches")
    except AssertionError:
        return
    raise AssertionError(f"{fault} passes the blocks check")


def _averaged(outs, lses, dtype):
    """``ref.decode_merge`` with a planted fault: the mean of the live
    blocks' outputs (``ref.decode_merge_faults``' "blocks averaged")."""
    live = (lses > -math.inf).float()
    return ((outs.float() * live[..., None]).sum(0) /
            live.sum(0).clamp_min(1)[..., None]).to(dtype)


def _mla_bf16_fault_case(arch, mesh, fault, pos):
    """A planted fault of the merged MLA decode on a bf16 cache at
    ``pos`` ("uniform-bf16": ``_uniform_partial``; "averaged-bf16": the
    blocks' contexts averaged, ``_averaged``) must miss the weights'
    band on the logits (``weights_close``)."""
    from repro_torch.kernels import ref
    from repro_torch.launch.steps import jit_cell, make_decode_step
    from repro_torch.models import attention
    cfg, shape, params, tok, caches, rest = serve_inputs(
        arch, False, torch.bfloat16, pos)
    step = make_decode_step(cfg)
    want, _ = step(params, tok, tree_map(torch.clone, caches), *rest)
    band = weights_band(want, mla_weights_witness(step, params, tok,
                                                  caches, *rest)[0])
    real_partial, real_merge = attention._mla_partial, ref.decode_merge
    if fault == "uniform-bf16":
        attention._mla_partial = _uniform_partial
    else:
        ref.decode_merge = _averaged
    try:
        got, _ = jit_cell(cfg, shape, mesh)[0](params, tok, caches, *rest)
    finally:
        attention._mla_partial, ref.decode_merge = real_partial, real_merge
    try:
        weights_close(got.full_tensor(), want, band, fault)
    except AssertionError:
        return
    raise AssertionError(f"{fault} passes the weights' band {band}")


def sharded_mla(rank, world):
    """Every (mesh, config, case) of MESHES[world] x MLA x ``mla_cases``
    (its faults where "model" has more than one rank);
    each rank writes its outcome a case to ``OUT /
    sharded_mla.<rank>.json``, rank 0 a train case's losses, grad norms
    and whole state to ``OUT / train.<name>.pt`` and a serving case's
    whole logits and caches to ``OUT / serve.<name>.pt`` (the test reads
    them)."""
    from repro_torch.launch.mesh import make_host_mesh
    res = {}
    for data, model in MESHES[world]:
        mesh = make_host_mesh(data=data, model=model, device_type="cpu")
        for arch in MLA:
            cases, faults = mla_cases(arch)
            for case in cases + (faults if model > 1 else ()):
                name = f"{data}x{model}-{arch}-{case}"
                try:
                    if case in MLA_TRAIN:
                        _moe_train_case(reduced(arch), mla_flags(case),
                                        mesh, name)
                    elif case in MLA_FAULTS:
                        _mla_fault_case(arch, mesh, case)
                    else:
                        with serve_big_rules() if case.startswith("big-") \
                                else contextlib.nullcontext():
                            _serve_case(arch, mesh, case.split("-", 1)[1],
                                        name, mla_flags(case))
                    res[name] = "ok"
                except Exception as e:              # noqa: BLE001
                    res[name] = f"{type(e).__name__}: {e}"
    (OUT / f"sharded_mla.{rank}.json").write_text(json.dumps(res))


# ``ModelShards.reblock``'s cases: a VLM's inputs to its residual's
# blocks and back (``models/model._prefix_rows``: 8 prefix rows and 40
# tokens), random runs of 37 rows (a rank's rows in up to three runs),
# and a rank that holds no row before or after
REBLOCK_CASES = ("prefix-in", "prefix-out", "random-0", "random-1",
                 "empty-rank")


def _random_rows(n, size, rng):
    """``n`` rows cut into runs at random and dealt to ``size`` ranks (a
    rank's runs ascending): every row on one rank."""
    cuts = np.sort(rng.choice(np.arange(1, n), 3 * size - 1, replace=False))
    edges = [0, *map(int, cuts), n]
    runs = [(a, b) for a, b in zip(edges[:-1], edges[1:])]
    owner = rng.permutation(np.arange(len(runs)) % size)
    return [tuple(r for r, o in zip(runs, owner) if o == k)
            for k in range(size)]


def _reblock_rows(case, size):
    """(rows of the sequence, src, dst) of a REBLOCK_CASES case."""
    from repro_torch.models.model import _prefix_rows
    if case.startswith("prefix"):
        held, residual, tokens = _prefix_rows(8, 40, size)
        if case == "prefix-in":
            return 48, held, residual
        own = [tuple((max(a, 8), max(b, 8)) for a, b in r)
               for r in residual]
        return 48, own, tokens
    if case == "empty-rank":
        src = [((0, 10),), ((10, 37),)] + [()] * (size - 2)
        dst = [()] + [((0, 37),)] + [()] * (size - 2)
        return 37, src, dst
    rng = np.random.default_rng(int(case[-1]) + 10 * size)
    return 37, _random_rows(37, size, rng), _random_rows(37, size, rng)


def _reblock_case(mesh, case):
    """``reblock`` of a [2, rows, 3] float64 sequence (each rank its
    ``src`` rows) against the rows ``dst`` names, exactly; its gradient
    (of the sum of the result times a second sequence's ``dst`` rows)
    the second sequence's ``src`` rows, exactly; one all-to-all each
    way."""
    from torch.distributed.tensor.debug import CommDebugMode

    from repro_torch.distributed.sharding import ModelShards
    tp = ModelShards(mesh, {})
    n, src, dst = _reblock_rows(case, tp.size)
    rng = np.random.default_rng(7)
    full, weight = (torch.from_numpy(rng.standard_normal((2, n, 3)))
                    for _ in range(2))

    def rows(t, runs):
        return torch.cat([t[:, a:b] for a, b in runs], 1) if runs \
            else t[:, :0]

    x = rows(full, src[tp.index]).requires_grad_()
    with CommDebugMode() as comm:
        y = tp.reblock(x, src, dst)
        (y * rows(weight, dst[tp.index])).sum().backward()
    assert torch.equal(y.detach(), rows(full, dst[tp.index])), case
    assert torch.equal(x.grad, rows(weight, src[tp.index])), case
    counts = {str(k): v for k, v in comm.get_comm_counts().items()}
    assert counts == {"c10d.alltoall_base_": 2}, counts


def reblock(rank, world):
    """Every REBLOCK_CASES case on a {model: world} mesh; each rank
    writes its outcome a case to ``OUT / reblock.<rank>.json``."""
    from repro_torch.launch.mesh import make_host_mesh
    mesh = make_host_mesh(data=1, model=world, device_type="cpu")
    res = {}
    for case in REBLOCK_CASES:
        try:
            _reblock_case(mesh, case)
            res[case] = "ok"
        except Exception as e:                      # noqa: BLE001
            res[case] = f"{type(e).__name__}: {e}"
    (OUT / f"reblock.{rank}.json").write_text(json.dumps(res))


JOBS = {"sharded_steps": sharded_steps,
        "reblock": reblock,
        "pipeline_two_stages": pipeline_two_stages,
        "sharded_train": sharded_train,
        "sharded_serve": sharded_serve,
        "sharded_moe": sharded_moe,
        "sharded_long": sharded_long,
        "sharded_mla": sharded_mla}
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
