"""Logical-axis -> mesh-axis sharding rules (the reference's
``repro/distributed/sharding.py``), resolved onto DTensor placements.

A *rule set* maps each logical axis name (``models/params.py`` specs) to
an ordered list of candidate mesh-axis tuples.  ``partition_spec``
picks, per tensor dimension, the first candidate whose mesh axes (a)
all exist in the mesh, (b) evenly divide the dimension, and (c) are not
already used by another dimension of the same tensor.  Unsatisfiable
dims replicate.  The five rule sets and the resolution are the
reference's, unchanged: ``partition_spec`` gives the same entries as the
reference's ``PartitionSpec``, compared as tuples.

Rule sets:
  * TRAIN_RULES: FSDP on the "embed" axis over data (ZeRO-style weight
    gathering) + tensor/expert parallel over "model"; batch over
    (pod, data).
  * SERVE_RULES: weights replicated over data, TP/EP over "model";
    KV-cache length over "model".
  * LONG_SERVE_RULES: batch=1 long-context decode -- cache length sharded
    over (data, model).
  * SERVE_BIG_RULES / LONG_SERVE_BIG_RULES: the serve rules with "embed"
    over data, for archs whose weights cannot replicate over data.

A spec becomes DTensor placements over a ``DeviceMesh`` (``Mesh`` wraps
one with the reference's view: ``axis_names`` and ``shape`` as a
name -> size mapping): for each mesh dimension, ``Shard(i)`` when tensor
dimension ``i`` names that mesh axis, else ``Replicate()``.  A tuple
entry such as ``("pod", "data")`` shards one tensor dimension over
several mesh dimensions; DTensor splits them in mesh-dimension order and
the reference major to minor, so a tuple must follow the mesh's axis
order (``placements`` raises otherwise), and then each rank's block is
the one the reference's spec assigns it.

``shard_hint`` is the reference's activation constraint: an exact no-op
outside ``activation_sharding`` and on a plain tensor; inside it a
DTensor is redistributed to the rule's placements.  ``BatchShards``
(set by ``data_parallel``, read by ``batch_shards``) tells the loss and
the MoE router, inside a sharded step body, that each rank holds a
block of the batch's tokens, so that they compute their share of the
global batch's statistics (``launch/steps.jit_cell``).

``ModelShards`` (set by ``model_parallel``, read by ``model_shards``)
is the "model" axis inside the sharded train body, where each rank
computes on its blocks of the state as ``TRAIN_RULES`` lays them out.
It gathers a layer's weights over their FSDP axes ("data") and, where
a product needs a weight whole (the embedding, the head), over every
axis; it gathers the residual's sequence before the column-parallel
products and reduce-scatters it after the row-parallel ones (Megatron
sequence parallelism), and reduce-scatters a product's partial sums
along its channels where the rank's channels need every rank's rows of
a weight (``channel_scatter``: the RG-LRU's gates).  The collectives
carry their gradients (an
all-gather's is a reduce-scatter, and back), so a gathered weight's
gradient returns to its block by a reduce-scatter; ``reduce_grads``
then sums each gradient over the axes its leaf is replicated over,
where each rank computed a part of it.  ``reblock`` moves rows of a
sequence between two block layouts by one uneven all-to-all (a VLM's
residual, whose blocks are the concatenated [prefix; tokens]
sequence's, not the tokens').  ``replicated`` is the same view of a
subtree of the params (an encoder's) with the residual replicated over
"model" (whisper-base's 1,500 frames, which 16 ranks do not split): its
sequence ops keep every row and a row-parallel product's partial sums
end in an all-reduce whose gradient is an all-reduce too (each rank
holds a part of the replicated residual's gradient; the sum is the
whole).
Inside that body the model's tensors are plain local tensors and
``shard_hint`` leaves them as they are: the hint sites' layouts are the
body's own (the residual split by rows and sequence, the logits of the
local tokens).

``ServeShards``, a ``ModelShards`` over the params' specs under a
serving rule set, is the "model" axis inside the sharded serving body
(the prefill and decode cells of a decoder of attention, MLA or RG-LRU
blocks with dense or MoE FFNs, or of an encoder-decoder, and such a
decoder's one-row decode under the long rules).  The
residual is replicated over "model" there (``"seq": []``), so its
sequence "gather" is the residual itself and its "reduce-scatter" an
all-reduce: each row-parallel product's partial sums summed over the
axis.  A layer's weights split by head dim
(``"hdim"``: the heads do not divide the axis) or by K/V head are
gathered whole, since rope pairs dims i and i + D/2 and every rank
writes every K/V head of its cache rows; every rank then runs those
heads, GSPMD's redundancy for such a dim.  Under ``SERVE_BIG_RULES``
each weight is also gathered over its other axes ("embed" over "data")
inside its layer, as the train body's FSDP gathers; under
``SERVE_RULES`` no weight is split over them and nothing more is
gathered.  The KV cache's length is split over its own axes
(``kv_axes``, as the cache's spec names them): "model" under
SERVE_RULES, every mesh axis under the long rules (one row, which
splits over none).  Each rank holds the block ``kv_rows(T)`` of the
length, numbered major to minor over those axes as DTensor lays a
dimension split over several mesh dims out, and writes it in place;
``merge`` combines the partial decode attention (or MLA's latent
context) of every length block by their log-sum-exps
(``ref.decode_merge``), in block order.  A cross-attention cache whose
length and K/V heads do not split (whisper-base's) is split by head dim
over "model": each rank writes its block of the dims (``dim_block``)
and a decode step gathers them whole (``dim_whole``).
"""
from __future__ import annotations

import contextlib
import contextvars
import copy
import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.kernels import ref
from repro_torch.models.params import ParamSpec, tree_map

Tree = Any
Candidate = Tuple[str, ...]
RuleSet = Dict[str, List[Candidate]]

TRAIN_RULES: RuleSet = {
    "batch": [("pod", "data"), ("data",)],
    "embed": [("data",)],                 # FSDP / ZeRO weight sharding
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "ffn": [("model",)],
    "experts": [("model",)],
    "vocab": [("model",)],
    "lora": [],
    "layers": [],
    "hdim": [], "hdim2": [], "ffn2": [], "conv": [],
    "kv_len": [],
    # sequence parallelism for residual activations (block-boundary hint
    # ("batch", "seq", None))
    "seq": [("model",)],
}

SERVE_RULES: RuleSet = {
    "batch": [("pod", "data"), ("data",)],
    "embed": [],                          # replicate over data for decode
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "ffn": [("model",)],
    "experts": [("model",)],
    "vocab": [("model",)],
    "lora": [],
    "layers": [],
    # hdim shards W_k/W_v over "model" when kv_heads cannot -- caches are
    # unaffected (their kv_len takes "model" first)
    "hdim": [("model",)], "hdim2": [], "ffn2": [], "conv": [],
    "kv_len": [("model",)],               # cache length over model axis
    "seq": [],
}

LONG_SERVE_RULES: RuleSet = dict(
    SERVE_RULES,
    kv_len=[("pod", "data", "model"), ("data", "model"), ("model",)],
)

# archs too big to replicate their weights over the data axis at serve
# time shard the "embed" dim over data too
SERVE_BIG_RULES: RuleSet = dict(SERVE_RULES, embed=[("data",)])
LONG_SERVE_BIG_RULES: RuleSet = dict(LONG_SERVE_RULES, embed=[("data",)])


class PartitionSpec(tuple):
    """One entry a tensor dimension: ``None`` (replicated), a mesh axis
    name, or a tuple of names (the dimension split over several axes,
    major to minor).  Equal, as a tuple, to the reference's spec."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


class Mesh:
    """A ``DeviceMesh`` seen as the reference sees its mesh: ``axis_names``
    and ``shape`` (axis name -> size)."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names,
                                              device_mesh.shape))

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_mesh.device_type!r})"


def partition_spec(axes: Sequence[Optional[str]], shape: Sequence[int],
                   rules: RuleSet, mesh: Any) -> PartitionSpec:
    """``mesh``: anything with ``axis_names`` and ``shape`` (a name ->
    size mapping)."""
    taken: set = set()
    parts: List[Optional[Any]] = []
    for dim, ax in zip(shape, axes):
        chosen = None
        for cand in (rules.get(ax) or []) if ax else []:
            if not all(a in mesh.axis_names for a in cand):
                continue
            size = math.prod(mesh.shape[a] for a in cand)
            if size <= 1 or dim % size != 0:
                continue
            if any(a in taken for a in cand):
                continue
            chosen = cand
            taken.update(cand)
            break
        if chosen is None:
            parts.append(None)
        elif len(chosen) == 1:
            parts.append(chosen[0])
        else:
            parts.append(chosen)
    return PartitionSpec(*parts)


def entry_axes(entry) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major to minor."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh: Mesh) -> Tuple[Any, ...]:
    """DTensor placements of ``spec`` over ``mesh``'s dimensions."""
    out: List[Any] = [Replicate()] * len(mesh.axis_names)
    for dim, entry in enumerate(spec):
        names = entry_axes(entry)
        idx = [mesh.axis_names.index(a) for a in names]
        if idx != sorted(idx):
            raise ValueError(
                f"spec entry {entry!r} does not follow the mesh's axis order "
                f"{mesh.axis_names}: DTensor would split it in another order "
                f"than the spec assigns")
        for i in idx:
            out[i] = Shard(dim)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (the reference's ``NamedSharding``)."""
    mesh: Mesh
    spec: PartitionSpec

    @property
    def placements(self) -> Tuple[Any, ...]:
        return placements(self.spec, self.mesh)


def shardings_for_specs(spec_tree: Tree, rules: RuleSet, mesh: Mesh) -> Tree:
    """NamedSharding tree from a ParamSpec tree (params, caches)."""
    def one(s: ParamSpec) -> NamedSharding:
        return NamedSharding(mesh, partition_spec(s.axes, s.shape, rules,
                                                  mesh))
    return tree_map(one, spec_tree)


def shardings_for_tree(axes_tree: Tree, abstract_tree: Tree, rules: RuleSet,
                       mesh: Mesh) -> Tree:
    """NamedSharding tree for ad-hoc trees: ``axes_tree`` mirrors
    ``abstract_tree`` with tuples of logical axis names as leaves."""
    def one(axes, arr):
        return NamedSharding(mesh, partition_spec(axes, arr.shape, rules,
                                                  mesh))
    return tree_map(one, axes_tree, abstract_tree)


def distribute(x: Any, sharding: NamedSharding) -> DTensor:
    """``x`` laid out as ``sharding`` says.  A plain tensor (or number) is
    taken as the global value, the same on every rank, and each rank
    keeps its block (no communication); a DTensor is redistributed, or
    returned as it is where it is laid out so already (a donated input
    is then written in place)."""
    dm = sharding.mesh.device_mesh
    if isinstance(x, DTensor):
        if x.device_mesh == dm and \
                tuple(x.placements) == tuple(sharding.placements):
            return x
        return x.redistribute(dm, sharding.placements)
    x = torch.as_tensor(x, device=dm.device_type)
    full = DTensor.from_local(x, dm, [Replicate()] * dm.ndim,
                              run_check=False)
    return full.redistribute(dm, sharding.placements)


def gather(x: Any) -> Any:
    """The global value of a DTensor as a plain tensor; anything else as
    it is."""
    return x.full_tensor() if isinstance(x, DTensor) else x


# ---------------------------------------------------------------------------
# Activation sharding hints.
#
# The reference anchors activations with with_sharding_constraint at block
# boundaries so GSPMD all-gathers weights and keeps activations sharded.
# The hints are no-ops outside ``activation_sharding``.
# ---------------------------------------------------------------------------

_ACT_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "activation_sharding", default=None)


@contextlib.contextmanager
def activation_sharding(mesh: Mesh, rules: RuleSet):
    tok = _ACT_CTX.set((mesh, rules))
    try:
        yield
    finally:
        _ACT_CTX.reset(tok)


def shard_hint(x: torch.Tensor, axes: Sequence[Optional[str]]
               ) -> torch.Tensor:
    """Constrain ``x``'s sharding per the active rule set.  A no-op if
    none is active, or if ``x`` is a plain tensor: inside a sharded step
    body every tensor is a rank's local block, laid out by the body
    itself (``ModelShards``), and is returned as it is."""
    ctx = _ACT_CTX.get()
    if ctx is None or not isinstance(x, DTensor):
        return x
    mesh, rules = ctx
    ps = partition_spec(axes, x.shape, rules, mesh)
    return x.redistribute(mesh.device_mesh, placements(ps, mesh))


# ---------------------------------------------------------------------------
# The batch split over data ranks inside a sharded step body.
# ---------------------------------------------------------------------------

class BatchShards:
    """The mesh axes a step's batch rows are split over (major to minor):
    this rank holds block ``index`` of ``size`` equal blocks.  In the
    sharded train body the axes are the rows' and the sequence's
    ("model" last): the loss's statistics are then over every token."""

    def __init__(self, mesh: Mesh, axes: Sequence[str]):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = math.prod(mesh.shape[a] for a in self.axes)
        dm = mesh.device_mesh
        index = 0
        for a in self.axes:
            index = index * mesh.shape[a] + dm.get_local_rank(a)
        self.index = index

    def without(self, axis: str) -> Optional["BatchShards"]:
        """The split over the same axes but ``axis`` (None if no axis is
        left): the tokens' blocks once they are gathered over ``axis``."""
        axes = tuple(a for a in self.axes if a != axis)
        return BatchShards(self.mesh, axes) if axes else None

    def sum(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` summed over the batch's ranks, in place."""
        for a in self.axes:
            dist.all_reduce(t, group=self.mesh.device_mesh.get_group(a))
        return t

    def rows(self, x: torch.Tensor, dim: int = 0, groups: int = 1
             ) -> torch.Tensor:
        """This rank's rows of the global ``x`` along ``dim``: of each of
        ``groups`` equal runs of rows (gradient accumulation's
        microbatches), its block."""
        n = x.shape[dim]
        if n % (groups * self.size):
            raise ValueError(f"{n} rows do not split into {groups} x "
                             f"{self.size} equal blocks")
        v = x.reshape(x.shape[:dim] + (groups, n // groups)
                      + x.shape[dim + 1:])
        b = n // (groups * self.size)
        v = v.narrow(dim + 1, self.index * b, b)
        return v.reshape(x.shape[:dim] + (groups * b,) + x.shape[dim + 1:])


_BATCH_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "batch_shards", default=None)


@contextlib.contextmanager
def data_parallel(shards: Optional[BatchShards]):
    tok = _BATCH_CTX.set(shards)
    try:
        yield
    finally:
        _BATCH_CTX.reset(tok)


def batch_shards() -> Optional[BatchShards]:
    """The active ``BatchShards`` (None outside a sharded step body)."""
    return _BATCH_CTX.get()


# ---------------------------------------------------------------------------
# The "model" axis and the FSDP gathers inside the sharded train body.
# ---------------------------------------------------------------------------

# The collectives of the sharded body are blocking c10d calls inside
# autograd functions: the all-gather's gradient is a reduce-scatter and
# the reduce-scatter's an all-gather.  (The asynchronous autograd
# collectives of ``_functional_collectives`` on gloo corrupted the heap
# in one of four runs of the CPU tests, and waiting on their results at
# once gave a second microbatch a gradient read before its reduce-scatter
# was done.)  A dim other than 0 travels as dim 0 of a contiguous copy.
# (``all_gather_single`` / ``reduce_scatter_single`` are the newer names
# of ``all_gather_into_tensor`` / ``reduce_scatter_tensor``.)
_ALL_GATHER = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((dist.get_world_size(group) * x.shape[0],)
                      + tuple(x.shape[1:]))
    _ALL_GATHER(out, x, group=group)
    return out.movedim(0, dim)


def _scatter(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = t.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group),)
                      + tuple(x.shape[1:]))
    _REDUCE_SCATTER(out, x, group=group)
    return out.movedim(0, dim)


class _AllGather(torch.autograd.Function):
    """``apply(t, dim, group)``: ``t`` concatenated along ``dim`` over
    ``group``'s ranks; the gradient goes back by a reduce-scatter."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _gather(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.dim, ctx.group), None, None


class _ReduceScatter(torch.autograd.Function):
    """``apply(t, dim, group)``: ``t`` summed over ``group``'s ranks,
    each keeping its block along ``dim``; the gradient goes back by an
    all-gather."""

    @staticmethod
    def forward(ctx, t, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter(t, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


Rows = Sequence[Tuple[int, int]]


def _runs(have: Rows, want: Rows) -> List[Tuple[int, int]]:
    """The rows in both ``have`` and ``want`` (each [lo, hi) runs of a
    sequence's rows, ascending) as [lo, hi) runs, ascending."""
    return sorted((max(a, c), min(b, d)) for a, b in have for c, d in want
                  if max(a, c) < min(b, d))


def _place(rows: Rows, i: int) -> int:
    """The place of row ``i`` in a block that holds ``rows`` in order."""
    n = 0
    for a, b in rows:
        if a <= i < b:
            return n + i - a
        n += b - a
    raise ValueError(f"row {i} is not in {list(rows)}")


def _count(rows: Rows) -> int:
    return sum(b - a for a, b in rows)


def _taken(x: torch.Tensor, rows: Rows, runs: Rows) -> torch.Tensor:
    """The rows of ``runs`` of ``x`` (dim 0; ``x`` holds ``rows``), in
    run order, as one contiguous tensor."""
    parts = [x.narrow(0, _place(rows, a), b - a) for a, b in runs]
    return torch.cat(parts) if parts else \
        x.new_empty((0,) + tuple(x.shape[1:]))


def _laid(buf: torch.Tensor, runs: Rows, rows: Rows) -> torch.Tensor:
    """``buf`` (dim 0: the rows of ``runs``, in run order) laid out as
    ``rows``, which the runs cover once each; ``buf`` itself where it
    is so already."""
    if _count(runs) != _count(rows):
        raise ValueError(f"{list(runs)} do not cover {list(rows)}")
    starts = [0]
    for a, b in runs:
        starts.append(starts[-1] + b - a)
    order = sorted(range(len(runs)), key=lambda i: _place(rows, runs[i][0]))
    if order == list(range(len(runs))):
        return buf
    return torch.cat([buf.narrow(0, starts[i], runs[i][1] - runs[i][0])
                      for i in order])


class _Reblock(torch.autograd.Function):
    """``apply(x, dim, group, index, src, dst)``: ``x`` holds, along
    ``dim``, the rows ``src[index]`` of a sequence (rank ``index`` of
    ``group``); the result holds ``dst[index]``, each row sent to the
    rank whose ``dst`` block holds it by one uneven all-to-all (a blocking
    c10d call, as the gathers are); the gradient goes back by the reverse
    exchange."""

    @staticmethod
    def _exchange(x, dim, group, have, give, got, mine):
        """Send this rank's rows ``have`` (of ``x``) to each peer as
        ``give[peer]`` says; receive ``got[peer]`` from each; lay them
        out as ``mine``."""
        xm = x.movedim(dim, 0)
        send = _taken(xm, have, [r for runs in give for r in runs])
        out = xm.new_empty((sum(_count(r) for r in got),) + xm.shape[1:])
        dist.all_to_all_single(out, send, [_count(r) for r in got],
                               [_count(r) for r in give], group=group)
        return _laid(out, [r for runs in got for r in runs],
                     mine).movedim(0, dim)

    @staticmethod
    def forward(ctx, x, dim, group, index, src, dst):
        size = len(src)
        ctx.dim, ctx.group = dim, group
        ctx.src, ctx.dst = src[index], dst[index]
        ctx.give = [_runs(src[index], dst[q]) for q in range(size)]
        ctx.got = [_runs(src[r], dst[index]) for r in range(size)]
        return _Reblock._exchange(x, dim, group, ctx.src, ctx.give,
                                  ctx.got, ctx.dst)

    @staticmethod
    def backward(ctx, g):
        return _Reblock._exchange(g, ctx.dim, ctx.group, ctx.dst, ctx.got,
                                  ctx.give, ctx.src), \
            None, None, None, None, None


class _AllReduce(torch.autograd.Function):
    """``apply(t, group)``: ``t`` summed over ``group``'s ranks, in place;
    the gradient summed over them too, in a copy (the output is a
    residual replicated over the group, whose gradient each rank holds a
    part of: the sum of the parts is the whole, which each rank's block
    of a weight before the sum needs; the incoming gradient is also the
    residual's skip branch's, which keeps its part)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        ctx.mark_dirty(t)
        dist.all_reduce(t, group=group)
        return t

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX}


def reduce_over(t: torch.Tensor, groups: Sequence[Any], op: str = "sum"
                ) -> torch.Tensor:
    """``t`` reduced by ``op`` ("sum" or "max") over each process group
    of ``groups`` in turn, in place (no gradient); ``t`` itself when
    there are none."""
    for g in groups:
        dist.all_reduce(t, op=_OPS[op], group=g)
    return t


def _at(tree: Tree, path: Sequence[str]) -> Tree:
    for k in path:
        tree = tree[k]
    return tree


class ModelShards:
    """The sharded train body's view of its mesh (module docstring):
    ``axis`` ("model") of ``size`` ranks, this rank ``index`` of them,
    and ``specs``, the params' tree of ``PartitionSpec``s under
    ``TRAIN_RULES``, by which each weight is gathered.  ``split_seq``:
    the residual is split by sequence over the axis (the train body's
    decoder), or replicated over it (``replicated``: an encoder's
    frames, which no rank splits; the serving body).  An axis of size
    1 takes no collective, so at world size 1 the body's arithmetic is
    the unsharded step's, op for op."""

    def __init__(self, mesh: Mesh, specs: Tree, axis: str = "model"):
        self.mesh, self.specs, self.axis = mesh, specs, axis
        self.size = mesh.shape.get(axis, 1)
        self.index = mesh.device_mesh.get_local_rank(axis) \
            if self.size > 1 else 0
        # the leaves ``layer`` gathers whole, over the axis too (none here)
        self.wholes = tree_map(lambda s: False, specs)
        self.split_seq = True

    def replicated(self, *path: str) -> "ModelShards":
        """This view of the params' subtree at ``path`` (``specs`` and
        ``wholes`` taken there) with the residual replicated over the
        axis: the sequence ops keep every row, and a row-parallel
        product's partial sums end in an all-reduce whose gradient is an
        all-reduce too (``_AllReduce``; the serving body's ``sum``).
        ``layer`` and ``fsdp`` gather as they do."""
        view = copy.copy(self)
        view.specs, view.wholes = _at(self.specs, path), \
            _at(self.wholes, path)
        view.split_seq = False
        return view

    def _group(self, axis: str):
        return self.mesh.device_mesh.get_group(axis)

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of ``n`` rows."""
        b = n // self.size
        return self.index * b, (self.index + 1) * b

    def seq_rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): the rows of a sequence of ``n`` the residual holds
        here (this rank's block; all of them where it is replicated)."""
        return self.rows(n) if self.split_seq else (0, n)

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S / size, ...] -> [B, S, ...]: the ranks' sequence blocks
        in order (before a column-parallel product); a replicated
        residual as it is."""
        if self.size == 1 or not self.split_seq:
            return x
        return _AllGather.apply(x, 1, self._group(self.axis))

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, ...] partial sums -> [B, S / size, ...]: summed over
        the ranks, this rank's sequence block kept (after a row-parallel
        product); for a replicated residual summed over the ranks, the
        gradient too (``_AllReduce``)."""
        if self.size == 1:
            return x
        if not self.split_seq:
            return _AllReduce.apply(x, self._group(self.axis))
        return _ReduceScatter.apply(x, 1, self._group(self.axis))

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, ...] computed whole on every rank -> the residual's rows
        of it (this rank's sequence block, or all of them)."""
        if self.size == 1 or not self.split_seq:
            return x
        lo, hi = self.rows(x.shape[1])
        return x[:, lo:hi]

    def channel_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """[..., W] partial sums -> [..., W / size], contiguous: summed
        over the ranks, this rank's block of the last dim kept (a product
        of the rank's channels against its rows of a [W, W] weight, for
        its own channels; one reduce-scatter over the axis, an all-gather
        in the backward)."""
        if self.size == 1:
            return x
        return _ReduceScatter.apply(x, x.dim() - 1,
                                    self._group(self.axis)).contiguous()

    def concat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks ``x`` concatenated along ``dim``, in rank
        order (the gradient goes back by a reduce-scatter)."""
        if self.size == 1:
            return x
        return _AllGather.apply(x, dim, self._group(self.axis))

    def reblock(self, x: torch.Tensor, src: Sequence[Rows],
                dst: Sequence[Rows], dim: int = 1) -> torch.Tensor:
        """``x``, which holds along ``dim`` the rows ``src[index]`` of a
        sequence ([lo, hi) runs, ascending: ``src`` and ``dst`` give every
        rank's of the axis), re-blocked to hold ``dst[index]``: each row
        goes to the rank whose ``dst`` block holds it, by one uneven
        all-to-all over the axis (the reverse exchange in the backward).
        No rank holds more than its own rows.  One rank holds every row
        in order, and ``x`` is returned as it is."""
        if self.size == 1:
            return x
        return _Reblock.apply(x, dim, self._group(self.axis), self.index,
                              src, dst)

    def gather(self, t: torch.Tensor, spec: Sequence, whole: bool = False
               ) -> torch.Tensor:
        """A weight's local block gathered over the axes of ``spec``
        other than ``axis`` (FSDP), or over all of them (``whole``).  A
        dimension split over several axes is gathered minor axis first,
        so the blocks land in the spec's major-to-minor order."""
        for dim, entry in enumerate(spec):
            for a in reversed(entry_axes(entry)):
                if (a != self.axis or whole) and self.mesh.shape[a] > 1:
                    t = _AllGather.apply(t, dim, self._group(a))
        return t

    def whole(self, params: Tree, *path: str) -> torch.Tensor:
        """The leaf at ``path`` of ``params`` gathered whole."""
        return self.gather(_at(params, path), _at(self.specs, path),
                           whole=True)

    def fsdp(self, params: Tree, *path: str) -> Tree:
        """The subtree at ``path`` of ``params``, each leaf gathered over
        its FSDP axes."""
        return tree_map(self.gather, _at(params, path),
                        _at(self.specs, path))

    def layer(self, tree: Tree, *path: str) -> Tree:
        """One layer's slice of the stacked subtree at ``path`` (its
        leaves' local blocks, the "layers" dim taken), gathered over its
        FSDP axes: the per-layer gather, inside the layer's checkpoint,
        so the recompute gathers it again and nothing holds it between
        layers.  A leaf of ``wholes`` is gathered whole."""
        return tree_map(lambda t, s, w: self.gather(t, s[1:], whole=w),
                        tree, _at(self.specs, path), _at(self.wholes, path))

    def _axes(self, spec: Sequence, used: bool) -> List[Any]:
        """The groups of the mesh axes (of more than one rank) that
        ``spec`` uses, or that it does not."""
        mine = {a for e in spec for a in entry_axes(e)}
        return [self._group(a) for a in self.mesh.axis_names
                if self.mesh.shape[a] > 1 and (a in mine) == used]

    def shard_groups(self) -> Tree:
        """A tree like the params: each leaf's groups of the axes it is
        split over (a statistic of the whole leaf reduces over them)."""
        return tree_map(lambda s: self._axes(s, True), self.specs)

    def reduce_grads(self, grads: Tree) -> Tree:
        """Each gradient summed over the axes its leaf is replicated
        over: the body computes every replicated leaf's gradient in parts
        (a data rank's rows, a model rank's sequence block or its query
        heads' share of replicated K/V heads)."""
        return tree_map(lambda g, s: reduce_over(g, self._axes(s, False)),
                        grads, self.specs)


class ServeShards(ModelShards):
    """The sharded serving body's view of its mesh (module docstring):
    ``specs`` the params' ``PartitionSpec``s under a serving rule set,
    ``params`` their ``ParamSpec``s, whose logical axes give ``wholes``:
    the leaves split by head dim or K/V head over the heads' ``axis``
    ("model").  ``layer`` gathers each leaf over its other axes too
    (SERVE_BIG_RULES' "embed" over "data"; none under SERVE_RULES).
    ``kv_axes``: the mesh axes the KV cache's length is split over, major
    to minor, as its spec's ``kv_len`` entry names them (("model",)
    under SERVE_RULES, ("data", "model") or ("pod", "data", "model")
    under the long rules; () where it is not split); this rank holds
    length block ``kv_index`` of ``kv_size``.  An axis of size 1 takes no
    collective, so at world size 1 the body is the unsharded step, op
    for op."""

    def __init__(self, mesh: Mesh, specs: Tree, params: Tree,
                 kv_axes: Sequence[str], axis: str = "model"):
        super().__init__(mesh, specs, axis)
        self.wholes = tree_map(
            lambda s, p: any(self.axis in entry_axes(e) and
                             a in ("hdim", "kv_heads")
                             for e, a in zip(s, p.axes)), specs, params)
        blocks = BatchShards(mesh, kv_axes)
        self.kv_axes, self.kv_size, self.kv_index = \
            blocks.axes, blocks.size, blocks.index
        self.split_seq = False

    def _groups(self) -> List[Any]:
        return [self._group(self.axis)] if self.size > 1 else []

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s partial sums summed over the axis, in place."""
        return reduce_over(x, self._groups())

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums summed over the axis
        (the residual is replicated, so nothing is scattered; no
        gradient)."""
        return self.sum(x)

    def dim_block(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """This rank's block of ``n`` of ``x``'s last dim (a cache leaf
        split by head dim over the axis); ``x`` itself where ``n`` is the
        whole dim."""
        if n == x.shape[-1]:
            return x
        return x.narrow(-1, self.index * n, n)

    def dim_whole(self, x: torch.Tensor, n: int) -> torch.Tensor:
        """``x``, this rank's block of a last dim of ``n``, gathered whole
        over the axis (one all-gather; contiguous); ``x`` itself where it
        is whole."""
        if x.shape[-1] == n:
            return x
        return _AllGather.apply(x, x.dim() - 1,
                                self._group(self.axis)).contiguous()

    def kv_rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of a cache of ``n`` rows."""
        b = n // self.kv_size
        return self.kv_index * b, (self.kv_index + 1) * b

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """One-token attention over the whole cache from this rank's
        partial over its length block: out [B,H,D] and lse [B,H] of every
        rank gathered (one all-gather of both, in float32, a length axis;
        the minor axis first, so the partials land in block order) and
        merged in block order by ``ref.decode_merge``."""
        parts = torch.cat([out.float(), lse[..., None]], -1)[None]
        for a in reversed(self.kv_axes):
            if self.mesh.shape[a] > 1:
                parts = _AllGather.apply(parts, 0, self._group(a))
        return ref.decode_merge(parts[..., :-1], parts[..., -1], out.dtype)


_MODEL_CTX: contextvars.ContextVar = contextvars.ContextVar(
    "model_shards", default=None)


@contextlib.contextmanager
def model_parallel(shards: Optional[ModelShards]):
    tok = _MODEL_CTX.set(shards)
    try:
        yield
    finally:
        _MODEL_CTX.reset(tok)


def model_shards() -> Optional[ModelShards]:
    """The active ``ModelShards`` (None outside a sharded step body; a
    ``ServeShards`` in the serving one)."""
    return _MODEL_CTX.get()
