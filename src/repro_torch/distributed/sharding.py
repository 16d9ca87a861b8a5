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
sequence parallelism).  The collectives carry their gradients (an
all-gather's is a reduce-scatter, and back), so a gathered weight's
gradient returns to its block by a reduce-scatter; ``reduce_grads``
then sums each gradient over the axes its leaf is replicated over,
where each rank computed a part of it.
Inside that body the model's tensors are plain local tensors and
``shard_hint`` leaves them as they are: the hint sites' layouts are the
body's own (the residual split by rows and sequence, the logits of the
local tokens).

``ServeShards``, a ``ModelShards`` over the params' ``SERVE_RULES`` or
``SERVE_BIG_RULES`` specs, is the "model" axis inside the sharded
serving body (the prefill and decode cells of a decoder of attention +
dense or MoE FFN blocks).  The residual is replicated over "model"
there (``"seq": []``), so its sequence "gather" is the residual itself
and its "reduce-scatter" an all-reduce: each row-parallel product's
partial sums summed over the axis.  A layer's weights split by head dim
(``"hdim"``: the heads do not divide the axis) or by K/V head are
gathered whole, since rope pairs dims i and i + D/2 and every rank
writes every K/V head of its cache rows; every rank then runs those
heads, GSPMD's redundancy for such a dim.  Under ``SERVE_BIG_RULES``
each weight is also gathered over its other axes ("embed" over "data")
inside its layer, as the train body's FSDP gathers; under
``SERVE_RULES`` no weight is split over them and nothing more is
gathered.  Each rank holds the block ``rows(T)`` of the KV cache's
length and writes it in place; ``merge`` combines the ranks' partial
decode attention over their blocks by their log-sum-exps
(``ref.decode_merge``).
"""
from __future__ import annotations

import contextlib
import contextvars
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
    ``TRAIN_RULES``, by which each weight is gathered.  An axis of size
    1 takes no collective, so at world size 1 the body's arithmetic is
    the unsharded step's, op for op."""

    def __init__(self, mesh: Mesh, specs: Tree, axis: str = "model"):
        self.mesh, self.specs, self.axis = mesh, specs, axis
        self.size = mesh.shape.get(axis, 1)
        self.index = mesh.device_mesh.get_local_rank(axis) \
            if self.size > 1 else 0
        # the leaves ``layer`` gathers whole, over the axis too (none here)
        self.wholes = tree_map(lambda s: False, specs)

    def _group(self, axis: str):
        return self.mesh.device_mesh.get_group(axis)

    def rows(self, n: int) -> Tuple[int, int]:
        """[lo, hi): this rank's block of ``n`` sequence rows."""
        b = n // self.size
        return self.index * b, (self.index + 1) * b

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S / size, ...] -> [B, S, ...]: the ranks' sequence blocks
        in order (before a column-parallel product)."""
        if self.size == 1:
            return x
        return _AllGather.apply(x, 1, self._group(self.axis))

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, ...] partial sums -> [B, S / size, ...]: summed over
        the ranks, this rank's sequence block kept (after a row-parallel
        product)."""
        if self.size == 1:
            return x
        return _ReduceScatter.apply(x, 1, self._group(self.axis))

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """[B, S, ...] computed whole on every rank -> this rank's
        sequence block of it."""
        if self.size == 1:
            return x
        lo, hi = self.rows(x.shape[1])
        return x[:, lo:hi]

    def concat(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ranks' blocks ``x`` concatenated along ``dim``, in rank
        order (the gradient goes back by a reduce-scatter)."""
        if self.size == 1:
            return x
        return _AllGather.apply(x, dim, self._group(self.axis))

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
    ``specs`` the params' ``PartitionSpec``s under ``SERVE_RULES`` or
    ``SERVE_BIG_RULES``, ``params`` their ``ParamSpec``s, whose logical
    axes give ``wholes``: the leaves split by head dim or K/V head over
    the axis.  ``layer`` gathers each leaf over its other axes too
    (SERVE_BIG_RULES' "embed" over "data"; none under SERVE_RULES).  An
    axis of size 1 takes no collective, so at world size 1 the body is
    the unsharded step, op for op."""

    def __init__(self, mesh: Mesh, specs: Tree, params: Tree,
                 axis: str = "model"):
        super().__init__(mesh, specs, axis)
        self.wholes = tree_map(
            lambda s, p: any(self.axis in entry_axes(e) and
                             a in ("hdim", "kv_heads")
                             for e, a in zip(s, p.axes)), specs, params)

    def _groups(self) -> List[Any]:
        return [self._group(self.axis)] if self.size > 1 else []

    def seq_gather(self, x: torch.Tensor) -> torch.Tensor:
        """The residual as it is: replicated over the axis."""
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x``'s partial sums summed over the axis, in place."""
        return reduce_over(x, self._groups())

    def seq_scatter(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel product's partial sums summed over the axis
        (the residual is replicated, so nothing is scattered)."""
        return self.sum(x)

    def own(self, x: torch.Tensor) -> torch.Tensor:
        """A result computed whole on every rank: the residual's
        layout, as it is."""
        return x

    def merge(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """One-token attention over the whole cache from this rank's
        partial over its length block: out [B,H,D] and lse [B,H] of every
        rank gathered (one all-gather of both, in float32) and merged in
        rank order by ``ref.decode_merge``."""
        both = torch.cat([out.float(), lse[..., None]], -1)
        parts = self.concat(both[None], 0)
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
