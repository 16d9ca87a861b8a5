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
block of the batch's rows, so that they compute their share of the
global batch's statistics (``launch/steps.jit_cell``).
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
    keeps its block (no communication); a DTensor is redistributed."""
    dm = sharding.mesh.device_mesh
    if isinstance(x, DTensor):
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
    """Constrain ``x``'s sharding per the active rule set (no-op if none,
    or if ``x`` is a plain tensor)."""
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
    this rank holds block ``index`` of ``size`` equal blocks."""

    def __init__(self, mesh: Mesh, axes: Sequence[str]):
        self.mesh, self.axes = mesh, tuple(axes)
        self.size = math.prod(mesh.shape[a] for a in self.axes)
        dm = mesh.device_mesh
        index = 0
        for a in self.axes:
            index = index * mesh.shape[a] + dm.get_local_rank(a)
        self.index = index

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
