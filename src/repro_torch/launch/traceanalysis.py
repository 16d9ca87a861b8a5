"""Roofline terms from one traced step of a cell (the counterpart of the
reference's ``repro/launch/hloanalysis.py``, as ``fleet/mega/torchback``
is of ``jaxback``).

The reference compiles the cell with XLA and reads the partitioned
module: ``cost_analysis()`` for FLOPs and bytes, ``memory_analysis()``
for the buffers, the HLO text for the collectives.  The port has no
compiled module: it runs the cell's step once, eagerly, on rank 0 of a
fake process group, on fake tensors (``launch/dryrun``), and counts
what that rank dispatches:

* ``flops_per_device``: ``FlopCounterMode``'s total over the aten ops,
  plus the operations of every kernel launch the trace would make (the
  kernel wrappers' fake branch records them, ``kernels.ops.fake_work``:
  the kernel table's yardstick, 4 D a visible (query, key) pair, 2.5x
  that for the float32 backward, 2 a scan step and channel);
* ``bytes_per_device``: the operands and results of every aten op that
  is not a view (what XLA's "bytes accessed" counts an HLO op), plus
  every kernel launch's table bytes (inputs read once, outputs written
  once); an in-place ``copy_`` into a view (the sharded serving body's
  cache write) counts the view's bytes and makes no storage;
* ``collective_*``: the operand bytes and count of every c10d and
  ``c10d_functional`` op, under the reference's names (``all-gather``,
  ``all-reduce``, ``reduce-scatter``, ``all-to-all``,
  ``collective-permute``); an op with none (the pipeline's
  ``broadcast``) under its own name.  A ``wait_tensor`` is the async
  ``-done`` half and is not counted.  The counts are held equal to
  ``CommDebugMode``'s in every trace;
* the memory fields: ``argument_bytes`` the inputs' local storages,
  ``output_bytes`` the outputs', ``alias_bytes`` the outputs that are
  inputs' storages (donated: written in place), ``temp_bytes`` the peak
  of live storage less the arguments and the outputs that are not
  donated (XLA's temp: what is neither), so ``peak_device_bytes`` is
  the trace's peak of live storage.  Storages are counted as the card's
  caching allocator counts them (512-byte blocks) when the trace is of
  the card, and so are the temporaries the card's kernels allocate
  while they run, where their fake (meta) kernels do not: the softmax
  backward's, the size of its gradient (``_TEMPS``; seen on the H100 as
  the peak of the plain-recompute attention backward).

The reference extrapolates each count from two compiles (scan unrolled
once and twice) because XLA's cost analysis visits a ``while`` body
once.  The eager port runs every layer and every microbatch, so its
counts need no extrapolation (``tests/test_torch_dryrun.py`` shows
them linear in the layers).  Nor does it parse HLO text
(``parse_collectives``, ``_shape_bytes``): the collectives are counted
as they are dispatched.

The rates are one H100 SXM5's, from NVIDIA's H100 datasheet.
"""
from __future__ import annotations

import dataclasses
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Sequence, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake
from torch.distributed.tensor import DTensor
from torch.distributed.tensor.debug import CommDebugMode
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import ops

# NVIDIA H100 datasheet, SXM5 part
PEAK_FLOPS = 989e12          # dense BF16 tensor-core FLOP/s per GPU
HBM_BW = 3.35e12             # HBM3 bytes/s per GPU
HBM_BYTES = 80e9             # HBM3 per GPU (80 GB)
# one 400 Gb/s ConnectX-7 port a GPU (DGX H100): every axis of both
# production meshes spans more than one 8-GPU node, so the network sets
# the rate of a collective over it, not NVLink's 900 GB/s within a node
LINK_BW = 50e9               # bytes/s per GPU
ALLOC_BLOCK = 512            # the CUDA caching allocator's block size

COLLECTIVE_OPS = ("all-reduce", "all-gather", "reduce-scatter",
                  "all-to-all", "collective-permute")
_COLLECTIVE_NS = ("c10d", "_c10d_functional", "c10d_functional",
                  "_c10d_functional_autograd")
# op -> (the reference's name, the argument that holds the operands)
_COLLECTIVES = {
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_reduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "all_to_all_single": ("all-to-all", 0),
}
# the async halves and wrappers: not collectives
_NOT_COLLECTIVES = ("wait_tensor", "_wrap_tensor_autograd")
# ops whose kernels clone the whole storage of their first argument
# (``clone_preserve_strides``), which their fake (meta) kernels do not
_SCATTERS = ("slice_scatter", "select_scatter", "diagonal_scatter",
             "as_strided_scatter")
# ops whose CUDA kernels allocate, while they run, a temporary the size of
# their first argument (the card's only; their meta kernels do not)
_TEMPS = ("_softmax_backward_data",)
# dispatched ops that move no data
_NO_DATA = ("empty", "empty_like", "empty_strided", "new_empty",
            "new_empty_strided", "detach", "alias", "lift_fresh",
            "_local_scalar_dense", "resize_", "set_")


def collective_name(func) -> Tuple[str, int]:
    """(the reference's name, the operand argument) of a c10d op; an op
    with no counterpart keeps its own name (trailing ``_`` dropped) and
    counts every tensor argument."""
    op = func._schema.name.split("::")[-1]
    return _COLLECTIVES.get(op, (op.rstrip("_"), -1))


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_op: Dict[str, int]
    count_by_op: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_op.values())


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    n_devices: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collective_detail: Dict[str, int]
    collective_counts: Dict[str, int]
    # the trace's storages
    argument_bytes: int
    output_bytes: int
    temp_bytes: int
    alias_bytes: int
    model_flops_global: float           # 6 N_active D (or 2 N_active D)
    tag: str = "baseline"

    # -- derived ----------------------------------------------------------
    @property
    def compute_s(self) -> float:
        return self.flops_per_device / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.bytes_per_device / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_device / LINK_BW

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time lower bound (no overlap assumption)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs (global) -- remat/dispatch waste
        meter."""
        traced_global = self.flops_per_device * self.n_devices
        return self.model_flops_global / traced_global \
            if traced_global else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Achievable MFU bound: useful compute time / roofline-bound step
        time, i.e. (MODEL_FLOPS/(chips*peak)) / max(terms)."""
        useful_s = self.model_flops_global / (self.n_devices * PEAK_FLOPS)
        return useful_s / self.bound_s if self.bound_s else 0.0

    @property
    def peak_device_bytes(self) -> int:
        return self.argument_bytes + self.output_bytes + self.temp_bytes \
            - self.alias_bytes

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        for k in ("compute_s", "memory_s", "collective_s", "dominant",
                  "bound_s", "useful_flops_ratio", "roofline_fraction",
                  "peak_device_bytes"):
            d[k] = getattr(self, k)
        return d


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _local(t: Any) -> Any:
    return t._local_tensor if isinstance(t, DTensor) else t


def _tensors(tree: Any):
    return [_local(x) for x in tree_flatten(tree)[0]
            if isinstance(x, torch.Tensor)]


class _Storages:
    """Live storages and their peak, in the allocator's blocks."""

    def __init__(self, block: int):
        self.block = block
        self.live = self.peak = 0
        self._refs: Dict[int, Tuple[weakref.ref, int]] = {}

    def size(self, st: torch.UntypedStorage) -> int:
        return -(-st.nbytes() // self.block) * self.block

    def hold(self, t: torch.Tensor, nbytes: int = 0) -> None:
        """Count ``t``'s storage (``nbytes`` if more) while it lives."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._refs:
            return
        n = max(self.size(st), -(-nbytes // self.block) * self.block)
        self._refs[key] = (weakref.ref(st, lambda _, k=key: self._free(k)),
                           n)
        self.live += n
        self.peak = max(self.peak, self.live)

    def spike(self, nbytes: int) -> None:
        """A temporary of ``nbytes`` allocated and freed within an op, on
        top of what is live after it."""
        n = -(-nbytes // self.block) * self.block
        self.peak = max(self.peak, self.live + n)

    def held(self, t: torch.Tensor) -> int:
        """The bytes counted for ``t``'s storage (0 if not held)."""
        ref = self._refs.get(t.untyped_storage()._cdata)
        return ref[1] if ref else 0

    def _free(self, key: int) -> None:
        _, n = self._refs.pop(key)
        self.live -= n


class _Trace(TorchDispatchMode):
    """Counts what rank 0 dispatches: aten bytes, collectives, storages.
    DTensor ops are let through to their local ops, which it counts."""

    def __init__(self, block: int, card: bool = False):
        super().__init__()
        self.card = card
        self.bytes = 0
        self.collectives = CollectiveStats(dict.fromkeys(COLLECTIVE_OPS, 0),
                                           dict.fromkeys(COLLECTIVE_OPS, 0))
        self.storages = _Storages(block)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        ns = func.namespace
        op = func._schema.name.split("::")[-1]
        if ns in _COLLECTIVE_NS and op == "wait_tensor" and is_fake(args[0]):
            # eager returns the waited tensor itself; a fake wait's
            # meta kernel makes a new one
            return args[0]
        out = func(*args, **kwargs)
        whole = 0
        if op in _SCATTERS and is_fake(args[0]) and \
                not torch._debug_has_internal_overlap(args[0]):
            # the real kernel copies all of args[0]'s storage
            whole = args[0].untyped_storage().nbytes()
        if ns in _COLLECTIVE_NS and op not in _NOT_COLLECTIVES:
            name, arg = collective_name(func)
            operands = _tensors(args if arg < 0 else args[arg])
            c = self.collectives
            c.bytes_by_op[name] = c.bytes_by_op.get(name, 0) + sum(
                _nbytes(t) for t in operands)
            c.count_by_op[name] = c.count_by_op.get(name, 0) + 1
        elif whole:
            # the storage copied, then the source copied into its slice
            self.bytes += 2 * whole + 2 * _nbytes(args[1])
        elif ns == "aten" and not func.is_view and op not in _NO_DATA:
            self.bytes += sum(_nbytes(t) for t in _tensors((args, kwargs))
                              + _tensors(out))
        for t in _tensors(out):
            self.storages.hold(t, whole)
        if self.card and op in _TEMPS:
            self.storages.spike(_nbytes(args[0]))
        return out


def _comm_counts(cm: CommDebugMode) -> Dict[str, int]:
    counts: Dict[str, int] = defaultdict(int)
    for packet, n in cm.get_comm_counts().items():
        op = packet._qualified_op_name.split("::")[-1]
        counts[_COLLECTIVES.get(op, (op.rstrip("_"), -1))[0]] += n
    return dict(counts)


def analyze_trace(fn: Callable, args: Sequence[Any], *, arch: str,
                  shape: str, mesh_name: str, n_devices: int,
                  model_flops_global: float, tag: str = "baseline",
                  card: bool = True) -> Tuple[RooflineReport, Dict]:
    """Run ``fn(*args)`` once on this rank and build its report.
    ``card``: the trace is of the card's program (the kernel launches'
    work counted, storages in the allocator's blocks).  Returns the
    report and the detail: the aten FLOPs, the fake kernel launches per
    op and per route and their work, the peak of live storage."""
    ops.reset_launches()
    trace = _Trace(ALLOC_BLOCK if card else 1, card)
    inputs = _tensors(args)
    for t in inputs:
        trace.storages.hold(t)
    arg_bytes = trace.storages.live
    with FlopCounterMode(display=False) as flops, CommDebugMode() as cm, \
            trace:
        out = fn(*args)
    coll = trace.collectives
    counted = {k: n for k, n in coll.count_by_op.items() if n}
    if _comm_counts(cm) != counted:
        raise RuntimeError(f"collectives counted {counted} but "
                           f"CommDebugMode counts {_comm_counts(cm)}")
    work = ops.fake_work()
    k_flops = sum(w["operations"] for w in work.values())
    k_bytes = sum(w["bytes"] for w in work.values())
    st = trace.storages
    in_keys = {t.untyped_storage()._cdata for t in inputs}
    outs = {t.untyped_storage()._cdata: st.held(t) for t in _tensors(out)}
    out_bytes = sum(outs.values())
    alias = sum(n for k, n in outs.items() if k in in_keys)
    aten_flops = flops.get_total_flops()
    rep = RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, n_devices=n_devices,
        flops_per_device=float(aten_flops + k_flops),
        bytes_per_device=float(trace.bytes + k_bytes),
        collective_bytes_per_device=float(coll.total_bytes),
        collective_detail=coll.bytes_by_op,
        collective_counts=coll.count_by_op,
        argument_bytes=arg_bytes, output_bytes=out_bytes,
        temp_bytes=st.peak - arg_bytes - (out_bytes - alias),
        alias_bytes=alias, model_flops_global=model_flops_global, tag=tag)
    detail = {"aten_flops": aten_flops, "aten_bytes": trace.bytes,
              "kernel_launches": {k: n for k, n in
                                  ops.fake_launch_counts().items() if n},
              "kernel_routes": {op: {k: n for k, n in
                                     ops.fake_route_counts(op).items() if n}
                                for op in ("flash_attention",
                                           "decode_attention",
                                           "rglru_scan")},
              "kernel_work": {k: w for k, w in work.items()
                              if w["operations"] or w["bytes"]},
              "peak_bytes": st.peak}
    return rep, detail
