"""Parameter-spec trees: one model definition, concrete tensors on demand.

A model is defined once as a nested dict of ``ParamSpec`` leaves (shape,
dtype, *logical axes*, init law).  ``materialize(tree, generator,
device)`` turns it into tensors, ``abstract`` into meta tensors (shape
and dtype, no storage); ``param_bytes`` / ``param_count`` read
sizes off the specs without allocating.  The logical axes ("embed",
"heads", "layers", "kv_len", ...) are the reference's names, which the
sharding rules (``distributed/sharding.py``) map onto a mesh.
"""
from __future__ import annotations

import dataclasses
import math
import zlib
from typing import (Any, Callable, Iterable, Iterator, List, Optional,
                    Sequence, Tuple)

import torch

Tree = Any


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.float32
    axes: Tuple[Optional[str], ...] = ()
    init: str = "normal"          # normal | zeros | ones | embed
    init_scale: Optional[float] = None

    def __post_init__(self):
        if len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} must match shape {self.shape} rank")


def spec(shape: Sequence[int], axes: Sequence[Optional[str]],
         dtype: torch.dtype = torch.bfloat16, init: str = "normal",
         init_scale: Optional[float] = None) -> ParamSpec:
    return ParamSpec(tuple(int(s) for s in shape), dtype, tuple(axes),
                     init, init_scale)


def is_spec(x: Any) -> bool:
    return isinstance(x, ParamSpec)


def tree_map_specs(fn: Callable[[ParamSpec], Any], tree: Tree) -> Tree:
    if isinstance(tree, dict):
        return {k: tree_map_specs(fn, v) for k, v in tree.items()}
    return fn(tree)


def leaves_with_paths(tree: Tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, leaf) pairs in sorted-key order; the path string is the
    reference's ``jax.tree_util.keystr`` form (``"['embed']['table']"``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_paths(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def tree_leaves(tree: Tree) -> List[Any]:
    """The leaves in sorted-key order (``jax.tree_util.tree_leaves``'s
    order for a tree of dicts)."""
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_unflatten(tree: Tree, leaves: Iterable[Any]) -> Tree:
    """A tree of ``tree``'s structure holding ``leaves``, taken in
    sorted-key order."""
    it = iter(leaves)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        return next(it)

    return build(tree)


def tree_map(fn: Callable[..., Any], tree: Tree, *rest: Tree) -> Tree:
    """``fn`` on each leaf of ``tree`` and the matching leaves of
    ``rest`` (trees of the same structure)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    return fn(tree, *rest)


def abstract(tree: Tree) -> Tree:
    """Meta-tensor stand-ins of a spec tree: shapes and dtypes, no
    allocation (the reference's ``ShapeDtypeStruct`` trees)."""
    return tree_map_specs(
        lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), tree)


def param_bytes(tree: Tree) -> int:
    return sum(math.prod(s.shape) * s.dtype.itemsize
               for _, s in leaves_with_paths(tree))


def param_count(tree: Tree) -> int:
    return sum(math.prod(s.shape) for _, s in leaves_with_paths(tree))


def _init_leaf(s: ParamSpec, seed: int, device: torch.device
               ) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    # fan-in scaled normal by default; "embed" uses unit normal
    if s.init == "embed":
        scale = 1.0
    else:
        fan_in = s.shape[-2] if len(s.shape) >= 2 else s.shape[-1]
        scale = s.init_scale if s.init_scale is not None else 1.0 / math.sqrt(
            max(fan_in, 1))
    gen = torch.Generator(device=device).manual_seed(seed)
    out = torch.empty(s.shape, dtype=s.dtype, device=device)
    # a stacked leaf is drawn one layer at a time from its one stream, so
    # the float32 temporary is one layer's size, not the whole stack's
    rows = out if s.axes[:1] == ("layers",) else out[None]
    for row in rows:
        row.copy_(torch.randn(row.shape, generator=gen, dtype=torch.float32,
                              device=device) * scale)
    return out


def materialize(tree: Tree, generator: torch.Generator,
                device: str | torch.device = "cuda") -> Tree:
    """Concrete random init on ``device`` with the reference's init laws.

    ``generator`` (a CPU ``torch.Generator``) gives one base seed; each
    leaf then draws from its own stream, seeded from that base and the
    crc32 of the leaf's path, so adding or removing an unrelated
    parameter does not reshuffle the others (crc32, not Python's salted
    ``hash``, so restarts agree).  The streams are not the reference's
    ``jax.random`` streams: parity with the reference comes from
    carrying its weights over (``convert.params_from_numpy``)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("materialize: no CUDA device is available; "
                           "pass device='cpu' to build the tensors on the "
                           "host")
    # 32-bit seeds: the CPU generator keeps only the low 32 bits
    base = int(torch.randint(0, 2 ** 32, (1,), generator=generator))
    seeds = {path: base ^ zlib.crc32(path.encode())
             for path, _ in leaves_with_paths(tree)}

    def build(tree, path=""):
        if isinstance(tree, dict):
            return {k: build(v, f"{path}[{k!r}]") for k, v in tree.items()}
        return _init_leaf(tree, seeds[path], device)

    return build(tree)
