"""Fault-tolerant checkpointing (the reference's
``repro/checkpoint/checkpoint.py``, same files).

Layout: <dir>/step_<N>/shard_0.npz + manifest.json, committed by atomic
rename of a ".tmp" directory -- a partially-written checkpoint is never
visible, so a crash mid-save costs nothing (restart resumes from the
previous commit).  ``CheckpointManager`` adds:

  * async saves on a worker thread (training never blocks on disk),
  * retention (keep the newest K),
  * deterministic resume: the step counter and the data-pipeline cursor
    ride inside the tree.

A tree is nested dicts of tensors (or numpy arrays), flattened as
``jax.tree_util`` flattens dicts: keys sorted, each leaf's path in its
``keystr`` form (``['state']['params']['embed']['table']``), leaf i
stored as ``leaf_i``.  So a checkpoint written by the reference restores
into the port's template and the other way round, with the same
manifest.  A bfloat16 leaf is stored as the reference stores it (numpy
has no bfloat16: two raw bytes an element, dtype ``|V2``, manifest
dtype ``bfloat16``).
"""
from __future__ import annotations

import json
import pathlib
import queue
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.models.params import (leaves_with_paths, tree_leaves,
                                       tree_map, tree_unflatten)

Tree = Any


def _to_numpy(leaf: Any) -> np.ndarray:
    if not isinstance(leaf, torch.Tensor):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


_BF16 = np.dtype("V2")


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16 else str(arr.dtype)


def save_pytree(tree: Tree, directory: str | pathlib.Path, step: int) -> \
        pathlib.Path:
    """Synchronous atomic save of one tree as step_<N>."""
    directory = pathlib.Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    final = directory / f"step_{step:08d}"
    tmp = directory / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    leaves = [(p, _to_numpy(leaf)) for p, leaf in leaves_with_paths(tree)]
    arrays = {f"leaf_{i}": arr for i, (_, arr) in enumerate(leaves)}
    np.savez(tmp / "shard_0.npz", **arrays)
    manifest = {
        "step": step,
        "n_leaves": len(leaves),
        "paths": [p for p, _ in leaves],
        "dtypes": [_dtype_name(a) for _, a in leaves],
        "shapes": [list(a.shape) for _, a in leaves],
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if final.exists():
        shutil.rmtree(final)
    tmp.rename(final)                       # atomic commit
    return final


def _to_tensor(arr: np.ndarray, tmpl: torch.Tensor) -> torch.Tensor:
    if arr.dtype == _BF16:                  # the reference's bfloat16
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=tmpl.device, dtype=tmpl.dtype)


def restore_pytree(template: Tree, directory: str | pathlib.Path,
                   step: Optional[int] = None) -> Tree:
    """Restore into the structure of ``template`` (a tree of tensors):
    each leaf shape-checked, cast to its template's dtype, on its
    template's device."""
    directory = pathlib.Path(directory)
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {directory}")
    path = directory / f"step_{step:08d}"
    manifest = json.loads((path / "manifest.json").read_text())
    with np.load(path / "shard_0.npz") as data:
        arrays = [data[f"leaf_{i}"] for i in range(manifest["n_leaves"])]
    flat = tree_leaves(template)
    if len(flat) != len(arrays):
        raise ValueError(
            f"checkpoint has {len(arrays)} leaves, template {len(flat)}")
    out = []
    for tmpl, arr in zip(flat, arrays):
        if tuple(tmpl.shape) != tuple(arr.shape):
            raise ValueError(f"shape mismatch {tuple(tmpl.shape)} vs "
                             f"{arr.shape}")
        out.append(_to_tensor(arr, tmpl))
    return tree_unflatten(template, out)


def latest_step(directory: str | pathlib.Path) -> Optional[int]:
    directory = pathlib.Path(directory)
    if not directory.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in directory.glob("step_*")
             if p.is_dir() and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


class CheckpointManager:
    """Async checkpointing with retention."""

    def __init__(self, directory: str | pathlib.Path, *, keep: int = 3):
        self.directory = pathlib.Path(directory)
        self.keep = keep
        self._q: "queue.Queue" = queue.Queue()
        self._worker = threading.Thread(target=self._run, daemon=True)
        self._worker.start()
        self._errors: List[Exception] = []

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            tree, step = item
            try:
                save_pytree(tree, self.directory, step)
                self._gc()
            except Exception as e:            # noqa: BLE001
                self._errors.append(e)
            finally:
                self._q.task_done()

    def _gc(self) -> None:
        steps = sorted(int(p.name.split("_")[1])
                       for p in self.directory.glob("step_*")
                       if p.is_dir() and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(self.directory / f"step_{s:08d}",
                          ignore_errors=True)

    def save_async(self, tree: Tree, step: int) -> None:
        # copy to host numpy now: the train step updates its tensors in
        # place
        host_tree = tree_map(_to_numpy, tree)
        self._q.put((host_tree, step))

    def wait(self) -> None:
        self._q.join()
        if self._errors:
            raise self._errors[0]

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join(timeout=10)
