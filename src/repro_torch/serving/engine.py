"""Single-model serving engine: slot-based continuous batching over the
prefill/decode steps of ``models/model.py``.

The engine owns a fixed decode working set: ``max_batch`` slots sharing
one stacked KV cache of ``max_len``.  Requests prefill into a free slot
(prompt written at cache offset 0..len) and then join the batched decode
step; finished slots are released and immediately reusable.  Slot
occupancy is tracked by ``serving/slots.py``'s ``SlotPool``.

Everything runs eagerly on ``device`` (default ``"cuda"``, where the
attention goes through the hand-written kernels; a missing card raises
rather than running on the CPU).  The KV caches are float32 whatever the
model dtype, as in the reference; attention reads them back in the
activation dtype.  A recurrent layer's state (``models/recurrent.py``)
has no time axis: its leaves are ``[layers, batch, ...]`` like the KV
caches', so a slot's row is written and merged the same way.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.models.model import (RunFlags, build_cache_specs,
                                      decode_step, prefill)
from repro_torch.models.params import materialize
from repro_torch.serving.slots import SlotPool

Tree = Any


@dataclasses.dataclass
class GenerationResult:
    request_id: int
    prompt: List[int]
    tokens: List[int]
    prefill_s: float = 0.0
    decode_s: float = 0.0


def _tree_map(fn, *trees):
    if isinstance(trees[0], dict):
        return {k: _tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class ServingEngine:
    def __init__(self, cfg: ArchConfig, params: Tree, *, max_batch: int = 4,
                 max_len: int = 128, flags: RunFlags = RunFlags(),
                 seed: int = 0, device: str | torch.device = "cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(
                "ServingEngine runs on a CUDA device and none is "
                "available; pass device='cpu' to run the plain PyTorch "
                "versions of the kernels")
        self.cfg = cfg
        self.params = params
        self.max_batch = max_batch
        self.max_len = max_len
        self.flags = flags
        self._rng = np.random.default_rng(seed)
        self._caches = self._new_caches(max_batch)
        self._slots = SlotPool(max_batch)                # occupancy tracker
        self._slot_pos = np.zeros(max_batch, np.int32)   # next write offset
        self._slot_last = np.zeros(max_batch, np.int32)  # last sampled token

    def _new_caches(self, batch: int) -> Tree:
        return materialize(
            build_cache_specs(self.cfg, batch, self.max_len, torch.float32),
            torch.Generator().manual_seed(0), self.device)

    # -- slots -------------------------------------------------------------
    def free_slots(self) -> List[int]:
        return self._slots.free_slots()

    # -- serving -----------------------------------------------------------
    def admit(self, prompt: List[int], extras: Optional[Dict[str, Any]]
              = None) -> int:
        """Prefill ``prompt`` into a free slot; returns the slot id."""
        slot = self._slots.acquire()
        if slot is None:
            raise RuntimeError("no free slots")
        # batch-1 prefill, then scatter the slot's cache rows
        toks = torch.tensor([prompt], dtype=torch.int64, device=self.device)
        batch = {"tokens": toks}
        if extras:
            batch.update({k: torch.as_tensor(v, device=self.device)
                          for k, v in extras.items()})
        logits, b1_caches = prefill(self.params, batch, self._new_caches(1),
                                    self.cfg, self.flags)
        next_tok = int(torch.argmax(logits[0]))

        # every cache leaf is [layers, batch, ...]: write row ``slot``
        def put(big, small):
            big[:, slot] = small[:, 0]
            return big
        self._caches = _tree_map(put, self._caches, b1_caches)
        self._slot_pos[slot] = len(prompt)
        self._slot_last[slot] = next_tok
        return slot

    def step(self) -> Dict[int, int]:
        """One batched decode step across live slots; returns
        {slot: sampled_token}.  Slots at different positions decode in
        one call per distinct position (all rows run, only the rows of
        the slots at that position keep their cache update)."""
        if self._slots.busy == 0:
            return {}
        out: Dict[int, int] = {}
        tokens = torch.as_tensor(self._slot_last, dtype=torch.int64,
                                 device=self.device)[:, None]
        # snapshot positions first: a slot advanced by an earlier group
        # must not match a later group's position and decode twice
        live = np.asarray(self._slots.live_slots(), dtype=np.intp)
        pos_now = self._slot_pos.copy()
        for pos in np.unique(pos_now[live]):
            pos_slots = [int(s) for s in live if pos_now[s] == pos]
            logits, new_caches = decode_step(self.params, tokens,
                                             self._caches, int(pos),
                                             self.cfg, self.flags)
            rows = torch.tensor(pos_slots, dtype=torch.int64,
                                device=self.device)

            # keep cache updates only for the slots at this position (in
            # place: the old cache is the engine's own)
            def merge(new, old):
                old[:, rows] = new[:, rows]
                return old
            self._caches = _tree_map(merge, new_caches, self._caches)
            picked = torch.argmax(logits[rows], dim=-1).tolist()
            for s, tok in zip(pos_slots, picked):
                out[s] = tok
                self._slot_last[s] = tok
                self._slot_pos[s] += 1
        return out

    def release(self, slot: int) -> None:
        self._slots.release(slot)
        self._slot_pos[slot] = 0

    def generate(self, prompt: List[int], max_new: int = 16
                 ) -> GenerationResult:
        """Convenience single-request generation."""
        slot = self.admit(prompt)
        toks: List[int] = [int(self._slot_last[slot])]
        for _ in range(max_new - 1):
            if self._slot_pos[slot] + 1 >= self.max_len:
                break
            out = self.step()
            toks.append(out[slot])
        self.release(slot)
        return GenerationResult(request_id=slot, prompt=list(prompt),
                                tokens=toks)
