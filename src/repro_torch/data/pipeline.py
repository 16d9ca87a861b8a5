"""Data pipeline: deterministic synthetic LM batches with a resumable
cursor and background prefetch.  This is the reference's
``repro/data/pipeline.py`` (numpy only), copied: the same seed gives
the same batches bit for bit.

Synthetic corpus: a mixture of Zipf-distributed unigrams and short
repeated motifs, so a language model has real (low-entropy) structure to
learn -- the 100M-example's loss curve must actually descend, not just
jitter (a uniform-random stream has no learnable signal).

``DataCursor`` (just the batch index) rides inside the training
checkpoint, making restarts bit-exact: batch i is a pure function of
(seed, i).  Prefetch runs one batch ahead on a thread -- the host-side
analogue of overlapping input copy with compute.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass
class DataCursor:
    batch_index: int = 0


class SyntheticLMDataset:
    def __init__(self, *, vocab_size: int, seq_len: int, batch_size: int,
                 seed: int = 0, motif_len: int = 16, n_motifs: int = 64):
        self.vocab_size = vocab_size
        self.seq_len = seq_len
        self.batch_size = batch_size
        self.seed = seed
        rng = np.random.default_rng(seed)
        # motif bank: repeated phrases give the model learnable structure
        self._motifs = rng.integers(
            0, vocab_size, size=(n_motifs, motif_len), dtype=np.int32)
        # Zipf unigram distribution
        ranks = np.arange(1, vocab_size + 1, dtype=np.float64)
        p = 1.0 / ranks ** 1.1
        self._unigram = p / p.sum()

    def batch(self, index: int) -> Dict[str, np.ndarray]:
        """Batch `index` as a pure function of (seed, index)."""
        rng = np.random.default_rng((self.seed, index))
        b, s = self.batch_size, self.seq_len
        toks = rng.choice(self.vocab_size, size=(b, s + 1),
                          p=self._unigram).astype(np.int32)
        # overwrite random spans with motifs (about half the stream)
        n_spans = max((s // self._motifs.shape[1]) // 2, 1)
        for i in range(b):
            for _ in range(n_spans):
                m = self._motifs[rng.integers(len(self._motifs))]
                start = rng.integers(0, s + 1 - len(m))
                toks[i, start:start + len(m)] = m
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def iterate(self, cursor: Optional[DataCursor] = None, *,
                prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Resumable background-prefetched stream."""
        cursor = cursor or DataCursor()
        q: "queue.Queue" = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def producer():
            i = cursor.batch_index
            while not stop.is_set():
                q.put((i, self.batch(i)))
                i += 1

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                i, b = q.get()
                cursor.batch_index = i + 1
                yield b
        finally:
            stop.set()
            try:
                q.get_nowait()
            except queue.Empty:
                pass
