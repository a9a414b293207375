"""Deterministic, restartable, host-sharded data pipeline
(src/repro/data/pipeline.py).

Sources are synthetic (the repository holds no corpora) but the pipeline
layer is real: the sample order comes from (seed, document index), so a
restarted job resumes mid-epoch bit for bit; hosts shard by
``process_index``; documents are packed into rows; a background thread
prefetches. The documents are numpy ``RandomState`` draws, the same
bits as the JAX package's, and the batches are ``{"tokens", "labels"}``
int64 tensors on the CPU, as numpy's packing gives them (``np.append``
of the int32 documents and the int ``eod`` promotes): the train step
moves them to its device.

``order`` (a permutation of document ids, e.g. ``data.ordering.
semantic_order``'s) makes the stream traverse the corpus in that order:
the paper's greedy reorder applied at the corpus level.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from repro_torch.core.device import process_grid


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seq_len: int = 512
    global_batch: int = 8
    vocab: int = 512
    seed: int = 0
    pack: bool = True
    prefetch: int = 2


class SyntheticLMSource:
    """Deterministic synthetic token documents (zipfian unigrams with
    per-doc topic drift so consecutive tokens correlate: a learnable
    signal for the examples)."""

    def __init__(self, vocab: int, seed: int = 0, mean_len: int = 384):
        self.vocab = vocab
        self.seed = seed
        self.mean_len = mean_len

    def doc(self, i: int) -> np.ndarray:
        rng = np.random.RandomState((self.seed * 1_000_003 + i) % (2**31))
        n = max(8, int(rng.exponential(self.mean_len)))
        topic = rng.randint(0, max(self.vocab // 64, 1))
        base = rng.zipf(1.5, size=n) % (self.vocab // 2)
        drift = (topic * 64 + rng.randint(0, 64, size=n)) % self.vocab
        use_topic = rng.rand(n) < 0.5
        return np.where(use_topic, drift, base).astype(np.int32)


def pack_documents(source, start_doc: int, seq_len: int, n_seqs: int,
                   *, eod: int = 0):
    """Pack docs into (n_seqs, seq_len+1) contiguous token rows; returns
    (rows, next_doc) so the caller can resume exactly."""
    need = n_seqs * (seq_len + 1)
    toks: list[np.ndarray] = []
    total = 0
    d = start_doc
    while total < need:
        t = source.doc(d)
        toks.append(np.append(t, eod))
        total += len(t) + 1
        d += 1
    flat = np.concatenate(toks)[:need]
    return flat.reshape(n_seqs, seq_len + 1), d


class TokenPipeline:
    """Host-sharded iterator of {'tokens','labels'} batches."""

    def __init__(self, dc: DataConfig, *, process_index: int | None = None,
                 process_count: int | None = None,
                 order: np.ndarray | None = None):
        self.dc = dc
        rank, world = process_grid()
        self.pi = rank if process_index is None else process_index
        self.pc = world if process_count is None else process_count
        assert dc.global_batch % self.pc == 0
        self.local_batch = dc.global_batch // self.pc
        self.source = SyntheticLMSource(dc.vocab, dc.seed)
        self.order = order          # optional semantic permutation of docs
        self._doc = self.pi         # interleave hosts over the doc stream

    def state(self) -> dict:
        return {"doc": self._doc}

    def restore(self, state: dict):
        self._doc = state["doc"]

    def _next_rows(self) -> np.ndarray:
        rows, nxt = pack_documents(
            _Permuted(self.source, self.order), self._doc,
            self.dc.seq_len, self.local_batch)
        # stride hosts: each host consumes every pc-th doc region
        self._doc = self._doc + (nxt - self._doc) * self.pc
        return rows

    def __iter__(self) -> Iterator[dict]:
        if self.dc.prefetch:
            return _prefetch(self._gen(), self.dc.prefetch)
        return self._gen()

    def _gen(self):
        while True:
            rows = self._next_rows()
            yield {
                "tokens": torch.from_numpy(np.ascontiguousarray(rows[:, :-1])),
                "labels": torch.from_numpy(np.ascontiguousarray(rows[:, 1:])),
            }


class _Permuted:
    def __init__(self, source, order):
        self.source = source
        self.order = order

    def doc(self, i: int) -> np.ndarray:
        if self.order is None:
            return self.source.doc(i)
        return self.source.doc(int(self.order[i % len(self.order)]))


def _prefetch(gen, depth: int):
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = object()

    def worker():
        try:
            for item in gen:
                q.put(item)
        finally:
            q.put(stop)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is stop:
            return
        yield item
