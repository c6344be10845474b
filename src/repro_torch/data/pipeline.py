"""Synthetic tokenized data pipeline: deterministic, shardable, resumable.

No datasets ship offline, so the corpus is a seeded synthetic token stream
with enough structure for a ~100M model to show a real learning curve
(a mixture of repeated n-grams + skewed unigram draws — compressible, so
loss drops well below ln(V)).  The pipeline is the substrate a real corpus
would slot into: deterministic sharding by host, bounded prefetch queue,
and exact step-resume (state = (epoch, step) only — no iterator pickling).
"""

from __future__ import annotations

import queue
import threading
from dataclasses import dataclass
from typing import Dict, Iterator, Optional

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    ngram_order: int = 3
    n_hosts: int = 1
    host_id: int = 0
    prefetch: int = 2


class SyntheticCorpus:
    """Deterministic n-gram language: next token = f(prev n-1 tokens) with
    noise — gives a steep, reproducible learning curve."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        rng = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        self._table = rng.integers(0, v, size=4096).astype(np.int32)
        self._unigram = rng.zipf(1.4, size=1 << 16).astype(np.int64) % v

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rng = np.random.default_rng(
            (cfg.seed, step, cfg.host_id)
        )  # deterministic per (step, host): exact resume & elastic re-shard
        b, s = per_host, cfg.seq_len
        toks = np.empty((b, s + 1), np.int32)
        toks[:, 0] = rng.integers(0, cfg.vocab_size, size=b)
        noise = rng.random((b, s)) < 0.1
        rand_toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
        h = toks[:, 0].astype(np.int64)
        for t in range(1, s + 1):
            nxt = self._table[(h ^ (h >> 7)) % len(self._table)]
            nxt = np.where(noise[:, t - 1], rand_toks[:, t - 1], nxt)
            toks[:, t] = nxt
            h = (h * 31 + nxt) & 0xFFFFFFFF
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}


class Prefetcher:
    """Bounded background prefetch — a slow host never stalls the step loop
    by more than the queue depth (straggler smoothing at the input layer)."""

    def __init__(self, corpus: SyntheticCorpus, start_step: int = 0):
        self.corpus = corpus
        self._q: "queue.Queue" = queue.Queue(maxsize=corpus.cfg.prefetch)
        self._step = start_step
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        while not self._stop.is_set():
            batch = self.corpus.batch(self._step)
            self._step += 1
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __next__(self):
        return self._q.get()

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=2.0)


def make_pipeline(cfg: DataConfig, start_step: int = 0) -> Prefetcher:
    return Prefetcher(SyntheticCorpus(cfg), start_step)
