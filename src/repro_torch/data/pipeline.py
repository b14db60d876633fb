"""Deterministic synthetic data pipeline — a copy of
``repro.data.pipeline`` (numpy only), kept line for line so that
``batch_at(s)`` is bitwise the reference's.

* ``SyntheticCorpus`` — reproducible token stream (Zipf-ish unigram mix +
  local n-gram structure so models actually have something to learn).
* Sharded batching: each data-parallel rank draws its deterministic slice
  from the (step, rank) key, so restarts and elastic re-shards replay the
  exact same global batch order — the property checkpoint/restart relies
  on (cursor == step).
* ``Prefetcher`` — background-thread double buffering (host-side analogue
  of the input pipeline overlap the paper's infra assumes).
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticCorpus:
    """Deterministic pseudo-corpus. Batch for step s is a pure function of
    (seed, step) — restart-safe without storing data state beyond the step
    counter."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int = 1234, ngram: int = 3):
        self.vocab = vocab_size
        self.seq = seq_len
        self.batch = global_batch
        self.seed = seed
        self.ngram = ngram
        # fixed unigram distribution (Zipf-ish) and n-gram transition seeds
        rng = np.random.RandomState(seed)
        ranks = np.arange(1, min(vocab_size, 4096) + 1)
        p = 1.0 / ranks ** 1.1
        self.top = min(vocab_size, 4096)
        self.p = p / p.sum()
        self.trans_seed = rng.randint(0, 2 ** 31)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.RandomState((self.seed * 1000003 + step) % 2 ** 31)
        toks = rng.choice(self.top, size=(self.batch, self.seq),
                          p=self.p).astype(np.int32)
        # structure: with prob .5, t[i] = f(t[i-1]) (learnable bigram)
        prev = toks[:, :-1].astype(np.int64)
        f_prev = (prev * 2654435761 + self.trans_seed) % self.top
        mask = rng.rand(self.batch, self.seq - 1) < 0.5
        toks[:, 1:] = np.where(mask, f_prev, toks[:, 1:]).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.batch, 1), -1, np.int32)], axis=1)
        return {"tokens": toks, "labels": labels}

    def iterate(self, start_step: int = 0) -> Iterator[Dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch_at(step)
            step += 1


class Prefetcher:
    """Background-thread prefetch with bounded queue."""

    def __init__(self, it: Iterator, depth: int = 2):
        self.q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()

        def work():
            for item in it:
                if self._stop.is_set():
                    return
                self.q.put(item)

        self.t = threading.Thread(target=work, daemon=True)
        self.t.start()

    def __iter__(self):
        return self

    def __next__(self):
        return self.q.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self.q.get_nowait()
        except queue.Empty:
            pass
