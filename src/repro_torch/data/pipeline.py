"""Deterministic synthetic data pipeline (the port's copy of
``repro.data.pipeline``: numpy only, the same draws, so a batch here is the
reference's batch bit for bit).

Design constraints from the fault-tolerance story:
  * batches are a pure function of (seed, step) — restart from a checkpoint
    at step k reproduces the exact remaining stream, no iterator state to
    persist;
  * host-sharded: each process materializes only its slice of the global
    batch (data-parallel loading), chosen by the ``process_index`` and
    ``process_count`` arguments;
  * double-buffered prefetch thread so host generation overlaps device
    compute.

The synthetic LM task is structured (a noisy integer-sequence grammar), not
uniform noise, so cross-entropy has a learnable signal and the end-to-end
example can show a falling loss curve.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np


class SyntheticLM:
    """Structured synthetic token stream: piecewise arithmetic sequences with
    a vocabulary-dependent stride — next-token is predictable within a
    segment, so CE can drop well below ln(V)."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int, *, seed: int = 0,
                 process_index: int = 0, process_count: int = 1):
        if global_batch % process_count:
            raise ValueError(f"global_batch {global_batch} does not split over {process_count} processes")
        self.vocab = vocab_size
        self.seq = seq_len
        self.local_batch = global_batch // process_count
        self.seed = seed
        self.pidx = process_index

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.pidx])
        )
        b, s = self.local_batch, self.seq
        starts = rng.integers(0, self.vocab, (b, 1))
        strides = rng.integers(1, 8, (b, 1))
        toks = (starts + strides * np.arange(s + 1)[None, :]) % self.vocab
        noise = rng.random((b, s + 1)) < 0.05
        toks = np.where(noise, rng.integers(0, self.vocab, (b, s + 1)), toks)
        return {
            "tokens": toks[:, :s].astype(np.int32),
            "labels": toks[:, 1 : s + 1].astype(np.int32),
        }


def make_batch_iterator(
    ds: SyntheticLM, start_step: int = 0, *, prefetch: int = 2
) -> Iterator[Dict[str, np.ndarray]]:
    """Background-thread prefetching iterator starting at ``start_step``."""
    q: "queue.Queue" = queue.Queue(maxsize=prefetch)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            try:
                q.put(ds.batch_at(step), timeout=0.5)
                step += 1
            except queue.Full:
                continue

    t = threading.Thread(target=worker, daemon=True)
    t.start()

    def gen():
        try:
            while True:
                yield q.get()
        finally:
            stop.set()

    return gen()
