"""Deterministic synthetic data pipeline.

The port of ``repro.data.pipeline``, copied as it is: the reference is pure
numpy, so the same seed draws the same batches in the same order, bit for
bit.  Produces packed LM batches from a seeded PRNG stream with a Zipfian
unigram distribution (so losses are non-trivial and decrease under
training).  Every host computes only its own shard of the global batch
(``host_id`` of ``n_hosts``); the trainer moves each numpy batch to its
device.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    zipf_a: float = 1.2
    doc_len_mean: int = 512
    bos_id: int = 1
    eos_id: int = 2


class SyntheticLM:
    """Packed-document synthetic token stream."""

    def __init__(self, cfg: DataConfig, *, host_id: int = 0,
                 n_hosts: int = 1):
        assert cfg.global_batch % n_hosts == 0
        self.cfg = cfg
        self.host_id = host_id
        self.n_hosts = n_hosts
        self.local_batch = cfg.global_batch // n_hosts
        # Zipf over the vocab, renormalized (ids 0..2 reserved)
        ranks = np.arange(3, cfg.vocab, dtype=np.float64)
        w = 1.0 / np.power(ranks - 2, cfg.zipf_a)
        self._probs = w / w.sum()
        self._ids = ranks.astype(np.int64)

    def _rng(self, step: int) -> np.random.Generator:
        # independent stream per (seed, step, host): restart-stable
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.host_id]))

    def batch(self, step: int) -> dict[str, np.ndarray]:
        """Returns {'tokens': [local_B, S], 'labels': [local_B, S]} for a
        given global step — pure function of (seed, step, host)."""
        cfg = self.cfg
        rng = self._rng(step)
        b, s = self.local_batch, cfg.seq_len
        toks = rng.choice(self._ids, size=(b, s + 1), p=self._probs)
        # pack documents: periodically insert EOS/BOS at sampled doc breaks
        n_docs = max(1, int((s + 1) / cfg.doc_len_mean))
        for row in range(b):
            breaks = rng.integers(1, s, size=n_docs)
            toks[row, breaks] = cfg.eos_id
            toks[row, np.minimum(breaks + 1, s)] = cfg.bos_id
        toks[:, 0] = cfg.bos_id
        # next-token LM: inputs/labels offset by one
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }

    def iterate(self, start_step: int = 0) -> Iterator[dict[str, np.ndarray]]:
        step = start_step
        while True:
            yield self.batch(step)
            step += 1
