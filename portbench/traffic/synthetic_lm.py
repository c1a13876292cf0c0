"""The training traffic: batches of a structured synthetic language, a
Zipf unigram mixed over Markov bigram states, so that a model's loss
falls as on text and unlike on uniform noise. A frozen copy of the
program's ``data/pipeline.py::SyntheticLM`` (numpy only): the benchmark
keeps its own generator so that a change to the program cannot change
the traffic it is measured on.

``batch_at(step)`` is a pure function of (seed, step): the same seed gives
the same batches, and every step's rows differ.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


class SyntheticLM:
    """Random-access batches ``{tokens, labels, loss_mask}`` of
    ``global_batch`` rows of ``seq_len`` tokens."""

    def __init__(self, vocab_size: int, seq_len: int, global_batch: int,
                 seed: int, n_bigram_states: int = 64):
        self.vocab_size, self.seq_len = vocab_size, seq_len
        self.global_batch, self.seed = global_batch, seed
        self.n_states = n_bigram_states
        base = np.random.default_rng(seed)
        v = vocab_size
        ranks = np.arange(1, v + 1)
        unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        base.integers(0, n_bigram_states, size=v)   # the state of a token
        trans = base.dirichlet(np.ones(n_bigram_states) * 0.3,
                               size=n_bigram_states)
        boosts = base.random((n_bigram_states, v)) ** 4
        emiss = unigram[None, :] * (0.2 + boosts)
        emiss = emiss / emiss.sum(axis=1, keepdims=True)
        self._emiss_cdf = np.cumsum(emiss, axis=1)
        self._trans_cdf = np.cumsum(trans, axis=1)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng((self.seed, step, 0))
        b, s = self.global_batch, self.seq_len
        toks = np.empty((b, s + 1), np.int32)
        state = rng.integers(0, self.n_states, size=b)
        for t in range(s + 1):
            u = rng.random(b)
            toks[:, t] = _first_above(self._emiss_cdf, state, u)
            u2 = rng.random(b)
            state = _first_above(self._trans_cdf, state, u2)
        return {"tokens": toks[:, :-1],
                "labels": toks[:, 1:].copy(),
                "loss_mask": np.ones((b, s), np.float32)}


def _first_above(cdfs: np.ndarray, rows: np.ndarray,
                 u: np.ndarray) -> np.ndarray:
    """For each i, the first index j with ``cdfs[rows[i], j] > u[i]``, or
    0 when there is none."""
    n = cdfs.shape[1]
    out = np.empty(len(u), dtype=np.int64)
    for i, (r, x) in enumerate(zip(rows, u)):
        j = int(np.searchsorted(cdfs[r], x, side="right"))
        out[i] = j if j < n else 0
    return out
