"""Deterministic, sharded, resumable synthetic LM data pipeline: the
port's own copy of ``repro/data/pipeline.py`` (numpy only, so the batches
are the reference's bit for bit; the trainer moves them to the device).

Properties a 1000-node training job actually needs:

* DETERMINISM: batch(step) is a pure function of (seed, step) — every host
  derives its own shard with no coordination, and a restarted job at step k
  regenerates exactly the batch it would have seen (tested).
* RESUMABILITY: ``state_dict``/``load_state_dict`` carry only the step
  counter; skip-to-step is O(1) (no replaying the stream).
* SHARDING: each host materializes only its slice of the global batch
  (``batch_at(step, host_index=, host_count=)``); one process here, so
  the local slice IS the global batch.
* STRAGGLER-FRIENDLY: data for step k is available without the data for
  step k-1 (random access), so a restarted/migrated worker never replays.

The token stream is a structured synthetic language (a Zipf-ish unigram
mixture with per-document Markov bigram structure) — enough statistical
structure that a real LM's loss DECREASES (used by the trainer integration
test), unlike uniform noise.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np


@dataclasses.dataclass
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 1234
    n_bigram_states: int = 64      # Markov structure strength
    vision_patches: int = 0        # VLM: prepend this many patch embeddings
    d_model: int = 0               # width of the patch / frame stubs
    n_frames: int = 0              # encoder-decoder: stub frames a row


class SyntheticLM:
    """Random-access synthetic LM batches."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        self._step = 0
        base = np.random.default_rng(cfg.seed)
        v = cfg.vocab_size
        # fixed Zipf unigram distribution + a bigram transition kernel over
        # a low-dim state space projected into the vocab
        ranks = np.arange(1, v + 1)
        self._unigram = (1.0 / ranks) / np.sum(1.0 / ranks)
        self._state_of_tok = base.integers(0, cfg.n_bigram_states, size=v)
        self._trans = base.dirichlet(
            np.ones(cfg.n_bigram_states) * 0.3, size=cfg.n_bigram_states)
        # per-state emission: re-weighted unigram
        boosts = base.random((cfg.n_bigram_states, v)) ** 4
        emiss = self._unigram[None, :] * (0.2 + boosts)
        self._emiss = emiss / emiss.sum(axis=1, keepdims=True)
        # the per-state CDFs the reference recomputes for every token
        # (np.cumsum of a row is the same sequential sum either way), so a
        # [8, 256] batch at OLMo's 50304 tokens costs milliseconds, not the
        # half second of 514 cumsums over [8, 50304]
        self._emiss_cdf = np.cumsum(self._emiss, axis=1)
        self._trans_cdf = np.cumsum(self._trans, axis=1)

    # ------------------------------------------------------------- batches
    def batch_at(self, step: int, *, host_index: int = 0,
                 host_count: int = 1) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        assert cfg.global_batch % host_count == 0
        local_b = cfg.global_batch // host_count
        rng = np.random.default_rng(
            (cfg.seed, step, host_index))  # independent per (step, host)
        s = cfg.seq_len
        toks = np.empty((local_b, s + 1), np.int32)
        state = rng.integers(0, cfg.n_bigram_states, size=local_b)
        # vectorized Markov sampling over the batch
        for t in range(s + 1):
            u = rng.random(local_b)
            toks[:, t] = _first_above(self._emiss_cdf, state, u)
            u2 = rng.random(local_b)
            state = _first_above(self._trans_cdf, state, u2)

        batch = {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].copy(),
            "loss_mask": np.ones((local_b, s), np.float32),
        }
        if cfg.vision_patches:
            # drawn after the tokens, from the same stream, as the
            # reference draws them; the loss skips the patch positions
            batch["vision_embeds"] = rng.standard_normal(
                (local_b, cfg.vision_patches, cfg.d_model)).astype(np.float32)
            batch["loss_mask"][:, :cfg.vision_patches] = 0.0
        if cfg.n_frames:
            # the encoder's frames, drawn last, as the reference draws them
            batch["frames"] = rng.standard_normal(
                (local_b, cfg.n_frames, cfg.d_model)).astype(np.float32)
        return batch

    # ------------------------------------------------------------ iterator
    def __iter__(self):
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b

    # ------------------------------------------------------------- resume
    def state_dict(self) -> Dict[str, int]:
        return {"step": self._step}

    def load_state_dict(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])


def _first_above(cdfs: np.ndarray, rows: np.ndarray,
                 u: np.ndarray) -> np.ndarray:
    """For each i, the first index j with ``cdfs[rows[i], j] > u[i]``, or
    0 when there is none: the reference's ``np.argmax(u[:, None] < cdf,
    axis=1)``, by binary search on the (non-decreasing) CDF rows."""
    n = cdfs.shape[1]
    out = np.empty(len(u), dtype=np.int64)
    for i, (r, x) in enumerate(zip(rows, u)):
        j = int(np.searchsorted(cdfs[r], x, side="right"))
        out[i] = j if j < n else 0
    return out
