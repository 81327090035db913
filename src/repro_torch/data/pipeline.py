"""Deterministic synthetic data pipeline.

Two sources, both fully offline and reproducible:

  * ``MarkovCorpus`` — a seeded sparse first-order Markov chain over the
    vocabulary.  Sequences have real learnable structure (entropy well
    below log V), so a few hundred training steps visibly reduce loss and
    induce non-uniform, temporally-correlated expert routing — the regime
    DALI's cache/prefetch exploit (paper Fig. 8).
  * ``UniformCorpus`` — i.i.d. tokens (control).

``batches()`` yields {"tokens", "labels"} with next-token labels, packed to
a fixed (batch, seq_len).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator

import numpy as np


@dataclass
class MarkovCorpus:
    vocab: int
    branching: int = 8          # successors per token
    seed: int = 0
    domain_shift_every: int = 0  # >0: re-draw transition row subset per block

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        V, B = self.vocab, self.branching
        self.successors = rng.integers(0, V, size=(V, B))
        probs = rng.dirichlet(np.ones(B) * 0.5, size=V)
        self.probs = probs

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        V, B = self.vocab, self.branching
        out = np.empty(length, np.int32)
        tok = int(rng.integers(0, V))
        for i in range(length):
            out[i] = tok
            j = rng.choice(B, p=self.probs[tok])
            tok = int(self.successors[tok, j])
        return out


@dataclass
class UniformCorpus:
    vocab: int
    seed: int = 0

    def sample(self, rng: np.random.Generator, length: int) -> np.ndarray:
        return rng.integers(0, self.vocab, size=length).astype(np.int32)


def batches(corpus, batch_size: int, seq_len: int, n_steps: int,
            seed: int = 0) -> Iterator[dict]:
    rng = np.random.default_rng(seed)
    for _ in range(n_steps):
        toks = np.stack([corpus.sample(rng, seq_len + 1)
                         for _ in range(batch_size)])
        yield {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
