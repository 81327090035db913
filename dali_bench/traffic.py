"""The one traffic generator: a traffic file's parameters and ``--seed`` ->
the requests of a run.

A traffic file (``traffic/<name>.json``) gives:

  ``arrival``         "closed": every request is due when the window opens,
                      and the server's slots refill from the queue as
                      requests finish (so the cell's ``slots`` are the
                      clients)
  ``prompt_tokens``,  ``{"dist": "loguniform" | "uniform", "min", "max"}``
  ``output_tokens``

A run serves ``max(1, round(requests_per_s * seconds))`` requests, where
the cell fixes ``requests_per_s``: a number set by the cell's files and
``--seconds`` alone, never by a reading taken at run time.

Every seed serves the same requests' sizes in the same order, so the
server's schedule (which request takes which slot at which step) is the
same for every seed, and the seed draws only the tokens.  The sizes are
the ``(i + 0.5) / n`` quantiles, i = 0..n-1, of the prompt and of the
output distribution, each set put in an order of its own drawn once from a
fixed stream (``ORDER``), so that prompt and answer sizes pair at random
and arrive unsorted.  A seed that drew the order would change the work: a
closed loop of a few rounds ends in a drain, whose share of the window
depends on which requests come last.
The tokens come from a seeded sparse first-order Markov chain over the
vocabulary: a frozen copy of the program's ``MarkovCorpus`` chain (the same
successors and transition weights from the same seed), sampled for all
prompts at once, position by position.
"""
from __future__ import annotations

import math

import numpy as np

ORDER = 0        # the fixed stream the request order is drawn from


class MarkovChain:
    """``MarkovCorpus``' chain: each token has ``branching`` successors with
    Dirichlet(0.5) transition weights, both drawn from ``seed``."""

    def __init__(self, vocab: int, seed: int, branching: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.successors = rng.integers(0, vocab, size=(vocab, branching))
        self.cum = np.cumsum(rng.dirichlet(np.ones(branching) * 0.5,
                                           size=vocab), axis=1)
        self.cum[:, -1] = 1.0

    def sample(self, rng: np.random.Generator, lengths) -> list:
        """One sequence of each length in ``lengths`` (int32 arrays)."""
        lengths = np.asarray(lengths, dtype=np.int64)
        n, L = len(lengths), int(lengths.max(initial=0))
        out = np.empty((n, L), np.int32)
        tok = rng.integers(0, self.vocab, size=n)
        u = rng.random((L, n))
        rows = np.arange(n)
        for i in range(L):
            out[:, i] = tok
            j = (self.cum[tok] < u[i][:, None]).sum(1)
            tok = self.successors[tok, np.minimum(j, self.cum.shape[1] - 1)]
        return [out[r, :lengths[r]].copy() for r in rows]


def quantiles(dist: dict, n: int) -> np.ndarray:
    """The ``(i + 0.5) / n`` quantiles, i = 0..n-1, of a size distribution,
    rounded to whole tokens."""
    q = (np.arange(n) + 0.5) / n
    lo, hi = float(dist["min"]), float(dist["max"])
    if dist["dist"] == "loguniform":
        v = np.exp(math.log(lo) + q * (math.log(hi) - math.log(lo)))
    elif dist["dist"] == "uniform":
        v = lo + q * (hi - lo)
    else:
        raise ValueError(f"unknown size distribution {dist['dist']!r}")
    return np.clip(np.rint(v), lo, hi).astype(np.int64)


def n_requests(requests_per_s: float, seconds: float) -> int:
    return max(1, int(round(requests_per_s * seconds)))


def requests(traffic: dict, vocab: int, seed: int, n: int):
    """[(prompt int32 array, output tokens)] of ``n`` requests, in arrival
    order."""
    if traffic["arrival"] != "closed":
        raise ValueError(f"unknown arrival rule {traffic['arrival']!r}")
    order = np.random.default_rng([ORDER, n])
    prompts = quantiles(traffic["prompt_tokens"], n)[order.permutation(n)]
    outputs = quantiles(traffic["output_tokens"], n)[order.permutation(n)]
    toks = MarkovChain(vocab, seed).sample(np.random.default_rng([seed, 2]),
                                           prompts)
    return [(t, int(o)) for t, o in zip(toks, outputs)]


def calibration_prompts(vocab: int, seed: int, n: int = 8,
                        length: int = 64) -> np.ndarray:
    """The ``(n, length)`` prompts the program's residual vectors are
    calibrated on in set-up (the same chain, another stream)."""
    chain = MarkovChain(vocab, seed)
    return np.stack(chain.sample(np.random.default_rng([seed, 1]),
                                 [length] * n))
