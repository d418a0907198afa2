"""Open-loop arrivals from the seed.

Each connection's requests arrive as a Poisson process of its share of
the rate: exponential gaps.  The set of gaps is drawn once from the
traffic file's ``shape_seed`` and only their order from the run's seed,
so every seed offers the same number of requests over the same seconds
with the same set of gaps, in another order; and the same seed gives
the same schedule."""

from __future__ import annotations

from typing import List

import numpy as np


def due_times(rate: float, seconds: float, seed: int, shape_seed: int,
              conns: int) -> List[np.ndarray]:
    """Each connection's due times in seconds after the window opens:
    ``round(rate / conns * seconds)`` requests whose gaps sum to
    ``seconds``, so the last is due as the window closes."""
    n = max(1, int(round(rate / conns * seconds)))
    out = []
    for c in range(conns):
        gaps = np.random.default_rng([shape_seed, c]).exponential(1.0, n)
        gaps *= seconds / gaps.sum()
        order = np.random.default_rng([seed, c]).permutation(n)
        out.append(np.cumsum(gaps[order]))
    return out


def frame_ids(n: int, ring: int, seed: int, conn: int) -> np.ndarray:
    """Which of the ``ring`` frames each of a connection's ``n`` requests
    carries."""
    return np.random.default_rng([seed, conn, 1]).integers(0, ring, n)


def sampled(n: int, k: int, seed: int, conn: int) -> np.ndarray:
    """The requests of a connection whose answers are checked: ``k``
    drawn from the seed, and the last."""
    pick = np.random.default_rng([seed, conn, 2]).choice(n, size=min(k, n), replace=False)
    return np.unique(np.append(pick, n - 1))
