"""The benchmark's arithmetic: percentiles and sample times, plain Python
so that the CPU tests hold them."""

from __future__ import annotations

import math
import random


def percentile(values, q: float) -> float:
    """Nearest-rank percentile ``q`` (0 < q <= 100) of every value: the
    smallest value with at least q % of the values at or below it."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(xs)))
    return xs[k - 1]


def rng(seed: int, stream: str) -> random.Random:
    """A generator of its own for each use of the seed."""
    return random.Random(f"{int(seed)}:{stream}")


def sample_times(seconds: float, k: int, seed: int) -> list[float]:
    """``k`` times in [0, seconds), one drawn from the seed in each k-th of
    the window, in order."""
    r = rng(seed, "samples")
    return [seconds * (j + r.random()) / k for j in range(k)]
