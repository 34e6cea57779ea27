"""Request arrival processes for the serving loop, copied from
``repro/sim/arrivals.py`` (the streams are bit-identical to the
reference's: tests/test_torch_serve.py).

The serving engine's clock is simulated (decode steps are priced by the
coded tier's straggler draws), so request *arrivals* live on the same
axis: a sorted (n,) array of simulated timestamps handed to
``ServeEngine.submit(..., arrival=t)``.  Two sources cover the
benchmark and launcher needs:

* ``poisson_arrivals`` — a homogeneous Poisson process at ``rate``
  requests per unit time (i.i.d. exponential gaps), the open-loop load
  model every serving benchmark defaults to;
* ``trace_arrivals`` — replay explicit timestamps (validated sorted),
  optionally rescaled to a target mean rate so one recorded burst
  pattern can be swept across load levels.

Pure numpy, deterministic under a seed — the same arrival stream
replays exactly across scheduler-policy comparisons, which is what
makes offline policy pricing (uncoded vs coded tier on identical load)
an apples-to-apples experiment.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

__all__ = ["poisson_arrivals", "trace_arrivals"]


def poisson_arrivals(n: int, rate: float, *, seed: int = 0,
                     start: float = 0.0, rng=None) -> np.ndarray:
    """(n,) sorted arrival times of a Poisson process at ``rate``.

    Gap k is Exp(rate); ``start`` offsets the whole stream.  Pass an
    existing ``rng`` to continue a stream, or ``seed`` for a fresh
    reproducible one.
    """
    if n < 0:
        raise ValueError("n must be >= 0")
    if rate <= 0.0:
        raise ValueError("rate must be positive")
    if rng is None:
        rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=int(n))
    return start + np.cumsum(gaps)


def trace_arrivals(times: Sequence[float], *, n: Optional[int] = None,
                   rate: Optional[float] = None,
                   start: float = 0.0) -> np.ndarray:
    """Replay recorded arrival timestamps as a simulated stream.

    ``times`` must be non-decreasing.  With ``n`` the trace is truncated
    (or cycled, shifted by the trace span, when the trace is shorter).
    With ``rate`` the stream is rescaled so its mean arrival rate over
    the replayed window equals ``rate`` — the knob for sweeping one
    burst shape across load levels.
    """
    t = np.asarray(times, np.float64).reshape(-1)
    if t.size == 0:
        raise ValueError("empty arrival trace")
    if np.any(np.diff(t) < 0):
        raise ValueError("arrival trace must be sorted non-decreasing")
    t = t - t[0]
    if n is not None:
        n = int(n)
        if n <= t.size:
            t = t[:n]
        else:  # cycle, each repetition shifted past the previous span
            span = float(t[-1]) + (float(np.diff(t).mean()) if t.size > 1
                                   else 1.0)
            reps = -(-n // t.size)
            t = np.concatenate([t + k * span for k in range(reps)])[:n]
    if rate is not None:
        if rate <= 0.0:
            raise ValueError("rate must be positive")
        span = float(t[-1])
        if span > 0.0:
            # mean rate over the window [0, span] is (len-1)/span for the
            # gaps actually replayed; rescale gaps to hit the target
            current = (t.size - 1) / span if t.size > 1 else 1.0
            t = t * (current / rate)
    return start + t
