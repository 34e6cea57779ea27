"""Gradient-coding encode/decode matrices (Tandon et al., ICML'17).

Copied from ``repro/core/coding.py``, trimmed to the constructions a
``Plan`` builds (identity, fractional repetition, cyclic), the decode
solve and the ``GradientCode`` bank.  For a redundancy level ``s`` over
``N`` workers, row ``n`` of the N x N matrix ``B`` is supported on the
cyclic window {n, ..., n+s} (mod N), and for every fastest set F of size
N - s there is a with aᵀ B_F = 1ᵀ.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

__all__ = ["identity_B", "frac_repetition_B", "cyclic_B", "make_code",
           "decode_weights", "GradientCode"]


def identity_B(n_workers: int) -> np.ndarray:
    return np.eye(n_workers, dtype=np.float64)


def frac_repetition_B(n_workers: int, s: int) -> np.ndarray:
    """Fractional repetition code; requires (s+1) | N (0/1 entries)."""
    if (s + 1) <= 0 or n_workers % (s + 1) != 0:
        raise ValueError(f"fractional repetition needs (s+1)|N, got N={n_workers} s={s}")
    b = np.zeros((n_workers, n_workers), dtype=np.float64)
    group = s + 1
    for w in range(n_workers):
        g = w // group
        b[w, g * group : (g + 1) * group] = 1.0
    return b


def cyclic_B(n_workers: int, s: int, rng=0) -> np.ndarray:
    """Tandon et al. Algorithm 1 (cyclic repetition code): random H with
    H @ 1 = 0, row n of B on the window {n..n+s} with B Hᵀ = 0."""
    if s == 0:
        return identity_B(n_workers)
    if not (0 < s < n_workers):
        raise ValueError(f"need 0 <= s < N, got s={s}, N={n_workers}")
    rng = np.random.default_rng(rng)
    h = rng.standard_normal((s, n_workers))
    h[:, -1] = -h[:, :-1].sum(axis=1)
    b = np.zeros((n_workers, n_workers), dtype=np.float64)
    for n in range(n_workers):
        win = (n + np.arange(s + 1)) % n_workers
        rhs = -h[:, win[0]]
        sol = np.linalg.solve(h[:, win[1:]], rhs)
        b[n, win[0]] = 1.0
        b[n, win[1:]] = sol
    return b


def make_code(n_workers: int, s: int, rng=0, prefer_fractional: bool = True) -> np.ndarray:
    """Best available B for (N, s): identity, fractional (exact 0/1) or cyclic."""
    if s == 0:
        return identity_B(n_workers)
    if prefer_fractional and n_workers % (s + 1) == 0:
        return frac_repetition_B(n_workers, s)
    return cyclic_B(n_workers, s, rng)


def decode_weights(b: np.ndarray, fastest: np.ndarray) -> np.ndarray:
    """Full-length decode vector a ∈ R^N with zeros on stragglers:
    aᵀ B[fastest, :] = 1ᵀ by least squares."""
    n_workers = b.shape[0]
    fastest = np.asarray(fastest, dtype=np.int64)
    sub = b[fastest, :]  # (N-s, N)
    coeff, *_ = np.linalg.lstsq(sub.T, np.ones(n_workers), rcond=None)
    a = np.zeros(n_workers, dtype=np.float64)
    a[fastest] = coeff
    return a


@dataclass
class GradientCode:
    """A bank of codes, one per redundancy level in use (built lazily)."""

    n_workers: int
    rng_seed: int = 0
    prefer_fractional: bool = True
    _bank: dict = field(default_factory=dict, repr=False)

    def b(self, s: int) -> np.ndarray:
        if s not in self._bank:
            self._bank[s] = make_code(
                self.n_workers, s, rng=self.rng_seed + 7919 * s, prefer_fractional=self.prefer_fractional
            )
        return self._bank[s]

    def decode(self, s: int, fastest: np.ndarray) -> np.ndarray:
        return decode_weights(self.b(s), fastest)

    def fastest_set(self, s: int, times: np.ndarray) -> np.ndarray:
        """Indices of the N - s fastest workers for a realization T."""
        order = np.argsort(times, kind="stable")
        return np.sort(order[: self.n_workers - s])
