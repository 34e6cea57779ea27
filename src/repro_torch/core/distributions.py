"""Straggler models: distributions of per-worker CPU cycle times T_n.

Copied from ``repro/core/distributions.py`` (the port keeps its own copy
of the numpy plan layer) and trimmed to what the port's slices call: the
``StragglerDistribution`` base with its Monte-Carlo order statistics, the
shifted exponential (paper §V-C) with its closed forms, the empirical
(trace-bootstrap) model the adaptive re-planner fits, the scaled model
that folds a static degradation into a worker, and the exact JSON
registry that lets an ``Env`` embed bit-identically inside
``Plan.to_dict``.  The other distributions of the reference are ROADMAP
work.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Optional

import numpy as np
from scipy import integrate, special

__all__ = [
    "StragglerDistribution",
    "ShiftedExponential",
    "EmpiricalStraggler",
    "ScaledStraggler",
    "register_distribution",
    "dist_to_dict",
    "dist_from_dict",
]


def _as_rng(rng) -> np.random.Generator:
    if isinstance(rng, np.random.Generator):
        return rng
    return np.random.default_rng(rng)


#: class-name -> class registry for ``dist_from_dict``.
_DIST_REGISTRY: dict = {}


def register_distribution(cls):
    """Class decorator: make ``cls`` JSON round-trippable by name."""
    if not (isinstance(cls, type) and issubclass(cls, StragglerDistribution)):
        raise TypeError("register_distribution needs a StragglerDistribution "
                        "subclass")
    _DIST_REGISTRY[cls.__name__] = cls
    return cls


def _encode_field(v):
    if isinstance(v, StragglerDistribution):
        return {"__dist__": dist_to_dict(v)}
    if isinstance(v, (tuple, list)):
        return [_encode_field(x) for x in v]
    return v


def _decode_field(v):
    if isinstance(v, dict) and "__dist__" in v:
        return dist_from_dict(v["__dist__"])
    if isinstance(v, list):  # all sequence-valued fields are stored as tuples
        return tuple(_decode_field(x) for x in v)
    return v


def dist_to_dict(d: "StragglerDistribution") -> dict:
    """JSON-able snapshot {type, **fields}; exact (no float formatting)."""
    name = type(d).__name__
    if _DIST_REGISTRY.get(name) is not type(d):
        raise TypeError(
            f"{name} is not registered; decorate it with @register_distribution")
    out = {"type": name}
    for f in dataclasses.fields(d):
        out[f.name] = _encode_field(getattr(d, f.name))
    return out


def dist_from_dict(blob: dict) -> "StragglerDistribution":
    """Inverse of ``dist_to_dict`` (bit-identical fields)."""
    cls = _DIST_REGISTRY.get(blob.get("type"))
    if cls is None:
        raise KeyError(f"unknown distribution type {blob.get('type')!r}; "
                       f"registered: {sorted(_DIST_REGISTRY)}")
    return cls(**{k: _decode_field(v) for k, v in blob.items() if k != "type"})


@dataclass(frozen=True)
class StragglerDistribution:
    """Base class.  Subclasses must implement ``sample``."""

    #: Monte-Carlo sample count used by the default order-statistic
    #: estimators
    mc_samples: int = 200_000

    def sample(self, rng, shape) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def cdf(self, t) -> np.ndarray:
        """Pr[T <= t].  Subclasses with a closed form override; the
        Monte-Carlo order statistics do not need it."""
        raise NotImplementedError(
            f"{type(self).__name__} has no cdf; use the Monte-Carlo "
            "order-statistic estimators")

    def mean(self) -> float:
        rng = np.random.default_rng(0)
        return float(self.sample(rng, (self.mc_samples,)).mean())

    def sample_sorted(self, rng, n_workers: int, n_draws: int) -> np.ndarray:
        """(n_draws, n_workers) of order statistics T_(1) <= ... <= T_(N)."""
        t = self.sample(_as_rng(rng), (n_draws, n_workers))
        t.sort(axis=1)
        return t

    def expected_order_stats(self, n_workers: int, rng=0) -> np.ndarray:
        """t with t[k-1] = E[T_(k)]  (Monte-Carlo default)."""
        draws = self.sample_sorted(rng, n_workers, self.mc_samples)
        return draws.mean(axis=0)

    def inv_expected_inv_order_stats(self, n_workers: int, rng=0) -> np.ndarray:
        """t' with t'[k-1] = 1 / E[1/T_(k)]  (Monte-Carlo default)."""
        draws = self.sample_sorted(rng, n_workers, self.mc_samples)
        return 1.0 / (1.0 / draws).mean(axis=0)


# ---------------------------------------------------------------------------
# Shifted exponential (paper §V-C):  Pr[T <= t] = 1 - exp(-mu (t - t0)), t>=t0
# ---------------------------------------------------------------------------
@register_distribution
@dataclass(frozen=True)
class ShiftedExponential(StragglerDistribution):
    mu: float = 1e-3
    t0: float = 50.0

    def sample(self, rng, shape) -> np.ndarray:
        rng = _as_rng(rng)
        return self.t0 + rng.exponential(scale=1.0 / self.mu, size=shape)

    def mean(self) -> float:
        return self.t0 + 1.0 / self.mu

    def cdf(self, t):
        t = np.asarray(t, dtype=np.float64)
        return np.where(t >= self.t0, 1.0 - np.exp(-self.mu * (t - self.t0)), 0.0)

    # ---- paper eq. (11):  t_n = (H_N - H_{N-n}) / mu + t0  (Renyi 1953)
    def expected_order_stats(self, n_workers: int, rng=None) -> np.ndarray:
        harm = np.concatenate([[0.0], np.cumsum(1.0 / np.arange(1, n_workers + 1))])
        h_n = harm[n_workers]
        n = np.arange(1, n_workers + 1)
        return (h_n - harm[n_workers - n]) / self.mu + self.t0

    # ---- paper Lemma 2, by the reference's quadrature form
    def inv_expected_inv_order_stats(self, n_workers: int, rng=None) -> np.ndarray:
        """1/E[1/T_(n)] via the Beta-reparameterized integral.

        With u = F(t) = 1 - exp(-mu (t - t0)),  t(u) = t0 - log(1-u)/mu,
          E[1/T_(n)] = int_0^1  Beta(u; n, N-n+1) / t(u) du.
        """
        big_n = n_workers
        out = np.empty(big_n)
        for n in range(1, big_n + 1):
            ln_coef = (
                math.log(n)
                + special.gammaln(big_n + 1)
                - special.gammaln(n + 1)
                - special.gammaln(big_n - n + 1)
            )

            def integrand(u, n=n, ln_coef=ln_coef):
                if u <= 0.0 or u >= 1.0:
                    return 0.0
                t_u = self.t0 - math.log1p(-u) / self.mu
                ln_w = ln_coef + (n - 1) * math.log(u) + (big_n - n) * math.log1p(-u)
                return math.exp(ln_w) / t_u

            val, _ = integrate.quad(integrand, 0.0, 1.0, limit=200)
            out[n - 1] = 1.0 / val
        return out


@register_distribution
@dataclass(frozen=True)
class EmpiricalStraggler(StragglerDistribution):
    """Bootstrap-resamples a measured trace of cycle times."""

    trace: Optional[tuple] = None  # tuple for hashability/frozen

    def sample(self, rng, shape) -> np.ndarray:
        if not self.trace:
            raise ValueError("EmpiricalStraggler needs a non-empty trace")
        rng = _as_rng(rng)
        arr = np.asarray(self.trace, dtype=np.float64)
        return rng.choice(arr, size=shape, replace=True)

    def cdf(self, t) -> np.ndarray:
        if not self.trace:
            raise ValueError("EmpiricalStraggler needs a non-empty trace")
        arr = np.sort(np.asarray(self.trace, np.float64))
        t = np.asarray(t, np.float64)
        return np.searchsorted(arr, t, side="right") / arr.size

    def mean(self) -> float:
        return float(np.mean(np.asarray(self.trace)))


@register_distribution
@dataclass(frozen=True)
class ScaledStraggler(StragglerDistribution):
    """``factor`` x a base distribution: a worker slowed by a static
    degradation (``Env.effective_dists``)."""

    base: Optional[StragglerDistribution] = None
    factor: float = 1.0

    def __post_init__(self):
        if self.base is None:
            raise ValueError("ScaledStraggler needs a base distribution")
        if not hasattr(self.base, "sample"):
            # the classic misbinding: ScaledStraggler(dist, 2.5) binds the
            # inherited mc_samples field first — insist on keywords
            raise TypeError(
                f"base must be a StragglerDistribution, got "
                f"{type(self.base).__name__!r}; construct with keywords: "
                "ScaledStraggler(base=dist, factor=2.5)")
        if self.factor <= 0:
            raise ValueError("factor must be positive")

    def sample(self, rng, shape) -> np.ndarray:
        return self.factor * self.base.sample(rng, shape)

    def cdf(self, t) -> np.ndarray:
        return self.base.cdf(np.asarray(t, np.float64) / self.factor)

    def mean(self) -> float:
        return self.factor * self.base.mean()
