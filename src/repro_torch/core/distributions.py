"""Straggler models: distributions of per-worker CPU cycle times T_n.

Copied from ``repro/core/distributions.py`` (the port keeps its own copy
of the numpy plan layer) and trimmed to what the training slice calls:
the ``StragglerDistribution`` base, the shifted exponential (paper §V-C)
with its closed-form order statistics, and the exact JSON registry that
lets an ``Env`` embed bit-identically inside ``Plan.to_dict``.  The other
distributions of the reference are ROADMAP work.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass

import numpy as np
from scipy import integrate, special

__all__ = [
    "StragglerDistribution",
    "ShiftedExponential",
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


def dist_to_dict(d: "StragglerDistribution") -> dict:
    """JSON-able snapshot {type, **fields}; exact (no float formatting)."""
    name = type(d).__name__
    if _DIST_REGISTRY.get(name) is not type(d):
        raise TypeError(
            f"{name} is not registered; decorate it with @register_distribution")
    out = {"type": name}
    for f in dataclasses.fields(d):
        out[f.name] = getattr(d, f.name)
    return out


def dist_from_dict(blob: dict) -> "StragglerDistribution":
    """Inverse of ``dist_to_dict`` (bit-identical fields)."""
    cls = _DIST_REGISTRY.get(blob.get("type"))
    if cls is None:
        raise KeyError(f"unknown distribution type {blob.get('type')!r}; "
                       f"registered: {sorted(_DIST_REGISTRY)}")
    return cls(**{k: v for k, v in blob.items() if k != "type"})


@dataclass(frozen=True)
class StragglerDistribution:
    """Base class.  Subclasses implement ``sample`` and the order
    statistics the closed-form schemes need."""

    #: Monte-Carlo sample count of the reference's default estimators
    #: (kept so serialized distributions match the reference field by field)
    mc_samples: int = 200_000

    def sample(self, rng, shape) -> np.ndarray:  # pragma: no cover - abstract
        raise NotImplementedError

    def expected_order_stats(self, n_workers: int, rng=0) -> np.ndarray:
        raise NotImplementedError(f"{type(self).__name__} has no order "
                                  "statistics in the port (ROADMAP)")

    def inv_expected_inv_order_stats(self, n_workers: int, rng=0) -> np.ndarray:
        raise NotImplementedError(f"{type(self).__name__} has no order "
                                  "statistics in the port (ROADMAP)")


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
