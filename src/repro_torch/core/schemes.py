"""The ``Scheme`` registry: every way of partitioning the L coordinates.

Copied from ``repro/core/schemes.py``, with the reference's nine schemes
under their canonical names, display names, kinds and aliases: the
paper's proposed ``xt`` (Theorem 2), ``xf`` (Theorem 3) and ``spsg`` (the
stochastic projected subgradient optimum of Problem 3, which takes a
``warm_start``); the uncoded ``uniform``; the §VI baselines
``single-bcgc``, ``tandon-alpha``, ``ferdinand-l`` and ``ferdinand-l2``;
and ``single-real``, the one level that minimizes the realized cost of a
neural gradient.  Each solves with the uniform signature

    solve(env, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None)
        -> x  (N,) nonnegative, sum(x) == total

against the env's solver view; only the closed forms honor ``s_cap``.
"""
from __future__ import annotations

import inspect
import warnings
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .assignment import round_x
from .baselines import ferdinand_x, single_bcgc, tandon_alpha_x
from .env import Env
from .runtime import CostModel, DEFAULT_COST, tau_hat_realized_batch
from .solvers import solve_xf, solve_xt, spsg

__all__ = ["Scheme", "SchemeWarning", "register_scheme", "get_scheme",
           "available_schemes", "solve_scheme", "scheme_accepts_warm_start",
           "scheme_bank"]


class SchemeWarning(UserWarning):
    """A usability warning of the scheme registry (a ``warm_start`` seed
    discarded by a seed-free scheme)."""


@dataclass(frozen=True)
class Scheme:
    """A registered block-partition scheme; ``solve`` has the signature
    ``(env, n_workers, total, *, cost, rng, s_cap) -> x``."""

    name: str
    solve: Callable = field(repr=False)
    display: str = ""
    kind: str = "extra"
    description: str = ""
    aliases: tuple = ()


_REGISTRY: dict[str, Scheme] = {}
_ALIASES: dict[str, str] = {}


def register_scheme(name: str, *, display: Optional[str] = None,
                    kind: str = "extra", aliases: tuple = (),
                    description: str = ""):
    """Decorator: register ``fn`` as scheme ``name``."""

    def deco(fn: Callable) -> Callable:
        if name in _REGISTRY or name in _ALIASES:
            raise ValueError(f"scheme {name!r} already registered")
        scheme = Scheme(name=name, solve=fn, display=display or name,
                        kind=kind, description=description,
                        aliases=tuple(aliases))
        for a in scheme.aliases:
            if a in _REGISTRY or a in _ALIASES:
                raise ValueError(
                    f"alias {a!r} collides with an existing scheme or alias")
        _REGISTRY[name] = scheme
        for a in scheme.aliases:
            _ALIASES[a] = name
        return fn

    return deco


def get_scheme(name: str) -> Scheme:
    """Look up a scheme by canonical name or alias."""
    if name in _REGISTRY:
        return _REGISTRY[name]
    key = _ALIASES.get(name)
    if key is None:
        raise KeyError(
            f"unknown scheme {name!r}; available: {available_schemes()}")
    return _REGISTRY[key]


def available_schemes() -> list[str]:
    """Sorted canonical names of every registered scheme."""
    return sorted(_REGISTRY)


def solve_scheme(name: str, env, n_workers: int, total: int, *,
                 cost: CostModel = DEFAULT_COST, rng=0, s_cap=None,
                 integer: bool = True, warm_start=None) -> np.ndarray:
    """Solve the block partition with the named scheme against the env's
    solver view; ``integer=True`` largest-remainder-rounds so
    ``sum(x) == total`` exactly.

    ``warm_start`` (a previous block vector) is forwarded only to schemes
    whose solve function declares a ``warm_start`` parameter (``spsg``);
    the others' solutions are seed-free, so they discard it with a
    ``SchemeWarning``.
    """
    scheme = get_scheme(name)
    env = Env.coerce(env, n_workers).solver_view()
    kw = {}
    if warm_start is not None:
        if _accepts_warm_start(scheme):
            kw["warm_start"] = np.asarray(warm_start, np.float64)
        else:
            warnings.warn(
                f"scheme {scheme.name!r} does not declare a warm_start "
                "parameter; the provided seed vector is discarded (its "
                "solution is seed-free). Pass warm_start only to "
                "iterative schemes (check scheme_accepts_warm_start).",
                SchemeWarning, stacklevel=2)
    x = scheme.solve(env, n_workers, total, cost=cost, rng=rng, s_cap=s_cap,
                     **kw)
    x = np.asarray(x, np.float64)
    return round_x(x, total) if integer else x


def _accepts_warm_start(scheme: Scheme) -> bool:
    """True when the scheme's solve function declares ``warm_start``."""
    try:
        return "warm_start" in inspect.signature(scheme.solve).parameters
    except (TypeError, ValueError):  # builtins/C callables: assume not
        return False


def scheme_accepts_warm_start(name: str) -> bool:
    """Does scheme ``name`` consume a ``warm_start`` seed?  The adaptive
    re-planner gates on this instead of tripping the discard warning."""
    return _accepts_warm_start(get_scheme(name))


def scheme_bank(env, n_workers: int, total: int, rng=0,
                cost: CostModel = DEFAULT_COST) -> dict:
    """All §VI baseline x's, keyed by *canonical* scheme name.

    The paper's plot-legend strings live on each registered scheme's
    ``display`` attribute — presentation metadata, not lookup keys.
    """
    env = Env.coerce(env, n_workers).solver_view()
    return {
        name: _REGISTRY[name].solve(env, n_workers, total, cost=cost,
                                    rng=rng, s_cap=None)
        for name in available_schemes()
        if _REGISTRY[name].kind == "baseline"
    }


# ------------------------------------------------------------ registrations
@register_scheme("xt", display="x_t (Thm 2)", kind="proposed", aliases=("x_t",),
                 description="Theorem 2 closed form at t_n = E[T_(n)]")
def _solve_xt(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None):
    return solve_xt(dist, n_workers, total, rng=rng, s_cap=s_cap)


@register_scheme("xf", display="x_f (Thm 3)", kind="proposed", aliases=("x_f",),
                 description="Theorem 3 closed form at t'_n = 1/E[1/T_(n)]")
def _solve_xf(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None):
    return solve_xf(dist, n_workers, total, rng=rng, s_cap=s_cap)


@register_scheme("spsg", display="x_dagger (SPSG)", kind="proposed",
                 aliases=("x_dagger",),
                 description="stochastic projected subgradient on Problem 3")
def _solve_spsg(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None,
                warm_start=None):
    # s_cap is honored by the closed forms; the subgradient iteration has
    # no level cap.  A warm start seeds the iteration from the current
    # plan's x; cold solves are unchanged bit for bit.
    return spsg(dist, n_workers, total, n_iters=2000, batch=128, rng=rng,
                cost=cost, warm_start=warm_start).x


@register_scheme("uniform", display="uncoded", kind="uncoded",
                 aliases=("uncoded",),
                 description="no redundancy: every coordinate at level 0")
def _solve_uniform(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                   s_cap=None):
    x = np.zeros(n_workers)
    x[0] = total
    return x


@register_scheme("single-bcgc", display="single-BCGC", kind="baseline",
                 aliases=("single-BCGC",),
                 description="Problem 2 restricted to one redundancy level")
def _solve_single_bcgc(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                       s_cap=None):
    return single_bcgc(dist, n_workers, total, rng=rng, cost=cost)


@register_scheme("tandon-alpha", display="Tandon et al. (alpha)",
                 kind="baseline", aliases=("tandon", "Tandon et al. (alpha)"),
                 description="gradient coding of [1], alpha-partial-straggler level")
def _solve_tandon(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                  s_cap=None):
    return tandon_alpha_x(dist, n_workers, total, rng=rng)


@register_scheme("ferdinand-l", display="Ferdinand et al. (r=L)",
                 kind="baseline", aliases=("Ferdinand et al. (r=L)",),
                 description="hierarchical coded computation [8], r = L layers")
def _solve_ferdinand_l(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                       s_cap=None):
    return ferdinand_x(dist, n_workers, total, n_layers=total, rng=rng)


@register_scheme("ferdinand-l2", display="Ferdinand et al. (r=L/2)",
                 kind="baseline", aliases=("Ferdinand et al. (r=L/2)",),
                 description="hierarchical coded computation [8], r = L/2 layers")
def _solve_ferdinand_l2(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                        s_cap=None):
    return ferdinand_x(dist, n_workers, total, n_layers=max(total // 2, 1),
                       rng=rng)


@register_scheme("single-real", display="single level (realized cost)",
                 kind="extra",
                 description="argmin_s of the NN/SPMD realized runtime at one level")
def _solve_single_real(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0,
                       s_cap=None):
    # realized-cost-optimal single level: the per-slot realization of a
    # neural gradient prices level s at (s+1) full passes, so
    # argmin_s E[T_(N-s)] * (s+1).
    draws = dist.sample(np.random.default_rng(rng), (30_000, n_workers))
    top = n_workers if s_cap is None else min(int(s_cap) + 1, n_workers)
    best_s, best_v = 0, np.inf
    for s in range(top):
        xs = np.zeros(n_workers)
        xs[s] = total
        v = float(tau_hat_realized_batch(xs, draws, cost).mean())
        if v < best_v:
            best_s, best_v = s, v
    x = np.zeros(n_workers)
    x[best_s] = total
    return x
