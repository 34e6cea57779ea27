"""The scheme registry, trimmed to the paper's two closed forms.

Copied from ``repro/core/schemes.py``.  The port registers ``xt``
(Theorem 2) and ``xf`` (Theorem 3); any other name raises ``KeyError``
— SPSG, the §VI baselines and the realized-cost single level are ROADMAP
work.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np

from .assignment import round_x
from .env import Env
from .runtime import CostModel, DEFAULT_COST
from .solvers import solve_xf, solve_xt

__all__ = ["Scheme", "register_scheme", "get_scheme", "available_schemes",
           "solve_scheme"]


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
            f"unknown scheme {name!r}; available in the port: "
            f"{available_schemes()} (the other schemes of the reference are "
            "still to be ported, see ROADMAP)")
    return _REGISTRY[key]


def available_schemes() -> list[str]:
    """Sorted canonical names of every registered scheme."""
    return sorted(_REGISTRY)


def solve_scheme(name: str, env, n_workers: int, total: int, *,
                 cost: CostModel = DEFAULT_COST, rng=0, s_cap=None,
                 integer: bool = True) -> np.ndarray:
    """Solve the block partition with the named scheme; ``integer=True``
    largest-remainder-rounds so ``sum(x) == total`` exactly."""
    scheme = get_scheme(name)
    env = Env.coerce(env, n_workers).solver_view()
    x = scheme.solve(env, n_workers, total, cost=cost, rng=rng, s_cap=s_cap)
    x = np.asarray(x, np.float64)
    return round_x(x, total) if integer else x


# ------------------------------------------------------------ registrations
@register_scheme("xt", display="x_t (Thm 2)", kind="proposed", aliases=("x_t",),
                 description="Theorem 2 closed form at t_n = E[T_(n)]")
def _solve_xt(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None):
    return solve_xt(dist, n_workers, total, rng=rng, s_cap=s_cap)


@register_scheme("xf", display="x_f (Thm 3)", kind="proposed", aliases=("x_f",),
                 description="Theorem 3 closed form at t'_n = 1/E[1/T_(n)]")
def _solve_xf(dist, n_workers, total, *, cost=DEFAULT_COST, rng=0, s_cap=None):
    return solve_xf(dist, n_workers, total, rng=rng, s_cap=s_cap)
