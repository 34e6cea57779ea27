"""Scale constants of the paper's runtime model (eq. 2).

Copied from ``repro/core/runtime.py``, trimmed to the ``CostModel`` the
plan's eq. (2) ledger uses; the Monte-Carlo estimators and subgradients
(SPSG, single-BCGC) are ROADMAP work.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["CostModel", "DEFAULT_COST"]


@dataclass(frozen=True)
class CostModel:
    """Scale constants of eq. (2): M samples, b cycles/partial-derivative."""

    m_samples: int = 50
    b_cycles: float = 1.0

    def scale(self, n_workers: int) -> float:
        return self.m_samples / n_workers * self.b_cycles


DEFAULT_COST = CostModel()
