"""Integer rounding of block solutions and layer-block level assignment.

Copied from ``repro/core/assignment.py``, trimmed to ``round_x`` and
``assign_levels_to_layers`` (the paper's footnote-2/3 layer blocks).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

__all__ = ["round_x", "assign_levels_to_layers"]


def round_x(x: np.ndarray, total: int) -> np.ndarray:
    """Round a continuous feasible x (sum = L) to integers with exact sum
    (largest-remainder rounding)."""
    x = np.maximum(np.asarray(x, dtype=np.float64), 0.0)
    if x.sum() <= 0:
        raise ValueError("x must have positive mass")
    x = x * (total / x.sum())
    base = np.floor(x).astype(np.int64)
    short = int(total - base.sum())
    if short > 0:
        order = np.argsort(-(x - base), kind="stable")
        base[order[:short]] += 1
    elif short < 0:  # numerically possible after rescale
        order = np.argsort(x - base, kind="stable")
        take = 0
        for idx in order:
            if take == -short:
                break
            if base[idx] > 0:
                base[idx] -= 1
                take += 1
    if base.sum() != total or (base < 0).any():
        raise ArithmeticError(f"round_x produced {base} for total {total}")
    return base


def assign_levels_to_layers(
    layer_costs: Sequence[float], x: np.ndarray, total_units: int | None = None
) -> np.ndarray:
    """Redundancy level per layer from a block solution x over L units.

    Layers are laid out along the abstract coordinate axis in order, each
    occupying a cost-proportional stretch of the L units; layer j gets the
    level of the unit at its midpoint (monotone in j by Lemma 1).
    """
    costs = np.asarray(layer_costs, dtype=np.float64)
    if (costs < 0).any() or costs.sum() <= 0:
        raise ValueError("layer costs must be nonnegative with positive sum")
    x = np.asarray(x, dtype=np.float64)
    total = float(total_units if total_units is not None else x.sum())
    cum_mid = (np.cumsum(costs) - 0.5 * costs) / costs.sum() * total  # unit midpoint
    cum_x = np.cumsum(x)
    # level of unit u = min{ i : cum_x[i] >= u }
    levels = np.searchsorted(cum_x, cum_mid, side="left")
    return np.clip(levels, 0, x.shape[0] - 1).astype(np.int64)
