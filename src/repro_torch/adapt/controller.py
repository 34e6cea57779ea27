"""``RecoveryEvent``, copied from ``repro/adapt/controller.py``."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Optional

__all__ = ["RecoveryEvent"]


@dataclass(frozen=True)
class RecoveryEvent:
    """One worker-death recovery: death detected -> (re-plan) -> coded
    restore from the survivors -> training continues from ``ckpt_step``."""

    step: int                  # trainer step at which death was detected
    dead_workers: tuple        # cumulative dead set at recovery time
    ckpt_step: int             # checkpoint step the state rewound to
    swap: Optional[Any]        # the forced re-plan; always None until the
    #                            adaptive controller is ported (ROADMAP 1.8)
