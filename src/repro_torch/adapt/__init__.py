"""Worker-death detection and its provenance record, copied from
``repro.adapt`` and trimmed to what the recovery path calls: the
``DeathWatch`` tripwire and ``RecoveryEvent``.  Adaptive re-planning
(``AdaptiveController``) is ROADMAP 1.8."""
from .controller import RecoveryEvent
from .monitor import DeathWatch

__all__ = ["DeathWatch", "RecoveryEvent"]
