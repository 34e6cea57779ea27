"""Adaptive re-planning and worker-death detection, copied from
``repro.adapt``: ``RuntimeMonitor`` folds per-round per-worker completion
times into a sliding-window ``Env`` estimate with a drift detector;
``AdaptiveController`` decides when re-planning pays, re-solves and hands
back a fresh ``Plan`` for the trainer to hot-swap at a step boundary;
``DeathWatch`` is the worker-death tripwire, ``RecoveryEvent`` its
record.

    ctrl = AdaptiveController(AdaptConfig(), plan, model)
    new_plan = ctrl.observe(times_row)   # (N,) per-worker completions
    if new_plan is not None:
        trainer.swap_plan(new_plan)      # optimizer, RNG, step untouched
"""
from .controller import AdaptConfig, AdaptiveController, RecoveryEvent, SwapEvent
from .monitor import DeathWatch, DriftReport, RuntimeMonitor

__all__ = ["AdaptConfig", "AdaptiveController", "DeathWatch", "DriftReport",
           "RecoveryEvent", "RuntimeMonitor", "SwapEvent"]
