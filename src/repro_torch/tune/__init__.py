"""``repro_torch.tune`` — the launch-configuration autotuner, after
``repro.tune``.

``autotune(cfg, env, budget=MemBudget.from_gb(16))`` searches (scheme x
redundancy cap x pipeline x reduce mode x grad dtype), prices each
candidate with the ``Plan.simulate`` straggler backends plus a
shapes-only memory estimate, prunes over-budget points, and returns the
argmin plan with a JSON-serializable report.  ``analyze_memory`` measures
a step's argument and output bytes (and on CUDA its peak).
``Plan.build(..., scheme="auto")`` routes through ``autotune_plan``.
"""
from .memory import MemBudget, MemEstimate, analyze_memory, estimate_memory
from .tune import (Candidate, TuneError, TuneReport, TuneResult, autotune,
                   autotune_plan)

__all__ = ["MemBudget", "MemEstimate", "analyze_memory", "estimate_memory", "Candidate", "TuneError",
           "TuneReport", "TuneResult", "autotune", "autotune_plan"]
