"""The numpy plan layer, copied from ``repro.core`` and trimmed to the
port's slices: ``Env`` and the shifted-exponential, empirical and scaled
straggler models, the ``xf``/``xt`` closed forms and ``spsg``, the
eq. (2)/(5) runtimes, the gradient codes, ``FlatLayout`` (torch
pack/unpack), and ``Plan``/``PlanSimulator``.  No module here imports
``repro``; the copies are held bit-identical to the reference by
``tests/test_torch_plan.py`` and ``tests/test_torch_adapt.py``."""
from .coding import GradientCode, decode_weights, make_code
from .distributions import (EmpiricalStraggler, ScaledStraggler, ShiftedExponential,
                            StragglerDistribution)
from .env import DegradedWorker, Env, WorkerDeath
from .flat import FlatLayout
from .plan import Plan, PlanSimulator, UNIT_RESOLUTION
from .runtime import CostModel, DEFAULT_COST, tau_hat_batch
from .schemes import (available_schemes, get_scheme, scheme_accepts_warm_start,
                      solve_scheme)
from .solvers import project_block_simplex, spsg

__all__ = [k for k in dir() if not k.startswith("_")]
