"""The numpy plan layer, copied from ``repro.core`` and trimmed to the
training slice: ``Env`` and the shifted-exponential straggler model, the
``xf``/``xt`` closed-form schemes, the gradient codes, ``FlatLayout``
(torch pack/unpack), and ``Plan``/``PlanSimulator``.  No module here
imports ``repro``; the copies are held bit-identical to the reference by
``tests/test_torch_plan.py``."""
from .coding import GradientCode, decode_weights, make_code
from .distributions import ShiftedExponential, StragglerDistribution
from .env import DegradedWorker, Env, WorkerDeath
from .flat import FlatLayout
from .plan import Plan, PlanSimulator, UNIT_RESOLUTION
from .runtime import CostModel, DEFAULT_COST
from .schemes import available_schemes, get_scheme, solve_scheme

__all__ = [k for k in dir() if not k.startswith("_")]
