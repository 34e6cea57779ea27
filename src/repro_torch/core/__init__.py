"""The numpy plan layer, copied from ``repro.core``: ``Env`` and the
straggler models, the nine registered schemes (the paper's closed forms
and ``spsg``, the §VI baselines, the uncoded and realized-cost single
levels), the eq. (2)/(5) and realized runtimes, the gradient codes,
``FlatLayout`` (torch pack/unpack), and ``Plan``/``PlanSimulator`` with
the ``eq2``/``event``/``mc`` simulation backends.  No module here imports
``repro``; the copies are held bit-identical to the reference by
``tests/test_torch_plan.py``, ``tests/test_torch_sim.py`` and
``tests/test_torch_adapt.py``."""
from .baselines import ferdinand_x, single_bcgc, tandon_alpha_level, tandon_alpha_x
from .coding import GradientCode, decode_weights, make_code
from .distributions import (BernoulliStraggler, EmpiricalStraggler, LogNormalStraggler,
                            MixtureStraggler, ParetoStraggler, ScaledStraggler,
                            ShiftedExponential, StragglerDistribution, UniformStraggler,
                            dist_from_dict, dist_to_dict, register_distribution)
from .env import DegradedWorker, Env, WorkerDeath
from .flat import FlatLayout
from .plan import Plan, PlanSimulator, UNIT_RESOLUTION, leaf_costs_of
from .runtime import (CostModel, DEFAULT_COST, completion_trace, expected_tau_hat,
                      tau_hat_batch)
from .schemes import (Scheme, available_schemes, get_scheme, register_scheme,
                      scheme_accepts_warm_start, scheme_bank, solve_scheme)
from .solvers import brute_force_int, project_block_simplex, solve_xf, solve_xt, spsg

__all__ = [k for k in dir() if not k.startswith("_")]
