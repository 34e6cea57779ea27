"""Slim public facade of the port: one import for the whole system,
after ``repro/api.py``.

    from repro_torch import api
    plan = api.Plan.build(model, api.ShiftedExponential(mu=1e-3, t0=50.0),
                          n_workers=8, scheme="xf")

Math-only names (schemes, plans, distributions, cost model) import
eagerly from ``repro_torch.core``; trainer, serving, checkpoint and
simulation entry points resolve lazily on first attribute access, so
``import repro_torch.api`` loads no model, trainer or server.  Every
name of the reference's facade is here except ``build_plan``, its
legacy shim.
"""
from __future__ import annotations

from .core import (  # noqa: F401
    CostModel,
    DegradedWorker,
    Env,
    GradientCode,
    Plan,
    PlanSimulator,
    Scheme,
    UNIT_RESOLUTION,
    WorkerDeath,
    available_schemes,
    get_scheme,
    leaf_costs_of,
    register_scheme,
    scheme_bank,
    solve_scheme,
)
from .core.distributions import (  # noqa: F401
    BernoulliStraggler,
    EmpiricalStraggler,
    LogNormalStraggler,
    MixtureStraggler,
    ParetoStraggler,
    ScaledStraggler,
    ShiftedExponential,
    StragglerDistribution,
    UniformStraggler,
    register_distribution,
)

_LAZY = {
    # adaptive re-planning
    "AdaptConfig": ("repro_torch.adapt", "AdaptConfig"),
    "AdaptiveController": ("repro_torch.adapt", "AdaptiveController"),
    "DeathWatch": ("repro_torch.adapt", "DeathWatch"),
    "RecoveryEvent": ("repro_torch.adapt", "RecoveryEvent"),
    "RuntimeMonitor": ("repro_torch.adapt", "RuntimeMonitor"),
    # checkpointing (monolithic + erasure-coded)
    "CkptConfig": ("repro_torch.checkpoint", "CkptConfig"),
    "CheckpointManager": ("repro_torch.checkpoint", "CheckpointManager"),
    "CodedSpec": ("repro_torch.checkpoint", "CodedSpec"),
    "save_checkpoint": ("repro_torch.checkpoint", "save_checkpoint"),
    "load_checkpoint": ("repro_torch.checkpoint", "load_checkpoint"),
    "restore_train_state": ("repro_torch.checkpoint", "restore_train_state"),
    "save_coded_checkpoint": ("repro_torch.checkpoint", "save_coded_checkpoint"),
    "load_coded_checkpoint": ("repro_torch.checkpoint", "load_coded_checkpoint"),
    "restore_coded_train_state": ("repro_torch.checkpoint", "restore_coded_train_state"),
    "latest_step": ("repro_torch.checkpoint", "latest_step"),
    # trainer stack
    "Trainer": ("repro_torch.train.trainer", "Trainer"),
    "TrainConfig": ("repro_torch.train.trainer", "TrainConfig"),
    "WaveConfig": ("repro_torch.train.wave", "WaveConfig"),
    "WaveRunner": ("repro_torch.train.wave", "WaveRunner"),
    "make_coded_train_step": ("repro_torch.train.trainer", "make_coded_train_step"),
    "make_train_step": ("repro_torch.train.trainer", "make_train_step"),
    "make_coded_grad_fn": ("repro_torch.train.coded", "make_coded_grad_fn"),
    "uncoded_grad_fn": ("repro_torch.train.coded", "uncoded_grad_fn"),
    "combine_grads": ("repro_torch.train.coded", "combine_grads"),
    # serving
    "generate": ("repro_torch.serve.engine", "generate"),
    "make_serve_step": ("repro_torch.serve.engine", "make_serve_step"),
    "restore_plan": ("repro_torch.serve.engine", "restore_plan"),
    "ServeEngine": ("repro_torch.serve.engine", "ServeEngine"),
    "ServeConfig": ("repro_torch.serve.engine", "ServeConfig"),
    "Request": ("repro_torch.serve.request", "Request"),
    "CodedDecode": ("repro_torch.serve.coded", "CodedDecode"),
    "ReplicationPlan": ("repro_torch.serve.coded", "ReplicationPlan"),
    "solve_replication": ("repro_torch.serve.coded", "solve_replication"),
    # arrival processes
    "poisson_arrivals": ("repro_torch.sim.arrivals", "poisson_arrivals"),
    "trace_arrivals": ("repro_torch.sim.arrivals", "trace_arrivals"),
    # cluster simulation
    "ClusterSim": ("repro_torch.sim", "ClusterSim"),
    "ClusterConfig": ("repro_torch.sim", "ClusterConfig"),
    "Trace": ("repro_torch.sim", "Trace"),
    "simulate_plan": ("repro_torch.sim", "simulate_plan"),
    "simulate_x": ("repro_torch.sim", "simulate_x"),
    "schedule_from_plan": ("repro_torch.sim", "schedule_from_plan"),
    "schedule_from_plan_levels": ("repro_torch.sim", "schedule_from_plan_levels"),
    "schedule_from_x": ("repro_torch.sim", "schedule_from_x"),
    "WaveTrace": ("repro_torch.sim", "WaveTrace"),
    "WaveEvent": ("repro_torch.sim", "WaveEvent"),
    # configs
    "get_config": ("repro_torch.configs", "get_config"),
    "list_archs": ("repro_torch.configs", "list_archs"),
}

__all__ = sorted(
    [k for k in dict(globals())
     if not k.startswith("_") and k != "annotations"] + list(_LAZY)
)


def __getattr__(name: str):
    if name in _LAZY:
        import importlib

        module, attr = _LAZY[name]
        return getattr(importlib.import_module(module), attr)
    raise AttributeError(f"module 'repro_torch.api' has no attribute {name!r}")


def __dir__():
    return __all__
