"""The port's autotuner (``repro_torch.tune``) against the JAX
reference's (``repro.tune``), on the CPU.

The search is numpy on both sides except the ``mc`` backend: with the
port's ``launch.mesh.HW`` set to the reference's TPU constants, the
port's ``autotune`` and ``autotune_plan`` return the reference's report —
the same candidates in the same order, the same memory estimates, the
same pruned entries and reasons, the same best — with straggler times
bit-equal under ``eq2`` (an i.i.d. env) and within 1e-6 relative under
``mc`` (a heterogeneous env; torch fp32 against jax fp32).
``estimate_memory`` is equal field by field.  Both searches price the
same schemes: the reference's registry is held to the entries the
port's registry has (``same_schemes``), so a scheme another test file
registers in the reference's process-wide registry (the run's workers
share processes between files) does not change the reference's search.
``Trainer(scheme="auto")``
adopts the reference's knobs and plan, its first two losses match the
reference trainer's, and the launcher's ``--autotune --hbm-gb`` prints
the reference launcher's ``autotune: ...`` line.
"""
import json

import jax
import numpy as np
import pytest
import torch

import repro.core as J
import repro.core.schemes as J_schemes
import repro_torch.core as T
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch.mesh import HW as JHW
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.tune import MemBudget as JMemBudget
from repro.tune import autotune as j_autotune
from repro.tune import autotune_plan as j_autotune_plan
from repro.tune import estimate_memory as j_estimate_memory
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as launch_train
from repro_torch.train.state import abstract_train_state
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tune import (MemBudget, TuneError, TuneReport, autotune, autotune_plan,
                              estimate_memory)

N = 4
KW = dict(n_layers=2, d_model=128)
SE = dict(mu=1e-3, t0=50.0)
COSTS = np.asarray([4.0, 2.0, 1.0, 0.5, 3.0])


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors: one intra-op thread keeps torch's pool from spinning
    on cores other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def tpu_hw(monkeypatch):
    """The port's ``HW`` at the reference's TPU v5e constants, so both
    packages price the same roofline overhead."""
    monkeypatch.setattr(tmesh.HW, "HBM_BW", JHW.HBM_BW)
    monkeypatch.setattr(tmesh.HW, "ICI_BW", JHW.ICI_BW)


def _port_schemes_only(monkeypatch) -> None:
    """The reference's scheme registry (and aliases), for the test, cut to
    the schemes the port's registry has."""
    keep = set(T.available_schemes())
    monkeypatch.setattr(J_schemes, "_REGISTRY",
                        {k: v for k, v in J_schemes._REGISTRY.items() if k in keep})
    monkeypatch.setattr(J_schemes, "_ALIASES",
                        {a: k for a, k in J_schemes._ALIASES.items() if k in keep})


@pytest.fixture
def same_schemes(monkeypatch):
    """Both searches price the same schemes, whatever else the process
    registered in the reference's registry before."""
    _port_schemes_only(monkeypatch)


def _cfgs():
    return get_config("gc-lm-110m").reduced(**KW), jax_get_config("gc-lm-110m").reduced(**KW)


def _envs(kind):
    """(port env, reference env): i.i.d. (eq2 prices it) or heterogeneous
    with a static degradation (mc prices it)."""
    if kind == "iid":
        env_j = J.Env.iid(J.ShiftedExponential(**SE), N)
    else:
        fast = J.ShiftedExponential(mc_samples=20_000, **SE)
        env_j = J.Env.heterogeneous([fast] * 2 + [J.ScaledStraggler(base=fast, factor=5.0)] * 2,
                                    mc_samples=20_000).with_faults(J.DegradedWorker(1, 1.5))
    return T.Env.from_dict(json.loads(json.dumps(env_j.to_dict()))), env_j


def _reports_equal(rep_t, rep_j, time_rtol):
    """The same candidates in the same order, memory equal, the same
    pruned entries and reasons; times equal or within ``time_rtol``."""
    bt, bj = rep_t.to_dict(), rep_j.to_dict()
    for key in ("n_workers", "budget_bytes", "backend", "steps", "seed", "n_candidates",
                "n_admissible"):
        assert bt[key] == bj[key], key
    for part in ("candidates", "pruned"):
        assert len(bt[part]) == len(bj[part])
        for ct, cj in zip(bt[part], bj[part]):
            for key in ("straggler_time", "time"):
                np.testing.assert_allclose(ct.pop(key), cj.pop(key), rtol=time_rtol)
            assert ct == cj
    assert rep_t.best.key() == rep_j.best.key()
    assert rep_t.best.plan.to_dict() == rep_j.best.plan.to_dict()


def test_estimate_memory_equal_field_by_field():
    cfg_t, cfg_j = _cfgs()
    env_t, env_j = _envs("iid")
    model = abstract_train_state(cfg_t).params
    shapes = j_abstract_train_state(cfg_j)[0].params
    for s_cap in (0, 2):
        plan_t = T.Plan.build(model, env_t, scheme="xf", s_cap=s_cap)
        plan_j = J.Plan.build(shapes, env_j, scheme="xf", s_cap=s_cap)
        cost_t = T.Plan.build(COSTS, env_t, scheme="xt", s_cap=s_cap)
        cost_j = J.Plan.build(COSTS, env_j, scheme="xt", s_cap=s_cap)
        for pipeline in ("flat", "tree"):
            for reduce_mode in ("psum", "psum_scatter"):
                for grad_dtype in ("fp32", "bf16"):
                    kw = dict(grad_dtype=grad_dtype, pipeline=pipeline, reduce_mode=reduce_mode)
                    got = estimate_memory(plan_t, cfg=cfg_t, global_batch=8, seq_len=32, **kw)
                    want = j_estimate_memory(plan_j, cfg=cfg_j, global_batch=8, seq_len=32, **kw)
                    assert got.to_dict() == want.to_dict()
                    assert estimate_memory(cost_t, **kw).to_dict() \
                        == j_estimate_memory(cost_j, **kw).to_dict()
    with pytest.raises(ValueError, match="grad_dtype"):
        estimate_memory(plan_t, grad_dtype="fp16")
    b_t, b_j = MemBudget.from_gb(3.0), JMemBudget.from_gb(3.0)
    assert (b_t.hbm_bytes, b_t.label) == (b_j.hbm_bytes, b_j.label)
    assert str(MemBudget(2 * 2**30)) == str(JMemBudget(2 * 2**30)) == "2.00 GiB"


@pytest.mark.parametrize("kind,rtol", [("iid", 0.0), ("heterogeneous", 1e-6)])
def test_autotune_report_equals_reference(tpu_hw, same_schemes, kind, rtol):
    """The full search (every scheme but spsg x every s_cap x the three
    knob axes) under a cap that prunes some and admits some."""
    cfg_t, cfg_j = _cfgs()
    env_t, env_j = _envs(kind)
    kw = dict(global_batch=8, seq_len=32, steps=60, seed=0)
    open_j = j_autotune(cfg_j, env_j, None, **kw)
    mems = sorted(c.mem.total for c in open_j.report.candidates)
    cap = 0.5 * (mems[0] + mems[-1])
    res_t = autotune(cfg_t, env_t, MemBudget(cap), device="cpu", **kw)
    res_j = j_autotune(cfg_j, env_j, JMemBudget(cap), **kw)
    assert res_t.report.backend == ("eq2" if kind == "iid" else "mc")
    assert res_t.report.pruned and res_t.report.candidates
    _reports_equal(res_t.report, res_j.report, rtol)
    assert res_t.plan.to_dict() == res_j.plan.to_dict()
    if kind == "iid":
        assert res_t.report.table() == res_j.report.table()
    with pytest.raises(TuneError) as ei:
        autotune(cfg_t, env_t, MemBudget(1.0), schemes=("xf",), steps=5, device="cpu")
    assert isinstance(ei.value.report, TuneReport) and not ei.value.report.candidates


@pytest.mark.parametrize("kind,rtol", [("iid", 0.0), ("heterogeneous", 1e-6)])
def test_autotune_plan_and_plan_build_auto_equal_reference(tpu_hw, same_schemes, kind, rtol):
    env_t, env_j = _envs(kind)
    for s_cap in (None, 1):
        plan_t = autotune_plan(COSTS, env_t, s_cap=s_cap, steps=40, device="cpu")
        plan_j = j_autotune_plan(COSTS, env_j, s_cap=s_cap, steps=40)
        _reports_equal(plan_t.tune_report, plan_j.tune_report, rtol)
        assert plan_t.to_dict() == plan_j.to_dict()
    budget_t, budget_j = MemBudget(1e6), JMemBudget(1e6)
    plan_t = T.Plan.build(COSTS, env_t, scheme="auto", budget=budget_t, device="cpu")
    plan_j = J.Plan.build(COSTS, env_j, scheme="auto", budget=budget_j)
    _reports_equal(plan_t.tune_report, plan_j.tune_report, rtol)
    assert plan_t.to_dict() == plan_j.to_dict()
    with pytest.raises(ValueError, match="scheme='auto'"):
        T.Plan.build(COSTS, env_t, scheme="xf", budget=budget_t)


def test_trainer_auto_adopts_reference_knobs_and_losses(tpu_hw, same_schemes):
    cfg_t, cfg_j = _cfgs()
    seq = 32
    budget = 64.0
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=10),
                   J.ShiftedExponential(**SE), n_workers=N, scheme="auto",
                   budget=JMemBudget.from_gb(budget), global_batch=8, seed=0)
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq, global_batch=8,
                                            seed=0))
    init = jax.tree.map(np.asarray, ref.state.params)
    ours = Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10), T.ShiftedExponential(**SE),
                   n_workers=N, scheme="auto", budget=MemBudget.from_gb(budget),
                   global_batch=8, seed=0, device="cpu", params=init)
    ours.data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=seq, global_batch=8,
                                           seed=0))
    best = ours.tune_report.best
    assert (ours.pipeline, ours.reduce_mode, ours.grad_dtype) \
        == (best.pipeline, best.reduce_mode, best.grad_dtype) \
        == (ref.pipeline, ref.reduce_mode, ref.grad_dtype)
    _reports_equal(ours.tune_report, ref.tune_report, 0.0)
    assert ours.plan.to_dict() == ref.plan.to_dict()
    ours.run(2, log_every=0)
    ref.run(2, log_every=0)
    for ht, hj in zip(ours.history, ref.history, strict=True):
        assert (ht["tau_coded"], ht["tau_uncoded"]) == (hj["tau_coded"], hj["tau_uncoded"])
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    with pytest.raises(ValueError, match="scheme='auto'"):
        Trainer(cfg_t, TrainConfig(), T.ShiftedExponential(), n_workers=N, scheme="xf",
                budget=MemBudget.from_gb(1), device="cpu")


def test_reference_registry_extension_leaves_the_comparison_whole(tpu_hw, monkeypatch):
    """A scheme registered in the reference's registry first — as
    ``tests/test_schemes_plan.py`` registers one for good — is priced by
    the reference's search and not by the port's; with the registry held
    to the port's schemes the reports are equal again."""
    monkeypatch.setattr(J_schemes, "_REGISTRY", dict(J_schemes._REGISTRY))
    monkeypatch.setattr(J_schemes, "_ALIASES", dict(J_schemes._ALIASES))

    @J_schemes.register_scheme("test-only-extra", kind="extra", aliases=("test-extra",))
    def _extra(dist, n_workers, total, *, cost=None, rng=0, s_cap=None):
        return np.full(n_workers, total / n_workers)

    assert "test-only-extra" in J.available_schemes()
    assert "test-only-extra" not in T.available_schemes()
    env_t, env_j = _envs("iid")
    kw = dict(s_cap=1, steps=40)
    plan_t = autotune_plan(COSTS, env_t, device="cpu", **kw)
    wider = j_autotune_plan(COSTS, env_j, **kw).tune_report
    assert wider.to_dict()["n_candidates"] > plan_t.tune_report.to_dict()["n_candidates"]
    _port_schemes_only(monkeypatch)
    assert J.available_schemes() == T.available_schemes()
    _reports_equal(plan_t.tune_report, j_autotune_plan(COSTS, env_j, **kw).tune_report, 0.0)


def test_launcher_autotune_flags(capsys):
    args = launch_train.parse_args(["--autotune", "--hbm-gb", "3"])
    assert args.autotune and args.hbm_gb == 3.0
    trainer = launch_train.main(["--reduced", "--hbm-gb", "64", "--steps", "2", "--seq", "16",
                                 "--global-batch", "8", "--device", "cpu", "--log-every", "0"])
    out = capsys.readouterr().out.splitlines()
    report = trainer.tune_report
    assert f"autotune: {len(report.candidates)} admissible, {len(report.pruned)} pruned " \
           f"(budget 64 GiB)" in out
    assert f"selected {report.best.label()}" in out
    assert len(trainer.history) == 2 and all(np.isfinite(h["loss"]) for h in trainer.history)
