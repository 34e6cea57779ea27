"""Adaptive re-planning in the port against the JAX reference, on the CPU.

The port keeps its own copies of the numpy layers the re-planner runs
on, so the decisions must be the reference's exactly, not merely close:

* plan layer: ``Env.from_trace`` and the Monte-Carlo order statistics of
  heterogeneous and faulted populations, ``spsg`` cold and warm-started,
  the eq. (2)/(5) runtimes and ``tau_hat_batch`` are bit-identical;
  ``Trace`` and ``Plan.to_dict`` of a re-planned plan are JSON-identical;
* monitor and controller: the same ``DriftReport``s on a seeded
  step-change stream, the same ``SwapEvent``s (round, x_old, x_new, gain)
  on full-width gc-lm-110m's plan — the swap step ``chip_smoke.py``'s
  ``[adapt]`` phase asserts on the card — and the gain gate refuses a
  uniform slowdown;
* ``Trainer(adapt=...)`` against the JAX ``Trainer``: the swap steps and
  x are exact, the ledger is bit-identical, losses and parameters agree
  to the three-step parity's tolerances (loss 1e-5, parameters 3e-6).
"""
import json
import warnings

import jax
import numpy as np
import pytest
import torch

from repro.adapt import AdaptConfig as JAdaptConfig
from repro.adapt import AdaptiveController as JController
from repro.adapt.monitor import RuntimeMonitor as JMonitor
from repro.adapt.monitor import ks_2sample as jks_2sample
from repro.configs import get_config as jax_get_config
from repro.core import DegradedWorker as JDegraded
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ScaledStraggler as JScaled
from repro.core import ShiftedExponential as JShiftedExp
from repro.core import runtime as jruntime
from repro.core.schemes import scheme_accepts_warm_start as j_accepts_warm_start
from repro.core.schemes import solve_scheme as j_solve_scheme
from repro.core.solvers import spsg as jspsg
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.sim.trace import Trace as JTrace
from repro.train.state import abstract_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.adapt import AdaptConfig, AdaptiveController, RuntimeMonitor
from repro_torch.adapt.monitor import ks_2sample
from repro_torch.configs import get_config
from repro_torch.core import (DegradedWorker, Env, Plan, ScaledStraggler, ShiftedExponential,
                              runtime, scheme_accepts_warm_start, solve_scheme, spsg)
from repro_torch.core.schemes import SchemeWarning
from repro_torch.models.params import GCLM, params_to_numpy
from repro_torch.sim import Trace
from repro_torch.train.trainer import TrainConfig, Trainer

N = 4
KW = dict(n_layers=2, d_model=128)
SE, JSE = ShiftedExponential(mu=1e-3, t0=50.0), JShiftedExp(mu=1e-3, t0=50.0)
#: chip_smoke.py's [adapt] env: workers 2 and 3 five times slower from round 2
CHIP_FAULTS = [dict(worker=2, factor=5.0, from_round=2), dict(worker=3, factor=5.0, from_round=2)]
#: with seed 0 the controller below swaps after this many observed rounds
CHIP_SWAP_ROUND = 24


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The tensors here are small: one intra-op thread keeps torch's
    thread pool from spinning on cores that other test processes share
    (a run of this module's trainers went from minutes to seconds under
    a loaded pytest-xdist run).  Every comparison runs in one setting."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(blob):
    return json.dumps(blob, sort_keys=True)


def _times(seed, rounds=24):
    rng = np.random.default_rng(seed)
    t = SE.sample(rng, (rounds, N))
    t[:, 1] *= 3.0
    return t


def _envs(kind):
    """The same population in both packages."""
    if kind == "trace":
        t = _times(1)
        return (Env.from_trace(Trace.from_times(t), mc_samples=4000),
                JEnv.from_trace(JTrace.from_times(t), mc_samples=4000))
    if kind == "heterogeneous":
        return (Env.heterogeneous([SE, SE, ScaledStraggler(base=SE, factor=2.5), SE],
                                  mc_samples=4000),
                JEnv.heterogeneous([JSE, JSE, JScaled(base=JSE, factor=2.5), JSE],
                                   mc_samples=4000))
    # static and mid-run degradations: the solver folds in the static one
    return (Env.iid(SE, N, mc_samples=4000).with_faults(DegradedWorker(0, 3.0),
                                                        DegradedWorker(1, 5.0, from_round=4)),
            JEnv.iid(JSE, N, mc_samples=4000).with_faults(JDegraded(0, 3.0),
                                                          JDegraded(1, 5.0, from_round=4)))


# ---------------------------------------------------------------- plan layer
@pytest.mark.parametrize("kind", ["trace", "heterogeneous", "faulted"])
def test_env_order_statistics_bit_identical(kind):
    env, jenv = _envs(kind)
    assert _json(env.to_dict()) == _json(jenv.to_dict())
    assert _json(Env.from_dict(json.loads(_json(jenv.to_dict()))).to_dict()) \
        == _json(jenv.to_dict())
    view, jview = env.solver_view(), jenv.solver_view()
    assert _json(view.to_dict()) == _json(jview.to_dict())
    for rng in (0, 7):
        np.testing.assert_array_equal(env.expected_order_stats(N, rng),
                                      jenv.expected_order_stats(N, rng))
        np.testing.assert_array_equal(view.inv_expected_inv_order_stats(N, rng),
                                      jview.inv_expected_inv_order_stats(N, rng))
    np.testing.assert_array_equal(env.means(), jenv.means())
    assert env.mean() == jenv.mean()
    np.testing.assert_array_equal(env.sample_sorted(3, N, 50), jenv.sample_sorted(3, N, 50))
    for scheme in ("xf", "xt"):
        np.testing.assert_array_equal(solve_scheme(scheme, env, N, 20_000),
                                      j_solve_scheme(scheme, jenv, N, 20_000))


def test_trace_json_identical_and_validated():
    t = _times(2, rounds=6)
    tr, jtr = Trace.from_times(t, meta={"source": "test"}), JTrace.from_times(t, meta={"source": "test"})
    assert _json(tr.to_dict()) == _json(jtr.to_dict())
    assert _json(Trace.from_dict(jtr.to_dict()).to_dict()) == _json(jtr.to_dict())
    assert _json(tr.to_env(per_worker=False).to_dict()) \
        == _json(jtr.to_env(per_worker=False).to_dict())
    for bad in (t[0], -t, np.full((2, N), np.inf)):
        with pytest.raises(ValueError):
            Trace.from_times(bad)


@pytest.mark.parametrize("warm", [False, True])
def test_spsg_bit_identical_cold_and_warm(warm):
    env, jenv = _envs("heterogeneous")
    seed = np.asarray([9000.0, 1.0, 3000.0, 8000.0]) if warm else None
    kw = dict(n_iters=120, batch=16, rng=3, warm_start=seed, eval_every=40, eval_samples=500)
    got, want = spsg(env, N, 20_000.0, **kw), jspsg(jenv, N, 20_000.0, **kw)
    np.testing.assert_array_equal(got.x, want.x)
    np.testing.assert_array_equal(got.x_last, want.x_last)
    assert got.history == want.history and len(got.history) == 3
    assert got.x.sum() == pytest.approx(20_000.0)


def test_spsg_scheme_and_warm_start_threading():
    assert scheme_accepts_warm_start("spsg") and j_accepts_warm_start("spsg")
    assert not scheme_accepts_warm_start("xf")
    x_seed = solve_scheme("xt", SE, N, 1000)
    for warm in (None, x_seed):
        np.testing.assert_array_equal(solve_scheme("spsg", SE, N, 1000, warm_start=warm),
                                      j_solve_scheme("spsg", JSE, N, 1000, warm_start=warm))
    with pytest.warns(SchemeWarning, match="discarded"):
        got = solve_scheme("xf", SE, N, 1000, warm_start=x_seed)
    np.testing.assert_array_equal(got, solve_scheme("xf", SE, N, 1000))
    model = GCLM(get_config("gc-lm-110m").reduced(**KW), device="meta")
    warm = Plan.build(model, SE, N, scheme="spsg", warm_start=x_seed * 20)
    shapes = abstract_train_state(jax_get_config("gc-lm-110m").reduced(**KW))[0].params
    assert _json(warm.to_dict()) == _json(
        JPlan.build(shapes, JSE, N, scheme="spsg", warm_start=x_seed * 20).to_dict())
    assert warm.partition_key() == JPlan.from_dict(warm.to_dict()).partition_key()
    np.testing.assert_array_equal(warm.level_index(),
                                  JPlan.from_dict(warm.to_dict()).level_index())


def test_runtimes_bit_identical():
    rng = np.random.default_rng(5)
    draws = SE.sample(rng, (64, N))
    x = np.asarray([8000.0, 2000.0, 4000.0, 6000.0])
    s = np.asarray([0, 0, 1, 3, 2, 3])
    np.testing.assert_array_equal(runtime.tau_hat_batch(x, draws),
                                  jruntime.tau_hat_batch(x, draws))
    np.testing.assert_array_equal(runtime.subgradient_tau_hat(x, draws),
                                  jruntime.subgradient_tau_hat(x, draws))
    assert runtime.tau_hat(x, draws[0]) == jruntime.tau_hat(x, draws[0])
    assert runtime.tau(s, draws[1]) == jruntime.tau(s, draws[1])
    assert runtime.expected_tau_hat(x, SE, N, n_samples=500) == \
        jruntime.expected_tau_hat(x, JSE, N, n_samples=500)


# --------------------------------------------------------- monitor and controller
def _report_tuple(rep):
    return (rep.fired, rep.ks.tolist(), rep.ks_threshold, rep.mean_shift.tolist(),
            rep.mean_threshold, rep.worker)


def test_monitor_drift_reports_identical():
    rng = np.random.default_rng(21)
    mon, jmon = RuntimeMonitor(N, window=32, min_rounds=16), JMonitor(N, window=32, min_rounds=16)
    fired = []
    for r in range(48):
        t = SE.sample(rng, (N,))
        if r >= 24:
            t[3] *= 4.0  # step change of one worker
        mon.observe(t)
        jmon.observe(t)
        rep, jrep = mon.drift(), jmon.drift()
        assert _report_tuple(rep) == _report_tuple(jrep), r
        base = np.full(N, SE.mean())
        assert _report_tuple(mon.shift_from(base)) == _report_tuple(jmon.shift_from(base)), r
        fired.append(rep.fired)
    assert not any(fired[:24]) and any(fired[24:])
    assert _json(mon.estimated_env().to_dict()) == _json(jmon.estimated_env().to_dict())
    a, b = rng.standard_normal(17), rng.standard_normal(11) + 0.5
    assert ks_2sample(a, b) == jks_2sample(a, b)
    with pytest.raises(ValueError):
        mon.observe(np.ones(N + 1))


@pytest.fixture(scope="module")
def full_width_plans():
    """Full-width gc-lm-110m's plan under chip_smoke.py's [adapt] env."""
    model = GCLM(get_config("gc-lm-110m"), device="meta")
    shapes = abstract_train_state(jax_get_config("gc-lm-110m"))[0].params
    env = Env.iid(SE, N).with_faults(*(DegradedWorker(**f) for f in CHIP_FAULTS))
    jenv = JEnv.iid(JSE, N).with_faults(*(JDegraded(**f) for f in CHIP_FAULTS))
    return model, shapes, env, jenv


def _drive(ctl, jctl, plan, jplan, env, jenv, rounds):
    sim, jsim = plan.simulator(env, seed=0), jplan.simulator(jenv, seed=0)
    for r in range(rounds):
        (_, rec), (_, jrec) = sim.step(), jsim.step()
        np.testing.assert_array_equal(rec["times"], jrec["times"])
        new, jnew = ctl.observe(rec["times"]), jctl.observe(jrec["times"])
        assert (new is None) == (jnew is None), r
        if new is not None:
            assert _json(new.to_dict()) == _json(jnew.to_dict())
            sim.plan, jsim.plan = new, jnew


def _swap_tuple(ev):
    return (ev.round_idx, ev.x_old.tolist(), ev.x_new.tolist(), ev.predicted_gain,
            _report_tuple(ev.drift))


def test_controller_swaps_identical_at_full_width(full_width_plans):
    model, shapes, env, jenv = full_width_plans
    plan, jplan = Plan.build(model, env, scheme="xf"), JPlan.build(shapes, jenv, scheme="xf")
    assert _json(plan.to_dict()) == _json(jplan.to_dict())
    assert plan.x.tolist() == [5783, 2751, 3689, 7777]
    cfg = dict(window=16, min_rounds=8, check_every=2)
    ctl = AdaptiveController(AdaptConfig(**cfg), plan, model)
    jctl = JController(JAdaptConfig(**cfg), jplan, shapes)
    # the controller holds shapes only, never the parameters' storage
    assert all(t.device.type == "meta" for t in ctl.params_or_costs)
    _drive(ctl, jctl, plan, jplan, env, jenv, CHIP_SWAP_ROUND + 2)
    assert [_swap_tuple(e) for e in ctl.swaps] == [_swap_tuple(e) for e in jctl.swaps]
    assert [e.round_idx for e in ctl.swaps] == [CHIP_SWAP_ROUND]
    assert ctl.plan.leaf_levels.tolist()[:3] == [1, 2, 2]  # leaves change levels
    assert ctl.checks == jctl.checks


def test_gain_gate_refuses_a_uniform_slowdown(full_width_plans):
    model, shapes, _, _ = full_width_plans
    env, jenv = Env.iid(SE, N), JEnv.iid(JSE, N)
    plan, jplan = Plan.build(model, env, scheme="xf"), JPlan.build(shapes, jenv, scheme="xf")
    cfg = dict(window=16, min_rounds=8, check_every=2)
    ctl = AdaptiveController(AdaptConfig(**cfg), plan, model)
    jctl = JController(JAdaptConfig(**cfg), jplan, shapes)
    rng = np.random.default_rng(13)
    for _ in range(60):
        t = 3.0 * SE.sample(rng, (N,))  # every worker 3x slower
        assert ctl.observe(t) is None and jctl.observe(t) is None
    assert ctl.swaps == [] and ctl.checks == jctl.checks > 0


# ------------------------------------------------------------------ trainer
def test_trainer_adapt_matches_reference_trainer():
    """Workers 2 and 3 eight times slower from round 2: both trainers swap
    after the 16th step to the same plan and go on in step."""
    seq, steps = 16, 18
    faults = [dict(worker=w, factor=8.0, from_round=2) for w in (2, 3)]
    cfg_t, cfg_j = get_config("gc-lm-110m").reduced(**KW), jax_get_config("gc-lm-110m").reduced(**KW)
    ad = dict(window=16, min_rounds=8, check_every=2)
    ref = JTrainer(cfg_j, JTrainConfig(warmup=2, total_steps=40),
                   JEnv.iid(JSE, N).with_faults(*(JDegraded(**f) for f in faults)),
                   scheme="xf", global_batch=8, seed=0, adapt=JAdaptConfig(**ad))
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq, global_batch=8,
                                            seed=0))
    init = jax.tree.map(np.asarray, ref.state.params)
    ours = Trainer(cfg_t, TrainConfig(warmup=2, total_steps=40),
                   Env.iid(SE, N).with_faults(*(DegradedWorker(**f) for f in faults)),
                   scheme="xf", global_batch=8, seed=0, device="cpu", params=init,
                   seq_len=seq, adapt=AdaptConfig(**ad))
    with warnings.catch_warnings():
        warnings.simplefilter("error")  # no discarded warm start, no other warning
        _, sum_t = ours.run(steps, log_every=0)
    _, sum_j = ref.run(steps, log_every=0)
    assert sum_t == sum_j
    for rt, rj in zip(ours.sim.ledger, ref.sim.ledger, strict=True):
        np.testing.assert_array_equal(rt["times"], rj["times"])
        assert (rt["tau_coded"], rt["tau_uncoded"]) == (rj["tau_coded"], rj["tau_uncoded"])
    assert [_swap_tuple(e) for e in ours.controller.swaps] == \
        [_swap_tuple(e) for e in ref.controller.swaps]
    swapped = [h["step"] for h in ours.history if h.get("plan_swap")]
    assert swapped == [h["step"] for h in ref.history if h.get("plan_swap")] == [16]
    assert _json(ours.plan.to_dict()) == _json(ref.plan.to_dict())
    assert ours.plan is ours.controller.plan is ours.sim.plan
    for ht, hj in zip(ours.history, ref.history, strict=True):
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6)
