"""The port's copied straggler models, schemes, cost functions and
simulators against the JAX reference's, on the CPU.

``repro_torch.core`` and ``repro_torch.sim`` are copies of ``repro.core``
and ``repro.sim`` (the port imports nothing of ``repro``), so the numpy
layer must be bit-identical, not merely close: every distribution's
``sample``/``cdf``/``mean``, every registered scheme's ``x`` on every
population, the realized-cost functions, ``brute_force_int``,
``completion_trace``, the ``eq2`` and ``event`` ledgers of
``Plan.simulate`` and the event engine's timelines (faults,
``comm_delay``, ``cancel_decoded``, waves).  Only ``sim/mc.py`` is torch:
it runs in fp32, as the reference's jitted function runs in jax's default
fp32, so it is held to the reference's ``mc`` within 1e-6 relative and to
the fp64 ``eq2`` ledger within 1e-4 (``tests/test_sim_mc.py``).  Every
population is built in the reference and handed to the port through its
exact JSON form (``to_dict``/``from_dict``), which the tests hold too.
"""
import json
import os

import numpy as np
import pytest
import torch

import repro.core as J
import repro.sim as JS
import repro_torch.core as T
import repro_torch.sim as TS
from repro.core import runtime as jrt
from repro.core.distributions import dist_from_dict as j_dist_from_dict
from repro.sim import faults as jfaults
from repro.sim import mc as jmc
from repro_torch.core import runtime as trt
from repro_torch.sim import faults as tfaults
from repro_torch.sim import mc as tmc

SE = dict(mu=1e-3, t0=50.0)
COSTS = np.asarray([3.0, 1.0, 4.0, 1.0, 5.0, 9.0, 2.0, 6.0])
SCHEMES = ["xt", "xf", "spsg", "uniform", "single-bcgc", "tandon-alpha", "ferdinand-l",
           "ferdinand-l2", "single-real"]
#: reduced Monte-Carlo order-statistic sample counts keep the scheme
#: sweep fast; the code path is the default one
MC = 20_000


def _iid(dist):
    return lambda n: J.Env.iid(dist, n)


def _het(n):
    fast = J.ShiftedExponential(mc_samples=MC, **SE)
    slow = J.ScaledStraggler(base=fast, factor=2.5)
    return J.Env.heterogeneous([fast] * (n - 2) + [slow] * 2, mc_samples=MC)


def _het_faulted(n):
    """Heterogeneous plus a static degradation (folded into the solver
    view) and a death (dropped from it)."""
    return _het(n).with_faults(J.DegradedWorker(0, 1.5), J.WorkerDeath(1, at_round=50))


#: every population of the sweep, built in the reference
POPULATIONS = {
    "shifted-exp": _iid(J.ShiftedExponential(**SE)),
    "bernoulli": _iid(J.BernoulliStraggler(p_straggle=0.2, t_fast=1.0, t_slow=8.0,
                                           mc_samples=MC)),
    "pareto": _iid(J.ParetoStraggler(alpha=2.5, t_min=1.0, mc_samples=MC)),
    "lognormal": _iid(J.LogNormalStraggler(mu_log=0.0, sigma_log=0.75, shift=0.5,
                                           mc_samples=MC)),
    "uniform": _iid(J.UniformStraggler(lo=0.5, hi=1.5, mc_samples=MC)),
    "mixture": _iid(J.MixtureStraggler(
        components=(J.ShiftedExponential(**SE),
                    J.ScaledStraggler(base=J.ShiftedExponential(**SE), factor=3.0)),
        weights=(0.7, 0.3), mc_samples=MC)),
    "heterogeneous": _het,
    "heterogeneous-faulted": _het_faulted,
}

#: one distribution of every registered class, built in the reference
DISTS = {
    "shifted-exp": J.ShiftedExponential(**SE),
    "bernoulli": J.BernoulliStraggler(p_straggle=0.2, t_fast=1.0, t_slow=8.0),
    "pareto": J.ParetoStraggler(alpha=2.5, t_min=1.0),
    "pareto-heavy": J.ParetoStraggler(alpha=0.9, t_min=2.0),
    "lognormal": J.LogNormalStraggler(mu_log=0.2, sigma_log=0.5, shift=1.0),
    "uniform": J.UniformStraggler(lo=0.5, hi=1.5),
    "empirical": J.EmpiricalStraggler(trace=(3.0, 1.0, 4.0, 1.0, 5.0, 9.0)),
    "scaled": J.ScaledStraggler(base=J.UniformStraggler(), factor=2.5),
    "mixture": J.MixtureStraggler(components=(J.UniformStraggler(), J.ShiftedExponential(**SE)),
                                  mc_samples=MC),
    "mixture-weighted": J.MixtureStraggler(
        components=(J.BernoulliStraggler(), J.LogNormalStraggler(), J.ParetoStraggler()),
        weights=(1.0, 2.0, 1.0), mc_samples=MC),
}


def _port_env(env_j):
    """The reference's env, carried into the port by its exact JSON form."""
    blob = json.loads(json.dumps(env_j.to_dict()))
    env_t = T.Env.from_dict(blob)
    assert env_t.to_dict() == env_j.to_dict()
    return env_t


def _port_dist(d_j):
    blob = json.loads(json.dumps(J.dist_to_dict(d_j)))
    d_t = T.dist_from_dict(blob)
    assert T.dist_to_dict(d_t) == J.dist_to_dict(d_j) == blob
    assert j_dist_from_dict(T.dist_to_dict(d_t)) == d_j
    return d_t


# ------------------------------------------------------------ distributions
@pytest.mark.parametrize("name", sorted(DISTS))
def test_distributions_bit_equal_and_round_trip(name):
    d_j = DISTS[name]
    d_t = _port_dist(d_j)
    for shape in [(7,), (5, 4)]:
        np.testing.assert_array_equal(d_t.sample(np.random.default_rng(3), shape),
                                      d_j.sample(np.random.default_rng(3), shape))
    t = np.linspace(-1.0, 3000.0, 41)
    with np.errstate(invalid="ignore"):
        np.testing.assert_array_equal(d_t.cdf(t), d_j.cdf(t))
    assert d_t.mean() == d_j.mean()
    assert d_t.replace(mc_samples=7) == T.dist_from_dict(
        J.dist_to_dict(d_j.replace(mc_samples=7)))


def test_shifted_exponential_median_and_env_marginals():
    d_j = J.ShiftedExponential(**SE)
    assert _port_dist(d_j).median() == d_j.median()
    for env_j in (_het(4), _het_faulted(5), J.Env.iid(d_j, 3)):
        env_t = _port_env(env_j)
        assert (env_t.iid_dist is None) == (env_j.iid_dist is None)
        if env_j.iid_dist is not None:
            assert T.dist_to_dict(env_t.iid_dist) == J.dist_to_dict(env_j.iid_dist)
        assert T.dist_to_dict(env_t.pooled()) == J.dist_to_dict(env_j.pooled())
        np.testing.assert_array_equal(env_t.pooled().sample(np.random.default_rng(1), (9,)),
                                      env_j.pooled().sample(np.random.default_rng(1), (9,)))
    with pytest.raises(ValueError):
        T.MixtureStraggler()
    with pytest.raises(ValueError):
        T.MixtureStraggler(components=(T.UniformStraggler(),), weights=(1.0, 2.0))


# ------------------------------------------------------------------ schemes
def test_all_nine_reference_schemes_registered():
    assert T.available_schemes() == J.available_schemes()
    for name in J.available_schemes():
        st, sj = T.get_scheme(name), J.get_scheme(name)
        assert (st.display, st.kind, st.aliases, st.description) \
            == (sj.display, sj.kind, sj.aliases, sj.description)
        for alias in sj.aliases:
            assert T.get_scheme(alias).name == name
    with pytest.raises(KeyError, match="unknown scheme"):
        T.get_scheme("not-a-scheme")


@pytest.mark.parametrize("n", [3, 4, 6])
@pytest.mark.parametrize("population", sorted(POPULATIONS))
def test_every_scheme_x_bit_identical(population, n):
    env_j = POPULATIONS[population](n)
    env_t = _port_env(env_j)
    total = 20_000
    for scheme in SCHEMES:
        if scheme == "spsg" and n != 4:  # the subgradient solve is slow; one N covers it
            continue
        for s_cap in (None, 1):
            x_t = T.solve_scheme(scheme, env_t, n, total, s_cap=s_cap)
            x_j = J.solve_scheme(scheme, env_j, n, total, s_cap=s_cap)
            assert x_t.dtype == x_j.dtype
            np.testing.assert_array_equal(x_t, x_j, err_msg=f"{scheme} s_cap={s_cap}")
            assert x_t.sum() == total


def test_scheme_bank_and_baseline_functions_bit_identical():
    env_j = _het(5)
    env_t = _port_env(env_j)
    bank_t, bank_j = T.scheme_bank(env_t, 5, 1000), J.scheme_bank(env_j, 5, 1000)
    assert list(bank_t) == list(bank_j) == ["ferdinand-l", "ferdinand-l2", "single-bcgc",
                                            "tandon-alpha"]
    for k in bank_j:
        np.testing.assert_array_equal(bank_t[k], bank_j[k])
    from repro.core import baselines as jb
    from repro_torch.core import baselines as tb

    for k, v in tb.scheme_bank(env_t, 5, 1000).items():
        np.testing.assert_array_equal(v, jb.scheme_bank(env_j, 5, 1000)[k])
    d_j = J.LogNormalStraggler(mc_samples=MC)
    d_t = _port_dist(d_j)
    assert T.tandon_alpha_level(d_t, 6) == J.tandon_alpha_level(d_j, 6)
    np.testing.assert_array_equal(T.single_bcgc(d_t, 6, 99), J.single_bcgc(d_j, 6, 99))
    np.testing.assert_array_equal(T.ferdinand_x(d_t, 6, 100, n_layers=7),
                                  J.ferdinand_x(d_j, 6, 100, n_layers=7))


# ------------------------------------------------------------ numpy helpers
def test_brute_force_realized_costs_and_completion_trace_equal():
    d_j = J.ShiftedExponential(**SE)
    d_t = _port_dist(d_j)
    x_t, v_t = T.brute_force_int(d_t, 3, 6, n_samples=2000, rng=1)
    x_j, v_j = J.brute_force_int(d_j, 3, 6, n_samples=2000, rng=1)
    np.testing.assert_array_equal(x_t, x_j)
    assert v_t == v_j
    rng = np.random.default_rng(5)
    draws = d_j.sample(rng, (64, 5))
    for x in ([10.0, 0.0, 5.0, 0.0, 1.0], [0.0, 0.0, 0.0, 0.0, 0.0], [1.0, 2.0, 3.0, 4.0, 5.0]):
        for active_only in (True, False):
            np.testing.assert_array_equal(
                trt.tau_hat_realized_batch(x, draws, active_only=active_only),
                jrt.tau_hat_realized_batch(x, draws, active_only=active_only))
        np.testing.assert_array_equal(trt.subgradient_tau_hat_realized(x, draws),
                                      jrt.subgradient_tau_hat_realized(x, draws))
    x = [4.0, 0.0, 3.0, 1.0, 2.0]
    assert trt.expected_tau_hat_realized(x, d_t, 5, n_samples=500, rng=2) \
        == jrt.expected_tau_hat_realized(x, d_j, 5, n_samples=500, rng=2)
    s, times = np.asarray([1, 1, 2, 2, 0]), draws[0]
    for a, b in zip(T.completion_trace(s, times), J.completion_trace(s, times)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------- ledgers
def _plans(scheme="xf", n=5, env_j=None):
    env_j = env_j if env_j is not None else J.Env.iid(J.ShiftedExponential(**SE), n)
    env_t = _port_env(env_j)
    plan_j = J.Plan.build(COSTS, env_j, scheme=scheme)
    plan_t = T.Plan.build(COSTS, env_t, scheme=scheme)
    assert plan_t.to_dict() == plan_j.to_dict()
    return plan_t, plan_j, env_t, env_j


def _ledger_equal(sim_t, sim_j):
    assert len(sim_t.ledger) == len(sim_j.ledger)
    for a, b in zip(sim_t.ledger, sim_j.ledger):
        np.testing.assert_array_equal(a["times"], b["times"])
        # nan (an uncovered death: inf - inf) equals nan here
        np.testing.assert_array_equal([a["tau_coded"], a["tau_uncoded"]],
                                      [b["tau_coded"], b["tau_uncoded"]])
    assert json.dumps(sim_t.summary()) == json.dumps(sim_j.summary())


@pytest.mark.parametrize("env_name", ["iid", "degraded", "heterogeneous"])
@pytest.mark.parametrize("backend", ["eq2", "event"])
def test_eq2_and_event_ledgers_bit_identical(backend, env_name):
    n = 5
    env_j = {"iid": J.Env.iid(J.ShiftedExponential(**SE), n),
             "degraded": J.Env.iid(J.ShiftedExponential(**SE), n).with_faults(
                 J.DegradedWorker(2, 3.0, from_round=5)),
             "heterogeneous": _het(n)}[env_name]
    plan_t, plan_j, env_t, _ = _plans("xf", n, env_j)
    _ledger_equal(plan_t.simulate(env_t, 24, seed=9, backend=backend),
                  plan_j.simulate(env_j, 24, seed=9, backend=backend))
    # the plan's bound env when none is passed; its full decode weights
    _ledger_equal(plan_t.simulate(steps=3, backend=backend),
                  plan_j.simulate(steps=3, backend=backend))
    np.testing.assert_array_equal(plan_t.full_decode_weights(), plan_j.full_decode_weights())
    assert plan_t.solver == plan_j.solver == "xf"


@pytest.mark.parametrize("death", [dict(at_round=6), dict(at_time=2.5e8)])
def test_event_ledger_prices_deaths_like_the_reference(death):
    """A death: eq2 and mc raise in both packages; the event engine
    prices an uncovered death at infinity and the uncoded ledger stalls
    from the round it hits — bit-identical."""
    n = 5
    env_j = J.Env.iid(J.ShiftedExponential(**SE), n).with_faults(
        J.WorkerDeath(0, **death), J.WorkerDeath(3, **death))
    plan_t, plan_j, env_t, _ = _plans("xt", n, env_j)
    sim_t = plan_t.simulate(env_t, 12, seed=4, backend="event")
    _ledger_equal(sim_t, plan_j.simulate(env_j, 12, seed=4, backend="event"))
    assert np.isinf([r["tau_uncoded"] for r in sim_t.ledger]).any()
    for backend in ("eq2", "mc"):
        with pytest.raises(ValueError, match="WorkerDeath"):
            plan_t.simulate(env_t, 3, backend=backend, device="cpu")
    with pytest.raises(ValueError, match="backend"):
        plan_t.simulate(env_t, 2, backend="nope")


def _results_equal(rt, rj):
    for f in ("times", "decode_times", "round_done", "worker_busy", "round_start"):
        np.testing.assert_array_equal(getattr(rt, f), getattr(rj, f))
    assert (rt.makespan, rt.stalled, rt.undecoded) == (rj.makespan, rj.stalled, rj.undecoded)
    assert rt.deliver_sets == rj.deliver_sets
    assert rt.summary() == rj.summary()
    np.testing.assert_array_equal(rt.round_durations(), rj.round_durations())
    if not rt.stalled:
        assert rt.wave_trace().to_dict() == rj.wave_trace().to_dict()


@pytest.mark.parametrize("config", [
    dict(wave=False),
    dict(wave=True, comm_delay=40.0, cancel_decoded=True),
    dict(wave=True, staleness=1, update_cost=5e4, broadcast_latency=1e3, comm_delay=7.5),
    dict(wave=False, comm_delay=3e4, cancel_decoded=True),
])
def test_event_engine_timelines_bit_identical(config):
    """``simulate_plan``/``simulate_x`` pass the engine's keywords through
    (``comm_delay`` and ``cancel_decoded`` among them); a throttled
    worker, a death mid-run and per-worker distribution lists included."""
    n = 5
    plan_t, plan_j, _, _ = _plans("xf", n)
    faults_j = (J.DegradedWorker(1, 4.0, from_round=2), J.WorkerDeath(4, at_round=3))
    faults_t = (T.DegradedWorker(1, 4.0, from_round=2), T.WorkerDeath(4, at_round=3))
    _results_equal(TS.simulate_plan(plan_t, rounds=6, seed=3, faults=faults_t, **config),
                   JS.simulate_plan(plan_j, rounds=6, seed=3, faults=faults_j, **config))
    x = J.solve_scheme("xt", J.ShiftedExponential(**SE), n, 1000)
    dists_j = jfaults.heterogeneous(J.ShiftedExponential(**SE), n,
                                    {2: J.ShiftedExponential(mu=1e-4, t0=50.0)})
    dists_t = tfaults.heterogeneous(_port_dist(J.ShiftedExponential(**SE)), n,
                                    {2: T.ShiftedExponential(mu=1e-4, t0=50.0)})
    assert [T.dist_to_dict(d) for d in dists_t] == [J.dist_to_dict(d) for d in dists_j]
    _results_equal(TS.simulate_x(x, dists_t, n, rounds=4, seed=8, **config),
                   JS.simulate_x(x, dists_j, n, rounds=4, seed=8, **config))
    with pytest.raises(ValueError):
        TS.simulate_x(x, dists_t, n, comm_delay=-1.0)
    with pytest.raises(ValueError):
        tfaults.heterogeneous(T.ShiftedExponential(), 3, {3: T.ShiftedExponential()})


def test_trace_record_and_replay_equal():
    env_j = _het(4)
    env_t = _port_env(env_j)
    tr_t = TS.Trace.record(env_t, 6, 4, seed=2, meta={"src": "test"})
    tr_j = JS.Trace.record(env_j, 6, 4, seed=2, meta={"src": "test"})
    assert tr_t.to_dict() == tr_j.to_dict()
    plan_t, plan_j, _, _ = _plans("xt", 4)
    res_t = TS.ClusterSim(TS.schedule_from_plan(plan_t), env_t, 4, wave=False).run(
        6, times=tr_t.replay())
    res_j = JS.ClusterSim(JS.schedule_from_plan(plan_j), env_j, 4, wave=False).run(
        6, times=tr_j.replay())
    _results_equal(res_t, res_j)
    assert res_t.trace(meta={"a": 1}).to_dict() == res_j.trace(meta={"a": 1}).to_dict()
    replay = tr_t.replay()
    replay[0, 0] = -1.0  # a copy: the trace stays intact
    assert tr_t.times[0, 0] > 0


@pytest.mark.parametrize("fault", ["torn_write", "flip_bit", "drop_shard"])
def test_storage_fault_injectors_equal(tmp_path, fault):
    payload = bytes(range(256)) * 3
    paths = []
    for pkg in ("t", "j"):
        path = tmp_path / f"shard_{pkg}.bin"
        path.write_bytes(payload)
        paths.append(str(path))
    args = {"torn_write": (0.3,), "flip_bit": (17, 5), "drop_shard": ()}[fault]
    getattr(tfaults, fault)(paths[0], *args)
    getattr(jfaults, fault)(paths[1], *args)
    if fault == "drop_shard":
        assert not os.path.exists(paths[0]) and not os.path.exists(paths[1])
    else:
        got = open(paths[0], "rb").read()
        assert got == open(paths[1], "rb").read() and got != payload
    with pytest.raises(ValueError):
        tfaults.torn_write(str(tmp_path / "x"), 1.0)
    with pytest.raises(ValueError):
        tfaults.flip_bit(str(tmp_path / "x"), 0, 8)


# ----------------------------------------------------------------------- mc
@pytest.mark.parametrize("shape", [(512, 8), (16, 5, 8)])
def test_mc_runtime_matches_reference_mc(shape):
    """Single-round (S, N) and multi-round barrier (S, R, N) totals: the
    port's torch fp32 within 1e-6 of the reference's jax fp32, and both
    within 1e-4 of the fp64 closed form."""
    dist = J.ShiftedExponential(**SE)
    x = J.solve_scheme("xf", dist, 8, 5000)
    times = dist.sample(np.random.default_rng(1), shape)
    sched_t, sched_j = TS.schedule_from_x(x), JS.schedule_from_x(x)
    assert [(b.index, b.level, b.work) for b in sched_t] \
        == [(b.index, b.level, b.work) for b in sched_j]
    got = tmc.runtime_batch(sched_t, times, device="cpu")
    np.testing.assert_allclose(got, jmc.runtime_batch(sched_j, times), rtol=1e-6)
    want = (J.tau_hat_batch(x, times) if len(shape) == 2
            else np.stack([J.tau_hat_batch(x, t).sum() for t in times]))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    if len(shape) == 2:
        dt = tmc.decode_times_batch(sched_t, times, device="cpu")
        np.testing.assert_allclose(dt, jmc.decode_times_batch(sched_j, times), rtol=1e-6)
        np.testing.assert_allclose(dt.max(axis=1), got, rtol=1e-6)
    with pytest.raises(ValueError):
        tmc.runtime_batch(sched_t, times.reshape(-1)[:8], device="cpu")


def test_mc_cluster_size_mismatch_raises_and_device_is_required():
    x = J.solve_scheme("xf", J.ShiftedExponential(**SE), 8, 5000)  # levels up to 7
    t4 = J.ShiftedExponential(**SE).sample(np.random.default_rng(6), (16, 4))
    with pytest.raises(ValueError, match="n_workers"):
        tmc.runtime_batch(TS.schedule_from_x(x), t4, device="cpu")
    if not torch.cuda.is_available():
        t8 = J.ShiftedExponential(**SE).sample(np.random.default_rng(6), (16, 8))
        with pytest.raises(RuntimeError, match="CUDA"):  # no silent CPU fallback
            tmc.runtime_batch(TS.schedule_from_x(x), t8)


@pytest.mark.parametrize("rounds", [1, 3])
def test_mc_expected_runtime_matches_reference(rounds):
    plan_t, plan_j, env_t, env_j = _plans("xf", 5, _het(5))
    got = tmc.expected_runtime(plan_t, env_t, 5, n_samples=400, rounds=rounds, seed=5,
                               device="cpu")
    want = jmc.expected_runtime(plan_j, env_j, 5, n_samples=400, rounds=rounds, seed=5)
    assert (got["n_samples"], got["rounds"]) == (want["n_samples"], want["rounds"])
    for k in ("mean", "std", "sem"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
    assert tmc.as_schedule(plan_t) == TS.schedule_from_plan(plan_t)
    assert tmc.as_schedule(list(tmc.as_schedule(plan_t))) == tmc.as_schedule(plan_t)


@pytest.mark.parametrize("env_name", ["iid", "heterogeneous", "degraded"])
def test_plan_simulate_mc_matches_reference_mc_and_eq2(env_name):
    n = 5
    env_j = {"iid": J.Env.iid(J.ShiftedExponential(**SE), n), "heterogeneous": _het(n),
             "degraded": _het(n).with_faults(J.DegradedWorker(4, 2.0, from_round=3))}[env_name]
    plan_t, plan_j, env_t, _ = _plans("xf", n, env_j)
    mc_t = plan_t.simulate(env_t, 40, seed=9, backend="mc", device="cpu").ledger
    mc_j = plan_j.simulate(env_j, 40, seed=9, backend="mc").ledger
    eq2 = plan_j.simulate(env_j, 40, seed=9).ledger
    for a, b, c in zip(mc_t, mc_j, eq2, strict=True):
        np.testing.assert_array_equal(a["times"], b["times"])
        np.testing.assert_array_equal(a["times"], c["times"])
        # fp64 in both packages; the batched backends multiply in another order
        assert a["tau_uncoded"] == b["tau_uncoded"]
        np.testing.assert_allclose(a["tau_uncoded"], c["tau_uncoded"], rtol=1e-15)
        np.testing.assert_allclose(a["tau_coded"], b["tau_coded"], rtol=1e-6)
        np.testing.assert_allclose(a["tau_coded"], c["tau_coded"], rtol=1e-4)
