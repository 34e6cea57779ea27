"""The wave-pipelined loop and the per-level and tree combines of the
port against the JAX reference, on the CPU.

* the event engine's ``wave_trace()`` gives the reference's events
  (kind, round, pos, workers, version, time) for staleness 0, 1 and
  None, and for a degraded env;
* combines: the union of ``combine_level`` over the levels equals
  ``combine_rows`` bitwise (each level one grouped call, one ``gc_fused``
  launch on CUDA) and the reference's ``combine_level`` within 1e-5; the
  tree pipeline equals the flat one and the reference's tree within 1e-5
  and the uncoded gradient within 1e-4, for every straggler count;
* ``WaveRunner``: staleness 0 is bitwise equal to the port's barrier
  ``Trainer.run``; staleness 1 executes the simulator's order and its
  losses and parameters match the reference ``WaveRunner`` (loss 1e-5,
  parameters 3e-6); the tree pipeline (deferred) agrees with the staged
  flat one; a plan swap quiesces at the reference's ``swap_rounds``;
  death faults are rejected and ``WaveConfig`` is validated.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import AdaptConfig as JAdaptConfig
from repro.configs import get_config as jax_get_config
from repro.core import DegradedWorker as JDegraded
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.sim import ClusterSim as JClusterSim
from repro.sim import schedule_from_plan_levels as j_schedule_levels
from repro.train.coded import combine_level as j_combine_level
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.wave import WaveConfig as JWaveConfig
from repro_torch.adapt import AdaptConfig
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, Plan, ShiftedExponential, WorkerDeath
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.kernels import ref
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.sim import ClusterSim, schedule_from_plan_levels
from repro_torch.train.coded import (combine_grads, combine_level, combine_rows,
                                     make_coded_grad_fn, uncoded_grad_fn)
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.train.wave import WaveConfig

N = 4
KW = dict(n_layers=2, d_model=128)
SEQ = 16
SE, JSE = ShiftedExponential(mu=1e-3, t0=50.0), JShiftedExp(mu=1e-3, t0=50.0)


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


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b, strict=True))


# ------------------------------------------------------------ event engine
@pytest.fixture(scope="module")
def full_width_plans():
    model = GCLM(get_config("gc-lm-110m"), device="meta")
    shapes = abstract_train_state(jax_get_config("gc-lm-110m"))[0].params
    return Plan.build(model, SE, N), JPlan.build(shapes, JSE, N)


@pytest.mark.parametrize("staleness,degraded", [(0, False), (1, False), (None, False),
                                                (1, True)])
def test_wave_trace_events_identical(full_width_plans, staleness, degraded):
    plan, jplan = full_width_plans
    env, jenv = Env.iid(SE, N), JEnv.iid(JSE, N)
    if degraded:
        env = env.with_faults(DegradedWorker(1, 5.0, from_round=3))
        jenv = jenv.with_faults(JDegraded(1, 5.0, from_round=3))
    sched, jsched = schedule_from_plan_levels(plan), j_schedule_levels(jplan)
    assert [tuple(vars(b).values()) for b in sched] == [tuple(vars(b).values()) for b in jsched]
    kw = dict(wave=True, staleness=staleness, update_cost=3e7, broadcast_latency=1e6)
    got = ClusterSim(sched, env, N, seed=5, **kw).run(rounds=10)
    want = JClusterSim(jsched, jenv, N, seed=5, **kw).run(rounds=10)
    np.testing.assert_array_equal(got.times, want.times)
    np.testing.assert_array_equal(got.decode_times, want.decode_times)
    np.testing.assert_array_equal(got.round_durations(), want.round_durations())
    trace, jtrace = got.wave_trace(), want.wave_trace()
    assert _json(trace.to_dict()) == _json(jtrace.to_dict())
    assert len(trace.events) == 10 * (2 + len(plan.used_levels))
    np.testing.assert_array_equal(trace.realized_staleness(), jtrace.realized_staleness())
    if staleness is not None:
        assert trace.realized_staleness().max() <= staleness


def test_barrier_rounds_price_like_the_plan(full_width_plans):
    plan, _ = full_width_plans
    rng = np.random.default_rng(0)
    t = SE.sample(rng, (12, N))
    res = ClusterSim(schedule_from_plan_levels(plan), t, N, wave=False).run(rounds=12)
    np.testing.assert_allclose(res.round_durations(), [plan.tau(row) for row in t],
                               rtol=1e-9)


# ---------------------------------------------------------------- combines
@pytest.fixture(scope="module")
def sim_setup():
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    state, _ = jax_init_train_state(cfg_j, jax.random.PRNGKey(0))
    model = params_from_numpy(GCLM(cfg_t, device="cpu"),
                              jax.tree.map(np.asarray, state.params))
    plan_j = JPlan.build(state.params, JSE, N, scheme="xf")
    plan_t = Plan.build(model, SE, N, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=SEQ, global_batch=8))
    wb = coded_worker_batches(data, 0, N, plan_t.s_max)
    shards = np.stack([data.shard(0, i, N) for i in range(N)])
    g_unc = uncoded_grad_fn(cfg_t, N)(model, shards)
    return cfg_t, cfg_j, state, model, plan_t, plan_j, wb, g_unc


def test_combine_level_union_is_combine_rows_bitwise(sim_setup, monkeypatch):
    _, _, state, _, plan, plan_j, _, _ = sim_setup
    layout = plan.flat_layout
    k = plan.k_shards
    rng = np.random.default_rng(0)
    grads = [rng.standard_normal((N, k) + s).astype(np.float32) for s in layout.leaf_shapes]
    rows = [torch.from_numpy(g.reshape(N * k, -1)) for g in grads]
    dec_w = plan.decode_weights(SE.sample(rng, (N,)))
    calls = []
    grouped = ref.encode_decode_leaves_ref

    def counted(a, b_codes, which, gs):
        calls.append((tuple(b_codes.shape), len(gs)))
        return grouped(a, b_codes, which, gs)

    monkeypatch.setattr(ref, "encode_decode_leaves_ref", counted)
    full = combine_rows(plan, rows, dec_w.astype(np.float32))
    got = {}
    for li in range(layout.n_levels):
        part = combine_level(plan, rows, li, dec_w[li])
        assert sorted(part) == sorted(layout.level_leaves[li])
        got.update(part)
    # one grouped call per level, over exactly that level's leaves
    assert calls[1:] == [((1, 1, N * k), len(ids)) for ids in layout.level_leaves]
    assert sorted(got) == list(range(layout.n_leaves))
    for j, leaf in enumerate(full):
        assert torch.equal(got[j], leaf), j
    tree_j = jax.tree.unflatten(jax.tree.structure(state.params), [jnp.asarray(g) for g in grads])
    for li in range(layout.n_levels):
        want = j_combine_level(plan_j, tree_j, li, dec_w[li])
        assert sorted(want) == sorted(layout.level_leaves[li])
        assert _max_err([got[j] for j in sorted(want)],
                        [want[j] for j in sorted(want)]) < 1e-5
    with pytest.raises(ValueError, match="out of range"):
        combine_level(plan, rows, layout.n_levels, dec_w[0])


def test_tree_pipeline_matches_flat_reference_tree_and_uncoded(sim_setup):
    cfg_t, cfg_j, state, model, plan_t, plan_j, wb, g_unc = sim_setup
    tree = make_coded_grad_fn(cfg_t, plan_t, pipeline="tree")
    flat = make_coded_grad_fn(cfg_t, plan_t, pipeline="auto")
    theirs = jax.jit(jax_coded_grad_fn(cfg_j, plan_j, mode="sim", pipeline="tree"))
    for u in range(plan_t.s_max + 1):
        times = np.ones(N)
        times[:u] = 1e6  # u realized stragglers
        dec_w = plan_t.decode_weights(times).astype(np.float32)
        g_tree = tree(model, wb, dec_w)
        g_j = jax.tree.leaves(theirs(state.params, jnp.asarray(wb), jnp.asarray(dec_w)))
        assert [tuple(g.shape) for g in g_tree] == [g.shape for g in g_j]
        assert _max_err(g_tree, flat(model, wb, dec_w)) < 1e-5, u   # tree == flat
        assert _max_err(g_tree, g_j) < 1e-5, u                      # == reference tree
        assert _max_err(g_tree, g_unc) < 1e-4, u                    # == uncoded
    # the combine alone, on rows: a plan without a layout takes the tree
    layout = plan_t.flat_layout
    sizes = [layout.leaf_size(j) for j in range(layout.n_leaves)]
    rows = [torch.randn(N * plan_t.k_shards, d) for d in sizes]
    bare = Plan.build(np.asarray(sizes, np.float64), SE, N)
    dec_w = bare.decode_weights(np.arange(N, dtype=np.float64))
    flat_ys = combine_grads(plan_t, rows, dec_w, pipeline="flat")
    for y, z in zip(combine_grads(bare, rows, dec_w, pipeline="auto"), flat_ys, strict=True):
        assert y.shape == (z.numel(),)
        torch.testing.assert_close(y, z.reshape(-1), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------- the loop
def _port(init, env=None, **kw):
    return Trainer(get_config("gc-lm-110m").reduced(**KW), TrainConfig(warmup=2, total_steps=40),
                   env or Env.iid(SE, N), scheme="xf", global_batch=8, seed=0, device="cpu",
                   params=init, seq_len=SEQ, **kw)


def _reference(env=None, **kw):
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    tr = JTrainer(cfg_j, JTrainConfig(warmup=2, total_steps=40), env or JEnv.iid(JSE, N),
                  scheme="xf", global_batch=8, seed=0, **kw)
    tr.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=SEQ, global_batch=8,
                                           seed=0))
    return tr, jax.tree.map(np.asarray, tr.state.params)


def _state_bytes(trainer) -> list:
    st = trainer.state
    return [t.detach().numpy().tobytes()
            for t in st.params.leaves() + st.opt["m"] + st.opt["v"]]


@pytest.fixture(scope="module")
def init_params():
    return _reference()[1]


def test_wave_staleness0_bitwise_equals_barrier(init_params):
    bar = _port(init_params)
    bar.run(4, log_every=0)
    wav = _port(init_params, wave=WaveConfig(staleness=0, update_cost=3e7,
                                             broadcast_latency=1e6))
    wav.run(4, log_every=0)
    assert _state_bytes(bar) == _state_bytes(wav)
    assert bar.state.step == wav.state.step == 4
    assert bar.state.opt["count"] == wav.state.opt["count"]
    assert bar.sim.rng.bit_generator.state == wav.sim.rng.bit_generator.state
    for rb, rw in zip(bar.sim.ledger, wav.sim.ledger, strict=True):
        np.testing.assert_array_equal(rb["times"], rw["times"])
        assert (rb["tau_coded"], rb["tau_uncoded"]) == (rw["tau_coded"], rw["tau_uncoded"])
    assert [h["loss"] for h in bar.history] == [h["loss"] for h in wav.history]
    assert wav.wave._strategy(wav.plan) == "barrier"


def test_wave_staleness1_matches_reference_wave_runner(init_params):
    wcfg = dict(staleness=1, update_cost=3e7, broadcast_latency=1e6)
    ref_tr, _ = _reference(wave=JWaveConfig(**wcfg))
    ours = _port(init_params, wave=WaveConfig(**wcfg))
    ours.run(6, log_every=0)
    ref_tr.run(6, log_every=0)
    [trace], [log] = ours.wave.traces, ours.wave.executed
    assert log == list(trace.events)  # the executed order IS the simulator's
    assert _json(trace.to_dict()) == _json(ref_tr.wave.traces[0].to_dict())
    assert trace.realized_staleness().max() == 1
    assert ours.wave._strategy(ours.plan) == "staged"
    for ht, hj in zip(ours.history, ref_tr.history, strict=True):
        assert (ht["step"], ht["staleness"]) == (hj["step"], hj["staleness"])
        assert (ht["tau_coded"], ht["tau_uncoded"]) == (hj["tau_coded"], hj["tau_uncoded"])
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref_tr.state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6)


def test_wave_tree_pipeline_defers_and_matches_staged(init_params):
    staged = _port(init_params, wave=WaveConfig(staleness=1, update_cost=3e7))
    deferred = _port(init_params, pipeline="tree", wave=WaveConfig(staleness=1, update_cost=3e7))
    assert deferred.wave._strategy(deferred.plan) == "deferred"
    staged.run(4, log_every=0)
    deferred.run(4, log_every=0)
    assert deferred.wave.executed[0] == list(deferred.wave.traces[0].events)
    assert _json(deferred.wave.traces[0].to_dict()) == _json(staged.wave.traces[0].to_dict())
    for hs, hd in zip(staged.history, deferred.history, strict=True):
        assert hs["staleness"] == hd["staleness"]
        np.testing.assert_allclose(hd["loss"], hs["loss"], rtol=1e-5)
    for a, b in zip(deferred.state.params.leaves(), staged.state.params.leaves()):
        torch.testing.assert_close(a, b, rtol=0, atol=3e-6)


def test_wave_quiesce_on_swap_matches_reference(init_params):
    """Workers 2 and 3 eight times slower from round 2: the controller
    accepts a swap mid-wave; dispatched rounds drain under the old plan
    and the swap binds at the reference's round."""
    faults = [dict(worker=w, factor=8.0, from_round=2) for w in (2, 3)]
    ad = dict(window=16, min_rounds=8, check_every=2)
    wcfg = dict(staleness=2, update_cost=3e7)
    ref_tr, _ = _reference(JEnv.iid(JSE, N).with_faults(*(JDegraded(**f) for f in faults)),
                           adapt=JAdaptConfig(**ad), wave=JWaveConfig(**wcfg))
    ours = _port(init_params, Env.iid(SE, N).with_faults(*(DegradedWorker(**f) for f in faults)),
                 adapt=AdaptConfig(**ad), wave=WaveConfig(**wcfg))
    ours.run(18, log_every=0)
    ref_tr.run(18, log_every=0)
    assert ours.wave.swap_rounds == ref_tr.wave.swap_rounds and len(ours.wave.swap_rounds) == 1
    assert ours.state.step == 18 and len(ours.history) == len(ours.sim.ledger) == 18
    assert [len(t.events) for t in ours.wave.traces] == [len(t.events) for t in ref_tr.wave.traces]
    for t, tj in zip(ours.wave.traces, ref_tr.wave.traces, strict=True):
        assert _json(t.to_dict()) == _json(tj.to_dict())
    # the drained segment ran exactly the dispatched rounds' events
    assert {e.round for e in ours.wave.executed[0]} == set(range(ours.wave.swap_rounds[0]))
    assert _json(ours.plan.to_dict()) == _json(ref_tr.plan.to_dict())
    assert ours.plan is ours.controller.plan
    for rt, rj in zip(ours.sim.ledger, ref_tr.sim.ledger, strict=True):
        np.testing.assert_array_equal(rt["times"], rj["times"])
    for ht, hj in zip(ours.history, ref_tr.history, strict=True):
        assert ht.get("plan_swap") == hj.get("plan_swap")
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)


def test_wave_rejects_death_faults_and_validates_config(init_params):
    with pytest.raises(ValueError, match="WorkerDeath"):
        _port(init_params, Env.iid(SE, N).with_faults(WorkerDeath(0, at_round=3)),
              wave=WaveConfig(staleness=1))
    with pytest.raises(ValueError, match="staleness"):
        WaveConfig(staleness=-1)
    with pytest.raises(ValueError, match=">= 0"):
        WaveConfig(update_cost=-1.0)
    assert WaveConfig(staleness=None).cluster_config().staleness is None
