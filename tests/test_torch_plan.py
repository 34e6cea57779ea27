"""The port's copied numpy plan layer against the JAX reference's.

``repro_torch.core`` is a trimmed copy of ``repro.core`` (the port
imports nothing of ``repro``), so everything here must be bit-identical,
not merely close: the same model binds the same ``Plan`` (compared as
JSON), the decode weights and the straggler ledger are equal draw for
draw, and the data batches are equal token for token.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import DegradedWorker as JDegraded
from repro.core import Env as JEnv
from repro.core import FlatLayout as JFlatLayout
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.data import pipeline as jdata
from repro.train.state import abstract_train_state
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, FlatLayout, Plan, ShiftedExponential
from repro_torch.data import pipeline as tdata
from repro_torch.models.params import GCLM

N = 4
MU, T0 = 1e-3, 50.0
RAGGED_SHAPES = [(), (5,), (3, 7), (128,), (130,), (2, 2, 3)]
RAGGED_LEVELS = [0, 1, 0, 1, 0, 0]


def _configs(name):
    if name == "full":
        return get_config("gc-lm-110m"), jax_get_config("gc-lm-110m")
    kw = dict(n_layers=2, d_model=128)
    return get_config("gc-lm-110m").reduced(**kw), jax_get_config("gc-lm-110m").reduced(**kw)


def _json(blob):
    return json.dumps(blob, sort_keys=True)


@pytest.fixture(scope="module", params=["full", "reduced"])
def plans_by_size(request):
    """Port model on the meta device (shapes, no storage) and the
    reference's abstract parameter tree (``jax.eval_shape``)."""
    cfg_t, cfg_j = _configs(request.param)
    model = GCLM(cfg_t, device="meta")
    shapes = abstract_train_state(cfg_j)[0].params
    return model, shapes


@pytest.mark.parametrize("scheme,s_cap", [("xf", None), ("xt", None), ("xf", 1)])
def test_plan_to_dict_identical_to_reference(plans_by_size, scheme, s_cap):
    model, shapes = plans_by_size
    port = Plan.build(model, ShiftedExponential(mu=MU, t0=T0), N, scheme=scheme,
                      s_cap=s_cap)
    ref = JPlan.build(shapes, JShiftedExp(mu=MU, t0=T0), N, scheme=scheme,
                      s_cap=s_cap)
    assert _json(port.to_dict()) == _json(ref.to_dict())
    # a blob written by either package loads in the other, unchanged
    assert _json(Plan.from_dict(json.loads(_json(ref.to_dict()))).to_dict()) \
        == _json(ref.to_dict())


def test_main_path_plan_shape(plans_by_size):
    """gc-lm-110m at the trainer's defaults: 11 leaves, K = s_max + 1 = 4."""
    model, _ = plans_by_size
    plan = Plan.build(model, ShiftedExponential(mu=MU, t0=T0), N, scheme="xf")
    assert plan.flat_layout.n_leaves == 11
    assert plan.s_max == 3 and plan.k_shards == 4
    assert plan.leaf_levels.tolist() == [0, 0, 0, 2, 3, 3, 3, 3, 3, 3, 3]


@pytest.fixture(scope="module")
def plan_pair():
    model = GCLM(get_config("gc-lm-110m"), device="meta")
    shapes = abstract_train_state(jax_get_config("gc-lm-110m"))[0].params
    return (Plan.build(model, ShiftedExponential(mu=MU, t0=T0), N),
            JPlan.build(shapes, JShiftedExp(mu=MU, t0=T0), N))


def test_decode_weights_identical_every_straggler_count(plan_pair):
    port, ref = plan_pair
    rng = np.random.default_rng(0)
    for u in range(port.s_max + 1):
        for _ in range(5):
            times = rng.uniform(1.0, 2.0, N)
            times[rng.choice(N, size=u, replace=False)] = 1e6
            np.testing.assert_array_equal(port.decode_weights(times),
                                          ref.decode_weights(times))


@pytest.mark.parametrize("faulted", [False, True])
def test_simulator_ledger_bit_identical(plan_pair, faulted):
    port, ref = plan_pair
    env_t = Env.iid(ShiftedExponential(mu=MU, t0=T0), N)
    env_j = JEnv.iid(JShiftedExp(mu=MU, t0=T0), N)
    if faulted:  # a worker throttled from round 5: folded into the draws
        env_t = Env(dists=env_t.dists, faults=(DegradedWorker(2, 3.0, from_round=5),))
        env_j = env_j.with_faults(JDegraded(2, 3.0, from_round=5))
        assert _json(env_t.to_dict()) == _json(env_j.to_dict())
        assert _json(Env.from_dict(env_j.to_dict()).to_dict()) == _json(env_j.to_dict())
    sim_t, sim_j = port.simulator(env_t, seed=7), ref.simulator(env_j, seed=7)
    for _ in range(20):
        (dw_t, rec_t), (dw_j, rec_j) = sim_t.step(), sim_j.step()
        np.testing.assert_array_equal(dw_t, dw_j)
        np.testing.assert_array_equal(rec_t["times"], rec_j["times"])
        assert rec_t["tau_coded"] == rec_j["tau_coded"]
        assert rec_t["tau_uncoded"] == rec_j["tau_uncoded"]
    assert sim_t.summary() == sim_j.summary()


def test_coded_worker_batches_identical():
    cfg_t = tdata.DataConfig(vocab=512, seq_len=48, global_batch=8, seed=3)
    cfg_j = jdata.DataConfig(vocab=512, seq_len=48, global_batch=8, seed=3)
    src_t, src_j = tdata.SyntheticTokens(cfg_t), jdata.SyntheticTokens(cfg_j)
    for step in (0, 1, 17):
        for s_max in (0, 3):
            a = tdata.coded_worker_batches(src_t, step, N, s_max)
            b = jdata.coded_worker_batches(src_j, step, N, s_max)
            assert a.dtype == b.dtype and a.shape == (N, s_max + 1, 2, 49)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(src_t.batch(step), src_j.batch(step))
    uni_t = tdata.SyntheticTokens(tdata.DataConfig(512, 16, 4, kind="uniform"))
    uni_j = jdata.SyntheticTokens(jdata.DataConfig(512, 16, 4, kind="uniform"))
    np.testing.assert_array_equal(uni_t.shard(2, 1, 4), uni_j.shard(2, 1, 4))


@pytest.mark.parametrize("batch", [(), (3,), (2, 4)])
def test_flat_layout_pack_unpack_matches_reference(batch):
    port = FlatLayout.build(RAGGED_SHAPES, RAGGED_LEVELS, N)
    ref = JFlatLayout.build(RAGGED_SHAPES, RAGGED_LEVELS, N)
    assert port.to_dict() == ref.to_dict()
    assert (port.level_sizes, port.level_offsets) == (ref.level_sizes, ref.level_offsets)
    rng = np.random.default_rng(7)
    leaves = [rng.standard_normal(batch + s).astype(np.float32) for s in RAGGED_SHAPES]
    bufs_t = port.pack([torch.from_numpy(x) for x in leaves])
    bufs_j = ref.pack([jnp.asarray(x) for x in leaves])
    for bt, bj in zip(bufs_t, bufs_j):
        np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    for back, x in zip(port.unpack(bufs_t), leaves):
        np.testing.assert_array_equal(back.numpy(), x)


def test_unknown_scheme_and_autotune_raise():
    """A name neither package registers raises ``KeyError`` in both;
    ``scheme="auto"`` builds the tuner's winning plan, carrying its
    search record, equal to the reference's."""
    model = GCLM(get_config("gc-lm-110m").reduced(n_layers=2, d_model=128),
                 device="meta")
    shapes = abstract_train_state(jax_get_config("gc-lm-110m").reduced(n_layers=2,
                                                                       d_model=128))[0].params
    for build in (lambda **kw: Plan.build(model, ShiftedExponential(), N, **kw),
                  lambda **kw: JPlan.build(shapes, JShiftedExp(), N, **kw)):
        with pytest.raises(KeyError, match="unknown scheme"):
            build(scheme="no-such-scheme")
    port = Plan.build(model, ShiftedExponential(), N, scheme="auto", device="cpu")
    ref = JPlan.build(shapes, JShiftedExp(), N, scheme="auto")
    assert port.tune_report.best.scheme == port.scheme == ref.scheme
    assert port.tune_report.n_workers == N and port.tune_report.backend == "eq2"
    assert [c.key() for c in port.tune_report.candidates] \
        == [c.key() for c in ref.tune_report.candidates]
    assert _json(port.to_dict()) == _json(ref.to_dict())
    plan = Plan.build(model, ShiftedExponential(), N, scheme="x_f")  # alias
    assert plan.scheme == "x_f" and plan.flat_layout is not None


@pytest.mark.parametrize("backend", ["eq2", "event", "mc"])
def test_full_width_simulate_ledgers_match_reference(plan_pair, backend):
    """``Plan.simulate`` on full-width gc-lm-110m's plan: eq2 and event
    bit-identical to the reference's; mc (fp32) within 1e-6 of the
    reference's mc, with the same draws."""
    port, ref = plan_pair
    env_t = Env.heterogeneous([ShiftedExponential(mu=MU, t0=T0)] * 2
                              + [ShiftedExponential(mu=MU / 5, t0=T0 * 5)] * 2)
    env_j = JEnv.from_dict(env_t.to_dict())
    sim_t = port.simulate(env_t, 50, seed=3, backend=backend, device="cpu")
    sim_j = ref.simulate(env_j, 50, seed=3, backend=backend)
    rtol = 1e-6 if backend == "mc" else 0.0
    for a, b in zip(sim_t.ledger, sim_j.ledger, strict=True):
        np.testing.assert_array_equal(a["times"], b["times"])
        assert a["tau_uncoded"] == b["tau_uncoded"]
        np.testing.assert_allclose(a["tau_coded"], b["tau_coded"], rtol=rtol)
