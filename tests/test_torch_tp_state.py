"""A sharded state on the port's ``model`` axis through checkpoints,
worker-death recovery, adaptive re-planning, the wave loop and
``scheme="auto"``, against the JAX reference, on the CPU.

One four-rank gloo job (``tests/torch_tp_state_ranks.py``, no JAX) on a
(data 2, model 2) mesh of reduced gc-lm-110m (2 layers, width 128,
``max_seq`` 32) with N = 2 workers and ``CodedSpec(2, 1)``, started in a
thread while this process computes the reference's runs on the same
initial weights:

* one checkpoint format: the axis's plain and coded checkpoints are
  byte-equal (arrays, manifest, shard payloads) to a one-process save of
  the gathered state, and the reference's ``restore_train_state`` /
  ``restore_coded_train_state`` load them into its template byte-equal
  to that state; a model-1 checkpoint resumes on the axis as each rank's
  ``shard_of`` cut, and an axis checkpoint at model 1;
* decoded once: only rank 0 runs the decode and the parity encode, and
  every rank receives exactly one broadcast per leaf (and one digest
  check); the same on a (data 4) mesh without a model axis;
* worker 0 dies: the recovery step, the checkpoint step, the forced
  re-plan and its ``x`` are the reference sim-mode trainer's, the
  gathered parameters after the replay within 1e-5 of its;
* the wave loop: staleness 0 byte-equal to the axis barrier loop;
  staleness 1 executes the reference's ``WaveTrace``, parameters within
  1e-5 of its sim-mode run;
* ``scheme="auto"``: the report is the reference's ``autotune`` (its TPU
  constants, its registry held to the port's schemes), the step-0 coded
  gradients of the shards gathered within 1e-5 of sim mode;
* ``tests/test_torch_tp_state_launch.py``: the four options on a meta
  mesh, and ``torchrun`` of the launcher resuming on the axis.
"""
import json
import threading
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import repro.core.schemes as J_schemes
from repro.adapt import AdaptConfig as JAdaptConfig
from repro.checkpoint import CkptConfig as JCkptConfig
from repro.checkpoint import CodedSpec as JCodedSpec
from repro.checkpoint import restore_coded_train_state as jax_restore_coded
from repro.checkpoint import restore_train_state as jax_restore
from repro.checkpoint.ckpt import _flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.core import DegradedWorker as JDegradedWorker
from repro.core import Env as JEnv
from repro.core import ShiftedExponential as JShiftedExp
from repro.launch.mesh import HW as JHW
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.train.wave import WaveConfig as JWaveConfig
from repro.tune import MemBudget as JMemBudget
from repro.tune import autotune as j_autotune
from repro_torch.checkpoint import CkptConfig, CodedSpec, save_checkpoint, save_coded_checkpoint
from repro_torch.checkpoint.ckpt import fill_tree, flatten_with_paths
from repro_torch.core import Env, Plan, ShiftedExponential, available_schemes
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.params import GCLM, params_from_numpy, shard_model, shard_of
from repro_torch.optim.optim import adamw_init
from repro_torch.train.coded import make_coded_grad_fn
from repro_torch.train.state import TrainState
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tune import autotune

import torch_tp_state_ranks as R

pytestmark = pytest.mark.spmd

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 300.0
WORLD = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_j():
    return jax_get_config("gc-lm-110m").reduced(**R.KW).replace(max_seq=R.MAX_SEQ)


def _env_j(death: bool = False):
    e = JEnv.iid(JShiftedExp(**R.SE), R.N)
    return e.with_faults(JDegradedWorker(**R.DEATH)) if death else e


def _ref_trainer(**kw):
    return JTrainer(_cfg_j(), JTrainConfig(**R.CFG_T), kw.pop("env", _env_j()), n_workers=R.N,
                    scheme="xf", global_batch=8, seed=0, **kw)


def _port_state(full: dict) -> TrainState:
    """A one-process port state (model 1, CPU) holding ``full``, a
    key -> array dict of the reference's tree."""
    model = GCLM(R.cfg(), device="cpu")
    return fill_tree(TrainState(params=model, opt=adamw_init(model.leaves()), step=0), full)


def _bytes(tree) -> dict:
    arrays, dtypes = flatten_with_paths(tree)
    return {k: (dtypes[k], a.shape, a.tobytes()) for k, a in arrays.items()}


def _files(step_dir: Path) -> dict:
    """file -> contents of a step dir (an npz's arrays by name)."""
    out = {}
    for f in sorted(step_dir.iterdir()):
        if f.suffix == ".npz":
            with np.load(f) as z:
                out[f.name] = {k: z[k].tobytes() for k in z.files}
        else:
            out[f.name] = json.loads(f.read_text())
    return out


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def work(tmp_path_factory):
    """The reference's initial weights (an npz the ranks read) and a
    one-process checkpoint of one step on them (model 1, coded)."""
    d = tmp_path_factory.mktemp("tp_state")
    state, _ = jax_init_train_state(_cfg_j(), jax.random.PRNGKey(0))
    np.savez(d / "init.npz", **{f"init/{j}": np.asarray(leaf)
                                for j, leaf in enumerate(jax.tree.leaves(state.params))})
    one = Trainer(R.cfg(), TrainConfig(**R.CFG_T), R.env(), scheme="xf", global_batch=8, seed=0,
                  device="cpu", params=R.init_tree(d / "init.npz"),
                  ckpt=CkptConfig(dir=str(d / "m1"), coded=CodedSpec(**R.SPEC)))
    one.run(1, log_every=0)
    one.save_checkpoint()
    return d


@pytest.fixture(scope="module")
def cap():
    """A memory cap between the open search's smallest and largest
    candidate: it prunes some and admits some."""
    res = autotune(R.cfg(), R.env(), None, global_batch=8, seq_len=R.MAX_SEQ, seed=0,
                   device="cpu")
    mems = sorted(c.mem.total for c in res.report.candidates)
    return 0.5 * (mems[0] + mems[-1])


@pytest.fixture(scope="module")
def job(work, cap):
    """The four-rank gloo job, running in a thread; ``job()`` waits for
    it and returns every rank's output."""
    paths = {k: str(work / k) for k in ("plain", "coded", "m1", "death", "data4")}
    paths.update(init=str(work / "init.npz"), hw=(JHW.HBM_BW, JHW.ICI_BW), cap=cap)
    box = {}

    def run():
        try:
            box["out"] = dist_spawn.spawn(R.state_rank, WORLD, paths,
                                          store_dir=str(work / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the test thread
            box["exc"] = exc

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    yield wait
    thread.join()


@pytest.fixture(scope="module")
def ranks(job, ref_death, ref_wave):
    """Every rank's output; the reference's runs are made while the job
    runs."""
    return job()


# --------------------------------------------------------------- checkpoints
@pytest.mark.parametrize("kind", ["plain", "coded"])
def test_axis_checkpoint_is_a_one_process_checkpoint(ranks, work, tmp_path, kind):
    """The axis's checkpoint holds the same arrays, manifest and payloads
    as one process's save of the gathered state, and the reference
    restores it into its template byte for byte."""
    full = ranks[0]["format"]["full"]
    state = _port_state(full)
    assert _bytes(state) == _bytes(full)
    extra = {"plan": Plan.build(GCLM(R.cfg(), device="meta"), R.env(), scheme="xf",
                                rng=0).to_dict()}
    if kind == "plain":
        save_checkpoint(str(tmp_path), 2, state, extra=extra)
    else:
        save_coded_checkpoint(str(tmp_path), 2, state, CodedSpec(**R.SPEC), extra=extra,
                              device="cpu")
    got = _files(work / kind / "step_00000002")
    assert got == _files(tmp_path / "step_00000002")
    template, _ = jax_init_train_state(_cfg_j(), jax.random.PRNGKey(1))
    restore = jax_restore if kind == "plain" else jax_restore_coded
    ref_state = restore(template, str(work / kind), 2)
    arrays, dtypes = jax_flatten(ref_state)
    assert {k: (dtypes[k], a.shape, a.tobytes()) for k, a in arrays.items()} == _bytes(full)


def test_axis_restore_decodes_on_rank_0_alone(ranks):
    """A coded restore with worker 0's stripe lost: every rank's shards
    come back byte-equal to its shards at the save (and a replayed step
    to the live run's); rank 0 alone decodes and encoded the parity;
    every rank receives one broadcast per leaf and one digest check."""
    assert [r["coords"] for r in ranks] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ranks:
        fmt = r["format"]
        assert fmt["n_leaves"] == 35
        assert fmt["restored"]["step"] == 2 and fmt["restored"]["digest"] == fmt["saved"]
        assert fmt["replayed"]
        assert fmt["restored"]["counts"] == dict(psum=0, psum_scatter=0, all_gather=0,
                                                 broadcast=fmt["n_leaves"] + 1)
    assert [r["format"]["restored"]["calls"] for r in ranks] == [["_solve_digits"], [], [], []]
    assert [r["format"]["save_calls"] for r in ranks] == [["encode"], [], [], []]
    # the data ranks of a model index hold the same bytes, the model ranks differ
    saved = [r["format"]["saved"] for r in ranks]
    assert saved[0] == saved[2] and saved[1] == saved[3] and saved[0] != saved[1]


def test_data_axis_restore_decodes_on_rank_0_alone(ranks):
    """spmd without a model axis (data 4, ``CodedSpec(4, 2)``, data
    stripe 0 and parity stripe 0 lost): rank 0 alone encodes the
    survivor and decodes; every rank gets each full leaf by one
    broadcast and checks its state against the world's."""
    for r in ranks:
        got = r["data4"]
        assert got["restored"]["step"] == 2 and got["restored"]["digest"] == got["saved"]
        assert got["restored"]["counts"] == dict(psum=0, psum_scatter=0, all_gather=0,
                                                 broadcast=36)
    assert [r["data4"]["restored"]["calls"] for r in ranks] == \
        [["_solve_digits", "encode"], [], [], []]
    assert len({r["data4"]["saved"] for r in ranks}) == 1


def test_model_1_checkpoint_resumes_on_the_axis(ranks, work):
    """One process's checkpoint (step 1) restores on each rank as the
    ``shard_of`` cut of every full leaf."""
    from repro_torch.checkpoint import CheckpointManager

    arrays, step = CheckpointManager(CkptConfig(dir=str(work / "m1"))).load(device="cpu")
    assert step == 1
    for rank, r in enumerate(ranks):
        assert r["from_m1"]["step"] == 1
        mesh = meta_mesh(data=R.N, model=2, rank=rank)
        local = shard_model(GCLM(R.cfg(), device="meta"), mesh)
        splits = TrainState(params=local, opt=adamw_init(local.leaves()), step=0).leaf_splits()
        assert [k for k, *_ in splits] == list(r["from_m1"]["shards"]) == list(arrays)
        for key, _, dim, blocks in splits:
            want = shard_of(torch.as_tensor(arrays[key]), dim, mesh, blocks).numpy()
            assert np.array_equal(r["from_m1"]["shards"][key], want), (rank, key)


@pytest.mark.parametrize("kind", ["plain", "coded"])
def test_axis_checkpoint_resumes_at_model_1(ranks, work, kind):
    """The axis's checkpoint resumes in one process (sim mode, model 1):
    its state is the gathered state at the save, byte for byte."""
    one = Trainer(R.cfg(), TrainConfig(**R.CFG_T), R.env(), scheme="xf", global_batch=8,
                  seed=0, device="cpu", ckpt=CkptConfig(dir=str(work / kind)))
    assert int(one.state.step) == 2
    assert _bytes(one.state) == _bytes(ranks[0]["format"]["full"])


# ------------------------------------------------------------ death, adapt
@pytest.fixture(scope="module")
def ref_death(tmp_path_factory):
    ref = _ref_trainer(env=_env_j(death=True), adapt=JAdaptConfig(**R.ADAPT),
                       ckpt=JCkptConfig(dir=str(tmp_path_factory.mktemp("jax_death")), every=2,
                                        coded=JCodedSpec(**R.SPEC)))
    ref.run(R.DEATH_STEPS, log_every=0)
    return ref


def test_death_and_forced_replan_are_the_reference_s(ranks, ref_death):
    """Worker 0 dies: every rank trips the DeathWatch on the reference's
    step, forces its re-plan (the same x) and rewinds to its checkpoint
    step; the losses within 1e-5 and, after the replay, the gathered
    parameters within 1e-5 of the reference's sim-mode trainer."""
    got = ranks[0]["death"]
    [(step, dead, ckpt_step, round_idx, x_old, x_new, gain)] = got["recoveries"]
    [ev] = ref_death.recoveries
    assert (step, dead, ckpt_step) == (ev.step, ev.dead_workers, ev.ckpt_step)
    assert (round_idx, x_old, x_new) == (ev.swap.round_idx, ev.swap.x_old.tolist(),
                                         ev.swap.x_new.tolist())
    assert x_new != x_old
    assert gain == ev.swap.predicted_gain
    assert got["plan"] == json.dumps(ref_death.plan.to_dict(), sort_keys=True)
    hist = ref_death.history
    assert [h[:2] for h in got["history"]] == [(h["step"], h.get("recovery")) for h in hist]
    np.testing.assert_allclose([h[2] for h in got["history"]], [h["loss"] for h in hist],
                               rtol=1e-5)
    for a, b in zip(got["params"], jax.tree.leaves(ref_death.state.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    for r in ranks:  # the same decisions on every rank, one grouped call a step
        assert {k: v for k, v in r["death"].items() if k not in ("params", "digest", "calls")} \
            == {k: v for k, v in got.items() if k not in ("params", "digest", "calls")}
        assert r["death"]["grouped"] == R.DEATH_STEPS
    assert ranks[0]["death"]["calls"].count("_solve_digits") == 1
    assert all(r["death"]["calls"] == [] for r in ranks[1:])


# --------------------------------------------------------------------- wave
@pytest.fixture(scope="module")
def ref_wave():
    ref = _ref_trainer(wave=JWaveConfig(staleness=1, **R.WAVE))
    ref.run(R.WAVE_ROUNDS, log_every=0)
    return ref


def test_wave_loop_on_the_axis(ranks, ref_wave):
    """Staleness 0 is byte-equal to the axis barrier loop; staleness 1
    (deferred: a rank's rows at the dispatch, the combine at the update)
    executes the reference's trace, one grouped call a round, the
    parameters within 1e-5 of its sim-mode run."""
    for r in ranks:
        w = r["wave"]
        assert w["barrier"] == w["stale0"]
        assert w["strategies"] == ("barrier", "deferred") and w["executed_is_trace"]
        assert w["grouped"] == R.WAVE_ROUNDS
    got = ranks[0]["wave"]
    assert got["trace"] == json.dumps(ref_wave.wave.traces[0].to_dict(), sort_keys=True)
    hist = ref_wave.history
    assert [h[:2] for h in got["history"]] == [(h["step"], h["staleness"]) for h in hist]
    np.testing.assert_allclose([h[2] for h in got["history"]], [h["loss"] for h in hist],
                               rtol=1e-5)
    for a, b in zip(got["params"], jax.tree.leaves(ref_wave.state.params), strict=True):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)


# --------------------------------------------------------------------- auto
def test_scheme_auto_on_the_axis(ranks, work, cap, monkeypatch):
    """Every rank's search is the reference's (its TPU constants, its
    registry held to the port's schemes): the same report and plan, one
    digest check; the step-0 coded gradients of the shards, gathered,
    within 1e-5 of each leaf's scale of sim mode; one step, one grouped
    call."""
    keep = set(available_schemes())
    monkeypatch.setattr(J_schemes, "_REGISTRY",
                        {k: v for k, v in J_schemes._REGISTRY.items() if k in keep})
    monkeypatch.setattr(J_schemes, "_ALIASES",
                        {a: k for a, k in J_schemes._ALIASES.items() if k in keep})
    res = j_autotune(_cfg_j(), _env_j(), JMemBudget(cap), global_batch=8,
                     seq_len=R.MAX_SEQ, seed=0)
    want = res.report.to_dict()
    assert want["candidates"] and want["pruned"]
    got = ranks[0]["auto"]
    assert got["report"] == want
    assert got["plan"] == res.plan.to_dict()
    best = res.report.best
    assert got["knobs"] == (best.pipeline, best.reduce_mode, "fp32")
    for r in ranks:
        a = r["auto"]
        assert (a["report"], a["plan"], a["knobs"]) == (got["report"], got["plan"], got["knobs"])
        assert a["tuned_counts"]["broadcast"] == 1 and a["grouped"] == 1
        assert np.isfinite(a["loss"])
    model = params_from_numpy(GCLM(R.cfg(), device="cpu"), R.init_tree(work / "init.npz"))
    plan = Plan.build(model, R.env(), scheme=best.scheme, s_cap=best.s_cap)
    assert plan.to_dict() == got["plan"]
    from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches

    data = SyntheticTokens(DataConfig(vocab=R.cfg().vocab, seq_len=R.MAX_SEQ, global_batch=8,
                                      seed=0))
    wb = coded_worker_batches(data, 0, R.N, plan.s_max)
    sim = make_coded_grad_fn(R.cfg(), plan)
    for u, grads in got["grads"].items():
        times = np.ones(R.N)
        times[:u] = 1e6
        want_g = sim(model, wb, plan.decode_weights(times).astype(np.float32))
        for a, b in zip(grads, want_g, strict=True):
            b = b.detach().numpy()
            assert float(np.abs(a - b).max()) <= 1e-5 * float(np.abs(b).max()), u
