"""Checkpoints of the PyTorch port against the JAX reference, on the CPU.

* ``FlatLayout.for_bytes`` serializes identically in both packages;
* the port flattens its ``TrainState`` to the reference's keys, dtypes,
  shapes and bytes (parameters carried by ``params_from_numpy``, moments
  by ``opt_from_numpy``);
* the same state saved by both packages gives equal ``manifest.json`` /
  ``meta.json`` and equal shard payloads (payloads, not file bytes: npz
  zip headers carry timestamps), coded and monolithic;
* a JAX-written coded checkpoint restores into the port bit-exactly, and
  the reverse, for every loss pattern of ``CodedSpec(4, 2)``;
* the port's own contract: every loss pattern of ``CodedSpec(6, 2)``,
  ``ShardLossError`` beyond s, a crc flip demotes a shard, bf16/fp8
  bytes round-trip without ``ml_dtypes``, crash atomicity at every stage;
* ``Trainer(ckpt=...)``: resume is bitwise, and worker-death recovery
  matches the reference ``Trainer`` step for step, with and without an
  adaptive controller (whose forced re-plan is ``RecoveryEvent.swap``);
* the launcher's ``--ckpt*`` flags.

Everything runs on the CPU, where the encode is the plain version; the
``gc_encode`` kernel is held to it on the card (chip_smoke.py,
tests/test_torch_cuda.py).
"""
import itertools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.adapt import AdaptConfig as JAdaptConfig
from repro.checkpoint import CkptConfig as JCkptConfig
from repro.checkpoint import CodedSpec as JCodedSpec
from repro.checkpoint import restore_coded_train_state as jax_restore_coded
from repro.checkpoint import save_checkpoint as jax_save_checkpoint
from repro.checkpoint import save_coded_checkpoint as jax_save_coded
from repro.checkpoint.ckpt import _flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.core import DegradedWorker as JDegradedWorker
from repro.core import Env as JEnv
from repro.core import ShiftedExponential as JShiftedExp
from repro.core.flat import FlatLayout as JFlatLayout
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.sim.faults import drop_shard, flip_bit, torn_write
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.adapt import AdaptConfig, RecoveryEvent
from repro_torch.checkpoint import (
    CheckpointManager,
    CkptConfig,
    CodedSpec,
    ShardLossError,
    intact_steps,
    latest_coded_step,
    load_checkpoint,
    load_coded_checkpoint,
    restore_coded_train_state,
    restore_train_state,
    save_checkpoint,
    save_coded_checkpoint,
)
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, ShiftedExponential
from repro_torch.core.flat import FlatLayout
from repro_torch.kernels import gc_encode
from repro_torch.launch import train as launch_train
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.train.state import TrainState, opt_from_numpy
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
KW = dict(n_layers=1, d_model=64)
N = 4
#: worker 1 runs 1000x slower from round 0: with seed 0 the DeathWatch
#: (factor 20, 4 rounds) trips after the 4th step
FAULT = dict(worker=1, factor=1000.0, from_round=0)


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


# ------------------------------------------------------------------ states
@pytest.fixture(scope="module")
def states():
    """The same TrainState in both packages: reference params, random
    moments, count 5, step 7."""
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    state, _ = jax_init_train_state(cfg_j, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    params = jax.tree.map(np.asarray, state.params)
    opt = {"m": jax.tree.map(lambda p: rng.standard_normal(p.shape).astype(np.float32),
                             params),
           "v": jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32), params),
           "count": np.int32(5)}
    jstate = state._replace(params=jax.tree.map(jnp.asarray, params),
                            opt=jax.tree.map(jnp.asarray, opt),
                            step=jnp.asarray(7, jnp.int32))
    model = params_from_numpy(GCLM(get_config("gc-lm-110m").reduced(**KW), device="cpu"),
                              params)
    tstate = TrainState(params=model, opt=opt_from_numpy(model, opt), step=7)
    return jstate, tstate


def _port_bytes(tree) -> dict:
    arrays, dtypes = flatten_with_paths(tree)
    return {k: (dtypes[k], a.shape, a.tobytes()) for k, a in arrays.items()}


def _zeroed(tstate) -> TrainState:
    """A template of the same structure with every tensor zeroed."""
    model = GCLM(tstate.params.cfg, device="cpu")
    with torch.no_grad():
        for t in model.leaves():
            t.zero_()
    return TrainState(params=model,
                      opt={"m": [torch.zeros_like(t) for t in tstate.opt["m"]],
                           "v": [torch.zeros_like(t) for t in tstate.opt["v"]],
                           "count": 0}, step=0)


# ----------------------------------------------------------------- layout
@pytest.mark.parametrize("sizes,n", [([1654096904], 3), ([7, 0, 129, 4096], 4),
                                     ([3, 5], 6), ([], 2)])
def test_for_bytes_layout_serializes_like_reference(sizes, n):
    ours, theirs = FlatLayout.for_bytes(sizes, n), JFlatLayout.for_bytes(sizes, n)
    assert ours.to_dict() == theirs.to_dict()
    assert ours.level_sizes == theirs.level_sizes
    assert ours.level_offsets == theirs.level_offsets


# ------------------------------------------------------------- flattening
def test_train_state_flattens_to_reference_keys_dtypes_shapes_bytes(states):
    jstate, tstate = states
    j_arrays, j_dtypes = jax_flatten(jstate)
    ours = _port_bytes(tstate)
    assert list(ours) == list(j_arrays)  # same keys, same order
    assert len(ours) == 35
    assert list(ours)[:3] == ["params/embed/tok", "params/final_norm/scale",
                              "params/stack/[0]/ffn/wg"]
    assert list(ours)[11] == "opt/count" and list(ours)[-1] == "step"
    for key, (dtype, shape, raw) in ours.items():
        assert dtype == j_dtypes[key], key
        assert shape == j_arrays[key].shape, key
        assert raw == np.ascontiguousarray(j_arrays[key]).tobytes(), key


def test_plain_trees_flatten_like_jax():
    rng = np.random.default_rng(1)
    tree = {"b": [rng.standard_normal(3).astype(np.float32),
                  {"z": np.int32(4), "a": rng.integers(0, 9, (2, 2))}],
            "a": rng.standard_normal((2, 3)).astype(np.float32)}
    j_arrays, j_dtypes = jax_flatten(tree)
    t_tree = {"b": [torch.from_numpy(tree["b"][0]), tree["b"][1]],
              "a": torch.from_numpy(tree["a"])}
    ours = _port_bytes(t_tree)
    assert list(ours) == list(j_arrays) == ["a", "b/[0]", "b/[1]/a", "b/[1]/z"]
    for key, (dtype, shape, raw) in ours.items():
        assert (dtype, shape, raw) == (j_dtypes[key], j_arrays[key].shape,
                                       j_arrays[key].tobytes())


# ------------------------------------------------------ same state, same files
def _payload(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("n_shards,parity", [(4, 1), (4, 2), (3, 1)])
def test_same_state_saves_same_coded_checkpoint_in_both_packages(states, tmp_path,
                                                                 n_shards, parity):
    jstate, tstate = states
    extra = {"plan": {"x": [1, 2]}}
    jax_save_coded(str(tmp_path / "jax"), 7, jstate, JCodedSpec(n_shards, parity),
                   extra=extra)
    save_coded_checkpoint(str(tmp_path / "port"), 7, tstate, CodedSpec(n_shards, parity),
                          extra=extra)
    a, b = tmp_path / "jax" / "step_00000007", tmp_path / "port" / "step_00000007"
    for name in ("manifest.json", "meta.json"):
        assert json.loads((a / name).read_text()) == json.loads((b / name).read_text())
    for i in range(n_shards):
        pa, pb = _payload(a / f"shard_{i:03d}.npz"), _payload(b / f"shard_{i:03d}.npz")
        assert pa.keys() == pb.keys() == {"stripe"}
        assert pa["stripe"].dtype == pb["stripe"].dtype == np.uint8
        assert np.array_equal(pa["stripe"], pb["stripe"]), i


def test_same_state_saves_same_monolithic_checkpoint_in_both_packages(states, tmp_path):
    jstate, tstate = states
    jax_save_checkpoint(str(tmp_path / "jax"), 3, jstate, extra={"k": 1})
    save_checkpoint(str(tmp_path / "port"), 3, tstate, extra={"k": 1})
    a, b = tmp_path / "jax" / "step_00000003", tmp_path / "port" / "step_00000003"
    assert json.loads((a / "meta.json").read_text()) == \
        json.loads((b / "meta.json").read_text())
    pa, pb = _payload(a / "arrays.npz"), _payload(b / "arrays.npz")
    assert list(pa) == list(pb)
    for k in pa:
        assert pa[k].dtype == pb[k].dtype and np.array_equal(pa[k], pb[k]), k
    # and either package reads the other's
    arrays, meta = load_checkpoint(str(tmp_path / "jax"))
    restored = restore_train_state(_zeroed(tstate), str(tmp_path / "jax"))
    assert meta["step"] == 3 and _port_bytes(restored) == _port_bytes(tstate)


# -------------------------------------------------------------- cross-restore
LOSS_4_2 = [lost for r in range(3) for lost in itertools.combinations(range(4), r)]


@pytest.fixture(scope="module")
def cross_dirs(states, tmp_path_factory):
    jstate, tstate = states
    root = tmp_path_factory.mktemp("cross")
    jax_save_coded(str(root / "jax"), 7, jstate, JCodedSpec(4, 2))
    save_coded_checkpoint(str(root / "port"), 7, tstate, CodedSpec(4, 2))
    return root


@pytest.mark.parametrize("lost", LOSS_4_2, ids=str)
def test_jax_coded_checkpoint_restores_into_port_bitwise(states, cross_dirs, lost):
    _, tstate = states
    before = gc_encode.launches
    got = restore_coded_train_state(_zeroed(tstate), str(cross_dirs / "jax"),
                                    missing=lost)
    assert gc_encode.launches == before  # the CPU takes the plain version
    assert isinstance(got, TrainState) and got.step == 7 and got.opt["count"] == 5
    assert _port_bytes(got) == _port_bytes(tstate)


@pytest.mark.parametrize("lost", LOSS_4_2, ids=str)
def test_port_coded_checkpoint_restores_into_jax_bitwise(states, cross_dirs, lost):
    jstate, _ = states
    template = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), jstate)
    got = jax_restore_coded(template, str(cross_dirs / "port"), missing=lost)
    want, _ = jax_flatten(jstate)
    for key, arr in jax_flatten(got)[0].items():
        assert arr.dtype == want[key].dtype and arr.tobytes() == want[key].tobytes(), key


# ----------------------------------------------------- the port's own contract
def _exotic_tree(seed):
    """Native and bf16/fp8 leaves with NaN/inf payloads, as tensors."""
    rng = np.random.default_rng(seed)
    bf16 = torch.from_numpy(rng.standard_normal(37).astype(np.float32)).to(torch.bfloat16)
    bf16[:4] = torch.tensor([float("nan"), float("inf"), float("-inf"), -0.0])
    return {"params": {"w": torch.from_numpy(rng.standard_normal((11, 13)).astype(np.float32)),
                       "emb": bf16,
                       "q": torch.from_numpy(rng.standard_normal(29).astype(np.float32))
                       .to(torch.float8_e4m3fn)},
            "opt": {"mu": torch.from_numpy(rng.standard_normal((11, 13)).astype(np.float32))
                    .to(torch.bfloat16), "count": np.int32(7)},
            "step": np.int32(int(rng.integers(0, 1 << 30))),
            "rng": rng.integers(0, 1 << 32, 2, dtype=np.uint32)}


def _zero_like(tree):
    if isinstance(tree, dict):
        return {k: _zero_like(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return torch.zeros_like(tree)
    return np.zeros_like(tree)


def _bits(tree) -> dict:
    return {k: (d, raw) for k, (d, _, raw) in _port_bytes(tree).items()}


LOSS_6_2 = [lost for r in range(3) for lost in itertools.combinations(range(6), r)]


@pytest.fixture(scope="module")
def coded_6_2(tmp_path_factory):
    d = tmp_path_factory.mktemp("c62")
    tree = _exotic_tree(1)
    save_coded_checkpoint(str(d), 5, tree, CodedSpec(n_shards=6, parity=2))
    return d, tree


@pytest.mark.parametrize("lost", LOSS_6_2, ids=str)
def test_every_loss_pattern_of_6_2_restores_bitwise(coded_6_2, lost):
    d, tree = coded_6_2
    got = restore_coded_train_state(_zero_like(tree), str(d), missing=lost)
    assert _bits(got) == _bits(tree)
    assert got["params"]["emb"].dtype == torch.bfloat16
    assert got["params"]["q"].dtype == torch.float8_e4m3fn


def _shard(d, step, i):
    return os.path.join(str(d), f"step_{step:08d}", f"shard_{i:03d}.npz")


def test_losses_beyond_s_raise_and_corruption_demotes_to_lost(tmp_path):
    tree = _exotic_tree(3)
    save_coded_checkpoint(str(tmp_path), 1, tree, CodedSpec(n_shards=8, parity=2))
    torn_write(_shard(tmp_path, 1, 0), keep_fraction=0.4)
    flip_bit(_shard(tmp_path, 1, 3), byte_offset=200, bit=5)  # crc catches it
    got = restore_coded_train_state(_zero_like(tree), str(tmp_path))
    assert _bits(got) == _bits(tree)
    drop_shard(_shard(tmp_path, 1, 6))  # a third loss: over budget
    with pytest.raises(ShardLossError, match="tolerates at most 2"):
        load_coded_checkpoint(str(tmp_path), device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        load_coded_checkpoint(str(tmp_path), missing=[8], device="cpu")


def test_crc_flip_in_a_survivor_demotes_it(tmp_path):
    tree = _exotic_tree(6)
    save_coded_checkpoint(str(tmp_path), 0, tree, CodedSpec(n_shards=4, parity=1))
    flip_bit(_shard(tmp_path, 0, 1), byte_offset=150)
    got = restore_coded_train_state(_zero_like(tree), str(tmp_path))  # 1 loss: fine
    assert _bits(got) == _bits(tree)
    with pytest.raises(ShardLossError):
        load_coded_checkpoint(str(tmp_path), missing=[2], device="cpu")


def test_bf16_round_trips_without_ml_dtypes(tmp_path):
    """In a process that imports only the port: a bf16 tensor with NaN/inf
    payloads round-trips bit-exactly, monolithic and coded, and
    ``ml_dtypes`` is never loaded."""
    code = f"""
import sys, torch
from repro_torch.checkpoint import (CodedSpec, restore_coded_train_state,
    restore_train_state, save_checkpoint, save_coded_checkpoint)
x = torch.tensor([1.5, float('nan'), float('inf'), -0.0, 3e38]).to(torch.bfloat16)
for save, restore, kw in ((save_checkpoint, restore_train_state, {{}}),
                          (save_coded_checkpoint, restore_coded_train_state,
                           {{"spec": CodedSpec(3, 1)}})):
    d = {str(tmp_path)!r} + "/" + save.__name__
    save(d, 1, {{"x": x}}, **kw)
    got = restore({{"x": torch.zeros_like(x)}}, d)["x"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), x.view(torch.int16)), got
assert "ml_dtypes" not in sys.modules and "jax" not in sys.modules
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("ok")


class _CrashAt:
    def __init__(self, stage):
        self.stage, self.seen = stage, []

    def __call__(self, stage):
        self.seen.append(stage)
        if stage == self.stage:
            raise KeyboardInterrupt(f"injected crash at {stage}")


MONO_STAGES = ["arrays_synced", "meta_synced", "payload_synced", "staging_synced",
               "renamed", "parent_synced"]
CODED_STAGES = ["shards_synced", "manifest_synced", "payload_synced",
                "staging_synced", "renamed", "parent_synced"]


@pytest.mark.parametrize("coded,stage", [(False, s) for s in MONO_STAGES] +
                         [(True, s) for s in CODED_STAGES])
def test_crash_at_every_boundary_keeps_previous_checkpoint(tmp_path, coded, stage):
    old, new = _exotic_tree(8), _exotic_tree(9)
    kw = {"spec": CodedSpec(n_shards=4, parity=1)} if coded else {}
    save = save_coded_checkpoint if coded else save_checkpoint
    restore = restore_coded_train_state if coded else restore_train_state
    save(str(tmp_path), 1, old, **kw)
    with pytest.raises(KeyboardInterrupt):
        save(str(tmp_path), 2, new, _crash_hook=_CrashAt(stage), **kw)
    assert _bits(restore(_zero_like(old), str(tmp_path), 1)) == _bits(old)
    newest = CheckpointManager(CkptConfig(dir=str(tmp_path))).latest()[0]
    assert newest == (2 if stage in ("renamed", "parent_synced") else 1)
    save(str(tmp_path), 3, new, **kw)  # sweeps the orphan, lands cleanly
    assert not any(d.endswith(".tmp") for d in os.listdir(str(tmp_path)))
    assert _bits(restore(_zero_like(new), str(tmp_path), 3)) == _bits(new)


@pytest.mark.parametrize("coded", [False, True])
def test_crash_hook_stage_order(tmp_path, coded):
    hook = _CrashAt(None)
    if coded:
        save_coded_checkpoint(str(tmp_path), 0, {"x": torch.zeros(4)},
                              CodedSpec(3, 1), _crash_hook=hook)
        assert hook.seen == CODED_STAGES
    else:
        save_checkpoint(str(tmp_path), 0, {"x": torch.zeros(4)}, _crash_hook=hook)
        assert hook.seen == MONO_STAGES


def test_manager_cadence_retention_and_dispatch(tmp_path):
    mgr = CheckpointManager(CkptConfig(dir=str(tmp_path), every=4, keep=2,
                                       coded=CodedSpec(n_shards=4, parity=1)))
    tree = {"x": torch.arange(64.0), "step": np.int32(0)}
    assert mgr.restore_latest(tree) is None
    for step in range(1, 13):
        saved = mgr.maybe_save(step, dict(tree, step=np.int32(step)))
        assert (saved is not None) == (step % 4 == 0)
    assert [s for s, _ in intact_steps(str(tmp_path))] == [12, 8]  # keep=2
    state, step = mgr.restore_from_survivors(dict(tree, x=torch.zeros(64)), missing=[2])
    assert step == 12 and int(state["step"]) == 12
    assert torch.equal(state["x"], torch.arange(64.0))
    assert mgr.maybe_save(12, tree) is None  # no re-save after a rewind
    assert latest_coded_step(str(tmp_path)) == 12


# ----------------------------------------------------------------- trainer
def _port_trainer(tmp, *, init=None, every=2, parity=1, seq=32, adapt=None):
    cfg = get_config("gc-lm-110m").reduced(**KW)
    return Trainer(cfg, TrainConfig(warmup=1, total_steps=16),
                   Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), N), scheme="xf",
                   global_batch=8, seed=0, device="cpu", seq_len=seq, params=init,
                   ckpt=CkptConfig(dir=str(tmp), every=every,
                                   coded=CodedSpec(n_shards=N, parity=parity)),
                   adapt=adapt)


def test_trainer_checkpoints_on_cadence_and_resumes_bitwise(tmp_path):
    tr = _port_trainer(tmp_path)
    assert tr.state.step == 0 and tr.deathwatch is not None
    tr.run(5, log_every=0)
    assert tr.manager.last_saved == 4
    want = _port_bytes(tr.manager.restore_latest(_zeroed(tr.state))[0])
    tr2 = _port_trainer(tmp_path)
    assert tr2.state.step == 4
    assert _port_bytes(tr2.state) == want
    manifest = json.loads((tmp_path / "step_00000004" / "manifest.json").read_text())
    assert manifest["extra"]["plan"] == tr.plan.to_dict()


def test_trainer_death_recovery_matches_reference_trainer(tmp_path):
    """Worker 1 dies (1000x slower from round 0); both trainers trip the
    DeathWatch after step 4, restore step 2 from the three survivors and
    replay: same ledger, history, recovery events and losses (1e-5)."""
    seq = 32
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=16),
                   JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), N), scheme="xf",
                   global_batch=8, seed=0,
                   ckpt=JCkptConfig(dir=str(tmp_path / "jax"), every=2,
                                    coded=JCodedSpec(n_shards=N, parity=1)))
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq,
                                            global_batch=8, seed=0))
    ref.sim.env = ref.env.with_faults(JDegradedWorker(**FAULT))
    ours = _port_trainer(tmp_path / "port", init=jax.tree.map(np.asarray, ref.state.params),
                         seq=seq)
    ours.sim.env = ours.env.with_faults(DegradedWorker(**FAULT))
    before = gc_encode.launches
    _, sum_t = ours.run(6, log_every=0)
    _, sum_j = ref.run(6, log_every=0)
    assert gc_encode.launches == before  # the CPU path takes the plain version
    assert sum_t == sum_j
    for rt, rj in zip(ours.sim.ledger, ref.sim.ledger, strict=True):
        np.testing.assert_array_equal(rt["times"], rj["times"])
    assert len(ours.recoveries) == len(ref.recoveries) == 1
    ev, ev_j = ours.recoveries[0], ref.recoveries[0]
    assert isinstance(ev, RecoveryEvent)
    assert (ev.step, ev.dead_workers, ev.ckpt_step, ev.swap) == \
        (ev_j.step, ev_j.dead_workers, ev_j.ckpt_step, ev_j.swap) == (4, (1,), 2, None)
    for ht, hj in zip(ours.history, ref.history, strict=True):
        assert ht["step"] == hj["step"]
        assert ht.get("recovery") == hj.get("recovery")
        assert ht.get("recovery_ckpt_step") == hj.get("recovery_ckpt_step")
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)
    steps = [h["step"] for h in ours.history]
    assert steps == [1, 2, 3, 4, 3, 4]
    # the replayed step's monitoring loss uses the restored parameters
    assert ours.history[4]["loss"] == ours.history[2]["loss"]
    assert ours.deathwatch.dead == {1} and ours.state.step == 4


def test_death_recovery_with_a_controller_replans_like_reference(tmp_path):
    """Worker 1 dies from round 6: both trainers trip the DeathWatch after
    step 10, force a re-plan from the 5 newest of the 10 observed rounds
    (the drift checks are still gated off) and restore step 8 from the
    survivors; the forced swap and the plan after it are the
    reference's exactly."""
    seq, fault = 16, dict(FAULT, from_round=6)
    ad = dict(window=64, min_rounds=48)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=16),
                   JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), N), scheme="xf",
                   global_batch=8, seed=0, adapt=JAdaptConfig(**ad),
                   ckpt=JCkptConfig(dir=str(tmp_path / "jax"), every=2,
                                    coded=JCodedSpec(n_shards=N, parity=1)))
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq,
                                            global_batch=8, seed=0))
    ref.sim.env = ref.env.with_faults(JDegradedWorker(**fault))
    ours = _port_trainer(tmp_path / "port", init=jax.tree.map(np.asarray, ref.state.params),
                         seq=seq, adapt=AdaptConfig(**ad))
    ours.sim.env = ours.env.with_faults(DegradedWorker(**fault))
    ours.run(11, log_every=0)
    ref.run(11, log_every=0)
    assert len(ours.recoveries) == len(ref.recoveries) == 1
    ev, ev_j = ours.recoveries[0], ref.recoveries[0]
    assert (ev.step, ev.dead_workers, ev.ckpt_step) == \
        (ev_j.step, ev_j.dead_workers, ev_j.ckpt_step) == (10, (1,), 8)
    assert ev.swap is not None and ev_j.swap is not None
    assert (ev.swap.round_idx, ev.swap.x_old.tolist(), ev.swap.x_new.tolist(),
            ev.swap.predicted_gain) == (ev_j.swap.round_idx, ev_j.swap.x_old.tolist(),
                                        ev_j.swap.x_new.tolist(), ev_j.swap.predicted_gain)
    assert ev.swap.round_idx == 10 and ev.swap.x_new.tolist() != ev.swap.x_old.tolist()
    assert json.dumps(ours.plan.to_dict(), sort_keys=True) == \
        json.dumps(ref.plan.to_dict(), sort_keys=True)
    assert ours.controller.swaps == [ev.swap] and len(ours.controller.monitor) == 1
    for ht, hj in zip(ours.history, ref.history, strict=True):
        assert (ht["step"], ht.get("recovery")) == (hj["step"], hj.get("recovery"))
        np.testing.assert_allclose(ht["loss"], hj["loss"], rtol=1e-5)


def test_recovery_without_a_checkpoint_continues(tmp_path):
    tr = _port_trainer(tmp_path, every=0)
    tr.sim.env = tr.env.with_faults(DegradedWorker(**FAULT))
    logs = []
    tr.run(5, log_every=1, log_fn=logs.append)
    assert tr.recoveries == [] and tr.deathwatch.dead == {1}
    assert any("no checkpoint to restore" in line for line in logs)
    assert tr.state.step == 5


def test_trainer_without_ckpt_has_no_recovery_surface():
    cfg = get_config("gc-lm-110m").reduced(**KW)
    tr = Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=N, device="cpu",
                 global_batch=8, seq_len=16)
    assert tr.manager is None and tr.deathwatch is None and tr.recoveries == []


# ----------------------------------------------------------------- launcher
def test_launch_cli_ckpt_flags_save_and_resume(tmp_path, capsys):
    argv = ["--reduced", "--seq", "16", "--global-batch", "8", "--device", "cpu",
            "--log-every", "0", "--ckpt", str(tmp_path), "--ckpt-every", "2",
            "--ckpt-coded", "1"]
    first = launch_train.main(argv + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "saved:" in out and "resumed" not in out
    assert first.manager.last_saved == 3
    assert CheckpointManager(CkptConfig(dir=str(tmp_path))).latest() == (3, "coded")
    second = launch_train.main(argv + ["--steps", "5"])
    out = capsys.readouterr().out
    assert f"resumed from checkpoint step 3 under {tmp_path}" in out
    assert len(second.history) == 2 and second.state.step == 5
    assert second.manager.last_saved == 5
