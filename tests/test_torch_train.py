"""Coded training in the port against the JAX reference, on the CPU.

* the flat coded gradient equals the reference's
  ``make_coded_grad_fn(mode="sim", pipeline="flat")`` and the port's own
  uncoded gradient for every straggler count 0..s_max — the bounds of
  ``tests/test_flat_pipeline.py`` (1e-5 between two coded forms, 1e-4
  against the uncoded mean, fp32); its combine is one grouped call per
  step (one kernel launch on CUDA);
* one clip + AdamW + cosine update equals ``repro.optim.optim``;
* three ``Trainer`` steps from the same initial parameters and seed give
  the same ledger bit for bit, and the same losses and parameters to
  tolerance.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.optim import optim as joptim
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.kernels import gc_fused, ops, ref
from repro_torch.launch import train as launch_train
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.optim import optim
from repro_torch.train.coded import (combine_rows, make_coded_grad_fn, per_shard_grad_rows,
                                     uncoded_grad_fn)
from repro_torch.train.trainer import TrainConfig, Trainer

N = 4
KW = dict(n_layers=2, d_model=128)


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


def _max_err(a, b):
    return max(float(np.abs(np.asarray(x, np.float32) - np.asarray(y, np.float32)).max())
               for x, y in zip(a, b))


@pytest.fixture(scope="module")
def sim_setup():
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    state, _ = jax_init_train_state(cfg_j, jax.random.PRNGKey(0))
    model = params_from_numpy(GCLM(cfg_t, device="cpu"),
                              jax.tree.map(np.asarray, state.params))
    plan_j = JPlan.build(state.params, JShiftedExp(mu=1e-3, t0=50.0), N, scheme="xf")
    plan_t = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), N, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=48, global_batch=8))
    wb = coded_worker_batches(data, 0, N, plan_t.s_max)
    shards = np.stack([data.shard(0, i, N) for i in range(N)])
    g_unc = uncoded_grad_fn(cfg_t, N)(model, shards)
    return cfg_t, cfg_j, state, model, plan_t, plan_j, wb, g_unc


def test_flat_coded_grads_match_jax_and_uncoded_every_straggler_count(sim_setup):
    cfg_t, cfg_j, state, model, plan_t, plan_j, wb, g_unc = sim_setup
    assert plan_t.to_dict() == plan_j.to_dict()
    ours = make_coded_grad_fn(cfg_t, plan_t, mode="sim", pipeline="flat")
    theirs = jax.jit(jax_coded_grad_fn(cfg_j, plan_j, mode="sim", pipeline="flat"))
    for u in range(plan_t.s_max + 1):
        times = np.ones(N)
        times[:u] = 1e6  # u realized stragglers
        dec_w = plan_t.decode_weights(times).astype(np.float32)
        g_t = ours(model, wb, dec_w)
        g_j = jax.tree.leaves(theirs(state.params, jnp.asarray(wb), jnp.asarray(dec_w)))
        assert [tuple(g.shape) for g in g_t] == [g.shape for g in g_j]
        assert _max_err(g_t, g_j) < 1e-5, u      # port flat == reference flat
        assert _max_err(g_t, g_unc) < 1e-4, u    # port flat == port uncoded


def test_combine_makes_one_grouped_call_per_step(sim_setup, monkeypatch):
    """Each coded gradient makes one grouped combine call over all leaves
    (one gc_fused launch per step on CUDA), never one call per leaf; its
    outputs, in leaf order, are those of the per-leaf combine."""
    cfg_t, _, _, model, plan_t, _, wb, _ = sim_setup
    calls = []
    grouped = ref.encode_decode_leaves_ref

    def counted(a, b_codes, which, gs):
        calls.append((tuple(b_codes.shape), tuple(which), len(gs)))
        return grouped(a, b_codes, which, gs)

    def per_leaf(*args):
        raise AssertionError("combine_rows made a per-leaf call")

    monkeypatch.setattr(ref, "encode_decode_leaves_ref", counted)
    monkeypatch.setattr(ops, "encode_decode", per_leaf)
    layout = plan_t.flat_layout
    dec_w = plan_t.decode_weights(np.ones(N)).astype(np.float32)
    rows = per_shard_grad_rows(cfg_t, model, wb)
    got = combine_rows(plan_t, rows, dec_w)
    nk = N * plan_t.k_shards
    assert calls == [((layout.n_levels, 1, nk), layout.leaf_level, layout.n_leaves)]
    inv_n = torch.ones(1) / N
    b_rows = torch.as_tensor(plan_t.b_rows, dtype=torch.float32)
    for j, y in enumerate(got):
        li = layout.leaf_level[j]
        w = (torch.from_numpy(dec_w[li])[:, None] * b_rows[:, li, :]).reshape(1, -1)
        want = ref.encode_decode_ref(inv_n, w, rows[j])[0].reshape(layout.leaf_shapes[j])
        assert torch.equal(y, want), j
    make_coded_grad_fn(cfg_t, plan_t)(model, wb, dec_w)
    assert len(calls) == 2


def test_coded_grad_fn_scope_raises(sim_setup):
    """spmd mode is ported (tests/test_torch_spmd.py) and needs a mesh;
    the tree pipeline is ported (tests/test_torch_wave.py); an unknown
    mode or pipeline is refused."""
    cfg_t, _, _, _, plan_t, *_ = sim_setup
    with pytest.raises(ValueError, match="needs a mesh"):
        make_coded_grad_fn(cfg_t, plan_t, mode="spmd")
    with pytest.raises(ValueError, match="unknown mode"):
        make_coded_grad_fn(cfg_t, plan_t, mode="pmap")
    with pytest.raises(ValueError, match="unknown pipeline"):
        make_coded_grad_fn(cfg_t, plan_t, pipeline="ring")


@pytest.mark.parametrize("step", [0, 3, 50, 120])
def test_one_update_matches_reference_optim(step):
    rng = np.random.default_rng(step)
    shapes = [(7,), (3, 5), (2, 4, 6)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    grads = [(3.0 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    m = [(0.1 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    v = [np.abs(0.01 * rng.standard_normal(s)).astype(np.float32) for s in shapes]
    count = 4

    lr_j = joptim.cosine_schedule(step, 3e-4, 10, 100)
    gj, norm_j = joptim.clip_by_global_norm([jnp.asarray(g) for g in grads], 1.0)
    pj, oj = joptim.adamw_update(
        gj, {"m": [jnp.asarray(x) for x in m], "v": [jnp.asarray(x) for x in v],
             "count": jnp.asarray(count, jnp.int32)},
        [jnp.asarray(p) for p in params], lr_j, weight_decay=0.01)

    lr_t = optim.cosine_schedule(step, 3e-4, 10, 100)
    gt, norm_t = optim.clip_by_global_norm([torch.from_numpy(g) for g in grads], 1.0)
    pt = [torch.from_numpy(p.copy()) for p in params]
    ot = optim.adamw_update(gt, {"m": [torch.from_numpy(x.copy()) for x in m],
                                 "v": [torch.from_numpy(x.copy()) for x in v],
                                 "count": count}, pt, lr_t, weight_decay=0.01)
    np.testing.assert_allclose(float(lr_t), float(lr_j), rtol=1e-6)  # cos: an ulp
    # fp32 elementwise math in the same order: equal to the last ulp or two
    np.testing.assert_allclose(float(norm_t), float(norm_j), rtol=1e-6)
    assert ot["count"] == int(oj["count"]) == count + 1
    for got, want in ((pt, pj), (ot["m"], oj["m"]), (ot["v"], oj["v"])):
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-9)


def test_three_trainer_steps_match_reference_trainer():
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    seq = 32
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=10),
                   JShiftedExp(mu=1e-3, t0=50.0), n_workers=N, scheme="xf",
                   global_batch=8, seed=0)
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq,
                                            global_batch=8, seed=0))
    init = jax.tree.map(np.asarray, ref.state.params)
    ours = Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10),
                   ShiftedExponential(mu=1e-3, t0=50.0), n_workers=N, scheme="xf",
                   global_batch=8, seed=0, device="cpu", params=init, seq_len=seq)
    assert ours.plan.to_dict() == ref.plan.to_dict()
    before = gc_fused.launches
    _, sum_t = ours.run(3, log_every=0)
    _, sum_j = ref.run(3, log_every=0)
    assert gc_fused.launches == before  # the CPU path never launches the kernel
    # the ledger is the same numpy simulation: bit-identical
    assert sum_t == sum_j
    for rt, rj in zip(ours.sim.ledger, ref.sim.ledger):
        np.testing.assert_array_equal(rt["times"], rj["times"])
        assert (rt["tau_coded"], rt["tau_uncoded"]) == (rj["tau_coded"], rj["tau_uncoded"])
    for ht, hj in zip(ours.history, ref.history):
        assert ht["step"] == hj["step"]
        assert (ht["tau_coded"], ht["tau_uncoded"]) == (hj["tau_coded"], hj["tau_uncoded"])
        # fp32 sums in another order: the loss and gradient norm agree to 1e-5
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
        # torch's and XLA's cos may differ by an ulp
        np.testing.assert_allclose(ht["lr"], hj["lr"], rtol=1e-6)
    # two non-zero updates (lr is 0 at step 0 during warmup) each move a
    # weight by at most about lr = 3e-4; the two packages agree to 1% of it
    params_t = params_to_numpy(ours.state.params)
    for a, b in zip(jax.tree.leaves(params_t),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6)
    assert ours.state.step == int(ref.state.step) == 3


def test_trainer_unported_options_raise():
    """Every option of the reference trainer is ported (ckpt=, adapt=,
    wave=, mode="spmd", grad_dtype=, and scheme="auto" with budget=:
    tests/test_torch_{checkpoint,adapt,wave,spmd,tune}.py); ``budget=``
    without ``scheme="auto"`` raises the reference's ``ValueError`` in
    both packages."""
    from repro.tune import MemBudget as JMemBudget
    from repro_torch.tune import MemBudget

    dist = ShiftedExponential()
    with pytest.raises(ValueError, match="scheme='auto'"):
        Trainer(get_config("gc-lm-110m").reduced(**KW), TrainConfig(), dist, n_workers=N,
                device="cpu", budget=MemBudget.from_gb(1))
    with pytest.raises(ValueError, match="scheme='auto'"):
        JTrainer(jax_get_config("gc-lm-110m").reduced(**KW), JTrainConfig(),
                 JShiftedExp(), n_workers=N, scheme="xf", budget=JMemBudget.from_gb(1))


def test_launch_cli_runs_on_cpu(capsys):
    trainer = launch_train.main(["--reduced", "--steps", "2", "--seq", "16",
                                 "--global-batch", "8", "--device", "cpu",
                                 "--log-every", "0"])
    out = capsys.readouterr().out
    assert "s_max=3" in out and "simulated runtime" in out
    assert len(trainer.history) == 2
    assert all(np.isfinite(h["loss"]) for h in trainer.history)


def test_launch_cli_env_and_adapt_flags(tmp_path, capsys):
    """``--env`` loads an ``Env.to_dict()`` file (its worker count wins)
    and ``--adapt`` runs the controller with ``--adapt-window`` rounds."""
    env = Env.heterogeneous([ShiftedExponential(mu=1e-3, t0=50.0)] * 2
                            + [ShiftedExponential(mu=5e-4, t0=50.0)] * 3)
    path = tmp_path / "env.json"
    path.write_text(json.dumps(env.to_dict()))
    trainer = launch_train.main(["--reduced", "--steps", "3", "--seq", "16",
                                 "--global-batch", "10", "--device", "cpu",
                                 "--log-every", "0", "--env", str(path), "--adapt",
                                 "--adapt-window", "8"])
    out = capsys.readouterr().out
    assert "workers=5" in out and "adapt=True" in out and "plan swap(s)" in out
    assert trainer.env.to_dict() == env.to_dict() and trainer.n_workers == 5
    assert trainer.controller.monitor.window == 8
    assert len(trainer.controller.monitor) == 3 and len(trainer.history) == 3
