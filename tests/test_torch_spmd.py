"""spmd coded training of the port over ``torch.distributed``, against
the JAX reference's spmd mode, on the CPU.

* The reference runs once, in one subprocess with four fake host devices
  (as ``tests/test_spmd.py`` runs it), and writes its outputs to an
  ``.npz``: its initial weights, its spmd gradients on the meshes
  ``(4,) ("data",)`` (N = 4) and ``(2, 2) ("pod", "data")`` (N = 2) for
  the flat pipeline with ``psum``, ``psum_scatter`` and bf16
  ``grad_dtype`` and the tree pipeline with ``psum`` and
  ``psum_scatter``, for every straggler count; its sim-mode bf16
  gradient; and three steps of its spmd ``Trainer``.
* The port runs one four-process gloo job per mesh through
  ``repro_torch.dist.spawn`` (module-scoped), and one four-rank job for
  the trainer, the plan swap, the coded restore and the wave loop.
* Gradients: fp32 within 1e-5 of each leaf's scale of the reference's
  spmd output and of the port's sim mode, within 1e-4 of the uncoded
  gradient; bf16 within the reference's 5e-2 of the uncoded gradient and
  within 2^-7 of each leaf's scale of the reference's bf16 output; the
  same bytes on every rank; one grouped combine call per rank and one
  collective per level (twice that for ``psum_scatter``, plus one per
  level over the pod ranks), one per leaf for the tree.
* The trainer: the reference's ledger bit for bit, losses within 1e-5,
  parameters within 3e-6 and byte-equal across ranks; a swap at the
  sim-mode step with its x; a coded restore bit-identical to the live
  state for every two lost shards; the wave loop's staleness 0 byte-equal
  to the spmd barrier loop and staleness 1 executing the simulator's
  trace, in step with sim mode.
* Errors: a model axis that does not divide the world, what the model
  axis does not split yet (MLA), serving's wrong meshes, ``--model-par``
  without spmd, two NCCL ranks on one card and a rank's exception raise;
  a hung job is killed at its time limit (checkpoints, adapt, the wave
  loop and the tuner on the model axis: ``tests/test_torch_tp_state.py``).
"""
import hashlib
import itertools
import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, Plan, ShiftedExponential
from repro_torch.core.flat import LANE
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import collectives, spawn as dist_spawn
from repro_torch.kernels import _pipe, ops
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import prefill
from repro_torch.models.params import GCLM, params_from_numpy, shard_model
from repro_torch.serve import ServeEngine
from repro_torch.train.coded import (make_coded_grad_fn, per_shard_grad_rows, scatter_dims,
                                     uncoded_grad_fn)
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step
from repro_torch.train.wave import WaveConfig

pytestmark = pytest.mark.spmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 4
KW = dict(n_layers=2, d_model=128)
SEQ = 48
SE = ShiftedExponential(mu=1e-3, t0=50.0)
#: seconds every multi-process job may take before it is killed
LIMIT = 300.0
MESHES = {"data": dict(data=4, pod=1), "pod": dict(data=2, pod=2)}
VARIANTS = {"flat": dict(pipeline="flat"),
            "flat_scatter": dict(pipeline="flat", reduce_mode="psum_scatter"),
            "flat_bf16": dict(pipeline="flat", grad_dtype=torch.bfloat16),
            "tree": dict(pipeline="tree"),
            "tree_scatter": dict(pipeline="tree", reduce_mode="psum_scatter")}
ADAPT_FAULTS = [dict(worker=w, factor=8.0, from_round=2) for w in (2, 3)]
WAVE = dict(update_cost=3e7, broadcast_latency=1e6)

JAX_SIDE = textwrap.dedent("""
    import os, sys
    import jax, numpy as np, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import Plan, ShiftedExponential
    from repro.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
    from repro.dist.sharding import make_rules, use_mesh
    from repro.train.coded import _scatter_dims, make_coded_grad_fn
    from repro.train.state import init_train_state
    from repro.train.trainer import TrainConfig, Trainer

    out = {}
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    state, _ = init_train_state(cfg, jax.random.PRNGKey(0))
    for j, leaf in enumerate(jax.tree.leaves(state.params)):
        out[f"init/{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1] + ".tmp.npz", **out)  # the weights first: the port starts on them
    os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=%(seq)d, global_batch=8))
    se = ShiftedExponential(mu=1e-3, t0=50.0)
    shapes = jax.tree.map(lambda l: jax.ShapeDtypeStruct(l.shape, l.dtype), state.params)

    def dec(plan, n, u):
        times = np.ones(n); times[:u] = 1e6
        return jnp.asarray(plan.decode_weights(times), jnp.float32)

    def put(key, tree):
        for j, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{key}/{j}"] = np.asarray(leaf.astype(jnp.float32))

    for tag, shape, names in (("data", (4,), ("data",)), ("pod", (2, 2), ("pod", "data"))):
        mesh = jax.make_mesh(shape, names,
                             axis_types=(jax.sharding.AxisType.Auto,) * len(names))
        n = mesh.shape["data"]
        plan = Plan.build(state.params, se, n, scheme="xf")
        wb = jnp.asarray(coded_worker_batches(data, 0, n, plan.s_max))
        out[f"dims/{tag}"] = np.asarray([-1 if d is None else d
                                         for d in _scatter_dims(shapes, None, n)])
        kws = {"flat": dict(pipeline="flat"),
               "flat_scatter": dict(pipeline="flat", reduce_mode="psum_scatter"),
               "flat_bf16": dict(pipeline="flat", grad_dtype=jnp.bfloat16),
               "tree": dict(pipeline="tree"),
               "tree_scatter": dict(pipeline="tree", reduce_mode="psum_scatter",
                                    param_shapes=shapes)}
        with use_mesh(mesh, make_rules(cfg)):
            for name, kw in kws.items():
                fn = jax.jit(make_coded_grad_fn(cfg, plan, mesh=mesh, mode="spmd", **kw))
                for u in range(plan.s_max + 1):
                    put(f"{tag}/{name}/{u}", fn(state.params, wb, dec(plan, n, u)))
        if tag == "data":
            fn = jax.jit(make_coded_grad_fn(cfg, plan, mode="sim", pipeline="flat",
                                            grad_dtype=jnp.bfloat16))
            for u in (0, plan.s_max):
                put(f"sim_bf16/{u}", fn(state.params, wb, dec(plan, n, u)))

    mesh = jax.make_mesh((4,), ("data",), axis_types=(jax.sharding.AxisType.Auto,))
    with use_mesh(mesh, make_rules(cfg)):
        tr = Trainer(cfg, TrainConfig(warmup=1, total_steps=10), se, n_workers=4,
                     scheme="xf", global_batch=8, seed=0, mesh=mesh, mode="spmd")
        tr.data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                                             seed=0))
        tr.run(3, log_every=0)
    put("trainer/params", tr.state.params)
    for key in ("loss", "grad_norm", "lr", "tau_coded", "tau_uncoded", "step"):
        out[f"trainer/{key}"] = np.asarray([h[key] for h in tr.history])
    out["trainer/times"] = np.stack([r["times"] for r in tr.sim.ledger])
    np.savez(sys.argv[2], **out)
    print(len(jax.devices()))
""") % {"seq": SEQ}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread, as every rank runs: under the tier-1 run's
    pytest-xdist workers torch's pool otherwise spins on shared cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg():
    return get_config("gc-lm-110m").reduced(**KW)


def _tree(leaves) -> dict:
    """The reference parameter tree of leaves in leaf order."""
    return GCLM(_cfg(), device="meta").tree(leaves)


def _leaves(blob, key) -> list:
    n = len([k for k in blob if k.startswith(f"{key}/")])
    return [blob[f"{key}/{j}"] for j in range(n)]


def _setup(init, n_workers):
    cfg = _cfg()
    model = params_from_numpy(GCLM(cfg, device="cpu"), _tree(init))
    plan = Plan.build(model, SE, n_workers, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=8))
    wb = coded_worker_batches(data, 0, n_workers, plan.s_max)
    dec_ws = []
    for u in range(plan.s_max + 1):
        times = np.ones(n_workers)
        times[:u] = 1e6  # u realized stragglers
        dec_ws.append(plan.decode_weights(times).astype(np.float32))
    shards = np.stack([data.shard(0, i, n_workers) for i in range(n_workers)])
    return cfg, model, plan, wb, dec_ws, shards


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        h.update(str(t.dtype).encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _count_grouped_calls() -> list:
    """Count the grouped combine calls of this process (one ``gc_fused``
    launch each on CUDA; on the CPU they take the plain version)."""
    calls, grouped = [], ops.encode_decode_leaves

    def counted(*args, **kwargs):
        calls.append(len(args[3]))
        return grouped(*args, **kwargs)

    ops.encode_decode_leaves = counted
    return calls



def _worst(got, want, tol: float, scales=None) -> float:
    """Largest per-leaf max error over ``tol`` times the leaf's scale
    (``scales[j]``, by default max |want|): <= 1 means within the bound."""
    worst = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        scale = float(np.abs(b).max()) if scales is None else scales[j]
        worst = max(worst, float(np.abs(a - b).max()) / (tol * scale) if scale else
                    float(np.abs(a).max()))
    return worst


def _max_abs(got, want) -> float:
    return max(float(np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32)).max())
               for a, b in zip(got, want, strict=True))


# ------------------------------------------------------------------ ranks
def _init(ref_path) -> list:
    with np.load(ref_path) as blob:
        return _leaves(blob, "init")


def _grads(mesh, ref_path, calls):
    """Every variant's spmd gradient for every straggler count: rank 0's
    values, every rank's digest, and the calls of each."""
    cfg, model, plan, wb, dec_ws, _ = _setup(_init(ref_path), mesh.data)
    out = {"digests": {}, "grads": {}, "counts": {}, "coords": (mesh.pod_index, mesh.data_index)}
    for name, kw in VARIANTS.items():
        fn = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh, **kw)
        for u, dec_w in enumerate(dec_ws):
            collectives.reset_counts()
            calls.clear()
            g = [t.detach().clone() for t in fn(model, wb, dec_w)]
            out["counts"][name, u] = (list(calls), dict(collectives.counts))
            out["digests"][name, u] = _digest(g)
            if mesh.rank == 0:
                out["grads"][name, u] = [t.float().numpy() for t in g]
    return out


def _spmd_trainer(tree, mesh, seq, **kw):
    return Trainer(_cfg(), kw.pop("cfg_t", TrainConfig(warmup=2, total_steps=40)),
                   kw.pop("env", Env.iid(SE, N)), scheme="xf", global_batch=8, seed=0,
                   device="cpu", params=tree, seq_len=seq, mesh=mesh, mode="spmd", **kw)


def _rank(rank, world, ref_path, ckpt_dir):
    """The job of every rank: the gradients on both meshes, then the spmd
    trainer against the reference, a swap, a coded restore and the wave
    loop on the (4,) data mesh."""
    calls = _count_grouped_calls()
    meshes = {tag: make_local_mesh(**kw, device="cpu") for tag, kw in MESHES.items()}
    out = {tag: _grads(mesh, ref_path, calls) for tag, mesh in meshes.items()}
    mesh = meshes["data"]
    tree = _tree(_init(ref_path))

    tr = _spmd_trainer(tree, mesh, 32, cfg_t=TrainConfig(warmup=1, total_steps=10))
    collectives.reset_counts()
    calls.clear()
    digests = []
    for _ in range(3):
        tr.run(1, log_every=0)
        digests.append(tr.state.digest())
    out["trainer"] = dict(
        history=[{k: v for k, v in h.items() if k != "wall_s"} for h in tr.history], times=[r["times"] for r in tr.sim.ledger],
        taus=[(r["tau_coded"], r["tau_uncoded"]) for r in tr.sim.ledger],
        digests=digests, calls=list(calls), counts=dict(collectives.counts),
        n_levels=tr.plan.flat_layout.n_levels,
        params=[t.detach().numpy().copy() for t in tr.state.params.leaves()])

    env = Env.iid(SE, N).with_faults(*(DegradedWorker(**f) for f in ADAPT_FAULTS))
    tr = _spmd_trainer(tree, mesh, 16, env=env,
                       adapt=AdaptConfig(window=16, min_rounds=8, check_every=2))
    tr.run(18, log_every=0)
    out["swap"] = dict(swapped=[h["step"] for h in tr.history if h.get("plan_swap")],
                       plan=json.dumps(tr.plan.to_dict(), sort_keys=True),
                       losses=[h["loss"] for h in tr.history], digest=tr.state.digest())

    tr = _spmd_trainer(tree, mesh, 32, ckpt=CkptConfig(dir=ckpt_dir, every=2,
                                                       coded=CodedSpec(n_shards=N, parity=2)))
    tr.run(2, log_every=0)
    live = tr.state.digest()
    restored = {lost: (tr.restore_checkpoint(missing=lost), tr.state.digest())
                for lost in itertools.combinations(range(N), 2)}
    out["ckpt"] = dict(live=live, restored=restored, saved=tr.manager.last_saved)

    state = init_train_state(_cfg(), device="cpu", params=tree)
    state, metrics = make_train_step(_cfg(), UNCODED_CFG, mesh=mesh)(state, _uncoded_batch())
    out["uncoded"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                          digest=state.digest(),
                          params=[t.detach().numpy().copy() for t in state.params.leaves()])

    bar = _spmd_trainer(tree, mesh, 16)
    bar.run(4, log_every=0)
    w0 = _spmd_trainer(tree, mesh, 16, wave=WaveConfig(staleness=0, **WAVE))
    w0.run(4, log_every=0)
    w1 = _spmd_trainer(tree, mesh, 16, wave=WaveConfig(staleness=1, **WAVE))
    w1.run(6, log_every=0)
    [trace], [executed] = w1.wave.traces, w1.wave.executed
    out["wave"] = dict(
        barrier=(bar.state.digest(), [h["loss"] for h in bar.history]),
        stale0=(w0.state.digest(), [h["loss"] for h in w0.history], w0.wave._strategy(w0.plan)),
        strategy=w1.wave._strategy(w1.plan), executed_is_trace=executed == list(trace.events),
        trace=json.dumps(trace.to_dict(), sort_keys=True), digest=w1.state.digest(),
        history=[(h["step"], h["staleness"], h["loss"], h["grad_norm"]) for h in w1.history],
        params=[t.detach().numpy().copy() for t in w1.state.params.leaves()])
    return out


#: the uncoded step's schedule: no warmup, so its first update moves the weights
UNCODED_CFG = TrainConfig(warmup=0, total_steps=10)


def _uncoded_batch() -> dict:
    return {"tokens": SyntheticTokens(DataConfig(vocab=_cfg().vocab, seq_len=32,
                                                 global_batch=8)).batch(0)}


def _raise_on_rank_1(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.all_reduce(torch.zeros(1))  # rank 0 waits for rank 1 here


def _sleep(rank, world):
    time.sleep(3600)


# --------------------------------------------------------------- fixtures
@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The reference, in one JAX subprocess that writes its initial
    weights first and its outputs when it ends; the port's jobs run
    meanwhile."""
    d = tmp_path_factory.mktemp("jax")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               PYTHONPATH=os.path.join(ROOT, "src"))
    with open(d / "stdout", "w") as out, open(d / "stderr", "w") as err:
        proc = subprocess.Popen([sys.executable, "-c", JAX_SIDE, str(d / "init.npz"),
                                 str(d / "ref.npz")], env=env, stdout=out, stderr=err)
    try:
        yield proc, d
    finally:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def jax_path(jax_proc):
    """The file of the reference's initial weights; the ranks read them
    from it (a spawned process reads its arguments only after its
    imports, so large ones would start the ranks one after another)."""
    proc, d = jax_proc
    deadline = time.monotonic() + LIMIT
    while not (d / "init.npz").exists():
        assert proc.poll() is None, (d / "stderr").read_text()[-4000:]
        assert time.monotonic() < deadline, "the reference wrote no weights in time"
        time.sleep(0.2)
    return str(d / "init.npz")


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    proc, d = jax_proc
    assert proc.wait(timeout=LIMIT) == 0, (d / "stderr").read_text()[-4000:]
    assert (d / "stdout").read_text().split()[-1] == "4"  # four host devices
    with np.load(d / "ref.npz") as blob:
        return dict(blob)


@pytest.fixture(scope="module")
def init(jax_path):
    return _init(jax_path)


@pytest.fixture(scope="module")
def spmd_run(jax_path, tmp_path_factory):
    """The one four-process gloo job of the module (``_rank``)."""
    return dist_spawn.spawn(_rank, 4, jax_path, str(tmp_path_factory.mktemp("ckpt")),
                            store_dir=str(tmp_path_factory.mktemp("spawn")), timeout=LIMIT)


@pytest.fixture(scope="module")
def port_refs(init):
    """Per mesh: the plan, and the port's sim-mode coded gradient, its
    uncoded gradient and the scales of the coded contributions on the
    same weights and batches."""
    out = {}
    for tag, kw in MESHES.items():
        cfg, model, plan, wb, dec_ws, shards = _setup(init, kw["data"])
        sim = make_coded_grad_fn(cfg, plan, mode="sim", pipeline="flat")
        rows = per_shard_grad_rows(cfg, model, wb)
        out[tag] = dict(plan=plan, sim=[[t.numpy() for t in sim(model, wb, d)] for d in dec_ws],
                        uncoded=[t.numpy() for t in uncoded_grad_fn(cfg, kw["data"])(model, shards)],
                        contrib=[_contribution_scales(plan, rows, d) for d in dec_ws])
    return out


def _contribution_scales(plan, rows, dec_w) -> list:
    """Per leaf, max over its elements of sum_n |c_n|, c_n = (dec_w[l, n]
    / N) b_rows[n, l] @ G_n worker n's coded contribution: the largest
    partial sum a reduction of the contributions can form, the scale of
    its rounding error."""
    n, k = plan.n_workers, plan.k_shards
    out = []
    for j, g in enumerate(rows):
        li = plan.flat_layout.leaf_level[j]
        total = sum((float(dec_w[li, w]) / n * torch.as_tensor(plan.b_rows[w, li],
                                                               dtype=torch.float32)
                     @ g[w * k:(w + 1) * k]).abs() for w in range(n))
        out.append(float(total.max()))
    return out


@pytest.mark.parametrize("tag", list(MESHES))
def test_spmd_grads_have_the_same_bytes_on_every_rank(spmd_run, port_refs, tag):
    ranks = [r[tag] for r in spmd_run]
    pods, data = MESHES[tag]["pod"], MESHES[tag]["data"]
    # pod-major ranks, as jax.make_mesh((pod, data), ("pod", "data")) lays out devices
    assert [r["coords"] for r in ranks] == [(p, d) for p in range(pods) for d in range(data)]
    for key, digest in ranks[0]["digests"].items():
        assert all(r["digests"][key] == digest for r in ranks), key
    assert ranks[0]["grads"]["flat_bf16", 0][0].dtype == np.float32  # returned as fp32
    assert len(ranks[0]["digests"]) == len(VARIANTS) * (port_refs[tag]["plan"].s_max + 1)


@pytest.mark.parametrize("tag", list(MESHES))
def test_spmd_counts_one_grouped_call_and_one_collective_per_level(spmd_run, port_refs, tag):
    plan = port_refs[tag]["plan"]
    layout, pod = plan.flat_layout, MESHES[tag]["pod"]
    n_lv, n_leaves = layout.n_levels, layout.n_leaves
    pod_sums = n_lv if pod > 1 else 0
    dims = [d for d in scatter_dims(layout.leaf_shapes, plan.n_workers) if d is not None]
    want = {"flat": ([n_leaves], dict(psum=n_lv + pod_sums)),
            "flat_bf16": ([n_leaves], dict(psum=n_lv + pod_sums)),
            "flat_scatter": ([n_leaves], dict(psum=pod_sums, psum_scatter=n_lv, all_gather=n_lv)),
            "tree": ([], dict(psum=n_leaves * (1 + (pod > 1)))),
            "tree_scatter": ([], dict(psum=n_leaves * (pod > 1) + n_leaves - len(dims),
                                      psum_scatter=len(dims), all_gather=len(dims)))}
    for rank in spmd_run:
        for (name, u), (calls, counts) in rank[tag]["counts"].items():
            want_calls, want_counts = want[name]
            assert calls == want_calls, (name, u)
            assert counts == dict(dict.fromkeys(counts, 0), **want_counts), (name, u)


def test_spmd_swap_matches_sim_mode(spmd_run, init):
    """Workers 2 and 3 eight times slower from round 2: the spmd trainer
    swaps after the sim-mode trainer's step, to its plan, and goes on in
    step with it."""
    env = Env.iid(SE, N).with_faults(*(DegradedWorker(**f) for f in ADAPT_FAULTS))
    sim = Trainer(_cfg(), TrainConfig(warmup=2, total_steps=40), env, scheme="xf",
                  global_batch=8, seed=0, device="cpu", params=_tree(init), seq_len=16,
                  adapt=AdaptConfig(window=16, min_rounds=8, check_every=2))
    sim.run(18, log_every=0)
    got = spmd_run[0]["swap"]
    assert got["swapped"] == [h["step"] for h in sim.history if h.get("plan_swap")] == [16]
    assert got["plan"] == json.dumps(sim.plan.to_dict(), sort_keys=True)
    np.testing.assert_allclose(got["losses"], [h["loss"] for h in sim.history], rtol=1e-5)
    assert all(r["swap"] == got for r in spmd_run)


def test_spmd_coded_restore_bit_identical_for_every_two_lost_shards(spmd_run):
    got = spmd_run[0]["ckpt"]
    assert got["saved"] == 2
    assert sorted(got["restored"]) == list(itertools.combinations(range(N), 2))
    assert all(r == (2, got["live"]) for r in got["restored"].values())
    assert all(r["ckpt"] == got for r in spmd_run)


def test_spmd_wave_loop(spmd_run, init):
    """Staleness 0 is byte-equal to the spmd barrier loop; staleness 1
    (deferred: this rank's rows at dispatch, the combine at the update)
    executes the simulator's trace and stays in step with sim mode's
    staged loop (loss 1e-5, parameters 3e-6)."""
    got = spmd_run[0]["wave"]
    assert got["barrier"][0] == got["stale0"][0] and got["barrier"][1] == got["stale0"][1]
    assert got["stale0"][2] == "barrier" and got["strategy"] == "deferred"
    assert got["executed_is_trace"]
    sim = Trainer(_cfg(), TrainConfig(warmup=2, total_steps=40), Env.iid(SE, N), scheme="xf",
                  global_batch=8, seed=0, device="cpu", params=_tree(init), seq_len=16,
                  wave=WaveConfig(staleness=1, **WAVE))
    sim.run(6, log_every=0)
    assert got["trace"] == json.dumps(sim.wave.traces[0].to_dict(), sort_keys=True)
    assert [h[:2] for h in got["history"]] == [(h["step"], h["staleness"]) for h in sim.history]
    for (*_, loss, gnorm), h in zip(got["history"], sim.history, strict=True):
        np.testing.assert_allclose([loss, gnorm], [h["loss"], h["grad_norm"]], rtol=1e-5)
    for a, b in zip(got["params"], sim.state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=3e-6)
    assert all(r["wave"]["digest"] == got["digest"] for r in spmd_run)


def test_spmd_uncoded_step_is_the_plain_data_parallel_step(spmd_run, init):
    """Each rank's rows of the batch, one all_reduce of the gradients and
    metrics: the one-process step on the whole batch, to fp32 order."""
    state = init_train_state(_cfg(), device="cpu", params=_tree(init))
    state, metrics = make_train_step(_cfg(), UNCODED_CFG)(state, _uncoded_batch())
    got = spmd_run[0]["uncoded"]
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(metrics[key]), rtol=1e-5)
    assert got["metrics"]["lr"] == float(metrics["lr"]) > 0
    for a, b in zip(got["params"], state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=3e-6)
    assert all(r["uncoded"]["digest"] == got["digest"] for r in spmd_run)


# ---------------------------------------------------- kernels and layout
def test_out_views_take_the_grouped_combine_in_place():
    """``out=`` writes each leaf into a given view (a level-buffer slice)
    with the allocating call's values; anything the kernel could not
    write as it is raises, with no hidden copy."""
    gen = torch.Generator().manual_seed(0)
    widths, which = [5, 128, 7], [0, 1, 0]
    gs = [torch.randn(4, d, generator=gen) for d in widths]
    a, tab = torch.randn(1, generator=gen), torch.randn(2, 1, 4, generator=gen)
    buf = torch.zeros(sum(widths) + 3)
    offs = np.cumsum([0] + widths)
    views = [buf[o:o + d].view(1, d) for o, d in zip(offs, widths)]
    got = ops.encode_decode_leaves(a, tab, which, gs, out=views)
    want = ops.encode_decode_leaves(a, tab, which, gs)
    assert all(g is v for g, v in zip(got, views))
    for v, w in zip(views, want):
        assert torch.equal(v, w)
    assert torch.equal(buf[-3:], torch.zeros(3))
    bad = {"shape": [torch.zeros(1, d + 1) for d in widths],
           "dtype": [torch.zeros(1, d, dtype=torch.float64) for d in widths],
           "contiguous": [torch.zeros(1, 2 * d)[:, ::2] for d in widths],
           "count": views[:2]}
    for what, out in bad.items():
        with pytest.raises(ValueError):
            ops.encode_decode_leaves(a, tab, which, gs, out=out)


def test_full_width_level_slices_stay_on_the_tma_path():
    """gc-lm-110m's leaf sizes are multiples of 4 floats, so every slice
    of its level buffers starts 16-byte aligned: the grouped kernel takes
    them on its TMA ring (``_pipe.leaf_mode``), not per column."""
    model = GCLM(get_config("gc-lm-110m"), device="meta")
    layout = Plan.build(model, SE, N, scheme="xf").flat_layout
    assert layout.n_leaves == 11 and layout.n_levels == 3
    assert all(size % LANE == 0 for size in layout.level_sizes)
    slices = list(layout.leaf_slices())
    assert sorted(j for j, *_ in slices) == list(range(11))
    for j, li, off, size in slices:
        assert (off * 4) % 16 == 0 and (size * 4) % 16 == 0, j
        assert _pipe.leaf_mode(size, 4, 0, 4 * off, stages=2) == _pipe.RING, j


# ----------------------------------------------------------------- errors
def test_unported_and_impossible_meshes_raise(monkeypatch, tmp_path):
    with pytest.raises(ValueError, match="needs 8 ranks, the world has 1"):
        make_local_mesh(4, model=2, device="cpu")
    monkeypatch.setenv("WORLD_SIZE", "8")
    with pytest.raises(ValueError, match="needs 12 ranks, the world has 8"):
        make_local_mesh(4, model=3, device="cpu")
    monkeypatch.delenv("WORLD_SIZE")
    tp = meta_mesh(data=N, model=2)
    xlstm = shard_model(GCLM(get_config("xlstm-1.3b").reduced(**KW), device="meta"), tp)
    assert xlstm.tp.axes == {"heads", "d_inner", "vocab"}  # on the axis since ROADMAP 6c
    local = shard_model(GCLM(_cfg(), device="meta"), tp)
    logits, caches = prefill(_cfg(), local, torch.zeros((1, 4), dtype=torch.long, device="meta"),
                             last_only=True)  # serving runs on the axis: whole rows, its heads
    assert logits.shape == (1, 1, _cfg().vocab)
    assert caches[0]["k"].shape[-2] == _cfg().n_kv_heads // 2
    with pytest.raises(ValueError, match="another mesh"):
        ServeEngine(_cfg(), local, device="meta", mesh=meta_mesh(data=N, model=2))
    with pytest.raises(ValueError, match="serves only a sharded module"):
        ServeEngine(_cfg(), GCLM(_cfg(), device="meta"), device="meta", mesh=tp)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="one rank per card"):
        dist_spawn.spawn(_sleep, 2, store_dir=str(tmp_path), backend="nccl")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    with pytest.raises(ValueError, match="one rank per card"):
        make_local_mesh(2, device="cuda", backend="nccl")
    with pytest.raises(ValueError, match="CUDA tensors"):
        make_local_mesh(2, device="cpu", backend="nccl")
    assert not torch.distributed.is_initialized()
    cfg = _cfg()
    plan = Plan.build(GCLM(cfg, device="meta"), SE, N)
    with pytest.raises(ValueError, match="needs a mesh"):
        make_coded_grad_fn(cfg, plan, mode="spmd")
    with pytest.raises(ValueError, match="reduce_mode"):
        make_coded_grad_fn(cfg, plan, reduce_mode="all_to_all")
    with pytest.raises(ValueError, match="needs a mesh"):
        Trainer(cfg, TrainConfig(), SE, n_workers=N, device="cpu", mode="spmd")


def test_a_rank_exception_fails_the_job_within_its_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 raised first") as info:
        dist_spawn.spawn(_raise_on_rank_1, 2, store_dir=str(tmp_path), timeout=120.0)
    assert "ValueError: rank 1 fails on purpose" in str(info.value)
    assert time.monotonic() - t0 < 120.0


def test_a_hung_job_is_killed_at_its_limit(tmp_path):
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="killed"):
        dist_spawn.spawn(_sleep, 2, store_dir=str(tmp_path), timeout=8.0)
    assert time.monotonic() - t0 < 8.0 + 30.0


# --------------------------------------------------------------- launcher
def test_launcher_under_torchrun_trains_spmd_and_prints_once():
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--reduced", "--steps", "2", "--seq", "32",
           "--global-batch", "8", "--data-par", "4", "--device", "cpu", "--backend", "gloo",
           "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=LIMIT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].startswith("simulated runtime: {'steps': 2")  # the ledger, last
    assert sum("mode=spmd" in ln for ln in lines) == 1              # rank 0 alone prints
    assert sum(ln.startswith("step") for ln in lines) == 2


def test_launcher_uncoded_trains_the_plain_step(capsys):
    state = launch_train.main(["--reduced", "--steps", "2", "--seq", "16", "--global-batch",
                               "8", "--device", "cpu", "--uncoded", "--log-every", "1"])
    out = capsys.readouterr().out
    assert "uncoded ranks=1" in out and out.count("\nstep ") == 2
    assert state.step == 2 and state.opt["count"] == 2
    with pytest.raises(ValueError, match="--uncoded"):
        launch_train.main(["--reduced", "--steps", "1", "--device", "cpu", "--uncoded",
                           "--adapt"])


def test_launcher_model_par_raises():
    """``--model-par`` splits spmd workers: without ``--data-par`` it
    raises, and in one process its world is too small."""
    with pytest.raises(ValueError, match="splits spmd workers"):
        launch_train.main(["--reduced", "--steps", "1", "--device", "cpu", "--model-par", "2"])
    with pytest.raises(ValueError, match="needs 8 ranks, the world has 1"):
        launch_train.main(["--reduced", "--steps", "1", "--device", "cpu",
                           "--data-par", "4", "--model-par", "2"])
    with pytest.raises(ValueError, match="data-par"):
        launch_train.main(["--reduced", "--steps", "1", "--device", "cpu", "--data-par", "3"])


# ------------------------------------------- against the reference's outputs
# ------------------------------------------------------------------ grads
@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("tag", list(MESHES))
def test_spmd_grads_match_jax_spmd_sim_mode_and_uncoded(spmd_run, port_refs, jax_ref, tag,
                                                         variant):
    ref, rank0 = port_refs[tag], spmd_run[0][tag]
    for u in range(ref["plan"].s_max + 1):
        got = rank0["grads"][variant, u]
        want = _leaves(jax_ref, f"{tag}/{variant}/{u}")
        if variant == "flat_bf16":
            # two bf16 reductions of the same contributions differ by their
            # roundings, which scale with the contributions, not with the
            # decoded sum: at s_max stragglers a decode weight of -15.975
            # makes one contribution ~16x the result, and a last-bit fp32
            # difference flips its bf16 rounding (1.10 * 2^-7 of the
            # output's scale); 2^-7 of sum_n |c_n| bounds it
            assert _worst(got, want, 2.0 ** -7, ref["contrib"][u]) <= 1, u
            assert _max_abs(got, ref["uncoded"]) < 5e-2, u            # == uncoded
            continue
        assert _worst(got, want, 1e-5) <= 1, u                        # == reference spmd
        assert _worst(got, ref["sim"][u], 1e-5) <= 1, u               # == port sim mode
        assert _max_abs(got, ref["uncoded"]) < 1e-4, u                # == uncoded


@pytest.mark.parametrize("tag", list(MESHES))
def test_scatter_dims_are_the_reference_s(port_refs, jax_ref, tag):
    """The tree pipeline's psum_scatter splits each leaf along the
    reference's dimension (a leaf without one takes a plain psum)."""
    plan = port_refs[tag]["plan"]
    dims = scatter_dims(plan.flat_layout.leaf_shapes, plan.n_workers)
    assert [-1 if d is None else d for d in dims] == jax_ref[f"dims/{tag}"].tolist()


def test_sim_mode_bf16_grad_dtype(init, jax_ref):
    """The reference's ``test_flat_bf16_grad_dtype_parity_sim``: bf16
    leaves within 5e-2 of the uncoded gradient, and within 2^-7 of each
    leaf's scale of the reference's sim-mode bf16 output."""
    cfg, model, plan, wb, dec_ws, shards = _setup(init, N)
    fn = make_coded_grad_fn(cfg, plan, mode="sim", pipeline="flat", grad_dtype=torch.bfloat16)
    g_ref = uncoded_grad_fn(cfg, N)(model, shards)
    for u in (0, plan.s_max):
        g = fn(model, wb, dec_ws[u])
        assert all(t.dtype == torch.bfloat16 for t in g)
        got = [t.float().numpy() for t in g]
        assert _max_abs(got, [t.numpy() for t in g_ref]) < 5e-2, u
        assert _worst(got, _leaves(jax_ref, f"sim_bf16/{u}"), 2.0 ** -7) <= 1, u
    with pytest.raises(ValueError, match="grad_dtype"):
        make_coded_grad_fn(cfg, plan, grad_dtype="bf16")


# ---------------------------------------------------------------- trainer
def test_spmd_trainer_matches_jax_spmd_trainer(spmd_run, jax_ref):
    got = spmd_run[0]["trainer"]
    np.testing.assert_array_equal(np.stack(got["times"]), jax_ref["trainer/times"])
    assert [list(t) for t in got["taus"]] == np.stack(
        [jax_ref["trainer/tau_coded"], jax_ref["trainer/tau_uncoded"]], 1).tolist()
    hist = got["history"]
    assert [h["step"] for h in hist] == jax_ref["trainer/step"].tolist() == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hist], jax_ref[f"trainer/{key}"], rtol=1e-5)
    np.testing.assert_allclose([h["lr"] for h in hist], jax_ref["trainer/lr"], rtol=1e-6)
    for a, b in zip(got["params"], _leaves(jax_ref, "trainer/params"), strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6)
    for rank in spmd_run:  # replicated: the same bytes after every step
        assert rank["trainer"]["digests"] == got["digests"]
        assert rank["trainer"]["history"] == hist
    # per step: one grouped call, one psum per level, one draw check
    n_lv = got["n_levels"]
    assert got["calls"] == [len(got["params"])] * 3
    assert got["counts"] == dict(psum=3 * n_lv, psum_scatter=0, all_gather=0, broadcast=3)
