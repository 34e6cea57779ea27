"""The spmd ranks of ``tests/test_torch_tp_state.py``: a sharded state on
a (data 2, model 2) mesh through checkpoints, worker-death recovery,
adaptive re-planning, the wave loop and ``scheme="auto"``, and a
(data 4) mesh's restore, over gloo on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
digests and counts; rank 0 also returns its model group's leaves
gathered into the full tree."""
import json

import numpy as np
import torch

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CheckpointManager, CkptConfig, CodedSpec, coded
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, ShiftedExponential
from repro_torch.data.pipeline import coded_worker_batches
from repro_torch.dist import collectives
from repro_torch.kernels import ops
from repro_torch.launch import mesh as launch_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, gather_model
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.train.wave import WaveConfig
from repro_torch.tune import MemBudget

#: reduced gc-lm-110m at 32 tokens (``max_seq`` 32 in both packages, so
#: the tuner prices the sequence the trainer feeds)
KW = dict(n_layers=2, d_model=128)
MAX_SEQ = 32
N = 2
SE = dict(mu=1e-3, t0=50.0)
SPEC = dict(n_shards=N, parity=1)
#: worker 0 runs 1000x slower from round 6: the DeathWatch (factor 20,
#: 4 rounds) trips after step 10 and the forced re-plan sees the 5 newest
#: of 10 rounds; worker 0 holds the one data stripe of CodedSpec(2, 1), so
#: the restore decodes it from the parity stripe
DEATH = dict(worker=0, factor=1000.0, from_round=6)
DEATH_STEPS = 11
#: drift checks gated off (min_rounds 48): the only swap is the forced one
ADAPT = dict(window=64, min_rounds=48)
WAVE = dict(update_cost=3e7, broadcast_latency=1e6)
WAVE_ROUNDS = 4
CFG_T = dict(warmup=1, total_steps=16)


def cfg():
    return get_config("gc-lm-110m").reduced(**KW).replace(max_seq=MAX_SEQ)


def env(death: bool = False):
    e = Env.iid(ShiftedExponential(**SE), N)
    return e.with_faults(DegradedWorker(**DEATH)) if death else e


def trainer(mesh, tree, **kw):
    return Trainer(cfg(), TrainConfig(**CFG_T), kw.pop("env", env()), n_workers=mesh.data,
                   scheme=kw.pop("scheme", "xf"), global_batch=8, seed=0, device="cpu",
                   params=tree, mesh=mesh, mode="spmd", **kw)


def init_tree(path) -> dict:
    """The reference's initial parameters (leaf order) as its tree."""
    with np.load(path) as blob:
        leaves = [blob[f"init/{j}"] for j in range(len(blob.files))]
    return GCLM(cfg(), device="meta").tree(leaves)


def full_state(tr) -> dict:
    """key -> array of the full tree (every rank of a model group takes
    part in the gathers)."""
    return {k: np.array(v) for k, v in tr.state.full_leaves()}


def gathered_params(tr) -> list:
    return [t.detach().numpy().copy() for t in gather_model(tr.state.params).leaves()]


def _counted(module, name, calls: list) -> None:
    fn = getattr(module, name)

    def counted(*args, **kwargs):
        calls.append(name)
        return fn(*args, **kwargs)

    setattr(module, name, counted)


def _restore_counted(tr, missing, calls) -> dict:
    """``restore_checkpoint`` with this rank's decodes, parity encodes and
    collectives counted."""
    calls.clear()
    collectives.reset_counts()
    step = tr.restore_checkpoint(missing=missing)
    return dict(step=step, calls=sorted(calls), counts=dict(collectives.counts),
                digest=tr.state.digest())


def state_rank(rank, world, paths):
    calls = []
    _counted(coded, "_solve_digits", calls)   # the decode of lost stripes
    _counted(ops, "encode", calls)            # the gc_encode kernel's wrapper
    grouped = []
    _counted(ops, "encode_decode_leaves", grouped)  # one gc_fused launch on CUDA
    mesh = make_local_mesh(N, model=2, device="cpu")
    tree = init_tree(paths["init"])
    out = {"coords": (mesh.data_index, mesh.model_index)}

    # one checkpoint format: plain and coded saves of a state 2 steps on,
    # then a coded restore with worker 0's stripe lost, and the state
    # after a replayed step
    tr = trainer(mesh, tree, ckpt=CkptConfig(dir=paths["plain"]))
    tr.run(2, log_every=0)
    calls.clear()
    tr.save_checkpoint()
    saved, save_calls = tr.state.digest(), sorted(calls)
    tr.manager = CheckpointManager(CkptConfig(dir=paths["coded"], coded=CodedSpec(**SPEC)))
    calls.clear()
    tr.save_checkpoint()
    save_calls += sorted(calls)
    full = full_state(tr)
    tr.run(1, log_every=0)
    after = tr.state.digest()
    restored = _restore_counted(tr, (0,), calls)
    tr.run(1, log_every=0)
    out["format"] = dict(saved=saved, save_calls=save_calls, restored=restored,
                         replayed=tr.state.digest() == after, n_leaves=len(full),
                         full=full if rank == 0 else None)

    # a checkpoint of one process (model 1) resumes on the axis
    tr = trainer(mesh, tree, ckpt=CkptConfig(dir=paths["m1"]))
    out["from_m1"] = dict(step=int(tr.state.step), digest=tr.state.digest(),
                          shards={k: np.array(v.detach() if isinstance(v, torch.Tensor) else v)
                                  for k, v, *_ in tr.state.leaf_splits()})

    # worker 0 dies: the DeathWatch, a forced re-plan, a coded restore
    # from the survivor, the replay
    calls.clear()
    grouped.clear()
    tr = trainer(mesh, tree, env=env(death=True), adapt=AdaptConfig(**ADAPT),
                 ckpt=CkptConfig(dir=paths["death"], every=2, coded=CodedSpec(**SPEC)))
    tr.run(DEATH_STEPS, log_every=0)
    out["death"] = dict(
        recoveries=[(e.step, e.dead_workers, e.ckpt_step, e.swap.round_idx,
                     e.swap.x_old.tolist(), e.swap.x_new.tolist(), e.swap.predicted_gain)
                    for e in tr.recoveries],
        history=[(h["step"], h.get("recovery"), h["loss"]) for h in tr.history],
        plan=json.dumps(tr.plan.to_dict(), sort_keys=True), calls=sorted(calls),
        grouped=len(grouped), digest=tr.state.digest(), params=gathered_params(tr))

    # the wave loop: staleness 0 against the barrier loop, then staleness 1
    bar = trainer(mesh, tree)
    bar.run(3, log_every=0)
    w0 = trainer(mesh, tree, wave=WaveConfig(staleness=0, **WAVE))
    w0.run(3, log_every=0)
    grouped.clear()
    w1 = trainer(mesh, tree, wave=WaveConfig(staleness=1, **WAVE))
    w1.run(WAVE_ROUNDS, log_every=0)
    [trace], [executed] = w1.wave.traces, w1.wave.executed
    out["wave"] = dict(
        barrier=(bar.state.digest(), [h["loss"] for h in bar.history]),
        stale0=(w0.state.digest(), [h["loss"] for h in w0.history]),
        strategies=(w0.wave._strategy(w0.plan), w1.wave._strategy(w1.plan)),
        executed_is_trace=executed == list(trace.events), grouped=len(grouped),
        trace=json.dumps(trace.to_dict(), sort_keys=True), digest=w1.state.digest(),
        history=[(h["step"], h["staleness"], h["loss"]) for h in w1.history],
        params=gathered_params(w1))

    # scheme="auto": the reference's search at its TPU constants; step-0
    # coded gradients of the shards, gathered (fp32 pinned: the tuner's
    # bf16 would round them); one step
    launch_mesh.HW.HBM_BW, launch_mesh.HW.ICI_BW = paths["hw"]
    collectives.reset_counts()
    tr = trainer(mesh, tree, scheme="auto", budget=MemBudget(paths["cap"]), grad_dtype="fp32")
    tuned_counts = dict(collectives.counts)
    local = tr.state.params
    wb = coded_worker_batches(tr.data, 0, N, tr.plan.s_max)
    grads = {}
    for u in sorted({0, tr.plan.s_max}):
        times = np.ones(N)
        times[:u] = 1e6
        dec_w = tr.plan.decode_weights(times).astype(np.float32)
        g = gather_model(local, tr.step_fn.grad_fn(local, wb, dec_w))
        grads[u] = [t.detach().numpy().copy() for t in g.leaves()]
    grouped.clear()
    tr.run(1, log_every=0)
    out["auto"] = dict(report=tr.tune_report.to_dict(), plan=tr.plan.to_dict(),
                       knobs=(tr.pipeline, tr.reduce_mode, tr.grad_dtype),
                       tuned_counts=tuned_counts, grouped=len(grouped),
                       grads=grads if rank == 0 else None,
                       loss=tr.history[0]["loss"])

    # spmd without a model axis (data 4): rank 0 alone decodes
    mesh4 = make_local_mesh(4, device="cpu")
    tr = trainer(mesh4, tree, env=Env.iid(ShiftedExponential(**SE), 4),
                 ckpt=CkptConfig(dir=paths["data4"], every=2, coded=CodedSpec(4, 2)))
    tr.run(2, log_every=0)
    saved = tr.state.digest()
    tr.run(1, log_every=0)
    out["data4"] = dict(saved=saved, restored=_restore_counted(tr, (0, 2), calls))
    return out
