"""The spmd ranks of ``tests/test_torch_fsdp.py``: a training state cut
over ``data`` by the ``fsdp`` rule (``embed`` over ``data``) on top of the
``model`` axis, on a (data 2, model 2) mesh over gloo on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
shapes and counts; rank 0 also returns the gathered trees.

``step_counts`` is the collectives one coded step must make, written
from the config, the plan and the pipeline alone."""
import dataclasses

import numpy as np
import torch

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import DegradedWorker, Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import collectives
from repro_torch.dist.mesh import meta_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, data_dims, gather_model, init_shards, local_shapes
from repro_torch.train.coded import local_layout, scatter_dims
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_coded_train_step
from repro_torch.train.wave import WaveConfig

import torch_tp_mla_ranks as M

#: gemma2-27b (dense: every leaf cut) and mixtral-8x22b (experts split on
#: ``expert_mlp``, the published ``shard_experts=False``)
ARCHS = ("gemma2-27b", "mixtral-8x22b")
N = 2
MESH = dict(data=N, model=2)
SE = dict(mu=1e-3, t0=50.0)
CFG_T = dict(warmup=1, total_steps=10)
SEQ, BATCH = 32, 8
VARIANTS = [(p, r) for p in ("flat", "tree") for r in ("psum", "psum_scatter")]
STEPS = 2
#: worker 0 runs 1000x slower from round 6 (``torch_tp_state_ranks``'):
#: the DeathWatch (factor 20, 4 rounds) trips after step 10, the forced
#: re-plan swaps the plan, and the restore decodes worker 0's stripe of
#: the newest checkpoint from the parity
DEATH = dict(worker=0, factor=1000.0, from_round=6)
DEATH_STEPS = 11
ADAPT = dict(window=64, min_rounds=48)
WAVE = dict(staleness=1, update_cost=3e7, broadcast_latency=1e6)
WAVE_ROUNDS = 3


def cfg(arch: str, fsdp: bool = True):
    """``arch`` reduced to 2 layers at d_model 128, ``fsdp`` set: reduced
    configs clear it."""
    return dataclasses.replace(get_config(arch).reduced(d_model=128), fsdp=fsdp)


def env(death: bool = False):
    e = Env.iid(ShiftedExponential(**SE), N)
    return e.with_faults(DegradedWorker(**DEATH)) if death else e


def plan_of(c) -> Plan:
    return Plan.build(GCLM(c, device="meta"), ShiftedExponential(**SE), N, scheme="xf")


def data_of(c) -> SyntheticTokens:
    return SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=SEQ, global_batch=BATCH, seed=0))


def dec_ws(plan) -> list:
    """The decode weights with u = 0 .. s_max of the N workers straggling."""
    out = []
    for u in range(plan.s_max + 1):
        times = np.ones(N)
        times[:u] = 1e6
        out.append(plan.decode_weights(times).astype(np.float32))
    return out


def step_counts(c, pipeline: str, reduce_mode: str) -> dict:
    """One coded spmd step's collectives on a rank of the fsdp mesh: the
    model axis's (``torch_tp_mla_ranks.pass_counts`` for K passes and the
    monitoring forward, and the clip's one reduce); over the data group
    one all-gather of each cut leaf's working shape, the clip's psum of
    two fp32 squares, and the combine's: per level a psum (or a
    reduce-scatter and an all-gather) of the rank's level buffers (flat),
    per leaf a psum or a reduce-scatter (tree), followed by an
    all-gather only for a scattered leaf that is not cut.  Bytes: one
    rank's buffers (an all-gather's output)."""
    mesh = meta_mesh(**MESH)
    plan = plan_of(c)
    k = plan.k_shards
    p = M.pass_counts(c, MESH["model"])
    shapes = local_shapes(c, mesh)
    size = [4 * int(np.prod(s)) for s in shapes]
    cut = [d is not None for d in data_dims(c, mesh)]
    out = dict(copy=k * p["copy"], reduce=(k + 1) * p["reduce"] + 1, max=(k + 1) * p["max"],
               broadcast=0, psum=1, psum_scatter=0, all_gather=sum(cut),
               psum_bytes=8, psum_scatter_bytes=0,
               all_gather_bytes=sum(b for b, x in zip(size, cut) if x))
    out["all_gather"] += (k + 1) * p["all_gather"]
    if pipeline == "flat":
        levels = [4 * n for n in local_layout(c, plan, mesh).level_sizes]
        kind = "psum" if reduce_mode == "psum" else "psum_scatter"
        out[kind] += len(levels)
        out[f"{kind}_bytes"] += sum(levels)
        if reduce_mode == "psum_scatter":
            out["all_gather"] += len(levels)
            out["all_gather_bytes"] += sum(levels)
        return out
    scatter = scatter_dims(shapes, N, GCLM(c, device="meta").leaf_axes()) \
        if reduce_mode == "psum_scatter" else [None] * len(shapes)
    for b, dim, x in zip(size, scatter, cut):
        kind = "psum" if dim is None else "psum_scatter"
        out[kind] += 1
        out[f"{kind}_bytes"] += b
        if dim is not None and not x:
            out["all_gather"] += 1
            out["all_gather_bytes"] += b
    return out


def _counts() -> dict:
    return dict(collectives.counts, **collectives.model_counts,
                **{f"{k}_bytes": collectives.nbytes[k] for k in ("psum", "psum_scatter",
                                                                 "all_gather")})


def _host(tensors) -> list:
    return [t.detach().float().numpy().copy() for t in tensors]


def _full_state(state, rank, names=("params", "m", "v")) -> dict:
    """Rank 0's gathered parameters and moments (every rank gathers)."""
    trees = {"params": None, "m": state.opt["m"], "v": state.opt["v"]}
    out = {name: _host(gather_model(state.params, trees[name]).leaves()) for name in names}
    return out if rank == 0 else None


def _steps(c, mesh, tree, pipeline, reduce_mode, dec_w, rank) -> dict:
    """``STEPS`` coded spmd steps (``make_coded_train_step``) from ``tree``
    at one straggler count: the first step's first moment — its clipped
    gradient over 10 (the warmup's first step leaves the parameters) —
    and the last step's parameters and moments, gathered (rank 0); the
    last step's collectives counted."""
    plan, data = plan_of(c), data_of(c)
    state = init_train_state(c, device="cpu", params=tree, mesh=mesh)
    step = make_coded_train_step(c, TrainConfig(**CFG_T), plan, mode="spmd", mesh=mesh,
                                 pipeline=pipeline, reduce_mode=reduce_mode)
    out = {"losses": []}
    for i in range(STEPS):
        collectives.reset_counts()
        state, metrics = step(state, coded_worker_batches(data, i, N, plan.s_max), dec_w)
        out["counts"] = _counts()
        out["losses"].append(float(metrics["loss"]))
        if i == 0:
            out["m1"] = _full_state(state, rank, ("m",))
    out["final"] = _full_state(state, rank)
    out["shapes"] = [tuple(t.shape) for t in state.params.leaves()]
    out["moment_shapes"] = [tuple(t.shape) for t in state.opt["m"]]
    return out


def _trainer(c, mesh, tree, **kw):
    return Trainer(c, TrainConfig(**CFG_T), kw.pop("env", env()), n_workers=N, scheme="xf",
                   global_batch=BATCH, seed=0, device="cpu", params=tree, mesh=mesh,
                   mode="spmd", seq_len=SEQ, **kw)


def _loop(c, mesh, tree, rank, **kw) -> dict:
    """A trainer's run: with ``death``, ``DEATH_STEPS`` steps with coded
    checkpoints every 2 steps and an adaptive controller, through one
    worker death (a forced re-plan and swap, a restore from the
    survivors); with ``wave``, ``WAVE_ROUNDS`` rounds at staleness 1."""
    death = kw.pop("death", False)
    steps = DEATH_STEPS if death else WAVE_ROUNDS
    if death:
        kw.update(env=env(death=True), adapt=AdaptConfig(**ADAPT),
                  ckpt=CkptConfig(dir=kw.pop("ckpt_dir"), every=2,
                                  coded=CodedSpec(n_shards=N, parity=1)))
    else:
        kw.update(wave=WaveConfig(**WAVE))
    tr = _trainer(c, mesh, tree, **kw)
    tr.run(steps, log_every=0)
    out = dict(history=[(h["step"], h.get("recovery"), h["loss"]) for h in tr.history],
               state=_full_state(tr.state, rank), plan_x=[int(v) for v in tr.plan.x],
               recoveries=[(ev.step, ev.dead_workers, ev.ckpt_step,
                            None if ev.swap is None else [int(v) for v in ev.swap.x_old],
                            None if ev.swap is None else [int(v) for v in ev.swap.x_new])
                           for ev in tr.recoveries])
    return out


def fsdp_rank(rank, world, blob):
    """Everything one rank runs: per arch, the cut's round trip
    (``init_shards`` then ``gather_model``) and ``STEPS`` coded steps of
    every pipeline and reduce mode at every straggler count, fsdp on and
    off; for gemma2-27b, a checkpoint saved with fsdp on, a one-process
    checkpoint restored with fsdp on, one death recovery with its forced
    swap and the wave loop, fsdp on and off."""
    torch.set_num_threads(1)
    mesh = make_local_mesh(**MESH, device="cpu")
    out = {"coords": (mesh.data_index, mesh.model_index)}
    for arch in ARCHS:
        c, tree = cfg(arch), blob[arch]["tree"]
        local = init_shards(c, mesh, device="cpu", params=tree, over_data=True)
        full = _host(gather_model(local).leaves())
        got = {"cut_shapes": [tuple(t.shape) for t in local.leaves()],
               "data_dims": local.fsdp.dims, "gathered": full if rank == 0 else None}
        del local, full
        dec = dec_ws(plan_of(c))
        for pipeline, reduce_mode in VARIANTS:
            for u, dec_w in enumerate(dec):
                for fsdp in (True, False):
                    got[pipeline, reduce_mode, u, fsdp] = _steps(
                        cfg(arch, fsdp), mesh, tree, pipeline, reduce_mode, dec_w, rank)
        out[arch] = got

    c, tree = cfg(ARCHS[0]), blob[ARCHS[0]]["tree"]
    # a checkpoint of a state cut over data, one step on, restored into
    # itself; and the same with fsdp off (its 2-D leaves split on their
    # last dimension are saved transposed)
    for fsdp in (True, False):
        tr = _trainer(cfg(ARCHS[0], fsdp), mesh, tree,
                      ckpt=CkptConfig(dir=blob["ckpt"]["fsdp" if fsdp else "off"]))
        tr.run(1, log_every=0)
        tr.save_checkpoint()
        if fsdp:
            full = {k: np.array(v) for k, v in tr.state.full_leaves()}
            out["saved"] = full if rank == 0 else None
        before = tr.state.digest()
        tr.restore_checkpoint()
        out["self_restore", fsdp] = tr.state.digest() == before
        del tr
    # a one-process checkpoint (model 1, fsdp off) resumed on the fsdp mesh
    tr = _trainer(c, mesh, tree, ckpt=CkptConfig(dir=blob["ckpt"]["m1"]))
    out["resumed"] = dict(step=int(tr.state.step), shards={
        key: torch.as_tensor(leaf).detach().numpy().copy()
        for key, leaf, *_ in tr.state.leaf_splits()})
    del tr
    for fsdp in (True, False):
        cc = cfg(ARCHS[0], fsdp)
        out["death", fsdp] = _loop(cc, mesh, tree, rank, death=True,
                                   ckpt_dir=blob["ckpt"][f"death{int(fsdp)}"])
        out["wave", fsdp] = _loop(cc, mesh, tree, rank)
    return out
