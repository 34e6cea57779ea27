"""The ranks of ``tests/test_torch_tp_moe.py``: reduced mixtral-8x22b with
its experts on the ``model`` axis of a (data 2, model 2) mesh, over gloo
on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
digests and counts; rank 0 also returns the model group's gradients and
parameters all-gathered into full leaves (``gather_model``).  The cases
are the reference's greedy split at model 2: (b) the published
``shard_experts=False`` splits each expert's FFN width, (a)
``shard_experts=True`` the experts themselves."""
import dataclasses

import numpy as np
import torch

from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM, gather_model, init_shards
from repro_torch.train.coded import make_coded_grad_fn
from repro_torch.train.trainer import TrainConfig, Trainer

from torch_tp_ranks import _count_grouped_calls, digest
from torch_tp_serve_ranks import _engine

N = 2
MESH = dict(data=N, model=2)
SE = dict(mu=1e-3, t0=50.0)
#: case -> shard_experts
CASES = {"b": False, "a": True}
#: the reduced config's capacity factor (nothing drops) and the published
#: one (drops)
CAPACITIES = (8.0, 1.25)
CFG_T = dict(warmup=1, total_steps=10)
TRAIN_STEPS = 3


def cfg(case: str, capacity_factor: float):
    """``mixtral-8x22b.reduced()`` (E = 4, expert width 682) with the case's
    ``shard_experts`` and every MoE layer at ``capacity_factor``."""
    base = get_config("mixtral-8x22b").reduced().replace(shard_experts=CASES[case])
    return base.replace(layers=tuple(dataclasses.replace(
        l, moe=dataclasses.replace(l.moe, capacity_factor=capacity_factor))
        for l in base.layers))


def trainer(case: str, mesh, tree, **kw):
    return Trainer(cfg(case, 1.25), TrainConfig(**CFG_T), Env.iid(ShiftedExponential(**SE), N),
                   scheme="xf", global_batch=8, seed=0, device="cpu", params=tree, seq_len=32,
                   mesh=mesh, mode="spmd", **kw)


def _counts() -> dict:
    return dict(collectives.counts, **{f"model_{k}": v
                                       for k, v in collectives.model_counts.items()})


def _full(local, tensors, rank):
    full = gather_model(local, [t.detach().float() for t in tensors]).leaves()
    return [t.detach().numpy().copy() for t in full] if rank == 0 else None


def _gradients(c, local, blob, rank, grouped) -> dict:
    """The uncoded loss and its gradient on the whole batch, then the flat
    spmd coded gradient (fp32 at every straggler count, bf16 at none)."""
    collectives.reset_counts()
    loss, metrics = train_loss(c, local, {"tokens": blob["batch"]})
    grads = torch.autograd.grad(loss, local.leaves())
    out = dict(loss=float(loss), aux=float(metrics["aux"]), xent=float(metrics["xent"]),
               counts=_counts(), axes=sorted(local.tp.axes), shard_dims=local.shard_dims,
               grads=_full(local, grads, rank), coded={})
    plan = Plan.build(GCLM(c, device="meta"), ShiftedExponential(**SE), N, scheme="xf")
    for name, kw in (("fp32", {}), ("bf16", dict(grad_dtype=torch.bfloat16))):
        fn = make_coded_grad_fn(c, plan, mode="spmd", mesh=local.tp.mesh, pipeline="flat", **kw)
        for u, dec_w in enumerate(blob["dec_w"]):
            if name == "bf16" and u:
                continue
            grouped.clear()
            g = [t.detach().clone() for t in fn(local, blob["wb"], dec_w)]
            out["coded"][name, u] = dict(grouped=list(grouped), digest=digest(g),
                                         full=_full(local, g, rank))
    return out


class _IdCensus:
    """Records what ``moe._global_ids`` returns on this rank: each MoE
    call's every-rank expert ids, where this rank's begin, and its own."""

    def __init__(self):
        self.calls, self._orig = [], moe._global_ids

        def recording(flat_e, rows):
            every, first = self._orig(flat_e, rows)
            self.calls.append((every.numpy().copy(), first, flat_e.numel()))
            return every, first

        moe._global_ids = recording

    def close(self) -> list:
        moe._global_ids = self._orig
        return self.calls


def train_rank(rank, world, path):
    """Per case and capacity: the uncoded and coded gradients of the
    shards (``_gradients``); then per case at capacity 1.25, three steps
    of ``Trainer(mode="spmd")`` — the history, this rank's digest after
    every step — and, for case (b), a coded checkpoint saved after step
    2, round-tripped through a restore that loses worker 0's stripe."""
    blob = torch.load(path, weights_only=False)
    grouped = _count_grouped_calls()
    mesh = make_local_mesh(**MESH, device="cpu")
    out = {"coords": (mesh.pod_index, mesh.data_index, mesh.model_index)}
    for case in CASES:
        for cf in CAPACITIES:
            c = cfg(case, cf)
            local = init_shards(c, mesh, device="cpu", params=blob["tree"])
            out[case, cf] = _gradients(c, local, blob, rank, grouped)
    for case in CASES:
        ckpt = CkptConfig(dir=blob["ckpt"], coded=CodedSpec(N, 1)) if case == "b" else None
        tr = trainer(case, mesh, blob["tree"], ckpt=ckpt)
        digests, counts = [], []
        for step in range(TRAIN_STEPS):
            grouped.clear()
            tr.run(1, log_every=0)
            digests.append(tr.state.digest())
            counts.append(len(grouped))
            if ckpt is not None and step == 1:
                tr.save_checkpoint()
                saved = (tr.state.digest(), {k: np.array(v) for k, v in tr.state.full_leaves()})
        got = dict(history=[{k: v for k, v in h.items() if k != "wall_s"} for h in tr.history],
                   digests=digests, grouped=counts, params=_full(tr.state.params,
                                                                 tr.state.params.leaves(), rank))
        if ckpt is not None:
            step = tr.restore_checkpoint(missing=(0,))
            got["ckpt"] = dict(step=step, saved=saved[0], restored=tr.state.digest(),
                               full=saved[1] if rank == 0 else None)
        out["trainer", case] = got
    return out


def serve_rank(rank, world, path):
    """Per case, and for case (b) with ``moe_impl="manual"``, the engine on
    the mesh (fp32 slab, greedy) over the run saved at ``path``:
    ``torch_tp_serve_ranks._engine``'s record of every step, and each MoE
    call's expert ids of every rank (``_IdCensus``)."""
    blob = torch.load(path, weights_only=False)
    mesh = make_local_mesh(**MESH, device="cpu")
    out = {"coords": (mesh.pod_index, mesh.data_index, mesh.model_index)}
    run = blob["engine"]
    for name, case, impl in (("b", "b", "gspmd"), ("a", "a", "gspmd"),
                             ("manual", "b", "manual")):
        c = cfg(case, run["capacity_factor"]).replace(moe_impl=impl)
        local = init_shards(c, mesh, device="cpu", params=blob["tree"])
        census = _IdCensus()
        try:
            got = _engine(c, local, mesh, run, torch.float32)
        finally:
            ids = census.close()
        got["ids"], got["axes"] = ids, sorted(local.tp.axes)
        out[name] = got
    return out
