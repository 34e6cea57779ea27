"""The ranks of ``tests/test_torch_tp_mla.py`` (and, through ``axis_job``,
of ``tests/test_torch_tp_mamba.py``): a reduced model on the ``model``
axis of a (data 2, model 2) mesh, over gloo on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
digests and counts; rank 0 also returns the model group's gradients and
parameters gathered into full leaves (``gather_model``).

``pass_counts`` and ``serve_counts`` are the collectives the model axis
must make, written from the config alone: the tests hold every counted
collective to them."""
import dataclasses

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM, gather_model, init_shards
from repro_torch.train.coded import make_coded_grad_fn
from repro_torch.train.trainer import TrainConfig, Trainer

from torch_tp_ranks import _count_grouped_calls, digest
from torch_tp_serve_ranks import _engine

N = 2
MESH = dict(data=N, model=2)
SE = dict(mu=1e-3, t0=50.0)
CFG_T = dict(warmup=1, total_steps=10)
TRAIN_STEPS = 3
SEQ = 32


def cfg():
    """deepseek-v3-671b reduced to d_model 128 at two layers — its first, a
    dense MLA layer, and its fourth, the first MoE layer (4 experts, top-2
    sigmoid, one shared expert: split by expert at model 2, case a) — and
    MTP depth 1, whose layer is MLA with a dense FFN.  At this width the
    dense MLP (329 wide) stays whole at model 2 and the shared expert
    (36) splits: the reference splits each MLP by its own width."""
    base = get_config("deepseek-v3-671b").reduced(n_layers=4, d_model=128)
    return base.replace(n_layers=2, layers=(base.layers[0], base.layers[3]))


#: a mixer's model-group all-reduces per pass on the axis: (forward
#: reduces, backward copies).  Attention: the output projection, the
#: input; MLA: the output projection, the query latent, the KV latent and
#: the shared RoPE key; Mamba: ``x_proj`` and ``out_proj``, the input and
#: ``x_proj``'s reduced output
MIXER = {"attn": (1, 1), "mla": (1, 3), "mamba": (2, 2)}


def _mlp(width: int, model: int) -> tuple:
    """An MLP's (reduce, copy): one of each where its width splits."""
    return (1, 1) if width % model == 0 else (0, 0)


def layer_counts(c, spec, model: int) -> dict:
    """One layer's collectives per pass: forward reduces and all-gathers,
    backward copies.  A MoE FFN split by expert (E divides the axis and
    ``shard_experts``: case a) or by each expert's width (case b) reduces
    its output and copies its gates' and its input's gradients, and in
    case (a) gathers its router's logits; whole (case c) it makes none;
    its shared experts are an MLP of their own width."""
    red, cop = MIXER[spec.mixer]
    gather = 0
    if spec.moe is not None:
        by_expert = c.shard_experts and spec.moe.num_experts % model == 0
        if by_expert or spec.moe.d_ff % model == 0:
            red, cop, gather = red + 1, cop + 2, int(by_expert)
        if spec.moe.num_shared:
            r, k = _mlp(spec.moe.d_ff * spec.moe.num_shared, model)
            red, cop = red + r, cop + k
    elif c.d_ff:
        r, k = _mlp(c.d_ff, model)
        red, cop = red + r, cop + k
    return dict(reduce=red, copy=cop, all_gather=gather)


def pass_counts(c, model: int) -> dict:
    """One forward and backward of ``train_loss`` on the axis: the layers',
    then the vocab-parallel embedding (a reduce), head (a copy) and loss
    (two reduces and a max); each multi-token prediction module adds its
    embedding, its layer (the last spec with a dense FFN), the head and
    the loss."""
    total = dict(reduce=3, copy=1, all_gather=0, max=1)
    specs = list(c.layers) + [dataclasses.replace(c.layers[-1], moe=None)] * c.mtp_depth
    for spec in specs:
        for k, v in layer_counts(c, spec, model).items():
            total[k] += v
    total["reduce"] += 3 * c.mtp_depth
    total["copy"] += c.mtp_depth
    total["max"] += c.mtp_depth
    return total


def step_counts(c, model: int, k: int, n_levels: int) -> dict:
    """One ``Trainer(mode="spmd")`` step on a rank: ``k`` passes forward
    and backward and the monitoring forward, the clip's one reduce of the
    split leaves' squares, one psum per level over the data group and one
    check of the straggler draw."""
    p = pass_counts(c, model)
    return dict(psum=n_levels, psum_scatter=0, broadcast=1, all_gather=(k + 1) * p["all_gather"],
                copy=k * p["copy"], reduce=(k + 1) * p["reduce"] + 1, max=(k + 1) * p["max"])


def serve_counts(c, model: int, step: dict, rows: range, n_slots: int, prompt_len: int,
                 data: int) -> dict:
    """One engine step's collectives on a rank holding the slots ``rows``
    (fp32): per decode of its B rows and per prefill of an admission into
    them, the embedding's and every layer's forward reduces — (B, 1, d),
    or (1, S, d) — except Mamba's ``x_proj`` reduce, of width dt_rank +
    2·d_state, then one all-gather of the logits (B, V) or (1, V); a MoE
    layer split by expert gathers its router's (rows, E) logits, and on
    data-parallel slots a decode gathers every slot's k int64 expert ids
    per MoE layer; the step gathers its int64 tokens over the data ranks
    (n_slots per column)."""
    b, d, v = len(rows), c.d_model, c.vocab
    mine = len([s for s in step["admitted"] if s in rows])
    dec = step["decoded"]
    cols = bool(step["admitted"]) + dec
    wide = narrow = router = ids = 0
    for spec in c.layers:
        got = layer_counts(c, spec, model)
        if spec.mixer == "mamba":
            narrow += 1
            wide += got["reduce"] - 1
        else:
            wide += got["reduce"]
        router += got["all_gather"]
        ids += int(spec.moe is not None and data > 1)
    moe = next((s.moe for s in c.layers if s.moe is not None), None)
    x_proj = 0
    if narrow:
        x_proj = (c.mamba.dt_rank or -(-d // 16)) + 2 * c.mamba.d_state
    tokens = int(data > 1 and cols > 0)
    per_row = 4 * ((wide + 1) * d + narrow * x_proj)
    return dict(
        reduce=(wide + narrow + 1) * (dec + mine), others=0,
        all_gather=dec * (1 + ids + router) + mine * (1 + router) + tokens,
        reduce_bytes=per_row * (dec * b + mine * prompt_len),
        all_gather_bytes=4 * v * (dec * b + mine) + 8 * n_slots * cols * tokens
        + (dec * ids * 8 * n_slots * moe.top_k if ids else 0)
        + (4 * moe.num_experts * router * (dec * b + mine * prompt_len) if router else 0))


def _counts() -> dict:
    return dict(collectives.counts, **collectives.model_counts)


def _full(local, tensors, rank):
    full = gather_model(local, [t.detach().float() for t in tensors]).leaves()
    return [t.detach().numpy().copy() for t in full] if rank == 0 else None


def axis_job(c, rank, blob, ckpt=None) -> dict:
    """Everything one rank of a family's job runs on (data 2, model 2),
    from the reference's weights ``blob["tree"]``: the shards gathered back
    (rank 0); the loss, metrics, collectives and gathered gradients of
    one ``train_loss`` on ``blob["batch"]``; the flat spmd coded gradient
    at every straggler count (fp32) and at none (bf16) with its grouped
    calls and digest; ``TRAIN_STEPS`` steps of ``Trainer(mode="spmd")``
    (history, digests, grouped calls and collectives per step, gathered
    parameters) — with ``ckpt``, a checkpoint saved after step 2 (its
    full leaves on rank 0, every rank's digest) and restored after step
    3 with worker 0's stripe lost; then the engine on the mesh over
    ``blob["engine"]`` (fp32 slab, greedy)."""
    torch.set_num_threads(1)
    grouped = _count_grouped_calls()
    mesh = make_local_mesh(**MESH, device="cpu")
    local = init_shards(c, mesh, device="cpu", params=blob["tree"])
    out = dict(coords=(mesh.pod_index, mesh.data_index, mesh.model_index),
               axes=sorted(local.tp.axes), shard_dims=local.shard_dims,
               shard_blocks=local.shard_blocks, shapes=[tuple(t.shape) for t in local.leaves()],
               gathered=_full(local, local.leaves(), rank))

    collectives.reset_counts()
    loss, metrics = train_loss(c, local, {"tokens": blob["batch"]})
    grads = torch.autograd.grad(loss, local.leaves())
    out.update(metrics={k: float(v.detach()) for k, v in metrics.items()}, counts=_counts(),
               grads=_full(local, grads, rank), coded={})
    plan = Plan.build(GCLM(c, device="meta"), ShiftedExponential(**SE), N, scheme="xf")
    for name, kw in (("fp32", {}), ("bf16", dict(grad_dtype=torch.bfloat16))):
        fn = make_coded_grad_fn(c, plan, mode="spmd", mesh=mesh, pipeline="flat", **kw)
        for u, dec_w in enumerate(blob["dec_w"]):
            if name == "bf16" and u:
                continue
            grouped.clear()
            g = [t.detach().clone() for t in fn(local, blob["wb"], dec_w)]
            out["coded"][name, u] = dict(grouped=list(grouped), digest=digest(g),
                                         full=_full(local, g, rank))
    del local

    tr = Trainer(c, TrainConfig(**CFG_T), Env.iid(ShiftedExponential(**SE), N), scheme="xf",
                 global_batch=8, seed=0, device="cpu", params=blob["tree"], seq_len=SEQ,
                 mesh=mesh, mode="spmd", ckpt=ckpt)
    got = dict(digests=[], grouped=[], counts=[])
    for step in range(TRAIN_STEPS):
        grouped.clear()
        collectives.reset_counts()
        tr.run(1, log_every=0)
        got["counts"].append(_counts())
        got["digests"].append(tr.state.digest())
        got["grouped"].append(len(grouped))
        if ckpt is not None and step == 1:
            tr.save_checkpoint()
            got["saved_digest"] = tr.state.digest()
            saved = {k: np.array(v) for k, v in tr.state.full_leaves()}  # the group's gathers
            got["saved"] = saved if rank == 0 else None
    got.update(history=[{k: v for k, v in h.items() if k != "wall_s"} for h in tr.history],
               params=_full(tr.state.params, tr.state.params.leaves(), rank),
               n_levels=tr.plan.flat_layout.n_levels, k_shards=tr.plan.k_shards)
    if ckpt is not None:  # worker 0's stripe lost: decoded from worker 1's and the parity
        got["restored_step"] = tr.restore_checkpoint(missing=(0,))
        got["restored_digest"] = tr.state.digest()
    out["trainer"] = got
    del tr

    local = init_shards(c, mesh, device="cpu", params=blob["tree"])
    eng = _engine(c, local, mesh, blob["engine"], torch.float32)
    out["engine"] = eng
    return out


def train_rank(rank, world, path):
    """``axis_job`` of ``cfg()`` on the inputs saved at ``path``."""
    return axis_job(cfg(), rank, torch.load(path, weights_only=False))
