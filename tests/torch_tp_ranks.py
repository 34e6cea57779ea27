"""The spmd ranks of ``tests/test_torch_tp.py``: the port on a mesh with a
``model`` axis, over gloo on the CPU.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
digests and counts; rank 0 also returns the model group's gradients and
parameters all-gathered into full leaves (``gather_model``)."""
import hashlib

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.dist import collectives
from repro_torch.dist.collectives import copy_to_model, max_over_model, reduce_from_model
from repro_torch.dist.sharding import ModelSplit
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.layers import embed_tokens, unembed
from repro_torch.models.model import _xent
from repro_torch.models.params import GCLM, gather_model, params_from_numpy, shard_model
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step

SE = dict(mu=1e-3, t0=50.0)


def digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        t = t.detach().contiguous().reshape(-1)
        h.update(str(t.dtype).encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _count_grouped_calls() -> list:
    """Count this process's grouped combine calls (one ``gc_fused`` launch
    each on CUDA)."""
    calls, grouped = [], ops.encode_decode_leaves

    def counted(*args, **kwargs):
        calls.append(len(args[3]))
        return grouped(*args, **kwargs)

    ops.encode_decode_leaves = counted
    return calls


def _model(blob, mesh):
    """The full model from the reference's weights, its plan, and this
    rank's shards."""
    cfg = get_config(blob["arch"]).reduced(**blob["reduced"])
    full = params_from_numpy(GCLM(cfg, device="cpu"), blob["tree"])
    plan = Plan.build(full, ShiftedExponential(**SE), mesh.data, scheme="xf")
    return cfg, plan, shard_model(full, mesh)


def _split(local) -> list:
    return [d is not None for d in local.shard_dims]


def coded_grads_rank(rank, world, path):
    """Every variant's spmd coded gradient for every set of decode weights
    in the inputs saved at ``path`` (the arch, its ``reduced()`` keywords,
    the reference's weights, the mesh, the tokens, the decode weights, the
    variants' keywords, the uncoded shards); per call this rank's digest,
    its replicated leaves' digest, the grouped calls and collectives; then
    the uncoded gradient of the shards and one uncoded step
    (``make_train_step``) on ``batch``."""
    blob = torch.load(path, weights_only=False)
    calls = _count_grouped_calls()
    mesh = make_local_mesh(**blob["mesh"], device="cpu")
    cfg, plan, local = _model(blob, mesh)
    split = _split(local)
    out = {"coords": (mesh.pod_index, mesh.data_index, mesh.model_index),
           "shard_dims": local.shard_dims, "grads": {}, "digests": {}, "replicated": {},
           "counts": {}}
    for name, kw in blob["variants"].items():
        fn = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh, **kw)
        for u, dec_w in enumerate(blob["dec_w"]):
            collectives.reset_counts()
            calls.clear()
            g = [t.detach().clone() for t in fn(local, blob["wb"], dec_w)]
            out["counts"][name, u] = (list(calls), dict(collectives.counts))
            out["digests"][name, u] = digest(g)
            out["replicated"][name, u] = digest([t for t, s in zip(g, split) if not s])
            full = gather_model(local, [t.float() for t in g]).leaves()
            if rank == 0:
                out["grads"][name, u] = [t.detach().numpy() for t in full]
    unc = uncoded_grad_fn(cfg, mesh.data)(local, blob["shards"])
    full = gather_model(local, unc).leaves()
    if rank == 0:
        out["uncoded"] = [t.detach().numpy() for t in full]
    state = init_train_state(cfg, device="cpu", params=blob["tree"], mesh=mesh)
    state, metrics = make_train_step(cfg, TrainConfig(warmup=0, total_steps=10), mesh=mesh)(
        state, {"tokens": blob["batch"]})
    full = gather_model(state.params).leaves()
    out["step"] = dict(metrics={k: float(v) for k, v in metrics.items()},
                       params=[t.detach().numpy() for t in full] if rank == 0 else None)
    return out


def trainer_rank(rank, world, path):
    """Per arch in the inputs saved at ``path``: the flat spmd gradients
    (``coded_grads_rank``'s), then three steps of ``Trainer(mode="spmd")``
    on the reference's weights — the history, this rank's digest and its
    replicated leaves' digest after every step, and (rank 0) the
    parameters all-gathered."""
    blobs = torch.load(path, weights_only=False)
    out = {}
    for arch, blob in blobs.items():
        mesh = make_local_mesh(**blob["mesh"], device="cpu")
        cfg, plan, local = _model(blob, mesh)
        fn = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
        grads = []
        for dec_w in blob["dec_w"]:
            full = gather_model(local, fn(local, blob["wb"], dec_w)).leaves()
            grads.append([t.detach().numpy() for t in full])
        tr = Trainer(cfg, TrainConfig(warmup=1, total_steps=10), Env.iid(
            ShiftedExponential(**SE), mesh.data), scheme="xf", global_batch=8, seed=0,
            device="cpu", params=blob["tree"], seq_len=32, mesh=mesh, mode="spmd")
        split = _split(tr.state.params)
        digests, replicated = [], []
        for _ in range(3):
            tr.run(1, log_every=0)
            leaves = tr.state.params.leaves()
            digests.append(digest(leaves))
            replicated.append(digest([t for t, s in zip(leaves, split) if not s]))
        params = gather_model(tr.state.params).leaves()
        out[arch] = dict(
            coords=(mesh.pod_index, mesh.data_index, mesh.model_index),
            shard_dims=tr.state.params.shard_dims, digests=digests, replicated=replicated,
            history=[{k: v for k, v in h.items() if k != "wall_s"} for h in tr.history],
            grads=grads if rank == 0 else None,
            params=[t.detach().numpy().copy() for t in params] if rank == 0 else None)
    return out


def collectives_rank(rank, world, seed):
    """Megatron's f and g, the max and the vocab-parallel embedding, head
    and loss on a model group of ``world`` ranks, against the same
    products in one process: returns this rank's results and gradients
    (and its model counts and bytes)."""
    mesh = make_local_mesh(1, model=world, device="cpu")
    group = mesh.model_group
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(3, 5, 8, generator=gen)
    a, b = torch.randn(8, 6 * world, generator=gen), torch.randn(6 * world, 7, generator=gen)
    cols = slice(6 * rank, 6 * (rank + 1))
    collectives.reset_counts()
    xl, al, bl = (t.clone().requires_grad_() for t in (x, a[:, cols], b[cols]))
    y = reduce_from_model((copy_to_model(xl, group) @ al) @ bl, group)
    up = torch.randn(y.shape, generator=gen)
    gx, ga, gb = torch.autograd.grad((y * up).sum(), (xl, al, bl))
    top = max_over_model(x[..., rank], group)
    counts = (dict(collectives.model_counts), dict(collectives.nbytes))

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    vocab, d = cfg.vocab, cfg.d_model
    tok = torch.randn(vocab, d, generator=gen)
    tokens = torch.randint(0, vocab, (2, 9), generator=gen)
    labels = torch.randint(0, vocab, (2, 9), generator=gen)
    h = torch.randn(2, 9, d, generator=gen)
    n = vocab // world
    tl, hl = tok[rank * n:(rank + 1) * n].clone().requires_grad_(), h.clone().requires_grad_()
    tp = ModelSplit(mesh, frozenset({"vocab"}))
    emb = embed_tokens(cfg, tl, tokens, tp)
    logits = unembed(cfg, {"tok": tl}, hl, tp)
    loss = _xent(logits, labels, None, rank * n, tp)
    g_tok, g_h = torch.autograd.grad(loss + (emb * h).sum(), (tl, hl))
    return dict(y=y.detach(), gx=gx, ga=ga, gb=gb, top=top, counts=counts, emb=emb.detach(),
                loss=loss.detach(), g_tok=g_tok, g_h=g_h,
                inputs=(x, a, b, up, tok, tokens, labels, h))
