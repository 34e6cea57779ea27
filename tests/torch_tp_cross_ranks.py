"""The ranks of ``tests/test_torch_tp_cross.py``: reduced whisper-base (also
with an odd vocabulary, which the axis leaves whole) and
llama-3.2-vision-11b on the ``model`` axis of a (data 2, model 2) mesh,
over gloo on the CPU, each with its stubbed modality embeddings
(``aux_inputs``, ``worker_aux``).

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  Every rank returns its
digests and counts; rank 0 also returns the model group's gradients and
parameters gathered into full leaves."""
import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import coded_worker_batches
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM, init_shards
from repro_torch.serve import generate
from repro_torch.train.coded import make_coded_grad_fn
from repro_torch.train.trainer import TrainConfig, Trainer

from torch_tp_mla_ranks import CFG_T, MESH, N, SE, SEQ, _counts, _full
from torch_tp_ranks import _count_grouped_calls, digest
from torch_tp_xlstm_ranks import pass_counts

#: the job's configs: name -> (arch, reduced layers, fields replaced).
#: Whisper at 2 + 2 layers with the reduced vocabulary of 512 (split at
#: model 2) and of 511 (whole: the full width's 51,865 is odd too); vision
#: at 5 layers, the cross-attention mixer at index 3
CASES = {"whisper": ("whisper-base", 2, {}), "whisper511": ("whisper-base", 2, {"vocab": 511}),
         "vision": ("llama-3.2-vision-11b", 5, {})}
#: spmd trainer steps with ``worker_aux``
TRAIN_STEPS = 2
#: generate(aux_inputs=): prompts and new tokens
GENERATE = dict(batch=2, prompt_len=8, max_new=6)


def cfg(name: str):
    arch, n_layers, fields = CASES[name]
    return get_config(arch).reduced(n_layers=n_layers, d_model=128, seq_cap=64).replace(**fields)


def aux_rows(c, n: int, seed) -> np.ndarray:
    """``n`` rows of stubbed modality embeddings, standard normal fp32 from
    ``seed``: frames (n, n_frames, d_model) or patches (n, n_patches,
    d_vision)."""
    shape = ((c.encoder.n_frames, c.d_model) if c.encoder is not None
             else (c.vision.n_patches, c.vision.d_vision))
    return np.random.default_rng(seed).standard_normal((n, *shape), dtype=np.float32)


def worker_aux(c, step: int, n_workers: int, k: int, rows: int) -> np.ndarray:
    """The step's ``worker_aux`` (N, K, rows, ...) by the cyclic map of
    ``coded_worker_batches``: worker n, slot k holds shard (n + k) mod N,
    whose rows are drawn from the seed (step, shard)."""
    shards = [aux_rows(c, rows, (step, i)) for i in range(n_workers)]
    return np.stack([np.stack([shards[(n + j) % n_workers] for j in range(k)])
                     for n in range(n_workers)])


def serve_counts(c, model: int, max_new: int) -> dict:
    """``generate(aux_inputs=)``'s collectives on a rank: each of its
    ``max_new`` forwards (the prefill, then a decode step per later token)
    makes the forward reduces of a training pass — every layer's, each
    encoder layer's, the embedding's where the vocabulary splits — and,
    where it splits, one all-gather of the logits; no backward, so no
    copy, and no loss."""
    p = pass_counts(c, model)
    vocab = int(c.vocab % model == 0)
    return dict(reduce=max_new * (p["reduce"] - 2 * vocab), all_gather=max_new * vocab,
                copy=0, max=0)


def make_trainer(c, blob, mesh=None):
    """The spmd (``mesh``) or one-process trainer on the reference's
    weights ``blob["tree"]`` (gates open)."""
    kw = {} if mesh is None else dict(mesh=mesh, mode="spmd")
    return Trainer(c, TrainConfig(**CFG_T), Env.iid(ShiftedExponential(**SE), N), scheme="xf",
                   global_batch=8, seed=0, device="cpu", params=blob["tree"], seq_len=SEQ, **kw)


def train_steps(tr, blob, each=None) -> list:
    """``TRAIN_STEPS`` coded steps of ``tr.step_fn`` with ``blob["wa"]``'s
    worker_aux and the trainer's straggler draws; ``each(i)`` after each.
    Returns the metrics."""
    hist = []
    for i in range(TRAIN_STEPS):
        dec_w, _ = tr.sim.step()
        wb = coded_worker_batches(tr.data, i, N, tr.plan.s_max)
        tr.state, metrics = tr.step_fn(tr.state, wb, dec_w, blob["wa"][i])
        hist.append({k: float(v) for k, v in metrics.items()})
        if each is not None:
            each(i)
    return hist


def cross_job(c, rank, blob) -> dict:
    """Everything one rank runs on (data 2, model 2) for ``c``, from the
    reference's weights ``blob["tree"]``: the shards gathered back (rank
    0); the loss, metrics, collectives and gathered gradients of one
    ``train_loss`` on ``blob["batch"]`` with its ``aux_inputs``; the flat
    spmd coded gradient with ``worker_aux`` at every straggler count
    (fp32) and at none (bf16), with its grouped calls and digest;
    ``TRAIN_STEPS`` spmd trainer steps with ``worker_aux`` (metrics,
    digests, grouped calls and collectives per step, gathered
    parameters); ``generate(aux_inputs=)``'s tokens and collectives."""
    torch.set_num_threads(1)
    grouped = _count_grouped_calls()
    mesh = make_local_mesh(**MESH, device="cpu")
    local = init_shards(c, mesh, device="cpu", params=blob["tree"])
    out = dict(coords=(mesh.pod_index, mesh.data_index, mesh.model_index),
               axes=sorted(local.tp.axes), shard_dims=local.shard_dims,
               shapes=[tuple(t.shape) for t in local.leaves()],
               gathered=_full(local, local.leaves(), rank))

    collectives.reset_counts()
    loss, metrics = train_loss(c, local, {"tokens": blob["batch"],
                                          "aux_inputs": blob["batch_aux"]})
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
            g = [t.detach().clone() for t in fn(local, blob["wb"], dec_w, blob["wa"][0])]
            out["coded"][name, u] = dict(grouped=list(grouped), digest=digest(g),
                                         full=_full(local, g, rank))

    g = GENERATE
    collectives.reset_counts()
    tokens = generate(c, local, blob["prompts"], g["max_new"], aux_inputs=blob["gen_aux"],
                      device="cpu")
    out["generate"] = dict(tokens=tokens.numpy(), counts=_counts())
    del local

    tr = make_trainer(c, blob, mesh)
    got = dict(digests=[], grouped=[], counts=[])

    def each(i):
        got["counts"].append(_counts())
        got["digests"].append(tr.state.digest())
        got["grouped"].append(len(grouped))
        grouped.clear()
        collectives.reset_counts()

    grouped.clear()
    collectives.reset_counts()
    got["history"] = train_steps(tr, blob, each)
    got.update(params=_full(tr.state.params, tr.state.params.leaves(), rank),
               n_levels=tr.plan.flat_layout.n_levels, k_shards=tr.plan.k_shards)
    out["trainer"] = got
    return out


def train_rank(rank, world, path):
    """``cross_job`` of every case of ``CASES`` on the inputs saved at
    ``path`` (``blob[name]``)."""
    blob = torch.load(path, weights_only=False)
    return {name: cross_job(cfg(name), rank, blob[name]) for name in CASES}
