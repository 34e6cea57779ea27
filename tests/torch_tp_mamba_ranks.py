"""The ranks of ``tests/test_torch_tp_mamba.py``: reduced jamba-v0.1-52b on
the ``model`` axis of a (data 2, model 2) mesh, over gloo on the CPU
(``torch_tp_mla_ranks.axis_job``, with a coded checkpoint), and the
blocked cut of Mamba's ``in_proj`` gathered back on deeper configs.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module."""
import torch

from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, gather_model, init_shards

from torch_tp_mla_ranks import MESH, N, axis_job

#: configs whose every leaf is cut and gathered back: one period of 8
#: layers (runs of one) and two (a pattern stacked over 2 repeats, so
#: ``in_proj``'s blocks lie on dimension 2)
ROUND_TRIP_LAYERS = (8, 16)


def cfg():
    """jamba-v0.1-52b reduced to d_model 128 at three layers — its first (a
    Mamba mixer with a dense MLP), second (Mamba with the MoE FFN: 4
    experts top-2, split by expert at model 2) and fifth (global
    attention, 4 heads over 2 KV heads, a dense MLP) — Mamba's d_inner
    256, d_state 8."""
    base = get_config("jamba-v0.1-52b").reduced(n_layers=8, d_model=128)
    return base.replace(n_layers=3, layers=(base.layers[0], base.layers[1], base.layers[4]))


def _round_trips(rank) -> dict:
    """Per config of ``ROUND_TRIP_LAYERS``: whether every leaf of the
    shards (drawn from seed 5) gathered back equals the full model's
    leaf, byte for byte (rank 0), and the leaves' block counts."""
    mesh = make_local_mesh(**MESH, device="cpu")
    out = {}
    for n in ROUND_TRIP_LAYERS:
        c = get_config("jamba-v0.1-52b").reduced(n_layers=n, d_model=128)
        local = init_shards(c, mesh, device="cpu", seed=5)
        gathered = gather_model(local).leaves()
        full = GCLM(c, device="cpu", seed=5).leaves() if rank == 0 else gathered
        out[n] = dict(equal=[torch.equal(a, b) for a, b in zip(gathered, full, strict=True)],
                      blocks=local.shard_blocks, dims=local.shard_dims,
                      paths=local.leaf_paths())
    return out


def train_rank(rank, world, path):
    """``axis_job`` of ``cfg()`` on the inputs saved at ``path``, with a
    coded checkpoint (``CodedSpec(N, 1)``) under ``blob["ckpt"]``; then
    the round trips."""
    blob = torch.load(path, weights_only=False)
    out = axis_job(cfg(), rank, blob, ckpt=CkptConfig(dir=blob["ckpt"], coded=CodedSpec(N, 1)))
    out["round_trips"] = _round_trips(rank)
    return out
