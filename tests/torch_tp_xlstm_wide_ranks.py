"""The ranks of ``tests/test_torch_tp_xlstm_wide.py``: reduced xlstm-1.3b with
2 heads on a (data 1, model 4) mesh over gloo on the CPU — a model axis
wider than the heads, which splits ``d_inner`` and leaves the heads whole,
as the reference's rule splits xlstm-1.3b's 4 heads at model 8 and 16.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.  The collective formula
is ``torch_tp_xlstm_ranks.pass_counts``'."""
import torch

from repro_torch.configs import get_config
from repro_torch.dist import collectives
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import init_shards

from torch_tp_mla_ranks import _counts, _full
from torch_tp_serve_ranks import _engine

MESH = dict(data=1, model=4)
D_MODEL = 128
N_HEADS = 2


def cfg(dtype: str = "float32"):
    """xlstm-1.3b reduced to 8 layers (a run of 7 mLSTM layers and the
    sLSTM) at d_model 128 with 2 heads: at model 4 each head's channels
    lie on 2 ranks, the mLSTM's 128 and the sLSTM's 64 per head.
    ``dtype`` sets the activations' (the leaves stay fp32)."""
    return get_config("xlstm-1.3b").reduced(n_layers=8, d_model=D_MODEL).replace(
        n_heads=N_HEADS, n_kv_heads=N_HEADS, dtype=dtype)


def wide_rank(rank, world, path):
    """One rank on the reference's weights ``blob["tree"]``: the shards
    gathered back (rank 0), the loss, metrics, collectives and gathered
    gradients of one ``train_loss`` on ``blob["batch"]`` — and the
    gathered gradients again with float64 activations — then the engine
    on the mesh over ``blob["engine"]`` (fp32 slab, greedy)."""
    torch.set_num_threads(1)
    blob = torch.load(path, weights_only=False)
    c = cfg()
    mesh = make_local_mesh(**MESH, device="cpu")
    local = init_shards(c, mesh, device="cpu", params=blob["tree"])
    out = dict(axes=sorted(local.tp.axes), shard_dims=local.shard_dims,
               shapes=[tuple(t.shape) for t in local.leaves()],
               gathered=_full(local, local.leaves(), rank))
    collectives.reset_counts()
    loss, metrics = train_loss(c, local, {"tokens": blob["batch"]})
    grads = torch.autograd.grad(loss, local.leaves())
    out.update(metrics={k: float(v.detach()) for k, v in metrics.items()}, counts=_counts(),
               grads=_full(local, grads, rank))
    c64 = cfg("float64")
    loss, _ = train_loss(c64, local, {"tokens": blob["batch"]})
    out["grads64"] = _full(local, torch.autograd.grad(loss, local.leaves()), rank)
    out["engine"] = _engine(c, local, mesh, blob["engine"], torch.float32)
    return out
