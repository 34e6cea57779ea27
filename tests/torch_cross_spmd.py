"""The spmd rank of ``tests/test_torch_{whisper,vision}.py``: the coded
gradients of a model with a cross-attention source on one gloo rank.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module."""
import torch

from repro_torch.configs import get_config
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.train.coded import make_coded_grad_fn


def coded_grads_rank(rank, world, path):
    """This rank's spmd coded gradients (numpy, leaf order) for each set of
    decode weights, from the inputs saved at ``path``: the arch and its
    ``reduced()`` keywords, the weights' numpy tree, the straggler env's
    keywords, the (N, K, rows, S+1) tokens, the ``worker_aux`` and the
    list of decode weights."""
    blob = torch.load(path, weights_only=False)
    cfg = get_config(blob["arch"]).reduced(**blob["reduced"])
    model = params_from_numpy(GCLM(cfg, device="cpu"), blob["tree"])
    plan = Plan.build(model, ShiftedExponential(**blob["env"]), world, scheme="xf")
    grad_fn = make_coded_grad_fn(cfg, plan, mode="spmd",
                                 mesh=make_local_mesh(data=world, device="cpu"))
    return [[g.clone().numpy() for g in grad_fn(model, blob["wb"], dec_w, blob["wa"])]
            for dec_w in blob["dec_w"]]
