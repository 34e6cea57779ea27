"""TrainState: the model (its parameters), the AdamW state and the step,
after ``repro/train/state.py``.

A checkpoint of either package is a checkpoint of the other: the port's
state presents itself to ``repro_torch.checkpoint`` as the reference's
``TrainState`` pytree (``checkpoint_tree``), whose flattened keys are
``params/<path>``, ``opt/count``, ``opt/m/<path>``, ``opt/v/<path>`` and
``step`` — list indices written ``[i]``, ``count`` and ``step`` int32
0-d arrays — 35 leaves for gc-lm-110m.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..checkpoint.ckpt import tree_items
from ..models.params import GCLM, _lookup, init_shards, params_from_numpy
from ..optim.optim import adamw_init

__all__ = ["TrainState", "StateTree", "init_train_state", "abstract_train_state",
           "opt_from_numpy"]


class StateTree(NamedTuple):
    """The reference ``TrainState``'s pytree; its fields flatten in this
    order (a NamedTuple's), not sorted."""
    params: dict
    opt: dict
    step: np.ndarray


@dataclass
class TrainState:
    params: GCLM      # parameters, leaves in the reference's order
    opt: dict         # {"m": [...], "v": [...], "count": int}, leaf order
    step: int

    def checkpoint_tree(self) -> StateTree:
        """The reference's pytree over this state's tensors (by reference,
        not copied): moments keyed by parameter path, ``count`` and
        ``step`` as int32 0-d arrays."""
        model = self.params
        return StateTree(
            params=model.tree(),
            opt={"count": np.asarray(self.opt["count"], np.int32),
                 "m": model.tree(self.opt["m"]), "v": model.tree(self.opt["v"])},
            step=np.asarray(self.step, np.int32))

    def digest(self) -> bytes:
        """sha256 over every leaf of ``checkpoint_tree`` (key and bytes):
        two states with one digest are byte-equal."""
        h = hashlib.sha256()
        for key, leaf in tree_items(self.checkpoint_tree()):
            h.update(key.encode())
            t = torch.as_tensor(leaf).detach().contiguous().reshape(-1)
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())
        return h.digest()

    def from_checkpoint_tree(self, tree: StateTree) -> "TrainState":
        """This state after a restore filled its tensors in place from
        ``tree``; ``count`` and ``step`` come from ``tree``."""
        return TrainState(params=self.params,
                          opt=dict(self.opt, count=int(tree.opt["count"])),
                          step=int(tree.step))


def init_train_state(cfg, *, device="cuda", seed: int = 0, params=None,
                     mesh=None) -> TrainState:
    """Fresh state: parameters from ``seed`` on ``device``, or copied from
    ``params`` (a reference parameter tree of numpy arrays) when given.
    On a ``mesh`` with a ``model`` axis, this rank's shards of those
    parameters (``init_shards``: the full tree never lies on ``device``)
    and moments of the shards' shapes."""
    if mesh is not None:
        model = init_shards(cfg, mesh, device=device, seed=seed, params=params)
    else:
        model = GCLM(cfg, device=device, seed=seed)
        if params is not None:
            params_from_numpy(model, params)
    return TrainState(params=model, opt=adamw_init(model.leaves()), step=0)


def abstract_train_state(cfg) -> TrainState:
    """The state of ``cfg`` on the meta device: every tensor's shape and
    dtype, no storage (the reference builds it with ``jax.eval_shape``).
    The autotuner prices candidates and binds plans to it."""
    return init_train_state(cfg, device="meta")


def opt_from_numpy(model: GCLM, opt) -> dict:
    """The port's AdamW state from a reference optimizer tree
    (``{"m": tree, "v": tree, "count": ...}`` of arrays): the moments in
    ``model``'s leaf order, on its device."""
    def moments(tree):
        return [torch.tensor(np.array(_lookup(tree, path), np.float32), device=t.device)
                for path, t in model.leaf_items()]

    return {"m": moments(opt["m"]), "v": moments(opt["v"]),
            "count": int(np.asarray(opt["count"]))}
