"""TrainState: the model (its parameters), the AdamW state and the step,
after ``repro/train/state.py``.

A checkpoint of either package is a checkpoint of the other: the port's
state presents itself to ``repro_torch.checkpoint`` as the reference's
``TrainState`` pytree (``checkpoint_tree``), whose flattened keys are
``params/<path>``, ``opt/count``, ``opt/m/<path>``, ``opt/v/<path>`` and
``step`` — list indices written ``[i]``, ``count`` and ``step`` int32
0-d arrays — 35 leaves for gc-lm-110m.

A state on a ``model`` axis holds a rank's shards, and where the config
sets ``fsdp`` each shard's data slice too (``init_shards(...,
over_data=True)``); it still saves and restores that full tree, one leaf
at a time (``full_leaves``, ``fill_from_full``), never holding the whole
of it on the device.  The data ranks of a state cut over ``data`` hold
different slices, so they compare ``replicated_digest`` — not
``digest`` — to prove that they agree.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..checkpoint.ckpt import tree_items
from ..models.params import (GCLM, _lookup, data_shard_of, gather_data_leaf, gather_leaf,
                             init_shards, params_from_numpy, shard_of)
from ..optim.optim import adamw_init

__all__ = ["TrainState", "StateTree", "init_train_state", "abstract_train_state",
           "opt_from_numpy", "cut_leaf"]


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
        return self._digest(tree_items(self.checkpoint_tree()))

    def replicated_digest(self) -> bytes:
        """``digest`` over what the data ranks of a model index hold alike:
        every leaf no ``data`` cut touches, ``count`` and ``step`` — all of
        ``checkpoint_tree`` (``digest`` itself) unless the state is cut
        over ``data``."""
        if self.params.fsdp is None:
            return self.digest()
        return self._digest((key, leaf) for key, leaf, *_, ddim in self._leaf_cuts()
                            if ddim is None)

    @staticmethod
    def _digest(items) -> bytes:
        h = hashlib.sha256()
        for key, leaf in items:
            h.update(key.encode())
            t = torch.as_tensor(leaf).detach().contiguous().reshape(-1)
            h.update(t.view(torch.uint8).cpu().numpy().tobytes())
        return h.digest()

    def leaf_splits(self) -> list:
        """``(key, this rank's leaf, its split dimension or None, the blocks
        that dimension is cut in)`` for every leaf of ``checkpoint_tree``,
        in its order (``models.params.shard_blocks``): a moment splits as
        its parameter; ``count`` and ``step`` are whole."""
        return [cut[:4] for cut in self._leaf_cuts()]

    def _leaf_cuts(self) -> list:
        """``leaf_splits`` with a fifth entry: the leaf's ``data`` cut
        dimension (``models.params.data_dims``) or None."""
        model = self.params
        n = len(model.leaves())

        def per_leaf(values, whole):
            """``values`` (one per parameter) laid out as the state's tree."""
            return tree_items(StateTree(params=model.tree(values),
                                        opt={"count": whole, "m": model.tree(values),
                                             "v": model.tree(values)}, step=whole))

        dims = per_leaf(model.shard_dims or (None,) * n, None)
        blocks = per_leaf(model.shard_blocks or (1,) * n, 1)
        ddims = per_leaf(model.fsdp.dims if model.fsdp is not None else (None,) * n, None)
        return [(key, leaf, dim, b, dd) for (key, leaf), (_, dim), (_, b), (_, dd)
                in zip(tree_items(self.checkpoint_tree()), dims, blocks, ddims, strict=True)]

    def _mesh(self):
        """The mesh the state is cut on, or None."""
        cut = self.params.tp or self.params.fsdp
        return None if cut is None else cut.mesh

    def full_leaves(self, host: bool = True):
        """The reference's full tree, one leaf at a time: ``(key, leaf)``
        in ``checkpoint_tree`` order, each leaf cut over ``data`` gathered
        over the data group (``models.params.gather_data_leaf``), each
        split leaf then over the model group (``gather_leaf``, the
        reference's layout; every rank of a group iterates in step: the
        gathers pair up), each copied to the host when ``host`` — so at
        most one full leaf lies on the device besides the shards, and
        none once the host holds it."""
        group = None if self.params.tp is None else self.params.tp.model_group
        dgroup = None if self.params.fsdp is None else self.params.fsdp.data_group
        for key, leaf, dim, blocks, ddim in self._leaf_cuts():
            if ddim is not None:
                leaf = gather_data_leaf(leaf, ddim, dgroup)
            if dim is not None:
                leaf = gather_leaf(leaf, dim, group, blocks)
            if host and isinstance(leaf, torch.Tensor):
                leaf = leaf.detach().cpu()
            yield key, leaf
            del leaf

    @torch.no_grad()
    def fill_from_full(self, source) -> "TrainState":
        """This state with every tensor filled in place from full leaves
        that arrive one at a time: ``source(key, shape, dtype)`` returns
        the full leaf ``key`` of the reference's tree (its full ``shape``
        and this state's ``dtype``; ``count`` and ``step`` int32 0-d),
        asked for in ``checkpoint_tree`` order; each leaf is cut to this
        rank's shard (``cut_leaf``) and let go before the next is asked for."""
        mesh = self._mesh()
        scalars = {}
        for key, leaf, dim, blocks, ddim in self._leaf_cuts():
            if not isinstance(leaf, torch.Tensor):
                scalars[key] = int(source(key, (), torch.int32))
                continue
            shape = list(leaf.shape)
            if dim is not None:
                shape[dim] *= mesh.model
            if ddim is not None:
                shape[ddim] *= mesh.data
            full = source(key, tuple(shape), leaf.dtype)
            leaf.copy_(cut_leaf(full, mesh, dim, blocks, ddim))
            del full
        return TrainState(params=self.params,
                          opt=dict(self.opt, count=scalars["opt/count"]),
                          step=scalars["step"])

    def from_checkpoint_tree(self, tree: StateTree) -> "TrainState":
        """This state after a restore filled its tensors in place from
        ``tree``; ``count`` and ``step`` come from ``tree``."""
        return TrainState(params=self.params,
                          opt=dict(self.opt, count=int(tree.opt["count"])),
                          step=int(tree.step))


def cut_leaf(full: torch.Tensor, mesh, dim, blocks: int, ddim) -> torch.Tensor:
    """A rank's shard of one full leaf: its ``model`` shard on ``dim`` in
    ``blocks`` blocks (``models.params.shard_of``), then its ``data``
    slice on ``ddim`` (``data_shard_of``) — the cut ``init_shards(...,
    over_data=True)`` makes; ``full`` itself when neither cuts it."""
    if dim is not None:
        full = shard_of(full, dim, mesh, blocks)
    return data_shard_of(full, ddim, mesh)


def init_train_state(cfg, *, device="cuda", seed: int = 0, params=None,
                     mesh=None) -> TrainState:
    """Fresh state: parameters from ``seed`` on ``device``, or copied from
    ``params`` (a reference parameter tree of numpy arrays) when given.
    On a ``mesh`` with a ``model`` axis, or whose ``data`` axis the
    config's ``fsdp`` rule cuts leaves on, this rank's shards of those
    parameters (``init_shards(..., over_data=True)``: the full tree never
    lies on ``device``) and moments of the shards' shapes."""
    if mesh is not None:
        model = init_shards(cfg, mesh, device=device, seed=seed, params=params,
                            over_data=True)
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
