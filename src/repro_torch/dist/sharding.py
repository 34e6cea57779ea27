"""Logical-axis sharding rules, after ``repro/dist/sharding.py``.

Model leaves name *logical* axes ("embed", "heads", "vocab", ...); the
mapping onto *mesh* axes ("pod", "data", "model") lives in one rules
dict, ``make_rules(cfg)``.  ``pspec_for_axes`` consumes the rules
greedily per dimension, skipping a mesh axis that is absent from the
mesh, already used by an earlier dimension, or that does not divide the
dimension — the reference's rule, so a leaf is split exactly where the
reference's GSPMD splits it.

The reference installs its (mesh, rules) pair as ambient state
(``use_mesh``) and emits sharding constraints from inside the layers;
the port shards explicitly, Megatron-style: ``models.params.shard_model``
slices each leaf on its ``model_dim`` and records the split as a
``ModelSplit``, which is what the layers, the optimizer and the coded
step read; the layers call the model group's collectives
(``dist/collectives.py``).  Every function here
takes its mesh as an argument — anything with a ``shape`` mapping of
mesh axis to size, the port's ``dist.mesh.Mesh`` or a
``jax.sharding.Mesh`` alike.  A spec is a tuple with one entry per
dimension: ``None``, a mesh axis, or a tuple of mesh axes.

The ``fsdp`` rule (``embed`` over ``data``) cuts a training state a
second time: where a config sets ``fsdp`` and the ``data`` axis divides a
leaf's ``embed`` dimension (``data_dim``), a rank keeps only its
``data_index``-th slice of that leaf and of both its AdamW moments, and
all-gathers the leaf over the data group at the start of a step
(``models.params.gather_data``), as GSPMD gathers the reference's
``state_shardings``.  A pod's replicas hold the same data shards.
Serving holds every leaf whole along ``data``, as the reference's
``launch/serve.py`` draws its parameters unplaced.
``shard_experts`` (false for Mixtral) empties the ``experts`` rule, so a
MoE's experts split by their FFN width (``expert_mlp``) instead.

Serving splits its slab's rows by the ``batch`` rule (``batch_rows``):
a row count the ``("pod", "data")`` ranks divide is cut into equal
contiguous blocks, pod-major; one they do not divide stays whole on
every rank, as the reference's GSPMD leaves it replicated.
"""
from __future__ import annotations

from dataclasses import dataclass

__all__ = ["make_rules", "pspec_for_axes", "model_dim", "data_dim", "ModelSplit", "DataSplit",
           "RowSplit", "batch_rows"]


def make_rules(cfg=None) -> dict:
    """Logical axis -> mesh axes, in order of preference: activations
    batch over ("pod", "data"); heads, kv heads, MLP widths, Mamba's inner
    width, experts and the vocabulary over "model"; ``embed`` replicated
    unless ``cfg.fsdp`` (then over "data"); ``vocab`` and ``experts``
    replicated when the config opts out (``shard_vocab``,
    ``shard_experts``)."""
    rules = {
        "batch": ("pod", "data"),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "expert_mlp": ("model",),
        "d_inner": ("model",),
        "experts": ("model",),
        "vocab": ("model",),
        "embed": (),
    }
    if cfg is not None:
        if getattr(cfg, "fsdp", False):
            rules["embed"] = ("data",)
        if not getattr(cfg, "shard_vocab", True):
            rules["vocab"] = ()
        if not getattr(cfg, "shard_experts", True):
            rules["experts"] = ()
    return rules


def pspec_for_axes(axes, shape, mesh, rules: dict) -> tuple:
    """The spec of a leaf with logical ``axes`` and ``shape`` on ``mesh``:
    per dimension, the rule's mesh axes in order, each taken while it is
    in the mesh, unused by an earlier dimension and dividing the
    dimension together with those taken before it."""
    sizes = dict(mesh.shape)
    used: set = set()
    entries = []
    for name, dim in zip(tuple(axes), tuple(shape)):
        picked, size = [], 1
        for mesh_axis in rules.get(name, ()):
            if mesh_axis not in sizes or mesh_axis in used:
                continue
            nxt = size * sizes[mesh_axis]
            if int(dim) % nxt:
                continue
            picked.append(mesh_axis)
            size = nxt
        used.update(picked)
        entries.append(None if not picked else picked[0] if len(picked) == 1
                       else tuple(picked))
    return tuple(entries)


def model_dim(axes, shape, mesh, rules: dict):
    """The one dimension of a leaf that ``mesh``'s ``model`` axis splits,
    or ``None`` (replicated over ``model``, also when the axis has size 1)."""
    if mesh.shape.get("model", 1) == 1:
        return None
    spec = pspec_for_axes(axes, shape, mesh, rules)
    return spec.index("model") if "model" in spec else None


def data_dim(axes, shape, mesh, rules: dict):
    """The one dimension of a leaf that ``mesh``'s ``data`` axis cuts under
    ``rules`` (the ``fsdp`` rule's ``embed``), or ``None`` (whole over
    ``data``, also when the axis has size 1).  The same greedy spec as
    ``model_dim``'s: a dimension that takes ``model`` never takes
    ``data``, and ``data`` is taken only where it divides."""
    if mesh.shape.get("data", 1) == 1:
        return None
    spec = pspec_for_axes(axes, shape, mesh, rules)
    return spec.index("data") if "data" in spec else None


@dataclass(frozen=True)
class ModelSplit:
    """Where a module lies on a mesh's ``model`` axis, as
    ``models.params.shard_model`` cut it: the mesh and the logical axes
    its leaves are split on (``"heads"``, ``"kv_heads"``, ``"mlp"``,
    ``"d_inner"``, ``"vocab"``, and a MoE's ``"experts"`` or
    ``"expert_mlp"``).  The layers ask ``name in split.axes`` which of
    their products to reduce over the model group (an MLP asks its own
    width: ``layers.apply_mlp``)."""

    mesh: object
    axes: frozenset

    @property
    def model_group(self):
        return self.mesh.model_group

    @property
    def model_index(self) -> int:
        return self.mesh.model_index

    def local(self, axis: str, n: int) -> int:
        """This rank's share of ``n`` along a logical ``axis``: ``n /
        model`` where the module is split on it, else ``n``."""
        return n // self.mesh.model if axis in self.axes else n


@dataclass(frozen=True)
class DataSplit:
    """Where a training state lies on a mesh's ``data`` axis, as
    ``models.params.init_shards(..., over_data=True)`` cut it: the mesh
    and each leaf's cut dimension (``data_dim``) or None, in leaf order.
    A cut leaf holds the rank's ``data_index``-th of ``data`` equal
    contiguous slices of its dimension."""

    mesh: object
    dims: tuple

    @property
    def data_group(self):
        return self.mesh.data_group

    @property
    def data_index(self) -> int:
        return self.mesh.data_index


@dataclass(frozen=True)
class RowSplit:
    """A rank's block of batch rows: the mesh axes that split them (major
    first, each of more than one rank; empty when every rank holds every
    row), the global rows ``rows`` this rank holds, and the ``mesh``
    (None off a mesh)."""

    axes: tuple
    rows: range
    mesh: object = None


def batch_rows(n: int, mesh=None) -> RowSplit:
    """This rank's rows of a batch of ``n`` on ``mesh`` by ``make_rules``'
    ``batch`` rule through ``pspec_for_axes``: over ``("pod", "data")``
    where they divide ``n``, else over what divides it, else none."""
    if mesh is None:
        return RowSplit((), range(n))
    entry = pspec_for_axes(("batch",), (n,), mesh, make_rules())[0]
    axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
    axes = tuple(a for a in axes if mesh.shape[a] > 1)
    index, size = 0, 1
    for axis in axes:
        index = index * mesh.shape[axis] + getattr(mesh, f"{axis}_index")
        size *= mesh.shape[axis]
    block = n // size
    return RowSplit(axes, range(index * block, (index + 1) * block), mesh)
