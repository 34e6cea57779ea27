"""Flat per-level gradient layout — the memory plan of the fused pipeline.

Copied from ``repro/core/flat.py``; ``pack``/``unpack`` work on torch
tensors.  Leaves are grouped by redundancy level; within a level each
leaf gets a static ``(offset, size)`` slice in flat leaf order (the
reference's ``jax.tree.leaves`` order); every level buffer is padded to
a multiple of ``lcm(lane, N)``.  Serialization stores only the
generating inputs, so ``from_dict(to_dict())`` is bit-identical and a
layout serialized by either package loads in the other.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = ["FlatLayout", "LANE"]

#: last-dim alignment every level buffer pads to (the reference's TPU lane
#: width; kept so layouts are identical across the two packages)
LANE = 128


@dataclass(frozen=True)
class FlatLayout:
    """Static leaf -> (level, offset, size) packing plan.  ``leaf_level[j]``
    indexes the plan's ``used_levels``; the derived fields come from
    ``build`` only."""

    n_workers: int
    lane: int
    leaf_shapes: tuple          # tuple[tuple[int, ...], ...], flat leaf order
    leaf_level: tuple           # tuple[int, ...] level index per leaf
    level_leaves: tuple         # per level: leaf ids in pack order
    level_offsets: tuple        # per level: offset of each packed leaf
    level_used: tuple           # per level: payload element count
    level_sizes: tuple          # per level: padded buffer size

    @classmethod
    def build(cls, leaf_shapes: Sequence, leaf_level: Sequence,
              n_workers: int, *, lane: int = LANE) -> "FlatLayout":
        leaf_shapes = tuple(tuple(int(d) for d in s) for s in leaf_shapes)
        leaf_level = tuple(int(v) for v in leaf_level)
        if len(leaf_shapes) != len(leaf_level):
            raise ValueError(f"{len(leaf_shapes)} leaf shapes vs "
                             f"{len(leaf_level)} leaf levels")
        n_levels = max(leaf_level) + 1 if leaf_level else 0
        missing = set(range(n_levels)) - set(leaf_level)
        if missing:
            raise ValueError(f"leaf_level has empty level(s) {sorted(missing)}; "
                             "level indices must be dense 0..n_levels-1")
        quantum = int(np.lcm(lane, n_workers))
        level_leaves, level_offsets, level_used, level_sizes = [], [], [], []
        for li in range(n_levels):
            ids = tuple(j for j, v in enumerate(leaf_level) if v == li)
            offsets, off = [], 0
            for j in ids:
                offsets.append(off)
                off += int(np.prod(leaf_shapes[j], dtype=np.int64))
            level_leaves.append(ids)
            level_offsets.append(tuple(offsets))
            level_used.append(off)
            level_sizes.append(-(-off // quantum) * quantum)
        return cls(n_workers=int(n_workers), lane=int(lane),
                   leaf_shapes=leaf_shapes, leaf_level=leaf_level,
                   level_leaves=tuple(level_leaves),
                   level_offsets=tuple(level_offsets),
                   level_used=tuple(level_used),
                   level_sizes=tuple(level_sizes))

    @classmethod
    def for_bytes(cls, byte_sizes: Sequence[int], n_shards: int, *,
                  lane: int = LANE) -> "FlatLayout":
        """Single-level byte-stripe layout: every leaf is a flat run of
        ``byte_sizes[j]`` bytes in one level-0 buffer padded to
        ``lcm(lane, n_shards)``, so the buffer splits into ``n_shards``
        equal stripes — the erasure-coded checkpoint's packing plan
        (``repro_torch.checkpoint.coded``)."""
        sizes = [int(n) for n in byte_sizes]
        return cls.build([(n,) for n in sizes], [0] * len(sizes), n_shards,
                         lane=lane)

    # --------------------------------------------------------------- queries
    @property
    def n_levels(self) -> int:
        return len(self.level_sizes)

    @property
    def n_leaves(self) -> int:
        return len(self.leaf_shapes)

    @property
    def total_elems(self) -> int:
        """Payload elements across all level buffers (== model size)."""
        return int(sum(self.level_used))

    @property
    def padded_elems(self) -> int:
        return int(sum(self.level_sizes))

    def leaf_size(self, j: int) -> int:
        return int(np.prod(self.leaf_shapes[j], dtype=np.int64))

    def leaf_slices(self):
        """Yield ``(leaf_id, level, offset, size)`` for every leaf."""
        for li, (ids, offs) in enumerate(zip(self.level_leaves, self.level_offsets)):
            for j, off in zip(ids, offs):
                yield j, li, off, self.leaf_size(j)

    # ------------------------------------------------------------ pack/unpack
    def pack(self, leaves) -> list:
        """Pack flat-order ``leaves`` into one buffer per level; each leaf
        may carry shared leading batch dims, giving ``(*batch, level_size)``
        buffers with a zero tail past the payload."""
        if len(leaves) != self.n_leaves:
            raise ValueError(f"pack: got {len(leaves)} leaves, layout has "
                             f"{self.n_leaves}")
        bufs = []
        for li in range(self.n_levels):
            parts = []
            for j in self.level_leaves[li]:
                leaf = leaves[j]
                nb = leaf.ndim - len(self.leaf_shapes[j])
                if nb < 0 or tuple(leaf.shape[nb:]) != self.leaf_shapes[j]:
                    raise ValueError(f"pack: leaf {j} has shape "
                                     f"{tuple(leaf.shape)}, layout expects "
                                     f"trailing {self.leaf_shapes[j]}")
                parts.append(leaf.reshape(tuple(leaf.shape[:nb]) + (-1,)))
            buf = parts[0] if len(parts) == 1 else torch.cat(parts, -1)
            pad = self.level_sizes[li] - self.level_used[li]
            if pad:
                buf = torch.nn.functional.pad(buf, (0, pad))
            bufs.append(buf)
        return bufs

    def unpack_level(self, li: int, buf) -> dict:
        """``{flat leaf id: (*batch, *shape) tensor}`` of one level buffer."""
        if not 0 <= li < self.n_levels:
            raise ValueError(f"unpack_level: level {li} out of range "
                             f"[0, {self.n_levels})")
        out = {}
        for j, off in zip(self.level_leaves[li], self.level_offsets[li]):
            size = self.leaf_size(j)
            out[j] = buf[..., off:off + size].reshape(
                tuple(buf.shape[:-1]) + self.leaf_shapes[j])
        return out

    def unpack(self, bufs) -> list:
        """Inverse of ``pack`` (padding discarded)."""
        if len(bufs) != self.n_levels:
            raise ValueError(f"unpack: got {len(bufs)} buffers, layout has "
                             f"{self.n_levels} levels")
        leaves = [None] * self.n_leaves
        for li, buf in enumerate(bufs):
            for j, piece in self.unpack_level(li, buf).items():
                leaves[j] = piece
        return leaves

    # --------------------------------------------------------- serialization
    def to_dict(self) -> dict:
        return {
            "version": 1,
            "n_workers": int(self.n_workers),
            "lane": int(self.lane),
            "leaf_shapes": [list(s) for s in self.leaf_shapes],
            "leaf_level": list(self.leaf_level),
        }

    @classmethod
    def from_dict(cls, blob: Optional[dict]) -> Optional["FlatLayout"]:
        if blob is None:
            return None
        return cls.build(blob["leaf_shapes"], blob["leaf_level"],
                         int(blob["n_workers"]), lane=int(blob["lane"]))
