"""The launch planner of ``csrc/gc_pipe.cuh``'s grouped kernel, in plain
Python (no CUDA needed, so the CPU tests reach it).

One launch streams up to ``MAX_LEAVES`` leaves ``G_j`` (K, D_j) of one
dtype.  The planner fixes the tile shape — ``tile_cols`` columns of all K
rows per tile, ``stages`` tiles in the shared-memory ring — from K, the
dtype, the weight table and the card's shared memory of one block, cuts
the leaf list into launches, gives each leaf of a launch its first
global tile (prefix sums of ceil(D_j / tile_cols)), and gives each leaf
its mode: the TMA ring, or 16-byte loads from global memory when K is
too wide for a ring of two stages (both need 16-byte rows and pointers),
or per-column loads.  Every K is served; only a weight table larger than
the shared memory of one block is refused.  ``descriptors`` packs a
launch's leaves in the layout of gc_pipe.cuh's ``Leaf`` struct; the C
side checks them again before it launches.
"""
from __future__ import annotations

import struct
from typing import NamedTuple, Sequence

__all__ = ["MAX_LEAVES", "MAX_STAGES", "RING_BYTES", "PER_COLUMN", "RING", "DIRECT", "LEAF",
           "Launch", "tile_shape", "leaf_mode", "plan_launches", "descriptors"]

#: leaves in one launch (the kernel parameter's fixed array)
MAX_LEAVES = 32
#: consumer threads of a CTA; each takes one 16-byte column group per row
CONSUMERS = 256
#: shared memory for the ring of one CTA: two CTAs share an SM's 228 KB,
#: so each SM runs two producers and its last tiles split finer
RING_BYTES = 96 * 1024
MAX_STAGES = 8
#: the stages' mbarriers ahead of the weight table in shared memory
BARRIER_BYTES = 2 * MAX_STAGES * 8
#: leaf modes (gc_pipe.cuh's ``Mode``): rows not of whole 16-byte groups,
#: the TMA ring, 16-byte loads from global memory (no ring)
PER_COLUMN, RING, DIRECT = 0, 1, 2
#: gc_pipe.cuh's ``Leaf``: g, out, d, tile0, widx, mode
LEAF = struct.Struct("<QQqqii")


class Launch(NamedTuple):
    leaves: tuple   # leaf indices into the caller's list, in order
    tile0: tuple    # first global tile of each leaf
    n_tiles: int    # tiles of the launch


def tile_shape(k: int, itemsize: int, n_weights: int, smem_bytes: int) -> tuple:
    """(tile_cols, stages) for K rows of ``itemsize``-byte elements, with
    ``n_weights`` floats of weight table in a block of ``smem_bytes``
    shared memory (the card's opt-in maximum): one 16-byte group per
    consumer thread and row when two such stages fit the ring beside the
    table, else narrower tiles down to one warp's width; when not even
    those fit, no ring (stages = 0) and full-width tiles.  Raises
    ``ValueError`` only when the weight table alone does not fit."""
    head = -(-(BARRIER_BYTES + 4 * n_weights) // 128) * 128
    if head > smem_bytes:
        raise ValueError(f"{n_weights} weights exceed the {smem_bytes} bytes of shared "
                         "memory of one block")
    budget = min(RING_BYTES, smem_bytes - head)
    vec = 16 // itemsize
    cols = CONSUMERS * vec
    while True:
        stages = min(MAX_STAGES, budget // (k * cols * itemsize))
        if stages >= 2:
            return cols, stages
        if cols == 32 * vec:
            return CONSUMERS * vec, 0
        cols //= 2


def leaf_mode(d: int, itemsize: int, g_ptr: int, out_ptr: int, stages: int) -> int:
    """The leaf's mode: ``RING`` (or ``DIRECT`` when the launch has no
    ring) for rows of whole 16-byte groups at 16-byte aligned pointers,
    else ``PER_COLUMN``."""
    if (d * itemsize) % 16 or g_ptr % 16 or out_ptr % 16:
        return PER_COLUMN
    return RING if stages else DIRECT


def plan_launches(widths: Sequence[int], tile_cols: int) -> list:
    """Cut the leaves into launches of at most ``MAX_LEAVES`` in order;
    a launch with no tile (only empty leaves) is dropped."""
    launches = []
    for first in range(0, len(widths), MAX_LEAVES):
        ids = tuple(range(first, min(first + MAX_LEAVES, len(widths))))
        tile0, n = [], 0
        for j in ids:
            tile0.append(n)
            n += -(-int(widths[j]) // tile_cols)
        if n:
            launches.append(Launch(ids, tuple(tile0), n))
    return launches


def descriptors(launch: Launch, g_ptrs, out_ptrs, widths, which, modes) -> bytes:
    """The launch's leaves packed as gc_pipe.cuh's ``Leaf`` array."""
    return b"".join(LEAF.pack(g_ptrs[j], out_ptrs[j], int(widths[j]), t0, int(which[j]),
                              int(modes[j]))
                    for j, t0 in zip(launch.leaves, launch.tile0))
