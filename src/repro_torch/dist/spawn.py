"""Run a function on W local processes over ``torch.distributed``: the
port's counterpart of the reference's
``--xla_force_host_platform_device_count`` (fake host devices), for the
CPU tests (gloo) and the one-card rehearsal (gloo on CUDA tensors).

The ranks meet through a ``FileStore`` in a directory the caller gives,
not a TCP port, so concurrent jobs (pytest-xdist workers) never collide.
Each rank runs with one intra-op thread.  The job has a hard time limit:
the process group's timeout bounds every collective, and past the limit
the parent kills every rank and raises.  An exception in any rank fails
the call with that rank's traceback, and the other ranks are killed, so
a dead rank never leaves the others waiting in a collective.
"""
from __future__ import annotations

import datetime
import os
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import check_backend

__all__ = ["spawn"]

#: seconds the other ranks get to exit after one failed, before they are killed
GRACE_S = 5.0


def _result_path(store_dir: str, rank: int) -> str:
    return os.path.join(store_dir, f"result_{rank}.pt")


def _error_path(store_dir: str, rank: int) -> str:
    return os.path.join(store_dir, f"error_{rank}.txt")


def _rank_main(rank, world, fn, args, store_dir, backend, timeout):
    torch.set_num_threads(1)
    store = dist.FileStore(os.path.join(store_dir, "filestore"), world)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    try:
        torch.save(fn(rank, world, *args), _result_path(store_dir, rank))
    except Exception:
        with open(_error_path(store_dir, rank), "w") as f:
            f.write(f"{time.time()!r}\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _failures(store_dir: str, world: int) -> str:
    """The tracebacks of the ranks that raised, the first to fail first
    (the others mostly fail in a collective with the rank that died)."""
    found = []
    for r in range(world):
        if os.path.exists(_error_path(store_dir, r)):
            with open(_error_path(store_dir, r)) as f:
                stamp, _, text = f.read().partition("\n")
            found.append((float(stamp), r, text))
    return "".join(f"\n-- rank {r} raised{' first' if i == 0 else ''}:\n{text}"
                   for i, (_, r, text) in enumerate(sorted(found)))


def spawn(fn, world: int, *args, store_dir: str, backend: str = "gloo",
          timeout: float = 300.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` local processes (start
    method ``spawn``: ``fn`` and ``args`` are pickled, so ``fn`` is a
    module-level function; a child reads them only after its imports,
    so pass large data as a path, or the ranks start one after another)
    with the default process group initialized over ``backend``.  Returns each rank's return value (``torch.save``d
    and loaded on the CPU), in rank order.  Raises ``RuntimeError`` with
    the failing ranks' tracebacks (the first to fail first) when a rank
    raises or dies, or ``TimeoutError`` past ``timeout`` seconds; either
    way no rank outlives the call."""
    check_backend(backend, world)
    os.makedirs(store_dir, exist_ok=True)
    stale = [os.path.join(store_dir, "filestore")]
    for r in range(world):
        stale += [_result_path(store_dir, r), _error_path(store_dir, r)]
    for path in stale:
        if os.path.exists(path):
            os.remove(path)
    ctx = mp.start_processes(_rank_main, args=(world, fn, args, store_dir, backend, timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0),
                           grace_period=GRACE_S):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"spawn: {world} ranks of {getattr(fn, '__name__', fn)} "
                                   f"passed the {timeout:.0f} s limit; every rank was killed")
    except (mp.ProcessRaisedException, mp.ProcessExitedException) as exc:
        raise RuntimeError(f"spawn: a rank of {getattr(fn, '__name__', fn)} failed"
                           f"{_failures(store_dir, world) or f': {exc}'}") from exc
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
            p.join()
    return [torch.load(_result_path(store_dir, r), map_location="cpu", weights_only=False)
            for r in range(world)]
