"""Admission scheduler + KV-slab slot allocator for continuous batching,
copied from ``repro/serve/scheduler.py``.

Policy (deliberately boring, and pinned by tests):

* a request becomes *eligible* once its simulated ``arrival`` time has
  passed;
* eligible requests are admitted in (priority, submission-order) order —
  strict priority classes, FIFO within a class — for as long as free
  slab slots remain;
* a released slot returns to the free pool and is handed to the next
  admission (slot indices never exceed ``n_slots``, and the lowest free
  index is always reused first, which keeps slab occupancy contiguous
  under steady load).

Starvation: within a finite request stream every request is eventually
admitted (slots recycle as requests finish), which the tests pin.  With
strict priorities an *infinite* stream of high-priority work can of
course park low-priority requests forever — that is the contract of a
priority class, not a scheduler bug; use one priority level for pure
FIFO.
"""
from __future__ import annotations

import heapq
import itertools
from typing import List, Optional, Tuple

from .request import QUEUED, Request

__all__ = ["Scheduler"]


class Scheduler:
    """Priority/FIFO admission queue over ``n_slots`` KV-slab rows."""

    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("need at least one slab slot")
        self.n_slots = int(n_slots)
        self._free: List[int] = list(range(self.n_slots))  # min-heap
        heapq.heapify(self._free)
        self._queue: List[Tuple[int, int, Request]] = []   # (priority, seq, req)
        self._seq = itertools.count()

    # ------------------------------------------------------------- queueing
    def enqueue(self, req: Request) -> None:
        if req.state != QUEUED:
            raise ValueError(f"request {req.uid} is {req.state}, not queued")
        heapq.heappush(self._queue, (req.priority, next(self._seq), req))

    def __len__(self) -> int:
        return len(self._queue)

    @property
    def free_slots(self) -> int:
        return len(self._free)

    def next_arrival(self, now: float) -> Optional[float]:
        """Earliest arrival time among queued requests not yet eligible
        at ``now`` (None if some request is already eligible or the
        queue is empty)."""
        future = None
        for _, _, req in self._queue:
            if req.arrival <= now:
                return None
            future = req.arrival if future is None else min(future, req.arrival)
        return future

    # ------------------------------------------------------------ admission
    def admit(self, now: float) -> List[Tuple[Request, int]]:
        """Pop eligible requests into free slots: (priority, FIFO) order.

        Requests whose arrival is still in the future stay queued (they
        are skipped over without losing their queue position).
        """
        admitted: List[Tuple[Request, int]] = []
        deferred: List[Tuple[int, int, Request]] = []
        while self._queue and self._free:
            prio, seq, req = heapq.heappop(self._queue)
            if req.arrival > now:
                deferred.append((prio, seq, req))
                continue
            slot = heapq.heappop(self._free)
            admitted.append((req, slot))
        for item in deferred:
            heapq.heappush(self._queue, item)
        return admitted

    def release(self, slot: int) -> None:
        if not (0 <= slot < self.n_slots):
            raise ValueError(f"slot {slot} out of range [0,{self.n_slots})")
        if slot in self._free:
            raise ValueError(f"slot {slot} already free")
        heapq.heappush(self._free, slot)
