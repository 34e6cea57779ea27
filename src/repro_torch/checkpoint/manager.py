"""Checkpoint cadence, retention and kind dispatch for the live loop,
after ``repro/checkpoint/manager.py``.

``CkptConfig`` is the knob surface the trainer and the launcher see:
where to write, how often (``every``), how many step dirs to keep, and
which format — monolithic npz (``coded=None``) or erasure-coded stripes
under a ``CodedSpec``.  ``CheckpointManager.maybe_save`` fires on step
boundaries, ``restore_latest`` resumes from the newest intact checkpoint
of either kind, and ``restore_from_survivors`` is the worker-death entry
point: dead workers' shard ids become ``missing`` and the coded decode
rebuilds the exact state from the ``N - s`` survivors.  ``save`` also
takes a leaf stream and ``load`` hands back the full leaves, so a
sharded state (a rank's shards on a ``model`` axis) saves and restores
the reference's full tree one leaf at a time.
"""
from __future__ import annotations

import os
import shutil
from dataclasses import dataclass
from typing import Any, Optional, Sequence

from .ckpt import intact_steps, load_checkpoint, restore_train_state, save_checkpoint
from .coded import (CodedSpec, load_coded_checkpoint, restore_coded_train_state,
                    save_coded_checkpoint)

__all__ = ["CkptConfig", "CheckpointManager"]


@dataclass(frozen=True)
class CkptConfig:
    """Checkpointing policy for ``Trainer(..., ckpt=CkptConfig(...))``.

    ``every=0`` disables periodic saves; ``coded=None`` writes monolithic
    npz checkpoints, a ``CodedSpec`` erasure-coded stripes (worker ``i``
    owns shard ``i``, so ``n_shards`` should match the worker count for
    death recovery).  ``keep`` bounds retention (0 = keep everything);
    ``resume=True`` restores from the newest intact checkpoint on startup.
    """

    dir: str
    every: int = 0
    coded: Optional[CodedSpec] = None
    keep: int = 3
    resume: bool = True

    def __post_init__(self):
        if not self.dir:
            raise ValueError("CkptConfig.dir must be a path")
        if self.every < 0 or self.keep < 0:
            raise ValueError("CkptConfig.every/keep must be >= 0")


class CheckpointManager:
    """Stateful driver of one ``CkptConfig`` (one checkpoint dir)."""

    def __init__(self, cfg: CkptConfig):
        self.cfg = cfg
        #: step of the last successful save this process made
        self.last_saved: Optional[int] = None

    def save(self, step: int, tree: Any, extra: Optional[dict] = None, *,
             device=None) -> str:
        """Unconditional save (kind per ``cfg.coded``), then retention.
        ``tree`` is a state or a leaf stream (``(key, leaf)`` pairs in
        flattening order, consumed once); a coded save's parity encode
        runs on ``device`` (default: the state's; CUDA for a stream)."""
        if self.cfg.coded is not None:
            path = save_coded_checkpoint(self.cfg.dir, step, tree, self.cfg.coded,
                                         extra=extra, device=device)
        else:
            path = save_checkpoint(self.cfg.dir, step, tree, extra=extra)
        self.last_saved = int(step)
        self._retain()
        return path

    def due(self, step: int) -> bool:
        """Whether ``maybe_save`` saves at ``step``: a multiple of ``every``
        and not a re-save of the same step after a rewind."""
        return self.cfg.every > 0 and step % self.cfg.every == 0 \
            and self.last_saved != int(step)

    def maybe_save(self, step: int, tree: Any,
                   extra: Optional[dict] = None) -> Optional[str]:
        """Save when ``due(step)``."""
        return self.save(step, tree, extra=extra) if self.due(step) else None

    def _retain(self) -> None:
        if self.cfg.keep <= 0:
            return
        for s, _kind in intact_steps(self.cfg.dir)[self.cfg.keep:]:
            shutil.rmtree(os.path.join(self.cfg.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    def latest(self) -> Optional[tuple[int, str]]:
        """Newest intact ``(step, kind)`` on disk, or None."""
        steps = intact_steps(self.cfg.dir)
        return steps[0] if steps else None

    def load(self, step: Optional[int] = None, *, missing: Sequence[int] = (),
             device="cuda") -> tuple[dict, int]:
        """(key -> host array, step) of the newest (or given) intact
        checkpoint, in flattening order: the leaf source of a restore that
        fills its state itself, one leaf at a time (a sharded state cuts
        each full leaf to its shard).  A coded checkpoint decodes from
        whatever shards survive (``missing`` marks known-dead workers'
        shards), the survivors' encode on ``device``; a monolithic one
        ignores both."""
        step, kind = self._find(step)
        if kind == "coded":
            arrays, _ = load_coded_checkpoint(self.cfg.dir, step, missing=missing,
                                              device=device)
        else:
            arrays, _ = load_checkpoint(self.cfg.dir, step)
        return arrays, int(step)

    def _find(self, step: Optional[int]) -> tuple[int, str]:
        """(step, kind) of the newest intact checkpoint, or of ``step``."""
        if step is None:
            found = self.latest()
            if found is None:
                raise FileNotFoundError(f"no loadable checkpoints under {self.cfg.dir}")
            step, kind = found
        else:
            kinds = dict(intact_steps(self.cfg.dir))
            if step not in kinds:
                raise FileNotFoundError(f"no intact checkpoint for step {step} "
                                        f"under {self.cfg.dir}")
            kind = kinds[step]
        return step, kind

    def restore(self, template: Any, step: Optional[int] = None, *,
                missing: Sequence[int] = ()) -> tuple[Any, int]:
        """Restore into ``template``; returns (state, step).  A coded
        checkpoint decodes from whatever shards survive (``missing`` marks
        known-dead workers' shards); a monolithic one ignores ``missing``."""
        step, kind = self._find(step)
        if kind == "coded":
            state = restore_coded_train_state(template, self.cfg.dir, step,
                                              missing=missing)
        else:
            state = restore_train_state(template, self.cfg.dir, step)
        return state, int(step)

    def restore_latest(self, template: Any) -> Optional[tuple[Any, int]]:
        """(state, step) from the newest intact checkpoint, or None."""
        if self.latest() is None:
            return None
        return self.restore(template)

    def restore_from_survivors(self, template: Any, missing: Sequence[int],
                               step: Optional[int] = None) -> tuple[Any, int]:
        """The worker-death path: decode the newest (or given) checkpoint
        treating ``missing`` shard ids as lost."""
        return self.restore(template, step, missing=missing)
