"""Data pipeline: deterministic synthetic token streams + the paper's
cyclic coded shard allocation (sample-allocation phase, §III).

Copied from ``repro/data/pipeline.py`` (numpy only; the batches are
bit-identical to the reference's).  Synthetic batches are a stateless
function of (seed, step), so every worker can materialize any shard
locally — the property the cyclic redundant allocation needs.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

__all__ = ["DataConfig", "SyntheticTokens", "coded_worker_batches"]


@dataclass(frozen=True)
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    kind: str = "zipf"  # 'uniform' | 'zipf'


class SyntheticTokens:
    """Stateless random-access synthetic LM stream: ``batch(step)`` ->
    (B, S+1) int32, and shard i of step t is identical no matter which
    worker asks."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        if cfg.kind == "zipf":
            ranks = np.arange(1, cfg.vocab + 1, dtype=np.float64)
            p = 1.0 / ranks**1.1
            self._probs = p / p.sum()
        else:
            self._probs = None

    def _rng(self, step: int, shard: Optional[int] = None) -> np.random.Generator:
        seq = np.random.SeedSequence([self.cfg.seed, step if step >= 0 else 2**31,
                                      0 if shard is None else shard + 1])
        return np.random.default_rng(seq)

    def batch(self, step: int) -> np.ndarray:
        b, s = self.cfg.global_batch, self.cfg.seq_len
        return self._draw(self._rng(step), (b, s + 1))

    def shard(self, step: int, shard_idx: int, n_shards: int) -> np.ndarray:
        """Shard ``shard_idx`` of step's global batch (B/n_shards rows)."""
        b = self.cfg.global_batch
        if b % n_shards:
            raise ValueError(f"global batch {b} not divisible into {n_shards} shards")
        rows = b // n_shards
        return self._draw(self._rng(step, shard_idx), (rows, self.cfg.seq_len + 1))

    def _draw(self, rng, shape) -> np.ndarray:
        if self._probs is not None:
            flat = rng.choice(self.cfg.vocab, size=int(np.prod(shape)), p=self._probs)
            toks = flat.reshape(shape)
            # light structure: token t+1 correlates with token t (learnable)
            mix = rng.random(shape) < 0.35
            rolled = np.roll(toks, 1, axis=-1)
            toks = np.where(mix, (rolled * 7 + 11) % self.cfg.vocab, toks)
            return toks.astype(np.int32)
        return rng.integers(0, self.cfg.vocab, size=shape, dtype=np.int32)


def coded_worker_batches(
    data: SyntheticTokens, step: int, n_workers: int, s_max: int
) -> np.ndarray:
    """Sample-allocation phase: (N, s_max+1, B/N, S+1) overlapping shards;
    worker n, slot k holds shard (n + k) mod N of the step's global batch."""
    shards = [data.shard(step, i, n_workers) for i in range(n_workers)]
    return np.stack(
        [np.stack([shards[(n + k) % n_workers] for k in range(s_max + 1)])
         for n in range(n_workers)]
    )  # (N, K, rows, S+1)
