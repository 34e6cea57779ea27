"""Continuous-batching serving engine with a coded decode tier, after
``repro/serve/engine.py``.

``ServeEngine`` is the subsystem's core: a priority/FIFO admission
queue (``serve.scheduler``) feeding a shared batched KV-cache slab
(``serve.slab``), decoded in lockstep one token per engine step.  Each
admitted request prefills at batch 1, its cache row is written into the
slab at the assigned slot, and every later engine step decodes *all*
slots at once — per-row cache positions let requests sit at different
depths in one batch.  Steps are priced on a simulated clock by an
optional ``CodedDecode`` tier (``serve.coded``): each step goes to R
replica workers drawn from an ``Env`` and completes at the (R-s)-th
delivery.

The reference jits its entry points and counts retraces
(``trace_counts``, ``clear_jit_cache``); the port runs eagerly, has
nothing to count and leaves both out.  The slab is written in place:
a decode step writes each layer's K/V at ``[layer, rows, pos % cap]``
and copies nothing else.  The host reads one ``(B,)`` token tensor per
engine step and one token per admission.

Determinism contract: a request's token stream is a pure function of
(prompt, seed, params) on one device, independent of batch composition
and slot.  Greedy decoding (temperature <= 0) is ``argmax`` (the first
maximum, as in the reference) and matches the reference.  Above it,
token j adds Gumbel noise of shape (V,) from a generator seeded by
``fold_seed(seed, j)`` to ``logits / temperature``: the reference's
``jax.random`` key stream cannot be reproduced in torch (ROADMAP 3.5).

``restore_plan`` reads the coding ``Plan`` a trainer stored in a port
checkpoint's metadata.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..models.model import decode_step, prefill
from .coded import CodedDecode
from .request import DONE, RUNNING, Request
from .scheduler import Scheduler
from .slab import insert_request, make_slab

__all__ = ["ServeConfig", "ServeEngine", "make_serve_step", "generate",
           "restore_plan", "fold_seed"]


def restore_plan(ckpt_dir: str, step: Optional[int] = None):
    """Rebuild the coding ``Plan`` stored in a checkpoint's metadata
    (``Trainer.save`` writes ``extra["plan"]``); None when there is none."""
    from ..checkpoint.ckpt import load_checkpoint
    from ..core.plan import Plan

    _, meta = load_checkpoint(ckpt_dir, step)
    blob = meta.get("extra", {}).get("plan")
    return Plan.from_dict(blob) if blob else None


def make_serve_step(cfg):
    """(params, caches, token) -> (next_token_logits, caches): one decode
    step, caches updated in place."""

    def serve_step(params, caches, token, aux_inputs=None):
        if aux_inputs is not None:
            raise NotImplementedError("aux_inputs (vision/encoder configs) are not "
                                      "ported yet (ROADMAP 1.9)")
        logits, caches = decode_step(cfg, params, caches, token)
        return logits[:, -1], caches

    return serve_step


def fold_seed(seed: int, j: int) -> int:
    """A 63-bit generator seed that depends on ``(seed, j)`` only."""
    lo, hi = np.random.SeedSequence((int(seed), int(j))).generate_state(2, np.uint32)
    return int(lo) | (int(hi) & 0x7FFFFFFF) << 32


def _row_seed(seed: int, row: int) -> int:
    """Per-row seed of a batched ``generate``: row 0 keeps the caller's
    seed (B = 1 stays the single-stream output), later rows fold in a
    high offset that no token index reaches."""
    return int(seed) if row == 0 else fold_seed(seed, 2 ** 30 + row)


def _sample_row(logits, seed: int, j: int, temperature: float):
    """Token ``j`` of a request from its (V,) logits, on their device:
    ``argmax`` at temperature <= 0, else ``argmax(logits / t + g)`` with
    Gumbel noise g drawn from ``fold_seed(seed, j)``."""
    if temperature <= 0.0:
        return logits.argmax(-1)
    gen = torch.Generator(device=logits.device).manual_seed(fold_seed(seed, j))
    u = torch.rand(logits.shape[-1], generator=gen, device=logits.device)
    gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))
    return (logits.float() / temperature + gumbel).argmax(-1)


# ------------------------------------------------------------------ engine
@dataclass(frozen=True)
class ServeConfig:
    """Engine geometry: slab capacity and cache dtype.

    ``n_slots`` bounds concurrent requests (the slab batch); ``max_len``
    is the per-slot cache capacity — a request needs
    ``len(prompt) + max_new <= max_len``.
    """

    n_slots: int = 4
    max_len: int = 256
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if self.n_slots < 1:
            raise ValueError("need at least one slab slot")
        if self.max_len < 2:
            raise ValueError("max_len must be >= 2")


class ServeEngine:
    """Continuous-batching serving loop over a shared KV slab.

    ``submit`` queues requests (priority/FIFO admission, simulated
    arrival times); ``step`` runs one engine iteration — admit into free
    slots (per-request prefill + slab insert + first token), then one
    lockstep decode over every slot; ``run`` drains the engine.  Evicted
    slots are recycled at once.

    The clock is *simulated*: each decode step costs one draw from the
    ``coded`` tier (step latency (s+1)/R * work * T_(R-s:R) on the env's
    straggler model) or 1.0 time unit when ``coded`` is None.  Prefill is
    not charged, so ``step_latencies`` is exactly the coded tier's stream.

    ``params`` is a ``GCLM``; the engine runs on its device, which must
    be of the kind ``device`` names (default the card).
    """

    def __init__(self, cfg, params, serve: Optional[ServeConfig] = None, *,
                 coded: Optional[CodedDecode] = None, device="cuda"):
        dev = resolve_device(device)
        self.device = params.embed.tok.device
        if self.device.type != dev.type:
            raise ValueError(f"params are on {self.device}, engine device is {dev}")
        self.cfg = cfg
        self.params = params
        self.serve = serve or ServeConfig()
        self.coded = coded
        self.scheduler = Scheduler(self.serve.n_slots)
        self.slab = make_slab(cfg, self.serve.n_slots, self.serve.max_len,
                              dtype=self.serve.dtype, device=self.device)
        self.now = 0.0
        self.finished: List[Request] = []
        self.step_latencies: List[float] = []
        self._running = {}                      # slot -> Request
        b = self.serve.n_slots
        self._tok = torch.zeros(b, dtype=torch.long, device=self.device)  # last token
        self._steps = np.ones(b, np.int64)      # next token index per slot
        self._temps = np.zeros(b, np.float32)
        self._seeds = [0] * b

    # ------------------------------------------------------------ interface
    def submit(self, prompt, max_new: int = 32, *, temperature: float = 0.0,
               seed: int = 0, priority: int = 0,
               arrival: Optional[float] = None) -> Request:
        """Queue one generation request; returns the live ``Request``
        (its ``tokens``/timestamps fill in as the engine runs)."""
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size + max_new > self.serve.max_len:
            raise ValueError(
                f"prompt({prompt.size}) + max_new({max_new}) exceeds slab "
                f"capacity {self.serve.max_len}")
        req = Request(prompt=prompt, max_new=max_new, temperature=temperature,
                      seed=int(seed), priority=priority,
                      arrival=self.now if arrival is None else float(arrival))
        self.scheduler.enqueue(req)
        return req

    @property
    def n_running(self) -> int:
        return len(self._running)

    def step(self) -> bool:
        """One engine iteration; False once every request is finished."""
        if not self._running and not len(self.scheduler):
            return False
        admitted = self.scheduler.admit(self.now)
        if not admitted and not self._running:
            # nothing live and nothing eligible: jump to the next arrival
            self.now = max(self.now, self.scheduler.next_arrival(self.now))
            admitted = self.scheduler.admit(self.now)
        for req, slot in admitted:
            self._admit(req, slot)
        if not self._running:        # every admission completed at token 0
            return len(self.scheduler) > 0
        self._decode_step()
        return True

    def run(self) -> List[Request]:
        """Drain the engine; returns every finished request (in
        completion order)."""
        while self.step():
            pass
        return self.finished

    # ------------------------------------------------------------ internals
    def _admit(self, req: Request, slot: int) -> None:
        tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
        logits, caches = prefill(self.cfg, self.params, tokens,
                                 target_len=self.serve.max_len)
        insert_request(self.cfg, self.slab, caches, slot)
        tok0 = _sample_row(logits[0, -1], req.seed, 0, req.temperature)
        self._tok[slot] = tok0
        req.state = RUNNING
        req.slot = slot
        req.t_admit = req.t_first = self.now
        req.tokens.append(int(tok0))
        self._running[slot] = req
        self._seeds[slot] = req.seed
        self._steps[slot] = 1
        self._temps[slot] = float(req.temperature)
        if len(req.tokens) >= req.max_new:
            self._finish(slot)

    def _decode_step(self) -> None:
        logits, _ = decode_step(self.cfg, self.params, self.slab, self._tok[:, None])
        last = logits[:, -1]
        nxt = last.argmax(-1)
        for slot in self._running:
            if self._temps[slot] > 0.0:
                nxt[slot] = _sample_row(last[slot], self._seeds[slot],
                                        int(self._steps[slot]), float(self._temps[slot]))
        self._tok = nxt
        lat = self.coded.draw_step() if self.coded is not None else 1.0
        self.now += lat
        self.step_latencies.append(lat)
        nxt_host = nxt.cpu().numpy()  # the step's one read on the host
        for slot in sorted(self._running):
            req = self._running[slot]
            req.tokens.append(int(nxt_host[slot]))
            req.n_steps += 1
            self._steps[slot] += 1
            if len(req.tokens) >= req.max_new:
                self._finish(slot)

    def _finish(self, slot: int) -> None:
        req = self._running.pop(slot)
        req.state = DONE
        req.t_done = self.now
        req.slot = None
        self.scheduler.release(slot)
        self._temps[slot] = 0.0
        self.finished.append(req)


# ---------------------------------------------------------------- generate
def generate(cfg, params, prompt_tokens, max_new: int = 32, *,
             temperature: float = 0.0, seed: int = 0, aux_inputs=None,
             device="cuda"):
    """prompt_tokens: (B, S) -> (B, S + max_new) int32 tokens (a CPU
    tensor), through ``ServeEngine``: each prompt row is one request with
    its own seed (row 0 keeps ``seed``; row r > 0 uses
    ``fold_seed(seed, 2**30 + r)``)."""
    if max_new <= 0:
        return prompt_tokens
    if aux_inputs is not None:
        raise NotImplementedError("aux_inputs (vision/encoder configs) are not "
                                  "ported yet (ROADMAP 1.9)")
    if isinstance(prompt_tokens, torch.Tensor):
        prompt_tokens = prompt_tokens.cpu().numpy()
    prompts = np.asarray(prompt_tokens)
    b, s = prompts.shape
    eng = ServeEngine(cfg, params, ServeConfig(n_slots=b, max_len=s + max_new),
                      device=device)
    reqs = [eng.submit(prompts[r], max_new=max_new, temperature=temperature,
                       seed=_row_seed(seed, r)) for r in range(b)]
    eng.run()
    return torch.from_numpy(np.stack([r.output for r in reqs]))
