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
and copies nothing else.  The host reads one token tensor per engine
step: the step's decoded tokens, and its admissions' first tokens beside
them.

On a mesh (``mesh=``; a module from ``params.shard_model`` or
``init_shards`` brings its own) every rank runs the same scheduler, the
same coded tier (seeded alike) and the same simulated clock, so
admissions, slots and timestamps agree on every rank with no exchange.
The slab's slots are split over the data ranks by the ``batch`` rule
(``dist.sharding.batch_rows``: equal blocks where they divide the slots,
else every rank holds every slot), and a sharded module's slab holds the
rank's KV heads, Mamba channels and mLSTM and sLSTM heads beside MLA's
whole latent.  An
admission prefills on the ranks that hold its slot (its whole model
group: the model ranks' collectives pair up); a decode
step runs every rank's rows, with the logits gathered over the
vocabulary — a MoE layer counts its capacity over every rank's rows, as
the one-rank engine counts it over the whole slab (``moe.apply_moe``'s
``rows``); the step's tokens are then gathered over the data ranks
(``dist.collectives.gather_rows``), so every rank's ``Request``s fill in
alike.

Determinism contract: a request's token stream is a pure function of
(prompt, seed, params) on one device, independent of batch composition
and slot.  Greedy decoding (temperature <= 0) is ``argmax`` (the first
maximum, as in the reference) and matches the reference.  Above it,
token j adds Gumbel noise of shape (V,) from a generator seeded by
``fold_seed(seed, j)`` to ``logits / temperature``: the reference's
``jax.random`` key stream cannot be reproduced in torch (ROADMAP 3.5).

``restore_plan`` reads the coding ``Plan`` a trainer stored in a port
checkpoint's metadata.

A model with a cross-attention source (Whisper, Llama-3.2-vision) is
served by ``generate(aux_inputs=)``'s direct loop — one prefill, then a
``decode_step`` per token, each recomputing the source — not by the
engine, which takes no aux inputs (nor does the reference's).  A sharded
module runs the loop on its shards, every row on every rank: the source
whole, the encoder and the layers on the rank's heads.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, List, Optional

import numpy as np
import torch

from ..device import resolve_device
from ..dist.collectives import gather_rows
from ..dist.sharding import batch_rows
from ..models.model import decode_step, has_source, prefill
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
    """(params, caches, token, aux_inputs=None) -> (next_token_logits,
    caches): one decode step, caches updated in place."""

    def serve_step(params, caches, token, aux_inputs=None):
        logits, caches = decode_step(cfg, params, caches, token, aux_inputs=aux_inputs)
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
    be of the kind ``device`` names (default the card).  ``mesh``: this
    rank's ``dist.mesh.Mesh`` (a sharded ``params`` defaults to its own;
    a mesh with a ``model`` axis takes only params cut for it).
    A model with a cross-attention source raises: the engine takes no aux
    inputs (``generate(aux_inputs=)`` serves it).
    """

    def __init__(self, cfg, params, serve: Optional[ServeConfig] = None, *,
                 coded: Optional[CodedDecode] = None, device="cuda", mesh=None):
        if has_source(cfg):
            raise ValueError(f"{cfg.name} cross-attends to a source and the engine takes no "
                             "aux inputs: serve it with generate(aux_inputs=...)")
        dev = resolve_device(device)
        self.device = params.embed.tok.device
        if self.device.type != dev.type:
            raise ValueError(f"params are on {self.device}, engine device is {dev}")
        tp = params.tp
        if tp is not None and mesh is not None and tp.mesh is not mesh:
            raise ValueError("params are cut for another mesh than the engine's")
        if tp is None and mesh is not None and mesh.model > 1:
            raise ValueError(f"a mesh of model {mesh.model} serves only a sharded module: cut "
                             "the params with params.init_shards or shard_model")
        self.mesh = tp.mesh if mesh is None and tp is not None else mesh
        self.cfg = cfg
        self.params = params
        self.serve = serve or ServeConfig()
        self.coded = coded
        self.scheduler = Scheduler(self.serve.n_slots)
        b = self.serve.n_slots
        #: the slots this rank's slab holds (all of them off a mesh)
        self.rows = batch_rows(b, self.mesh)
        self.slab = make_slab(cfg, len(self.rows.rows), self.serve.max_len,
                              dtype=self.serve.dtype, device=self.device, tp=tp)
        self.now = 0.0
        self.finished: List[Request] = []
        self.step_latencies: List[float] = []
        self._running = {}                      # slot -> Request
        self._tok = torch.zeros(len(self.rows.rows), dtype=torch.long,
                                device=self.device)  # last token of each local row
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
        cols = [self._tok.clone()] if admitted else []  # the admissions' first tokens
        for req, slot in admitted:
            if req.max_new <= 1:  # complete at token 0, before this step's decode
                self._finish(slot)
        decoding = sorted(self._running)
        if decoding:
            cols.append(self._decode_step())
        if not cols:
            return len(self.scheduler) > 0
        host = self._read(cols)
        for req, slot in admitted:
            req.tokens.append(int(host[slot, 0]))
        for slot in decoding:
            req = self._running[slot]
            req.tokens.append(int(host[slot, -1]))
            req.n_steps += 1
            self._steps[slot] += 1
            if len(req.tokens) >= req.max_new:
                self._finish(slot)
        return bool(decoding) or len(self.scheduler) > 0

    def run(self) -> List[Request]:
        """Drain the engine; returns every finished request (in
        completion order)."""
        while self.step():
            pass
        return self.finished

    # ------------------------------------------------------------ internals
    def _local(self, slot: int):
        """The slab row of global ``slot`` on this rank, or None when
        another rank holds it."""
        return slot - self.rows.rows.start if slot in self.rows.rows else None

    def _admit(self, req: Request, slot: int) -> None:
        """Prefill ``req`` into ``slot`` (on the ranks holding it) and
        sample its first token into the slot's row of ``_tok``; the host
        reads it with the step's tokens."""
        row = self._local(slot)
        if row is not None:
            tokens = torch.from_numpy(req.prompt[None, :]).to(self.device)
            logits, caches = prefill(self.cfg, self.params, tokens,
                                     target_len=self.serve.max_len, last_only=True)
            insert_request(self.cfg, self.slab, caches, row)
            self._tok[row] = _sample_row(logits[0, -1], req.seed, 0, req.temperature)
        req.state = RUNNING
        req.slot = slot
        req.t_admit = req.t_first = self.now
        self._running[slot] = req
        self._seeds[slot] = req.seed
        self._steps[slot] = 1
        self._temps[slot] = float(req.temperature)

    def _decode_step(self) -> torch.Tensor:
        """One lockstep decode of this rank's rows; returns their next
        tokens (on the device) and advances the simulated clock."""
        logits, _ = decode_step(self.cfg, self.params, self.slab, self._tok[:, None],
                                rows=self.rows)
        last = logits[:, -1]
        nxt = last.argmax(-1)
        for slot in self._running:
            row = self._local(slot)
            if row is not None and self._temps[slot] > 0.0:
                nxt[row] = _sample_row(last[row], self._seeds[slot],
                                       int(self._steps[slot]), float(self._temps[slot]))
        self._tok = nxt
        lat = self.coded.draw_step() if self.coded is not None else 1.0
        self.now += lat
        self.step_latencies.append(lat)
        return nxt

    def _read(self, cols: list) -> np.ndarray:
        """The step's tokens of every slot, (n_slots, len(cols)) on the
        host: this rank's rows gathered over the data ranks, then the
        step's one read."""
        return gather_rows(torch.stack(cols, dim=-1), self.rows).cpu().numpy()

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
             device="cuda", mesh=None):
    """prompt_tokens: (B, S) -> (B, S + max_new) int32 tokens (a CPU
    tensor), through ``ServeEngine`` (on ``mesh`` when given: every rank
    returns every row): each prompt row is one request with
    its own seed (row 0 keeps ``seed``; row r > 0 uses
    ``fold_seed(seed, 2**30 + r)``).  With ``aux_inputs`` (B, ...) —
    the modality embeddings of a model with a cross-attention source —
    the reference's direct loop instead (``_generate_direct``, every row
    on every rank), with the same row seeds."""
    if max_new <= 0:
        return prompt_tokens
    if isinstance(prompt_tokens, torch.Tensor):
        prompt_tokens = prompt_tokens.cpu().numpy()
    prompts = np.asarray(prompt_tokens)
    if aux_inputs is not None:
        return _generate_direct(cfg, params, prompts, max_new, temperature, seed,
                                aux_inputs, device)
    b, s = prompts.shape
    eng = ServeEngine(cfg, params, ServeConfig(n_slots=b, max_len=s + max_new),
                      device=device, mesh=mesh)
    reqs = [eng.submit(prompts[r], max_new=max_new, temperature=temperature,
                       seed=_row_seed(seed, r)) for r in range(b)]
    eng.run()
    return torch.from_numpy(np.stack([r.output for r in reqs]))


def _generate_direct(cfg, params, prompts, max_new: int, temperature: float, seed: int,
                     aux_inputs, device):
    """The reference's direct decode loop (kept for ``aux_inputs``): one
    prefill of the whole batch into caches of capacity S + max_new, then
    one ``decode_step`` per token over every row, each recomputing the
    source from ``aux_inputs``; token j of row r drawn as the engine draws
    it (``_sample_row`` with the row's seed)."""
    dev = resolve_device(device)
    if params.embed.tok.device.type != dev.type:
        raise ValueError(f"params are on {params.embed.tok.device}, device is {dev}")
    b, s = prompts.shape
    seeds = [_row_seed(seed, r) for r in range(b)]
    aux = torch.as_tensor(aux_inputs, device=params.embed.tok.device)
    tokens = torch.from_numpy(prompts.astype(np.int64)).to(params.embed.tok.device)
    logits, caches = prefill(cfg, params, tokens, aux_inputs=aux, target_len=s + max_new,
                             last_only=True)

    def sample(last, j):
        return torch.stack([_sample_row(last[r], seeds[r], j, temperature) for r in range(b)])

    out = [sample(logits[:, -1], 0)]
    for j in range(1, max_new):
        logits, caches = decode_step(cfg, params, caches, out[-1][:, None], aux_inputs=aux)
        out.append(sample(logits[:, -1], j))
    new = torch.stack(out, dim=1).cpu().numpy()
    return torch.from_numpy(np.concatenate([prompts, new], axis=1).astype(np.int32))
