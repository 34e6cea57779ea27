#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Run from the root of a checkout.  It imports only ``torch`` and the
port (``src/repro_torch``) — nothing of JAX or of the ``repro`` package
— and fails (non-zero exit, no result line) without CUDA or without the
port's sources beside it.  Phases; any failure raises:

1. device: the card's name and power limit, and the build of every
   CUDA source of the port (``nvcc``, one process per source).
2. setup: full-width gc-lm-110m (12 layers, d_model 768, vocab 32,000,
   random weights from seed 0) in a ``Trainer`` on the card: N = 4
   workers, scheme ``xf``, seq 256, global batch 8.
3. kernel: ``gc_fused`` (``csrc/gc_pipe.cuh``'s grouped kernel) on the
   main path's shapes: the step's 11 leaves (NB = 1, K = N·(s_max+1),
   fp32, each leaf with its level's weights) in one launch, against the
   grouped plain version and bit-equal to the per-leaf streaming loop of
   ``gc_stream.cuh`` (``gc_encode.encode`` of the folded weights); a list
   longer than one launch holds (split); mixed aligned and ragged widths
   in fp32 and bf16 at NB = 1, K = 16, NB = 3, K = 4 and NB = 8; K too
   wide for a ring (100 and 400, N = 20 workers) with weight tables past
   4096 floats, bit-equal to the loop.  Times
   per step and per width: host-inclusive (CUDA events around a call),
   device-only (a CUDA graph of R calls replayed between two events) and
   the wrapper's host time (host clock, no synchronisation), of the
   streaming loop, the new kernel and one ``torch.matmul`` in turns, and
   the memory bound.
4. exactness: at step 0 the coded gradient equals the port's uncoded
   data-parallel gradient, with 0 and with s_max stragglers.
5. train: ``Trainer.run`` for 3 steps with every launch count set to 0
   just before; each kernel must have launched on this path (gc_fused:
   one launch per step), and the loss must be finite.
6. breakdown: the time of each piece of one step (forward+backward,
   the per-shard rows, the combine, the update), host clock around
   synchronized calls, and one coded-gradient call under
   ``torch.profiler`` (device time by kernel, device busy share).
6a. levels: one step's full-width per-shard rows combined per level
   (``combine_level``: one ``gc_fused`` launch per level, 3, 1 and 7
   leaves) are bit-equal to the step's one grouped launch; device-only
   times of the three launches and of the one, in turns, against the
   same bound.
6b. tree: the tree pipeline (per-leaf torch ops) against the flat one on
   the same rows (1e-5 per leaf), both equal to the uncoded gradient
   (1e-4), with 0 and s_max stragglers; device-only time of each combine.
6c. adapt: a fresh full-width ``Trainer(adapt=AdaptConfig(window=16,
   min_rounds=8, check_every=2))`` on workers 2 and 3 five times slower
   from round 2, 26 steps with the counts set to 0 just before: the
   controller swaps the plan after step 24 (the step the port's numpy
   layer predicts on the CPU: tests/test_torch_adapt.py), ``gc_fused``
   launches once per step across the swap, and the coded gradient under
   the new plan equals the uncoded one.
6d. wave: 3 barrier steps, then a fresh trainer from the same weights
   with ``WaveConfig(staleness=0)``: parameters and moments byte-equal;
   then 6 rounds at staleness 1: the executed events are the simulator's
   ``WaveTrace``, one ``gc_fused`` launch per decode event (3 per round),
   finite losses, and the peak device memory.
6e. spmd: four ranks on card 0 over gloo (``repro_torch.dist.spawn``;
   NCCL takes one card per rank), each a full-width
   ``Trainer(mode="spmd")`` with K = s_max + 1 shards per rank.  A probe
   says whether gloo reduce-scatters CUDA tensors on this torch
   (``psum_scatter`` runs only if it does).  At step 0, with 0 and s_max
   stragglers, the spmd gradient (``psum``, bf16, ``psum_scatter``) has
   the same bytes on every rank and equals rank 0's sim-mode gradient
   of the same weights and batches (1e-5 per leaf) and the uncoded one
   (1e-4; bf16 5e-2).  Three steps with the counts set to 0 just
   before: one ``gc_fused`` launch per rank per step, one ``psum`` per
   level per step, parameters byte-equal across ranks after every step,
   losses within 1e-4 of ``[train]``'s.  The time of one psum per level
   (gloo, host-staged, one card: no collective figure); rank 0's
   per-rank combine (one launch into the level buffers, bit-equal to
   the allocating call) device-only against its bound and
   ``torch.matmul`` in turns.  A rank's failure fails the script.
7. ckpt: a fresh full-width trainer (as in 2) with erasure-coded
   checkpoints, ``CodedSpec(n_shards=4, parity=1)`` every 2 steps, and
   worker 1 (which owns data stripe 1) 1000x slower from round 0, so the
   ``DeathWatch`` trips after step 4 (seed 0).  5 steps with every count
   set to 0 just before: a save at step 2 (parity through ``gc_encode``),
   a restore from the 3 survivors (``gc_encode`` on the survivors), one
   replayed step (gc_fused: one launch per step).  The restored state
   must be byte-equal to the saved one and the replayed loss equal to
   the first; the save, restore, snapshot and training times, the pieces
   of the save and the restore, and the host's peak RSS after each are
   printed.
8. encode: ``gc_encode`` at the checkpoint's shapes (NB = 1, K = 3 and
   2, the stripe's integer digits) equal to its plain version and to an
   int64 host product, and at ragged widths in fp32 and bf16 (NB = 3,
   K = 5 and NB = K = 12); host-inclusive, device-only and host times
   against the memory bound.
9. decode: ``gc_decode`` at ``benchmarks/kernel_bench.py``'s shapes
   (bit-equal to the streaming loop, timed in turns with it), ragged
   widths and N = 100, 400 against its plain version, then the
   reference's coded
   round trip through both kernels (counts set to 0 just before): encode
   with the (6, 6) cyclic code, strike 2 stragglers, decode, recover
   ``g.sum(0)``; times at the round trip's full width.
9a. serve: full-width gc-lm-110m (random weights, seed 0) in a
   ``ServeEngine`` (8 slots of 320, bf16 slab) behind the coded decode
   tier ``CodedDecode.solve(Env.iid(ShiftedExponential(mu=1e-3, t0=50),
   8), objective="p99", seed=0)``: 32 requests, Poisson arrivals at rate
   2e-3 (seed 0), 256-token prompts (numpy, seed 0), 64 new tokens each,
   greedy, with every count set to 0 just before.  Every request ends
   with 64 tokens, every slot serves more than one, the engine's step
   latencies are the tier's stream element for element, and no ``gc_*``
   kernel launches (the tier prices steps and calls none).  Teacher
   forcing: each decode step's logits against prefill logits of prompt
   + generated tokens at that position, two requests on a bf16 slab
   (``SERVE_BF16_REL``) and one on an fp32 slab (``SERVE_FP32_REL``).
   Prints prefill (256 tokens, batch 1) and one ``decode_step`` (batch 8,
   full slab), host-inclusive and device-only, beside their bounds; the
   engine's tokens/s by the wall clock; one engine step under
   ``torch.profiler`` (device-busy share, host syncs); peak device
   memory; the simulated step-latency p50 and p99 beside the tier's
   closed-form p99.
10. reference: three training steps at a reduced size on the CPU (the
   plain versions) and on the card, from the same weights, agree; the
   same weights and prompts through ``ServeEngine`` (fp32 slab, greedy)
   on both give equal tokens, timestamps and step latencies, and
   teacher-forced logits within 1e-4 of the largest.

The line before the last is the card's name and power limit; before it
a JSON line lists every kernel with its launches, error and times; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import resource
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(ROOT, "src")

#: H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS = 67e12
#: the kernel-parity tolerances of tests/test_kernel_parity.py::_tol
TOL = {"float32": dict(rtol=1e-5, atol=1e-5), "bfloat16": dict(rtol=2e-2, atol=1e-4)}
#: coded vs uncoded gradient, relative max error per leaf (fp32, TF32 off)
EXACT_RTOL = 1e-4
STEPS = 3
#: the [adapt] phase: workers 2 and 3 five times slower from round 2; with
#: seed 0 the controller swaps after step 24 (tests/test_torch_adapt.py
#: holds the port's numpy layer to the reference on this stream)
ADAPT_FAULTS = (dict(worker=2, factor=5.0, from_round=2), dict(worker=3, factor=5.0, from_round=2))
ADAPT_SWAP_STEP = 24
ADAPT_STEPS = 26
#: the [wave] phase: the master's update cost and broadcast latency per
#: round, in simulated time (a barrier round here is about 1e8 to 8e8)
WAVE_COSTS = dict(update_cost=3e7, broadcast_latency=1e6)
WAVE_ROUNDS = 6
#: the [spmd] phase: ranks on one card over gloo (NCCL takes one card per
#: rank) and the job's time limit, seconds
SPMD_RANKS = 4
SPMD_LIMIT_S = 600.0
#: worker 1 dies (1000x slower from round 0): with seed 0 the DeathWatch
#: (factor 20, 4 rounds) trips after the 4th step (found on the CPU with
#: the port's PlanSimulator and DeathWatch alone)
DEATH = dict(worker=1, factor=1000.0, from_round=0)
CKPT_STEPS = 5
#: the [serve] phase: slab, load and the launcher's default coded tier
SERVE = dict(n_slots=8, max_len=320, n_requests=32, prompt_len=256, max_new=64,
             rate=2e-3, workers=8, profile_step=120)
#: teacher-forced decode logits against prefill logits of the same tokens,
#: relative to the largest logit: a bf16 slab rounds every cached K/V to
#: 8 bits (full width on an H100 80GB HBM3 at 700.00 W: 6.425e-3; the
#: reduced model on the CPU: 1.54e-3, tests/test_torch_serve.py); an fp32
#: slab sums the same fp32 terms in another order (the same card: 3.825e-6)
SERVE_BF16_REL = 2e-2
SERVE_FP32_REL = 1e-4


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median time of one call between two CUDA events, after warm-up: the
    host-inclusive time (the card idles while the host prepares the
    launch, so the wrapper's host path is part of it)."""
    import torch

    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


#: the side stream of ``device_ms``'s warm-ups and captures
_SIDE = None


def device_ms(fn, reps: int) -> float:
    """Device-only time per call: ``reps`` calls captured in one CUDA
    graph, replayed between two CUDA events, over ``reps`` (the median of
    three replays, after warm-up).  No host work runs between the
    kernels of a replay, so the wrapper's host path is left out; what
    remains beside the kernels is the graph's launch of each."""
    import torch

    global _SIDE
    if _SIDE is None:  # one stream for every capture: a library call keeps
        _SIDE = torch.cuda.Stream()  # a workspace for each stream it meets
    _SIDE.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(_SIDE):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(_SIDE)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=_SIDE):
        for _ in range(reps):
            fn()
    graph.replay()
    times = []
    for _ in range(3):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    del graph
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """The host's time per call over ``reps`` calls with no
    synchronisation among them (the wrapper's host path, while the
    device's queue takes the launches)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    spent = time.perf_counter() - t0
    torch.cuda.synchronize()
    return spent / reps * 1e3


def device_in_turns(fns: dict, reps: int) -> dict:
    """Device-only ms of each function, measured in turns (a, b, c, c, b,
    a); {name: [first, second]}."""
    names = list(fns)
    out = {n: [] for n in names}
    for n in names + names[::-1]:
        out[n].append(device_ms(fns[n], reps))
    return out


def _mean(pair) -> float:
    return sum(pair) / len(pair)


def check_close(kernel: str, got, want, dtype_name: str, what: str) -> float:
    import torch

    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"{kernel} disagrees with its plain version at {what}: "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item()


def check_wide(kernel: str, got, want, w, g, dtype_name: str, what: str) -> float:
    """``check_close`` for a wide K: two fp32 sums of the same K products
    in different orders each lie within K·2^-24·(|w| @ |G|) of the exact
    sum, so the stated tolerance widens by twice that bound.  ``w`` is
    the (NB, K) weights as the kernel rounds them (G's dtype)."""
    import torch

    tol = TOL[dtype_name]
    g64, w64, want64 = g.double(), w.double(), want.double()
    err = (got.double() - want64).abs()
    spread = 2 * w.shape[1] * 2.0 ** -24 * (w64.abs() @ g64.abs())
    bad = err > tol["atol"] + tol["rtol"] * want64.abs() + spread
    if bool(bad.any()) or not bool(torch.isfinite(got.float()).all()):
        raise AssertionError(f"{kernel} disagrees with its plain version at {what}: "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item()


def bounds_ms(n_bytes: float, n_ops: float) -> tuple:
    """(bytes time, operations time) in ms at the card's peaks: the least
    time is the larger of the two."""
    return n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_FLOPS * 1e3


def reset_counts() -> None:
    from repro_torch.kernels import gc_decode, gc_encode, gc_fused

    gc_fused.launches = gc_encode.launches = gc_decode.launches = 0


def read_counts() -> dict:
    from repro_torch.kernels import gc_decode, gc_encode, gc_fused

    return {"gc_fused": gc_fused.launches, "gc_encode": gc_encode.launches,
            "gc_decode": gc_decode.launches}


# --------------------------------------------------------------- phases
def phase_device():
    from repro_torch.kernels import _build

    line = smi_line()
    log(f"[device] {line}")
    t0 = time.perf_counter()
    libs = _build.build_all()
    log(f"[device] built {sorted(libs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)})")
    for name, rec in _build.build_logs().items():
        regs = [ln.strip() for ln in rec["log"].splitlines() if "registers" in ln]
        spills = [ln.strip() for ln in rec["log"].splitlines()
                  if "spill" in ln and not ln.strip().startswith("0 bytes stack frame, 0 bytes spill")]
        log(f"[device] {name}: {rec['seconds']:.2f} s, {len(regs)} entry points, "
            f"max registers {max((int(r.split('Used ')[1].split()[0]) for r in regs), default=0)}, "
            f"spilling entries {len(spills)}")


def make_trainer(env=None, **kw):
    """Full-width gc-lm-110m in a ``Trainer`` on the card (seed 0); ``kw``
    goes to the ``Trainer`` (ckpt, adapt, wave, params)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("gc-lm-110m").replace(max_seq=512)
    return Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                   env or ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4,
                   scheme="xf", global_batch=8, seed=0, device="cuda",
                   seq_len=256, **kw)


def phase_setup():
    t0 = time.perf_counter()
    trainer = make_trainer()
    plan = trainer.plan
    n_params = sum(t.numel() for t in trainer.state.params.leaves())
    log(f"[setup] gc-lm-110m: {n_params} params in {len(plan.flat_layout.leaf_shapes)} "
        f"leaves, x={plan.x.tolist()}, leaf levels {plan.leaf_levels.tolist()}, "
        f"s_max={plan.s_max}, N*K={plan.n_workers * plan.k_shards}; "
        f"{time.perf_counter() - t0:.2f} s")
    return trainer


def phase_kernel(trainer):
    """``gc_fused``: the main path's grouped launch (the step's leaves,
    each with its level's weights) against the grouped plain version and
    bit-equal to ``gc_stream.cuh``'s per-leaf loop (``gc_encode.encode`` of the
    folded weights w = a ⊙ B: the same products in the same order), per
    step and per width; a split list; mixed aligned and ragged leaves."""
    import torch

    from repro_torch.kernels import _pipe, gc_encode, gc_fused, ref

    plan = trainer.plan
    layout = plan.flat_layout
    nk = plan.n_workers * plan.k_shards
    gen = torch.Generator(device="cuda").manual_seed(1234)
    which = list(layout.leaf_level)
    widths = [layout.leaf_size(j) for j in range(layout.n_leaves)]
    a = torch.full((1,), 1.0 / plan.n_workers, device="cuda")
    table = torch.randn((layout.n_levels, 1, nk), device="cuda", generator=gen)
    gs = [torch.randn((nk, d), device="cuda", generator=gen) for d in widths]
    ws = [(a[:, None] * table[i]).contiguous() for i in which]
    before = gc_fused.launches
    ys = gc_fused.encode_decode_leaves(a, table, which, gs)
    if gc_fused.launches - before != 1:
        raise AssertionError(f"the step's {len(gs)} leaves took "
                             f"{gc_fused.launches - before} launches, expected 1")
    max_err = 0.0
    for j, (y, want) in enumerate(zip(ys, ref.encode_decode_leaves_ref(a, table, which, gs))):
        max_err = max(max_err, check_close("gc_fused", y, want, "float32",
                                           f"grouped leaf {j} NB=1 K={nk} D={widths[j]}"))
        if not torch.equal(y, gc_encode.encode(ws[j], gs[j])):
            raise AssertionError(f"gc_fused is not bit-equal to the streaming loop at leaf {j} "
                                 f"D={widths[j]}")
    del ys
    log(f"[kernel] grouped launch of the step's {len(gs)} leaves (levels {which}): "
        f"agrees with the grouped plain version, max abs err {max_err:.3e}; bit-equal to "
        "the streaming loop (gc_encode.encode of w = a * B) at every main-path width")

    # per step: the streaming loop (one launch per leaf), the new kernel and torch.matmul in turns
    step = {"old": lambda: [gc_encode.encode(w, g) for w, g in zip(ws, gs)],
            "new": lambda: gc_fused.encode_decode_leaves(a, table, which, gs),
            "library": lambda: [torch.matmul(w, g) for w, g in zip(ws, gs)]}
    dev = device_in_turns(step, 10)
    n_cols = sum(widths)
    # each input read once, the output written once; one multiply-add per
    # element of G
    bytes_ms, ops_ms = bounds_ms((1 + nk) * n_cols * 4 + (layout.n_levels + 1) * nk * 4,
                                 2.0 * nk * n_cols)
    totals = {"ms": time_ms(step["new"], 10),
              "plain_ms": time_ms(lambda: ref.encode_decode_leaves_ref(a, table, which, gs), 10),
              "library_ms": time_ms(step["library"], 10),
              "bound_ms": max(bytes_ms, ops_ms),
              "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
              "device_ms": _mean(dev["new"]), "host_ms": host_ms(step["new"], 10),
              "old_device_ms": _mean(dev["old"]), "old_ms": time_ms(step["old"], 10),
              "old_host_ms": host_ms(step["old"], 10),
              "library_device_ms": _mean(dev["library"])}
    log(f"[kernel] per step ({len(gs)} leaves, one launch; the streaming loop: one per leaf), "
        f"device-only ms in turns old/new/library/library/new/old: "
        + ", ".join(f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in dev.items())
        + f"; bound_ms {totals['bound_ms']:.4f}, share_of_bound new "
        f"{totals['bound_ms'] / totals['device_ms']:.3f} old "
        f"{totals['bound_ms'] / totals['old_device_ms']:.3f} library "
        f"{totals['bound_ms'] / totals['library_device_ms']:.3f}; host-inclusive ms new "
        f"{totals['ms']:.4f} old {totals['old_ms']:.4f} plain {totals['plain_ms']:.4f} "
        f"library {totals['library_ms']:.4f}; wrapper host ms per step new {totals['host_ms']:.4f} "
        f"old {totals['old_host_ms']:.4f}")

    # per width, one leaf per call
    for d in sorted(set(widths)):
        j = widths.index(d)
        g, w = gs[j], ws[j]
        b = table[which[j]]
        reps = 20 if d > 10**6 else 200
        one = {"old": lambda: gc_encode.encode(w, g),
               "new": lambda: gc_fused.encode_decode(a, b, g),
               "library": lambda: torch.matmul(w, g)}
        dev = device_in_turns(one, reps)
        k_ms = time_ms(one["new"], reps)
        p_ms = time_ms(lambda: ref.encode_decode_ref(a, b, g), reps)
        l_ms = time_ms(one["library"], reps)
        h_ms = host_ms(one["new"], reps)
        h_old = host_ms(one["old"], reps)
        bound = max(bounds_ms((1 + nk) * d * 4 + (nk + 1) * 4, 2.0 * nk * d))
        log(f"[kernel] NB=1 K={nk} D={d} fp32 x{widths.count(d)}/step: kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bound:.4f}; device-only "
            f"new {_mean(dev['new']):.4f} old {_mean(dev['old']):.4f} library "
            f"{_mean(dev['library']):.4f} (turns {dev}); share_of_bound new "
            f"{bound / _mean(dev['new']):.3f} old {bound / _mean(dev['old']):.3f}; wrapper "
            f"host ms new {h_ms:.4f} old {h_old:.4f}")
    del gs, ws

    # a list longer than one launch holds: split into ceil(n / MAX_LEAVES)
    n_split = 2 * _pipe.MAX_LEAVES + 6
    split_w = [100 * (j + 1) + 4 * (j % 3) for j in range(n_split)]
    split_which = [j % 3 for j in range(n_split)]
    split_tab = torch.randn((3, 1, nk), device="cuda", generator=gen)
    gs = [torch.randn((nk, d), device="cuda", generator=gen) for d in split_w]
    before = gc_fused.launches
    ys = gc_fused.encode_decode_leaves(a, split_tab, split_which, gs)
    launches = gc_fused.launches - before
    if launches != -(-n_split // _pipe.MAX_LEAVES):
        raise AssertionError(f"{n_split} leaves took {launches} launches")
    for j, (y, g) in enumerate(zip(ys, gs)):
        want = ref.encode_decode_ref(a, split_tab[split_which[j]], g)
        max_err = max(max_err, check_close("gc_fused", y, want, "float32",
                                           f"split leaf {j} D={split_w[j]}"))
        w = (a[:, None] * split_tab[split_which[j]]).contiguous()
        if not torch.equal(y, gc_encode.encode(w, g)):
            raise AssertionError(f"split leaf {j}: not bit-equal to the streaming loop")

    # mixed aligned and ragged leaves in one list, fp32 and bf16
    mixed = (1, 127, 129, 513, 1021, 1024, 768, 4100, 9216)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for nb, k in ((1, nk), (3, 4), (8, nk)):
            a_m = torch.randn((nb,), device="cuda", generator=gen)
            tab = torch.randn((2, nb, k), device="cuda", generator=gen)
            w_idx = [j % 2 for j in range(len(mixed))]
            gs = [torch.randn((k, d), device="cuda", generator=gen).to(dtype) for d in mixed]
            ys = gc_fused.encode_decode_leaves(a_m, tab, w_idx, gs)
            for y, g, i, d in zip(ys, gs, w_idx, mixed):
                if y.dtype != dtype or tuple(y.shape) != (nb, d):
                    raise AssertionError(f"gc_fused output {y.dtype}{tuple(y.shape)}")
                max_err = max(max_err, check_close(
                    "gc_fused", y, ref.encode_decode_ref(a_m, tab[i], g), name,
                    f"mixed NB={nb} K={k} D={d} {name}"))
            # the single-leaf entry at the same ragged widths
            for d in mixed[:5]:
                g = gs[mixed.index(d)]
                max_err = max(max_err, check_close(
                    "gc_fused", gc_fused.encode_decode(a_m, tab[0], g),
                    ref.encode_decode_ref(a_m, tab[0], g), name, f"NB={nb} K={k} D={d} {name}"))
    # K too wide for a ring of two stages (N = 20 workers: K = 100 at
    # s_max = 4, K = 400 at s_max = 19) and weight tables past 4096 floats
    wide = ((1, 100, 5), (1, 400, 20), (8, 400, 4))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for nb, k, n_w in wide:
            a_m = torch.randn((nb,), device="cuda", generator=gen)
            tab = torch.randn((n_w, nb, k), device="cuda", generator=gen)
            w_idx = [j % n_w for j in range(len(mixed))]
            gs = [torch.randn((k, d), device="cuda", generator=gen).to(dtype) for d in mixed]
            ys = gc_fused.encode_decode_leaves(a_m, tab, w_idx, gs)
            for y, g, i, d in zip(ys, gs, w_idx, mixed):
                w = (a_m[:, None] * tab[i]).contiguous()
                max_err = max(max_err, check_wide(
                    "gc_fused", y, ref.encode_decode_ref(a_m, tab[i], g), w.to(dtype), g,
                    name, f"wide NB={nb} K={k} n_w={n_w} D={d} {name}"))
                if not torch.equal(y, gc_encode.encode(w, g)):
                    raise AssertionError(f"gc_fused at NB={nb} K={k} D={d} {name}: not "
                                         "bit-equal to the streaming loop")
    torch.cuda.synchronize()
    log(f"[kernel] gc_fused agrees with its plain version at every shape (grouped main path, "
        f"{n_split} leaves in {launches} launches, mixed aligned/ragged fp32/bf16 at NB=1 K={nk}, "
        f"NB=3 K=4, NB=8 K={nk}; (NB, K, weight sets) {wide} without a ring, bit-equal to "
        f"the streaming loop); max abs err {max_err:.3e}; per step: "
        + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                   for k, v in totals.items()))
    return max_err, totals


def _uncoded_grads(trainer, step: int) -> list:
    """The port's plain data-parallel mean gradient over step ``step``'s
    global batch, at the trainer's current parameters."""
    import numpy as np

    from repro_torch.train.coded import uncoded_grad_fn

    n = trainer.n_workers
    shards = np.stack([trainer.data.shard(step, i, n) for i in range(n)])
    return uncoded_grad_fn(trainer.cfg, n)(trainer.state.params, shards)


def _straggler_dec_w(plan, u: int):
    """Decode weights with the first ``u`` workers straggling."""
    import numpy as np

    times = np.ones(plan.n_workers)
    times[:u] = 1e6
    return plan.decode_weights(times).astype(np.float32)


def _worst_rel(got, want, paths, bound: float, what: str) -> float:
    """Largest per-leaf relative max error of ``got`` against ``want``;
    raises past ``bound``."""
    worst = 0.0
    for path, a, b in zip(paths, got, want, strict=True):
        rel = ((a - b).abs().max() / b.abs().max().clamp_min(1e-30)).item()
        if not rel <= bound:
            raise AssertionError(f"{what} at {path}: relative max error {rel:.3e} > {bound}")
        worst = max(worst, rel)
    return worst


def check_coded_equals_uncoded(trainer, tag: str) -> None:
    """At the trainer's current step and plan, the coded gradient equals
    the uncoded one with 0 and s_max stragglers."""
    import torch

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.train.coded import make_coded_grad_fn

    plan, model, step = trainer.plan, trainer.state.params, int(trainer.state.step)
    wb = coded_worker_batches(trainer.data, step, trainer.n_workers, plan.s_max)
    g_ref = _uncoded_grads(trainer, step)
    coded = make_coded_grad_fn(trainer.cfg, plan)
    for u in (0, plan.s_max):
        worst = _worst_rel(coded(model, wb, _straggler_dec_w(plan, u)), g_ref,
                           model.leaf_paths(), EXACT_RTOL, f"coded != uncoded, {u} stragglers")
        log(f"[{tag}] step {step}, {u} stragglers: coded == uncoded, worst leaf relative "
            f"max error {worst:.3e} (bound {EXACT_RTOL})")
    del g_ref
    torch.cuda.synchronize()


def phase_exactness(trainer):
    check_coded_equals_uncoded(trainer, "exactness")


def phase_train(trainer):
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda s: log(f"[train] {s}"))
    torch.cuda.synchronize()
    launches = read_counts()
    if launches["gc_fused"] != STEPS:
        raise AssertionError(f"gc_fused launched {launches['gc_fused']} times in "
                             f"{STEPS} steps, expected one per step")
    losses = [h["loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    walls = [h["wall_s"] for h in trainer.history]
    log(f"[train] {STEPS} steps, losses {losses}, step wall_s {walls}, "
        f"max_memory_allocated {torch.cuda.max_memory_allocated()} bytes, "
        f"launches {launches}")
    return launches


def phase_breakdown(trainer):
    """Where one step's time goes: host clock around synchronized pieces
    of the step, then one coded-gradient call under ``torch.profiler``
    (device time by kernel, and the device's busy share of that call).
    Runs after the main path, whose counts are already read."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.models.model import train_loss
    from repro_torch.optim.optim import adamw_update, clip_by_global_norm
    from repro_torch.train.coded import combine_rows, make_coded_grad_fn, per_shard_grad_rows

    cfg, plan, model = trainer.cfg, trainer.plan, trainer.state.params
    leaves = model.leaves()
    wb = coded_worker_batches(trainer.data, 0, trainer.n_workers, plan.s_max)
    dec_w = plan.decode_weights(np.arange(trainer.n_workers)).astype(np.float32)
    tokens = torch.as_tensor(wb[0, 0], device="cuda")
    grad_fn = make_coded_grad_fn(cfg, plan)

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    def fwd():
        with torch.no_grad():
            train_loss(cfg, model, {"tokens": tokens})

    def fwd_bwd():
        torch.autograd.grad(train_loss(cfg, model, {"tokens": tokens})[0], leaves)

    rows = per_shard_grad_rows(cfg, model, wb)
    grads = [torch.zeros_like(t) for t in leaves]

    def update():
        g, _ = clip_by_global_norm(grads, 1.0)
        trainer.state.opt = adamw_update(g, trainer.state.opt, leaves, 1e-12)

    parts = {"fwd_bwd": ms(fwd_bwd), "combine": ms(lambda: combine_rows(plan, rows, dec_w)),
             "fwd": ms(fwd), "update": ms(update)}
    del rows
    parts["rows"] = ms(lambda: per_shard_grad_rows(cfg, model, wb), reps=2)
    parts["grad_fn"] = ms(lambda: grad_fn(model, wb, dec_w), reps=2)
    nk = plan.n_workers * plan.k_shards
    log(f"[breakdown] one step at N*K={nk}: fwd+bwd {parts['fwd_bwd']:.2f} ms "
        f"(x{nk} = {nk * parts['fwd_bwd']:.1f} ms); rows incl. copies {parts['rows']:.1f} ms; "
        f"combine (1 launch) {parts['combine']:.2f} ms; coded grads in all "
        f"{parts['grad_fn']:.1f} ms; monitor fwd {parts['fwd']:.2f} ms; "
        f"clip+adamw {parts['update']:.2f} ms")

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        grad_fn(model, wb, dec_w)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernels only: a CPU op's self device time repeats its kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    log(f"[profile] coded grads under the profiler: wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), {len(events)} kernel kinds")
    for e in sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:10]:
        log(f"[profile]   {e.self_device_time_total / 1e3:9.2f} ms  x{e.count:<5d} "
            f"{e.key[:90]}")


def phase_levels(trainer):
    """The wave loop's per-level combine on one step's full-width rows:
    one ``gc_fused`` launch per level (``combine_level``), their union
    bit-equal to the step's one grouped launch (``combine_rows``);
    device-only times of both patterns in turns against the same bound.
    Returns the rows (the [tree] phase reuses them) and the times."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import gc_fused
    from repro_torch.train.coded import (combine_level, combine_rows, level_weights,
                                         per_shard_grad_rows)

    plan, n = trainer.plan, trainer.n_workers
    layout = plan.flat_layout
    wb = coded_worker_batches(trainer.data, int(trainer.state.step), n, plan.s_max)
    rows = per_shard_grad_rows(trainer.cfg, trainer.state.params, wb)
    dec_w = plan.decode_weights(np.asarray([3.0, 1.0, 4.0, 2.0])[:n])
    sizes = [len(ids) for ids in layout.level_leaves]
    before = gc_fused.launches
    full = combine_rows(plan, rows, dec_w.astype(np.float32))
    grouped_launches = gc_fused.launches - before
    got = {}
    for li in range(layout.n_levels):
        got.update(combine_level(plan, rows, li, dec_w[li]))
    level_launches = gc_fused.launches - before - grouped_launches
    torch.cuda.synchronize()
    if (grouped_launches, level_launches) != (1, layout.n_levels):
        raise AssertionError(f"grouped combine took {grouped_launches} launches, the "
                             f"per-level one {level_launches}; expected 1 and {layout.n_levels}")
    for j, y in enumerate(full):
        if not torch.equal(got[j], y):
            raise AssertionError(f"per-level combine of leaf {j} is not bit-equal to the "
                                 "grouped launch")
    del full, got

    # the two launch patterns on the same tensors, device-only in turns
    nk = n * plan.k_shards
    inv_n = torch.full((1,), 1.0 / n, device="cuda")
    n_lv = layout.n_levels
    w_all = level_weights(plan, dec_w, "cuda")
    w_lv = [level_weights(plan, dec_w[li:li + 1], "cuda", levels=[li]) for li in range(n_lv)]
    ids = layout.level_leaves
    pattern = {
        "grouped": lambda: gc_fused.encode_decode_leaves(inv_n, w_all, layout.leaf_level, rows),
        "levels": lambda: [gc_fused.encode_decode_leaves(inv_n, w_lv[li], [0] * len(ids[li]),
                                                         [rows[j] for j in ids[li]])
                           for li in range(n_lv)]}
    dev = device_in_turns(pattern, 10)
    n_cols = sum(layout.leaf_size(j) for j in range(layout.n_leaves))
    bound = max(bounds_ms((1 + nk) * n_cols * 4 + (n_lv + 1) * nk * 4, 2.0 * nk * n_cols))
    times = {"grouped_device_ms": _mean(dev["grouped"]), "levels_device_ms": _mean(dev["levels"]),
             "grouped_ms": time_ms(pattern["grouped"], 10),
             "levels_ms": time_ms(pattern["levels"], 10), "bound_ms": bound}
    log(f"[levels] levels of {sizes} leaves: {level_launches} per-level launches bit-equal to "
        f"{grouped_launches} grouped launch; device-only ms in turns grouped/levels/levels/grouped "
        f"{dev}; means grouped {times['grouped_device_ms']:.4f} levels "
        f"{times['levels_device_ms']:.4f}, bound_ms {bound:.4f} (share grouped "
        f"{bound / times['grouped_device_ms']:.3f}, levels {bound / times['levels_device_ms']:.3f}); "
        f"host-inclusive ms grouped {times['grouped_ms']:.4f} levels {times['levels_ms']:.4f}")
    return rows, times


def phase_tree(trainer, rows):
    """The tree pipeline against the flat one on the same rows (1e-5 per
    leaf), both equal to the uncoded gradient (1e-4); device-only time of
    each combine in turns."""
    import torch

    from repro_torch.kernels import gc_fused
    from repro_torch.train.coded import combine_grads, level_weights, tree_combine

    plan, model = trainer.plan, trainer.state.params
    paths = model.leaf_paths()
    g_ref = _uncoded_grads(trainer, int(trainer.state.step))
    worst = {"tree_flat": 0.0, "tree_uncoded": 0.0, "flat_uncoded": 0.0}
    for u in (0, plan.s_max):
        dec_w = _straggler_dec_w(plan, u)
        tree = combine_grads(plan, rows, dec_w, pipeline="tree")
        flat = combine_grads(plan, rows, dec_w, pipeline="flat")
        what = f"{u} stragglers"
        worst["tree_flat"] = max(worst["tree_flat"], _worst_rel(
            tree, flat, paths, 1e-5, f"tree != flat, {what}"))
        worst["tree_uncoded"] = max(worst["tree_uncoded"], _worst_rel(
            tree, g_ref, paths, EXACT_RTOL, f"tree != uncoded, {what}"))
        worst["flat_uncoded"] = max(worst["flat_uncoded"], _worst_rel(
            flat, g_ref, paths, EXACT_RTOL, f"flat != uncoded, {what}"))
        del tree, flat
    del g_ref
    dec_w = _straggler_dec_w(plan, plan.s_max)
    n, layout = plan.n_workers, plan.flat_layout
    b_rows = torch.as_tensor(plan.b_rows, dtype=torch.float32, device="cuda")
    dw = torch.as_tensor(dec_w, dtype=torch.float32, device="cuda")
    inv_n = torch.full((1,), 1.0 / n, device="cuda")
    w_all = level_weights(plan, dec_w, "cuda")
    level_idx = plan.level_index().tolist()
    dev = device_in_turns({
        "flat": lambda: gc_fused.encode_decode_leaves(inv_n, w_all, layout.leaf_level, rows),
        "tree": lambda: tree_combine(b_rows, dw, level_idx, rows)}, 5)
    log(f"[tree] tree vs flat on one step's rows, 0 and {plan.s_max} stragglers: worst leaf "
        f"relative max error tree/flat {worst['tree_flat']:.3e} (bound 1e-5), tree/uncoded "
        f"{worst['tree_uncoded']:.3e}, flat/uncoded {worst['flat_uncoded']:.3e} (bound "
        f"{EXACT_RTOL}); combine device-only ms in turns flat/tree/tree/flat {dev}: flat "
        f"{_mean(dev['flat']):.4f}, tree {_mean(dev['tree']):.4f}")
    torch.cuda.synchronize()
    return {"flat_device_ms": _mean(dev["flat"]), "tree_device_ms": _mean(dev["tree"])}


def phase_adapt():
    """Adaptive re-planning at full width: the swap comes after the
    predicted step, ``gc_fused`` launches once per step across it, and
    the coded gradient under the new plan equals the uncoded one.
    Returns the counts of this path."""
    import torch

    from repro_torch.adapt import AdaptConfig
    from repro_torch.core import DegradedWorker, Env, ShiftedExponential

    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 4).with_faults(
        *(DegradedWorker(**f) for f in ADAPT_FAULTS))
    t0 = time.perf_counter()
    trainer = make_trainer(env, adapt=AdaptConfig(window=16, min_rounds=8, check_every=2))
    old = trainer.plan
    log(f"[adapt] trainer on {ADAPT_FAULTS}, AdaptConfig(window=16, min_rounds=8, "
        f"check_every=2); {time.perf_counter() - t0:.2f} s")
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(ADAPT_STEPS, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    swapped = [h["step"] for h in trainer.history if h.get("plan_swap")]
    if swapped != [ADAPT_SWAP_STEP]:
        raise AssertionError(f"plan swaps after steps {swapped}, predicted "
                             f"[{ADAPT_SWAP_STEP}]")
    if launches["gc_fused"] != ADAPT_STEPS:
        raise AssertionError(f"gc_fused launched {launches['gc_fused']} times in "
                             f"{ADAPT_STEPS} steps across the swap, expected one per step")
    losses = [h["loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"non-finite loss {losses}")
    new, ev = trainer.plan, trainer.controller.swaps[0]
    log(f"[adapt] {ADAPT_STEPS} steps in {wall:.2f} s (step wall_s "
        f"{[round(h['wall_s'], 3) for h in trainer.history]}); swap after step {swapped[0]} "
        f"(round {ev.round_idx}, predicted gain {ev.predicted_gain:.4f}): x {old.x.tolist()} "
        f"-> {new.x.tolist()}, leaf levels {old.leaf_levels.tolist()} -> "
        f"{new.leaf_levels.tolist()}; launches {launches}; losses "
        f"{[round(x, 4) for x in losses]}")
    check_coded_equals_uncoded(trainer, "adapt")
    del trainer
    torch.cuda.empty_cache()
    return launches


def phase_wave():
    """The wave-pipelined loop at full width: staleness 0 is byte-equal
    to the barrier loop; at staleness 1 the executed events are the
    simulator's, with one ``gc_fused`` launch per decode event.  Returns
    the counts of the three runs, summed."""
    import numpy as np
    import torch

    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.wave import WaveConfig, WaveRunner

    total = {}

    def counted(trainer, steps):
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run(steps, log_every=0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        got = read_counts()
        for k, v in got.items():
            total[k] = total.get(k, 0) + v
        return got, wall

    bar = make_trainer()
    init = params_to_numpy(bar.state.params)
    bar_launches, bar_wall = counted(bar, 3)
    want = _snapshot(bar.state.checkpoint_tree())
    bar_losses = [h["loss"] for h in bar.history]
    bar_times = [r["times"] for r in bar.sim.ledger]
    del bar
    torch.cuda.empty_cache()
    trainer = make_trainer(params=init, wave=WaveConfig(staleness=0, **WAVE_COSTS))
    del init
    wave0_launches, wave0_wall = counted(trainer, 3)
    if not _same_bytes(_snapshot(trainer.state.checkpoint_tree()), want):
        raise AssertionError("staleness 0: parameters or moments differ from the barrier loop's")
    if [h["loss"] for h in trainer.history] != bar_losses or not all(
            np.array_equal(a, r["times"]) for a, r in zip(bar_times, trainer.sim.ledger)):
        raise AssertionError("staleness 0: losses or ledger differ from the barrier loop's")
    if bar_launches["gc_fused"] != 3 or wave0_launches["gc_fused"] != 3:
        raise AssertionError(f"launches barrier {bar_launches}, staleness 0 {wave0_launches}: "
                             "want one per step")
    del want
    log(f"[wave] staleness 0, 3 rounds: parameters, moments, losses and ledger byte-equal to "
        f"3 barrier steps (barrier {bar_wall:.2f} s, wave {wave0_wall:.2f} s); launches "
        f"{wave0_launches}")

    trainer.wave = WaveRunner(trainer, WaveConfig(staleness=1, **WAVE_COSTS))
    first = len(trainer.history)
    torch.cuda.reset_peak_memory_stats()
    wave1_launches, wave1_wall = counted(trainer, WAVE_ROUNDS)
    [trace], [executed] = trainer.wave.traces, trainer.wave.executed
    if executed != list(trace.events):
        raise AssertionError("staleness 1: the executed events differ from the WaveTrace")
    n_decode = sum(e.kind == "decode" for e in trace.events)
    if wave1_launches["gc_fused"] != n_decode or n_decode != 3 * WAVE_ROUNDS:
        raise AssertionError(f"staleness 1: {wave1_launches['gc_fused']} gc_fused launches for "
                             f"{n_decode} decode events")
    hist = trainer.history[first:]
    losses = [h["loss"] for h in hist]
    if len(hist) != WAVE_ROUNDS or not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"staleness 1: losses {losses}")
    log(f"[wave] staleness 1, {WAVE_ROUNDS} rounds in {wave1_wall:.2f} s: executed events == "
        f"WaveTrace ({len(trace.events)} events, {n_decode} decodes), realized staleness "
        f"{trace.realized_staleness().tolist()}, update wall_s "
        f"{[round(h['wall_s'], 3) for h in hist]}, launches {wave1_launches}, losses "
        f"{[round(x, 4) for x in losses]}; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated()} bytes")
    del trainer
    torch.cuda.empty_cache()
    return total


def _spmd_rank(rank, world, train_losses):
    """One rank of the [spmd] phase (``dist.spawn``: every rank on card 0
    over gloo).  Rank 0 logs; every check raises, and a rank's failure
    fails the whole job.  Returns this rank's counts and times."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
    from repro_torch.kernels import gc_fused, ref
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.train.coded import make_coded_grad_fn

    say = log if rank == 0 else (lambda *args: None)
    mesh = make_local_mesh(world, device="cuda:0", backend="gloo")
    dev = mesh.device

    # does gloo reduce-scatter (and all-gather) CUDA tensors on this torch?
    try:
        collectives.all_gather(collectives.psum_scatter(
            torch.ones(world * 32, device=dev), mesh.data_group), mesh.data_group)
        scatter = None
    except RuntimeError as exc:
        scatter = str(exc).strip().splitlines()[0][:160]
    say(f"[spmd] probe: gloo reduce-scatter of CUDA tensors "
        f"{'works' if scatter is None else 'refused (' + scatter + ')'}; psum_scatter "
        f"{'runs on the card' if scatter is None else 'waits for a four-card run'}")

    t0 = time.perf_counter()
    trainer = make_trainer(mesh=mesh, mode="spmd")
    cfg, plan, model = trainer.cfg, trainer.plan, trainer.state.params
    layout, paths = plan.flat_layout, model.leaf_paths()
    wb = coded_worker_batches(trainer.data, 0, world, plan.s_max)
    say(f"[spmd] {world} ranks on {torch.cuda.get_device_name(dev)} over gloo, each a "
        f"full-width trainer (mode='spmd', K = {plan.k_shards} shards per rank); "
        f"{time.perf_counter() - t0:.2f} s")

    # step 0: spmd == sim mode (rank 0 computes it from the same weights
    # and batches while the other ranks wait) and == uncoded
    sim, unc, scales = {}, None, {}
    if rank == 0:
        unc = _uncoded_grads(trainer, 0)
        coded = make_coded_grad_fn(cfg, plan)
        rows = coded.rows(model, wb)
        for u in (0, plan.s_max):
            dec_w = _straggler_dec_w(plan, u)
            sim[u] = coded.combine(rows, dec_w)
            scales[u] = _contribution_scales(plan, rows, dec_w)
        del coded, rows
        torch.cuda.synchronize()
    dist.barrier()
    variants = {"psum": {}, "bf16": {"grad_dtype": torch.bfloat16}}
    if scatter is None:
        variants["psum_scatter"] = {"reduce_mode": "psum_scatter"}
    worst = {}
    for name, kw in variants.items():
        fn = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh, **kw)
        for u in (0, plan.s_max):
            g = fn(model, wb, _straggler_dec_w(plan, u))
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes() for t in g)).digest()
            collectives.check_replicated(digest, dev, f"the {name} gradient, {u} stragglers")
            if rank == 0:
                what = f"spmd {name}, {u} stragglers"
                if name == "bf16":
                    worst[name, u] = (_worst_abs(g, unc, paths, 5e-2, what + " != uncoded"),
                                      _worst_bf16(g, unc, scales[u], paths, what))
                else:
                    worst[name, u] = (_worst_rel(g, sim[u], paths, 1e-5, what + " != sim mode"),
                                      _worst_rel(g, unc, paths, EXACT_RTOL, what + " != uncoded"))
            del g
        del fn
    del sim, unc
    torch.cuda.empty_cache()
    say(f"[spmd] step 0, 0 and {plan.s_max} stragglers, every rank's gradient byte-equal: "
        + "; ".join(f"{n} u={u}: " + (f"vs uncoded max abs {w[0]:.3e} (bound 5e-2), "
                                      f"{w[1]:.3f} of 2^-7 sum_n |c_n|" if n == "bf16"
                                      else f"vs sim mode {w[0]:.3e} (bound 1e-5), vs uncoded "
                                           f"{w[1]:.3e} (bound {EXACT_RTOL})")
                    for (n, u), w in worst.items()))

    # the main path: Trainer(mode="spmd"), counts set to 0 just before
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(dev)
    reset_counts()
    collectives.reset_counts()
    for i in range(STEPS):
        trainer.run(1, log_every=0)
        torch.cuda.synchronize()
        for t in trainer.state.params.leaves():  # byte-equal to rank 0's
            theirs = t.detach().clone()
            dist.broadcast(theirs, src=0)
            if not torch.equal(theirs.view(torch.int32), t.detach().view(torch.int32)):
                raise AssertionError(f"rank {rank}: parameters differ from rank 0's after "
                                     f"step {i + 1}")
    counts = dict(collectives.counts)
    launches = read_counts()
    mem = torch.cuda.max_memory_allocated(dev)
    if launches["gc_fused"] != STEPS:
        raise AssertionError(f"rank {rank}: gc_fused launched {launches['gc_fused']} times "
                             f"in {STEPS} steps, expected one per step")
    if counts != dict(psum=STEPS * layout.n_levels, psum_scatter=0, all_gather=0,
                      broadcast=STEPS):
        raise AssertionError(f"rank {rank}: collectives {counts} in {STEPS} steps, expected "
                             f"one psum per level and one draw check per step")
    losses = [h["loss"] for h in trainer.history]
    for a, b in zip(losses, train_losses, strict=True):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"spmd losses {losses} vs [train]'s {train_losses}")
    walls = [h["wall_s"] for h in trainer.history]
    say(f"[spmd] {STEPS} steps of Trainer(mode='spmd'): losses {losses} (== [train]'s within "
        f"1e-4), parameters byte-equal across ranks after every step; rank 0 launches "
        f"{launches}, collectives {counts}, step wall_s {[round(w, 3) for w in walls]}, "
        f"max_memory_allocated {mem} bytes")

    # the collectives' time: gloo, host-staged, one card (no collective figure)
    bufs = {dt: [torch.zeros(n, dtype=dt, device=dev) for n in layout.level_sizes]
            for dt in (torch.float32, torch.bfloat16)}
    coll_ms = {}
    for dt, b in bufs.items():
        reps = []
        for _ in range(2):
            dist.barrier()
            t0 = time.perf_counter()
            collectives.psum(b, mesh.data_group)
            torch.cuda.synchronize()
            reps.append((time.perf_counter() - t0) * 1e3)
        coll_ms[str(dt).split(".")[-1]] = reps
    del bufs
    say(f"[spmd] one psum per level over {world} ranks (gloo, host-staged, one card; no "
        f"collective figure), ms per step: {coll_ms}")

    # the per-rank combine on rank 0 while the others wait at a barrier
    times = {}
    dist.barrier()
    if rank == 0:
        k = plan.k_shards
        rows = trainer.step_fn.grad_fn.rows(model, wb)
        dec_w = _straggler_dec_w(plan, plan.s_max)
        w = torch.as_tensor(dec_w[:, mesh.data_index], device=dev) / plan.n_workers
        b = torch.as_tensor(plan.b_rows[mesh.data_index], dtype=torch.float32, device=dev)
        table = (w[:, None] * b)[:, None, :].contiguous()
        one = torch.ones((1,), device=dev)
        which = list(layout.leaf_level)
        buf = [torch.zeros(n, device=dev) for n in layout.level_sizes]
        views = [None] * layout.n_leaves
        for j, li, off, size in layout.leaf_slices():
            views[j] = buf[li][off:off + size].view(1, size)
        before = gc_fused.launches
        gc_fused.encode_decode_leaves(one, table, which, rows, out=views)
        if gc_fused.launches - before != 1:
            raise AssertionError(f"the per-rank combine took {gc_fused.launches - before} "
                                 "launches, expected 1")
        err = 0.0
        alloc = gc_fused.encode_decode_leaves(one, table, which, rows)
        for j, (v, y, want) in enumerate(zip(views, alloc, ref.encode_decode_leaves_ref(
                one, table, which, rows))):
            if not torch.equal(v, y):
                raise AssertionError(f"out= leaf {j}: not bit-equal to the allocating call")
            err = max(err, check_close("gc_fused", v, want, "float32",
                                       f"spmd leaf {j} NB=1 K={k} D={v.shape[1]}"))
        del alloc
        ws = [table[i] for i in which]
        fns = {"kernel": lambda: gc_fused.encode_decode_leaves(one, table, which, rows,
                                                               out=views),
               "library": lambda: [torch.matmul(wt, g) for wt, g in zip(ws, rows)]}
        dev_ms = device_in_turns(fns, 10)
        n_cols = sum(layout.leaf_size(j) for j in range(layout.n_leaves))
        bytes_ms, ops_ms = bounds_ms((1 + k) * n_cols * 4 + layout.n_levels * k * 4,
                                     2.0 * k * n_cols)
        times = {"device_ms": _mean(dev_ms["kernel"]),
                 "library_device_ms": _mean(dev_ms["library"]),
                 "bound_ms": max(bytes_ms, ops_ms),
                 "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                 "ms": time_ms(fns["kernel"], 10), "library_ms": time_ms(fns["library"], 10),
                 "plain_ms": time_ms(lambda: ref.encode_decode_leaves_ref(one, table, which,
                                                                          rows), 10),
                 "max_abs_err": err}
        say(f"[spmd] per-rank combine (NB=1, K={k}, {layout.n_leaves} leaves in one launch "
            f"into the level buffers, out= bit-equal to the allocating call, max abs err "
            f"{err:.3e} vs the plain version): device-only ms in turns kernel/library/"
            f"library/kernel {dev_ms}; means kernel {times['device_ms']:.4f} library "
            f"{times['library_device_ms']:.4f}; bound_ms {times['bound_ms']:.4f} (share "
            f"{times['bound_ms'] / times['device_ms']:.3f}); host-inclusive ms kernel "
            f"{times['ms']:.4f} library {times['library_ms']:.4f} plain {times['plain_ms']:.4f}")
        del rows, buf, views
    dist.barrier()
    return {"launches": launches["gc_fused"], "counts": counts, "walls": walls, "mem": mem,
            "coll_ms": coll_ms, "times": times, "scatter": scatter is None}


def _contribution_scales(plan, rows, dec_w) -> list:
    """Per leaf, max over its elements of sum_n |c_n|, c_n = (dec_w[l, n]
    / N) b_rows[n, l] @ G_n worker n's coded contribution (``rows``: the
    sim-mode (N·K, size) rows): the largest partial sum a reduction of
    the contributions forms, the scale of a bf16 reduction's rounding."""
    import torch

    n, k = plan.n_workers, plan.k_shards
    b = torch.as_tensor(plan.b_rows, dtype=torch.float32, device=rows[0].device)
    out = []
    for j, g in enumerate(rows):
        li = plan.flat_layout.leaf_level[j]
        total = sum(((float(dec_w[li, w]) / n) * b[w, li] @ g[w * k:(w + 1) * k]).abs()
                    for w in range(n))
        out.append(float(total.max()))
    return out


def _worst_abs(got, want, paths, bound: float, what: str) -> float:
    """Largest per-leaf max abs error; raises past ``bound``."""
    worst = 0.0
    for path, a, b in zip(paths, got, want, strict=True):
        err = (a.float() - b).abs().max().item()
        if not err <= bound:
            raise AssertionError(f"{what} at {path}: max abs error {err:.3e} > {bound}")
        worst = max(worst, err)
    return worst


def _worst_bf16(got, want, scales, paths, what: str) -> float:
    """Largest per-leaf max abs error of a bf16 reduction over 2^-7 of the
    leaf's contribution scale (``_contribution_scales``: four roundings of
    2^-9 each, the terms' and the sums'); raises past 1."""
    worst = 0.0
    for path, a, b, scale in zip(paths, got, want, scales, strict=True):
        ratio = (a.float() - b).abs().max().item() / (2.0 ** -7 * max(scale, 1e-30))
        if not ratio <= 1.0:
            raise AssertionError(f"{what} at {path}: max abs error {ratio:.3f} x 2^-7 of "
                                 "sum_n |c_n|, past the bound")
        worst = max(worst, ratio)
    return worst


def phase_spmd(train_losses):
    """spmd coded training on one card: ``SPMD_RANKS`` ranks on card 0
    over gloo (NCCL takes one card per rank), each a full-width
    ``Trainer(mode="spmd")``.  Returns the ranks' gc_fused launches on
    the main path, summed, and rank 0's combine times."""
    from repro_torch.dist.spawn import spawn

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_spmd_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        ranks = spawn(_spmd_rank, SPMD_RANKS, train_losses, store_dir=store, backend="gloo",
                      timeout=SPMD_LIMIT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    log(f"[spmd] {SPMD_RANKS} ranks done in {time.perf_counter() - t0:.1f} s; per rank "
        f"gc_fused launches {[r['launches'] for r in ranks]}, step wall_s "
        f"{[[round(w, 3) for w in r['walls']] for r in ranks]}, max_memory_allocated "
        f"{[r['mem'] for r in ranks]} bytes, psum ms per step {[r['coll_ms'] for r in ranks]}")
    return sum(r["launches"] for r in ranks), ranks[0]["times"]


def _snapshot(tree) -> dict:
    """{key: device copy} of every leaf of a state, for a byte comparison."""
    import numpy as np
    import torch

    from repro_torch.checkpoint.ckpt import tree_items

    return {k: v.detach().clone() if isinstance(v, torch.Tensor) else np.array(v)
            for k, v in tree_items(tree)}


def _same_bytes(a: dict, b: dict) -> bool:
    import numpy as np
    import torch

    if list(a) != list(b):
        return False
    for k, x in a.items():
        y = b[k]
        if isinstance(x, torch.Tensor):
            if not (isinstance(y, torch.Tensor) and x.dtype == y.dtype and x.shape == y.shape
                    and torch.equal(x.reshape(-1).view(torch.uint8),
                                    y.reshape(-1).view(torch.uint8))):
                return False
        elif np.asarray(x).tobytes() != np.asarray(y).tobytes():
            return False
    return True


class Pieces:
    """Exclusive host time of named module functions while installed: a
    function's own time, less that of the timed functions it calls."""

    def __init__(self, module, names):
        self.module, self.names = module, names
        self.spent: dict = {}
        self._stack: list = []
        self._orig: dict = {}

    def _timed(self, name, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            self._stack.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                dt = time.perf_counter() - t0
                inner = self._stack.pop()
                self.spent[name] = self.spent.get(name, 0.0) + dt - inner
                if self._stack:
                    self._stack[-1] += dt
        return call

    def __enter__(self):
        for name in self.names:
            self._orig[name] = getattr(self.module, name)
            setattr(self.module, name, self._timed(name, self._orig[name]))
        return self

    def __exit__(self, *exc):
        for name, fn in self._orig.items():
            setattr(self.module, name, fn)

    def take(self) -> dict:
        out, self.spent = self.spent, {}
        return out


def _peak_rss_gb() -> float:
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss * 1024 / 1e9


def _pieces_line(total: float, pieces: dict) -> str:
    rest = total - sum(pieces.values())
    return ", ".join(f"{k} {v:.3f}" for k, v in pieces.items()) + f", rest {rest:.3f}"


#: the host and device pieces of a coded save and restore, timed apart
SAVE_PIECES = ("_leaf_records", "_encode_digits", "_pack_uints", "_crc", "write_durable")
RESTORE_PIECES = ("_read_shard", "_crc", "_unpack_uints", "_encode_digits", "_solve_digits",
                  "_digits_to_stripe", "loaded_array", "fill_tree")


def phase_ckpt():
    """Erasure-coded checkpoints and worker-death recovery of full-width
    gc-lm-110m: save at step 2, worker 1 dies, restore from the three
    survivors, replay.  Returns the counts of this path and its timings.
    The save and the restore are split into their pieces (exclusive host
    time of ``checkpoint/coded.py``'s functions)."""
    import torch

    from repro_torch.checkpoint import CkptConfig, CodedSpec
    from repro_torch.checkpoint import coded
    from repro_torch.core import DegradedWorker

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    ckpt_dir = tempfile.mkdtemp(prefix="chip_smoke_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        trainer = make_trainer(ckpt=CkptConfig(dir=ckpt_dir, every=2,
                                               coded=CodedSpec(n_shards=4, parity=1)))
        trainer.sim.env = trainer.env.with_faults(DegradedWorker(**DEATH))
        log(f"[ckpt] trainer with CodedSpec(4, 1) every 2 steps, {DEATH}; "
            f"{time.perf_counter() - t0:.2f} s; host peak RSS {_peak_rss_gb():.2f} GB")
        manager = trainer.manager
        saved, restored = {}, {}
        spent = {"save": 0.0, "restore": 0.0, "snapshot": 0.0}
        pieces = {}
        orig_save, orig_restore = manager.save, manager.restore_from_survivors

        def snapshot(into, step, tree):
            t = time.perf_counter()
            into[step] = _snapshot(tree)
            torch.cuda.synchronize()
            spent["snapshot"] += time.perf_counter() - t

        def save(step, tree, extra=None):
            snapshot(saved, int(step), tree)
            t = time.perf_counter()
            with Pieces(coded, SAVE_PIECES) as timer:
                path = orig_save(step, tree, extra=extra)
            spent["save"] += time.perf_counter() - t
            pieces["save"] = timer.take()
            log(f"[ckpt] save at step {step}: {spent['save']:.2f} s; host peak RSS "
                f"{_peak_rss_gb():.2f} GB")
            return path

        def restore(template, missing, step=None):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with Pieces(coded, RESTORE_PIECES) as timer:
                state, at = orig_restore(template, missing, step)
                torch.cuda.synchronize()
            spent["restore"] += time.perf_counter() - t
            pieces["restore"] = timer.take()
            log(f"[ckpt] restore of step {at}: {spent['restore']:.2f} s; host peak RSS "
                f"{_peak_rss_gb():.2f} GB")
            snapshot(restored, at, state)
            return state, at

        manager.save, manager.restore_from_survivors = save, restore
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run(CKPT_STEPS, log_every=1, log_fn=lambda m: log(f"[ckpt] {m}"))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counts()
        step_dir = os.path.join(ckpt_dir, "step_00000002")
        disk = sum(os.path.getsize(os.path.join(step_dir, f)) for f in os.listdir(step_dir))
        with open(os.path.join(step_dir, "manifest.json")) as f:
            manifest = json.load(f)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)

    evs = trainer.recoveries
    if len(evs) != 1 or evs[0].dead_workers != (1,) or evs[0].ckpt_step != 2 \
            or evs[0].swap is not None:
        raise AssertionError(f"expected one recovery of worker 1 to step 2, got {evs}")
    if sorted(saved) != [2] or sorted(restored) != [2]:
        raise AssertionError(f"saves at {sorted(saved)}, restores to {sorted(restored)}")
    if not _same_bytes(restored[2], saved[2]):
        raise AssertionError("the state restored from the survivors differs from the "
                             "state saved at step 2")
    hist = trainer.history
    steps = [h["step"] for h in hist]
    if steps != [1, 2, 3, 4, 3]:
        raise AssertionError(f"step sequence {steps}, expected [1, 2, 3, 4, 3]")
    first, replay = hist[2]["loss"], hist[4]["loss"]
    if not abs(replay - first) <= 1e-6 * abs(first):
        raise AssertionError(f"replayed step 2->3 loss {replay} != {first}")
    if launches["gc_encode"] < 2 or launches["gc_fused"] != CKPT_STEPS:
        raise AssertionError(f"launches {launches}: want gc_encode >= 2 (save and "
                             "restore) and gc_fused once per step")
    for what in ("save", "restore"):
        log(f"[ckpt] {what} pieces, s: {_pieces_line(spent[what], pieces[what])}")
    log(f"[ckpt] {CKPT_STEPS} steps in {wall:.2f} s: save {spent['save']:.2f} s, "
        f"restore from survivors {spent['restore']:.2f} s, state snapshots for the "
        f"byte check {spent['snapshot']:.2f} s, training "
        f"{wall - spent['save'] - spent['restore'] - spent['snapshot']:.2f} s "
        f"(step wall_s {[round(h['wall_s'], 3) for h in hist]}); payload "
        f"{manifest['payload_bytes']} bytes, stripe {manifest['stripe_bytes']} bytes, "
        f"{disk} bytes on disk; losses {[round(h['loss'], 6) for h in hist]}, replayed "
        f"loss {replay} == {first}; restored state byte-equal to the step-2 save; "
        f"launches {launches}; host peak RSS {_peak_rss_gb():.2f} GB")
    del trainer, saved, restored
    torch.cuda.empty_cache()
    return launches, manifest["stripe_bytes"] // 2


def phase_encode(n_digits: int):
    """``gc_encode`` at the checkpoint's shapes (integer digits: exact) and
    at ragged widths; times against the memory bound."""
    import torch

    from repro_torch.kernels import gc_encode, ref

    gen = torch.Generator(device="cuda").manual_seed(7)
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0,
                  ops_ms=0.0, device_ms=0.0, host_ms=0.0)
    for k, what in ((3, "save"), (2, "restore")):
        p = torch.ones((1, k), device="cuda")  # CodedSpec(4, 1)'s parity rows
        g = torch.randint(0, 2 ** 16, (k, n_digits), device="cuda", generator=gen,
                          dtype=torch.float32)
        c = gc_encode.encode(p, g)
        if not torch.equal(c, ref.encode_ref(p, g)):
            raise AssertionError(f"gc_encode != its plain version at K={k} D={n_digits}")
        cols = slice(n_digits - 1_000_000, n_digits)  # the tail: the last blocks
        want = p.cpu().long() @ g[:, cols].cpu().long()
        if not torch.equal(c[:, cols].cpu().long(), want):
            raise AssertionError(f"gc_encode != the int64 product at K={k}")
        k_ms = time_ms(lambda: gc_encode.encode(p, g), 20)
        p_ms = time_ms(lambda: ref.encode_ref(p, g), 20)
        l_ms = time_ms(lambda: torch.matmul(p, g), 20)
        d_ms = device_ms(lambda: gc_encode.encode(p, g), 20)
        h_ms = host_ms(lambda: gc_encode.encode(p, g), 20)
        bytes_ms, ops_ms = bounds_ms((1 + k) * n_digits * 4 + k * 4, 2.0 * k * n_digits)
        bound = max(bytes_ms, ops_ms)
        log(f"[encode] {what}: NB=1 K={k} D={n_digits} integer fp32: exact (== plain, "
            f"== int64 on the last 1e6 columns); kernel_ms {k_ms:.4f} plain_ms {p_ms:.4f} "
            f"library_ms {l_ms:.4f} bound_ms {bound:.4f} share_of_bound {bound / k_ms:.3f}; "
            f"device-only ms {d_ms:.4f} (share {bound / d_ms:.3f}); wrapper host ms {h_ms:.4f}")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bound), ("bytes_ms", bytes_ms), ("ops_ms", ops_ms),
                       ("device_ms", d_ms), ("host_ms", h_ms)):
            totals[key] += v
        del g, c
    max_err = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for nb, k in ((3, 5), (12, 12)):
            for d in (1, 127, 129, 513, 1021):
                b = torch.randn((nb, k), device="cuda", generator=gen)
                g = torch.randn((k, d), device="cuda", generator=gen).to(dtype)
                y = gc_encode.encode(b, g)
                if y.dtype != dtype or tuple(y.shape) != (nb, d):
                    raise AssertionError(f"gc_encode output {y.dtype}{tuple(y.shape)}")
                max_err = max(max_err, check_close("gc_encode", y, ref.encode_ref(b, g),
                                                   name, f"NB={nb} K={k} D={d} {name}"))
    torch.cuda.synchronize()
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations"
    log(f"[encode] ragged widths agree (fp32/bf16, NB=3 K=5 and NB=K=12), max abs err "
        f"{max_err:.3e}; save + restore: " + " ".join(
            f"{k} {v:.4f}" for k, v in totals.items() if k != "bound_by"))
    return max_err, totals


def phase_decode():
    """``gc_decode`` at kernel_bench's shapes and ragged widths, then the
    coded round trip through both kernels.  Returns (counts of the round
    trip, max error, times at the round trip's full width)."""
    import numpy as np
    import torch

    from repro_torch.core.coding import decode_weights, make_code
    from repro_torch.kernels import gc_decode, gc_encode, ref

    gen = torch.Generator(device="cuda").manual_seed(11)
    max_err = 0.0
    for n, d, dtype in ((4, 2 ** 20, torch.float32), (8, 2 ** 22, torch.float32),
                        (4, 2 ** 22, torch.bfloat16)):
        name = str(dtype).split(".")[-1]
        a = torch.randn((n,), device="cuda", generator=gen)
        c = torch.randn((n, d), device="cuda", generator=gen).to(dtype)
        y = gc_decode.decode(a, c)
        max_err = max(max_err, check_close("gc_decode", y, ref.decode_ref(a, c), name,
                                           f"N={n} D={d}"))
        # the streaming loop computes the same products in the same order
        if not torch.equal(y, gc_encode.encode(a[None], c)[0]):
            raise AssertionError(f"gc_decode is not bit-equal to the streaming loop at N={n} "
                                 f"D={d} {name}")
        one = {"old": lambda: gc_encode.encode(a[None], c),
               "new": lambda: gc_decode.decode(a, c),
               "library": lambda: torch.matmul(a.to(dtype)[None], c)}
        dev = device_in_turns(one, 50)
        k_ms = time_ms(one["new"], 50)
        p_ms = time_ms(lambda: ref.decode_ref(a, c), 50)
        l_ms = time_ms(one["library"], 50)
        item = c.element_size()
        bound = max(bounds_ms((1 + n) * d * item + n * 4, 2.0 * n * d))
        log(f"[decode] N={n} D={d} {name}: bit-equal to the streaming loop; kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bound:.4f} "
            f"share_of_bound {bound / k_ms:.3f}; device-only new {_mean(dev['new']):.4f} "
            f"old {_mean(dev['old']):.4f} library {_mean(dev['library']):.4f} (turns {dev}), "
            f"share new {bound / _mean(dev['new']):.3f}; wrapper host ms new "
            f"{host_ms(one['new'], 50):.4f} old {host_ms(one['old'], 50):.4f}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for d in (1, 127, 129, 513, 1021):
            a = torch.randn((6,), device="cuda", generator=gen)
            c = torch.randn((6, d), device="cuda", generator=gen).to(dtype)
            y = gc_decode.decode(a, c)
            if y.dtype != dtype or tuple(y.shape) != (d,):
                raise AssertionError(f"gc_decode output {y.dtype}{tuple(y.shape)}")
            max_err = max(max_err, check_close("gc_decode", y, ref.decode_ref(a, c), name,
                                               f"N=6 D={d} {name}"))
        # N too wide for a ring of two stages: bit-equal to the streaming loop
        for n, d in ((100, 4096), (400, 1021)):
            a = torch.randn((n,), device="cuda", generator=gen)
            c = torch.randn((n, d), device="cuda", generator=gen).to(dtype)
            y = gc_decode.decode(a, c)
            max_err = max(max_err, check_wide("gc_decode", y, ref.decode_ref(a, c),
                                              a.to(dtype)[None], c, name, f"N={n} D={d} {name}"))
            if not torch.equal(y, gc_encode.encode(a[None], c)[0]):
                raise AssertionError(f"gc_decode at N={n} D={d} {name}: not bit-equal to the "
                                     "streaming loop")

    n, s = 6, 2
    rng = np.random.default_rng(3)
    b_mat = make_code(n, s, rng=3, prefer_fractional=False)
    widths = (257, 2 ** 22)  # a ragged width (the reference's tile_d + 129), full width
    inputs = []
    for d in widths:
        g = rng.standard_normal((n, d))
        fastest = np.setdiff1d(np.arange(n), rng.choice(n, size=s, replace=False))
        inputs.append((g, torch.tensor(decode_weights(b_mat, fastest), dtype=torch.float32,
                                       device="cuda"),
                       torch.tensor(g, dtype=torch.float32, device="cuda")))
    b = torch.tensor(b_mat, dtype=torch.float32, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    results = [gc_decode.decode(a, gc_encode.encode(b, g_dev)) for _, a, g_dev in inputs]
    torch.cuda.synchronize()
    launches = read_counts()
    for (g, _, _), y, d in zip(inputs, results, widths):
        np.testing.assert_allclose(y.cpu().numpy(), g.sum(axis=0), rtol=1e-4, atol=1e-4,
                                   err_msg=f"round trip at D={d}")
    if launches["gc_encode"] < 1 or launches["gc_decode"] < 1:
        raise AssertionError(f"round trip launches {launches}")
    g, a, g_dev = inputs[-1]
    coded = gc_encode.encode(b, g_dev)
    d = widths[-1]
    dev = device_in_turns({"old": lambda: gc_encode.encode(a[None], coded),
                           "new": lambda: gc_decode.decode(a, coded)}, 50)
    times = {"ms": time_ms(lambda: gc_decode.decode(a, coded), 50),
             "plain_ms": time_ms(lambda: ref.decode_ref(a, coded), 50),
             "library_ms": time_ms(lambda: torch.matmul(a[None], coded), 50),
             "device_ms": _mean(dev["new"]), "old_device_ms": _mean(dev["old"]),
             "host_ms": host_ms(lambda: gc_decode.decode(a, coded), 50),
             "old_host_ms": host_ms(lambda: gc_encode.encode(a[None], coded), 50)}
    bytes_ms, ops_ms = bounds_ms((1 + n) * d * 4 + n * 4, 2.0 * n * d)
    times.update(bound_ms=max(bytes_ms, ops_ms),
                 bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    log(f"[decode] kernel_bench shapes, ragged widths and N = 100, 400 agree, max abs err "
        f"{max_err:.3e}; "
        f"round trip (6, 6) cyclic code, 2 stragglers, D in {widths}: recovers g.sum(0) "
        f"(1e-4), launches {launches}; decode at N=6 D={d} fp32 (device-only in turns "
        f"old/new/new/old {dev}): "
        + " ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                   for k, v in times.items()))
    return launches, max_err, times


def teacher_forced(cfg, model, reqs, dtype, device):
    """Decode logits ``(T-1, B, V)`` on a fresh slab of ``dtype``, each row
    fed its own generated tokens, and the fp32 prefill logits of prompt +
    generated tokens at the same positions.  The requests share one
    prompt length and one token count."""
    import numpy as np
    import torch

    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve import insert_request, make_slab

    s, n = len(reqs[0].prompt), len(reqs[0].tokens)
    max_len = s + n
    outputs = torch.from_numpy(np.stack([r.output for r in reqs]).astype(np.int64)).to(device)
    slab = make_slab(cfg, len(reqs), max_len, dtype=dtype, device=device)
    for slot, r in enumerate(reqs):
        _, pref = prefill(cfg, model, outputs[slot:slot + 1, :s], target_len=max_len)
        insert_request(cfg, slab, pref, slot)
    steps = []
    for t in range(n - 1):
        logits, _ = decode_step(cfg, model, slab, outputs[:, s + t, None])
        steps.append(logits[:, -1])
    full, _ = prefill(cfg, model, outputs)
    return torch.stack(steps), full[:, s:s + n - 1].transpose(0, 1)


def _rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())


def phase_serve():
    """Full-width serving through ``ServeEngine`` and the coded tier."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.core import Env, ShiftedExponential
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.params import GCLM, count_params
    from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine
    from repro_torch.sim.arrivals import poisson_arrivals

    cfg = get_config("gc-lm-110m")
    model = GCLM(cfg, device="cuda", seed=0)
    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), SERVE["workers"])
    coded = CodedDecode.solve(env, objective="p99", seed=0)
    plan = coded.plan
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(SERVE["n_requests"], SERVE["prompt_len"]))
    arrivals = poisson_arrivals(SERVE["n_requests"], SERVE["rate"], seed=0)
    eng = ServeEngine(cfg, model, ServeConfig(n_slots=SERVE["n_slots"],
                                              max_len=SERVE["max_len"]),
                      coded=coded, device="cuda")
    reqs = [eng.submit(p, max_new=SERVE["max_new"], arrival=float(t))
            for p, t in zip(prompts, arrivals)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    served_by = {}
    n_steps, prof, step_wall, walls = 0, None, None, []
    t0 = time.perf_counter()
    while True:
        if n_steps == SERVE["profile_step"]:  # one steady engine step, profiled
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t1 = time.perf_counter()
                more = eng.step()
                torch.cuda.synchronize()
                step_wall = (time.perf_counter() - t1) * 1e3
        else:
            t1 = time.perf_counter()
            more = eng.step()  # ends in the host's read of the sampled tokens
            walls.append((time.perf_counter() - t1) * 1e3)
        if not more:
            break
        n_steps += 1
        for i, r in enumerate(reqs):
            if r.slot is not None:
                served_by.setdefault(r.slot, set()).add(i)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_tokens = sum(len(r.tokens) for r in reqs)

    if not all(r.done and len(r.tokens) == SERVE["max_new"] for r in reqs):
        raise AssertionError(f"[serve] unfinished requests: {[r.summary() for r in reqs if not r.done]}")
    if sorted(served_by) != list(range(SERVE["n_slots"])) or \
            min(len(v) for v in served_by.values()) < 2:
        raise AssertionError(f"[serve] not every slot was reused: {served_by}")
    replay = CodedDecode(env, plan, seed=0).step_latencies(len(eng.step_latencies), seed=0)
    if not np.array_equal(np.asarray(eng.step_latencies), replay):
        raise AssertionError("[serve] the engine's clock is not the coded tier's stream")
    if any(counts.values()):
        raise AssertionError(f"[serve] the coded tier launched kernels: {counts}")
    if prof is None:
        raise AssertionError(f"[serve] only {n_steps} engine steps; none was profiled")

    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    syncs = {e.key: e.count for e in prof.key_averages()
             if e.device_type == DeviceType.CPU and any(
                 w in e.key for w in ("Synchronize", "Memcpy", "_local_scalar_dense"))}
    n_kernels = sum(e.count for e in events)

    bf16_got, bf16_want = teacher_forced(cfg, model, reqs[:2], torch.bfloat16, "cuda")
    fp32_got, fp32_want = teacher_forced(cfg, model, reqs[2:3], torch.float32, "cuda")
    bf16_err, fp32_err = _rel_err(bf16_got, bf16_want), _rel_err(fp32_got, fp32_want)
    if not bf16_err <= SERVE_BF16_REL or not fp32_err <= SERVE_FP32_REL:
        raise AssertionError(f"[serve] teacher-forced logits: bf16 slab {bf16_err:.3e} "
                             f"(bound {SERVE_BF16_REL}), fp32 slab {fp32_err:.3e} "
                             f"(bound {SERVE_FP32_REL})")
    del bf16_got, bf16_want, fp32_got, fp32_want

    # prefill of one prompt and one decode step of the full slab
    n_params, s, b, cap = count_params(model), SERVE["prompt_len"], SERVE["n_slots"], \
        SERVE["max_len"]
    L, d, vocab = cfg.n_layers, cfg.d_model, cfg.vocab
    tokens = torch.from_numpy(prompts[:1]).cuda()
    slab = [{k: v.clone() for k, v in seg.items()} for seg in eng.slab]
    for seg in slab:
        seg["pos"].fill_(cap - 1)
    tok = torch.arange(1, b + 1, device="cuda")[:, None]
    kv_bytes = L * 2 * cap * cfg.n_kv_heads * cfg.head_dim
    pre = {"ms": time_ms(lambda: prefill(cfg, model, tokens, target_len=cap), 10),
           "device_ms": device_ms(lambda: prefill(cfg, model, tokens, target_len=cap), 10)}
    pre_bytes, pre_ops = bounds_ms(4 * n_params + 8 * s + 4 * s * vocab + 4 * kv_bytes,
                                   2 * n_params * s + 4 * L * d * s * (s + 1) / 2)
    dec = {"ms": time_ms(lambda: decode_step(cfg, model, slab, tok), 20),
           "device_ms": device_ms(lambda: decode_step(cfg, model, slab, tok), 20)}
    dec_bytes, dec_ops = bounds_ms(4 * n_params + 2 * b * kv_bytes + 8 * b + 4 * b * vocab,
                                   2 * n_params * b + 4 * L * d * b * cap)
    steps = np.asarray(eng.step_latencies)
    log(f"[serve] coded tier R={plan.r} s={plan.s} (work {plan.work_factor:.3f}); "
        f"{len(reqs)} requests, {n_tokens} tokens in {wall:.3f} s wall over {n_steps} engine "
        f"steps: {n_tokens / wall:.1f} tok/s (one step under the profiler included); every "
        f"request {SERVE['max_new']} tokens, slots served "
        f"{sorted(len(v) for v in served_by.values())} "
        f"requests each; step latencies == the tier's stream; gc_* launches {counts}; "
        f"max_memory_allocated {peak} bytes")
    log(f"[serve] engine step wall, host clock (ms): first {walls[0]:.3f}, median "
        f"{statistics.median(walls):.3f}, mean {statistics.mean(walls):.3f}, max "
        f"{max(walls):.3f} over {len(walls)} unprofiled steps")
    log(f"[serve] teacher forcing: bf16 slab (2 requests, {bf16_err:.3e} of the largest "
        f"logit, bound {SERVE_BF16_REL}), fp32 slab (1 request, {fp32_err:.3e}, bound "
        f"{SERVE_FP32_REL})")
    log(f"[serve] prefill S={s} B=1: incl {pre['ms']:.4f} ms, device-only "
        f"{pre['device_ms']:.4f} ms, bound {max(pre_bytes, pre_ops):.4f} ms "
        f"(operations {pre_ops:.4f}, bytes {pre_bytes:.4f}); share of bound (device-only) "
        f"{max(pre_bytes, pre_ops) / pre['device_ms']:.3f}")
    log(f"[serve] decode_step B={b} cap={cap} bf16 slab full: incl {dec['ms']:.4f} ms, "
        f"device-only {dec['device_ms']:.4f} ms, bound {max(dec_bytes, dec_ops):.4f} ms "
        f"(bytes {dec_bytes:.4f}, operations {dec_ops:.4f}); share of bound (device-only) "
        f"{max(dec_bytes, dec_ops) / dec['device_ms']:.3f}")
    log(f"[serve] one engine step under the profiler: wall {step_wall:.3f} ms, device busy "
        f"{busy_ms:.3f} ms ({busy_ms / step_wall:.1%}), {n_kernels} kernels; host syncs and "
        f"copies {syncs}")
    log(f"[serve] simulated step latency p50 {np.quantile(steps, 0.5):.3f} p99 "
        f"{np.quantile(steps, 0.99):.3f} over {steps.size} steps; tier closed form p99 "
        f"{coded.predicted_quantile(0.99):.3f}, mean {coded.predicted_mean():.3f}")


def _reference_serve(cfg, init):
    """The same weights and prompts through ``ServeEngine`` on the CPU
    (plain versions) and on the card, fp32 slab, greedy."""
    import numpy as np
    import torch

    from repro_torch.core import Env, ShiftedExponential
    from repro_torch.models.params import GCLM, params_from_numpy
    from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine

    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 8)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(6, 16))
    runs = {}
    for device in ("cpu", "cuda"):
        model = params_from_numpy(GCLM(cfg, device=device), init)
        eng = ServeEngine(cfg, model, ServeConfig(n_slots=3, max_len=32,
                                                  dtype=torch.float32),
                          coded=CodedDecode.solve(env, seed=0), device=device)
        reqs = [eng.submit(p, max_new=12, arrival=100.0 * i) for i, p in enumerate(prompts)]
        eng.run()
        got, want = teacher_forced(cfg, model, reqs, torch.float32, device)
        runs[device] = (eng, reqs, got.cpu(), want.cpu())
    (eng_c, reqs_c, got_c, want_c), (eng_g, reqs_g, got_g, want_g) = runs["cpu"], runs["cuda"]
    for rc, rg in zip(reqs_c, reqs_g, strict=True):
        if rc.tokens != rg.tokens or (rc.t_admit, rc.t_done, rc.n_steps) != \
                (rg.t_admit, rg.t_done, rg.n_steps):
            raise AssertionError(f"[reference] serve: cpu {rc.tokens} vs cuda {rg.tokens}")
    if eng_c.step_latencies != eng_g.step_latencies:
        raise AssertionError("[reference] serve: step latencies differ")
    errs = (_rel_err(got_g, got_c), _rel_err(want_g, want_c))
    if not max(errs) <= 1e-4:
        raise AssertionError(f"[reference] serve: logits differ by {errs} of the largest")
    return errs


def phase_reference():
    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.models.params import params_to_numpy
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    histories = {}
    init = None
    for device in ("cpu", "cuda"):
        tr = Trainer(cfg, TrainConfig(warmup=2, total_steps=10),
                     ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4,
                     global_batch=8, seed=0, device=device, seq_len=64,
                     params=init)
        if init is None:
            init = params_to_numpy(tr.state.params)
        tr.run(3, log_every=0)
        histories[device] = tr.history
    # fp32 sums in another order on each device, and AdamW's normalized
    # step amplifies that in near-zero gradient entries: 1e-3 relative
    for step, (h_cpu, h_gpu) in enumerate(zip(histories["cpu"], histories["cuda"])):
        for key in ("loss", "grad_norm"):
            if not abs(h_cpu[key] - h_gpu[key]) <= 1e-3 * abs(h_cpu[key]):
                raise AssertionError(f"reduced step {step} {key}: cpu {h_cpu[key]} "
                                     f"cuda {h_gpu[key]}")
    log("[reference] reduced gc-lm-110m, 3 steps from the same weights: cpu "
        "(plain versions) and cuda agree; losses "
        f"{[h['loss'] for h in histories['cpu']]} vs "
        f"{[h['loss'] for h in histories['cuda']]}")
    errs = _reference_serve(cfg, init)
    log("[reference] serving, the same weights and prompts (6 requests, 12 tokens, fp32 "
        "slab, greedy): equal tokens, timestamps and step latencies on cpu and cuda; "
        f"teacher-forced decode / prefill logits differ by {errs[0]:.3e} / {errs[1]:.3e} "
        "of the largest")


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(SRC, "repro_torch")):
        print(f"chip_smoke: the port's sources are missing ({SRC}/repro_torch); "
              "run from the root of a checkout", file=sys.stderr)
        return 2
    sys.path.insert(0, SRC)
    import repro_torch.device  # noqa: F401  (TF32 off, before any product)

    t_start = time.perf_counter()
    spent = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        spent[name] = round(time.perf_counter() - t0, 1)
        return out

    timed("device", phase_device)
    trainer = timed("setup", phase_setup)
    max_err, kernel_times = timed("kernel", phase_kernel, trainer)
    timed("exactness", phase_exactness, trainer)
    launches = timed("train", phase_train, trainer)
    train_losses = [h["loss"] for h in trainer.history]
    timed("breakdown", phase_breakdown, trainer)
    rows, level_times = timed("levels", phase_levels, trainer)
    tree_times = timed("tree", phase_tree, trainer, rows)
    del trainer, rows
    torch.cuda.empty_cache()
    adapt_launches = timed("adapt", phase_adapt)
    wave_launches = timed("wave", phase_wave)
    spmd_launches, spmd_times = timed("spmd", phase_spmd, train_losses)
    ckpt_launches, n_digits = timed("ckpt", phase_ckpt)
    enc_err, enc_times = timed("encode", phase_encode, n_digits)
    trip_launches, dec_err, dec_times = timed("decode", phase_decode)
    timed("serve", phase_serve)
    timed("reference", phase_reference)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; seconds by "
        f"phase {spent}")

    def row(name, tpu_kernel, n_launches, err, times, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": tpu_kernel, "launches": n_launches, "max_abs_err": err,
                **{k: times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "host_ms")}, **extra}

    # gc_fused's main paths: barrier training, adaptive re-planning, wave,
    # spmd (every rank's launches)
    fused_launches = {"train": launches["gc_fused"], "adapt": adapt_launches["gc_fused"],
                      "wave": wave_launches["gc_fused"], "spmd": spmd_launches}
    print(json.dumps({"kernels": [
        row("gc_fused", "src/repro/kernels/gc_fused.py:57", sum(fused_launches.values()),
            max_err, kernel_times, launches_by_path=fused_launches,
            per_level_device_ms=level_times["levels_device_ms"],
            grouped_device_ms=level_times["grouped_device_ms"],
            tree_combine_device_ms=tree_times["tree_device_ms"],
            spmd_device_ms=spmd_times["device_ms"], spmd_bound_ms=spmd_times["bound_ms"],
            spmd_library_ms=spmd_times["library_device_ms"]),
        row("gc_encode", "src/repro/kernels/gc_encode.py:56", ckpt_launches["gc_encode"],
            enc_err, enc_times),
        row("gc_decode", "src/repro/kernels/gc_decode.py:51", trip_launches["gc_decode"],
            dec_err, dec_times)]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
