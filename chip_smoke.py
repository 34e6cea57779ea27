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
10. reference: three steps at a reduced size on the CPU (the plain
   versions) and on the card, from the same weights, agree.

The line before the last is the card's name and power limit; before it
a JSON line lists every kernel with its launches, error and times; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

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
#: worker 1 dies (1000x slower from round 0): with seed 0 the DeathWatch
#: (factor 20, 4 rounds) trips after the 4th step (found on the CPU with
#: the port's PlanSimulator and DeathWatch alone)
DEATH = dict(worker=1, factor=1000.0, from_round=0)
CKPT_STEPS = 5


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


def make_trainer(ckpt=None):
    """Full-width gc-lm-110m in a ``Trainer`` on the card (seed 0)."""
    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("gc-lm-110m").replace(max_seq=512)
    return Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                   ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4,
                   scheme="xf", global_batch=8, seed=0, device="cuda",
                   seq_len=256, ckpt=ckpt)


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


def phase_exactness(trainer):
    import numpy as np
    import torch

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn

    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    g_ref = uncoded_grad_fn(trainer.cfg, n)(model, shards)
    coded = make_coded_grad_fn(trainer.cfg, plan)
    for u in (0, plan.s_max):
        times = np.ones(n)
        times[:u] = 1e6  # u realized stragglers
        dec_w = plan.decode_weights(times).astype(np.float32)
        worst = 0.0
        for path, gc, gu in zip(model.leaf_paths(), coded(model, wb, dec_w), g_ref):
            rel = ((gc - gu).abs().max() / gu.abs().max().clamp_min(1e-30)).item()
            if not rel <= EXACT_RTOL:
                raise AssertionError(f"coded != uncoded at {path}, {u} stragglers: "
                                     f"relative max error {rel:.3e}")
            worst = max(worst, rel)
        log(f"[exactness] {u} stragglers: coded == uncoded, worst leaf relative "
            f"max error {worst:.3e} (bound {EXACT_RTOL})")
    del g_ref
    torch.cuda.synchronize()


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
    phase_device()
    trainer = phase_setup()
    max_err, kernel_times = phase_kernel(trainer)
    phase_exactness(trainer)
    launches = phase_train(trainer)
    phase_breakdown(trainer)
    del trainer
    torch.cuda.empty_cache()
    ckpt_launches, n_digits = phase_ckpt()
    enc_err, enc_times = phase_encode(n_digits)
    trip_launches, dec_err, dec_times = phase_decode()
    phase_reference()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")

    def row(name, tpu_kernel, n_launches, err, times):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": tpu_kernel, "launches": n_launches, "max_abs_err": err,
                **{k: times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "host_ms")}}

    print(json.dumps({"kernels": [
        row("gc_fused", "src/repro/kernels/gc_fused.py:57", launches["gc_fused"],
            max_err, kernel_times),
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
