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
3. kernel: ``gc_fused`` against its plain version (``kernels/ref.py``)
   at the main path's shapes (NB = 1, K = N·(s_max+1), every leaf
   width, fp32), at ragged widths in fp32 and bf16, and at an spmd-like
   NB = 3, K = 4; times of the kernel, the plain version, one
   ``torch.matmul`` and the memory bound at the main-path shapes.
4. exactness: at step 0 the coded gradient equals the port's uncoded
   data-parallel gradient, with 0 and with s_max stragglers.
5. train: ``Trainer.run`` for 3 steps with every launch count set to 0
   just before; each kernel must have launched on this path (gc_fused:
   one launch per leaf per step), and the loss must be finite.
6. breakdown: the time of each piece of one step (forward+backward,
   the per-shard rows, the combine, the update), host clock around
   synchronized calls, and one coded-gradient call under
   ``torch.profiler`` (device time by kernel, device busy share).
7. reference: three steps at a reduced size on the CPU (the plain
   versions) and on the card, from the same weights, agree.

The line before the last is the card's name and power limit; before it
a JSON line lists every kernel with its launches, error and times; the
last line is ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
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


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int) -> float:
    """Median device time of one call, by CUDA events, after warm-up."""
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


def check_close(got, want, dtype_name: str, what: str) -> float:
    import torch

    tol = TOL[dtype_name]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bad = err > tol["atol"] + tol["rtol"] * w.abs()
    if bool(bad.any()) or not bool(torch.isfinite(g).all()):
        raise AssertionError(f"gc_fused disagrees with its plain version at {what}: "
                             f"max abs err {err.max().item():.3e}")
    return err.max().item()


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


def phase_setup():
    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = get_config("gc-lm-110m").replace(max_seq=512)
    t0 = time.perf_counter()
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4,
                      scheme="xf", global_batch=8, seed=0, device="cuda",
                      seq_len=256)
    plan = trainer.plan
    n_params = sum(t.numel() for t in trainer.state.params.leaves())
    log(f"[setup] gc-lm-110m: {n_params} params in {len(plan.flat_layout.leaf_shapes)} "
        f"leaves, x={plan.x.tolist()}, leaf levels {plan.leaf_levels.tolist()}, "
        f"s_max={plan.s_max}, N*K={plan.n_workers * plan.k_shards}; "
        f"{time.perf_counter() - t0:.2f} s")
    return trainer


def phase_kernel(trainer):
    import torch

    from repro_torch.kernels import gc_fused, ref

    plan = trainer.plan
    layout = plan.flat_layout
    nk = plan.n_workers * plan.k_shards
    gen = torch.Generator(device="cuda").manual_seed(1234)
    widths = {}
    for j in range(layout.n_leaves):
        d = layout.leaf_size(j)
        widths[d] = widths.get(d, 0) + 1
    max_err = 0.0
    totals = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0,
                  bytes_ms=0.0, ops_ms=0.0)
    for d, count in sorted(widths.items()):
        a = torch.full((1,), 1.0 / plan.n_workers, device="cuda")
        b = torch.randn((1, nk), device="cuda", generator=gen)
        g = torch.randn((nk, d), device="cuda", generator=gen)
        max_err = max(max_err, check_close(gc_fused.encode_decode(a, b, g),
                                           ref.encode_decode_ref(a, b, g),
                                           "float32", f"NB=1 K={nk} D={d}"))
        w = (a[:, None] * b).contiguous()
        reps = 20 if d > 10**6 else 200
        k_ms = time_ms(lambda: gc_fused.encode_decode(a, b, g), reps)
        p_ms = time_ms(lambda: ref.encode_decode_ref(a, b, g), reps)
        l_ms = time_ms(lambda: torch.matmul(w, g), reps)
        # each input read once, the output written once; one multiply-add
        # per element of G
        bytes_ms = ((1 + nk) * d * 4 + (nk + 1) * 4) / HBM_BYTES_PER_S * 1e3
        ops_ms = 2.0 * nk * d / FP32_FLOPS * 1e3
        bound = max(bytes_ms, ops_ms)
        log(f"[kernel] NB=1 K={nk} D={d} fp32 x{count}/step: kernel_ms {k_ms:.4f} "
            f"plain_ms {p_ms:.4f} library_ms {l_ms:.4f} bound_ms {bound:.4f} "
            f"share_of_bound {bound / k_ms:.3f}")
        for key, v in (("ms", k_ms), ("plain_ms", p_ms), ("library_ms", l_ms),
                       ("bound_ms", bound), ("bytes_ms", bytes_ms),
                       ("ops_ms", ops_ms)):
            totals[key] += count * v
        del g
    # ragged widths (scalar path) and an spmd-like NB=3, K=4
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for nb, k in ((1, nk), (3, 4)):
            for d in (1, 127, 129, 513, 1021):
                a = torch.randn((nb,), device="cuda", generator=gen)
                b = torch.randn((nb, k), device="cuda", generator=gen)
                g = torch.randn((k, d), device="cuda", generator=gen).to(dtype)
                y = gc_fused.encode_decode(a, b, g)
                if y.dtype != dtype or tuple(y.shape) != (nb, d):
                    raise AssertionError(f"gc_fused output {y.dtype}{tuple(y.shape)}")
                max_err = max(max_err, check_close(y, ref.encode_decode_ref(a, b, g),
                                                   name, f"NB={nb} K={k} D={d} {name}"))
    torch.cuda.synchronize()
    log(f"[kernel] gc_fused agrees with its plain version at every shape; "
        f"max abs err {max_err:.3e}; per step ({layout.n_leaves} launches): "
        + " ".join(f"{k} {v:.4f}" for k, v in totals.items()))
    totals["bound_by"] = "bytes" if totals["bytes_ms"] >= totals["ops_ms"] else "operations"
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

    from repro_torch.kernels import gc_fused

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gc_fused.launches = 0
    trainer.run(STEPS, log_every=1, log_fn=lambda s: log(f"[train] {s}"))
    torch.cuda.synchronize()
    launches = {"gc_fused": gc_fused.launches}
    n_leaves = trainer.plan.flat_layout.n_leaves
    if launches["gc_fused"] != n_leaves * STEPS:
        raise AssertionError(f"gc_fused launched {launches['gc_fused']} times in "
                             f"{STEPS} steps, expected {n_leaves} per step")
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
        f"combine (11 launches) {parts['combine']:.2f} ms; coded grads in all "
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
    phase_reference()
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "gc_fused", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/gc_fused.cu",
        "replaces": "src/repro/kernels/gc_fused.py:57",
        "launches": launches["gc_fused"], "max_abs_err": max_err,
        "ms": kernel_times["ms"], "plain_ms": kernel_times["plain_ms"],
        "bound_ms": kernel_times["bound_ms"], "bound_by": kernel_times["bound_by"],
        "library_ms": kernel_times["library_ms"]}]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
