#!/usr/bin/env python3
"""How to read a coded-gradient call's device kernels out of ``torch.profiler``.

    python3 scripts/profiler_tables.py      # from the root of a checkout, on a CUDA card

``chip_smoke.py``'s [breakdown] profiles one coded-gradient call of
full-width gc-lm-110m (its phase 2 trainer) and prints the device time by
kernel.  This script profiles that call three ways and prints, for each,
how long the table took to read and what it holds:

1. CPU and CUDA activities, read by ``key_averages()`` (which first parses
   every CPU op of the call into a tree);
2. the same profile read by ``chip_smoke._device_kernels`` (the raw device
   events, summed by name): it must give the same kinds, counts and times;
3. CUDA activity alone, read by ``key_averages()``.

Exits 1 if 1 and 2 differ.
"""
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]


def _averaged(prof) -> list:
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0),
                  key=lambda x: -x[1])


def _line(how: str, table: list, read_s: float) -> str:
    busy = sum(us for _, us, _ in table) / 1e3
    return (f"[profiler-tables] {how}: read in {read_s:.2f} s; {len(table)} kinds, "
            f"{sum(n for _, _, n in table)} launches, busy {busy:.4f} ms")


def main() -> int:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke as cs
    import repro_torch.device  # noqa: F401  (TF32 off, as chip_smoke.py has it)
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.train.coded import make_coded_grad_fn

    trainer = cs.phase_setup()
    cfg, plan, model = trainer.cfg, trainer.plan, trainer.state.params
    wb = coded_worker_batches(trainer.data, 0, trainer.n_workers, plan.s_max)
    dec_w = plan.decode_weights(np.arange(trainer.n_workers)).astype(np.float32)
    grad_fn = make_coded_grad_fn(cfg, plan)
    grad_fn(model, wb, dec_w)
    torch.cuda.synchronize()

    def profiled(activities):
        with profile(activities=activities) as prof:
            grad_fn(model, wb, dec_w)
            torch.cuda.synchronize()
        return prof

    prof = profiled([ProfilerActivity.CPU, ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    raw = cs._device_kernels(prof)
    t1 = time.perf_counter()
    averaged = _averaged(prof)
    t2 = time.perf_counter()
    print(_line("CPU+CUDA, key_averages()", averaged, t2 - t1), flush=True)
    print(_line("CPU+CUDA, _device_kernels", raw, t1 - t0), flush=True)
    a = {k: (round(us, 3), n) for k, us, n in raw}
    b = {k: (round(us, 3), n) for k, us, n in averaged}
    differ = {k: (a.get(k), b.get(k)) for k in a.keys() | b.keys() if a.get(k) != b.get(k)}
    print(f"[profiler-tables] entries that differ (name: raw, averaged; us to 1e-3): "
          f"{len(differ)} {list(differ.items())[:4]}", flush=True)

    prof = profiled([ProfilerActivity.CUDA])
    t0 = time.perf_counter()
    alone = _averaged(prof)
    print(_line("CUDA alone, key_averages()", alone, time.perf_counter() - t0), flush=True)
    return 1 if differ else 0


if __name__ == "__main__":
    sys.exit(main())
