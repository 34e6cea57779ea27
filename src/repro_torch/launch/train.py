"""Coded training of an LM on one device, the port's ``examples/train_lm.py``:

    python -m repro_torch.launch.train --arch gc-lm-110m --steps 300 \
        --workers 4 --scheme xf --seq 256 --global-batch 8

Runs ``Trainer.run`` (barrier loop, sim mode, the fused ``gc_fused``
combine on CUDA) and prints the loss and the simulated-runtime ledger
(tau_coded vs the wait-for-slowest tau_uncoded).  ``--device`` defaults
to ``cuda`` and fails without CUDA; pass ``--device cpu`` to run the
plain versions on the CPU.
"""
from __future__ import annotations

import argparse
import time

from repro_torch.configs import get_config
from repro_torch.core import ShiftedExponential, available_schemes, get_scheme
from repro_torch.models.params import count_params
from repro_torch.train.trainer import TrainConfig, Trainer


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gc-lm-110m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--scheme", "--solver", dest="scheme", default="xf",
                    metavar="SCHEME",
                    help="scheme name or alias; one of " + ", ".join(available_schemes()))
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--mu", type=float, default=1e-3)
    ap.add_argument("--t0", type=float, default=50.0)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model for a fast smoke run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=10)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.scheme = get_scheme(args.scheme).name
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    cfg = cfg.replace(max_seq=args.seq * 2)
    dist = ShiftedExponential(mu=args.mu, t0=args.t0)
    cfg_t = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 10),
                        total_steps=args.steps)
    trainer = Trainer(cfg, cfg_t, dist, n_workers=args.workers,
                      scheme=args.scheme, global_batch=args.global_batch,
                      seed=0, device=args.device, seq_len=args.seq)
    print(f"arch={cfg.name} params={count_params(trainer.state.params) / 1e6:.1f}M "
          f"workers={args.workers} scheme={args.scheme} s_max={trainer.plan.s_max} "
          f"x={trainer.plan.x.tolist()} device={args.device}")
    t0 = time.time()
    _, summary = trainer.run(args.steps, log_every=args.log_every)
    losses = [h["loss"] for h in trainer.history]
    print(f"wall {time.time() - t0:.1f}s  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"simulated runtime: {summary}")
    return trainer


if __name__ == "__main__":
    main()
