"""Coded training of an LM on one device, the port's ``examples/train_lm.py``:

    python -m repro_torch.launch.train --arch gc-lm-110m --steps 300 \
        --workers 4 --scheme xf --seq 256 --global-batch 8

Runs ``Trainer.run`` (barrier loop, sim mode, the fused ``gc_fused``
combine on CUDA) and prints the loss and the simulated-runtime ledger
(tau_coded vs the wait-for-slowest tau_uncoded).  ``--device`` defaults
to ``cuda`` and fails without CUDA; pass ``--device cpu`` to run the
plain versions on the CPU.

``--ckpt DIR`` checkpoints under DIR (every ``--ckpt-every`` steps, and
once when training ends) and resumes from the newest intact checkpoint
there, training on up to ``--steps`` in all; ``--ckpt-coded S``
erasure-codes each checkpoint across the workers with S parity shards
(parity through the ``gc_encode`` kernel on CUDA).

The worker population is ``Env.iid(ShiftedExponential(mu, t0), workers)``
by default; ``--env FILE`` loads a full one (heterogeneous per-worker
distributions, degradations) from an ``Env.to_dict()`` JSON file and
sets the worker count.  ``--adapt`` re-plans under drift: the realized
per-worker times feed an ``AdaptiveController`` (window
``--adapt-window`` rounds) that hot-swaps the plan when re-planning pays.
"""
from __future__ import annotations

import argparse
import json
import time

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential, available_schemes, get_scheme
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
    ap.add_argument("--env", default="",
                    help="JSON file with an Env.to_dict() worker-population "
                         "model (overrides --mu/--t0/--workers)")
    ap.add_argument("--adapt", action="store_true",
                    help="adaptive re-planning: monitor the realized per-worker "
                         "completion times, re-solve and hot-swap the plan on drift")
    ap.add_argument("--adapt-window", type=int, default=128,
                    help="sliding-window rounds of the runtime monitor")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model for a fast smoke run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt", default="", help="checkpoint directory")
    ap.add_argument("--ckpt-every", type=int, default=0,
                    help="checkpoint every N steps (0: once, after training "
                         "ends); resumes from the newest intact checkpoint "
                         "under --ckpt on startup")
    ap.add_argument("--ckpt-coded", type=int, default=0, metavar="S",
                    help="erasure-code checkpoints across the workers with S "
                         "parity shards (any workers-S survivors restore "
                         "bit-exactly; 0: monolithic npz)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.scheme = get_scheme(args.scheme).name
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    cfg = cfg.replace(max_seq=args.seq * 2)
    if args.env:
        with open(args.env) as f:
            env = Env.from_dict(json.load(f))
        args.workers = env.n_workers
    else:
        env = Env.iid(ShiftedExponential(mu=args.mu, t0=args.t0), args.workers)
    cfg_t = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 10),
                        total_steps=args.steps)
    ckpt = None
    if args.ckpt:
        spec = CodedSpec(n_shards=args.workers, parity=args.ckpt_coded) \
            if args.ckpt_coded else None
        ckpt = CkptConfig(dir=args.ckpt, every=args.ckpt_every, coded=spec)
    adapt = AdaptConfig(window=args.adapt_window) if args.adapt else None
    trainer = Trainer(cfg, cfg_t, env, scheme=args.scheme,
                      global_batch=args.global_batch, seed=0, device=args.device,
                      seq_len=args.seq, ckpt=ckpt, adapt=adapt)
    if trainer.manager is not None and trainer.manager.latest() is not None:
        print(f"resumed from checkpoint step {trainer.state.step} under {args.ckpt}")
    print(f"arch={cfg.name} params={count_params(trainer.state.params) / 1e6:.1f}M "
          f"workers={args.workers} scheme={args.scheme} s_max={trainer.plan.s_max} "
          f"x={trainer.plan.x.tolist()} device={args.device} adapt={args.adapt}")
    t0 = time.time()
    _, summary = trainer.run(max(args.steps - trainer.state.step, 0),
                             log_every=args.log_every)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        print(f"wall {time.time() - t0:.1f}s  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    print(f"simulated runtime: {summary}")
    if trainer.controller is not None:
        print(f"adaptive: {len(trainer.controller.swaps)} plan swap(s), "
              f"{trainer.controller.checks} drift check(s)")
    manager = trainer.manager
    if manager is not None and manager.last_saved != trainer.state.step:
        print("saved:", manager.save(trainer.state.step, trainer.state,
                                     extra={"plan": trainer.plan.to_dict()}))
    return trainer


if __name__ == "__main__":
    main()
