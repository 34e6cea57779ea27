"""Serving launcher: continuous batching + coded decode, after
``repro/launch/serve.py``.

One-shot batch mode:

    python -m repro_torch.launch.serve --arch gc-lm-110m --batch 4 \
        --prompt-len 64 --new 16

Request-stream mode drives the ``ServeEngine`` with a Poisson arrival
stream and prices every decode step on an ``Env`` straggler model
through the coded decode tier (R replicas per step, complete at the
(R-s)-th delivery, (R, s) solved against the env):

    python -m repro_torch.launch.serve --arch gc-lm-110m --stream 16 \
        --rate 0.002 --workers 8 --budget 4 --objective p99

The straggler environment is ``Env.iid(ShiftedExponential(mu, 50), N)``
by default, or ``--env-json`` with an ``Env.to_dict()`` population file.
Weights are random (seed 0); prompts are drawn with numpy from
``--seed``.  ``--device`` defaults to ``cuda`` and fails without CUDA;
``--reduced`` shrinks the model (off by default: the reference's flag
cannot be turned off).  The port runs gc-lm-110m only; other archs are
ROADMAP 1.9.  It serves on one device: ``--data-par`` and
``--model-par`` (the reference's mesh) must stay 1.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential
from repro_torch.models.params import GCLM
from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine, fold_seed, generate
from repro_torch.sim.arrivals import poisson_arrivals


def _build_env(args) -> Env:
    if args.env_json:
        with open(args.env_json) as f:
            return Env.from_dict(json.load(f))
    return Env.iid(ShiftedExponential(mu=args.mu, t0=50.0), args.workers)


def _serve_stream(cfg, params, args) -> None:
    env = _build_env(args)
    if args.uncoded:
        coded = CodedDecode.uncoded(env, seed=args.seed)
    else:
        coded = CodedDecode.solve(env, budget=args.budget,
                                  objective=args.objective, seed=args.seed)
    plan = coded.plan
    print(f"coded decode tier: R={plan.r} s={plan.s} (complete at "
          f"{plan.need}-th delivery, per-replica work {plan.work_factor:.2f}) "
          f"objective={plan.objective}")

    eng = ServeEngine(cfg, params,
                      ServeConfig(n_slots=args.slots,
                                  max_len=args.prompt_len + args.new),
                      coded=coded, device=args.device)
    arrivals = poisson_arrivals(args.stream, args.rate, seed=args.seed)
    prompts = np.random.default_rng((args.seed, 1)).integers(
        0, cfg.vocab, size=(args.stream, args.prompt_len))
    for i, t in enumerate(arrivals):
        eng.submit(prompts[i], max_new=args.new, temperature=args.temperature,
                   seed=fold_seed(args.seed, i), arrival=float(t))
    _sync(eng.device)
    t0 = time.time()
    done = eng.run()
    _sync(eng.device)
    wall = time.time() - t0

    steps = np.asarray(eng.step_latencies)
    lats = np.asarray([r.latency for r in done])
    delays = np.asarray([r.queue_delay for r in done])
    toks = sum(len(r.tokens) for r in done)
    print(f"served {len(done)} requests / {toks} tokens in {wall:.1f}s wall "
          f"({toks / max(wall, 1e-9):.1f} tok/s), "
          f"{eng.now:.0f} simulated time units over {steps.size} decode steps")
    print(f"step latency   p50={np.quantile(steps, 0.5):.1f} "
          f"p99={np.quantile(steps, 0.99):.1f} "
          f"(env closed form p99={coded.predicted_quantile(0.99):.1f})")
    print(f"request latency p50={np.quantile(lats, 0.5):.1f} "
          f"p99={np.quantile(lats, 0.99):.1f}; "
          f"mean queue delay {delays.mean():.1f}")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gc-lm-110m")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model for a fast smoke run")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--data-par", type=int, default=1,
                    help="data-parallel serving ranks (not ported: only 1)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="tensor-parallel serving ranks (not ported: only 1)")
    ap.add_argument("--temperature", type=float, default=0.0)
    # ---- request-stream mode
    ap.add_argument("--stream", type=int, default=0,
                    help="serve N streamed requests through the "
                         "continuous-batching engine (0 = one-shot batch)")
    ap.add_argument("--rate", type=float, default=2e-3,
                    help="Poisson arrival rate, requests per simulated "
                         "time unit")
    ap.add_argument("--slots", type=int, default=4,
                    help="KV-slab slots (max concurrent requests)")
    ap.add_argument("--workers", type=int, default=8,
                    help="straggler-env population size")
    ap.add_argument("--mu", type=float, default=1e-3,
                    help="ShiftedExponential rate for the default env")
    ap.add_argument("--env-json", default="",
                    help="JSON file with an Env.to_dict() worker-population "
                         "description (overrides --workers/--mu)")
    ap.add_argument("--budget", type=int, default=None,
                    help="replica budget for the coded decode tier")
    ap.add_argument("--objective", default="p99",
                    choices=["p99", "p50", "mean"],
                    help="what the (R, s) solver minimizes")
    ap.add_argument("--uncoded", action="store_true",
                    help="force the R=1 uncoded baseline tier")
    ap.add_argument("--seed", type=int, default=0)
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.data_par != 1 or args.model_par != 1:
        raise NotImplementedError("sharded serving (--data-par/--model-par above 1) is "
                                  "not ported: the port serves on one device")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    params = GCLM(cfg, device=args.device, seed=0)
    if args.stream > 0:
        _serve_stream(cfg, params, args)
        return
    prompt = np.random.default_rng((args.seed, 1)).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len))
    _sync(params.embed.tok.device)
    t0 = time.time()
    out = generate(cfg, params, prompt, max_new=args.new,
                   temperature=args.temperature, seed=args.seed, device=args.device)
    dt = time.time() - t0
    print(f"{cfg.name}: {tuple(out.shape)} in {dt:.1f}s "
          f"({args.batch * args.new / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
