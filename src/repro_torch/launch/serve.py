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
cannot be turned off).  ``--arch`` takes gc-lm-110m (the default), the
Gemma family (gemma-2b, gemma2-27b, gemma3-27b: sliding-window layers
decode against ring caches), qwen1.5-32b, mixtral-8x22b,
deepseek-v3-671b (whose MoE capacity counts the tokens of each call: a
prompt's prefill may drop assignments, a decode step over at most 8
slots cannot; DeepSeek's MLA layers decode against a latent cache) and
jamba-v0.1-52b (whose Mamba layers decode from a fixed-size state),
xlstm-1.3b (mLSTM and sLSTM layers, a fixed-size state too),
whisper-base and llama-3.2-vision-11b.  The last two cross-attend to
stubbed modality embeddings — frames (B, 1500, 512) through Whisper's
encoder, patches (B, 1601, 7680) through the vision projector — which
batch mode draws with numpy from ``--seed`` and ``generate`` feeds to
every step; ``--stream`` refuses them, as the reference's launcher does
(the engine takes no aux inputs).  A full-width gemma3-27b (27.0 B
parameters, 108 GB in fp32) does not fit one 80 GB card, so the default
stays gc-lm-110m where the reference's is gemma3-27b.

``--data-par D --model-par M`` serve on the reference's ``(data, model)``
mesh, one process per rank under ``torchrun`` (D · M ranks): the engine's
slots split over the D data ranks, each replica's heads, MLP widths,
experts and vocabulary over its M model ranks; each rank draws only its
shards (``params.init_shards``, the one-rank launcher's weights cut), and
rank 0 alone prints.  ``--backend`` defaults from the device (``nccl``,
one card per rank; ``gloo`` on the CPU, or to rehearse several ranks on
one card).  The model axis takes every family: the dense ones
(gc-lm-110m, Gemma, Qwen 1.5), mixtral-8x22b (its experts split by
their FFN width, as the reference splits them; a MoE layer counts its
capacity over every data rank's slots), deepseek-v3-671b (MLA's heads
split, the latent cache whole on every rank), jamba-v0.1-52b (the Mamba
mixers' channels and their state split), xlstm-1.3b (the mLSTM's and
the sLSTM's heads and their state split) and the cross-attention
families (Whisper's encoder and decoder heads, Llama-3.2-vision's; the
source whole on every rank), which batch mode serves through
``generate(aux_inputs=)``, every row on every rank:

    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --reduced \
        --device cpu --data-par 2 --model-par 2 --stream 8
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch mixtral-8x22b \
        --reduced --device cpu --data-par 2 --model-par 2 --stream 8
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch jamba-v0.1-52b \
        --reduced --device cpu --data-par 2 --model-par 2 --stream 8
    torchrun --nproc-per-node 4 -m repro_torch.launch.serve --arch xlstm-1.3b \
        --reduced --device cpu --data-par 2 --model-par 2 --stream 8
    torchrun --nproc-per-node 2 -m repro_torch.launch.serve --arch whisper-base \
        --reduced --device cpu --model-par 2

    python -m repro_torch.launch.serve --arch gemma3-27b --reduced --device cpu
    python -m repro_torch.launch.serve --arch mixtral-8x22b --reduced --device cpu
    python -m repro_torch.launch.serve --arch deepseek-v3-671b --reduced --device cpu
    python -m repro_torch.launch.serve --arch jamba-v0.1-52b --reduced --device cpu
    python -m repro_torch.launch.serve --arch xlstm-1.3b --reduced --device cpu
    python -m repro_torch.launch.serve --arch whisper-base --reduced --device cpu
    python -m repro_torch.launch.serve --arch llama-3.2-vision-11b --reduced --device cpu
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential
from repro_torch.dist.mesh import meta_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, init_shards, shard_blocks
from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine, fold_seed, generate
from repro_torch.sim.arrivals import poisson_arrivals


def _build_env(args) -> Env:
    if args.env_json:
        with open(args.env_json) as f:
            return Env.from_dict(json.load(f))
    return Env.iid(ShiftedExponential(mu=args.mu, t0=50.0), args.workers)


def _serve_stream(cfg, params, args, mesh, log) -> None:
    env = _build_env(args)
    if args.uncoded:
        coded = CodedDecode.uncoded(env, seed=args.seed)
    else:
        coded = CodedDecode.solve(env, budget=args.budget,
                                  objective=args.objective, seed=args.seed)
    plan = coded.plan
    log(f"coded decode tier: R={plan.r} s={plan.s} (complete at "
          f"{plan.need}-th delivery, per-replica work {plan.work_factor:.2f}) "
          f"objective={plan.objective}")

    eng = ServeEngine(cfg, params,
                      ServeConfig(n_slots=args.slots,
                                  max_len=args.prompt_len + args.new),
                      coded=coded, device=args.device, mesh=mesh)
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
    log(f"served {len(done)} requests / {toks} tokens in {wall:.1f}s wall "
          f"({toks / max(wall, 1e-9):.1f} tok/s), "
          f"{eng.now:.0f} simulated time units over {steps.size} decode steps")
    log(f"step latency   p50={np.quantile(steps, 0.5):.1f} "
          f"p99={np.quantile(steps, 0.99):.1f} "
          f"(env closed form p99={coded.predicted_quantile(0.99):.1f})")
    log(f"request latency p50={np.quantile(lats, 0.5):.1f} "
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
                    help="data-parallel serving ranks: the slots split over them "
                         "(under torchrun)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="tensor-parallel ranks per replica: heads, MLP widths and "
                         "vocabulary split over them (under torchrun)")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend: nccl or gloo (default: nccl on "
                         "CUDA, gloo on the CPU)")
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
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.stream > 0 and (cfg.vision is not None or cfg.encoder is not None):
        raise SystemExit("--stream serves text-only configs (the engine does not take "
                         "aux_inputs)")
    if args.model_par > 1:  # a fused leaf whose blocks do not split raises here
        shard_blocks(cfg, meta_mesh(args.data_par, model=args.model_par))
    mesh = None
    if args.data_par > 1 or args.model_par > 1:
        mesh = make_local_mesh(args.data_par, args.model_par, device=args.device,
                               backend=args.backend)
    try:
        _serve(cfg, args, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _serve(cfg, args, mesh) -> None:
    log = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    params = (GCLM(cfg, device=args.device, seed=0) if mesh is None
              else init_shards(cfg, mesh, device=mesh.device, seed=0))
    if args.stream > 0:
        _serve_stream(cfg, params, args, mesh, log)
        return
    prompt = np.random.default_rng((args.seed, 1)).integers(
        0, cfg.vocab, size=(args.batch, args.prompt_len))
    aux = None
    if cfg.vision is not None:
        aux = np.random.default_rng((args.seed, 2)).standard_normal(
            (args.batch, cfg.vision.n_patches, cfg.vision.d_vision), dtype=np.float32)
    if cfg.encoder is not None:
        aux = np.random.default_rng((args.seed, 3)).standard_normal(
            (args.batch, cfg.encoder.n_frames, cfg.d_model), dtype=np.float32)
    _sync(params.embed.tok.device)
    t0 = time.time()
    out = generate(cfg, params, prompt, max_new=args.new, temperature=args.temperature,
                   seed=args.seed, aux_inputs=aux, device=args.device, mesh=mesh)
    dt = time.time() - t0
    log(f"{cfg.name}: {tuple(out.shape)} in {dt:.1f}s "
        f"({args.batch * args.new / dt:.1f} tok/s)")


if __name__ == "__main__":
    main()
