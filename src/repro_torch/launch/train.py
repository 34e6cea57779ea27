"""Coded training of an LM on one device, the port's ``examples/train_lm.py``:

    python -m repro_torch.launch.train --arch gc-lm-110m --steps 300 \
        --workers 4 --scheme xf --seq 256 --global-batch 8

``--arch`` takes gc-lm-110m, the Gemma family (gemma-2b, gemma2-27b,
gemma3-27b), qwen1.5-32b (QKV biases, an untied head), mixtral-8x22b
(mixture-of-experts FFNs, whose load-balance loss joins the training
loss), deepseek-v3-671b (MLA, whose multi-token prediction loss joins
it too), jamba-v0.1-52b (Mamba mixers) and xlstm-1.3b (mLSTM and sLSTM
mixers, no FFN sublayers); whisper-base and llama-3.2-vision-11b, whose
layers cross-attend to modality embeddings the loop does not feed,
are refused (``make_coded_train_step`` takes their ``worker_aux``);
``--reduced`` cuts the config
to 2 layers of width 128.  Sim mode holds N·K fp32 rows of every
parameter, so Qwen, Mixtral, DeepSeek, Jamba and xLSTM train on one card only
reduced: one full-width layer of Qwen or Mixtral, with its embedding and
head, is 2.1-2.9 B parameters, one DeepSeek MoE layer 11.5 B, one Jamba
MoE layer 2.82 B, and xLSTM's 48 layers take 16 rows of 7.67 GB
(ROADMAP 3.14).  Runs ``Trainer.run`` (barrier loop, sim mode, the fused ``gc_fused``
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

``--autotune`` (or ``--scheme auto``) searches scheme x redundancy cap x
pipeline x reduce mode x gradient dtype with ``repro_torch.tune``, under
a per-worker memory cap of ``--hbm-gb`` GiB when it is given (which
implies ``--autotune``), and prints the reference launcher's
``autotune: ...`` line, the ranked table and the selected candidate:

    python -m repro_torch.launch.train --autotune --hbm-gb 3 --steps 3

spmd: ``--data-par N`` equal to ``--workers`` trains the N workers as N
data-parallel ranks over ``torch.distributed``, one process each, with
the rank and world from ``torchrun``'s environment:

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --data-par 4

``--backend`` defaults from the device (``nccl`` on CUDA, one card per
rank; ``gloo`` on the CPU; ``--backend gloo`` rehearses several ranks on
one card).  Only rank 0 prints.  ``--model-par M`` splits each worker
over M tensor-parallel ranks (the ``model`` axis: attention, MLA and
xLSTM heads, MLP widths, Mamba channels, a MoE's experts and the vocabulary,
``repro_torch.dist.sharding``), so the job runs ``--data-par · M``
ranks:

    torchrun --nproc-per-node 8 -m repro_torch.launch.train --data-par 4 \
        --model-par 2 --backend gloo
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch xlstm-1.3b \
        --reduced --workers 2 --data-par 2 --model-par 2 --device cpu --backend gloo

The model axis takes the dense families (gc-lm-110m, Gemma, Qwen 1.5),
mixtral-8x22b (its experts split where the reference's rule splits
them: by their FFN width at the published ``shard_experts=False``, and
``--reduced``'s width of 341 stays whole at model 2), deepseek-v3-671b
(MLA's heads and its multi-token prediction module), jamba-v0.1-52b
(the Mamba mixers' channels) and xlstm-1.3b (the mLSTM's and the
sLSTM's heads); the cross-attention families train on the axis through
``make_coded_grad_fn``/``Trainer.step_fn`` with ``worker_aux``, which
this launcher does not feed (it refuses them, as the reference's does).
Every option of one process runs on the axis: ``--ckpt`` and ``--ckpt-coded`` (the
checkpoint is the full tree, saved from rank 0's model group and restored by rank 0's
broadcast of each leaf, so a run resumes from a checkpoint written at
any ``--model-par``), ``--adapt``, ``--autotune`` and ``--hbm-gb``.  On
the CPU, in a fresh directory (a run resumes from whatever checkpoint
the directory holds):

    rm -rf build/ck_tp
    torchrun --nproc-per-node 4 -m repro_torch.launch.train --reduced \
        --workers 2 --data-par 2 --model-par 2 --device cpu --backend gloo \
        --ckpt build/ck_tp --ckpt-coded 1 --adapt

``--uncoded`` trains the plain data-parallel step instead of the coded
one.
"""
from __future__ import annotations

import argparse
import json
import time

import torch.distributed as dist

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential, available_schemes, get_scheme
from repro_torch.data.pipeline import DataConfig, SyntheticTokens
from repro_torch.dist.mesh import meta_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import has_source
from repro_torch.models.params import GCLM, count_params, shard_blocks
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_train_step
from repro_torch.tune import MemBudget


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gc-lm-110m")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--scheme", "--solver", dest="scheme", default="xf",
                    metavar="SCHEME",
                    help="scheme name or alias; one of " + ", ".join(available_schemes())
                    + "; or 'auto' to search the launch space (repro_torch.tune)")
    ap.add_argument("--autotune", action="store_true", help="shorthand for --scheme auto")
    ap.add_argument("--hbm-gb", type=float, default=0.0,
                    help="per-worker memory cap in GiB for the autotuner "
                         "(0: uncapped); implies --autotune")
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
    ap.add_argument("--data-par", type=int, default=1,
                    help="data-parallel ranks: 1 (sim mode, one process) or --workers "
                         "(spmd, one rank per worker, under torchrun)")
    ap.add_argument("--model-par", type=int, default=1,
                    help="tensor-parallel ranks per worker (the model axis; spmd only)")
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend of spmd: nccl or gloo (default: "
                         "nccl on CUDA, gloo on the CPU)")
    ap.add_argument("--uncoded", action="store_true",
                    help="train the plain data-parallel step instead of the coded one")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.autotune or args.hbm_gb or args.scheme == "auto":
        args.scheme = "auto"
    else:
        args.scheme = get_scheme(args.scheme).name
    cfg = get_config(args.arch)
    if has_source(cfg):
        raise SystemExit(f"{cfg.name} cross-attends to a source, and the launcher's "
                         "Trainer.run feeds tokens only (as the reference's does): drive "
                         "make_coded_train_step with worker_aux instead")
    if args.reduced:
        cfg = cfg.reduced(n_layers=2, d_model=128)
    cfg = cfg.replace(max_seq=args.seq * 2)
    if args.env:
        with open(args.env) as f:
            env = Env.from_dict(json.load(f))
        args.workers = env.n_workers
    else:
        env = Env.iid(ShiftedExponential(mu=args.mu, t0=args.t0), args.workers)
    if args.data_par not in (1, args.workers):
        raise ValueError(f"--data-par {args.data_par}: 1 (sim mode) or --workers "
                         f"{args.workers} (spmd, one rank per worker)")
    if args.model_par > 1 and args.data_par == 1 and not args.uncoded:
        raise ValueError(f"--model-par {args.model_par} splits spmd workers: pass "
                         f"--data-par {args.workers}")
    if args.model_par > 1:  # a fused leaf whose blocks do not split raises here
        shard_blocks(cfg, meta_mesh(args.data_par, model=args.model_par))
    mesh = None
    if args.data_par > 1 or args.model_par > 1:
        mesh = make_local_mesh(args.data_par, args.model_par, device=args.device,
                               backend=args.backend)
    try:
        return _train(args, cfg, env, mesh)
    finally:
        if mesh is not None:
            dist.destroy_process_group()


def _train(args, cfg, env, mesh):
    log = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    cfg_t = TrainConfig(lr=args.lr, warmup=max(args.steps // 10, 10),
                        total_steps=args.steps)
    if args.uncoded:
        return _train_uncoded(args, cfg, cfg_t, mesh, log)
    ckpt = None
    if args.ckpt:
        spec = CodedSpec(n_shards=args.workers, parity=args.ckpt_coded) \
            if args.ckpt_coded else None
        ckpt = CkptConfig(dir=args.ckpt, every=args.ckpt_every, coded=spec)
    adapt = AdaptConfig(window=args.adapt_window) if args.adapt else None
    budget = MemBudget.from_gb(args.hbm_gb) if args.hbm_gb else None
    trainer = Trainer(cfg, cfg_t, env, scheme=args.scheme,
                      global_batch=args.global_batch, seed=0, device=args.device,
                      seq_len=args.seq, ckpt=ckpt, adapt=adapt, mesh=mesh,
                      mode="sim" if mesh is None else "spmd", budget=budget)
    report = trainer.tune_report
    if report is not None:
        log(f"autotune: {len(report.candidates)} admissible, {len(report.pruned)} pruned "
            f"(budget {budget or 'uncapped'})")
        log(report.table())
        log(f"selected {report.best.label()}")
    if trainer.manager is not None and trainer.manager.latest() is not None:
        log(f"resumed from checkpoint step {trainer.state.step} under {args.ckpt}")
    log(f"arch={cfg.name} params={count_params(GCLM(cfg, device='meta')) / 1e6:.1f}M "
        f"workers={args.workers} scheme={trainer.plan.scheme} s_max={trainer.plan.s_max} "
        f"x={trainer.plan.x.tolist()} device={args.device} adapt={args.adapt} "
        f"mode={trainer.mode} model_par={args.model_par}")
    t0 = time.time()
    _, summary = trainer.run(max(args.steps - trainer.state.step, 0),
                             log_every=args.log_every, log_fn=log)
    losses = [h["loss"] for h in trainer.history]
    if losses:
        log(f"wall {time.time() - t0:.1f}s  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    log(f"simulated runtime: {summary}")
    if trainer.controller is not None:
        log(f"adaptive: {len(trainer.controller.swaps)} plan swap(s), "
            f"{trainer.controller.checks} drift check(s)")
    manager = trainer.manager
    if manager is not None and manager.last_saved != trainer.state.step:
        log("saved:", trainer.save_checkpoint())
    return trainer


def _train_uncoded(args, cfg, cfg_t, mesh, log):
    """The plain data-parallel baseline: ``make_train_step`` on each
    step's global batch (in spmd each rank takes its rows)."""
    if args.ckpt or args.adapt:
        raise ValueError("--uncoded trains without --ckpt and --adapt")
    state = init_train_state(cfg, device=args.device if mesh is None else mesh.device, seed=0,
                             mesh=mesh)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                      global_batch=args.global_batch, seed=0))
    step = make_train_step(cfg, cfg_t, mesh=mesh)
    log(f"arch={cfg.name} params={count_params(GCLM(cfg, device='meta')) / 1e6:.1f}M uncoded "
        f"ranks={1 if mesh is None else mesh.size} device={args.device}")
    t0, losses = time.time(), []
    while (i := int(state.step)) < args.steps:
        state, metrics = step(state, {"tokens": data.batch(i)})
        losses.append(float(metrics["loss"]))
        if args.log_every and (i % args.log_every == 0 or i == args.steps - 1):
            log(f"step {i + 1:5d}  loss {losses[-1]:.4f}")
    if losses:
        log(f"wall {time.time() - t0:.1f}s  loss {losses[0]:.3f} -> {losses[-1]:.3f}")
    return state


if __name__ == "__main__":
    main()
