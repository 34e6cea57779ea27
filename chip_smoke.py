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
6c. adapt: a fresh ``Trainer(adapt=AdaptConfig(window=16, min_rounds=8,
   check_every=2))`` of gc-lm-110m at ``CUT_LAYERS`` (2) of its 12 layers
   (the swap step is the same at either depth: a function of the time
   stream, checked on the CPU) on workers 2 and 3 five times slower
   from round 2, 26 steps with the counts set to 0 just before: the
   controller swaps the plan after step 24 (the step the port's numpy
   layer predicts on the CPU: tests/test_torch_adapt.py), ``gc_fused``
   launches once per step across the swap, and the coded gradient under
   the new plan equals the uncoded one.
6d. wave: 3 barrier steps of gc-lm-110m at 6c's depth, then a fresh
   trainer from the same weights
   with ``WaveConfig(staleness=0)``: parameters and moments byte-equal;
   then 6 rounds at staleness 1: the executed events are the simulator's
   ``WaveTrace``, one ``gc_fused`` launch per decode event (one per level
   and round: 3 levels at 2 layers, 4 at 4, 3 at 12),
   finite losses, and the peak device memory.
6e. tune: the autotuner at full width (gc-lm-110m, seq 256, global batch
   8) on workers 2 and 3 five times slower (``Env.heterogeneous``, N = 4,
   so the ``mc`` backend prices on the card) under a 3 GiB memory cap
   per worker: the report equals the same search on the CPU (the same
   candidates in the same order, pruned for the same reasons, the same
   best, times within 1e-6), and the cap prunes some and admits some.
   The winning plan through ``Plan.simulate`` for 20,000 steps: ``mc`` on
   the card against ``eq2`` (equal times, ``tau_coded`` within 1e-4),
   the mc call's device time beside the eq2 loop's host time.  Then a
   fresh full-width ``Trainer(scheme="auto", budget=...)``: it adopts the
   report's knobs, its coded gradient equals the uncoded one at step 0
   with 0 and s_max stragglers, and 3 steps with the counts set to 0
   just before launch ``gc_fused`` once per step with finite losses;
   ``max_memory_allocated`` beside the tuner's per-worker estimate (sim
   mode holds all N·K rows on one card: no gate).
6f. spmd: four ranks on card 0 over gloo (``repro_torch.dist.spawn``;
   NCCL takes one card per rank), each a ``Trainer(mode="spmd")`` of
   gc-lm-110m at 6c's depth, with K = s_max + 1 shards per rank.  A probe
   says whether gloo reduce-scatters CUDA tensors on this torch
   (``psum_scatter`` runs only if it does).  At step 0, with 0 and s_max
   stragglers, the spmd gradient (``psum``, bf16, ``psum_scatter``) has
   the same bytes on every rank and equals rank 0's sim-mode gradient
   of the same weights and batches (1e-5 per leaf) and the uncoded one
   (1e-4; bf16 5e-2).  Three steps with the counts set to 0 just
   before: one ``gc_fused`` launch per rank per step, one ``psum`` per
   level per step, parameters byte-equal across ranks after every step,
   losses within 1e-4 of a one-process trainer's at the same depth
   (``_axis_losses``, run first).  The time of one psum per level
   (gloo, host-staged, one card: no collective figure); rank 0's
   per-rank combine (one launch into the level buffers, bit-equal to
   the allocating call) device-only against its bound and
   ``torch.matmul`` in turns.  A rank's failure fails the script.
6f'. tp: eight ranks on card 0 over gloo, a (data 4, model 2) mesh: each
   a ``Trainer(mode="spmd")`` of gc-lm-110m at 6f's depth that binds the
   plan to the full tree and keeps its tensor-parallel shards (heads, MLP width and
   vocabulary split over the model axis; ``dist/sharding.py``).  At step
   0, with 0, 1 and s_max stragglers, the coded gradients all-gathered
   over each model group equal rank 0's sim-mode gradient of the full
   weights (1e-5 of each leaf's scale).  Three steps with the counts set
   to 0 just before: one ``gc_fused`` launch per rank per step over its
   11 local leaves (24 in all), one ``psum`` per level per step over the
   data group, every leaf byte-equal across the four data ranks of a
   model index and the three replicated norm leaves across all eight
   after every step, losses within 1e-5 of 6f's one-process trainer's.  The step wall
   time, the data-group level bytes and the model-group bytes per rank
   per step (counted by ``dist/collectives.py``), and rank 0's combine
   over its local rows against its plain version, its bound and
   ``torch.matmul``.  Rank 0's first step runs under the op counter
   (``analyze_ops`` around its ``step_fn``): its FLOPs, transcendentals,
   bytes and collectives by kind and bytes equal, op for op, the dry
   run's rank 0 of the same (data 4, model 2) mesh on meta
   (``launch.dryrun.build_case``, coded, the trainer's rows and int32
   tokens, the same plan), with one counted ``gc_fused`` call for its one
   launch: the dry run's model axis is the card's.
6f''. moe-tp, in 6f''s job after tp: ``mixtral-8x22b.reduced()`` (16's
   config) in a ``Trainer(mode="spmd")`` on the same mesh, its experts
   split as the reference's rule splits them: case (b), the published
   ``shard_experts=False`` (each expert's FFN width over the model axis),
   and case (a), ``shard_experts=True`` (the 4 experts).  At step 0, at
   capacity factors 8 (nothing drops) and 1.25 (drops, counted), with 0,
   1 and s_max stragglers, the model groups' gathered coded gradients
   equal rank 0's sim mode on the full weights (1e-5 of each leaf's
   scale).  Three steps with the counts set to 0 just before: one
   ``gc_fused`` launch per rank per step (48 in all), the losses 16's
   within 1e-5 (16 now runs before 6f), every leaf byte-equal across the
   data ranks of a model index after every step, and every step's
   collectives the formula (``_step_counts``: per forward 2L + 3 model
   all-reduces and in case (a) L all-gathers of the router's logits, per
   backward 3L + 1).
6f'''. mla-tp and mamba-tp, in 6f''s job after moe-tp: 18's config
   (``deepseek-v3-671b.reduced(n_layers=4)``: 3 dense MLA layers, 1 MoE
   layer split by expert, case (a), MTP depth 1) and 20's
   (``jamba-v0.1-52b.reduced(n_layers=8)``: 7 Mamba layers, each
   ``in_proj`` cut in 2 blocks, attention, 4 MoE layers split by
   expert) in a ``Trainer(mode="spmd")`` on the same mesh
   (``_family_tp_rank``): the shards gathered back equal the full model
   drawn from the same seed, byte for byte; at step 0, with 0, 1 and
   s_max stragglers, the model groups' gathered coded gradients equal 18's
   and 20's sim-mode gradients of the same weights and batches (1e-5 of
   each leaf's scale; 18 and 20 save them to the host and now run before
   6f, so no rank recomputes them); three steps with the counts set to 0
   just before: one grouped ``gc_fused`` call per rank per step (2 and 4
   launches: 48 and 96 in all), the losses 18's and 20's within 1e-5,
   every leaf byte-equal across the data ranks of a model index, every
   step's collectives the formula (``_step_counts``: per pass an MLA
   layer one reduce after ``wo`` and three copies — the query latent, the
   KV latent and the RoPE key — a Mamba layer two reduces, ``x_proj``
   and ``out_proj``, and two copies, its input and ``x_proj``'s reduced
   output; an MLP where its own width divides the axis one of each; the
   MTP module its embedding, layer, head and loss).
6f''''. xlstm-tp and cross-tp, in 6f''s job with 6f''' (``_family_tp_rank``):
   xlstm-tp trains ``xlstm-1.3b.reduced(n_layers=8, d_model=384)`` (7
   mLSTM layers, ``up`` cut in 2 blocks, and the sLSTM, ``w_gates`` and
   ``b_gates`` in 4, its GeGLU 512 wide split) at 64 tokens, held to
   xlstm-tp-sim (its one-process sim-mode run, before 6f: the coded
   gradient == the uncoded one at step 0, ``b_i`` — zero in exact
   arithmetic — at its ``b_f``'s; 3 steps' losses); cross-tp trains
   whisper-base at the reference's smoke widths with its published
   51,865-row vocabulary (whole on the axis) in fp32 at 64 tokens, held
   to whisper-tp-sim (the same in one process; 23 trains the full width
   in the config's bf16, which the axis's split sums would move past
   1e-5, and the full width in fp32 costs ~25 s more than the budget
   holds: ``WHISPER_TP_SEQ``), and
   26's ``llama-3.2-vision-11b.reduced(n_layers=10)``, held to 26 (now
   run before 6f), each with its gates opened from the seed and each
   step's ``worker_aux`` from the seed, stepped by ``Trainer.step_fn``
   with the trainer's draws as 23 and 26 step: the same gates as 6f'''
   (the gathered shards, 3 steps' losses within 1e-5, one grouped
   ``gc_fused`` call per rank per step, and, from the rows of the main
   path's own step 0, the gathered coded gradients at 0, 1 and s_max
   stragglers within 1e-5 of the sim-mode ones — xlstm-tp's within
   ``XLSTM_TP_REL``, 6e-5, twice its worst reading on an H100: the axis
   sums every row-parallel product in another order, and the xLSTM
   stack amplifies rounding at a random init, so 1e-5 does not hold;
   xlstm-tp-sim prints the smaller distance of another exact form of
   one process's stack, the mLSTM's chunks halved — leaves
   byte-equal over the data ranks of a model index, every step's
   collectives ``_step_counts``: per pass an mLSTM layer 2 reduces — the
   gates, reduced then copied, and ``down`` — and 2 copies, the input and
   the gates; the sLSTM a copy of its input, an all-gather of h and its
   GeGLU's reduce and copy where it splits; a cross-attention a reduce
   and a copy, the source one copy a pass; an encoder layer 2 and 2;
   whisper-base's 51,865-row vocabulary whole: no embedding, loss or head
   term).
6f'''''. xlstm-wide, in 6f''s job after xlstm-tp: the job's eight ranks
   as a (data 2, model 4) mesh (``build_mesh`` over the same process
   group), each a ``Trainer(mode="spmd")`` of xlstm-tp's config with 2
   heads (``XLSTM_WIDE``): the axis splits ``d_inner`` and leaves the
   heads whole, each head's channels on 2 ranks, as the reference's rule
   splits xlstm-1.3b's 4 heads at model 8 and 16.  One step with the
   counts set to 0 just before: one grouped ``gc_fused`` call a rank, the
   collectives the formula (``_step_counts`` at model 4: per pass an
   mLSTM layer 2 reduces, 3 copies, a gather of its conv's output and
   x_m and its reduce-scatter; the sLSTM a copy and 3 gathers, its
   GeGLU's reduce and copy).  From that step's own rows, at 0 and s_max
   stragglers, the gathered coded gradients within ``XLSTM_WIDE_REL`` of
   each leaf's scale of a one-process sim-mode step of the same config
   (made in xlstm-tp-sim, ``_xlstm_wide_sim``).
6f''''''. fsdp, in 6f''s job after 7a's trainers: the reference's ``fsdp``
   rule (``embed`` over ``data``) on the (data 4, model 2) mesh.
   gemma2-27b with ``fsdp`` set (``FSDP_KW``: its local and global layer,
   softcaps and sandwich norms at d_model 512; every one of its 24 leaves
   cut by ``data``), a ``Trainer(mode="spmd")`` whose ranks each hold
   their (data, model) slice of every leaf and of both AdamW moments,
   then the same with ``fsdp`` off.  ``FSDP_STEPS`` steps each, the
   launch counts set to 0 just before the fsdp run: one ``gc_fused``
   launch per rank per step on the working layout; every rank's slice of
   each parameter and moment with fsdp on within ``FSDP_OFF_REL`` of the
   same slice of its fsdp-off shard (no tree is gathered for it), the
   losses within 1e-6.  The fsdp trainer's checkpoint (each leaf gathered
   over the data and model groups) restores into it byte-equal and, after
   its own run, into the fsdp-off trainer, whose slices are then the
   saved state byte for byte.  Each rank's state bytes and ``max_memory_allocated``, fsdp on
   and off, beside the card's name and power limit.
6g. dryrun: (a) the dry run (``repro_torch.launch.dryrun``) on meta of
   every arch at full width at every input shape on the reference's
   single mesh (data 16, model 16: rank 0's shards, caches and
   collectives), and the spmd coded step of gc-lm-110m and gemma-2b, in
   8 worker processes beside the card's work, the longest cases first:
   no case fails — xLSTM's four shapes included, its 4 heads whole on
   the ranks of their channels — and the skips are the reference's
   (``long_500k`` without a sub-quadratic layer); a line per case with
   its mesh shape, the rank's parameters, FLOPs, bytes, collective
   bytes, argument bytes, roofline terms and trace seconds.  (b) the main path's coded
   step (phase 2's setup, one step of a fresh state) under the op
   counter (``launch/op_analysis.py``) on the card, with the counts set
   to 0 just before, and on meta: FLOPs, transcendentals, bytes and
   collectives equal, op for op, and one counted combine per
   ``gc_fused`` launch.  (c) ``tune.memory.analyze_memory`` of that step
   on the card: argument bytes equal to the meta figure, the peak at
   least the arguments, printed beside ``estimate_memory`` and beside
   argument plus output bytes.  (d) the coded gradients' device time
   under the profiler (from 6) beside the dry run's roofline time.
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
7a. tp-state: a sharded state on the model axis, eight ranks on card 0
   over gloo, (data 4, model 2), each a ``Trainer(mode="spmd")`` of 6f's
   gc-lm-110m over its shards (seed 0), run by the job of 6f' after tp
   and moe-tp (so the ranks start once); the parent's parts, (b) and (d)'s search, run
   after 7.  (a) ``adapt=AdaptConfig()`` and
   ``CodedSpec(4, 1)`` checkpoints every 4 steps, worker 1 1000x slower
   from round 4, 9 steps with every count set to 0 just before: the
   DeathWatch trips after step 8 and the forced re-plan's x is the CPU's
   (``TP_SWAP_X``); rank 0's model group gathers each leaf to it for the
   step-4 save, rank 0 alone reads and decodes the restore (the
   survivors' encode through ``gc_encode``) and broadcasts each full
   leaf; every rank's restored shards are byte-equal to its shards at
   the save and the replayed loss equals the first; ``gc_fused`` once
   per rank per step, ``gc_encode`` twice on rank 0 and never elsewhere.
   Save and restore times and every rank's host peak RSS.  (b) One
   process (model 1) restores that checkpoint on the card byte-equal to
   the state gathered at the save and saves it again: the same crc32s.
   (c) a fresh trainer at staleness 0, byte-equal (shards and moments) to
   (a)'s first 3 steps — barrier steps from the same weights and draws,
   before any save, death or swap — then 4 rounds at staleness 1 (deferred): the
   executed events are the ``WaveTrace``, one ``gc_fused`` launch per
   rank per round.  (d) ``scheme="auto"`` on an i.i.d. env (eq2 on the
   host) under ``TUNE_HBM_GB``: the ranks' report equals the same search
   in the parent process, the step-0 coded gradients gathered equal rank
   0's sim mode on the full weights (1e-5), 1 step with one launch per
   rank; a rank's peak allocation beside the tuner's estimate.
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
9b. tp-serve: serving on the model axis.  gc-lm-110m at its published
   widths cut to 8 of 12 layers (seed 0) served on one rank, then by four
   ranks on card 0 over gloo, a (data 2, model 2) mesh: each draws its
   shards (``init_shards``: 50,049,792 parameters) and holds 4 of the 8
   slots and 6 of the 12 KV heads.
   16 requests drawn as 9a draws its 32, 9a's tier, on an fp32 slab with fp32
   activations, every count set to 0 just before: every rank's tokens,
   slots, timestamps and step latencies equal the one-rank engine's, and
   a slot serves a second request; the
   collectives of every engine step on every rank equal the formula
   (per decode step 17 all-reduces of (4, 1, 768), one all-gather of the
   logits, one gather of the step's tokens over the data ranks; per
   prefill 17 all-reduces of (1, 256, 768) and one of the last position's
   logits); no ``gc_*`` launch.  Teacher forcing on a rank's bf16 slab
   (15,728,640 bytes) within ``SERVE_BF16_REL``; bf16 activations on a
   bf16 slab, the first 8 requests served on one rank and on the mesh:
   the tokens that differ are counted, not gated.  Prints tokens/s by
   the wall clock, the decode step's median by the host clock (gloo
   stages every collective through the host: not a collective figure)
   and each rank's peak memory.
9c. moe-tp-serve: serving a MoE on the model axis.  mixtral-8x22b at its
   published widths cut to 2 of 56 layers (5,410,781,184 parameters,
   21.64 GB fp32), fp32 activations on an fp32 slab, served on one rank,
   the model freed, then by four ranks on card 0 over gloo, a (data 2,
   model 2) mesh, each drawing its shards (``init_shards``, one rank at a
   time: a full stacked expert leaf is 6.44 GB) and holding 4 of the 8
   slots: case (b) (2,705,455,104 parameters a rank), then the shards
   re-cut in case (a) (2,705,405,952).  9b's load: 16 requests of
   256-token prompts, 32 new tokens each.  Every rank's tokens, slots,
   timestamps and step latencies equal the one-rank engine's, a slot
   serves a second request, no ``gc_*`` launch, and every engine step's
   collectives on every rank equal the formula (``_serve_collectives``:
   9b's, plus per MoE layer and decode one all-gather of every slot's k
   expert ids — the capacity counted over the whole slab, as one rank
   counts it — and in case (a) one all-gather of the router's logits per
   decode and prefill).  Prints each rank's peaks.  At 8 slots the
   capacity is the floor of 8 whether counted over a rank's 4 rows or all
   8, and top-2 over 8 rows puts at most 8 assignments on an expert, so
   nothing can drop: the card shows the gathers, not what the global
   count keeps.  That is held on the CPU, at 24 slots over 2 data ranks
   (tests/test_torch_tp_moe_serve.py).
9d. deepseek-tp-serve and jamba-tp-serve: 9c's steps and gates
   (``phase_axis_tp_serve``: the three phases' one-rank runs, then one
   job of four ranks serving all three, so the ranks start once) for
   deepseek-v3-671b at its published widths cut to
   its first 2 of 61 layers (dense MLA, d_ff 18,432; no MTP module:
   3,020,332,032 parameters, 12.08 GB fp32; a rank's heads, the latent
   slab whole on every rank) and jamba-v0.1-52b at its first 2 of 32
   layers (Mamba of d_inner 8,192 with a dense MLP, and with the MoE FFN
   of 16 experts top-2, split by expert: 3,742,306,304 parameters, 14.97
   GB; a rank's channels of every Mamba leaf and of the slab's state):
   one rank, the model freed, then four ranks drawing their shards one
   at a time; every step's collectives the formula (a Mamba layer's
   ``x_proj`` reduce of width dt_rank + 2·d_state = 288); each rank's
   slab checked (``_check_axis_slab``) and its peaks printed.
   DeepSeek's first MoE layer alone is 256 x 3 x 7168 x 2048 fp32, ~45
   GB, and two data replicas of it do not fit one card: its split stays
   with 6f''' and the CPU tests.
9e. xlstm-tp-serve, whisper-tp-serve and vision-tp-serve, in 9d's job:
   xlstm-1.3b at full width cut to 21's 8 of 48 layers (one period: 7
   mLSTM and the sLSTM, whose GeGLU, 2,731 wide, stays whole; 405,444,664
   parameters, 1.62 GB fp32) through 9c's engine steps and gates (the slab
   of a rank's mLSTM heads and channels and of its sLSTM heads; per
   decode an mLSTM layer's gates, 2·heads wide, and ``down`` reduced, the
   sLSTM's h all-gathered), but that a request's tokens may part from one
   rank's at a near tie — the one-rank logits rank the two tokens first
   and second within 1e-4 of the largest — and the mesh, fed one rank's
   tokens of that request, then gives one rank's tokens after the part
   but at such ties (``_forced_tokens``); whisper-base at full width and depth
   (70,646,278 parameters; the encoder over 1,500 frames on the shards
   every forward; the vocabulary whole) and llama-3.2-vision-11b at 5 of
   40 layers (the cross layer at index 3, 2,172,694,529 parameters, 8.69
   GB fp32; ``vision_proj`` whole) through ``generate(aux_inputs=)``, 2
   and 4 prompts of 128 and 512 tokens + 16 new, gates opened from the seed,
   fp32: one rank, the model freed, then the four ranks (every rank runs
   every row: the direct loop has no slots) — tokens equal on every rank,
   the entry point's prefill and every decode step counted (its
   collectives and bytes == ``_cross_serve_collectives``), no ``gc_*``
   launch; a decode step's host wall on the mesh beside one rank's, and
   the device's busy time in one decode step (the profiler's device
   events) beside one rank's, whose device-only time (a replayed CUDA
   graph) is printed too.
10. reference: three training steps at a reduced size on the CPU (the
   plain versions) and on the card, from the same weights, agree; the
   same weights and prompts through ``ServeEngine`` (fp32 slab, greedy)
   on both give equal tokens, timestamps and step latencies, and
   teacher-forced logits within 1e-4 of the largest.
11. gemma-train: full-width gemma-2b (d_model 2048, MQA, head_dim 256,
   d_ff 16384, vocab 256,000, GeGLU, the embedding scale, bf16
   activations, ``remat="dots"``) cut to 2 layers, in a sim-mode
   ``Trainer`` as in 2 (N = 4, ``xf``, s_max = 3: 16 fp32 rows of every
   parameter).  At step 0 the coded gradient equals the uncoded one with
   0 and s_max stragglers: fp32 activations within 1e-4 per leaf (the
   gate), the config's bf16 within ``GEMMA_BF16_RTOL``.  3 steps with the
   counts set to 0 just before: one ``gc_fused`` launch per step, finite
   losses, ``max_memory_allocated`` beside the 62.5 GB reckoning.  The
   step combine (11 leaves, 744,499,200 columns, one launch) against its
   plain version, device-only in turns with ``torch.matmul``, against its
   memory bound; the pieces of a step by the host clock.
12. gemma3-serve: full-width gemma3-27b (QK-norm, sandwich norms, local
   RoPE base 1e4 and global 1e6, windows of 1,024) cut to 14 layers (a
   pattern of 6 over 2 repeats and a tail run of 2) in a ``ServeEngine``
   (8 slots, bf16 slab, the launcher's coded tier), 16 requests of
   1,536-token prompts and 64 new tokens, greedy, counts set to 0 just
   before: every request completes, the clock is the tier's stream, a
   slot serves a second request (so in every ``_serve_run`` phase below),
   the local layers' rings wrap, no ``gc_*`` launch; seconds and tokens/s.
   Teacher forcing: fp32 activations on an fp32 slab within 1e-4 of the
   largest logit, the config's bf16 on a bf16 slab within 2e-2.
12a. gemma3-tp-serve: gemma3-27b at full width cut to one 5:1 period (6
   layers: 5 windowed at 1,024, 1 global; 3,886,682,880 parameters), fp32
   activations on an fp32 slab: 4 requests of 1,536-token prompts (the
   rings wrap) and 32 new tokens served on one rank, the model freed,
   then on 2 ranks at model 2 (8 of the 16 KV heads each): equal tokens,
   slots, timestamps and step latencies, the collectives of every step at
   the formula, no ``gc_*`` launch.
13. gemma2: full-width gemma2-27b (softcaps 50 and 30) cut to 4 layers (a
   pattern of 2 over 2 repeats): a 4,352-token prefill past the 4,096
   window (the rings rolled at prefill), then 16 teacher-forced decode
   steps at 12's bounds.
14. qwen-serve: full-width qwen1.5-32b (d_model 5120, 40 heads, head_dim
   128, d_ff 27,392, vocab 152,064, QKV biases, an untied head, bf16
   activations) cut to 4 of 64 layers, its biases — and only they — set
   to seeded normal values (std 0.02; the reference initializes them to
   zero), in a ``ServeEngine`` (8 slots, bf16 slab, the launcher's coded
   tier): 16 requests of 512-token prompts, 64 new tokens each, greedy,
   counts set to 0 just before: every request completes, the clock is the
   tier's stream, no ``gc_*`` launch.  Prefill (B = 1) and one
   ``decode_step`` (B = 8) host-inclusive and device-only beside their
   bounds (bf16 tensor-core peak), tokens/s, peak bytes.  Teacher forcing
   as 9a checks it: fp32 activations on a bf16 slab (the slab's rounding)
   within 2e-2, fp32 on fp32 within 1e-4; the config's bf16 activations
   on a bf16 slab measured and printed (at 16 layers their own rounding
   reached 2e-2: ROADMAP 3.17).
15. mixtral-serve: full-width mixtral-8x22b (d_model 6144, 48 heads over 8
   KV, 8 experts top-2 of d_ff 16,384, windows of 4,096, vocab 32,768, an
   untied head) cut to 4 of 56 layers at the published capacity factor
   1.25: 16 requests of 4,352-token prompts (the rings wrap), 32 new
   tokens, with 14's gates and times.  A census of dropped assignments
   (``DropCensus``: the port's ``moe.route`` on each MoE layer's input):
   each prompt's prefill (may drop) and one 8-slot decode step (capacity
   8: must not).  Teacher forcing one row per call: at capacity 1.25 the
   bound applies to the rows whose prefills dropped nothing (counted); at
   capacity factor 4 (experts / top-k: nothing can drop) to every row.
16. moe-train: coded training of ``mixtral-8x22b.reduced()`` (the
   reference's smoke shapes; a full-width layer's 16 fp32 rows would be
   186 GB) in sim mode with 2's plan settings: coded == uncoded at step 0
   with 0 and s_max stragglers at capacity 8 and at 1.25 (drops counted,
   some required); 3 steps with the counts set to 0 just before (one
   ``gc_fused`` launch per step, finite losses with the aux term); on the
   card, ``remat="full"`` bit-equal to ``"none"`` and two runs of one
   forward+backward at capacity 1.25 byte-equal.
17. deepseek-serve: full-width deepseek-v3-671b (multi-head latent
   attention: q_lora 1536, kv_lora 512, nope 128, rope 64, v 128 over 128
   heads; sigmoid top-8 of 256 experts of d_ff 2,048 plus one shared;
   vocab 129,280, an untied head, bf16 activations) cut to its first 4 of
   61 layers (3 dense, d_ff 18,432, and 1 MoE at capacity factor 1.25; no
   MTP module, which serving does not run), 15,111,101,440 parameters:
   16 requests of 512-token prompts, 32 new tokens, with 14's gates and
   times; the slab's bytes per token (the latent c_kv and k_r, 4,608)
   beside plain attention's K/V (262,144); the census of 15; teacher
   forcing one row per call with fp32 activations on a bf16 slab (2e-2)
   and fp32 on fp32 (1e-4), at capacity 1.25 on the drop-free rows and
   at capacity factor 32 on every row; the config's bf16 activations on
   a bf16 slab measured, not gated (the absorbed decode rounds at other
   points than the expanded prefill).
18. deepseek-train: coded training of ``deepseek-v3-671b.reduced(n_layers
   =4)`` (3 dense MLA layers, 1 MoE layer, MTP depth 1; one full-width
   MoE layer's 16 fp32 rows would be 736 GB) with 2's plan settings:
   coded == uncoded at step 0 with 0 and s_max stragglers, the MTP
   leaves included; 3 steps with the counts set to 0 just before (one
   grouped ``gc_fused`` call per step: 52 leaves, 2 launches of at most
   32; finite loss, xent, aux and mtp); on the
   card ``remat="full"`` bit-equal to ``"none"`` and two runs of one
   forward+backward byte-equal.
19. jamba-serve: full-width jamba-v0.1-52b (Mamba mixers of d_inner
   8,192, d_state 16, dt_rank 256; global attention of 32 heads over 8
   KV heads; 16 experts top-2 of d_ff 14,336 on the odd layers; vocab
   65,536, an untied head, bf16 activations) cut to its first 8 of 32
   layers (one period: 7 Mamba, attention at offset 4, 4 MoE at capacity
   factor 1.25), 13,295,235,072 parameters: 16 requests of 2,048-token
   prompts (two chunks of the online softmax, 8 scan chunks), 32 new
   tokens, with 14's gates and times and a peak under 80 GB; the slab's
   K/V bytes per token and its fixed Mamba state per slot (``h`` fp32 in
   the bf16 slab); the census of 15; teacher forcing one row per call
   with fp32 activations on a bf16 slab (2e-2) and fp32 on fp32 (1e-4) at
   capacity factor 8 on every row, the rows drop-free at 1.25 printed;
   the config's bf16 activations measured, not gated.
20. jamba-train: coded training of ``jamba-v0.1-52b.reduced(n_layers=8)``
   (7 Mamba layers and attention, 4 MoE layers, 114 leaves; one
   full-width MoE layer's 16 fp32 rows would be 180 GB) with 2's plan
   settings at seq 256 (4 scan chunks of 64): coded == uncoded at step 0
   with 0 and s_max stragglers; 3 steps with the counts set to 0 just
   before (one grouped ``gc_fused`` call per step: 4 launches of at most
   32; finite loss, xent and aux); on the card ``remat="full"``
   bit-equal to ``"none"`` and two runs of one forward+backward
   byte-equal.
21. xlstm-serve: full-width xlstm-1.3b cut to 8 of its 48 layers (one
   period — seven mLSTM layers of d_inner 4,096 over 4 heads of 1,024, in
   a stacked run, and an sLSTM layer; no FFN sublayers; vocab 50,304,
   tied, bf16 activations), 405,444,664 parameters: 16 requests of
   512-token prompts (two chunks of 256 of the chunkwise mLSTM), 32 new
   tokens, with 14's gates; the slab's fixed state per slot (117,760,112
   bytes: ``C``/``n``/``m`` and the sLSTM state fp32, ``conv`` bf16); a
   2,048-token prefill at B = 1 timed whole and in its pieces (one mLSTM
   mixer, one sLSTM mixer — a Python loop over tokens — and the rest) and
   one ``decode_step`` over the 8 slots, beside their bounds; teacher
   forcing with fp32 activations on a bf16 slab (2e-2) and fp32 on fp32
   (1e-4), the config's bf16 activations measured, not gated; peak
   memory.
22. xlstm-train: coded training of xlstm-1.3b at full width cut to its
   layers 5 to 8 of 48 (3 mLSTM and the period's sLSTM; 254,212,120
   parameters in 22 leaves, bf16 activations, ``remat="dots"``) with 2's plan settings at
   seq 256: coded == uncoded at step 0 with 0 and s_max stragglers (``b_i``, whose
   gradient is zero in exact arithmetic, against its layer's ``b_f``
   scale); 3 steps with the counts set to 0 just before (one grouped
   ``gc_fused`` launch per step); ``remat`` "none", "dots" and "full"
   bit-equal and two runs of one forward+backward byte-equal.
23. whisper-train: coded training of whisper-base at full width and depth
   (6 encoder layers over 1,500 stubbed frames of width 512 with QKV biases,
   no RoPE and layer norms; 6 decoder layers with RoPE, a gated
   cross-attention sublayer over the encoder's output and an ungated GELU
   MLP; vocab 51,865, tied; bf16 activations; 70,646,278 parameters in 103
   leaves) with 2's plan settings at seq 224, every cross ``gate`` drawn
   from U(0.3, 0.9) (zero, the init, closes the cross sublayers and leaves
   the encoder without gradient), ``worker_aux`` (4, 4, 2, 1500, 512) drawn
   per shard with numpy and allocated by ``coded_worker_batches``' cyclic
   map: coded == uncoded at step 0 with 0 and s_max stragglers (the
   encoder's ``bk``, whose gradient is zero in exact arithmetic, against its
   layer's ``bq``); 3 steps of ``make_coded_train_step`` with the counts
   set to 0 just before (one grouped ``gc_fused`` call per step: 4
   launches of at most 32; finite losses); two runs of one
   forward+backward byte-equal; the encoder's share of one pass.
24. whisper-serve: full-width whisper-base (gates open) through
   ``generate(aux_inputs=)`` — one prefill, then a ``decode_step`` per
   token, each re-running the encoder over the rows' frames — 4 prompts of
   128 tokens + 64 new, counts set to 0 just before: no ``gc_*`` launch,
   tokens/s; prefill (B = 1) and ``decode_step`` (B = 4) host-inclusive
   and device-only beside their bounds, the encoder's share of a decode
   step; teacher forcing with fp32 activations on a bf16 slab (2e-2) and
   on an fp32 slab (1e-4), the config's bf16 activations measured, not
   gated.
25. vision-serve: full-width llama-3.2-vision-11b cut to 10 of its 40
   layers (one pattern of 5 over 2 repeats, gated cross-attention image
   layers at 3 and 8 over 1,601 stubbed patches of width 7,680 projected
   by ``vision_proj``; 32 heads over 8 KV heads, d_ff 14,336, vocab
   128,256, an untied head, bf16 activations; 3,263,254,530 parameters,
   13.05 GB fp32; gates open) through 24's steps: 4 prompts of 512 tokens
   + 32 new (the projector and 2 layers' cross K/V recomputed every decode
   step), peak memory under 80 GB.
26. vision-train: coded training of ``llama-3.2-vision-11b.reduced(n_layers
   =10)`` (two periods: the cross layer stacked in a pattern; 50 leaves;
   full width needs 16 rows of 39 GB) with 16-patch aux rows, as 23 checks
   it: coded == uncoded, 3 steps with 2 ``gc_fused`` launches each, two
   forward+backward runs byte-equal.

Order: 16 (moe-train), 18 (deepseek-train), 20 (jamba-train),
xlstm-tp-sim, whisper-tp-sim and 26 (vision-train) run after 6e, before
6f, whose job's 6f'', 6f''' and 6f'''' hold to their losses;
9c and 9d run after 9b.

Depth cuts that hold the phases to 820 s on an H100 host where they took
961.4 s before the cuts (so that a host ~1.4x slower in every phase stays
under the 1,200 s limit), each saving (predicted; PERF.md §6): 6c, 6d,
6f, 6f' and 7a from 12 to 4 layers of gc-lm-110m, ~20, ~8, ~25, ~60 and
~15 s (7a's parent part); 25 from 40 to 10 layers, ~13 s.  22 keeps
the period's sLSTM (a loop over tokens, ~95 s) and drops layers 1 to 4,
all mLSTM (~4 s).  6 reads the profiled call's kernels from the
profiler's raw device events (``_device_kernels``) instead of
``key_averages()``, which parsed every CPU op of the call into a tree
first (~30 s; scripts/profiler_tables.py compares the two).  The new
phases cost ~15 s (6f'') and ~30 s (9c).  PR 29's phases (6f''' ~25-55
s and 9d ~45-50 s in its runs, on hosts ~2x apart) are paid for by
depth cuts, each rehearsed on the card, saving (predicted): 6c, 6d, 6f,
6f' and 7a from 4 to 2 layers of gc-lm-110m (``CUT_LAYERS``), ~5, ~2,
~10, ~3 and ~15-25 s; 9b from 12 to 8 layers, ~12-18 s (at 4 a near
tie flipped a token); 14 from 8 to 4 layers, ~4-6 s; 21 from 16 to 8
layers (one period), ~15-22 s; and by work shared: 18 and 20 save their
sim-mode gradients for 6f''' (no rank recomputes them), and every part
of 6f''s job runs a rank's per-shard passes once per gradient check,
not once per straggler count (``_gathered_coded``), ~20-30 s; 9c and
9d run in one job of four ranks, which start once, ~15-20 s.  The
xLSTM and cross-attention phases on the axis (6f'''' ~43 s, 9e ~46 s
and their one-process references ~39 s on an H100, 864.3 s of phases
beside 762.5 without them, in one call) are paid for by work shared
and by the new phases' own sizes, each rehearsed on the card: every
sim-mode training phase (18, 20, 22, 23, 26, xlstm-tp-sim and
whisper-tp-sim) and every family part of 6f''s job holds the
per-shard rows of the trainer's own step 0 to the uncoded gradient or
to sim mode after its run (``_keep_step0_rows``), so those passes run
once (~16-20 s in 22, a quarter of a rank's passes in 6f''' and
6f''''); xlstm-tp at 64 tokens; whisper-tp-serve over 2 rows (~40 s).
PR 32's fsdp phase (6f'''''', 9.4 and 14.1 s in two calls when it
gathered both runs' trees to compare them) is paid for by its own
shape: each rank compares its slices in place (no tree gathered but
the checkpoint's), and the fsdp-off trainer takes the second restore
after its run (no third trainer).

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
#: the [tune] phase: the memory cap per worker (at N = 4 the tuner's
#: estimate prices fp32 with K = 4 under psum at 4.27 GiB and bf16 with
#: K = 4 under psum_scatter at 2.80 GiB, so 3 GiB prunes 46 of 136
#: candidates; found on the CPU with the port's numpy layer), the steps
#: of the mc-against-eq2 ledger and its bound (tests/test_sim_mc.py)
TUNE_HBM_GB = 3.0
TUNE_SIM_STEPS = 20_000
MC_EQ2_RTOL = 1e-4
#: the [dryrun] phase: the sweep's worker processes (one per core of the
#: host; the main process's card work meanwhile is short), the coded
#: cases, and the reference's skips (``shape_supported``: ``long_500k``
#: needs a recurrent or windowed layer; tests/test_torch_specs.py holds the
#: port's skips to the reference's)
DRYRUN_WORKERS = 8
DRYRUN_CODED = ("gc-lm-110m", "gemma-2b")
DRYRUN_SKIPS = {(a, "long_500k") for a in ("deepseek-v3-671b", "gc-lm-110m", "gemma-2b",
                                           "llama-3.2-vision-11b", "qwen1.5-32b",
                                           "whisper-base")}
#: the [spmd] phase: ranks on one card over gloo (NCCL takes one card per
#: rank) and the job's time limit, seconds
SPMD_RANKS = 4
SPMD_LIMIT_S = 600.0
#: [adapt], [wave], [spmd], [tp] and [tp-state] run gc-lm-110m at its
#: published widths cut to its first 2 of 12 layers (43,454,208
#: parameters, still a stacked run; 62,331,648 at the 4 layers of PR 28,
#: 137,841,408 before the script's phases were held to 820 s; the plan's
#: x, the swap after step 24 and the death's re-plan are the same at 2, 4
#: and 12 layers on the CPU): the spmd phases' time is gloo's host
#: staging of the data group's level buffers and the checkpoint's host
#: path, in proportion to the parameters, and [adapt]'s and [wave]'s is
#: 26 and 12 steps' passes.  The swap step, the wave trace and the death
#: are functions of the numpy time stream, not of the model; the losses
#: [spmd] and [tp] are held to are a one-process trainer's at that depth
#: (``_axis_losses``).  Full depth stays in [train], [kernel], [breakdown],
#: [dryrun], [tune], [ckpt] and [serve]
CUT_LAYERS = 2
#: the [tp] phase: a (data, model) mesh of ranks on one card over gloo
TP_DATA, TP_MODEL = 4, 2
#: [moe-tp], in [tp]'s job: ``mixtral-8x22b.reduced()`` ([moe-train]'s
#: config; a full-width layer's spmd rank would hold ~7 x 2.906e9 fp32
#: values) in case (b) (the published ``shard_experts=False``: each
#: expert's FFN width split) and case (a) (``shard_experts=True``: the 4
#: experts split), at the reduced capacity factor 8 and the published 1.25
MOE_TP_CASES = (("b", False), ("a", True))
MOE_TP_CAPACITIES = (8.0, 1.25)
#: worker 1 dies (1000x slower from round 0): with seed 0 the DeathWatch
#: (factor 20, 4 rounds) trips after the 4th step (found on the CPU with
#: the port's PlanSimulator and DeathWatch alone)
DEATH = dict(worker=1, factor=1000.0, from_round=0)
CKPT_STEPS = 5
#: [tp-state]: worker 1 dies from round 4, so the DeathWatch trips after
#: step 8 and the forced re-plan estimates from 4 rounds (the newest half
#: of 8; fewer than 4 and it declines); the last save before it is step
#: 4's.  The trip step and the re-plan's x were found on the CPU (the
#: port's PlanSimulator, DeathWatch and AdaptiveController over
#: full-width gc-lm-110m's plan on a meta model, seed 0)
TP_DEATH = dict(worker=1, factor=1000.0, from_round=4)
TP_CKPT_EVERY = 4
TP_DEATH_STEP = 8
TP_SWAP_X = [46, 4000, 3130, 12824]
TP_STATE_STEPS = 9
TP_WAVE_ROUNDS = 4
#: [tp-state]'s trainers and its search run at 128 tokens, not make_trainer's
#: 256: a step's model-group all-reduces through gloo set its time, and
#: the checkpoint's size is the parameters', whatever the sequence
TP_STATE_SEQ = 128
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
#: [tp-serve]: gc-lm-110m at its published widths cut to 8 of 12 layers (12
#: before PR 29; at 4 one request's fp32 greedy tokens on the mesh differed
#: from one rank's: a near tie) on a (data 2, model 2) mesh of four
#: ranks on card 0 over gloo, [serve]'s slots, prompts, arrivals and tier
#: on an fp32 slab (a rank: 4 of the 8 slots, 6 of the 12 KV heads); 16
#: requests drawn as [serve] draws its 32, so the slots serve a second
#: request each (re-admission into a used slot: a rank's row mapping and
#: the overwrite of its KV heads)
TP_SERVE = dict(n_layers=8, data=2, model=2, n_slots=8, max_len=320, n_requests=16,
                prompt_len=256, max_new=64, rate=2e-3, workers=8)
#: [tp-serve]'s bf16-activation comparison (printed, not gated) serves the
#: first 8 requests: at ~40 tokens/s over gloo all 32 took ~55 s
TP_SERVE_BF16 = dict(TP_SERVE, n_requests=8)
#: the model axis's serving phases at published widths, cut to 2 layers,
#: fp32 activations on an fp32 slab, [tp-serve]'s layout and load: (data 2,
#: model 2), 8 slots, 16 requests so that every slot serves a second
AXIS_TP_SERVE = dict(n_layers=2, data=2, model=2, n_slots=8, max_len=288, n_requests=16,
                     prompt_len=256, max_new=32, rate=2e-3, workers=8)
#: each of them: its arch, its cases (name -> config fields), its parameters.
#: [moe-tp-serve]: mixtral-8x22b (21.64 GB fp32), the experts in case (b),
#: then re-cut in case (a) in the same job; [deepseek-tp-serve]:
#: deepseek-v3-671b's first 2 layers, dense MLA (12.08 GB; no MTP module,
#: which serving does not run; its first MoE layer alone, 256 x 3 x 7168 x
#: 2048 fp32, is ~45 GB, and two data replicas of it do not fit: that split
#: stays with [mla-tp] and the CPU tests); [jamba-tp-serve]:
#: jamba-v0.1-52b's first 2 layers, Mamba of d_inner 8,192 with a dense MLP
#: and with the MoE FFN, 16 experts top-2 (14.97 GB)
AXIS_SERVE_PHASES = {
    "moe-tp-serve": ("mixtral-8x22b", {"b": dict(shard_experts=False),
                                       "a": dict(shard_experts=True)}, 5_410_781_184),
    "deepseek-tp-serve": ("deepseek-v3-671b", {"": dict(mtp_depth=0)}, 3_020_332_032),
    "jamba-tp-serve": ("jamba-v0.1-52b", {"": {}}, 3_742_306_304),
    # [xlstm-serve]'s 8 of 48 layers (one period: 7 mLSTM and the sLSTM,
    # whose GeGLU, 2,731 wide, stays whole at model 2); 1.62 GB fp32
    "xlstm-tp-serve": ("xlstm-1.3b", {"": dict(n_layers=8)}, 405_444_664)}
#: the model axis's serving phases of the cross-attention families, through
#: ``generate(aux_inputs=)`` (the engine takes no aux inputs) in the same
#: job: fp32, gates opened from the seed, every row on every rank (a data
#: replica runs all of them: the direct loop has no slots); per phase its
#: arch, depth, parameters and load.  [whisper-tp-serve]: whisper-base at
#: full width and depth, the encoder over 1,500 frames on the shards every
#: forward, the vocabulary (51,865 rows: odd) whole; [vision-tp-serve]:
#: llama-3.2-vision-11b at 5 of 40 layers (the cross layer at index 3,
#: 1,601 patches of width 7,680 through the whole ``vision_proj``)
CROSS_TP_SERVE = {
    "whisper-tp-serve": ("whisper-base", 6, 70_646_278, dict(batch=2, prompt_len=128,
                                                             max_new=16)),
    "vision-tp-serve": ("llama-3.2-vision-11b", 5, 2_172_694_529,
                        dict(batch=4, prompt_len=512, max_new=16))}
#: [gemma3-tp-serve]: gemma3-27b at full width cut to one 5:1 period (6
#: layers), fp32 activations on an fp32 slab, 2 ranks at model 2 (8 of the
#: 16 KV heads each), 1,536-token prompts past the 1,024 window
GEMMA3_TP_SERVE = dict(n_layers=6, data=1, model=2, n_slots=4, max_len=1568, n_requests=4,
                       prompt_len=1536, max_new=32, rate=2e-3, workers=8)
#: the Gemma phases, at the configs' published widths, cut in depth only.
#: [gemma-train]: gemma-2b at 2 layers (one run, 11 leaves): sim mode holds
#: N·K = 16 fp32 rows of every parameter, 47.65 GB at P = 744,499,200;
#: with parameters and AdamW moments (8.93 GB), one pass's gradients and
#: the decoded gradient (2.98 GB each) the reckoning is 62.5 GB plus
#: activations (3 layers: ~72 GB)
GEMMA_TRAIN_LAYERS = 2
#: coded vs uncoded with the config's bf16 activations, per leaf: both
#: sides run the same bf16 per-shard passes; only the fp32 combine differs
GEMMA_BF16_RTOL = 1e-4
#: [gemma3-serve]: gemma3-27b at 14 layers (a pattern of 6 over 2 repeats
#: and a tail run of 2, the segmenting of the full 62), 1,536-token
#: prompts past the 1,024 window
GEMMA3_SERVE = dict(n_layers=14, n_slots=8, n_requests=16, prompt_len=1536, max_new=64,
                    rate=2e-3, workers=8)
#: [gemma2]: gemma2-27b at 4 layers (a pattern of 2 over 2 repeats), a
#: 4,352-token prompt past the 4,096 window
GEMMA2 = dict(n_layers=4, prompt_len=4352, decode_steps=16)
#: Qwen 1.5 and Mixtral at their published widths, cut in depth only.
#: [qwen-serve]: qwen1.5-32b at 4 of 64 layers (one run; 16 before
#: [tp-state] joined the script, 8 before PR 29): 3,659,637,760
#: parameters, 14.64 GB fp32
QWEN_SERVE = dict(n_layers=4, n_slots=8, n_requests=16, prompt_len=512, max_new=64,
                  rate=2e-3, workers=8)
#: [mixtral-serve]: mixtral-8x22b at 4 of 56 layers: 10,418,903,040
#: parameters, 41.68 GB fp32, at the published capacity factor 1.25;
#: 4,352-token prompts past the 4,096 window
MIXTRAL_SERVE = dict(n_layers=4, n_slots=8, n_requests=16, prompt_len=4352, max_new=32,
                     rate=2e-3, workers=8)
#: every ``_serve_run`` phase serves 16 requests over 8 slots: a slot serves
#: a second request (the reset of a used slot's state is what its token and
#: teacher-forcing checks hold)
#: DeepSeek-V3 at its published widths, cut in depth only.
#: [deepseek-serve]: deepseek-v3-671b at its first 4 of 61 layers (the 3
#: dense ones and the first MoE layer) without the MTP module, which
#: serving does not run: 15,111,101,440 parameters, 60.44 GB fp32, plus
#: the per-call bf16 cast of one (256, 7168, 2048) expert matrix, 7.52 GB
DEEPSEEK_SERVE = dict(n_layers=4, n_slots=8, n_requests=16, prompt_len=512, max_new=32,
                      rate=2e-3, workers=8)
#: [deepseek-train]: the reference's smoke shapes with one MoE layer
#: (``reduced()`` keeps the first n layers, and DeepSeek's first 3 are
#: dense); a full-width MoE layer's 16 fp32 rows would be 736 GB
DEEPSEEK_TRAIN_LAYERS = 4
#: Jamba at its published widths, cut in depth only.
#: [jamba-serve]: jamba-v0.1-52b at its first 8 of 32 layers (one period:
#: seven Mamba layers, global attention at offset 4, MoE on the odd
#: layers): 13,295,235,072 parameters, 53.18 GB fp32, plus the per-call
#: bf16 cast of one (16, 4096, 14336) expert matrix, 1.88 GB, freed before
#: the next; 2,048-token prompts, past the 1,024 ``attn_chunk`` and 8 scan
#: chunks of 256
JAMBA_SERVE = dict(n_layers=8, n_slots=8, n_requests=16, prompt_len=2048, max_new=32,
                   rate=2e-3, workers=8)
#: [jamba-train]: the reference's smoke shapes at 8 layers (one period, 114
#: leaves: 4 launches of at most 32 per grouped combine); a full-width MoE
#: layer's 16 fp32 rows would be 180 GB
JAMBA_TRAIN_LAYERS = 8
#: xLSTM at its published widths.
#: [xlstm-serve]: xlstm-1.3b at its published widths cut to its first 8 of
#: 48 layers (one period: a run of 7 mLSTM layers and the sLSTM; all 48
#: before [tp-state] joined the script, 16 — the period over 2 repeats —
#: before PR 29, each cut to hold the script's time), 405,444,664
#: parameters, 1.62 GB fp32; a fixed state of 117,760,112 bytes per slot
#: (7 mLSTM matrix memories of 16.8 MB fp32), 0.94 GB for 8 slots;
#: 512-token prompts (two mLSTM chunks of 256), and one 2,048-token
#: prefill timed in its pieces
XLSTM_SERVE = dict(n_layers=8, n_slots=8, n_requests=16, prompt_len=512, max_new=32,
                   rate=2e-3, workers=8, prefill_len=2048)
#: [xlstm-train]: the published widths cut to layers 5 to 8 of 48 (three
#: mLSTM layers and the period's sLSTM; the first 8 before the script's
#: phases were held to 820 s).  The sLSTM takes most of the phase: a
#: Python loop over the 256 tokens, forward and backward, in each of ~70
#: passes (~95 of the 8 layers' 108.5 s)
XLSTM_TRAIN_LAYERS = slice(4, 8)
#: Whisper and Llama-3.2-vision at their published widths; the cross gates
#: (zero at init: tanh closes every cross sublayer) drawn from U(0.3, 0.9).
#: [whisper-train]: whisper-base at full width and depth (6 encoder and 6
#: decoder layers, 70,646,278 parameters in 103 leaves: 4 launches of at
#: most 32 per grouped combine), 1,500 frames per row, bf16 activations;
#: 16 fp32 rows of 282.6 MB per step
WHISPER_TRAIN = dict(seq_len=224, global_batch=8)
#: [whisper-serve]: 4 prompts of 128 tokens + 64 new through
#: ``generate(aux_inputs=)``, each decode step re-running the encoder
WHISPER_SERVE = dict(batch=4, prompt_len=128, max_new=64)
#: [vision-serve]: llama-3.2-vision-11b cut to 10 of 40 layers (a pattern of
#: 5 over 2 repeats, cross layers 3 and 8; all 40 before the script's
#: phases were held to 820 s), 3,263,254,530 parameters, 13.05 GB fp32; 4
#: prompts of 512 tokens + 32 new
VISION_SERVE = dict(n_layers=10, batch=4, prompt_len=512, max_new=32)
#: [vision-train]: ``reduced(n_layers=10)``, two periods: the cross layer
#: stacked in a pattern, 50 leaves (2 launches); full width needs 16 rows
#: of 39 GB (ROADMAP 3.14)
VISION_TRAIN_LAYERS = 10
#: [xlstm-tp] (in [tp]'s job, data 4 x model 2) and its one-process
#: reference [xlstm-tp-sim]: xlstm-1.3b.reduced(n_layers=8, d_model=384) —
#: 7 mLSTM layers and the sLSTM, whose GeGLU (512 wide) splits at model 2 —
#: at 64 tokens (one mLSTM chunk; the chunks' carry is a head's own, which
#: the axis leaves alone): the sLSTM's token loop runs 16 passes a step on
#: every rank (128 tokens cost ~16 s more on an H100)
XLSTM_TP = dict(n_layers=8, d_model=384, seq_len=64)
#: [cross-tp]'s Whisper ([whisper-tp-sim]): whisper-base at the reference's
#: smoke widths (``reduced()``: 2 + 2 layers, d_model 256, 64 frames) with
#: the published vocabulary of 51,865 rows, which the model axis leaves
#: whole (odd), at 64 tokens.  Full width and depth in fp32 at
#: [whisper-train]'s 224 tokens meet the same gates on an H100 80GB HBM3
#: at 700.00 W (1.301e-6 to 1.328e-6 of sim mode) but took 11.3 s in
#: [whisper-tp-sim] and 23.2 s of [tp]'s job against 3.3 and 4.4 s here:
#: ~25 s more, past the script's 820 s budget (PERF.md, PR 30 run 4)
WHISPER_TP_SEQ = 64
#: [xlstm-tp]'s bound against its sim mode, per leaf of the gathered
#: gradient: twice the worst of its readings on an H100 80GB HBM3 at
#: 700.00 W (2.821e-5 at 64 tokens; 1.280e-5 to 1.869e-5 at 128).  1e-5
#: does not hold there: the axis sums every row-parallel product of every
#: layer in another order, forward and backward, where another exact form
#: of one process's stack (the mLSTM's chunks halved) moves only the
#: mLSTM's chunk sums (4.940e-6 to 7.083e-6 on the same card), and each
#: mLSTM layer's group norm lifts a small h to unit scale, so the stack
#: amplifies either (ROADMAP 3.20)
XLSTM_TP_REL = 6e-5
#: [xlstm-wide] (in [tp]'s job, its 8 ranks as data 2 x model 4) and its
#: one-process reference (in [xlstm-tp-sim]): [xlstm-tp]'s config with 2
#: heads, so the model axis splits the channels and leaves the heads whole
#: (each head on 2 ranks), as the reference's rule splits xlstm-1.3b's 4
#: heads at model 8 and 16; N = 2 workers
XLSTM_WIDE = dict(n_heads=2, data=2, model=4)
#: [xlstm-wide]'s bound against its sim mode, per leaf of the gathered
#: gradient: twice its worst reading on an H100 80GB HBM3 at 700.00 W
#: (2.033e-4, at the first mLSTM's gn_scale).  With float64 activations on
#: both sides the same check reads 1.655e-6 there (1.930e-6 on the CPU,
#: whose fp32 reading is 7.022e-5): no term of the split is wrong, and the
#: stack amplifies the split sums' rounding (ROADMAP 3.20) more with 2 heads
#: of 384 channels each than [xlstm-tp]'s 4 of 192 (XLSTM_TP_REL's 6e-5)
XLSTM_WIDE_REL = 4.1e-4
#: [fsdp] (in [tp]'s job, data 4 x model 2): gemma2-27b (a local and a
#: global layer, softcaps, sandwich norms; every one of its 24 leaves cut
#: by ``data``) reduced to ``d_model`` 512 with ``fsdp`` set: at its
#: published width one rank's working shard of a layer pair and the
#: 256,000-row embedding is 1.16e9 fp32 values, so eight ranks' state,
#: K rows and gathered trees do not fit one 80 GB card even with fsdp on
FSDP_KW = dict(n_layers=2, d_model=512)
FSDP_SEQ = 64
FSDP_STEPS = 2
#: [fsdp]'s gate against the same job's fsdp-off run: the clip norm's sum
#: is all that differs (tests/test_torch_fsdp.py's 1e-6 of a leaf's scale)
FSDP_OFF_REL = 1e-6
GATE_RANGE = (0.3, 0.9)
#: bf16 dense peak of the card's tensor cores (the data sheet, 700 W): the
#: operations bound of the bf16 serving phases
BF16_FLOPS = 989e12


def log(*args):
    print(*args, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, reps: int, warmup: int = 3) -> float:
    """Median time of one call between two CUDA events, after warm-up: the
    host-inclusive time (the card idles while the host prepares the
    launch, so the wrapper's host path is part of it)."""
    import torch

    for _ in range(warmup):
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


def _gc_lm(n_layers: int = None):
    """gc-lm-110m at its published widths (``max_seq`` 512), cut to its
    first ``n_layers`` layers when given."""
    from repro_torch.configs import get_config

    cfg = get_config("gc-lm-110m").replace(max_seq=512)
    return cfg if n_layers is None else cfg.replace(n_layers=n_layers,
                                                    layers=cfg.layers[:n_layers])


def make_trainer(env=None, scheme="xf", seq_len=256, n_layers=None, **kw):
    """Full-width gc-lm-110m in a ``Trainer`` on the card (seed 0) at
    ``seq_len`` tokens, cut to ``n_layers`` when given; ``kw`` goes to the
    ``Trainer`` (ckpt, adapt, wave, params, budget)."""
    from repro_torch.core import ShiftedExponential
    from repro_torch.train.trainer import TrainConfig, Trainer

    cfg = _gc_lm(n_layers)
    return Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                   env or ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4,
                   scheme=scheme, global_batch=8, seed=0, device="cuda",
                   seq_len=seq_len, **kw)


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
    kernels = _device_kernels(prof)
    busy_ms = sum(us for _, us, _ in kernels) / 1e3
    log(f"[profile] coded grads under the profiler: wall {wall_ms:.1f} ms, device "
        f"busy {busy_ms:.1f} ms ({busy_ms / wall_ms:.1%}), {len(kernels)} kernel kinds")
    for name, us, n in kernels[:10]:
        log(f"[profile]   {us / 1e3:9.2f} ms  x{n:<5d} {name[:90]}")
    return {"wall_ms": wall_ms, "busy_ms": busy_ms, "parts_ms": parts}


def _device_kernels(prof) -> list:
    """The device's work in a ``torch.profiler`` run: (name, total us,
    count) per kernel or copy name, longest first, summed from the
    profiler's raw device events.  ``key_averages()`` gives the same
    table, but first parses every CPU op of the run into a tree: ~30 s
    for a coded-gradient call (scripts/profiler_tables.py)."""
    from torch.autograd import DeviceType

    table = {}
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0:
            us, n = table.get(e.name(), (0.0, 0))
            table[e.name()] = (us + e.duration_ns() / 1e3, n + 1)
    return sorted(((k, us, n) for k, (us, n) in table.items()), key=lambda x: -x[1])


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


def _dryrun_init(src: str) -> None:
    """A sweep worker: the port's sources, one torch thread."""
    sys.path.insert(0, src)
    import torch

    torch.set_num_threads(1)


def _dryrun_case(arch: str, shape: str, coded: bool, out_dir: str) -> dict:
    from repro_torch.launch import dryrun

    t0 = time.perf_counter()
    rec = dryrun.run_case(arch, shape, "single", coded=coded, out_dir=out_dir,
                          skip_existing=False)
    rec["wall_s"] = time.perf_counter() - t0
    return rec


def _dryrun_sweep_line(rec: dict) -> str:
    head = f"[dryrun] {rec['arch']:22s} {rec['shape']:12s} {rec['step']:11s} {rec['status']:4s}"
    if rec["status"] != "ok":
        return f"{head} {rec.get('reason') or rec.get('error', '')}"
    return (f"{head} mesh_shape {rec['mesh_shape']} local_params {rec['local_params']} flops "
            f"{rec['per_device_flops']:.6e} bytes {rec['per_device_bytes']:.6e} "
            f"collective_bytes {rec['collective_bytes']:.6e} argument_bytes "
            f"{rec['memory']['argument_bytes']} compute_s {rec['compute_s']:.6e} memory_s "
            f"{rec['memory_s']:.6e} collective_s {rec['collective_s']:.6e} trace_s "
            f"{rec['trace_s']} (wall {rec['wall_s']:.1f} s)")


def _same_costs(cuda, meta) -> list:
    """The op counts of two ``OpCost``s that differ, by op."""
    keys = sorted(set(cuda.by_op) | set(meta.by_op))
    return [(k, cuda.by_op.get(k), meta.by_op.get(k)) for k in keys
            if cuda.by_op.get(k) != meta.by_op.get(k)]


def phase_dryrun(trainer, profile: dict) -> dict:
    """(a) the meta sweep in worker processes; (b) the main path's coded
    step counted on the card and on meta; (c) its memory on the card;
    (d) its device time beside the roofline time; then, while the sweep
    ends, [tp]'s dry-run rank (``_tp_dryrun_rank``), returned as
    ``tp_ref``."""
    import numpy as np
    import torch

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.launch.dryrun import roofline
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.train.coded import make_coded_grad_fn
    from repro_torch.train.state import abstract_train_state, init_train_state
    from repro_torch.train.trainer import TrainConfig, make_coded_train_step
    from repro_torch.tune import analyze_memory, estimate_memory
    from repro_torch.tune.memory import tree_bytes

    t0 = time.perf_counter()
    sweep = _dryrun_sweep_start()

    # (b) the main path's coded step, counted on the card and on meta
    cfg, plan = trainer.cfg, trainer.plan
    n = trainer.n_workers
    wb_np = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    dec_w = plan.decode_weights(np.arange(n, dtype=np.float64)).astype(np.float32)
    step = make_coded_train_step(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300), plan)
    state = init_train_state(cfg, device="cuda", seed=0)
    wb = torch.as_tensor(wb_np, device="cuda")
    torch.cuda.synchronize()
    reset_counts()
    t1 = time.perf_counter()
    cuda = analyze_ops(step, state, wb, dec_w)
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t1
    launches = read_counts()
    meta_args = (abstract_train_state(cfg), torch.empty(wb.shape, dtype=wb.dtype,
                                                        device="meta"), dec_w)
    t1 = time.perf_counter()
    meta = analyze_ops(step, *meta_args)
    meta_s = time.perf_counter() - t1
    diff = _same_costs(cuda, meta)
    log(f"[dryrun] main path's coded step (N={n}, K={plan.k_shards}, seq 256, batch 8): cuda "
        f"flops {cuda.flops:.6e} bytes {cuda.bytes:.6e} transcendentals "
        f"{cuda.transcendentals:.6e} collectives {cuda.collective_counts} kernel calls "
        f"{cuda.kernel_calls} ({cuda_s:.2f} s); meta flops {meta.flops:.6e} bytes "
        f"{meta.bytes:.6e} transcendentals {meta.transcendentals:.6e} kernel calls "
        f"{meta.kernel_calls} loop trips {meta.loop_trips} ({meta_s:.2f} s); "
        f"launches {launches}; ops that differ {diff}")
    if (cuda.flops, cuda.transcendentals, cuda.collective_bytes, cuda.collective_counts) != \
            (meta.flops, meta.transcendentals, meta.collective_bytes, meta.collective_counts):
        raise AssertionError(f"the card's counts differ from meta's: {diff}")
    if cuda.bytes != meta.bytes or diff:
        raise AssertionError(f"the card's bytes differ from meta's by "
                             f"{cuda.bytes - meta.bytes}: {diff}")
    if not (launches["gc_fused"] == cuda.kernel_calls.get("gc_fused") ==
            meta.kernel_calls.get("gc_fused") == 1):
        raise AssertionError(f"gc_fused launched {launches['gc_fused']} times, counted "
                             f"{cuda.kernel_calls} on the card and {meta.kernel_calls} on "
                             "meta: want one counted combine per launch, one per step")

    # (c) memory of that step on the card
    mem = analyze_memory(step, state, wb, dec_w, device="cuda")
    meta_arg, meta_out = tree_bytes(meta_args), tree_bytes(meta.output)
    est = estimate_memory(plan, cfg=cfg, global_batch=8, seq_len=256).total
    log(f"[dryrun] memory of the step on the card: argument bytes {mem['argument_bytes']} "
        f"(meta {meta_arg}), output bytes {mem['output_bytes']} (meta {meta_out}), peak "
        f"{mem['peak_bytes']} (temp {mem['temp_bytes']}); peak / estimate_memory "
        f"{mem['peak_bytes'] / est:.3f} (estimate {est:.0f}), peak / (argument + output) "
        f"{mem['peak_bytes'] / (meta_arg + meta_out):.3f}")
    if mem["argument_bytes"] != meta_arg:
        raise AssertionError(f"argument bytes {mem['argument_bytes']} on the card, {meta_arg} "
                             "on meta")
    if mem["peak_bytes"] < mem["argument_bytes"]:
        raise AssertionError(f"peak {mem['peak_bytes']} below the arguments' "
                             f"{mem['argument_bytes']} bytes")

    # (d) the coded gradients' device time beside their roofline time
    grads = analyze_ops(make_coded_grad_fn(cfg, plan), meta_args[0].params, meta_args[1],
                        dec_w)
    terms, step_terms = roofline(grads), roofline(meta)
    bound_ms = max(terms["compute_s"], terms["memory_s"]) * 1e3
    log(f"[dryrun] coded gradients: device busy {profile['busy_ms']:.1f} ms of wall "
        f"{profile['wall_ms']:.1f} ms under the profiler (phase 6) beside the dry run's "
        f"max(compute_s, memory_s) {bound_ms:.2f} ms (compute {terms['compute_s'] * 1e3:.2f}"
        f" ms, memory {terms['memory_s'] * 1e3:.2f} ms; busy / roofline "
        f"{profile['busy_ms'] / bound_ms:.2f}); the whole step's max(compute_s, memory_s) "
        f"{max(step_terms['compute_s'], step_terms['memory_s']) * 1e3:.2f} ms")
    del state, wb, cuda, mem
    torch.cuda.empty_cache()

    tp_ref = _tp_dryrun_rank()  # [tp]'s reference, while the sweep runs
    _dryrun_sweep_finish(sweep)
    log(f"[dryrun] phase {time.perf_counter() - t0:.1f} s")
    return {"launches": launches["gc_fused"], "tp_ref": tp_ref}


def _dryrun_sweep_start():
    """[dryrun] (a): every (arch, shape) case and the coded cases submitted
    to ``DRYRUN_WORKERS`` worker processes, the training and prefill
    cases first (the longest), so the pool's tail is short.  Returns the
    pool, its futures and the start time."""
    import concurrent.futures
    import multiprocessing

    from repro_torch.configs import INPUT_SHAPES, list_archs

    out_dir = os.path.join(ROOT, "artifacts", "dryrun_torch")
    cases = [(a, s, False) for a in list_archs() for s in INPUT_SHAPES]
    cases += [(a, "train_4k", True) for a in DRYRUN_CODED]
    first = {"train": 0, "prefill": 1, "decode": 2}
    cases.sort(key=lambda c: first[INPUT_SHAPES[c[1]].kind])
    pool = concurrent.futures.ProcessPoolExecutor(
        max_workers=min(DRYRUN_WORKERS, os.cpu_count() or 1),
        mp_context=multiprocessing.get_context("spawn"), initializer=_dryrun_init,
        initargs=(SRC,))
    return pool, [pool.submit(_dryrun_case, a, s, c, out_dir) for a, s, c in cases], \
        time.perf_counter()


def _dryrun_sweep_finish(sweep) -> list:
    """[dryrun] (a)'s records: a line each; no case fails, and the skips
    are the reference's.  Returns the records."""
    pool, futures, t0 = sweep
    recs = [f.result() for f in futures]
    pool.shutdown()
    for rec in recs:
        log(_dryrun_sweep_line(rec))
    fails = [(r["arch"], r["shape"], r["step"]) for r in recs if r["status"] == "fail"]
    skips = {(r["arch"], r["shape"]) for r in recs if r["status"] == "skip"}
    if fails:
        raise AssertionError(f"dry-run cases failed: {fails}")
    if skips != DRYRUN_SKIPS:
        raise AssertionError(f"skips {sorted(skips)}, the reference's {sorted(DRYRUN_SKIPS)}")
    meshes = {tuple(r["mesh_shape"]) for r in recs if r["status"] == "ok"}
    log(f"[dryrun] {len(recs)} cases on {sorted(meshes)} ({DRYRUN_WORKERS} workers): "
        f"{len(recs) - len(skips)} ok, {len(skips)} skipped as the reference skips them; "
        f"slowest {max(r['wall_s'] for r in recs):.1f} s; the sweep "
        f"{time.perf_counter() - t0:.1f} s")
    return recs


def phase_adapt():
    """Adaptive re-planning of gc-lm-110m at full width cut to
    ``CUT_LAYERS`` layers: the swap comes after the predicted step, ``gc_fused`` launches once per step across it, and
    the coded gradient under the new plan equals the uncoded one.
    Returns the counts of this path."""
    import torch

    from repro_torch.adapt import AdaptConfig
    from repro_torch.core import DegradedWorker, Env, ShiftedExponential

    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 4).with_faults(
        *(DegradedWorker(**f) for f in ADAPT_FAULTS))
    t0 = time.perf_counter()
    trainer = make_trainer(env, adapt=AdaptConfig(window=16, min_rounds=8, check_every=2),
                           n_layers=CUT_LAYERS)
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
    """The wave-pipelined loop of gc-lm-110m at full width cut to
    ``CUT_LAYERS`` layers: staleness 0 is byte-equal
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

    bar = make_trainer(n_layers=CUT_LAYERS)
    init = params_to_numpy(bar.state.params)
    bar_launches, bar_wall = counted(bar, 3)
    want = _snapshot(bar.state.checkpoint_tree())
    bar_losses = [h["loss"] for h in bar.history]
    bar_times = [r["times"] for r in bar.sim.ledger]
    del bar
    torch.cuda.empty_cache()
    trainer = make_trainer(params=init, wave=WaveConfig(staleness=0, **WAVE_COSTS),
                           n_layers=CUT_LAYERS)
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
    n_levels = trainer.plan.flat_layout.n_levels  # one decode event per level and round
    if wave1_launches["gc_fused"] != n_decode or n_decode != n_levels * WAVE_ROUNDS:
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


def _tune_env():
    """Workers 2 and 3 five times slower than 0 and 1 (the [adapt]
    phase's population from its first round): not i.i.d., so the tuner
    prices with the ``mc`` backend."""
    from repro_torch.core import Env, ScaledStraggler, ShiftedExponential

    fast = ShiftedExponential(mu=1e-3, t0=50.0)
    return Env.heterogeneous([fast] * 2 + [ScaledStraggler(base=fast, factor=5.0)] * 2)


def _same_reports(got, want) -> float:
    """Raise unless two ``TuneReport``s hold the same candidates in the same
    order, pruned for the same reasons, with equal memory and the same
    best; returns the largest relative time difference (bound 1e-6)."""
    worst = 0.0
    for part in ("candidates", "pruned"):
        a, b = getattr(got, part), getattr(want, part)
        if [c.key() for c in a] != [c.key() for c in b] \
                or [c.prune_reason for c in a] != [c.prune_reason for c in b]:
            raise AssertionError(f"[tune] the card's {part} differ from the CPU's")
        for ca, cb in zip(a, b):
            if ca.mem.to_dict() != cb.mem.to_dict() or ca.x != cb.x:
                raise AssertionError(f"[tune] {ca.label()}: memory or x differ")
            rel = abs(ca.time - cb.time) / abs(cb.time)
            if not rel <= 1e-6:
                raise AssertionError(f"[tune] {ca.label()}: time {ca.time} on the card, "
                                     f"{cb.time} on the CPU")
            worst = max(worst, rel)
    if got.best.key() != want.best.key():
        raise AssertionError(f"[tune] best {got.best.label()} != {want.best.label()}")
    return worst


def phase_tune():
    """The autotuner at full width: its report on the card equals the CPU's;
    the winning plan's ``mc`` ledger on the card agrees with ``eq2``; a
    ``Trainer(scheme="auto")`` adopts the winner and launches ``gc_fused``
    once per step.  Returns the counts of the training path."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.sim import mc
    from repro_torch.tune import MemBudget, autotune

    env, budget = _tune_env(), MemBudget.from_gb(TUNE_HBM_GB)
    cfg = get_config("gc-lm-110m").replace(max_seq=512)
    kw = dict(global_batch=8, seq_len=256, seed=0)
    t0 = time.perf_counter()
    res = autotune(cfg, env, budget, device="cuda", **kw)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    res_cpu = autotune(cfg, env, budget, device="cpu", **kw)
    t_cpu = time.perf_counter() - t0
    report, best = res.report, res.best
    if report.backend != "mc":
        raise AssertionError(f"[tune] backend {report.backend}, expected mc")
    if not report.pruned or not report.candidates:
        raise AssertionError(f"[tune] the {budget} cap must prune some and admit some: "
                             f"{len(report.candidates)} admissible, {len(report.pruned)} pruned")
    worst = _same_reports(report, res_cpu.report)
    log(f"[tune] autotune(gc-lm-110m, workers 2 and 3 5x slower, {budget}): backend mc on the "
        f"card, {len(report.candidates)} admissible, {len(report.pruned)} pruned; winner "
        f"{best.label()} x={best.x} s_max={best.s_max} time {best.time!r} (straggler "
        f"{best.straggler_time!r} + overhead {best.overhead_time!r}), estimate "
        f"{best.mem.total / 2**30:.4f} GiB; equal to the CPU's search (times within "
        f"{worst:.3e}); {t_card:.2f} s on the card, {t_cpu:.2f} s on the CPU")
    log("[tune] " + report.table(8).replace("\n", "\n[tune] "))

    plan = res.plan
    t0 = time.perf_counter()
    eq2 = plan.simulate(env, TUNE_SIM_STEPS, seed=0, backend="eq2")
    eq2_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    mcs = plan.simulate(env, TUNE_SIM_STEPS, seed=0, backend="mc", device="cuda")
    mc_s = time.perf_counter() - t0
    a = np.asarray([r["tau_coded"] for r in mcs.ledger])
    b = np.asarray([r["tau_coded"] for r in eq2.ledger])
    rel = float(np.max(np.abs(a - b) / np.abs(b)))
    if not all(np.array_equal(x["times"], y["times"]) for x, y in zip(mcs.ledger, eq2.ledger)) \
            or len(a) != TUNE_SIM_STEPS or not rel <= MC_EQ2_RTOL:
        raise AssertionError(f"[tune] mc vs eq2 over {TUNE_SIM_STEPS} steps: relative "
                             f"{rel:.3e} (bound {MC_EQ2_RTOL}) or times differ")
    times = np.stack([r["times"] for r in mcs.ledger])
    sched = mc.as_schedule(plan)
    call_ms = time_ms(lambda: mc.runtime_batch(sched, times, device="cuda"), 20)
    log(f"[tune] Plan.simulate({TUNE_SIM_STEPS} steps): mc tau_coded within {rel:.3e} of eq2 "
        f"(bound {MC_EQ2_RTOL}), times equal; mean tau_coded mc {float(a.mean())!r} eq2 "
        f"{float(b.mean())!r}; host time of the whole call: eq2 loop {eq2_s:.3f} s, mc "
        f"{mc_s:.3f} s (draws included); one mc.runtime_batch of the {TUNE_SIM_STEPS} x 4 "
        f"draws {call_ms:.4f} ms (CUDA events, host copy in and out included)")

    t0 = time.perf_counter()
    trainer = make_trainer(env, scheme="auto", budget=budget)
    if trainer.tune_report.best.key() != best.key() or \
            trainer.plan.to_dict() != plan.to_dict():
        raise AssertionError("[tune] the trainer's search differs from autotune's")
    knobs = (trainer.pipeline, trainer.reduce_mode, trainer.grad_dtype)
    if knobs != (best.pipeline, best.reduce_mode, best.grad_dtype):
        raise AssertionError(f"[tune] trainer knobs {knobs} != the report's best {best.label()}")
    log(f"[tune] Trainer(scheme='auto', budget={budget}): plan {trainer.plan.scheme} "
        f"x={trainer.plan.x.tolist()}, leaf levels {trainer.plan.leaf_levels.tolist()}, "
        f"knobs {knobs}; {time.perf_counter() - t0:.2f} s")
    check_coded_equals_uncoded(trainer, "tune")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(STEPS, log_every=0)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if launches["gc_fused"] != STEPS:
        raise AssertionError(f"[tune] gc_fused launched {launches['gc_fused']} times in "
                             f"{STEPS} steps, expected one per step")
    losses = [h["loss"] for h in trainer.history]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[tune] non-finite loss {losses}")
    peak, est = torch.cuda.max_memory_allocated(), best.mem.total
    log(f"[tune] {STEPS} steps in {wall:.2f} s, losses {losses}, launches {launches}; "
        f"max_memory_allocated {peak} bytes ({held} allocated when the steps began) against "
        f"the tuner's per-worker estimate {est:.0f} bytes (ratio {peak / est:.4f}; sim mode "
        "holds all N·K rows on one card)")
    del trainer
    torch.cuda.empty_cache()
    return launches


def _spmd_rank(rank, world, axis_losses):
    """One rank of the [spmd] phase (``dist.spawn``: every rank on card 0
    over gloo).  Rank 0 logs; every check raises, and a rank's failure
    fails the whole job.  Returns this rank's counts and times."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
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
    trainer = make_trainer(mesh=mesh, mode="spmd", n_layers=CUT_LAYERS)
    cfg, plan, model = trainer.cfg, trainer.plan, trainer.state.params
    layout, paths = plan.flat_layout, model.leaf_paths()
    wb = coded_worker_batches(trainer.data, 0, world, plan.s_max)
    say(f"[spmd] {world} ranks on {torch.cuda.get_device_name(dev)} over gloo, each a "
        f"full-width trainer of {cfg.n_layers} layers (mode='spmd', K = {plan.k_shards} "
        f"shards per rank); {time.perf_counter() - t0:.2f} s")

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
    for a, b in zip(losses, axis_losses, strict=True):
        if not abs(a - b) <= 1e-4 * abs(b):
            raise AssertionError(f"spmd losses {losses} vs one process's {axis_losses}")
    walls = [h["wall_s"] for h in trainer.history]
    say(f"[spmd] {STEPS} steps of Trainer(mode='spmd'): losses {losses} (== one process's "
        f"within 1e-4), parameters byte-equal across ranks after every step; rank 0 launches "
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
        times = _rank_combine_times("spmd", trainer.step_fn.grad_fn.rows(model, wb), plan,
                                    layout, mesh)
    dist.barrier()
    return {"launches": launches["gc_fused"], "counts": counts, "walls": walls, "mem": mem,
            "coll_ms": coll_ms, "times": times, "scatter": scatter is None}


def _rank_combine_times(tag, rows, plan, layout, mesh) -> dict:
    """One rank's grouped combine of its per-shard ``rows`` into level
    buffers of ``layout`` (one launch, ``out=`` bit-equal to the
    allocating call and close to the plain version), timed device-only
    against ``torch.matmul`` in turns, host-inclusive, and against its
    bytes bound.  Logs one line under ``tag``; returns the times."""
    import torch

    from repro_torch.kernels import gc_fused, ref

    dev, k = rows[0].device, plan.k_shards
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
        raise AssertionError(f"[{tag}] the per-rank combine took "
                             f"{gc_fused.launches - before} launches, expected 1")
    err = 0.0
    alloc = gc_fused.encode_decode_leaves(one, table, which, rows)
    for j, (v, y, want) in enumerate(zip(views, alloc, ref.encode_decode_leaves_ref(
            one, table, which, rows))):
        if not torch.equal(v, y):
            raise AssertionError(f"[{tag}] out= leaf {j}: not bit-equal to the allocating call")
        err = max(err, check_close("gc_fused", v, want, "float32",
                                   f"{tag} leaf {j} NB=1 K={k} D={v.shape[1]}"))
    del alloc
    ws = [table[i] for i in which]
    fns = {"kernel": lambda: gc_fused.encode_decode_leaves(one, table, which, rows, out=views),
           "library": lambda: [torch.matmul(wt, g) for wt, g in zip(ws, rows)]}
    dev_ms = device_in_turns(fns, 10)
    n_cols = sum(layout.leaf_size(j) for j in range(layout.n_leaves))
    bytes_ms, ops_ms = bounds_ms((1 + k) * n_cols * 4 + layout.n_levels * k * 4, 2.0 * k * n_cols)
    times = {"device_ms": _mean(dev_ms["kernel"]),
             "library_device_ms": _mean(dev_ms["library"]),
             "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
             "ms": time_ms(fns["kernel"], 10), "library_ms": time_ms(fns["library"], 10),
             "plain_ms": time_ms(lambda: ref.encode_decode_leaves_ref(one, table, which, rows),
                                 10),
             "max_abs_err": err}
    log(f"[{tag}] per-rank combine (NB=1, K={k}, {layout.n_leaves} leaves of {n_cols} "
        f"columns in one launch into the level buffers, out= bit-equal to the allocating "
        f"call, max abs err {err:.3e} vs the plain version): device-only ms in turns "
        f"kernel/library/library/kernel {dev_ms}; means kernel {times['device_ms']:.4f} "
        f"library {times['library_device_ms']:.4f}; bound_ms {times['bound_ms']:.4f} (share "
        f"{times['bound_ms'] / times['device_ms']:.3f}); host-inclusive ms kernel "
        f"{times['ms']:.4f} library {times['library_ms']:.4f} plain {times['plain_ms']:.4f}")
    return times


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


def _axis_losses() -> list:
    """The losses of ``STEPS`` steps of a one-process (sim-mode) trainer of
    gc-lm-110m at ``CUT_LAYERS`` layers, the main path's settings and
    weights: what [spmd] and [tp] are held to."""
    import torch

    trainer = make_trainer(n_layers=CUT_LAYERS)
    trainer.run(STEPS, log_every=0)
    losses = [h["loss"] for h in trainer.history]
    del trainer
    torch.cuda.empty_cache()
    return losses


def phase_spmd():
    """spmd coded training on one card: ``SPMD_RANKS`` ranks on card 0
    over gloo (NCCL takes one card per rank), each a full-width
    ``Trainer(mode="spmd")`` of ``CUT_LAYERS`` layers.  Returns the
    ranks' gc_fused launches on the main path, summed, rank 0's combine
    times, and the one-process losses at that depth (``_axis_losses``)."""
    from repro_torch.dist.spawn import spawn

    axis_losses = _axis_losses()
    log(f"[spmd] one process, gc-lm-110m at {CUT_LAYERS} of 12 layers: {STEPS} steps, "
        f"losses {axis_losses} (what [spmd] and [tp] are held to)")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_spmd_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        ranks = spawn(_spmd_rank, SPMD_RANKS, axis_losses, store_dir=store, backend="gloo",
                      timeout=SPMD_LIMIT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    log(f"[spmd] {SPMD_RANKS} ranks done in {time.perf_counter() - t0:.1f} s; per rank "
        f"gc_fused launches {[r['launches'] for r in ranks]}, step wall_s "
        f"{[[round(w, 3) for w in r['walls']] for r in ranks]}, max_memory_allocated "
        f"{[r['mem'] for r in ranks]} bytes, psum ms per step {[r['coll_ms'] for r in ranks]}")
    return sum(r["launches"] for r in ranks), ranks[0]["times"], axis_losses


def _digest(tensors) -> str:
    """sha256 over the bytes of ``tensors``, in order."""
    import torch

    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def _gathered_coded(local, grad_fn, rows, plan, stragglers):
    """Yield ``(u, the model group's gathered spmd coded gradient)`` at each
    straggler count ``u`` from this rank's per-shard ``rows`` (its passes
    run once: the same rows whatever the stragglers): the spmd combine and
    its collectives per count (``grad_fn.combine``), gathered
    (``gather_model``) before the next combine reuses its buffers."""
    from repro_torch.models.params import gather_model

    for u in stragglers:
        ys = grad_fn.combine(rows, _straggler_dec_w(plan, u))
        yield u, gather_model(local, [y.reshape(t.shape) for y, t in zip(ys, local.leaves())])


def _tp_job(rank, world, axis_losses, moe_losses, families, ckpt_dir, tp_ref):
    """One rank of the eight-rank job (``dist.spawn``: every rank on card
    0 over gloo, a (data 4, model 2) mesh) that runs [mla-tp], [mamba-tp],
    [xlstm-tp] and [cross-tp]'s two parts (``families``: tag -> what
    ``_family_tp_rank`` holds it to), [xlstm-wide] (the same ranks as
    data 2 x model 4), [tp], [moe-tp], then [tp-state]'s
    trainers: one job, so the ranks start, reach the card and join the
    process group once.  ``tp_ref`` is [tp]'s dry-run rank
    (``_tp_dryrun_rank``).
    Returns this rank's results of each, and the seconds of each."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    mesh = make_local_mesh(TP_DATA, model=TP_MODEL, device="cuda:0", backend="gloo")
    out, seconds = {}, {}
    parts = [(tag, _family_tp_rank, (tag, fam)) for tag, fam in families.items()]
    if "xlstm-tp" in families:
        parts.append(("xlstm-wide", _xlstm_wide_rank, (families["xlstm-tp"]["wide"],)))
    parts += [("tp", _tp_rank, (axis_losses, tp_ref)), ("moe-tp", _moe_tp_rank, (moe_losses,)),
              ("tp-state", _tp_state_rank, (ckpt_dir,)),
              ("fsdp", _fsdp_rank, (ckpt_dir + "_fsdp",))]
    for part, fn, args in parts:
        torch.cuda.empty_cache()
        dist.barrier()
        t0 = time.perf_counter()
        out[part] = fn(rank, world, mesh, *args)
        seconds[part] = time.perf_counter() - t0
    out["seconds"] = seconds
    return out


def _fsdp_rank(rank, world, mesh, ckpt_dir):
    """[fsdp] on one rank of ``_tp_job``: gemma2-27b at ``FSDP_KW`` with
    ``fsdp`` set, a ``Trainer(mode="spmd")`` on the (data 4, model 2) mesh
    whose state each rank holds cut by ``data`` and ``model``
    (``init_shards(..., over_data=True)``), and the same trainer with
    ``fsdp`` off.  Each runs ``FSDP_STEPS`` steps, the launch counts set to 0
    just before the fsdp run (one ``gc_fused`` launch a step, on the
    working layout).  Every rank holds its slice of each parameter and
    moment with fsdp on within ``FSDP_OFF_REL`` of the same slice of its
    fsdp-off shard (the slice's scale, no larger than the leaf's), losses
    within 1e-6.  The fsdp trainer's checkpoint (every cut leaf gathered
    over both groups) restores into it, and into the fsdp-off trainer
    after its run, each byte-equal to what was saved.  Returns this rank's
    launches, worst errors, state bytes, peaks and step times."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import CkptConfig
    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.models.params import GCLM, data_dims, data_shard_of
    from repro_torch.train.trainer import TrainConfig, Trainer

    say = log if rank == 0 else (lambda *args: None)
    base = get_config("gemma2-27b").reduced(**FSDP_KW)
    paths = GCLM(base, device="meta").leaf_paths()
    cut = data_dims(base.replace(fsdp=True), mesh)

    def trainer(fsdp, **kw):
        return Trainer(base.replace(fsdp=fsdp), TrainConfig(lr=3e-4, warmup=1, total_steps=10),
                       ShiftedExponential(mu=1e-3, t0=50.0), n_workers=TP_DATA, scheme="xf",
                       global_batch=8, seed=0, device=mesh.device, mesh=mesh, mode="spmd",
                       seq_len=FSDP_SEQ, **kw)

    def trees(state, sliced=False):
        """The parameters and both moments, each cut to the rank's data
        slice when ``sliced`` (a state with fsdp off)."""
        out = [state.params.leaves(), state.opt["m"], state.opt["v"]]
        return [[data_shard_of(t, d, mesh) for t, d in zip(ts, cut)] for ts in out] if sliced \
            else out

    out, runs, worst = {}, {}, {}
    for fsdp in (True, False):
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        dist.barrier()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        tr = trainer(fsdp, ckpt=CkptConfig(dir=ckpt_dir, resume=False))
        state_bytes = sum(t.numel() * t.element_size() for t in
                          tr.state.params.leaves() + tr.state.opt["m"] + tr.state.opt["v"])
        torch.cuda.synchronize()
        dist.barrier()
        if fsdp:
            reset_counts()
        tr.run(FSDP_STEPS, log_every=0)
        torch.cuda.synchronize()
        runs[fsdp] = dict(state_bytes=state_bytes,
                          mem=torch.cuda.max_memory_allocated(mesh.device),
                          walls=[h["wall_s"] for h in tr.history],
                          losses=[h["loss"] for h in tr.history])
        if fsdp:
            out["launches"] = read_counts()["gc_fused"]
            if out["launches"] != FSDP_STEPS:
                raise AssertionError(f"[fsdp] rank {rank}: gc_fused launched "
                                     f"{out['launches']} times in {FSDP_STEPS} steps, expected one "
                                     "per step")
            if tr.state.params.fsdp.dims != cut or None in cut:
                raise AssertionError(f"[fsdp] rank {rank}: leaves cut by data on "
                                     f"{tr.state.params.fsdp.dims}, expected every leaf on {cut}")
            # the checkpoint of the cut state, restored into itself
            saved = [[t.detach().clone() for t in ts] for ts in trees(tr.state)]
            mine = tr.state.digest()
            tr.save_checkpoint()
            t0 = time.perf_counter()
            tr.restore_checkpoint()
            out["restore_s"] = time.perf_counter() - t0
            if tr.state.digest() != mine:
                raise AssertionError(f"[fsdp] rank {rank}: the restored shards differ from "
                                     "the saved ones")
        else:
            for name, a, b in zip(("params", "m", "v"), saved, trees(tr.state, sliced=True)):
                worst[name] = _worst_rel(a, b, paths, FSDP_OFF_REL,
                                         f"[fsdp] rank {rank}'s {name} slices, fsdp on vs off")
            # the fsdp checkpoint restored with fsdp off: the rank's slices are
            # the fsdp state's at the save, byte for byte
            if tr.restore_checkpoint() != FSDP_STEPS or _digest(
                    [t for ts in trees(tr.state, sliced=True) for t in ts]) != _digest(
                    [t for ts in saved for t in ts]):
                raise AssertionError(f"[fsdp] rank {rank}: the fsdp checkpoint restored with "
                                     "fsdp off differs from the saved state")
        del tr
    on, off = runs[True], runs[False]
    for a, b in zip(on["losses"], off["losses"], strict=True):
        if not abs(a - b) <= 1e-6 * abs(b):
            raise AssertionError(f"[fsdp] losses {on['losses']} with fsdp on vs "
                                 f"{off['losses']} off")
    say(f"[fsdp] {smi_line() if rank == 0 else ''}: {world} ranks, (data {TP_DATA}, model "
        f"{TP_MODEL}), gemma2-27b at {FSDP_KW}, "
        f"{FSDP_SEQ} tokens: {FSDP_STEPS} steps with fsdp on (one gc_fused launch a step) and off, "
        f"rank 0's slices of params, m and v within {FSDP_OFF_REL} of the slice's scale (worst "
        + ", ".join(f"{k} {v:.3e}" for k, v in worst.items())
        + f"); losses {on['losses']}; rank 0's state (params and two moments) "
        f"{on['state_bytes']:,} bytes on vs {off['state_bytes']:,} off, max_memory_allocated "
        f"{on['mem']:,} vs {off['mem']:,}; step wall_s {[round(w, 3) for w in on['walls']]} "
        f"vs {[round(w, 3) for w in off['walls']]}; the fsdp checkpoint restored into itself "
        f"and, after its run, into the fsdp-off trainer byte-equal ({out['restore_s']:.2f} s "
        "restore)")
    dist.barrier()
    return dict(out, worst=worst, state_bytes=(on["state_bytes"], off["state_bytes"]),
                mem=(on["mem"], off["mem"]), walls=(on["walls"], off["walls"]))


def _xlstm_wide_rank(rank, world, mesh, wide):
    """[xlstm-wide] on one rank of ``_tp_job``: the job's ranks as a (data
    2, model 4) mesh (``build_mesh`` over the same process group), each a
    ``Trainer(mode="spmd")`` of ``wide["cfg"]`` (2 heads: the axis splits
    ``d_inner`` and leaves the heads whole, each head on 2 ranks) at
    ``wide["seq_len"]`` tokens.  One step with the counts set to 0 just
    before: one grouped ``gc_fused`` call a rank, a finite loss, the
    collectives the formula (``_step_counts`` at model 4: per pass an
    mLSTM layer's gather of its conv's output and x_m, its reduce-scatter
    and 3 copies, the sLSTM's 3 gathers).  From that step's own rows, at
    0 and s_max stragglers, the model groups' gathered coded gradients
    within ``XLSTM_WIDE_REL`` of each leaf's scale of the one-process
    sim-mode ones (``_xlstm_wide_sim``; ``b_i`` at its ``b_f``'s).  Rank 0
    logs; every check raises."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
    from repro_torch.dist.mesh import build_mesh
    from repro_torch.kernels import _pipe
    from repro_torch.train.coded import local_layout
    from repro_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    w, cfg = XLSTM_WIDE, wide["cfg"]
    wide_mesh = build_mesh(w["data"], 1, mesh.device, model=w["model"])
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=w["data"], scheme="xf",
                      global_batch=8, seed=0, device=mesh.device, seq_len=wide["seq_len"],
                      mesh=wide_mesh, mode="spmd")
    plan, local = trainer.plan, trainer.state.params
    if [int(v) for v in plan.x] != wide["x"] or local.tp.axes != {"d_inner", "mlp", "vocab"}:
        raise AssertionError(f"[xlstm-wide] rank {rank}: plan x {plan.x} (sim mode's "
                             f"{wide['x']}), split axes {sorted(local.tp.axes)}")
    paths, layout = local.leaf_paths(), local_layout(cfg, plan, wide_mesh)
    wb = coded_worker_batches(trainer.data, 0, w["data"], plan.s_max)
    take = _keep_step0_rows(trainer.step_fn.grad_fn)
    want = _step_counts(cfg, plan.k_shards, layout.n_levels, model=w["model"])
    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    collectives.reset_counts()
    trainer.run(1, log_every=0)
    torch.cuda.synchronize()
    counts = {**collectives.counts, **collectives.model_counts}
    launches, loss = read_counts(), trainer.history[-1]["loss"]
    if counts != want or launches["gc_fused"] != per_step or not math.isfinite(loss):
        raise AssertionError(f"[xlstm-wide] rank {rank}: collectives {counts} (the formula "
                             f"{want}), launches {launches} (want {per_step}), loss {loss}")
    sim = torch.load(wide["sim"]) if rank == 0 else None
    worst = {}
    for u, got in _gathered_coded(local, trainer.step_fn.grad_fn, take(wb), plan,
                                  sorted({0, plan.s_max})):
        if rank == 0:
            worst[u] = _worst_rel_held(got.leaves(), [t.to(mesh.device) for t in sim[u]],
                                       paths, XLSTM_WIDE_REL,
                                       f"[xlstm-wide] gathered spmd vs sim mode, {u} "
                                       "stragglers", _b_i_partner)
        del got
    if rank == 0:
        log(f"[xlstm-wide] {cfg.name} reduced ({cfg.n_layers} layers, d_model {cfg.d_model}, "
            f"{cfg.n_heads} heads) on (data {w['data']}, model {w['model']}) at "
            f"{wide['seq_len']} tokens: split axes {sorted(local.tp.axes)} (the heads whole, "
            f"each on {w['model'] // cfg.n_heads} ranks); a rank holds {layout.total_elems:,} "
            f"of {plan.flat_layout.total_elems:,} parameters; one step: loss {loss}, "
            f"launches {launches}, collectives {counts} (the formula), bytes "
            f"{dict(collectives.nbytes)}; its rows' gathered coded gradients vs sim mode "
            f"(bound {XLSTM_WIDE_REL:.1e}): "
            + ", ".join(f"{u} stragglers {v:.3e}" for u, v in worst.items())
            + f"; {time.perf_counter() - t0:.1f} s")
    del trainer, local, sim
    torch.cuda.empty_cache()
    return {"launches": launches["gc_fused"], "worst": worst}


def _tp_rank(rank, world, mesh, axis_losses, tp_ref):
    """[tp] on one rank of ``_tp_job``.  Rank 0 logs; every check
    raises, and a rank's failure fails the whole job.  Returns this rank's
    launches, counts, bytes and times."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
    from repro_torch.models.params import gather_model
    from repro_torch.train.coded import local_layout, make_coded_grad_fn

    say = log if rank == 0 else (lambda *args: None)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    trainer = make_trainer(mesh=mesh, mode="spmd", n_layers=CUT_LAYERS)
    init_peak = torch.cuda.max_memory_allocated(mesh.device)
    cfg, plan, local = trainer.cfg, trainer.plan, trainer.state.params
    layout, paths = local_layout(cfg, plan, mesh), local.leaf_paths()
    replicated = [p for p, d in zip(paths, local.shard_dims) if d is None]
    if len(replicated) != 3 or layout.n_leaves != 11:
        raise AssertionError(f"rank {rank}: replicated leaves {replicated} of "
                             f"{layout.n_leaves}, expected the 3 norm scales of 11")
    wb = coded_worker_batches(trainer.data, 0, TP_DATA, plan.s_max)
    say(f"[tp] {world} ranks on {torch.cuda.get_device_name(mesh.device)} over gloo, a "
        f"(data {TP_DATA}, model {TP_MODEL}) mesh, each a full-width trainer of "
        f"{cfg.n_layers} layers (mode='spmd', K = {plan.k_shards} shards per rank) holding "
        f"{layout.total_elems:,} of {plan.flat_layout.total_elems:,} parameters "
        f"(replicated: {replicated}; level "
        f"buffers {list(layout.level_sizes)} of {list(plan.flat_layout.level_sizes)}); "
        f"{time.perf_counter() - t0:.2f} s; the trainer's peak allocation on the card "
        f"{init_peak:,} bytes (init_shards: shards, moments and one full leaf at a time; "
        f"the full fp32 tree alone is {4 * plan.flat_layout.total_elems:,} bytes)")

    # step 0: the model group's gathered gradients == rank 0's sim mode on
    # the full weights (the other ranks wait at the barrier)
    stragglers = sorted({0, 1, plan.s_max})
    full, sim = gather_model(local), {}
    if rank == 0:
        coded = make_coded_grad_fn(cfg, plan)
        rows = coded.rows(full, wb)
        for u in stragglers:
            sim[u] = coded.combine(rows, _straggler_dec_w(plan, u))
        del coded, rows
        torch.cuda.synchronize()
    del full
    dist.barrier()
    worst = {}
    fn = trainer.step_fn.grad_fn
    for u, got in _gathered_coded(local, fn, fn.rows(local, wb), plan, stragglers):
        if rank == 0:
            worst[u] = _worst_rel(got.leaves(), sim[u], paths, 1e-5,
                                  f"[tp] gathered spmd vs sim mode, {u} stragglers")
        del got
    del sim
    torch.cuda.empty_cache()
    say(f"[tp] step 0, the model groups' gathered coded gradients vs rank 0's sim mode "
        f"(worst leaf relative max error, bound 1e-5): "
        + ", ".join(f"{u} stragglers {w:.3e}" for u, w in worst.items()))

    # the main path: Trainer(mode="spmd") on the shards, counts set to 0 just
    # before; rank 0's first step under the op counter (_tp_counted_step)
    counted = _tp_counted_step(trainer) if rank == 0 else {}
    torch.cuda.synchronize()
    dist.barrier()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    reset_counts()
    collectives.reset_counts()
    for i in range(STEPS):
        trainer.run(1, log_every=0)
        torch.cuda.synchronize()
        leaves = trainer.state.params.leaves()
        mine = (_digest(leaves),
                _digest([t for t, d in zip(leaves, local.shard_dims) if d is None]))
        every = [None] * world
        dist.all_gather_object(every, mine)
        for r, (d_all, d_rep) in enumerate(every):
            if r % TP_MODEL == mesh.model_index and d_all != mine[0]:
                raise AssertionError(f"rank {rank}: parameters differ from rank {r}'s (the "
                                     f"same model index) after step {i + 1}")
            if d_rep != mine[1]:
                raise AssertionError(f"rank {rank}: replicated leaves differ from rank {r}'s "
                                     f"after step {i + 1}")
    counts, model_counts = dict(collectives.counts), dict(collectives.model_counts)
    nbytes = dict(collectives.nbytes)
    launches = read_counts()
    mem = torch.cuda.max_memory_allocated(mesh.device)
    if launches["gc_fused"] != STEPS:
        raise AssertionError(f"rank {rank}: gc_fused launched {launches['gc_fused']} times "
                             f"in {STEPS} steps, expected one per step")
    if counts != dict(psum=STEPS * layout.n_levels, psum_scatter=0, all_gather=0,
                      broadcast=STEPS):
        raise AssertionError(f"rank {rank}: collectives {counts} in {STEPS} steps, expected "
                             "one psum per level over the data group and one draw check "
                             "per step")
    losses = [h["loss"] for h in trainer.history]
    for a, b in zip(losses, axis_losses, strict=True):
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"[tp] losses {losses} vs one process's {axis_losses}")
    if rank == 0:
        _tp_check_counted(trainer, counted, wb, tp_ref)
    walls = [h["wall_s"] for h in trainer.history]
    data_bytes = nbytes["psum"] / STEPS
    model_bytes = sum(nbytes[k] for k in model_counts) / STEPS
    say(f"[tp] {STEPS} steps of Trainer(mode='spmd'): losses {losses} (== one process's "
        f"within 1e-5), every leaf byte-equal across the {TP_DATA} data ranks of a model "
        f"index and "
        f"the replicated leaves across all {world} after every step; rank 0 launches "
        f"{launches}, data-group collectives {counts}, model-group all-reduces "
        f"{model_counts}; step wall_s {[round(w, 3) for w in walls]}; bytes per rank per "
        f"step: data group (the level buffers) {data_bytes:,.0f}, model group "
        f"{model_bytes:,.0f} ({ {k: nbytes[k] // STEPS for k in model_counts} }); "
        f"max_memory_allocated {mem} bytes")

    # rank 0's combine over its local rows while the others wait (every
    # rank runs the passes: the model group's collectives take both)
    times = {}
    rows = trainer.step_fn.grad_fn.rows(local, wb)
    torch.cuda.synchronize()
    dist.barrier()
    if rank == 0:
        times = _rank_combine_times("tp", rows, plan, layout, mesh)
    del rows, trainer, local
    dist.barrier()
    return {"launches": launches["gc_fused"], "counts": counts, "model_counts": model_counts,
            "walls": walls, "mem": mem, "data_bytes": data_bytes, "model_bytes": model_bytes,
            "times": times}


def _tp_counted_step(trainer) -> dict:
    """Run the trainer's next step under the op counter
    (``analyze_ops`` around its ``step_fn``, once): returns a dict that
    the step fills with its ``OpCost`` and its ``gc_fused`` launches."""
    from repro_torch.launch.op_analysis import analyze_ops

    inner, counted = trainer.step_fn, {}

    def step(*args):
        trainer.step_fn = inner
        before = read_counts()["gc_fused"]
        counted["cost"] = analyze_ops(inner, *args, device=trainer.mesh.device)
        counted["launches"] = read_counts()["gc_fused"] - before
        return counted["cost"].output

    step.grad_fn = inner.grad_fn
    trainer.step_fn = step
    return counted


def _tp_dryrun_rank() -> dict:
    """[tp]'s reference for its counted step: the dry run's rank 0 of (data
    ``TP_DATA``, model ``TP_MODEL``) on meta (``launch.dryrun.build_case``,
    coded) at ``make_trainer``'s config and rows with the trainer's int32
    tokens, priced in the main process before the ranks start (a fresh
    rank's first meta op imports torch's compiler, ~13 s on the card's host
    while its peers wait; ``phase_dryrun`` prices it while its sweep
    runs).  Returns its ``OpCost`` (without the output),
    the plan's x, the worker batches' shape and the parameter counts."""
    import torch

    from repro_torch.configs import InputShape
    from repro_torch.dist.mesh import meta_mesh
    from repro_torch.launch import dryrun
    from repro_torch.launch.op_analysis import analyze_ops

    fn, args, extra = dryrun.build_case(_gc_lm(CUT_LAYERS), InputShape("tp", 256, 8, "train"),
                                        meta_mesh(TP_DATA, model=TP_MODEL), coded=True)
    wb = torch.empty(args[1].shape, dtype=torch.int32, device="meta")
    cost = analyze_ops(fn, args[0], wb, args[2])
    cost.output = None
    return {"cost": cost, "x": extra["x"], "wb_shape": tuple(wb.shape),
            "local_params": extra["local_params"], "params_b": extra["params_b"]}


def _tp_check_counted(trainer, counted, wb, ref) -> None:
    """[tp]: rank 0's step counted on the card (``_tp_counted_step``)
    equals the dry run's rank 0 on meta at (data 4, model 2)
    (``_tp_dryrun_rank``, on the same plan and inputs): FLOPs,
    transcendentals, collectives by kind and bytes, bytes, op for op, and
    one counted ``gc_fused`` call per launch."""
    cuda, meta = counted["cost"], ref["cost"]
    if ref["x"] != [int(v) for v in trainer.plan.x] or ref["wb_shape"] != tuple(wb.shape):
        raise AssertionError(f"[tp] the dry run's plan x {ref['x']} and batches "
                             f"{ref['wb_shape']}, the trainer's {trainer.plan.x} and {wb.shape}")
    diff = _same_costs(cuda, meta)
    log(f"[tp] rank 0's first step counted on the card: flops {cuda.flops:.6e} bytes "
        f"{cuda.bytes:.6e} transcendentals {cuda.transcendentals:.6e} collectives "
        f"{cuda.collective_counts} bytes {cuda.collective_bytes} kernel calls "
        f"{cuda.kernel_calls}, gc_fused launches {counted['launches']}; the dry run's rank 0 "
        f"of (data {TP_DATA}, model {TP_MODEL}) on meta: flops {meta.flops:.6e} bytes "
        f"{meta.bytes:.6e} transcendentals {meta.transcendentals:.6e} local params "
        f"{ref['local_params']:,} of {ref['params_b']:,}; ops that differ {diff}")
    if (cuda.flops, cuda.transcendentals, cuda.collective_bytes, cuda.collective_counts,
            cuda.bytes) != (meta.flops, meta.transcendentals, meta.collective_bytes,
                            meta.collective_counts, meta.bytes) or diff:
        raise AssertionError(f"[tp] the card's step differs from the dry run's rank: {diff}")
    if not (counted["launches"] == cuda.kernel_calls.get("gc_fused") ==
            meta.kernel_calls.get("gc_fused") == 1):
        raise AssertionError(f"[tp] gc_fused launched {counted['launches']} times, counted "
                             f"{cuda.kernel_calls} on the card and {meta.kernel_calls} on "
                             "meta: want one counted combine per launch")


#: a mixer's model-group all-reduces per pass on the model axis: (forward
#: reduces, backward copies).  Attention and a cross-attention mixer: the
#: output projection, the input; MLA: the output projection, the query
#: latent, the KV latent and the shared RoPE key; Mamba: ``x_proj`` and
#: ``out_proj``, the input and ``x_proj``'s reduced output; the mLSTM: the
#: gates (reduced, then copied) and ``down``, the input and the gates; the
#: sLSTM: none and the input (it gathers h: ``_layer_collectives``)
MIXER_COLLECTIVES = {"attn": (1, 1), "cross_attn": (1, 1), "mla": (1, 3), "mamba": (2, 2),
                     "mlstm": (2, 2), "slstm": (0, 1)}


def _layer_collectives(cfg, spec, model: int) -> dict:
    """One layer's model-group collectives per pass, written from the
    config: forward reduces and all-gathers, backward copies and
    reduce-scatters.  An MLP (a dense FFN, a MoE's shared experts or the
    sLSTM's GeGLU at their own width) splits where its width divides the
    axis: one reduce, one copy.  The sLSTM gathers its h over the heads:
    one all-gather.  Where the axis splits xLSTM's channels but not its
    heads (more ranks than heads), the mLSTM also gathers its conv's
    output and x_m (an all-gather forward, a reduce-scatter backward) and
    copies its replicated leaves' gradients in one all-reduce, and the
    sLSTM gathers its gates' input, ``b_gates`` and, where the rule splits
    it, ``r_gates`` instead of h.  A ``cross_source`` sublayer (Whisper's
    decoder) is a cross-attention: one reduce, one copy.  A MoE FFN split
    by expert (case a: ``shard_experts`` and E divides the axis) or by
    each expert's width (case b) reduces its output and copies its gates'
    and its input's gradients, and in case (a) gathers its router's
    logits; whole (case c) it makes none."""
    red, cop = MIXER_COLLECTIVES[spec.mixer]
    gather, scatter = int(spec.mixer == "slstm"), 0

    def mlp(width):
        return (1, 1) if width % model == 0 else (0, 0)

    if spec.mixer in ("mlstm", "slstm") and cfg.n_heads % model:
        if spec.mixer == "mlstm":
            cop, gather, scatter = cop + 1, 1, 1
        else:
            gather = 2 + int(4 * (cfg.d_model // cfg.n_heads) % model == 0)
    if spec.mixer == "slstm":
        r, k = mlp(int(round(4.0 / 3.0 * cfg.d_model)))
        red, cop = red + r, cop + k
    if spec.cross_source:
        red, cop = red + 1, cop + 1
    moe = spec.moe
    if moe is not None:
        by_expert = cfg.shard_experts and moe.num_experts % model == 0
        if by_expert or moe.d_ff % model == 0:
            red, cop, gather = red + 1, cop + 2, gather + int(by_expert)
        if moe.num_shared:
            r, k = mlp(moe.d_ff * moe.num_shared)
            red, cop = red + r, cop + k
    elif cfg.d_ff and spec.use_ffn:
        r, k = mlp(cfg.d_ff)
        red, cop = red + r, cop + k
    return dict(reduce=red, copy=cop, all_gather=gather, psum_scatter=scatter)


def _step_counts(cfg, k: int, n_levels: int, model: int = TP_MODEL, broadcast: int = 1) -> dict:
    """The collectives of one spmd step on a rank of the model axis: ``k``
    passes forward and backward and the step's monitoring forward — per
    forward every layer's (``_layer_collectives``), each encoder layer's
    attention and MLP reduces, and where the vocabulary splits the
    embedding's reduce and the loss's two and its max, each multi-token
    prediction module's embedding, layer (the last spec with a dense
    FFN), loss and max; per backward every layer's and encoder layer's
    copies and reduce-scatters, the source's one copy, and where the
    vocabulary splits the head's and each prediction module's head's
    copy — the clip's one reduce of the split leaves' squares, one psum
    per level over the data group and ``broadcast`` checks of the
    straggler draw (``Trainer.run``'s one; 0 for a loop that draws its
    own)."""
    import dataclasses

    specs = list(cfg.layers) + [dataclasses.replace(cfg.layers[-1], moe=None)] * cfg.mtp_depth
    per = [_layer_collectives(cfg, spec, model) for spec in specs]
    heads = (1 + cfg.mtp_depth) * int(cfg.vocab % model == 0)
    enc = 0 if cfg.encoder is None else cfg.encoder.n_layers * (1 + int(cfg.d_ff % model == 0))
    source = int(any(spec.mixer == "cross_attn" or spec.cross_source for spec in cfg.layers))
    red = 3 * heads + sum(p["reduce"] for p in per) + enc
    cop = heads + sum(p["copy"] for p in per) + enc + source
    gather = sum(p["all_gather"] for p in per)
    return dict(psum=n_levels, psum_scatter=k * sum(p["psum_scatter"] for p in per),
                broadcast=broadcast, all_gather=(k + 1) * gather, copy=k * cop,
                reduce=(k + 1) * red + 1, max=(k + 1) * heads)


def _moe_tp_rank(rank, world, mesh, moe_losses):
    """[moe-tp] on one rank of ``_tp_job``: ``mixtral-8x22b.reduced()`` in
    a ``Trainer(mode="spmd")`` over its shards in each of
    ``MOE_TP_CASES``.  At step 0, at each of ``MOE_TP_CAPACITIES`` with 0,
    1 and s_max stragglers, the model groups' gathered coded gradients
    equal rank 0's sim mode on the full weights (1e-5 of each leaf's
    scale); ``STEPS`` steps with the counts set to 0 just before: one
    ``gc_fused`` launch per rank per step, the losses [moe-train]'s
    (``moe_losses``, 1e-5), every leaf byte-equal across the data ranks
    of a model index after every step, the collectives of every step the
    formula (``_step_counts``).  Rank 0 logs; every check raises."""
    import torch
    import torch.distributed as dist

    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
    from repro_torch.models.moe import expert_split
    from repro_torch.models.params import gather_model
    from repro_torch.train.coded import local_layout, make_coded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    out = {"launches": 0, "cases": {}}
    for case, shard_experts in MOE_TP_CASES:
        t0 = time.perf_counter()
        base = get_config("mixtral-8x22b").reduced().replace(shard_experts=shard_experts)
        trainer = Trainer(base, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                          ShiftedExponential(mu=1e-3, t0=50.0), n_workers=TP_DATA,
                          scheme="xf", global_batch=8, seed=0, device=mesh.device,
                          seq_len=256, mesh=mesh, mode="spmd")
        plan, local = trainer.plan, trainer.state.params
        split = expert_split(local.tp)
        if split != {"a": "experts", "b": "expert_mlp"}[case]:
            raise AssertionError(f"[moe-tp] ({case}) the experts split on {split}")
        paths, layout = local.leaf_paths(), local_layout(base, plan, mesh)
        wb = coded_worker_batches(trainer.data, 0, TP_DATA, plan.s_max)
        stragglers = sorted({0, 1, plan.s_max})
        worst, dropped = {}, {}
        for cf in MOE_TP_CAPACITIES:
            cfg = _with_capacity(base, cf)
            full, sim = gather_model(local), {}
            if rank == 0:
                coded = make_coded_grad_fn(cfg, plan)
                with DropCensus() as census:
                    rows = coded.rows(full, wb)
                dropped[cf] = census.dropped()
                for u in stragglers:
                    sim[u] = coded.combine(rows, _straggler_dec_w(plan, u))
                del coded, rows
                torch.cuda.synchronize()
            del full
            dist.barrier()
            fn = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
            for u, got in _gathered_coded(local, fn, fn.rows(local, wb), plan, stragglers):
                if rank == 0:
                    worst[cf, u] = _worst_rel(
                        got.leaves(), sim[u], paths, 1e-5,
                        f"[moe-tp] ({case}) capacity {cf}: gathered spmd vs sim mode, "
                        f"{u} stragglers")
                del got
            del sim, fn
        if rank == 0 and (dropped[8.0] or not dropped[1.25]):
            raise AssertionError(f"[moe-tp] ({case}) dropped assignments by capacity factor: "
                                 f"{dropped}")
        torch.cuda.empty_cache()

        # the main path: Trainer(mode="spmd") on the shards, counts set to 0 just before
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        steps = []
        for i in range(STEPS):
            collectives.reset_counts()
            trainer.run(1, log_every=0)
            torch.cuda.synchronize()
            counts = {**collectives.counts, **collectives.model_counts}
            want = _step_counts(base, plan.k_shards, layout.n_levels)
            if counts != want:
                raise AssertionError(f"[moe-tp] ({case}) rank {rank} step {i + 1}: "
                                     f"collectives {counts}, the formula {want}")
            steps.append(dict(collectives.nbytes))
            every = [None] * world
            dist.all_gather_object(every, _digest(trainer.state.params.leaves()))
            if any(d != every[rank] for r, d in enumerate(every)
                   if r % TP_MODEL == mesh.model_index):
                raise AssertionError(f"[moe-tp] ({case}) rank {rank}: parameters differ from "
                                     f"its model index's after step {i + 1}")
        launches = read_counts()
        if launches != {"gc_fused": STEPS, "gc_encode": 0, "gc_decode": 0}:
            raise AssertionError(f"[moe-tp] ({case}) rank {rank}: launches {launches} in "
                                 f"{STEPS} steps, expected one gc_fused launch per step")
        losses = [h["loss"] for h in trainer.history]
        for a, b in zip(losses, moe_losses, strict=True):
            if not abs(a - b) <= 1e-5 * abs(b):
                raise AssertionError(f"[moe-tp] ({case}) losses {losses} vs [moe-train]'s "
                                     f"{moe_losses}")
        out["launches"] += launches["gc_fused"]
        out["cases"][case] = dict(split=split, losses=losses, seconds=time.perf_counter() - t0)
        if rank == 0:  # dropped and worst are rank 0's
            log(f"[moe-tp] ({case}) mixtral-8x22b reduced, experts split on {split!r} "
                f"(shard_experts={shard_experts}): a rank holds {layout.total_elems:,} of "
                f"{plan.flat_layout.total_elems:,} parameters; step 0, gathered coded gradients "
                f"vs rank 0's sim mode (bound 1e-5): "
                + "; ".join(f"capacity {cf} ({dropped[cf]} assignments dropped in the "
                            f"{TP_DATA * plan.k_shards} passes) "
                            + ", ".join(f"{u}: {worst[cf, u]:.3e}" for u in stragglers)
                            for cf in MOE_TP_CAPACITIES)
                + f"; {STEPS} steps: losses {losses} (== [moe-train]'s within 1e-5), leaves "
                f"byte-equal over the data ranks of a model index, launches {launches}, "
                f"collectives per step {counts} (the formula), bytes per step {steps[-1]}; "
                f"{time.perf_counter() - t0:.1f} s")
        del trainer, local
        torch.cuda.empty_cache()
    return out


def _family_tp_rank(rank, world, mesh, tag, fam):
    """[mla-tp], [mamba-tp], [xlstm-tp] or a part of [cross-tp] on one rank
    of ``_tp_job``: ``fam["cfg"]`` (``[deepseek-train]``'s,
    ``[jamba-train]``'s, ``[xlstm-tp-sim]``'s, ``[whisper-tp-sim]``'s or
    ``[vision-train]``'s config) in a ``Trainer(mode="spmd")`` over its
    shards at ``fam["seq_len"]`` tokens, as [moe-tp] runs Mixtral's; a
    model with a cross-attention source with its gates opened from the
    seed (``_open_gates``) and each step's ``worker_aux`` from the seed
    (``_worker_aux``).  The shards gathered back are the full model drawn
    from the same seed, byte for byte (Mamba's ``in_proj`` and the mLSTM's
    ``up`` cut in 2 blocks, the sLSTM's ``w_gates`` and ``b_gates`` in 4).
    ``STEPS`` steps with the counts set to 0 just before — ``Trainer.run``,
    or for a model with a source ``Trainer.step_fn`` with the trainer's
    straggler draws and ``worker_aux``, as that phase steps — one grouped
    ``gc_fused`` call per rank per step (its launches of at most
    ``MAX_LEAVES`` leaves), the losses that phase's (1e-5), every leaf
    byte-equal across the data ranks of a model index after every step,
    every step's collectives the formula (``_step_counts``).  Then, from
    the per-shard rows of the trainer's own step 0 (``_keep_step0_rows``),
    with 0, 1 and s_max stragglers, the model groups' gathered coded
    gradients equal that phase's sim-mode gradients on the same weights
    and batches (``fam["bound"]``, else 1e-5, of each leaf's scale; a leaf
    whose gradient is zero in exact arithmetic at ``fam["partner"]``'s;
    saved under ``fam["sim"]`` by that phase, so no rank recomputes
    them).  Rank 0 logs; every check raises."""
    import torch
    import torch.distributed as dist

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.dist import collectives
    from repro_torch.kernels import _pipe
    from repro_torch.models.model import has_source
    from repro_torch.models.params import GCLM, gather_model
    from repro_torch.train.coded import local_layout
    from repro_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    cfg, source = fam["cfg"], has_source(fam["cfg"])
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=TP_DATA, scheme="xf",
                      global_batch=8, seed=0, device=mesh.device, seq_len=fam["seq_len"],
                      mesh=mesh, mode="spmd")
    plan, local = trainer.plan, trainer.state.params
    if source:
        _open_gates(local, 0)
    paths, layout = local.leaf_paths(), local_layout(cfg, plan, mesh)
    blocked = [p for p, b in zip(paths, local.shard_blocks) if b > 1]
    gathered = gather_model(local).leaves()
    if rank == 0:
        full = GCLM(cfg, device=mesh.device, seed=0)
        if source:
            _open_gates(full, 0)
        if not all(torch.equal(a, b) for a, b in zip(gathered, full.leaves(), strict=True)):
            raise AssertionError(f"[{tag}] the gathered shards differ from the full model")
        del full
    del gathered
    rows = trainer.data.cfg.global_batch // TP_DATA
    inputs = [(coded_worker_batches(trainer.data, i, TP_DATA, plan.s_max),
               _worker_aux(cfg, i, TP_DATA, plan.s_max, rows)[1] if source else None)
              for i in range(STEPS)]
    # the main path: Trainer(mode="spmd") on the shards, counts set to 0 just before
    take = _keep_step0_rows(trainer.step_fn.grad_fn)
    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    want = _step_counts(cfg, plan.k_shards, layout.n_levels, broadcast=int(not source))
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    losses = []
    for i in range(STEPS):
        collectives.reset_counts()
        if source:  # as _cross_train steps: the trainer's draws, the step's worker_aux
            dec_w, _ = trainer.sim.step()
            wb, wa = inputs[i]
            trainer.state, metrics = trainer.step_fn(trainer.state, wb, dec_w, wa)
            losses.append(float(metrics["loss"]))
        else:
            trainer.run(1, log_every=0)
            losses.append(trainer.history[-1]["loss"])
        torch.cuda.synchronize()
        counts = {**collectives.counts, **collectives.model_counts}
        if counts != want:
            raise AssertionError(f"[{tag}] rank {rank} step {i + 1}: collectives {counts}, the "
                                 f"formula {want}")
        nbytes = dict(collectives.nbytes)
        every = [None] * world
        dist.all_gather_object(every, _digest(trainer.state.params.leaves()))
        if any(d != every[rank] for r, d in enumerate(every) if r % TP_MODEL == mesh.model_index):
            raise AssertionError(f"[{tag}] rank {rank}: parameters differ from its model "
                                 f"index's after step {i + 1}")
    launches = read_counts()
    if launches != {"gc_fused": STEPS * per_step, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[{tag}] rank {rank}: launches {launches} in {STEPS} steps, "
                             f"expected one grouped gc_fused call per step ({per_step} "
                             f"launches of at most {_pipe.MAX_LEAVES} of {len(paths)} leaves)")
    for a, b in zip(losses, fam["losses"], strict=True):
        if not abs(a - b) <= 1e-5 * abs(b):
            raise AssertionError(f"[{tag}] losses {losses} vs [{fam['phase']}]'s "
                                 f"{fam['losses']}")
    # step 0's gradient check on the main path's own rows
    stragglers = sorted({0, 1, plan.s_max})
    sim = torch.load(fam["sim"]) if rank == 0 else None
    partner = fam.get("partner") or (lambda p: None)
    bound = fam.get("bound", 1e-5)
    worst = {}
    for u, got in _gathered_coded(local, trainer.step_fn.grad_fn, take(*inputs[0]), plan,
                                  stragglers):
        if rank == 0:
            worst[u] = _worst_rel_held(got.leaves(), [t.to(mesh.device) for t in sim[u]],
                                       paths, bound,
                                       f"[{tag}] gathered spmd vs sim mode, {u} stragglers",
                                       partner)
        del got
    del sim
    if rank == 0:
        log(f"[{tag}] {cfg.name} ({cfg.n_layers} layers, d_model {cfg.d_model}, mixers "
            f"{sorted({l.mixer for l in cfg.layers})}, {cfg.dtype}, MTP depth "
            f"{cfg.mtp_depth}{', worker_aux' if source else ''}) on (data {TP_DATA}, model "
            f"{TP_MODEL}) at {fam['seq_len']} tokens: split axes {sorted(local.tp.axes)}, "
            f"blocked leaves {blocked}; a rank holds {layout.total_elems:,} of "
            f"{plan.flat_layout.total_elems:,} parameters; the gathered shards == the full "
            f"model byte for byte; step 0, gathered coded gradients vs [{fam['phase']}]'s sim "
            f"mode (bound {bound:.3e}): "
            + ", ".join(f"{u} stragglers {w:.3e}" for u, w in worst.items())
            + f"; {STEPS} steps: losses {losses} (== [{fam['phase']}]'s within 1e-5), leaves "
            f"byte-equal over the data ranks of a model index, launches {launches}, "
            f"collectives per step {counts} (the formula), bytes per step {nbytes}; "
            f"{time.perf_counter() - t0:.1f} s")
    del trainer, local
    torch.cuda.empty_cache()
    return {"launches": launches["gc_fused"], "losses": losses}


def phase_tp(axis_losses, moe_losses, families, tp_ref):
    """spmd coded training on a model axis on one card: a (data 4, model
    2) mesh of eight ranks on card 0 over gloo, each a full-width
    ``Trainer(mode="spmd")`` of ``CUT_LAYERS`` layers over its shards;
    the same job then runs [moe-tp], [mla-tp], [mamba-tp], [xlstm-tp] and
    [cross-tp] (``families``: tag -> the config's phase, its losses and its
    saved sim-mode gradients, which are removed after the job) and
    [tp-state]'s trainers
    (``_tp_job``), whose checkpoint stays in the returned work directory
    for ``phase_tp_state``; ``tp_ref`` is [tp]'s dry-run rank
    (``_tp_dryrun_rank``).  Returns the ranks' gc_fused launches on
    each part's main path, each summed over the ranks, rank 0's combine
    times, every rank's [tp-state] results and the work directory."""
    from repro_torch.dist.spawn import spawn

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_tp_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        jobs = spawn(_tp_job, TP_DATA * TP_MODEL, axis_losses, moe_losses, families,
                     os.path.join(work, "ckpt"), tp_ref,
                     store_dir=os.path.join(work, "spawn"), backend="gloo",
                     timeout=SPMD_LIMIT_S)
    except BaseException:
        shutil.rmtree(work, ignore_errors=True)
        raise
    finally:
        for fam in families.values():
            shutil.rmtree(os.path.dirname(fam["sim"]), ignore_errors=True)
            if "wide" in fam:
                shutil.rmtree(os.path.dirname(fam["wide"]["sim"]), ignore_errors=True)
    ranks = [j["tp"] for j in jobs]
    launches = {"tp": sum(r["launches"] for r in ranks)}
    if launches["tp"] != STEPS * TP_DATA * TP_MODEL:
        raise AssertionError(f"[tp] {launches['tp']} gc_fused launches, expected "
                             f"{STEPS * TP_DATA * TP_MODEL}")
    moe = [j["moe-tp"] for j in jobs]
    launches["moe-tp"] = sum(r["launches"] for r in moe)
    if launches["moe-tp"] != len(MOE_TP_CASES) * STEPS * TP_DATA * TP_MODEL:
        raise AssertionError(f"[moe-tp] {launches['moe-tp']} gc_fused launches, expected "
                             f"{len(MOE_TP_CASES) * STEPS * TP_DATA * TP_MODEL}")
    for tag, fam in families.items():
        launches[tag] = sum(j[tag]["launches"] for j in jobs)
        if launches[tag] != fam["launches"] * TP_DATA * TP_MODEL:
            raise AssertionError(f"[{tag}] {launches[tag]} gc_fused launches, expected "
                                 f"[{fam['phase']}]'s {fam['launches']} on each of "
                                 f"{TP_DATA * TP_MODEL} ranks")
    if "xlstm-tp" in families:
        launches["xlstm-wide"] = sum(j["xlstm-wide"]["launches"] for j in jobs)
        if launches["xlstm-wide"] != TP_DATA * TP_MODEL:
            raise AssertionError(f"[xlstm-wide] {launches['xlstm-wide']} gc_fused launches, "
                                 f"expected one on each of {TP_DATA * TP_MODEL} ranks")
    fsdp = [j["fsdp"] for j in jobs]
    launches["fsdp"] = sum(r["launches"] for r in fsdp)
    if launches["fsdp"] != FSDP_STEPS * TP_DATA * TP_MODEL:
        raise AssertionError(f"[fsdp] {launches['fsdp']} gc_fused launches, expected "
                             f"{FSDP_STEPS * TP_DATA * TP_MODEL}")
    sec = jobs[0]["seconds"]
    log(f"[tp] {len(ranks)} ranks done in {time.perf_counter() - t0:.1f} s ("
        + ", ".join(f"[{part}] {sec[part]:.1f} s" for part in sec)
        + f" of rank 0's job); gc_fused launches, all ranks {launches}; [tp] per rank "
        f"gc_fused launches {[r['launches'] for r in ranks]}, step "
        f"wall_s {[[round(w, 3) for w in r['walls']] for r in ranks]}, max_memory_allocated "
        f"{[r['mem'] for r in ranks]} bytes, data-group bytes per rank per step "
        f"{sorted({r['data_bytes'] for r in ranks})}, model-group "
        f"{sorted({r['model_bytes'] for r in ranks})}; [fsdp] worst slice error over the ranks "
        f"{ {k: max(r['worst'][k] for r in fsdp) for k in fsdp[0]['worst']} }, per rank state "
        "bytes (on, off) "
        f"{[r['state_bytes'] for r in fsdp]}, max_memory_allocated (on, off) "
        f"{[r['mem'] for r in fsdp]} bytes")
    return launches, ranks[0]["times"], [j["tp-state"] for j in jobs], work


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


class _RssPeak:
    """The peak of this process's resident set (``VmRSS``), GB, sampled
    every 20 ms on a thread while the block runs: a spawned rank's
    ``ru_maxrss`` starts at its parent's peak, so it cannot tell one
    rank's own."""

    def __init__(self):
        import threading

        self.gb, self._stop = 0.0, threading.Event()
        self._thread = threading.Thread(target=self._sample, daemon=True)

    @staticmethod
    def _now() -> float:
        try:
            with open("/proc/self/status") as f:
                for line in f:
                    if line.startswith("VmRSS:"):
                        return int(line.split()[1]) * 1024 / 1e9
        except OSError:
            pass
        return float("nan")

    def _sample(self):
        while True:
            self.gb = max(self.gb, self._now())
            if self._stop.wait(0.02):
                return

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self.gb = max(self.gb, self._now())


def _pieces_line(total: float, pieces: dict) -> str:
    rest = total - sum(pieces.values())
    return ", ".join(f"{k} {v:.3f}" for k, v in pieces.items()) + f", rest {rest:.3f}"


#: the host and device pieces of a coded save and restore, timed apart
SAVE_PIECES = ("_leaf_records", "_encode_digits", "_pack_uints", "_crc", "write_durable")
RESTORE_PIECES = ("_read_shard", "_crc", "_unpack_uints", "_encode_digits", "_solve_digits",
                  "_digits_to_stripe", "loaded_array")


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
        saved, restored = {}, {}
        spent = {"save": 0.0, "restore": 0.0, "snapshot": 0.0}
        pieces = {}
        orig_save, orig_restore = trainer.save_checkpoint, trainer.restore_checkpoint

        def snapshot(into, step):
            t = time.perf_counter()
            into[step] = _snapshot(trainer.state)
            torch.cuda.synchronize()
            spent["snapshot"] += time.perf_counter() - t

        def save():
            step = int(trainer.state.step)
            snapshot(saved, step)
            t = time.perf_counter()
            with Pieces(coded, SAVE_PIECES) as timer:
                path = orig_save()
            spent["save"] += time.perf_counter() - t
            pieces["save"] = timer.take()
            log(f"[ckpt] save at step {step}: {spent['save']:.2f} s; host peak RSS "
                f"{_peak_rss_gb():.2f} GB")
            return path

        def restore(missing=()):
            torch.cuda.synchronize()
            t = time.perf_counter()
            with Pieces(coded, RESTORE_PIECES) as timer:
                at = orig_restore(missing=missing)
                torch.cuda.synchronize()
            spent["restore"] += time.perf_counter() - t
            pieces["restore"] = timer.take()
            log(f"[ckpt] restore of step {at}: {spent['restore']:.2f} s; host peak RSS "
                f"{_peak_rss_gb():.2f} GB")
            snapshot(restored, at)
            return at

        trainer.save_checkpoint, trainer.restore_checkpoint = save, restore
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


def _tp_state_rank(rank, world, mesh, ckpt_dir):
    """[tp-state] on one rank of ``_tp_job``: (a) coded checkpoints, worker
    1's death, a forced re-plan, the restore and the replay; (c) the wave
    loop; (d) ``scheme="auto"``.  Rank 0 logs; every check raises, and a
    rank's failure fails the job.  Returns this rank's counts, digests,
    times and peaks."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.adapt import AdaptConfig
    from repro_torch.checkpoint import CkptConfig, CodedSpec
    from repro_torch.core import DegradedWorker, Env, ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.models.params import gather_model
    from repro_torch.train.coded import make_coded_grad_fn
    from repro_torch.train.wave import WaveConfig, WaveRunner
    from repro_torch.tune import MemBudget

    say = log if rank == 0 else (lambda *args: None)
    out = {"launches": {}}

    def counted(trainer, steps, part):
        torch.cuda.synchronize()
        dist.barrier()
        reset_counts()
        t0 = time.perf_counter()
        trainer.run(steps, log_every=0)
        torch.cuda.synchronize()
        out["launches"][part] = read_counts()
        return time.perf_counter() - t0

    # (a) coded checkpoints, a death, a forced re-plan, the restore
    trainer = make_trainer(mesh=mesh, mode="spmd", adapt=AdaptConfig(), seq_len=TP_STATE_SEQ,
                           n_layers=CUT_LAYERS,
                           ckpt=CkptConfig(dir=ckpt_dir, every=TP_CKPT_EVERY,
                                           coded=CodedSpec(n_shards=4, parity=1)))
    trainer.sim.env = trainer.env.with_faults(DegradedWorker(**TP_DEATH))
    saved, saved_alike, restored, gathered, spent, rss = {}, {}, {}, {}, {}, {}
    save, restore, manager_save = (trainer.save_checkpoint, trainer.restore_checkpoint,
                                   trainer.manager.save)

    def timed(what, fn, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with _RssPeak() as peak:
            got = fn(*args, **kwargs)
            torch.cuda.synchronize()
        spent[what] = spent.get(what, 0.0) + time.perf_counter() - t0
        rss[what] = peak.gb
        return got

    def timed_save():
        path = timed("save", save)
        saved[int(trainer.state.step)] = trainer.state.digest()
        # what the data ranks of a model index hold alike (all of it here:
        # the config does not set fsdp), for the parent's check that they agree
        saved_alike[int(trainer.state.step)] = trainer.state.replicated_digest()
        return path

    def timed_restore(missing=()):
        step = timed("restore", restore, missing=missing)
        restored[step] = trainer.state.digest()
        return step

    def teed_save(step, tree, extra=None, device=None):
        """rank 0: the save, with a digest (``TrainState.digest``'s) of the
        gathered leaves as they stream to the checkpoint."""
        h = hashlib.sha256()

        def tee():
            for key, leaf in tree:
                h.update(key.encode())
                h.update(torch.as_tensor(leaf).contiguous().reshape(-1).view(torch.uint8)
                         .numpy().tobytes())
                yield key, leaf

        path = manager_save(step, tee(), extra=extra, device=device)
        gathered[int(step)] = h.digest()
        return path

    trainer.save_checkpoint, trainer.restore_checkpoint = timed_save, timed_restore
    if rank == 0:
        trainer.manager.save = teed_save
    torch.cuda.synchronize()
    dist.barrier()
    reset_counts()
    t0 = time.perf_counter()
    trainer.run(3, log_every=0)  # no save, death or swap yet: 3 barrier steps, (c)'s reference
    barrier = (trainer.state.digest(), [h["loss"] for h in trainer.history])
    trainer.run(TP_STATE_STEPS - 3, log_every=0)
    torch.cuda.synchronize()
    out["launches"]["ckpt"] = read_counts()
    wall = time.perf_counter() - t0
    hist, evs = trainer.history, trainer.recoveries
    steps = [h["step"] for h in hist]
    want_steps = list(range(1, TP_DEATH_STEP + 1)) + [TP_CKPT_EVERY + 1]
    if len(evs) != 1 or (evs[0].step, evs[0].dead_workers, evs[0].ckpt_step) != \
            (TP_DEATH_STEP, (TP_DEATH["worker"],), TP_CKPT_EVERY) or evs[0].swap is None:
        raise AssertionError(f"rank {rank}: recoveries {evs}, expected one of worker "
                             f"{TP_DEATH['worker']} after step {TP_DEATH_STEP} to step "
                             f"{TP_CKPT_EVERY}, with a forced re-plan")
    swap = evs[0].swap
    if swap.x_new.tolist() != TP_SWAP_X or trainer.plan.x.tolist() != TP_SWAP_X:
        raise AssertionError(f"rank {rank}: the forced re-plan's x {swap.x_new.tolist()}, the "
                             f"CPU's {TP_SWAP_X}")
    if sorted(saved) != [TP_CKPT_EVERY] or sorted(restored) != [TP_CKPT_EVERY] \
            or restored[TP_CKPT_EVERY] != saved[TP_CKPT_EVERY]:
        raise AssertionError(f"rank {rank}: saves at {sorted(saved)}, restores to "
                             f"{sorted(restored)}, or the restored shards differ from the saved")
    first, replay = hist[TP_CKPT_EVERY]["loss"], hist[-1]["loss"]
    if steps != want_steps or replay != first:
        raise AssertionError(f"rank {rank}: steps {steps} (want {want_steps}), replayed loss "
                             f"{replay} vs {first}")
    launches = out["launches"]["ckpt"]
    want_encode = 2 if rank == 0 else 0  # the save's parity, the survivors' encode
    if launches["gc_fused"] != TP_STATE_STEPS or launches["gc_encode"] != want_encode:
        raise AssertionError(f"rank {rank}: launches {launches}, expected gc_fused "
                             f"{TP_STATE_STEPS} (one per step), gc_encode {want_encode}")
    say(f"[tp-state] (a) {world} ranks, (data {TP_DATA}, model {TP_MODEL}), each a full-width "
        f"trainer of {CUT_LAYERS} layers (mode='spmd', adapt=AdaptConfig(), "
        f"ckpt=CodedSpec(4, 1) every {TP_CKPT_EVERY}) on {TP_DEATH}: {TP_STATE_STEPS} steps "
        f"in {wall:.2f} s, steps {steps}; DeathWatch tripped after step {evs[0].step} (the "
        f"CPU's), forced re-plan x "
        f"{swap.x_old.tolist()} -> {swap.x_new.tolist()} (the CPU's), restore of step "
        f"{evs[0].ckpt_step} byte-equal to the save on every rank; replayed loss {replay} "
        f"== {first}; rank 0 save {spent['save']:.2f} s, restore {spent['restore']:.2f} s; "
        f"launches {launches}")
    out.update(ckpt=dict(spent=spent, rss=rss, gathered=gathered.get(TP_CKPT_EVERY),
                         saved=saved_alike[TP_CKPT_EVERY],
                         coords=(mesh.data_index, mesh.model_index)))
    del trainer, save, restore, manager_save
    torch.cuda.empty_cache()

    # (c) the wave loop: a fresh trainer at staleness 0 byte-equal to (a)'s
    # first 3 steps (barrier steps from the same weights and draws), then
    # 4 rounds of it at staleness 1
    trainer = make_trainer(mesh=mesh, mode="spmd", seq_len=TP_STATE_SEQ, n_layers=CUT_LAYERS,
                           wave=WaveConfig(staleness=0, **WAVE_COSTS))
    counted(trainer, 3, "wave0")
    if (trainer.state.digest(), [h["loss"] for h in trainer.history]) != barrier:
        raise AssertionError(f"rank {rank}: staleness 0 differs from the barrier loop")
    trainer.wave = WaveRunner(trainer, WaveConfig(staleness=1, **WAVE_COSTS))
    first = len(trainer.history)
    wall = counted(trainer, TP_WAVE_ROUNDS, "wave1")
    [trace], [executed] = trainer.wave.traces, trainer.wave.executed
    losses = [h["loss"] for h in trainer.history[first:]]
    launches = out["launches"]["wave1"]
    if executed != list(trace.events) or trainer.wave._strategy(trainer.plan) != "deferred":
        raise AssertionError(f"rank {rank}: staleness 1 did not execute the WaveTrace deferred")
    if launches["gc_fused"] != TP_WAVE_ROUNDS or len(losses) != TP_WAVE_ROUNDS or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"rank {rank}: staleness 1 launches {launches}, losses {losses}")
    say(f"[tp-state] (c) wave loop on the axis: staleness 0, 3 rounds, byte-equal to (a)'s 3 "
        f"barrier steps (shards and moments, every rank); staleness 1 (deferred), "
        f"{TP_WAVE_ROUNDS} rounds in {wall:.2f} s: executed events == WaveTrace "
        f"({len(trace.events)} events), realized staleness "
        f"{trace.realized_staleness().tolist()}, launches {launches} (one per round), losses "
        f"{[round(x, 4) for x in losses]}")
    del trainer
    torch.cuda.empty_cache()

    # (d) scheme="auto" on an i.i.d. env (eq2 prices it on the host) under
    # TUNE_HBM_GB; fp32 gradients pinned for the 1e-5 comparison
    t0 = time.perf_counter()
    budget = MemBudget.from_gb(TUNE_HBM_GB)
    trainer = make_trainer(Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 4), scheme="auto",
                           budget=budget, grad_dtype="fp32", mesh=mesh, mode="spmd",
                           seq_len=TP_STATE_SEQ, n_layers=CUT_LAYERS)
    tune_s = time.perf_counter() - t0
    cfg, plan, local = trainer.cfg, trainer.plan, trainer.state.params
    paths = local.leaf_paths()
    wb = coded_worker_batches(trainer.data, 0, TP_DATA, plan.s_max)
    stragglers = sorted({0, plan.s_max})
    full, sim = gather_model(local), {}
    if rank == 0:
        coded = make_coded_grad_fn(cfg, plan)
        rows = coded.rows(full, wb)
        for u in stragglers:
            sim[u] = coded.combine(rows, _straggler_dec_w(plan, u))
        del coded, rows
        torch.cuda.synchronize()
    del full
    dist.barrier()
    worst = {}
    fn = trainer.step_fn.grad_fn
    for u, got in _gathered_coded(local, fn, fn.rows(local, wb), plan, stragglers):
        if rank == 0:
            worst[u] = _worst_rel(got.leaves(), sim[u], paths, 1e-5,
                                  f"[tp-state] (d) gathered spmd vs sim mode, {u} stragglers")
        del got
    del sim
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    counted(trainer, 1, "auto")
    peak = torch.cuda.max_memory_allocated(mesh.device)
    launches = out["launches"]["auto"]
    loss = trainer.history[0]["loss"]
    if launches["gc_fused"] != 1 or not math.isfinite(loss):
        raise AssertionError(f"rank {rank}: scheme='auto' step launches {launches}, loss {loss}")
    best = trainer.tune_report.best
    say(f"[tp-state] (d) Trainer(scheme='auto', budget={budget}) on the axis: every rank's "
        f"search in {tune_s:.2f} s, winner {best.label()} x={best.x}, knobs "
        f"{(trainer.pipeline, trainer.reduce_mode, trainer.grad_dtype)} (fp32 pinned); step 0, "
        f"gathered coded gradients vs rank 0's sim mode (bound 1e-5): "
        + ", ".join(f"{u} stragglers {w:.3e}" for u, w in worst.items())
        + f"; 1 step, launches {launches}, loss {loss}")
    out.update(auto=dict(report=trainer.tune_report.to_dict(), plan=plan.to_dict(),
                         peak=peak, estimate=best.mem.total))
    del trainer, local
    torch.cuda.empty_cache()
    return out


def phase_tp_state(ranks, work):
    """A sharded state on the model axis: eight ranks on card 0 over gloo,
    (data 4, model 2), each a full-width ``Trainer(mode="spmd")`` over its
    shards — run in [tp]'s job, whose results ``ranks`` are — through (a)
    coded checkpoints, worker 1's death, a forced re-plan, the restore
    decoded on rank 0 alone and the replay; (b) the checkpoint (under
    ``work``, removed here) restored by one process (model 1) and saved
    again there; (c) the wave loop; (d) ``scheme="auto"``.  Returns the
    ranks' launches on these paths, summed by kernel."""
    import torch

    from repro_torch.checkpoint import CheckpointManager, CkptConfig, CodedSpec
    from repro_torch.core import Env, ShiftedExponential
    from repro_torch.tune import MemBudget, autotune

    ckpt_dir = os.path.join(work, "ckpt")
    try:
        ck = [r["ckpt"] for r in ranks]
        log(f"[tp-state] (a) per rank (data, model): save s "
            f"{[round(c['spent']['save'], 2) for c in ck]}, restore s "
            f"{[round(c['spent']['restore'], 2) for c in ck]}; host peak RSS GB (VmRSS "
            f"sampled every 20 ms) during the save {[round(c['rss']['save'], 2) for c in ck]}, "
            f"during the restore {[round(c['rss']['restore'], 2) for c in ck]} (rank 0 reads and "
            f"decodes; the others receive one broadcast per leaf)")
        for c in ck:
            if c["saved"] != ck[c["coords"][1]]["saved"]:  # data index 0, its model index
                raise AssertionError(f"[tp-state] rank {c['coords']}: the saved shards differ "
                                     "from its model index's data rank 0's")

        # (b) the axis's checkpoint in one process (model 1), saved again
        t0 = time.perf_counter()
        one = make_trainer(ckpt=CkptConfig(dir=ckpt_dir), seq_len=TP_STATE_SEQ,
                           n_layers=CUT_LAYERS)
        restore_s = time.perf_counter() - t0
        if int(one.state.step) != TP_CKPT_EVERY or one.state.digest() != ck[0]["gathered"]:
            raise AssertionError("[tp-state] (b) the one-process restore differs from the "
                                 "gathered state at the save")
        twin_dir = os.path.join(work, "twin")
        one.manager = CheckpointManager(CkptConfig(dir=twin_dir,
                                                   coded=CodedSpec(n_shards=4, parity=1)))
        t0 = time.perf_counter()
        one.save_checkpoint()
        save_s = time.perf_counter() - t0
        manifests = []
        for d in (ckpt_dir, twin_dir):
            with open(os.path.join(d, f"step_{TP_CKPT_EVERY:08d}", "manifest.json")) as f:
                manifests.append(json.load(f))
        axis, twin = manifests
        if axis["shards"] != twin["shards"] or axis["leaves"] != twin["leaves"]:
            raise AssertionError("[tp-state] (b) the axis's crc32s or leaf records differ from "
                                 "a one-process save of the same state")
        log(f"[tp-state] (b) one process (model 1) restored the axis's checkpoint of step "
            f"{TP_CKPT_EVERY} byte-equal to the gathered state ({restore_s:.2f} s with the "
            f"trainer's construction) and saved it again ({save_s:.2f} s): the same "
            f"{len(axis['shards'])} crc32s and {len(axis['leaves'])} leaf records")
        del one
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(work, ignore_errors=True)

    # (d) every rank's search == the same search in this process
    res = autotune(_gc_lm(CUT_LAYERS), Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 4),
                   MemBudget.from_gb(TUNE_HBM_GB), global_batch=8, seq_len=TP_STATE_SEQ,
                   seed=0, device="cuda")
    if ranks[0]["auto"]["report"] != res.report.to_dict() or \
            ranks[0]["auto"]["plan"] != res.plan.to_dict():
        raise AssertionError("[tp-state] (d) the ranks' search differs from this process's")
    peaks = [r["auto"]["peak"] for r in ranks]
    log(f"[tp-state] (d) the ranks' report == autotune in this process ({res.report.backend}, "
        f"{len(res.report.candidates)} admissible, {len(res.report.pruned)} pruned); a rank's "
        f"max_memory_allocated over the step {max(peaks):,} bytes (ranks {peaks}) beside the "
        f"tuner's per-worker estimate {ranks[0]['auto']['estimate']:,.0f} bytes (the whole "
        f"worker, no model axis)")
    total = {}
    for r in ranks:
        for part in r["launches"].values():
            for k, v in part.items():
                total[k] = total.get(k, 0) + v
    by_part = {p: sum(r["launches"][p]["gc_fused"] for r in ranks) for p in ranks[0]["launches"]}
    log(f"[tp-state] {len(ranks)} ranks (in [tp]'s job); launches on these paths, all "
        f"ranks: {total}; gc_fused by path {by_part}")
    return total


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
    fed its own generated tokens, and the prefill logits of prompt +
    generated tokens at the same positions.  The requests share one
    prompt length and one token count."""
    import numpy as np
    import torch

    outputs = torch.from_numpy(np.stack([r.output for r in reqs]).astype(np.int64)).to(device)
    return teacher_forced_tokens(cfg, model, outputs, len(reqs[0].prompt), dtype, device)


def teacher_forced_tokens(cfg, model, outputs, s: int, dtype, device, aux=None):
    """``teacher_forced`` of token rows ``outputs`` (B, S + T) whose first
    ``s`` are the prompt: each row prefilled at batch 1 into a slab of
    capacity S + T, then T - 1 decode steps fed the next tokens (a sharded
    ``model``: on its heads, the logits gathered).  ``aux``
    (B, ...): the rows' modality embeddings, for a model with a
    cross-attention source (every call recomputes the source from them)."""
    import torch

    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve import insert_request, make_slab

    max_len = outputs.shape[1]
    n = max_len - s
    slab = make_slab(cfg, outputs.shape[0], max_len, dtype=dtype, device=device, tp=model.tp)
    for slot in range(outputs.shape[0]):
        _, pref = prefill(cfg, model, outputs[slot:slot + 1, :s],
                          aux_inputs=None if aux is None else aux[slot:slot + 1],
                          target_len=max_len, last_only=True)
        insert_request(cfg, slab, pref, slot)
        del pref
    steps = []
    for t in range(n - 1):
        logits, _ = decode_step(cfg, model, slab, outputs[:, s + t, None], aux_inputs=aux)
        steps.append(logits[:, -1])
    del slab
    full, _ = prefill(cfg, model, outputs, aux_inputs=aux)
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
    held = torch.cuda.memory_allocated()
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
        f"max_memory_allocated {peak} bytes ({held} allocated when the run began)")
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


# ------------------------------------------------ serving on the model axis
def _tp_engine(cfg, model, g, slab_dtype, mesh=None) -> dict:
    """``g``'s requests — prompts (numpy, seed 0) and Poisson arrivals
    (seed 0) — through a ``ServeEngine`` of ``g``'s slots on a slab of
    ``slab_dtype`` behind the launcher's default coded tier, greedy, on
    ``mesh`` when given, one step at a time with the ``gc_*`` counts set
    to 0 just before the run and the collectives before each step: per
    step its host wall, the slots it admitted into, whether it decoded and
    its collectives with their bytes.  Every request completes and the
    clock is the tier's stream."""
    import numpy as np
    import torch

    from repro_torch.core import Env, ShiftedExponential
    from repro_torch.dist import collectives
    from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine
    from repro_torch.sim.arrivals import poisson_arrivals

    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), g["workers"])
    coded = CodedDecode.solve(env, objective="p99", seed=0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                size=(g["n_requests"], g["prompt_len"]))
    arrivals = poisson_arrivals(g["n_requests"], g["rate"], seed=0)
    eng = ServeEngine(cfg, model, ServeConfig(g["n_slots"], g["max_len"], slab_dtype),
                      coded=coded, device="cuda", mesh=mesh)
    reqs = [eng.submit(p, max_new=g["max_new"], arrival=float(t))
            for p, t in zip(prompts, arrivals)]
    torch.cuda.synchronize()
    reset_counts()
    steps, slots = [], []
    t0 = time.perf_counter()
    while True:
        waiting = [r for r in reqs if r.t_admit is None]
        n_lat = len(eng.step_latencies)
        collectives.reset_counts()
        t1 = time.perf_counter()
        more = eng.step()  # ends in the host's read of the step's tokens
        ms = (time.perf_counter() - t1) * 1e3
        steps.append(dict(ms=ms, admitted=[r.slot for r in waiting if r.t_admit is not None],
                          decoded=len(eng.step_latencies) - n_lat,
                          counts={**collectives.counts, **collectives.model_counts},
                          nbytes=dict(collectives.nbytes)))
        if not more:
            break
        slots.append([r.slot for r in reqs])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if not all(r.done and len(r.tokens) == g["max_new"] for r in reqs):
        raise AssertionError(f"unfinished: {[r.summary() for r in reqs if not r.done]}")
    replay = CodedDecode(env, coded.plan, seed=0).step_latencies(len(eng.step_latencies), seed=0)
    if not np.array_equal(np.asarray(eng.step_latencies), replay):
        raise AssertionError("the engine's clock is not the coded tier's stream")
    n_tokens = sum(len(r.tokens) for r in reqs)
    return dict(eng=eng, slots=slots, steps=steps, latencies=list(eng.step_latencies),
                reqs=[(list(r.tokens), r.t_admit, r.t_first, r.t_done, r.n_steps) for r in reqs],
                outputs=[r.output for r in reqs], wall=wall, tokens_per_s=n_tokens / wall,
                launches=launches, rows=eng.rows.rows)


def _serve_collectives(cfg, g, local_split, step) -> dict:
    """The collectives one engine step must make on a rank, with their
    bytes (fp32 activations): per decode of the rank's B rows, every
    layer's forward all-reduces (``_layer_collectives``) of (B, 1, d) —
    but Mamba's ``x_proj`` reduce, of width dt_rank + 2·d_state, and the
    mLSTM's gates, of width 2·heads — and one for the vocab-parallel
    embedding, one all-gather of the logits (B, 1, V) out, and per sLSTM
    one all-gather of its h (B, 1, d) out; per prefill on the rank (an
    admission into its rows) the same of (1, S, ·) and one all-gather of
    the last position's logits (1, 1, V); and, where the slots split over
    the data ranks, one gather of the step's int64 tokens (n_slots per
    column: the decode's, and the admissions' first).  A MoE layer adds,
    per decode on data-parallel slots, one all-gather of every slot's k
    int64 expert ids (the capacity's count), and split by expert (case a)
    one all-gather of the router's fp32 logits, (rows, E) out, per decode
    and per prefill."""
    b, rows, d = len(local_split), local_split, cfg.d_model
    mine = len([slot for slot in step["admitted"] if slot in rows])
    dec = step["decoded"]
    cols = bool(step["admitted"]) + dec
    token_gather = int(g["data"] > 1 and cols > 0)
    wide = router = ids = hs = 0
    narrow = []  # the widths of the reduces narrower than d
    for spec in cfg.layers:
        per = _layer_collectives(cfg, spec, g["model"])
        if spec.mixer == "mamba":
            narrow.append((cfg.mamba.dt_rank or -(-d // 16)) + 2 * cfg.mamba.d_state)
        elif spec.mixer == "mlstm":
            narrow.append(2 * cfg.n_heads)
        wide += per["reduce"] - (spec.mixer in ("mamba", "mlstm"))
        hs += spec.mixer == "slstm"
        router += per["all_gather"] - (spec.mixer == "slstm")
        ids += spec.moe is not None and g["data"] > 1
    moe = next((spec.moe for spec in cfg.layers if spec.moe is not None), None)
    n_red = wide + len(narrow) + 1
    counts = dict(psum=0, psum_scatter=0, broadcast=0, copy=0, max=0,
                  all_gather=dec * (1 + ids + router + hs) + mine * (1 + router + hs)
                  + token_gather,
                  reduce=n_red * (dec + mine))
    per_router = 4 * moe.num_experts if router else 0
    per_ids = 8 * g["n_slots"] * moe.top_k if ids else 0
    positions = dec * b + mine * g["prompt_len"]
    nbytes = dict(psum=0, psum_scatter=0, broadcast=0, copy=0, max=0,
                  all_gather=4 * cfg.vocab * (dec * b + mine) + 8 * g["n_slots"] * cols
                  * token_gather + dec * (ids * per_ids + router * per_router * b)
                  + mine * router * per_router * g["prompt_len"] + 4 * d * hs * positions,
                  reduce=4 * ((wide + 1) * d + sum(narrow)) * positions)
    return dict(counts=counts, nbytes=nbytes)


def _tp_serve_cfg(arch: str):
    if arch == "gc-lm-110m":
        return _cut(arch, TP_SERVE["n_layers"])
    return _cut(arch, GEMMA3_TP_SERVE["n_layers"]).replace(dtype="float32")


def _tp_serve_rank(rank, world, arch):
    """One rank of [tp-serve] (gc-lm-110m) or [gemma3-tp-serve] (gemma3-27b)
    (``dist.spawn``: every rank on card 0 over gloo): its shards drawn by
    ``init_shards`` (seed 0), the engine on an fp32 slab with every count
    set to 0 just before; for gc-lm-110m also teacher forcing on a bf16
    slab and the engine with bf16 activations on a bf16 slab.  Returns what
    the rank saw; the parent holds it to the one-rank engine."""
    import numpy as np
    import torch

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.params import count_params, init_shards

    g = TP_SERVE if arch == "gc-lm-110m" else GEMMA3_TP_SERVE
    mesh = make_local_mesh(g["data"], model=g["model"], device="cuda:0", backend="gloo")
    cfg = _tp_serve_cfg(arch)
    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats(mesh.device)
    local = init_shards(cfg, mesh, device=mesh.device, seed=0)
    out = dict(coords=(mesh.pod_index, mesh.data_index, mesh.model_index),
               params=count_params(local), init_s=time.perf_counter() - t0,
               init_peak=torch.cuda.max_memory_allocated(mesh.device))
    torch.cuda.reset_peak_memory_stats(mesh.device)
    run = _tp_engine(cfg, local, g, torch.float32, mesh=mesh)
    eng = run.pop("eng")
    trees = [t for seg in eng.slab for t in (seg if isinstance(seg, list) else [seg])]
    out["kv_heads"] = sorted({t["k"].shape[-2] for t in trees})
    out["ring"] = [(t["k"].shape[-3], int(t["pos"].max())) for t in trees]
    del eng, trees
    out["fp32"] = run
    out["peak"] = torch.cuda.max_memory_allocated(mesh.device)
    if arch == "gc-lm-110m":
        toks = torch.from_numpy(np.stack(run["outputs"][:2]).astype(np.int64)).to(mesh.device)
        got, want = teacher_forced_tokens(cfg, local, toks, g["prompt_len"], torch.bfloat16,
                                          mesh.device)
        out["teacher_bf16"] = _rel_err(got, want)
        del got, want
        run16 = _tp_engine(cfg.replace(dtype="bfloat16"), local, TP_SERVE_BF16, torch.bfloat16,
                           mesh=mesh)
        eng16 = run16.pop("eng")
        out["slab_bf16_bytes"] = sum(v.numel() * v.element_size() for seg in eng16.slab
                                     for k, v in seg.items() if k != "pos")
        del eng16
        out["bf16"] = dict(reqs=run16["reqs"], tokens_per_s=run16["tokens_per_s"])
        out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated(mesh.device))
    torch.cuda.synchronize()
    return out


def _spawn_tp_serve(arch: str, g: dict) -> list:
    from repro_torch.dist.spawn import spawn

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_tp_serve_", dir=os.path.join(ROOT, "build"))
    try:
        return spawn(_tp_serve_rank, g["data"] * g["model"], arch, store_dir=store,
                     backend="gloo", timeout=SPMD_LIMIT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)


def _check_tp_serve(tag, cfg, g, one, ranks, near_ties=None) -> dict:
    """Every rank's engine against the one-rank engine on the same weights:
    tokens, timestamps, slots and step latencies equal; no ``gc_*``
    launch; each step's collectives equal ``_serve_collectives``.  With
    ``near_ties`` (a model whose stack amplifies rounding: xLSTM), a
    request's tokens may part from one rank's at a near tie alone: its
    timestamps stay equal, and the rank's ``forced`` tokens of it
    (``_forced_tokens``: the mesh fed one rank's tokens) must equal one
    rank's after the part too; ``near_ties`` holds the one-rank logits at
    the first differing token and at every forced token that differs
    (``_near_ties``).  Returns rank 0's decode-only step walls (host
    clock, ms), its per-step collectives of the first decode-only step,
    the requests that parted (request, token) and the near ties."""
    import numpy as np

    parted, ties = set(), set()
    for r, rank in enumerate(ranks):
        run = rank["fp32"]
        for key in ("reqs", "slots", "latencies"):
            if run[key] == one[key]:
                continue
            if key == "reqs" and near_ties is not None and all(
                    a[1:] == b[1:] for a, b in zip(run[key], one[key], strict=True)):
                for i, (a, b) in enumerate(zip(run[key], one[key])):
                    if a[0] != b[0]:
                        j = next(j for j, (x, y) in enumerate(zip(a[0], b[0])) if x != y)
                        parted.add((i, j))
                        ties.add((i, j, a[0][j], b[0][j]))
                        # forced[t] follows one rank's token t: it predicts token t + 1
                        ties.update((i, t + 1, x, y) for t, (x, y) in
                                    enumerate(zip(run["forced"][i], b[0][1:], strict=True))
                                    if x != y)
                continue
            diff = sum(a != b for a, b in zip(run[key], one[key]))
            raise AssertionError(f"[{tag}] rank {r}: {key} differ from the one-rank "
                                 f"engine's ({diff} of {len(one[key])})")
        if any(run["launches"].values()):
            raise AssertionError(f"[{tag}] rank {r}: the serving path launched {run['launches']}")
        for i, step in enumerate(run["steps"]):
            want = _serve_collectives(cfg, g, run["rows"], step)
            got = dict(counts={k: step["counts"][k] for k in want["counts"]},
                       nbytes={k: step["nbytes"][k] for k in want["nbytes"]})
            if got != want or sum(step["counts"].values()) != sum(want["counts"].values()):
                raise AssertionError(f"[{tag}] rank {r} step {i}: collectives {step} vs the "
                                     f"formula {want}")
    if ties:
        near_ties(sorted(ties))
    steady = [s for s in ranks[0]["fp32"]["steps"] if s["decoded"] and not s["admitted"]]
    return dict(walls=[s["ms"] for s in steady], per_step=steady[0],
                one_walls=[s["ms"] for s in one["steps"] if s["decoded"] and not s["admitted"]],
                median=float(np.median([s["ms"] for s in steady])), parted=sorted(parted),
                ties=sorted(ties))


def _forced_tokens(cfg, model, run, want, g, device) -> dict:
    """For each request of the engine's ``run`` whose tokens part from
    ``want`` (one rank's prompt and tokens, by request), the greedy tokens
    of ``model`` fed ``want``'s tokens (``teacher_forced_tokens``: each
    row prefilled, then a decode step per token, fp32 slab): {request:
    the ``max_new`` - 1 tokens, the t-th following ``want``'s token t}.
    Every rank of a model group holds the same tokens, so its ranks run
    the same forwards."""
    import numpy as np
    import torch

    parted = [i for i, (a, b) in enumerate(zip(run["outputs"], want, strict=True))
              if not np.array_equal(a, b)]
    if not parted:
        return {}
    toks = torch.from_numpy(np.stack([want[i] for i in parted]).astype(np.int64)).to(device)
    steps, _ = teacher_forced_tokens(cfg, model, toks, g["prompt_len"], torch.float32, device)
    return {i: steps[:, k].argmax(-1).tolist() for k, i in enumerate(parted)}


def _near_ties(tag, cfg, outputs, prompt_len: int):
    """The check of ``_check_tp_serve``'s ``near_ties`` for ``cfg`` (its
    one-rank model drawn again from seed 0): at each token where the mesh
    and one rank differ (request, token, mesh's, one rank's), the one-rank
    model's fp32 logits of its prefix (``prefill``, last position), from
    ``outputs`` (each request's prompt and one rank's tokens), rank the two
    tokens first and second, within ``SERVE_FP32_REL`` of the largest
    logit of each other (the fp32 cache and step's own rounding: the
    teacher-forcing bound).  Raises otherwise; logs each tie."""
    import torch

    from repro_torch.models.model import prefill
    from repro_torch.models.params import GCLM

    def check(parted):
        model = GCLM(cfg, device="cuda", seed=0)
        for i, j, got, want in parted:
            prefix = torch.as_tensor(outputs[i][:prompt_len + j], device="cuda")[None].long()
            logits, _ = prefill(cfg, model, prefix, last_only=True)
            top = logits[0, -1].float()
            vals, ids = top.topk(2)
            margin = ((vals[0] - vals[1]) / top.abs().max()).item()
            if sorted(ids.tolist()) != sorted([got, want]) or not margin <= SERVE_FP32_REL:
                raise AssertionError(f"[{tag}] request {i}, token {j}: the mesh's {got} vs one "
                                     f"rank's {want}: top-2 {ids.tolist()} apart by "
                                     f"{margin:.3e} of the largest logit (bound "
                                     f"{SERVE_FP32_REL})")
            log(f"[{tag}] request {i}, token {j}: the mesh's {got} vs one rank's {want}: a "
                f"near tie, the two top-2 and {margin:.3e} of the largest logit apart")
        del model
        torch.cuda.empty_cache()

    return check


def phase_tp_serve():
    """Serving on the model axis: gc-lm-110m at its published widths cut
    to ``TP_SERVE["n_layers"]`` layers on a (data 2, model 2) mesh of four
    ranks on card 0 over gloo, each holding its
    shards (``init_shards``), 4 of the 8 slots and 6 of the 12 KV heads,
    against the one-rank engine on the same weights (fp32 activations,
    fp32 slab)."""
    import torch

    from repro_torch.models.params import GCLM

    g = TP_SERVE
    cfg = _tp_serve_cfg("gc-lm-110m")
    model = GCLM(cfg, device="cuda", seed=0)
    one = _tp_engine(cfg, model, g, torch.float32)
    one.pop("eng")
    one16 = _tp_engine(cfg.replace(dtype="bfloat16"), model, TP_SERVE_BF16, torch.bfloat16)
    one16.pop("eng")
    del model
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawn_tp_serve("gc-lm-110m", g)
    job_s = time.perf_counter() - t0
    if [r["coords"] for r in ranks] != [(0, d, m) for d in range(2) for m in range(2)]:
        raise AssertionError(f"[tp-serve] ranks {[r['coords'] for r in ranks]}")
    if {r["params"] for r in ranks} != {50_049_792} or {tuple(r["kv_heads"]) for r in ranks} \
            != {(6,)}:
        raise AssertionError(f"[tp-serve] a rank holds {[r['params'] for r in ranks]} params, "
                             f"KV heads {[r['kv_heads'] for r in ranks]}; expected 50,049,792 "
                             "and 6")
    if {r["slab_bf16_bytes"] for r in ranks} != {15_728_640}:
        raise AssertionError(f"[tp-serve] bf16 slab bytes {[r['slab_bf16_bytes'] for r in ranks]}"
                             ", expected 15,728,640 (a quarter of 62,914,560)")
    worst = max(r["teacher_bf16"] for r in ranks)
    if not worst <= SERVE_BF16_REL:
        raise AssertionError(f"[tp-serve] teacher forcing on the bf16 slab {worst:.3e} > "
                             f"{SERVE_BF16_REL}")
    seen = _check_tp_serve("tp-serve", cfg, g, one, ranks)
    reused = _reused_slots("tp-serve", one["slots"])  # every rank's slots are these
    differ = sum(a != b for x, y in zip(ranks[0]["bf16"]["reqs"], one16["reqs"], strict=True)
                 for a, b in zip(x[0], y[0], strict=True))
    n_tok16 = sum(len(x[0]) for x in one16["reqs"])
    run = ranks[0]["fp32"]
    n_tok = sum(len(x[0]) for x in run["reqs"])
    per = seen["per_step"]
    log(f"[tp-serve] {len(ranks)} ranks on {torch.cuda.get_device_name(0)} over gloo, (data "
        f"{g['data']}, model {g['model']}): each {ranks[0]['params']:,} params (init_shards, "
        f"{ranks[0]['init_s']:.2f} s, peak {ranks[0]['init_peak']:,} bytes), slots "
        f"{[list(r['fp32']['rows']) for r in ranks]}, KV heads {ranks[0]['kv_heads']}; the "
        f"job {job_s:.1f} s")
    log(f"[tp-serve] fp32 activations, fp32 slab: tokens, slots, timestamps and step "
        f"latencies == the one-rank engine's on every rank ({len(run['reqs'])} requests, "
        f"{n_tok} tokens, {len(run['latencies'])} decode steps; slots serving a second "
        f"request {reused}); gc_* launches "
        f"{[r['fp32']['launches'] for r in ranks]}; {n_tok / run['wall']:.1f} tok/s by the "
        f"wall clock ({run['wall']:.3f} s; one rank {one['tokens_per_s']:.1f} tok/s); a decode "
        f"step (no admission) median {seen['median']:.3f} ms by the host clock (one rank "
        f"{statistics.median(seen['one_walls']):.3f} ms), max {max(seen['walls']):.3f}")
    log(f"[tp-serve] collectives per rank per decode step (== the formula on every step of "
        f"every rank): {per['counts']}, bytes {per['nbytes']}")
    log(f"[tp-serve] bf16 slab: {ranks[0]['slab_bf16_bytes']:,} bytes a rank; teacher "
        f"forcing {[round(r['teacher_bf16'], 9) for r in ranks]} of the largest logit (bound "
        f"{SERVE_BF16_REL}); bf16 activations on a bf16 slab, the first "
        f"{TP_SERVE_BF16['n_requests']} requests: {differ} of {n_tok16} tokens differ from the "
        f"one-rank bf16 engine's (not gated), {ranks[0]['bf16']['tokens_per_s']:.1f} tok/s; "
        f"max_memory_allocated per rank {[r['peak'] for r in ranks]} bytes")
    return {"launches": sum(sum(r["fp32"]["launches"].values()) for r in ranks)}


def _axis_serve_cfg(arch: str, n_layers: int = AXIS_TP_SERVE["n_layers"], **kw):
    """A model-axis serving phase's config: ``arch`` at its published
    widths cut to ``n_layers`` layers (``AXIS_TP_SERVE``'s by default),
    fp32 activations, ``kw`` replaced."""
    return _cut(arch, n_layers, dtype="float32", **kw)


def _slab_trees(slab) -> list:
    """Every cache tree of a slab: a run's one, a pattern's p."""
    return [tree for seg in slab for tree in (seg if isinstance(seg, list) else [seg])]


def _slab_shapes(slab) -> dict:
    """{leaf name: the set of its shapes over the slab's segments}."""
    out = {}
    for tree in _slab_trees(slab):
        for name, leaf in tree.items():
            out.setdefault(name, set()).add(tuple(leaf.shape))
    return out


def _axis_serve_rank(rank, world, forced):
    """One rank of the model axis's serving job (``dist.spawn``: every rank
    on card 0 over gloo, ``AXIS_TP_SERVE``'s (data, model) mesh): per
    phase of ``AXIS_SERVE_PHASES`` and per case its shards drawn by
    ``init_shards`` (seed 0; one rank at a time, as a full leaf of up to
    6.44 GB lies beside its cut while it is drawn), the engine on an fp32
    slab with every count set to 0 just before — for a phase in
    ``forced`` (tag -> one rank's prompts and tokens), then the mesh fed
    one rank's tokens of each request that parted (``_forced_tokens``) —
    then the shards let go before the next are cut.  Returns what the
    rank saw — per phase and case its parameters, split, slab leaf
    shapes, engine run and peaks, and each phase's seconds; the parent
    holds it to the one-rank engine."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.moe import expert_split
    from repro_torch.models.params import count_params, init_shards

    g = AXIS_TP_SERVE
    mesh = make_local_mesh(g["data"], model=g["model"], device="cuda:0", backend="gloo")
    out = dict(coords=(mesh.pod_index, mesh.data_index, mesh.model_index), phases={},
               seconds={})
    for tag, (arch, cases, _) in AXIS_SERVE_PHASES.items():
        t_tag = time.perf_counter()
        out["phases"][tag] = {}
        for case, kw in cases.items():
            cfg = _axis_serve_cfg(arch, **kw)
            t0 = time.perf_counter()
            torch.cuda.reset_peak_memory_stats(mesh.device)
            local = None
            for r in range(world):
                if r == rank:
                    free, total = torch.cuda.mem_get_info(mesh.device)
                    log(f"[{tag}] {case and f'({case}) '}rank {rank} draws its shards; the "
                        f"card has {free:,} of {total:,} bytes free")
                    local = init_shards(cfg, mesh, device=mesh.device, seed=0)
                    torch.cuda.synchronize()
                    torch.cuda.empty_cache()  # the full leaves' blocks, for the next draw
                dist.barrier()
            got = dict(params=count_params(local), split=expert_split(local.tp),
                       axes=sorted(local.tp.axes), init_s=time.perf_counter() - t0,
                       init_peak=torch.cuda.max_memory_allocated(mesh.device))
            torch.cuda.reset_peak_memory_stats(mesh.device)
            run = _tp_engine(cfg, local, g, torch.float32, mesh=mesh)
            got["slab"] = _slab_shapes(run.pop("eng").slab)
            if tag in forced:
                run["forced"] = _forced_tokens(cfg, local, run, forced[tag], g, mesh.device)
            got.update(fp32=run, peak=torch.cuda.max_memory_allocated(mesh.device))
            out["phases"][tag][case] = got
            del local, run
            torch.cuda.empty_cache()
        out["seconds"][tag] = time.perf_counter() - t_tag
    for tag, (arch, n_layers, _, load) in CROSS_TP_SERVE.items():
        t_tag = time.perf_counter()
        cfg = _axis_serve_cfg(arch, n_layers)
        local = None
        for r in range(world):
            if r == rank:
                local = init_shards(cfg, mesh, device=mesh.device, seed=0)
                _open_gates(local, 0)
                torch.cuda.synchronize()
                torch.cuda.empty_cache()
            dist.barrier()
        torch.cuda.reset_peak_memory_stats(mesh.device)
        run = _cross_generate(cfg, local, load, busy=True, profile=rank == 0)
        out["phases"][tag] = dict(run, params=count_params(local), axes=sorted(local.tp.axes),
                                  peak=torch.cuda.max_memory_allocated(mesh.device))
        del local, run
        torch.cuda.empty_cache()
        out["seconds"][tag] = time.perf_counter() - t_tag
    return out


def _cross_generate(cfg, model, g, busy: bool = False, profile: bool = False) -> dict:
    """``g``'s rows through ``generate(aux_inputs=)`` — prompts (numpy, seed
    0) and modality embeddings (``_aux_rows``, seed 1) — greedy, with the
    ``gc_*`` counts set to 0 just before, and the entry point's prefill
    and each decode step counted: its collectives with their bytes and its
    host wall (synchronized).  With ``busy``, one more decode step of every
    row at the last position of caches of capacity S + max_new, the
    device's busy time in it read from the profiler's raw device events
    (``_device_kernels``) where ``profile`` (every rank of a model group
    runs the step: its collectives pair up)."""
    import numpy as np
    import torch

    from repro_torch.dist import collectives
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.serve import engine as serve_engine

    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(g["batch"], g["prompt_len"]))
    aux = _aux_rows(cfg, g["batch"], 1)
    real = {"prefill": serve_engine.prefill, "decode": serve_engine.decode_step}
    calls = []

    def counted(kind):
        def call(*args, **kwargs):
            torch.cuda.synchronize()
            collectives.reset_counts()
            t0 = time.perf_counter()
            result = real[kind](*args, **kwargs)
            torch.cuda.synchronize()
            calls.append(dict(kind=kind, ms=(time.perf_counter() - t0) * 1e3,
                              counts={**collectives.counts, **collectives.model_counts},
                              nbytes=dict(collectives.nbytes)))
            return result
        return call

    serve_engine.prefill, serve_engine.decode_step = counted("prefill"), counted("decode")
    reset_counts()
    t0 = time.perf_counter()
    try:
        tokens = serve_engine.generate(cfg, model, prompts, g["max_new"], aux_inputs=aux,
                                       device="cuda")
    finally:
        serve_engine.prefill, serve_engine.decode_step = real["prefill"], real["decode"]
    out = dict(tokens=tokens.numpy(), calls=calls, wall=time.perf_counter() - t0,
               launches=read_counts(), busy_ms=None)
    if busy:
        cap = g["prompt_len"] + g["max_new"]
        with torch.no_grad():
            _, caches = prefill(cfg, model, torch.from_numpy(prompts).cuda(), aux_inputs=aux,
                                target_len=cap, last_only=True)
            for seg in caches:
                for tree in (seg if isinstance(seg, list) else [seg]):
                    if tree is not None:
                        tree["pos"].fill_(cap - 1)
            step = torch.from_numpy(prompts[:, -1:]).cuda()
            decode_step(cfg, model, caches, step, aux_inputs=aux)  # warm
            for tree in (t for seg in caches for t in (seg if isinstance(seg, list) else [seg])):
                if tree is not None:
                    tree["pos"].fill_(cap - 1)
            torch.cuda.synchronize()
            if profile:
                with torch.profiler.profile(
                        activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
                    decode_step(cfg, model, caches, step, aux_inputs=aux)
                    torch.cuda.synchronize()
                out["busy_ms"] = sum(us for _, us, _ in _device_kernels(prof)) / 1e3
            else:
                decode_step(cfg, model, caches, step, aux_inputs=aux)
                torch.cuda.synchronize()
        del caches
    return out


def _cross_serve_collectives(cfg, g, kind: str, model: int) -> dict:
    """The collectives of one forward of ``generate(aux_inputs=)`` on a rank
    (fp32, every row): the prefill of the B prompts (S tokens) or a decode
    step (1) makes every decoder layer's forward reduces
    (``_layer_collectives``) of (B, S, d), and where the vocabulary splits
    the embedding's; each of Whisper's encoder layers its attention's and
    MLP's reduces of (B, frames, d) — the encoder runs again every
    forward; where the vocabulary splits, one all-gather of the last
    position's logits, (B, V) out.  The projector and the gates make
    none; no backward, so no copy."""
    rows, d = g["batch"], cfg.d_model
    tokens = g["prompt_len"] if kind == "prefill" else 1
    vocab = int(cfg.vocab % model == 0)
    dec = sum(_layer_collectives(cfg, spec, model)["reduce"] for spec in cfg.layers)
    enc, frames = 0, 0
    if cfg.encoder is not None:
        enc = cfg.encoder.n_layers * (1 + int(cfg.d_ff % model == 0))
        frames = cfg.encoder.n_frames
    zero = dict(psum=0, psum_scatter=0, broadcast=0, copy=0, max=0)
    return dict(counts=dict(zero, all_gather=vocab, reduce=vocab + dec + enc),
                nbytes=dict(zero, all_gather=4 * cfg.vocab * rows * vocab,
                            reduce=4 * d * rows * (tokens * (vocab + dec) + frames * enc)))


def _cross_serve_one(tag) -> dict:
    """A cross phase's one-rank run: its arch at full width cut to its
    depth, fp32, gates opened from the seed, its parameters counted;
    ``_cross_generate`` and a decode step's device-only time (a replayed
    CUDA graph, ``device_ms``) and device-busy time (the profiler's), the
    peak and the seconds; the model freed."""
    import torch

    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.params import GCLM

    t0 = time.perf_counter()
    _free_card()
    arch, n_layers, n_want, g = CROSS_TP_SERVE[tag]
    cfg = _axis_serve_cfg(arch, n_layers)
    model = GCLM(cfg, device="cuda", seed=0)
    _open_gates(model, 0)
    n_params = sum(t.numel() for t in model.leaves())
    if n_params != n_want:
        raise AssertionError(f"[{tag}] {n_params} params, expected {n_want:,}")
    one = _cross_generate(cfg, model, g, busy=True, profile=True)
    cap = g["prompt_len"] + g["max_new"]
    aux = _aux_rows(cfg, g["batch"], 1)
    with torch.no_grad():
        tok = torch.arange(1, g["batch"] + 1, device="cuda")[:, None]
        _, caches = prefill(cfg, model, tok.expand(-1, g["prompt_len"]).contiguous(),
                            aux_inputs=aux, target_len=cap)
        for seg in caches:
            for tree in (seg if isinstance(seg, list) else [seg]):
                if tree is not None:
                    tree["pos"].fill_(cap - 1)
        one["device_ms"] = device_ms(lambda: decode_step(cfg, model, caches, tok,
                                                         aux_inputs=aux), 3)
    del caches
    one.update(peak=torch.cuda.max_memory_allocated(), n_params=n_params)
    del model
    _free_card()
    one["s"] = time.perf_counter() - t0
    return one


def _check_axis_slab(tag, cfg, g, got) -> str:
    """A rank's slab on the axis: MLA's whole latent (``c_kv``, ``k_r``),
    Mamba's state of the rank's channels (``conv``, and ``h`` of d_inner /
    model), attention's KV heads of the rank, the mLSTM's state of its
    heads (``C``; ``conv`` of its channels) and the sLSTM's (``h``, ``c``
    of d_model / model); raises otherwise.  Returns a line of the
    shapes."""
    rows = g["n_slots"] // g["data"]
    shapes = got["slab"]
    want = {}
    if any(spec.mixer == "mla" for spec in cfg.layers):
        want.update(c_kv=(rows, g["max_len"], cfg.mla.kv_lora_rank),
                    k_r=(rows, g["max_len"], cfg.mla.qk_rope_head_dim))
    if any(spec.mixer == "mamba" for spec in cfg.layers):
        half = cfg.mamba.expand * cfg.d_model // g["model"]
        want.update(h=(rows, half, cfg.mamba.d_state), conv=(rows, cfg.mamba.d_conv - 1, half))
    if any(spec.mixer == "attn" for spec in cfg.layers):
        want.update(k=(rows, g["max_len"], cfg.n_kv_heads // g["model"], cfg.head_dim))
    if any(spec.mixer == "mlstm" for spec in cfg.layers):
        from repro_torch.models.xlstm import mlstm_dims

        spec, d_inner, nh, dh = mlstm_dims(cfg)
        want.update(C=(rows, nh // g["model"], dh, dh),
                    conv=(rows, spec.conv_kernel - 1, d_inner // g["model"]))
    if any(spec.mixer == "slstm" for spec in cfg.layers):
        want.update(h=(rows, cfg.d_model // g["model"]), c=(rows, cfg.d_model // g["model"]))
    for name, shape in want.items():
        if {s[-len(shape):] for s in shapes.get(name, ())} != {shape}:
            raise AssertionError(f"[{tag}] slab leaf {name}: shapes {shapes.get(name)}, "
                                 f"expected {shape} a layer")
    return ", ".join(f"{name} {shape}" for name, shape in want.items())


def _axis_serve_one(tag) -> dict:
    """A model-axis serving phase's one-rank run: ``AXIS_SERVE_PHASES[tag]``'s
    arch at its published widths cut to ``AXIS_TP_SERVE["n_layers"]``
    layers (its first case's config), fp32 activations on an fp32 slab,
    its parameters counted; the engine's record, the peak and the seconds,
    the model freed."""
    import torch

    from repro_torch.models.params import GCLM

    t0 = time.perf_counter()
    _free_card()
    arch, cases, n_want = AXIS_SERVE_PHASES[tag]
    cfg = _axis_serve_cfg(arch, **next(iter(cases.values())))
    model = GCLM(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.leaves())
    if n_params != n_want:
        raise AssertionError(f"[{tag}] {n_params} params, expected {n_want:,}")
    one = _tp_engine(cfg, model, AXIS_TP_SERVE, torch.float32)
    one.pop("eng")
    one.update(peak=torch.cuda.max_memory_allocated(), n_params=n_params)
    del model
    _free_card()
    one["s"] = time.perf_counter() - t0
    return one


def phase_axis_tp_serve():
    """The model axis's serving phases — [moe-tp-serve] (mixtral-8x22b in
    case (b), then re-cut in case (a)), [deepseek-tp-serve] (dense MLA, a
    rank's heads, the latent slab whole on every rank) and
    [jamba-tp-serve] (Mamba with a dense MLP and with 16 experts split by
    expert, a rank's channels of every Mamba leaf and of the slab's
    state) and [xlstm-tp-serve] (xLSTM at 8 layers: a rank's mLSTM and
    sLSTM heads of the slab), each at its published widths cut to 2
    layers (xLSTM 8), fp32
    activations on an fp32 slab: each served on one rank, the model freed
    (``_axis_serve_one``), then all by one job of four ranks on card 0
    over gloo on a (data 2, model 2) mesh (4 of the 8 slots each; the
    ranks start once), case by case: equal tokens, slots, timestamps and
    step latencies; the collectives of every step on every rank the
    formula (``_serve_collectives``); the slab of a rank's state
    (``_check_axis_slab``); a slot serving a second request; no ``gc_*``
    launch; each rank's peaks.  The same job then runs [whisper-tp-serve]
    and [vision-tp-serve] through ``generate(aux_inputs=)`` against their
    one-rank runs (``_cross_serve_one``, ``_cross_generate``: tokens equal,
    every forward's collectives ``_cross_serve_collectives``).  Returns
    each phase's launches and seconds (its one-rank run and its part of
    rank 0's job)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.dist.spawn import spawn

    g = AXIS_TP_SERVE
    ones = {tag: _axis_serve_one(tag) for tag in AXIS_SERVE_PHASES}
    ones.update({tag: _cross_serve_one(tag) for tag in CROSS_TP_SERVE})
    # the xLSTM stack amplifies rounding: a request may part from one rank's
    # tokens at a near tie, and the mesh is then fed one rank's tokens
    forced = {tag: ones[tag]["outputs"] for tag, (arch, _, _) in AXIS_SERVE_PHASES.items()
              if get_config(arch).xlstm_blocks}
    free, total = torch.cuda.mem_get_info()
    log(f"[axis-tp-serve] one-rank runs done, each model freed: this process holds "
        f"{torch.cuda.memory_allocated():,} bytes ({torch.cuda.memory_reserved():,} reserved); "
        f"the card has {free:,} of {total:,} bytes free")
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    store = tempfile.mkdtemp(prefix="chip_smoke_axis_serve_", dir=os.path.join(ROOT, "build"))
    t0 = time.perf_counter()
    try:
        ranks = spawn(_axis_serve_rank, g["data"] * g["model"], forced, store_dir=store,
                      backend="gloo", timeout=SPMD_LIMIT_S)
    finally:
        shutil.rmtree(store, ignore_errors=True)
    job_s = time.perf_counter() - t0
    if [r["coords"] for r in ranks] != [(0, d, m) for d in range(2) for m in range(2)]:
        raise AssertionError(f"[axis-tp-serve] ranks {[r['coords'] for r in ranks]}")
    out = {}
    for tag, (arch, cases, _) in AXIS_SERVE_PHASES.items():
        one = ones[tag]
        cfg = _axis_serve_cfg(arch, **next(iter(cases.values())))
        reused = _reused_slots(tag, one["slots"])
        n_tok = sum(len(x[0]) for x in one["reqs"])
        part = ranks[0]["seconds"][tag]
        log(f"[{tag}] {cfg.name} at full width, {cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers (mixers {[l.mixer for l in cfg.layers]}, MoE "
            f"{[l.moe is not None for l in cfg.layers]}), fp32: {one['n_params']:,} params; one "
            f"rank: {one['tokens_per_s']:.1f} tok/s, peak {one['peak']:,} bytes, {one['s']:.1f} "
            f"s; {len(ranks)} ranks on {torch.cuda.get_device_name(0)} over gloo, (data "
            f"{g['data']}, model {g['model']}): {part:.1f} s of rank 0's job ({job_s:.1f} s)")
        launches = 0
        for case, kw in cases.items():
            got = [r["phases"][tag][case] for r in ranks]
            name = f"{tag} ({case})" if case else tag
            case_cfg = _axis_serve_cfg(arch, **kw)
            if case and {x["split"] for x in got} != {{"a": "experts", "b": "expert_mlp"}[case]}:
                raise AssertionError(f"[{name}] the experts split on "
                                     f"{[x['split'] for x in got]}")
            slab = _check_axis_slab(name, case_cfg, g, got[0])
            ties = None
            if tag in forced:
                ties = _near_ties(name, case_cfg, one["outputs"], g["prompt_len"])
            seen = _check_tp_serve(name, case_cfg, g, one, got, ties)
            launches += sum(sum(x["fp32"]["launches"].values()) for x in got)
            run = got[0]["fp32"]
            per = seen["per_step"]
            log(f"[{name}] split axes {got[0]['axes']} (experts: {got[0]['split']}); a rank "
                f"holds {[x['params'] for x in got]} params (init_shards one rank at a time, "
                f"{got[0]['init_s']:.2f} s, peaks {[x['init_peak'] for x in got]} bytes), slots "
                f"{[list(x['fp32']['rows']) for x in got]}, a slab of {slab} a layer; "
                f"{len(run['reqs'])} requests x {g['prompt_len']}-token prompts: tokens, "
                f"slots, timestamps and step latencies == the one-rank engine's on every rank "
                f"({n_tok} tokens, {len(run['latencies'])} decode steps; slots serving a second "
                f"request {reused}; requests parted at a near tie (request, token) "
                f"{seen['parted']}, and the mesh fed one rank's tokens of each gives them "
                f"after it but at the near ties (request, token, mesh, one rank) "
                f"{seen['ties']}); gc_* launches "
                f"{[x['fp32']['launches'] for x in got]}; "
                f"{n_tok / run['wall']:.1f} tok/s by the wall clock, a decode step (no "
                f"admission) median {seen['median']:.3f} ms by the host clock (one rank "
                f"{statistics.median(seen['one_walls']):.3f} ms); collectives per rank per "
                f"decode step (== the formula on every step of every rank): {per['counts']}, "
                f"bytes {per['nbytes']}; serving peaks {[x['peak'] for x in got]} bytes")
        out[tag] = {"launches": launches, "s": one["s"] + part}
    for tag, (arch, n_layers, _, load) in CROSS_TP_SERVE.items():
        one, part = ones[tag], ranks[0]["seconds"][tag]
        cfg = _axis_serve_cfg(arch, n_layers)
        got = [r["phases"][tag] for r in ranks]
        for r, x in enumerate(got):
            if not np.array_equal(x["tokens"], one["tokens"]):
                diff = int((x["tokens"] != one["tokens"]).sum())
                raise AssertionError(f"[{tag}] rank {r}: {diff} tokens differ from one rank's")
            if any(x["launches"].values()):
                raise AssertionError(f"[{tag}] rank {r}: the serving path launched "
                                     f"{x['launches']}")
            if [c["kind"] for c in x["calls"]] != ["prefill"] + ["decode"] * (load["max_new"] - 1):
                raise AssertionError(f"[{tag}] rank {r}: calls {[c['kind'] for c in x['calls']]}")
            for i, call in enumerate(x["calls"]):
                want = _cross_serve_collectives(cfg, load, call["kind"], g["model"])
                if {"counts": call["counts"], "nbytes": call["nbytes"]} != want:
                    raise AssertionError(f"[{tag}] rank {r} forward {i} ({call['kind']}): "
                                         f"collectives {call} vs the formula {want}")
        steps = [c["ms"] for c in got[0]["calls"][1:]]
        one_steps = [c["ms"] for c in one["calls"][1:]]
        per = got[0]["calls"][1]
        log(f"[{tag}] {cfg.name} at full width, {cfg.n_layers} of {get_config(arch).n_layers} "
            f"layers (mixers {[l.mixer for l in cfg.layers]}, cross sublayers "
            f"{sum(l.cross_source for l in cfg.layers)}{', encoder ' if cfg.encoder else ''}"
            f"{cfg.encoder.n_layers if cfg.encoder else ''}), fp32, gates open: "
            f"{one['n_params']:,} params; generate(aux_inputs=) {load['batch']} x "
            f"{load['prompt_len']} + {load['max_new']} tokens, one rank {one['s']:.1f} s (peak "
            f"{one['peak']:,} bytes); {len(ranks)} ranks (data {g['data']}, model {g['model']}: "
            f"every rank runs every row) over gloo: split axes {got[0]['axes']}, a rank holds "
            f"{[x['params'] for x in got]} params; tokens == one rank's on every rank; gc_* "
            f"launches {[x['launches'] for x in got]}; collectives of every forward == the "
            f"formula, a decode step {per['counts']} bytes {per['nbytes']}; a decode step "
            f"median {statistics.median(steps):.3f} ms by the host clock (one rank "
            f"{statistics.median(one_steps):.3f} ms); device busy in one decode step "
            f"{got[0]['busy_ms']:.4f} ms on rank 0 (one rank {one['busy_ms']:.4f} ms; its "
            f"device-only {one['device_ms']:.4f} ms by a replayed graph); serving peaks "
            f"{[x['peak'] for x in got]} bytes; {part:.1f} s of rank 0's job")
        out[tag] = {"launches": sum(sum(x["launches"].values()) for x in got),
                    "s": one["s"] + part}
    log("[axis-tp-serve] seconds by phase (its one-rank run and its part of the job): "
        + ", ".join(f"[{tag}] {v['s']:.1f}" for tag, v in out.items()))
    return out


def phase_gemma3_tp_serve():
    """gemma3-27b at full width cut to one 5:1 period (6 layers), fp32
    activations on an fp32 slab, served on one rank and then on 2 ranks at
    model 2 (8 of the 16 KV heads each): equal tokens, slots, timestamps
    and step latencies; the windowed layers' rings wrap."""
    import torch

    from repro_torch.models.params import GCLM

    _free_card()
    g = GEMMA3_TP_SERVE
    cfg = _tp_serve_cfg("gemma3-27b")
    model = GCLM(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.leaves())
    one = _tp_engine(cfg, model, g, torch.float32)
    one.pop("eng")
    one_peak = torch.cuda.max_memory_allocated()
    del model
    _free_card()
    t0 = time.perf_counter()
    ranks = _spawn_tp_serve("gemma3-27b", g)
    job_s = time.perf_counter() - t0
    if {tuple(r["kv_heads"]) for r in ranks} != {(cfg.n_kv_heads // 2,)}:
        raise AssertionError(f"[gemma3-tp-serve] KV heads {[r['kv_heads'] for r in ranks]}")
    window = cfg.layers[0].window
    rings = [(cap, pos) for cap, pos in ranks[0]["ring"] if cap == window]
    if not rings or not all(pos > cap for cap, pos in rings):
        raise AssertionError(f"[gemma3-tp-serve] the windowed layers' rings did not wrap: "
                             f"{ranks[0]['ring']}")
    seen = _check_tp_serve("gemma3-tp-serve", cfg, g, one, ranks)
    run = ranks[0]["fp32"]
    n_tok = sum(len(x[0]) for x in run["reqs"])
    log(f"[gemma3-tp-serve] {cfg.name} at full width, {cfg.n_layers} layers (windows "
        f"{[s.window for s in cfg.layers]}), fp32: {n_params:,} params, one rank peak "
        f"{one_peak:,} bytes, {one['tokens_per_s']:.1f} tok/s; 2 ranks at model 2: "
        f"{[r['params'] for r in ranks]} params, KV heads {ranks[0]['kv_heads']}, init "
        f"{ranks[0]['init_s']:.2f} s (peak {ranks[0]['init_peak']:,}), serving peak "
        f"{[r['peak'] for r in ranks]} bytes; the job {job_s:.1f} s")
    log(f"[gemma3-tp-serve] {len(run['reqs'])} requests x {g['prompt_len']}-token prompts: "
        f"tokens, slots, timestamps and step latencies == one rank's on both ranks ({n_tok} "
        f"tokens); rings {sorted(set(rings))} wrapped; gc_* launches "
        f"{[r['fp32']['launches'] for r in ranks]}; {n_tok / run['wall']:.1f} tok/s, a decode "
        f"step median {seen['median']:.3f} ms by the host clock (one rank "
        f"{statistics.median(seen['one_walls']):.3f}); collectives per decode step "
        f"{seen['per_step']['counts']}, bytes {seen['per_step']['nbytes']}")
    return {"launches": sum(sum(r["fp32"]["launches"].values()) for r in ranks)}


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


# ------------------------------------------------------------ the Gemma family
def _cut(arch: str, n_layers: int, **kw):
    """The registered config at its published widths, cut in depth to its
    first ``n_layers`` layers."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return cfg.replace(n_layers=n_layers, layers=cfg.layers[:n_layers], **kw)


def _free_card() -> None:
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def phase_gemma_train():
    """Coded training of full-width gemma-2b (2 layers: one run of 11
    leaves) in sim mode: coded == uncoded at step 0 in fp32 (the gate)
    and in the config's bf16 (recorded against its own bound), then
    ``Trainer.run`` for 3 steps with every count set to 0 just before
    (``gc_fused``: one launch per step, over 16 fp32 rows of every
    parameter), then the step combine at full width — the kernel,
    ``torch.matmul`` (device-only, in turns) and the plain version —
    against its memory bound, and the pieces of a step."""
    import numpy as np
    import torch

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import gc_fused, ref
    from repro_torch.models.model import train_loss
    from repro_torch.optim.optim import adamw_update, clip_by_global_norm
    from repro_torch.train.coded import (combine_rows, level_weights, per_shard_grad_rows,
                                         uncoded_grad_fn)
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    cfg = _cut("gemma-2b", GEMMA_TRAIN_LAYERS, max_seq=512)
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=256)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    leaves = model.leaves()
    n_params = sum(t.numel() for t in leaves)
    nk = n * plan.k_shards
    reckon = {"rows": 4 * nk * n_params, "params+adamw": 12 * n_params,
              "one pass's gradients": 4 * n_params, "decoded gradient": 4 * n_params}
    log(f"[gemma-train] gemma-2b at full width, {cfg.n_layers} layers: {n_params} params in "
        f"{len(leaves)} leaves (embed.tok {leaves[0].numel()} columns), x={plan.x.tolist()}, "
        f"leaf levels {plan.leaf_levels.tolist()}, N*K={nk}, dtype {cfg.dtype}, remat "
        f"{cfg.remat}; memory reckoning {sum(reckon.values()) / 1e9:.2f} GB ("
        + ", ".join(f"{k} {v / 1e9:.2f}" for k, v in reckon.items()) + ") plus activations")

    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    gaps = {}
    for dtype, bound in (("float32", EXACT_RTOL), ("bfloat16", GEMMA_BF16_RTOL)):
        c = cfg.replace(dtype=dtype)
        rows = per_shard_grad_rows(c, model, wb)
        coded = {u: combine_rows(plan, rows, _straggler_dec_w(plan, u))
                 for u in (0, plan.s_max)}
        del rows
        g_ref = uncoded_grad_fn(c, n)(model, shards)
        for u, got in coded.items():
            gaps[dtype, u] = _worst_rel(got, g_ref, model.leaf_paths(), bound,
                                        f"[gemma-train] {dtype}: coded != uncoded, {u} stragglers")
        del coded, g_ref
        log(f"[gemma-train] step 0, {dtype} activations: coded == uncoded, worst leaf relative "
            f"max error {gaps[dtype, 0]:.3e} / {gaps[dtype, plan.s_max]:.3e} at 0 / "
            f"{plan.s_max} stragglers (bound {bound})")
    _free_card()

    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda m: log(f"[gemma-train] {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    losses = [h["loss"] for h in trainer.history]
    if launches != {"gc_fused": STEPS, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[gemma-train] launches {launches} in {STEPS} steps, expected "
                             "one gc_fused launch per step")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[gemma-train] non-finite loss {losses}")
    log(f"[gemma-train] {STEPS} steps, losses {losses}, step wall_s "
        f"{[h['wall_s'] for h in trainer.history]}, launches {launches}; max_memory_allocated "
        f"{peak} bytes ({peak / 1e9:.2f} GB) against the {sum(reckon.values()) / 1e9:.2f} GB "
        f"reckoning (ratio {peak / sum(reckon.values()):.4f})")

    # where a step's time goes, and the step combine at full width
    tokens = torch.as_tensor(wb[0, 0], device="cuda")

    def ms(fn, reps=3):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / reps * 1e3

    parts = {"fwd_bwd": ms(lambda: torch.autograd.grad(
        train_loss(cfg, model, {"tokens": tokens})[0], leaves))}
    t0 = time.perf_counter()
    rows = per_shard_grad_rows(cfg, model, wb)
    torch.cuda.synchronize()
    parts["rows"] = (time.perf_counter() - t0) * 1e3
    dec_w = _straggler_dec_w(plan, plan.s_max)
    layout = plan.flat_layout
    a = torch.full((1,), 1.0 / n, device="cuda")
    table = level_weights(plan, dec_w, "cuda")
    which = list(layout.leaf_level)
    outs = [torch.empty((1, g.shape[1]), device="cuda") for g in rows]
    ws = [(a[:, None] * table[i]).contiguous() for i in which]
    before = gc_fused.launches
    gc_fused.encode_decode_leaves(a, table, which, rows, out=outs)
    if gc_fused.launches - before != 1:
        raise AssertionError(f"[gemma-train] the combine took {gc_fused.launches - before} "
                             "launches, expected 1")
    max_err = 0.0
    for j, (y, g) in enumerate(zip(outs, rows)):
        want = ref.encode_decode_ref(a, table[which[j]], g)
        max_err = max(max_err, check_close("gc_fused", y, want, "float32",
                                           f"gemma-2b leaf {j} NB=1 K={nk} D={g.shape[1]}"))
        del want
    fns = {"new": lambda: gc_fused.encode_decode_leaves(a, table, which, rows, out=outs),
           "library": lambda: [torch.matmul(w, g, out=o) for w, g, o in zip(ws, rows, outs)]}
    dev = device_in_turns(fns, 3)
    n_cols = sum(g.shape[1] for g in rows)
    bytes_ms, ops_ms = bounds_ms((1 + nk) * n_cols * 4 + (layout.n_levels + 1) * nk * 4,
                                 2.0 * nk * n_cols)
    times = {"device_ms": _mean(dev["new"]), "ms": time_ms(fns["new"], 3),
             "plain_ms": time_ms(lambda: ref.encode_decode_leaves_ref(a, table, which, rows), 3),
             "library_ms": _mean(dev["library"]), "bound_ms": max(bytes_ms, ops_ms),
             "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}
    parts["combine"] = times["ms"]
    grads = [o.view_as(t) for o, t in zip(outs, leaves)]
    del rows
    parts["update"] = ms(lambda: adamw_update(clip_by_global_norm(grads, 1.0)[0],
                                              trainer.state.opt, leaves, 1e-12))
    log(f"[gemma-train] step combine, {len(outs)} leaves, NB=1 K={nk}, {n_cols} columns in one "
        f"launch: agrees with the plain version (max abs err {max_err:.3e}); device-only ms in "
        "turns new/library/library/new: " + ", ".join(f"{k} {v[0]:.4f} {v[1]:.4f}"
                                                       for k, v in dev.items())
        + f"; host-inclusive {times['ms']:.4f}, plain {times['plain_ms']:.4f}; bound "
        f"{times['bound_ms']:.4f} ms ({times['bound_by']}; bytes {bytes_ms:.4f}, operations "
        f"{ops_ms:.4f}); share of bound {times['bound_ms'] / times['device_ms']:.3f}, "
        f"torch.matmul {times['bound_ms'] / times['library_ms']:.3f}")
    log(f"[gemma-train] one step's pieces, host clock: fwd+bwd {parts['fwd_bwd']:.2f} ms "
        f"(x{nk} = {nk * parts['fwd_bwd']:.1f} ms); rows incl. copies {parts['rows']:.1f} ms; "
        f"combine (1 launch) {parts['combine']:.2f} ms; clip+adamw {parts['update']:.2f} ms")
    del outs, grads, trainer, model, leaves
    _free_card()
    return dict(times, launches=launches["gc_fused"], max_abs_err=max_err, peak=peak)


def _reused_slots(tag, slot_steps) -> list:
    """The slots that served more than one request, from each step's
    slot of every request (None when not running); raises when none
    did."""
    served_by = {}
    for step in slot_steps:
        for i, slot in enumerate(step):
            if slot is not None:
                served_by.setdefault(slot, set()).add(i)
    reused = sorted(slot for slot, reqs in served_by.items() if len(reqs) > 1)
    if not reused:
        raise AssertionError(f"[{tag}] no slot served a second request: {served_by}")
    return reused


def _serve_run(tag, cfg, model, g) -> dict:
    """``g["n_requests"]`` prompts of ``g["prompt_len"]`` random tokens
    (numpy, seed 0) and Poisson arrivals (seed 0) through a ``ServeEngine``
    of ``g["n_slots"]`` slots (bf16 slab) behind the launcher's default
    coded tier, greedy, ``g["max_new"]`` tokens each, with every count set
    to 0 just before: every request completes, the engine's clock is the
    tier's stream, no ``gc_*`` kernel launches."""
    import numpy as np
    import torch

    from repro_torch.core import Env, ShiftedExponential
    from repro_torch.serve import CodedDecode, ServeConfig, ServeEngine
    from repro_torch.sim.arrivals import poisson_arrivals

    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), g["workers"])
    coded = CodedDecode.solve(env, objective="p99", seed=0)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                size=(g["n_requests"], g["prompt_len"]))
    arrivals = poisson_arrivals(g["n_requests"], g["rate"], seed=0)
    eng = ServeEngine(cfg, model, ServeConfig(n_slots=g["n_slots"],
                                              max_len=g["prompt_len"] + g["max_new"]),
                      coded=coded, device="cuda")
    reqs = [eng.submit(p, max_new=g["max_new"], arrival=float(t))
            for p, t in zip(prompts, arrivals)]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    slot_steps = []
    t0 = time.perf_counter()
    while True:
        more = eng.step()
        slot_steps.append([r.slot for r in reqs])
        if not more:
            break
    done = eng.finished
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    n_tokens = sum(len(r.tokens) for r in reqs)
    if len(done) != len(reqs) or not all(r.done and len(r.tokens) == g["max_new"] for r in reqs):
        raise AssertionError(f"[{tag}] unfinished: {[r.summary() for r in reqs if not r.done]}")
    replay = CodedDecode(env, coded.plan, seed=0).step_latencies(len(eng.step_latencies), seed=0)
    if not np.array_equal(np.asarray(eng.step_latencies), replay):
        raise AssertionError(f"[{tag}] the engine's clock is not the coded tier's stream")
    if any(counts.values()):
        raise AssertionError(f"[{tag}] the serving path launched kernels: {counts}")
    reused = _reused_slots(tag, slot_steps)
    log(f"[{tag}] {cfg.name} at full width, {cfg.n_layers} layers: "
        f"{sum(t.numel() for t in model.leaves())} params; coded tier R={coded.plan.r} "
        f"s={coded.plan.s}; {len(reqs)} requests x {g['prompt_len']}-token prompts, {n_tokens} "
        f"tokens in {wall:.3f} s over {len(eng.step_latencies)} decode steps: "
        f"{n_tokens / wall:.1f} tok/s; every request {g['max_new']} tokens; step latencies == "
        f"the tier's stream; slots serving a second request {reused}; gc_* launches "
        f"{counts}; max_memory_allocated {peak} bytes")
    return {"eng": eng, "reqs": reqs, "prompts": prompts, "wall": wall, "peak": peak,
            "tokens_per_s": n_tokens / wall}


def phase_gemma3_serve():
    """Full-width gemma3-27b cut to 14 layers (a pattern of 6 over 2
    repeats and a tail run of 2) through ``_serve_run``: 16 requests of
    1,536-token prompts (past the 1,024 window: local layers take
    ``local_attention`` in prefill and their ring caches wrap in decode)
    and 64 new tokens each.  Teacher forcing against prefill logits: fp32
    activations on an fp32 slab, the config's bf16 on a bf16 slab."""
    from repro_torch.models.params import GCLM

    _free_card()
    g = GEMMA3_SERVE
    cfg = _cut("gemma3-27b", g["n_layers"])
    model = GCLM(cfg, device="cuda", seed=0)
    run = _serve_run("gemma3-serve", cfg, model, g)
    ring = run["eng"].slab[0][0]  # the pattern's first position: a windowed layer
    if ring["k"].shape[2] != cfg.layers[0].window or int(ring["pos"].max()) <= ring["k"].shape[2]:
        raise AssertionError(f"[gemma3-serve] the local layers' slab is not a wrapped ring: "
                             f"{tuple(ring['k'].shape)}, pos {ring['pos'].max().item()}")
    log(f"[gemma3-serve] local rings of {ring['k'].shape[2]} wrapped (pos up to "
        f"{int(ring['pos'].max())})")
    out = {"tokens_per_s": run["tokens_per_s"], "seconds": run["wall"]}
    outputs = [r.output for r in run["reqs"][:3]]
    del run
    out.update(_teacher_forcing("gemma3-serve", cfg, model, outputs, g["prompt_len"]))
    del model
    _free_card()
    return out


def _teacher_forcing(tag, cfg, model, outputs, s: int, bf16_activations: bool = True,
                     aux=None) -> dict:
    """Teacher-forced decode logits against prefill logits of the same
    tokens: rows 0-1 on a bf16 slab, with the config's bf16 activations
    (or, when ``bf16_activations`` is False, fp32 activations: the slab's
    rounding alone, as ``[serve]`` checks it), row 2 with fp32 activations
    on an fp32 slab, at ``[serve]``'s bounds; ``aux`` the rows' modality
    embeddings of a model with a cross-attention source."""
    import numpy as np
    import torch

    toks = torch.from_numpy(np.stack(outputs).astype(np.int64)).cuda()
    t0 = time.perf_counter()
    act = cfg if bf16_activations else cfg.replace(dtype="float32")
    got, want = teacher_forced_tokens(act, model, toks[:2], s, torch.bfloat16, "cuda",
                                      None if aux is None else aux[:2])
    bf16 = _rel_err(got, want)
    del got, want
    got, want = teacher_forced_tokens(cfg.replace(dtype="float32"), model, toks[2:3], s,
                                      torch.float32, "cuda", None if aux is None else aux[2:3])
    fp32 = _rel_err(got, want)
    del got, want
    torch.cuda.synchronize()
    if not bf16 <= SERVE_BF16_REL or not fp32 <= SERVE_FP32_REL:
        raise AssertionError(f"[{tag}] teacher-forced logits: bf16 slab {bf16:.3e} (bound "
                             f"{SERVE_BF16_REL}), fp32 {fp32:.3e} (bound {SERVE_FP32_REL})")
    log(f"[{tag}] teacher forcing over {toks.shape[1] - s - 1} decode steps: "
        f"{act.dtype} activations, bf16 slab (2 rows) {bf16:.3e} of the largest logit (bound "
        f"{SERVE_BF16_REL}); fp32 activations, fp32 slab (1 row) {fp32:.3e} (bound "
        f"{SERVE_FP32_REL}); {time.perf_counter() - t0:.1f} s")
    return {"bf16_rel": bf16, "fp32_rel": fp32}


def phase_gemma2():
    """Full-width gemma2-27b cut to 4 layers (a local/global pattern over 2
    repeats; attention softcap 50, final softcap 30): a 4,352-token prompt,
    past the 4,096 window, so prefill rolls the local layers' rings; then
    16 teacher-forced decode steps against the prefill logits."""
    import numpy as np
    import torch

    from repro_torch.models.model import prefill
    from repro_torch.models.params import GCLM, count_params

    _free_card()
    g = GEMMA2
    cfg = _cut("gemma2-27b", g["n_layers"])
    model = GCLM(cfg, device="cuda", seed=0)
    s, n = g["prompt_len"], g["decode_steps"] + 1
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(3, s + n))
    tok0 = torch.from_numpy(toks[:1, :s]).cuda()
    prefill(cfg, model, tok0, target_len=s + n)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    logits, caches = prefill(cfg, model, tok0, target_len=s + n)
    torch.cuda.synchronize()
    pre_ms = (time.perf_counter() - t0) * 1e3
    local, glob = caches[0]
    if local["k"].shape[2] != cfg.layers[0].window or glob["k"].shape[2] != s + n \
            or int(local["pos"][0]) != s:
        raise AssertionError(f"[gemma2] caches {tuple(local['k'].shape)} / "
                             f"{tuple(glob['k'].shape)}, pos {local['pos'].tolist()}")
    if not float(logits.float().abs().max()) <= cfg.final_softcap:
        raise AssertionError("[gemma2] logits past the final softcap")
    del logits, caches
    log(f"[gemma2] gemma2-27b at full width, {cfg.n_layers} layers: {count_params(model)} "
        f"params; prefill of {s} tokens (B=1, bf16 activations) {pre_ms:.1f} ms, host clock; "
        f"local rings of {cfg.layers[0].window} rolled at prefill, global caches of {s + n}")
    errs = _teacher_forcing("gemma2", cfg, model, list(toks), s)
    del model
    _free_card()
    return dict(errs, prefill_ms=pre_ms)


# ------------------------------------------------------ Qwen 1.5 and Mixtral
class DropCensus:
    """Counts the MoE assignments each call drops: while active, the name
    ``repro_torch.models.blocks.apply_moe`` also calls the port's routing
    function (``moe.route``) on the layer's input and keeps, per MoE layer
    call, (tokens, capacity, dropped assignments) — the last a device
    tensor, read only by ``dropped``.  For a whole module off a mesh (a
    sharded one routes over its model group)."""

    def __enter__(self):
        import torch

        from repro_torch.models import blocks, moe

        self.calls, self._blocks, self._orig = [], blocks, blocks.apply_moe

        def counting(cfg, p, x, spec, **kw):
            with torch.no_grad():
                r = moe.route(p, x.reshape(-1, x.shape[-1]), spec.moe)
                self.calls.append((x.shape[0] * x.shape[1], r.cap, (r.keep == 0).sum()))
            return self._orig(cfg, p, x, spec, **kw)

        blocks.apply_moe = counting
        return self

    def __exit__(self, *exc):
        self._blocks.apply_moe = self._orig

    def dropped(self) -> int:
        return int(sum(int(d) for _, _, d in self.calls))


def _with_capacity(cfg, capacity_factor: float):
    """``cfg`` with every MoE layer at ``capacity_factor`` (dense layers
    kept)."""
    import dataclasses

    return cfg.replace(layers=tuple(l if l.moe is None else dataclasses.replace(
        l, moe=dataclasses.replace(l.moe, capacity_factor=capacity_factor))
        for l in cfg.layers))


def _layer_work(cfg, spec) -> tuple:
    """One layer's (weights every token multiplies, cache values per
    position, prefill operations per attention pair, decode operations per
    cached slot, weights of one expert).  Attention: the Q/K/V/O
    projections, K/V rows, QK and PV products over the heads.  MLA: every
    projection of the mixer (the absorbed decode multiplies ``wk_b`` and
    ``wv_b`` once per token as the expansion does), the latent ``c_kv``
    plus ``k_r`` rows, the expanded products (nope + rope scores, v) in
    prefill and the latent ones (latent + rope scores, latent PV) in
    decode.  Mamba: ``in_proj``, ``x_proj``, ``dt_proj`` and
    ``out_proj``, no cache row.  A MoE FFN: the router and the shared
    experts for every token, one expert per kept assignment."""
    d, h = cfg.d_model, cfg.n_heads
    if spec.mixer == "mamba":  # no cache row: a fixed state (``_mamba_state``)
        from repro_torch.models.ssm import mamba_dims

        m, di, r = mamba_dims(cfg)
        attn = d * 2 * di + di * (r + 2 * m.d_state) + r * di + di * d
        row = pair_prefill = pair_decode = 0
    elif spec.mixer == "mla":
        m = cfg.mla
        attn = (d * m.q_lora_rank + m.q_lora_rank * h * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * h * (m.qk_nope_head_dim + m.v_head_dim) + h * m.v_head_dim * d)
        row = m.kv_lora_rank + m.qk_rope_head_dim
        pair_prefill = 2 * h * (m.qk_nope_head_dim + m.qk_rope_head_dim + m.v_head_dim)
        pair_decode = 2 * h * (2 * m.kv_lora_rank + m.qk_rope_head_dim)
    else:
        hd = h * cfg.head_dim
        attn = 2 * d * hd + 2 * d * cfg.n_kv_heads * cfg.head_dim
        row = 2 * cfg.n_kv_heads * cfg.head_dim
        pair_prefill = pair_decode = 4 * hd
    if spec.moe is None:
        ffn, expert = 3 * d * cfg.d_ff, 0
    else:
        ffn = d * spec.moe.num_experts + 3 * d * spec.moe.d_ff * spec.moe.num_shared
        expert = 3 * d * spec.moe.d_ff
    return attn + ffn, row, pair_prefill, pair_decode, expert


def _mamba_state(cfg, slab) -> tuple:
    """(bytes of one slot's state over the Mamba layers — ``conv`` at the
    slab's width, ``h`` in fp32 — and the elementwise operations per token
    of those layers: ~7 per state element for the scan — decay, input,
    recurrence, readout — and 2 per tap and channel for the conv); (0, 0)
    without Mamba layers."""
    from repro_torch.models.ssm import mamba_dims

    n = sum(1 for l in cfg.layers if l.mixer == "mamba")
    if not n:
        return 0, 0
    m, di, _ = mamba_dims(cfg)
    item = next(seg["conv"] for seg in slab if "conv" in seg).element_size()
    return (n * ((m.d_conv - 1) * di * item + di * m.d_state * 4),
            n * (7 * di * m.d_state + 2 * m.d_conv * di))


def _serve_times(tag, cfg, model, slab, prompt, expert_tokens=(0, 0)) -> dict:
    """Prefill of ``prompt`` (B = 1) and one ``decode_step`` of the whole
    ``slab`` (every row at its last position), host-inclusive and
    device-only, beside their bounds: the bytes (the fp32 weights read
    once — of the embedding table only the rows looked up — the cache
    rows written or read, the logits written) over the memory rate, and
    the operations of the matmuls and of the attention pairs the causal
    window needs (``_layer_work``) over the bf16 tensor-core peak.  A MoE
    layer multiplies each kept assignment by one expert:
    ``expert_tokens`` (prefill, decode) counts those.  Mamba layers
    (``_mamba_state``) add their state — written by the prefill, read and
    written by a decode step — and their elementwise work at the fp32
    rate."""
    import torch

    from repro_torch.models.model import decode_step, prefill

    n_params = sum(t.numel() for t in model.leaves())
    d, vocab, spec = cfg.d_model, cfg.vocab, cfg.layers[0]
    s = prompt.shape[1]
    b = slab[0]["pos"].shape[-1]
    kv = next(seg for seg in slab if "c_kv" in seg or "k" in seg)
    cap = kv["c_kv"].shape[-2] if "c_kv" in kv else kv["k"].shape[-3]
    state, scan_ops = _mamba_state(cfg, slab)
    work = [_layer_work(cfg, l) for l in cfg.layers]
    kv_row = sum(w[1] for w in work)  # cache entries per position
    per_token = sum(w[0] for w in work) + d * vocab  # weights every token multiplies
    expert = max(w[4] for w in work)
    window = spec.window or s
    pairs = sum(min(q + 1, window) for q in range(s))  # causal, windowed
    tok = torch.from_numpy(prompt).cuda()
    tokens = torch.arange(1, b + 1, device="cuda")[:, None]
    caches = [{k: v.clone() for k, v in seg.items()} for seg in slab]
    for seg in caches:
        seg["pos"].fill_(cap - 1)
    weights = 4 * (n_params - vocab * d)  # the embedding table: its rows only
    cases = {
        "prefill": (lambda: prefill(cfg, model, tok, target_len=cap),
                    weights + 4 * s * d + 2 * kv_row * s + 4 * s * vocab + state,
                    2 * per_token * s + 2 * expert * expert_tokens[0]
                    + sum(w[2] for w in work) * pairs, scan_ops * s, f"S={s} B=1"),
        "decode_step": (lambda: decode_step(cfg, model, caches, tokens),
                        weights + 4 * b * d + 2 * kv_row * b * cap + 4 * b * vocab
                        + 2 * state * b,
                        2 * per_token * b + 2 * expert * expert_tokens[1]
                        + sum(w[3] for w in work) * b * cap, scan_ops * b, f"B={b} cap={cap}")}
    out = {}
    for name, (fn, n_bytes, n_ops, n_fp32, shape) in cases.items():
        times = {"ms": time_ms(fn, 5), "device_ms": device_ms(fn, 3)}
        bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
        ops_ms = n_ops / BF16_FLOPS * 1e3 + n_fp32 / FP32_FLOPS * 1e3
        times.update(bound_ms=max(bytes_ms, ops_ms),
                     bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        out[name] = times
        log(f"[{tag}] {name} {shape}, bf16 activations: incl {times['ms']:.4f} ms, device-only "
            f"{times['device_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms ({times['bound_by']}; "
            f"bytes {bytes_ms:.4f}, operations {ops_ms:.4f}); share of bound (device-only) "
            f"{times['bound_ms'] / times['device_ms']:.3f}")
    del caches
    return out


def phase_qwen_serve():
    """Full-width qwen1.5-32b (QKV biases, an untied head, bf16
    activations) cut to 4 of 64 layers, its biases set to seeded normal
    values (std 0.02; the reference initializes them to zero), in a
    ``ServeEngine``: 16 requests of 512-token prompts, 64 new tokens each
    (``_serve_run``'s gates); prefill and ``decode_step`` times; teacher
    forcing at ``[serve]``'s bounds as ``[serve]`` checks them (fp32
    activations on a bf16 slab, and fp32 on fp32), the config's bf16
    activations on a bf16 slab measured beside them."""
    import numpy as np
    import torch

    from repro_torch.models.params import GCLM

    _free_card()
    g = QWEN_SERVE
    cfg = _cut("qwen1.5-32b", g["n_layers"])
    model = GCLM(cfg, device="cuda", seed=0)
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        for path, t in model.leaf_items():
            if path[-1] in ("bq", "bk", "bv"):
                t.normal_(0.0, 0.02, generator=gen)
    run = _serve_run("qwen-serve", cfg, model, g)
    times = _serve_times("qwen-serve", cfg, model, run["eng"].slab, run["prompts"][:1])
    outputs = [r.output for r in run["reqs"][:3]]
    errs = _teacher_forcing("qwen-serve", cfg, model, outputs, g["prompt_len"],
                            bf16_activations=False)
    toks = torch.from_numpy(np.stack(outputs[:2]).astype(np.int64)).cuda()
    got, want = teacher_forced_tokens(cfg, model, toks, g["prompt_len"], torch.bfloat16, "cuda")
    errs["bf16_activations_rel"] = _rel_err(got, want)
    del got, want
    log(f"[qwen-serve] bf16 activations on a bf16 slab (2 rows, the engine's numerics): "
        f"{errs['bf16_activations_rel']:.3e} of the largest logit, measured, not gated: at 16 "
        "layers the rounding of bf16 activations alone reaches the 2e-2 bound (ROADMAP 3.17)")
    out = dict(errs, tokens_per_s=run["tokens_per_s"], **times)
    del run, model
    _free_card()
    return out


def _moe_teacher_forcing(tag, cfg, model, outputs, s: int, bf16_activations: bool = True,
                         gate: bool = True) -> dict:
    """Teacher forcing of a MoE model, one row per call (a batch of rows
    would change the capacity of the full-sequence prefill): the decode
    logits of a row against the prefill logits of its tokens agree only
    when neither the prompt's prefill nor the full one dropped an
    assignment, so the bound applies to the rows whose calls dropped
    nothing (counted by ``DropCensus``).  Rows 0-1 run on a bf16 slab with
    the config's bf16 activations (or fp32 ones when ``bf16_activations``
    is False: the slab's rounding alone), row 2 fp32 on an fp32 slab;
    with ``gate`` False the errors are measured and not held to a
    bound."""
    import numpy as np
    import torch

    toks = torch.from_numpy(np.stack(outputs).astype(np.int64)).cuda()
    act = cfg if bf16_activations else cfg.replace(dtype="float32")
    rows, gated = [], {}
    for i in range(toks.shape[0]):
        c, dt = (act, torch.bfloat16) if i < 2 else (cfg.replace(dtype="float32"), torch.float32)
        with DropCensus() as census:
            got, want = teacher_forced_tokens(c, model, toks[i:i + 1], s, dt, "cuda")
        err, dropped = _rel_err(got, want), census.dropped()
        decode_drops = sum(int(dd) for t, _, dd in census.calls if t == 1)
        if decode_drops:
            raise AssertionError(f"[{tag}] a batch-1 decode step dropped {decode_drops}")
        bound = SERVE_BF16_REL if dt == torch.bfloat16 else SERVE_FP32_REL
        rows.append((i, f"{c.dtype} on a {str(dt).split('.')[-1]} slab", dropped, err))
        if dropped == 0 and gate:
            gated[i] = err
            if not err <= bound:
                raise AssertionError(f"[{tag}] teacher-forced logits of row {i} ({dt}): "
                                     f"{err:.3e} (bound {bound})")
        del got, want
    log(f"[{tag}] teacher forcing over {toks.shape[1] - s - 1} decode steps, one row per call "
        f"(request, activations and slab, assignments dropped by its two prefills, error of "
        f"the largest logit): {rows}; " + (f"the bound held on the {len(gated)} rows that "
                                          "dropped nothing" if gate else "measured, not gated"))
    return {"rows": rows, "gated": gated}


def phase_mixtral_serve():
    """Full-width mixtral-8x22b (8 experts top-2, windows of 4,096, an
    untied head, bf16 activations) cut to 4 of 56 layers, at the published
    capacity factor 1.25, in a ``ServeEngine``: 16 requests of 4,352-token
    prompts (past the window: the rings wrap), 32 new tokens each
    (``_serve_run``'s gates).  The census of dropped assignments: each
    request's prefill (may drop) and one decode step of the full slab
    (t = 8 tokens, capacity 8: cannot).  Teacher forcing at the published
    capacity on the rows that dropped nothing, and at capacity factor 4
    (= experts / top-k: no expert can overflow) on every row."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.params import GCLM

    _free_card()
    g = MIXTRAL_SERVE
    cfg = _cut("mixtral-8x22b", g["n_layers"])
    spec = cfg.layers[0].moe
    model = GCLM(cfg, device="cuda", seed=0)
    run = _serve_run("mixtral-serve", cfg, model, g)
    eng, reqs = run["eng"], run["reqs"]
    ring = eng.slab[0]
    if ring["k"].shape[2] != cfg.layers[0].window or int(ring["pos"].max()) <= ring["k"].shape[2]:
        raise AssertionError(f"[mixtral-serve] the slab is not a wrapped ring: "
                             f"{tuple(ring['k'].shape)}, pos {ring['pos'].max().item()}")

    # the census: every prompt's prefill, then one decode step of the slab
    per_request = []
    with torch.no_grad():
        for r in reqs:
            with DropCensus() as census:
                prefill(cfg, model, torch.from_numpy(r.prompt[None].astype("int64")).cuda())
            per_request.append(census.dropped())
        slab = [{k: v.clone() for k, v in seg.items()} for seg in eng.slab]
        with DropCensus() as census:
            decode_step(cfg, model, slab, torch.arange(1, g["n_slots"] + 1, device="cuda")[:, None])
        del slab
    if moe.capacity(g["n_slots"], spec) != g["n_slots"] or census.dropped():
        raise AssertionError(f"[mixtral-serve] a decode step over {g['n_slots']} slots dropped "
                             f"{census.dropped()} (capacity {moe.capacity(g['n_slots'], spec)})")
    caps = sorted({c for _, c, _ in census.calls})
    log(f"[mixtral-serve] census at capacity factor {spec.capacity_factor}: prefill of "
        f"{g['prompt_len']} tokens, capacity {moe.capacity(g['prompt_len'], spec)} per expert: "
        f"{sum(1 for d in per_request if d)} of {len(reqs)} prefills dropped assignments "
        f"({sum(per_request)} of {len(reqs) * cfg.n_layers * g['prompt_len'] * spec.top_k}; by "
        f"request {per_request}); a decode step of the {g['n_slots']}-slot slab (capacity "
        f"{caps}) dropped 0")

    kept = cfg.n_layers * g["prompt_len"] * spec.top_k - per_request[0]
    times = _serve_times("mixtral-serve", cfg, model, eng.slab, run["prompts"][:1],
                         expert_tokens=(kept, cfg.n_layers * g["n_slots"] * spec.top_k))
    tokens_per_s = run["tokens_per_s"]
    del run, eng
    outputs = [r.output for r in reqs[:3]]
    published = _moe_teacher_forcing("mixtral-serve", cfg, model, outputs, g["prompt_len"])
    roomy = _with_capacity(cfg, spec.num_experts / spec.top_k)
    full = _moe_teacher_forcing("mixtral-serve", roomy, model, outputs, g["prompt_len"])
    if len(full["gated"]) != 3:
        raise AssertionError(f"[mixtral-serve] capacity factor {spec.num_experts / spec.top_k} "
                             f"dropped assignments: {full['rows']}")
    del model
    _free_card()
    return {"tokens_per_s": tokens_per_s, "dropped": per_request,
            "gated_published": len(published["gated"]), **times}


def phase_moe_train():
    """Coded training of ``mixtral-8x22b.reduced()`` (the reference's smoke
    shapes: 2 layers, d_model 256, 4 experts top-2; full width does not
    fit, see PERF.md) in sim mode with the gc-lm-110m plan settings (N =
    4, ``xf``, s_max = 3, seq 256, global batch 8).  At step 0 the coded
    gradient equals the uncoded one (``EXACT_RTOL`` per leaf) with 0 and
    s_max stragglers, at the reduced capacity factor 8 (no drop) and at
    the published 1.25 (drops, counted).  ``Trainer.run`` for 3 steps with
    the counts set to 0 just before: one ``gc_fused`` launch per step,
    finite losses with the aux term in them.  On the card: ``remat="full"``
    bit-equal to ``"none"``, and two runs of the same forward+backward at
    capacity 1.25 byte-equal."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import combine_rows, per_shard_grad_rows, uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    base = get_config("mixtral-8x22b").reduced()
    trainer = Trainer(base, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=256)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    paths = model.leaf_paths()
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    gaps, dropped = {}, {}
    for cf in (base.layers[0].moe.capacity_factor, 1.25):
        cfg = _with_capacity(base, cf)
        with DropCensus() as census:
            rows = per_shard_grad_rows(cfg, model, wb)
        dropped[cf] = census.dropped()
        coded = {u: combine_rows(plan, rows, _straggler_dec_w(plan, u)) for u in (0, plan.s_max)}
        g_ref = uncoded_grad_fn(cfg, n)(model, shards)
        for u, got in coded.items():
            gaps[cf, u] = _worst_rel(got, g_ref, paths, EXACT_RTOL,
                                     f"[moe-train] capacity {cf}: coded != uncoded, {u} stragglers")
        del rows, coded, g_ref
    if dropped[8.0] or not dropped[1.25]:
        raise AssertionError(f"[moe-train] dropped assignments by capacity factor: {dropped}")
    log(f"[moe-train] mixtral-8x22b reduced ({base.n_layers} layers, d_model {base.d_model}, "
        f"{base.layers[0].moe.num_experts} experts top-{base.layers[0].moe.top_k}, d_ff "
        f"{base.layers[0].moe.d_ff}): {sum(t.numel() for t in model.leaves())} params in "
        f"{len(paths)} leaves, N*K={n * plan.k_shards}; step 0, coded == uncoded, worst leaf "
        "relative max error at 0 / s_max stragglers: "
        + "; ".join(f"capacity {cf} ({dropped[cf]} of the {n * plan.k_shards} passes' "
                    f"assignments dropped) {gaps[cf, 0]:.3e} / {gaps[cf, plan.s_max]:.3e}"
                    for cf in dropped) + f" (bound {EXACT_RTOL})")

    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda m: log(f"[moe-train] {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    hist = trainer.history
    if launches != {"gc_fused": STEPS, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[moe-train] launches {launches} in {STEPS} steps, expected one "
                             "gc_fused launch per step")
    if not all(math.isfinite(h["loss"]) and h["aux"] > 0
               and abs(h["loss"] - h["xent"] - h["aux"]) <= 1e-5 * h["loss"] for h in hist):
        raise AssertionError(f"[moe-train] losses {[(h['loss'], h['xent'], h['aux']) for h in hist]}")

    tokens = torch.as_tensor(wb[0, 0], device="cuda")

    def grads(cfg):
        loss, _ = train_loss(cfg, model, {"tokens": tokens})
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    for a, b in zip(grads(base), grads(base.replace(remat="full")), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[moe-train] remat='full' is not bit-equal to 'none'")
    drop = _with_capacity(base, 1.25)
    for a, b in zip(grads(drop), grads(drop), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[moe-train] two runs of one forward+backward differ")
    log(f"[moe-train] {STEPS} steps, losses {[h['loss'] for h in hist]} (aux "
        f"{[h['aux'] for h in hist]}), launches {launches}; remat 'full' bit-equal to 'none'; "
        "two forward+backward runs at capacity 1.25 byte-equal")
    del trainer, model
    _free_card()
    return {"launches": launches["gc_fused"], "gaps": gaps, "dropped": dropped,
            "losses": [h["loss"] for h in hist]}


# ------------------------------------------------------------------ DeepSeek-V3
def phase_deepseek_serve():
    """Full-width deepseek-v3-671b (MLA with ranks 1536/512, nope 128,
    rope 64, v 128 over 128 heads; sigmoid top-8 of 256 experts plus one
    shared; vocab 129,280, an untied head, bf16 activations) cut to its
    first 4 of 61 layers (3 dense, 1 MoE at the published capacity factor
    1.25), in a ``ServeEngine``: 16 requests of 512-token prompts, 32 new
    tokens each (``_serve_run``'s gates).  The slab holds the latent
    ``c_kv``/``k_r`` rows only: its bytes per token beside the K/V of
    plain attention over the same heads.  The census of dropped
    assignments (each prompt's prefill may drop; one 8-slot decode step,
    capacity 8, cannot), prefill and ``decode_step`` times against their
    bounds, and teacher forcing one row per call: fp32 activations on a
    bf16 slab (2e-2) and fp32 on fp32 (1e-4), on the drop-free rows at
    capacity 1.25 and on every row at capacity factor 32 (experts / top-k:
    nothing can drop); the config's bf16 activations measured beside
    them, not gated (the absorbed decode rounds at other points than the
    expanded prefill)."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.params import GCLM

    _free_card()
    g = DEEPSEEK_SERVE
    cfg = _cut("deepseek-v3-671b", g["n_layers"], mtp_depth=0)
    spec = cfg.layers[-1].moe
    model = GCLM(cfg, device="cuda", seed=0)
    run = _serve_run("deepseek-serve", cfg, model, g)
    eng, reqs = run["eng"], run["reqs"]
    slab_bytes = sum(v.element_size() * v.shape[-1] * (v.shape[0] if v.ndim == 4 else 1)
                     for seg in eng.slab for k, v in seg.items() if k != "pos")
    item = eng.slab[0]["c_kv"].element_size()
    mha_bytes = cfg.n_layers * 2 * cfg.n_heads * cfg.head_dim * item
    latent_bytes = cfg.n_layers * (cfg.mla.kv_lora_rank + cfg.mla.qk_rope_head_dim) * item
    if sorted(eng.slab[0]) != ["c_kv", "k_r", "pos"] or slab_bytes != latent_bytes:
        raise AssertionError(f"[deepseek-serve] the slab is not the latent cache: "
                             f"{[{k: tuple(v.shape) for k, v in seg.items()} for seg in eng.slab]}")
    log(f"[deepseek-serve] slab {slab_bytes} bytes per token ({cfg.n_layers} layers x "
        f"(c_kv {cfg.mla.kv_lora_rank} + k_r {cfg.mla.qk_rope_head_dim}) bf16) against "
        f"{mha_bytes} for plain attention's K/V over the same {cfg.n_heads} heads "
        f"({mha_bytes / slab_bytes:.1f}x)")

    per_request = []
    with torch.no_grad():
        for r in reqs:
            with DropCensus() as census:
                prefill(cfg, model, torch.from_numpy(r.prompt[None].astype("int64")).cuda())
            per_request.append(census.dropped())
        slab = [{k: v.clone() for k, v in seg.items()} for seg in eng.slab]
        with DropCensus() as census:
            decode_step(cfg, model, slab, torch.arange(1, g["n_slots"] + 1, device="cuda")[:, None])
        del slab
    if moe.capacity(g["n_slots"], spec) != g["n_slots"] or census.dropped():
        raise AssertionError(f"[deepseek-serve] a decode step over {g['n_slots']} slots dropped "
                             f"{census.dropped()} (capacity {moe.capacity(g['n_slots'], spec)})")
    n_moe = sum(1 for l in cfg.layers if l.moe is not None)
    log(f"[deepseek-serve] census at capacity factor {spec.capacity_factor}: prefill of "
        f"{g['prompt_len']} tokens, capacity {moe.capacity(g['prompt_len'], spec)} per expert: "
        f"{sum(1 for d in per_request if d)} of {len(reqs)} prefills dropped assignments "
        f"({sum(per_request)} of {len(reqs) * n_moe * g['prompt_len'] * spec.top_k}; by "
        f"request {per_request}); a decode step of the {g['n_slots']}-slot slab (capacity "
        f"{moe.capacity(g['n_slots'], spec)}) dropped 0")

    kept = n_moe * g["prompt_len"] * spec.top_k - per_request[0]
    times = _serve_times("deepseek-serve", cfg, model, eng.slab, run["prompts"][:1],
                         expert_tokens=(kept, n_moe * g["n_slots"] * spec.top_k))
    tokens_per_s, peak = run["tokens_per_s"], run["peak"]
    del run, eng
    outputs = [r.output for r in reqs[:3]]
    published = _moe_teacher_forcing("deepseek-serve", cfg, model, outputs, g["prompt_len"],
                                     bf16_activations=False)
    roomy = _with_capacity(cfg, spec.num_experts / spec.top_k)
    full = _moe_teacher_forcing("deepseek-serve", roomy, model, outputs, g["prompt_len"],
                                bf16_activations=False)
    if len(full["gated"]) != 3:
        raise AssertionError(f"[deepseek-serve] capacity factor "
                             f"{spec.num_experts / spec.top_k} dropped assignments: {full['rows']}")
    bf16 = _moe_teacher_forcing("deepseek-serve", roomy, model, outputs[:2], g["prompt_len"],
                                gate=False)
    log(f"[deepseek-serve] max_memory_allocated during the engine run {peak} bytes "
        f"({peak / 1e9:.2f} GB; the weights 60.44 GB fp32 plus one 7.52 GB expert cast)")
    del model
    _free_card()
    return {"tokens_per_s": tokens_per_s, "dropped": per_request, "peak": peak,
            "slab_bytes_per_token": slab_bytes,
            "gated_published": len(published["gated"]),
            "bf16_activations": [row[-1] for row in bf16["rows"]], **times}


def _family_cfg(arch: str):
    """[deepseek-train]'s or [jamba-train]'s config (the reference's smoke
    widths at ``DEEPSEEK_TRAIN_LAYERS`` or ``JAMBA_TRAIN_LAYERS``), which
    [mla-tp] and [mamba-tp] train on the model axis (``fam["cfg"]``)."""
    from repro_torch.configs import get_config

    layers = {"deepseek-v3-671b": DEEPSEEK_TRAIN_LAYERS, "jamba-v0.1-52b": JAMBA_TRAIN_LAYERS}
    return get_config(arch).reduced(n_layers=layers[arch])


def _keep_step0_rows(grad_fn):
    """Keep the per-shard rows that a trainer's own first step computes:
    its ``grad_fn.rows`` runs as the step runs it, and the step's combine
    gets them as before, while a reference to them stays here; later steps
    call ``grad_fn.rows`` directly.  A phase holds these rows — the main
    path's own — to the uncoded gradient or to sim mode after the run, so
    those passes run once.  Returns ``take(wb, wa=None)``, which checks
    that the first step was given the worker batches ``wb`` (and the
    ``worker_aux`` ``wa``) and hands the rows over."""
    import numpy as np
    import torch

    real, kept = grad_fn.rows, {}

    def first(model, worker_batches, worker_aux=None):
        grad_fn.rows = real
        kept.update(rows=real(model, worker_batches, worker_aux), wb=np.array(worker_batches),
                    wa=worker_aux)
        return kept["rows"]

    def take(wb, wa=None) -> list:
        if "rows" not in kept or not np.array_equal(kept["wb"], wb) or \
                (wa is None) != (kept["wa"] is None) or \
                (wa is not None and not torch.equal(kept["wa"], wa)):
            raise AssertionError("the trainer's first step did not run on step 0's inputs")
        return kept.pop("rows")

    grad_fn.rows = first
    return take


def _sim_grads(tag, plan, rows, g_ref, paths, partner=lambda p: None) -> tuple:
    """[tag]'s step-0 sim-mode coded gradients from the per-shard ``rows``
    at 0, 1 and s_max stragglers, each held to the uncoded one
    (``EXACT_RTOL`` per leaf; a leaf whose gradient is zero in exact
    arithmetic at ``partner``'s, ``_worst_rel_held``).  Returns the gaps by
    straggler count and the gradients by straggler count, on the card."""
    from repro_torch.train.coded import combine_rows

    gaps, sim = {}, {}
    for u in sorted({0, 1, plan.s_max}):
        sim[u] = combine_rows(plan, rows, _straggler_dec_w(plan, u))
        gaps[u] = _worst_rel_held(sim[u], g_ref, paths, EXACT_RTOL,
                                  f"[{tag}] coded != uncoded, {u} stragglers", partner)
    return gaps, sim


def _save_sim(tag, sim) -> str:
    """``_sim_grads``'s gradients copied to the host into a file in a new
    directory under ``build/``, for the model axis's phase of the same
    config and batches ([mla-tp], [mamba-tp], [xlstm-tp], [cross-tp]),
    which holds its gathered spmd gradients to them: the work is shared,
    not redone on a rank.  Returns the file."""
    import torch

    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    path = os.path.join(tempfile.mkdtemp(prefix=f"chip_smoke_{tag}_",
                                         dir=os.path.join(ROOT, "build")), "sim.pt")
    torch.save({u: [t.cpu() for t in g] for u, g in sim.items()}, path)
    return path


def phase_deepseek_train():
    """Coded training of ``deepseek-v3-671b.reduced(n_layers=4)`` (d_model
    256: 3 dense MLA layers and 1 MoE layer, sigmoid top-2 of 4 with one
    shared expert, MTP depth 1; full width does not fit: PERF.md) in sim
    mode with the gc-lm-110m plan settings (N = 4, ``xf``, s_max = 3, seq
    256, global batch 8).  At step 0 the coded gradient equals the uncoded
    one (``EXACT_RTOL`` per leaf, the MTP module's leaves included) with 0
    and s_max stragglers.  ``Trainer.run`` for 3 steps with the counts set
    to 0 just before: one grouped ``gc_fused`` call per step (its 52
    leaves in launches of at most 32: 2 launches), finite ``loss``,
    ``xent``, ``aux`` and ``mtp`` with loss = xent + 0.3 · mtp + aux.  On
    the card: ``remat="full"`` bit-equal to ``"none"``, and two runs of one
    forward+backward byte-equal."""
    import numpy as np
    import torch

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import _pipe
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    cfg = _family_cfg("deepseek-v3-671b")
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=256)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    paths = model.leaf_paths()
    mtp = [p for p in paths if p.startswith("mtp.")]
    if not mtp or [l.moe is None for l in cfg.layers] != [True, True, True, False]:
        raise AssertionError(f"[deepseek-train] expected 3 dense + 1 MoE layer and MTP leaves: "
                             f"{[l.moe is None for l in cfg.layers]}, {mtp}")
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    g_ref = uncoded_grad_fn(cfg, n)(model, shards)  # step 0's parameters
    take = _keep_step0_rows(trainer.step_fn.grad_fn)

    # one grouped combine per step; a launch holds at most MAX_LEAVES leaves
    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda m: log(f"[deepseek-train] {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    gaps, sim = _sim_grads("deepseek-train", plan, take(wb), g_ref, paths)
    sim = _save_sim("deepseek-train", sim)
    del g_ref
    log(f"[deepseek-train] deepseek-v3-671b reduced ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, MLA {cfg.mla.q_lora_rank}/{cfg.mla.kv_lora_rank}, "
        f"{cfg.layers[-1].moe.num_experts} experts top-{cfg.layers[-1].moe.top_k}, MTP depth "
        f"{cfg.mtp_depth}): {sum(t.numel() for t in model.leaves())} params in {len(paths)} "
        f"leaves ({len(mtp)} of MTP), N*K={n * plan.k_shards}; step 0 (the trainer's own "
        f"rows), coded == uncoded, worst leaf relative max error at 0 / 1 / s_max "
        f"stragglers: " + " / ".join(f"{v:.3e}" for v in gaps.values())
        + f" (bound {EXACT_RTOL})")
    hist = trainer.history
    if launches != {"gc_fused": STEPS * per_step, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[deepseek-train] launches {launches} in {STEPS} steps, expected "
                             f"one grouped gc_fused call per step: {per_step} launches of at "
                             f"most {_pipe.MAX_LEAVES} of the {len(paths)} leaves")
    keys = ("loss", "xent", "aux", "mtp")
    if not all(all(math.isfinite(h[k]) for k in keys) and h["aux"] > 0 and h["mtp"] > 0
               and abs(h["loss"] - h["xent"] - 0.3 * h["mtp"] - h["aux"]) <= 1e-5 * h["loss"]
               for h in hist):
        raise AssertionError(f"[deepseek-train] metrics {[[h.get(k) for k in keys] for h in hist]}")

    tokens = torch.as_tensor(wb[0, 0], device="cuda")

    def grads(c):
        loss, _ = train_loss(c, model, {"tokens": tokens})
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    for a, b in zip(grads(cfg), grads(cfg.replace(remat="full")), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[deepseek-train] remat='full' is not bit-equal to 'none'")
    for a, b in zip(grads(cfg), grads(cfg), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[deepseek-train] two runs of one forward+backward differ")
    log(f"[deepseek-train] {STEPS} steps, (loss, xent, aux, mtp) "
        f"{[tuple(h[k] for k in keys) for h in hist]}, launches {launches} ({per_step} per "
        f"step: {len(paths)} leaves in launches of at most {_pipe.MAX_LEAVES}); remat 'full' "
        "bit-equal to 'none'; two forward+backward runs byte-equal")
    del trainer, model
    _free_card()
    return {"launches": launches["gc_fused"], "gaps": gaps, "losses": [h["loss"] for h in hist],
            "sim": sim, "cfg": cfg, "seq_len": 256, "phase": "deepseek-train"}


def phase_jamba_serve():
    """Full-width jamba-v0.1-52b (d_model 4096; Mamba mixers of d_inner
    8,192, d_state 16, dt_rank 256; global attention of 32 heads over 8 KV
    heads; 16 experts top-2 of d_ff 14,336 on the odd layers; vocab 65,536,
    an untied head, bf16 activations) cut to its first 8 of 32 layers (one
    period: seven Mamba layers and attention at offset 4),
    13,295,235,072 parameters, in a ``ServeEngine``: 16 requests of
    2,048-token prompts — past ``attn_chunk`` (1,024: two chunks of the
    online softmax) and 8 scan chunks of 256 — and 32 new tokens each
    (``_serve_run``'s gates).  The slab holds K/V for the attention layer
    and a fixed state per slot (``conv`` bf16, ``h`` fp32) for each Mamba
    layer.  The census of dropped assignments (prefills at capacity 1.25
    may drop; an 8-slot decode step cannot), prefill and ``decode_step``
    times against their bounds, and teacher forcing one row per call with
    fp32 activations on a bf16 slab (2e-2) and fp32 on fp32 (1e-4) at
    capacity factor 8 (experts / top-k: nothing can drop) on every row,
    the rows that are drop-free at 1.25 counted; the config's bf16
    activations measured, not gated."""
    import torch

    from repro_torch.models import moe
    from repro_torch.models.model import decode_step, prefill
    from repro_torch.models.params import GCLM

    _free_card()
    g = JAMBA_SERVE
    cfg = _cut("jamba-v0.1-52b", g["n_layers"])
    spec = next(l.moe for l in cfg.layers if l.moe is not None)
    mixers = [l.mixer for l in cfg.layers]
    if mixers != ["mamba"] * 4 + ["attn"] + ["mamba"] * 3:
        raise AssertionError(f"[jamba-serve] not one period of the published layout: {mixers}")
    model = GCLM(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.leaves())
    if n_params != 13_295_235_072:
        raise AssertionError(f"[jamba-serve] {n_params} parameters, expected 13,295,235,072")
    run = _serve_run("jamba-serve", cfg, model, g)
    eng, reqs = run["eng"], run["reqs"]
    kv_bytes = sum(v.element_size() * v[0, 0].numel() for seg in eng.slab
                   for k, v in seg.items() if k in ("k", "v"))
    state_bytes = sum(v.element_size() * v[0].numel() for seg in eng.slab
                      for k, v in seg.items() if k in ("conv", "h"))
    mamba = [seg for seg in eng.slab if "h" in seg]
    if (len(mamba) != 7 or any(seg["h"].dtype != torch.float32 or seg["conv"].dtype
                               != torch.bfloat16 for seg in mamba)):
        raise AssertionError(f"[jamba-serve] the slab's Mamba state: "
                             f"{[{k: (tuple(v.shape), v.dtype) for k, v in seg.items()} for seg in mamba]}")
    log(f"[jamba-serve] slab: attention K/V {kv_bytes} bytes per token and slot (1 layer x "
        f"2 x {cfg.n_kv_heads} heads x {cfg.head_dim} bf16); Mamba state {state_bytes} bytes "
        f"per slot, whatever the length (7 layers x (conv {cfg.mamba.d_conv - 1} x "
        f"{cfg.mamba.expand * cfg.d_model} bf16 + h {cfg.mamba.expand * cfg.d_model} x "
        f"{cfg.mamba.d_state} fp32)); at {g['prompt_len'] + g['max_new']} tokens a slot holds "
        f"{kv_bytes * (g['prompt_len'] + g['max_new']) + state_bytes} bytes")

    per_request = []
    with torch.no_grad():
        for r in reqs:
            with DropCensus() as census:
                prefill(cfg, model, torch.from_numpy(r.prompt[None].astype("int64")).cuda())
            per_request.append(census.dropped())
        slab = [{k: v.clone() for k, v in seg.items()} for seg in eng.slab]
        with DropCensus() as census:
            decode_step(cfg, model, slab, torch.arange(1, g["n_slots"] + 1, device="cuda")[:, None])
        del slab
    if moe.capacity(g["n_slots"], spec) != g["n_slots"] or census.dropped():
        raise AssertionError(f"[jamba-serve] a decode step over {g['n_slots']} slots dropped "
                             f"{census.dropped()} (capacity {moe.capacity(g['n_slots'], spec)})")
    n_moe = sum(1 for l in cfg.layers if l.moe is not None)
    log(f"[jamba-serve] census at capacity factor {spec.capacity_factor}: prefill of "
        f"{g['prompt_len']} tokens, capacity {moe.capacity(g['prompt_len'], spec)} per expert: "
        f"{sum(1 for d in per_request if d)} of {len(reqs)} prefills dropped assignments "
        f"({sum(per_request)} of {len(reqs) * n_moe * g['prompt_len'] * spec.top_k}; by "
        f"request {per_request}); a decode step of the {g['n_slots']}-slot slab (capacity "
        f"{moe.capacity(g['n_slots'], spec)}) dropped 0")

    kept = n_moe * g["prompt_len"] * spec.top_k - per_request[0]
    times = _serve_times("jamba-serve", cfg, model, eng.slab, run["prompts"][:1],
                         expert_tokens=(kept, n_moe * g["n_slots"] * spec.top_k))
    pieces = _jamba_pieces(cfg, model, g["prompt_len"], times["prefill"]["device_ms"])
    tokens_per_s, peak = run["tokens_per_s"], run["peak"]
    del run, eng
    outputs = [r.output for r in reqs[:3]]
    published = _moe_teacher_forcing("jamba-serve", cfg, model, outputs, g["prompt_len"],
                                     bf16_activations=False, gate=False)
    roomy = _with_capacity(cfg, spec.num_experts / spec.top_k)
    full = _moe_teacher_forcing("jamba-serve", roomy, model, outputs, g["prompt_len"],
                                bf16_activations=False)
    if len(full["gated"]) != 3:
        raise AssertionError(f"[jamba-serve] capacity factor "
                             f"{spec.num_experts / spec.top_k} dropped assignments: {full['rows']}")
    bf16 = _moe_teacher_forcing("jamba-serve", roomy, model, outputs[:2], g["prompt_len"],
                                gate=False)
    drop_free = [row[0] for row in published["rows"] if row[2] == 0]
    log(f"[jamba-serve] rows whose two prefills dropped nothing at capacity factor "
        f"{spec.capacity_factor}: {drop_free}; max_memory_allocated during the engine run "
        f"{peak} bytes ({peak / 1e9:.2f} GB; the weights 53.18 GB fp32 plus one 1.88 GB "
        "expert-matrix cast and the prefill's activations)")
    if not peak < 80e9:
        raise AssertionError(f"[jamba-serve] peak {peak} bytes")
    del model
    _free_card()
    return {"tokens_per_s": tokens_per_s, "dropped": per_request, "peak": peak,
            "kv_bytes_per_token": kv_bytes, "state_bytes_per_slot": state_bytes,
            "drop_free_published": drop_free, "gated": full["gated"],
            "bf16_activations": [row[-1] for row in bf16["rows"]], "pieces": pieces, **times}


def _jamba_pieces(cfg, model, s: int, prefill_ms: float) -> dict:
    """Where a Jamba prefill's device time goes: device-only ms (a replayed
    CUDA graph) of its pieces at ``s`` tokens, B = 1, bf16 activations on
    seeded normal layer inputs — one Mamba mixer (layer 0), its chunked
    scan alone, the attention mixer (layer 4), one MoE FFN (layer 1) and
    one dense FFN (layer 0) — and their sum weighted by the layers that
    run each, beside the whole prefill's device-only time."""
    import torch

    from repro_torch.models import attention, ssm
    from repro_torch.models.layers import apply_mlp
    from repro_torch.models.moe import apply_moe
    from repro_torch.models.stack import _tree

    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((1, s, cfg.d_model), generator=gen, device="cuda").to(torch.bfloat16)
    mamba, moe_layer, attn = (_tree(model.stack[i]) for i in (0, 1, 4))
    specs = cfg.layers
    with torch.no_grad():
        x_in = torch.einsum("bsd,di->bsi", x, mamba["mixer"]["in_proj"].to(x.dtype))
        xc = torch.nn.functional.silu(ssm._causal_conv(
            x_in[..., :x_in.shape[-1] // 2], mamba["mixer"]["conv_w"], mamba["mixer"]["conv_b"])[0])
        delta, a, b_t, c_t = ssm._ssm_params(cfg, mamba["mixer"], xc)
        h0 = torch.zeros((1, xc.shape[-1], cfg.mamba.d_state), device="cuda")
        fns = {
            "mamba_mixer": lambda: ssm.mamba_forward(cfg, mamba["mixer"], x, specs[0],
                                                     mode="prefill"),
            "mamba_scan": lambda: ssm._scan_chunked(cfg, delta, a, b_t, c_t, xc, h0),
            "attention_mixer": lambda: attention.attn_forward(cfg, attn["mixer"], x, specs[4],
                                                              mode="prefill", target_len=s + 1),
            "moe_ffn": lambda: apply_moe(cfg, moe_layer["ffn"], x, specs[1]),
            "dense_ffn": lambda: apply_mlp(cfg, mamba["ffn"], x)}
        out = {name: device_ms(fn, 3) for name, fn in fns.items()}
    counts = {"mamba_mixer": sum(l.mixer == "mamba" for l in specs),
              "attention_mixer": sum(l.mixer == "attn" for l in specs),
              "moe_ffn": sum(l.moe is not None for l in specs),
              "dense_ffn": sum(l.moe is None for l in specs)}
    layers_ms = sum(out[k] * n for k, n in counts.items())
    log(f"[jamba-serve] prefill pieces, S={s} B=1, device-only ms: "
        + ", ".join(f"{k} {v:.4f}" + (f" (x{counts[k]})" if k in counts else "")
                    for k, v in out.items())
        + f"; layers in all {layers_ms:.4f} of the prefill's {prefill_ms:.4f} "
        f"({layers_ms / prefill_ms:.3f}); the Mamba mixers "
        f"{out['mamba_mixer'] * counts['mamba_mixer'] / prefill_ms:.3f} of it, the scan "
        f"{out['mamba_scan'] / out['mamba_mixer']:.3f} of a Mamba mixer")
    return out


def phase_jamba_train():
    """Coded training of ``jamba-v0.1-52b.reduced(n_layers=8)`` (d_model
    256: seven Mamba layers of d_inner 512, d_state 8, and global attention
    at offset 4; 4 experts top-2 on the odd layers; 114 leaves; full width
    does not fit: PERF.md) in sim mode with the gc-lm-110m plan settings
    (N = 4, ``xf``, s_max = 3, seq 256: 4 scan chunks of 64, 2 attention
    chunks of 128, global batch 8).  At step 0 the coded gradient equals
    the uncoded one (``EXACT_RTOL`` per leaf) with 0 and s_max stragglers.
    ``Trainer.run`` for 3 steps with the counts set to 0 just before: one
    grouped ``gc_fused`` call per step (114 leaves in launches of at most
    32: 4 launches), finite ``loss``, ``xent`` and ``aux``.  On the card:
    ``remat="full"`` bit-equal to ``"none"``, and two runs of one
    forward+backward byte-equal."""
    import numpy as np
    import torch

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import _pipe
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    cfg = _family_cfg("jamba-v0.1-52b")
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=256)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    paths = model.leaf_paths()
    if len(paths) != 114 or [l.mixer for l in cfg.layers].count("mamba") != 7:
        raise AssertionError(f"[jamba-train] {len(paths)} leaves, layers "
                             f"{[l.mixer for l in cfg.layers]}")
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    g_ref = uncoded_grad_fn(cfg, n)(model, shards)  # step 0's parameters
    take = _keep_step0_rows(trainer.step_fn.grad_fn)

    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda m: log(f"[jamba-train] {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    gaps, sim = _sim_grads("jamba-train", plan, take(wb), g_ref, paths)
    sim = _save_sim("jamba-train", sim)
    del g_ref
    log(f"[jamba-train] jamba-v0.1-52b reduced ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"Mamba d_inner {cfg.mamba.expand * cfg.d_model} d_state {cfg.mamba.d_state}, scan "
        f"chunks of {cfg.scan_chunk}, {cfg.layers[1].moe.num_experts} experts "
        f"top-{cfg.layers[1].moe.top_k}): {sum(t.numel() for t in model.leaves())} params in "
        f"{len(paths)} leaves, N*K={n * plan.k_shards}; step 0 (the trainer's own rows), "
        f"coded == uncoded, worst leaf relative max error at 0 / 1 / s_max stragglers: "
        + " / ".join(f"{v:.3e}" for v in gaps.values()) + f" (bound {EXACT_RTOL})")
    hist = trainer.history
    if launches != {"gc_fused": STEPS * per_step, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[jamba-train] launches {launches} in {STEPS} steps, expected "
                             f"one grouped gc_fused call per step: {per_step} launches of at "
                             f"most {_pipe.MAX_LEAVES} of the {len(paths)} leaves")
    keys = ("loss", "xent", "aux")
    if not all(all(math.isfinite(h[k]) for k in keys) and h["aux"] > 0 for h in hist):
        raise AssertionError(f"[jamba-train] metrics {[[h.get(k) for k in keys] for h in hist]}")

    tokens = torch.as_tensor(wb[0, 0], device="cuda")

    def grads(c):
        loss, _ = train_loss(c, model, {"tokens": tokens})
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    for a, b in zip(grads(cfg), grads(cfg.replace(remat="full")), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[jamba-train] remat='full' is not bit-equal to 'none'")
    for a, b in zip(grads(cfg), grads(cfg), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[jamba-train] two runs of one forward+backward differ")
    log(f"[jamba-train] {STEPS} steps, (loss, xent, aux) "
        f"{[tuple(h[k] for k in keys) for h in hist]}, launches {launches} ({per_step} per "
        f"step: {len(paths)} leaves in launches of at most {_pipe.MAX_LEAVES}); remat 'full' "
        "bit-equal to 'none'; two forward+backward runs byte-equal")
    del trainer, model
    _free_card()
    return {"launches": launches["gc_fused"], "gaps": gaps, "losses": [h["loss"] for h in hist],
            "sim": sim, "cfg": cfg, "seq_len": 256, "phase": "jamba-train"}


def _xlstm_state_bytes(cfg, slab) -> int:
    """Bytes of one slot's state over every layer (``pos`` aside): a
    stacked tree's slot is its second axis (its ``pos`` is (layers, slots)),
    a single layer's its first."""
    return sum(t.element_size() * (t[:, 0] if tree["pos"].ndim == 2 else t[0]).numel()
               for tree in _slab_trees(slab) for k, t in tree.items() if k != "pos")


def _layer_mixer(cfg, model, i: int) -> dict:
    """Layer ``i``'s mixer parameters, as ``stack.apply_stack`` hands them
    to the layer: from a run of one, a stacked run at its index, or a
    pattern's position at its repeat."""
    from repro_torch.models.stack import Run, _tree, plan_segments

    first = 0
    for seg, node in zip(plan_segments(cfg.layers), model.stack):
        n = seg.count if isinstance(seg, Run) else len(seg.specs) * seg.repeats
        if i < first + n:
            if isinstance(seg, Run) and seg.count == 1:
                return _tree(node)["mixer"]
            r, j = (i - first, None) if isinstance(seg, Run) else divmod(i - first,
                                                                         len(seg.specs))
            index = {id(t): t.unbind(0)[r] for t in node.parameters()}
            return _tree(node if j is None else node[j], index)["mixer"]
        first += n
    raise IndexError(f"layer {i} of {cfg.n_layers}")


def _xlstm_fp32_ops(cfg, s: int, b: int, decode: bool) -> int:
    """fp32 operations of the recurrences for ``b`` rows of ``s`` tokens.
    mLSTM, prefill: per chunk of length L and head, Q K^T and S V (4·L²·dh),
    the carried state's Q C0^T after the first chunk (2·L·dh²) and the end
    state V^T diag(u) K (2·L·dh²); decode: per head the update and read of
    C (5·dh²).  sLSTM: the block-diagonal recurrence, 2·d·4·dh per token."""
    from repro_torch.models.xlstm import mlstm_dims, slstm_dims

    _, _, nh, dh = mlstm_dims(cfg)
    snh, sdh, _ = slstm_dims(cfg)
    n_m = sum(l.mixer == "mlstm" for l in cfg.layers)
    n_s = sum(l.mixer == "slstm" for l in cfg.layers)
    if decode:
        mlstm = 5 * dh * dh
    else:
        chunk = min(cfg.scan_chunk, s)
        lengths = [min(chunk, s - i) for i in range(0, s, chunk)]
        mlstm = sum(4 * L * L * dh + 2 * L * dh * dh for L in lengths)
        mlstm += sum(2 * L * dh * dh for L in lengths[1:])
    return b * (n_m * nh * mlstm + n_s * s * 2 * cfg.d_model * 4 * sdh)


def _xlstm_times(cfg, model, slab, g) -> dict:
    """A ``g["prefill_len"]``-token prefill at B = 1 and one ``decode_step``
    of the slab (every row as the engine left it), host-inclusive and
    device-only, beside their bounds: the bytes (every fp32 weight read
    once — the tied table is the head's — each slot's state written by
    the prefill, read and written by a decode step, the logits written)
    over the memory rate, and the operations — the matmuls (2 per weight
    and token, bf16 tensor cores) and the recurrences' fp32 work
    (``_xlstm_fp32_ops``) — over the peak rates.  The prefill's device-only
    time is left out (a graph of its ~0.3 M kernels); its pieces are
    timed instead: one mLSTM mixer and one sLSTM mixer at S tokens, both
    ways, and the rest (embedding, norms, residuals, head) as what the
    whole prefill's host-inclusive time leaves."""
    import numpy as np
    import torch

    from repro_torch.models import xlstm
    from repro_torch.models.model import decode_step, prefill

    n_params = sum(t.numel() for t in model.leaves())
    s, b = g["prefill_len"], g["n_slots"]
    state = _xlstm_state_bytes(cfg, slab)
    vocab, d = cfg.vocab, cfg.d_model
    tok = torch.from_numpy(np.random.default_rng(1).integers(0, vocab, size=(1, s))).cuda()
    tokens = torch.arange(1, b + 1, device="cuda")[:, None]
    caches = [[{k: v.clone() for k, v in tree.items()} for tree in seg] if isinstance(seg, list)
              else {k: v.clone() for k, v in seg.items()} for seg in slab]
    cases = {"prefill": (4 * n_params + state + 4 * s * vocab, 2 * n_params * s,
                         _xlstm_fp32_ops(cfg, s, 1, False), f"S={s} B=1"),
             "decode_step": (4 * n_params + 2 * state * b + 4 * b * vocab, 2 * n_params * b,
                             _xlstm_fp32_ops(cfg, 1, b, True), f"B={b}")}
    out = {}
    with torch.no_grad():
        fns = {"prefill": lambda: prefill(cfg, model, tok),
               "decode_step": lambda: decode_step(cfg, model, caches, tokens)}
        for name, (n_bytes, n_ops, n_fp32, shape) in cases.items():
            times = {"ms": time_ms(fns[name], 2 if name == "prefill" else 5,
                                   warmup=1 if name == "prefill" else 3),
                     "device_ms": None if name == "prefill" else device_ms(fns[name], 3)}
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / BF16_FLOPS * 1e3 + n_fp32 / FP32_FLOPS * 1e3
            times.update(bound_ms=max(bytes_ms, ops_ms),
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            out[name] = times
            dev = ("not measured" if times["device_ms"] is None
                   else f"{times['device_ms']:.4f} ms")
            log(f"[xlstm-serve] {name} {shape}, bf16 activations: incl {times['ms']:.4f} ms, "
                f"device-only {dev}, bound {times['bound_ms']:.4f} ms ({times['bound_by']}; "
                f"bytes {bytes_ms:.4f}, operations {ops_ms:.4f}: bf16 matmuls "
                f"{n_ops / BF16_FLOPS * 1e3:.4f}, fp32 recurrences {n_fp32 / FP32_FLOPS * 1e3:.4f})"
                + ("" if times["device_ms"] is None else
                   f"; share of bound (device-only) {times['bound_ms'] / times['device_ms']:.3f}"))
        del caches
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((1, s, d), generator=gen, device="cuda").to(torch.bfloat16)
        first = {k: [l.mixer for l in cfg.layers].index(k) for k in ("mlstm", "slstm")}
        layers = {k: _layer_mixer(cfg, model, i) for k, i in first.items()}
        pieces = {}
        for kind, fn in (("mlstm", xlstm.mlstm_forward), ("slstm", xlstm.slstm_forward)):
            spec = cfg.layers[first[kind]]

            def call(fn=fn, p=layers[kind], spec=spec):
                return fn(cfg, p, x, spec, mode="prefill")

            pieces[kind] = {"ms": time_ms(call, 2, warmup=1), "device_ms": device_ms(call, 1)}
    counts = {k: sum(l.mixer == k for l in cfg.layers) for k in ("mlstm", "slstm")}
    whole = out["prefill"]["ms"]
    rest = whole - sum(pieces[k]["ms"] * n for k, n in counts.items())
    log(f"[xlstm-serve] prefill pieces, S={s} B=1 (incl / device-only ms): mLSTM mixer "
        f"{pieces['mlstm']['ms']:.4f} / {pieces['mlstm']['device_ms']:.4f} (x{counts['mlstm']}: "
        f"{pieces['mlstm']['ms'] * counts['mlstm'] / whole:.3f} of the prefill), sLSTM mixer "
        f"{pieces['slstm']['ms']:.4f} / {pieces['slstm']['device_ms']:.4f} (x{counts['slstm']}: "
        f"{pieces['slstm']['ms'] * counts['slstm'] / whole:.3f}; {s} tokens of a Python loop), "
        f"the rest {rest:.4f} ({rest / whole:.3f}) of the prefill's {whole:.4f}; the mixers' "
        f"device-only sum "
        f"{sum(pieces[k]['device_ms'] * n for k, n in counts.items()):.4f}")
    out["pieces"] = pieces
    return out


def _xlstm_prefill_logits(cfg, model, toks, s: int, scan_chunk: int = 0,
                          bf16_taps: bool = False):
    """The prefill logits of ``toks`` (B, T) with fp32 activations at the
    teacher-forced positions s .. T-2, as (T-1-s, B, V): with the mLSTM in
    chunks of ``scan_chunk`` (0: the config's), and with ``bf16_taps`` the
    bf16 slab's rounding emulated — from position s on, every mLSTM conv
    reads its earlier taps rounded to bf16, as a decode step reads them
    from a bf16 slab (the same sum, in the same order)."""
    import torch

    from repro_torch.models import xlstm
    from repro_torch.models.model import prefill

    act = cfg.replace(dtype="float32", scan_chunk=scan_chunk or cfg.scan_chunk)
    conv = xlstm._causal_conv

    def slab_taps(x, w, b, init_state=None):
        out, state = conv(x, w, b)
        k = w.shape[0]
        xp = torch.cat([torch.zeros_like(x[:, :k - 1]), x], dim=1)
        xr = xp.to(torch.bfloat16).to(x.dtype)
        taps = sum(xr[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k - 1))
        taps = taps + xp[:, k - 1:] * w[k - 1].to(x.dtype) + b.to(x.dtype)
        return torch.cat([out[:, :s], taps[:, s:]], dim=1), state

    xlstm._causal_conv = slab_taps if bf16_taps else conv
    try:
        with torch.no_grad():
            logits = prefill(act, model, toks)[0]
    finally:
        xlstm._causal_conv = conv
    return logits[:, s:toks.shape[1] - 1].transpose(0, 1)


def _xlstm_teacher_forcing(cfg, model, outputs, s: int) -> dict:
    """Teacher forcing as ``_teacher_forcing`` runs it — rows 0-1 with fp32
    activations on a bf16 slab, row 2 fp32 on an fp32 slab — each held to
    the larger of ``[serve]``'s bound and twice the prefill's own change
    under the same rounding at the same rows (``_xlstm_prefill_logits``):
    for the fp32 row, the mLSTM chunk halved (the same function summed in
    another order); for the bf16-slab rows, the slab's rounding of the
    conv taps emulated from position s on.  At a random init the stack
    amplifies rounding, so those changes, not the bounds alone, set how
    far two exact forms of one function can differ.  The config's bf16
    activations on a bf16 slab are measured, not gated."""
    import numpy as np
    import torch

    toks = torch.from_numpy(np.stack(outputs).astype(np.int64)).cuda()
    act = cfg.replace(dtype="float32")
    slab, _ = teacher_forced_tokens(act, model, toks[:2], s, torch.bfloat16, "cuda")
    fp32, fp32_want = teacher_forced_tokens(act, model, toks[2:3], s, torch.float32, "cuda")
    bf16, bf16_want = teacher_forced_tokens(cfg, model, toks[:2], s, torch.bfloat16, "cuda")
    plain = _xlstm_prefill_logits(cfg, model, toks, s)
    half = _xlstm_prefill_logits(cfg, model, toks[2:3], s, cfg.scan_chunk // 2)
    taps = _xlstm_prefill_logits(cfg, model, toks[:2], s, bf16_taps=True)
    floors = {"fp32": _rel_err(half, plain[:, 2:3]), "bf16_slab": _rel_err(taps, plain[:, :2])}
    out = {"fp32": _rel_err(fp32, fp32_want), "bf16_slab": _rel_err(slab, plain[:, :2]),
           "bf16_slab_vs_emulated": _rel_err(slab, taps),
           "bf16_activations": _rel_err(bf16, bf16_want)}
    bounds = {"fp32": max(SERVE_FP32_REL, 2 * floors["fp32"]),
              "bf16_slab": max(SERVE_BF16_REL, 2 * floors["bf16_slab"])}
    log(f"[xlstm-serve] teacher forcing over {toks.shape[1] - s - 1} decode steps (error of "
        f"the largest logit): fp32 activations, fp32 slab (1 row) {out['fp32']:.3e} (bound "
        f"{bounds['fp32']:.3e}: the prefill's own change with half the mLSTM chunk "
        f"{floors['fp32']:.3e}); fp32 activations, bf16 slab (2 rows) {out['bf16_slab']:.3e} "
        f"(bound {bounds['bf16_slab']:.3e}: the prefill's own change with the slab's bf16 conv "
        f"taps {floors['bf16_slab']:.3e}; against that prefill {out['bf16_slab_vs_emulated']:.3e}"
        f"); the config's bf16 activations, bf16 slab (2 rows) {out['bf16_activations']:.3e}, "
        "measured, not gated")
    for name, bound in bounds.items():
        if not out[name] <= bound:
            raise AssertionError(f"[xlstm-serve] teacher-forced logits, {name}: "
                                 f"{out[name]:.3e} (bound {bound:.3e})")
    return {"teacher_forcing": out, "floors": floors}


def phase_xlstm_serve():
    """Full-width xlstm-1.3b cut in depth (d_model 2048; 8 of 48 layers:
    one period — a run of seven mLSTM layers of d_inner 4,096 over 4 heads
    of 1,024 and an sLSTM layer; no FFN sublayers; vocab 50,304, tied;
    bf16 activations), 405,444,664 parameters, in a
    ``ServeEngine`` of 8 slots over a bf16 slab: 16 requests of 512-token
    prompts and 32 new tokens each (``_serve_run``'s gates).  The slab
    holds a fixed state per slot and no K/V: ``C``, ``n``, ``m`` and the
    sLSTM state fp32, ``conv`` bf16.  The prefill's pieces and
    ``decode_step`` against their bounds (``_xlstm_times``); teacher
    forcing with fp32 activations on a bf16 slab (2e-2) and fp32 on an
    fp32 slab (1e-4), the config's bf16 activations on a bf16 slab
    measured, not gated; peak memory under 80 GB."""
    import numpy as np
    import torch

    from repro_torch.models.blocks import has_ffn
    from repro_torch.models.params import GCLM

    _free_card()
    g = XLSTM_SERVE
    cfg = _cut("xlstm-1.3b", g["n_layers"])
    mixers = [l.mixer for l in cfg.layers]
    periods = g["n_layers"] // 8
    if mixers != (["mlstm"] * 7 + ["slstm"]) * periods or \
            any(has_ffn(cfg, l) for l in cfg.layers):
        raise AssertionError(f"[xlstm-serve] not the published layout: {mixers}")
    model = GCLM(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.leaves())
    if n_params != 405_444_664 or len(model.leaves()) != 22:
        raise AssertionError(f"[xlstm-serve] {n_params} parameters in {len(model.leaves())} "
                             "leaves, expected 405,444,664 in 22")
    run = _serve_run("xlstm-serve", cfg, model, g)
    eng, reqs = run["eng"], run["reqs"]
    trees = _slab_trees(eng.slab)
    state = _xlstm_state_bytes(cfg, eng.slab)
    dtypes = {k: str(t.dtype) for tree in trees for k, t in tree.items() if k != "pos"}
    m_tree = next(tree for tree in trees if "C" in tree)
    if state != 117_760_112 or dtypes.pop("conv") != "torch.bfloat16" or \
            set(dtypes.values()) != {"torch.float32"}:
        raise AssertionError(f"[xlstm-serve] the slab's state: {state} bytes per slot, {dtypes}")
    log(f"[xlstm-serve] slab: no K/V; a fixed state of {state} bytes per slot whatever the "
        f"length ({7 * periods} mLSTM layers x (C {tuple(m_tree['C'].shape[-3:])} + n + m "
        f"fp32, conv {tuple(m_tree['conv'].shape[-2:])} bf16) + {periods} sLSTM layers x 4 x "
        f"{cfg.d_model} fp32), "
        f"{state * g['n_slots']} bytes for {g['n_slots']} slots")
    times = _xlstm_times(cfg, model, eng.slab, g)
    tokens_per_s, peak = run["tokens_per_s"], run["peak"]
    outputs = [r.output for r in reqs[:3]]
    del run, eng, reqs, trees, m_tree
    _free_card()
    tf = _xlstm_teacher_forcing(cfg, model, outputs, g["prompt_len"])
    log(f"[xlstm-serve] max_memory_allocated during the engine run {peak} bytes "
        f"({peak / 1e9:.2f} GB: the weights {4 * n_params / 1e9:.2f} GB fp32, the slab "
        f"{state * g['n_slots'] / 1e9:.2f} GB, the prefill's activations)")
    if not peak < 80e9:
        raise AssertionError(f"[xlstm-serve] peak {peak} bytes")
    del model
    _free_card()
    return {"tokens_per_s": tokens_per_s, "peak": peak, "state_bytes_per_slot": state,
            **tf, **times}


def _worst_rel_held(got, want, paths, bound: float, what: str, partner) -> float:
    """``_worst_rel`` over the leaves; a leaf whose gradient is zero in exact
    arithmetic — ``partner(path)`` names another leaf of its layer, else
    None — is held at ``bound`` of that leaf's gradient instead."""
    by_path = dict(zip(paths, want, strict=True))
    keep = [i for i, p in enumerate(paths) if partner(p) is None]
    worst = _worst_rel([got[i] for i in keep], [want[i] for i in keep],
                       [paths[i] for i in keep], bound, what)
    for i, p in enumerate(paths):
        if partner(p) is not None:
            err = ((got[i] - want[i]).abs().max() / by_path[partner(p)].abs().max()).item()
            if not err <= bound:
                raise AssertionError(f"{what} at {p}: {err:.3e} of {partner(p)}'s gradient "
                                     f"> {bound}")
    return worst


def phase_xlstm_train():
    """Coded training of xlstm-1.3b at its published widths cut to its
    layers 5 to 8 of 48 (a run of 3 mLSTM layers and the period's sLSTM,
    254,212,120 parameters in 22 leaves; 16 fp32 rows of 1.02 GB per
    step), bf16 activations and ``remat="dots"`` as the config has
    them, in sim mode with the gc-lm-110m plan settings (N = 4, ``xf``,
    s_max = 3, seq 256: one mLSTM chunk, global batch 8).  ``Trainer.run``
    for 3 steps with the counts set to 0 just before: one grouped
    ``gc_fused`` launch per step, finite ``loss`` and ``xent``; the rows
    of its step 0 give a coded gradient equal to the uncoded one
    (``EXACT_RTOL`` per leaf; ``b_i``, zero in exact arithmetic, at its
    ``b_f``'s) with 0, 1 and s_max stragglers.  On the
    card: ``remat`` "none", "dots" and "full" bit-equal, and two runs of
    one forward+backward byte-equal."""
    import numpy as np
    import torch

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    from repro_torch.configs import get_config

    full = get_config("xlstm-1.3b")
    layers = full.layers[XLSTM_TRAIN_LAYERS]
    cfg = full.replace(n_layers=len(layers), layers=layers)
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=256)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    paths = model.leaf_paths()
    n_params = sum(t.numel() for t in model.leaves())
    mixers = [l.mixer for l in cfg.layers]
    if len(paths) != 22 or n_params != 254_212_120 or cfg.dtype != "bfloat16" or \
            cfg.remat != "dots" or mixers != ["mlstm"] * 3 + ["slstm"]:
        raise AssertionError(f"[xlstm-train] {n_params} params in {len(paths)} leaves, "
                             f"{cfg.dtype}, remat {cfg.remat}, mixers {mixers}")
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    g_ref = uncoded_grad_fn(cfg, n)(model, shards)  # step 0's parameters
    take = _keep_step0_rows(trainer.step_fn.grad_fn)

    reset_counts()
    trainer.run(STEPS, log_every=1, log_fn=lambda m: log(f"[xlstm-train] {m}"))
    torch.cuda.synchronize()
    launches = read_counts()
    gaps, _ = _sim_grads("xlstm-train", plan, take(wb), g_ref, paths, _b_i_partner)
    del g_ref
    log(f"[xlstm-train] xlstm-1.3b at full width, layers {XLSTM_TRAIN_LAYERS.start + 1} to "
        f"{XLSTM_TRAIN_LAYERS.stop} of 48 ({mixers.count('mlstm')} mLSTM, "
        f"{mixers.count('slstm')} sLSTM, bf16 activations, "
        f"remat {cfg.remat}): {n_params} params in {len(paths)} leaves, "
        f"N*K={n * plan.k_shards}; step 0 (the trainer's own rows), coded == uncoded, worst "
        f"leaf relative max error at 0 / 1 / s_max stragglers: "
        + " / ".join(f"{v:.3e}" for v in gaps.values()) + f" (bound {EXACT_RTOL})")
    hist = trainer.history
    if launches != {"gc_fused": STEPS, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[xlstm-train] launches {launches} in {STEPS} steps, expected "
                             f"one grouped gc_fused launch per step ({len(paths)} leaves)")
    keys = ("loss", "xent")
    if not all(all(math.isfinite(h[k]) for k in keys) for h in hist):
        raise AssertionError(f"[xlstm-train] metrics {[[h.get(k) for k in keys] for h in hist]}")

    tokens = torch.as_tensor(wb[0, 0], device="cuda")

    def grads(c):
        loss, _ = train_loss(c, model, {"tokens": tokens})
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    plain = grads(cfg.replace(remat="none"))
    for remat in ("dots", "full"):
        for a, b in zip(plain, grads(cfg.replace(remat=remat)), strict=True):
            if not torch.equal(a, b):
                raise AssertionError(f"[xlstm-train] remat={remat!r} is not bit-equal to 'none'")
    for a, b in zip(plain, grads(cfg.replace(remat="none")), strict=True):
        if not torch.equal(a, b):
            raise AssertionError("[xlstm-train] two runs of one forward+backward differ")
    log(f"[xlstm-train] {STEPS} steps, (loss, xent) {[tuple(h[k] for k in keys) for h in hist]}"
        f", launches {launches} (one per step: {len(paths)} leaves); remat 'dots' and 'full' "
        "bit-equal to 'none'; two forward+backward runs byte-equal")
    del trainer, model, plain
    _free_card()
    return {"launches": launches["gc_fused"], "gaps": gaps}


def _open_gates(model, seed: int) -> None:
    """Every cross-attention ``gate`` leaf drawn from U(``GATE_RANGE``)
    (numpy, ``seed``): at the init (0) tanh closes every cross sublayer, the
    source adds nothing, and the encoder, ``vision_proj`` and the cross
    projections get zero gradient."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for path, t in model.leaf_items():
            if path[-1] == "gate":
                t.copy_(torch.from_numpy(rng.uniform(*GATE_RANGE, tuple(t.shape))
                                         .astype(np.float32)))


def _aux_rows(cfg, n: int, seed):
    """``n`` rows of stubbed modality embeddings, standard normal fp32 drawn
    with numpy from ``seed`` and put on the card: frames (n, n_frames,
    d_model) for Whisper, patches (n, n_patches, d_vision) for vision."""
    import numpy as np
    import torch

    shape = ((cfg.encoder.n_frames, cfg.d_model) if cfg.encoder is not None
             else (cfg.vision.n_patches, cfg.vision.d_vision))
    rows = np.random.default_rng(seed).standard_normal((n, *shape), dtype=np.float32)
    return torch.from_numpy(rows).cuda()


def _worker_aux(cfg, step: int, n_workers: int, s_max: int, rows: int):
    """The step's (N, rows, ...) shard embeddings (seed (0, step, shard))
    and ``worker_aux`` (N, K, rows, ...) by the cyclic map of
    ``coded_worker_batches``: worker n, slot k holds shard (n + k) mod N."""
    import torch

    shards = torch.stack([_aux_rows(cfg, rows, (0, step, i)) for i in range(n_workers)])
    return shards, torch.stack([torch.stack([shards[(n + k) % n_workers]
                                             for k in range(s_max + 1)])
                                for n in range(n_workers)])


def _cross_train(tag, cfg, partner=lambda p: None, seq_len: int = 256) -> dict:
    """Coded training of a model with a cross-attention source in sim mode
    with the gc-lm-110m plan settings (N = 4, ``xf``, s_max = 3, global
    batch 8), the gates open, ``worker_aux`` per step from the seed:
    ``make_coded_train_step``'s step with ``worker_aux`` for 3 steps with
    the counts set to 0 just before: ceil(leaves / 32) ``gc_fused``
    launches per step, finite losses; the rows of its step 0 give a coded
    gradient equal to the uncoded one (``_sim_grads``: ``EXACT_RTOL`` per
    leaf; ``partner`` names the leaf against whose gradient a leaf that is
    zero in exact arithmetic is held) with 0, 1 and s_max stragglers
    (returned under ``"sim"``, on the card); two runs of one
    forward+backward byte-equal."""
    import numpy as np
    import torch

    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import _pipe
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=seq_len)
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    _open_gates(model, 0)
    paths = model.leaf_paths()
    n_params = sum(t.numel() for t in model.leaves())
    rows_per_shard = trainer.data.cfg.global_batch // n
    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    shard_aux, wa = _worker_aux(cfg, 0, n, plan.s_max, rows_per_shard)
    g_ref = uncoded_grad_fn(cfg, n)(model, shards, shard_aux)  # step 0's parameters
    take = _keep_step0_rows(trainer.step_fn.grad_fn)

    inputs = [(wb, wa)]
    for i in range(1, STEPS):
        wb_i = coded_worker_batches(trainer.data, i, n, plan.s_max)
        inputs.append((wb_i, _worker_aux(cfg, i, n, plan.s_max, rows_per_shard)[1]))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    walls, losses = [], []
    for wb_i, wa_i in inputs:
        dec_w, _ = trainer.sim.step()
        t0 = time.perf_counter()
        trainer.state, metrics = trainer.step_fn(trainer.state, wb_i, dec_w, wa_i)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        losses.append(float(metrics["loss"]))
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    if launches != {"gc_fused": per_step * STEPS, "gc_encode": 0, "gc_decode": 0}:
        raise AssertionError(f"[{tag}] launches {launches} in {STEPS} steps, expected "
                             f"{per_step} gc_fused launches per step ({len(paths)} leaves)")
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[{tag}] losses {losses}")
    gaps, sim = _sim_grads(tag, plan, take(wb, wa), g_ref, paths, partner)
    del g_ref
    log(f"[{tag}] {cfg.name}: {n_params} params in {len(paths)} leaves, {cfg.n_layers} "
        f"layers, {cfg.dtype} activations, remat {cfg.remat}, aux {tuple(wa.shape)} fp32, "
        f"N*K={n * plan.k_shards}; step 0 (the trainer's own rows), coded == uncoded, worst "
        f"leaf relative max error at 0 / 1 / s_max stragglers: "
        + " / ".join(f"{v:.3e}" for v in gaps.values()) + f" (bound {EXACT_RTOL})")

    tokens = torch.as_tensor(wb[0, 0], device="cuda")
    batch = {"tokens": tokens, "aux_inputs": wa[0, 0]}

    def grads():
        loss, _ = train_loss(cfg, model, batch)
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    first = grads()
    if not all(torch.equal(a, b) for a, b in zip(first, grads(), strict=True)):
        raise AssertionError(f"[{tag}] two runs of one forward+backward differ")
    log(f"[{tag}] {STEPS} steps of make_coded_train_step with worker_aux: losses {losses}, "
        f"step wall_s {[round(w, 4) for w in walls]}, launches {launches} ({per_step} per step: "
        f"{len(paths)} leaves); max_memory_allocated {peak} bytes ({peak / 1e9:.2f} GB, step "
        "0's rows and the uncoded gradient held for the check); two forward+backward runs "
        "byte-equal")
    out = {"launches": launches["gc_fused"], "gaps": gaps, "step_s": walls, "peak": peak,
           "model": model, "batch": batch, "trainer": trainer, "losses": losses, "sim": sim}
    return out


def phase_whisper_train():
    """Coded training of whisper-base at full width and depth (6 encoder
    and 6 decoder layers, d_model 512, 1,500 frames, bf16 activations;
    70,646,278 parameters in 103 leaves), seq 224 (``_cross_train``):
    coded == uncoded at step 0 — the encoder's ``bk``, whose gradient is
    zero in exact arithmetic (no RoPE: a key bias shifts a query row's
    scores alike), against its layer's ``bq`` — 3 steps with 4 ``gc_fused``
    launches each; the encoder's share of one pass (host-inclusive
    forward+backward of one shard, 2 rows, against the encoder's alone)."""
    import torch

    from repro_torch.configs import get_config
    from repro_torch.models.model import run_encoder, train_loss

    _free_card()
    cfg = get_config("whisper-base")
    run = _cross_train("whisper-train", cfg, seq_len=WHISPER_TRAIN["seq_len"],
                       partner=_encoder_bk_partner)
    model, batch = run["model"], run["batch"]
    n_params = sum(t.numel() for t in model.leaves())
    if len(model.leaves()) != 103 or n_params != 70_646_278 or cfg.dtype != "bfloat16" or \
            cfg.encoder.n_frames != 1500 or cfg.encoder.n_layers != 6:
        raise AssertionError(f"[whisper-train] {n_params} params in {len(model.leaves())} "
                             f"leaves, {cfg.dtype}, {cfg.encoder}")
    leaves = model.leaves()
    enc = [t for p, t in model.leaf_items() if p[0] == "encoder"]

    def one_pass():
        loss, _ = train_loss(cfg, model, batch)
        torch.autograd.grad(loss, leaves)

    def encoder_pass():
        out = run_encoder(cfg, model, batch["aux_inputs"])
        torch.autograd.grad(out.float().square().mean(), enc)

    pass_ms, enc_ms = time_ms(one_pass, 3, warmup=1), time_ms(encoder_pass, 3, warmup=1)
    log(f"[whisper-train] one shard's forward+backward ({batch['tokens'].shape[0]} rows x "
        f"{batch['tokens'].shape[1]} tokens over {cfg.encoder.n_frames} frames): "
        f"{pass_ms:.4f} ms host-inclusive; the encoder's alone "
        f"{enc_ms:.4f} ms ({enc_ms / pass_ms:.3f} of the pass)")
    out = {k: run[k] for k in ("launches", "gaps", "step_s", "peak")}
    del run, model, batch, leaves, enc
    _free_card()
    return {**out, "pass_ms": pass_ms, "encoder_ms": enc_ms}


def phase_vision_train():
    """Coded training of ``llama-3.2-vision-11b.reduced(n_layers=10)`` (two
    periods: the cross layer stacked in a pattern; 50 leaves) with 16-patch
    aux rows (``_cross_train``): coded == uncoded at step 0, 3 steps with 2
    ``gc_fused`` launches each, two forward+backward runs byte-equal.  It
    runs before [spmd] and saves its step-0 sim-mode gradients for
    [cross-tp], which trains the same config, weights, gates and batches
    on the model axis (``_save_sim``)."""
    from repro_torch.configs import get_config

    _free_card()
    cfg = get_config("llama-3.2-vision-11b").reduced(n_layers=VISION_TRAIN_LAYERS)
    run = _cross_train("vision-train", cfg)
    if len(run["model"].leaves()) != 50:
        raise AssertionError(f"[vision-train] {len(run['model'].leaves())} leaves, expected 50")
    out = {k: run[k] for k in ("launches", "gaps", "step_s", "peak", "losses")}
    out["sim"] = _save_sim("vision-train", run["sim"])
    del run
    _free_card()
    return {**out, "cfg": cfg, "seq_len": 256, "phase": "vision-train"}


def phase_whisper_tp_sim():
    """[cross-tp]'s Whisper in one process, sim mode: whisper-base at the
    reference's smoke widths with its published vocabulary (``reduced()``,
    fp32: 2 encoder and 2 decoder layers, d_model 256, 64 frames, 51,865
    rows, whole on the model axis: odd) at ``WHISPER_TP_SEQ`` tokens
    (``_cross_train``: 3 steps with 2 ``gc_fused`` launches each, coded ==
    uncoded at step 0, the encoder's ``bk`` held at its ``bq``'s); its
    step-0 sim-mode gradients saved for [cross-tp].  [whisper-train]
    trains the full width in the config's bf16, whose rounding the axis's
    split sums would move past the 1e-5 gate; the full width in fp32 costs
    more than the script's budget holds (``WHISPER_TP_SEQ``)."""
    from repro_torch.configs import get_config

    _free_card()
    cfg = get_config("whisper-base").reduced().replace(vocab=get_config("whisper-base").vocab)
    run = _cross_train("whisper-tp-sim", cfg, partner=_encoder_bk_partner,
                       seq_len=WHISPER_TP_SEQ)
    out = {k: run[k] for k in ("launches", "gaps", "losses")}
    out["sim"] = _save_sim("whisper-tp-sim", run["sim"])
    del run
    _free_card()
    return {**out, "cfg": cfg, "seq_len": WHISPER_TP_SEQ, "phase": "whisper-tp-sim",
            "partner": _encoder_bk_partner}


def _encoder_bk_partner(path):
    """An encoder ``bk``'s partner, its layer's ``bq`` (its gradient is zero
    in exact arithmetic: no RoPE, a key bias shifts a query row's scores
    alike), else None."""
    return path[:-1] + "q" if path.startswith("encoder.") and path.endswith(".bk") else None


def _b_i_partner(path):
    """An mLSTM ``b_i``'s partner, its layer's ``b_f`` (its gradient is
    zero in exact arithmetic: a shift of every log_i of a head moves C, n
    and e^m alike), else None."""
    return path[:-1] + "f" if path.endswith("b_i") else None


def phase_xlstm_tp_sim():
    """[xlstm-tp]'s config in one process, sim mode:
    ``xlstm-1.3b.reduced(n_layers=8, d_model=384)`` (7 mLSTM layers and the
    sLSTM, 4 heads, the GeGLU 512 wide: split at model 2) with the
    gc-lm-110m plan settings (N = 4, ``xf``, s_max = 3, global batch 8) at
    ``XLSTM_TP["seq_len"]`` tokens.  ``Trainer.run`` for 3 steps with the
    counts set to 0 just before: one grouped ``gc_fused`` call per step,
    finite losses; the rows of its step 0 give a coded gradient equal to
    the uncoded one (``EXACT_RTOL``; ``b_i`` at its ``b_f``'s) with 0, 1
    and s_max stragglers, saved for [xlstm-tp] (``_save_sim``).  The
    stack amplifies rounding at this random init (ROADMAP 3.20): one
    shard's gradient by another exact form — the mLSTM's chunks halved —
    lies a few 1e-6 of a leaf's scale away (printed beside [xlstm-tp]'s
    distance, which ``XLSTM_TP_REL`` bounds)."""
    import numpy as np
    import torch

    from repro_torch.configs import get_config
    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.kernels import _pipe
    from repro_torch.models.model import train_loss
    from repro_torch.train.coded import uncoded_grad_fn
    from repro_torch.train.trainer import TrainConfig, Trainer

    _free_card()
    g = XLSTM_TP
    cfg = get_config("xlstm-1.3b").reduced(n_layers=g["n_layers"], d_model=g["d_model"])
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=4, scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=g["seq_len"])
    plan, model, n = trainer.plan, trainer.state.params, trainer.n_workers
    paths = model.leaf_paths()
    wb = coded_worker_batches(trainer.data, 0, n, plan.s_max)
    shards = np.stack([trainer.data.shard(0, i, n) for i in range(n)])
    g_ref = uncoded_grad_fn(cfg, n)(model, shards)  # step 0's parameters
    # the stack's own rounding: one shard's gradient by two exact forms, the
    # mLSTM's chunks halved in the second (printed beside [xlstm-tp]'s distance)
    tokens = {"tokens": torch.as_tensor(wb[0, 0], device="cuda")}
    one, halved = (torch.autograd.grad(train_loss(c, model, tokens)[0], model.leaves())
                   for c in (cfg, cfg.replace(scan_chunk=cfg.scan_chunk // 2)))
    own_rel = max(((a - b).abs().max() / a.abs().max()).item()
                  for p, a, b in zip(paths, one, halved) if _b_i_partner(p) is None)
    del one, halved
    take = _keep_step0_rows(trainer.step_fn.grad_fn)
    per_step = -(-len(paths) // _pipe.MAX_LEAVES)
    reset_counts()
    trainer.run(STEPS, log_every=0)
    torch.cuda.synchronize()
    launches = read_counts()
    losses = [h["loss"] for h in trainer.history]
    if launches != {"gc_fused": STEPS * per_step, "gc_encode": 0, "gc_decode": 0} or \
            not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"[xlstm-tp-sim] launches {launches}, losses {losses}")
    gaps, sim = _sim_grads("xlstm-tp-sim", plan, take(wb), g_ref, paths, _b_i_partner)
    sim = _save_sim("xlstm-tp-sim", sim)
    del g_ref, trainer
    wide = _xlstm_wide_sim(cfg, g["seq_len"])
    log(f"[xlstm-tp-sim] {cfg.name} reduced ({cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"mixers {[l.mixer for l in cfg.layers]}) at {g['seq_len']} tokens: "
        f"{sum(t.numel() for t in model.leaves())} params in {len(paths)} leaves; step 0, coded "
        f"== uncoded at 0 / 1 / s_max stragglers: "
        + " / ".join(f"{v:.3e}" for v in gaps.values())
        + f" (bound {EXACT_RTOL}); one shard's gradient with the mLSTM's chunks halved "
        f"(another exact form) lies {own_rel:.3e} of a leaf's scale from it; {STEPS} steps: "
        f"losses {losses}, launches {launches}")
    del model
    _free_card()
    return {"launches": launches["gc_fused"], "gaps": gaps, "losses": losses, "sim": sim,
            "cfg": cfg, "seq_len": g["seq_len"], "phase": "xlstm-tp-sim",
            "partner": _b_i_partner, "bound": XLSTM_TP_REL, "own": own_rel, "wide": wide}


def _xlstm_wide_sim(base, seq_len: int) -> dict:
    """[xlstm-wide]'s reference in one process: ``base`` with
    ``XLSTM_WIDE["n_heads"]`` heads in a sim-mode trainer of
    ``XLSTM_WIDE["data"]`` workers; step 0's coded gradients at 0 and
    s_max stragglers from its per-shard rows, saved (``_save_sim``) for
    the ranks."""
    from repro_torch.core import ShiftedExponential
    from repro_torch.data.pipeline import coded_worker_batches
    from repro_torch.train.coded import combine_rows
    from repro_torch.train.trainer import TrainConfig, Trainer

    t0 = time.perf_counter()
    w = XLSTM_WIDE
    cfg = base.replace(n_heads=w["n_heads"], n_kv_heads=w["n_heads"])
    trainer = Trainer(cfg, TrainConfig(lr=3e-4, warmup=10, total_steps=300),
                      ShiftedExponential(mu=1e-3, t0=50.0), n_workers=w["data"], scheme="xf",
                      global_batch=8, seed=0, device="cuda", seq_len=seq_len)
    plan = trainer.plan
    rows = trainer.step_fn.grad_fn.rows(trainer.state.params,
                                        coded_worker_batches(trainer.data, 0, w["data"],
                                                             plan.s_max))
    sim = {u: combine_rows(plan, rows, _straggler_dec_w(plan, u))
           for u in sorted({0, plan.s_max})}
    path = _save_sim("xlstm-wide", sim)
    log(f"[xlstm-tp-sim] [xlstm-wide]'s reference: {cfg.n_heads} heads, N = {w['data']} "
        f"(s_max {plan.s_max}, x {[int(v) for v in plan.x]}), step 0's sim-mode coded "
        f"gradients at {sorted(sim)} stragglers saved; {time.perf_counter() - t0:.1f} s")
    del trainer, rows, sim
    return {"cfg": cfg, "seq_len": seq_len, "sim": path, "x": [int(v) for v in plan.x]}


def _cross_bounds(cfg, model, b: int, s: int, cap: int, decode: bool) -> tuple:
    """(bytes, bf16 operations) of a prefill of ``s`` tokens (B = ``b``) or
    of one decode step over caches of capacity ``cap``.  Bytes: every fp32
    weight read once (of an untied model's embedding table only the rows
    looked up), the aux inputs read, the self-attention K/V written by a
    prefill or read by a decode step (the activations' dtype), the logits
    written.  Operations, 2 per weight and row: the decoder's weights per
    token (the head included); a cross layer's K/V projections per source
    row; the source itself — Llama-3.2-vision's projector per patch,
    Whisper's encoder per frame with its non-causal attention (4·H·Dh per
    frame pair); 4·H·Dh per attention pair, causal for self-attention,
    every source row for cross-attention."""
    d, hd = cfg.d_model, cfg.n_heads * cfg.head_dim
    kvd = cfg.n_kv_heads * cfg.head_dim
    item = 2 if cfg.dtype == "bfloat16" else 4
    ffn = (3 if cfg.activation in ("silu", "gelu") else 2) * d * cfg.d_ff
    n_self = sum(l.mixer == "attn" for l in cfg.layers)
    n_cross = sum(l.mixer == "cross_attn" or l.cross_source for l in cfg.layers)
    per_token = (n_self * (2 * d * hd + 2 * d * kvd) + n_cross * 2 * d * hd
                 + cfg.n_layers * ffn + d * cfg.vocab)
    if cfg.encoder is not None:
        n_src, d_src = cfg.encoder.n_frames, d
        enc_layer = 2 * d * hd + 2 * d * kvd + ffn
        source = cfg.encoder.n_layers * b * (2 * enc_layer * n_src + 4 * hd * n_src * n_src)
    else:
        n_src, d_src = cfg.vision.n_patches, cfg.vision.d_vision
        source = 2 * d_src * d * n_src * b
    tokens = b if decode else b * s
    pairs = b * cap if decode else b * s * (s + 1) // 2
    n_params = sum(t.numel() for t in model.leaves())
    table = 0 if cfg.tie_embeddings else cfg.vocab * d - tokens * d
    n_bytes = (4 * (n_params - table) + 4 * b * n_src * d_src
               + item * 2 * kvd * n_self * (b * cap if decode else tokens)
               + item * tokens * cfg.vocab)
    n_ops = (2 * per_token * tokens + n_cross * 2 * 2 * d * kvd * n_src * b + source
             + 4 * hd * (n_self * pairs + n_cross * tokens * n_src))
    return n_bytes, n_ops


def _clone_caches(caches):
    return [[None if t is None else {k: v.clone() for k, v in t.items()} for t in seg]
            if isinstance(seg, list) else {k: v.clone() for k, v in seg.items()}
            for seg in caches]


def _cross_times(tag, cfg, model, prompts, aux, max_new: int) -> dict:
    """Prefill (B = 1, the prompt length, one aux row) and one
    ``decode_step`` of every row at the last position of caches of
    capacity S + max_new, host-inclusive and device-only, beside their
    bounds (``_cross_bounds``); and the source's own device-only time —
    ``source_embeds``: Whisper's encoder, the vision projector — as a share
    of the decode step, which recomputes it every step."""
    import torch

    from repro_torch.models.model import decode_step, prefill, source_embeds

    b, s = prompts.shape
    cap = s + max_new
    tok = prompts.cuda()
    with torch.no_grad():
        _, caches = prefill(cfg, model, tok, aux_inputs=aux, target_len=cap)
    for seg in caches:
        for tree in (seg if isinstance(seg, list) else [seg]):
            if tree is not None:
                tree["pos"].fill_(cap - 1)
    tokens = torch.arange(1, b + 1, device="cuda")[:, None]
    cases = {"prefill": (lambda: prefill(cfg, model, tok[:1], aux_inputs=aux[:1],
                                         target_len=cap), 1, f"S={s} B=1"),
             "decode_step": (lambda: decode_step(cfg, model, caches, tokens, aux_inputs=aux),
                             b, f"B={b} cap={cap}")}
    out = {}
    with torch.no_grad():
        for name, (fn, rows, shape) in cases.items():
            n_bytes, n_ops = _cross_bounds(cfg, model, rows, s, cap, name == "decode_step")
            times = {"ms": time_ms(fn, 3), "device_ms": device_ms(fn, 3)}
            bytes_ms = n_bytes / HBM_BYTES_PER_S * 1e3
            ops_ms = n_ops / BF16_FLOPS * 1e3
            times.update(bound_ms=max(bytes_ms, ops_ms), n_ops=n_ops,
                         bound_by="bytes" if bytes_ms >= ops_ms else "operations")
            out[name] = times
            log(f"[{tag}] {name} {shape}, {cfg.dtype} activations: incl {times['ms']:.4f} ms, "
                f"device-only {times['device_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
                f"({times['bound_by']}; bytes {bytes_ms:.4f}, operations {ops_ms:.4f}: "
                f"{n_ops / rows / 1e9:.1f} GFLOP per row); share of bound (device-only) "
                f"{times['bound_ms'] / times['device_ms']:.3f}")
        src_ms = device_ms(lambda: source_embeds(cfg, model, aux), 3)
    share = src_ms / out["decode_step"]["device_ms"]
    log(f"[{tag}] the source alone (source_embeds, B={b}): device-only {src_ms:.4f} ms, "
        f"{share:.3f} of a decode step")
    del caches
    return {**out, "source_ms": src_ms, "source_share": share}


def _cross_serve(tag, cfg, model, g, seed: int) -> dict:
    """``generate(aux_inputs=)`` — the direct loop: one prefill, then a
    ``decode_step`` per token, each recomputing the source — of
    ``g["batch"]`` random prompts of ``g["prompt_len"]`` tokens (numpy,
    ``seed``) with their aux rows, ``g["max_new"]`` tokens, greedy, with
    every count set to 0 just before: the tokens' shape and range, no
    ``gc_*`` launch, tokens/s by the wall clock and the peak memory; the
    times (``_cross_times``); teacher forcing one row per call with fp32
    activations on a bf16 slab (2 rows, ``SERVE_BF16_REL``) and on an fp32
    slab (1 row, ``SERVE_FP32_REL``), the config's bf16 activations on a
    bf16 slab measured, not gated."""
    import numpy as np
    import torch

    from repro_torch.serve import generate

    b, s, new = g["batch"], g["prompt_len"], g["max_new"]
    prompts = torch.from_numpy(np.random.default_rng(seed).integers(0, cfg.vocab, size=(b, s)))
    aux = _aux_rows(cfg, b, (seed, 1))
    generate(cfg, model, prompts[:, :8], 2, aux_inputs=aux)  # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    out = generate(cfg, model, prompts, new, aux_inputs=aux)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts, peak = read_counts(), torch.cuda.max_memory_allocated()
    if tuple(out.shape) != (b, s + new) or not torch.equal(out[:, :s], prompts.int()) or \
            int(out.min()) < 0 or int(out.max()) >= cfg.vocab:
        raise AssertionError(f"[{tag}] generate gave {tuple(out.shape)}, tokens in "
                             f"[{int(out.min())}, {int(out.max())}]")
    if any(counts.values()):
        raise AssertionError(f"[{tag}] the serving path launched kernels: {counts}")
    log(f"[{tag}] generate(aux_inputs=) of {b} prompts x {s} tokens + {new}: {b * new} tokens "
        f"in {wall:.3f} s ({b * new / wall:.1f} tok/s); gc_* launches {counts}; "
        f"max_memory_allocated {peak} bytes ({peak / 1e9:.2f} GB)")
    times = _cross_times(tag, cfg, model, prompts[:, :s], aux, new)
    outputs = list(out.numpy()[:3])
    tf = _teacher_forcing(tag, cfg, model, outputs, s, bf16_activations=False, aux=aux[:3])
    toks = torch.from_numpy(np.stack(outputs[:2]).astype(np.int64)).cuda()
    got, want = teacher_forced_tokens(cfg, model, toks, s, torch.bfloat16, "cuda", aux[:2])
    tf["bf16_activations_rel"] = _rel_err(got, want)
    log(f"[{tag}] teacher forcing, the config's {cfg.dtype} activations on a bf16 slab (2 rows): "
        f"{tf['bf16_activations_rel']:.3e} of the largest logit, measured, not gated")
    return {"tokens_per_s": b * new / wall, "peak": peak, **tf, **times}


def phase_whisper_serve():
    """Full-width whisper-base (random weights, seed 0; the gates open)
    through ``_cross_serve``: 4 prompts of 128 tokens + 64 new over 1,500
    frames per row, bf16 activations."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import GCLM

    _free_card()
    cfg = get_config("whisper-base")
    model = GCLM(cfg, device="cuda", seed=0)
    _open_gates(model, 1)
    out = _cross_serve("whisper-serve", cfg, model, WHISPER_SERVE, seed=0)
    del model
    _free_card()
    return out


def phase_vision_serve():
    """Full-width llama-3.2-vision-11b cut to 10 of its 40 layers (a pattern
    of 5 over 2 repeats, cross layers 3 and 8; d_model 4096, 32 heads over
    8 KV heads, d_ff 14,336, vocab 128,256, an untied head, bf16
    activations; 3,263,254,530 parameters, 13.05 GB fp32; random weights,
    seed 0, the gates open) through ``_cross_serve``: 4 prompts of 512
    tokens + 32 new, each row with 1,601 patches of width 7,680; peak
    memory under 80 GB."""
    from repro_torch.configs import get_config
    from repro_torch.models.params import GCLM
    from repro_torch.models.stack import Pattern, plan_segments

    _free_card()
    g = VISION_SERVE
    cfg = _cut("llama-3.2-vision-11b", g["n_layers"])
    segs = plan_segments(cfg.layers)
    if len(segs) != 1 or not isinstance(segs[0], Pattern) or segs[0].repeats != 2 or \
            [l.mixer for l in segs[0].specs] != ["attn"] * 3 + ["cross_attn", "attn"]:
        raise AssertionError(f"[vision-serve] not the published layout: {segs}")
    model = GCLM(cfg, device="cuda", seed=0)
    n_params = sum(t.numel() for t in model.leaves())
    if n_params != 3_263_254_530 or len(model.leaves()) != 50:
        raise AssertionError(f"[vision-serve] {n_params} parameters in {len(model.leaves())} "
                             "leaves, expected 3,263,254,530 in 50")
    _open_gates(model, 2)
    out = _cross_serve("vision-serve", cfg, model, g, seed=0)
    if not out["peak"] < 80e9:
        raise AssertionError(f"[vision-serve] peak {out['peak']} bytes")
    del model
    _free_card()
    return out


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
    profile = timed("breakdown", phase_breakdown, trainer)
    rows, level_times = timed("levels", phase_levels, trainer)
    tree_times = timed("tree", phase_tree, trainer, rows)
    del rows
    dryrun = timed("dryrun", phase_dryrun, trainer, profile)
    del trainer
    torch.cuda.empty_cache()
    adapt_launches = timed("adapt", phase_adapt)
    wave_launches = timed("wave", phase_wave)
    tune_launches = timed("tune", phase_tune)
    moe_train = timed("moe-train", phase_moe_train)
    deepseek = timed("deepseek-train", phase_deepseek_train)
    jamba = timed("jamba-train", phase_jamba_train)
    xlstm_sim = timed("xlstm-tp-sim", phase_xlstm_tp_sim)
    whisper_sim = timed("whisper-tp-sim", phase_whisper_tp_sim)
    vision = timed("vision-train", phase_vision_train)
    spmd_launches, spmd_times, axis_losses = timed("spmd", phase_spmd)
    tp_launches, tp_times, tp_state_ranks, tp_state_work = timed(
        "tp", phase_tp, axis_losses, moe_train["losses"],
        {"mla-tp": deepseek, "mamba-tp": jamba, "xlstm-tp": xlstm_sim,
         "cross-tp/whisper": whisper_sim, "cross-tp/vision": vision}, dryrun["tp_ref"])
    ckpt_launches, n_digits = timed("ckpt", phase_ckpt)
    tp_state_launches = timed("tp-state", phase_tp_state, tp_state_ranks, tp_state_work)
    enc_err, enc_times = timed("encode", phase_encode, n_digits)
    trip_launches, dec_err, dec_times = timed("decode", phase_decode)
    timed("serve", phase_serve)
    tp_serve = timed("tp-serve", phase_tp_serve)
    axis_serve = timed("axis-tp-serve", phase_axis_tp_serve)
    timed("reference", phase_reference)
    gemma = timed("gemma-train", phase_gemma_train)
    timed("gemma3-serve", phase_gemma3_serve)
    gemma3_tp_serve = timed("gemma3-tp-serve", phase_gemma3_tp_serve)
    timed("gemma2", phase_gemma2)
    timed("qwen-serve", phase_qwen_serve)
    timed("mixtral-serve", phase_mixtral_serve)
    timed("deepseek-serve", phase_deepseek_serve)
    timed("jamba-serve", phase_jamba_serve)
    timed("xlstm-serve", phase_xlstm_serve)
    xlstm = timed("xlstm-train", phase_xlstm_train)
    whisper = timed("whisper-train", phase_whisper_train)
    timed("whisper-serve", phase_whisper_serve)
    timed("vision-serve", phase_vision_serve)
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s; seconds by "
        f"phase {spent}")

    def row(name, tpu_kernel, n_launches, err, times, **extra):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{name}.cu",
                "replaces": tpu_kernel, "launches": n_launches, "max_abs_err": err,
                **{k: times[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms", "device_ms", "host_ms")}, **extra}

    # gc_fused's main paths: barrier training, adaptive re-planning, wave,
    # the tuned trainer, spmd (every rank's launches)
    fused_launches = {"train": launches["gc_fused"], "adapt": adapt_launches["gc_fused"],
                      "wave": wave_launches["gc_fused"], "tune": tune_launches["gc_fused"],
                      "spmd": spmd_launches, "tp": tp_launches["tp"], "gemma": gemma["launches"],
                      "moe": moe_train["launches"], "deepseek": deepseek["launches"],
                      "jamba": jamba["launches"], "xlstm": xlstm["launches"],
                      "whisper": whisper["launches"], "vision": vision["launches"],
                      "dryrun": dryrun["launches"], "tp-serve": tp_serve["launches"],
                      "moe-tp": tp_launches["moe-tp"],
                      "mla-tp": tp_launches["mla-tp"], "mamba-tp": tp_launches["mamba-tp"],
                      "xlstm-tp-sim": xlstm_sim["launches"], "xlstm-tp": tp_launches["xlstm-tp"],
                      "xlstm-wide": tp_launches["xlstm-wide"], "fsdp": tp_launches["fsdp"],
                      "whisper-tp-sim": whisper_sim["launches"],
                      "cross-tp": tp_launches["cross-tp/whisper"]
                      + tp_launches["cross-tp/vision"],
                      **{tag: v["launches"] for tag, v in axis_serve.items()},
                      "gemma3-tp-serve": gemma3_tp_serve["launches"],
                      "tp-state": tp_state_launches["gc_fused"]}
    print(json.dumps({"kernels": [
        row("gc_fused", "src/repro/kernels/gc_fused.py:57", sum(fused_launches.values()),
            max(max_err, gemma["max_abs_err"]), kernel_times, launches_by_path=fused_launches,
            per_level_device_ms=level_times["levels_device_ms"],
            grouped_device_ms=level_times["grouped_device_ms"],
            tree_combine_device_ms=tree_times["tree_device_ms"],
            spmd_device_ms=spmd_times["device_ms"], spmd_bound_ms=spmd_times["bound_ms"],
            spmd_library_ms=spmd_times["library_device_ms"],
            tp_device_ms=tp_times["device_ms"], tp_bound_ms=tp_times["bound_ms"],
            tp_library_ms=tp_times["library_device_ms"],
            gemma_device_ms=gemma["device_ms"], gemma_ms=gemma["ms"],
            gemma_plain_ms=gemma["plain_ms"], gemma_library_ms=gemma["library_ms"],
            gemma_bound_ms=gemma["bound_ms"]),
        row("gc_encode", "src/repro/kernels/gc_encode.py:56",
            ckpt_launches["gc_encode"] + tp_state_launches["gc_encode"], enc_err, enc_times,
            launches_by_path={"ckpt": ckpt_launches["gc_encode"],
                              "tp-state": tp_state_launches["gc_encode"]}),
        row("gc_decode", "src/repro/kernels/gc_decode.py:51", trip_launches["gc_decode"],
            dec_err, dec_times)]}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
