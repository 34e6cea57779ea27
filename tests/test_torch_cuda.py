"""Tests of the port that need an NVIDIA GPU (marker ``cuda``).

The CUDA kernels have no CPU mode, so these skip without CUDA.  The file
imports no JAX, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import Env, ScaledStraggler, ShiftedExponential
from repro_torch.core.plan import Plan
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.checkpoint import CodedSpec, restore_coded_train_state, save_coded_checkpoint
from repro_torch.dist.spawn import spawn
from repro_torch.kernels import _launch, _pipe, gc_decode, gc_encode, gc_fused, ops, ref
from repro_torch.launch import serve as launch_serve
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.model import decode_step, prefill
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, generate,
                               insert_request, make_slab)
from repro_torch.sim.arrivals import poisson_arrivals
from repro_torch.train.coded import (combine_grads, combine_level, combine_rows,
                                     make_coded_grad_fn, uncoded_grad_fn)
from repro_torch.train.trainer import TrainConfig, Trainer

pytestmark = pytest.mark.cuda

# the kernel-parity tolerances of tests/test_kernel_parity.py
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-5),
       torch.bfloat16: dict(rtol=2e-2, atol=1e-4)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_fused_matches_plain_version(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(0)
    for nb, k, d in [(1, 16, 768), (1, 16, 1021), (3, 4, 129), (3, 4, 4096), (8, 16, 1)]:
        a, b = torch.randn(nb, generator=gen), torch.randn(nb, k, generator=gen)
        g = torch.randn(k, d, generator=gen).to(dtype)
        a, b, g = a.to(cuda), b.to(cuda), g.to(cuda)
        before = gc_fused.launches
        got = ops.encode_decode(a, b, g)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + 1
        assert got.dtype == dtype and tuple(got.shape) == (nb, d)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.encode_decode_ref(a, b, g).float().cpu().numpy(),
                                   **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_fused_grouped_matches_plain_version_and_splits(cuda, dtype):
    """Mixed aligned and ragged leaves, two weight sets, NB 1 / 3 / 8; a
    list longer than one launch holds takes ceil(n / 32) launches."""
    gen = torch.Generator(device="cpu").manual_seed(3)
    for nb, k, n_leaves in [(1, 16, 11), (3, 4, 9), (8, 16, 7), (1, 16, 70)]:
        widths = [(1, 127, 129, 513, 1021, 1024, 768, 4100, 9216)[j % 9] + 8 * (j // 9)
                  for j in range(n_leaves)]
        a = torch.randn(nb, generator=gen).to(cuda)
        b = torch.randn(2, nb, k, generator=gen).to(cuda)
        which = [j % 2 for j in range(n_leaves)]
        gs = [torch.randn(k, d, generator=gen).to(dtype).to(cuda) for d in widths]
        before = gc_fused.launches
        got = ops.encode_decode_leaves(a, b, which, gs)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + -(-n_leaves // _pipe.MAX_LEAVES)
        for y, want in zip(got, ref.encode_decode_leaves_ref(a, b, which, gs)):
            assert y.dtype == dtype and y.shape == want.shape
            np.testing.assert_allclose(y.float().cpu().numpy(), want.float().cpu().numpy(),
                                       **TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_fused_and_gc_decode_are_bit_equal_to_the_streaming_loop(cuda, dtype):
    """The grouped kernel runs each column's fmaf chain over K in order,
    as gc_stream.cuh's loop (reached through gc_encode with the folded
    weights w = a * B) does: the outputs are equal bit for bit."""
    gen = torch.Generator(device="cpu").manual_seed(4)
    a = torch.full((1,), 0.25).to(cuda)
    b = torch.randn(3, 1, 16, generator=gen).to(cuda)
    widths = [768, 9216, 70_000, 1021, 1 << 20]
    which = [0, 0, 1, 2, 2]
    gs = [torch.randn(16, d, generator=gen).to(dtype).to(cuda) for d in widths]
    for y, g, i in zip(gc_fused.encode_decode_leaves(a, b, which, gs), gs, which):
        assert torch.equal(y, gc_encode.encode((a[:, None] * b[i]).contiguous(), g))
    for n, d in [(4, 1 << 20), (8, 1 << 22), (6, 257)]:
        w = torch.randn(n, generator=gen).to(cuda)
        c = torch.randn(n, d, generator=gen).to(dtype).to(cuda)
        assert torch.equal(gc_decode.decode(w, c), gc_encode.encode(w[None], c)[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_fused_and_gc_decode_serve_every_k(cuda, dtype):
    """K too wide for a ring of two stages (N = 20 workers: K = 100 at
    s_max = 4, K = 400 at s_max = 19) and weight tables past 4096 floats
    run without a ring, still bit-equal to the streaming loop; only a
    table past the card's shared memory is refused."""
    gen = torch.Generator(device="cpu").manual_seed(5)
    widths = [1024, 1021, 70_000, 1, 4100]
    for nb, k, n_w in [(1, 100, 5), (1, 400, 20), (8, 400, 4), (3, 96, 2)]:
        a = torch.randn(nb, generator=gen).to(cuda)
        b = torch.randn(n_w, nb, k, generator=gen).to(cuda)
        which = [j % n_w for j in range(len(widths))]
        gs = [torch.randn(k, d, generator=gen).to(dtype).to(cuda) for d in widths]
        got = gc_fused.encode_decode_leaves(a, b, which, gs)
        for y, g, i in zip(got, gs, which):
            w = (a[:, None] * b[i]).contiguous()
            # two fp32 sums of K products in different orders each lie
            # within K·2^-24·(|w| @ |G|) of the exact sum
            want = ref.encode_decode_ref(a, b[i], g).double()
            spread = 2 * k * 2.0 ** -24 * (w.to(dtype).double().abs() @ g.double().abs())
            lim = TOL[dtype]["atol"] + TOL[dtype]["rtol"] * want.abs() + spread
            assert bool(((y.double() - want).abs() <= lim).all())
            assert torch.equal(y, gc_encode.encode(w, g))
    for n, d in [(100, 4096), (400, 1021)]:
        w = torch.randn(n, generator=gen).to(cuda)
        c = torch.randn(n, d, generator=gen).to(dtype).to(cuda)
        assert torch.equal(gc_decode.decode(w, c), gc_encode.encode(w[None], c)[0])
    with pytest.raises(ValueError, match="shared memory"):
        gc_fused.encode_decode_leaves(torch.ones(1, device=cuda),
                                      torch.ones(4000, 1, 16, device=cuda), [0],
                                      [torch.ones(16, 64, device=cuda, dtype=dtype)])


def test_gc_fused_rejects_what_it_cannot_run(cuda):
    g = torch.zeros(4, 16, device=cuda)
    with pytest.raises(ValueError, match="NB"):
        gc_fused.encode_decode(torch.zeros(9, device=cuda), torch.zeros(9, 4, device=cuda), g)
    with pytest.raises(ValueError, match="contiguous"):
        gc_fused.encode_decode(torch.zeros(1, device=cuda), torch.zeros(1, 4, device=cuda),
                               torch.zeros(16, 4, device=cuda).t())
    with pytest.raises(TypeError):
        gc_fused.encode_decode(torch.zeros(1, device=cuda), torch.zeros(1, 4, device=cuda),
                               g.half())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gc_encode_and_gc_decode_match_plain_versions(cuda, dtype):
    gen = torch.Generator(device="cpu").manual_seed(1)
    for nb, k, d in [(1, 3, 4096), (3, 5, 1021), (12, 12, 129), (6, 6, 1), (1, 2, 513)]:
        b = torch.randn(nb, k, generator=gen).to(cuda)
        g = torch.randn(k, d, generator=gen).to(dtype).to(cuda)
        before = gc_encode.launches
        got = ops.encode(b, g)
        torch.cuda.synchronize()
        assert gc_encode.launches == before + -(-nb // gc_encode.MAX_NB)
        assert got.dtype == dtype and tuple(got.shape) == (nb, d)
        np.testing.assert_allclose(got.float().cpu().numpy(),
                                   ref.encode_ref(b, g).float().cpu().numpy(), **TOL[dtype])
        a = torch.randn(k, generator=gen).to(cuda)
        before = gc_decode.launches
        y = ops.decode(a, g)
        torch.cuda.synchronize()
        assert gc_decode.launches == before + 1
        assert y.dtype == dtype and tuple(y.shape) == (d,)
        np.testing.assert_allclose(y.float().cpu().numpy(),
                                   ref.decode_ref(a, g).float().cpu().numpy(), **TOL[dtype])


def test_gc_encode_is_exact_on_integer_digits(cuda):
    """Parity sums up to 2^24 - 4 (the coded checkpoint's budget) come
    out as the exact int64 product: true fp32 FMA, no TF32."""
    rng = np.random.default_rng(0)
    p = np.array([[1, 1, 1, 1], [1, 2, 3, 4]], np.float32)
    digits = rng.integers(0, 2 ** 16, (4, 100_003)).astype(np.float32)
    digits[:, 1] = [0, 0, 0, (2 ** 24 - 1) // 4]
    got = gc_encode.encode(torch.from_numpy(p).to(cuda), torch.from_numpy(digits).to(cuda))
    want = p.astype(np.int64) @ digits.astype(np.int64)
    assert np.array_equal(got.cpu().numpy().astype(np.int64), want)


def test_coded_checkpoint_of_cuda_tensors_goes_through_gc_encode(cuda, tmp_path):
    gen = torch.Generator(device="cpu").manual_seed(2)
    tree = {"w": torch.randn(1000, 37, generator=gen).to(cuda),
            "h": torch.randn(77, generator=gen).to(torch.bfloat16).to(cuda)}
    before = gc_encode.launches
    save_coded_checkpoint(str(tmp_path), 1, tree, CodedSpec(n_shards=4, parity=1))
    assert gc_encode.launches == before + 1
    template = {k: torch.zeros_like(v) for k, v in tree.items()}
    got = restore_coded_train_state(template, str(tmp_path), missing=[1])
    assert gc_encode.launches == before + 2  # the survivors' contribution
    assert got["w"].is_cuda and torch.equal(got["w"].view(torch.int32),
                                            tree["w"].view(torch.int32))
    assert torch.equal(got["h"].view(torch.int16), tree["h"].view(torch.int16))


def test_coded_step_on_cuda_matches_uncoded_and_launches_once_per_step(cuda):
    """Reduced gc-lm-110m on the card: coded == uncoded for 0 and s_max
    stragglers (fp32, TF32 off), one grouped kernel launch per step."""
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    tr = Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=4,
                 global_batch=8, device="cuda", seq_len=32)
    plan, model = tr.plan, tr.state.params
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, 4, plan.s_max)
    shards = np.stack([data.shard(0, i, 4) for i in range(4)])
    g_ref = uncoded_grad_fn(cfg, 4)(model, shards)
    coded = make_coded_grad_fn(cfg, plan)
    for u in (0, plan.s_max):
        times = np.ones(4)
        times[:u] = 1e6
        before = gc_fused.launches
        g = coded(model, wb, plan.decode_weights(times).astype(np.float32))
        assert gc_fused.launches == before + 1
        for gc, gu in zip(g, g_ref):
            assert float((gc - gu).abs().max()) <= 1e-4 * float(gu.abs().max())
    cpu = Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=4,
                  global_batch=8, device="cpu", seq_len=32,
                  params=params_to_numpy(model))
    tr.run(2, log_every=0)
    cpu.run(2, log_every=0)
    for hg, hc in zip(tr.history, cpu.history):
        np.testing.assert_allclose(hg["loss"], hc["loss"], rtol=1e-4)


def _level_setup(cuda, seed):
    """Reduced gc-lm-110m's plan and random per-shard rows on the card."""
    model = GCLM(get_config("gc-lm-110m").reduced(n_layers=2, d_model=128), device="meta")
    plan = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), 4)
    layout = plan.flat_layout
    gen = torch.Generator(device="cpu").manual_seed(seed)
    rows = [torch.randn(4 * plan.k_shards, layout.leaf_size(j), generator=gen).to(cuda)
            for j in range(layout.n_leaves)]
    return model, plan, rows


def test_per_level_launches_are_bit_equal_to_one_grouped_launch(cuda):
    """The wave loop's per-level combines: one launch per level, their
    union bit-equal to the step's one grouped launch."""
    _, plan, rows = _level_setup(cuda, 5)
    dec_w = plan.decode_weights(np.asarray([3.0, 1.0, 4.0, 2.0]))
    before = gc_fused.launches
    full = combine_rows(plan, rows, dec_w.astype(np.float32))
    torch.cuda.synchronize()
    assert gc_fused.launches == before + 1
    got = {}
    for li in range(plan.flat_layout.n_levels):
        got.update(combine_level(plan, rows, li, dec_w[li]))
    torch.cuda.synchronize()
    assert gc_fused.launches == before + 1 + plan.flat_layout.n_levels
    for j, y in enumerate(full):
        assert torch.equal(got[j], y), j


def test_replanned_leaf_levels_launch_correctly_through_the_cached_planner(cuda):
    """A swap gives the same leaves (same pointers, same widths) new
    levels: the cached launch plan is keyed by the leaf-to-level map, so
    the new map is planned anew, and every plan, and a swap back,
    combines with its own weights."""
    model, plan_a, rows = _level_setup(cuda, 6)
    se = ShiftedExponential(mu=1e-3, t0=50.0)
    plan_b = Plan.build(model, Env.heterogeneous(
        [se, se, ScaledStraggler(base=se, factor=6.0), ScaledStraggler(base=se, factor=6.0)]), 4)
    assert plan_b.leaf_levels.tolist() != plan_a.leaf_levels.tolist()
    assert plan_b.k_shards == plan_a.k_shards
    times = np.asarray([3.0, 1.0, 4.0, 2.0])
    for i, plan in enumerate((plan_a, plan_b, plan_a)):
        dec_w = plan.decode_weights(times).astype(np.float32)
        misses = _launch.pipe_launches.cache_info().misses
        got = combine_rows(plan, rows, dec_w)
        if i == 1:
            assert _launch.pipe_launches.cache_info().misses > misses
        want = combine_rows(plan, [r.cpu() for r in rows], dec_w)
        for y, w in zip(got, want, strict=True):
            np.testing.assert_allclose(y.cpu().numpy(), w.numpy(), **TOL[torch.float32])
        assert all(torch.equal(a, b) for a, b in zip(combine_rows(plan, rows, dec_w), got))


def test_tree_pipeline_matches_flat_on_cuda(cuda):
    _, plan, rows = _level_setup(cuda, 7)
    for u in (0, plan.s_max):
        times = np.ones(4)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times)
        tree = combine_grads(plan, rows, dec_w, pipeline="tree")
        flat = combine_grads(plan, rows, dec_w, pipeline="flat")
        for t, f in zip(tree, flat, strict=True):
            assert t.is_cuda and t.shape == f.shape
            assert float((t - f).abs().max()) <= 1e-5 * float(f.abs().max())


def _spmd_rank(rank, world):
    """A rank on card 0 over gloo: ``out=`` views of level buffers take
    the grouped launch bit-equal to the allocating call, on the TMA ring;
    the spmd flat gradient equals sim mode's.  Returns the gradients'
    bytes digest."""
    import hashlib

    mesh = make_local_mesh(world, device="cuda:0", backend="gloo")
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    model = GCLM(cfg, device="cuda", seed=0)  # the same weights on every rank
    plan = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), world)
    layout, k = plan.flat_layout, plan.k_shards
    gen = torch.Generator(device="cpu").manual_seed(rank)
    rows = [torch.randn(k, layout.leaf_size(j), generator=gen).cuda()
            for j in range(layout.n_leaves)]
    table = torch.randn(layout.n_levels, 1, k, generator=gen).cuda()
    one = torch.ones(1, device="cuda")
    bufs = [torch.zeros(n, device="cuda") for n in layout.level_sizes]
    views = [None] * layout.n_leaves
    for j, li, off, size in layout.leaf_slices():
        views[j] = bufs[li][off:off + size].view(1, size)
    before = gc_fused.launches
    got = gc_fused.encode_decode_leaves(one, table, layout.leaf_level, rows, out=views)
    want = gc_fused.encode_decode_leaves(one, table, layout.leaf_level, rows)
    torch.cuda.synchronize()
    assert gc_fused.launches == before + 2
    stages = _pipe.tile_shape(k, 4, layout.n_levels * k, _launch.smem_per_block("gc_fused", 0))[1]
    for v, g, w, r in zip(views, got, want, rows, strict=True):
        assert g is v and torch.equal(v, w)
        assert _pipe.leaf_mode(v.shape[1], 4, r.data_ptr(), v.data_ptr(), stages) == _pipe.RING
    for li, b in enumerate(bufs):  # the padding past the leaves stays zero
        assert not bool(b[layout.level_used[li]:].any())
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, world, plan.s_max)
    spmd = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
    sim = make_coded_grad_fn(cfg, plan)
    h = hashlib.sha256()
    for u in (0, plan.s_max):
        times = np.ones(world)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times).astype(np.float32)
        g_spmd, g_sim = spmd(model, wb, dec_w), sim(model, wb, dec_w)
        for a, b in zip(g_spmd, g_sim, strict=True):
            assert a.is_cuda and float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
            h.update(a.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
    return h.hexdigest()


def test_spmd_ranks_share_one_card_over_gloo(cuda, tmp_path):
    """Two spmd ranks on card 0 over gloo (NCCL takes one card per rank):
    the grouped launch writes into level-buffer views bit-equal to the
    allocating call, and the spmd flat gradient equals the sim-mode one
    with the same bytes on both ranks."""
    digests = spawn(_spmd_rank, 2, store_dir=str(tmp_path), backend="gloo", timeout=600.0)
    assert len(set(digests)) == 1


def _serve_run(cfg, model, device, dtype=torch.float32):
    """Six greedy requests over three slots, Poisson arrivals, the coded
    tier of an 8-worker env; returns (engine, requests)."""
    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 8)
    eng = ServeEngine(cfg, model, ServeConfig(n_slots=3, max_len=32, dtype=dtype),
                      coded=CodedDecode.solve(env, seed=0), device=device)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab, size=(6, 12))
    times = poisson_arrivals(6, 2e-3, seed=0)
    reqs = [eng.submit(p, max_new=n, arrival=float(t))
            for p, n, t in zip(prompts, (8, 12, 5, 20, 9, 14), times)]
    eng.run()
    return eng, reqs


def test_serve_engine_on_cuda_matches_cpu(cuda):
    """The same weights, prompts, arrivals and coded tier through the
    engine on the card and on the CPU (plain PyTorch), fp32 slab, greedy:
    the same tokens, timestamps and step latencies; the coded tier
    launches no kernel."""
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    cpu_model = GCLM(cfg, device="cpu", seed=0)
    gpu_model = params_from_numpy(GCLM(cfg, device="cuda"), params_to_numpy(cpu_model))
    before = (gc_fused.launches, gc_encode.launches, gc_decode.launches)
    eng_g, reqs_g = _serve_run(cfg, gpu_model, "cuda")
    assert (gc_fused.launches, gc_encode.launches, gc_decode.launches) == before
    eng_c, reqs_c = _serve_run(cfg, cpu_model, "cpu")
    assert eng_g.step_latencies == eng_c.step_latencies
    for rg, rc in zip(reqs_g, reqs_c, strict=True):
        assert rg.tokens == rc.tokens
        assert (rg.t_admit, rg.t_done, rg.n_steps) == (rc.t_admit, rc.t_done, rc.n_steps)
    prompt = torch.from_numpy(reqs_c[3].output[None].astype(np.int64))
    got = prefill(cfg, gpu_model, prompt.cuda())[0].cpu()
    want = prefill(cfg, cpu_model, prompt)[0]
    assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max())


def test_serve_slab_is_written_in_place_on_cuda(cuda):
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    model = GCLM(cfg, device="cuda", seed=0)
    slab = make_slab(cfg, 4, 32)
    ptrs = [(t["k"].data_ptr(), t["v"].data_ptr(), t["pos"].data_ptr()) for t in slab]
    _, pref = prefill(cfg, model, torch.arange(1, 9, device="cuda")[None], target_len=32)
    insert_request(cfg, slab, pref, 2)
    before = slab[0]["k"][:, 2, :8].clone()
    logits, out = decode_step(cfg, model, slab, torch.full((4, 1), 7, device="cuda"))
    torch.cuda.synchronize()
    assert out is slab and logits.is_cuda
    assert ptrs == [(t["k"].data_ptr(), t["v"].data_ptr(), t["pos"].data_ptr()) for t in slab]
    assert torch.equal(slab[0]["k"][:, 2, :8], before)  # the prompt's rows stay
    assert slab[0]["pos"][:, 2].tolist() == [9] * cfg.n_layers
    assert bool(slab[0]["k"][:, 2, 8].any())            # this step's K at pos 8
    eng, _ = _serve_run(cfg, model, "cuda", dtype=torch.bfloat16)
    slab = eng.slab
    assert all(t["k"].dtype == torch.bfloat16 for t in slab)


def test_serve_entry_points_default_to_cuda(cuda, capsys):
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    model = GCLM(cfg, seed=0)
    eng = ServeEngine(cfg, model)
    assert eng.device.type == "cuda" and eng.slab[0]["k"].is_cuda
    req = eng.submit(np.arange(1, 9), max_new=3)
    eng.run()
    assert req.done and len(req.tokens) == 3
    assert generate(cfg, model, np.arange(1, 9)[None], 2).shape == (1, 10)
    launch_serve.main(["--reduced", "--stream", "3", "--prompt-len", "8", "--new", "3"])
    assert "served 3 requests / 9 tokens" in capsys.readouterr().out
