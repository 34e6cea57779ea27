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
from repro_torch.models.model import decode_step, forward, prefill
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, generate,
                               insert_request, make_slab)
from repro_torch.sim.arrivals import poisson_arrivals
from repro_torch.train.coded import (combine_grads, combine_level, combine_rows,
                                     make_coded_grad_fn, uncoded_grad_fn)
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_coded_train_step

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


def _tp_rank(rank, world):
    """A rank of a (data 2, model 2) mesh on card 0 over gloo: this rank's
    shards (``init_shards`` draws them byte-equal to ``shard_model``'s
    cut) take one grouped launch per coded gradient, and the model
    group's gathered gradient equals sim mode's on the full model.
    Returns (this rank's digest, its replicated leaves' digest)."""
    import hashlib

    from repro_torch.dist import collectives
    from repro_torch.models.params import gather_model, init_shards, shard_model

    mesh = make_local_mesh(2, model=2, device="cuda:0", backend="gloo")
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    full = GCLM(cfg, device="cuda", seed=0)
    plan = Plan.build(full, ShiftedExponential(mu=1e-3, t0=50.0), 2)
    local = shard_model(full, mesh)
    drawn = init_shards(cfg, mesh, device="cuda", seed=0)  # never the full tree
    assert all(torch.equal(a, b) for a, b in zip(drawn.leaves(), local.leaves(), strict=True))
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, 2, plan.s_max)
    spmd = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
    sim = make_coded_grad_fn(cfg, plan)
    h, rep = hashlib.sha256(), hashlib.sha256()
    for u in (0, plan.s_max):
        times = np.ones(2)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times).astype(np.float32)
        before = gc_fused.launches
        collectives.reset_counts()
        g = spmd(local, wb, dec_w)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + 1
        assert collectives.counts["psum"] == plan.flat_layout.n_levels
        assert collectives.model_counts["reduce"] > 0 and collectives.model_counts["copy"] > 0
        for t, d in zip(g, local.shard_dims):
            (h if d is not None else rep).update(t.reshape(-1).view(torch.uint8).cpu().numpy()
                                                 .tobytes())
        for a, b in zip(gather_model(local, g).leaves(), sim(full, wb, dec_w), strict=True):
            assert a.is_cuda and float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    return mesh.model_index, h.hexdigest(), rep.hexdigest()


def test_model_mesh_ranks_share_one_card_over_gloo(cuda, tmp_path):
    """Four ranks of a (data 2, model 2) mesh on card 0 over gloo: one
    grouped launch per rank and coded gradient over its shards, the
    gathered gradient equal to sim mode's, the same bytes on the data
    ranks of a model index and replicated leaves equal on all four."""
    out = spawn(_tp_rank, 4, store_dir=str(tmp_path), backend="gloo", timeout=600.0)
    assert [o[0] for o in out] == [0, 1, 0, 1]
    assert out[0][1] == out[2][1] and out[1][1] == out[3][1] and out[0][1] != out[1][1]
    assert len({o[2] for o in out}) == 1


def _tp_jamba_rank(rank, world):
    """A rank of a (data 2, model 2) mesh on card 0 over gloo with reduced
    Jamba at three layers (Mamba, Mamba with the MoE FFN, attention): its
    shards, Mamba's ``in_proj`` cut in 2 blocks, gathered back byte-equal
    to the full model; one grouped combine per coded gradient (its
    launches of at most ``_pipe.MAX_LEAVES`` leaves), the gathered
    gradient equal to sim mode's on the full model.  Returns the rank's
    model index and its digest."""
    import hashlib

    from repro_torch.models.params import gather_model, init_shards

    mesh = make_local_mesh(2, model=2, device="cuda:0", backend="gloo")
    base = get_config("jamba-v0.1-52b").reduced(n_layers=8, d_model=128)
    cfg = base.replace(n_layers=3, layers=(base.layers[0], base.layers[1], base.layers[4]))
    full = GCLM(cfg, device="cuda", seed=0)
    local = init_shards(cfg, mesh, device="cuda", seed=0)
    assert sorted(b for b in local.shard_blocks if b > 1) == [2, 2]  # the two in_proj leaves
    assert all(torch.equal(a, b) for a, b in zip(gather_model(local).leaves(), full.leaves(),
                                                 strict=True))
    plan = Plan.build(full, ShiftedExponential(mu=1e-3, t0=50.0), 2)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, 2, plan.s_max)
    spmd = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
    sim = make_coded_grad_fn(cfg, plan)
    per_call = -(-len(full.leaves()) // _pipe.MAX_LEAVES)
    h = hashlib.sha256()
    for u in (0, plan.s_max):
        times = np.ones(2)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times).astype(np.float32)
        before = gc_fused.launches
        g = spmd(local, wb, dec_w)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + per_call
        for t in g:
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        for a, b in zip(gather_model(local, g).leaves(), sim(full, wb, dec_w), strict=True):
            assert a.is_cuda and float((a - b).abs().max()) <= 1e-5 * float(b.abs().max())
    return mesh.model_index, h.hexdigest()


def test_jamba_on_a_model_mesh_shares_one_card_over_gloo(cuda, tmp_path):
    """Four ranks of a (data 2, model 2) mesh on card 0 over gloo, reduced
    Jamba: the blocked cut round-trips, the gathered coded gradient equals
    sim mode's, the data ranks of a model index hold the same bytes."""
    out = spawn(_tp_jamba_rank, 4, store_dir=str(tmp_path), backend="gloo", timeout=600.0)
    assert [o[0] for o in out] == [0, 1, 0, 1]
    assert out[0][1] == out[2][1] and out[1][1] == out[3][1] and out[0][1] != out[1][1]


def _tp_family_rank(rank, world, arch, n_layers, d_model):
    """A rank of a (data 2, model 2) mesh on card 0 over gloo with ``arch``
    reduced to ``n_layers`` layers at ``d_model``, every cross gate opened
    to 0.5: its shards gathered back byte-equal to the full model; one
    grouped combine per coded gradient (with ``worker_aux`` for a model
    with a source), the gathered gradient equal to sim mode's on the full
    model; one greedy token per row from ``prefill`` equal to the full
    model's.  Returns the rank's model index, its digest and the worst
    leaf's distance of the gathered gradient from sim mode's (relative to
    the leaf's largest entry)."""
    import hashlib

    from repro_torch.models.params import gather_model, init_shards

    mesh = make_local_mesh(2, model=2, device="cuda:0", backend="gloo")
    cfg = get_config(arch).reduced(n_layers=n_layers, d_model=d_model)
    full = GCLM(cfg, device="cuda", seed=0)
    local = init_shards(cfg, mesh, device="cuda", seed=0)
    with torch.no_grad():
        for model in (full, local):
            for path, t in model.leaf_items():
                if path[-1] == "gate":
                    t.fill_(0.5)
    assert all(torch.equal(a, b) for a, b in zip(gather_model(local).leaves(), full.leaves(),
                                                 strict=True))
    plan = Plan.build(full, ShiftedExponential(mu=1e-3, t0=50.0), 2)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, 2, plan.s_max)
    wa = None
    if cfg.encoder is not None or cfg.vision is not None:
        shape = ((cfg.encoder.n_frames, cfg.d_model) if cfg.encoder is not None
                 else (cfg.vision.n_patches, cfg.vision.d_vision))
        wa = torch.from_numpy(np.random.default_rng(1).standard_normal(
            (*wb.shape[:3], *shape), dtype=np.float32)).cuda()
    spmd = make_coded_grad_fn(cfg, plan, mode="spmd", mesh=mesh)
    sim = make_coded_grad_fn(cfg, plan)
    per_call = -(-len(full.leaves()) // _pipe.MAX_LEAVES)
    worst = 0.0
    h = hashlib.sha256()
    for u in (0, plan.s_max):
        times = np.ones(2)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times).astype(np.float32)
        before = gc_fused.launches
        g = spmd(local, wb, dec_w, wa)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + per_call
        for t in g:
            h.update(t.reshape(-1).view(torch.uint8).cpu().numpy().tobytes())
        for path, a, b in zip(full.leaf_paths(), gather_model(local, g).leaves(),
                              sim(full, wb, dec_w, wa), strict=True):
            if path.endswith(("b_i", ".bk")):  # zero in exact arithmetic: rounding noise
                continue
            assert a.is_cuda
            worst = max(worst, float((a - b).abs().max()) / float(b.abs().max()))
    aux = None if wa is None else wa[0, 0, :2]
    tokens = torch.as_tensor(wb[0, 0, :2, :8], device="cuda")
    got, _ = prefill(cfg, local, tokens, aux_inputs=aux, last_only=True)
    want, _ = prefill(cfg, full, tokens, aux_inputs=aux, last_only=True)
    assert torch.equal(got.argmax(-1), want.argmax(-1))
    return mesh.model_index, h.hexdigest(), worst


@pytest.mark.parametrize("arch,n_layers,d_model,rel", [("xlstm-1.3b", 8, 256, 8e-5),
                                                      ("whisper-base", 2, 128, 1e-5)])
def test_xlstm_and_whisper_on_a_model_mesh_share_one_card_over_gloo(cuda, tmp_path, arch,
                                                                    n_layers, d_model, rel):
    """Four ranks of a (data 2, model 2) mesh on card 0 over gloo: reduced
    xLSTM (7 mLSTM layers and the sLSTM at d_model 256; ``up``, ``w_gates``
    and ``b_gates`` cut block by block) and reduced Whisper (its encoder
    and the cross-attention with ``worker_aux``): the cut round-trips, the
    gathered coded gradient equals sim mode's within ``rel`` of each
    leaf's scale (printed), greedy tokens equal the full model's, the data
    ranks of a model index hold the same bytes.  ``rel`` is 1e-5, and
    xLSTM's about twice its reading on an H100 80GB HBM3 at 700.00 W
    (3.740e-5): the axis sums every row-parallel product in another
    order, and at a random init the xLSTM stack amplifies that rounding
    (ROADMAP 3.20; tests/test_torch_tp_xlstm.py shows the gap fall below
    2e-6 with float64 activations)."""
    out = spawn(_tp_family_rank, 4, arch, n_layers, d_model, store_dir=str(tmp_path),
                backend="gloo", timeout=600.0)
    worst = max(o[2] for o in out)
    print(f"{arch}: the gathered gradient's worst leaf lies {worst:.3e} of its scale from sim "
          f"mode's (bound {rel})")
    assert worst <= rel, worst
    assert [o[0] for o in out] == [0, 1, 0, 1]
    assert out[0][1] == out[2][1] and out[1][1] == out[3][1] and out[0][1] != out[1][1]


def _tp_ckpt_rank(rank, world, ckpt_dir, device="cuda:0"):
    """One rank of a (data 1, model 2) mesh on card 0: reduced
    gc-lm-110m's shards through 2 steps, a coded save, a step on, and a
    restore with the data stripe lost; returns the rank's model index,
    its state's digest at the save and after the restore, and its
    gc_encode launches."""
    from repro_torch.checkpoint import CkptConfig

    mesh = make_local_mesh(1, model=2, device=device, backend="gloo")
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    tr = Trainer(cfg, TrainConfig(warmup=1, total_steps=10),
                 Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 1), global_batch=8, seed=0,
                 seq_len=32, mesh=mesh, mode="spmd", device=device,
                 ckpt=CkptConfig(dir=ckpt_dir, coded=CodedSpec(n_shards=2, parity=1)))
    before = gc_encode.launches
    tr.run(2, log_every=0)
    tr.save_checkpoint()
    saved = tr.state.digest()
    tr.run(1, log_every=0)
    step = tr.restore_checkpoint(missing=(0,))
    return mesh.model_index, step, saved, tr.state.digest(), gc_encode.launches - before


def test_model_mesh_coded_checkpoint_round_trip_over_gloo(cuda, tmp_path):
    """Two ranks of a (data 1, model 2) mesh on card 0: rank 0's model
    group gathers the full tree to it, its card encodes the parity
    (gc_encode), and a restore with the data stripe lost gives every
    rank's shards back byte-equal."""
    out = spawn(_tp_ckpt_rank, 2, str(tmp_path / "ck"), store_dir=str(tmp_path / "st"),
                backend="gloo", timeout=600.0)
    assert [o[:2] for o in out] == [(0, 2), (1, 2)]
    assert all(o[2] == o[3] for o in out) and out[0][2] != out[1][2]
    assert [o[4] for o in out] == [1, 0]   # the save's parity, on rank 0 alone


def _fsdp_rank(rank, world, device="cuda:0"):
    """One rank of a (data 2, model 2) mesh on card 0: reduced gemma2-27b
    (``fsdp`` set: every leaf cut by ``data`` too) and its fsdp-off twin,
    2 coded steps each from seed 0; returns each run's gathered
    parameters and moments (rank 0), the fsdp run's gc_fused launches and
    state shapes."""
    import dataclasses

    from repro_torch.models.params import gather_model

    mesh = make_local_mesh(2, model=2, device=device, backend="gloo")
    out = {}
    for fsdp in (True, False):
        cfg = dataclasses.replace(get_config("gemma2-27b").reduced(d_model=128), fsdp=fsdp)
        tr = Trainer(cfg, TrainConfig(warmup=1, total_steps=10),
                     Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 2), global_batch=8, seed=0,
                     seq_len=32, mesh=mesh, mode="spmd", device=device)
        before = gc_fused.launches
        tr.run(2, log_every=0)
        full = [[t.detach().cpu() for t in gather_model(tr.state.params, tensors).leaves()]
                for tensors in (None, tr.state.opt["m"], tr.state.opt["v"])]
        out[fsdp] = dict(full=full if rank == 0 else None, launches=gc_fused.launches - before,
                         cut=tr.state.params.fsdp is not None,
                         shapes=[tuple(t.shape) for t in tr.state.opt["m"]])
    return out


def test_fsdp_state_trains_as_fsdp_off_on_the_card(cuda, tmp_path):
    """Four ranks of a (data 2, model 2) mesh on card 0 over gloo: with
    ``fsdp`` each rank holds its data slice of every leaf and both
    moments (a quarter of the working shard's rows or columns, on
    ``embed``), launches gc_fused once a step, and after 2 steps the
    gathered parameters and moments are within 1e-6 of each leaf's scale
    of the fsdp-off run's (only the clip norm's summation order
    differs)."""
    out = spawn(_fsdp_rank, 4, store_dir=str(tmp_path), backend="gloo", timeout=600.0)
    for o in out:
        assert o[True]["cut"] and not o[False]["cut"]
        assert o[True]["launches"] == o[False]["launches"] == 2
        on, off = o[True]["shapes"], o[False]["shapes"]
        assert [np.prod(a) * 2 for a in on] == [np.prod(b) for b in off]
    for a_tree, b_tree in zip(out[0][True]["full"], out[0][False]["full"], strict=True):
        for a, b in zip(a_tree, b_tree, strict=True):
            scale = float(b.abs().max())
            assert float((a - b).abs().max()) <= 1e-6 * scale


def _tp_serve_rank(rank, world):
    """One rank of a (data 2, model 2) serving mesh on card 0: reduced
    gc-lm-110m's shards (seed 0) through ``_serve_run``'s requests."""
    from repro_torch.models.params import init_shards

    mesh = make_local_mesh(2, model=2, device="cuda:0", backend="gloo")
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    local = init_shards(cfg, mesh, device=mesh.device, seed=0)
    eng, reqs = _serve_run(cfg, local, "cuda", mesh=mesh, n_slots=4)
    return ([(r.tokens, r.t_admit, r.t_done, r.n_steps) for r in reqs], eng.step_latencies,
            [tuple(t["k"].shape) for t in eng.slab])


def test_serving_mesh_ranks_share_one_card_over_gloo(cuda, tmp_path):
    """Four ranks of a (data 2, model 2) serving mesh on card 0 over gloo,
    fp32 slab, greedy: every rank's tokens, timestamps and step latencies
    equal the one-rank engine's on the same weights; a rank's slab holds 2
    of the 4 slots and 1 of the 2 KV heads."""
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    eng, reqs = _serve_run(cfg, GCLM(cfg, device="cuda", seed=0), "cuda", n_slots=4)
    want = [(r.tokens, r.t_admit, r.t_done, r.n_steps) for r in reqs]
    out = spawn(_tp_serve_rank, 4, store_dir=str(tmp_path), backend="gloo", timeout=600.0)
    for got, latencies, shapes in out:
        assert got == want and latencies == eng.step_latencies
        assert shapes == [(cfg.n_layers, 2, 32, cfg.n_kv_heads // 2, cfg.head_dim)]


def _serve_run(cfg, model, device, dtype=torch.float32, mesh=None, n_slots=3):
    """Six greedy requests over ``n_slots`` slots, Poisson arrivals, the
    coded tier of an 8-worker env, on ``mesh`` when given; returns
    (engine, requests)."""
    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 8)
    eng = ServeEngine(cfg, model, ServeConfig(n_slots=n_slots, max_len=32, dtype=dtype),
                      coded=CodedDecode.solve(env, seed=0), device=device, mesh=mesh)
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


def _slow_pair_env(n=4):
    fast = ShiftedExponential(mu=1e-3, t0=50.0)
    return Env.heterogeneous([fast] * (n - 2) + [ScaledStraggler(base=fast, factor=5.0)] * 2)


def test_mc_backend_on_cuda_matches_cpu(cuda):
    """The batched Monte-Carlo backend on the card against itself on the
    CPU (the same fp32 sort, gather, products and max): within 1e-6, and
    ``Plan.simulate(backend="mc")`` defaults to the card."""
    from repro_torch.sim import mc, schedule_from_plan

    env = _slow_pair_env()
    plan = Plan.build(np.asarray([3.0, 1.0, 4.0, 1.0, 5.0]), env, scheme="xf")
    times = env.sample(np.random.default_rng(0), (2000, 4))
    for t in (times, times.reshape(400, 5, 4)):
        np.testing.assert_allclose(mc.runtime_batch(schedule_from_plan(plan), t),
                                   mc.runtime_batch(schedule_from_plan(plan), t, device="cpu"),
                                   rtol=1e-6)
    got = plan.simulate(env, 300, seed=2, backend="mc").ledger
    want = plan.simulate(env, 300, seed=2, backend="mc", device="cpu").ledger
    for a, b in zip(got, want, strict=True):
        np.testing.assert_array_equal(a["times"], b["times"])
        np.testing.assert_allclose(a["tau_coded"], b["tau_coded"], rtol=1e-6)


def test_autotune_report_on_cuda_matches_cpu(cuda):
    """The tuner on a heterogeneous env prices with mc on the card (its
    default device): the same candidates, order, memory, prunes and best
    as the same search on the CPU, times within 1e-6."""
    from repro_torch.tune import MemBudget, autotune

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    kw = dict(global_batch=8, seq_len=32, steps=60)
    mems = sorted(c.mem.total for c in autotune(cfg, _slow_pair_env(), device="cpu",
                                                **kw).report.candidates)
    cap = MemBudget(0.5 * (mems[0] + mems[-1]))  # prunes some, admits some
    got = autotune(cfg, _slow_pair_env(), cap, **kw).report
    want = autotune(cfg, _slow_pair_env(), cap, device="cpu", **kw).report
    assert got.backend == "mc" and got.pruned and got.best.key() == want.best.key()
    for part in ("candidates", "pruned"):
        a, b = getattr(got, part), getattr(want, part)
        assert [c.key() for c in a] == [c.key() for c in b]
        assert [c.prune_reason for c in a] == [c.prune_reason for c in b]
        for ca, cb in zip(a, b):
            assert ca.mem.to_dict() == cb.mem.to_dict()
            np.testing.assert_allclose(ca.time, cb.time, rtol=1e-6)


def _gemma3_reduced():
    """gemma3-27b at 14 layers (a Pattern of 6 over 2 repeats and a tail
    run of 2), d_model 128, windows of 32."""
    return get_config("gemma3-27b").reduced(n_layers=14, d_model=128, seq_cap=64)


def test_gemma3_forward_prefill_and_ring_decode_on_cuda_match_cpu(cuda):
    """Reduced gemma3 (QK-norm, sandwich norms, local RoPE base, windows
    of 32) on the card against the CPU's plain path from the same
    weights, fp32: training logits, a 48-token prefill (past the window:
    ``local_attention`` and rolled rings) and 8 decode steps (the rings
    wrap), within 1e-4 of the largest logit — fp32 sums in another order
    on each device, as ``test_serve_engine_on_cuda_matches_cpu`` bounds
    them."""
    from repro_torch.models.model import forward

    cfg = _gemma3_reduced()
    cpu_model = GCLM(cfg, device="cpu", seed=0)
    gpu_model = params_from_numpy(GCLM(cfg, device="cuda"), params_to_numpy(cpu_model))
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(2, 56)))

    def close(got, want, what):
        got, want = got.float().cpu(), want.float()
        assert float((got - want).abs().max()) <= 1e-4 * float(want.abs().max()), what

    with torch.no_grad():
        close(forward(cfg, gpu_model, toks[:, :48].cuda())[0],
              forward(cfg, cpu_model, toks[:, :48])[0], "forward")
    got, c_gpu = prefill(cfg, gpu_model, toks[:, :48].cuda(), target_len=56)
    want, c_cpu = prefill(cfg, cpu_model, toks[:, :48], target_len=56)
    close(got, want, "prefill")
    assert c_gpu[0][0]["k"].shape[2] == 32  # a ring of the window
    for t in range(48, 56):
        got, _ = decode_step(cfg, gpu_model, c_gpu, toks[:, t:t + 1].cuda())
        want, _ = decode_step(cfg, cpu_model, c_cpu, toks[:, t:t + 1])
        close(got, want, f"decode at {t}")
    assert c_gpu[0][0]["pos"].tolist() == [56, 56]


def test_gc_fused_groups_gemma3_leaves_into_three_launches(cuda):
    """One grouped ``ops.encode_decode_leaves`` over reduced gemma3's 93
    leaves (more than one launch holds) makes ceil(93 / 32) = 3 launches
    and equals the plain version."""
    cfg = _gemma3_reduced()
    model = GCLM(cfg, device="meta")
    widths = [t.numel() for t in model.leaves()]
    assert len(widths) == 93
    gen = torch.Generator(device="cpu").manual_seed(5)
    k, n_w = 16, 3
    a = torch.full((1,), 0.25, device=cuda)
    tab = torch.randn(n_w, 1, k, generator=gen).to(cuda)
    which = [j % n_w for j in range(len(widths))]
    gs = [torch.randn(k, d, generator=gen).to(cuda) for d in widths]
    before = gc_fused.launches
    ys = ops.encode_decode_leaves(a, tab, which, gs)
    torch.cuda.synchronize()
    assert gc_fused.launches - before == 3
    for y, want in zip(ys, ref.encode_decode_leaves_ref(a, tab, which, gs), strict=True):
        np.testing.assert_allclose(y.cpu().numpy(), want.cpu().numpy(),
                                   **TOL[torch.float32])


def _close_to_cpu(got, want, what, rel=1e-4):
    got, want = got.detach().float().cpu(), want.detach().float()
    assert float((got - want).abs().max()) <= rel * float(want.abs().max()), what


def _moe_layer_inputs(device, capacity_factor=1.25, t=96, d=64, seed=0):
    """A Mixtral-style layer (8 experts, top-2) and tokens with a positive
    mean against a router biased toward expert 0: capacity 1.25 drops."""
    import dataclasses

    from repro_torch.configs import MoESpec

    spec = dataclasses.replace(get_config("mixtral-8x22b").layers[0],
                               moe=MoESpec(8, 2, 48, capacity_factor=capacity_factor))
    gen = torch.Generator(device="cpu").manual_seed(seed)
    p = {"router": torch.randn(d, 8, generator=gen) / d ** 0.5,
         "wi": torch.randn(8, d, 48, generator=gen) / d ** 0.5,
         "wg": torch.randn(8, d, 48, generator=gen) / d ** 0.5,
         "wo": torch.randn(8, 48, d, generator=gen) / 48 ** 0.5}
    p["router"][:, 0] += 0.5
    x = torch.randn(2, t // 2, d, generator=gen) + 0.3
    return spec, {k: v.to(device).requires_grad_() for k, v in p.items()}, \
        x.to(device).requires_grad_()


def test_moe_layer_on_cuda_matches_cpu(cuda):
    """The MoE layer with drops (capacity 1.25) in fp32: the same expert
    indices and keep mask on the card as on the CPU, output, aux and
    every gradient within 1e-4 of the largest entry."""
    from repro_torch.models import moe

    cfg = get_config("mixtral-8x22b")
    out = {}
    for dev in ("cpu", cuda):
        spec, p, x = _moe_layer_inputs(dev)
        r = moe.route(p, x.detach().reshape(-1, x.shape[-1]), spec.moe)
        y, aux = moe.apply_moe(cfg, p, x, spec)
        grads = torch.autograd.grad(y.square().sum() + aux, [x, *p.values()])
        out[str(dev)] = (r, y, aux, grads)
    (r_c, y_c, a_c, g_c), (r_g, y_g, a_g, g_g) = out["cpu"], out[str(cuda)]
    assert torch.equal(r_g.idx.cpu(), r_c.idx) and torch.equal(r_g.keep.cpu(), r_c.keep)
    assert not bool(r_c.keep.all())  # assignments were dropped
    _close_to_cpu(y_g, y_c, "out")
    _close_to_cpu(a_g, a_c, "aux")
    for i, (a, b) in enumerate(zip(g_g, g_c)):
        _close_to_cpu(a, b, f"grad {i}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_forward_backward_on_cuda_is_byte_equal(cuda, dtype):
    """Two runs of reduced Mixtral's loss and gradients on the card, at
    capacity 1.25 (drops), give the same bytes: the dispatch's
    ``index_add_`` only adds zeros onto an occupied slot, and the combine
    sums each token's k rows in order."""
    import dataclasses

    from repro_torch.models.model import train_loss

    cfg = get_config("mixtral-8x22b").reduced(n_layers=2, d_model=128)
    cfg = cfg.replace(dtype=dtype, layers=tuple(dataclasses.replace(
        l, moe=dataclasses.replace(l.moe, capacity_factor=1.25)) for l in cfg.layers))
    model = GCLM(cfg, device="cuda", seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 129)))

    def run():
        loss, metrics = train_loss(cfg, model, {"tokens": toks.cuda()})
        return [loss, metrics["aux"], *torch.autograd.grad(loss, model.leaves())]

    first, second = run(), run()
    assert first[1].item() > 0
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


def test_qwen_bias_path_on_cuda_matches_cpu(cuda):
    """Reduced Qwen with nonzero QKV biases and its untied head on the card
    against the CPU from the same weights, fp32: training logits, a
    48-token prefill and 8 decode steps within 1e-4 of the largest logit."""
    from repro_torch.models.model import forward

    cfg = get_config("qwen1.5-32b").reduced(n_layers=2, d_model=128, seq_cap=64)
    cpu_model = GCLM(cfg, device="cpu", seed=0)
    tree = params_to_numpy(cpu_model)
    rng = np.random.default_rng(3)
    for name in ("bq", "bk", "bv"):
        leaf = tree["stack"][0]["mixer"][name]
        tree["stack"][0]["mixer"][name] = (0.02 * rng.standard_normal(leaf.shape)).astype(
            np.float32)
    params_from_numpy(cpu_model, tree)
    gpu_model = params_from_numpy(GCLM(cfg, device="cuda"), tree)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, size=(2, 56)))
    with torch.no_grad():
        _close_to_cpu(forward(cfg, gpu_model, toks[:, :48].cuda())[0],
                      forward(cfg, cpu_model, toks[:, :48])[0], "forward")
    got, c_gpu = prefill(cfg, gpu_model, toks[:, :48].cuda(), target_len=56)
    want, c_cpu = prefill(cfg, cpu_model, toks[:, :48], target_len=56)
    _close_to_cpu(got, want, "prefill")
    for t in range(48, 56):
        got, _ = decode_step(cfg, gpu_model, c_gpu, toks[:, t:t + 1].cuda())
        want, _ = decode_step(cfg, cpu_model, c_cpu, toks[:, t:t + 1])
        _close_to_cpu(got, want, f"decode at {t}")


def test_mla_layer_and_absorbed_decode_on_cuda_match_cpu(cuda):
    """One MLA mixer of reduced DeepSeek-V3 on the card against the CPU from
    the same weights, fp32: the layer's training output and gradients, a
    48-token prefill (latent caches) and 8 absorbed decode steps at
    per-row positions (the slab's layout), within 1e-4 of the largest."""
    from repro_torch.models import mla

    cfg = get_config("deepseek-v3-671b").reduced(n_layers=4, d_model=128, seq_cap=64)
    spec = cfg.layers[0]
    tree = params_to_numpy(GCLM(cfg, device="cpu", seed=0))
    rng = np.random.default_rng(5)
    p_np = {k: v[0] for k, v in tree["stack"][0]["mixer"].items()}
    for name in ("q_a_norm", "kv_a_norm"):
        p_np[name] = (0.1 * rng.standard_normal(p_np[name].shape)).astype(np.float32)
    x_np = rng.standard_normal((2, 48, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p_np.items()}
        x = torch.tensor(x_np, device=dev, requires_grad=True)
        y, _ = mla.mla_forward(cfg, p, x, spec)
        grads = torch.autograd.grad(y.square().sum(), [x, *p.values()])
        with torch.no_grad():
            _, cache = mla.mla_forward(cfg, p, x[:, :40], spec, mode="prefill", target_len=48)
            cache["pos"] = torch.tensor([40, 33], dtype=torch.int32, device=dev)
            steps = [mla.mla_forward(cfg, p, x[:, t:t + 1], spec, mode="decode",
                                     cache=cache)[0] for t in range(40, 48)]
        out[str(dev)] = (y, grads, steps, cache)
    (y_c, g_c, s_c, c_c), (y_g, g_g, s_g, c_g) = out["cpu"], out[str(cuda)]
    _close_to_cpu(y_g, y_c, "train out")
    for i, (a, b) in enumerate(zip(g_g, g_c, strict=True)):
        _close_to_cpu(a, b, f"grad {i}")
    for t, (a, b) in enumerate(zip(s_g, s_c, strict=True)):
        _close_to_cpu(a, b, f"decode step {t}")
    for name in ("c_kv", "k_r"):
        _close_to_cpu(c_g[name], c_c[name], name)
    assert c_g["pos"].tolist() == [48, 41]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_deepseek_forward_backward_on_cuda_is_byte_equal(cuda, dtype):
    """Two runs of reduced DeepSeek-V3's loss (cross-entropy, aux and MTP)
    and every gradient on the card give the same bytes."""
    from repro_torch.models.model import train_loss

    cfg = get_config("deepseek-v3-671b").reduced(n_layers=4, d_model=128).replace(dtype=dtype)
    model = GCLM(cfg, device="cuda", seed=0)
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 129)))

    def run():
        loss, metrics = train_loss(cfg, model, {"tokens": toks.cuda()})
        return [loss, metrics["aux"], metrics["mtp"], *torch.autograd.grad(loss, model.leaves())]

    first, second = run(), run()
    assert first[1].item() > 0 and first[2].item() > 0
    for a, b in zip(first, second, strict=True):
        assert torch.equal(a, b)


def test_mamba_mixer_on_cuda_matches_cpu(cuda):
    """One Mamba mixer of reduced Jamba on the card against the CPU from the
    same weights, fp32, at 100 tokens (two scan chunks of 64, the tail
    padded): the training output and gradients, the prefill state
    ``{conv, h}`` and 4 decode steps from it with per-row positions,
    within 1e-4 of the largest."""
    from repro_torch.models import ssm

    cfg = get_config("jamba-v0.1-52b").reduced(n_layers=8, d_model=128, seq_cap=64)
    spec = cfg.layers[0]
    tree = params_to_numpy(GCLM(cfg, device="cpu", seed=0))
    rng = np.random.default_rng(5)
    p_np = dict(tree["stack"][0]["mixer"])
    for name in ("conv_b", "d_skip"):
        p_np[name] = (p_np[name] + 0.1 * rng.standard_normal(p_np[name].shape)).astype(np.float32)
    x_np = rng.standard_normal((2, 104, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p_np.items()}
        x = torch.tensor(x_np, device=dev, requires_grad=True)
        y, _ = ssm.mamba_forward(cfg, p, x[:, :100], spec)
        grads = torch.autograd.grad(y.square().sum(), [x, *p.values()])
        with torch.no_grad():
            _, cache = ssm.mamba_forward(cfg, p, x[:, :100], spec, mode="prefill")
            state = {k: cache[k].clone() for k in ("conv", "h")}
            cache["pos"] = torch.tensor([100, 93], dtype=torch.int32, device=dev)
            steps = [ssm.mamba_forward(cfg, p, x[:, t:t + 1], spec, mode="decode",
                                       cache=cache)[0] for t in range(100, 104)]
        out[str(dev)] = (y, grads, state, steps, cache)
    (y_c, g_c, st_c, s_c, c_c), (y_g, g_g, st_g, s_g, c_g) = out["cpu"], out[str(cuda)]
    _close_to_cpu(y_g, y_c, "train out")
    for i, (a, b) in enumerate(zip(g_g, g_c, strict=True)):
        _close_to_cpu(a, b, f"grad {i}")
    for name in ("conv", "h"):
        _close_to_cpu(st_g[name], st_c[name], f"prefill {name}")
        _close_to_cpu(c_g[name], c_c[name], f"decoded {name}")
    for t, (a, b) in enumerate(zip(s_g, s_c, strict=True)):
        _close_to_cpu(a, b, f"decode step {t}")
    assert c_g["h"].dtype == torch.float32 and c_g["pos"].tolist() == [104, 97]


def test_chunked_attention_with_chunk_remat_on_cuda_matches_cpu(cuda):
    """The online softmax over two KV chunks of 128 (160 tokens, GQA 4
    over 2) with ``attn_chunk_remat`` on the card against the CPU, fp32:
    output and the gradients of q, k and v within 1e-4 of the largest;
    on the card the remat gradients are bit-equal to no remat."""
    from repro_torch.models import attention

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    assert cfg.attn_chunk == 128 and cfg.head_dim == 32
    rng = np.random.default_rng(4)
    qkv = [3 * rng.standard_normal((2, 160, h, 32)).astype(np.float32) for h in (4, 2, 2)]
    out = {}
    for dev, remat in (("cpu", True), (cuda, True), (cuda, False)):
        ts = [torch.tensor(a, device=dev, requires_grad=True) for a in qkv]
        y = attention.chunked_attention(cfg.replace(attn_chunk_remat=remat), *ts, cap=50.0)
        out[(str(dev), remat)] = [y, *torch.autograd.grad(y.square().sum(), ts)]
    for a, b in zip(out[(str(cuda), True)], out[("cpu", True)], strict=True):
        _close_to_cpu(a, b, "chunked attention")
    for a, b in zip(out[(str(cuda), True)], out[(str(cuda), False)], strict=True):
        assert torch.equal(a, b)


def test_jamba_decode_step_replays_in_a_cuda_graph(cuda):
    """A decode step of reduced Jamba over a 4-slot fp32 slab, captured in a
    CUDA graph and replayed 3 times: each replay writes every Mamba
    layer's ``conv`` and ``h`` and the attention layer's K/V in place (the
    slab's storage unchanged) and advances ``pos``, as 3 eager steps do on
    a copy, within 1e-5 of the largest entry."""
    cfg = get_config("jamba-v0.1-52b").reduced(n_layers=8, d_model=128, seq_cap=64)
    model = GCLM(cfg, device="cuda", seed=0)
    slab = make_slab(cfg, 4, 32, dtype=torch.float32)
    _, pref = prefill(cfg, model, torch.arange(1, 9, device="cuda")[None], target_len=32)
    insert_request(cfg, slab, pref, 2)
    eager = [{k: v.clone() for k, v in seg.items()} for seg in slab]
    ptrs = [{k: v.data_ptr() for k, v in seg.items()} for seg in slab]
    tok = torch.full((4, 1), 7, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a copy
        decode_step(cfg, model, [{k: v.clone() for k, v in seg.items()} for seg in slab], tok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        logits, _ = decode_step(cfg, model, slab, tok)
    h_before = slab[0]["h"][2].clone()
    for _ in range(3):
        graph.replay()
        want, _ = decode_step(cfg, model, eager, tok)
        torch.cuda.synchronize()
        _close_to_cpu(logits, want.cpu(), "replayed logits", rel=1e-5)
    assert ptrs == [{k: v.data_ptr() for k, v in seg.items()} for seg in slab]
    assert not torch.equal(slab[0]["h"][2], h_before)
    for seg, ref_seg in zip(slab, eager, strict=True):
        for name in seg:
            if name == "pos":
                assert torch.equal(seg[name], ref_seg[name])
            else:
                _close_to_cpu(seg[name], ref_seg[name].cpu(), name, rel=1e-5)
    assert slab[0]["pos"][2].item() == 8 + 3 and slab[4]["pos"][2].item() == 8 + 3


def test_mlstm_chunked_prefill_on_cuda_matches_cpu(cuda):
    """One mLSTM mixer of reduced xLSTM on the card against the CPU from the
    same weights, fp32, at 160 tokens (chunks of 64, 64 and a 32-token
    tail): the training output, the gradients (``b_i``'s aside: zero in
    exact arithmetic, rounding noise on both devices) and the prefill
    state ``{C, n, m, conv}``, within 1e-4 of the largest."""
    from repro_torch.models import xlstm

    cfg = get_config("xlstm-1.3b").reduced(n_layers=8, d_model=128, seq_cap=64)
    spec = cfg.layers[0]
    assert cfg.scan_chunk == 64 and spec.mixer == "mlstm"
    tree = params_to_numpy(GCLM(cfg, device="cpu", seed=0))
    rng = np.random.default_rng(5)
    p_np = {k: v[0] for k, v in tree["stack"][0]["mixer"].items()}
    for name in ("b_i", "conv_b", "gn_scale"):
        p_np[name] = (p_np[name] + 0.1 * rng.standard_normal(p_np[name].shape)).astype(np.float32)
    x_np = rng.standard_normal((2, 160, cfg.d_model)).astype(np.float32)
    out = {}
    for dev in ("cpu", cuda):
        p = {k: torch.tensor(v, device=dev, requires_grad=True) for k, v in p_np.items()}
        x = torch.tensor(x_np, device=dev, requires_grad=True)
        y, _ = xlstm.mlstm_forward(cfg, p, x, spec)
        grads = torch.autograd.grad(y.square().sum(), [x, *(v for k, v in p.items()
                                                          if k != "b_i")])
        with torch.no_grad():
            _, cache = xlstm.mlstm_forward(cfg, p, x, spec, mode="prefill")
        out[str(dev)] = (y, grads, cache)
    (y_c, g_c, c_c), (y_g, g_g, c_g) = out["cpu"], out[str(cuda)]
    _close_to_cpu(y_g, y_c, "train out")
    for i, (a, b) in enumerate(zip(g_g, g_c, strict=True)):
        _close_to_cpu(a, b, f"grad {i}")
    for name in ("C", "n", "m", "conv"):
        assert c_g[name].dtype == torch.float32
        _close_to_cpu(c_g[name], c_c[name], f"prefill {name}")
    assert int(c_g["pos"]) == 160


def test_xlstm_decode_step_replays_in_a_cuda_graph(cuda):
    """A decode step of reduced xLSTM (a run of 7 mLSTM layers and an
    sLSTM layer) over a 4-slot fp32 slab, captured in a CUDA graph and
    replayed 3 times: each replay writes every mLSTM layer's ``C``,
    ``n``, ``m`` and ``conv`` and the sLSTM layer's ``h``, ``c``, ``n``,
    ``m`` in place (the slab's storage unchanged) and advances ``pos``, as
    3 eager steps do on a copy, within 1e-5 of the largest entry."""
    cfg = get_config("xlstm-1.3b").reduced(n_layers=8, d_model=128, seq_cap=64)
    model = GCLM(cfg, device="cuda", seed=0)
    slab = make_slab(cfg, 4, 32, dtype=torch.float32)
    _, pref = prefill(cfg, model, torch.arange(1, 9, device="cuda")[None], target_len=32)
    insert_request(cfg, slab, pref, 2)
    eager = [{k: v.clone() for k, v in seg.items()} for seg in slab]
    ptrs = [{k: v.data_ptr() for k, v in seg.items()} for seg in slab]
    tok = torch.full((4, 1), 7, device="cuda")
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on a copy
        decode_step(cfg, model, [{k: v.clone() for k, v in seg.items()} for seg in slab], tok)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        logits, _ = decode_step(cfg, model, slab, tok)
    c_before, h_before = slab[0]["C"][:, 2].clone(), slab[1]["h"][2].clone()
    for _ in range(3):
        graph.replay()
        want, _ = decode_step(cfg, model, eager, tok)
        torch.cuda.synchronize()
        _close_to_cpu(logits, want.cpu(), "replayed logits", rel=1e-5)
    assert ptrs == [{k: v.data_ptr() for k, v in seg.items()} for seg in slab]
    assert not torch.equal(slab[0]["C"][:, 2], c_before)
    assert not torch.equal(slab[1]["h"][2], h_before)
    for seg, ref_seg in zip(slab, eager, strict=True):
        for name in seg:
            if name == "pos":
                assert torch.equal(seg[name], ref_seg[name])
            else:
                _close_to_cpu(seg[name], ref_seg[name].cpu(), name, rel=1e-5)
    assert slab[0]["pos"][:, 2].tolist() == [8 + 3] * 7 and slab[1]["pos"][2].item() == 8 + 3


def _cross_model(arch, n_layers, device):
    """Reduced ``arch`` at d_model 128 with every cross ``gate`` set to 0.5
    (a closed gate, the init, hides the source), its numpy tree, and the
    modality embeddings of 4 shards of 2 rows (seed 0)."""
    cfg = get_config(arch).reduced(n_layers=n_layers, d_model=128, seq_cap=64)
    tree = params_to_numpy(GCLM(cfg, device="cpu", seed=0))

    def walk(node):
        if isinstance(node, dict):
            return {k: (np.full_like(v, 0.5) if k == "gate" else walk(v))
                    for k, v in node.items()}
        return [walk(v) for v in node] if isinstance(node, list) else node

    tree = walk(tree)
    shape = ((cfg.encoder.n_frames, cfg.d_model) if cfg.encoder is not None
             else (cfg.vision.n_patches, cfg.vision.d_vision))
    aux = np.random.default_rng(0).standard_normal((4, 2) + shape, dtype=np.float32)
    return cfg, tree, params_from_numpy(GCLM(cfg, device=device), tree), aux


@pytest.mark.parametrize("arch,n_layers", [("whisper-base", 2), ("llama-3.2-vision-11b", 10)])
def test_cross_source_forward_and_coded_step_on_cuda_match_cpu(cuda, arch, n_layers):
    """Reduced Whisper (2 + 2 layers, 51 leaves) and reduced vision (10
    layers: the cross layer inside a pattern, 50 leaves), gates open: the
    forward with aux inputs on the card within 1e-4 of the CPU's; the coded
    gradient with ``worker_aux`` equal to the uncoded one (1e-4) for 0 and
    s_max stragglers, in ceil(leaves / 32) = 2 ``gc_fused`` launches; a
    ``make_coded_train_step`` step's loss as the CPU's."""
    cfg, tree, model, aux = _cross_model(arch, n_layers, cuda)
    cpu_model = params_from_numpy(GCLM(cfg, device="cpu"), tree)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 24))
    with torch.no_grad():
        got = forward(cfg, model, toks, aux_inputs=aux[0])[0]
        want = forward(cfg, cpu_model, toks, aux_inputs=aux[0])[0]
    _close_to_cpu(got, want, "logits")
    plan = Plan.build(model, ShiftedExponential(), 4)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8))
    wb = coded_worker_batches(data, 0, 4, plan.s_max)
    wa = np.stack([np.stack([aux[(n + k) % 4] for k in range(plan.s_max + 1)])
                   for n in range(4)])
    shards = np.stack([data.shard(0, i, 4) for i in range(4)])
    g_ref = uncoded_grad_fn(cfg, 4)(model, shards, aux)
    coded = make_coded_grad_fn(cfg, plan)
    n_leaves = len(model.leaves())
    for u in (0, plan.s_max):
        times = np.ones(4)
        times[:u] = 1e6
        dec_w = plan.decode_weights(times).astype(np.float32)
        before = gc_fused.launches
        g = coded(model, wb, dec_w, wa)
        torch.cuda.synchronize()
        assert gc_fused.launches == before + -(-n_leaves // _pipe.MAX_LEAVES) == before + 2
        for gc, gu in zip(g, g_ref):
            assert float((gc - gu).abs().max()) <= 1e-4 * float(gu.abs().max())
    losses = []
    for m in (model, cpu_model):
        state = init_train_state(cfg, device=m.embed.tok.device, params=tree)
        step = make_coded_train_step(cfg, TrainConfig(), Plan.build(m, ShiftedExponential(), 4))
        _, metrics = step(state, wb, dec_w, wa)
        losses.append(float(metrics["loss"]))
    np.testing.assert_allclose(losses[0], losses[1], rtol=1e-4)


def test_generate_with_aux_inputs_on_cuda_matches_cpu(cuda):
    """``generate(aux_inputs=)`` (the direct loop) of reduced vision at 10
    layers, fp32, greedy: the card's tokens are the CPU's."""
    cfg, tree, model, aux = _cross_model("llama-3.2-vision-11b", 10, cuda)
    cpu_model = params_from_numpy(GCLM(cfg, device="cpu"), tree)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 12))
    got = generate(cfg, model, prompts, 8, aux_inputs=aux[0])
    want = generate(cfg, cpu_model, prompts, 8, aux_inputs=aux[0], device="cpu")
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def _counted_step(device):
    """One coded step of reduced gc-lm-110m (N = 4, xf) on ``device``
    under the op counter, and the launches it made."""
    from repro_torch.launch.op_analysis import analyze_ops
    from repro_torch.train.state import abstract_train_state

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8, seed=0))
    state = abstract_train_state(cfg) if device == "meta" else \
        init_train_state(cfg, device=device, seed=0)
    plan = Plan.build(state.params, ShiftedExponential(mu=1e-3, t0=50.0), 4, scheme="xf")
    wb = torch.as_tensor(coded_worker_batches(data, 0, 4, plan.s_max), device=device)
    dec_w = plan.decode_weights(np.arange(4, dtype=np.float64)).astype(np.float32)
    before = gc_fused.launches
    cost = analyze_ops(make_coded_train_step(cfg, TrainConfig(), plan), state, wb, dec_w)
    return cost, gc_fused.launches - before


def test_op_counts_of_a_coded_step_equal_on_cuda_and_meta(cuda):
    """The card runs all N·K passes and launches ``gc_fused``; meta runs
    one pass counted N·K times and the plain combine: the same counts, op
    for op, and one counted combine per launch."""
    got, launches = _counted_step("cuda")
    want, _ = _counted_step("meta")
    assert got.by_op == want.by_op
    assert (got.flops, got.bytes, got.transcendentals) == \
        (want.flops, want.bytes, want.transcendentals)
    assert launches == got.kernel_calls["gc_fused"] == want.kernel_calls["gc_fused"] == 1


def test_analyze_memory_on_cuda_peaks_above_the_arguments(cuda):
    from repro_torch.tune import analyze_memory

    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    state = init_train_state(cfg, device="cuda", seed=0)
    tokens = torch.zeros((4, 33), dtype=torch.int64, device="cuda")
    from repro_torch.train.trainer import make_train_step

    mem = analyze_memory(make_train_step(cfg, TrainConfig()), state, {"tokens": tokens},
                         device="cuda")
    assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
    assert 0 <= mem["temp_bytes"] <= mem["peak_bytes"]


def test_dryrun_measure_records_the_peak(cuda, tmp_path):
    from repro_torch.launch import dryrun

    cfg = get_config("gc-lm-110m").reduced()
    rec = dryrun.run_case("gc-lm-110m", "train_4k", "single", coded=False,
                          out_dir=str(tmp_path), cfg=cfg, measure=True)
    assert rec["status"] == "ok", rec.get("error")
    mem = rec["memory"]
    assert (mem["measured"], mem["groups"], rec["mesh_shape"]) == ("ok", "solo", [16, 16])
    assert rec["local_params"] < rec["params_b"]  # a (16, 16) rank's shards
    assert mem["peak_bytes"] >= mem["argument_bytes"] == mem["measured_argument_bytes"]
