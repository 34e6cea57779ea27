"""The port's op counter (``launch/op_analysis.py``), the counterpart of
``launch/hlo_analysis.py``: the reference's known-FLOP programs in
torch, the kernels and collectives counted as one op each on every
route, the meta-only trip-count shortcut equal to the full loop (the
sLSTM's tokens and the Mamba and mLSTM chunks, forward and backward; the
coded step's per-shard passes), and the FLOPs of reduced models against
the reference's ``analyze_hlo``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.hlo_analysis as H
from repro.configs import get_config as jax_get_config
from repro.launch.hlo_analysis import analyze_hlo
from repro.models.model import decode_step as j_decode
from repro.models.model import init_decode_caches as j_caches
from repro.models.model import init_model
from repro.models.model import prefill as j_prefill
from repro.models.model import train_loss as j_train_loss
from repro_torch.configs import get_config
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist.collectives import all_gather, psum, psum_scatter
from repro_torch.dist.mesh import meta_mesh
from repro_torch.kernels import ops
from repro_torch.launch import op_analysis
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.models import ssm
from repro_torch.models.model import decode_step, init_decode_caches, prefill, train_loss
from repro_torch.models.params import GCLM
from repro_torch.train.coded import per_shard_grad_rows

MATMULS = ("mm", "bmm", "addmm", "baddbmm")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(shape, device, dtype=torch.float32, grad=False):
    t = torch.zeros(shape, dtype=dtype, device=device)
    return t.requires_grad_(grad)


# ------------------------------------------------- the reference's programs
@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_plain_matmul_flops(device):
    a = _t((256, 256), device)
    cost = analyze_ops(lambda x, y: x @ y, a, a)
    assert cost.flops == 2 * 256 ** 3
    assert cost.bytes == 3 * 256 * 256 * 4
    assert cost.flops_by_dtype == {"float32": 2 * 256 ** 3}


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_scan_multiplies_by_trip_count(device):
    def f(a, xs):
        def step(i, c, xs):
            new = c[0] @ xs[i]
            return (new,), new

        return op_analysis.scan(step, 7, (a,), (xs,))[0][0]

    cost = analyze_ops(f, _t((128, 128), device), _t((7, 128, 128), device))
    assert cost.flops == 7 * 2 * 128 ** 3
    assert 7 in cost.loop_trips


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_nested_scan(device):
    def inner(i, c, x):
        new = c[0] @ x
        return (new,), new

    def outer(i, c, xs):
        carry, _ = op_analysis.scan(inner, 3, c, (xs[i],))
        return carry, carry[0]

    def f(a, xs):
        return op_analysis.scan(outer, 5, (a,), (xs,))[0][0]

    cost = analyze_ops(f, _t((64, 64), device), _t((5, 64, 64), device))
    assert cost.flops == 5 * 3 * 2 * 64 ** 3
    assert cost.loop_trips == [3, 5]


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_scan_bytes_not_inflated_by_stacked_operand(device):
    """Reading one slice per iteration is a view: each trip moves its
    slice, the carry and the sum, never the whole stack."""
    def step(i, c, xs):
        new = c[0] + xs[i]
        return (new,), new

    def f(a, xs):
        return op_analysis.scan(step, 100, (a,), (xs,))[0]

    cost = analyze_ops(f, _t((256, 256), device), _t((100, 256, 256), device))
    full_stack = 100 * 256 * 256 * 4
    assert cost.bytes == 3 * full_stack
    assert cost.flops == 100 * 256 * 256


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_elementwise_and_reduce(device):
    cost = analyze_ops(lambda v: torch.tanh(v).sum(), _t((1 << 16,), device))
    assert cost.flops == 2 * (1 << 16)
    assert cost.transcendentals == 1 << 16
    assert cost.by_op["tanh"][1] == cost.by_op["sum"][1] == 1 << 16


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_narrow_dtype_counts_its_own_width(device):
    """fp8 counts 1 byte per element and its conversion is elementwise;
    nothing is left unpriced."""
    x = _t((128, 256), device, torch.float8_e4m3fn)
    cost = analyze_ops(lambda v: v.float() + v.float(), x)
    n = 128 * 256
    assert cost.by_op["_to_copy"] == [2.0, 2.0 * n, 2 * (n + 4 * n)]
    assert cost.flops == 3 * n and cost.unpriced == {}


def test_views_and_allocation_cost_nothing():
    x = _t((64, 32), "meta")
    cost = analyze_ops(lambda v: (v.t(), v[3], v.reshape(-1), torch.empty_like(v)), x)
    assert cost.flops == cost.bytes == 0 and cost.by_op == {}


def test_in_place_writes_count_what_they_move():
    """``copy_`` into a row of a buffer moves the row twice (read, write),
    not the buffer; ``index_put_`` moves its values and indices."""
    buf = _t((16, 1024), "meta")
    row = _t((1024,), "meta")
    cost = analyze_ops(lambda b, r: b[3].copy_(r), buf, row)
    assert cost.bytes == 2 * 1024 * 4
    idx = torch.zeros(4, dtype=torch.long, device="meta")
    vals = _t((4, 1024), "meta")
    cost = analyze_ops(lambda b, i, v: b.index_put_((i,), v), buf, idx, vals)
    assert cost.bytes == 4 * 8 + 2 * 4 * 1024 * 4


def test_host_work_and_host_copies_are_not_the_devices():
    x = _t((8, 8), "meta")

    def f(v):
        lr = torch.tensor(3.0) * 2  # host arithmetic beside the step
        w = torch.as_tensor(np.ones((8, 8), np.float64), dtype=torch.float32, device="meta")
        return v * w + float(lr)

    cost = analyze_ops(f, x)
    assert set(cost.by_op) == {"mul", "add"}


# ------------------------------------------------------ kernels, collectives
def _combine_inputs(device, widths, n_w=3, nb=1, k=8):
    gen = torch.Generator().manual_seed(0)
    a = torch.rand(nb, generator=gen).to(device)
    b = torch.rand(n_w, nb, k, generator=gen).to(device)
    gs = [torch.rand(k, d, generator=gen).to(device) for d in widths]
    which = [j % n_w for j in range(len(widths))]
    return a, b, which, gs


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_combine_is_one_op_per_launch_on_every_route(device):
    widths = [5, 128, 7, 1, 300] * 8  # 40 leaves: two launches of at most 32
    a, b, which, gs = _combine_inputs(device, widths)
    cost = analyze_ops(ops.encode_decode_leaves, a, b, which, gs)
    assert cost.kernel_calls == {"gc_fused": 2}
    assert set(cost.by_op) == {"gc_fused"}  # nothing of the plain version
    assert cost.flops == sum(2 * 8 * d for d in widths) + 3 * 8
    assert cost.bytes == sum(9 * d for d in widths) * 4 + (3 * 8 + 1) * 4
    ys = cost.output
    assert [tuple(y.shape) for y in ys] == [(1, d) for d in widths]
    assert all(y.device.type == device for y in ys)


def test_combine_counts_alike_on_cpu_and_meta():
    for fn, make in [
        (ops.encode_decode_leaves, lambda d: _combine_inputs(d, [33, 64, 2])),
        (ops.encode_decode, lambda d: (lambda a, b, w, g: (a, b[0], g[0]))(
            *_combine_inputs(d, [100]))),
        (ops.encode, lambda d: (lambda a, b, w, g: (b[0], g[0]))(*_combine_inputs(d, [100]))),
        (ops.decode, lambda d: (torch.rand(6).to(d), torch.rand(6, 77).to(d))),
    ]:
        cpu, meta = analyze_ops(fn, *make("cpu")), analyze_ops(fn, *make("meta"))
        assert cpu == meta and len(cpu.by_op) == 1 and sum(cpu.kernel_calls.values()) == 1


def test_meta_mesh_collectives_count_by_kind():
    mesh = meta_mesh(data=4, pod=2)
    bufs = [_t((64,), "meta"), _t((32, 3), "meta", torch.bfloat16)]

    def f(bufs):
        psum(bufs, mesh.data_group)
        tile = psum_scatter(bufs[0], mesh.data_group)
        assert tuple(tile.shape) == (16,)
        full = all_gather(tile, mesh.data_group)
        assert tuple(full.shape) == (64,)
        return full

    cost = analyze_ops(f, bufs)
    assert cost.collective_counts == {"all-gather": 1, "all-reduce": 2, "reduce-scatter": 1,
                                      "all-to-all": 0, "collective-permute": 0}
    assert cost.collective_bytes["all-reduce"] == 64 * 4 + 96 * 2
    assert cost.collective_bytes["reduce-scatter"] == 16 * 4
    assert cost.collective_bytes["all-gather"] == 64 * 4
    assert cost.total_collective_bytes == 2 * (64 * 4 + 96 * 2) + 16 * 4 + 64 * 4
    assert mesh.size == 8 and mesh.pod_group.size == 2 and mesh.world_group.size == 8


def test_meta_mesh_misuse_raises():
    mesh = meta_mesh(data=4)
    with pytest.raises(ValueError, match="meta mesh reduces meta tensors only"):
        psum([torch.zeros(8)], mesh.data_group)  # a real tensor on a meta mesh
    with pytest.raises(ValueError, match="process group"):
        psum([_t((8,), "meta")], None)  # a meta tensor on a real group
    with pytest.raises(ValueError, match="process group"):
        all_gather(_t((8,), "meta"), None)
    with pytest.raises(ValueError, match="no rank"):
        meta_mesh(data=4, rank=4)


def test_meta_route_only_for_meta_tensors():
    assert ops._route(_t((2,), "meta"), "kernel", "plain") == "plain"
    assert ops._route(torch.zeros(2), "kernel", "plain") == "plain"
    if torch.cuda.is_available():
        assert ops._route(torch.zeros(2, device="cuda"), "kernel", "plain") == "kernel"


# ------------------------------------------------ the trip-count shortcut
def _xlstm_step(cfg, s):
    def run(device):
        model = GCLM(cfg, device=device, seed=0)
        tokens = torch.zeros((2, s + 1), dtype=torch.long, device=device)

        def step(t):
            loss, _ = train_loss(cfg, model, {"tokens": t})
            return torch.autograd.grad(loss, model.leaves())

        return analyze_ops(step, tokens)
    return run


@pytest.mark.parametrize("s", [16, 320])
def test_xlstm_shortcut_equals_the_full_loop(s):
    """The sLSTM's per-token loop (16 and 320 tokens) and the mLSTM's
    chunks (5 of 64 at 320): on meta the middle trips run once, counted
    n - 2 times forward and backward; op for op equal to the CPU's full
    loops."""
    cfg = get_config("xlstm-1.3b").reduced(n_layers=8, d_model=128)
    run = _xlstm_step(cfg, s)
    cpu, meta = run("cpu"), run("meta")
    assert cpu.by_op == meta.by_op
    assert (cpu.flops, cpu.bytes, cpu.transcendentals) == \
        (meta.flops, meta.bytes, meta.transcendentals)
    assert s in meta.loop_trips


@pytest.mark.parametrize("n_chunks", [4, 5, 7])
def test_mamba_scan_shortcut_equals_the_full_loop(n_chunks):
    cfg = get_config("jamba-v0.1-52b").reduced(n_layers=8, d_model=128)
    b, s, di, ns = 2, 64 * n_chunks - 10, 16, 8  # a padded tail chunk

    def run(device):
        leaves = [_t(sh, device, grad=True) for sh in
                  [(b, s, di), (di, ns), (b, s, ns), (b, s, ns), (b, s, di)]]

        def f(delta, a, b_t, c_t, x_in):
            y, h = ssm._scan_chunked(cfg, delta * 1.0, a, b_t, c_t, x_in * 1.0,
                                     torch.zeros((b, di, ns), device=device))
            return torch.autograd.grad(y.sum() + h.sum(), [delta, a, b_t, c_t, x_in])

        return analyze_ops(f, *leaves)

    cpu, meta = run("cpu"), run("meta")
    assert cpu.by_op == meta.by_op and cpu.flops == meta.flops and cpu.bytes == meta.bytes
    assert meta.loop_trips == [n_chunks]


def test_per_shard_passes_counted_n_k_times():
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=16, global_batch=8, seed=0))

    def run(device):
        model = GCLM(cfg, device=device, seed=0)
        plan = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), 4, scheme="xf")
        wb = torch.as_tensor(coded_worker_batches(data, 0, 4, plan.s_max), device=device)
        return analyze_ops(per_shard_grad_rows, cfg, model, wb), plan

    (cpu, plan), (meta, _) = run("cpu"), run("meta")
    assert cpu == meta
    assert meta.loop_trips == [4 * (plan.s_max + 1)]


def test_shortcut_is_meta_only():
    """On the CPU a scan under a counter runs every trip: the same values
    as without a counter."""
    xs = torch.randn(6, 5, 5, generator=torch.Generator().manual_seed(0))

    def f(xs):
        return op_analysis.scan(lambda i, c, xs: ((c[0] @ xs[i],), c[0].sum()), 6,
                                (torch.eye(5),), (xs,))

    plain = f(xs)
    counted = analyze_ops(f, xs).output
    torch.testing.assert_close(counted[0][0], plain[0][0], rtol=0, atol=0)
    assert [float(y) for y in counted[1]] == [float(y) for y in plain[1]]


# ------------------------------------------- against the reference's HLO
B, S = 2, 128


def _ref_flops(fn, *specs, dots_only=False, monkeypatch=None):
    text = jax.jit(fn).lower(*specs).compile().as_text()
    if dots_only:
        orig = H._Analyzer._add_op

        def only_dots(self, comp, op, cost):
            if op.opcode in ("dot", "while", "fusion", "call", "map", "conditional"):
                orig(self, comp, op, cost)

        monkeypatch.setattr(H._Analyzer, "_add_op", only_dots)
    return analyze_hlo(text).flops


@pytest.mark.parametrize("arch", ["gc-lm-110m", "gemma-2b", "mixtral-8x22b"])
def test_flops_against_the_references_hlo(arch, monkeypatch):
    """Reduced models, fp32, on meta: training (forward and backward) and
    prefill within 5% of the reference's trip-count-aware FLOPs (its
    figure includes XLA's elementwise work).  A decode step's matmuls
    equal the reference's dots exactly; its total is below the
    reference's by elementwise work only (XLA converts the bf16 caches
    more often than the port's one cast per use)."""
    cj, ct = jax_get_config(arch).reduced(), get_config(arch).reduced()
    params = jax.eval_shape(lambda: init_model(cj, jax.random.PRNGKey(0))[0])
    model = GCLM(ct, device="meta")

    def jgrad(p, t):
        return jax.value_and_grad(lambda q: j_train_loss(cj, q, {"tokens": t})[0])(p)

    def tstep(t):
        return torch.autograd.grad(train_loss(ct, model, {"tokens": t})[0], model.leaves())

    tok = torch.empty((B, S + 1), dtype=torch.long, device="meta")
    ref = _ref_flops(jgrad, params, jax.ShapeDtypeStruct((B, S + 1), jnp.int32))
    assert analyze_ops(tstep, tok).flops == pytest.approx(ref, rel=0.05)

    ref = _ref_flops(lambda p, t: j_prefill(cj, p, t, target_len=S + 1), params,
                     jax.ShapeDtypeStruct((B, S), jnp.int32))
    got = analyze_ops(lambda t: prefill(ct, model, t, target_len=S + 1),
                      torch.empty((B, S), dtype=torch.long, device="meta")).flops
    assert got == pytest.approx(ref, rel=0.05)

    cspec = jax.eval_shape(lambda: j_caches(cj, B, S))
    one = jax.ShapeDtypeStruct((B, 1), jnp.int32)
    ref_total = _ref_flops(lambda p, c, t: j_decode(cj, p, c, t), params, cspec, one)
    ref_dots = _ref_flops(lambda p, c, t: j_decode(cj, p, c, t), params, cspec, one,
                          dots_only=True, monkeypatch=monkeypatch)
    cost = analyze_ops(lambda c, t: decode_step(ct, model, c, t),
                       init_decode_caches(ct, B, S, device="meta"),
                       torch.empty((B, 1), dtype=torch.long, device="meta"))
    dots = sum(v[1] for k, v in cost.by_op.items() if k in MATMULS)
    assert dots == pytest.approx(ref_dots, rel=1e-9)
    assert 0 < cost.flops - dots <= ref_total - ref_dots
