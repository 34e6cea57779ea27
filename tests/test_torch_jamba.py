"""The port's Jamba — the Mamba mixer (``models/ssm.py``) in a hybrid
stack with attention and MoE layers — against the JAX reference, on the
CPU.

The model is ``jamba-v0.1-52b.reduced(n_layers=8, d_model=128,
seq_cap=64)``: one period of the published layout — seven Mamba layers
(d_inner 256, d_state 8, dt_rank 8, conv 4) and global attention at
offset 4, a 4-expert top-2 MoE FFN (capacity factor 8: no drops) on the
odd layers — eight single-layer runs, 114 leaves, an untied head, Mamba
scans in chunks of 64.  ``n_layers=16`` makes one pattern of 8 over 2
repeats.  The reference's initialized weights are carried with
``params_from_numpy`` and its caches with ``caches_from_numpy``.

Tolerances:

* fp32 — the mixer's output, prefill state and gradients, the model's
  logits, loss and every leaf's gradient, prefill and decode logits and
  caches: 1e-5 of each tensor's largest entry (the same fp32 math, sums
  in another order); the fixed-value leaves of the init: bit-equal;
* bf16 activations — the mixer ``MIXER_BF16_REL`` = 2e-2 of the largest
  output (measured on the CPU: 6.35e-3 to 6.80e-3 over the three lengths;
  the scan is fp32, the projections and the conv round at bf16); the
  model at ``test_torch_gemma.py``'s bounds (logits 5e-2 of the largest,
  gradients 1e-1 of a leaf's largest, loss 1e-3 relative): XLA keeps
  excess precision between fused bf16 ops, torch rounds each;
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), against the reference's coded: 1e-5;
* the engine's tokens, slots and timestamps: equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.models import model as jmodel
from repro.models import ssm as jssm
from repro.models.params import count_params as jax_count_params
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro_torch.configs import MambaSpec, get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import ssm
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.models.stack import Pattern, Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy, make_slab)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn

ARCH = "jamba-v0.1-52b"
KW = dict(n_layers=8, d_model=128, seq_cap=64)
REL = 1e-5
MIXER_BF16_REL = 2e-2
BF16_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
N = 4
SE = dict(mu=1e-3, t0=50.0)
MAMBA_LEAVES = ("a_log", "conv_b", "conv_w", "d_skip", "dt_bias", "dt_proj", "in_proj",
                "out_proj", "x_proj")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors and many steps: one intra-op thread keeps torch's
    pool from spinning on cores other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"
    return err / scale


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


_CARRIED = {}


def carried(n_layers=8):
    """(cfg_t, cfg_j, numpy tree, jax params, model) of reduced Jamba,
    built once per module and depth."""
    if n_layers not in _CARRIED:
        kw = dict(KW, n_layers=n_layers)
        cfg_t, cfg_j = get_config(ARCH).reduced(**kw), jax_get_config(ARCH).reduced(**kw)
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, state.params)
        model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
        _CARRIED[n_layers] = (cfg_t, cfg_j, tree, jax.tree.map(jnp.asarray, tree), model)
    return _CARRIED[n_layers]


def _tokens(cfg, seq=48, batch=2, seed=1):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(0)


def _as(dtype, x):
    """x rounded to ``dtype`` on both sides: (jax array, torch tensor)."""
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("size", ["full", "cut8", "reduced"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    """Leaf paths, order and shapes on meta at full width (32 layers: one
    pattern of 8 over 4 repeats; the first 8: eight single-layer runs,
    13,295,235,072 parameters) and reduced to 8 layers (114 leaves)."""
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    if size == "cut8":
        cfg_t = cfg_t.replace(n_layers=8, layers=cfg_t.layers[:8])
        cfg_j = cfg_j.replace(n_layers=8, layers=cfg_j.layers[:8])
    elif size == "reduced":
        cfg_t, cfg_j = cfg_t.reduced(n_layers=8), cfg_j.reduced(n_layers=8)
    model = GCLM(cfg_t, device="meta")
    params_j = j_abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert len(paths) == 114
    assert paths[:3] == ["embed.tok", "embed.unembed", "final_norm.scale"]
    first = "stack.0.0" if size == "full" else "stack.0"
    assert [p for p in paths if p.startswith(f"{first}.mixer.")] == \
        [f"{first}.mixer.{n}" for n in MAMBA_LEAVES]
    segs = plan_segments(cfg_t.layers)
    if size == "full":
        assert segs == [Pattern(cfg_t.layers[:8], 4, 0)]
        assert tuple(model.stack[0][0].mixer.x_proj.shape) == (4, 8192, 256 + 2 * 16)
    else:
        assert segs == [Run(spec, 1, i) for i, spec in enumerate(cfg_t.layers)]
    assert [s.mixer for s in cfg_t.layers[:8]] == ["mamba"] * 4 + ["attn"] + ["mamba"] * 3
    assert [s.moe is not None for s in cfg_t.layers[:8]] == [False, True] * 4
    n = sum(int(np.prod(s)) for s in shapes)
    assert n == jax_count_params(params_j)
    if size == "cut8":
        assert n == 13_295_235_072, n


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
                      (get_config(ARCH).reduced(n_layers=8), jax_get_config(ARCH).reduced(
                          n_layers=8)),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe and dataclasses.asdict(lt.moe),
                         lt.use_ffn, lt.cross_source) for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe and dataclasses.asdict(lj.moe), lj.use_ffn,
                      lj.cross_source) for lj in value]
            elif f.name in ("mla", "mamba") and value is not None:
                assert dataclasses.asdict(getattr(got, f.name)) == dataclasses.asdict(value)
            else:
                assert getattr(got, f.name) == value, f.name
    red = get_config(ARCH).reduced(n_layers=8)
    assert red.mamba == MambaSpec(d_state=8) and red.scan_chunk == 64
    assert get_config(ARCH).scan_chunk == 256 and get_config(ARCH).remat == "full"


def test_reset_parameters_fixed_leaves_equal_the_reference_init():
    """``a_log``, ``dt_bias`` (``np.random.default_rng(0)``), ``d_skip``
    (ones) and ``conv_b`` (zeros) from ``reset_parameters`` bit-equal to
    the reference's init at the reduced width, and the init functions
    behind them at the published d_inner of 8,192; the other Mamba
    matrices follow the fan-in law."""
    cfg_t, _, tree, *_ = carried()
    model = GCLM(cfg_t, device="cpu", seed=3)
    fixed = ("a_log", "dt_bias", "d_skip", "conv_b")
    seen = 0
    for path, t in model.leaf_items():
        if path[-1] in fixed:
            want = tree["stack"][int(path[1])]["mixer"][path[-1]]
            np.testing.assert_array_equal(t.detach().numpy(), want, err_msg=".".join(path))
            seen += 1
    assert seen == 4 * 7
    cfg_full = jax_get_config(ARCH)
    # jit keeps only the small leaves: the full-width matrices are never drawn
    want = jax.jit(lambda k: {n: v.value for n, v in jssm.init_mamba(cfg_full, k, None).items()
                              if n in fixed})(jax.random.PRNGKey(0))
    full = get_config(ARCH)
    assert want["dt_bias"].shape == (8192,) and want["a_log"].shape == (8192, 16)
    np.testing.assert_array_equal(ssm.a_log_init(full), np.asarray(want["a_log"]))
    np.testing.assert_array_equal(ssm.dt_bias_init(full), np.asarray(want["dt_bias"]))
    np.testing.assert_array_equal(np.asarray(want["d_skip"]), 1.0)
    np.testing.assert_array_equal(np.asarray(want["conv_b"]), 0.0)
    mixer = model.stack[0].mixer
    for name, fan_in in (("in_proj", 128), ("conv_w", 4), ("x_proj", 256),
                         ("dt_proj", 8), ("out_proj", 256)):
        t = getattr(mixer, name).detach()
        std = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 * std * (1 + 1e-6), name
        if t.numel() >= 2048:
            assert abs(float(t.std()) / std - 0.8796) < 0.03, name  # truncated at +-2


# ---------------------------------------------------------- mixer alone
def _mixer_inputs(s, seed=4):
    cfg_t, cfg_j, tree, *_ = carried()
    p = dict(tree["stack"][0]["mixer"])
    rng = np.random.default_rng(seed)
    for name in ("conv_b", "d_skip"):  # the reference's init: zeros, ones
        p[name] = (p[name] + 0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    return cfg_t, cfg_j, p, x


@pytest.mark.parametrize("s", [40, 100, 200])
def test_mamba_mixer_fp32_matches_reference(s):
    """One Mamba mixer in training and prefill at 40 tokens (one chunk),
    100 (two chunks of 64, the tail padded) and 200 (four): outputs, the
    prefill state ``{conv, h, pos}`` and the gradients of x and of every
    leaf; then 4 decode steps from the reference's prefill state, the
    state written in place."""
    cfg_t, cfg_j, p, x = _mixer_inputs(s)
    assert cfg_t.scan_chunk == 64
    spec_t, spec_j = cfg_t.layers[0], cfg_j.layers[0]
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y_j, _ = jssm.mamba_forward(cfg_j, pj, jnp.asarray(x), spec_j)
    y_t, c_t = ssm.mamba_forward(cfg_t, pt, xt, spec_t)
    assert c_t is None
    _close(y_t.detach(), y_j, REL, "out")
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    g_j = jax.grad(lambda p_, x_: jnp.sum(jssm.mamba_forward(cfg_j, p_, x_, spec_j)[0] * cot),
                   argnums=(0, 1))(pj, jnp.asarray(x))
    grads = torch.autograd.grad((y_t * torch.from_numpy(cot)).sum(), [*pt.values(), xt])
    for name, g in zip([*pt, "x"], grads):
        _close(g, g_j[1] if name == "x" else g_j[0][name], REL, f"grad {name}")
        assert torch.count_nonzero(g) > 0, name

    with torch.no_grad():
        pt = {k: torch.tensor(v) for k, v in p.items()}
        _, cache_j = jssm.mamba_forward(cfg_j, pj, jnp.asarray(x), spec_j, mode="prefill")
        _, cache_t = ssm.mamba_forward(cfg_t, pt, torch.from_numpy(x), spec_t, mode="prefill")
        assert sorted(cache_t) == ["conv", "h", "pos"] and int(cache_t["pos"]) == s
        assert cache_t["h"].dtype == torch.float32
        for name in ("conv", "h"):
            _close(cache_t[name], cache_j[name], REL, f"prefill {name}")
        cache_t = {k: torch.tensor(np.asarray(v)) for k, v in cache_j.items()}
        held = dict(cache_t)
        steps = np.random.default_rng(5).standard_normal((4, 2, 1, cfg_t.d_model))
        for xs in steps.astype(np.float32):
            y_j, cache_j = jssm.mamba_forward(cfg_j, pj, jnp.asarray(xs), spec_j,
                                              mode="decode", cache=cache_j)
            y_t, out = ssm.mamba_forward(cfg_t, pt, torch.from_numpy(xs), spec_t,
                                         mode="decode", cache=cache_t)
            assert out is cache_t
            _close(y_t, y_j, REL, "decode out")
        for name in ("conv", "h"):
            assert cache_t[name] is held[name]  # written in place
            _close(held[name], cache_j[name], REL, f"decoded {name}")
        assert int(held["pos"]) == int(cache_j["pos"]) == s + 4


@pytest.mark.parametrize("s", [40, 100, 200])
def test_mamba_mixer_bf16_matches_reference(s):
    cfg_t, cfg_j, p, x = _mixer_inputs(s)
    cfg_t, cfg_j = cfg_t.replace(dtype="bfloat16"), cfg_j.replace(dtype="bfloat16")
    xj, xt = _as("bfloat16", x)
    for mode in ("train", "prefill"):
        y_j, c_j = jssm.mamba_forward(cfg_j, {k: jnp.asarray(v) for k, v in p.items()}, xj,
                                      cfg_j.layers[0], mode=mode)
        y_t, c_t = ssm.mamba_forward(cfg_t, {k: torch.tensor(v) for k, v in p.items()}, xt,
                                     cfg_t.layers[0], mode=mode)
        assert y_t.dtype == torch.bfloat16
        err = _close(y_t.float(), np.asarray(y_j, np.float32), MIXER_BF16_REL, f"{mode} out")
        print(f"mamba mixer bf16, S={s} {mode}: {err:.3e} of the largest output")
        if mode == "prefill":
            assert c_t["conv"].dtype == torch.bfloat16 and c_t["h"].dtype == torch.float32
            _close(c_t["h"], c_j["h"], MIXER_BF16_REL, "prefill h")


# -------------------------------------------------------------- the model
def _reference_routes(monkeypatch):
    """Record the reference's expert indices, one array per MoE layer call."""
    from repro.models import moe as jmoe

    want, j_top = [], jmoe._top_k

    def j_rec(x, k):  # traced: a host callback
        out = j_top(x, k)
        jax.debug.callback(lambda i: want.append(np.asarray(i)), out[1], ordered=True)
        return out

    monkeypatch.setattr(jmoe, "_top_k", j_rec)
    return want


def _follow_routes(monkeypatch, want):
    """Make the port's MoE calls take the reference's expert indices, in
    call order, and record the share of tokens whose own top-k agreed."""
    from repro_torch.models import moe

    agree, t_top, routes = [], moe.top_k, iter(want)

    def forced(x, k):
        _, idx = t_top(x, k)
        ref = torch.from_numpy(next(routes).astype(np.int64))
        agree.append(float((idx == ref).all(-1).float().mean()))
        return torch.gather(x, -1, ref), ref

    monkeypatch.setattr(moe, "top_k", forced)
    return agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_every_leaf_gradient_match_jax(dtype, monkeypatch):
    """Logits, ``loss``, ``xent`` and ``aux`` and the gradient of every one
    of the 114 leaves at 100 tokens (the scans: two chunks of 64).
    Routing is compared first: in fp32 every token's experts are the
    reference's; in bf16 the port takes the reference's indices (at least
    90% of them its own: 95-99% per layer measured, the seven Mamba layers
    of rounding ahead of the routers flipping near-ties) and the numbers
    are compared on equal routes."""
    cfg_t, cfg_j, _, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens = _tokens(cfg_t, seq=100)
    logit_rel, grad_rel, loss_rel = (REL, REL, REL) if dtype == "float32" else \
        (BF16_REL, BF16_GRAD_REL, BF16_LOSS_REL)
    want = _reference_routes(monkeypatch)
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    jax.effects_barrier()
    assert len(want) == 4  # the four MoE layers
    agree = _follow_routes(monkeypatch, want)
    loss_t, metrics_t = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert len(agree) == 4 and min(agree) >= (1.0 if dtype == "float32" else 0.9), agree
    assert sorted(metrics_t) == sorted(metrics_j) == ["aux", "loss", "xent"]
    for key in metrics_t:
        want_v = float(metrics_j[key])
        assert abs(metrics_t[key].item() - want_v) <= loss_rel * abs(want_v), key
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j),
                              strict=True):
        assert g_t.dtype == torch.float32
        _close(g_t, g_j, grad_rel, path)
        if path.endswith(("in_proj", "x_proj", "dt_proj", "out_proj", "a_log", "router")):
            assert torch.count_nonzero(g_t) > 0, path
    if dtype == "float32":
        logits_j = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
        with torch.no_grad():
            logits_t = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))[0]
        _close(logits_t, logits_j, logit_rel, "logits")


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gradients_bit_equal(remat):
    cfg_t, *_, model = carried()
    tokens = _tokens(cfg_t, seq=100)

    def grads(cfg):
        loss, _ = train_loss(cfg, model, {"tokens": tokens})
        return loss, torch.autograd.grad(loss, model.leaves())

    loss0, g0 = grads(cfg_t)
    loss1, g1 = grads(cfg_t.replace(remat=remat))
    assert torch.equal(loss0, loss1)
    for path, a, b in zip(model.leaf_paths(), g0, g1):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("n_layers", [8, 16])
def test_prefill_and_decode_from_reference_caches(n_layers):
    """The reference's prefill (70 tokens of 2 rows: two scan chunks)
    against the port's, then 8 decode steps of both packages from the
    reference's caches: logits, and every cache leaf — attention K/V at
    ``pos % cap``, Mamba's ``conv`` and fp32 ``h`` — written in place into
    the stacked tensors the port was handed (8 layers: eight runs; 16:
    a pattern of 8 over 2 repeats, with per-row ``pos``, the slab's
    layout)."""
    cfg_t, cfg_j, _, jparams, model = carried(n_layers)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(2, 78))
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :70]), target_len=80)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :70]), target_len=80)
    _close(logits_t, logits_j, REL, "prefill logits")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        _close(g, w, REL, "prefill cache")
    want = jax.tree.map(np.asarray, caches_j)
    if n_layers == 16:
        assert isinstance(plan_segments(cfg_t.layers)[0], Pattern)
        rows = np.array([0, -7], np.int32)  # row 1 seven tokens behind, as a slot may be
        want = [[{k: (v[..., None] + rows if k == "pos" else v) for k, v in tree.items()}
                 for tree in seg] for seg in want]
        assert want[0][0]["h"].shape == (2, 2, 256, 8) and want[0][0]["pos"].shape == (2, 2)
        assert want[0][4]["k"].shape == (2, 2, 80, 2, 32)
    else:
        assert want[0]["conv"].shape == (2, 3, 256) and want[4]["k"].shape == (2, 80, 2, 32)
    caches_j = jax.tree.map(jnp.asarray, want)
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    held = [t for t in jax.tree.leaves(caches_t)]
    for t in range(70, 78):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]))
        logits_t, out = decode_step(cfg_t, model, caches_t, torch.from_numpy(toks[:, t:t + 1]))
        assert out is caches_t
        _close(logits_t, logits_j, REL, f"decode logits at {t}")
    assert all(a is b for a, b in zip(held, jax.tree.leaves(caches_t), strict=True))
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, REL, "decoded cache")


# -------------------------------------------------------------- training
def test_coded_grads_equal_uncoded_and_the_reference_coded():
    cfg_t, cfg_j, tree, jparams, model = carried()
    plan_t = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    plan_j = JPlan.build(jparams, JShiftedExp(**SE), N, scheme="xf")
    assert plan_t.to_dict() == plan_j.to_dict()
    data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, N, plan_t.s_max)
    shards = np.stack([data.shard(0, i, N) for i in range(N)])
    g_unc = uncoded_grad_fn(cfg_t, N)(model, shards)
    ours = make_coded_grad_fn(cfg_t, plan_t)
    theirs = jax.jit(jax_coded_grad_fn(cfg_j, plan_j, mode="sim", pipeline="flat"))
    for u in range(plan_t.s_max + 1):
        times = np.ones(N)
        times[:u] = 1e6
        dec_w = plan_t.decode_weights(times).astype(np.float32)
        g_t = ours(model, wb, dec_w)
        g_j = jax.tree.leaves(theirs(jparams, jnp.asarray(wb), jnp.asarray(dec_w)))
        for path, a, b, c in zip(model.leaf_paths(), g_t, g_unc, g_j, strict=True):
            _close(a, b, 1e-4, f"coded vs uncoded, {u} stragglers, {path}")
            _close(a, c, REL, f"coded vs the reference's, {u} stragglers, {path}")


# -------------------------------------------------------------- serving
ENGINE = dict(n_slots=3, max_len=48, prompt_len=20, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_engine_run_matches_reference():
    """One fp32-slab engine run of each package, 5 requests in 3 slots (two
    slots reused after a finished request): equal tokens, slots and
    timestamps; the slab holds each Mamba layer's fixed state per slot
    and the attention layer's K/V."""
    cfg_t, cfg_j, _, jparams, model = carried()
    jenv = JEnv.iid(JShiftedExp(**SE), 6)
    env = Env.iid(ShiftedExponential(**SE), 6)
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, cfg_t.vocab, size=ENGINE["prompt_len"]).astype(np.int32)
               for _ in ENGINE["news"]]
    times = np.cumsum(np.random.default_rng(0).exponential(1 / ENGINE["rate"],
                                                           len(prompts)))
    out = {}
    for name in ("port", "ref"):
        if name == "port":
            eng = ServeEngine(cfg_t, model, ServeConfig(ENGINE["n_slots"], ENGINE["max_len"],
                                                        torch.float32),
                              coded=CodedDecode.solve(env, budget=4, seed=0), device="cpu")
        else:
            eng = JServeEngine(cfg_j, jparams, JServeConfig(ENGINE["n_slots"],
                                                            ENGINE["max_len"], jnp.float32),
                               coded=JCodedDecode.solve(jenv, budget=4, seed=0))
        reqs = [eng.submit(p, max_new=n, arrival=float(t))
                for p, n, t in zip(prompts, ENGINE["news"], times)]
        slots = []
        while eng.step():
            slots.append([(i, r.slot) for i, r in enumerate(reqs) if r.slot is not None])
        out[name] = (eng, reqs, slots)
    (eng, reqs, slots), (jeng, jreqs, jslots) = out["port"], out["ref"]
    assert slots == jslots
    assert len({r.slot for r in reqs}) < len(reqs)  # a slot served twice
    assert all(r.done for r in reqs) and len(eng.finished) == len(reqs)
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        for field in ("t_admit", "t_first", "t_done", "n_steps", "slot", "state"):
            assert getattr(r, field) == getattr(jr, field), field
    assert eng.step_latencies == jeng.step_latencies
    assert eng.now == jeng.now
    assert sorted(eng.slab[0]) == ["conv", "h", "pos"] and sorted(eng.slab[4]) == ["k", "pos", "v"]
    assert tuple(eng.slab[0]["h"].shape) == (ENGINE["n_slots"], 256, 8)


def test_a_slot_s_history_does_not_leak_into_the_next_request():
    """A finished slot's Mamba state goes on being advanced by the batched
    decode step until the next admission overwrites ``conv``, ``h`` and
    ``pos``: a request admitted into a used slot of a bf16 slab emits the
    tokens it emits in a fresh engine."""
    cfg_t, *_, model = carried()
    rng = np.random.default_rng(3)
    first, second, other = (rng.integers(0, cfg_t.vocab, size=12) for _ in range(3))

    def run(prompts, news, arrivals):
        eng = ServeEngine(cfg_t, model, ServeConfig(2, 40), device="cpu")
        reqs = [eng.submit(p, max_new=n, arrival=a) for p, n, a in zip(prompts, news, arrivals)]
        eng.run()
        assert all(r.done for r in reqs)
        return reqs

    busy = run([first, other, second], [3, 20, 6], [0.0, 0.0, 5.0])
    assert busy[2].slot == busy[0].slot and busy[2].t_admit > busy[0].t_done
    alone = run([second], [6], [0.0])
    assert busy[2].tokens == alone[0].tokens


def test_slab_of_the_cut_config_holds_fixed_state_for_mamba():
    """At published widths, 8 layers: the attention layer's K/V take
    2·8·128 values per token and slot (4,096 bytes in bf16); each of the
    seven Mamba layers holds a fixed state per slot — conv 3·8,192 in the
    slab's dtype and h 8,192·16 in fp32."""
    cfg = get_config(ARCH)
    cfg = cfg.replace(n_layers=8, layers=cfg.layers[:8])
    slab = make_slab(cfg, 2, 16, device="meta")
    assert [sorted(seg) for seg in slab] == [["conv", "h", "pos"]] * 4 + [["k", "pos", "v"]] + \
        [["conv", "h", "pos"]] * 3
    assert slab[0]["h"].dtype == torch.float32 and slab[0]["conv"].dtype == torch.bfloat16
    per_token = sum(t.element_size() * t[0, 0].numel() for seg in slab
                    for k, t in seg.items() if k in ("k", "v"))
    per_slot = sum(t.element_size() * t[0].numel() for seg in slab
                   for k, t in seg.items() if k in ("conv", "h"))
    assert per_token == 2 * 8 * 128 * 2 == 4096
    assert per_slot == 7 * (3 * 8192 * 2 + 8192 * 16 * 4) == 4_014_080


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_jamba_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")


def test_train_launcher_runs_jamba_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and out.count("\nstep ") == 2
