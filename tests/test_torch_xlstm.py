"""The port's xLSTM — the mLSTM and sLSTM mixers (``models/xlstm.py``) in
a stack of layers without an FFN sublayer — against the JAX reference,
on the CPU.

The model is ``xlstm-1.3b.reduced(n_layers=8, d_model=128, seq_cap=64)``:
one period of the published layout — seven mLSTM layers (d_inner 256 over
4 heads of 64, conv 4) and an sLSTM layer at offset 7 (4 heads of 32,
post-up 171) — a run of 7 and a run of 1, 22 leaves, tied embeddings, no
RoPE, the mLSTM in chunks of 64.  ``n_layers=16`` makes one pattern of 8
over 2 repeats.  The reference's initialized weights are carried with
``params_from_numpy`` and its caches with ``caches_from_numpy``.  At
these inputs |n·q| < 1 at every mLSTM position, so the output depends on
exp(-m) and the stabilizer's gradient is exercised.

Tolerances:

* fp32, one mixer — outputs, prefill states, decode steps and gradients:
  ``REL`` = 1e-5 of each tensor's largest entry (the same fp32 math; the
  mLSTM's chunkwise form sums in another order than the reference's
  token-by-token scan); the fixed-value leaves of the init: bit-equal;
* fp32, the stack — logits, caches and every leaf's gradient:
  ``STACK_REL`` = 3e-4, the loss ``REL``.  At this random init each mLSTM
  layer's group norm lifts a small h to unit scale, so the stack
  amplifies rounding: ``test_the_stack_amplifies_rounding`` measures a
  1e-7 relative perturbation of the embedding moving the logits by ~1e-5,
  and the reference's own token-by-token recurrence, transcribed to
  torch, landing as far from JAX's logits as the chunkwise form does
  (measured worst: gradients 8.3e-5 at 8 layers, logits 6.2e-5 at 16);
* ``b_i``'s gradient is zero in exact arithmetic — a shift of every
  log_i of a head scales C, n and e^m alike, so h does not move — and
  both packages return rounding noise: each is held at the bound times
  the largest gradient of the same layer's ``b_f`` (a per-head sum over
  the same tokens);
* bf16 activations — the mixers ``MIXER_BF16_REL`` = 2e-2 of the largest
  output (the Jamba mixer's bound; the recurrences are fp32, the
  projections, the conv and the group norm's output round at bf16); the
  model's loss ``BF16_LOSS_REL`` = 1e-3 relative.  Its gradients move
  with bf16 rounding itself (the reference's bf16 gradients lie up to
  1.21 of a leaf's largest from its own fp32 ones), so each leaf's bf16
  gradient is held within ``BF16_GRAD_RATIO`` = 2 times the reference's
  bf16 distance from the reference's fp32 gradient (measured ≤ 1.23);
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), against the reference's coded: ``STACK_REL``;
* the engine's tokens, slots and timestamps, the slab after inserts:
  equal.
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
from repro.models import xlstm as jxlstm
from repro.models.blocks import _xlstm_spec as j_xlstm_spec
from repro.models.params import count_params as jax_count_params
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import insert_request as j_insert_request
from repro.serve import make_slab as j_make_slab
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro_torch.configs import XLSTMSpec, get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import xlstm
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.models.stack import Pattern, Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy, insert_request, make_slab)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn

ARCH = "xlstm-1.3b"
KW = dict(n_layers=8, d_model=128, seq_cap=64)
REL = 1e-5
STACK_REL = 3e-4
MIXER_BF16_REL = 2e-2
BF16_GRAD_RATIO = 2.0
BF16_LOSS_REL = 1e-3
N = 4
SE = dict(mu=1e-3, t0=50.0)
MLSTM_LEAVES = ("b_f", "b_i", "conv_b", "conv_w", "down", "gn_scale", "up", "w_if", "wk",
                "wq", "wv")
SLSTM_LEAVES = ("b_gates", "down", "gn_scale", "r_gates", "up1", "up2", "w_gates")
FORWARD = {"mlstm": (xlstm.mlstm_forward, jxlstm.mlstm_forward),
           "slstm": (xlstm.slstm_forward, jxlstm.slstm_forward)}


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


def _grads_close(paths, got, want, rel, what=""):
    """``_close`` per leaf; ``b_i`` (zero in exact arithmetic) held on both
    sides at ``rel`` of the largest gradient of its layer's ``b_f``."""
    got, want = dict(zip(paths, got, strict=True)), dict(zip(paths, want, strict=True))
    for path in paths:
        if path.endswith("b_i"):
            scale = float(np.abs(np.asarray(want[path[:-1] + "f"])).max())
            for g in (got[path], want[path]):
                assert float(np.abs(np.asarray(g)).max()) <= rel * scale, f"{what} {path}"
        else:
            _close(got[path], want[path], rel, f"{what} {path}")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


_CARRIED = {}


def carried(n_layers=8):
    """(cfg_t, cfg_j, numpy tree, jax params, model) of reduced xLSTM,
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
@pytest.mark.parametrize("size", ["full", "reduced", "reduced16"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    """Leaf paths, order and shapes on meta at full width (48 layers: one
    pattern of 8 over 6 repeats, 94 leaves, 1,917,544,784 parameters) and
    reduced to 8 layers (a run of 7 mLSTM and one sLSTM layer, 22 leaves)
    and 16 (a pattern of 8 over 2 repeats)."""
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    if size != "full":
        n = 16 if size == "reduced16" else 8
        cfg_t, cfg_j = cfg_t.reduced(n_layers=n), cfg_j.reduced(n_layers=n)
    model = GCLM(cfg_t, device="meta")
    params_j = j_abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert len(paths) == (22 if size == "reduced" else 94)
    assert paths[:2] == ["embed.tok", "final_norm.scale"]
    first, last = ("stack.0", "stack.1") if size == "reduced" else ("stack.0.0", "stack.0.7")
    assert [p for p in paths if p.startswith(f"{first}.")] == \
        [f"{first}.mixer.{n}" for n in MLSTM_LEAVES] + [f"{first}.norm_mix.scale"]
    assert [p for p in paths if p.startswith(f"{last}.")] == \
        [f"{last}.mixer.{n}" for n in SLSTM_LEAVES] + [f"{last}.norm_mix.scale"]
    assert not any("ffn" in p for p in paths)
    segs = plan_segments(cfg_t.layers)
    if size == "reduced":
        assert segs == [Run(cfg_t.layers[0], 7, 0), Run(cfg_t.layers[7], 1, 7)]
    else:
        assert segs == [Pattern(cfg_t.layers[:8], 6 if size == "full" else 2, 0)]
    n = sum(int(np.prod(s)) for s in shapes)
    assert n == jax_count_params(params_j)
    if size == "full":
        assert n == 1_917_544_784, n
        assert tuple(model.stack[0][0].mixer.wq.shape) == (6, 4, 1024, 1024)
        assert tuple(model.stack[0][7].mixer.up1.shape) == (6, 2048, 2731)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
                      (get_config(ARCH).reduced(n_layers=16), jax_get_config(ARCH).reduced(
                          n_layers=16)),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe, lt.use_ffn, lt.cross_source)
                        for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe, lj.use_ffn, lj.cross_source) for lj in value]
            elif f.name == "xlstm_blocks":
                assert [dataclasses.asdict(s) for s in getattr(got, f.name)] == \
                    [dataclasses.asdict(s) for s in value]
            elif f.name in ("mla", "mamba") and value is not None:
                assert dataclasses.asdict(getattr(got, f.name)) == dataclasses.asdict(value)
            else:
                assert getattr(got, f.name) == value, f.name
    full, red = get_config(ARCH), get_config(ARCH).reduced(n_layers=8)
    assert full.xlstm_blocks == (XLSTMSpec("mlstm", 2.0, 4), XLSTMSpec("slstm", 4.0 / 3.0, 4))
    assert red.xlstm_blocks == full.xlstm_blocks and red.scan_chunk == 64
    assert full.scan_chunk == 256 and full.remat == "dots" and full.dtype == "bfloat16"
    assert [s.mixer for s in full.layers] == (["mlstm"] * 7 + ["slstm"]) * 6
    assert not any(s.use_ffn for s in full.layers) and full.d_ff == 0


def test_reset_parameters_fixed_leaves_equal_the_reference_init():
    """``b_f`` (3), ``b_i`` and ``conv_b`` (zeros), ``gn_scale`` (ones) and
    ``b_gates`` (0 / 3 / 0 / 0) from ``reset_parameters`` bit-equal to the
    reference's init; the matrices follow the fan-in law (``conv_w`` and
    ``r_gates`` at the reference's ``scale=1.0``, the default)."""
    cfg_t, _, tree, *_ = carried()
    model = GCLM(cfg_t, device="cpu", seed=3)
    fixed = ("b_f", "b_i", "conv_b", "gn_scale", "b_gates")
    seen = 0
    for path, t in model.leaf_items():
        if path[-1] in fixed:
            want = tree["stack"][int(path[1])]["mixer"][path[-1]]
            np.testing.assert_array_equal(t.detach().numpy(), want, err_msg=".".join(path))
            seen += 1
    assert seen == 6  # four mLSTM leaves (a run of 7), two sLSTM leaves
    np.testing.assert_array_equal(tree["stack"][1]["mixer"]["b_gates"][128:256], 3.0)
    for node, name, fan_in in ((model.stack[0], "conv_w", 4), (model.stack[0], "wq", 256),
                               (model.stack[0], "up", 128), (model.stack[1], "r_gates", 128),
                               (model.stack[1], "w_gates", 128), (model.stack[1], "down", 171)):
        t = getattr(node.mixer, name).detach()
        std = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 * std * (1 + 1e-6), name
        assert abs(float(t.std()) / std - 0.8796) < 0.05, name  # truncated at +-2


# ---------------------------------------------------------- mixers alone
def _mixer_inputs(kind, s, seed=4):
    """The reference's reduced weights of one mixer (layer 0 of the mLSTM
    run, or the sLSTM layer), with the zero and one biases and scales
    moved off their init, and seeded normal inputs (B = 2)."""
    cfg_t, cfg_j, tree, *_ = carried()
    if kind == "mlstm":
        p = {k: v[0] for k, v in tree["stack"][0]["mixer"].items()}
        moved = ("b_i", "conv_b", "gn_scale")
    else:
        p = dict(tree["stack"][1]["mixer"])
        moved = ("gn_scale",)
    rng = np.random.default_rng(seed)
    for name in moved:
        p[name] = (p[name] + 0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    spec = cfg_t.layers[0 if kind == "mlstm" else 7]
    spec_j = cfg_j.layers[0 if kind == "mlstm" else 7]
    return cfg_t, cfg_j, spec, spec_j, p, x


def _ref(kind, cfg_j, spec_j):
    """The reference's mixer with its spec bound."""
    fn = FORWARD[kind][1]
    return lambda p, x, **kw: fn(cfg_j, p, x, spec_j, j_xlstm_spec(cfg_j, kind), **kw)


@pytest.mark.parametrize("s", [160, 64])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_fp32_matches_reference(kind, s):
    """One mixer in training and prefill at 160 tokens (mLSTM: chunks of
    64, 64 and a 32-token tail) and 64 (one chunk): outputs, the gradients
    of x and of every leaf, the prefill state; then 4 decode steps from
    the reference's prefill state, every leaf written in place."""
    cfg_t, cfg_j, spec_t, spec_j, p, x = _mixer_inputs(kind, s)
    ours, ref = FORWARD[kind][0], _ref(kind, cfg_j, spec_j)
    assert cfg_t.scan_chunk == 64
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt = torch.tensor(x, requires_grad=True)
    y_j, _ = ref(pj, jnp.asarray(x))
    y_t, c_t = ours(cfg_t, pt, xt, spec_t)
    assert c_t is None
    _close(y_t.detach(), y_j, REL, "out")
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    g_j = jax.grad(lambda p_, x_: jnp.sum(ref(p_, x_)[0] * cot), argnums=(0, 1))(
        pj, jnp.asarray(x))
    grads = torch.autograd.grad((y_t * torch.from_numpy(cot)).sum(), [*pt.values(), xt])
    _grads_close([*pt, "x"], grads, [*(g_j[0][n] for n in pt), g_j[1]], REL, "grad")
    assert all(torch.count_nonzero(g) > 0 for g in grads)

    state = ("C", "conv", "m", "n") if kind == "mlstm" else ("c", "h", "m", "n")
    with torch.no_grad():
        pt = {k: torch.tensor(v) for k, v in p.items()}
        _, cache_j = ref(pj, jnp.asarray(x), mode="prefill")
        _, cache_t = ours(cfg_t, pt, torch.from_numpy(x), spec_t, mode="prefill")
        assert sorted(cache_t) == sorted(cache_j) == sorted(state + ("pos",))
        assert int(cache_t["pos"]) == s
        for name in state:
            assert cache_t[name].dtype == torch.float32
            _close(cache_t[name], cache_j[name], REL, f"prefill {name}")
        cache_t = {k: torch.tensor(np.asarray(v)) for k, v in cache_j.items()}
        held = dict(cache_t)
        steps = np.random.default_rng(5).standard_normal((4, 2, 1, cfg_t.d_model))
        for xs in steps.astype(np.float32):
            y_j, cache_j = ref(pj, jnp.asarray(xs), mode="decode", cache=cache_j)
            y_t, out = ours(cfg_t, pt, torch.from_numpy(xs), spec_t, mode="decode",
                            cache=cache_t)
            assert out is cache_t
            _close(y_t, y_j, REL, "decode out")
        for name in state:
            assert cache_t[name] is held[name]  # written in place
            _close(held[name], cache_j[name], REL, f"decoded {name}")
        assert int(held["pos"]) == int(cache_j["pos"]) == s + 4


@pytest.mark.parametrize("s", [160, 64])
@pytest.mark.parametrize("kind", ["mlstm", "slstm"])
def test_mixer_bf16_matches_reference(kind, s):
    cfg_t, cfg_j, spec_t, spec_j, p, x = _mixer_inputs(kind, s)
    cfg_t, cfg_j = cfg_t.replace(dtype="bfloat16"), cfg_j.replace(dtype="bfloat16")
    ref = _ref(kind, cfg_j, spec_j)
    xj, xt = _as("bfloat16", x)
    for mode in ("train", "prefill"):
        y_j, c_j = ref({k: jnp.asarray(v) for k, v in p.items()}, xj, mode=mode)
        y_t, c_t = FORWARD[kind][0](cfg_t, {k: torch.tensor(v) for k, v in p.items()}, xt,
                                    spec_t, mode=mode)
        assert y_t.dtype == torch.bfloat16
        err = _close(y_t.float(), np.asarray(y_j, np.float32), MIXER_BF16_REL, f"{mode} out")
        print(f"{kind} mixer bf16, S={s} {mode}: {err:.3e} of the largest output")
        if mode == "prefill":
            for name, t in c_t.items():
                assert t.dtype == (torch.bfloat16 if name == "conv" else
                                   torch.int32 if name == "pos" else torch.float32), name
                if name not in ("conv", "pos"):
                    _close(t, c_j[name], MIXER_BF16_REL, f"prefill {name}")


# -------------------------------------------------------------- the model
def _model_grads(cfg_t, cfg_j, jparams, model, tokens):
    (_, metrics_j), grads_j = jax.value_and_grad(
        lambda p: jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    loss_t, metrics_t = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    return metrics_t, grads_t, metrics_j, [np.asarray(g) for g in jax.tree.leaves(grads_j)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_every_leaf_gradient_match_jax(dtype):
    """``loss`` and ``xent`` and the gradient of every one of the 22
    leaves at 100 tokens (the mLSTM: chunks of 64 and 36); in fp32 the
    logits too.  bf16 gradients against the reference's fp32 ones, beside
    the reference's own bf16 gradients."""
    cfg_t, cfg_j, _, jparams, model = carried()
    tokens = _tokens(cfg_t, seq=100)
    paths = model.leaf_paths()
    metrics_t, grads_t, metrics_j, grads_j = _model_grads(
        cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype), jparams, model, tokens)
    assert sorted(metrics_t) == sorted(metrics_j) == ["aux", "loss", "xent"]
    assert float(metrics_t["aux"]) == float(metrics_j["aux"]) == 0.0
    loss_rel = REL if dtype == "float32" else BF16_LOSS_REL
    for key in ("loss", "xent"):
        want_v = float(metrics_j[key])
        assert abs(metrics_t[key].item() - want_v) <= loss_rel * abs(want_v), key
    assert all(g.dtype == torch.float32 and torch.count_nonzero(g) > 0 for g in grads_t)
    if dtype == "float32":
        _grads_close(paths, grads_t, grads_j, STACK_REL)
        logits_j = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
        with torch.no_grad():
            logits_t = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))[0]
        _close(logits_t, logits_j, STACK_REL, "logits")
        return
    *_, fp32_j = _model_grads(cfg_t, cfg_j, jparams, model, tokens)
    worst = 0.0
    for path, g_t, g_j, g_f in zip(paths, grads_t, grads_j, fp32_j, strict=True):
        if path.endswith("b_i"):
            continue
        ours = _close(g_t, g_f, np.inf)
        theirs = _close(g_j, g_f, np.inf)
        assert ours <= BF16_GRAD_RATIO * theirs, (path, ours, theirs)
        worst = max(worst, ours / theirs)
    print(f"bf16 gradients: the port's distance from the reference's fp32 gradient at most "
          f"{worst:.3f} times the reference's own bf16 distance")


def _per_token(cfg, q, k, v, log_i, log_f, need_state):
    """The reference's token-by-token mLSTM recurrence in torch."""
    b, _, nh, dh = q.shape
    state = {"C": q.new_zeros((b, nh, dh, dh)), "n": q.new_zeros((b, nh, dh)),
             "m": q.new_full((b, nh), -1e30)}
    hs = []
    for t in range(q.shape[1]):
        hs.append(xlstm._mlstm_step(state, q[:, t], k[:, t], v[:, t], log_i[:, t], log_f[:, t]))
    return torch.stack(hs, 1), (state["C"], state["n"], state["m"])


@torch.no_grad()
def test_the_stack_amplifies_rounding(monkeypatch):
    """Why the stack is held at ``STACK_REL``: the port's logits move by
    more than 1e-6 of the largest under a 1e-7 relative perturbation of
    the embedding, and the reference's token-by-token recurrence in torch
    lands about as far from JAX's logits as the chunkwise form."""
    cfg_t, cfg_j, _, jparams, model = carried()
    tokens = torch.from_numpy(_tokens(cfg_t, seq=100)[:, :-1])
    want = np.asarray(jmodel.forward(cfg_j, jparams, jnp.asarray(tokens.numpy()))[0])
    chunked = forward(cfg_t, model, tokens)[0]
    tok = model.embed.tok.detach().clone()
    gen = torch.Generator().manual_seed(0)
    try:
        model.embed.tok.mul_(1 + 1e-7 * torch.randn(tok.shape, generator=gen))
        moved = _close(forward(cfg_t, model, tokens)[0], chunked, np.inf)
    finally:
        model.embed.tok.copy_(tok)
    monkeypatch.setattr(xlstm, "_mlstm_chunked", _per_token)
    per_token = _close(forward(cfg_t, model, tokens)[0], want, np.inf)
    ours = _close(chunked, want, np.inf)
    print(f"logits: 1e-7 perturbation moves them {moved:.3e}; against JAX's, the chunkwise "
          f"form {ours:.3e}, the token-by-token recurrence {per_token:.3e}")
    assert moved > 1e-6 and ours <= 1.5 * per_token


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
    """The reference's prefill (70 tokens of 2 rows: mLSTM chunks of 64
    and 6) against the port's, then 8 decode steps of both packages from
    the reference's caches: logits, and every state leaf — the mLSTM's
    ``C``, ``n``, ``m``, ``conv``, the sLSTM's ``h``, ``c``, ``n``, ``m`` —
    written in place into the stacked tensors the port was handed (8
    layers: a run of 7 and one; 16: a pattern of 8 over 2 repeats, with
    per-row ``pos``, the slab's layout)."""
    cfg_t, cfg_j, _, jparams, model = carried(n_layers)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(2, 78))
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :70]), target_len=80)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :70]), target_len=80)
    _close(logits_t, logits_j, STACK_REL, "prefill logits")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        _close(g, w, STACK_REL, "prefill cache")
    want = jax.tree.map(np.asarray, caches_j)
    if n_layers == 16:
        assert isinstance(plan_segments(cfg_t.layers)[0], Pattern)
        rows = np.array([0, -7], np.int32)  # row 1 seven tokens behind, as a slot may be
        want = [[{k: (v[..., None] + rows if k == "pos" else v) for k, v in tree.items()}
                 for tree in seg] for seg in want]
        assert want[0][0]["C"].shape == (2, 2, 4, 64, 64) and want[0][0]["pos"].shape == (2, 2)
        assert want[0][7]["h"].shape == (2, 2, 128)
    else:
        assert want[0]["C"].shape == (7, 2, 4, 64, 64) and want[0]["conv"].shape == (7, 2, 3, 256)
        assert want[1]["m"].shape == (2, 128)
    caches_j = jax.tree.map(jnp.asarray, want)
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    held = [t for t in jax.tree.leaves(caches_t)]
    for t in range(70, 78):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]))
        logits_t, out = decode_step(cfg_t, model, caches_t, torch.from_numpy(toks[:, t:t + 1]))
        assert out is caches_t
        _close(logits_t, logits_j, STACK_REL, f"decode logits at {t}")
    assert all(a is b for a, b in zip(held, jax.tree.leaves(caches_t), strict=True))
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, STACK_REL, "decoded cache")


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
        paths = model.leaf_paths()
        _grads_close(paths, g_t, g_unc, 1e-4, f"coded vs uncoded, {u} stragglers,")
        _grads_close(paths, g_t, g_j, STACK_REL, f"coded vs the reference's, {u} stragglers,")


# -------------------------------------------------------------- serving
ENGINE = dict(n_slots=3, max_len=48, prompt_len=20, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_engine_run_matches_reference():
    """One fp32-slab engine run of each package, 5 requests in 3 slots (two
    slots reused after a finished request): equal tokens, slots and
    timestamps; the slab holds each layer's fixed state per slot."""
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
    assert sorted(eng.slab[0]) == ["C", "conv", "m", "n", "pos"]
    assert sorted(eng.slab[1]) == ["c", "h", "m", "n", "pos"]
    assert tuple(eng.slab[0]["C"].shape) == (7, ENGINE["n_slots"], 4, 64, 64)


def test_a_slot_s_history_does_not_leak_into_the_next_request():
    """A finished slot's state goes on being advanced by the batched decode
    step until the next admission overwrites every leaf: a request
    admitted into a used slot of a bf16 slab emits the tokens it emits in
    a fresh engine."""
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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slab_insert_on_the_pattern_matches_reference(dtype):
    """16 layers (a pattern of 8 over 2 repeats, the caches of each
    position stacked over the repeats): two batch-1 prefills of different
    lengths inserted into slots 2 and 0 of a 3-slot slab, by both
    packages from the reference's prefill caches — every leaf equal,
    ``C``/``n``/``m`` and the sLSTM state fp32 also in a bf16 slab."""
    cfg_t, cfg_j, _, jparams, _ = carried(16)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    slab_j = j_make_slab(cfg_j, 3, 32, dtype=jdt)
    slab_t = make_slab(cfg_t, 3, 32, dtype=tdt, device="cpu")
    held = jax.tree.leaves(slab_t)
    rng = np.random.default_rng(2)
    for slot, s in ((2, 11), (0, 19)):
        toks = jnp.asarray(rng.integers(0, cfg_t.vocab, size=(1, s)))
        _, pref = jmodel.prefill(cfg_j, jparams, toks, target_len=32)
        slab_j = j_insert_request(cfg_j, slab_j, pref, slot)
        assert insert_request(cfg_t, slab_t, caches_from_numpy(
            cfg_t, jax.tree.map(np.asarray, pref), device="cpu"), slot) is slab_t
    assert all(a is b for a, b in zip(held, jax.tree.leaves(slab_t), strict=True))
    mlstm, slstm = slab_t[0][0], slab_t[0][7]
    assert mlstm["C"].dtype == slstm["h"].dtype == torch.float32
    assert mlstm["conv"].dtype == tdt and tuple(mlstm["pos"].shape) == (2, 3)
    for g, w in zip(jax.tree.leaves(caches_to_numpy(slab_t)),
                    jax.tree.leaves(jax.tree.map(lambda a: np.asarray(a, np.float32)
                                                 if a.dtype != jnp.int32 else np.asarray(a),
                                                 slab_j)), strict=True):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(mlstm["pos"].numpy(), [[19, 0, 11]] * 2)


def test_slab_of_the_full_config_holds_a_fixed_state_per_slot():
    """At published widths, 48 layers: no K/V; each slot holds 42 mLSTM
    states (C 4·1024·1024, n 4·1024, m 4 in fp32, conv 3·4,096 in the
    slab's dtype) and 6 sLSTM states (4·2,048 fp32), whatever the
    length."""
    slab = make_slab(get_config(ARCH), 2, 16, device="meta")
    (seg,) = slab
    assert [sorted(t) for t in seg] == [["C", "conv", "m", "n", "pos"]] * 7 + \
        [["c", "h", "m", "n", "pos"]]
    assert seg[0]["C"].dtype == torch.float32 and seg[0]["conv"].dtype == torch.bfloat16
    per_slot = sum(t.element_size() * t[:, 0].numel() for tree in seg
                   for k, t in tree.items() if k != "pos")
    mlstm = 4 * 1024 * 1024 * 4 + 4 * 1024 * 4 + 4 * 4 + 3 * 4096 * 2
    assert per_slot == 42 * mlstm + 6 * 4 * 2048 * 4 == 706_560_672


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_xlstm_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")


def test_train_launcher_runs_xlstm_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and out.count("\nstep ") == 2
