"""The port's Gemma family against the JAX reference, on the CPU.

gemma-2b (2 layers: one run), gemma2-27b (4 layers: one Pattern of
local/global, p = 2) and gemma3-27b (14 layers: a Pattern of 5 local + 1
global, p = 6, over 2 repeats, and a tail run of 2 local layers), each
``reduced(n_layers=…, d_model=128, seq_cap=64)`` so that the windows
are 32; the reference's initialized weights are carried across with
``params_from_numpy`` and its caches with ``caches_from_numpy``.

Tolerances:

* fp32 — logits, loss, every leaf's gradient, prefill and decode logits
  and caches — 1e-5 of each tensor's largest entry, as
  ``tests/test_torch_model.py`` holds gc-lm-110m: the same fp32 math
  with sums in another order;
* bf16 activations (the configs' own dtype): the reference runs XLA on
  the CPU, which may keep fp32 between fused elementwise ops, while torch
  rounds every op's output to bf16; the gap grows with depth.  Measured
  (worst of the three archs, gemma3's 14 layers): logits 3.19e-2 of the
  largest, gradients 5.82e-2 of each leaf's largest entry, loss 1.1e-4
  relative; the bounds are ``BF16_LOGITS_REL`` = 5e-2,
  ``BF16_GRAD_REL`` = 1e-1, ``BF16_LOSS_REL`` = 1e-3;
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), the port's coded against the reference's: 1e-5;
* plan JSON, the trainer's ledger and the engine's tokens, slots and
  timestamps: equal.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.params import count_params as jax_count_params
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state, init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.kernels import _pipe, gc_fused
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, layers
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.models.stack import Pattern, Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.trainer import TrainConfig, Trainer

REL = 1e-5
BF16_LOGITS_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
#: the reduced depth of each arch and its segmenting
DEPTH = {"gemma-2b": 2, "gemma2-27b": 4, "gemma3-27b": 14}
SEGMENTS = {"gemma-2b": ["Run(2)"], "gemma2-27b": ["Pattern(2x2)"],
            "gemma3-27b": ["Pattern(6x2)", "Run(2)"]}
ARCHS = tuple(DEPTH)
N = 4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small tensors and many steps: one intra-op thread keeps torch's
    pool from spinning on cores other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _kw(arch):
    return dict(n_layers=DEPTH[arch], d_model=128, seq_cap=64)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


_CARRIED = {}


def carried(arch):
    """(cfg_t, cfg_j, numpy tree, jax params, model) of the reduced arch,
    built once per module."""
    if arch not in _CARRIED:
        cfg_t, cfg_j = get_config(arch).reduced(**_kw(arch)), \
            jax_get_config(arch).reduced(**_kw(arch))
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, state.params)
        model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
        _CARRIED[arch] = (cfg_t, cfg_j, tree, jax.tree.map(jnp.asarray, tree), model)
    return _CARRIED[arch]


def _tokens(cfg, seq=48, batch=2, seed=1):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(0)


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_leaf_paths_shapes_and_order_match_jax(arch, size):
    cfg_t, cfg_j = get_config(arch), jax_get_config(arch)
    if size == "reduced":
        cfg_t, cfg_j = cfg_t.reduced(**_kw(arch)), cfg_j.reduced(**_kw(arch))
    model = GCLM(cfg_t, device="meta")
    params_j = abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert sorted(n for n, _ in model.named_parameters()) == sorted(paths)
    segs = plan_segments(cfg_t.layers)
    if size == "reduced":
        assert [f"Run({s.count})" if isinstance(s, Run) else
                f"Pattern({len(s.specs)}x{s.repeats})" for s in segs] == SEGMENTS[arch]
    else:
        n = sum(int(np.prod(s)) for s in shapes)
        assert n == jax_count_params(params_j)
        # the reference's ranges (tests/test_configs.py)
        lo, hi = {"gemma-2b": (2e9, 3.5e9)}.get(arch, (24e9, 32e9))
        assert lo <= n <= hi, n
    if arch == "gemma3-27b":
        assert "stack.0.3.mixer.q_norm" in paths
        assert len(paths) == 93  # 6 x 13 pattern leaves, 13 of the tail, 2


@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_config_matches_reference(arch):
    cfg_t = get_config(arch).reduced(**_kw(arch))
    cfg_j = jax_get_config(arch).reduced(**_kw(arch))
    full_t, full_j = get_config(arch), jax_get_config(arch)
    for got, want in ((cfg_t, cfg_j), (full_t, full_j)):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe, lt.use_ffn, lt.cross_source)
                        for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe, lj.use_ffn, lj.cross_source)
                     for lj in value]
            else:
                assert getattr(got, f.name) == value, f.name
    assert {l.window for l in cfg_t.layers} <= {None, 32}


# -------------------------------------------------------------- numerics
def test_layer_primitives_match_jax():
    """The softcap, GeGLU's tanh gelu (not torch's default erf form), the
    QK-norm and the embedding scale rounded to the activations' dtype."""
    rng = np.random.default_rng(5)
    x = (20 * rng.standard_normal((2, 9, 128))).astype(np.float32)
    _close(layers.softcap(torch.from_numpy(x), 30.0), jlayers.softcap(jnp.asarray(x), 30.0),
           what="softcap")
    xt = torch.from_numpy(x)
    assert layers.softcap(xt, 0.0) is xt  # cap 0: off
    cfg_t = get_config("gemma-2b").reduced(**_kw("gemma-2b"))
    cfg_j = jax_get_config("gemma-2b").reduced(**_kw("gemma-2b"))
    p = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wi", (128, 512)), ("wg", (128, 512)), ("wo", (512, 128)))}
    xs = (x / 20).astype(np.float32)
    got = layers.apply_mlp(cfg_t, {n: torch.from_numpy(a) for n, a in p.items()},
                           torch.from_numpy(xs))
    _close(got, jlayers.apply_mlp(cfg_j, {n: jnp.asarray(a) for n, a in p.items()},
                                  jnp.asarray(xs)), what="geglu")
    erf = torch.einsum("bsf,fd->bsd", torch.nn.functional.gelu(
        torch.from_numpy(xs @ p["wg"])) * torch.from_numpy(xs @ p["wi"]),
        torch.from_numpy(p["wo"]))
    assert not torch.allclose(erf, got, rtol=0, atol=1e-7)  # the trap: another function
    xh = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(32)).astype(np.float32)
    _close(attention._rms_head(torch.from_numpy(xh), torch.from_numpy(scale)),
           jattn._rms_head(jnp.asarray(xh), jnp.asarray(scale)), what="qk-norm")
    tok = rng.standard_normal((64, 128)).astype(np.float32)
    ids = rng.integers(0, 64, size=(2, 5))
    for dt, jdt, d, factor in ((torch.bfloat16, jnp.bfloat16, 2048, 45.25),
                               (torch.bfloat16, jnp.bfloat16, 5376, 73.5),
                               (torch.float32, jnp.float32, 2048, None)):
        c_t = cfg_t.replace(d_model=d, dtype=str(dt).split(".")[-1])
        c_j = cfg_j.replace(d_model=d, dtype=str(dt).split(".")[-1])
        got = layers.embed_tokens(c_t, torch.from_numpy(tok), torch.from_numpy(ids))
        want = jlayers.embed_tokens(c_j, {"tok": jnp.asarray(tok)}, jnp.asarray(ids))
        assert got.dtype == dt
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
        if factor is not None:
            assert layers._embed_scale(d, dt) == factor


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_local_attention_matches_reference_over_several_chunks(cap):
    """Three query chunks of 16 (the last one ragged) against spans of a
    window of 20, GQA 4 over 2, with and without the score softcap."""
    cfg_t = get_config("gemma2-27b").reduced(**_kw("gemma2-27b")).replace(attn_chunk=16)
    cfg_j = jax_get_config("gemma2-27b").reduced(**_kw("gemma2-27b")).replace(attn_chunk=16)
    rng = np.random.default_rng(4)
    q, k, v = (3 * rng.standard_normal((2, 40, h, 32)).astype(np.float32) for h in (4, 2, 2))
    want = jattn.local_attention(cfg_j, *(jnp.asarray(a) for a in (q, k, v)), window=20,
                                 cap=cap)
    got = attention.local_attention(cfg_t, *(torch.from_numpy(a) for a in (q, k, v)),
                                    window=20, cap=cap)
    _close(got, want, what="local attention")
    glob = attention.chunked_attention(cfg_t, *(torch.from_numpy(a) for a in (q, k, v)),
                                       cap=cap)
    _close(glob, jattn.chunked_attention(cfg_j, *(jnp.asarray(a) for a in (q, k, v)),
                                         cap=cap), what="global attention")
    # the first 20 positions see their whole history: local == global there
    _close(got[:, :20], glob[:, :20], what="inside the window")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_every_leaf_gradient_match_jax(arch, dtype):
    cfg_t, cfg_j, _, jparams, model = carried(arch)
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens = _tokens(cfg_t)
    logit_rel, grad_rel, loss_rel = (REL, REL, REL) if dtype == "float32" else \
        (BF16_LOGITS_REL, BF16_GRAD_REL, BF16_LOSS_REL)

    def loss_fn(p):
        return jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)})[0]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jparams)
    logits_j = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
    with torch.no_grad():
        logits_t = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))[0]
    assert logits_t.dtype == getattr(torch, dtype)
    _close(logits_t.float(), logits_j, logit_rel, "logits")
    loss_t, _ = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert abs(loss_t.item() - float(loss_j)) <= loss_rel * abs(float(loss_j))
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j),
                              strict=True):
        assert g_t.dtype == torch.float32
        _close(g_t, g_j, grad_rel, path)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_ring_decode_match_jax(arch):
    """Prefill of 48 tokens, past the reduced window of 32 (local layers
    take ``local_attention`` and their ring caches of 32 are rolled),
    then 8 decode steps from the reference's caches: logits and caches —
    the rolled and wrapping rings included — match the reference's."""
    cfg_t, cfg_j, _, jparams, model = carried(arch)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab, size=(2, 56))
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :48]),
                                        target_len=56)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :48]), target_len=56)
    _close(logits_t, logits_j, what="prefill logits")
    want = jax.tree.map(np.asarray, caches_j)
    got = caches_to_numpy(caches_t)
    assert jax.tree.structure(got) == jax.tree.structure(want)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        _close(g, w, what="prefill cache")
    caps = {int(leaf.shape[-3]) for leaf in jax.tree.leaves(want) if leaf.ndim >= 4}
    assert caps == ({56} if arch == "gemma-2b" else {32, 56})
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    for t in range(48, 56):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]))
        logits_t, caches_t = decode_step(cfg_t, model, caches_t, torch.from_numpy(toks[:, t:t + 1]))
        _close(logits_t, logits_j, what=f"decode logits at {t}")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, what="decoded cache")


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_remat_gradients_bit_equal(arch, remat):
    cfg_t, *_, model = carried(arch)
    tokens = _tokens(cfg_t)

    def grads(cfg):
        loss, _ = train_loss(cfg, model, {"tokens": tokens})
        return loss, torch.autograd.grad(loss, model.leaves())

    loss0, g0 = grads(cfg_t)
    loss1, g1 = grads(cfg_t.replace(remat=remat))
    assert torch.equal(loss0, loss1)
    for path, a, b in zip(model.leaf_paths(), g0, g1):
        assert torch.equal(a, b), path


@pytest.mark.parametrize("arch", ARCHS)
def test_reset_parameters_zero_inits_what_the_reference_does(arch):
    """Norm scales (``scale``, the post-norms' too) and the QK-norm scales
    start at zero; every other leaf draws the dense-init law."""
    cfg_t, _, tree, *_ = carried(arch)
    model = GCLM(cfg_t, device="cpu", seed=3)
    zero_ref = {p for p, leaf in zip(model.leaf_paths(), jax.tree.leaves(tree))
                if not np.any(leaf)}
    zero = {p for p, t in model.leaf_items() if not torch.any(t)}
    zero = {".".join(p) for p in zero}
    assert zero == zero_ref
    names = {p.split(".")[-1] for p in zero} | {".".join(p.split(".")[-2:]) for p in zero}
    assert "scale" in names
    if arch != "gemma-2b":
        assert {"norm_mix_post.scale", "norm_ffn_post.scale"} <= names
    if arch == "gemma3-27b":
        assert {"q_norm", "k_norm"} <= names


def test_unported_gemma_neighbours_raise():
    """What the other families need builds on the Gemma layer: layer norm,
    the ungated MLP, the ``cross_attn`` mixer and cross-attention
    sublayers (Whisper and Llama-3.2-vision, tests/test_torch_{whisper,
    vision}.py), with Qwen's QKV bias and untied head, MoE FFNs,
    DeepSeek's MLA and MTP, Jamba's Mamba mixer and xLSTM's mLSTM and
    sLSTM mixers (tests/test_torch_{qwen,moe,deepseek,jamba,xlstm}.py);
    the Whisper and vision configs are registered.  What no family has —
    an unknown mixer — raises."""
    cfg = get_config("gemma-2b").reduced(**_kw("gemma-2b"))
    for change in (dict(layers=(dataclasses.replace(cfg.layers[0], mixer="cross_attn"),) * 2),
                   dict(norm="layer"), dict(activation="gelu_mlp"),
                   dict(layers=(dataclasses.replace(cfg.layers[0], mixer="cross_attn",
                                                    cross_source=True),) * 2),
                   dict(layers=(dataclasses.replace(cfg.layers[0], cross_source=True),) * 2)):
        GCLM(cfg.replace(**change), device="meta")
    with pytest.raises(ValueError, match="unknown mixer"):
        GCLM(cfg.replace(layers=(dataclasses.replace(cfg.layers[0], mixer="rwkv"),) * 2),
             device="meta")
    for arch in ("whisper-base", "llama-3.2-vision-11b"):
        assert get_config(arch).name == arch
    GCLM(cfg.replace(qkv_bias=True, tie_embeddings=False), device="meta")
    for mixer in ("mlstm", "slstm"):
        GCLM(cfg.replace(layers=(dataclasses.replace(cfg.layers[0], mixer=mixer),) * 2),
             device="meta")
    assert get_config("xlstm-1.3b").n_layers == 48


# ------------------------------------------------------ training (gemma3)
def _gemma3_plans():
    cfg_t, cfg_j, tree, jparams, model = carried("gemma3-27b")
    plan_t = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), N, scheme="xf")
    plan_j = JPlan.build(jparams, JShiftedExp(mu=1e-3, t0=50.0), N, scheme="xf")
    return plan_t, plan_j


def test_gemma3_plan_json_matches_reference():
    plan_t, plan_j = _gemma3_plans()
    assert json.dumps(plan_t.to_dict(), sort_keys=True) == \
        json.dumps(plan_j.to_dict(), sort_keys=True)
    layout = plan_t.flat_layout
    assert layout.n_leaves == 93 > _pipe.MAX_LEAVES
    # on the card the grouped call splits into ceil(93 / 32) = 3 launches
    widths = [layout.leaf_size(j) for j in range(layout.n_leaves)]
    assert len(_pipe.plan_launches(widths, 1024)) == 3


def test_gemma3_coded_grads_equal_uncoded_every_straggler_count():
    cfg_t, cfg_j, tree, jparams, model = carried("gemma3-27b")
    plan_t, plan_j = _gemma3_plans()
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


def test_gemma3_three_trainer_steps_match_reference_trainer():
    cfg_t, cfg_j, tree, *_ = carried("gemma3-27b")
    seq = 32
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=10),
                   JShiftedExp(mu=1e-3, t0=50.0), n_workers=N, scheme="xf",
                   global_batch=8, seed=0)
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq,
                                            global_batch=8, seed=0))
    init = jax.tree.map(np.asarray, ref.state.params)
    ours = Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10),
                   ShiftedExponential(mu=1e-3, t0=50.0), n_workers=N, scheme="xf",
                   global_batch=8, seed=0, device="cpu", params=init, seq_len=seq)
    assert ours.plan.to_dict() == ref.plan.to_dict()
    before = gc_fused.launches
    _, sum_t = ours.run(3, log_every=0)
    _, sum_j = ref.run(3, log_every=0)
    assert gc_fused.launches == before  # the CPU path never launches the kernel
    assert sum_t == sum_j
    for ht, hj in zip(ours.history, ref.history, strict=True):
        assert (ht["step"], ht["tau_coded"], ht["tau_uncoded"]) == \
            (hj["step"], hj["tau_coded"], hj["tau_uncoded"])
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=3e-6)


# -------------------------------------------------------- serving (gemma3)
#: prompts of 36 tokens past the window of 32: rings rolled at prefill,
#: wrapping again in decode
ENGINE = dict(n_slots=3, max_len=48, prompt_len=36, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_gemma3_engine_run_matches_reference():
    cfg_t, cfg_j, _, jparams, model = carried("gemma3-27b")
    jenv = JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), 6)
    env = Env.iid(ShiftedExponential(mu=1e-3, t0=50.0), 6)
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
    assert all(r.done for r in reqs) and len(eng.finished) == len(reqs)
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        assert len(r.tokens) == r.max_new
        for field in ("t_admit", "t_first", "t_done", "n_steps", "slot", "state"):
            assert getattr(r, field) == getattr(jr, field), field
    assert eng.step_latencies == jeng.step_latencies
    assert eng.now == jeng.now
    # the slab's local layers are rings of 32 behind every slot's pos
    ring = eng.slab[0][0]
    assert ring["k"].shape[2] == 32 and int(ring["pos"].max()) > 32


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_gemma3_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", "gemma3-27b", "--reduced",
                       "--prompt-len", "8", "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        "gemma3-27b: (2, 11) in ")


def test_train_launcher_runs_gemma_2b_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", "gemma-2b", "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8"])
    out = capsys.readouterr().out
    assert "arch=gemma-2b" in out


def test_segments_of_the_full_configs():
    """The full configs' segmenting, which the full-width card phases cut
    only in depth: gemma3 62 = Pattern(6 x 10) + Run(2), gemma2 46 =
    Pattern(2 x 23), gemma-2b one Run of 18."""
    segs = {a: plan_segments(get_config(a).layers) for a in ARCHS}
    assert segs["gemma-2b"] == [Run(get_config("gemma-2b").layers[0], 18, 0)]
    p2, = segs["gemma2-27b"]
    assert isinstance(p2, Pattern) and (len(p2.specs), p2.repeats) == (2, 23)
    p3, tail = segs["gemma3-27b"]
    assert isinstance(p3, Pattern) and (len(p3.specs), p3.repeats) == (6, 10)
    assert isinstance(tail, Run) and (tail.count, tail.start) == (2, 60)
    cut = get_config("gemma3-27b").replace(
        n_layers=14, layers=get_config("gemma3-27b").layers[:14])
    assert [type(s).__name__ for s in plan_segments(cut.layers)] == ["Pattern", "Run"]
