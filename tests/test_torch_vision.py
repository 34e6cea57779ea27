"""The port's Llama-3.2-vision — gated cross-attention image layers over
projected patch embeddings — against the JAX reference, on the CPU.

The model is ``llama-3.2-vision-11b.reduced(n_layers, d_model=128,
seq_cap=64)`` with ``reduced()``'s ``VisionSpec(16, 64)``: 16 stubbed
patches of width 64, projected by ``vision_proj`` to d_model.
``reduced()``'s default 2 layers hold no cross layer, so the tests take
5 layers — attention ×3, the cross-attention mixer at index 3, attention
(runs of 3, 1 and 1; 32 leaves) — and 10, two periods of the published
layout: one ``Pattern`` of 5 over 2 repeats with the cross layer stacked
at position 3 (50 leaves, as at full size).  GQA: 4 heads over 2 KV
heads; an untied head; RoPE base 5e5.  The reference's initialized
weights are carried with ``params_from_numpy``, its caches with
``caches_from_numpy``.  The gates start closed (``tanh(0) = 0``: the
image would add nothing and ``vision_proj`` and the cross projections
get no gradient), so every comparison first sets each ``gate`` leaf to a
value drawn from a seed, on the reference's tree, then carries it
across.  The patches are drawn with numpy from a seed.

Tolerances:

* fp32 — ``cross_attention`` as a mixer (with gradients), the projected
  source, logits, loss, every leaf's gradient, prefill and decode logits
  and caches, coded gradients against the reference's: ``REL`` = 1e-5 of
  each tensor's largest entry;
* bf16 ``cross_attention``: 2^-8 of its largest output; the test prints
  whether it equals the reference's bit for bit;
* bf16 activations, the model: logits 5e-2 of the largest, the loss 1e-3
  relative, every leaf's gradient 1e-1 of its largest (``PERF.md`` §2) —
  or, where bf16 rounding moves the reference's own gradient further from
  its fp32 one (a ``gate``: one sum over every position), 2 times that
  distance, as ``tests/test_torch_whisper.py`` holds it;
* remat ("dots", "full") against "none": bit-equal;
* coded gradients against the uncoded mean: 1e-4 per leaf (the repo's
  gate), in sim mode and on four gloo ranks in spmd mode (spmd against
  sim mode: 1e-5); greedy ``generate(aux_inputs=)`` tokens: equal.
"""
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.models.params import count_params as jax_count_params
from repro.serve.engine import generate as jax_generate
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro_torch.configs import VisionSpec, get_config
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention
from repro_torch.models.model import (decode_step, forward, prefill, source_embeds,
                                      train_loss)
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.models.stack import Pattern, Run, plan_segments
from repro_torch.serve import ServeConfig, ServeEngine, caches_from_numpy, caches_to_numpy
from repro_torch.serve import generate
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from torch_cross_spmd import coded_grads_rank

ARCH = "llama-3.2-vision-11b"
KW = dict(d_model=128, seq_cap=64)
REL = 1e-5
BF16_REL = 2 ** -8
BF16_LOGITS_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
BF16_GRAD_RATIO = 2.0
N = 4
SE = dict(mu=1e-3, t0=50.0)
ATTN = ("wk", "wo", "wq", "wv")
CROSS = ("gate", "wk", "wo", "wq", "wv")
FFN = ("wg", "wi", "wo")


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


def _grads_close(paths, got, want, rel, what="", rels=None):
    """``_close`` per leaf, at ``rels[path]`` when given, else ``rel``."""
    for path, g, w in zip(paths, got, want, strict=True):
        _close(g, w, (rels or {}).get(path, rel), f"{what} {path}")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


def open_gates(tree, seed=0):
    """The tree with every ``gate`` leaf drawn from U(0.3, 0.9) (seeded):
    at the reference's init (0) the cross layers add nothing."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.uniform(0.3, 0.9, np.shape(v)).astype(np.float32) if k == "gate"
                        else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


_CARRIED = {}


def carried(n_layers=5):
    """(cfg_t, cfg_j, numpy tree (gates open), jax params, model) of reduced
    vision, built once per module and depth; ``_CARRIED[("init", n)]``
    keeps the reference's init tree (gates closed)."""
    if n_layers not in _CARRIED:
        kw = dict(KW, n_layers=n_layers)
        cfg_t, cfg_j = get_config(ARCH).reduced(**kw), jax_get_config(ARCH).reduced(**kw)
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        _CARRIED[("init", n_layers)] = jax.tree.map(np.asarray, state.params)
        tree = open_gates(_CARRIED[("init", n_layers)])
        model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
        _CARRIED[n_layers] = (cfg_t, cfg_j, tree, jax.tree.map(jnp.asarray, tree), model)
    return _CARRIED[n_layers]


def _patches(cfg, batch=2, seed=3):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.vision.n_patches, cfg.vision.d_vision), dtype=np.float32)


def _tokens(cfg, seq=24, batch=2, seed=1):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(0)


def _as(dtype, x):
    """x rounded to ``dtype`` on both sides: (jax array, torch tensor)."""
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("size", ["full", "reduced5", "reduced10"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    """Leaf paths, order and shapes on meta: at full size 40 layers — one
    pattern of 5 over 8 repeats, the cross layer at position 3 — 50 leaves
    and 9,806,614,536 parameters; reduced to 5 layers, runs of 3, 1 and 1
    (32 leaves); to 10, a pattern of 5 over 2 (50 leaves)."""
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    if size != "full":
        n = int(size[len("reduced"):])
        cfg_t, cfg_j = cfg_t.reduced(n_layers=n, **KW), cfg_j.reduced(n_layers=n, **KW)
    model = GCLM(cfg_t, device="meta")
    params_j = j_abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert paths[:3] == ["embed.tok", "embed.unembed", "final_norm.scale"]
    assert paths[-1] == "vision_proj"
    segs = plan_segments(cfg_t.layers)
    cross = "stack.1" if size == "reduced5" else "stack.0.3"
    assert [p for p in paths if p.startswith(f"{cross}.")] == \
        [f"{cross}.ffn.{n}" for n in FFN] + [f"{cross}.mixer.{n}" for n in CROSS] + \
        [f"{cross}.{n}.scale" for n in ("norm_ffn", "norm_mix")]
    if size == "reduced5":
        assert len(paths) == 32
        assert segs == [Run(cfg_t.layers[0], 3, 0), Run(cfg_t.layers[3], 1, 3),
                        Run(cfg_t.layers[4], 1, 4)]
    else:
        assert len(paths) == 50
        assert segs == [Pattern(cfg_t.layers[:5], 2 if size == "reduced10" else 8, 0)]
        assert [p for p in paths if p.startswith("stack.0.0.")] == \
            [f"stack.0.0.ffn.{n}" for n in FFN] + [f"stack.0.0.mixer.{n}" for n in ATTN] + \
            [f"stack.0.0.{n}.scale" for n in ("norm_ffn", "norm_mix")]
    n = sum(int(np.prod(s)) for s in shapes)
    assert n == jax_count_params(params_j)
    if size == "full":
        assert n == 9_806_614_536, n
        assert tuple(model.stack[0][3].mixer.gate.shape) == (8,)
        assert tuple(model.vision_proj.shape) == (7680, 4096)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(n_layers=5, **KW),
                       jax_get_config(ARCH).reduced(n_layers=5, **KW)),
                      (get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe, lt.use_ffn, lt.cross_source)
                        for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe, lj.use_ffn, lj.cross_source) for lj in value]
            elif f.name in ("encoder", "vision") and value is not None:
                assert dataclasses.asdict(getattr(got, f.name)) == dataclasses.asdict(value)
            else:
                assert getattr(got, f.name) == value, f.name
    full = get_config(ARCH)
    assert get_config(ARCH).reduced().vision == VisionSpec(16, 64)
    assert [i for i, l in enumerate(full.layers) if l.mixer == "cross_attn"] == \
        [3, 8, 13, 18, 23, 28, 33, 38]
    assert full.remat == "dots" and full.dtype == "bfloat16" and not full.tie_embeddings


def test_reset_parameters_constants_equal_the_reference_init():
    """Every ``gate`` 0 and every rms norm's ``scale`` 0 (it stores scale -
    1) — the reference's init, bit for bit — from ``reset_parameters``."""
    cfg_t = carried(10)[0]
    init = _CARRIED[("init", 10)]
    want = dict(zip(_jax_paths(init)[0], jax.tree.leaves(init)))
    model = GCLM(cfg_t, device="cpu", seed=5)
    fixed = [p for p in model.leaf_paths() if p.split(".")[-1] in ("scale", "gate")]
    assert len(fixed) == 1 + 5 * 2 + 1
    for path, t in zip(model.leaf_paths(), model.leaves()):
        if path in fixed:
            np.testing.assert_array_equal(t.detach().numpy(), want[path], err_msg=path)
    assert float(model.vision_proj.detach().abs().max()) > 0


# ---------------------------------------------------------------- pieces
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_mixer_matches_reference(dtype):
    """The cross-attention mixer (4 query heads over 2 KV heads) over the
    16 projected patches: fp32 outputs and gradients 1e-5; bf16 2^-8 of
    the largest, printing whether it is the reference's bit for bit."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    src = rng.standard_normal((2, 16, 128)).astype(np.float32)
    p_j = dict(jparams["stack"][1]["mixer"])
    p_t = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in p_j.items()}
    (xj, xt), (sj, st) = _as(dtype, x), _as(dtype, src)
    out_j = jattn.cross_attention(cfg_j, p_j, xj, sj)
    xt.requires_grad_()
    st.requires_grad_()
    out_t = attention.cross_attention(cfg_t, p_t, xt, st)
    assert out_t.dtype == getattr(torch, dtype)
    if dtype == "bfloat16":
        err = _close(out_t.detach().float(), np.asarray(out_j.astype(jnp.float32)), BF16_REL,
                     "bf16 cross_attention")
        print(f"bf16 cross_attention (GQA): {err:.3e} of the largest "
              f"({'bit-equal' if err == 0 else 'within 2^-8'})")
        return
    _close(out_t.detach(), out_j, REL, "cross_attention")
    cot = rng.standard_normal(out_t.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda p, a, b: jattn.cross_attention(cfg_j, p, a, b), p_j, xj, sj)
    g_pj, g_xj, g_sj = vjp(jnp.asarray(cot))
    names = list(p_t)
    g_t = torch.autograd.grad(out_t, [p_t[k] for k in names] + [xt, st], torch.from_numpy(cot))
    for name, got_g, want_g in zip(names + ["x", "source"], g_t,
                                   [g_pj[k] for k in names] + [g_xj, g_sj]):
        _close(got_g, want_g, REL, f"cross_attention grad {name}")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_source_embeds_match_reference(dtype):
    """The projected patches ``aux @ vision_proj`` in the activations'
    dtype: fp32 1e-5, bf16 2^-8 of the largest."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    patches = _patches(cfg_t)
    want = jmodel._source_embeds(cfg_j, jparams, jnp.asarray(patches))
    with torch.no_grad():
        got = source_embeds(cfg_t, model, patches)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (2, 16, 128)
    _close(got.float(), np.asarray(want.astype(jnp.float32)),
           REL if dtype == "float32" else BF16_REL, f"{dtype} source")
    assert source_embeds(cfg_t, model, None) is None


# ----------------------------------------------------------------- model
_REF = {}


def _reference(cfg_j, jparams, tokens, aux):
    """The reference's loss, gradients (leaf order) and logits of one batch
    at ``cfg_j``'s depth and dtype, in one jitted call, once per module."""
    key = (cfg_j.n_layers, cfg_j.dtype)
    if key not in _REF:
        batch = {"tokens": jnp.asarray(tokens), "aux_inputs": jnp.asarray(aux)}

        def fn(p):
            loss, g = jax.value_and_grad(lambda q: jmodel.train_loss(cfg_j, q, batch)[0])(p)
            return loss, g, jmodel.forward(cfg_j, p, batch["tokens"][:, :-1],
                                           aux_inputs=batch["aux_inputs"])[0]

        loss, g, logits = jax.jit(fn)(jparams)
        _REF[key] = (loss, jax.tree.leaves(g), logits)
    return _REF[key]


@pytest.mark.parametrize("n_layers,dtype", [(5, "float32"), (10, "float32"), (5, "bfloat16")])
def test_forward_loss_and_every_leaf_gradient_match_jax(n_layers, dtype):
    """Logits and loss, and every leaf's gradient — ``vision_proj``'s and
    the cross layers' included, with the gates open — at 5 layers (runs)
    and 10 (the cross layer stacked in a pattern): fp32 1e-5; bf16 at 5
    layers, at ``PERF.md`` §2's bounds."""
    cfg_t, cfg_j, tree, jparams, model = carried(n_layers)
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens, patches = _tokens(cfg_t), _patches(cfg_t)
    loss_j, g_j, logits_j = _reference(cfg_j, jparams, tokens, patches)
    loss_t, _ = train_loss(cfg_t, model, {"tokens": tokens, "aux_inputs": patches})
    g_t = torch.autograd.grad(loss_t, model.leaves())
    with torch.no_grad():
        logits_t = forward(cfg_t, model, tokens[:, :-1], aux_inputs=patches)[0]
    paths = model.leaf_paths()
    if dtype == "float32":
        _close(logits_t, logits_j, REL, "logits")
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=REL)
        _grads_close(paths, g_t, g_j, REL, "grad")
    else:
        _close(logits_t.float(), np.asarray(logits_j.astype(jnp.float32)), BF16_LOGITS_REL,
               "bf16 logits")
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=BF16_LOSS_REL)
        g32 = _reference(cfg_j.replace(dtype="float32"), jparams, tokens, patches)[1]
        rels = {}
        for path, a, b in zip(paths, g_j, g32):
            a = np.asarray(a, np.float32)
            own = float(np.abs(a - np.asarray(b)).max()) / max(float(np.abs(a).max()), 1e-30)
            rels[path] = max(BF16_GRAD_REL, BF16_GRAD_RATIO * own)
        _grads_close(paths, g_t, g_j, BF16_GRAD_REL, "bf16 grad", rels)
    assert all(float(g.abs().max()) > 0 for g in g_t)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gradients_bit_equal(remat):
    """The source reaches the cross layer inside a remat'ed pattern body:
    loss and every gradient bit-equal to ``remat="none"``."""
    cfg_t, _, _, _, model = carried(10)
    batch = {"tokens": _tokens(cfg_t), "aux_inputs": _patches(cfg_t)}

    def grads(cfg):
        loss, _ = train_loss(cfg, model, batch)
        return loss, torch.autograd.grad(loss, model.leaves())

    loss0, g0 = grads(cfg_t)
    loss1, g1 = grads(cfg_t.replace(remat=remat))
    assert torch.equal(loss0, loss1)
    for path, a, b in zip(model.leaf_paths(), g0, g1):
        assert torch.equal(a, b), path


def test_prefill_and_decode_from_reference_caches():
    """At 10 layers (a pattern whose cross position keeps no cache): the
    reference's prefill (20 tokens of 2 rows) against the port's — logits
    and K/V caches, None at the cross position — then 4 decode steps of
    both packages from the reference's caches with per-row ``pos`` (the
    slab's layout), each re-projecting the patches."""
    cfg_t, cfg_j, _, jparams, model = carried(10)
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(2, 24))
    patches = _patches(cfg_t, seed=4)
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :20]),
                                        aux_inputs=jnp.asarray(patches), target_len=32)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :20]),
                                 aux_inputs=patches, target_len=32)
    assert caches_t[0][3] is None and caches_j[0][3] is None
    _close(logits_t, logits_j, REL, "prefill logits")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        _close(g, w, REL, "prefill cache")
    rows = np.array([0, -3], np.int32)  # row 1 three tokens behind, as a slot may be
    want = [[None if tree is None else
             {k: (np.asarray(v)[..., None] + rows if k == "pos" else np.asarray(v))
              for k, v in tree.items()} for tree in seg] for seg in caches_j]
    caches_j = jax.tree.map(jnp.asarray, want)
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    for t in range(20, 24):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]),
                                                aux_inputs=jnp.asarray(patches))
        logits_t, out = decode_step(cfg_t, model, caches_t, torch.from_numpy(toks[:, t:t + 1]),
                                    aux_inputs=patches)
        assert out is caches_t
        _close(logits_t, logits_j, REL, f"decode logits at {t}")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, REL, "decoded cache")


def test_generate_greedy_tokens_equal_reference():
    """``generate(aux_inputs=)``: the reference's direct loop, fp32, greedy,
    10 layers: 2 prompts of 12 tokens + 8 new, equal tokens."""
    cfg_t, cfg_j, _, jparams, model = carried(10)
    prompts = np.random.default_rng(5).integers(0, cfg_t.vocab, size=(2, 12)).astype(np.int32)
    patches = _patches(cfg_t, seed=6)
    want = np.asarray(jax_generate(cfg_j, jparams, jnp.asarray(prompts), 8,
                                   aux_inputs=jnp.asarray(patches)))
    got = generate(cfg_t, model, prompts, 8, aux_inputs=patches, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_engine_refuses_a_model_with_a_source():
    cfg_t, *_, model = carried()
    with pytest.raises(ValueError, match="generate"):
        ServeEngine(cfg_t, model, ServeConfig(n_slots=2, max_len=16), device="cpu")
    with pytest.raises(ValueError, match="needs its source: pass aux_inputs"):
        forward(cfg_t, model, _tokens(cfg_t)[:, :-1])


# -------------------------------------------------------------- training
def worker_aux(shard_aux, n_workers, s_max):
    """(N, K, rows, ...) by the cyclic map of ``coded_worker_batches``:
    worker n, slot k holds shard (n + k) mod N's embeddings."""
    return np.stack([np.stack([shard_aux[(n + k) % n_workers] for k in range(s_max + 1)])
                     for n in range(n_workers)])


def _coded_inputs(cfg_t, plan_t):
    data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=16, global_batch=8))
    wb = coded_worker_batches(data, 0, N, plan_t.s_max)
    shards = np.stack([data.shard(0, i, N) for i in range(N)])
    shard_aux = np.stack([_patches(cfg_t, batch=shards.shape[1], seed=20 + i)
                          for i in range(N)])
    return wb, shards, shard_aux, worker_aux(shard_aux, N, plan_t.s_max)


def _dec_w(plan, u):
    times = np.ones(plan.n_workers)
    times[:u] = 1e6
    return plan.decode_weights(times).astype(np.float32)


def test_coded_grads_equal_uncoded_and_the_reference_coded():
    """Sim mode with ``worker_aux`` at 10 layers, 0 and s_max stragglers:
    coded == uncoded (1e-4) and == the reference's coded (1e-5), every
    leaf."""
    cfg_t, cfg_j, tree, jparams, model = carried(10)
    plan_t = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    plan_j = JPlan.build(jparams, JShiftedExp(**SE), N, scheme="xf")
    assert plan_t.to_dict() == plan_j.to_dict()
    wb, shards, shard_aux, wa = _coded_inputs(cfg_t, plan_t)
    assert wa.shape == (N, plan_t.s_max + 1, 2, 16, 64)
    g_unc = uncoded_grad_fn(cfg_t, N)(model, shards, shard_aux)
    ours = make_coded_grad_fn(cfg_t, plan_t)
    theirs = jax.jit(jax_coded_grad_fn(cfg_j, plan_j, mode="sim", pipeline="flat"))
    paths = model.leaf_paths()
    for u in (0, plan_t.s_max):
        dec_w = _dec_w(plan_t, u)
        g_t = ours(model, wb, dec_w, wa)
        g_j = jax.tree.leaves(theirs(jparams, jnp.asarray(wb), jnp.asarray(dec_w),
                                     jnp.asarray(wa)))
        _grads_close(paths, g_t, g_unc, 1e-4, f"coded vs uncoded, {u} stragglers,")
        _grads_close(paths, g_t, g_j, REL, f"coded vs the reference's, {u} stragglers,")


def test_spmd_coded_grads_match_sim_mode(tmp_path):
    """Four gloo ranks at 10 layers, each its own K per-shard passes over
    its slice of ``worker_aux``, s_max stragglers, one collective per
    level: the same bytes on every rank, equal to sim mode's (1e-5) and to
    the uncoded mean (1e-4)."""
    cfg_t, _, tree, _, model = carried(10)
    plan = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    wb, shards, shard_aux, wa = _coded_inputs(cfg_t, plan)
    dec_w = _dec_w(plan, plan.s_max)
    path = os.path.join(tmp_path, "inputs.pt")
    torch.save({"arch": ARCH, "reduced": dict(KW, n_layers=10), "env": SE, "tree": tree,
                "wb": wb, "wa": wa, "dec_w": [dec_w]}, path)
    out = [grads for (grads,) in dist_spawn.spawn(coded_grads_rank, N, path,
                                                  store_dir=str(tmp_path), timeout=240.0)]
    for r in range(1, N):
        for a, b in zip(out[0], out[r], strict=True):
            np.testing.assert_array_equal(a, b)
    paths = model.leaf_paths()
    _grads_close(paths, out[0], make_coded_grad_fn(cfg_t, plan)(model, wb, dec_w, wa), REL,
                 "spmd vs sim,")
    _grads_close(paths, out[0], uncoded_grad_fn(cfg_t, N)(model, shards, shard_aux), 1e-4,
                 "spmd vs uncoded,")


# ------------------------------------------------------------ launchers
def test_serve_launcher_runs_vision_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")
    with pytest.raises(SystemExit, match="text-only"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--stream", "2"])


def test_train_launcher_refuses_vision():
    with pytest.raises(SystemExit, match="worker_aux"):
        launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "1"])
