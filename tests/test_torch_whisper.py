"""The port's Whisper — layer norm, the ungated GELU MLP, the audio
encoder and the gated cross-attention sublayer over its output — against
the JAX reference, on the CPU.

The model is ``whisper-base.reduced(n_layers=2, d_model=128, seq_cap=64)``:
2 decoder layers (one run: self-attention with QKV biases and RoPE, the
``cross`` sublayer, an ungated MLP; layer norms) over a 2-layer encoder
of 64 frames (``reduced()``'s ``EncoderSpec(2, 64)``), 51 leaves.  The
reference's initialized weights are carried with ``params_from_numpy``,
its caches with ``caches_from_numpy``.  Its gates start closed
(``tanh(0) = 0``): the source would add nothing and the encoder get no
gradient, so every comparison first sets each ``gate`` leaf to a value
drawn from a seed, on the reference's tree, then carries it across.
The frames are drawn with numpy from a seed.

Tolerances:

* fp32 — ``layer_norm``, the GELU MLP, ``cross_attention`` (with
  gradients), ``run_encoder`` at 64 frames and at 160 over chunks of 128
  (the non-causal padded tail), logits, loss, every leaf's gradient,
  prefill and decode logits and caches, coded gradients against the
  reference's: ``REL`` = 1e-5 of each tensor's largest entry;
* the encoder's ``bk`` gradients are zero in exact arithmetic — without
  RoPE a key bias shifts every score of a query row alike — and both
  packages return rounding noise (~1e-10 against ``bq``'s ~1e-3): each
  is held at the bound times the largest gradient of the same layer's
  ``bq``.  The decoder rotates its keys after the bias, so its ``bk`` has
  a real gradient and is held like any leaf;
* bf16 ``cross_attention``: 2^-8 of its largest output; the test prints
  whether it equals the reference's bit for bit;
* bf16 activations, the model: logits 5e-2 of the largest, the loss 1e-3
  relative, every leaf's gradient 1e-1 of its largest (``PERF.md`` §2's
  bounds for the other families) — or, where bf16 rounding moves the
  reference's own gradient further from its fp32 one, ``BF16_GRAD_RATIO``
  = 2 times that distance, as the xLSTM test holds it: a cross ``gate``'s
  gradient is one sum over every position with much cancellation, and the
  reference's bf16 gradient lies 0.228 of its largest from its fp32 one
  (the port's from the reference's bf16: 0.230);
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
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro.models.params import count_params as jax_count_params
from repro.serve.engine import generate as jax_generate
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro_torch.configs import EncoderSpec, get_config
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, layers
from repro_torch.models.model import decode_step, forward, prefill, run_encoder, train_loss
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.models.stack import Run, plan_segments
from repro_torch.serve import ServeConfig, ServeEngine, caches_from_numpy, caches_to_numpy
from repro_torch.serve import generate
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from torch_cross_spmd import coded_grads_rank
from repro_torch.train.state import init_train_state as t_init_train_state
from repro_torch.train.trainer import TrainConfig, Trainer, make_coded_train_step

ARCH = "whisper-base"
KW = dict(n_layers=2, d_model=128, seq_cap=64)
REL = 1e-5
BF16_REL = 2 ** -8
BF16_LOGITS_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
BF16_GRAD_RATIO = 2.0
N = 4
SE = dict(mu=1e-3, t0=50.0)
ATTN_LEAVES = ("bk", "bq", "bv", "wk", "wo", "wq", "wv")
CROSS_LEAVES = ("gate", "wk", "wo", "wq", "wv")


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
    """``_close`` per leaf, at ``rels[path]`` when given, else ``rel``; an
    encoder ``bk`` (zero in exact arithmetic: no RoPE) held on both sides at
    ``rel`` of the largest gradient of its layer's ``bq``."""
    got, want = dict(zip(paths, got, strict=True)), dict(zip(paths, want, strict=True))
    for path in paths:
        if path.startswith("encoder.") and path.endswith(".bk"):
            scale = float(np.abs(np.asarray(want[path[:-1] + "q"])).max())
            for g in (got[path], want[path]):
                assert float(np.abs(np.asarray(g)).max()) <= rel * scale, f"{what} {path}"
        else:
            _close(got[path], want[path], (rels or {}).get(path, rel), f"{what} {path}")


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


def open_gates(tree, seed=0):
    """The tree with every ``gate`` leaf drawn from U(0.3, 0.9) (seeded):
    at the reference's init (0) the cross sublayers add nothing."""
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


def carried():
    """(cfg_t, cfg_j, numpy tree (gates open), jax params, model) of reduced
    Whisper, built once per module; ``_CARRIED["init"]`` keeps the
    reference's init tree (gates closed)."""
    if not _CARRIED:
        cfg_t, cfg_j = get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        _CARRIED["init"] = jax.tree.map(np.asarray, state.params)
        tree = open_gates(_CARRIED["init"])
        model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
        _CARRIED["v"] = (cfg_t, cfg_j, tree, jax.tree.map(jnp.asarray, tree), model)
    return _CARRIED["v"]


def _frames(cfg, batch=2, n=None, seed=3):
    n = cfg.encoder.n_frames if n is None else n
    return np.random.default_rng(seed).standard_normal((batch, n, cfg.d_model),
                                                       dtype=np.float32)


def _tokens(cfg, seq=24, batch=2, seed=1):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(0)


def _as(dtype, x):
    """x rounded to ``dtype`` on both sides: (jax array, torch tensor)."""
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    """Leaf paths, order and shapes on meta: at full width 103 leaves
    (embed, a 6-layer encoder of 13 leaves each and its final layer norm,
    the final layer norm, a run of 6 decoder layers of 20 leaves),
    70,646,278 parameters; reduced, 51."""
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    if size == "reduced":
        cfg_t, cfg_j = cfg_t.reduced(**KW), cfg_j.reduced(**KW)
    model = GCLM(cfg_t, device="meta")
    params_j = j_abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    n_enc = cfg_t.encoder.n_layers
    assert len(paths) == 1 + 2 + 13 * n_enc + 2 + 20
    assert paths[:3] == ["embed.tok", "encoder.final_norm.bias", "encoder.final_norm.scale"]
    assert [p for p in paths if p.startswith("encoder.layers.0.")] == \
        [f"encoder.layers.0.ffn.{n}" for n in ("wi", "wo")] + \
        [f"encoder.layers.0.mixer.{n}" for n in ATTN_LEAVES] + \
        [f"encoder.layers.0.{n}.{k}" for n in ("norm_ffn", "norm_mix") for k in ("bias", "scale")]
    assert [p for p in paths if p.startswith("stack.0.")] == \
        [f"stack.0.cross.{n}" for n in CROSS_LEAVES] + \
        [f"stack.0.ffn.{n}" for n in ("wi", "wo")] + \
        [f"stack.0.mixer.{n}" for n in ATTN_LEAVES] + \
        [f"stack.0.{n}.{k}" for n in ("norm_cross", "norm_ffn", "norm_mix")
         for k in ("bias", "scale")]
    assert plan_segments(cfg_t.layers) == [Run(cfg_t.layers[0], cfg_t.n_layers, 0)]
    n = sum(int(np.prod(s)) for s in shapes)
    assert n == jax_count_params(params_j)
    if size == "full":
        assert len(paths) == 103 and n == 70_646_278, (len(paths), n)
        assert tuple(model.stack[0].cross.gate.shape) == (6,)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
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
    red = get_config(ARCH).reduced(**KW)
    assert red.encoder == EncoderSpec(2, 64) and red.norm == "layer" and red.qkv_bias
    assert get_config(ARCH).encoder == EncoderSpec(6, 1500)


def test_reset_parameters_constants_equal_the_reference_init():
    """Every layer norm's ``scale`` 1 and ``bias`` 0, every ``gate`` 0 and
    every QKV bias 0 — the reference's init, bit for bit — from
    ``reset_parameters``; ``params_to_numpy`` gives the reference's tree."""
    cfg_t = carried()[0]
    init = _CARRIED["init"]
    want = dict(zip(_jax_paths(init)[0], jax.tree.leaves(init)))
    model = GCLM(cfg_t, device="cpu", seed=5)
    fixed = [p for p in model.leaf_paths()
             if p.split(".")[-1] in ("scale", "bias", "gate", "bq", "bk", "bv")]
    assert len(fixed) == 2 + 2 * (4 + 3) + 2 + 10
    for path, t in zip(model.leaf_paths(), model.leaves()):
        if path in fixed:
            np.testing.assert_array_equal(t.detach().numpy(), want[path], err_msg=path)
    assert float(model.encoder.final_norm.scale.detach().min()) == 1.0
    back = params_to_numpy(model)  # the reference's tree: ``encoder.layers`` a list
    assert jax.tree.structure(back) == jax.tree.structure(init)
    assert isinstance(back["encoder"]["layers"], list) and len(back["encoder"]["layers"]) == 2


# ---------------------------------------------------------------- pieces
def test_layer_norm_and_gelu_mlp_match_reference():
    """``layer_norm`` (eps 1e-5, fp32 inside) and the ungated tanh-GELU MLP
    in fp32, outputs and gradients."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32) * 3 + 1
    scale, bias = (rng.standard_normal(128).astype(np.float32) for _ in range(2))
    want = jlayers.layer_norm(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    got = layers.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                            torch.from_numpy(bias))
    _close(got, want, REL, "layer_norm")
    p_j = jparams["stack"][0]["ffn"]
    p_j = {k: v[0] for k, v in p_j.items()}
    assert set(p_j) == {"wi", "wo"}
    p_t = {k: torch.from_numpy(np.array(v)).requires_grad_() for k, v in p_j.items()}
    out_j, vjp = jax.vjp(lambda p, x_: jlayers.apply_mlp(cfg_j, p, x_), p_j, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    out_t = layers.apply_mlp(cfg_t, p_t, xt)
    _close(out_t.detach(), out_j, REL, "gelu_mlp")
    cot = rng.standard_normal(out_t.shape).astype(np.float32)
    g_j = vjp(jnp.asarray(cot))
    g_t = torch.autograd.grad(out_t, [p_t["wi"], p_t["wo"], xt], torch.from_numpy(cot))
    for got_g, want_g, name in zip(g_t, [g_j[0]["wi"], g_j[0]["wo"], g_j[1]], ("wi", "wo", "x")):
        _close(got_g, want_g, REL, f"gelu_mlp grad {name}")


def _cross_params(jparams):
    return {k: v[0] for k, v in jparams["stack"][0]["cross"].items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_reference(dtype):
    """The gated cross-attention over a 40-row source: fp32 outputs and
    gradients (source included) 1e-5; bf16 2^-8 of the largest, printing
    whether it is the reference's bit for bit."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    rng = np.random.default_rng(12)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    src = rng.standard_normal((2, 40, 128)).astype(np.float32)
    p_j = _cross_params(jparams)
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
        print(f"bf16 cross_attention: {err:.3e} of the largest "
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


@pytest.mark.parametrize("n_frames", [64, 160])
def test_run_encoder_matches_reference(n_frames):
    """The encoder at 64 frames (one chunk) and at 160 over KV chunks of 128
    (the non-causal online softmax's padded, masked tail): 1e-5."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    assert cfg_t.attn_chunk == 128
    frames = _frames(cfg_t, n=n_frames)
    want = jmodel.run_encoder(cfg_j, jparams, jnp.asarray(frames))
    with torch.no_grad():
        got = run_encoder(cfg_t, model, torch.from_numpy(frames))
    _close(got, want, REL, f"encoder at {n_frames} frames")


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


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_every_leaf_gradient_match_jax(dtype):
    """Logits and loss, and all 51 leaves' gradients — the encoder's and
    the cross sublayers' included, with the gates open — fp32 at 1e-5
    (each ``bk`` against its layer's ``bq``), bf16 at ``PERF.md`` §2's
    bounds."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens, frames = _tokens(cfg_t), _frames(cfg_t)
    loss_j, g_j, logits_j = _reference(cfg_j, jparams, tokens, frames)
    loss_t, _ = train_loss(cfg_t, model, {"tokens": tokens, "aux_inputs": frames})
    g_t = torch.autograd.grad(loss_t, model.leaves())
    with torch.no_grad():
        logits_t = forward(cfg_t, model, tokens[:, :-1], aux_inputs=frames)[0]
    paths = model.leaf_paths()
    if dtype == "float32":
        _close(logits_t, logits_j, REL, "logits")
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=REL)
        _grads_close(paths, g_t, g_j, REL, "grad")
    else:
        _close(logits_t.float(), np.asarray(logits_j.astype(jnp.float32)), BF16_LOGITS_REL,
               "bf16 logits")
        np.testing.assert_allclose(float(loss_t.detach()), float(loss_j), rtol=BF16_LOSS_REL)
        g32 = _reference(cfg_j.replace(dtype="float32"), jparams, tokens, frames)[1]
        rels = {}
        for path, a, b in zip(paths, g_j, g32):
            a = np.asarray(a, np.float32)
            own = float(np.abs(a - np.asarray(b)).max()) / max(float(np.abs(a).max()), 1e-30)
            rels[path] = max(BF16_GRAD_REL, BF16_GRAD_RATIO * own)
        _grads_close(paths, g_t, g_j, BF16_GRAD_REL, "bf16 grad", rels)
    assert all(float(g.abs().max()) > 0 for p, g in zip(paths, g_t)
               if p.startswith("encoder.") and not p.endswith(".bk"))


def test_forward_without_frames_raises():
    cfg_t, *_, model = carried()
    with pytest.raises(ValueError, match="needs its source: pass aux_inputs"):
        forward(cfg_t, model, _tokens(cfg_t)[:, :-1])


def test_prefill_and_decode_from_reference_caches():
    """The reference's prefill (20 tokens of 2 rows, frames as the source)
    against the port's — logits and K/V caches — then 4 decode steps of
    both packages from the reference's caches, each recomputing the
    encoder from the frames."""
    cfg_t, cfg_j, _, jparams, model = carried()
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(2, 24))
    frames = _frames(cfg_t, seed=4)
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :20]),
                                        aux_inputs=jnp.asarray(frames), target_len=32)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :20]),
                                 aux_inputs=frames, target_len=32)
    _close(logits_t, logits_j, REL, "prefill logits")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        _close(g, w, REL, "prefill cache")
    caches_t = caches_from_numpy(cfg_t, jax.tree.map(np.asarray, caches_j), device="cpu")
    for t in range(20, 24):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]),
                                                aux_inputs=jnp.asarray(frames))
        logits_t, out = decode_step(cfg_t, model, caches_t, torch.from_numpy(toks[:, t:t + 1]),
                                    aux_inputs=frames)
        assert out is caches_t
        _close(logits_t, logits_j, REL, f"decode logits at {t}")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        _close(g, w, REL, "decoded cache")


def test_generate_greedy_tokens_equal_reference():
    """``generate(aux_inputs=)``: the reference's direct loop, fp32, greedy:
    2 prompts of 12 tokens + 8 new, equal tokens."""
    cfg_t, cfg_j, _, jparams, model = carried()
    prompts = np.random.default_rng(5).integers(0, cfg_t.vocab, size=(2, 12)).astype(np.int32)
    frames = _frames(cfg_t, seed=6)
    want = np.asarray(jax_generate(cfg_j, jparams, jnp.asarray(prompts), 8,
                                   aux_inputs=jnp.asarray(frames)))
    got = generate(cfg_t, model, prompts, 8, aux_inputs=frames, device="cpu")
    assert got.dtype == torch.int32 and tuple(got.shape) == (2, 20)
    np.testing.assert_array_equal(got.numpy(), want)


def test_the_engine_and_trainer_run_refuse_a_model_with_a_source():
    cfg_t, *_, model = carried()
    with pytest.raises(ValueError, match="generate"):
        ServeEngine(cfg_t, model, ServeConfig(n_slots=2, max_len=16), device="cpu")
    tr = Trainer(cfg_t, TrainConfig(), ShiftedExponential(**SE), n_workers=N, global_batch=8,
                 device="cpu", seq_len=16)
    with pytest.raises(ValueError, match="worker_aux"):
        tr.run(1, log_every=0)


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
    shard_aux = np.stack([_frames(cfg_t, batch=shards.shape[1], seed=20 + i)
                          for i in range(N)])
    return wb, shards, shard_aux, worker_aux(shard_aux, N, plan_t.s_max)


def _dec_w(plan, u):
    times = np.ones(plan.n_workers)
    times[:u] = 1e6
    return plan.decode_weights(times).astype(np.float32)


def test_coded_grads_equal_uncoded_and_the_reference_coded():
    """Sim mode with ``worker_aux``, 0 to s_max stragglers: coded ==
    uncoded (1e-4) and == the reference's coded (1e-5), every leaf."""
    cfg_t, cfg_j, tree, jparams, model = carried()
    plan_t = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    plan_j = JPlan.build(jparams, JShiftedExp(**SE), N, scheme="xf")
    assert plan_t.to_dict() == plan_j.to_dict()
    wb, shards, shard_aux, wa = _coded_inputs(cfg_t, plan_t)
    assert wa.shape == (N, plan_t.s_max + 1, 2, 64, 128)
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
    with pytest.raises(ValueError, match="worker_aux"):
        ours(model, wb, _dec_w(plan_t, 0))


def test_coded_train_step_takes_worker_aux():
    """``make_coded_train_step``'s step with ``worker_aux``: its monitoring
    loss is shard 0's with ``worker_aux[0, 0]``, and it moves every leaf
    the source reaches."""
    cfg_t, _, tree, _, _ = carried()
    model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
    plan = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    wb, _, _, wa = _coded_inputs(cfg_t, plan)
    state = t_init_train_state(cfg_t, device="cpu", params=tree)
    with torch.no_grad():
        want = train_loss(cfg_t, state.params, {"tokens": wb[0, 0], "aux_inputs": wa[0, 0]})[0]
    step = make_coded_train_step(cfg_t, TrainConfig(warmup=1, total_steps=10), plan)
    before = params_to_numpy(state.params)
    state, metrics = step(state, wb, _dec_w(plan, plan.s_max), wa)
    assert float(metrics["loss"]) == float(want)
    state, _ = step(state, wb, _dec_w(plan, 0), wa)  # the LR warms up from 0 at step 0
    after = params_to_numpy(state.params)
    assert not np.array_equal(after["encoder"]["layers"][0]["mixer"]["wq"],
                              before["encoder"]["layers"][0]["mixer"]["wq"])
    assert not np.array_equal(after["stack"][0]["cross"]["gate"], before["stack"][0]["cross"]["gate"])


def test_spmd_coded_grads_match_sim_mode(tmp_path):
    """Four gloo ranks, each its own K per-shard passes over its slice of
    ``worker_aux``, one collective per level: the same bytes on every
    rank, equal to sim mode's (1e-5) and to the uncoded mean (1e-4)."""
    cfg_t, _, tree, _, model = carried()
    plan = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    wb, shards, shard_aux, wa = _coded_inputs(cfg_t, plan)
    dec_ws = [_dec_w(plan, 0), _dec_w(plan, plan.s_max)]
    path = os.path.join(tmp_path, "inputs.pt")
    torch.save({"arch": ARCH, "reduced": KW, "env": SE, "tree": tree, "wb": wb, "wa": wa,
                "dec_w": dec_ws}, path)
    out = dist_spawn.spawn(coded_grads_rank, N, path, store_dir=str(tmp_path), timeout=240.0)
    g_unc = uncoded_grad_fn(cfg_t, N)(model, shards, shard_aux)
    sim = make_coded_grad_fn(cfg_t, plan)
    paths = model.leaf_paths()
    for i, dec_w in enumerate(dec_ws):
        for r in range(1, N):
            for a, b in zip(out[0][i], out[r][i], strict=True):
                np.testing.assert_array_equal(a, b)
        _grads_close(paths, out[0][i], sim(model, wb, dec_w, wa), REL, "spmd vs sim,")
        _grads_close(paths, out[0][i], g_unc, 1e-4, "spmd vs uncoded,")


# ------------------------------------------------------------ launchers
def test_serve_launcher_runs_whisper_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")
    with pytest.raises(SystemExit, match="text-only"):
        launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--stream", "2"])


def test_train_launcher_refuses_whisper():
    with pytest.raises(SystemExit, match="worker_aux"):
        launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "1"])
