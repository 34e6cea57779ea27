"""The port's DeepSeek-V3 — multi-head latent attention (``models/mla.py``)
and the multi-token prediction loss — against the JAX reference, on the
CPU.

The model is ``deepseek-v3-671b.reduced(n_layers=4, d_model=128,
seq_cap=64)``: 3 dense MLA layers (one run) and 1 MoE layer (sigmoid
top-2 of 4, one shared expert, capacity factor 8: no drops), MLA ranks
64/32, nope 32, rope 16, v 32, an untied head and one MTP module (a
dense MLA layer).  The reference's initialized weights are carried with
``params_from_numpy`` and its caches with ``caches_from_numpy``.

Tolerances:

* fp32 — the MLA layer's output, prefill cache and gradients, logits,
  loss, ``xent``/``aux``/``mtp``, every leaf's gradient (the MTP
  module's included), prefill and absorbed-decode logits and caches —
  1e-5 of each tensor's largest entry (the same fp32 math, sums in
  another order); expert indices: equal;
* bf16 activations, held at ``test_torch_gemma.py``'s bounds (outputs
  and logits 5e-2 of the largest entry, gradients 1e-1, loss 1e-3
  relative): XLA keeps excess precision between fused bf16 ops, torch
  rounds each.  Measured on the CPU: the MLA layer 3.01e-3 at 48 tokens
  (one reference chunk) and at 160 (the reference's two chunks of 128
  against the port's one softmax), its prefill cache bit-equal; the
  model's logits 1.57e-2, gradients 3.24e-2 of a leaf's largest (``wq_b``),
  loss 1.08e-4 and aux 7.1e-4 relative, on the reference's routes (the
  port's own agree on 94 of 96 tokens); 8 absorbed decode steps from the
  reference's bf16 caches 2.10e-2;
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), against the reference's coded: 1e-5; three trainer steps
  against the reference trainer: losses 1e-5 relative, parameters 2e-5
  absolute (AdamW's normalized step, as in ``test_torch_qwen.py``);
* plan JSON, autotune reports, the engine's tokens, slots and
  timestamps: equal; the spmd trainer's losses against sim mode's: 1e-5.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import MLASpec as JMLASpec
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import SyntheticTokens as JSyntheticTokens
from repro.launch.mesh import HW as JHW
from repro.models import mla as jmla
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.params import count_params as jax_count_params
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import Trainer as JTrainer
from repro.tune import MemBudget as JMemBudget
from repro.tune import autotune as j_autotune
from repro_torch.configs import MLASpec, get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import mla, moe
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.models.stack import Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy, make_slab)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.state import abstract_train_state
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tune import MemBudget, autotune

ARCH = "deepseek-v3-671b"
KW = dict(n_layers=4, d_model=128, seq_cap=64)
REL = 1e-5
BF16_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
N = 4
SE = dict(mu=1e-3, t0=50.0)
MLA_LEAVES = ("kv_a_norm", "q_a_norm", "wk_b", "wk_rope", "wkv_a", "wo", "wq_a", "wq_b",
              "wv_b")


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


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


_CARRIED = {}


def carried():
    """(cfg_t, cfg_j, numpy tree, jax params, model) of reduced DeepSeek-V3,
    built once per module."""
    if not _CARRIED:
        cfg_t, cfg_j = get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, state.params)
        model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
        _CARRIED.update(v=(cfg_t, cfg_j, tree, jax.tree.map(jnp.asarray, tree), model))
    return _CARRIED["v"]


def _tokens(cfg, seq=48, batch=2, seed=1):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=batch,
                                      seed=seed)).batch(0)


def _as(dtype, x):
    """x rounded to ``dtype`` on both sides: (jax array, torch tensor)."""
    xj = jnp.asarray(x, getattr(jnp, dtype))
    return xj, torch.tensor(np.asarray(xj.astype(jnp.float32))).to(getattr(torch, dtype))


# ------------------------------------------------------------ structure
@pytest.mark.parametrize("size", ["full", "reduced"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    if size == "reduced":
        cfg_t, cfg_j = cfg_t.reduced(**KW), cfg_j.reduced(**KW)
    model = GCLM(cfg_t, device="meta")
    params_j = j_abstract_train_state(cfg_j)[0].params
    paths, shapes = _jax_paths(params_j)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert paths[:3] == ["embed.tok", "embed.unembed", "final_norm.scale"]
    mtp = [p for p in paths if p.startswith("mtp.")]
    assert mtp[-3:] == ["mtp.0.norm_e.scale", "mtp.0.norm_h.scale", "mtp.0.proj"]
    assert [p for p in mtp if ".mixer." in p] == [f"mtp.0.layer.mixer.{n}" for n in MLA_LEAVES]
    assert [p for p in mtp if ".ffn." in p] == [f"mtp.0.layer.ffn.{n}" for n in ("wg", "wi", "wo")]
    assert paths.index(mtp[-1]) + 1 == paths.index(
        next(p for p in paths if p.startswith("stack.")))
    m, d, h = cfg_t.mla, cfg_t.d_model, cfg_t.n_heads
    assert tuple(model.stack[0].mixer.wq_b.shape) == (
        3, m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim)
    assert tuple(model.stack[1].mixer.wk_b.shape[-3:]) == (
        m.kv_lora_rank, h, m.qk_nope_head_dim)
    assert tuple(model.mtp[0].proj.shape) == (2 * d, d)
    assert plan_segments(cfg_t.layers) == [Run(cfg_t.layers[0], 3, 0),
                                           Run(cfg_t.layers[3], cfg_t.n_layers - 3, 3)]
    n = sum(int(np.prod(s)) for s in shapes)
    assert n == jax_count_params(params_j)
    if size == "full":
        assert n == 671_712_662_528, n
        assert 600e9 <= n <= 750e9, n  # the reference's range (tests/test_configs.py)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
                      (get_config(ARCH).reduced(), jax_get_config(ARCH).reduced()),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe and dataclasses.asdict(lt.moe),
                         lt.use_ffn, lt.cross_source) for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe and dataclasses.asdict(lj.moe), lj.use_ffn,
                      lj.cross_source) for lj in value]
            elif f.name == "mla":
                assert dataclasses.asdict(getattr(got, f.name)) == dataclasses.asdict(value)
            else:
                assert getattr(got, f.name) == value, f.name
    red = get_config(ARCH).reduced(**KW)
    assert red.mla == MLASpec(64, 32, 32, 16, 32) and red.mtp_depth == 1
    assert [lt.moe is None for lt in red.layers] == [True, True, True, False]
    assert {f.name for f in dataclasses.fields(MLASpec)} == \
        {f.name for f in dataclasses.fields(JMLASpec)}


# ------------------------------------------------------------ mla alone
def _mla_inputs(s, seed=4):
    cfg_t, cfg_j, tree, *_ = carried()
    p = {k: v[0] for k, v in tree["stack"][0]["mixer"].items()}  # layer 0 of the run
    rng = np.random.default_rng(seed)
    for name in ("q_a_norm", "kv_a_norm"):  # the reference zero-inits them
        p[name] = (0.1 * rng.standard_normal(p[name].shape)).astype(np.float32)
    x = rng.standard_normal((2, s, cfg_t.d_model)).astype(np.float32)
    return cfg_t, cfg_j, p, x


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,s", [("train", 48), ("prefill", 48), ("train", 160)])
def test_mla_layer_matches_reference(mode, s, dtype):
    """One MLA mixer in training and prefill (160 tokens: the reference
    scans two chunks of ``attn_chunk`` = 128): outputs, the prefill cache
    of capacity ``max(target_len, S + 1)``, and in fp32 training the
    gradients of x and every leaf."""
    cfg_t, cfg_j, p, x = _mla_inputs(s)
    spec_t, spec_j = cfg_t.layers[0], cfg_j.layers[0]
    rel = REL if dtype == "float32" else BF16_REL
    xj, xt = _as(dtype, x)
    pj = {k: jnp.asarray(v) for k, v in p.items()}
    pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
    xt.requires_grad_(dtype == "float32")
    y_j, c_j = jmla.mla_forward(cfg_j, pj, xj, spec_j, mode=mode, target_len=s + 8)
    y_t, c_t = mla.mla_forward(cfg_t, pt, xt, spec_t, mode=mode, target_len=s + 8)
    assert y_t.dtype == xt.dtype
    _close(y_t.detach().float(), np.asarray(y_j, np.float32), rel, "out")
    if mode == "prefill":
        assert list(c_t) == ["c_kv", "k_r", "pos"] and int(c_t["pos"]) == s
        assert c_t["c_kv"].shape == (2, s + 8, cfg_t.mla.kv_lora_rank)
        for name in ("c_kv", "k_r"):
            _close(c_t[name].detach().float(), np.asarray(c_j[name], np.float32), rel, name)
        return
    assert c_t is None
    if dtype == "float32":
        cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
        g_j = jax.grad(lambda p_, x_: jnp.sum(jmla.mla_forward(cfg_j, p_, x_, spec_j)[0]
                                              * cot), argnums=(0, 1))(pj, xj)
        grads = torch.autograd.grad((y_t * torch.from_numpy(cot)).sum(), [*pt.values(), xt])
        for (name, a), b in zip([*pt.items(), ("x", None)], grads):
            want = g_j[1] if name == "x" else g_j[0][name]
            _close(b, want, REL, f"grad {name}")
            assert torch.count_nonzero(b) > 0, name


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_absorbed_decode_from_reference_caches_per_row(dtype):
    """The reference's prefill caches (40 tokens, capacity 56) with
    per-row positions — the serving slab's layout, row 1 seven tokens
    behind (its later slots stale, masked until written) — through 8
    absorbed decode steps of the whole model in both packages: logits,
    the latent caches written in place at ``pos % cap``, and ``pos``."""
    cfg_t, cfg_j, _, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    rel = REL if dtype == "float32" else BF16_REL
    toks = np.random.default_rng(0).integers(0, cfg_t.vocab, size=(2, 48))
    _, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :40]), target_len=56)
    row_pos = np.array([40, 33], np.int32)
    want = [{k: (np.broadcast_to(row_pos, v.shape + (2,)).copy() if k == "pos" else
                 np.asarray(v)) for k, v in seg.items()} for seg in caches_j]
    assert [w["c_kv"].shape for w in want] == [(3, 2, 56, 32), (2, 56, 32)]
    assert [w["pos"].shape for w in want] == [(3, 2), (2,)]
    caches_j = jax.tree.map(jnp.asarray, want)
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    assert caches_t[0]["c_kv"].dtype == getattr(torch, dtype)
    for t in range(40, 48):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]))
        logits_t, caches_t = decode_step(cfg_t, model, caches_t,
                                         torch.from_numpy(toks[:, t:t + 1]))
        _close(logits_t.float(), np.asarray(logits_j, np.float32), rel,
               f"decode logits at {t}")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, np.asarray(w, np.float32), rel, "decoded cache")
    np.testing.assert_array_equal(caches_t[1]["pos"].numpy(), row_pos + 8)


# -------------------------------------------------------------- the model
def _reference_routes(monkeypatch):
    """Record the reference's expert indices, one array per MoE layer call."""
    want, j_top = [], jmoe._top_k

    def j_rec(x, k):  # traced: a host callback
        out = j_top(x, k)
        jax.debug.callback(lambda i: want.append(np.asarray(i)), out[1], ordered=True)
        return out

    monkeypatch.setattr(jmoe, "_top_k", j_rec)
    return want


def _follow_routes(monkeypatch, want):
    """Make the port's MoE calls take the reference's expert indices, in
    call order (the gate values gathered from the port's own scores), and
    record the share of tokens whose own top-k agreed."""
    agree, t_top, routes = [], moe.top_k, iter(want)

    def forced(x, k):
        _, idx = t_top(x, k)
        ref = torch.from_numpy(next(routes).astype(np.int64))
        agree.append(float((idx == ref).all(-1).float().mean()))
        return torch.gather(x, -1, ref), ref

    monkeypatch.setattr(moe, "top_k", forced)
    return agree


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_metrics_and_every_leaf_gradient_match_jax(dtype, monkeypatch):
    """Logits, ``loss``, ``xent``, ``aux`` and ``mtp`` (0.3 · mtp / depth
    in the loss) and the gradient of every leaf, the MTP module's
    included.  Routing is compared first: in fp32 every token's experts
    are the reference's; with bf16 activations three MLA layers of
    rounding ahead of the sigmoid router flip a few near-ties (2 of 96
    tokens measured), so the port takes the reference's indices — at
    least 95% of them its own — and the numbers are compared on equal
    routes."""
    cfg_t, cfg_j, _, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens = _tokens(cfg_t)
    logit_rel, grad_rel, loss_rel = (REL, REL, REL) if dtype == "float32" else \
        (BF16_REL, BF16_GRAD_REL, BF16_LOSS_REL)
    want = _reference_routes(monkeypatch)
    logits_j = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    jax.effects_barrier()
    assert len(want) == 2  # the one MoE layer, in two calls
    agree = _follow_routes(monkeypatch, want)
    with torch.no_grad():
        logits_t, _, aux_t, _ = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))
    loss_t, metrics_t = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert len(agree) == 2 and min(agree) >= (1.0 if dtype == "float32" else 0.95), agree
    assert logits_t.dtype == getattr(torch, dtype) and float(aux_t) > 0
    _close(logits_t.float(), logits_j, logit_rel, "logits")
    assert sorted(metrics_t) == sorted(metrics_j) == ["aux", "loss", "mtp", "xent"]
    for key in metrics_t:
        want_v = float(metrics_j[key])
        assert abs(metrics_t[key].item() - want_v) <= loss_rel * abs(want_v), key
    m = {k: v.item() for k, v in metrics_t.items()}
    assert m["loss"] == pytest.approx(m["xent"] + 0.3 * m["mtp"] + m["aux"], rel=1e-6)
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j),
                              strict=True):
        assert g_t.dtype == torch.float32
        _close(g_t, g_j, grad_rel, path)
        if path.startswith("mtp.") or path.endswith(("wq_b", "wk_b", "wv_b", "router")):
            assert torch.count_nonzero(g_t) > 0, path


def test_mtp_skipped_at_two_tokens():
    """With 2 tokens per row there is no token t+2 to predict: no ``mtp``
    metric, the loss is xent + aux, and the MTP leaves get no gradient —
    as in the reference."""
    cfg_t, cfg_j, _, jparams, model = carried()
    tokens = _tokens(cfg_t, seq=1)
    assert tokens.shape[1] == 2
    (loss_j, metrics_j), grads_j = jax.value_and_grad(
        lambda p: jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)}),
        has_aux=True)(jparams)
    loss_t, metrics_t = train_loss(cfg_t, model, {"tokens": tokens})
    assert sorted(metrics_t) == sorted(metrics_j) == ["aux", "loss", "xent"]
    assert abs(loss_t.item() - float(loss_j)) <= REL * abs(float(loss_j))
    grads_t = torch.autograd.grad(loss_t, model.leaves(), allow_unused=True)
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j)):
        if path.startswith("mtp."):
            assert g_t is None and not np.any(np.asarray(g_j)), path
        else:
            _close(g_t, g_j, REL, path)


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_remat_gradients_bit_equal(remat):
    cfg_t, *_, model = carried()
    tokens = _tokens(cfg_t)

    def grads(cfg):
        loss, _ = train_loss(cfg, model, {"tokens": tokens})
        return loss, torch.autograd.grad(loss, model.leaves())

    loss0, g0 = grads(cfg_t)
    loss1, g1 = grads(cfg_t.replace(remat=remat))
    assert torch.equal(loss0, loss1)
    for path, a, b in zip(model.leaf_paths(), g0, g1):
        assert torch.equal(a, b), path


def test_reset_parameters_follow_the_reference_init_law():
    """Zeros where the reference zero-inits (``q_a_norm``, ``kv_a_norm``,
    every norm scale, the MTP norms); elsewhere the dense-init law, fan-in
    the product of all but the last axis of the per-layer shape — for
    ``wq_b`` at DeepSeek-V3's published MLA widths 1536·128 — at a width
    of 128 so the mixer is small."""
    cfg_t, _, tree, *_ = carried()
    model = GCLM(cfg_t, device="cpu", seed=3)
    zero_ref = {p for p, leaf in zip(model.leaf_paths(), jax.tree.leaves(tree))
                if not np.any(leaf)}
    zero = {".".join(p) for p, t in model.leaf_items() if not torch.any(t)}
    assert zero == zero_ref
    assert {"stack.0.mixer.q_a_norm", "stack.1.mixer.kv_a_norm", "mtp.0.norm_e.scale",
            "mtp.0.norm_h.scale", "mtp.0.layer.mixer.q_a_norm"} <= zero
    full = get_config(ARCH)
    cfg = cfg_t.replace(n_layers=1, layers=cfg_t.layers[:1], n_heads=full.n_heads,
                        n_kv_heads=full.n_kv_heads, mla=full.mla, mtp_depth=0)
    mixer = GCLM(cfg, device="cpu", seed=0).stack[0].mixer
    m = full.mla
    for name, fan_in in (("wq_b", 1536 * 128), ("wk_b", 512 * 128), ("wv_b", 512 * 128),
                         ("wo", 128 * 128), ("wq_a", 128), ("wkv_a", 128)):
        t = getattr(mixer, name).detach()
        std = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 * std * (1 + 1e-6), name
        assert abs(float(t.std()) / std - 0.8796) < 0.03, name  # truncated at +-2
    assert tuple(mixer.wq_b.shape) == (m.q_lora_rank, 128,
                                       m.qk_nope_head_dim + m.qk_rope_head_dim)
    proj = model.mtp[0].proj.detach()
    assert abs(float(proj.std()) * np.sqrt(2 * cfg_t.d_model) - 0.8796) < 0.03


# -------------------------------------------------------------- training
def test_plan_json_and_autotune_at_full_width_on_meta(monkeypatch):
    """``Plan.build`` of the full 61-layer model (MTP leaves included) on
    the meta device and the autotuner through ``abstract_train_state``
    equal the reference's (the port's ``HW`` at the reference's
    constants)."""
    monkeypatch.setattr(tmesh.HW, "HBM_BW", JHW.HBM_BW)
    monkeypatch.setattr(tmesh.HW, "ICI_BW", JHW.ICI_BW)
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    model = abstract_train_state(cfg_t).params
    shapes = j_abstract_train_state(cfg_j)[0].params
    plan_t = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    plan_j = JPlan.build(shapes, JShiftedExp(**SE), N, scheme="xf")
    assert json.dumps(plan_t.to_dict(), sort_keys=True) == \
        json.dumps(plan_j.to_dict(), sort_keys=True)
    env_t, env_j = Env.iid(ShiftedExponential(**SE), N), JEnv.iid(JShiftedExp(**SE), N)
    kw = dict(global_batch=8, seq_len=256, steps=40, seed=0, schemes=("xf", "uniform"))
    res_t = autotune(cfg_t, env_t, MemBudget.from_gb(20000.0), device="cpu", **kw)
    res_j = j_autotune(cfg_j, env_j, JMemBudget.from_gb(20000.0), **kw)
    assert res_t.report.table() == res_j.report.table()
    assert res_t.plan.to_dict() == res_j.plan.to_dict()


def test_coded_grads_equal_uncoded_every_straggler_count():
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


def test_three_trainer_steps_match_reference_trainer():
    cfg_t, cfg_j, tree, *_ = carried()
    seq = 32
    ref = JTrainer(cfg_j, JTrainConfig(warmup=1, total_steps=10), JShiftedExp(**SE),
                   n_workers=N, scheme="xf", global_batch=8, seed=0)
    ref.data = JSyntheticTokens(JDataConfig(vocab=cfg_j.vocab, seq_len=seq, global_batch=8,
                                            seed=0))
    ref.state = ref.state._replace(params=jax.tree.map(jnp.asarray, tree))
    ours = Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10), ShiftedExponential(**SE),
                   n_workers=N, scheme="xf", global_batch=8, seed=0, device="cpu",
                   params=tree, seq_len=seq)
    assert ours.plan.to_dict() == ref.plan.to_dict()
    _, sum_t = ours.run(3, log_every=0)
    _, sum_j = ref.run(3, log_every=0)
    assert sum_t == sum_j
    for ht, hj in zip(ours.history, ref.history, strict=True):
        assert (ht["step"], ht["tau_coded"], ht["tau_uncoded"]) == \
            (hj["step"], hj["tau_coded"], hj["tau_uncoded"])
        for key in ("loss", "xent", "aux", "mtp", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.state.params)),
                    strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


def _trainer(mesh=None):
    cfg_t = get_config(ARCH).reduced(**KW)
    return Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10), ShiftedExponential(**SE),
                   n_workers=N, scheme="xf", global_batch=8, seed=0, device="cpu", seq_len=16,
                   mesh=mesh, mode="sim" if mesh is None else "spmd")


def _spmd_rank(rank, world):
    torch.set_num_threads(1)
    tr = _trainer(make_local_mesh(data=world, device="cpu"))
    tr.run(2, log_every=0)
    return [h["loss"] for h in tr.history], [h["mtp"] for h in tr.history], tr.state.digest()


def test_spmd_trainer_matches_sim_mode(tmp_path):
    """Four gloo ranks, each a ``Trainer(mode="spmd")`` running its own K
    per-shard passes (the MTP term included) and one collective per
    level: every rank ends with the same bytes, and the losses are sim
    mode's."""
    sim = _trainer()
    sim.run(2, log_every=0)
    out = dist_spawn.spawn(_spmd_rank, N, store_dir=str(tmp_path), timeout=240.0)
    assert len({digest for *_, digest in out}) == 1
    np.testing.assert_allclose(out[0][0], [h["loss"] for h in sim.history], rtol=1e-5)
    np.testing.assert_allclose(out[0][1], [h["mtp"] for h in sim.history], rtol=1e-5)


# -------------------------------------------------------------- serving
ENGINE = dict(n_slots=3, max_len=48, prompt_len=20, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_engine_run_matches_reference():
    """One fp32-slab engine run of each package over the latent caches:
    equal tokens, slots and timestamps; the slab holds ``c_kv``/``k_r``
    rows, 32 + 16 values per token and layer."""
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
    assert all(r.done for r in reqs) and len(eng.finished) == len(reqs)
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        for field in ("t_admit", "t_first", "t_done", "n_steps", "slot", "state"):
            assert getattr(r, field) == getattr(jr, field), field
    assert eng.step_latencies == jeng.step_latencies
    assert eng.now == jeng.now
    assert [sorted(seg) for seg in eng.slab] == [["c_kv", "k_r", "pos"]] * 2
    assert tuple(eng.slab[0]["c_kv"].shape) == (3, ENGINE["n_slots"], ENGINE["max_len"], 32)
    assert tuple(eng.slab[1]["k_r"].shape) == (ENGINE["n_slots"], ENGINE["max_len"], 16)


def test_slab_of_the_full_config_holds_the_latent_only():
    """At published widths the latent cache holds 512 + 64 values per token
    and layer — 1,152 bytes in bf16 — against 2·128·128 K/V values
    (65,536 bytes) for the same heads as plain attention."""
    cfg = get_config(ARCH)
    cfg = cfg.replace(n_layers=4, layers=cfg.layers[:4], mtp_depth=0)
    slab = make_slab(cfg, 2, 16, device="meta")
    assert [tuple(seg["c_kv"].shape) for seg in slab] == [(3, 2, 16, 512), (2, 16, 512)]
    per_token = sum(t.element_size() * t.shape[-1] * (t.shape[0] if t.ndim == 4 else 1)
                    for seg in slab for k, t in seg.items() if k != "pos")
    assert per_token == 4 * (512 + 64) * 2 == 4608
    assert 4 * 2 * cfg.n_heads * cfg.head_dim * 2 == 262_144


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_deepseek_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")


def test_train_launcher_runs_deepseek_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and out.count("\nstep ") == 2
