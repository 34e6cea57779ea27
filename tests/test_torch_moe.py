"""The port's mixture-of-experts FFN (``models/moe.py``) and Mixtral
against the JAX reference, on the CPU.

``moe.py`` alone is held to ``repro/models/moe.py::_moe_core`` on numpy
inputs: Mixtral's softmax top-2 of 8, a DeepSeek-style spec (sigmoid,
top-8 of 16, one shared expert) and a forced-drop case (capacity factor
1.25, the router biased toward expert 0); rows of zeros make every
expert tie, so the tie order of ``top_k`` is exercised.  The model is
``mixtral-8x22b.reduced(n_layers=2, d_model=128, seq_cap=64)`` (4
experts top-2, windows of 32, capacity factor 8: no drops), the
reference's initialized weights carried with ``params_from_numpy`` and
its caches with ``caches_from_numpy``.

Tolerances:

* fp32 — the MoE layer's output, aux loss and gradients, logits, loss,
  every leaf's gradient, prefill and decode logits and caches — 1e-5 of
  each tensor's largest entry (the same fp32 math, sums in another
  order); expert indices and the keep mask: equal;
* bf16 activations: routing may flip on near-ties between XLA and torch
  (each rounds at other points), so expert indices are compared first,
  then outputs on the tokens routed alike.  Measured on the CPU: the
  MoE layer alone routes every token alike (the test asks for 95%) and
  its output differs by 5.05e-3 of the largest entry (bound
  ``BF16_MOE_REL`` = 2e-2); the 2-layer model routes every token alike
  (asserted), logits 6.98e-3, gradients 1.13e-2 of each leaf's largest,
  loss 2.08e-4 relative — held at ``test_torch_gemma.py``'s bounds
  (5e-2, 1e-1, 1e-3);
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), against the reference's coded: 1e-5 — also at a
  capacity factor of 0.5, where every shard's pass drops assignments;
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
from repro.configs.base import MoESpec as JMoESpec
from repro.core import Env as JEnv
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.launch.mesh import HW as JHW
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.models.params import count_params as jax_count_params
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.coded import make_coded_grad_fn as jax_coded_grad_fn
from repro.train.state import abstract_train_state as j_abstract_train_state
from repro.train.state import init_train_state
from repro.tune import MemBudget as JMemBudget
from repro.tune import autotune as j_autotune
from repro_torch.configs import MoESpec, get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.models.stack import Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.state import abstract_train_state
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tune import MemBudget, autotune

ARCH = "mixtral-8x22b"
KW = dict(n_layers=2, d_model=128, seq_cap=64)
REL = 1e-5
BF16_MOE_REL = 2e-2
BF16_LOGITS_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
N = 4
SE = dict(mu=1e-3, t0=50.0)
#: the MoE layer alone: (spec, router bias toward expert 0)
SPECS = {
    "mixtral": (dict(num_experts=8, top_k=2, d_ff=48, capacity_factor=8.0), 0.0),
    "deepseek": (dict(num_experts=16, top_k=8, d_ff=32, num_shared=1, router="sigmoid",
                      capacity_factor=8.0), 0.0),
    "drop": (dict(num_experts=8, top_k=2, d_ff=48, capacity_factor=1.25), 0.5),
}


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
    """(cfg_t, cfg_j, numpy tree, jax params, model) of reduced Mixtral,
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
    assert paths[:2] == ["embed.tok", "embed.unembed"]
    assert [p for p in paths if ".ffn." in p] == [f"stack.0.ffn.{n}"
                                                 for n in ("router", "wg", "wi", "wo")]
    e, f, d = cfg_t.layers[0].moe.num_experts, cfg_t.layers[0].moe.d_ff, cfg_t.d_model
    count = cfg_t.n_layers
    assert tuple(model.stack[0].ffn.wi.shape) == (count, e, d, f)
    assert tuple(model.stack[0].ffn.wo.shape) == (count, e, f, d)
    assert plan_segments(cfg_t.layers) == [Run(cfg_t.layers[0], count, 0)]
    if size == "full":
        n = sum(int(np.prod(s)) for s in shapes)
        assert n == jax_count_params(params_j)
        assert 120e9 <= n <= 160e9, n  # the reference's range (tests/test_configs.py)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, dataclasses.asdict(lt.moe), lt.use_ffn,
                         lt.cross_source) for lt in got.layers] == \
                    [(lj.mixer, lj.window, dataclasses.asdict(lj.moe), lj.use_ffn,
                      lj.cross_source) for lj in value]
            else:
                assert getattr(got, f.name) == value, f.name
    moe_t = get_config(ARCH).reduced(**KW).layers[0].moe
    assert (moe_t.num_experts, moe_t.top_k, moe_t.d_ff, moe_t.capacity_factor) == \
        (4, 2, 341, 8.0)
    assert {f.name for f in dataclasses.fields(MoESpec)} == \
        {f.name for f in dataclasses.fields(JMoESpec)}


# ------------------------------------------------------------ moe alone
@pytest.mark.parametrize("n_tokens", [1, 8, 33, 100, 4352])
def test_capacity_matches_reference(n_tokens):
    for kw, _ in SPECS.values():
        assert moe.capacity(n_tokens, MoESpec(**kw)) == jmoe._capacity(n_tokens, JMoESpec(**kw))
    assert moe.capacity(4352, MoESpec(8, 2, 16384, capacity_factor=1.25)) == 1360
    assert moe.capacity(8, MoESpec(8, 2, 16384, capacity_factor=1.25)) == 8


def test_top_k_tie_order_matches_reference():
    """Rows of small integers tie often; the first maximal index wins,
    as in ``jax.lax.top_k`` and the reference's ``_top_k``."""
    x = np.random.default_rng(2).integers(0, 3, size=(64, 8)).astype(np.float32)
    x[0] = 1.0  # every entry ties
    for k in (1, 2, 8):
        vals, idx = moe.top_k(torch.from_numpy(x), k)
        jvals, jidx = jmoe._top_k(jnp.asarray(x), k)
        lvals, lidx = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(lidx))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(lvals))
    assert moe.top_k(torch.from_numpy(x), 8)[1][0].tolist() == list(range(8))


def _moe_inputs(name, dtype=np.float32, b=2, s=24, d=64, seed=0):
    kw, bias = SPECS[name]
    spec_t = dataclasses.replace(get_config(ARCH).layers[0], moe=MoESpec(**kw))
    spec_j = dataclasses.replace(jax_get_config(ARCH).layers[0], moe=JMoESpec(**kw))
    e, f = kw["num_experts"], kw["d_ff"]
    rng = np.random.default_rng(seed)

    def w(*shape, fan_in):
        return (rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32)

    p = {"router": w(d, e, fan_in=d), "wi": w(e, d, f, fan_in=d), "wg": w(e, d, f, fan_in=d),
         "wo": w(e, f, d, fan_in=f)}
    p["router"][:, 0] += bias  # toward expert 0: with x's positive mean, expert 0 overflows
    if kw.get("num_shared"):
        fs = f * kw["num_shared"]
        p["shared"] = {"wi": w(d, fs, fan_in=d), "wg": w(d, fs, fan_in=d),
                       "wo": w(fs, d, fan_in=fs)}
    x = (rng.standard_normal((b, s, d)) + (0.3 if bias else 0.0)).astype(np.float32)
    x[0, :3] = 0.0  # zero rows: every expert ties
    return spec_t, spec_j, p, x


def _stream_keep(idx, cap):
    """Plain reference of the drop rule: an assignment is kept when fewer
    than ``cap`` assignments before it in the token-major (t·k) stream
    chose its expert."""
    seen, keep = {}, []
    for e in np.asarray(idx).reshape(-1):
        keep.append(seen.get(int(e), 0) < cap)
        seen[int(e)] = seen.get(int(e), 0) + 1
    return np.asarray(keep)


@pytest.mark.parametrize("name", list(SPECS))
def test_moe_layer_matches_reference(name):
    """Outputs, aux, the expert indices, the keep mask and the gradients of
    x and every weight, at fp32 1e-5."""
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    spec_t, spec_j, p, x = _moe_inputs(name)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)

    def jloss(p_, x_):
        out, aux = jmoe._moe_core(cfg_j, p_, x_, spec_j)
        return jnp.sum(out * cot) + aux, (out, aux)

    (_, (out_j, aux_j)), (gp_j, gx_j) = jax.value_and_grad(jloss, argnums=(0, 1),
                                                           has_aux=True)(
        jax.tree.map(jnp.asarray, p), jnp.asarray(x))
    p_t = jax.tree.map(lambda a: torch.tensor(a, requires_grad=True), p)
    x_t = torch.tensor(x, requires_grad=True)
    out_t, aux_t = moe.apply_moe(cfg_t, p_t, x_t, spec_t)
    assert out_t.dtype == torch.float32 and aux_t.dtype == torch.float32
    _close(out_t.detach(), out_j, what="out")
    _close(aux_t.detach(), aux_j, what="aux")
    leaves_t = jax.tree.leaves(p_t)
    grads = torch.autograd.grad((out_t * torch.from_numpy(cot)).sum() + aux_t,
                                leaves_t + [x_t])
    for g_t, g_j, what in zip(grads, jax.tree.leaves(gp_j) + [gx_j],
                              [".".join(str(getattr(k, "key", k)) for k in path)
                               for path, _ in jax.tree_util.tree_flatten_with_path(p)[0]]
                              + ["x"], strict=True):
        _close(g_t, g_j, what=f"grad {what}")

    # routing: the reference's indices from its own top-k, its keep by the
    # drop rule on them
    moe_spec = spec_t.moe
    xt = x.reshape(-1, x.shape[-1])
    r = moe.route({"router": torch.from_numpy(p["router"])}, torch.from_numpy(xt), moe_spec)
    logits = jnp.asarray(xt) @ jnp.asarray(p["router"])
    scores = jax.nn.sigmoid(logits) if moe_spec.router == "sigmoid" else \
        jax.nn.softmax(logits, axis=-1)
    _, idx_j = jmoe._top_k(scores, moe_spec.top_k)
    np.testing.assert_array_equal(r.idx.numpy(), np.asarray(idx_j))
    assert r.idx[:3].tolist() == [list(range(moe_spec.top_k))] * 3  # zero rows: ties
    assert r.cap == jmoe._capacity(xt.shape[0], spec_j.moe)
    keep = _stream_keep(idx_j, r.cap)
    np.testing.assert_array_equal(r.keep.numpy().astype(bool), keep)
    assert (not keep.all()) == (name == "drop")
    if name == "drop":  # dropped assignments contribute nothing
        assert int((~keep).sum()) > 0 and r.dest.max() < moe_spec.num_experts * r.cap


def test_moe_layer_bf16_routes_first_then_outputs():
    cfg_t, cfg_j = get_config(ARCH), jax_get_config(ARCH)
    spec_t, spec_j, p, x = _moe_inputs("mixtral", s=64)
    xb = jnp.asarray(x, jnp.bfloat16)
    xt = torch.tensor(np.asarray(xb.astype(jnp.float32))).to(torch.bfloat16)
    r = moe.route({"router": torch.from_numpy(p["router"])}, xt.reshape(-1, 64), spec_t.moe)
    logits = (xb.reshape(-1, 64) @ jnp.asarray(p["router"]).astype(jnp.bfloat16)).astype(
        jnp.float32)
    _, idx_j = jmoe._top_k(jax.nn.softmax(logits, axis=-1), 2)
    same = np.all(r.idx.numpy() == np.asarray(idx_j), axis=-1)
    assert same.mean() >= 0.95, same.mean()
    out_j, aux_j = jmoe._moe_core(cfg_j, jax.tree.map(jnp.asarray, p), xb, spec_j)
    out_t, aux_t = moe.apply_moe(cfg_t, jax.tree.map(torch.from_numpy, p), xt, spec_t)
    assert out_t.dtype == torch.bfloat16
    rows = same.reshape(x.shape[:2])
    _close(out_t.float().numpy()[rows], np.asarray(out_j, np.float32)[rows], BF16_MOE_REL,
           "bf16 out on tokens routed alike")
    _close(aux_t, aux_j, BF16_MOE_REL, "bf16 aux")


# -------------------------------------------------------------- the model
def _record_routes(monkeypatch):
    """Record every call's expert indices in both packages, in layer order."""
    got, want = [], []
    t_top, j_top = moe.top_k, jmoe._top_k

    def t_rec(x, k):
        out = t_top(x, k)
        got.append(out[1].detach().numpy().copy())
        return out

    def j_rec(x, k):  # traced inside the reference's scan: a host callback
        out = j_top(x, k)
        jax.debug.callback(lambda i: want.append(np.asarray(i)), out[1], ordered=True)
        return out

    monkeypatch.setattr(moe, "top_k", t_rec)
    monkeypatch.setattr(jmoe, "_top_k", j_rec)
    return got, want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_aux_and_every_leaf_gradient_match_jax(dtype, monkeypatch):
    cfg_t, cfg_j, _, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens = _tokens(cfg_t)
    logit_rel, grad_rel, loss_rel = (REL, REL, REL) if dtype == "float32" else \
        (BF16_LOGITS_REL, BF16_GRAD_REL, BF16_LOSS_REL)
    got, want = _record_routes(monkeypatch)
    logits_j, _, aux_j, _ = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))
    jax.effects_barrier()
    with torch.no_grad():
        logits_t, _, aux_t, _ = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))
    assert len(got) == len(want) == cfg_t.n_layers
    for layer, (a, b) in enumerate(zip(got, want)):  # routing first
        np.testing.assert_array_equal(a, b, err_msg=f"layer {layer} experts")
    assert logits_t.dtype == getattr(torch, dtype)
    _close(logits_t.float(), logits_j, logit_rel, "logits")
    assert float(aux_t) > 0 and abs(float(aux_t) - float(aux_j)) <= loss_rel * float(aux_j)

    def loss_fn(p):
        return jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)})

    (loss_j, metrics_j), grads_j = jax.value_and_grad(loss_fn, has_aux=True)(jparams)
    loss_t, metrics_t = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert abs(loss_t.item() - float(loss_j)) <= loss_rel * abs(float(loss_j))
    assert abs(metrics_t["aux"].item() - float(metrics_j["aux"])) <= \
        loss_rel * float(metrics_j["aux"])
    assert loss_t.item() == pytest.approx(metrics_t["xent"].item() + metrics_t["aux"].item(),
                                          rel=1e-6)
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j),
                              strict=True):
        assert g_t.dtype == torch.float32
        _close(g_t, g_j, grad_rel, path)
    assert torch.count_nonzero(grads_t[model.leaf_paths().index("stack.0.ffn.router")]) > 0


def test_prefill_and_ring_decode_match_jax():
    """Prefill of 48 tokens, past the reduced window of 32 (the rings of
    32 are rolled), then 8 decode steps (batch 2: capacity 8, no drop)
    from the reference's caches."""
    cfg_t, cfg_j, _, jparams, model = carried()
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
    assert {int(leaf.shape[-3]) for leaf in jax.tree.leaves(want) if leaf.ndim >= 4} == {32}
    caches_t = caches_from_numpy(cfg_t, want, device="cpu")
    for t in range(48, 56):
        logits_j, caches_j = jmodel.decode_step(cfg_j, jparams, caches_j,
                                                jnp.asarray(toks[:, t:t + 1]))
        logits_t, caches_t = decode_step(cfg_t, model, caches_t,
                                         torch.from_numpy(toks[:, t:t + 1]))
        _close(logits_t, logits_j, what=f"decode logits at {t}")
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)),
                    jax.tree.leaves(jax.tree.map(np.asarray, caches_j)), strict=True):
        if g.dtype == np.int32:
            np.testing.assert_array_equal(g, w)
        else:
            _close(g, w, what="decoded cache")


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


def test_reset_parameters_follow_the_dense_init_law():
    """The expert leaves' fan-in is the product of all but the last axis of
    the per-layer shape (E·d for wi/wg, E·f for wo), as the reference's
    ``dense_init``; norm scales start at zero, the untied head is drawn."""
    cfg_t, _, tree, *_ = carried()
    model = GCLM(cfg_t, device="cpu", seed=3)
    zero_ref = {p for p, leaf in zip(model.leaf_paths(), jax.tree.leaves(tree))
                if not np.any(leaf)}
    assert {".".join(p) for p, t in model.leaf_items() if not torch.any(t)} == zero_ref
    e, f, d = 4, 341, 128
    for name, fan_in in (("wi", e * d), ("wg", e * d), ("wo", e * f), ("router", d)):
        t = getattr(model.stack[0].ffn, name).detach()
        std = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 * std * (1 + 1e-6), name
        assert abs(float(t.std()) / std - 0.8796) < 0.03, name  # truncated at +-2
        ref = tree["stack"][0]["ffn"][name]
        assert abs(float(t.std()) / float(ref.std()) - 1.0) < 0.03, name
    head = model.embed.unembed.detach()
    assert abs(float(head.std()) * np.sqrt(d) - 0.8796) < 0.03


# -------------------------------------------------------------- training
def test_plan_json_and_autotune_at_full_width_on_meta(monkeypatch):
    """``Plan.build`` of the full 56-layer model on the meta device and
    the autotuner through ``abstract_train_state`` equal the reference's
    (the port's ``HW`` at the reference's constants)."""
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
    res_t = autotune(cfg_t, env_t, MemBudget.from_gb(4000.0), device="cpu", **kw)
    res_j = j_autotune(cfg_j, env_j, JMemBudget.from_gb(4000.0), **kw)
    assert res_t.report.table() == res_j.report.table()
    assert res_t.plan.to_dict() == res_j.plan.to_dict()


@pytest.mark.parametrize("capacity_factor", [8.0, 0.5])
def test_coded_grads_equal_uncoded_every_straggler_count(capacity_factor):
    cfg_t, cfg_j, tree, jparams, model = carried()
    layers_t = tuple(dataclasses.replace(l, moe=dataclasses.replace(
        l.moe, capacity_factor=capacity_factor)) for l in cfg_t.layers)
    layers_j = tuple(dataclasses.replace(l, moe=dataclasses.replace(
        l.moe, capacity_factor=capacity_factor)) for l in cfg_j.layers)
    cfg_t, cfg_j = cfg_t.replace(layers=layers_t), cfg_j.replace(layers=layers_j)
    plan_t = Plan.build(model, ShiftedExponential(**SE), N, scheme="xf")
    plan_j = JPlan.build(jparams, JShiftedExp(**SE), N, scheme="xf")
    assert plan_t.to_dict() == plan_j.to_dict()
    data = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=32, global_batch=8))
    wb = coded_worker_batches(data, 0, N, plan_t.s_max)
    shards = np.stack([data.shard(0, i, N) for i in range(N)])
    if capacity_factor < 1:  # 2 x 32 tokens per pass: 128 assignments, 4 x 16 slots
        assert moe.capacity(64, layers_t[0].moe) * 4 < 64 * 2
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


def _trainer(mesh=None):
    cfg_t = get_config(ARCH).reduced(**KW)
    return Trainer(cfg_t, TrainConfig(warmup=1, total_steps=10), ShiftedExponential(**SE),
                   n_workers=N, scheme="xf", global_batch=8, seed=0, device="cpu", seq_len=16,
                   mesh=mesh, mode="sim" if mesh is None else "spmd")


def _spmd_rank(rank, world):
    torch.set_num_threads(1)
    tr = _trainer(make_local_mesh(data=world, device="cpu"))
    tr.run(2, log_every=0)
    return [h["loss"] for h in tr.history], tr.state.digest()


def test_spmd_trainer_matches_sim_mode(tmp_path):
    """Four gloo ranks, each a ``Trainer(mode="spmd")`` running its own K
    per-shard passes (aux term included) and one collective per level:
    every rank ends with the same bytes, and the losses are sim mode's."""
    sim = _trainer()
    sim.run(2, log_every=0)
    out = dist_spawn.spawn(_spmd_rank, N, store_dir=str(tmp_path), timeout=240.0)
    assert len({digest for _, digest in out}) == 1
    np.testing.assert_allclose(out[0][0], [h["loss"] for h in sim.history], rtol=1e-5)


# -------------------------------------------------------------- serving
ENGINE = dict(n_slots=3, max_len=48, prompt_len=36, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_engine_run_matches_reference():
    """One fp32-slab engine run of each package: prompts of 36 past the
    window of 32, equal tokens, slots and timestamps."""
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
    ring = eng.slab[0]
    assert ring["k"].shape[2] == 32 and int(ring["pos"].max()) > 32


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_mixtral_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(
        f"{ARCH}: (2, 11) in ")


def test_train_launcher_runs_mixtral_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and out.count("\nstep ") == 2
