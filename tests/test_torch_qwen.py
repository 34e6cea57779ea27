"""The port's Qwen 1.5 (QKV biases, an untied head) against the JAX
reference, on the CPU.

``qwen1.5-32b.reduced(n_layers=2, d_model=128, seq_cap=64)``: one run of
2 global-attention layers, 4 heads over 2 KV heads, the untied
``embed.unembed`` (128, 512).  The reference initializes the biases to
zero, which would leave their path untested, so the carried tree sets
``bq``/``bk``/``bv`` to seeded normal values (std 0.02) on both sides;
the reference's weights are carried with ``params_from_numpy`` and its
caches with ``caches_from_numpy``.

Tolerances:

* fp32 — projections, logits, loss, every leaf's gradient (the biases'
  included), prefill and decode logits and caches — 1e-5 of each
  tensor's largest entry (the same fp32 math, sums in another order);
* bf16 activations: XLA keeps excess precision between fused bf16 ops,
  torch rounds each op.  Measured on the CPU: the biased projections
  and the untied head bit-equal, logits 1.44e-2 of the largest entry,
  gradients 1.90e-2 of each leaf's largest, loss 9.8e-5 relative — held
  at ``test_torch_gemma.py``'s bounds (projections and logits 5e-2,
  gradients 1e-1, loss 1e-3);
* remat ("dots", "full") against "none": bit-equal;
* sim-mode coded gradients against the uncoded mean: 1e-4 per leaf (the
  repo's gate), against the reference's coded: 1e-5; three trainer steps
  against the reference trainer: losses 1e-5 relative, parameters 2e-5
  absolute (AdamW's normalized step m/sqrt(v) turns a last-bit
  difference of a near-zero gradient entry into a visible update
  difference: measured up to 5.24e-6 in the key bias ``bk``, whose
  gradient is near zero — a bias on every key barely moves the softmax
  — and at most 1.2e-7 in every other leaf);
* plan JSON, autotune reports, the engine's tokens, slots and
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
from repro.launch.mesh import HW as JHW
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models import model as jmodel
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
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import attention, layers
from repro_torch.models.model import decode_step, forward, prefill, train_loss
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy
from repro_torch.models.stack import Run, plan_segments
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy)
from repro_torch.train.coded import make_coded_grad_fn, uncoded_grad_fn
from repro_torch.train.state import abstract_train_state
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.tune import MemBudget, autotune

ARCH = "qwen1.5-32b"
KW = dict(n_layers=2, d_model=128, seq_cap=64)
REL = 1e-5
BF16_REL = 5e-2
BF16_GRAD_REL = 1e-1
BF16_LOSS_REL = 1e-3
N = 4
SE = dict(mu=1e-3, t0=50.0)


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


def _set_biases(tree, seed=3):
    """Seeded normal biases (std 0.02) in place of the reference's zeros."""
    rng = np.random.default_rng(seed)
    for seg in tree["stack"]:
        for name in ("bq", "bk", "bv"):
            seg["mixer"][name] = (0.02 * rng.standard_normal(seg["mixer"][name].shape)
                                  ).astype(np.float32)
    return tree


_CARRIED = {}


def carried():
    """(cfg_t, cfg_j, numpy tree, jax params, model) of reduced Qwen with
    nonzero biases, built once per module."""
    if not _CARRIED:
        cfg_t, cfg_j = get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)
        state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
        tree = _set_biases(jax.tree.map(np.array, state.params))
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
    assert [p for p in paths if ".mixer." in p] == [
        f"stack.0.mixer.{n}" for n in ("bk", "bq", "bv", "wk", "wo", "wq", "wv")]
    h, kv, dh, d = cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.head_dim, cfg_t.d_model
    assert tuple(model.stack[0].mixer.bq.shape) == (cfg_t.n_layers, h, dh)
    assert tuple(model.stack[0].mixer.bk.shape) == (cfg_t.n_layers, kv, dh)
    assert tuple(model.embed.unembed.shape) == (d, cfg_t.vocab)
    assert plan_segments(cfg_t.layers) == [Run(cfg_t.layers[0], cfg_t.n_layers, 0)]
    if size == "full":
        n = sum(int(np.prod(s)) for s in shapes)
        assert n == jax_count_params(params_j)
        assert 28e9 <= n <= 36e9, n  # the reference's range (tests/test_configs.py)


def test_reduced_config_matches_reference():
    for got, want in ((get_config(ARCH).reduced(**KW), jax_get_config(ARCH).reduced(**KW)),
                      (get_config(ARCH), jax_get_config(ARCH))):
        for f in dataclasses.fields(got):
            value = getattr(want, f.name)
            if f.name == "layers":
                assert [(lt.mixer, lt.window, lt.moe, lt.use_ffn, lt.cross_source)
                        for lt in got.layers] == \
                    [(lj.mixer, lj.window, lj.moe, lj.use_ffn, lj.cross_source)
                     for lj in value]
            else:
                assert getattr(got, f.name) == value, f.name
    assert get_config(ARCH).qkv_bias and not get_config(ARCH).tie_embeddings


# -------------------------------------------------------------- numerics
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_biased_projections_and_untied_head_match_jax(dtype):
    """``project_qkv`` adds the biases after the projections in the
    activations' dtype, before RoPE; ``unembed`` reads ``embed.unembed``."""
    cfg_t, cfg_j, tree, *_ = carried()
    rel = REL if dtype == "float32" else BF16_REL
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(4)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 9, 128)), jdt).astype(jnp.float32))
    mixer = {k: v[0] for k, v in tree["stack"][0]["mixer"].items()}
    positions = np.arange(9)[None, :]
    got = attention.project_qkv(cfg_t, {k: torch.from_numpy(v) for k, v in mixer.items()},
                                torch.tensor(x).to(tdt), torch.from_numpy(positions),
                                cfg_t.rope_base)
    want = jattn._project_qkv(cfg_j, {k: jnp.asarray(v) for k, v in mixer.items()},
                              jnp.asarray(x, jdt), jnp.asarray(positions), cfg_j.rope_base)
    for g, w, what in zip(got, want, "qkv"):
        assert g.dtype == tdt
        _close(g.float(), np.asarray(w, np.float32), rel, what)
    no_bias = attention.project_qkv(
        cfg_t, {k: torch.from_numpy(v) for k, v in mixer.items() if not k.startswith("b")},
        torch.tensor(x).to(tdt), torch.from_numpy(positions), cfg_t.rope_base)
    assert not torch.equal(no_bias[2], got[2])  # the biases take part
    embed = {k: torch.from_numpy(v) for k, v in tree["embed"].items()}
    got = layers.unembed(cfg_t, embed, torch.tensor(x).to(tdt))
    want = jlayers.unembed(cfg_j, {k: jnp.asarray(v) for k, v in tree["embed"].items()},
                           jnp.asarray(x, jdt))
    _close(got.float(), np.asarray(want, np.float32), rel, "unembed")
    tied = layers.unembed(cfg_t, {"tok": embed["tok"]}, torch.tensor(x).to(tdt))
    assert tied.shape == got.shape and not torch.equal(tied, got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_loss_and_every_leaf_gradient_match_jax(dtype):
    cfg_t, cfg_j, _, jparams, model = carried()
    cfg_t, cfg_j = cfg_t.replace(dtype=dtype), cfg_j.replace(dtype=dtype)
    tokens = _tokens(cfg_t)
    logit_rel, grad_rel, loss_rel = (REL, REL, REL) if dtype == "float32" else \
        (BF16_REL, BF16_GRAD_REL, BF16_LOSS_REL)

    def loss_fn(p):
        return jmodel.train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)})[0]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jparams)
    logits_j = jmodel.forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
    with torch.no_grad():
        logits_t, _, aux_t, _ = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]))
    assert logits_t.dtype == getattr(torch, dtype) and float(aux_t) == 0.0
    _close(logits_t.float(), logits_j, logit_rel, "logits")
    loss_t, _ = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert abs(loss_t.item() - float(loss_j)) <= loss_rel * abs(float(loss_j))
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j),
                              strict=True):
        assert g_t.dtype == torch.float32
        _close(g_t, g_j, grad_rel, path)
        if path.split(".")[-1] in ("bq", "bv", "unembed"):
            assert torch.count_nonzero(g_t) > 0, path


def test_prefill_and_decode_match_jax():
    """Prefill of 48 tokens into caches of 56, then 8 decode steps from the
    reference's caches: logits and caches match."""
    cfg_t, cfg_j, _, jparams, model = carried()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg_t.vocab, size=(2, 56))
    logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(toks[:, :48]),
                                        target_len=56)
    logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(toks[:, :48]), target_len=56)
    _close(logits_t, logits_j, what="prefill logits")
    want = jax.tree.map(np.asarray, caches_j)
    for g, w in zip(jax.tree.leaves(caches_to_numpy(caches_t)), jax.tree.leaves(want),
                    strict=True):
        _close(g, w, what="prefill cache")
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


def test_reset_parameters_zero_inits_the_biases():
    """The biases start at zero, as the reference's ``zeros_init``; the
    untied head draws the dense-init law (fan-in d_model)."""
    cfg_t, cfg_j, *_ = carried()
    state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    model = GCLM(cfg_t, device="cpu", seed=3)
    zero_ref = {p for p, leaf in zip(model.leaf_paths(), jax.tree.leaves(tree))
                if not np.any(leaf)}
    zero = {".".join(p) for p, t in model.leaf_items() if not torch.any(t)}
    assert zero == zero_ref
    assert {"stack.0.mixer.bq", "stack.0.mixer.bk", "stack.0.mixer.bv"} <= zero
    head = model.embed.unembed.detach()
    assert abs(float(head.std()) * np.sqrt(cfg_t.d_model) - 0.8796) < 0.03


# -------------------------------------------------------------- training
def test_plan_json_and_autotune_at_full_width_on_meta(monkeypatch):
    """``Plan.build`` of the full 64-layer model on the meta device and
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
    res_t = autotune(cfg_t, env_t, MemBudget.from_gb(2000.0), device="cpu", **kw)
    res_j = j_autotune(cfg_j, env_j, JMemBudget.from_gb(2000.0), **kw)
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
        for key in ("loss", "xent", "grad_norm"):
            np.testing.assert_allclose(ht[key], hj[key], rtol=1e-5)
    for a, b in zip(jax.tree.leaves(params_to_numpy(ours.state.params)),
                    jax.tree.leaves(jax.tree.map(np.asarray, ref.state.params))):
        np.testing.assert_allclose(a, b, rtol=0, atol=2e-5)


# -------------------------------------------------------------- serving
ENGINE = dict(n_slots=3, max_len=48, prompt_len=20, news=(4, 9, 6, 12, 3), rate=4e-3)


def test_engine_run_matches_reference():
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


# -------------------------------------------------------------- launchers
def test_serve_launcher_runs_qwen_on_the_cpu(capsys):
    launch_serve.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--prompt-len", "8",
                       "--new", "3", "--batch", "2"])
    assert capsys.readouterr().out.strip().splitlines()[-1].startswith(f"{ARCH}: (2, 11) in ")


def test_train_launcher_runs_qwen_on_the_cpu(capsys):
    launch_train.main(["--device", "cpu", "--arch", ARCH, "--reduced", "--steps", "2",
                       "--seq", "16", "--global-batch", "8", "--log-every", "1"])
    out = capsys.readouterr().out
    assert f"arch={ARCH}" in out and out.count("\nstep ") == 2
