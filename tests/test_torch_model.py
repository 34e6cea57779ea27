"""The port's dense LM against the JAX reference.

Parameters are the reference's tree (same key paths, same stacked
shapes, same leaf order); the reference's initialized arrays are carried
across with ``params_from_numpy``, and the loss, the logits and every
leaf gradient must agree on ``gc-lm-110m`` reduced to 2 layers and
d_model 128 in fp32.

Tolerances: the two packages run the same fp32 math with sums taken in
another order (matmul blocking, the reference's online softmax over KV
chunks against one softmax here), so values agree to a few fp32 ulps of
the largest terms — 1e-5 relative to each tensor's largest entry.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig, SyntheticTokens
from repro.models import attention as jattn
from repro.models import layers as jlayers
from repro.models.model import forward as jax_forward
from repro.models.model import train_loss as jax_train_loss
from repro.train.state import abstract_train_state, init_train_state
from repro_torch.configs import get_config
from repro_torch.models import attention, layers
from repro_torch.models.model import forward, train_loss
from repro_torch.models.params import GCLM, params_from_numpy, params_to_numpy

REL = 1e-5
KW = dict(n_layers=2, d_model=128)


def _close(got, want, rel=REL, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path)
            for path, _ in flat], [tuple(leaf.shape) for _, leaf in flat]


@pytest.mark.parametrize("size", ["full", "reduced"])
def test_leaf_paths_shapes_and_order_match_jax(size):
    cfg_t, cfg_j = get_config("gc-lm-110m"), jax_get_config("gc-lm-110m")
    if size == "reduced":
        cfg_t, cfg_j = cfg_t.reduced(**KW), cfg_j.reduced(**KW)
    model = GCLM(cfg_t, device="meta")
    paths, shapes = _jax_paths(abstract_train_state(cfg_j)[0].params)
    assert model.leaf_paths() == paths
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    # the parameter names are the key paths too
    assert sorted(n for n, _ in model.named_parameters()) == sorted(paths)
    if size == "full":
        assert len(paths) == 11
        assert sum(int(np.prod(s)) for s in shapes) == 137_841_408


def test_reduced_config_matches_reference():
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    for f in dataclasses.fields(cfg_t):
        want = getattr(cfg_j, f.name)
        if f.name == "layers":
            for lt, lj in zip(cfg_t.layers, want):
                assert (lt.mixer, lt.window, lt.moe, lt.use_ffn, lt.cross_source) == \
                    (lj.mixer, lj.window, lj.moe, lj.use_ffn, lj.cross_source)
        else:
            assert getattr(cfg_t, f.name) == want, f.name


@pytest.fixture(scope="module")
def carried():
    """Reduced config, the reference's initialized params and a batch."""
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    model = params_from_numpy(GCLM(cfg_t, device="cpu"), tree)
    tokens = SyntheticTokens(DataConfig(vocab=cfg_t.vocab, seq_len=48,
                                        global_batch=2, seed=1)).batch(0)
    return cfg_t, cfg_j, tree, model, tokens


def test_params_roundtrip_exact(carried):
    _, _, tree, model, _ = carried
    back = params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        np.testing.assert_array_equal(a, b)


def test_forward_loss_and_every_leaf_gradient_match_jax(carried):
    cfg_t, cfg_j, tree, model, tokens = carried
    jparams = jax.tree.map(jnp.asarray, tree)
    logits_j = jax_forward(cfg_j, jparams, jnp.asarray(tokens[:, :-1]))[0]
    with torch.no_grad():
        logits_t = forward(cfg_t, model, torch.from_numpy(tokens[:, :-1]).long())[0]
    _close(logits_t, logits_j, what="logits")

    def loss_fn(p):
        return jax_train_loss(cfg_j, p, {"tokens": jnp.asarray(tokens)})[0]

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jparams)
    loss_t, metrics = train_loss(cfg_t, model, {"tokens": tokens})
    grads_t = torch.autograd.grad(loss_t, model.leaves())
    assert abs(loss_t.item() - float(loss_j)) <= REL * abs(float(loss_j))
    assert set(metrics) == {"xent", "aux", "loss"}
    for path, g_t, g_j in zip(model.leaf_paths(), grads_t, jax.tree.leaves(grads_j)):
        _close(g_t, g_j, what=path)


def test_attention_matches_chunked_online_softmax():
    """Several KV chunks and GQA (4 query heads over 2 KV heads): the
    reference's online softmax equals one fp32 softmax."""
    cfg_t = get_config("gc-lm-110m").reduced(**KW).replace(attn_chunk=16)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW).replace(attn_chunk=16)
    rng = np.random.default_rng(4)
    q = rng.standard_normal((2, 40, 4, 32)).astype(np.float32)
    k = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    v = rng.standard_normal((2, 40, 2, 32)).astype(np.float32)
    want = jattn.chunked_attention(cfg_j, *(jnp.asarray(x) for x in (q, k, v)))
    got = attention.causal_attention(cfg_t, *(torch.from_numpy(x) for x in (q, k, v)))
    _close(got, want, what="attention")


def test_layer_primitives_match_jax():
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 9, 128)).astype(np.float32)
    scale = (0.1 * rng.standard_normal(128)).astype(np.float32)
    _close(layers.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           jlayers.rms_norm(jnp.asarray(x), jnp.asarray(scale)), what="rms_norm")
    xh = rng.standard_normal((2, 9, 4, 32)).astype(np.float32)
    pos = np.arange(9)[None, :]
    _close(layers.rope(torch.from_numpy(xh), torch.from_numpy(pos)),
           jlayers.rope(jnp.asarray(xh), jnp.asarray(pos)), what="rope")
    p = {n: (0.05 * rng.standard_normal(s)).astype(np.float32)
         for n, s in (("wi", (128, 512)), ("wg", (128, 512)), ("wo", (512, 128)))}
    _close(layers.apply_mlp(cfg_t, {n: torch.from_numpy(a) for n, a in p.items()},
                            torch.from_numpy(x)),
           jlayers.apply_mlp(cfg_j, {n: jnp.asarray(a) for n, a in p.items()},
                             jnp.asarray(x)), what="mlp")


def test_init_law_matches_dense_init():
    """Truncated normal on [-2, 2] std, std 1/sqrt(fan_in) of the per-layer
    shape; deterministic in the seed."""
    cfg = get_config("gc-lm-110m").reduced(**KW)
    m0, m0b, m1 = (GCLM(cfg, device="cpu", seed=s) for s in (0, 0, 1))
    for path, t in m0.leaf_items():
        t = t.detach()
        if path[-1] == "scale":
            assert torch.count_nonzero(t) == 0
            continue
        per_layer = tuple(t.shape[1:]) if path[0] == "stack" else tuple(t.shape)
        fan_in = per_layer[0] if len(per_layer) == 1 else int(np.prod(per_layer[:-1]))
        std = 1.0 / np.sqrt(fan_in)
        assert float(t.abs().max()) <= 2.0 * std * (1 + 1e-6), path
        # a standard normal truncated at +-2 has std 0.8796
        assert abs(float(t.std()) / std - 0.8796) < 0.03, path
    for (path, a), b, c in zip(m0.leaf_items(), m0b.leaves(), m1.leaves()):
        assert torch.equal(a, b)
        assert path[-1] == "scale" or not torch.equal(a, c)  # scales are zero


def test_unsupported_features_raise():
    cfg = get_config("gc-lm-110m").reduced(**KW)
    for change in (dict(qk_norm=True), dict(tie_embeddings=False),
                   dict(layers=(dataclasses.replace(cfg.layers[0], window=8),) * 2)):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            GCLM(cfg.replace(**change), device="meta")
