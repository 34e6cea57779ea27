"""The port's online-softmax attention over KV chunks
(``models/attention.py::chunked_attention`` and MLA's training and
prefill in ``models/mla.py``) against the JAX reference's, on the CPU.

The inputs are drawn with numpy from a seed and rounded alike on both
sides.  160 tokens against chunks of 128: two chunks, the second padded
and masked, and a causal edge that crosses the chunk boundary.

Tolerances:

* fp32 — outputs and gradients 1e-5 of each tensor's largest entry
  (the same fp32 math, sums in another order);
* bf16 activations, with and without ``attn_probs_bf16`` —
  ``chunked_attention``'s output ``ATTN_BF16_REL`` = 2^-8 (one bf16 step)
  of the largest entry, tighter than the 5e-2 every other bf16 parity
  test of the port uses (PERF.md §2): measured on the CPU it equals the
  reference's bit for bit.  The error of the one-softmax form the port
  used before (one fp32 softmax over all keys; 2.739e-2 measured) is
  printed beside the chunked form's, not compared.  MLA's output is held
  at 5e-2 (measured 2.618e-3: its projections and norms round in bf16
  too);
* ``attn_chunk_remat``: outputs and gradients bit-equal to no remat.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro.models import mla as jmla
from repro_torch.configs import get_config
from repro_torch.models import attention, mla
from repro_torch.models.layers import softcap
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM

REL = 1e-5
ATTN_BF16_REL = 2 ** -8
BF16_REL = 5e-2
S = 160
KW = dict(n_layers=2, d_model=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _err(got, want) -> float:
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)


def _as(dtype, *arrays):
    """Each array rounded to ``dtype`` on both sides: [(jax, torch)]."""
    out = []
    for a in arrays:
        aj = jnp.asarray(a, getattr(jnp, dtype))
        out.append((aj, torch.tensor(np.asarray(aj.astype(jnp.float32)))
                    .to(getattr(torch, dtype))))
    return out


def _configs(**kw):
    cfg_t = get_config("gc-lm-110m").reduced(**KW).replace(**kw)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW).replace(**kw)
    return cfg_t, cfg_j


def _qkv(s=S, seed=4):
    rng = np.random.default_rng(seed)
    return [3 * rng.standard_normal((2, s, h, 32)).astype(np.float32) for h in (4, 2, 2)]


def _one_softmax(cfg, q, k, v, cap=0.0):
    """The form the port used before: one fp32 softmax over every key."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    s = softcap(torch.einsum("bqkgd,bckd->bkgqc", qg, k) / np.sqrt(cfg.head_dim), cap)
    pos = torch.arange(sq)
    s = s.float() + torch.where(pos[None, :] <= pos[:, None], 0.0, -1e30)
    w = torch.softmax(s, dim=-1).to(q.dtype)
    return torch.einsum("bkgqc,bckd->bqkgd", w, v).reshape(b, sq, h, dh)


def test_reduced_keeps_the_reference_chunk_and_knobs():
    for name in ("gc-lm-110m", "gemma3-27b", "deepseek-v3-671b"):
        got, want = get_config(name), jax_get_config(name)
        for field in ("attn_chunk", "attn_chunk_remat", "attn_probs_bf16"):
            assert getattr(got, field) == getattr(want, field), (name, field)
            assert getattr(got.reduced(), field) == getattr(want.reduced(), field)
    assert get_config("gc-lm-110m").reduced().attn_chunk == 128


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("causal", [True, False])
def test_fp32_matches_reference_with_gradients(causal, cap):
    """Outputs and the gradients of q, k and v at 160 tokens over chunks of
    128, GQA 4 over 2, with and without the score softcap, causal and
    not (the encoder's form)."""
    cfg_t, cfg_j = _configs()
    q, k, v = _qkv()
    cot = np.random.default_rng(9).standard_normal(q.shape).astype(np.float32)
    ts = [torch.tensor(a, requires_grad=True) for a in (q, k, v)]
    got = attention.chunked_attention(cfg_t, *ts, causal=causal, cap=cap)

    def ref(*a):
        return jattn.chunked_attention(cfg_j, *a, causal=causal, cap=cap)

    want, vjp = jax.vjp(ref, *(jnp.asarray(a) for a in (q, k, v)))
    assert got.dtype == torch.float32 and got.shape == q.shape
    assert _err(got.detach(), want) <= REL
    grads = torch.autograd.grad((got * torch.from_numpy(cot)).sum(), ts)
    for name, g_t, g_j in zip("qkv", grads, vjp(jnp.asarray(cot))):
        assert _err(g_t, g_j) <= REL, name


@pytest.mark.parametrize("probs_bf16", [False, True])
def test_bf16_matches_reference(probs_bf16):
    """bf16 activations: the reference's rounding points (scores scaled
    into fp32, probabilities cast for the PV product, or rounded to bf16
    first with ``attn_probs_bf16``)."""
    cfg_t, cfg_j = _configs(attn_probs_bf16=probs_bf16)
    (qj, qt), (kj, kt), (vj, vt) = _as("bfloat16", *_qkv())
    want = np.asarray(jattn.chunked_attention(cfg_j, qj, kj, vj), np.float32)
    got = attention.chunked_attention(cfg_t, qt, kt, vt)
    assert got.dtype == torch.bfloat16
    chunked = _err(got.float(), want)
    one = _err(_one_softmax(cfg_t, qt, kt, vt).float(), want)
    print(f"bf16, attn_probs_bf16={probs_bf16}: chunked {chunked:.3e}, "
          f"one softmax {one:.3e} of the largest output")
    assert chunked <= ATTN_BF16_REL


def test_causal_edge_across_chunks_and_query_offset():
    """Queries at ``q_offset`` 120..159 against all 160 keys: the causal
    edge crosses the chunk boundary at 128, and every row equals the
    reference's and the full-sequence call's last 40 rows."""
    cfg_t, cfg_j = _configs()
    q, k, v = _qkv()
    tail = q[:, 120:]
    want = jattn.chunked_attention(cfg_j, *(jnp.asarray(a) for a in (tail, k, v)),
                                   q_offset=120)
    got = attention.chunked_attention(cfg_t, *(torch.from_numpy(a) for a in (tail, k, v)),
                                      q_offset=120)
    assert _err(got, want) <= REL
    full = attention.chunked_attention(cfg_t, *(torch.from_numpy(a) for a in (q, k, v)))
    assert _err(got, full[:, 120:]) <= REL
    # row 127 sees only the first chunk, row 128 one key of the second
    probe = torch.from_numpy(v).clone()
    probe[:, 129:] = 1e3  # keys past row 128's edge: masked for rows <= 128
    masked = attention.chunked_attention(cfg_t, torch.from_numpy(q), torch.from_numpy(k), probe)
    assert torch.equal(masked[:, :129], full[:, :129])
    assert not torch.equal(masked[:, 129:], full[:, 129:])


def test_chunk_remat_is_bit_equal():
    """``attn_chunk_remat``: outputs and the gradients of q, k and v
    bit-equal to no remat, in fp32 and bf16 with bf16 probabilities."""
    for dtype, probs in (("float32", False), ("bfloat16", True)):
        cfg_t, _ = _configs(attn_probs_bf16=probs)
        out, grads = [], []
        for remat in (False, True):
            ts = [t.detach().requires_grad_() for _, t in _as(dtype, *_qkv())]
            y = attention.chunked_attention(cfg_t.replace(attn_chunk_remat=remat), *ts)
            out.append(y)
            grads.append(torch.autograd.grad(y.float().square().sum(), ts))
        assert torch.equal(out[0], out[1])
        for a, b in zip(*grads):
            assert torch.equal(a, b)


def test_model_gradients_bit_equal_with_chunk_remat_inside_layer_remat():
    """The whole model at 40 tokens over chunks of 16: the loss and every
    leaf's gradient with ``attn_chunk_remat`` (alone and inside
    ``remat="full"``) bit-equal to neither."""
    cfg = get_config("gc-lm-110m").reduced(**KW).replace(attn_chunk=16)
    model = GCLM(cfg, device="cpu", seed=0)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 41))

    def grads(c):
        loss, _ = train_loss(c, model, {"tokens": tokens})
        return [loss, *torch.autograd.grad(loss, model.leaves())]

    base = grads(cfg)
    for kw in (dict(attn_chunk_remat=True), dict(attn_chunk_remat=True, remat="full")):
        for a, b in zip(base, grads(cfg.replace(**kw)), strict=True):
            assert torch.equal(a, b), kw


# ------------------------------------------------------------------- MLA
def _mla_params(cfg, seed=5):
    """An MLA mixer's nine leaves at the reference's shapes, fan-in scaled,
    its two norm scales nonzero."""
    m, d, h = cfg.mla, cfg.d_model, cfg.n_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    shapes = {"wq_a": (d, m.q_lora_rank), "q_a_norm": (m.q_lora_rank,),
              "wq_b": (m.q_lora_rank, h, qk), "wkv_a": (d, m.kv_lora_rank),
              "kv_a_norm": (m.kv_lora_rank,), "wk_rope": (d, m.qk_rope_head_dim),
              "wk_b": (m.kv_lora_rank, h, m.qk_nope_head_dim),
              "wv_b": (m.kv_lora_rank, h, m.v_head_dim), "wo": (h, m.v_head_dim, d)}
    rng = np.random.default_rng(seed)
    return {k: (rng.standard_normal(s) / np.sqrt(s[0] if len(s) == 1 else np.prod(s[:-1]))
                ).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_mla_chunked_matches_reference(mode, dtype):
    """MLA's expanded form over two chunks of 128 (160 tokens): outputs
    and, in prefill, the latent cache."""
    cfg_t = get_config("deepseek-v3-671b").reduced(**KW)
    cfg_j = jax_get_config("deepseek-v3-671b").reduced(**KW)
    assert cfg_t.attn_chunk == 128
    p = _mla_params(cfg_t)
    x = np.random.default_rng(6).standard_normal((2, S, cfg_t.d_model)).astype(np.float32)
    (xj, xt), = _as(dtype, x)
    y_j, c_j = jmla.mla_forward(cfg_j, {k: jnp.asarray(v) for k, v in p.items()}, xj,
                                cfg_j.layers[0], mode=mode, target_len=S + 8)
    y_t, c_t = mla.mla_forward(cfg_t, {k: torch.from_numpy(v) for k, v in p.items()}, xt,
                               cfg_t.layers[0], mode=mode, target_len=S + 8)
    rel = REL if dtype == "float32" else BF16_REL
    assert y_t.dtype == xt.dtype
    err = _err(y_t.float(), y_j)
    print(f"MLA {mode} {dtype}: {err:.3e} of the largest output")
    assert err <= rel
    if mode == "prefill":
        for name in ("c_kv", "k_r"):
            assert _err(c_t[name].float(), c_j[name]) <= rel, name


def test_mla_gradients_match_reference_and_remat_is_bit_equal():
    cfg_t = get_config("deepseek-v3-671b").reduced(**KW)
    cfg_j = jax_get_config("deepseek-v3-671b").reduced(**KW)
    p = _mla_params(cfg_t)
    x = np.random.default_rng(6).standard_normal((2, S, cfg_t.d_model)).astype(np.float32)
    cot = np.random.default_rng(9).standard_normal(x.shape).astype(np.float32)
    spec_j = cfg_j.layers[0]
    g_j = jax.grad(lambda p_, x_: jnp.sum(jmla.mla_forward(cfg_j, p_, x_, spec_j)[0] * cot),
                   argnums=(0, 1))({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x))
    runs = []
    for remat in (False, True):
        pt = {k: torch.tensor(v, requires_grad=True) for k, v in p.items()}
        xt = torch.tensor(x, requires_grad=True)
        y, _ = mla.mla_forward(cfg_t.replace(attn_chunk_remat=remat), pt, xt, cfg_t.layers[0])
        runs.append(torch.autograd.grad((y * torch.from_numpy(cot)).sum(), [*pt.values(), xt]))
    for name, g in zip([*p, "x"], runs[0]):
        assert _err(g, g_j[1] if name == "x" else g_j[0][name]) <= REL, name
    for a, b in zip(*runs):
        assert torch.equal(a, b)
