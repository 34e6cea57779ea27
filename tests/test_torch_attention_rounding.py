"""Where the port rounds windowed attention and the decode step's scores
(``models/attention.py::local_attention`` and ``_decode``), against the
JAX reference's, on the CPU.

The reference scales the bf16 scores by a numpy float (``* scale``,
``/ np.sqrt(head_dim)``), a product JAX promotes to fp32; the port takes
the scores in the activations' dtype, raises them to fp32, then scales,
softcaps and masks them in fp32.  The inputs are drawn with numpy from a
seed and rounded to bf16 alike on both sides.

Tolerance: the bf16 output ``BF16_REL`` = 2^-8 (one bf16 step) of its
largest entry; the test prints whether the port equals the reference's
bit for bit (measured on the CPU: it does in every case) or only within
the bound.  The form the port used before — the scores scaled and
softcapped in bf16 — is computed beside it and shown to break the bound.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import attention as jattn
from repro_torch.configs import get_config
from repro_torch.models import attention
from repro_torch.models.layers import softcap

BF16_REL = 2 ** -8
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


def _bf16(*arrays):
    """Each array rounded to bf16 on both sides: [(jax, torch)]."""
    out = []
    for a in arrays:
        aj = jnp.asarray(a, jnp.bfloat16)
        out.append((aj, torch.tensor(np.asarray(aj.astype(jnp.float32))).to(torch.bfloat16)))
    return out


def _configs(**kw):
    cfg_t = get_config("gc-lm-110m").reduced(**KW).replace(dtype="bfloat16", **kw)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW).replace(dtype="bfloat16", **kw)
    return cfg_t, cfg_j


def _held(what, got, want) -> float:
    """The error against the reference's, within the bound; prints which
    of the two criteria held."""
    err = _err(got.float(), np.asarray(want, np.float32))
    same = np.array_equal(got.float().numpy(), np.asarray(want, np.float32))
    print(f"{what}: {'bit-equal to the reference' if same else f'{err:.3e} of the largest'}")
    assert err <= BF16_REL, f"{what}: {err:.3e} > {BF16_REL}"
    return err


def _old_local(cfg, q, k, v, window, cap):
    """``local_attention`` as the port computed it before: the scores
    scaled and softcapped in the activations' dtype."""
    b, sq, h, dh = q.shape
    kvh = k.shape[2]
    pos = torch.arange(sq)
    valid = ((pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window))
    qg = q.reshape(b, sq, kvh, h // kvh, dh)
    s = softcap(torch.einsum("bqkgd,bckd->bkgqc", qg, k) * (1.0 / np.sqrt(cfg.head_dim)), cap)
    w = torch.softmax(s.float() + torch.where(valid, 0.0, -1e30), dim=-1)
    return torch.einsum("bkgqc,bckd->bqkgd", w.to(q.dtype), v).reshape(b, sq, h, dh)


@pytest.mark.parametrize("cap", [0.0, 50.0])
def test_bf16_local_attention_matches_reference(cap):
    """100 tokens in query chunks of 32 (4 chunks, the last padded) over a
    window of 40 (two chunks of history), GQA 4 over 2."""
    cfg_t, cfg_j = _configs(attn_chunk=32)
    rng = np.random.default_rng(4)
    (qj, qt), (kj, kt), (vj, vt) = _bf16(*(3 * rng.standard_normal((2, 100, h, 32))
                                           for h in (4, 2, 2)))
    got = attention.local_attention(cfg_t, qt, kt, vt, window=40, cap=cap)
    want = jattn.local_attention(cfg_j, qj, kj, vj, window=40, cap=cap)
    assert got.dtype == torch.bfloat16 and got.shape == qt.shape
    err = _held(f"local_attention bf16, cap {cap}", got, want)
    old = _err(_old_local(cfg_t, qt, kt, vt, 40, cap).float(), np.asarray(want, np.float32))
    print(f"local_attention bf16, cap {cap}: the old bf16 scaling {old:.3e}, the port {err:.3e}")
    assert old > BF16_REL, old


def _decode_inputs(cfg_t, cap_len, pos, seed):
    rng = np.random.default_rng(seed)
    d, h, kvh, dh = cfg_t.d_model, cfg_t.n_heads, cfg_t.n_kv_heads, cfg_t.head_dim
    p = {"wq": rng.standard_normal((d, h, dh)) / np.sqrt(d) * 4,
         "wk": rng.standard_normal((d, kvh, dh)) / np.sqrt(d) * 4,
         "wv": rng.standard_normal((d, kvh, dh)) / np.sqrt(d),
         "wo": rng.standard_normal((h, dh, d)) / np.sqrt(h * dh)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    b = len(pos)
    (xj, xt), (kj, kt), (vj, vt) = _bf16(rng.standard_normal((b, 1, d)),
                                         3 * rng.standard_normal((b, cap_len, kvh, dh)),
                                         rng.standard_normal((b, cap_len, kvh, dh)))
    cache_j = {"k": kj, "v": vj, "pos": jnp.asarray(pos, jnp.int32)}
    cache_t = {"k": kt.clone(), "v": vt.clone(), "pos": torch.tensor(pos, dtype=torch.int32)}
    return p, (xj, xt), cache_j, cache_t


def _old_decode(cfg, p, x, cache, spec):
    """The decode step's output as the port computed it before, from the
    cache the new step wrote: scores divided and softcapped in bf16."""
    pos = cache["pos"].long() - 1
    q, _, _ = attention.project_qkv(cfg, p, x, pos[:, None], cfg.rope_base)
    k_cache, v_cache = cache["k"], cache["v"]
    cap_len, b = k_cache.shape[1], x.shape[0]
    j = torch.arange(cap_len)
    valid = (j[None, :] <= pos[:, None]) | (pos[:, None] >= cap_len)
    qg = q.reshape(b, 1, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim)
    s = torch.einsum("bqkgd,bckd->bkgqc", qg, k_cache) / np.sqrt(cfg.head_dim)
    s = softcap(s, cfg.attn_softcap)
    w = torch.softmax(s.float() + torch.where(valid, 0.0, -1e30)[:, None, None, None, :],
                      dim=-1).to(q.dtype)
    out = torch.einsum("bkgqc,bckd->bqkgd", w, v_cache).reshape(b, 1, cfg.n_heads, -1)
    return torch.einsum("bshx,hxd->bsd", out, p["wo"].to(x.dtype))


@pytest.mark.parametrize("cap", [0.0, 50.0])
@pytest.mark.parametrize("cache", ["ring", "global"])
def test_bf16_decode_step_matches_reference(cache, cap):
    """One decode step of a bf16 attention layer with per-row positions:
    a ring of 16 that has wrapped (rows at positions 37, 21, 16 and 100)
    and a global cache of 48 (rows at 30, 5, 47 and 12).  The output, and
    the K/V the step wrote in place, against the reference's step."""
    cfg_t, cfg_j = _configs(attn_softcap=cap)
    window = 16 if cache == "ring" else None
    cap_len, pos = (16, [37, 21, 16, 100]) if cache == "ring" else (48, [30, 5, 47, 12])
    spec_t = dataclasses.replace(cfg_t.layers[0], window=window)
    spec_j = dataclasses.replace(cfg_j.layers[0], window=window)
    p, (xj, xt), cache_j, cache_t = _decode_inputs(cfg_t, cap_len, pos, seed=6)
    y_j, new_j = jattn.attn_forward(cfg_j, {k: jnp.asarray(v) for k, v in p.items()}, xj,
                                    spec_j, mode="decode", cache=cache_j)
    pt = {k: torch.from_numpy(v) for k, v in p.items()}
    y_t, new_t = attention.attn_forward(cfg_t, pt, xt, spec_t, mode="decode", cache=cache_t)
    assert new_t is cache_t and y_t.dtype == torch.bfloat16
    for name in ("k", "v"):
        np.testing.assert_array_equal(new_t[name].float().numpy(),
                                      np.asarray(new_j[name], np.float32))
    np.testing.assert_array_equal(new_t["pos"].numpy(), np.asarray(pos) + 1)
    err = _held(f"decode bf16, {cache} cache, cap {cap}", y_t, y_j)
    old = _err(_old_decode(cfg_t, pt, xt, cache_t, spec_t).float(), np.asarray(y_j, np.float32))
    print(f"decode bf16, {cache} cache, cap {cap}: the old bf16 scaling {old:.3e}, "
          f"the port {err:.3e}")
    assert old > BF16_REL, old
