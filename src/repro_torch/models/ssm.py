"""Jamba's Mamba mixer (selective SSM, arXiv:2312.00752), after
``repro/models/ssm.py``.

The reference's mixer is plain jnp — no Pallas kernel — so the port
computes the same function in plain PyTorch: ``in_proj`` splits into the
input x and a gate z; a depthwise causal conv over time (``d_conv``
taps), SiLU; per token ``x_proj`` gives dt (``dt_rank`` wide), B and C
(``d_state`` each); ``delta = softplus(dt_proj(dt) + dt_bias)`` and
``A = -exp(a_log)`` in fp32; the selective scan ``h_t = exp(delta_t A)
h_{t-1} + delta_t x_t B_t``, ``y_t = h_t C_t`` with the fp32 state h
(B, d_inner, d_state); then ``y + d_skip x``, the gate ``y·silu(z)`` and
``out_proj``.

The scan is the reference's ``_scan_chunked``: a Python loop over time
chunks of ``min(scan_chunk, S)`` (the tail padded with zeros;
``op_analysis.scan``) carries h,
and inside a chunk an associative scan of the pairs (decay, input) under
``combine(u, v) = (u0·v0, v0·u1 + v1)`` — the reference's own odd/even
recursion (``lax.associative_scan``): log2(chunk) levels of tensor ops,
no loop over tokens.  The decay ``exp(delta·A)`` and input ``delta·x·B``
are formed one chunk at a time (the reference forms them for the whole
sequence; at full width and 2,048 tokens that is 1.07 GB per tensor, a
chunk of 256 is 134 MB).

Decode is one recurrence step on the cache ``{"conv", "h", "pos"}``:
``conv`` (B, d_conv-1, d_inner) the last inputs of the conv, in the
cache's dtype; ``h`` (B, d_inner, d_state) **always fp32**, also in a
bf16 slab, as the reference never rounds the state; ``pos`` a scalar or
a ``(B,)`` row vector (the serving slab), advanced and otherwise unused.
The step writes ``conv`` and ``h`` and advances ``pos`` **in place**,
into the views ``stack.py`` hands each layer, as ``attention.py`` writes
K/V; the reference returns a new cache whose ``conv`` keeps the
activations' dtype, where the port rounds it to the cache's (equal when
they agree).

On the ``model`` axis (``tp``, a ``dist.sharding.ModelSplit`` that splits
``d_inner``) a rank holds its channels: ``in_proj`` cut block by block
(``params.shard_of``: its slice of x's columns beside the same slice of
the gate z's), ``conv_w``, ``conv_b``, ``dt_proj``'s columns,
``dt_bias``, ``a_log``, ``d_skip``, and the rows of ``x_proj`` and
``out_proj``.  The input enters through ``copy_to_model`` (``in_proj``
is column-parallel: its gradient is summed backward).  ``x_proj`` is
row-parallel: its (B, S, dt_rank + 2·d_state) output is a partial sum,
all-reduced forward (``reduce_from_model``); dt then feeds the rank's
columns of ``dt_proj`` and B and C its channels of the scan, so the
reduced output passes through ``copy_to_model`` too (its gradient summed
backward).  ``out_proj`` is row-parallel: one more all-reduce.  The
decode state holds the rank's channels: ``conv`` (B, d_conv-1,
d_inner/m) and ``h`` (B, d_inner/m, d_state), fp32.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..dist.collectives import copy_to_model, reduce_from_model
from ..launch import op_analysis

__all__ = ["mamba_forward", "init_mamba_cache", "mamba_dims", "a_log_init", "dt_bias_init"]


def mamba_dims(cfg):
    """(``MambaSpec``, d_inner = expand·d_model, dt_rank: the spec's, or
    ceil(d_model / 16))."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    dt_rank = m.dt_rank or -(-cfg.d_model // 16)
    return m, d_inner, dt_rank


def a_log_init(cfg) -> np.ndarray:
    """S4D-real ``a_log``: ``log(1..d_state)`` on every row (fp32), the
    reference's values bit for bit."""
    m, d_inner, _ = mamba_dims(cfg)
    return np.log(np.tile(np.arange(1, m.d_state + 1, dtype=np.float32), (d_inner, 1)))


def dt_bias_init(cfg) -> np.ndarray:
    """``dt_bias`` drawn as the reference draws it: the inverse softplus of
    dt log-uniform in [1e-3, 1e-1] from ``np.random.default_rng(0)``,
    computed in float64 and stored as fp32."""
    _, d_inner, _ = mamba_dims(cfg)
    dt = np.exp(np.random.default_rng(0).uniform(np.log(1e-3), np.log(1e-1), d_inner))
    return np.log(np.expm1(np.clip(dt, 1e-4, None))).astype(np.float32)


def _causal_conv(x, w, b, init_state=None):
    """Depthwise causal conv along time.  x: (B,S,Di), w: (K,Di).  Returns
    (out, the last K-1 inputs)."""
    k = w.shape[0]
    if init_state is None:
        pad = torch.zeros((x.shape[0], k - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = init_state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)
    out = sum(xp[:, i:i + x.shape[1]] * w[i].to(x.dtype) for i in range(k))
    return out + b.to(x.dtype), xp[:, -(k - 1):]


def _ssm_params(cfg, p, xc, group=None):
    """Per-token delta (fp32 softplus), A, B and C (fp32) from the conv
    output xc: (B,S,Di) — with the model ``group``, the rank's channels,
    whose ``x_proj`` product is all-reduced, then copied to them."""
    m, _, dt_rank = mamba_dims(cfg)
    dt = xc.dtype
    proj = torch.einsum("bsi,ir->bsr", xc, p["x_proj"].to(dt))
    if group is not None:
        proj = copy_to_model(reduce_from_model(proj, group), group)
    dt_raw, b_t, c_t = torch.split(proj, [dt_rank, m.d_state, m.d_state], dim=-1)
    pre = torch.einsum("bsr,ri->bsi", dt_raw, p["dt_proj"].to(dt)).float() + p["dt_bias"]
    delta = torch.logaddexp(pre, torch.zeros((), dtype=pre.dtype, device=pre.device))
    a = -torch.exp(p["a_log"])  # (Di, Ns) fp32
    return delta, a, b_t.float(), c_t.float()


def _combine(u, v):
    """Two consecutive steps of ``h -> u0 h + u1`` then ``v``."""
    return u[0] * v[0], v[0] * u[1] + v[1]


def _interleave(a, b):
    """[a0, b0, a1, b1, ...] along axis 1 (``len(a)`` is ``len(b)`` or one
    more)."""
    out = a.new_empty((a.shape[0], a.shape[1] + b.shape[1]) + tuple(a.shape[2:]))
    out[:, 0::2] = a
    out[:, 1::2] = b
    return out


def _assoc_scan(elems):
    """Inclusive scan of ``_combine`` along axis 1 by the odd/even recursion
    of ``lax.associative_scan``."""
    n = elems[0].shape[1]
    if n < 2:
        return elems
    odd = _assoc_scan(_combine([e[:, 0:n - 1:2] for e in elems], [e[:, 1::2] for e in elems]))
    if n % 2 == 0:
        even = _combine([e[:, :-1] for e in odd], [e[:, 2::2] for e in elems])
    else:
        even = _combine(odd, [e[:, 2::2] for e in elems])
    even = [torch.cat([e[:, :1], r], dim=1) for e, r in zip(elems, even)]
    return [_interleave(e, o) for e, o in zip(even, odd)]


def _scan_chunked(cfg, delta, a, b_t, c_t, x_in, h0):
    """The chunked selective scan.  delta, x_in: (B,S,Di); b_t, c_t:
    (B,S,Ns); a: (Di,Ns); h0: (B,Di,Ns) fp32.  Returns (y (B,S,Di) fp32,
    the last state)."""
    s = x_in.shape[1]
    chunk = min(cfg.scan_chunk, s)
    n_chunks = -(-s // chunk)
    pad = n_chunks * chunk - s
    if pad:
        delta, b_t, c_t, x_in = (F.pad(t, (0, 0, 0, pad)) for t in (delta, b_t, c_t, x_in))

    def step(i, carry, delta, a, b_t, c_t, x_in):
        cut = slice(i * chunk, (i + 1) * chunk)
        d_i = delta[:, cut]
        da = torch.exp(d_i[..., None] * a)  # (B, chunk, Di, Ns) decay
        dbx = (d_i * x_in[:, cut].float())[..., None] * b_t[:, cut, None, :]  # input
        dec, acc = _assoc_scan((da, dbx))
        h_t = dec * carry[0][:, None] + acc
        return (h_t[:, -1],), torch.einsum("bcin,bcn->bci", h_t, c_t[:, cut])

    (h,), ys = op_analysis.scan(step, n_chunks, (h0,), (delta, a, b_t, c_t, x_in))
    return torch.cat(ys, dim=1)[:, :s], h


def _project_out(y, p, group):
    """``out_proj`` of the gated y, all-reduced over the model ``group``
    (row-parallel) when there is one."""
    out = torch.einsum("bsi,id->bsd", y, p["out_proj"].to(y.dtype))
    return out if group is None else reduce_from_model(out, group)


def mamba_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0,
                  tp=None):
    """The Mamba sublayer.  Returns (out, cache): ``None`` in training, the
    prefill's new ``{"conv", "h", "pos"}`` (``target_len`` unused: the
    state has no sequence axis), or the decode cache updated in place.
    With ``tp``, this rank's channels and their state."""
    m = cfg.mamba
    group = tp.model_group if tp is not None and "d_inner" in tp.axes else None
    d_inner = p["d_skip"].shape[-1]  # the rank's channels
    b, s, _ = x.shape
    dt = x.dtype
    if group is not None:
        x = copy_to_model(x, group)
    xz = torch.einsum("bsd,di->bsi", x, p["in_proj"].to(dt))
    x_in, z = xz.split(d_inner, dim=-1)
    if mode in ("train", "prefill"):
        xc, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"])
        xc = F.silu(xc)
        delta, a, b_t, c_t = _ssm_params(cfg, p, xc, group)
        h0 = torch.zeros((b, d_inner, m.d_state), dtype=torch.float32, device=x.device)
        y, h_last = _scan_chunked(cfg, delta, a, b_t, c_t, xc, h0)
        y = y.to(dt) + xc * p["d_skip"].to(dt)
        out = _project_out(y * F.silu(z), p, group)
        new_cache = None
        if mode == "prefill":
            new_cache = {"conv": conv_state.to(dt), "h": h_last,
                         "pos": torch.full((), s, dtype=torch.int32, device=x.device)}
        return out, new_cache
    if mode != "decode":
        raise ValueError(f"unknown mode {mode!r}")
    xc_seq, conv_state = _causal_conv(x_in, p["conv_w"], p["conv_b"], init_state=cache["conv"])
    xc = F.silu(xc_seq)
    delta, a, b_t, c_t = _ssm_params(cfg, p, xc, group)
    da = torch.exp(delta[:, 0, :, None] * a)  # (B, Di, Ns)
    dbx = (delta[:, 0] * xc[:, 0].float())[..., None] * b_t[:, 0, None, :]
    h = da * cache["h"] + dbx
    y = torch.einsum("bin,bn->bi", h, c_t[:, 0])[:, None]  # (B, 1, Di)
    y = y.to(dt) + xc * p["d_skip"].to(dt)
    out = _project_out(y * F.silu(z), p, group)
    cache["conv"].copy_(conv_state)
    cache["h"].copy_(h)
    cache["pos"].add_(1)
    return out, cache


def init_mamba_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda", tp=None):
    """An empty state: ``conv`` in ``dtype``, ``h`` in fp32 (``seq_len``
    unused); with ``tp``, the rank's channels (``ModelSplit.local``)."""
    m, d_inner, _ = mamba_dims(cfg)
    if tp is not None:
        d_inner = tp.local("d_inner", d_inner)
    return {
        "conv": torch.zeros((batch, m.d_conv - 1, d_inner), dtype=dtype, device=device),
        "h": torch.zeros((batch, d_inner, m.d_state), dtype=torch.float32, device=device),
        "pos": torch.zeros((), dtype=torch.int32, device=device),
    }
