"""xLSTM's mixers (arXiv:2405.04517), after ``repro/models/xlstm.py``:
the mLSTM (a matrix memory) and the sLSTM (a scalar memory with a
block-diagonal recurrence), with exponential gates and the log-space
stabilizer m.  The mixers own their projections (the mLSTM's pre-up of
``proj_factor``, the sLSTM's post-up GeGLU of 4/3), so an xLSTM layer has
no FFN sublayer.

The reference's mixers are plain jnp — no Pallas kernel — so the port
computes the same functions in plain PyTorch.

**mLSTM.** ``up`` splits into x_m and a gate z; a depthwise causal conv
of x_m (``conv_kernel`` taps, ``ssm._causal_conv``), SiLU; headwise
(block-diagonal) q and k from the conv output and v from x_m, k divided
by sqrt(dh) in fp32 (the reference's bf16 product with a numpy float);
the gates in fp32, ``log_i = g_i + b_i`` and ``log_f = logsigmoid(g_f +
b_f)``; q, k, v raised to fp32.  The reference scans the recurrence
token by token::

    m_t = max(log_f_t + m_{t-1}, log_i_t)
    C_t = e^{log_f_t + m_{t-1} - m_t} C_{t-1} + e^{log_i_t - m_t} v_t k_t^T
    n_t = e^{log_f_t + m_{t-1} - m_t} n_{t-1} + e^{log_i_t - m_t} k_t
    h_t = C_t q_t / max(|n_t . q_t|, 1)

from (0, 0, -1e30).  Training and prefill run its chunkwise-parallel
form, the same function: chunks of ``min(scan_chunk, S)`` (the field the
reference's config carries for its scans; the last chunk keeps its true
length, so no padded token enters the state), and within a chunk, from
the carried (C0, n0, m0), with ``F_t`` the cumulative sum of log_f::

    m_t  = F_t + max(m0, max_{s<=t}(log_i_s - F_s))    (the running max, unrolled)
    D_ts = exp(F_t - F_s + log_i_s - m_t), s <= t      (0 above the diagonal)
    w_t  = exp(F_t + m0 - m_t)
    S    = (Q K^T) * D
    h    = (S V + w (Q C0^T)) / max(|rowsum(S) + w (Q n0)|, 1)

and the chunk's end state ``C = w_L C0 + V^T diag(D_L) K``, ``n = w_L n0 +
K^T D_L``, ``m = m_L``.  Every exponent is <= 0; the mask is applied
before the ``exp``.  m is **not** detached: where the clamp holds at 1,
h depends on exp(-m).  The first chunk's carry is the zero state, whose
terms add exact zeros, and is skipped.  h is cast to the activations'
dtype, group-normed per head (fp32, population variance, eps 1e-5, times
``gn_scale``), gated by ``silu(z)`` and projected by ``down``.

**sLSTM.** ``wx = x @ w_gates`` in fp32; per token the block-diagonal
``r_gates`` applied to h_{t-1} (fp32; the reference's gate order), plus
``b_gates``; the stabilized i/f gates, ``c``, ``n`` and ``h =
sigmoid(o) c / max(n, 1e-6)``.  The recurrence is sequential, so it is a
Python loop over tokens (``op_analysis.scan``), as the reference's
``lax.scan`` is a loop.  Then the group norm and the GeGLU ``gelu_tanh(h @ up1) * (h @ up2)``,
``down``.

**Decode** is one step of the reference's recurrence on a fixed-size
state: ``{"C", "n", "m", "conv", "pos"}`` for the mLSTM (``C`` (B, nh,
dh, dh), ``n``, ``m`` always fp32, ``m`` starting at -1e30; ``conv`` in
the cache's dtype), ``{"h", "c", "n", "m", "pos"}`` for the sLSTM (all
fp32).  The step writes every leaf and advances ``pos`` **in place**,
into the views ``stack.py`` hands each layer, as ``ssm.py`` does.

**The model axis** (``tp``, a ``dist.sharding.ModelSplit``): a rank holds
``d_inner / model`` channels.  The mLSTM's ``up`` and the sLSTM's
``w_gates``/``b_gates`` are cut block by block (``params.shard_blocks``),
so a rank holds its channels of x_m and of z, and its slice of each of
the four gates.  Where the axis splits the heads too (``_split``), a
rank's channels are its heads': the mLSTM copies its input to the rank,
reduces ``w_if``'s row-parallel gates and copies them back (every head's
gates feed from every channel; the rank takes its i and f columns from
both halves), and reduces ``down``; its state is the rank's heads'.  The
sLSTM copies its input, runs the block-diagonal recurrence on the rank's
heads (their state), all-gathers h, and runs the group norm and the
GeGLU on the whole h: replicated where the GeGLU's width does not split
over the axis (its leaves' gradients are then whole on every rank), else
Megatron's MLP (``layers.apply_mlp``).

Where the axis splits ``d_inner`` but not the heads (more model ranks
than heads, as the reference's rule splits xlstm-1.3b's 4 heads at
model 8 and 16), each head runs whole on the ranks that hold its
channels (``_heads_of``).  The mLSTM runs its conv on the rank's
channels, all-gathers the conv's output and x_m over the model group
(``gather_reduce_scatter``: the ranks of a head each use a slice of its
output, so the backward sums and scatters), runs q, k, v, the gates,
the recurrence and the group norm on the heads that hold its channels
(the replicated ``wq``/``wk``/``wv``/``b_i``/``b_f`` sliced to them; their
gradients summed over the group in one all-reduce,
``copy_leaves_to_model``), and keeps its own channels for the z gate and
the row-parallel ``down``; its state is those heads'.  The sLSTM
all-gathers its gates' input ``x @ w_gates`` and ``b_gates`` (and
``r_gates`` where the rule split it) and runs every head on every rank,
whose state it holds whole; what follows is as above.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ..configs.base import XLSTMSpec
from ..dist.collectives import (copy_leaves_to_model, copy_to_model, gather_from_model,
                                gather_reduce_scatter, reduce_from_model)
from ..launch import op_analysis
from .layers import apply_mlp
from .ssm import _causal_conv

__all__ = ["xlstm_spec", "mlstm_dims", "slstm_dims", "mlstm_forward", "slstm_forward",
           "init_mlstm_cache", "init_slstm_cache"]

EPS = 1e-6
NEG = -1e30


def xlstm_spec(cfg, kind: str) -> XLSTMSpec:
    """The config's ``XLSTMSpec`` of this mixer kind (every block of a
    kind shares it), or the default."""
    for spec in cfg.xlstm_blocks:
        if spec.kind == kind:
            return spec
    return XLSTMSpec(kind=kind)


def mlstm_dims(cfg):
    """(``XLSTMSpec``, d_inner = proj_factor·d_model, heads, head width)."""
    spec = xlstm_spec(cfg, "mlstm")
    d_inner = int(spec.proj_factor * cfg.d_model)
    if d_inner % cfg.n_heads:
        raise ValueError(f"d_inner {d_inner} is not a multiple of {cfg.n_heads} heads")
    return spec, d_inner, cfg.n_heads, d_inner // cfg.n_heads


def slstm_dims(cfg):
    """(heads, head width, the post-up width round(4/3·d_model))."""
    return cfg.n_heads, cfg.d_model // cfg.n_heads, int(round(4.0 / 3.0 * cfg.d_model))


def _group_norm(x, scale, nh: int, cols: slice = slice(None)):
    """Per-head group norm of (B, S, D) in fp32, cast back to x's dtype;
    only the channels ``cols`` of the result (``scale`` is theirs)."""
    b, s, d = x.shape
    xh = x.reshape(b, s, nh, d // nh).float()
    mu = xh.mean(-1, keepdim=True)
    var = (xh - mu).square().mean(-1, keepdim=True)
    out = (xh - mu) * torch.rsqrt(var + 1e-5)
    return (out.reshape(b, s, d)[..., cols] * scale).to(x.dtype)


# ================================================================ mLSTM
def _mlstm_inputs(p, xc, x_raw, nh: int, dh: int, tp=None):
    """q, k, v (B,S,nh,dh) and log_i, log_f (B,S,nh), all fp32.  With
    ``tp``, ``nh`` is the rank's heads and ``xc`` its channels: the gates'
    row-parallel product is all-reduced, then copied to the rank's heads
    (each takes only its own, while ``w_if``'s rows feed every head), and
    the rank's i and f columns are taken from both halves of
    ``[i of every head | f of every head]``."""
    dt = xc.dtype
    b, s = xc.shape[:2]
    xc_h, xr_h = xc.reshape(b, s, nh, dh), x_raw.reshape(b, s, nh, dh)
    q = torch.einsum("bshi,hij->bshj", xc_h, p["wq"].to(dt))
    k = torch.einsum("bshi,hij->bshj", xc_h, p["wk"].to(dt)).float() / np.sqrt(dh)
    v = torch.einsum("bshi,hij->bshj", xr_h, p["wv"].to(dt))
    gates = torch.einsum("bsi,ih->bsh", xc, p["w_if"].to(dt))
    i_cols = f_cols = slice(0, nh)
    if tp is not None:
        gates = copy_to_model(reduce_from_model(gates, tp.model_group), tp.model_group)
        first = tp.model_index * nh
        i_cols = slice(first, first + nh)
    total = gates.shape[-1] // 2  # every head's
    f_cols = slice(total + i_cols.start, total + i_cols.stop)
    gates = gates.float()
    log_i = gates[..., i_cols] + p["b_i"]
    log_f = F.logsigmoid(gates[..., f_cols] + p["b_f"])
    return q.float(), k, v.float(), log_i, log_f


def _mlstm_chunk(q, k, v, log_i, log_f, carry, need_state: bool):
    """One chunk of the chunkwise form.  q, k, v: (B,nh,L,dh); log_i,
    log_f: (B,nh,L); carry: the (C, n, m) before the chunk, or None for
    the zero state.  Returns (h (B,nh,L,dh), the state after the chunk or
    None)."""
    length = q.shape[2]
    f_cum = torch.cumsum(log_f, -1)
    a = log_i - f_cum
    causal = torch.ones((length, length), dtype=torch.bool, device=q.device).tril()
    # the running max as a masked max: its backward is elementwise (cummax's
    # scatters, which CUDA accumulates in no fixed order)
    run = torch.where(causal, a[..., None, :], -torch.inf).amax(-1)
    if carry is not None:
        run = torch.maximum(carry[2][..., None], run)
    m = f_cum + run
    log_d = f_cum[..., :, None] + a[..., None, :] - m[..., :, None]
    d_mat = torch.exp(torch.where(causal, log_d, -torch.inf))
    s_mat = (q @ k.transpose(-1, -2)) * d_mat
    num = s_mat @ v
    den = s_mat.sum(-1)
    if carry is not None:
        c0, n0, m0 = carry
        w = torch.exp(f_cum + m0[..., None] - m)
        num = num + w[..., None] * torch.einsum("bhtj,bhij->bhti", q, c0)
        den = den + w * torch.einsum("bhtj,bhj->bht", q, n0)
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    if not need_state:
        return h, None
    u = d_mat[..., -1, :]  # exp(F_L - F_s + log_i_s - m_L)
    c_new = (v * u[..., None]).transpose(-1, -2) @ k
    n_new = torch.einsum("bhs,bhsj->bhj", u, k)
    if carry is not None:
        w_l = w[..., -1]
        c_new = w_l[..., None, None] * c0 + c_new
        n_new = w_l[..., None] * n0 + n_new
    return h, (c_new, n_new, m[..., -1])


def _mlstm_chunked(cfg, q, k, v, log_i, log_f, need_state: bool):
    """The recurrence over (B,S,nh,·) inputs in chunks of
    ``min(scan_chunk, S)``.  Returns (h (B,S,nh,dh) fp32, the end state
    (C, n, m) or None)."""
    s = q.shape[1]
    chunk = min(cfg.scan_chunk, s)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))
    log_i, log_f = log_i.transpose(1, 2), log_f.transpose(1, 2)

    def step(i, carry, q, k, v, log_i, log_f):
        cut = slice(i * chunk, (i + 1) * chunk)
        h, carry = _mlstm_chunk(q[:, :, cut], k[:, :, cut], v[:, :, cut], log_i[..., cut],
                                log_f[..., cut], carry or None,
                                need_state or (i + 1) * chunk < s)
        return carry, h

    carry, hs = op_analysis.scan(step, -(-s // chunk), (), (q, k, v, log_i, log_f))
    return torch.cat(hs, dim=2).transpose(1, 2), carry


def _mlstm_step(cache, q, k, v, log_i, log_f):
    """One token of the reference's recurrence, writing ``C``, ``n`` and
    ``m`` in place.  q, k, v: (B,nh,dh); log_i, log_f: (B,nh).  Returns h
    (B,nh,dh)."""
    c_mat, n_vec, m_run = cache["C"], cache["n"], cache["m"]
    m_new = torch.maximum(log_f + m_run, log_i)
    i_p = torch.exp(log_i - m_new)[..., None]
    f_p = torch.exp(log_f + m_run - m_new)[..., None]
    c_mat.mul_(f_p[..., None]).add_(i_p[..., None] * (v[..., :, None] * k[..., None, :]))
    n_vec.mul_(f_p).add_(i_p * k)
    m_run.copy_(m_new)
    num = torch.einsum("bhij,bhj->bhi", c_mat, q)
    den = torch.clamp(torch.einsum("bhj,bhj->bh", n_vec, q).abs(), min=1.0)[..., None]
    return num / den


def _split(tp, axis: str):
    """``tp`` where it splits the logical ``axis``, else None."""
    return None if tp is None or axis not in tp.axes else tp


def _heads_of(tp, d_inner: int, dh: int) -> tuple:
    """Where the axis splits ``d_inner`` but not the heads: (first,
    count) of the heads whose channels overlap the rank's ``d_inner /
    model``, and the channels of the rank within theirs."""
    c = d_inner // tp.mesh.model
    lo = tp.model_index * c
    first = lo // dh
    count = (lo + c - 1) // dh - first + 1
    return first, count, slice(lo - first * dh, lo - first * dh + c)


def _mlstm_wide_inputs(p, xc, x_raw, heads: tuple, nh: int, dh: int, tp):
    """``_mlstm_inputs`` of the heads ``heads`` = (first, count) from the
    rank's channels ``xc`` and ``x_raw``: both all-gathered over the model
    group (``gather_reduce_scatter``), the head's channels taken; the
    replicated leaves sliced to the heads (their gradients summed over the
    group); the gates as ``_mlstm_inputs`` reduces and copies them."""
    first, count = heads
    dt = xc.dtype
    b, s, c = xc.shape
    group, model = tp.model_group, tp.mesh.model
    both = gather_reduce_scatter(torch.cat([xc, x_raw], -1), group, dim=2)
    both = both.unflatten(-1, (model, 2, c)).transpose(2, 3).flatten(-2)  # (B, S, 2, d_inner)
    both = both[..., first * dh:(first + count) * dh].unflatten(-1, (count, dh))
    wq, wk, wv, b_i, b_f = (t[first:first + count] for t in copy_leaves_to_model(
        [p[k] for k in ("wq", "wk", "wv", "b_i", "b_f")], group))
    q = torch.einsum("bshi,hij->bshj", both[:, :, 0], wq.to(dt))
    k = torch.einsum("bshi,hij->bshj", both[:, :, 0], wk.to(dt)).float() / np.sqrt(dh)
    v = torch.einsum("bshi,hij->bshj", both[:, :, 1], wv.to(dt))
    gates = torch.einsum("bsi,ih->bsh", xc, p["w_if"].to(dt))
    gates = copy_to_model(reduce_from_model(gates, group), group).float()
    log_i = gates[..., first:first + count] + b_i
    log_f = F.logsigmoid(gates[..., nh + first:nh + first + count] + b_f)
    return q.float(), k, v.float(), log_i, log_f


def mlstm_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0,
                  tp=None):
    """The mLSTM sublayer.  Returns (out, cache): ``None`` in training, the
    prefill's new ``{"C", "n", "m", "conv", "pos"}`` (``target_len``
    unused: the state has no sequence axis), or the decode cache updated
    in place.  With ``tp`` splitting ``d_inner``: the input copied to the
    rank's channels, ``up`` column-parallel (its x_m and z blocks), the
    conv on the rank's channels; where the heads split too, the
    recurrence and the group norm on the rank's heads and the gates
    reduced and copied (``_mlstm_inputs``), else on the heads that hold
    its channels, gathered (``_mlstm_wide_inputs``), keeping its own
    channels; ``down`` row-parallel and all-reduced; the state is the
    heads' the rank runs."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    tp = _split(tp, "d_inner")
    _, d_inner, nh, dh = mlstm_dims(cfg)
    heads, cols = None, slice(None)
    if tp is not None:
        if "heads" in tp.axes:
            nh = tp.local("heads", nh)
        else:
            *heads, cols = _heads_of(tp, d_inner, dh)
        d_inner = tp.local("d_inner", d_inner)
        x = copy_to_model(x, tp.model_group)
    b, s, _ = x.shape
    dt = x.dtype
    x_m, z = torch.einsum("bsd,di->bsi", x, p["up"].to(dt)).split(d_inner, dim=-1)
    decode = mode == "decode"
    xc, conv_state = _causal_conv(x_m, p["conv_w"], p["conv_b"],
                                  init_state=cache["conv"] if decode else None)
    if heads is None:
        q, k, v, log_i, log_f = _mlstm_inputs(p, F.silu(xc), x_m, nh, dh, tp)
    else:
        q, k, v, log_i, log_f = _mlstm_wide_inputs(p, F.silu(xc), x_m, heads, nh, dh, tp)
        nh = heads[1]
    if decode:
        h = _mlstm_step(cache, q[:, 0], k[:, 0], v[:, 0], log_i[:, 0], log_f[:, 0])[:, None]
        cache["conv"].copy_(conv_state)
        cache["pos"].add_(1)
        new_cache = cache
    else:
        h, state = _mlstm_chunked(cfg, q, k, v, log_i, log_f, need_state=mode == "prefill")
        new_cache = None
        if mode == "prefill":
            new_cache = {"C": state[0], "n": state[1], "m": state[2], "conv": conv_state.to(dt),
                         "pos": torch.full((), s, dtype=torch.int32, device=x.device)}
    h = _group_norm(h.reshape(b, -1, nh * dh).to(dt), p["gn_scale"], nh, cols)
    out = torch.einsum("bsi,id->bsd", h * F.silu(z), p["down"].to(dt))
    return (out if tp is None else reduce_from_model(out, tp.model_group)), new_cache


def init_mlstm_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda", tp=None):
    """An empty state: ``C``, ``n`` zero and ``m`` -1e30 in fp32, ``conv``
    in ``dtype`` (``seq_len`` unused); with ``tp``, the rank's channels
    and the heads it runs (its own, or those that hold its channels)."""
    xspec, d_inner, nh, dh = mlstm_dims(cfg)
    tp = _split(tp, "d_inner")
    if tp is not None:
        nh = tp.local("heads", nh) if "heads" in tp.axes else _heads_of(tp, d_inner, dh)[1]
        d_inner = tp.local("d_inner", d_inner)
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, nh, dh, dh), **f32),
            "n": torch.zeros((batch, nh, dh), **f32),
            "m": torch.full((batch, nh), NEG, **f32),
            "conv": torch.zeros((batch, xspec.conv_kernel - 1, d_inner), dtype=dtype,
                                device=device),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}


# ================================================================ sLSTM
def _slstm_cell(h, c, n, m, wx_t, r, b_gates, nh: int, dh: int):
    """One token: (h, c, n, m) (B, d) fp32 and the token's fp32 ``wx``
    (B, 4d) -> the next (h, c, n, m)."""
    b = h.shape[0]
    rec = torch.einsum("bhi,hij->bhj", h.reshape(b, nh, dh), r)
    rec = rec.reshape(b, nh, 4, dh).transpose(1, 2).reshape(b, 4, nh * dh)
    pre = wx_t.reshape(b, 4, nh * dh) + rec + b_gates.reshape(4, nh * dh)
    i_raw, f_raw, z_raw, o_raw = pre.unbind(1)
    log_f = F.logsigmoid(f_raw)
    m_new = torch.maximum(log_f + m, i_raw)
    i_p = torch.exp(i_raw - m_new)
    f_p = torch.exp(log_f + m - m_new)
    c_new = f_p * c + i_p * torch.tanh(z_raw)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(o_raw) * c_new / torch.clamp(n_new, min=EPS)
    return h_new, c_new, n_new, m_new


def _gather_blocks(t: torch.Tensor, tp, blocks: int) -> torch.Tensor:
    """The whole of a tensor whose last dimension holds the rank's slice
    of each of ``blocks`` blocks (``params.shard_of``'s cut), gathered
    over the model group (``gather_from_model``: every rank then uses it
    whole) and put back block by block."""
    whole = gather_from_model(t, tp.model_group, tp.model_index, dim=t.dim() - 1)
    return whole.unflatten(-1, (tp.mesh.model, blocks, -1)).transpose(-3, -2).flatten(-3)


def slstm_forward(cfg, p, x, spec, *, mode="train", cache=None, target_len: int = 0,
                  tp=None):
    """The sLSTM sublayer.  Returns (out, cache): ``None`` in training, the
    prefill's new ``{"h", "c", "n", "m", "pos"}``, or the decode cache
    updated in place.  With ``tp`` splitting ``d_inner``: the input copied
    to the rank, ``w_gates`` column-parallel (its four gate blocks); where
    the heads split too, the block-diagonal recurrence on the rank's heads
    and h gathered over them (``gather_from_model``: its backward is the
    rank's slice), else the gates' input, ``b_gates`` and a split
    ``r_gates`` gathered and every head run on every rank; then the group
    norm and the GeGLU on the whole h — replicated on every rank where the
    GeGLU's width does not split, else Megatron's MLP (``layers.apply_mlp``
    decides from the width); the state is the heads' the rank runs."""
    if mode not in ("train", "prefill", "decode"):
        raise ValueError(f"unknown mode {mode!r}")
    nh, dh, d_up = slstm_dims(cfg)
    mlp_tp, tp = tp, _split(tp, "d_inner")
    full_nh = nh
    wide = tp is not None and "heads" not in tp.axes
    if tp is not None:
        nh = tp.local("heads", nh)
        x = copy_to_model(x, tp.model_group)
    b, s, _ = x.shape
    d = nh * dh  # the rank's width of the state
    dt = x.dtype
    wx = torch.einsum("bsd,dj->bsj", x, p["w_gates"].to(dt))
    r, b_gates = p["r_gates"], p["b_gates"]
    if wide:
        wx, b_gates = _gather_blocks(wx, tp, 4), _gather_blocks(b_gates, tp, 4)
        if r.shape[-1] != 4 * dh:
            r = gather_from_model(r, tp.model_group, tp.model_index, dim=2)
    wx, r = wx.float(), r.float()
    if mode == "decode":
        state = _slstm_cell(cache["h"], cache["c"], cache["n"], cache["m"], wx[:, 0], r,
                            b_gates, nh, dh)
        for name, t in zip(("h", "c", "n", "m"), state):
            cache[name].copy_(t)
        cache["pos"].add_(1)
        h_seq, new_cache = state[0][:, None], cache
    else:
        zeros = torch.zeros((b, d), dtype=torch.float32, device=x.device)
        state = (zeros, zeros, zeros, torch.full((b, d), NEG, dtype=torch.float32,
                                                 device=x.device))

        def step(t, state, wx, r, b_gates):
            state = _slstm_cell(*state, wx[:, t], r, b_gates, nh, dh)
            return state, state[0]

        state, hs = op_analysis.scan(step, s, state, (wx, r, b_gates))
        h_seq, new_cache = torch.stack(hs, dim=1), None
        if mode == "prefill":
            new_cache = dict(zip(("h", "c", "n", "m"), state),
                             pos=torch.full((), s, dtype=torch.int32, device=x.device))
    h_seq = h_seq.to(dt)
    if tp is not None and not wide:
        h_seq = gather_from_model(h_seq, tp.model_group, tp.model_index, dim=2)
    h_seq = _group_norm(h_seq, p["gn_scale"], full_nh)
    # the GeGLU gelu_tanh(h @ up1) * (h @ up2) @ down: the gated MLP's form under
    # xlstm-1.3b's activation, the tanh gelu
    geglu = {"wi": p["up2"], "wg": p["up1"], "wo": p["down"]}
    return apply_mlp(cfg, geglu, h_seq, mlp_tp, width=d_up), new_cache


def init_slstm_cache(cfg, spec, batch: int, seq_len: int, dtype=torch.bfloat16,
                     device="cuda", tp=None):
    """An empty state, all fp32: ``h``, ``c``, ``n`` zero, ``m`` -1e30
    (``dtype`` and ``seq_len`` unused); with ``tp`` splitting the heads,
    the rank's heads' (``ModelSplit.local``), else every head's."""
    nh, dh, _ = slstm_dims(cfg)
    d = (nh if _split(tp, "d_inner") is None else tp.local("heads", nh)) * dh
    f32 = dict(dtype=torch.float32, device=device)
    return {"h": torch.zeros((batch, d), **f32), "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32), "m": torch.full((batch, d), NEG, **f32),
            "pos": torch.zeros((), dtype=torch.int32, device=device)}
