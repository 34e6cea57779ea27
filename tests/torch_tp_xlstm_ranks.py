"""The ranks of ``tests/test_torch_tp_xlstm.py``: reduced xlstm-1.3b on the
``model`` axis of a (data 2, model 2) mesh, over gloo on the CPU
(``torch_tp_mla_ranks.axis_job``), at two widths, and the blocked cuts of
the mLSTM's ``up`` and the sLSTM's ``w_gates``/``b_gates`` gathered back.

A module of its own that imports no JAX: each spawned rank imports only
it (torch and the port), not the test module.

``pass_counts``, ``step_counts`` and ``serve_counts`` are the collectives
the model axis must make for xLSTM and for the cross-attention families
(``tests/torch_tp_cross_ranks.py`` imports them), written from the config
alone: the tests hold every counted collective to them."""
import torch

from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models.params import GCLM, gather_model, init_shards
from repro_torch.models.xlstm import mlstm_dims, slstm_dims

from torch_tp_mla_ranks import MESH, N, axis_job

#: the widths of the job: at 256 the sLSTM's GeGLU (341 wide) stays whole
#: at model 2, at 384 (512 wide) it splits
WIDTHS = (256, 384)
#: configs whose every leaf is cut and gathered back: one period of 8
#: layers (runs) and two (a pattern stacked over 2 repeats, so the blocks
#: lie on dimension 2)
ROUND_TRIP_LAYERS = (8, 16)


def cfg(d_model: int):
    """xlstm-1.3b reduced to 8 layers — a run of 7 mLSTM layers and the
    period's sLSTM — at ``d_model``: 4 heads, the mLSTM's d_inner 2·d."""
    return get_config("xlstm-1.3b").reduced(n_layers=8, d_model=d_model)


def _split(width: int, model: int) -> int:
    return int(width % model == 0)


def layer_counts(c, spec, model: int) -> dict:
    """One layer's model-group collectives per pass: forward reduces and
    all-gathers, backward copies and reduce-scatters.  With the heads
    split — attention and a cross-attention mixer: the output projection,
    the input; the mLSTM: the gates (reduced, then copied) and ``down``,
    the input and the gates; the sLSTM: the input's copy and the gather of
    h.  Where the axis splits xLSTM's channels but not its heads (more
    ranks than heads): the mLSTM also gathers its conv's output and x_m
    (an all-gather forward, a reduce-scatter backward) and copies its
    replicated leaves' gradients in one all-reduce; the sLSTM gathers its
    gates' input, ``b_gates`` and, where the rule splits it, ``r_gates``,
    and no h.  The sLSTM's GeGLU a reduce and a copy where its width
    splits; a ``cross_source`` sublayer (Whisper's decoder) the same as a
    cross mixer; a dense MLP one of each where its width splits."""
    red, cop, gather = {"attn": (1, 1, 0), "cross_attn": (1, 1, 0), "mlstm": (2, 2, 0),
                        "slstm": (0, 1, 1)}[spec.mixer]
    scatter = 0
    if spec.mixer in ("mlstm", "slstm") and c.n_heads % model:
        if spec.mixer == "mlstm":
            cop, gather, scatter = cop + 1, 1, 1
        else:
            gather = 2 + _split(4 * slstm_dims(c)[1], model)
    if spec.mixer == "slstm":
        up = _split(slstm_dims(c)[2], model)
        red, cop = red + up, cop + up
    if spec.cross_source:
        red, cop = red + 1, cop + 1
    if spec.use_ffn and c.d_ff:
        red, cop = red + _split(c.d_ff, model), cop + _split(c.d_ff, model)
    return dict(reduce=red, copy=cop, all_gather=gather, psum_scatter=scatter)


def pass_counts(c, model: int) -> dict:
    """One forward and backward of ``train_loss`` on the axis: every
    layer's; where the vocabulary splits, the embedding's reduce, the
    head's copy and the loss's two reduces and max (none where it stays
    whole: Whisper's 51,865 rows, or 511); an encoder's layers, each its
    attention's reduce and copy and its MLP's; and one copy of the
    cross-attention source a pass."""
    vocab = _split(c.vocab, model)
    total = dict(reduce=3 * vocab, copy=vocab, all_gather=0, max=vocab, psum_scatter=0)
    for spec in c.layers:
        for k, v in layer_counts(c, spec, model).items():
            total[k] += v
    if c.encoder is not None:
        per = 1 + _split(c.d_ff, model)
        total["reduce"] += per * c.encoder.n_layers
        total["copy"] += per * c.encoder.n_layers
    if any(l.mixer == "cross_attn" or l.cross_source for l in c.layers):
        total["copy"] += 1
    return total


def step_counts(c, model: int, k: int, n_levels: int) -> dict:
    """One ``Trainer(mode="spmd")`` step on a rank: ``k`` passes forward
    and backward and the monitoring forward, the clip's one reduce of the
    split leaves' squares, one psum per level over the data group and one
    check of the straggler draw."""
    p = pass_counts(c, model)
    return dict(psum=n_levels, psum_scatter=k * p["psum_scatter"], broadcast=1,
                all_gather=(k + 1) * p["all_gather"], copy=k * p["copy"],
                reduce=(k + 1) * p["reduce"] + 1, max=(k + 1) * p["max"])


def serve_counts(c, model: int, step: dict, rows: range, n_slots: int, prompt_len: int,
                 data: int) -> dict:
    """One engine step's collectives on a rank holding the slots ``rows``
    (fp32), with the heads split: per decode of its B rows and per prefill of an admission into
    them, the forward reduces — the embedding's (B, 1, d) where the
    vocabulary splits, each mLSTM's gates (B, 1, 2·heads) and ``down``,
    each sLSTM's GeGLU where it splits — and all-gathers — each sLSTM's h
    (B, 1, d) out, and the logits (B, V) or (1, V) out; the step gathers
    its int64 tokens over the data ranks (n_slots per column)."""
    b, d, v = len(rows), c.d_model, c.vocab
    mine = len([s for s in step["admitted"] if s in rows])
    dec = step["decoded"]
    cols = bool(step["admitted"]) + dec
    kinds = [spec.mixer for spec in c.layers]
    n_m, n_s = kinds.count("mlstm"), kinds.count("slstm")
    up = _split(slstm_dims(c)[2], model) * n_s
    vocab = _split(v, model)
    gates = 2 * mlstm_dims(c)[2]
    tokens = int(data > 1 and cols > 0)
    per_row = 4 * ((vocab + n_m + up) * d + n_m * gates)
    return dict(
        reduce=(vocab + 2 * n_m + up) * (dec + mine), others=0,
        all_gather=(dec + mine) * (1 + n_s) + tokens,
        reduce_bytes=per_row * (dec * b + mine * prompt_len),
        all_gather_bytes=4 * v * (dec * b + mine) + 8 * n_slots * cols * tokens
        + 4 * d * n_s * (dec * b + mine * prompt_len))


def _round_trips(rank) -> dict:
    """Per config of ``ROUND_TRIP_LAYERS`` (d_model 128): whether every
    leaf of the shards (drawn from seed 5) gathered back equals the full
    model's leaf, byte for byte (rank 0), and the leaves' block counts
    and split dimensions."""
    mesh = make_local_mesh(**MESH, device="cpu")
    out = {}
    for n in ROUND_TRIP_LAYERS:
        c = get_config("xlstm-1.3b").reduced(n_layers=n, d_model=128)
        local = init_shards(c, mesh, device="cpu", seed=5)
        gathered = gather_model(local).leaves()
        full = GCLM(c, device="cpu", seed=5).leaves() if rank == 0 else gathered
        out[n] = dict(equal=[torch.equal(a, b) for a, b in zip(gathered, full, strict=True)],
                      blocks=local.shard_blocks, dims=local.shard_dims,
                      paths=local.leaf_paths())
    return out


def train_rank(rank, world, path):
    """``axis_job`` of ``cfg(d)`` for each of ``WIDTHS`` on the inputs saved
    at ``path`` (``blob[d]``), the last with a coded checkpoint
    (``CodedSpec(N, 1)``) under its ``ckpt``; then the round trips."""
    blob = torch.load(path, weights_only=False)
    out = {}
    for d in WIDTHS:
        ckpt = None
        if d == WIDTHS[-1]:
            ckpt = CkptConfig(dir=blob[d]["ckpt"], coded=CodedSpec(N, 1))
        out[d] = axis_job(cfg(d), rank, blob[d], ckpt=ckpt)
    out["round_trips"] = _round_trips(rank)
    return out


#: the rounding case: a narrow xLSTM whose gathered fp32 gradient lies
#: tens of 1e-6 of scale from model 1's, run again with float64
#: activations (the leaves stay fp32)
ROUNDING = dict(n_layers=8, d_model=64, seq=16, seed=3)


def rounding_cfg(dtype: str):
    return get_config("xlstm-1.3b").reduced(n_layers=ROUNDING["n_layers"],
                                            d_model=ROUNDING["d_model"]).replace(dtype=dtype)


def rounding_tokens(c):
    g = torch.Generator().manual_seed(ROUNDING["seed"])
    return torch.randint(0, c.vocab, (2, ROUNDING["seq"] + 1), generator=g)


def rounding_rank(rank, world) -> dict:
    """One rank of a (data 1, model 2) mesh: the gathered gradient of one
    ``train_loss`` of ``rounding_cfg`` on its shards (seed
    ``ROUNDING["seed"]``), with fp32 and with float64 activations
    (rank 0 returns both)."""
    from repro_torch.models.model import train_loss

    torch.set_num_threads(1)
    mesh = make_local_mesh(1, model=2, device="cpu")
    out = {}
    for dtype in ("float32", "float64"):
        c = rounding_cfg(dtype)
        local = init_shards(c, mesh, device="cpu", seed=ROUNDING["seed"])
        loss, _ = train_loss(c, local, {"tokens": rounding_tokens(c)})
        grads = torch.autograd.grad(loss, local.leaves())
        out[dtype] = [t.detach().numpy() for t in gather_model(local, list(grads)).leaves()]
    return out if rank == 0 else {}
