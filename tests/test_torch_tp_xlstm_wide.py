"""xLSTM on a ``model`` axis wider than its heads (``models/xlstm.py``'s
``_heads_of`` path): the axis splits ``d_inner`` and leaves the heads
whole, as the reference's rule splits xlstm-1.3b's 4 heads at model 8
and 16, and each head runs whole on the ranks that hold its channels.
Against the JAX reference, on the CPU.

* The split: ``shard_dims`` of xlstm-1.3b at model 8 and 16 equals the
  reference's ``pspec_for_axes`` on every leaf, reduced and at full
  width — ``d_inner`` and the vocabulary split, the heads whole (``wq``,
  ``wk``, ``wv``, ``b_i``, ``b_f`` replicated, ``w_if`` on its rows,
  ``r_gates`` on its gate columns).
* At full width on a (16, 16) meta mesh: the mixers' training, prefill
  and decode run on a rank's shards, its caches hold the heads it runs
  (the mLSTM's one 1,024-wide head, the sLSTM's every head), and one
  pass's collectives equal the formula.
* One 4-rank gloo job on (data 1, model 4) (ranks:
  ``tests/torch_tp_xlstm_wide_ranks.py``, which imports no JAX) of
  xlstm-1.3b reduced to 8 layers at d_model 128 with 2 heads (each on 2
  ranks), while this process computes the reference's ``train_loss``
  gradients on the same weights (``.replace(n_heads=2)`` in both
  packages):
  - the loss within 1e-5 of the reference's and of the port's model 1;
    every gathered gradient within ``STACK_REL`` = 3e-4 of scale of the
    reference's (the stack's bound, ``tests/test_torch_xlstm.py``), and
    with float64 activations within 1e-5 of scale of model 1's; with
    fp32 activations the stack amplifies the split sums' rounding, so
    the gap to model 1 is held to the reference's own distance from
    model 1 (``b_i``, zero in exact arithmetic, at its layer's ``b_f``'s
    scale throughout);
  - the collectives per pass equal the formula
    (``torch_tp_xlstm_ranks.pass_counts``): per mLSTM layer 2 reduces,
    3 copies (the input, the gates, the replicated leaves), a gather of
    its conv's output and x_m and its reduce-scatter; per sLSTM a copy,
    and gathers of its gates' input, ``b_gates`` and ``r_gates``;
  - the engine on the mesh (fp32 slab, greedy) gives one process's
    tokens, slots, timestamps and latencies; each rank's slab holds the
    mLSTM's state of the head it runs and the sLSTM's of every head.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.configs import get_config
from repro_torch.dist import collectives
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import decode_step, init_decode_caches, prefill, train_loss
from repro_torch.models.params import GCLM, init_shards, params_from_numpy, shard_dims

import torch_tp_xlstm_ranks as X
import torch_tp_xlstm_wide_ranks as W
from test_torch_tp_mla import (ENGINE, REL, check_gathered_tree, model1, reference_dims,
                               run_job, worst)
from test_torch_tp_xlstm import STACK_REL, scales
from torch_tp_serve_ranks import _engine

pytestmark = pytest.mark.spmd

ARCH = "xlstm-1.3b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _paths(c):
    return GCLM(c, device="meta").leaf_paths()


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("model", [8, 16])
def test_shard_dims_wider_than_the_heads_are_the_reference_s(model, full):
    """xlstm-1.3b on (data 2, model 8 or 16): every leaf split where the
    reference splits it; the heads stay whole, so the split axes are
    ``d_inner`` and the vocabulary; at full width 46 of the 94 leaves
    split."""
    n_layers = 0 if full else 8
    cfg = get_config(ARCH) if full else get_config(ARCH).reduced(n_layers=n_layers)
    mesh = meta_mesh(data=2, model=model)
    dims = shard_dims(cfg, mesh)
    assert dims == reference_dims(ARCH, model, n_layers)
    local = init_shards(cfg, mesh, device="meta")
    assert local.tp.axes == {"d_inner", "vocab"}
    meta = GCLM(cfg, device="meta")
    for path, dim, t in zip(meta.leaf_paths(), dims, meta.leaves()):
        name = path.rsplit(".", 1)[-1]
        if name in ("wq", "wk", "wv", "b_i", "b_f"):
            assert dim is None, path
        elif name == "w_if":
            assert dim == t.dim() - 2, path  # (.., d_inner, 2 heads): its rows
    if full:
        assert (len(dims), sum(d is not None for d in dims)) == (94, 46)


def _full_width(n_layers: int = 8):
    """xlstm-1.3b's published widths and vocabulary at 8 layers: 7 mLSTM
    layers and the sLSTM."""
    full = get_config(ARCH)
    return full.reduced(n_layers=n_layers, d_model=full.d_model).replace(vocab=full.vocab)


@pytest.mark.parametrize("model", [8, 16])
def test_mixers_run_on_a_meta_rank_wider_than_the_heads(model):
    """Full width on rank 5 of a (16, 16) or (16, 8) meta mesh: a
    training pass (its collectives the formula), a prefill and a decode
    step on the rank's shards; the mLSTM's state is the one head that
    holds its channels (1,024 x 1,024 per row), its conv the rank's
    channels, the sLSTM's state every head's."""
    c = _full_width()
    assert (c.d_model, c.n_heads, c.vocab) == (2048, 4, 50304)
    mesh = meta_mesh(16, model=model, rank=5)
    local = init_shards(c, mesh, device="meta")
    tokens = torch.empty((1, 9), dtype=torch.int64, device="meta")
    collectives.reset_counts()
    loss, _ = train_loss(c, local, {"tokens": tokens})
    torch.autograd.grad(loss, local.leaves())
    got = dict(collectives.counts, **collectives.model_counts)
    want = X.pass_counts(c, model)
    assert {k: got[k] for k in want} == want and got["psum"] == got["broadcast"] == 0
    assert want == dict(reduce=17, copy=23, all_gather=10, max=1, psum_scatter=7)
    logits, caches = prefill(c, local, tokens[:, :8], target_len=9)
    assert tuple(logits.shape[:2]) == (1, 8)
    empty = init_decode_caches(c, 2, 16, device="meta", tp=local.tp)
    d_inner = 2 * c.d_model
    for got in (caches, empty):
        (mlstm, slstm), rows = got, got[1]["h"].shape[0]
        assert tuple(mlstm["C"].shape) == (7, rows, 1, 1024, 1024)
        assert tuple(mlstm["conv"].shape) == (7, rows, 3, d_inner // model)
        assert tuple(slstm["h"].shape) == tuple(slstm["m"].shape) == (rows, c.d_model)
    logits, _ = decode_step(c, local, empty, tokens[:, :1].expand(2, 1))
    assert logits.shape[:2] == (2, 1)


# ------------------------------------------------------------------ the job
def _jax_cfg():
    return jax_get_config(ARCH).reduced(n_layers=8, d_model=W.D_MODEL).replace(
        n_heads=W.N_HEADS, n_kv_heads=W.N_HEADS)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job in a thread while this process computes the
    reference's gradients; then model 1 on the same weights."""
    blob, ranks, ref = run_job(W.wide_rank, W.cfg(), _jax_cfg(),
                               tmp_path_factory.mktemp("tp_xlstm_wide"))
    return blob, ranks, ref, model1(W.cfg(), blob)


def test_ranks_hold_their_channels_and_every_head_s_leaves(job):
    """Each rank holds a quarter of ``d_inner`` (half a head) and of the
    vocabulary, the heads' leaves whole; the shards gather to the
    reference's tree byte for byte."""
    blob, ranks, _, _ = job
    c = W.cfg()
    assert all(r["axes"] == ["d_inner", "vocab"] for r in ranks)
    shapes = dict(zip(_paths(c), ranks[0]["shapes"]))
    d = c.d_model
    assert shapes["stack.0.mixer.up"] == (7, d, d)  # 2 blocks of d_inner / 4
    assert shapes["stack.0.mixer.wq"] == (7, 2, d, d)  # both heads, 128 wide
    assert shapes["stack.0.mixer.w_if"] == (7, d // 2, 4)
    assert shapes["stack.1.mixer.r_gates"] == (2, d // 2, d // 2)  # 256 gate columns / 4
    assert shapes["stack.1.mixer.w_gates"] == (d, d)  # 4 gates of d / 4
    check_gathered_tree(blob, ranks)


def test_loss_and_gradients_match_the_reference_and_model_1(job):
    """The loss within 1e-5 of the reference's and of model 1's; the
    gathered gradients within ``STACK_REL`` of scale of the reference's
    and — with float64 activations on both sides — within 1e-5 of scale
    of model 1's.  With fp32 activations the stack amplifies the split
    sums' rounding (``test_the_axis_gap_is_the_stack_s_rounding`` in
    ``tests/test_torch_tp_xlstm.py``): the gap to model 1 is held to the
    reference's own distance from model 1 on the same weights (both
    printed)."""
    blob, ranks, ref, (_, metrics, grads) = job
    got, paths = ranks[0], _paths(W.cfg())
    assert all(r["metrics"] == got["metrics"] for r in ranks)
    assert got["metrics"].keys() == ref["metrics"].keys() == metrics.keys()
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= REL * abs(want), (k, got["metrics"][k], want)
        assert abs(got["metrics"][k] - metrics[k]) <= REL * abs(metrics[k]), k
    w_ref = worst(got["grads"], ref["grads"], STACK_REL, scales(paths, ref["grads"]))
    gap = worst(got["grads"], grads, 1.0, scales(paths, grads))
    ref_gap = worst(ref["grads"], grads, 1.0, scales(paths, grads))
    _, _, grads64 = model1(W.cfg("float64"), blob)
    w64 = worst(got["grads64"], grads64, REL, scales(paths, grads64))
    print(f"gradients vs the reference {w_ref * STACK_REL:.3e} of scale; vs model 1 "
          f"{gap:.3e} (the reference's distance from model 1 {ref_gap:.3e}), with float64 "
          f"activations {w64 * REL:.3e}")
    assert w_ref <= 1 and w64 <= 1 and gap <= ref_gap, (w_ref, w64, gap, ref_gap)


def test_collectives_per_pass_equal_the_formula(job):
    """One forward and backward: 7 mLSTM layers' 2 reduces, 3 copies, a
    gather and a reduce-scatter; the sLSTM's copy and 3 gathers (its
    GeGLU, 171 wide, whole); the embedding, head and loss.  No data-side
    collective."""
    _, ranks, _, _ = job
    want = dict(psum=0, psum_scatter=7, broadcast=0, all_gather=10, copy=23, reduce=17, max=1)
    assert X.pass_counts(W.cfg(), 4) == {k: want[k] for k in ("reduce", "copy", "all_gather",
                                                              "max", "psum_scatter")}
    assert all(r["counts"] == want for r in ranks), [r["counts"] for r in ranks]


def test_engine_on_the_mesh_equals_one_process(job):
    """The engine's tokens, slots, timestamps and latencies on every rank
    are one process's on the same weights; a rank's slab holds its 4
    slots' mLSTM state of the one head it runs and conv of its channels,
    and the sLSTM's state of both heads."""
    blob, ranks, _, _ = job
    c, run = W.cfg(), blob["engine"]
    one = _engine(c, params_from_numpy(GCLM(c, device="cpu"), blob["tree"]), None, run,
                  torch.float32)
    for r in ranks:
        for key in ("slots", "latencies", "now", "reqs"):
            assert r["engine"][key] == one[key], key
    assert len({s for step in one["slots"] for _, s in step}) < ENGINE["n_requests"]
    n = ENGINE["n_slots"]
    for r in ranks:
        mlstm, slstm = r["engine"]["slab"]
        assert mlstm["C"] == (7, n, 1, c.d_model, c.d_model) and mlstm["m"] == (7, n, 1)
        assert mlstm["conv"] == (7, n, 3, c.d_model // 2)
        assert slstm["h"] == slstm["c"] == (n, c.d_model)
    assert np.all([len(q["tokens"]) > 0 for q in one["reqs"]])
