"""xLSTM's mLSTM and sLSTM mixers on the port's ``model`` axis
(``models/xlstm.py`` with a ``ModelSplit``; the mLSTM's ``up`` and the
sLSTM's ``w_gates``/``b_gates`` cut block by block) in training,
checkpoints and serving, against the JAX reference, on the CPU.

* The split: ``shard_dims`` of xlstm-1.3b equals the reference's
  ``pspec_for_axes`` on every leaf, reduced and at full width; ``up`` is
  cut in 2 blocks (x_m and the gate z), ``w_gates`` and ``b_gates`` in 4
  (the gates i, f, z, o, each head-major), so a rank holds its heads of
  every one; the split check accepts a dimension whose mesh axis an
  earlier dimension took (``w_if``'s heads, ``r_gates``' d_inner) and
  still refuses a real disagreement; ``init_shards`` draws
  ``shard_model``'s cut.
* One 4-rank gloo job on (data 2, model 2) (ranks:
  ``tests/torch_tp_xlstm_ranks.py``, which imports no JAX) of xlstm-1.3b
  reduced to 8 layers (7 mLSTM and the sLSTM) at d_model 256 (the
  sLSTM's GeGLU, 341 wide, whole on every rank) and 384 (512: split),
  while this process computes the reference's ``train_loss`` gradients on
  the same weights:
  - the shards gathered back are the reference's tree byte for byte, and
    so are those of 8 and 16 layers at d_model 128 (runs, and a pattern
    whose stacked blocks lie on dimension 2);
  - the loss within 1e-5 of the reference's and of the port's model 1;
    the gathered gradients within 1e-5 of scale of model 1 and within
    ``STACK_REL`` = 3e-4 of the reference's — the bound
    ``tests/test_torch_xlstm.py`` holds the one-process port to, since
    at this random init the stack amplifies rounding (measured here:
    see the printed worst); ``b_i``, whose gradient is zero in exact
    arithmetic, held at the same bound times its layer's ``b_f``;
  - the collectives per pass equal the formula (``pass_counts``): per
    mLSTM layer 2 reduces (the gates, ``down``) and 2 copies (the input,
    the gates), per sLSTM a copy of the input and an all-gather of h,
    and its GeGLU's reduce and copy where it splits;
  - the flat spmd coded gradient at every straggler count within 1e-5 of
    the port's sim mode, bf16 ``grad_dtype`` within 2^-7 of the
    contributions' scale;
  - three ``Trainer(mode="spmd")`` steps equal to the one-process
    trainer's (losses 1e-5; parameters 2e-5, AdamW's normalized step,
    but ``b_i``: a noise gradient's sign decides its step), each step's
    collectives the formula;
  - at d_model 384 a coded checkpoint saved on the axis after step 2
    restores on the axis from worker 1's stripe and the parity, and a
    one-process trainer (model 1) resumes from it with the same full
    leaves, byte for byte;
  - the engine on the mesh (each rank's slab: its slots' mLSTM and sLSTM
    state of its heads) gives one rank's and the JAX engine's tokens,
    slots, timestamps and latencies, each step's collectives the formula.
* A 2-rank job of its own: a narrow xLSTM's gathered gradient lies tens
  of 1e-6 of scale from model 1's with fp32 activations, and within 2e-6
  with float64 ones: the gap is the stack's rounding, not a wrong term.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.serve import CodedDecode as JCodedDecode
from repro.core import Env as JEnv
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import (GCLM, _check_split_axes, init_shards, params_from_numpy,
                                       shard_dims, shard_model)
from repro_torch.train.coded import make_coded_grad_fn, per_shard_grad_rows
from repro_torch.train.trainer import TrainConfig, Trainer

import torch_tp_mla_ranks as R
import torch_tp_xlstm_ranks as X
from test_torch_tp_mla import (BF16_ABS, BF16_REL, ENGINE, LIMIT, PARAM_ATOL, REL,
                               check_gathered_tree, inputs, model1, reference,
                               reference_dims, worst)
from torch_tp_serve_ranks import _engine

pytestmark = pytest.mark.spmd

ARCH = "xlstm-1.3b"
#: the port's one-process xLSTM stack against the reference's, fp32 (the
#: bound of tests/test_torch_xlstm.py, which says why)
STACK_REL = 3e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scales(paths, want) -> list:
    """Each leaf's scale, max |want|; ``b_i``'s (zero in exact arithmetic)
    is the largest of its layer's ``b_f``."""
    by_path = dict(zip(paths, want, strict=True))
    return [float(np.abs(np.asarray(by_path[p[:-1] + "f" if p.endswith("b_i") else p],
                                    np.float32)).max()) for p in paths]


def _paths(c):
    return GCLM(c, device="meta").leaf_paths()


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_shard_dims_are_the_reference_s_and_the_fused_leaves_are_blocked(full):
    """xlstm-1.3b on (data 2, model 2): every leaf split where the
    reference splits it; ``up`` in 2 blocks, ``w_gates`` and ``b_gates`` in
    4, every other leaf in 1; the heads, ``d_inner`` and the vocabulary
    split, the GeGLU (2,731 wide at full width) whole."""
    n_layers = 0 if full else 8
    cfg = get_config(ARCH).reduced(n_layers=n_layers) if n_layers else get_config(ARCH)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(cfg, mesh)
    assert dims == reference_dims(ARCH, 2, n_layers)
    local = init_shards(cfg, mesh, device="meta")
    meta = GCLM(cfg, device="meta")
    want = {"up": 2, "w_gates": 4, "b_gates": 4}
    for path, dim, blocks, t, mine in zip(meta.leaf_paths(), dims, local.shard_blocks,
                                          meta.leaves(), local.leaves()):
        assert blocks == want.get(path.rsplit(".", 1)[-1], 1), path
        if dim is not None:
            assert mine.shape[dim] * 2 == t.shape[dim], path
    assert local.tp.axes == {"d_inner", "heads", "vocab"}


def test_split_check_accepts_a_taken_axis_and_refuses_a_disagreement():
    """The reference's rule skips a mesh axis an earlier dimension took:
    the mLSTM's ``w_if`` (d_inner, heads) splits on d_inner, the sLSTM's
    ``r_gates`` (heads, ·, d_inner) on heads — accepted.  A leaf left whole
    where its axis splits elsewhere (an mLSTM ``wq`` whose heads stay
    whole, an sLSTM ``w_gates`` whose d_inner does) still raises."""
    c = X.cfg(256)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(c, mesh)
    meta = GCLM(c, device="meta")
    paths = meta.leaf_paths()
    assert _check_split_axes(c, meta, dims) == {"d_inner", "heads", "vocab"}
    assert dims[paths.index("stack.0.mixer.w_if")] == 1
    assert dims[paths.index("stack.1.mixer.r_gates")] == 0
    for leaf, axis in (("stack.0.mixer.wq", "heads"), ("stack.1.mixer.w_gates", "d_inner")):
        bad = list(dims)
        bad[paths.index(leaf)] = None
        with pytest.raises(ValueError, match=rf"splits \[.*'{axis}'.*\] in some leaves"):
            _check_split_axes(c, meta, bad)


def test_init_shards_are_shard_model_s_and_hold_every_block():
    """``init_shards`` == ``shard_model``'s cut on every rank; a rank's
    ``up`` is its slice of x_m's columns beside the same slice of z's, its
    ``w_gates`` and ``b_gates`` its heads of each of the four gates."""
    c = X.cfg(256)
    full = GCLM(c, device="cpu", seed=3)
    leaves = dict(zip(full.leaf_paths(), full.leaves()))
    d, d_inner = c.d_model, 2 * c.d_model
    for rank in range(4):
        mesh = meta_mesh(data=2, model=2, rank=rank)
        want = shard_model(full, mesh)
        got = init_shards(c, mesh, device="cpu", seed=3)
        assert got.tp == want.tp and got.shard_dims == want.shard_dims
        assert got.shard_blocks == want.shard_blocks
        assert all(torch.equal(a, b) for a, b in zip(got.leaves(), want.leaves(), strict=True))
        mine = dict(zip(got.leaf_paths(), got.leaves()))
        i = mesh.model_index
        for path, width, blocks in (("stack.0.mixer.up", d_inner, 2),
                                    ("stack.1.mixer.w_gates", d, 4),
                                    ("stack.1.mixer.b_gates", d, 4)):
            whole, n = leaves[path].detach(), width // 2
            cut = [whole[..., j * width + i * n:j * width + (i + 1) * n] for j in range(blocks)]
            assert torch.equal(mine[path], torch.cat(cut, -1)), path


# ------------------------------------------------------------------ the job
def _jax_cfg(d_model: int):
    return jax_get_config(ARCH).reduced(n_layers=8, d_model=d_model)


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job over both widths in a thread, while this
    process computes the reference's gradients at each."""
    tmp = tmp_path_factory.mktemp("tp_xlstm")
    blobs = {d: inputs(X.cfg(d), _jax_cfg(d), tmp / str(d)) for d in X.WIDTHS}
    torch.save({d: {k: v for k, v in b.items() if k != "plan"} for d, b in blobs.items()},
               tmp / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(X.train_rank, 4, str(tmp / "inputs.pt"),
                                               store_dir=str(tmp / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {d: reference(_jax_cfg(d), blobs[d]) for d in X.WIDTHS}
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blobs, result["ranks"], refs


@pytest.fixture(scope="module")
def ones(job):
    return {d: model1(X.cfg(d), job[0][d]) for d in X.WIDTHS}


@pytest.mark.parametrize("d", X.WIDTHS)
def test_ranks_hold_their_heads_and_gather_the_reference_s_tree(job, d):
    blobs, ranks, _ = job
    c = X.cfg(d)
    mine = [r[d] for r in ranks]
    assert [r["coords"] for r in mine] == [(0, i, m) for i in range(2) for m in range(2)]
    axes = ["d_inner", "heads", "vocab"] + (["mlp"] if d == 384 else [])
    assert all(r["axes"] == sorted(axes) for r in mine)
    shapes = dict(zip(_paths(c), mine[0]["shapes"]))
    assert shapes["stack.0.mixer.up"] == (7, d, 2 * d)  # the run of 7: 2 blocks of d_inner/2
    assert shapes["stack.0.mixer.wq"][1] == c.n_heads // 2
    assert shapes["stack.1.mixer.r_gates"][0] == c.n_heads // 2
    assert shapes["stack.1.mixer.w_gates"] == (d, 2 * d)
    assert shapes["stack.1.mixer.gn_scale"] == (d,)
    check_gathered_tree(blobs[d], mine)


@pytest.mark.parametrize("n_layers", X.ROUND_TRIP_LAYERS)
def test_blocked_cut_round_trips_every_leaf(job, n_layers):
    """The shards of reduced xLSTM at 8 layers (a run of 7 mLSTM layers,
    ``up`` stacked, and one sLSTM) and 16 (a pattern of 8 stacked over 2
    repeats: every block one dimension further), gathered back: every
    leaf byte-equal to the full model's; ``up``, ``w_gates`` and
    ``b_gates`` the blocked ones."""
    _, ranks, _ = job
    got = ranks[0]["round_trips"][n_layers]
    assert got["equal"] and all(got["equal"]), [p for p, e in zip(got["paths"], got["equal"])
                                                if not e]
    blocked = {(p.rsplit(".", 1)[-1], b, d) for p, b, d in
               zip(got["paths"], got["blocks"], got["dims"]) if b > 1}
    lead = int(n_layers == 16)
    assert blocked == {("up", 2, 2), ("w_gates", 4, 1 + lead), ("b_gates", 4, lead)}


@pytest.mark.parametrize("d", X.WIDTHS)
def test_loss_and_gradients_match_the_reference_and_model_1(job, ones, d):
    _, ranks, refs = job
    _, metrics, grads = ones[d]
    ref, got = refs[d], ranks[0][d]
    paths = _paths(X.cfg(d))
    assert all(r[d]["metrics"] == got["metrics"] for r in ranks)
    assert got["metrics"].keys() == ref["metrics"].keys() == metrics.keys()
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= REL * abs(want), (k, got["metrics"][k], want)
        assert abs(got["metrics"][k] - metrics[k]) <= REL * abs(metrics[k]), k
    w_m1 = worst(got["grads"], grads, REL, scales(paths, grads))
    w_ref = worst(got["grads"], ref["grads"], STACK_REL, scales(paths, ref["grads"]))
    print(f"d_model {d}: gradients vs the reference {w_ref * STACK_REL:.3e}, vs model 1 "
          f"{w_m1 * REL:.3e} of scale")
    assert w_m1 <= 1 and w_ref <= 1, (w_m1, w_ref)


@pytest.mark.parametrize("d", X.WIDTHS)
def test_collectives_per_pass_equal_the_formula(job, d):
    """One forward and backward: 7 mLSTM layers' 2 reduces and 2 copies,
    the sLSTM's copy and gather of h (and at 384 its GeGLU's reduce and
    copy), the embedding, head and loss.  No data-side collective."""
    _, ranks, _ = job
    up = int(d == 384)
    want = dict(psum=0, psum_scatter=0, broadcast=0, all_gather=1, copy=16 + up,
                reduce=17 + up, max=1)
    assert X.pass_counts(X.cfg(d), 2) == {k: want[k] for k in ("reduce", "copy", "all_gather",
                                                                "max", "psum_scatter")}
    assert all(r[d]["counts"] == want for r in ranks), [r[d]["counts"] for r in ranks]


@pytest.mark.parametrize("d", X.WIDTHS)
def test_spmd_coded_gradients_match_sim_mode(job, ones, d):
    """The flat spmd coded gradient of the shards, gathered, against the
    port's sim mode on the full weights: fp32 within 1e-5 of scale at
    every straggler count, bf16 within 2^-7 of the contributions' scale
    (``b_i``'s, rounding noise on both sides, at its ``b_f``'s); one
    grouped combine per call; the data ranks of a model index
    byte-equal."""
    blobs, ranks, _ = job
    c, blob, model = X.cfg(d), blobs[d], ones[d][0]
    plan, paths = blob["plan"], _paths(c)
    rows = per_shard_grad_rows(c, model, blob["wb"])
    sim = make_coded_grad_fn(c, plan, mode="sim", pipeline="flat")
    got = ranks[0][d]["coded"]
    n, k = plan.n_workers, plan.k_shards
    w32 = 0.0
    for u, dec_w in enumerate(blob["dec_w"]):
        want = [t.numpy() for t in sim.combine(rows, dec_w)]
        w = worst(got["fp32", u]["full"], want, REL, scales(paths, want))
        assert w <= 1, f"{u} stragglers: {w * REL:.3e} of scale"
        w32 = max(w32, w)
        if u == 0:
            contrib = []
            for j, g in enumerate(rows):
                li = plan.flat_layout.leaf_level[j]
                total = sum((float(dec_w[li, i]) / n * torch.as_tensor(
                    plan.b_rows[i, li], dtype=torch.float32) @ g[i * k:(i + 1) * k]).abs()
                            for i in range(n))
                contrib.append(float(total.max()))
            by_path = dict(zip(paths, contrib))  # b_i's noise: held at its b_f's scale
            contrib = [by_path[p[:-1] + "f" if p.endswith("b_i") else p] for p in paths]
            bf16 = got["bf16", 0]["full"]
            w16 = worst(bf16, want, BF16_REL, contrib)
            abs16 = max(float(np.abs(a - b).max()) for a, b in zip(bf16, want))
            assert w16 <= 1 and abs16 <= BF16_ABS, (w16, abs16)
    for key in got:
        for r in ranks:
            assert r[d]["coded"][key]["grouped"] == [len(paths)], key
        for m in range(2):
            assert ranks[m][d]["coded"][key]["digest"] == ranks[m + 2][d]["coded"][key]["digest"]
    print(f"d_model {d}: spmd coded vs sim mode {w32 * REL:.3e} of scale; bf16 {w16:.3f} of "
          "2^-7 of the contributions' scale")


def test_the_axis_gap_is_the_stack_s_rounding(tmp_path):
    """The gathered gradient of narrow xLSTM (``X.ROUNDING``: 8 layers,
    d_model 64) on (data 1, model 2) against model 1's on the same
    weights: with fp32 activations the stack amplifies the split sums'
    rounding to tens of 1e-6 of a leaf's scale (printed; an H100 reads
    up to 2.8e-5 at d_model 384), and with float64 activations (the leaves
    and gradients stay fp32) the gap falls below 2e-6 — what is left is
    the fp32 leaves' own rounding, so no term of the split is wrong.
    ``b_i``, zero in exact arithmetic, is held at its ``b_f``'s scale."""
    out = dist_spawn.spawn(X.rounding_rank, 2, store_dir=str(tmp_path), timeout=LIMIT)[0]
    gaps = {}
    for dtype, got in out.items():
        c = X.rounding_cfg(dtype)
        model = GCLM(c, device="cpu", seed=X.ROUNDING["seed"])
        loss, _ = train_loss(c, model, {"tokens": X.rounding_tokens(c)})
        want = [t.numpy() for t in torch.autograd.grad(loss, model.leaves())]
        gaps[dtype] = worst(got, want, 1.0, scales(_paths(c), want))
    print(f"gathered vs model 1: fp32 activations {gaps['float32']:.3e}, float64 "
          f"{gaps['float64']:.3e} of scale")
    assert gaps["float64"] <= 2e-6 and gaps["float64"] < gaps["float32"] / 5, gaps


def _trainer(c, blob, **kw):
    tr = Trainer(c, TrainConfig(**R.CFG_T), Env.iid(ShiftedExponential(**R.SE), R.N),
                 scheme="xf", global_batch=8, seed=0, device="cpu", params=blob["tree"],
                 seq_len=R.SEQ, **kw)
    return tr


@pytest.mark.parametrize("d", X.WIDTHS)
def test_spmd_trainer_matches_the_one_process_trainer(job, d):
    """Three spmd steps against the one-process trainer: losses 1e-5, the
    gathered parameters 2e-5 (``b_i`` of every layer excepted: its
    gradient is rounding noise, whose sign sets AdamW's step); the data
    ranks of a model index byte-equal; each step's collectives the
    formula, one grouped combine a step."""
    blobs, ranks, _ = job
    c = X.cfg(d)
    tr = _trainer(c, blobs[d])
    tr.run(R.TRAIN_STEPS, log_every=0)
    got = [r[d]["trainer"] for r in ranks]
    np.testing.assert_allclose([h["loss"] for h in got[0]["history"]],
                               [h["loss"] for h in tr.history], rtol=REL)
    assert all(g["history"] == got[0]["history"] for g in got)
    for path, a, b in zip(_paths(c), got[0]["params"], tr.state.params.leaves(), strict=True):
        if not path.endswith("b_i"):
            np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=PARAM_ATOL,
                                       err_msg=path)
    for m in range(2):
        assert got[m]["digests"] == got[m + 2]["digests"]
    want = X.step_counts(c, 2, got[0]["k_shards"], got[0]["n_levels"])
    for g in got:
        assert g["grouped"] == [1] * R.TRAIN_STEPS
        assert g["counts"] == [want] * R.TRAIN_STEPS, (g["counts"], want)


def test_checkpoint_on_the_axis_is_the_full_tree_and_restores_at_model_1(job):
    """At d_model 384 the coded checkpoint saved on the axis after step 2:
    restored on the axis after step 3 from worker 1's stripe and the
    parity, every rank byte-equal to its state at the save; a one-process
    trainer (model 1) resumes from it at step 2 with rank 0's gathered
    leaves, byte for byte."""
    blobs, ranks, _ = job
    d = X.WIDTHS[-1]
    for r in ranks:
        got = r[d]["trainer"]
        assert got["restored_step"] == 2 and got["restored_digest"] == got["saved_digest"]
    saved = ranks[0][d]["trainer"]["saved"]
    tr = _trainer(X.cfg(d), blobs[d],
                  ckpt=CkptConfig(dir=blobs[d]["ckpt"], coded=CodedSpec(R.N, 1)))
    assert int(tr.state.step) == 2
    mine = {k: np.array(v) for k, v in tr.state.full_leaves()}
    assert mine.keys() == saved.keys()
    assert all(mine[k].tobytes() == saved[k].tobytes() for k in saved)


def _jax_engine(d, blob) -> dict:
    run = blob["engine"]
    eng = JServeEngine(_jax_cfg(d), jax.tree.map(jnp.asarray, blob["tree"]),
                       JServeConfig(run["n_slots"], run["max_len"], jnp.float32),
                       coded=JCodedDecode.solve(JEnv.from_dict(run["env"]), budget=4, seed=0))
    reqs = [eng.submit(p, max_new=n, arrival=float(t))
            for p, n, t in zip(run["prompts"], run["news"], run["times"])]
    while eng.step():
        pass
    return dict(latencies=list(eng.step_latencies), now=eng.now,
                tokens=[[int(t) for t in r.tokens] for r in reqs])


@pytest.mark.parametrize("d", X.WIDTHS)
def test_engine_on_the_mesh_equals_one_rank_and_the_jax_engine(job, d):
    """The (2, 2) engine's tokens, slots, timestamps and latencies are one
    rank's, and its tokens and latencies the JAX engine's; a slot serves a
    second request; each rank's slab holds its 2 slots' state of its
    heads — the mLSTM's C, n, m and conv, the sLSTM's h, c, n, m; every
    step's collectives the formula (``serve_counts``)."""
    blobs, ranks, _ = job
    c, blob = X.cfg(d), blobs[d]
    run = blob["engine"]
    one = _engine(c, params_from_numpy(GCLM(c, device="cpu"), blob["tree"]), None, run,
                  torch.float32)
    for r in ranks:
        for key in ("slots", "latencies", "now", "reqs"):
            assert r[d]["engine"][key] == one[key], key
    assert len({s for step in one["slots"] for _, s in step}) < ENGINE["n_requests"]
    ref = _jax_engine(d, blob)
    assert [r["tokens"] for r in one["reqs"]] == ref["tokens"]
    assert one["latencies"] == ref["latencies"] and one["now"] == ref["now"]
    rows = ENGINE["n_slots"] // R.N
    half_heads, dh = c.n_heads // 2, 2 * d // c.n_heads
    for r in ranks:
        got = r[d]["engine"]
        mlstm, slstm = got["slab"]
        assert mlstm["C"] == (7, rows, half_heads, dh, dh) and mlstm["m"] == (7, rows, half_heads)
        assert mlstm["conv"] == (7, rows, 3, d)  # the rank's d_inner / 2 channels
        assert slstm["h"] == slstm["c"] == (rows, d // 2)
        mine = range(r[d]["coords"][1] * rows, (r[d]["coords"][1] + 1) * rows)
        for i, step in enumerate(got["steps"]):
            want = X.serve_counts(c, 2, step, mine, ENGINE["n_slots"], ENGINE["prompt_len"], R.N)
            assert {k: step[k] for k in want} == want, (i, step, want)
