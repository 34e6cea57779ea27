"""The Mamba mixer on the port's ``model`` axis (``models/ssm.py`` with a
``ModelSplit``, Mamba's ``in_proj`` cut block by block) in training,
checkpoints and serving, against the JAX reference, on the CPU.

* The split: ``shard_dims`` of jamba-v0.1-52b equals the reference's
  ``pspec_for_axes`` on every leaf, reduced and at full width; every
  Mamba leaf splits on ``d_inner``, and ``in_proj`` — the input x and the
  gate z side by side — is cut in 2 blocks (``shard_blocks``), so a rank
  holds its channels of both; ``init_shards`` draws ``shard_model``'s
  cut.
* One 4-rank gloo job on (data 2, model 2) (ranks:
  ``tests/torch_tp_mamba_ranks.py``, which imports no JAX) of
  jamba-v0.1-52b reduced to d_model 128 at three layers — Mamba with a
  dense MLP, Mamba with the MoE FFN (split by expert), global attention —
  while this process computes the reference's ``train_loss`` gradients
  on the same weights:
  - the shards gathered back are the reference's tree byte for byte, and
    so are those of 8 and 16 reduced layers (runs, and a pattern whose
    stacked ``in_proj`` is cut on dimension 2);
  - the loss, ``xent`` and ``aux`` and the gathered gradients within 1e-5
    of scale of the reference's and of the port's model 1, leaf by leaf;
  - the collectives per pass equal the formula (``pass_counts``): per
    Mamba layer two reduces (``x_proj``, ``out_proj``) and two copies
    (the input, ``x_proj``'s reduced output);
  - the flat spmd coded gradient at every straggler count within 1e-5 of
    the port's sim mode, bf16 ``grad_dtype`` within 2^-7 of the
    contributions' scale;
  - three ``Trainer(mode="spmd")`` steps equal to the one-process
    trainer's, each step's collectives the formula;
  - a coded checkpoint saved on the axis after step 2 is the reference's
    full tree: restored on the axis from worker 1's stripe and the
    parity, byte-equal; a one-process trainer (model 1) resumes from it
    with the same full leaves, byte for byte;
  - the engine on the mesh (each rank's slab: its slots' Mamba state of
    its channels) gives one rank's tokens, slots, timestamps
    and latencies, each step's collectives the formula.
"""
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, ShiftedExponential
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.params import GCLM, init_shards, shard_dims, shard_model
from repro_torch.train.trainer import TrainConfig, Trainer

import torch_tp_mamba_ranks as M
import torch_tp_mla_ranks as R
from test_torch_tp_mla import (ENGINE, check_coded, check_engine, check_gathered_tree,
                               check_gradients, check_trainer, model1, reference_dims, run_job)

pytestmark = pytest.mark.spmd

ARCH = "jamba-v0.1-52b"


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_shard_dims_are_the_reference_s_and_in_proj_is_blocked(full):
    """jamba-v0.1-52b on (data 2, model 2): every leaf split where the
    reference splits it; every Mamba leaf on ``d_inner``; ``in_proj`` in 2
    blocks, every other leaf in 1."""
    n_layers = 0 if full else 8
    cfg = get_config(ARCH).reduced(n_layers=n_layers) if n_layers else get_config(ARCH)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(cfg, mesh)
    assert dims == reference_dims(ARCH, 2, n_layers)
    local = init_shards(cfg, mesh, device="meta")
    meta = GCLM(cfg, device="meta")
    for path, axes, dim, blocks, t, mine in zip(meta.leaf_paths(), meta.leaf_axes(), dims,
                                                local.shard_blocks, meta.leaves(),
                                                local.leaves()):
        if ".mixer." in path and "d_inner" in axes:
            assert dim == axes.index("d_inner"), path
        assert blocks == (2 if path.endswith("in_proj") else 1), path
        if dim is not None:
            assert mine.shape[dim] * 2 == t.shape[dim], path
    assert "d_inner" in local.tp.axes


def test_init_shards_are_shard_model_s_and_hold_both_blocks():
    """``init_shards`` == ``shard_model``'s cut on every rank; a rank's
    ``in_proj`` is its slice of x's columns beside the same slice of z's."""
    c = M.cfg()
    full = GCLM(c, device="cpu", seed=3)
    path = "stack.0.mixer.in_proj"
    d_inner = c.mamba.expand * c.d_model
    n = d_inner // 2
    whole = dict(zip(full.leaf_paths(), full.leaves()))[path].detach()
    for rank in range(4):
        mesh = meta_mesh(data=2, model=2, rank=rank)
        want = shard_model(full, mesh)
        got = init_shards(c, mesh, device="cpu", seed=3)
        assert got.tp == want.tp and got.shard_dims == want.shard_dims
        assert got.shard_blocks == want.shard_blocks
        assert all(torch.equal(a, b) for a, b in zip(got.leaves(), want.leaves(), strict=True))
        mine = dict(zip(got.leaf_paths(), got.leaves()))[path]
        i = mesh.model_index
        assert torch.equal(mine, torch.cat([whole[:, i * n:(i + 1) * n],
                                            whole[:, d_inner + i * n:d_inner + (i + 1) * n]], 1))


# ------------------------------------------------------------------ the job
def _jax_cfg():
    base = jax_get_config(ARCH).reduced(n_layers=8, d_model=128)
    return base.replace(n_layers=3, layers=(base.layers[0], base.layers[1], base.layers[4]))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(M.train_rank, M.cfg(), _jax_cfg(), tmp_path_factory.mktemp("tp_mamba"))


@pytest.fixture(scope="module")
def one(job):
    return model1(M.cfg(), job[0])


def test_ranks_hold_their_channels_and_gather_the_reference_s_tree(job):
    blob, ranks, _ = job
    c = M.cfg()
    assert [r["coords"] for r in ranks] == [(0, d, m) for d in range(2) for m in range(2)]
    assert all(r["axes"] == ["d_inner", "experts", "heads", "kv_heads", "mlp", "vocab"]
               for r in ranks)
    shapes = dict(zip(GCLM(c, device="meta").leaf_paths(), ranks[0]["shapes"]))
    d_inner = c.mamba.expand * c.d_model
    assert shapes["stack.0.mixer.in_proj"] == (c.d_model, d_inner)
    assert shapes["stack.0.mixer.x_proj"][0] == d_inner // 2
    assert shapes["stack.0.mixer.a_log"] == (d_inner // 2, c.mamba.d_state)
    check_gathered_tree(blob, ranks)


@pytest.mark.parametrize("n_layers", M.ROUND_TRIP_LAYERS)
def test_blocked_cut_round_trips_every_leaf(job, n_layers):
    """The shards of reduced Jamba at 8 layers (runs) and 16 (a pattern of
    8 stacked over 2 repeats: ``in_proj``'s blocks on dimension 2),
    gathered back: every leaf byte-equal to the full model's."""
    _, ranks, _ = job
    got = ranks[0]["round_trips"][n_layers]
    assert got["equal"] and all(got["equal"]), [p for p, e in zip(got["paths"], got["equal"])
                                                if not e]
    blocked = {(p, d) for p, b, d in zip(got["paths"], got["blocks"], got["dims"]) if b > 1}
    assert blocked and all(p.endswith("mixer.in_proj") for p, _ in blocked)
    assert {d for _, d in blocked} == ({1} if n_layers == 8 else {2})


def test_loss_and_gradients_match_the_reference_and_model_1(job, one):
    _, ranks, ref = job
    w_ref, w_m1 = check_gradients(ranks, ref, one)
    print(f"gradients vs the reference {w_ref:.3e}, vs model 1 {w_m1:.3e} of scale")


def test_collectives_per_pass_equal_the_formula(job):
    """One forward and backward: per Mamba layer 2 reduces and 2 copies,
    attention's 1 and 1, each dense MLP's 1 and 1, the MoE layer's output
    reduce, 2 copies and router gather; the embedding, head and loss."""
    _, ranks, _ = job
    want = dict(psum=0, psum_scatter=0, broadcast=0, all_gather=1, copy=10, reduce=11, max=1)
    assert R.pass_counts(M.cfg(), 2) == {k: want[k] for k in ("reduce", "copy", "all_gather",
                                                               "max")}
    assert all(r["counts"] == want for r in ranks), [r["counts"] for r in ranks]


def test_spmd_coded_gradients_match_sim_mode(job, one):
    blob, ranks, _ = job
    w32, w16 = check_coded(M.cfg(), blob, ranks, one[0])
    print(f"spmd coded vs sim mode {w32:.3e} of scale; bf16 {w16:.3f} of 2^-7 of the "
          "contributions' scale")


def test_spmd_trainer_matches_the_one_process_trainer(job):
    blob, ranks, _ = job
    check_trainer(M.cfg(), blob, ranks)


def test_checkpoint_on_the_axis_is_the_full_tree_and_restores_at_model_1(job):
    """The coded checkpoint saved on the axis after step 2: restored on the
    axis after step 3 from worker 1's stripe and the parity, every rank
    byte-equal to its state at the save; a one-process trainer (model 1)
    resumes from it at step 2 with rank 0's gathered leaves, byte for
    byte."""
    blob, ranks, _ = job
    for r in ranks:
        got = r["trainer"]
        assert got["restored_step"] == 2 and got["restored_digest"] == got["saved_digest"]
    saved = ranks[0]["trainer"]["saved"]
    tr = Trainer(M.cfg(), TrainConfig(**R.CFG_T), Env.iid(ShiftedExponential(**R.SE), R.N),
                 scheme="xf", global_batch=8, seed=0, device="cpu", params=blob["tree"],
                 seq_len=R.SEQ, ckpt=CkptConfig(dir=blob["ckpt"], coded=CodedSpec(R.N, 1)))
    assert int(tr.state.step) == 2
    mine = {k: np.array(v) for k, v in tr.state.full_leaves()}
    assert mine.keys() == saved.keys()
    assert all(mine[k].tobytes() == saved[k].tobytes() for k in saved)


def test_engine_on_the_mesh_equals_one_rank_with_the_channels_split(job):
    """The (2, 2) engine's tokens, slots, timestamps and latencies are one
    rank's; a slot serves a second request; each rank's slab holds its 2
    slots' Mamba state of its 128 channels; every step's
    collectives the formula (the MoE layer's id and router gathers
    included)."""
    blob, ranks, _ = job
    c = M.cfg()
    check_engine(c, blob, ranks)
    half = c.mamba.expand * c.d_model // 2
    rows = ENGINE["n_slots"] // R.N
    for r in ranks:
        mamba = [seg for seg in r["engine"]["slab"] if "h" in seg]
        assert len(mamba) == 2
        for seg in mamba:
            assert seg["h"] == (rows, half, c.mamba.d_state)
            assert seg["conv"] == (rows, c.mamba.d_conv - 1, half)
