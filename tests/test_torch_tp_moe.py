"""Mixture-of-experts expert parallelism on the port's ``model`` axis
(``models/moe.py`` with a ``ModelSplit``, ``params.shard_dims`` under
``shard_experts``) in training, against the JAX reference, on the CPU.

* The split: ``shard_dims`` of mixtral-8x22b equals the reference's
  ``pspec_for_axes`` on every leaf in the three cases of its greedy rule —
  (a) ``experts`` split (``shard_experts=True``, E divides ``model``),
  (b) ``expert_mlp`` split (the published ``shard_experts=False``), (c)
  neither (E = 4 and width 682 at model 4): the experts whole on every
  rank — reduced and at full width, and ``init_shards`` draws
  ``shard_model``'s cut in each.
* One 4-rank gloo job on (data 2, model 2) (ranks:
  ``tests/torch_tp_moe_ranks.py``, which imports no JAX) of
  ``mixtral-8x22b.reduced()`` in cases (a) and (b), at capacity factor 8
  and at 1.25 (which drops), while this process computes the reference's
  ``train_loss`` gradients on the same weights: the loss, the aux loss
  and the model groups' gathered gradients within 1e-5 of scale of the
  reference's unsharded ones and of the port's one-process (model 1)
  ones, leaf by leaf; the collectives per pass equal the formula; the
  flat spmd coded gradient at every straggler count within 1e-5 of the
  port's sim mode (bf16 ``grad_dtype`` within 2^-7 of the contributions'
  scale), one grouped combine per call, byte-equal over the data ranks
  of a model index; three ``Trainer(mode="spmd")`` steps equal to the
  one-process trainer's (losses 1e-5) with the replicas kept; a coded
  checkpoint of the shards round-trips byte-equal and a one-process
  trainer (model 1) resumes from it.
"""
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.dist.sharding import make_rules as ref_rules
from repro.dist.sharding import pspec_for_axes as ref_pspec
from repro.dist.sharding import use_mesh
from repro.models import model as jmodel
from repro.train.state import abstract_train_state
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.checkpoint import CkptConfig, CodedSpec
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import train_loss
from repro_torch.models import moe
from repro_torch.models.moe import expert_split
from repro_torch.models.params import GCLM, init_shards, params_from_numpy, shard_dims, shard_model
from repro_torch.train.coded import make_coded_grad_fn, per_shard_grad_rows
from repro_torch.train.trainer import TrainConfig, Trainer

import torch_tp_moe_ranks as R

pytestmark = pytest.mark.spmd

ARCH = "mixtral-8x22b"
LIMIT = 300.0
REL = 1e-5
#: bf16 spmd against the fp32 coded gradient: PERF.md §2's spmd bound
BF16_REL, BF16_ABS = 2.0 ** -7, 5e-2
#: the trainers' gathered parameters after three steps (AdamW turns a
#: last-bit gradient difference of a near-zero entry into a visible
#: update: tests/test_torch_tp.py's ``PARAM_ATOL``)
PARAM_ATOL = 3e-6
BATCH = dict(seq_len=32, global_batch=2)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _worst(got, want, rel=REL, scales=None) -> float:
    """Largest per-leaf max error over ``rel`` times the leaf's scale
    (``scales[j]``, by default max |want|): <= 1 is within the bound."""
    worst = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, j
        scale = float(np.abs(b).max()) if scales is None else scales[j]
        err = float(np.abs(a - b).max())
        worst = max(worst, err / (rel * scale) if scale else err)
    return worst


# ------------------------------------------------------------------ the split
#: (shard_experts, model) -> the reference's case
SPLITS = {(False, 2): "b", (True, 2): "a", (False, 4): "c", (True, 4): "a"}


@functools.lru_cache(maxsize=None)
def _reference_dims(shard_experts: bool, model: int, full: bool) -> tuple:
    cfg = jax_get_config(ARCH).replace(shard_experts=shard_experts)
    cfg = cfg if full else cfg.reduced()
    shapes, axes = abstract_train_state(cfg)
    shapes = [tuple(l.shape) for l in jax.tree.leaves(shapes.params)]
    axes = [tuple(a) for a in jax.tree.leaves(axes.params, is_leaf=lambda v: hasattr(v, "axes"))]
    with use_mesh(AbstractMesh((2, model), ("data", "model")), ref_rules(cfg)):
        specs = [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]
    return tuple(spec.index("model") if "model" in spec else None for spec in specs)


@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("split", list(SPLITS), ids=[f"{'a' if se else 'b'}-model{m}"
                                                     for se, m in SPLITS])
def test_expert_splits_are_the_reference_s(split, full):
    """The port's split of every leaf is the reference's; the experts'
    case is (a), (b) or (c) as its greedy rule gives it."""
    shard_experts, model = split
    cfg = get_config(ARCH).replace(shard_experts=shard_experts)
    cfg = cfg if full else cfg.reduced()
    mesh = meta_mesh(data=2, model=model)
    assert shard_dims(cfg, mesh) == _reference_dims(shard_experts, model, full)
    local = init_shards(cfg, mesh, device="meta")
    case = {"experts": "a", "expert_mlp": "b", None: "c"}[expert_split(local.tp)]
    e, f = cfg.layers[0].moe.num_experts, cfg.layers[0].moe.d_ff
    want = ("a" if shard_experts and e % model == 0 else "b" if f % model == 0 else "c")
    assert case == want
    if not full:
        assert case == SPLITS[split]
    paths = dict(zip(local.leaf_paths(), local.leaves()))
    router, wi = paths["stack.0.ffn.router"], paths["stack.0.ffn.wi"]
    assert router.shape[-1] == (e // model if case == "a" else e)
    assert wi.shape[1:] == ((e // model, cfg.d_model, f) if case == "a" else
                            (e, cfg.d_model, f // model) if case == "b" else (e, cfg.d_model, f))


@pytest.mark.parametrize("split", list(SPLITS), ids=[f"{'a' if se else 'b'}-model{m}"
                                                     for se, m in SPLITS])
def test_init_shards_are_shard_model_s_for_experts(split):
    shard_experts, model = split
    cfg = get_config(ARCH).reduced().replace(shard_experts=shard_experts)
    full = GCLM(cfg, device="cpu", seed=3)
    for rank in range(2 * model):
        mesh = meta_mesh(data=2, model=model, rank=rank)
        want = shard_model(full, mesh)
        got = init_shards(cfg, mesh, device="cpu", seed=3)
        assert got.tp == want.tp and got.shard_dims == want.shard_dims
        assert all(torch.equal(a, b) for a, b in zip(got.leaves(), want.leaves(), strict=True))


def test_other_families_raise_naming_6c():
    """The families ROADMAP 6c put on the axis — xLSTM, Whisper, vision —
    split no expert axis: they have no MoE layer."""
    mesh = meta_mesh(data=2, model=2)
    for arch in ("xlstm-1.3b", "whisper-base", "llama-3.2-vision-11b"):
        cfg = get_config(arch).reduced(n_layers=2)
        assert any(d is not None for d in shard_dims(cfg, mesh)), arch
        axes = init_shards(cfg, mesh, device="meta").tp.axes
        assert "heads" in axes and not axes & {"experts", "expert_mlp"}, arch


# ------------------------------------------------------------------ the job
def _jax_cfg(capacity_factor: float):
    import dataclasses

    base = jax_get_config(ARCH).reduced()
    return base.replace(layers=tuple(dataclasses.replace(
        l, moe=dataclasses.replace(l.moe, capacity_factor=capacity_factor))
        for l in base.layers))


def _dec_ws(plan) -> list:
    out = []
    for u in range(plan.s_max + 1):
        times = np.ones(R.N)
        times[:u] = 1e6
        out.append(plan.decode_weights(times).astype(np.float32))
    return out


def _inputs(tmp) -> dict:
    state, _ = jax_init_train_state(_jax_cfg(8.0), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    c = R.cfg("b", 8.0)
    plan = Plan.build(GCLM(c, device="meta"), ShiftedExponential(**R.SE), R.N, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=32, global_batch=8))
    return dict(tree=tree, plan=plan, dec_w=_dec_ws(plan),
                wb=coded_worker_batches(data, 0, R.N, plan.s_max),
                batch=SyntheticTokens(DataConfig(vocab=c.vocab, **BATCH)).batch(0),
                ckpt=str(tmp / "ckpt"))


def _reference(blob) -> dict:
    """The reference's loss, aux loss and gradients at each capacity."""
    out = {}
    params = jax.tree.map(jnp.asarray, blob["tree"])
    for cf in R.CAPACITIES:
        cfg = _jax_cfg(cf)

        def loss_fn(p, cfg=cfg):
            return jmodel.train_loss(cfg, p, {"tokens": jnp.asarray(blob["batch"])})

        (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        out[cf] = dict(loss=float(loss), aux=float(metrics["aux"]),
                       grads=[np.asarray(g) for g in jax.tree.leaves(grads)])
    return out


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job in a thread, while this process computes the
    reference's gradients."""
    d = tmp_path_factory.mktemp("tp_moe")
    blob = _inputs(d)
    torch.save({k: v for k, v in blob.items() if k != "plan"}, d / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(R.train_rank, 4, str(d / "inputs.pt"),
                                               store_dir=str(d / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        ref = _reference(blob)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blob, result["ranks"], ref


@pytest.fixture(scope="module")
def model1(job):
    """The port's model 1 per capacity: the full module on the reference's
    weights, its loss, aux loss and gradients on the batch."""
    blob = job[0]
    out = {}
    for cf in R.CAPACITIES:
        c = R.cfg("b", cf)
        model = params_from_numpy(GCLM(c, device="cpu"), blob["tree"])
        loss, metrics = train_loss(c, model, {"tokens": blob["batch"]})
        grads = torch.autograd.grad(loss, model.leaves())
        out[cf] = (model, float(loss), float(metrics["aux"]), [g.numpy() for g in grads])
    return out


CASE_CF = [(case, cf) for case in R.CASES for cf in R.CAPACITIES]
IDS = [f"{case}-cf{cf}" for case, cf in CASE_CF]


def test_ranks_lie_on_the_mesh(job):
    _, ranks, _ = job
    assert [r["coords"] for r in ranks] == [(0, d, m) for d in range(2) for m in range(2)]
    for case, cf in CASE_CF:
        want = {"a": "experts", "b": "expert_mlp"}[case]
        assert all(want in r[case, cf]["axes"] for r in ranks)
        assert {"experts", "expert_mlp"} - {want} - set(ranks[0][case, cf]["axes"]) == {
            "experts", "expert_mlp"} - {want}


@pytest.mark.parametrize("case,cf", CASE_CF, ids=IDS)
def test_loss_aux_and_gradients_match_the_reference_and_model_1(job, model1, case, cf):
    """Every rank's loss and aux loss equal (all-reduced); the gathered
    gradients within 1e-5 of scale of the reference's unsharded
    ``train_loss`` gradients and of the port's model 1, leaf by leaf."""
    blob, ranks, ref = job
    got = ranks[0][case, cf]
    _, loss, aux, grads = model1[cf]
    assert all(r[case, cf]["loss"] == got["loss"] and r[case, cf]["aux"] == got["aux"]
               for r in ranks)
    assert abs(got["loss"] - ref[cf]["loss"]) <= REL * abs(ref[cf]["loss"]), (got["loss"],
                                                                              ref[cf]["loss"])
    assert abs(got["aux"] - ref[cf]["aux"]) <= REL * ref[cf]["aux"], (got["aux"], ref[cf]["aux"])
    assert abs(got["loss"] - loss) <= REL * abs(loss) and abs(got["aux"] - aux) <= REL * aux
    worst_ref, worst_m1 = _worst(got["grads"], ref[cf]["grads"]), _worst(got["grads"], grads)
    assert worst_ref <= 1 and worst_m1 <= 1, (
        f"worst leaf error over 1e-5 of scale: reference {worst_ref:.3f}, model 1 {worst_m1:.3f}")
    print(f"[{case} cf {cf}] gradients vs the reference {worst_ref * REL:.3e}, "
          f"vs model 1 {worst_m1 * REL:.3e} of scale")


def test_capacity_1_25_drops_and_8_does_not(job, model1):
    """The published capacity factor drops assignments on this batch (the
    losses differ from capacity 8's); the reduced config's drops none."""
    blob, _, ref = job
    model = model1[1.25][0]

    dropped = {}
    orig = moe.route
    try:
        for cf in R.CAPACITIES:
            calls = []

            def counting(*args, **kw):
                r = orig(*args, **kw)
                calls.append(int((r.keep == 0).sum()))
                return r

            moe.route = counting
            with torch.no_grad():
                train_loss(R.cfg("b", cf), model, {"tokens": blob["batch"]})
            dropped[cf] = sum(calls)
    finally:
        moe.route = orig
    assert dropped[8.0] == 0 and dropped[1.25] > 0, dropped
    assert ref[8.0]["loss"] != ref[1.25]["loss"]


@pytest.mark.parametrize("case,cf", CASE_CF, ids=IDS)
def test_collectives_per_pass_equal_the_formula(job, case, cf):
    """One forward and backward of L layers: the model group's all-reduces
    — per layer forward attention's and the MoE output's (g), backward
    attention's input and the MoE's gates and expert input (f); the
    vocab-parallel embedding (g), head (f) and loss (two g, one max) —
    and in case (a) one all-gather of the router's logits per layer;
    no data-side collective."""
    _, ranks, _ = job
    layers = R.cfg(case, cf).n_layers
    for r in ranks:
        counts = r[case, cf]["counts"]
        assert counts == dict(psum=0, psum_scatter=0, broadcast=0,
                              all_gather=layers if case == "a" else 0,
                              model_copy=3 * layers + 1, model_reduce=2 * layers + 3,
                              model_max=1), counts


@pytest.mark.parametrize("case,cf", CASE_CF, ids=IDS)
def test_spmd_coded_gradients_match_sim_mode(job, model1, case, cf):
    """The flat spmd coded gradient of the shards at 0, 1 and s_max
    stragglers, gathered: within 1e-5 of the port's one-process sim mode;
    bf16 ``grad_dtype`` within 2^-7 of the contributions' scale and 5e-2;
    one grouped combine per call; byte-equal over the data ranks of a
    model index."""
    blob, ranks, _ = job
    model = model1[cf][0]
    c = R.cfg(case, cf)
    plan = blob["plan"]
    rows = per_shard_grad_rows(c, model, blob["wb"])
    sim = make_coded_grad_fn(c, plan, mode="sim", pipeline="flat")
    got = ranks[0][case, cf]["coded"]
    worst = 0.0
    n, k = plan.n_workers, plan.k_shards
    for u, dec_w in enumerate(blob["dec_w"]):
        want = [t.numpy() for t in sim.combine(rows, dec_w)]
        w = _worst(got["fp32", u]["full"], want)
        assert w <= 1, f"{u} stragglers: {w * REL:.3e} of scale"
        worst = max(worst, w)
        if u == 0:
            scales = []
            for j, g in enumerate(rows):
                li = plan.flat_layout.leaf_level[j]
                total = sum((float(dec_w[li, i]) / n * torch.as_tensor(
                    plan.b_rows[i, li], dtype=torch.float32) @ g[i * k:(i + 1) * k]).abs()
                            for i in range(n))
                scales.append(float(total.max()))
            bf16 = got["bf16", 0]["full"]
            w16 = _worst(bf16, want, BF16_REL, scales)
            abs16 = max(float(np.abs(a - b).max()) for a, b in zip(bf16, want))
            assert w16 <= 1 and abs16 <= BF16_ABS, (
                f"bf16: {w16:.3f} of 2^-7 of the contributions' scale, max abs {abs16:.3e}")
    for key in got:
        for r in ranks:
            assert r[case, cf]["coded"][key]["grouped"] == [len(model.leaves())], key
        for m in range(2):
            assert ranks[m][case, cf]["coded"][key]["digest"] == \
                ranks[m + 2][case, cf]["coded"][key]["digest"], key
    print(f"[{case} cf {cf}] spmd coded vs sim mode {worst * REL:.3e} of scale; bf16 "
          f"{w16:.3f} of 2^-7 of the contributions' scale, max abs {abs16:.3e}")


@pytest.mark.parametrize("case", list(R.CASES))
def test_spmd_trainer_matches_the_one_process_trainer(job, case):
    """Three steps at capacity 1.25 on (data 2, model 2): the losses within
    1e-5 of the one-process sim-mode trainer's, the parameters within
    ``PARAM_ATOL``; the data ranks of a model index hold the same bytes
    after every step; one grouped combine per rank per step."""
    blob, ranks, _ = job
    tr = Trainer(R.cfg(case, 1.25), TrainConfig(**R.CFG_T),
                 Env.iid(ShiftedExponential(**R.SE), R.N), scheme="xf", global_batch=8, seed=0,
                 device="cpu", params=blob["tree"], seq_len=32)
    tr.run(R.TRAIN_STEPS, log_every=0)
    got = [r["trainer", case] for r in ranks]
    np.testing.assert_allclose([h["loss"] for h in got[0]["history"]],
                               [h["loss"] for h in tr.history], rtol=REL)
    assert all(g["history"] == got[0]["history"] for g in got)
    for a, b in zip(got[0]["params"], tr.state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=PARAM_ATOL)
    for m in range(2):
        assert got[m]["digests"] == got[m + 2]["digests"]
    assert got[0]["digests"] != got[1]["digests"]
    assert all(g["grouped"] == [1] * R.TRAIN_STEPS for g in got)


def test_coded_checkpoint_of_expert_shards_round_trips_and_restores_at_model_1(job):
    """Case (b)'s coded checkpoint after step 2: restored from the stripe
    of worker 1 and the parity (worker 0's lost) byte-equal on every
    rank; a one-process trainer (model 1) resumes from it at step 2 with
    the gathered state, byte for byte."""
    blob, ranks, _ = job
    for r in ranks:
        ck = r["trainer", "b"]["ckpt"]
        assert ck["step"] == 2 and ck["restored"] == ck["saved"]
    full = ranks[0]["trainer", "b"]["ckpt"]["full"]
    tr = Trainer(R.cfg("b", 1.25), TrainConfig(**R.CFG_T),
                 Env.iid(ShiftedExponential(**R.SE), R.N), scheme="xf", global_batch=8, seed=0,
                 device="cpu", params=blob["tree"], seq_len=32,
                 ckpt=CkptConfig(dir=blob["ckpt"], coded=CodedSpec(R.N, 1)))
    assert int(tr.state.step) == 2
    mine = {k: np.array(v) for k, v in tr.state.full_leaves()}
    assert mine.keys() == full.keys()
    assert all(mine[k].tobytes() == full[k].tobytes() for k in full)
