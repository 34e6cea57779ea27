"""Multi-head latent attention and multi-token prediction on the port's
``model`` axis (``models/mla.py`` and ``models/model.py::_mtp_loss`` with a
``ModelSplit``) in training and serving, against the JAX reference, on
the CPU.

* The split: ``shard_dims`` of deepseek-v3-671b equals the reference's
  ``pspec_for_axes`` on every leaf, reduced and at full width; MLA's
  ``wq_b``, ``wk_b``, ``wv_b`` and ``wo`` split on ``heads``, its latent
  projections and norms stay whole; ``init_shards`` draws
  ``shard_model``'s cut.
* One 4-rank gloo job on (data 2, model 2) (ranks:
  ``tests/torch_tp_mla_ranks.py``, which imports no JAX) of
  deepseek-v3-671b reduced to d_model 128 at two layers — a dense MLA
  layer and the first MoE layer (split by expert) — with MTP depth 1,
  while this process computes the reference's ``train_loss`` gradients
  on the same weights:
  - the shards gathered back are the reference's tree byte for byte;
  - the loss, ``xent``, ``aux`` and ``mtp`` and the gathered gradients
    within 1e-5 of scale of the reference's and of the port's model 1,
    leaf by leaf (the MTP module's included);
  - the collectives per pass equal the formula (``pass_counts``);
  - the flat spmd coded gradient at every straggler count within 1e-5 of
    the port's sim mode, bf16 ``grad_dtype`` within 2^-7 of the
    contributions' scale; one grouped combine per call;
  - three ``Trainer(mode="spmd")`` steps equal to the one-process
    trainer's, each step's collectives the formula (``step_counts``);
  - the engine on the mesh (the latent slab whole on every rank) gives
    one rank's tokens, slots, timestamps and latencies, each step's
    collectives the formula (``serve_counts``).
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
from repro.core import Env as JEnv
from repro.core import ShiftedExponential as JShiftedExp
from repro.dist.sharding import make_rules as ref_rules
from repro.dist.sharding import pspec_for_axes as ref_pspec
from repro.dist.sharding import use_mesh
from repro.models import model as jmodel
from repro.train.state import abstract_train_state
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM, init_shards, params_from_numpy, shard_dims, shard_model
from repro_torch.sim import arrivals
from repro_torch.train.coded import make_coded_grad_fn, per_shard_grad_rows
from repro_torch.train.trainer import TrainConfig, Trainer

import torch_tp_mla_ranks as R
from torch_tp_serve_ranks import _engine

pytestmark = pytest.mark.spmd

ARCH = "deepseek-v3-671b"
LIMIT = 300.0
REL = 1e-5
#: bf16 spmd against the fp32 coded gradient: PERF.md §2's spmd bound
BF16_REL, BF16_ABS = 2.0 ** -7, 5e-2
#: the trainers' gathered parameters after three steps: AdamW's normalized
#: step turns a last-bit difference of a near-zero gradient entry into a
#: visible update (an ``embed.tok`` entry whose gradient is ~6e-10 moves
#: 1.6e-5 apart here); tests/test_torch_deepseek.py holds the port's
#: trainer to the reference's at the same 2e-5
PARAM_ATOL = 2e-5
BATCH = dict(seq_len=R.SEQ, global_batch=2)
#: the engine: 4 slots over 2 data ranks, 6 requests (a slot serves a second)
ENGINE = dict(n_slots=4, max_len=20, n_requests=6, prompt_len=8, rate=1.0)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def worst(got, want, rel=REL, scales=None) -> float:
    """Largest per-leaf max error over ``rel`` times the leaf's scale
    (``scales[j]``, by default max |want|): <= 1 is within the bound."""
    out = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, j
        scale = float(np.abs(b).max()) if scales is None else scales[j]
        err = float(np.abs(a - b).max())
        out = max(out, err / (rel * scale) if scale else err)
    return out


@functools.lru_cache(maxsize=None)
def reference_dims(arch: str, model: int, n_layers: int = 0) -> tuple:
    """The reference's split dimension of every leaf on (data 2, model),
    at full width, or reduced to ``n_layers`` layers."""
    cfg = jax_get_config(arch).reduced(n_layers=n_layers) if n_layers else jax_get_config(arch)
    shapes, axes = abstract_train_state(cfg)
    shapes = [tuple(l.shape) for l in jax.tree.leaves(shapes.params)]
    axes = [tuple(a) for a in jax.tree.leaves(axes.params, is_leaf=lambda v: hasattr(v, "axes"))]
    with use_mesh(AbstractMesh((2, model), ("data", "model")), ref_rules(cfg)):
        specs = [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]
    return tuple(spec.index("model") if "model" in spec else None for spec in specs)


def dec_ws(plan) -> list:
    out = []
    for u in range(plan.s_max + 1):
        times = np.ones(R.N)
        times[:u] = 1e6
        out.append(plan.decode_weights(times).astype(np.float32))
    return out


def engine_run(vocab: int) -> dict:
    rng = np.random.default_rng(3)
    news = rng.integers(3, ENGINE["max_len"] - ENGINE["prompt_len"] + 1,
                        ENGINE["n_requests"]).tolist()
    return dict(ENGINE, env=JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), 6).to_dict(), news=news,
                prompts=[rng.integers(0, vocab, ENGINE["prompt_len"]).astype(np.int32)
                         for _ in news],
                times=arrivals.poisson_arrivals(ENGINE["n_requests"], ENGINE["rate"], seed=0))


def inputs(c, jax_cfg, tmp) -> dict:
    """The reference's weights of ``jax_cfg``, the plan, decode weights at
    every straggler count, the workers' batches, one batch and the
    engine's load."""
    state, _ = jax_init_train_state(jax_cfg, jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    plan = Plan.build(GCLM(c, device="meta"), ShiftedExponential(**R.SE), R.N, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=R.SEQ, global_batch=8))
    return dict(tree=tree, plan=plan, dec_w=dec_ws(plan),
                wb=coded_worker_batches(data, 0, R.N, plan.s_max),
                batch=SyntheticTokens(DataConfig(vocab=c.vocab, **BATCH)).batch(0),
                engine=engine_run(c.vocab), ckpt=str(tmp / "ckpt"))


def reference(jax_cfg, blob) -> dict:
    """The reference's loss, metrics and gradients on the batch."""
    params = jax.tree.map(jnp.asarray, blob["tree"])

    def loss_fn(p):
        return jmodel.train_loss(jax_cfg, p, {"tokens": jnp.asarray(blob["batch"])})

    (loss, metrics), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)])


def run_job(rank_fn, c, jax_cfg, tmp) -> tuple:
    """The port's 4-rank job in a thread, while this process computes the
    reference's gradients; then the port's model 1 on the same weights."""
    blob = inputs(c, jax_cfg, tmp)
    torch.save({k: v for k, v in blob.items() if k != "plan"}, tmp / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(rank_fn, 4, str(tmp / "inputs.pt"),
                                               store_dir=str(tmp / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        ref = reference(jax_cfg, blob)
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blob, result["ranks"], ref


def model1(c, blob) -> tuple:
    """The port's one-process model on the reference's weights, its
    metrics and gradients on the batch."""
    model = params_from_numpy(GCLM(c, device="cpu"), blob["tree"])
    loss, metrics = train_loss(c, model, {"tokens": blob["batch"]})
    grads = torch.autograd.grad(loss, model.leaves())
    return model, {k: float(v.detach()) for k, v in metrics.items()}, [g.numpy() for g in grads]


# --------------------------------------------------- checks shared with Mamba
def check_gathered_tree(blob, ranks):
    """The gathered shards are the reference's tree, byte for byte."""
    want = [np.asarray(a, np.float32) for a in jax.tree.leaves(blob["tree"])]
    got = ranks[0]["gathered"]
    assert len(got) == len(want)
    assert all(a.tobytes() == b.tobytes() for a, b in zip(got, want))


def check_gradients(ranks, ref, m1):
    _, metrics, grads = m1
    got = ranks[0]
    assert all(r["metrics"] == got["metrics"] for r in ranks)
    assert got["metrics"].keys() == ref["metrics"].keys() == metrics.keys()
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= REL * abs(want), (k, got["metrics"][k], want)
        assert abs(got["metrics"][k] - metrics[k]) <= REL * abs(metrics[k]), k
    w_ref, w_m1 = worst(got["grads"], ref["grads"]), worst(got["grads"], grads)
    assert w_ref <= 1 and w_m1 <= 1, (
        f"worst leaf error over 1e-5 of scale: reference {w_ref:.3f}, model 1 {w_m1:.3f}")
    return w_ref * REL, w_m1 * REL


def check_coded(c, blob, ranks, model):
    """The flat spmd coded gradient of the shards against sim mode."""
    plan = blob["plan"]
    rows = per_shard_grad_rows(c, model, blob["wb"])
    sim = make_coded_grad_fn(c, plan, mode="sim", pipeline="flat")
    got = ranks[0]["coded"]
    n, k = plan.n_workers, plan.k_shards
    w32 = 0.0
    for u, dec_w in enumerate(blob["dec_w"]):
        want = [t.numpy() for t in sim.combine(rows, dec_w)]
        w = worst(got["fp32", u]["full"], want)
        assert w <= 1, f"{u} stragglers: {w * REL:.3e} of scale"
        w32 = max(w32, w)
        if u == 0:
            scales = []
            for j, g in enumerate(rows):
                li = plan.flat_layout.leaf_level[j]
                total = sum((float(dec_w[li, i]) / n * torch.as_tensor(
                    plan.b_rows[i, li], dtype=torch.float32) @ g[i * k:(i + 1) * k]).abs()
                            for i in range(n))
                scales.append(float(total.max()))
            bf16 = got["bf16", 0]["full"]
            w16 = worst(bf16, want, BF16_REL, scales)
            abs16 = max(float(np.abs(a - b).max()) for a, b in zip(bf16, want))
            assert w16 <= 1 and abs16 <= BF16_ABS, (
                f"bf16: {w16:.3f} of 2^-7 of the contributions' scale, max abs {abs16:.3e}")
    for key in got:
        for r in ranks:
            assert r["coded"][key]["grouped"] == [len(model.leaves())], key
        for m in range(2):
            assert ranks[m]["coded"][key]["digest"] == ranks[m + 2]["coded"][key]["digest"], key
    return w32 * REL, w16


def check_trainer(c, blob, ranks, param_atol=PARAM_ATOL, **kw):
    """Three spmd steps against the one-process trainer (losses 1e-5, the
    gathered parameters ``param_atol``); each step's collectives the
    formula.  Returns the one-process trainer."""
    tr = Trainer(c, TrainConfig(**R.CFG_T), Env.iid(ShiftedExponential(**R.SE), R.N),
                 scheme="xf", global_batch=8, seed=0, device="cpu", params=blob["tree"],
                 seq_len=R.SEQ, **kw)
    tr.run(R.TRAIN_STEPS, log_every=0)
    got = [r["trainer"] for r in ranks]
    np.testing.assert_allclose([h["loss"] for h in got[0]["history"]],
                               [h["loss"] for h in tr.history], rtol=REL)
    assert all(g["history"] == got[0]["history"] for g in got)
    for a, b in zip(got[0]["params"], tr.state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=param_atol)
    for m in range(2):
        assert got[m]["digests"] == got[m + 2]["digests"]
    assert got[0]["digests"] != got[1]["digests"]
    want = R.step_counts(c, 2, got[0]["k_shards"], got[0]["n_levels"])
    for g in got:
        assert g["grouped"] == [1] * R.TRAIN_STEPS
        assert g["counts"] == [want] * R.TRAIN_STEPS, (g["counts"], want)
    return tr


def check_engine(c, blob, ranks):
    """The engine on the mesh against one rank's on the same weights."""
    run = blob["engine"]
    one = _engine(c, params_from_numpy(GCLM(c, device="cpu"), blob["tree"]), None, run,
                  torch.float32)
    for r in ranks:
        for key in ("slots", "latencies", "now", "reqs"):
            assert r["engine"][key] == one[key], key
    assert len({(i, s) for step in one["slots"] for i, s in step}) == ENGINE["n_requests"]
    assert len({s for step in one["slots"] for _, s in step}) < ENGINE["n_requests"]
    rows = ENGINE["n_slots"] // R.N
    for r in ranks:
        mine = range(r["coords"][1] * rows, (r["coords"][1] + 1) * rows)
        for i, step in enumerate(r["engine"]["steps"]):
            want = R.serve_counts(c, 2, step, mine, ENGINE["n_slots"], ENGINE["prompt_len"], R.N)
            assert {k: step[k] for k in want} == want, (i, step, want)
    return one


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_shard_dims_are_the_reference_s(full):
    """deepseek-v3-671b on (data 2, model 2): every leaf split where the
    reference splits it — MLA's heads, the MLP, the experts, the
    vocabulary, the MTP module's leaves — its latents and norms whole."""
    n_layers = 0 if full else 4  # the reduced model's first MoE layer is its fourth
    cfg = get_config(ARCH).reduced(n_layers=n_layers) if n_layers else get_config(ARCH)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(cfg, mesh)
    assert dims == reference_dims(ARCH, 2, n_layers)
    local = init_shards(cfg, mesh, device="meta")
    paths = dict(zip(local.leaf_paths(), dims))
    for name in ("wq_b", "wk_b", "wv_b", "wo"):
        assert paths[f"stack.0.mixer.{name}"] is not None and \
            paths[f"mtp.0.layer.mixer.{name}"] is not None, name
    for name in ("wq_a", "q_a_norm", "wkv_a", "kv_a_norm", "wk_rope"):
        assert paths[f"stack.0.mixer.{name}"] is None, name
    assert paths["mtp.0.proj"] is None
    assert set(local.shard_blocks) == {1}
    assert {"heads", "experts", "vocab"} <= local.tp.axes


def test_init_shards_are_shard_model_s():
    c = R.cfg()
    full = GCLM(c, device="cpu", seed=3)
    for rank in range(4):
        mesh = meta_mesh(data=2, model=2, rank=rank)
        want = shard_model(full, mesh)
        got = init_shards(c, mesh, device="cpu", seed=3)
        assert got.tp == want.tp and got.shard_dims == want.shard_dims
        assert all(torch.equal(a, b) for a, b in zip(got.leaves(), want.leaves(), strict=True))


def test_each_mlp_splits_by_its_own_width():
    """At d_model 128 the dense MLP (329 wide) stays whole at model 2 while
    the shared expert (36) splits — leaf by leaf the reference's rule; at
    256 the other way round (658 and 73)."""
    mesh = meta_mesh(data=2, model=2)
    for c, dense, shared in ((R.cfg(), None, 1), (get_config(ARCH).reduced(n_layers=4), 2, None)):
        paths = dict(zip(GCLM(c, device="meta").leaf_paths(), shard_dims(c, mesh)))
        assert paths["stack.0.ffn.wi"] == dense
        assert paths["stack.1.ffn.shared.wi"] == shared
        assert "mlp" in init_shards(c, mesh, device="meta").tp.axes


# ------------------------------------------------------------------ the job
def _jax_cfg():
    base = jax_get_config(ARCH).reduced(n_layers=4, d_model=128)
    return base.replace(n_layers=2, layers=(base.layers[0], base.layers[3]))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    return run_job(R.train_rank, R.cfg(), _jax_cfg(), tmp_path_factory.mktemp("tp_mla"))


@pytest.fixture(scope="module")
def one(job):
    return model1(R.cfg(), job[0])


def test_ranks_lie_on_the_mesh_and_hold_their_heads(job):
    blob, ranks, _ = job
    c = R.cfg()
    assert [r["coords"] for r in ranks] == [(0, d, m) for d in range(2) for m in range(2)]
    assert all(r["axes"] == ["experts", "heads", "mlp", "vocab"] for r in ranks)
    assert R.pass_counts(c, 2)["all_gather"] == 1  # the MoE layer's router, case (a)
    shapes = dict(zip(GCLM(c, device="meta").leaf_paths(), ranks[0]["shapes"]))
    assert shapes["stack.0.mixer.wq_b"][1] == c.n_heads // 2
    assert shapes["stack.0.mixer.wkv_a"] == (c.d_model, c.mla.kv_lora_rank)
    check_gathered_tree(blob, ranks)


def test_loss_mtp_and_gradients_match_the_reference_and_model_1(job, one):
    """Every rank's loss, xent, aux and mtp equal (all-reduced), within
    1e-5 of the reference's and of model 1's; the gathered gradients —
    MLA's, the experts', the MTP module's — within 1e-5 of scale."""
    _, ranks, ref = job
    assert ranks[0]["metrics"]["mtp"] > 0
    w_ref, w_m1 = check_gradients(ranks, ref, one)
    print(f"gradients vs the reference {w_ref:.3e}, vs model 1 {w_m1:.3e} of scale")


def test_collectives_per_pass_equal_the_formula(job):
    """One forward and backward: per MLA layer one reduce after ``wo`` and
    three copies (``cq``, ``c_kv``, ``k_r``); the MoE layer's output reduce,
    gates' and input's copies and router gather, its shared expert's
    reduce and copy; the embedding, head and loss; the MTP module's
    embedding, MLA layer (its 329-wide MLP whole), head and loss.  No
    data-side collective."""
    _, ranks, _ = job
    want = dict(psum=0, psum_scatter=0, broadcast=0, all_gather=1, copy=14, reduce=11, max=2)
    assert R.pass_counts(R.cfg(), 2) == {k: want[k] for k in ("reduce", "copy", "all_gather",
                                                               "max")}
    assert all(r["counts"] == want for r in ranks), [r["counts"] for r in ranks]


def test_spmd_coded_gradients_match_sim_mode(job, one):
    blob, ranks, _ = job
    w32, w16 = check_coded(R.cfg(), blob, ranks, one[0])
    print(f"spmd coded vs sim mode {w32:.3e} of scale; bf16 {w16:.3f} of 2^-7 of the "
          "contributions' scale")


def test_spmd_trainer_matches_the_one_process_trainer(job):
    blob, ranks, _ = job
    check_trainer(R.cfg(), blob, ranks)


def test_engine_on_the_mesh_equals_one_rank_with_the_latent_whole(job):
    """The (2, 2) engine's tokens, slots, timestamps and latencies are one
    rank's; a slot serves a second request; each rank's slab holds its 2
    slots and the whole latent; every step's collectives the formula."""
    blob, ranks, _ = job
    c = R.cfg()
    check_engine(c, blob, ranks)
    for r in ranks:
        for seg in r["engine"]["slab"]:
            assert seg["c_kv"][-3:] == (ENGINE["n_slots"] // R.N, ENGINE["max_len"],
                                        c.mla.kv_lora_rank)
            assert seg["k_r"][-3:] == (ENGINE["n_slots"] // R.N, ENGINE["max_len"],
                                       c.mla.qk_rope_head_dim)
