"""Cross-attention, Whisper's encoder and the vision projector on the port's
``model`` axis (``models/attention.py::cross_attention``,
``models/model.py::run_encoder`` and ``source_embeds`` with a
``ModelSplit``) in training and serving, against the JAX reference, on
the CPU.  Every cross ``gate`` is opened from a seed (at the init, 0,
tanh closes the source off: ROADMAP 3.21).

* The split: ``shard_dims`` of whisper-base and llama-3.2-vision-11b
  equals the reference's ``pspec_for_axes`` on every leaf, reduced and
  at full width: the cross projections and the encoder's (its QKV biases
  too) on their heads, the scalar gates, layer norms and ``vision_proj``
  whole; full-width Whisper's 51,865-row vocabulary whole.
* One 4-rank gloo job on (data 2, model 2) (ranks:
  ``tests/torch_tp_cross_ranks.py``, which imports no JAX) of reduced
  Whisper (2 + 2 layers, d_model 128, vocabulary 512: split), the same
  with a vocabulary of 511 (whole: the branch full width takes) and
  reduced vision (5 layers, the cross mixer at index 3), each with its
  stubbed modality embeddings, while this process computes the
  reference's ``train_loss`` gradients on the same weights:
  - the shards gathered back are the reference's tree byte for byte;
  - the loss within 1e-5 of the reference's and of the port's model 1,
    the gathered gradients within 1e-5 of scale of both, leaf by leaf —
    the encoder's ``bk``, zero in exact arithmetic (no RoPE), held at the
    bound times its layer's ``bq`` (``tests/test_torch_whisper.py``);
  - the collectives per pass equal the formula (``pass_counts``): per
    cross-attention one reduce and one copy, per encoder layer two of
    each, one copy of the source a pass, and no vocabulary term where
    the vocabulary stays whole;
  - the flat spmd coded gradient with ``worker_aux`` at every straggler
    count within 1e-5 of the port's sim mode, bf16 ``grad_dtype`` within
    2^-7 of the contributions' scale;
  - two spmd ``make_coded_train_step`` steps with ``worker_aux``
    (``Trainer.step_fn``) equal to the one-process trainer's: metrics
    1e-5, parameters 2e-5, each step's collectives the formula;
  - ``generate(aux_inputs=)`` on the mesh (every row on every rank) gives
    the JAX ``generate``'s greedy tokens, each of its forwards the
    formula's collectives.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import model as jmodel
from repro.serve.engine import generate as jax_generate
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.configs import get_config
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.model import train_loss
from repro_torch.models.params import GCLM, init_shards, params_from_numpy, shard_dims
from repro_torch.train.coded import make_coded_grad_fn, per_shard_grad_rows

import torch_tp_cross_ranks as C
import torch_tp_mla_ranks as R
import torch_tp_xlstm_ranks as X
from test_torch_tp_mla import (BF16_ABS, BF16_REL, LIMIT, PARAM_ATOL, REL, check_gathered_tree,
                               dec_ws, reference_dims, worst)

pytestmark = pytest.mark.spmd

ARCHS = ("whisper-base", "llama-3.2-vision-11b")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def scales(paths, want) -> list:
    """Each leaf's scale, max |want|; an encoder ``bk``'s (zero in exact
    arithmetic) is its layer's ``bq``'s."""
    by_path = dict(zip(paths, want, strict=True))
    return [float(np.abs(np.asarray(
        by_path[p[:-1] + "q" if p.startswith("encoder.") and p.endswith(".bk") else p],
        np.float32)).max()) for p in paths]


def _paths(c):
    return GCLM(c, device="meta").leaf_paths()


def open_gates(tree, seed=0):
    """The tree with every ``gate`` leaf drawn from U(0.3, 0.9)."""
    rng = np.random.default_rng(seed)

    def walk(node):
        if isinstance(node, dict):
            return {k: (rng.uniform(0.3, 0.9, np.shape(v)).astype(np.float32) if k == "gate"
                        else walk(v)) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return node

    return walk(tree)


# ------------------------------------------------------------------ the split
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_shard_dims_are_the_reference_s(arch, full):
    """Every leaf split where the reference splits it on (data 2, model 2);
    the cross projections on their heads, the gates whole; Whisper's
    encoder layers on their heads and MLP columns, its norms whole;
    ``vision_proj`` whole; full-width Whisper's vocabulary (51,865 rows)
    whole, the reduced one (512) split."""
    n_layers = 0 if full else (2 if arch == "whisper-base" else 5)
    cfg = get_config(arch).reduced(n_layers=n_layers) if n_layers else get_config(arch)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(cfg, mesh)
    assert dims == reference_dims(arch, 2, n_layers)
    local = init_shards(cfg, mesh, device="meta")
    by_path = dict(zip(local.leaf_paths(), dims))
    gates = [p for p in by_path if p.endswith(".gate")]
    assert gates
    for path in gates:  # every cross-attention node: its gate whole, its projections split
        assert by_path[path] is None, path
        for leaf in ("wq", "wk", "wv", "wo"):
            assert by_path[path[:-4] + leaf] is not None, path
    for path in by_path:
        leaf = path.rsplit(".", 1)[-1]
        if path.startswith("encoder.layers.") and \
                leaf in ("bq", "bk", "bv", "wq", "wk", "wv", "wo", "wi"):
            assert by_path[path] is not None, path
    if arch == "llama-3.2-vision-11b":
        assert by_path["vision_proj"] is None
    vocab_split = not (full and arch == "whisper-base")
    assert (by_path["embed.tok"] is not None) == vocab_split
    assert ("vocab" in local.tp.axes) == vocab_split
    assert set(local.shard_blocks) == {1}


# ------------------------------------------------------------------ the job
def _jax_cfg(name):
    arch, n_layers, fields = C.CASES[name]
    return jax_get_config(arch).reduced(n_layers=n_layers, d_model=128,
                                        seq_cap=64).replace(**fields)


def _inputs(name) -> dict:
    """The reference's weights (gates open), the plan, decode weights at
    every straggler count, the workers' batches and ``worker_aux`` of
    each trainer step, one batch with its aux rows, and generate's
    prompts and aux rows."""
    c, jc = C.cfg(name), _jax_cfg(name)
    state, _ = jax_init_train_state(jc, jax.random.PRNGKey(0))
    tree = open_gates(jax.tree.map(np.asarray, state.params))
    plan = Plan.build(GCLM(c, device="meta"), ShiftedExponential(**R.SE), R.N, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=R.SEQ, global_batch=8))
    k, rows = plan.k_shards, 8 // R.N
    g = C.GENERATE
    return dict(tree=tree, plan=plan, dec_w=dec_ws(plan),
                wb=coded_worker_batches(data, 0, R.N, plan.s_max),
                wa=[C.worker_aux(c, i, R.N, k, rows) for i in range(C.TRAIN_STEPS)],
                batch=SyntheticTokens(DataConfig(vocab=c.vocab, seq_len=R.SEQ,
                                                 global_batch=2)).batch(0),
                batch_aux=C.aux_rows(c, 2, 7),
                prompts=np.random.default_rng(5).integers(
                    0, c.vocab, (g["batch"], g["prompt_len"])).astype(np.int32),
                gen_aux=C.aux_rows(c, g["batch"], 6))


def _reference(name, blob) -> dict:
    jc = _jax_cfg(name)
    params = jax.tree.map(jnp.asarray, blob["tree"])
    batch = {"tokens": jnp.asarray(blob["batch"]), "aux_inputs": jnp.asarray(blob["batch_aux"])}
    (_, metrics), grads = jax.value_and_grad(
        lambda p: jmodel.train_loss(jc, p, batch), has_aux=True)(params)
    tokens = jax_generate(jc, params, jnp.asarray(blob["prompts"]), C.GENERATE["max_new"],
                          aux_inputs=jnp.asarray(blob["gen_aux"]))
    return dict(metrics={k: float(v) for k, v in metrics.items()},
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                tokens=np.asarray(tokens))


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job over every case in a thread, while this
    process computes the reference's gradients and tokens."""
    tmp = tmp_path_factory.mktemp("tp_cross")
    blobs = {name: _inputs(name) for name in C.CASES}
    torch.save({n: {k: v for k, v in b.items() if k != "plan"} for n, b in blobs.items()},
               tmp / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(C.train_rank, 4, str(tmp / "inputs.pt"),
                                               store_dir=str(tmp / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        refs = {name: _reference(name, blobs[name]) for name in C.CASES}
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blobs, result["ranks"], refs


@pytest.fixture(scope="module")
def ones(job):
    """The port's one-process model of each case on the reference's
    weights, its metrics and gradients on the batch."""
    out = {}
    for name, blob in job[0].items():
        c = C.cfg(name)
        model = params_from_numpy(GCLM(c, device="cpu"), blob["tree"])
        loss, metrics = train_loss(c, model, {"tokens": blob["batch"],
                                              "aux_inputs": blob["batch_aux"]})
        grads = torch.autograd.grad(loss, model.leaves())
        out[name] = (model, {k: float(v.detach()) for k, v in metrics.items()},
                     [g.numpy() for g in grads])
    return out


@pytest.mark.parametrize("name", list(C.CASES))
def test_ranks_hold_their_heads_and_gather_the_reference_s_tree(job, name):
    blobs, ranks, _ = job
    c = C.cfg(name)
    mine = [r[name] for r in ranks]
    assert [r["coords"] for r in mine] == [(0, d, m) for d in range(2) for m in range(2)]
    axes = {"heads", "kv_heads", "mlp"} | ({"vocab"} if c.vocab % 2 == 0 else set())
    assert all(r["axes"] == sorted(axes) for r in mine)
    shapes = dict(zip(_paths(c), mine[0]["shapes"]))
    assert shapes["embed.tok"][0] == (c.vocab // 2 if c.vocab % 2 == 0 else c.vocab)
    if c.encoder is not None:
        assert shapes["stack.0.cross.wq"][-2] == c.n_heads // 2  # a run of 2: stacked
        assert shapes["encoder.layers.0.mixer.bq"][0] == c.n_heads // 2
    else:
        assert shapes["stack.1.mixer.wk"][1] == c.n_kv_heads // 2  # the cross mixer
        assert shapes["vision_proj"] == (c.vision.d_vision, c.d_model)
    check_gathered_tree(blobs[name], mine)


@pytest.mark.parametrize("name", list(C.CASES))
def test_loss_and_gradients_match_the_reference_and_model_1(job, ones, name):
    _, ranks, refs = job
    _, metrics, grads = ones[name]
    ref, got = refs[name], ranks[0][name]
    paths = _paths(C.cfg(name))
    assert all(r[name]["metrics"] == got["metrics"] for r in ranks)
    assert got["metrics"].keys() == ref["metrics"].keys() == metrics.keys()
    for k, want in ref["metrics"].items():
        assert abs(got["metrics"][k] - want) <= REL * abs(want), (k, got["metrics"][k], want)
        assert abs(got["metrics"][k] - metrics[k]) <= REL * abs(metrics[k]), k
    w_ref = worst(got["grads"], ref["grads"], REL, scales(paths, ref["grads"]))
    w_m1 = worst(got["grads"], grads, REL, scales(paths, grads))
    print(f"{name}: gradients vs the reference {w_ref * REL:.3e}, vs model 1 {w_m1 * REL:.3e} "
          "of scale")
    assert w_ref <= 1 and w_m1 <= 1, (w_ref, w_m1)


@pytest.mark.parametrize("name", list(C.CASES))
def test_collectives_per_pass_equal_the_formula(job, name):
    """One forward and backward.  Whisper: 2 encoder layers of 2 reduces
    and 2 copies, 2 decoder layers of 3 and 3 (attention, the cross
    sublayer, the MLP), the source's copy, and where the vocabulary
    splits the embedding's reduce, the loss's two and its max, the
    head's copy.  Vision: 4 attention and 1 cross mixer layers of 2 and 2
    (with the MLP), the source's copy, the vocabulary's terms."""
    _, ranks, _ = job
    want = {"whisper": dict(reduce=13, copy=12, max=1), "whisper511": dict(reduce=10, copy=11,
                                                                         max=0),
            "vision": dict(reduce=13, copy=12, max=1)}[name]
    want = dict(psum=0, psum_scatter=0, broadcast=0, all_gather=0, **want)
    assert X.pass_counts(C.cfg(name), 2) == {k: want[k] for k in (
        "reduce", "copy", "all_gather", "max", "psum_scatter")}
    assert all(r[name]["counts"] == want for r in ranks), [r[name]["counts"] for r in ranks]


@pytest.mark.parametrize("name", list(C.CASES))
def test_spmd_coded_gradients_match_sim_mode(job, ones, name):
    """The flat spmd coded gradient with ``worker_aux``, gathered, against
    the port's sim mode on the full weights: fp32 within 1e-5 of scale at
    every straggler count, bf16 within 2^-7 of the contributions' scale
    (an encoder ``bk``'s at its ``bq``'s); one grouped combine per call;
    the data ranks of a model index byte-equal."""
    blobs, ranks, _ = job
    c, blob, model = C.cfg(name), blobs[name], ones[name][0]
    plan, paths = blob["plan"], _paths(c)
    rows = per_shard_grad_rows(c, model, blob["wb"], blob["wa"][0])
    sim = make_coded_grad_fn(c, plan, mode="sim", pipeline="flat")
    got = ranks[0][name]["coded"]
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
            contrib = scales(paths, [np.asarray([x]) for x in contrib])
            bf16 = got["bf16", 0]["full"]
            w16 = worst(bf16, want, BF16_REL, contrib)
            abs16 = max(float(np.abs(a - b).max()) for a, b in zip(bf16, want))
            assert w16 <= 1 and abs16 <= BF16_ABS, (w16, abs16)
    for key in got:
        for r in ranks:
            assert r[name]["coded"][key]["grouped"] == [len(paths)], key
        for m in range(2):
            assert ranks[m][name]["coded"][key]["digest"] == \
                ranks[m + 2][name]["coded"][key]["digest"], key
    print(f"{name}: spmd coded vs sim mode {w32 * REL:.3e} of scale; bf16 {w16:.3f} of 2^-7 of "
          "the contributions' scale")


@pytest.mark.parametrize("name", list(C.CASES))
def test_spmd_train_steps_with_worker_aux_match_one_process(job, name):
    """``TRAIN_STEPS`` spmd ``make_coded_train_step`` steps with
    ``worker_aux`` against the one-process trainer's on the same draws:
    metrics 1e-5, the gathered parameters 2e-5 (AdamW's normalized step),
    the data ranks of a model index byte-equal, each step's collectives
    the formula (``step_counts``: its passes and the monitoring forward;
    the draws are this loop's, so no broadcast checks them), one grouped
    combine a step."""
    blobs, ranks, _ = job
    c, blob = C.cfg(name), blobs[name]
    tr = C.make_trainer(c, blob)
    hist = C.train_steps(tr, blob)
    got = [r[name]["trainer"] for r in ranks]
    for a, b in zip(got[0]["history"], hist, strict=True):
        for key in ("loss", "xent", "grad_norm"):
            assert abs(a[key] - b[key]) <= REL * abs(b[key]), (key, a[key], b[key])
    assert all(g["history"] == got[0]["history"] for g in got)
    for path, a, b in zip(_paths(c), got[0]["params"], tr.state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=PARAM_ATOL, err_msg=path)
    for m in range(2):
        assert got[m]["digests"] == got[m + 2]["digests"]
    assert got[0]["digests"] != got[1]["digests"]
    want = dict(X.step_counts(c, 2, got[0]["k_shards"], got[0]["n_levels"]), broadcast=0)
    for g in got:
        assert g["grouped"] == [1] * C.TRAIN_STEPS
        assert g["counts"] == [want] * C.TRAIN_STEPS, (g["counts"], want)


@pytest.mark.parametrize("name", list(C.CASES))
def test_generate_on_the_mesh_equals_the_reference(job, name):
    """``generate(aux_inputs=)`` on the mesh, fp32, greedy: every rank's
    tokens are the JAX ``generate``'s (2 prompts of 8 tokens + 6 new);
    every rank's collectives the formula (``serve_counts``): the encoder
    or projector, the layers and the logits' gather once per forward."""
    blobs, ranks, refs = job
    c = C.cfg(name)
    for r in ranks:
        got = r[name]["generate"]
        np.testing.assert_array_equal(got["tokens"], refs[name]["tokens"])
        want = C.serve_counts(c, 2, C.GENERATE["max_new"])
        assert {k: got["counts"][k] for k in want} == want, (got["counts"], want)
        assert got["counts"]["psum"] == got["counts"]["broadcast"] == 0
