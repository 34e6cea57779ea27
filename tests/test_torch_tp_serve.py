"""Serving on the ``model`` axis of the port (a sharded ``GCLM`` through
``prefill``, ``decode_step``, ``generate``, ``ServeEngine`` and
``launch.serve --data-par/--model-par``) against the JAX reference, on
the CPU.

One 4-rank gloo job on a (data 2, model 2) mesh (its ranks are
``tests/torch_tp_serve_ranks.py``, which imports no JAX) runs while this
process computes the reference's outputs, on the same weights — the
reference's own init carried by ``init_shards(params=)``, Qwen's QKV
biases drawn from a seed (they start at zero):

* per-head caches: a rank's cache holds its share of the KV heads where
  the axis splits them (gc-lm-110m, gemma2/3, qwen1.5) and the one KV
  head whole where it does not (gemma-2b's MQA), on (1, 2) and (2, 2)
  meshes; the slab's slots split over the data ranks by the ``batch``
  rule, as the reference's ``pspec_for_axes`` splits them;
* ``prefill`` (every position gathered over the vocabulary, and the last
  alone) and decode steps from its caches, past a window of 16 for
  gemma2/3 (a rolled ring that then wraps), QK-norm (gemma3) and QKV
  biases (qwen): fp32 logits and each rank's cache heads within 1e-5 of
  scale of the reference's, byte-equal on every rank;
* ``ServeEngine`` on the mesh, fp32 slab, the coded tier: greedy tokens,
  slots, timestamps and step latencies equal the reference's JAX engine;
  at temperature 0.8, the tokens equal the port's one-rank engine; on a
  bf16 slab, teacher-forced decode logits within ``TEACHER_BF16_REL`` of
  the gathered fp32 prefill's (fp32 slab: 1e-5);
* the collectives of every decode step and engine step, with their
  bytes, equal the formula: per layer one all-reduce of the attention's
  output and one of the MLP's (when the axis splits it), one of the
  vocab-parallel embedding, one all-gather of the last position's
  logits, and the engine's one gather of the step's tokens over the data
  ranks;
* xLSTM's and the cross-attention families' shards are drawn, and the
  launcher takes them (they serve on the axis since ROADMAP 6c);
* ``torchrun`` of ``launch.serve --data-par 2 --model-par 2 --stream 8``
  prints the one-rank launcher's lines, once.
"""
import os
import re
import subprocess
import sys
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
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.state import init_train_state
from repro_torch.configs import get_config
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.dist.sharding import batch_rows
from repro_torch.launch import serve as launch_serve
from repro_torch.models.model import init_decode_caches
from repro_torch.models.params import GCLM, init_shards, params_from_numpy, shard_model
from repro_torch.serve import generate, make_slab
from repro_torch.sim import arrivals

from torch_tp_serve_ranks import _engine, serve_rank

pytestmark = pytest.mark.spmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 300.0
REL = 1e-5
TEACHER_BF16_REL = 4e-3
MESH = dict(data=2, model=2)
#: the families on the axis, reduced: gemma2/3 with windows of 16 below
#: the 20-token prompts; qwen at d_model 256 (d_ff 1369: a replicated MLP)
ARCHS = {"gc-lm-110m": dict(n_layers=2, d_model=128),
         "gemma-2b": dict(n_layers=2, d_model=128),
         "gemma2-27b": dict(n_layers=2, d_model=128, seq_cap=32),
         "gemma3-27b": dict(n_layers=6, d_model=128, seq_cap=32),
         "qwen1.5-32b": dict(n_layers=2)}
#: cases that replace fields of a reduced config: 6 query heads over 3 KV
#: heads, which model 2 leaves whole, and a rank's 3 query heads read two
#: of them (heads 0, 1 -> KV 0; 2 -> KV 1 on model rank 0)
REPLACED = {"gc-lm-110m/6q3kv": ("gc-lm-110m", dict(n_heads=6, n_kv_heads=3))}
CASES = {**{a: (a, {}) for a in ARCHS}, **REPLACED}


def _cfg(case: str, port: bool = True):
    arch, fields = CASES[case]
    base = get_config(arch) if port else jax_get_config(arch)
    return base.reduced(**ARCHS[arch]).replace(**fields)
PROMPT, TARGET, FEED = 20, 28, 6
ENGINE = dict(arch="gc-lm-110m", n_slots=4, max_len=24, n_requests=7, rate=4e-3)
NEWS = [4, 9, 6, 12, 3, 7, 10]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(case):
    """The reference's initial weights (numpy), Qwen's QKV biases drawn
    from a seed."""
    state, _ = init_train_state(_cfg(case, port=False), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(5)
    for seg in tree["stack"]:
        for name in ("bq", "bk", "bv"):
            if name in seg["mixer"]:
                bias = seg["mixer"][name]
                seg["mixer"][name] = (0.1 * rng.standard_normal(bias.shape)).astype(np.float32)
    return tree


def _inputs() -> dict:
    rng = np.random.default_rng(11)
    archs = {}
    for case, (arch, fields) in CASES.items():
        vocab = _cfg(case).vocab
        archs[case] = dict(arch=arch, reduced=ARCHS[arch], replace=fields, tree=_tree(case),
                           target_len=TARGET,
                           prompts=rng.integers(0, vocab, (2, PROMPT)).astype(np.int64),
                           feed=rng.integers(0, vocab, (2, FEED)).astype(np.int64))
    vocab = get_config(ENGINE["arch"]).reduced(**ARCHS[ENGINE["arch"]]).vocab
    jenv = JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), 6)
    engine = dict(ENGINE, reduced=ARCHS[ENGINE["arch"]], env=jenv.to_dict(), news=NEWS,
                  prompts=[rng.integers(0, vocab, 8).astype(np.int32) for _ in NEWS],
                  times=arrivals.poisson_arrivals(ENGINE["n_requests"], ENGINE["rate"],
                                                  seed=0),
                  batch=rng.integers(0, vocab, (3, 6)).astype(np.int32),
                  forced=rng.integers(0, vocab, (3, 14)).astype(np.int64), forced_prompt=8)
    return dict(mesh=MESH, archs=archs, engine=engine)


def _reference_case(name, case) -> dict:
    cfg = _cfg(name, port=False)
    params = jax.tree.map(jnp.asarray, case["tree"])
    logits, caches = jmodel.prefill(cfg, params, jnp.asarray(case["prompts"]),
                                    target_len=case["target_len"])
    out = dict(prefill=np.asarray(logits), caches=jax.tree.map(np.asarray, caches))
    steps = []
    for j in range(case["feed"].shape[1]):
        step, caches = jmodel.decode_step(cfg, params, caches,
                                          jnp.asarray(case["feed"][:, j:j + 1]))
        steps.append(np.asarray(step))
    out["decode"] = np.stack(steps)
    out["decoded_caches"] = jax.tree.map(np.asarray, caches)
    return out


def _reference_engine(run, tree) -> dict:
    cfg = jax_get_config(run["arch"]).reduced(**run["reduced"])
    eng = JServeEngine(cfg, jax.tree.map(jnp.asarray, tree),
                       JServeConfig(run["n_slots"], run["max_len"], jnp.float32),
                       coded=JCodedDecode.solve(JEnv.from_dict(run["env"]), budget=4, seed=0))
    reqs = [eng.submit(p, max_new=n, arrival=float(t))
            for p, n, t in zip(run["prompts"], run["news"], run["times"])]
    slots = []
    while eng.step():
        slots.append([(i, r.slot) for i, r in enumerate(reqs) if r.slot is not None])
    return dict(slots=slots, latencies=list(eng.step_latencies), now=eng.now,
                finished=[r.uid - reqs[0].uid for r in eng.finished],
                reqs=[dict(tokens=[int(t) for t in r.tokens], t_admit=r.t_admit,
                           t_first=r.t_first, t_done=r.t_done, n_steps=r.n_steps,
                           state=r.state) for r in reqs])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job, in a thread, while this process computes the
    reference's outputs."""
    d = tmp_path_factory.mktemp("tp_serve")
    blob = _inputs()
    torch.save(blob, d / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(serve_rank, 4, str(d / "inputs.pt"),
                                               store_dir=str(d / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        ref = {arch: _reference_case(arch, case) for arch, case in blob["archs"].items()}
        run_ = blob["engine"]
        ref["engine"] = _reference_engine(run_, blob["archs"][run_["arch"]]["tree"])
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blob, result["ranks"], ref


def _close(got, want, rel, what=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _full_model(arch, tree):
    return params_from_numpy(GCLM(get_config(arch).reduced(**ARCHS[arch]), device="cpu"), tree)


# ------------------------------------------------------------ on meta
@pytest.mark.parametrize("mesh", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", ["gc-lm-110m", "gemma-2b", "gemma3-27b", "qwen1.5-32b",
                                  "gc-lm-110m/6q3kv"])
def test_rank_caches_hold_their_kv_heads(arch, mesh):
    """A rank's caches (and its slab) hold n_kv_heads / model heads where
    the axis splits them and all of them where it does not (gemma-2b's
    one KV head, the 3 of ``REPLACED``); the slab holds the rank's block
    of the slots."""
    cfg = _cfg(arch)
    data, model = mesh
    for rank in range(data * model):
        m = meta_mesh(data=data, model=model, rank=rank)
        tp = shard_model(GCLM(cfg, device="meta"), m).tp
        heads = cfg.n_kv_heads // model if cfg.n_kv_heads % model == 0 else cfg.n_kv_heads
        assert ("kv_heads" in tp.axes) == (cfg.n_kv_heads % model == 0)
        for caches in (init_decode_caches(cfg, 3, 16, tp=tp, device="meta"),
                       make_slab(cfg, len(batch_rows(8, m).rows), 16, tp=tp, device="meta")):
            for seg in caches:
                for tree in seg if isinstance(seg, list) else [seg]:
                    assert tree["k"].shape[-2] == tree["v"].shape[-2] == heads
        assert len(batch_rows(8, m).rows) == 8 // data
        assert caches[0]["k"].shape[-4] == 8 // data


@pytest.mark.parametrize("shape", [(2, 2), (4, 1), (2, 2, 1), (3, 2), (1, 2)])
@pytest.mark.parametrize("n", [8, 6, 3, 1])
def test_batch_rows_follow_the_reference_s_batch_rule(shape, n):
    """The slab's rows split where the reference's ``pspec_for_axes``
    splits a ``batch`` axis of ``n``: equal blocks, pod-major, or whole."""
    names = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    with use_mesh(AbstractMesh(shape, names), ref_rules(None)):
        (want,) = ref_pspec(("batch",), (n,))
    axes = () if want is None else (want,) if isinstance(want, str) else tuple(want)
    kw = dict(zip(names, shape))
    axes = tuple(a for a in axes if kw[a] > 1)  # an axis of one rank splits nothing
    n_ranks = int(np.prod(shape))
    blocks = set()
    for rank in range(n_ranks):
        split = batch_rows(n, meta_mesh(**kw, rank=rank))
        assert split.axes == axes
        blocks.add((split.rows.start, split.rows.stop))
    size = int(np.prod([kw[a] for a in axes]))
    assert sorted(blocks) == [(i * n // size, (i + 1) * n // size) for i in range(size)]
    assert batch_rows(n).rows == range(n) and batch_rows(n).axes == ()


@pytest.mark.parametrize("arch,layers,item", [
    ("xlstm-1.3b", 2, "6c"), ("whisper-base", 2, "6c"), ("llama-3.2-vision-11b", 2, "6c")])
def test_unported_families_raise_naming_their_item(arch, layers, item):
    """xLSTM and cross-attention, which ROADMAP 6c (``item``) put on the
    axis, serve there: their shards are drawn, and the launcher takes the
    family, stopping only at the world, which has one rank where
    ``--model-par 2`` needs two — before any process group exists
    (``tests/test_torch_tp_xlstm_cross_launch.py`` runs it under
    torchrun)."""
    cfg = get_config(arch).reduced(n_layers=layers)
    local = init_shards(cfg, meta_mesh(data=2, model=2), device="cpu")
    assert "heads" in local.tp.axes, item
    with pytest.raises(ValueError, match="needs 2 ranks, the world has 1"):
        launch_serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--model-par", "2"])
    assert not torch.distributed.is_initialized()


# --------------------------------------------------------- the 4-rank job
def test_ranks_lie_on_the_mesh_and_agree(job):
    _, ranks, _ = job
    assert [r["coords"] for r in ranks] == [(0, d, m) for d in range(2) for m in range(2)]
    for arch in CASES:
        assert len({r["archs"][arch]["digest"] for r in ranks}) == 1, arch
    for run in ("greedy", "sampled", "bf16"):
        for key in ("slots", "latencies", "now", "finished", "reqs"):
            assert all(r[run][key] == ranks[0][run][key] for r in ranks), (run, key)
    assert [r["greedy"]["rows"] for r in ranks] == [range(0, 2), range(0, 2), range(2, 4),
                                                    range(2, 4)]


@pytest.mark.parametrize("arch", list(CASES))
def test_sharded_prefill_and_decode_match_reference(job, arch):
    """Gathered fp32 logits of the prefill and of every decode step within
    1e-5 of scale of the reference's; each rank's cache heads within 1e-5
    of its heads of the reference's caches, after the prefill and after
    the last step."""
    _, ranks, ref = job
    cfg = _cfg(arch)
    got, want = ranks[0]["archs"][arch], ref[arch]
    _close(got["prefill"], want["prefill"], REL, f"{arch} prefill")
    _close(got["last"], got["prefill"][:, -1:], REL, f"{arch} last_only")
    _close(got["decode"], want["decode"], REL, f"{arch} decode")
    split = "kv_heads" in got["axes"]
    assert split == (cfg.n_kv_heads % 2 == 0)
    for rank in ranks[:2]:  # model index 0 and 1
        m = rank["coords"][2]
        heads = cfg.n_kv_heads // 2
        cut = slice(m * heads, (m + 1) * heads) if split else slice(None)
        for key in ("caches", "decoded_caches"):
            mine = rank["archs"][arch][key]
            theirs = want[key]
            for seg_m, seg_t in zip(mine, theirs, strict=True):
                pairs = zip(seg_m, seg_t) if isinstance(seg_m, list) else [(seg_m, seg_t)]
                for a, b in pairs:
                    np.testing.assert_array_equal(a["pos"], np.asarray(b["pos"]))
                    for name in ("k", "v"):
                        _close(a[name], np.asarray(b[name], np.float32)[..., cut, :], REL,
                               f"{arch} {key} {name} rank {m}")


@pytest.mark.parametrize("arch", list(CASES))
def test_decode_step_collectives_equal_the_formula(job, arch):
    """Per decode step of B rows: one all-reduce of (B, 1, d) per layer for
    attention, one more per layer where the axis splits the MLP, one for
    the vocab-parallel embedding; one all-gather of the logits, (B, 1, V)
    out; nothing else."""
    _, ranks, _ = job
    cfg = _cfg(arch)
    got = ranks[0]["archs"][arch]
    axes = set(got["axes"])
    b = 2
    n_reduce = cfg.n_layers * (1 + ("mlp" in axes)) + ("vocab" in axes)
    assert "heads" in axes and "vocab" in axes and ("mlp" in axes) == (arch != "qwen1.5-32b")
    for rank in ranks:
        assert rank["archs"][arch]["decode_counts"] == dict(
            all_gather=1, reduce=n_reduce, others=0, all_gather_bytes=b * cfg.vocab * 4,
            reduce_bytes=n_reduce * b * cfg.d_model * 4)


def test_engine_on_a_2x2_mesh_matches_reference(job):
    """Greedy on an fp32 slab: tokens, slots, admissions, timestamps and
    the coded tier's latencies equal the reference's JAX engine; the slab
    of a rank holds its 2 of 4 slots and its KV head."""
    _, ranks, ref = job
    got, want = ranks[0]["greedy"], ref["engine"]
    assert got["slots"] == want["slots"]
    assert len({s for step in got["slots"] for _, s in step}) == ENGINE["n_slots"]
    assert got["finished"] == want["finished"]
    assert got["reqs"] == want["reqs"]
    assert got["latencies"] == want["latencies"] and got["now"] == want["now"]
    cfg = get_config(ENGINE["arch"]).reduced(**ARCHS[ENGINE["arch"]])
    assert got["slab"][0]["k"] == (cfg.n_layers, 2, ENGINE["max_len"], cfg.n_kv_heads // 2,
                                   cfg.head_dim)
    assert got["slab"][0]["pos"] == (cfg.n_layers, 2)


def test_sampled_tokens_equal_the_one_rank_engine(job):
    """At temperature 0.8 (Gumbel noise from each request's seed) and on a
    bf16 slab, greedy, the mesh's engine serves what the port's one-rank
    engine serves on the full weights."""
    blob, ranks, _ = job
    run = blob["engine"]
    model = _full_model(run["arch"], blob["archs"][run["arch"]]["tree"])
    cfg = model.cfg
    one = _engine(cfg, model, None, run, torch.float32, temperature=0.8)
    assert ranks[0]["sampled"]["reqs"] == one["reqs"]
    assert ranks[0]["sampled"]["slots"] == one["slots"]
    bf16 = _engine(cfg, model, None, run, torch.bfloat16)
    assert ranks[0]["bf16"]["reqs"] == bf16["reqs"]
    assert one["steps"][0]["all_gather"] == one["steps"][0]["reduce"] == 0
    np.testing.assert_array_equal(
        ranks[0]["generate"], generate(cfg, model, run["batch"], max_new=5, device="cpu").numpy())


def test_teacher_forced_bf16_slab_on_the_mesh(job):
    """Decode logits on the ranks' bf16 slab, fed each row's tokens,
    against the gathered fp32 prefill of the same tokens at each position
    (``TEACHER_BF16_REL`` of the largest logit; fp32 slab: 1e-5)."""
    blob, ranks, _ = job
    s = blob["engine"]["forced_prompt"]
    got = ranks[0]
    at = got["forced_prefill"][:, s:s + got["forced_bf16"].shape[0]].transpose(1, 0, 2)
    _close(got["forced_bf16"], at, TEACHER_BF16_REL, "bf16 slab vs fp32 prefill")
    _close(got["forced_fp32"], at, REL, "fp32 slab vs fp32 prefill")
    assert all(np.array_equal(r["forced_bf16"], got["forced_bf16"]) for r in ranks)


def test_engine_collectives_per_step_equal_the_formula(job):
    """Every engine step on (data 2, model 2), per rank: its decode step
    (the formula of a decode step at 2 local rows) and one gather of the
    step's tokens over the data ranks (4 slots × 8 bytes, twice that when
    it admitted); per admission into the rank's slots, its prefill's
    all-reduces of (1, 8, d) and one all-gather of the last position's
    logits (1, 1, V)."""
    blob, ranks, _ = job
    cfg = get_config(ENGINE["arch"]).reduced(**ARCHS[ENGINE["arch"]])
    n_reduce, d, v = 2 * cfg.n_layers + 1, cfg.d_model, cfg.vocab
    prompt = len(blob["engine"]["prompts"][0])
    for rank in ranks:
        run = rank["greedy"]
        for i, step in enumerate(run["steps"]):
            mine = len([s for s in step["admitted"] if s in run["rows"]])
            decoded = step["decoded"]
            cols = bool(step["admitted"]) + decoded
            want = dict(all_gather=decoded + mine + (cols > 0), others=0,
                        reduce=n_reduce * (decoded + mine),
                        all_gather_bytes=decoded * 2 * v * 4 + mine * v * 4
                        + ENGINE["n_slots"] * cols * 8,
                        reduce_bytes=n_reduce * d * 4 * (decoded * 2 + mine * prompt))
            assert {k: step[k] for k in want} == want, (i, step)
        assert sum(bool(step["admitted"]) for step in run["steps"]) > 1
        assert sum(step["decoded"] for step in run["steps"]) == len(run["latencies"])


def test_launcher_data_and_model_par_under_torchrun_prints_once(capsys):
    """Four ranks (data 2 × model 2) print the one-rank launcher's lines,
    once: the coded tier, the requests and tokens served, the simulated
    time and steps, the step and request latencies."""
    argv = ["--reduced", "--device", "cpu", "--stream", "8"]
    launch_serve.main(argv)
    one = capsys.readouterr().out.strip().splitlines()
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.serve", *argv, "--data-par", "2", "--model-par", "2"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=LIMIT)
    assert res.returncode == 0, res.stderr[-4000:]
    four = res.stdout.strip().splitlines()
    wall = re.compile(r" in [0-9.]+s wall \([0-9.]+ tok/s\)")
    assert len(four) == len(one) == 4
    assert [wall.sub("", ln) for ln in four] == [wall.sub("", ln) for ln in one]
    assert one[1].startswith("served 8 requests / ")
