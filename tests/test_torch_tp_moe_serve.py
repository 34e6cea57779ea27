"""Serving a mixture-of-experts model on the port's ``model`` axis with
data-parallel slots (``ServeEngine`` on a sharded ``mixtral-8x22b``)
against the JAX reference and the port's one-rank engine, on the CPU.

One 4-rank gloo job on (data 2, model 2) (ranks:
``tests/torch_tp_moe_ranks.py``, which imports no JAX) serves 30
requests over 24 slots of ``mixtral-8x22b.reduced()`` at the published
capacity factor 1.25, greedy on an fp32 slab, in case (b) (each
expert's FFN width split), case (a) (the experts split) and case (b)
with ``moe_impl="manual"``, while this process runs the port's one-rank
engine and the reference's JAX engine on the same weights:

* tokens, slots, timestamps and step latencies of (a) and (b) equal the
  one-rank engine's and the JAX engine's;
* a rank holds 12 of the 24 slots: counted over its own 12 rows, the
  capacity (8) would drop assignments that the count over every rank's
  24 rows (capacity 16) keeps — the reference's ``gspmd`` count, which
  the engine takes by one all-gather of each row's expert ids per MoE
  layer; ``moe_impl="manual"`` counts a rank's own rows, as the
  reference's ``_apply_moe_manual`` does, and gathers none;
* the collectives of every engine step equal the formula.
"""
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.core import Env as JEnv
from repro.core import ShiftedExponential as JShiftedExp
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.train.state import init_train_state as jax_init_train_state
from repro_torch.dist import spawn as dist_spawn
from repro_torch.models import moe
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.sim import arrivals

import torch_tp_moe_ranks as R
from torch_tp_serve_ranks import _engine

pytestmark = pytest.mark.spmd

LIMIT = 300.0
ENGINE = dict(n_slots=24, max_len=24, n_requests=30, prompt_len=8, rate=1.0,
              capacity_factor=1.25)
ROWS = ENGINE["n_slots"] // R.N  # a data rank's slots


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax_cfg():
    import dataclasses

    base = jax_get_config("mixtral-8x22b").reduced()
    return base.replace(layers=tuple(dataclasses.replace(
        l, moe=dataclasses.replace(l.moe, capacity_factor=ENGINE["capacity_factor"]))
        for l in base.layers))


def _inputs() -> dict:
    state, _ = jax_init_train_state(_jax_cfg(), jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, state.params)
    rng = np.random.default_rng(3)
    vocab = R.cfg("b", 1.25).vocab
    news = rng.integers(3, ENGINE["max_len"] - ENGINE["prompt_len"] + 1,
                        ENGINE["n_requests"]).tolist()
    run = dict(ENGINE, env=JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), 6).to_dict(), news=news,
               prompts=[rng.integers(0, vocab, ENGINE["prompt_len"]).astype(np.int32)
                        for _ in news],
               times=arrivals.poisson_arrivals(ENGINE["n_requests"], ENGINE["rate"], seed=0))
    return dict(tree=tree, engine=run)


def _reference_engine(run, tree) -> dict:
    eng = JServeEngine(_jax_cfg(), jax.tree.map(jnp.asarray, tree),
                       JServeConfig(run["n_slots"], run["max_len"], jnp.float32),
                       coded=JCodedDecode.solve(JEnv.from_dict(run["env"]), budget=4, seed=0))
    reqs = [eng.submit(p, max_new=n, arrival=float(t))
            for p, n, t in zip(run["prompts"], run["news"], run["times"])]
    slots = []
    while eng.step():
        slots.append([(i, r.slot) for i, r in enumerate(reqs) if r.slot is not None])
    return dict(slots=slots, latencies=list(eng.step_latencies), now=eng.now,
                reqs=[dict(tokens=[int(t) for t in r.tokens], t_admit=r.t_admit,
                           t_first=r.t_first, t_done=r.t_done, n_steps=r.n_steps,
                           state=r.state) for r in reqs])


@pytest.fixture(scope="module")
def job(tmp_path_factory):
    """The port's 4-rank job in a thread, while this process runs the
    one-rank engine and the reference's."""
    d = tmp_path_factory.mktemp("tp_moe_serve")
    blob = _inputs()
    torch.save(blob, d / "inputs.pt")
    result = {}

    def run():
        try:
            result["ranks"] = dist_spawn.spawn(R.serve_rank, 4, str(d / "inputs.pt"),
                                               store_dir=str(d / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # re-raised in the test's thread
            result["error"] = exc

    thread = threading.Thread(target=run)
    thread.start()
    try:
        run_ = blob["engine"]
        c = R.cfg("b", run_["capacity_factor"])
        model = params_from_numpy(GCLM(c, device="cpu"), blob["tree"])
        one = _engine(c, model, None, run_, torch.float32)
        ref = _reference_engine(run_, blob["tree"])
    finally:
        thread.join()
    if "error" in result:
        raise result["error"]
    return blob, result["ranks"], one, ref


RUNS = ["b", "a"]


@pytest.mark.parametrize("name", RUNS)
def test_engine_equals_the_one_rank_engine_and_the_reference(job, name):
    _, ranks, one, ref = job
    for r in ranks:
        got = r[name]
        for key in ("slots", "latencies", "now", "reqs"):
            assert got[key] == one[key], (name, key)
    assert one["reqs"] == ref["reqs"] and one["slots"] == ref["slots"]
    assert one["latencies"] == ref["latencies"] and one["now"] == ref["now"]
    assert all(q["state"] == ranks[0][name]["reqs"][0]["state"] for q in one["reqs"])
    assert len({s for step in one["slots"] for _, s in step}) == ENGINE["n_slots"]
    assert len({(i, s) for step in one["slots"] for i, s in step}) == ENGINE["n_requests"]


def _positions(ids, cap: int):
    """Each assignment's position in its expert over the stream ``ids``
    (token-major), and whether it is inside ``cap``."""
    pos = np.zeros_like(ids)
    seen = {}
    for j, e in enumerate(ids):
        pos[j] = seen.get(int(e), 0)
        seen[int(e)] = pos[j] + 1
    return pos < cap


@pytest.mark.parametrize("name", RUNS)
def test_global_capacity_keeps_what_a_rank_s_count_would_drop(job, name):
    """On every decode step each rank holds its 12 rows and every rank's
    24 rows' expert ids (its own at its block), and keeps its assignments
    by the count over all 24 (capacity 16); counted over its own 12
    (capacity 8) some would drop that the global count keeps."""
    _, ranks, _, _ = job
    spec = R.cfg("b", 1.25).layers[0].moe
    k = spec.top_k
    cap_global, cap_local = moe.capacity(ENGINE["n_slots"], spec), moe.capacity(ROWS, spec)
    assert (cap_local, cap_global) == (8, 16)
    rescued, calls = 0, 0
    for r in ranks:
        decode = [(every, first, n) for every, first, n in r[name]["ids"] if n == ROWS * k]
        assert decode and all(every.size == ENGINE["n_slots"] * k and
                              first == (r["coords"][1] * ROWS * k) for every, first, n in decode)
        for every, first, n in decode:
            kept = _positions(every, cap_global)[first:first + n]
            alone = _positions(every[first:first + n], cap_local)
            rescued += int(np.sum(kept & ~alone))
            calls += 1
    assert rescued > 0, f"{name}: no assignment of {calls} decode calls depends on the count"
    print(f"[{name}] {rescued} assignments in {calls} rank decode calls kept by the global "
          "count that a rank's own count would drop")


def test_manual_moe_counts_a_rank_s_own_rows(job):
    """``moe_impl="manual"``: each decode call's ids are the rank's own
    (no gather), and the engine's steps make one all-gather per MoE layer
    fewer than the gspmd count's."""
    _, ranks, _, _ = job
    layers = R.cfg("b", 1.25).n_layers
    for r in ranks:
        assert all(every.size == n and first == 0 for every, first, n in r["manual"]["ids"])
        for ours, gspmd in zip(r["manual"]["steps"], r["b"]["steps"]):
            if ours["decoded"] and gspmd["decoded"]:
                assert gspmd["all_gather"] - ours["all_gather"] == layers


@pytest.mark.parametrize("name", RUNS)
def test_engine_collectives_per_step_equal_the_formula(job, name):
    """Per engine step and rank: its decode step of 12 rows — per layer
    one all-reduce of (12, 1, d) for attention and one for the MoE output,
    one all-gather of every rank's (24, k) int64 expert ids, and in case
    (a) one all-gather of the router's logits, (12, E) fp32 out; one
    all-reduce of the embedding, one all-gather of the logits — then the
    step's one gather of its tokens over the data ranks; per admission
    into its slots, its prefill: the same all-reduces over the prompt's
    8 tokens, the router gathers of (8, E), no gather of ids (one call's
    rows), and one all-gather of the last position's logits."""
    blob, ranks, _, _ = job
    c = R.cfg(name, 1.25)
    e, k, d, v = c.layers[0].moe.num_experts, c.layers[0].moe.top_k, c.d_model, c.vocab
    layers, n_reduce = c.n_layers, 2 * c.n_layers + 1
    router = layers if name == "a" else 0
    p = ENGINE["prompt_len"]
    for r in ranks:
        rows = range(r["coords"][1] * ROWS, (r["coords"][1] + 1) * ROWS)
        steps = r[name]["steps"]
        for i, step in enumerate(steps):
            mine = len([s for s in step["admitted"] if s in rows])
            decoded = step["decoded"]
            cols = bool(step["admitted"]) + decoded
            want = dict(
                reduce=n_reduce * (decoded + mine), others=0,
                all_gather=decoded * (1 + layers + router) + mine * (1 + router) + (cols > 0),
                reduce_bytes=n_reduce * d * 4 * (decoded * ROWS + mine * p),
                all_gather_bytes=decoded * (ROWS * v * 4 + layers * ENGINE["n_slots"] * k * 8
                                            + router * ROWS * e * 4)
                + mine * (v * 4 + router * p * e * 4) + ENGINE["n_slots"] * cols * 8)
            assert {key: step[key] for key in want} == want, (name, i, step)
        assert sum(step["decoded"] for step in steps) == len(r[name]["latencies"])
