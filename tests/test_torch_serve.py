"""The port's serving path against the JAX reference, on the CPU.

Bit-identical (numpy copies): ``Env.subset``, ``order_stat_quantile``
and the quadrature order statistics; the arrival streams; the
scheduler's admissions; ``solve_replication`` (JSON of ``to_dict``) and
the coded tier's latency stream.

Close (the model): gc-lm-110m reduced to 2 layers and d_model 128, with
the reference's initialized weights carried across (``params_from_numpy``)
and caches carried by ``caches_from_numpy``:

* fp32 — prefill logits and K/V, decode-step logits and caches — agree
  to 1e-5 of each tensor's largest entry: the same fp32 math with sums
  in another order (tests/test_torch_model.py);
* bf16 caches: the reference rounds its fp32 K/V into bf16 and so does
  the port; at these inputs the two packages' bf16 caches are bit-equal
  and the decode logits differ as fp32 ones do (measured: at most 6.4e-7
  of the largest logit), so ``BF16_REL`` is the fp32 bound, 1e-5;
* teacher forcing on a bf16 slab against fp32 prefill logits of the
  same tokens differs by the bf16 rounding of every cached K/V:
  ``TEACHER_BF16_REL`` = 4e-3 of the largest logit (measured: 1.54e-3);
* one whole engine run with an fp32 slab, greedy: tokens, admission
  slots and simulated timestamps are equal, and ``step_latencies`` too.

Within torch: batch-composition independence at temperature > 0, slot
recycling, ``max_new=1``, the capacity check, ``restore_plan`` and the
launcher.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.configs.base import LayerSpec as JLayerSpec
from repro.core import DegradedWorker as JDegraded
from repro.core import Env as JEnv
from repro.core import ScaledStraggler as JScaled
from repro.core import ShiftedExponential as JShiftedExp
from repro.core.env import WorkerDeath as JDeath
from repro.models import attention as jattn
from repro.models import model as jmodel
from repro.serve import CodedDecode as JCodedDecode
from repro.serve import ServeConfig as JServeConfig
from repro.serve import ServeEngine as JServeEngine
from repro.serve import insert_request as j_insert_request
from repro.serve import make_slab as j_make_slab
from repro.serve import solve_replication as j_solve_replication
from repro.serve.request import Request as JRequest
from repro.serve.scheduler import Scheduler as JScheduler
from repro.sim import arrivals as jarrivals
from repro.train.state import init_train_state
from repro_torch.checkpoint.ckpt import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import LayerSpec
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.launch import serve as launch_serve
from repro_torch.models import attention
from repro_torch.models.model import decode_step, init_decode_caches, prefill
from repro_torch.models.params import GCLM, params_from_numpy
from repro_torch.serve import (CodedDecode, ServeConfig, ServeEngine, caches_from_numpy,
                               caches_to_numpy, generate, insert_request, make_slab,
                               restore_plan, solve_replication)
from repro_torch.serve.request import Request
from repro_torch.serve.scheduler import Scheduler
from repro_torch.sim import arrivals

KW = dict(n_layers=2, d_model=128)
REL = 1e-5
BF16_REL = 1e-5
TEACHER_BF16_REL = 4e-3
CPU = dict(device="cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the engine runs many small steps, and torch's
    thread pool otherwise spins on cores that other test processes share."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _json(blob):
    return json.dumps(blob, sort_keys=True)


def _close(got, want, rel, what=""):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, f"{what}: max err {err:.3e} vs scale {scale:.3e}"


def _f32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


# ------------------------------------------------------------ numpy layer
def _envs():
    """(name, reference env): i.i.d., and heterogeneous with faults."""
    fast = JShiftedExp(mu=1e-3, t0=50.0)
    het = JEnv.heterogeneous([fast] * 3 + [JScaled(base=fast, factor=2.5)] * 2
                             + [JShiftedExp(mu=2e-3, t0=80.0)]).with_faults(
        JDegraded(1, 3.0), JDegraded(5, 2.0, from_round=4), JDeath(4, at_round=5))
    return [("iid", JEnv.iid(fast, 8)), ("hetero", het)]


def _port_env(jenv):
    return Env.from_dict(json.loads(_json(jenv.to_dict())))


def test_env_subset_matches_reference_with_faults_reindexed():
    _, jenv = _envs()[1]
    env = _port_env(jenv)
    for workers in ((0,), (4, 1, 5), (5, 4, 3, 2, 1, 0), (2, 3)):
        assert _json(env.subset(workers).to_dict()) == _json(jenv.subset(workers).to_dict())
    sub = env.subset((4, 1))
    assert [f.worker for f in sub.faults] == [1, 0]  # 1 -> 1, 4 -> 0
    with pytest.raises(ValueError):
        env.subset(())
    with pytest.raises(ValueError):
        env.subset((6,))


@pytest.mark.parametrize("name,jenv", _envs(), ids=["iid", "hetero"])
def test_order_stat_quantile_matches_reference(name, jenv):
    env = _port_env(jenv)
    for k in range(1, env.n_workers + 1):
        for q in (0.5, 0.9, 0.99):
            assert env.order_stat_quantile(k, q) == jenv.order_stat_quantile(k, q), (k, q)
    with pytest.raises(ValueError):
        env.order_stat_quantile(0, 0.5)
    with pytest.raises(ValueError):
        env.order_stat_quantile(1, 1.0)


def test_quadrature_order_stats_match_reference():
    _, jenv = _envs()[1]
    env = _port_env(jenv)
    for fn in ("expected_order_stats", "inv_expected_inv_order_stats"):
        np.testing.assert_array_equal(getattr(env, fn)(method="quad"),
                                      getattr(jenv, fn)(method="quad"))
    # Monte-Carlo stays the default
    np.testing.assert_array_equal(env.subset((0, 3)).expected_order_stats(),
                                  jenv.subset((0, 3)).expected_order_stats())


def test_arrival_streams_match_reference():
    for n, rate, seed, start in ((0, 1.0, 0, 0.0), (50, 2e-3, 0, 0.0), (17, 0.5, 9, 3.5)):
        np.testing.assert_array_equal(
            arrivals.poisson_arrivals(n, rate, seed=seed, start=start),
            jarrivals.poisson_arrivals(n, rate, seed=seed, start=start))
    rng, jrng = np.random.default_rng(4), np.random.default_rng(4)
    np.testing.assert_array_equal(arrivals.poisson_arrivals(5, 1.0, rng=rng),
                                  jarrivals.poisson_arrivals(5, 1.0, rng=jrng))
    times = np.cumsum(np.random.default_rng(2).exponential(3.0, size=12)) + 7.0
    for kw in ({}, dict(n=5), dict(n=40), dict(rate=0.25), dict(n=30, rate=2.0, start=1.0)):
        np.testing.assert_array_equal(arrivals.trace_arrivals(times, **kw),
                                      jarrivals.trace_arrivals(times, **kw))
    for bad in ((), (2.0, 1.0)):
        with pytest.raises(ValueError):
            arrivals.trace_arrivals(bad)


def test_scheduler_admission_sequence_matches_reference():
    """A scripted run of enqueue, admit and release: the same admissions
    (request, slot) at every call."""
    rng = np.random.default_rng(5)
    specs = [(int(rng.integers(0, 3)), float(rng.integers(0, 6))) for _ in range(12)]
    seqs = []
    for sched_cls, req_cls in ((Scheduler, Request), (JScheduler, JRequest)):
        sched = sched_cls(3)
        reqs = [req_cls(prompt=np.arange(1, 4), max_new=2, priority=p, arrival=a)
                for p, a in specs]
        index = {id(r): i for i, r in enumerate(reqs)}
        log, live = [], []
        for i, r in enumerate(reqs):
            sched.enqueue(r)
            if i % 3 == 2:
                for now in (float(i // 3), 2.0 + i // 3):
                    got = sched.admit(now)
                    log.append([(index[id(q)], s) for q, s in got])
                    live += [s for _, s in got]
                    log.append(sched.next_arrival(now))
                if live:
                    sched.release(live.pop(0))
        for now in (6.0, 7.0, 8.0, 9.0):
            while live:
                sched.release(live.pop())
            got = sched.admit(now)
            log.append([(index[id(q)], s) for q, s in got])
            live += [s for _, s in got]
        log.append((len(sched), sched.free_slots))
        seqs.append(log)
    assert seqs[0] == seqs[1]


@pytest.mark.parametrize("objective", ["p99", "p50", "mean"])
def test_solve_replication_matches_reference(objective):
    for _, jenv in _envs():
        env = _port_env(jenv)
        for budget in (None, 1, 3, env.n_workers - 1):
            for work in (1.0, 2.5):
                got = solve_replication(env, budget=budget, objective=objective, work=work)
                want = j_solve_replication(jenv, budget=budget, objective=objective,
                                           work=work)
                assert _json(got.to_dict()) == _json(want.to_dict())
    with pytest.raises(ValueError):
        solve_replication(env, objective="p100")


def test_coded_tier_latency_stream_matches_reference():
    for _, jenv in _envs():
        env = _port_env(jenv)
        for budget in (None, 2):
            tier = CodedDecode.solve(env, budget=budget, seed=21)
            jtier = JCodedDecode.solve(jenv, budget=budget, seed=21)
            np.testing.assert_array_equal(tier.step_latencies(40, seed=3),
                                          jtier.step_latencies(40, seed=3))
            assert [tier.draw_step() for _ in range(7)] == \
                [jtier.draw_step() for _ in range(7)]
            assert tier.predicted_mean() == jtier.predicted_mean()
            assert tier.predicted_quantile(0.99) == jtier.predicted_quantile(0.99)
            assert _json(tier.to_dict()) == _json(jtier.to_dict())
        base = CodedDecode.uncoded(env, seed=1)
        jbase = JCodedDecode.uncoded(jenv, seed=1)
        assert _json(base.to_dict()) == _json(jbase.to_dict())
        np.testing.assert_array_equal(base.step_latencies(9), jbase.step_latencies(9))


# -------------------------------------------------------------- the model
@pytest.fixture(scope="module")
def carried():
    """Reduced config, the reference's initialized params, and the port
    model holding them."""
    cfg_t = get_config("gc-lm-110m").reduced(**KW)
    cfg_j = jax_get_config("gc-lm-110m").reduced(**KW)
    state, _ = init_train_state(cfg_j, jax.random.PRNGKey(0))
    jparams = state.params
    model = params_from_numpy(GCLM(cfg_t, **CPU), jax.tree.map(np.asarray, jparams))
    return cfg_t, cfg_j, jparams, model


def _prompts(cfg, lengths, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).astype(np.int32) for n in lengths]


def _close_caches(got, want, rel, what):
    got = caches_to_numpy(got)
    assert len(got) == len(want)
    for g_seg, w_seg in zip(got, want):
        assert set(g_seg) == set(w_seg)
        np.testing.assert_array_equal(g_seg["pos"], np.asarray(w_seg["pos"]))
        assert g_seg["pos"].dtype == np.int32
        for name in ("k", "v"):
            _close(g_seg[name], _f32(w_seg[name]), rel, f"{what} {name}")


def test_prefill_logits_and_caches_match_reference(carried):
    cfg_t, cfg_j, jparams, model = carried
    tokens = np.stack(_prompts(cfg_t, (11, 11), seed=1))
    for target in (0, 24):
        logits_j, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(tokens),
                                            target_len=target)
        logits_t, caches_t = prefill(cfg_t, model, torch.from_numpy(tokens), target_len=target)
        _close(logits_t, logits_j, REL, f"prefill logits target {target}")
        assert caches_t[0]["k"].shape == (2, 2, max(target, 12), 2, cfg_t.head_dim)
        assert caches_t[0]["k"].dtype == torch.float32  # uncast, as the reference's
        _close_caches(caches_t, caches_j, REL, f"prefill target {target}")


def test_prefill_cache_ring_alignment_matches_reference(carried):
    """A windowed layer's capacity and roll (the port's layers raise on
    windows, ROADMAP 1.9; the cache function itself is the reference's)."""
    cfg_t, cfg_j, _, _ = carried
    rng = np.random.default_rng(2)
    k = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    v = rng.standard_normal((2, 13, 2, 8)).astype(np.float32)
    for window, target in ((5, 0), (5, 30), (32, 16), (None, 20)):
        spec = LayerSpec(window=window)
        got = attention.prefill_cache(cfg_t, spec, torch.from_numpy(k), torch.from_numpy(v),
                                      13, target)
        want = jattn.prefill_cache(cfg_j, JLayerSpec(window=window), jnp.asarray(k),
                                   jnp.asarray(v), 13, target)
        for name in ("k", "v"):
            np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
        assert int(got["pos"]) == int(want["pos"]) == 13


def _decode_cases():
    return [("scalar", "float32"), ("scalar", "bfloat16"), ("rows", "float32"),
            ("rows", "bfloat16"), ("wrapped", "float32")]


@pytest.mark.parametrize("kind,dtype", _decode_cases(),
                         ids=[f"{k}-{d}" for k, d in _decode_cases()])
def test_decode_step_from_reference_caches(carried, kind, dtype):
    """One decode step from the reference's caches carried across: scalar
    ``pos`` (a prefill cache), ``(B,)`` ``pos`` (a slab whose rows sit at
    different depths, one row never filled), and a cache decoded past its
    capacity (``pos >= cap``: every entry valid, the slot wraps)."""
    cfg_t, cfg_j, jparams, model = carried
    jdt = getattr(jnp, dtype)
    rel = REL if dtype == "float32" else BF16_REL
    if kind == "scalar":
        tokens = np.stack(_prompts(cfg_t, (9, 9), seed=3))
        _, caches_j = jmodel.prefill(cfg_j, jparams, jnp.asarray(tokens), target_len=16)
        caches_j = jax.tree.map(lambda a: a if a.ndim <= 1 else a.astype(jdt), caches_j)
        tok = np.array([[5], [77]], np.int32)
    elif kind == "rows":
        caches_j = j_make_slab(cfg_j, 4, 20, dtype=jdt)
        for slot, prompt in zip((0, 1, 3), _prompts(cfg_t, (3, 9, 14), seed=4)):
            _, pref = jmodel.prefill(cfg_j, jparams, jnp.asarray(prompt)[None], target_len=20)
            caches_j = j_insert_request(cfg_j, caches_j, pref, slot)
        tok = np.array([[5], [77], [0], [300]], np.int32)
    else:
        caches_j = jmodel.init_decode_caches(cfg_j, 2, 8, dtype=jdt, filled=11)
        rng = np.random.default_rng(6)
        caches_j = [{k: (jnp.asarray(rng.standard_normal(a.shape).astype(np.float32), jdt)
                         if a.ndim > 1 else a) for k, a in seg.items()} for seg in caches_j]
        tok = np.array([[5], [77]], np.int32)
    caches_t = caches_from_numpy(cfg_t, jax.tree.map(np.asarray, caches_j), **CPU)
    assert caches_t[0]["k"].dtype == getattr(torch, dtype)
    k_ptr = caches_t[0]["k"].data_ptr()
    logits_j, new_j = jmodel.decode_step(cfg_j, jparams, caches_j, jnp.asarray(tok))
    logits_t, new_t = decode_step(cfg_t, model, caches_t, torch.from_numpy(tok))
    assert new_t is caches_t and new_t[0]["k"].data_ptr() == k_ptr  # in place
    _close(logits_t, logits_j, rel, f"{kind} {dtype} logits")
    _close_caches(new_t, new_j, rel, f"{kind} {dtype}")


def test_init_decode_caches_layout_matches_reference(carried):
    cfg_t, cfg_j, _, _ = carried
    for row_pos in (False, True):
        want = jmodel.init_decode_caches(cfg_j, 3, 10, filled=4, row_pos=row_pos)
        got = init_decode_caches(cfg_t, 3, 10, filled=4, row_pos=row_pos, **CPU)
        assert got[0]["k"].dtype == torch.bfloat16
        for g, w in zip(caches_to_numpy(got), want):
            for name in w:
                assert g[name].shape == w[name].shape
                np.testing.assert_array_equal(g[name], _f32(w[name]) if name != "pos"
                                              else np.asarray(w[name]))


def _teacher_forced(cfg, model, prompts, outputs, dtype, max_len):
    """Decode logits (T-1, B, V) feeding each row's own generated tokens."""
    slab = make_slab(cfg, len(prompts), max_len, dtype=dtype, **CPU)
    for slot, prompt in enumerate(prompts):
        _, pref = prefill(cfg, model, torch.from_numpy(prompt)[None], target_len=max_len)
        insert_request(cfg, slab, pref, slot)
    s = len(prompts[0])
    steps = []
    for t in range(outputs.shape[1] - s - 1):
        logits, _ = decode_step(cfg, model, slab, torch.from_numpy(outputs[:, s + t, None]))
        steps.append(logits[:, -1].numpy())
    return np.stack(steps)


def _teacher_forced_jax(cfg, jparams, prompts, outputs, dtype, max_len):
    slab = j_make_slab(cfg, len(prompts), max_len, dtype=dtype)
    for slot, prompt in enumerate(prompts):
        _, pref = jmodel.prefill(cfg, jparams, jnp.asarray(prompt)[None], target_len=max_len)
        slab = j_insert_request(cfg, slab, pref, slot)
    s = len(prompts[0])
    steps = []
    for t in range(outputs.shape[1] - s - 1):
        logits, slab = jmodel.decode_step(cfg, jparams, slab,
                                          jnp.asarray(outputs[:, s + t, None]))
        steps.append(np.asarray(logits[:, -1]))
    return np.stack(steps)


# ------------------------------------------------------ one engine run each
ENGINE = dict(n_slots=3, max_len=24, n_requests=7, rate=4e-3)


@pytest.fixture(scope="module")
def engine_runs(carried):
    """The same prompts, arrivals and coded tier through both engines,
    greedy, fp32 slab, stepped one iteration at a time; after every step,
    each live request's slot."""
    cfg_t, cfg_j, jparams, model = carried
    jenv = JEnv.iid(JShiftedExp(mu=1e-3, t0=50.0), 6)
    env = _port_env(jenv)
    prompts = _prompts(cfg_t, [8] * ENGINE["n_requests"], seed=7)
    news = [4, 9, 6, 12, 3, 7, 10]
    times = arrivals.poisson_arrivals(ENGINE["n_requests"], ENGINE["rate"], seed=0)
    out = {}
    for name in ("port", "ref"):
        if name == "port":
            eng = ServeEngine(cfg_t, model, ServeConfig(ENGINE["n_slots"], ENGINE["max_len"],
                                                        torch.float32),
                              coded=CodedDecode.solve(env, budget=4, seed=0), **CPU)
        else:
            eng = JServeEngine(cfg_j, jparams, JServeConfig(ENGINE["n_slots"],
                                                            ENGINE["max_len"], jnp.float32),
                               coded=JCodedDecode.solve(jenv, budget=4, seed=0))
        reqs = [eng.submit(p, max_new=n, arrival=float(t))
                for p, n, t in zip(prompts, news, times)]
        slots = []
        while eng.step():
            slots.append([(i, r.slot) for i, r in enumerate(reqs) if r.slot is not None])
        out[name] = (eng, reqs, slots)
    return out


def test_engine_run_matches_reference(engine_runs):
    eng, reqs, slots = engine_runs["port"]
    jeng, jreqs, jslots = engine_runs["ref"]
    assert slots == jslots
    assert len({s for step in slots for _, s in step}) == ENGINE["n_slots"]
    assert len(eng.finished) == len(reqs) and all(r.done for r in reqs)
    assert [r.uid - reqs[0].uid for r in eng.finished] == \
        [r.uid - jreqs[0].uid for r in jeng.finished]
    for r, jr in zip(reqs, jreqs):
        assert r.tokens == [int(t) for t in jr.tokens]
        assert len(r.tokens) == r.max_new
        for field in ("t_admit", "t_first", "t_done", "n_steps", "slot", "state"):
            assert getattr(r, field) == getattr(jr, field), field
    assert eng.step_latencies == jeng.step_latencies
    assert eng.now == jeng.now
    replay = CodedDecode(eng.coded.env, eng.coded.plan, seed=0)
    np.testing.assert_array_equal(eng.step_latencies,
                                  replay.step_latencies(len(eng.step_latencies), seed=0))


def test_teacher_forced_bf16_slab_logits(carried, engine_runs):
    """Decode logits on a bf16 slab, fed the generated tokens: against the
    reference's bf16 slab, and against fp32 prefill logits of prompt +
    generated tokens at each position."""
    cfg_t, cfg_j, jparams, model = carried
    _, reqs, _ = engine_runs["port"]
    rows = [r for r in reqs if r.max_new == 9] + [r for r in reqs if r.max_new == 12]
    n = min(len(r.tokens) for r in rows)
    prompts = [r.prompt for r in rows]
    outputs = np.stack([r.output[:len(r.prompt) + n] for r in rows])
    got = _teacher_forced(cfg_t, model, prompts, outputs, torch.bfloat16, ENGINE["max_len"])
    want = _teacher_forced_jax(cfg_j, jparams, prompts, outputs, jnp.bfloat16,
                               ENGINE["max_len"])
    _close(got, want, BF16_REL, "bf16 slab vs the reference's")
    full, _ = prefill(cfg_t, model, torch.from_numpy(outputs))
    s = len(prompts[0])
    at = full.numpy()[:, s:s + got.shape[0]].transpose(1, 0, 2)
    _close(got, at, TEACHER_BF16_REL, "bf16 slab vs fp32 prefill")
    fp32 = _teacher_forced(cfg_t, model, prompts, outputs, torch.float32, ENGINE["max_len"])
    _close(fp32, at, REL, "fp32 slab vs fp32 prefill")


# ------------------------------------------------------------ torch only
def test_stream_independent_of_batch_composition(carried):
    """At temperature > 0, served beside other requests (4 over 2 slots:
    admissions, evictions, slot reuse), each request's tokens equal its
    solo run; ``generate``'s rows have distinct streams, row 0 keeps the
    seed."""
    cfg_t, _, _, model = carried
    prompts = _prompts(cfg_t, (6, 4, 6, 5), seed=3)
    news = [5, 3, 4, 5]
    eng = ServeEngine(cfg_t, model, ServeConfig(n_slots=2, max_len=16), **CPU)
    reqs = [eng.submit(p, max_new=n, temperature=0.7, seed=100 + i)
            for i, (p, n) in enumerate(zip(prompts, news))]
    eng.run()
    assert all(r.done for r in reqs)
    for i, (p, n, r) in enumerate(zip(prompts, news, reqs)):
        solo = generate(cfg_t, model, p[None], n, temperature=0.7, seed=100 + i, **CPU)
        np.testing.assert_array_equal(r.output, solo[0].numpy())
    both = np.stack([prompts[0], prompts[0]])
    out = generate(cfg_t, model, both, 6, temperature=0.9, seed=7, **CPU).numpy()
    assert not np.array_equal(out[0], out[1])
    solo = generate(cfg_t, model, prompts[0][None], 6, temperature=0.9, seed=7, **CPU)
    np.testing.assert_array_equal(out[0], solo[0].numpy())
    greedy = generate(cfg_t, model, both, 4, **CPU).numpy()
    np.testing.assert_array_equal(greedy[0], greedy[1])
    with pytest.raises(NotImplementedError, match="ROADMAP 1.9"):
        generate(cfg_t, model, both, 2, aux_inputs=np.zeros(3), **CPU)
    assert generate(cfg_t, model, both, 0, **CPU) is both


def test_slot_recycling_and_slab_written_in_place(carried):
    cfg_t, _, _, model = carried
    eng = ServeEngine(cfg_t, model, ServeConfig(n_slots=2, max_len=12), **CPU)
    ptrs = [(t["k"].data_ptr(), t["v"].data_ptr(), t["pos"].data_ptr()) for t in eng.slab]
    slab = eng.slab
    reqs = [eng.submit(np.arange(1, 7), max_new=3, seed=i) for i in range(5)]
    done = eng.run()
    assert len(done) == 5
    assert all(r.done and len(r.tokens) == 3 for r in reqs)
    assert all(r.slot is None for r in reqs)
    assert eng.scheduler.free_slots == 2 and eng.n_running == 0
    assert [r.uid for r in done] == sorted(r.uid for r in reqs)
    assert eng.slab is slab and ptrs == [(t["k"].data_ptr(), t["v"].data_ptr(),
                                          t["pos"].data_ptr()) for t in eng.slab]
    assert eng.step_latencies == [1.0] * len(eng.step_latencies)


def test_max_new_one_completes_at_admission(carried):
    cfg_t, _, _, model = carried
    eng = ServeEngine(cfg_t, model, ServeConfig(n_slots=1, max_len=8), **CPU)
    req = eng.submit(np.arange(1, 5), max_new=1)
    eng.run()
    assert req.done and len(req.tokens) == 1
    assert req.n_steps == 0 and eng.step_latencies == []


def test_submit_validates_slab_capacity_and_device(carried, monkeypatch):
    cfg_t, _, _, model = carried
    eng = ServeEngine(cfg_t, model, ServeConfig(n_slots=1, max_len=8), **CPU)
    with pytest.raises(ValueError, match="capacity"):
        eng.submit(np.arange(1, 8), max_new=4)
    with pytest.raises(ValueError):
        ServeConfig(n_slots=0, max_len=8)
    with pytest.raises(ValueError):
        eng.submit(np.arange(1, 3), max_new=0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg_t, model)  # the default device is the card
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_slab(cfg_t, 2, 8)


def test_restore_plan_from_a_port_checkpoint(carried, tmp_path):
    cfg_t, _, _, model = carried
    plan = Plan.build(model, ShiftedExponential(mu=1e-3, t0=50.0), 4, scheme="xf")
    save_checkpoint(str(tmp_path / "with"), 3, {"w": np.zeros(2, np.float32)},
                    extra={"plan": plan.to_dict()})
    assert _json(restore_plan(str(tmp_path / "with")).to_dict()) == _json(plan.to_dict())
    assert _json(restore_plan(str(tmp_path / "with"), step=3).to_dict()) == \
        _json(plan.to_dict())
    save_checkpoint(str(tmp_path / "without"), 1, {"w": np.zeros(2, np.float32)})
    assert restore_plan(str(tmp_path / "without")) is None


@pytest.mark.parametrize("mode", ["one-shot", "stream"])
def test_launcher_runs_on_the_cpu(mode, capsys):
    argv = ["--device", "cpu", "--reduced", "--prompt-len", "8", "--new", "4"]
    if mode == "stream":
        argv += ["--stream", "5", "--slots", "2", "--budget", "4"]
    else:
        argv += ["--batch", "2"]
    launch_serve.main(argv)
    lines = capsys.readouterr().out.strip().splitlines()
    if mode == "stream":
        assert lines[0].startswith("coded decode tier: R=")
        assert lines[1].startswith("served 5 requests / 20 tokens in ")
        assert lines[2].startswith("step latency   p50=") and "closed form p99=" in lines[2]
        assert lines[3].startswith("request latency p50=")
    else:
        assert lines[-1].startswith("gc-lm-110m: (2, 12) in ")
    with pytest.raises(KeyError, match="ROADMAP 1.9"):
        launch_serve.main(["--device", "cpu", "--arch", "gemma-2b"])
    with pytest.raises(NotImplementedError, match="one device"):
        launch_serve.main(["--device", "cpu", "--model-par", "2"])
