"""A training state cut over ``data`` by the ``fsdp`` rule (``embed`` over
``data``, on top of the ``model`` axis) in spmd coded training,
checkpoints, worker-death recovery, a plan swap and the wave loop,
against the JAX reference, on the CPU.

* The cut: the port's ``data_dims`` of the reduced configs with ``fsdp``
  set are the ``data`` entries of the reference's ``pspec_for_axes``
  under its ``make_rules(cfg)`` at (data 2, model 2).  The tree
  pipeline's ``scatter_dims`` is the reference's ``_scatter_dims`` (the
  ``embed`` dimension first) for all eleven configs at full width.
* One four-rank gloo job (``tests/torch_fsdp_ranks.py``, no JAX) on
  (data 2, model 2) of ``gemma2-27b`` (every leaf cut) and
  ``mixtral-8x22b`` (experts split on ``expert_mlp``), both
  ``reduced(d_model=128)`` with ``fsdp`` set, from the reference's initial weights,
  while this process runs the reference's sim-mode coded train step:
  ``init_shards(..., over_data=True)`` then ``gather_model`` is the full
  tree byte for byte; two coded spmd steps of every pipeline and reduce
  mode at every straggler count, gathered, within 1e-5 of each leaf's
  scale of the reference's (the first step's first moment, which is its
  clipped gradient, and the second step's moments; the parameters within
  ``PARAM_ATOL``) and within 1e-6 of the port's own
  fsdp-off run on the same mesh (only the clip norm's summation order
  differs; worst 0.51 of the bound); the state and moments take the
  state shapes; a step's collectives equal the formula
  (``torch_fsdp_ranks.step_counts``).
* gemma2-27b's checkpoints: one saved with fsdp on is the reference's
  tree (its ``restore_train_state`` loads it byte for byte) and resumes
  in one process (model 1, fsdp off) byte for byte; a one-process
  checkpoint resumes on the fsdp mesh as each rank's cut of every leaf;
  a save restores into its own mesh byte for byte, fsdp on and off.
* One worker death (its forced re-plan swaps the plan, then a coded
  restore from the survivors) and the wave loop at staleness 1 on the
  fsdp mesh: the same events as fsdp off, the gathered state within
  ``PARAM_ATOL``.
"""
import dataclasses
import functools
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.checkpoint import restore_train_state as jax_restore
from repro.checkpoint.ckpt import _flatten_with_paths as jax_flatten
from repro.configs import get_config as jax_get_config
from repro.core import Plan as JPlan
from repro.core import ShiftedExponential as JShiftedExp
from repro.dist.sharding import make_rules as ref_rules
from repro.dist.sharding import pspec_for_axes as ref_pspec
from repro.dist.sharding import use_mesh
from repro.train.coded import _scatter_dims as ref_scatter_dims
from repro.train.state import abstract_train_state
from repro.train.state import init_train_state as jax_init_train_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_coded_train_step as jax_coded_step
from repro_torch.checkpoint import CheckpointManager, CkptConfig
from repro_torch.checkpoint.ckpt import flatten_with_paths
from repro_torch.configs import get_config, list_archs
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.params import GCLM, data_dims, local_shapes, state_shapes
from repro_torch.train.coded import scatter_dims
from repro_torch.train.state import TrainState, cut_leaf
from repro_torch.train.trainer import TrainConfig, Trainer

import torch_fsdp_ranks as R

pytestmark = pytest.mark.spmd

LIMIT = 300.0
WORLD = 4
REL = 1e-5
OFF_REL = 1e-6
#: parameters after AdamW steps: a last-bit difference of a near-zero
#: gradient entry moves its update visibly (tests/test_torch_tp.py's
#: ``PARAM_ATOL``); against the reference after two steps, and against
#: fsdp off after the death and wave runs
PARAM_ATOL = 3e-6


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg_j(arch):
    return dataclasses.replace(jax_get_config(arch).reduced(d_model=128), fsdp=True)


def _worst(got, want, rel) -> float:
    """Largest per-leaf max error over ``rel`` times the leaf's scale
    (max |want|): <= 1 is within the bound."""
    worst = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape, j
        scale = float(np.abs(b).max())
        err = float(np.abs(a - b).max())
        worst = max(worst, err / (rel * scale) if scale else err)
    return worst


# ------------------------------------------------------------------ the cut
@functools.lru_cache(maxsize=None)
def _reference(arch: str, full: bool) -> tuple:
    cfg = jax_get_config(arch) if full else _cfg_j(arch)
    shapes, axes = abstract_train_state(cfg)
    return cfg, shapes.params, axes.params


def _leaves(shapes, axes) -> tuple:
    return ([tuple(l.shape) for l in jax.tree.leaves(shapes)],
            [tuple(a) for a in jax.tree.leaves(axes, is_leaf=lambda v: hasattr(v, "axes"))])


@pytest.mark.parametrize("arch", R.ARCHS)
def test_the_data_cut_is_the_reference_s(arch):
    """``data_dims`` are the ``data`` entries of the reference's specs,
    every leaf is cut, and the state shapes are the full ones cut on both
    entries."""
    cfg, shapes, axes = _reference(arch, False)
    shapes, axes = _leaves(shapes, axes)
    with use_mesh(AbstractMesh((2, 2), ("data", "model")), ref_rules(cfg)):
        specs = [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]
    mesh = meta_mesh(**R.MESH)
    c = R.cfg(arch)
    want = tuple(s.index("data") if "data" in s else None for s in specs)
    assert data_dims(c, mesh) == want and None not in want
    assert state_shapes(c, mesh) == [tuple(n // 2 if s[d] else n for d, n in enumerate(shape))
                                     for shape, s in zip(shapes, specs)]
    assert data_dims(R.cfg(arch, fsdp=False), mesh) == (None,) * len(shapes)


@pytest.mark.parametrize("n", [2, 4, 16])
@pytest.mark.parametrize("arch", list_archs())
def test_scatter_dims_are_the_reference_s(arch, n):
    """The tree pipeline's per-leaf scatter dimension: the ``embed``
    dimension where N divides it, else the first one N divides."""
    _, shapes, axes = _reference(arch, True)
    meta = GCLM(get_config(arch), device="meta")
    got = scatter_dims([tuple(t.shape) for t in meta.leaves()], n, meta.leaf_axes())
    assert got == ref_scatter_dims(shapes, axes, n)


# ---------------------------------------------------------------- the job
@pytest.fixture(scope="module")
def blob(tmp_path_factory):
    """The reference's initial weights of each arch, the batches and
    decode weights, and a one-process checkpoint (model 1) of gemma2-27b
    one step on."""
    d = tmp_path_factory.mktemp("fsdp")
    out = {"ckpt": {k: str(d / k) for k in ("fsdp", "off", "m1", "death0", "death1")}}
    for arch in R.ARCHS:
        state, _ = jax_init_train_state(_cfg_j(arch), jax.random.PRNGKey(0))
        out[arch] = {"tree": jax.tree.map(np.asarray, state.params)}
    one = Trainer(R.cfg(R.ARCHS[0], fsdp=False), TrainConfig(**R.CFG_T), R.env(),
                  n_workers=R.N, scheme="xf", global_batch=R.BATCH, seed=0, device="cpu",
                  params=out[R.ARCHS[0]]["tree"], seq_len=R.SEQ,
                  ckpt=CkptConfig(dir=out["ckpt"]["m1"]))
    one.run(1, log_every=0)
    one.save_checkpoint()
    out["dir"] = d
    return out


@pytest.fixture(scope="module")
def job(blob):
    """The four-rank job, running in a thread; ``job()`` waits for it."""
    box = {}

    def run():
        try:
            box["out"] = dist_spawn.spawn(R.fsdp_rank, WORLD, blob,
                                          store_dir=str(blob["dir"] / "spawn"), timeout=LIMIT)
        except BaseException as exc:  # noqa: BLE001 - re-raised in the test thread
            box["exc"] = exc

    thread = threading.Thread(target=run)
    thread.start()

    def wait():
        thread.join()
        if "exc" in box:
            raise box["exc"]
        return box["out"]

    yield wait
    thread.join()


@functools.lru_cache(maxsize=None)
def _jax_step(arch: str) -> tuple:
    """The reference's initial state of ``arch``, its ``xf`` plan and its
    jitted sim-mode coded train step."""
    cfg = _cfg_j(arch)
    state, _ = jax_init_train_state(cfg, jax.random.PRNGKey(0))
    plan = JPlan.build(state.params, JShiftedExp(**R.SE), R.N, scheme="xf")
    return state, plan, jax.jit(jax_coded_step(cfg, JTrainConfig(**R.CFG_T), plan, mode="sim"))


@pytest.fixture(scope="module")
def reference(blob, job):
    """Per arch and straggler count, the reference's sim-mode coded train
    step's parameters and moments after each of ``R.STEPS`` steps (made
    while the job runs), and its plan's x."""
    out = {}
    for arch in R.ARCHS:
        state, plan, step = _jax_step(arch)
        port = R.plan_of(R.cfg(arch))
        data = R.data_of(R.cfg(arch))
        wbs = [jnp.asarray(R.coded_worker_batches(data, i, R.N, port.s_max))
               for i in range(R.STEPS)]
        runs = []
        for dec_w in R.dec_ws(port):
            s, states = state, []
            for wb in wbs:
                s, _ = step(s, wb, jnp.asarray(dec_w))
                states.append({"params": [np.asarray(x) for x in jax.tree.leaves(s.params)],
                               "m": [np.asarray(x) for x in jax.tree.leaves(s.opt["m"])],
                               "v": [np.asarray(x) for x in jax.tree.leaves(s.opt["v"])]})
            runs.append({"m1": {"m": states[0]["m"]}, "final": states[-1]})
        out[arch] = dict(x=[int(v) for v in plan.x], port_x=[int(v) for v in port.x], runs=runs)
    return out


@pytest.fixture(scope="module")
def ranks(job, reference):
    return job()


@pytest.mark.parametrize("arch", R.ARCHS)
def test_init_shards_then_gather_model_is_the_full_tree(ranks, blob, arch):
    got = ranks[0][arch]["gathered"]
    want = [np.asarray(x) for x in jax.tree.leaves(blob[arch]["tree"])]
    assert [a.tobytes() for a in got] == [b.astype(np.float32).tobytes() for b in want]
    mesh = meta_mesh(**R.MESH)
    for rank, r in enumerate(ranks):
        assert r[arch]["cut_shapes"] == state_shapes(R.cfg(arch), mesh)
        assert r[arch]["data_dims"] == data_dims(R.cfg(arch), mesh)


@pytest.mark.parametrize("variant", R.VARIANTS, ids=["-".join(v) for v in R.VARIANTS])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_fsdp_steps_are_the_reference_s_sim_mode(ranks, reference, arch, variant):
    """Two steps at every straggler count, gathered, within 1e-5 of each
    leaf's scale of the reference's: the first step's first moment (its
    clipped decoded gradient over 10; the warmup's first step leaves the
    parameters) and the second step's moments; its parameters within
    ``PARAM_ATOL``."""
    ref = reference[arch]
    assert ref["x"] == ref["port_x"]
    got = ranks[0][arch]
    for u, want in enumerate(ref["runs"]):
        have = got[variant + (u, True)]
        for when, names in (("m1", ("m",)), ("final", ("m", "v"))):
            for name in names:
                assert _worst(have[when][name], want[when][name], REL) <= 1.0, (u, when, name)
        for a, b in zip(have["final"]["params"], want["final"]["params"], strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("variant", R.VARIANTS, ids=["-".join(v) for v in R.VARIANTS])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_fsdp_steps_are_fsdp_off_s(ranks, reference, arch, variant):
    """Within 1e-6 of scale of the same mesh with fsdp off, the same
    losses; every rank's parameters and both moments of the state
    shapes, fsdp off of the working shapes."""
    mesh = meta_mesh(**R.MESH)
    for u in range(len(reference[arch]["runs"])):
        on, off = (ranks[0][arch][variant + (u, f)] for f in (True, False))
        np.testing.assert_allclose(on["losses"], off["losses"], rtol=1e-6)
        for when in ("m1", "final"):
            for name, tree in on[when].items():
                assert _worst(tree, off[when][name], OFF_REL) <= 1.0, (u, when, name)
        for r in ranks:
            got = r[arch][variant + (u, True)]
            assert got["shapes"] == got["moment_shapes"] == state_shapes(R.cfg(arch), mesh)
            assert r[arch][variant + (u, False)]["shapes"] == local_shapes(R.cfg(arch), mesh)


@pytest.mark.parametrize("variant", R.VARIANTS, ids=["-".join(v) for v in R.VARIANTS])
@pytest.mark.parametrize("arch", R.ARCHS)
def test_fsdp_step_collectives_are_the_formula(ranks, arch, variant):
    want = R.step_counts(R.cfg(arch), *variant)
    for r in ranks:
        for u in (0, 1):
            assert r[arch][variant + (u, True)]["counts"] == want, u


# --------------------------------------------------------------- checkpoints
def _bytes(tree) -> dict:
    arrays, dtypes = flatten_with_paths(tree)
    return {k: (dtypes[k], a.shape, a.tobytes()) for k, a in arrays.items()}


def test_fsdp_checkpoint_is_the_reference_s_tree(ranks, blob):
    """Saved with fsdp on at (data 2, model 2): the reference restores it
    byte for byte into its template, and a one-process trainer (model 1,
    fsdp off) resumes it byte for byte."""
    full = ranks[0]["saved"]
    template, _ = jax_init_train_state(_cfg_j(R.ARCHS[0]), jax.random.PRNGKey(1))
    ref_state = jax_restore(template, blob["ckpt"]["fsdp"], 1)
    arrays, dtypes = jax_flatten(ref_state)
    assert {k: (dtypes[k], a.shape, a.tobytes()) for k, a in arrays.items()} == _bytes(full)
    one = Trainer(R.cfg(R.ARCHS[0], fsdp=False), TrainConfig(**R.CFG_T), R.env(),
                  n_workers=R.N, scheme="xf", global_batch=R.BATCH, seed=0, device="cpu",
                  seq_len=R.SEQ, ckpt=CkptConfig(dir=blob["ckpt"]["fsdp"]))
    assert int(one.state.step) == 1
    assert _bytes(one.state) == _bytes(full)


@pytest.mark.parametrize("fsdp", [True, False], ids=["fsdp", "model-only"])
def test_a_checkpoint_restores_into_its_own_mesh(ranks, fsdp):
    """Every rank's state after a save and a restore on the same mesh is
    its state at the save, byte for byte: the restore broadcasts each
    full leaf contiguous (a leaf gathered on its last dimension is saved
    transposed, in Fortran order, and loads so)."""
    assert all(r["self_restore", fsdp] for r in ranks)


def test_one_process_checkpoint_resumes_cut_over_data(ranks, blob):
    """A model-1 checkpoint restores on each rank of the fsdp mesh as the
    (model, data) cut of every full leaf."""
    arrays, step = CheckpointManager(CkptConfig(dir=blob["ckpt"]["m1"])).load(device="cpu")
    assert step == 1
    c = R.cfg(R.ARCHS[0])
    for rank, r in enumerate(ranks):
        assert r["resumed"]["step"] == 1
        mesh = meta_mesh(**R.MESH, rank=rank)
        from repro_torch.models.params import init_shards
        local = init_shards(c, mesh, device="meta", over_data=True)
        cuts = TrainState(params=local, opt={"m": local.leaves(), "v": local.leaves(),
                                             "count": 0}, step=0)._leaf_cuts()
        assert [k for k, *_ in cuts] == list(r["resumed"]["shards"]) == list(arrays)
        for key, _, dim, blocks, ddim in cuts:
            want = cut_leaf(torch.as_tensor(arrays[key]), mesh, dim, blocks, ddim).numpy()
            assert np.array_equal(r["resumed"]["shards"][key], want), (rank, key)


# ------------------------------------------------------------- death, wave
@pytest.mark.parametrize("kind", ["death", "wave"])
def test_death_swap_and_wave_on_the_fsdp_mesh(ranks, kind):
    """One worker death (a forced re-plan that swaps the plan, then a
    coded restore from the survivors), and the wave loop at staleness 1:
    the same events and losses as fsdp off, the gathered state within
    ``PARAM_ATOL``."""
    on, off = ranks[0][kind, True], ranks[0][kind, False]
    assert [h[:2] for h in on["history"]] == [h[:2] for h in off["history"]]
    np.testing.assert_allclose([h[2] for h in on["history"]], [h[2] for h in off["history"]],
                               rtol=1e-5)
    assert on["recoveries"] == off["recoveries"] and on["plan_x"] == off["plan_x"]
    if kind == "death":
        [(step, dead, ckpt_step, x_old, x_new)] = on["recoveries"]
        assert dead == (0,) and ckpt_step < step and x_old != x_new
    for name in ("params", "m", "v"):
        for a, b in zip(on["state"][name], off["state"][name], strict=True):
            np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL)
    for r in ranks:
        assert [h[:2] for h in r[kind, True]["history"]] == [h[:2] for h in on["history"]]
