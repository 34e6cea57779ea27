"""The dry run's ``model`` axis (``launch/dryrun.py``): the reference's
``single`` (data 16, model 16) and ``multi`` (pod 2, data 16, model 16)
meshes, one rank's shards, caches and collectives, on the CPU.

* The split of every arch at (16, 16) and (2, 16, 16): the port's spec
  (``shard_dims``' ``model`` entry and ``data_dims``' ``data`` entry,
  the ``fsdp`` rule's) equals the reference's ``pspec_for_axes`` on an
  ``AbstractMesh`` on every entry of every leaf, ``local_shapes`` (the
  working shapes) are the full shapes cut on the ``model`` entry and
  ``state_shapes`` cut on both; a mixtral-8x22b rank of (16, 16) holds
  7.09 GB of parameters and moments, not the 113.44 GB of its working
  shapes.  ``repro.launch.dryrun`` is never imported: it sets
  ``XLA_FLAGS`` to 512 host devices at import.
* At data 4 x model 2 on reduced gc-lm-110m: the coded, uncoded and
  decode records' collectives — counts and bytes — equal the formulas
  of ``tests/torch_tp_mla_ranks.py`` (``step_counts``, ``serve_counts``)
  with the bytes of each term written from the config, and the rank's
  argument bytes are its state shapes three times (parameters and two
  moments) plus the inputs.
* The CLI's records: ``n_chips`` 256 and 512 by default, and
  ``--mesh-shape`` honoured; at 16x1 the rank holds the whole tree.
* ``--measure``'s solo mesh on the CPU: the collectives return the
  rank's own data in the mesh's shapes, and a (16, 16) rank's step runs.
"""
import functools
import json
import math

import jax
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.dist.sharding import make_rules as ref_rules
from repro.dist.sharding import pspec_for_axes as ref_pspec
from repro.dist.sharding import use_mesh
from repro.train.state import abstract_train_state as j_abstract_state
from repro_torch.configs import InputShape, get_config, list_archs
from repro_torch.dist import collectives
from repro_torch.dist.mesh import meta_mesh, solo_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.models.params import data_dims, local_shapes, shard_dims, state_shapes
from repro_torch.train.coded import local_layout
from repro_torch.tune.memory import tree_bytes

import torch_tp_mla_ranks as R

#: (the reference's mesh shape and axes, the port's meta mesh)
MESHES = {"single": (((16, 16), ("data", "model")), dict(data=16, model=16)),
          "multi": (((2, 16, 16), ("pod", "data", "model")), dict(data=16, pod=2, model=16))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str) -> tuple:
    """The reference's full leaf shapes and logical axes of ``arch``."""
    shapes, axes = j_abstract_state(jax_get_config(arch))
    return ([tuple(l.shape) for l in jax.tree.leaves(shapes.params)],
            [tuple(a) for a in jax.tree.leaves(axes.params, is_leaf=lambda v: hasattr(v, "axes"))])


def _reference_specs(arch: str, mesh_kind: str) -> tuple:
    """The reference's full leaf shapes and specs of ``arch`` on the mesh."""
    shapes, axes = _reference_leaves(arch)
    (shape, names), _ = MESHES[mesh_kind]
    with use_mesh(AbstractMesh(shape, names), ref_rules(jax_get_config(arch))):
        return shapes, [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]


@pytest.mark.parametrize("mesh_kind", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_shards_on_the_reference_s_meshes_follow_its_rule(arch, mesh_kind):
    shapes, specs = _reference_specs(arch, mesh_kind)
    mesh = meta_mesh(**MESHES[mesh_kind][1])
    cfg = get_config(arch)
    port = []
    for shape, mdim, ddim in zip(shapes, shard_dims(cfg, mesh), data_dims(cfg, mesh),
                                 strict=True):
        port.append(tuple("model" if d == mdim else "data" if d == ddim else None
                          for d in range(len(shape))))
    assert port == specs
    assert local_shapes(cfg, mesh) == [
        tuple(n // 16 if s == "model" else n for n, s in zip(shape, spec))
        for shape, spec in zip(shapes, specs)]
    assert state_shapes(cfg, mesh) == [
        tuple(n // 16 if s else n for n, s in zip(shape, spec))
        for shape, spec in zip(shapes, specs)]
    assert any("data" in s for s in specs) == cfg.fsdp


def test_a_mixtral_rank_holds_its_fsdp_cut():
    """mixtral-8x22b's rank 0 of (16, 16): its parameters and two fp32
    moments come to 7.09 GB cut by ``data`` and ``model``, against
    113.44 GB cut by ``model`` alone; the dry run's record says so."""
    cfg, mesh = get_config("mixtral-8x22b"), meta_mesh(16, model=16)
    state = 12 * sum(math.prod(s) for s in state_shapes(cfg, mesh))
    working = 12 * sum(math.prod(s) for s in local_shapes(cfg, mesh))
    assert (round(state / 1e9, 2), round(working / 1e9, 2)) == (7.09, 113.44)
    args, extra = dryrun.build_case(cfg, InputShape("t", 8, 16, "decode"), mesh,
                                    coded=False)[1:]
    assert 12 * extra["local_params"] == state
    assert tree_bytes(args[0]) == state // 3


# ------------------------------------------------ data 4 x model 2, reduced
B, S = 8, 16
MESH = meta_mesh(4, model=2)


def _cfg():
    return get_config("gc-lm-110m").reduced()


def _pass_bytes(c, rows: int, backward: bool = True) -> int:
    """One pass's model-group all-reduce bytes over ``rows`` rows of S
    tokens: every forward reduce of (rows, S, d) — the embedding's and
    each layer's — and the loss's two reduces and max of (rows, S) fp32;
    backward, every copy of (rows, S, d), each layer's and the head's."""
    act = rows * S * c.d_model * torch.tensor([], dtype=getattr(torch, c.dtype)).element_size()
    p = R.pass_counts(c, 2)
    fwd = (p["reduce"] - 2) * act + 3 * 4 * rows * S
    return fwd + backward * p["copy"] * act


def _record(coded: bool, kind: str):
    fn, args, extra = dryrun.build_case(_cfg(), InputShape("t", S, B, kind), MESH, coded=coded)
    collectives.reset_counts()
    cost = analyze_ops(fn, *args)
    return args, extra, cost


def _as_kinds(counts: dict) -> dict:
    """The port's collective counts under the op counter's kinds."""
    return {"all-reduce": counts["psum"] + counts["copy"] + counts["reduce"] + counts["max"],
            "all-gather": counts["all_gather"], "reduce-scatter": counts["psum_scatter"]}


def _kinds(cost) -> dict:
    return {k: cost.collective_counts[k] for k in ("all-reduce", "all-gather", "reduce-scatter")}


def test_coded_record_s_collectives_and_memory_are_the_formula_s():
    """K passes of B/N rows and the monitoring forward (``step_counts``
    without the trainer's draw check), the clip's one scalar reduce and
    one psum of each level of the rank's layout; the arguments are the
    rank's state (parameters and two moments of its local shapes, two
    int32 counters), the workers' batches and the decode weights."""
    c = _cfg()
    args, extra, cost = _record(True, "train")
    k, n_levels = extra["s_max"] + 1, extra["n_levels"]
    # the op counter's (it multiplies the one pass meta runs of K)
    assert _kinds(cost) == _as_kinds(R.step_counts(c, 2, k, n_levels))
    plan = dryrun.Plan.build(dryrun.GCLM(c, device="meta"), dryrun.ShiftedExponential(
        mu=1e-3, t0=50.0), 4, scheme="xf")
    levels = 4 * sum(local_layout(c, plan, MESH).level_sizes)
    rows = B // 4
    assert cost.collective_bytes["all-reduce"] == (k * _pass_bytes(c, rows)
                                                  + _pass_bytes(c, rows, False) + 4 + levels)
    local = sum(math.prod(s) for s in state_shapes(c, MESH))
    assert extra["local_params"] == local
    assert extra["params_b"] == dryrun.count_params(dryrun.GCLM(c, device="meta"))
    wb, dec_w = args[1], args[2]
    assert tree_bytes(args) == 3 * 4 * local + 8 + wb.numel() * 8 + dec_w.nbytes
    assert wb.shape == (4, k, rows, S + 1)


def test_uncoded_record_s_collectives_and_memory_are_the_formula_s():
    """One pass of B / data rows, the clip's reduce and one psum of the
    rank's gradients and metrics over the data ranks."""
    c = _cfg()
    args, extra, cost = _record(False, "train")
    p = R.pass_counts(c, 2)
    want = dict(psum=1, psum_scatter=0, all_gather=0, broadcast=0, copy=p["copy"],
                reduce=p["reduce"] + 1, max=p["max"])
    assert dict(collectives.counts, **collectives.model_counts) == want
    assert _kinds(cost) == _as_kinds(want)
    local = extra["local_params"]
    n_metrics = 3  # loss, xent and the tokens' count
    assert cost.collective_bytes["all-reduce"] == (_pass_bytes(c, B // 4) + 4
                                                  + 4 * (local + n_metrics))
    assert tree_bytes(args) == 3 * 4 * local + 8 + B * (S + 1) * 8


def test_decode_record_s_collectives_and_memory_are_the_formula_s():
    """A decode step of ceil(B / data) rows against the rank's caches —
    its KV heads' — is one engine decode (``serve_counts``) without the
    engine's token gather; the arguments are the rank's parameters, its
    caches and the token."""
    c = _cfg()
    args, extra, cost = _record(False, "decode")
    rows = B // 4
    assert extra["rows"] == rows
    want = R.serve_counts(c, 2, dict(decoded=1, admitted=[]), range(rows), rows, S, 1)
    assert _kinds(cost) == {"all-reduce": want["reduce"], "all-gather": want["all_gather"],
                            "reduce-scatter": 0}
    assert cost.collective_bytes["all-reduce"] == want["reduce_bytes"]
    assert cost.collective_bytes["all-gather"] == want["all_gather_bytes"]
    params, caches, token = args
    k = caches[0]["k"]
    assert k.shape[-2] == c.n_kv_heads // 2 and token.shape == (rows, 1)
    assert tree_bytes(args) == 4 * extra["local_params"] + tree_bytes(caches) + rows * 8


# ------------------------------------------------------------------ the CLI
def test_cli_honours_the_mesh_shape(tmp_path, capsys):
    """``--mesh-shape 4x2``: (data 4, model 2) per pod, 8 and 16 chips,
    ceil(B / (data · pod)) rows; ``16x1`` holds the whole tree on a rank."""
    rc = dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "both",
                      "--mesh-shape", "4x2", "--out", str(tmp_path / "a")])
    assert rc == 0 and "done: 2 ok, 0 skip, 0 fail" in capsys.readouterr().out
    recs = [json.loads(p.read_text()) for p in sorted((tmp_path / "a").glob("*.json"))]
    assert [(r["mesh"], r["n_chips"], r["mesh_shape"], r["rows"]) for r in recs] == [
        ("multi", 16, [2, 4, 2], 16), ("single", 8, [4, 2], 32)]
    assert all(r["local_params"] < r["params_b"] for r in recs)
    rec = dryrun.run_case("gc-lm-110m", "decode_32k", "single", coded=False,
                          out_dir=str(tmp_path / "b"), mesh_shape=(16, 1))
    assert (rec["n_chips"], rec["mesh_shape"]) == (16, [16, 1])
    assert rec["local_params"] == rec["params_b"]
    assert rec["collectives"]["all-reduce"]["count"] == 0  # no model group


# ------------------------------------------------------------------ --measure
def test_solo_mesh_collectives_return_the_rank_s_own_data():
    """A solo group of 4: an all-gather repeats the tile, a reduce-scatter
    keeps the first, an all-reduce and a broadcast leave the input."""
    mesh = solo_mesh(4, model=2, device="cpu")
    x = torch.arange(8.0)
    assert torch.equal(collectives.all_gather(x, mesh.data_group), x.repeat(4))
    assert torch.equal(collectives.psum_scatter(x, mesh.data_group), x[:2])
    assert torch.equal(collectives.psum([x.clone()], mesh.data_group)[0], x)
    assert torch.equal(collectives.reduce_from_model(x, mesh.model_group), x)
    assert torch.equal(collectives.broadcast(x.clone(), mesh.world_group), x)
    with pytest.raises(ValueError, match="meta tensor"):
        collectives.psum([x.to("meta")], mesh.data_group)


@pytest.mark.parametrize("coded", [False, True])
def test_a_sixteen_by_sixteen_rank_s_step_runs_alone(coded):
    """Reduced gc-lm-110m's rank 0 of (16, 16) on a solo mesh on the CPU —
    what ``--measure`` runs on the card: the step runs on the rank's
    shards and its arguments are the meta record's."""
    c = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    shape = InputShape("t", 8, 32, "train")
    fn, args, extra = dryrun.build_case(c, shape, solo_mesh(16, model=16, device="cpu"),
                                        coded=coded, device="cpu")
    meta_args = dryrun.build_case(c, shape, meta_mesh(16, model=16), coded=coded)[1]
    assert tree_bytes(args) == tree_bytes(meta_args)
    args = dryrun._materialize(args, "cpu", torch.Generator().manual_seed(0))
    state, metrics = fn(*args)
    assert extra["local_params"] < extra["params_b"]
    assert all(torch.isfinite(v).all() for v in metrics.values())
