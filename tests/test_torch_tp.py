"""The tensor-parallel ``model`` axis of the port (``dist/sharding.py``,
``params.shard_model``, the model group's collectives, the sharded
layers, the vocab-parallel loss, the clip's norm) against the JAX
reference, on the CPU.

* The rules: the port's logical axes and ``pspec_for_axes`` equal the
  reference's on every leaf of all eleven configs at full width (on
  meta; the reference's ``abstract_train_state``), on the meshes
  ``(16, 16)``, ``(4, 2)``, ``(1, 8)`` and ``(2, 16, 16)``.
* Megatron's f and g, the max and the vocab-parallel embedding, head and
  loss on a 2-rank gloo job equal the one-process products, forward and
  backward (loss 1e-6).
* One 8-rank job on (data 4, model 2) with reduced gc-lm-110m: flat
  ``psum``, flat ``psum_scatter`` and tree ``psum`` at every straggler
  count within 1e-5 of each leaf's scale of the reference's spmd output
  on its own ``(4, 2)`` ``("data", "model")`` mesh (a JAX subprocess on
  8 fake host devices; each trainer's config runs in one of its own, on 4); bf16 ``grad_dtype`` within 2^-7 of the
  contributions' scale of the reference's sim-mode bf16 (its bf16 spmd
  function on a model axis aborts XLA, ROADMAP 3.1, so the subprocess
  never builds it); the uncoded gradient of the shards; the same bytes
  on the data ranks of a model index, replicated leaves byte-equal on
  all eight; one grouped call and one collective per level per rank.
* One 4-rank job on (data 2, model 2) with reduced gemma-2b (one KV head,
  replicated), qwen1.5-32b (QKV biases; d_ff 1369, a replicated MLP),
  gemma2-27b (a window of 16 below the sequence, the score and final
  softcaps, the post-norms) and gemma3-27b (QK-norm behind f, five
  windowed layers and a global one): flat spmd gradients against the
  reference's on its ``(2, 2)`` mesh, and three ``Trainer(mode="spmd")``
  steps against the reference's spmd trainer there (losses 1e-5,
  parameters ``PARAM_ATOL``), replicated leaves byte-equal across the
  model ranks after every step.
* ``init_shards`` draws the shards ``shard_model`` cuts from the full
  initial tree, byte for byte.
* gc-lm-110m's level slices at full width stay on the grouped kernel's
  TMA path at model 2 and 4.
"""
import functools
import os
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as ref_config
from repro.dist.sharding import make_rules as ref_rules
from repro.dist.sharding import pspec_for_axes as ref_pspec
from repro.dist.sharding import use_mesh
from repro.train.state import abstract_train_state
from repro_torch.configs import get_config, list_archs
from repro_torch.core import Plan, ShiftedExponential
from repro_torch.core.flat import LANE
from repro_torch.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
from repro_torch.dist import spawn as dist_spawn
from repro_torch.dist.mesh import meta_mesh
from repro_torch.dist.sharding import make_rules, model_dim, pspec_for_axes
from repro_torch.kernels import _pipe
from repro_torch.models.model import _xent
from repro_torch.models.params import (GCLM, init_shards, local_shapes, params_from_numpy,
                                       shard_dims, shard_model)
from repro_torch.train.coded import local_layout, make_coded_grad_fn, per_shard_grad_rows
from repro_torch.train.state import init_train_state
from repro_torch.train.trainer import TrainConfig, make_train_step

from torch_tp_ranks import coded_grads_rank, collectives_rank, trainer_rank

pytestmark = pytest.mark.spmd

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SE = ShiftedExponential(mu=1e-3, t0=50.0)
LIMIT = 300.0
SEQ = 48
#: the reference's meshes: (shape, axis names) and the port's (pod, data, model)
MESHES = {"16x16": ((16, 16), ("data", "model"), dict(data=16, model=16)),
          "4x2": ((4, 2), ("data", "model"), dict(data=4, model=2)),
          "1x8": ((1, 8), ("data", "model"), dict(data=1, model=8)),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"), dict(pod=2, data=16, model=16))}
GC = dict(arch="gc-lm-110m", reduced=dict(n_layers=2, d_model=128), data=4, model=2)
#: reduced gemma-2b: one KV head (replicated over model 2); qwen1.5-32b at
#: d_model 256: QKV biases, an untied head, d_ff 1369 (a replicated MLP);
#: gemma2-27b and gemma3-27b with windows of 16, below the trainer's 32
#: tokens and the gradients' 48 (gemma3: five windowed layers, one global)
TRAINERS = {"gemma-2b": dict(n_layers=2, d_model=128), "qwen1.5-32b": dict(n_layers=2),
            "gemma2-27b": dict(n_layers=2, d_model=128, seq_cap=32),
            "gemma3-27b": dict(n_layers=6, d_model=128, seq_cap=32)}
#: the families the model axis splits: all of them
ON_AXIS = tuple(list_archs())
#: the trainers' parameters against the reference's after three steps.
#: Qwen's takes ``tests/test_torch_qwen.py``'s bound: AdamW's normalized
#: step m/sqrt(v) turns a last-bit difference of a near-zero gradient
#: entry into a visible update — the port's one-process trainer already
#: lies 6.35e-6 from the reference's in the key bias ``bk``
PARAM_ATOL = {"gemma-2b": 3e-6, "qwen1.5-32b": 2e-5, "gemma2-27b": 3e-6, "gemma3-27b": 3e-6}
#: the leaves each trainer's config leaves whole on the model axis,
#: besides the norm scales
REPLICATED = {"gemma-2b": {"stack.0.mixer.wk", "stack.0.mixer.wv"},
              "qwen1.5-32b": {"stack.0.ffn.wi", "stack.0.ffn.wg", "stack.0.ffn.wo"},
              "gemma2-27b": set(),
              "gemma3-27b": {"stack.0.mixer.q_norm", "stack.0.mixer.k_norm",
                             "stack.1.mixer.q_norm", "stack.1.mixer.k_norm"}}
VARIANTS = {"flat": dict(pipeline="flat"),
            "flat_scatter": dict(pipeline="flat", reduce_mode="psum_scatter"),
            "tree": dict(pipeline="tree"),
            "flat_bf16": dict(pipeline="flat", grad_dtype=torch.bfloat16)}

JAX_SIDE = textwrap.dedent("""
    import os, sys
    import jax, numpy as np, jax.numpy as jnp
    from repro.configs import get_config
    from repro.core import Plan, ShiftedExponential
    from repro.data.pipeline import DataConfig, SyntheticTokens, coded_worker_batches
    from repro.dist.sharding import make_rules, use_mesh
    from repro.train.coded import make_coded_grad_fn
    from repro.train.state import init_train_state
    from repro.train.trainer import TrainConfig, Trainer

    part = sys.argv[3]  # "gc", or one of the trainers' configs
    if part == "gc":
        cfgs = {"gc-lm-110m": get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)}
    else:
        cfgs = {part: get_config(part).reduced(**%(trainers)r[part])}
    out, params = {}, {}
    for arch, cfg in cfgs.items():
        state, _ = init_train_state(cfg, jax.random.PRNGKey(0))
        params[arch] = state.params
        for j, leaf in enumerate(jax.tree.leaves(state.params)):
            out[f"init/{arch}/{j}"] = np.asarray(leaf)
    np.savez(sys.argv[1] + ".tmp.npz", **out)  # the weights first: the port starts on them
    os.replace(sys.argv[1] + ".tmp.npz", sys.argv[1])
    se = ShiftedExponential(mu=1e-3, t0=50.0)
    auto = jax.sharding.AxisType.Auto

    def dec(plan, n, u):
        times = np.ones(n); times[:u] = 1e6
        return jnp.asarray(plan.decode_weights(times), jnp.float32)

    def put(key, tree):
        for j, leaf in enumerate(jax.tree.leaves(tree)):
            out[f"{key}/{j}"] = np.asarray(leaf.astype(jnp.float32))

    def grads(arch, mesh, kws, seq):
        cfg, n = cfgs[arch], mesh.shape["data"]
        plan = Plan.build(params[arch], se, n, scheme="xf")
        data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=8))
        wb = jnp.asarray(coded_worker_batches(data, 0, n, plan.s_max))
        with use_mesh(mesh, make_rules(cfg)):
            for name, kw in kws.items():
                fn = jax.jit(make_coded_grad_fn(cfg, plan, mesh=mesh, mode="spmd", **kw))
                for u in range(plan.s_max + 1):
                    put(f"{arch}/{name}/{u}", fn(params[arch], wb, dec(plan, n, u)))
        return plan, wb

    # reduced gc-lm-110m on (4, 2): the flat pipeline with psum and
    # psum_scatter, the tree with psum (bf16 grad_dtype aborts XLA on a
    # model axis: its sim-mode output, off the mesh, instead)
    if part == "gc":
        mesh = jax.make_mesh((4, 2), ("data", "model"), axis_types=(auto, auto))
        plan, wb = grads("gc-lm-110m", mesh, {
            "flat": dict(pipeline="flat"),
            "flat_scatter": dict(pipeline="flat", reduce_mode="psum_scatter"),
            "tree": dict(pipeline="tree")}, %(seq)d)
        fn = jax.jit(make_coded_grad_fn(cfgs["gc-lm-110m"], plan, mode="sim", pipeline="flat",
                                        grad_dtype=jnp.bfloat16))
        for u in range(plan.s_max + 1):
            put(f"gc-lm-110m/sim_bf16/{u}", fn(params["gc-lm-110m"], wb, dec(plan, 4, u)))
    else:  # a trainer's config on (2, 2): flat gradients and three trainer steps
        arch, cfg = part, cfgs[part]
        mesh = jax.make_mesh((2, 2), ("data", "model"), axis_types=(auto, auto))
        grads(arch, mesh, {"flat": dict(pipeline="flat")}, %(seq)d)
        with use_mesh(mesh, make_rules(cfg)):
            tr = Trainer(cfg, TrainConfig(warmup=1, total_steps=10), se, n_workers=2,
                         scheme="xf", global_batch=8, seed=0, mesh=mesh, mode="spmd")
            for a, b in zip(jax.tree.leaves(tr.state.params), jax.tree.leaves(params[arch])):
                assert np.array_equal(np.asarray(a), np.asarray(b)), arch  # the same init
            tr.data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8,
                                                 seed=0))
            tr.run(3, log_every=0)
        put(f"{arch}/trainer/params", tr.state.params)
        for key in ("loss", "grad_norm", "lr", "step"):
            out[f"{arch}/trainer/{key}"] = np.asarray([h[key] for h in tr.history])
        out[f"{arch}/trainer/times"] = np.stack([r["times"] for r in tr.sim.ledger])
    np.savez(sys.argv[2], **out)
    print(len(jax.devices()))
""") % {"seq": SEQ, "trainers": TRAINERS}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch: str, kw: dict):
    return get_config(arch).reduced(**kw)


def _leaves(blob, key) -> list:
    n = len([k for k in blob if k.startswith(f"{key}/")])
    return [blob[f"{key}/{j}"] for j in range(n)]


def _worst(got, want, tol: float, scales=None) -> float:
    """Largest per-leaf max error over ``tol`` times the leaf's scale
    (``scales[j]``, by default max |want|): <= 1 means within the bound."""
    worst = 0.0
    for j, (a, b) in enumerate(zip(got, want, strict=True)):
        a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
        assert a.shape == b.shape
        scale = float(np.abs(b).max()) if scales is None else scales[j]
        worst = max(worst, float(np.abs(a - b).max()) / (tol * scale) if scale else
                    float(np.abs(a).max()))
    return worst


def _dec_ws(plan, n):
    out = []
    for u in range(plan.s_max + 1):
        times = np.ones(n)
        times[:u] = 1e6  # u realized stragglers
        out.append(plan.decode_weights(times).astype(np.float32))
    return out


# ------------------------------------------------------------------ rules
@functools.lru_cache(maxsize=None)
def _reference_leaves(arch: str):
    shapes, axes = abstract_train_state(ref_config(arch))
    return ([tuple(l.shape) for l in jax.tree.leaves(shapes.params)],
            [tuple(a) for a in jax.tree.leaves(axes.params, is_leaf=lambda v: hasattr(v, "axes"))])


@pytest.mark.parametrize("arch", list_archs())
def test_leaf_axes_are_the_reference_s(arch):
    shapes, axes = _reference_leaves(arch)
    model = GCLM(get_config(arch), device="meta")
    assert [tuple(t.shape) for t in model.leaves()] == shapes
    assert model.leaf_axes() == axes


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_pspecs_are_the_reference_s(arch, mesh):
    """The reference's ``pspec_for_axes`` reads only ``mesh.shape``, so an
    ``AbstractMesh`` stands for its production meshes."""
    shape, names, kw = MESHES[mesh]
    shapes, axes = _reference_leaves(arch)
    with use_mesh(AbstractMesh(shape, names), ref_rules(ref_config(arch))):
        want = [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]
    port, rules = meta_mesh(**kw), make_rules(get_config(arch))
    assert [pspec_for_axes(a, s, port, rules) for a, s in zip(axes, shapes)] == want
    dims = tuple(spec.index("model") if "model" in spec else None for spec in want)
    assert tuple(model_dim(a, s, port, rules) for a, s in zip(axes, shapes)) == dims
    if arch in ON_AXIS:  # the families the port splits: shard_model's cut
        assert shard_dims(get_config(arch), port) == dims
        assert local_shapes(get_config(arch), port) == [
            s if d is None else s[:d] + (s[d] // kw["model"],) + s[d + 1:]
            for s, d in zip(shapes, dims)]


def test_meta_mesh_lays_ranks_out_as_make_mesh():
    """rank = (pod_index · data + data_index) · model + model_index, as
    ``jax.make_mesh((pod, data, model))`` lays out devices."""
    coords = [(m.pod_index, m.data_index, m.model_index) for m in
              (meta_mesh(data=3, pod=2, model=2, rank=r) for r in range(12))]
    assert coords == [(p, d, k) for p in range(2) for d in range(3) for k in range(2)]
    mesh = meta_mesh(data=3, pod=2, model=2)
    assert mesh.size == 12 and mesh.model_group.size == 2 and mesh.data_group.size == 3
    assert mesh.shape == {"pod": 2, "data": 3, "model": 2}
    assert meta_mesh(data=4).model_group is None and meta_mesh(data=4).shape == {
        "data": 4, "model": 1}
    with pytest.raises(ValueError, match="no rank"):
        meta_mesh(data=4, model=2, rank=8)


@pytest.mark.parametrize("model", [2, 4])
def test_full_width_local_level_slices_stay_on_the_tma_path(model):
    """A model rank's level buffers of full-width gc-lm-110m (the plan's
    levels over the shards' shapes): every slice starts and ends on 16
    bytes, so the grouped kernel takes all 11 leaves on its TMA ring in
    one launch."""
    cfg = get_config("gc-lm-110m")
    plan = Plan.build(GCLM(cfg, device="meta"), SE, 4, scheme="xf")
    layout = local_layout(cfg, plan, meta_mesh(data=4, model=model))
    assert layout.leaf_level == plan.flat_layout.leaf_level
    assert layout.n_leaves == 11 <= _pipe.MAX_LEAVES
    assert all(size % LANE == 0 for size in layout.level_sizes)
    assert layout.total_elems < plan.flat_layout.total_elems
    for j, li, off, size in layout.leaf_slices():
        assert (off * 4) % 16 == 0 and (size * 4) % 16 == 0, j
        assert _pipe.leaf_mode(size, 4, 0, 4 * off, stages=2) == _pipe.RING, j
    assert len(_pipe.plan_launches([layout.leaf_size(j) for j in range(11)], 2048)) == 1


def test_unported_families_raise_on_the_model_axis():
    """No family is left off the axis: xLSTM, Whisper and vision, which
    raised naming ROADMAP 6c before, shard at model 2 — their heads,
    xLSTM's channels and the vocabulary where its rows divide the axis."""
    mesh = meta_mesh(data=2, model=2)
    for arch, axes in (("xlstm-1.3b", {"heads", "d_inner", "vocab"}),
                       ("whisper-base", {"heads", "kv_heads", "mlp", "vocab"}),
                       ("llama-3.2-vision-11b", {"heads", "kv_heads", "mlp", "vocab"})):
        local = shard_model(GCLM(get_config(arch).reduced(n_layers=2, d_model=128),
                                 device="meta"), mesh)
        assert local.tp.axes == axes, arch
    experts = shard_model(GCLM(get_config("mixtral-8x22b").reduced(), device="meta"), mesh)
    assert experts.tp.axes == {"heads", "kv_heads", "expert_mlp", "vocab"}
    local = shard_model(GCLM(_cfg("gc-lm-110m", GC["reduced"]), device="meta"), mesh)
    assert local.tp.mesh is mesh and sum(d is not None for d in local.shard_dims) == 8
    assert local.tp.axes == {"heads", "kv_heads", "mlp", "vocab"}


@functools.lru_cache(maxsize=None)
def _reference_model_dims(arch: str, reduced: bool) -> tuple:
    cfg = ref_config(arch).reduced() if reduced else ref_config(arch)
    shapes, axes = abstract_train_state(cfg)
    shapes = [tuple(l.shape) for l in jax.tree.leaves(shapes.params)]
    axes = [tuple(a) for a in jax.tree.leaves(axes.params, is_leaf=lambda v: hasattr(v, "axes"))]
    with use_mesh(AbstractMesh((2, 2), ("data", "model")), ref_rules(cfg)):
        specs = [tuple(ref_pspec(a, s)) for a, s in zip(axes, shapes)]
    return tuple(spec.index("model") if "model" in spec else None for spec in specs)


@pytest.mark.parametrize("size", ["full", "reduced"])
@pytest.mark.parametrize("arch", list_archs())
def test_shard_dims_take_every_config_at_model_2(arch, size):
    """``shard_dims`` and ``init_shards`` take each of the eleven configs at
    model 2, at full width and ``reduced()``: every leaf's split the
    reference's ``pspec_for_axes`` on (data 2, model 2), the split check
    passed, every fused leaf's blocks split."""
    cfg = get_config(arch).reduced() if size == "reduced" else get_config(arch)
    mesh = meta_mesh(data=2, model=2)
    dims = shard_dims(cfg, mesh)
    assert dims == _reference_model_dims(arch, size == "reduced")
    local = init_shards(cfg, mesh, device="meta")
    assert local.shard_dims == dims and local.tp.axes
    for t, mine, dim, n in zip(GCLM(cfg, device="meta").leaves(), local.leaves(), dims,
                               local.shard_blocks):
        assert dim is not None or n == 1
        if dim is not None:
            assert mine.shape[dim] * 2 == t.shape[dim] and t.shape[dim] % (2 * n) == 0


@pytest.mark.parametrize("arch", ON_AXIS)
def test_init_shards_are_shard_model_s(arch):
    """Each rank's ``init_shards`` (drawn leaf by leaf, or read from a
    reference tree) is ``shard_model`` of the full initial module, byte
    for byte, with the same split."""
    cfg = _cfg(arch, TRAINERS.get(arch, GC["reduced"]))
    full = GCLM(cfg, device="cpu", seed=3)
    tree = full.tree([t.detach().numpy() for t in full.leaves()])
    for rank in range(4):
        mesh = meta_mesh(data=2, model=2, rank=rank)
        want = shard_model(full, mesh)
        for got in (init_shards(cfg, mesh, device="cpu", seed=3),
                    init_shards(cfg, mesh, device="cpu", params=tree)):
            assert got.tp == want.tp and got.shard_dims == want.shard_dims
            assert all(torch.equal(a, b) for a, b in zip(got.leaves(), want.leaves(),
                                                          strict=True))


# ----------------------------------------------------- collectives (2 ranks)
@pytest.fixture(scope="module")
def coll_run(tmp_path_factory):
    return dist_spawn.spawn(collectives_rank, 2, 0, timeout=LIMIT,
                            store_dir=str(tmp_path_factory.mktemp("coll")))


def test_f_and_g_are_the_one_process_products(coll_run):
    """y = g((f(x) @ A_r) @ B_r) over column shards of A and row shards
    of B is x @ A @ B on both ranks; backward, dx is the whole gradient
    (f's all-reduce), dA_r and dB_r the slices of the whole ones."""
    x, a, b, up = (t.clone().requires_grad_() for t in coll_run[0]["inputs"][:4])
    y = (x @ a) @ b
    gx, ga, gb = torch.autograd.grad((y * up.detach()).sum(), (x, a, b))
    for r, got in enumerate(coll_run):
        cols = slice(6 * r, 6 * (r + 1))
        torch.testing.assert_close(got["y"], y.detach(), rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got["gx"], gx, rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got["ga"], ga[:, cols], rtol=1e-6, atol=1e-5)
        torch.testing.assert_close(got["gb"], gb[cols], rtol=1e-6, atol=1e-5)
        assert torch.equal(got["top"], torch.maximum(x.detach()[..., 0], x.detach()[..., 1]))
        counts, nbytes = got["counts"]
        assert counts == {"copy": 1, "reduce": 1, "max": 1}
        assert nbytes["copy"] == x.numel() * 4 and nbytes["reduce"] == y.numel() * 4
        assert nbytes["max"] == x[..., 0].numel() * 4
    assert torch.equal(coll_run[0]["y"], coll_run[1]["y"])  # all-reduced: the same bytes


def test_vocab_parallel_embedding_head_and_loss(coll_run):
    """The embedding of the rank's rows summed over the group, the rank's
    logits and the vocab-parallel cross-entropy equal the whole
    vocabulary's (loss within 1e-6), with the gradients of the rank's
    rows and of the hidden states."""
    *_, tok, tokens, labels, h = coll_run[0]["inputs"]
    cfg = _cfg(GC["arch"], GC["reduced"])
    tok, h = tok.clone().requires_grad_(), h.clone().requires_grad_()
    emb = torch.nn.functional.embedding(tokens, tok)
    loss = _xent(torch.einsum("bsd,vd->bsv", h, tok), labels)
    g_tok, g_h = torch.autograd.grad(loss + (emb * h.detach()).sum(), (tok, h))
    n = cfg.vocab // 2
    for r, got in enumerate(coll_run):
        assert torch.equal(got["emb"], emb.detach())
        assert abs(float(got["loss"]) - loss.item()) <= 1e-6 * abs(loss.item())
        torch.testing.assert_close(got["g_tok"], g_tok[r * n:(r + 1) * n], rtol=1e-5,
                                   atol=1e-6)
        torch.testing.assert_close(got["g_h"], g_h, rtol=1e-5, atol=1e-6)


# ------------------------------------------------ against the reference
#: the reference's subprocesses: part -> fake host devices
JAX_PARTS = {"gc": 8, **dict.fromkeys(TRAINERS, 4)}


@pytest.fixture(scope="module")
def jax_proc(tmp_path_factory):
    """The reference, in JAX subprocesses side by side: gc-lm-110m on 8
    fake host devices, each trainer's config on 4.  Each writes its
    initial weights first and its outputs when it ends, while the port's
    jobs run."""
    d = tmp_path_factory.mktemp("jax")
    procs = {}
    for part, n_dev in JAX_PARTS.items():
        env = dict(os.environ, XLA_FLAGS=f"--xla_force_host_platform_device_count={n_dev}",
                   PYTHONPATH=os.path.join(ROOT, "src"))
        with open(d / f"{part}.stdout", "w") as out, open(d / f"{part}.stderr", "w") as err:
            procs[part] = subprocess.Popen(
                [sys.executable, "-c", JAX_SIDE, str(d / f"{part}.init.npz"),
                 str(d / f"{part}.ref.npz"), part], env=env, stdout=out, stderr=err)
    try:
        yield procs, d
    finally:
        for proc in procs.values():
            proc.kill()
            proc.wait()


@pytest.fixture(scope="module")
def init(jax_proc):
    procs, d = jax_proc
    deadline = time.monotonic() + LIMIT
    out = {}
    for part, proc in procs.items():
        while not (d / f"{part}.init.npz").exists():
            assert proc.poll() is None, (d / f"{part}.stderr").read_text()[-4000:]
            assert time.monotonic() < deadline, "the reference wrote no weights in time"
            time.sleep(0.2)
        with np.load(d / f"{part}.init.npz") as blob:
            archs = {k.split("/")[1] for k in blob}
            out.update({arch: _leaves(blob, f"init/{arch}") for arch in archs})
    assert set(out) == {"gc-lm-110m", *TRAINERS}
    return out


@pytest.fixture(scope="module")
def jax_ref(jax_proc):
    procs, d = jax_proc
    out = {}
    for part, proc in procs.items():
        assert proc.wait(timeout=2 * LIMIT) == 0, (d / f"{part}.stderr").read_text()[-4000:]
        assert (d / f"{part}.stdout").read_text().split()[-1] == str(JAX_PARTS[part])
        with np.load(d / f"{part}.ref.npz") as blob:
            out.update(blob)
    return out


def _inputs(arch, reduced, tree, n_workers):
    """The port's full model on the reference's weights, its plan, the
    step-0 tokens and every straggler count's decode weights."""
    cfg = _cfg(arch, reduced)
    model = params_from_numpy(GCLM(cfg, device="cpu"), tree)
    plan = Plan.build(model, SE, n_workers, scheme="xf")
    data = SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=SEQ, global_batch=8))
    wb = coded_worker_batches(data, 0, n_workers, plan.s_max)
    shards = np.stack([data.shard(0, i, n_workers) for i in range(n_workers)])
    return cfg, model, plan, wb, _dec_ws(plan, n_workers), shards


def _tree(arch, reduced, leaves):
    return GCLM(_cfg(arch, reduced), device="meta").tree(leaves)


@pytest.fixture(scope="module")
def gc_run(init, tmp_path_factory):
    """The 8-rank job: (data 4, model 2), reduced gc-lm-110m."""
    d = tmp_path_factory.mktemp("gc")
    tree = _tree(GC["arch"], GC["reduced"], init["gc-lm-110m"])
    cfg, _, plan, wb, dec_ws, shards = _inputs(GC["arch"], GC["reduced"], tree, GC["data"])
    torch.save(dict(arch=GC["arch"], reduced=GC["reduced"], tree=tree,
                    mesh=dict(data=GC["data"], model=GC["model"]), wb=wb, dec_w=dec_ws,
                    variants=VARIANTS, shards=shards, batch=_uncoded_batch(cfg)),
               d / "inputs.pt")
    return dist_spawn.spawn(coded_grads_rank, GC["data"] * GC["model"], str(d / "inputs.pt"),
                            store_dir=str(d / "spawn"), timeout=LIMIT)


@pytest.fixture(scope="module")
def gc_port(init):
    """The port's one-process sim-mode rows and the contributions' scales."""
    tree = _tree(GC["arch"], GC["reduced"], init["gc-lm-110m"])
    cfg, model, plan, wb, dec_ws, shards = _inputs(GC["arch"], GC["reduced"], tree, GC["data"])
    rows = per_shard_grad_rows(cfg, model, wb)
    n, k = plan.n_workers, plan.k_shards
    scales = []
    for dec_w in dec_ws:
        out = []
        for j, g in enumerate(rows):
            li = plan.flat_layout.leaf_level[j]
            total = sum((float(dec_w[li, w]) / n * torch.as_tensor(plan.b_rows[w, li],
                                                                   dtype=torch.float32)
                         @ g[w * k:(w + 1) * k]).abs() for w in range(n))
            out.append(float(total.max()))
        scales.append(out)
    sim = make_coded_grad_fn(cfg, plan, mode="sim", pipeline="flat")
    return dict(plan=plan, scales=scales, sim=[[t.numpy() for t in sim.combine(rows, d)]
                                               for d in dec_ws])


# ----------------------------------------------- gemma-2b and qwen1.5 (2 x 2)
@pytest.fixture(scope="module")
def trainer_run(init, tmp_path_factory):
    d = tmp_path_factory.mktemp("trainers")
    blobs = {}
    for arch, reduced in TRAINERS.items():
        tree = _tree(arch, reduced, init[arch])
        _, _, _, wb, dec_ws, _ = _inputs(arch, reduced, tree, 2)
        blobs[arch] = dict(arch=arch, reduced=reduced, tree=tree, mesh=dict(data=2, model=2),
                           wb=wb, dec_w=dec_ws)
    torch.save(blobs, d / "inputs.pt")
    return dist_spawn.spawn(trainer_rank, 4, str(d / "inputs.pt"), store_dir=str(d / "spawn"),
                            timeout=LIMIT)


@pytest.fixture(scope="module", autouse=True)
def start_the_reference(jax_proc):
    """The reference's subprocesses start with the module's first test, so
    the port's tests and jobs run while it computes."""
    yield


def test_model_axis_uncoded_grads(gc_run, init):
    tree = _tree(GC["arch"], GC["reduced"], init["gc-lm-110m"])
    cfg, model, _, _, _, shards = _inputs(GC["arch"], GC["reduced"], tree, GC["data"])
    from repro_torch.train.coded import uncoded_grad_fn
    want = [t.numpy() for t in uncoded_grad_fn(cfg, GC["data"])(model, shards)]
    assert _worst(gc_run[0]["uncoded"], want, 1e-5) <= 1


def _uncoded_batch(cfg):
    return SyntheticTokens(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=8)).batch(0)


def test_model_axis_uncoded_step(gc_run, init):
    """``make_train_step`` on (data 4, model 2): each data index's rows,
    the sum over the data group; the one-process step on the whole batch
    (loss and the clip's norm 1e-5; parameters 2e-5: the first AdamW step
    moves each weight by lr · g / (|g| + eps), so a last-bit difference
    in a near-zero gradient entry moves its update visibly — 5.36e-6 in
    one of wi's 131,072 entries here — as ``PARAM_ATOL`` says)."""
    tree = _tree(GC["arch"], GC["reduced"], init["gc-lm-110m"])
    cfg = _cfg(GC["arch"], GC["reduced"])
    state = init_train_state(cfg, device="cpu", params=tree)
    state, metrics = make_train_step(cfg, TrainConfig(warmup=0, total_steps=10))(
        state, {"tokens": _uncoded_batch(cfg)})
    got = gc_run[0]["step"]
    for key in ("loss", "xent", "grad_norm"):
        np.testing.assert_allclose(got["metrics"][key], float(metrics[key]), rtol=1e-5)
    for a, b in zip(got["params"], state.params.leaves(), strict=True):
        np.testing.assert_allclose(a, b.detach().numpy(), rtol=0, atol=2e-5)
    assert all(r["step"]["metrics"] == got["metrics"] for r in gc_run)


def test_model_axis_bytes_and_counts(gc_run, gc_port):
    """Ranks lie as ``jax.make_mesh((4, 2))`` lays devices out; the data
    ranks of a model index return the same bytes, every rank's replicated
    leaves the same bytes; one grouped call over the 11 local leaves and
    one collective per level (two for psum_scatter), one per leaf for the
    tree."""
    layout = gc_port["plan"].flat_layout
    n_lv, n_leaves = layout.n_levels, layout.n_leaves
    assert [r["coords"] for r in gc_run] == [(0, d, m) for d in range(4) for m in range(2)]
    assert all(r["shard_dims"] == gc_run[0]["shard_dims"] for r in gc_run)
    want = {"flat": ([n_leaves], dict(psum=n_lv)), "flat_bf16": ([n_leaves], dict(psum=n_lv)),
            "flat_scatter": ([n_leaves], dict(psum_scatter=n_lv, all_gather=n_lv)),
            "tree": ([], dict(psum=n_leaves))}
    for key in gc_run[0]["digests"]:
        for m in range(2):
            assert len({r["digests"][key] for r in gc_run[m::2]}) == 1, key
        assert gc_run[0]["digests"][key] != gc_run[1]["digests"][key]  # other shards
        assert len({r["replicated"][key] for r in gc_run}) == 1, key
    for rank in gc_run:
        for (name, u), (calls, counts) in rank["counts"].items():
            assert calls == want[name][0], (name, u)
            assert counts == dict(dict.fromkeys(counts, 0), **want[name][1]), (name, u)


@pytest.mark.parametrize("arch", list(TRAINERS))
def test_model_axis_trainer_keeps_its_replicas(trainer_run, arch):
    """After every one of three steps on (data 2, model 2): the data ranks
    of a model index hold the same bytes, every rank the same replicated
    leaves, and every rank the same history."""
    ranks = [r[arch] for r in trainer_run]
    assert [r["coords"] for r in ranks] == [(0, d, m) for d in range(2) for m in range(2)]
    for m in range(2):
        assert ranks[m]["digests"] == ranks[m + 2]["digests"]
    assert ranks[0]["digests"] != ranks[1]["digests"]
    assert all(r["replicated"] == ranks[0]["replicated"] for r in ranks)
    assert all(r["history"] == ranks[0]["history"] for r in ranks)


def test_launcher_model_par_under_torchrun_trains_and_prints_once():
    """``--data-par 2 --model-par 2``: four ranks, two workers of two
    tensor-parallel ranks each; rank 0 alone prints."""
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", "repro_torch.launch.train", "--reduced", "--steps", "2", "--seq", "32",
           "--global-batch", "8", "--workers", "2", "--data-par", "2", "--model-par", "2",
           "--device", "cpu", "--backend", "gloo", "--log-every", "1"]
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=LIMIT)
    assert res.returncode == 0, res.stderr[-4000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1].startswith("simulated runtime: {'steps': 2")
    assert sum("mode=spmd model_par=2" in ln for ln in lines) == 1
    assert sum(ln.startswith("step") for ln in lines) == 2


# ------------------------------------------------ against the reference's outputs
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_model_axis_grads_match_jax_spmd(gc_run, gc_port, jax_ref, variant):
    rank0 = gc_run[0]
    for u in range(gc_port["plan"].s_max + 1):
        got = rank0["grads"][variant, u]
        if variant == "flat_bf16":
            want = _leaves(jax_ref, f"gc-lm-110m/sim_bf16/{u}")
            assert _worst(got, want, 2.0 ** -7, gc_port["scales"][u]) <= 1, u
            continue
        assert _worst(got, _leaves(jax_ref, f"gc-lm-110m/{variant}/{u}"), 1e-5) <= 1, u
        assert _worst(got, gc_port["sim"][u], 1e-5) <= 1, u            # == port sim mode


@pytest.mark.parametrize("arch", list(TRAINERS))
def test_replicated_kv_and_mlp_grads_match_jax_spmd(trainer_run, jax_ref, arch):
    """gemma-2b's one KV head and qwen's MLP stay whole, gemma3's QK-norm
    scales too; gemma2's and gemma3's windowed layers run on split heads."""
    got = trainer_run[0][arch]
    paths = GCLM(_cfg(arch, TRAINERS[arch]), device="meta").leaf_paths()
    whole = {p for p, d in zip(paths, got["shard_dims"]) if d is None}
    assert {p for p in whole if not p.endswith(".scale")} == REPLICATED[arch]
    for u, g in enumerate(got["grads"]):
        assert _worst(g, _leaves(jax_ref, f"{arch}/flat/{u}"), 1e-5) <= 1, u


@pytest.mark.parametrize("arch", list(TRAINERS))
def test_model_axis_trainer_matches_jax_spmd_trainer(trainer_run, jax_ref, arch):
    """Three steps on (data 2, model 2): the reference's losses within
    1e-5 and parameters within ``PARAM_ATOL``."""
    got = trainer_run[0][arch]
    hist = got["history"]
    assert [h["step"] for h in hist] == jax_ref[f"{arch}/trainer/step"].tolist() == [1, 2, 3]
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose([h[key] for h in hist], jax_ref[f"{arch}/trainer/{key}"],
                                   rtol=1e-5)
    np.testing.assert_allclose([h["lr"] for h in hist], jax_ref[f"{arch}/trainer/lr"],
                               rtol=1e-6)
    for a, b in zip(got["params"], _leaves(jax_ref, f"{arch}/trainer/params"), strict=True):
        np.testing.assert_allclose(a, b, rtol=0, atol=PARAM_ATOL[arch])
