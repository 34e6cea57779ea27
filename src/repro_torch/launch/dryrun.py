"""Dry run: price every (arch x input shape x mesh) on the meta device —
FLOPs, bytes, collectives, argument and output memory and the three
roofline terms — after ``repro/launch/dryrun.py``.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both] [--coded]
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh-shape 16x1  # data only
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gc-lm-110m --measure  # a card

Each case runs the port's step once, at full width, on meta tensors
(``launch/specs.py``) under the op counter (``launch/op_analysis.py``):
nothing is allocated and nothing is computed, so it needs no card, as
the reference lowers on placeholder devices.  The meshes are the
reference's: ``single`` is (data 16, model 16) on 256 chips, ``multi``
(pod 2, data 16, model 16) on 512; ``--mesh-shape DxM`` replaces the
per-pod (data, model), as the reference's does (``16x1``: the data
axes alone).  The figures are one rank's (``dist.mesh.meta_mesh``, rank
0): on a ``model`` axis the rank holds its shards of the parameters and
of the two moments (``models.params.init_shards``: the reference's rule
splits a leaf only where ``model`` divides it), its KV heads' and
states' caches, and every step reduces over the model group as well.
Where the config sets ``fsdp``, the rank's parameters and moments are
also cut over ``data`` on their ``embed`` dimension wherever ``data``
divides it (the reference's ``state_shardings``: every record's
arguments), and each step first all-gathers the cut leaves over the
data group into the working module (``models.params.gather_data``):

* ``train``: ``make_train_step`` over the mesh — the rank's rows of the
  global batch, then one all-reduce of the gradients over the data
  ranks (and the pod ranks);
* ``train_coded``: ``make_coded_train_step(mode="spmd")`` — the rank's
  K = s_max + 1 per-shard passes, the combine into the level buffers
  (one ``gc_fused`` launch on a card) and the per-level collectives, on
  the ``xf`` plan of ``ShiftedExponential(mu=1e-3, t0=50)`` over N =
  ``data`` workers, bound to the full tree as ``Trainer`` binds it;
* ``prefill``: ``models.model.prefill`` of the rank's rows,
  ceil(B / (data · pod)) — the model ranks of a replica read the same
  rows;
* ``serve``: one ``make_serve_step`` decode step of the rank's rows
  against caches of capacity S (bf16) — never the engine loop, which
  reads tokens back to the host.

A modality input (vision patches, encoder frames) is whole on every
model rank, as cross-attention's source is.

A record keeps the reference's keys where they mean something here:
``status`` (``ok``, ``skip`` with ``reason`` — the reference's
``shape_supported`` skips — or ``fail`` with ``error``), ``params_b``
(the full parameter count), ``n_chips`` (the mesh's ranks),
``mesh_shape``, ``s_max``/``n_levels``/``x`` (coded),
``per_device_flops``, ``per_device_bytes`` (operands plus outputs of
every eager op: above XLA's fused figure), ``collectives``,
``collective_bytes`` (over the data, pod and model groups alike),
``loop_trips`` (for ``while_trips``), ``memory`` (the rank's argument
and output bytes) and ``compute_s`` (each dtype's FLOPs over its peak),
``memory_s`` and ``collective_s`` by ``launch.mesh.HW`` (the H100 data
sheet's figures; every collective at one link's rate, ``HW.ICI_BW``,
though a model group of 16 spans two 8-card hosts).  ``local_params``
is the rank's parameter count.  ``trace_s`` replaces ``lower_s`` and
``compile_s``.  ``--measure`` runs each case that fits on the card once
more, as rank 0 of a solo mesh (``dist.mesh.solo_mesh``: every group's
collectives return this rank's own data in the mesh's shapes, so the
peak is one rank's without its peers' traffic and the values are not
the mesh's; the record says ``"groups": "solo"``), through
``tune.memory.analyze_memory``, adding ``memory.peak_bytes`` and
``memory.temp_bytes``; a case that does not fit records that.

Artifacts: one JSON per case under ``--out`` (default
``artifacts/dryrun_torch/``, apart from the reference's
``artifacts/dryrun/``).
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import numpy as np
import torch

from ..configs import INPUT_SHAPES, get_config, list_archs, shape_supported
from ..core import Plan, ShiftedExponential
from ..dist.mesh import Mesh, meta_mesh, solo_mesh
from ..models.model import prefill
from ..models.params import GCLM, count_params, gather_data
from ..serve.engine import make_serve_step
from ..train.state import init_train_state
from ..train.trainer import TrainConfig, make_coded_train_step, make_train_step
from ..tune.memory import analyze_memory, tree_bytes
from .mesh import HW
from .op_analysis import COLLECTIVES, analyze_ops
from .specs import input_specs, step_kind

__all__ = ["build_case", "run_case", "roofline", "main"]

MESHES = {"single": (16, 1, 16), "multi": (16, 2, 16)}  # (data, pod, model)
_LOW_PRECISION = ("bfloat16", "float16")


def roofline(cost) -> dict:
    """The three roofline terms of an ``OpCost`` on ``HW``: each dtype's
    FLOPs over its peak (bf16/fp16 on the tensor cores, every other
    dtype at the fp32 peak), bytes over HBM, collective bytes over the
    interconnect."""
    compute = sum(f / (HW.PEAK_FLOPS_BF16 if d in _LOW_PRECISION else HW.PEAK_FLOPS_FP32)
                  for d, f in cost.flops_by_dtype.items())
    return {"compute_s": compute, "memory_s": cost.bytes / HW.HBM_BW,
            "collective_s": cost.total_collective_bytes / HW.ICI_BW}


def _materialize(obj, device, gen):
    """A real copy of a tree of meta specs on ``device``: integer leaves
    (tokens, cache positions) drawn below 2 (any vocab and cache take
    them), float leaves normal."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "meta":
            return obj
        if obj.dtype.is_floating_point:
            return torch.randn(obj.shape, generator=gen, device=device).to(obj.dtype)
        return torch.randint(0, 2, obj.shape, generator=gen, device=device, dtype=obj.dtype)
    if isinstance(obj, dict):
        return {k: _materialize(v, device, gen) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_materialize(v, device, gen) for v in obj)
    return obj


def build_case(cfg, shape, mesh: Mesh, *, coded: bool, coded_opts: dict = None,
               device="meta"):
    """Returns (fn, args tuple, extra record fields) for one case on
    ``mesh``'s rank; the state lives on ``device`` (meta, or the card
    for a measured run) — on a ``model`` axis, or cut over ``data`` by
    the ``fsdp`` rule, the rank's shards and moments of their shapes —
    and the data inputs are meta specs (materialized by the caller for a
    measured run)."""
    state = init_train_state(cfg, device=device, seed=0, mesh=mesh)
    sharded = state.params.tp is not None or state.params.fsdp is not None
    full = GCLM(cfg, device="meta") if sharded else state.params
    extra = {"params_b": count_params(full), "local_params": count_params(state.params)}
    if shape.kind == "train" and coded:
        opts = dict(coded_opts or {})
        plan = Plan.build(full, ShiftedExponential(mu=1e-3, t0=50.0), mesh.data,
                          scheme="xf", s_cap=opts.pop("s_cap", None))
        extra.update(s_max=plan.s_max, n_levels=len(plan.used_levels),
                     x=[int(v) for v in plan.x])
        specs, _ = input_specs(cfg, shape, coded=True, n_workers=mesh.data,
                               s_max=plan.s_max)
        dec_w = plan.decode_weights(np.arange(mesh.data, dtype=np.float64)).astype(np.float32)
        if opts.get("grad_dtype") == "bf16":
            opts["grad_dtype"] = torch.bfloat16
        step = make_coded_train_step(cfg, TrainConfig(), plan, mode="spmd", mesh=mesh,
                                     **opts)
        args = [state, specs["worker_batches"], dec_w]
        if "aux_inputs" in specs:
            aux = specs["aux_inputs"]
            k, rows = plan.s_max + 1, shape.global_batch // mesh.data
            args.append(torch.empty((mesh.data, k, rows) + tuple(aux.shape[1:]),
                                    dtype=aux.dtype, device="meta"))
        return step, tuple(args), extra

    if shape.kind == "train":
        specs, _ = input_specs(cfg, shape)
        return make_train_step(cfg, TrainConfig(), mesh=mesh), (state, specs), extra

    rows = max(1, math.ceil(shape.global_batch / (mesh.data * mesh.pod)))
    extra["rows"] = rows
    local = type(shape)(shape.name, shape.seq_len, rows, shape.kind)
    specs, _ = input_specs(cfg, local, tp=state.params.tp)
    aux = specs.get("aux_inputs")
    if shape.kind == "prefill":
        def fn(params, tokens, aux_inputs=None):
            return prefill(cfg, gather_data(params), tokens, aux_inputs=aux_inputs,
                           target_len=shape.seq_len + 1)

        args = (state.params, specs["tokens"])
    else:
        serve = make_serve_step(cfg)

        def fn(params, caches, token, aux_inputs=None):
            return serve(gather_data(params), caches, token, aux_inputs=aux_inputs)

        args = (state.params, specs["caches"], specs["token"])
    return fn, args + (() if aux is None else (aux,)), extra


def _measure(cfg, shape, mesh_shape: tuple, coded: bool, coded_opts, arg_bytes: int) -> dict:
    """The case once on the card through ``analyze_memory``, as rank 0 of
    a solo mesh of ``mesh_shape`` (data, pod, model); or why not."""
    free, _ = torch.cuda.mem_get_info()
    if arg_bytes > free:
        return {"measured": "does not fit", "free_bytes": int(free), "groups": "solo"}
    data, pod, model = mesh_shape
    try:
        fn, args, _ = build_case(cfg, shape, solo_mesh(data, pod, model=model, device="cuda"),
                                 coded=coded, coded_opts=dict(coded_opts or {}),
                                 device="cuda")
        args = _materialize(args, "cuda", torch.Generator(device="cuda").manual_seed(0))
        mem = analyze_memory(fn, *args, device="cuda")
        return {"measured": "ok", "groups": "solo", "peak_bytes": mem["peak_bytes"],
                "temp_bytes": mem["temp_bytes"],
                "measured_argument_bytes": mem["argument_bytes"]}
    except torch.cuda.OutOfMemoryError as e:
        return {"measured": "does not fit", "groups": "solo", "error": str(e)[:300]}
    finally:
        torch.cuda.empty_cache()


def run_case(arch: str, shape_name: str, mesh_kind: str, *, coded: bool, out_dir: str,
             skip_existing: bool = True, mesh_shape: tuple = None, tag: str = "",
             cfg_overrides: dict = None, coded_opts: dict = None, measure: bool = False,
             cfg=None) -> dict:
    """One case's record, written to ``out_dir`` (and read back from
    there when ``skip_existing`` and it exists).  ``mesh_shape`` = (data,
    model) per pod replaces the reference's (16, 16); ``cfg`` replaces
    the registry's config of ``arch`` (a reduced one, in tests)."""
    shape = INPUT_SHAPES[shape_name]
    step_tag = "train_coded" if coded else step_kind(shape)
    name = f"{arch}__{shape_name}__{mesh_kind}__{step_tag}".replace("/", "_")
    if tag:
        name += f"__{tag}"
    path = os.path.join(out_dir, name + ".json")
    if skip_existing and os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    cfg = cfg if cfg is not None else get_config(arch)
    if cfg_overrides:
        cfg = cfg.replace(**cfg_overrides)
    ok, why = shape_supported(cfg, shape)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh_kind, "step": step_tag,
           "status": "skip", "reason": why, "tag": tag}
    if not ok:
        _dump(path, rec)
        return rec
    data, pod, model = MESHES[mesh_kind]
    if mesh_shape is not None:
        data, model = (int(v) for v in mesh_shape)
    try:
        fn, args, extra = build_case(cfg, shape, meta_mesh(data, pod, model=model),
                                     coded=coded, coded_opts=dict(coded_opts or {}))
        t0 = time.perf_counter()
        cost = analyze_ops(fn, *args, device="meta")
        trace_s = time.perf_counter() - t0
        arg_b, out_b = tree_bytes(args), tree_bytes(cost.output)
        rec.update(
            status="ok", n_chips=data * pod * model,
            mesh_shape=([pod] if pod > 1 else []) + [data, model], trace_s=round(trace_s, 2),
            per_device_flops=cost.flops, per_device_bytes=cost.bytes,
            transcendentals=cost.transcendentals, flops_by_dtype=cost.flops_by_dtype,
            kernel_calls=cost.kernel_calls,
            collectives={k: {"bytes": cost.collective_bytes[k],
                             "count": cost.collective_counts[k]} for k in COLLECTIVES},
            collective_bytes=cost.total_collective_bytes, loop_trips=cost.loop_trips,
            memory={"argument_bytes": arg_b, "output_bytes": out_b,
                    "total_bytes": arg_b + out_b},
            **roofline(cost), **extra)
        if cost.unpriced:
            rec["unpriced"] = cost.unpriced
        if measure:
            rec["memory"].update(_measure(cfg, shape, (data, pod, model), coded, coded_opts,
                                          arg_b))
    except Exception as e:  # noqa: BLE001 — record the failure, keep sweeping
        rec.update(status="fail", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-4000:])
    _dump(path, rec)
    return rec


def _dump(path, rec):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=2, default=str)


def _overrides(pairs) -> dict:
    out = {}
    for kv in pairs:
        k, v = kv.split("=", 1)
        for cast in (int, float):
            try:
                v = cast(v)
                break
            except ValueError:
                continue
        if v in ("true", "false"):
            v = v == "true"
        out[k] = v
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES) + [None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--coded", action="store_true",
                    help="the coded train step (train shapes only)")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--no-skip", action="store_true")
    ap.add_argument("--tag", default="", help="artifact filename suffix for variants")
    ap.add_argument("--mesh-shape", default=None,
                    help="per-pod (data, model) in place of 16x16, e.g. '16x1' or '32x8'")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (e.g. remat=dots)")
    ap.add_argument("--coded-reduce", default="psum", choices=["psum", "psum_scatter"])
    ap.add_argument("--coded-bf16", action="store_true",
                    help="bf16 coded blocks before the reduction")
    ap.add_argument("--coded-scap", type=int, default=None,
                    help="cap the top redundancy level")
    ap.add_argument("--measure", action="store_true",
                    help="also run each case that fits once on the card (needs CUDA)")
    args = ap.parse_args(argv)

    overrides = _overrides(args.set)
    mesh_shape = None
    if args.mesh_shape:
        mesh_shape = tuple(int(v) for v in args.mesh_shape.lower().split("x"))
        if len(mesh_shape) != 2 or min(mesh_shape) < 1:
            ap.error(f"--mesh-shape {args.mesh_shape!r}: want DxM, e.g. 16x16")
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    archs = [a for a in archs if a != "gc-lm-110m" or args.arch == "gc-lm-110m"]
    shapes = list(INPUT_SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    coded_opts = None
    if args.coded:
        coded_opts = {"reduce_mode": args.coded_reduce}
        if args.coded_bf16:
            coded_opts["grad_dtype"] = "bf16"
        if args.coded_scap is not None:
            coded_opts["s_cap"] = args.coded_scap

    results = []
    for arch in archs:
        for shape in shapes:
            if args.coded and INPUT_SHAPES[shape].kind != "train":
                continue
            for mesh_kind in meshes:
                t0 = time.perf_counter()
                rec = run_case(arch, shape, mesh_kind, coded=args.coded, out_dir=args.out,
                               skip_existing=not args.no_skip, mesh_shape=mesh_shape,
                               tag=args.tag,
                               cfg_overrides=overrides or None, coded_opts=coded_opts,
                               measure=args.measure)
                msg = rec.get("reason") or rec.get("error", "")
                print(f"[{rec['status']:4s}] {arch:22s} {shape:12s} {mesh_kind:6s} "
                      f"{rec.get('step', '')} ({time.perf_counter() - t0:.0f}s) {msg[:120]}",
                      flush=True)
                results.append(rec)
    n_ok = sum(r["status"] == "ok" for r in results)
    n_skip = sum(r["status"] == "skip" for r in results)
    n_fail = sum(r["status"] == "fail" for r in results)
    print(f"done: {n_ok} ok, {n_skip} skip, {n_fail} fail")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
