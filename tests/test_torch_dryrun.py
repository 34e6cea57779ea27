"""The port's dry run (``launch/dryrun.py``) and its memory analysis
(``tune.memory.analyze_memory``) against the reference: parameter counts
at full size, the skips, a reduced step's argument and output bytes
against ``analyze_memory_from_hlo``, the spmd coded step's collectives
on a meta mesh, and the full-width xLSTM and Jamba training dry runs
within their time (the trip-count shortcut)."""
import json

import jax
import jax.numpy as jnp
import pytest
import torch

from repro.configs import INPUT_SHAPES as J_SHAPES
from repro.configs import get_config as jax_get_config
from repro.configs import shape_supported as j_supported
from repro.models.params import count_params as j_count_params
from repro.train.state import abstract_train_state as j_abstract_state
from repro.train.trainer import TrainConfig as JTrainConfig
from repro.train.trainer import make_train_step as j_make_train_step
from repro.tune.memory import analyze_memory_from_hlo
from repro_torch.configs import INPUT_SHAPES, InputShape, get_config, list_archs
from repro_torch.dist.mesh import meta_mesh
from repro_torch.launch import dryrun
from repro_torch.launch.op_analysis import analyze_ops
from repro_torch.models.params import data_dims
from repro_torch.train.state import abstract_train_state
from repro_torch.train.trainer import TrainConfig, make_train_step
from repro_torch.tune import analyze_memory


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", list_archs())
def test_params_b_equals_the_references_at_full_size(arch):
    _, _, extra = dryrun.build_case(get_config(arch), INPUT_SHAPES["decode_32k"],
                                    meta_mesh(16), coded=False)
    state, _ = j_abstract_state(jax_get_config(arch))
    assert extra["params_b"] == j_count_params(state.params)


@pytest.mark.parametrize("arch", [a for a in list_archs()
                                  if not j_supported(jax_get_config(a),
                                                     J_SHAPES["long_500k"])[0]])
def test_skip_records_equal_the_references(arch, tmp_path):
    rec = dryrun.run_case(arch, "long_500k", "single", coded=False, out_dir=str(tmp_path))
    ok, why = j_supported(jax_get_config(arch), J_SHAPES["long_500k"])
    assert (rec["status"], rec["reason"], rec["step"]) == ("skip", why, "serve")
    path = tmp_path / f"{arch}__long_500k__single__serve.json"
    assert json.loads(path.read_text()) == rec


B, S = 8, 128


@pytest.fixture(scope="module")
def reference_memory():
    """The reference's ``analyze_memory_from_hlo`` of its uncoded step on
    reduced gc-lm-110m at (B, S+1) int32 tokens."""
    cfg = jax_get_config("gc-lm-110m").reduced()
    state, _ = j_abstract_state(cfg)
    batch = {"tokens": jax.ShapeDtypeStruct((B, S + 1), jnp.int32)}
    text = jax.jit(j_make_train_step(cfg, JTrainConfig())).lower(state, batch) \
        .compile().as_text()
    return analyze_memory_from_hlo(text)


def test_step_memory_equals_the_references(reference_memory):
    """The same state (params, two fp32 moments, int32 count and step):
    argument bytes equal the reference's plus 4 bytes per token (int64
    tokens); output bytes differ by at most the scalar metrics."""
    cfg = get_config("gc-lm-110m").reduced()
    tokens = torch.empty((B, S + 1), dtype=torch.int64, device="meta")
    mem = analyze_memory(make_train_step(cfg, TrainConfig()), abstract_train_state(cfg),
                         {"tokens": tokens}, device="meta")
    assert mem["argument_bytes"] == reference_memory["argument_bytes"] + 4 * B * (S + 1)
    assert abs(mem["output_bytes"] - reference_memory["output_bytes"]) <= 5 * 4
    assert mem["total_bytes"] == mem["argument_bytes"] + mem["output_bytes"]
    assert set(mem) == {"argument_bytes", "output_bytes", "total_bytes"}  # no peak on meta


def test_analyze_memory_on_the_cpu_runs_the_step():
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    from repro_torch.train.state import init_train_state

    state = init_train_state(cfg, device="cpu", seed=0)
    before = state.opt["m"][0].clone()
    tokens = torch.zeros((2, 17), dtype=torch.int64)
    mem = analyze_memory(make_train_step(cfg, TrainConfig()), state, {"tokens": tokens},
                         device="cpu")
    assert not torch.equal(before, state.opt["m"][0])  # the step ran, in place
    assert mem["argument_bytes"] == mem["output_bytes"] - 5 * 4 + tokens.numel() * 8
    assert "peak_bytes" not in mem


@pytest.mark.parametrize("reduce_mode", ["psum", "psum_scatter"])
@pytest.mark.parametrize("pod", [1, 2])
def test_spmd_coded_collectives_follow_the_plans_levels(reduce_mode, pod):
    """One rank of a (pod, data=4) meta mesh: one collective per level
    buffer and phase — a psum over the pod ranks, then a psum, or a
    reduce-scatter and an all-gather, over the data ranks — each of the
    level's fp32 bytes (a reduce-scatter's tile is a quarter)."""
    cfg = get_config("gc-lm-110m").reduced()
    fn, args, extra = dryrun.build_case(cfg, InputShape("t", 16, 8, "train"),
                                        meta_mesh(data=4, pod=pod), coded=True,
                                        coded_opts={"reduce_mode": reduce_mode})
    cost = analyze_ops(fn, *args)
    plan = dryrun.Plan.build(abstract_train_state(cfg).params,
                             dryrun.ShiftedExponential(mu=1e-3, t0=50.0), 4, scheme="xf")
    sizes = plan.flat_layout.level_sizes
    assert len(sizes) == extra["n_levels"] and plan.s_max == extra["s_max"]
    level_bytes = 4 * sum(sizes)
    psums = (reduce_mode == "psum") + (pod > 1)
    counts, nbytes = cost.collective_counts, cost.collective_bytes
    assert counts["all-reduce"] == psums * len(sizes)
    assert nbytes["all-reduce"] == psums * level_bytes
    scatter = reduce_mode == "psum_scatter"
    assert counts["reduce-scatter"] == counts["all-gather"] == scatter * len(sizes)
    assert nbytes["reduce-scatter"] == scatter * level_bytes / 4
    assert nbytes["all-gather"] == scatter * level_bytes
    assert cost.kernel_calls == {"gc_fused": 1}
    assert 1 + extra["s_max"] in cost.loop_trips  # the rank's K passes


@pytest.mark.parametrize("mesh_shape", [(16, 1), (16, 16)], ids=["16x1", "16x16"])
@pytest.mark.parametrize("arch", ["xlstm-1.3b", "jamba-v0.1-52b"])
def test_full_width_training_dry_run_within_its_time(arch, mesh_shape, tmp_path):
    """The sLSTM's 4,096 tokens and the Mamba and mLSTM chunks run three
    trips each on meta: the full-width train_4k dry run ends in under
    30 s here, on the data axes alone (one all-reduce of the gradients;
    Jamba sets ``fsdp``, so its rank also all-gathers each leaf the data
    axis cuts and adds up the clip's squares over the data group) and on
    the reference's (16, 16), where the rank holds its shards and
    reduces over the model group too (xLSTM's 4 heads whole on the ranks
    of their channels: its mLSTM layers reduce-scatter)."""
    rec = dryrun.run_case(arch, "train_4k", "single", coded=False, out_dir=str(tmp_path),
                          mesh_shape=mesh_shape)
    assert rec["status"] == "ok", rec.get("error")
    assert rec["trace_s"] < 30.0
    assert 4096 in rec["loop_trips"] or arch != "xlstm-1.3b"
    if mesh_shape == (16, 1):
        cut = sum(d is not None for d in data_dims(get_config(arch), meta_mesh(16)))
        assert (cut > 0) == get_config(arch).fsdp
        assert rec["collectives"]["all-reduce"]["count"] == 1 + (cut > 0)
        assert rec["collectives"]["all-gather"]["count"] == cut
        assert (rec["local_params"] == rec["params_b"]) == (cut == 0)
    else:
        assert rec["collectives"]["all-reduce"]["count"] > 1
        assert rec["local_params"] < rec["params_b"]
        scatters = rec["collectives"]["reduce-scatter"]["count"]
        assert scatters == (42 if arch == "xlstm-1.3b" else 0)  # 42 mLSTM layers
    assert (rec["n_chips"], rec["mesh_shape"]) == (16 * mesh_shape[1], list(mesh_shape))
    assert rec["compute_s"] > 0 and rec["memory_s"] > 0 and rec["collective_s"] > 0
    assert rec["memory"]["argument_bytes"] > 12 * rec["local_params"]  # state + tokens


def test_cli_writes_records(tmp_path, capsys):
    rc = dryrun.main(["--arch", "whisper-base", "--shape", "decode_32k", "--mesh", "both",
                      "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert rc == 0 and "done: 2 ok, 0 skip, 0 fail" in out
    recs = [json.loads(p.read_text()) for p in sorted(tmp_path.glob("*.json"))]
    assert [(r["mesh"], r["n_chips"], r["rows"]) for r in recs] == [("multi", 512, 4),
                                                                     ("single", 256, 8)]
    for r in recs:
        assert r["per_device_flops"] > 0 and r["memory"]["argument_bytes"] > 0
