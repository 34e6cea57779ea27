"""The options a sharded state takes on the port's ``model`` axis, and
the launcher on the axis, on the CPU (the parity with the JAX reference:
``tests/test_torch_tp_state.py``).

* Checkpoints, the controller, the wave loop and the tuner — what the
  axis refused before — build a trainer on a (data 4, model 2) meta mesh:
  its shards' shapes, the full tree's plan.
* ``torchrun`` of ``repro_torch.launch.train`` on (data 2, model 2) with
  coded checkpoints and the controller, then with the tuner, resumes
  from its own checkpoint; rank 0 alone prints.
"""
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.adapt import AdaptConfig
from repro_torch.checkpoint import CkptConfig
from repro_torch.core import Env, Plan, ShiftedExponential
from repro_torch.dist.mesh import meta_mesh
from repro_torch.models.params import GCLM, shard_model
from repro_torch.train.trainer import TrainConfig, Trainer
from repro_torch.train.wave import WaveConfig

import torch_tp_state_ranks as R

pytestmark = pytest.mark.spmd

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 300.0


@pytest.mark.parametrize("option", ["ckpt", "adapt", "wave", "auto"])
def test_axis_trainer_takes_every_option_on_a_meta_mesh(option, tmp_path):
    """What the axis refused before — checkpoints, the controller, the
    wave loop, the tuner — builds a trainer on a (data 4, model 2) meta
    mesh: its shards' shapes, the full tree's plan."""
    kw = {"ckpt": dict(ckpt=CkptConfig(dir=str(tmp_path))), "adapt": dict(adapt=AdaptConfig()),
          "wave": dict(wave=WaveConfig()), "auto": dict(scheme="auto")}[option]
    cfg, mesh = R.cfg(), meta_mesh(data=4, model=2)
    tr = Trainer(cfg, TrainConfig(), Env.iid(ShiftedExponential(**R.SE), 4), device="meta",
                 mode="spmd", mesh=mesh, **kw)
    local = shard_model(GCLM(cfg, device="meta"), mesh)
    assert [t.shape for t in tr.state.params.leaves()] == [t.shape for t in local.leaves()]
    assert tr.plan.flat_layout.leaf_shapes == Plan.build(
        GCLM(cfg, device="meta"), tr.env, scheme=tr.plan.scheme).flat_layout.leaf_shapes
    if option == "adapt":
        assert all(t.device.type == "meta" for t in tr.controller.params_or_costs)
        assert [tuple(t.shape) for t in tr.controller.params_or_costs] == \
            [tuple(t.shape) for t in GCLM(cfg, device="meta").leaves()]


def test_launcher_resumes_on_the_axis(tmp_path):
    """``torchrun`` of the launcher on (data 2, model 2) with coded
    checkpoints and the controller, then again with the tuner: the
    second run resumes from the first's checkpoint; rank 0 alone prints."""
    base = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
            "4", "-m", "repro_torch.launch.train", "--reduced", "--seq", "16",
            "--global-batch", "8", "--workers", "2", "--data-par", "2", "--model-par", "2",
            "--device", "cpu", "--backend", "gloo", "--log-every", "1",
            "--ckpt", str(tmp_path / "ck"), "--ckpt-coded", "1", "--adapt"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    outs = []
    for extra in (["--steps", "2"], ["--steps", "3", "--autotune", "--hbm-gb", "64"]):
        res = subprocess.run(base + extra, env=env, capture_output=True, text=True,
                             timeout=LIMIT)
        assert res.returncode == 0, res.stderr[-4000:]
        outs.append(res.stdout.strip().splitlines())
    first, second = outs
    assert sum(ln.startswith("saved:") for ln in first) == 1
    assert not any("resumed" in ln for ln in first)
    assert sum(f"resumed from checkpoint step 2 under {tmp_path / 'ck'}" in ln
               for ln in second) == 1
    assert sum(ln.startswith("autotune:") for ln in second) == 1
    assert sum(ln.startswith("step") for ln in second) == 1          # step 3 alone
    assert sum(ln.startswith("adaptive: 0 plan swap(s)") for ln in second) == 1
    assert sum("model_par=2" in ln for ln in second) == 1
