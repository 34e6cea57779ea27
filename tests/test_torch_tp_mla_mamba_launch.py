"""The launchers on the ``model`` axis with MLA and Mamba, on the CPU:
``torchrun`` of ``repro_torch.launch.train`` trains reduced deepseek-v3-671b
(MLA and its multi-token prediction module) on (data 2, model 2), and of
``repro_torch.launch.serve`` serves reduced jamba-v0.1-52b (Mamba and the
MoE FFN) there, each printing one rank's lines.  The parity of both
families with the JAX reference: ``tests/test_torch_tp_mla.py`` and
``tests/test_torch_tp_mamba.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train

pytestmark = pytest.mark.spmd

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 300.0


def _torchrun(module: str, argv: list) -> list:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           "4", "-m", module, *argv, "--data-par", "2", "--model-par", "2", "--device", "cpu",
           "--backend", "gloo"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=LIMIT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()


def test_train_launcher_trains_deepseek_on_the_axis_and_prints_once(capsys):
    """Two spmd workers of two tensor-parallel ranks each train reduced
    DeepSeek-V3 — MLA's heads and the MTP module on the axis — for 2 steps;
    rank 0 alone prints, and its step lines are the one-process (sim
    mode) launcher's: the same simulated times, the losses to the last
    printed digit."""
    argv = ["--arch", "deepseek-v3-671b", "--reduced", "--steps", "2", "--seq", "32",
            "--global-batch", "8", "--workers", "2", "--log-every", "1"]
    launch_train.main([*argv, "--device", "cpu"])
    one = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("step")]
    lines = _torchrun("repro_torch.launch.train", argv)
    assert lines[-1].startswith("simulated runtime: {'steps': 2")
    assert sum("mode=spmd model_par=2" in ln for ln in lines) == 1
    steps = [ln for ln in lines if ln.startswith("step")]
    assert len(steps) == len(one) == 2
    loss = re.compile(r"loss ([0-9.]+)")
    for got, want in zip(steps, one):
        assert loss.sub("", got) == loss.sub("", want)
        assert abs(float(loss.search(got)[1]) - float(loss.search(want)[1])) <= 1e-4, (got, want)


def test_serve_launcher_serves_jamba_on_the_axis_as_one_rank(capsys):
    """Four ranks (data 2 × model 2) serving reduced Jamba — the Mamba
    channels and their state split, the experts by expert — print the
    one-rank launcher's lines, once."""
    argv = ["--arch", "jamba-v0.1-52b", "--reduced", "--stream", "8"]
    launch_serve.main([*argv, "--device", "cpu"])
    one = capsys.readouterr().out.strip().splitlines()
    four = _torchrun("repro_torch.launch.serve", argv)
    wall = re.compile(r" in [0-9.]+s wall \([0-9.]+ tok/s\)")
    assert len(four) == len(one) == 4
    assert [wall.sub("", ln) for ln in four] == [wall.sub("", ln) for ln in one]
    assert one[1].startswith("served 8 requests / ")
