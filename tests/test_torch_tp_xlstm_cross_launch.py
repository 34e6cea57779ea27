"""The serving launcher on the ``model`` axis with xLSTM and Whisper, on the
CPU: ``torchrun`` of ``repro_torch.launch.serve`` serves reduced xlstm-1.3b
(the mLSTM's heads and channels and their state split) on (data 2, model
2) through the engine, and reduced whisper-base (the encoder's and the
decoder's heads, the cross-attention over a source whole on every rank)
at model 2 through ``generate(aux_inputs=)``, each printing one rank's
lines, once.  The parity of both families with the JAX reference:
``tests/test_torch_tp_xlstm.py`` and ``tests/test_torch_tp_cross.py``."""
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from repro_torch.launch import serve as launch_serve

pytestmark = pytest.mark.spmd

ROOT = Path(__file__).resolve().parents[1]
LIMIT = 300.0


def _torchrun(argv: list, ranks: int) -> list:
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node",
           str(ranks), "-m", "repro_torch.launch.serve", *argv, "--device", "cpu", "--backend",
           "gloo"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    res = subprocess.run(cmd, env=env, capture_output=True, text=True, timeout=LIMIT)
    assert res.returncode == 0, res.stderr[-4000:]
    return res.stdout.strip().splitlines()


def test_serve_launcher_serves_xlstm_on_the_axis_as_one_rank(capsys):
    """Four ranks (data 2 × model 2) serving reduced xLSTM print the
    one-rank launcher's lines, once."""
    argv = ["--arch", "xlstm-1.3b", "--reduced", "--stream", "8"]
    launch_serve.main([*argv, "--device", "cpu"])
    one = capsys.readouterr().out.strip().splitlines()
    four = _torchrun([*argv, "--data-par", "2", "--model-par", "2"], 4)
    wall = re.compile(r" in [0-9.]+s wall \([0-9.]+ tok/s\)")
    assert len(four) == len(one) == 4
    assert [wall.sub("", ln) for ln in four] == [wall.sub("", ln) for ln in one]
    assert one[1].startswith("served 8 requests / ")


def test_serve_launcher_serves_whisper_on_the_axis_and_prints_once(capsys):
    """Two ranks at model 2 serving reduced Whisper in batch mode (frames
    drawn from the seed, ``generate(aux_inputs=)``): one line, the
    one-rank launcher's but for its time."""
    argv = ["--arch", "whisper-base", "--reduced"]
    launch_serve.main([*argv, "--device", "cpu"])
    one = capsys.readouterr().out.strip().splitlines()
    two = _torchrun([*argv, "--model-par", "2"], 2)
    timing = re.compile(r" in [0-9.]+s \([0-9.]+ tok/s\)")
    assert len(two) == len(one) == 1
    assert timing.sub("", two[0]) == timing.sub("", one[0]) == "whisper-base: (4, 80)"
