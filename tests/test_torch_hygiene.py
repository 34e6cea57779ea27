"""Import hygiene and device policy of the PyTorch port.

The port imports ``torch``, ``numpy`` and ``scipy`` — never ``jax``,
``ml_dtypes`` or any module of the ``repro`` package (it keeps its own
copies) — and its entry points default to CUDA and raise without it
rather than fall back to the CPU.
"""
import ast
import importlib
import re
import inspect
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.checkpoint import load_coded_checkpoint
from repro_torch.configs import get_config, list_archs
from repro_torch.core import ShiftedExponential
from repro_torch.device import resolve_device
from repro_torch.models.params import GCLM
from repro_torch.train.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
#: ml_dtypes is JAX's dtype package; the GPU host does not have it
FORBIDDEN = ("jax", "jaxlib", "repro", "ml_dtypes")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_sources_import_no_jax_and_no_reference(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def _module_name(path: Path) -> str:
    parts = path.relative_to(ROOT / "src").with_suffix("").parts
    return ".".join(parts[:-1] if parts[-1] == "__init__" else parts)


def test_importing_the_port_loads_no_jax_and_no_reference():
    modules = sorted(_module_name(p) for p in (ROOT / "src" / "repro_torch").rglob("*.py"))
    code = (
        "import importlib, json, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_cuda_request_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    cfg = get_config("gc-lm-110m").reduced(n_layers=2, d_model=128)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        GCLM(cfg)  # the default device is CUDA
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, TrainConfig(), ShiftedExponential(), n_workers=4)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_coded_checkpoint("no-such-dir")  # the survivors' encode: CUDA
    assert resolve_device("cpu").type == "cpu"


def _is_cpu(value) -> bool:
    return (isinstance(value, str) and value.split(":")[0] == "cpu") or \
        (isinstance(value, torch.device) and value.type == "cpu")


def test_no_public_entry_defaults_to_the_cpu():
    """Every public function or class of the port that takes a device
    defaults to CUDA (or takes it from its inputs), never to the CPU."""
    seen = 0
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")):
        module = importlib.import_module(_module_name(path))
        for name in getattr(module, "__all__", ()):
            obj = getattr(module, name)
            if not callable(obj):
                continue
            try:
                params = inspect.signature(obj).parameters
            except (TypeError, ValueError):
                continue
            for p in params.values():
                if "device" in p.name and p.default is not p.empty:
                    seen += 1
                    assert not _is_cpu(p.default), \
                        f"{module.__name__}.{name}({p.name}={p.default!r})"
    assert seen >= 4  # GCLM, init_train_state, Trainer, load_coded_checkpoint


def test_tf32_is_off():
    import repro_torch.device  # noqa: F401

    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False


def test_chip_smoke_refuses_without_cuda():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")], env=env,
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


def test_the_port_registers_every_config_the_reference_registers():
    """The reference's registry, read from its config sources (this file
    imports nothing of the reference), equals the port's: eleven configs."""
    found = set()
    for path in (ROOT / "src" / "repro" / "configs").glob("*.py"):
        found |= set(re.findall(r'@register\("([^"]+)"\)', path.read_text()))
    assert len(found) == 11
    assert set(list_archs()) == found
