"""Build the port's CUDA sources into shared libraries, at first use.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface (no PyTorch headers, so a build
takes seconds) under ``build/repro_torch/`` at the repository root, a
directory ``.gitignore`` lists.  The library name carries a hash of the
source and the flags, so an edited source is rebuilt and a stale library
is never loaded.  The hash covers the source, every header of ``csrc/``
and the flags.  A failed build raises with the compiler's output.

``build_all`` starts one ``nvcc`` per source, all at once, so the build
time of a run is that of the slowest source.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from pathlib import Path

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "load_library", "build_all",
           "build_logs"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: compiler output (``-Xptxas -v`` register/shared-memory report) and
#: build seconds of every source built in this process, by source name.
_LOGS: dict = {}
_LIBS: dict = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME  # deferred: CUDA hosts only

    if CUDA_HOME is None:
        raise RuntimeError("cannot build CUDA kernels: no CUDA toolkit found "
                           "(set CUDA_HOME or put nvcc on PATH)")
    return str(Path(CUDA_HOME) / "bin" / "nvcc")


def _target(src: Path) -> Path:
    digest = hashlib.sha256(src.read_bytes())
    for header in sorted(src.parent.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{digest.hexdigest()[:16]}.so"


def _start(name: str):
    """Start compiling ``csrc/<name>.cu``; returns (target, process or None
    when the library is already built)."""
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(f"no CUDA source {src}")
    target = _target(src)
    if target.is_file():
        return target, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    return target, (proc, tmp, time.perf_counter())


def _finish(name: str, target: Path, pending) -> Path:
    if pending is None:
        _LOGS.setdefault(name, {"seconds": 0.0, "log": "(already built)"})
        return target
    proc, tmp, t0 = pending
    out, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)
    _LOGS[name] = {"seconds": seconds, "log": out}
    return target


def build_all() -> dict:
    """Compile every ``csrc/*.cu`` in parallel; returns {name: library path}."""
    names = sorted(p.stem for p in CSRC.glob("*.cu"))
    started = {n: _start(n) for n in names}
    return {n: _finish(n, *started[n]) for n in names}


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, building it if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        lib = _LIBS[name] = ctypes.CDLL(str(_finish(name, *_start(name))))
    return lib


def build_logs() -> dict:
    """{name: {"seconds", "log"}} of the builds made in this process."""
    return dict(_LOGS)
