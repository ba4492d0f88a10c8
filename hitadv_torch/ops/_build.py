"""Build the CUDA kernels of `ops/csrc/` at first use and load them.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` alone (plain C entry
points, no PyTorch headers) into its own shared library under
``ops/_build/`` and loaded with ``ctypes``. The library name carries a
hash of the source and the flags, so an edited source is rebuilt and a
stale library is never loaded. `build_all` starts one ``nvcc`` per
source, all at once, and waits for them together. The shared header
``csrc/common.cuh`` enters every library's hash, so editing it rebuilds
the sources that include it.

Every C entry point returns ``cudaGetLastError()`` after its launch;
`check` raises when that is not ``cudaSuccess``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"

SOURCES = ("max_linear_fwd", "max_linear_dh", "gather_rows", "knn", "nn",
           "fps", "scatter_add_rows", "graph_max_pool", "ball_query",
           "gather_group", "kde_density", "gaussian_blend",
           "gaussian_blend_fused")

FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-shared", "-Xcompiler", "-fPIC")
# kNN, FPS and the ball query select indices from distances: without
# contraction into FMAs every product and sum rounds as the plain PyTorch
# version's separate elementwise ops do, so both give the same bits and
# indices. (kde_density.cu, gaussian_blend.cu and gaussian_blend_fused.cu
# need no flag: they round each term's operations through the __f*_rn
# intrinsics, which are never contracted.)
EXTRA_FLAGS = {"knn": ("-fmad=false",), "nn": ("-fmad=false",),
               "fps": ("-fmad=false",), "ball_query": ("-fmad=false",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the PATH, else the
    toolkit's conventional install prefix."""
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        return str(Path(home) / "bin" / "nvcc")
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def _command(name: str, out: Path) -> list:
    return [nvcc_path(), *FLAGS, *EXTRA_FLAGS.get(name, ()),
            "-o", str(out), str(CSRC / f"{name}.cu")]


def _target(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += b"\0" + header.read_bytes()
    flags = " ".join(FLAGS + EXTRA_FLAGS.get(name, ())).encode()
    digest = hashlib.sha1(src + b"\0" + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def _start(name: str):
    """Start nvcc for ``name`` unless its library exists; returns
    ``(target, tmp, process)`` or ``(target, None, None)``."""
    target = _target(name)
    if target.exists():
        return target, None, None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(_command(name, tmp), stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return target, tmp, proc


def _finish(name: str, target: Path, tmp, proc) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)          # atomic: no reader sees a partial .so


def build_all(names: Iterable[str] = SOURCES) -> None:
    """Compile every source that has no current library, in parallel."""
    names = list(names)
    with _LOCK:
        started = [(n, *_start(n)) for n in names]
        for n, target, tmp, proc in started:
            _finish(n, target, tmp, proc)


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all([name])
        with _LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(_target(name)))
                _LIBS[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raise if a launch reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
