"""Native runtime: fast point-cloud text parsing (C++ / OpenMP, ctypes).

Port of `hitadv_tpu/runtime/__init__.py`, with a copy of its source
(`pointcloud_io.cpp`). The reference's ``DataLoader(num_workers=10)``
(`eval.py:90`) parsed the txt files in forked workers; this in-process
parser streams them at memory speed, in parallel across files.

The library builds at first use with the system's C++ compiler into the
package's ignored build directory (``hitadv_torch/ops/_build/``, the
kernels' own), under a name that carries a hash of the source and the
flags: an edited source is rebuilt, a stale library never loaded. Where
no compiler builds it, `available` is False and `NativeParser` raises;
nothing falls back to numpy by itself.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

SRC = Path(__file__).resolve().parent / "pointcloud_io.cpp"
BUILD_DIR = Path(__file__).resolve().parents[1] / "ops" / "_build"
FLAGS = ("-O3", "-fopenmp", "-shared", "-fPIC")
COMPILERS = ("g++", "c++", "clang++")

_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_LOCK = threading.Lock()


def library_path() -> Path:
    """Where the parser's library is built: its name carries a hash of
    the source and the flags."""
    digest = hashlib.sha1(SRC.read_bytes() + b"\0"
                          + " ".join(FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"libpointcloud_io-{digest}.so"


def _build() -> ctypes.CDLL:
    """Compile the source unless its library exists (atomically: a reader
    never sees a partial file), load it and declare its entry points;
    raises with every compiler's output when none builds it."""
    target = library_path()
    if not target.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = target.with_name(f"{target.name}.{os.getpid()}.tmp")
        errors = []
        for cc in COMPILERS:
            try:
                proc = subprocess.run([cc, *FLAGS, str(SRC), "-o", str(tmp)],
                                      capture_output=True, text=True)
            except FileNotFoundError:
                errors.append(f"{cc}: not found")
                continue
            if proc.returncode == 0:
                os.replace(tmp, target)
                break
            errors.append(f"{cc}: {proc.stderr.strip()}")
        else:
            raise RuntimeError("native parser: no compiler built "
                               f"{SRC.name}:\n" + "\n".join(errors))
    lib = ctypes.CDLL(str(target))
    lib.pcio_load_txt.restype = ctypes.c_int64
    lib.pcio_load_txt.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_float),
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.pcio_load_txt_batch.restype = ctypes.c_int64
    lib.pcio_load_txt_batch.argtypes = [
        ctypes.c_char_p, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64)]
    lib.pcio_normalize_batch.restype = None
    lib.pcio_normalize_batch.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.c_int64, ctypes.c_int64,
        ctypes.c_int64]
    return lib


def available() -> bool:
    """Whether the parser's library is built and loaded (building it on
    the first call; a failed build is not retried)."""
    global _lib, _build_error
    with _LOCK:
        if _lib is None and _build_error is None:
            try:
                _lib = _build()
            except RuntimeError as e:
                _build_error = str(e)
    return _lib is not None


def _floats(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class NativeParser:
    """Drop-in txt parser for the data loaders (a dataset's ``parser=``).

    ``load_txt(path)`` gives what ``np.loadtxt(path, delimiter=',')`` gives
    for the dense numeric tables of the point-cloud datasets, as float32.
    Raises when the library cannot be built.
    """

    def __init__(self, max_rows: int = 20000, n_cols: int = 6):
        if not available():
            raise RuntimeError(f"native parser unavailable: {_build_error}")
        self.max_rows = max_rows
        self.n_cols = n_cols

    def load_txt(self, path: str, n_cols: Optional[int] = None
                 ) -> np.ndarray:
        cols = n_cols or self.n_cols
        buf = np.empty((self.max_rows, cols), np.float32)
        rows = _lib.pcio_load_txt(path.encode(), _floats(buf),
                                  self.max_rows, cols, cols)
        if rows < 0:
            raise IOError(f"native parse failed ({rows}) for {path}")
        return buf[:rows].copy()

    def load_batch(self, paths: List[str], rows_per_file: int,
                   n_cols: Optional[int] = None,
                   normalize: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Parse many files in parallel into [F, rows, cols] (+row counts)."""
        cols = n_cols or self.n_cols
        n = len(paths)
        out = np.zeros((n, rows_per_file, cols), np.float32)
        counts = np.zeros(n, np.int64)
        blob = b"".join(p.encode() + b"\0" for p in paths)
        ok = _lib.pcio_load_txt_batch(
            blob, n, _floats(out), rows_per_file, cols,
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
        if ok != n:
            bad = [paths[i] for i in range(n) if counts[i] < 0]
            raise IOError(f"native parse failed for {bad[:3]}...")
        if normalize:
            _lib.pcio_normalize_batch(_floats(out), n, rows_per_file, cols)
        return out, counts
