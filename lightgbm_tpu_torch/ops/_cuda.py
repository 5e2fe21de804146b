"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``lightgbm_tpu_torch/_build/`` (listed in ``.gitignore``), and loaded with
``ctypes``. The library's file name carries a hash of its source and of
the shared headers (``csrc/*.cuh``), so an edited kernel is rebuilt.
Nothing here runs when the module is imported: the CPU tests import every
module of the port and have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["KERNELS", "build", "library", "check", "stream_ptr"]

_PKG = Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

# C entry points of each kernel library: name -> (restype, argtypes)
KERNELS: Dict[str, Dict[str, tuple]] = {
    "hist": {
        "hist_build": (_I, [_P, _I, _P, _I, _I, _I, _P, _I, _I, _I, _I,
                            _I, _I, _I, _I, _P, _P, _P, _P]),
        "hist_smem_bytes": (_I, [_I, _I, _I, _I, _I, _I, _I]),
    },
    "partition": {
        "partition_window": (_I, [_P, _P, _I, _P, _P, _I, _P, _P, _L, _I,
                                  _I, _I, _I, _I, _I, _P, _I, _I, _I, _I,
                                  _I, _L, _I, _I, _P, _P, _P, _P]),
        "partition_smem_bytes": (_I, [_I, _I, _I, _I, _I]),
        "partition_occupancy": (_I, [_I, _I, _I, _I]),
        "partition_cooperative": (_I, [_I]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    cands = ([os.path.join(home, "bin", "nvcc")] if home else []) \
        + [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise RuntimeError(
        "nvcc was not found (CUDA_HOME, PATH, /usr/local/cuda/bin): the "
        "port's kernels are built from csrc/*.cu at first use on a "
        "machine with the CUDA toolkit")


def _target(name: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(ARCH_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build(names: Iterable[str] = tuple(KERNELS)) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc``
    process per source, all started together. Returns the wall seconds
    of each compile (0.0 for a library that was already built)."""
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    secs: Dict[str, float] = {}
    for name in names:
        out = _target(name)
        if out.exists():
            secs[name] = 0.0
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
               "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(tmp),
               str(SRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT,
                                        text=True), tmp, out,
                       time.perf_counter())
    errors = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        (BUILD_DIR / f"{name}.ptxas.txt").write_text(log)
        os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return secs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(str(_target(name)))
            for fn, (res, args) in KERNELS[name].items():
                f = getattr(lib, fn)
                f.restype = res
                f.argtypes = args
            _libs[name] = lib
        return lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err}")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
