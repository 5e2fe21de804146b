"""The native text parser: ``native/fastparse.cpp``, compiled at first use
by the host's C++ compiler and loaded through ctypes.

A copy of the parsing half of ``lightgbm_tpu/utils/native.py`` (the
port bins on the device, so it has no native binning). The library is
built into ``lightgbm_tpu_torch/_build/native/`` (listed in
``.gitignore``, beside the CUDA kernels), a directory that only its
owner may write, under a name that carries a hash of the source, so an
edited parser is rebuilt. Without a compiler :func:`parse_dense_text`
returns None and the caller parses with numpy, as in the JAX package.
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

from ..log import log_warning

__all__ = ["parse_dense_text", "parse_dense_rows", "library"]

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "fastparse.cpp"
BUILD_DIR = _PKG / "_build" / "native"

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build_dir() -> Path:
    """The build directory, created 0700; refused when another user owns
    it (a library planted there would be loaded)."""
    BUILD_DIR.mkdir(mode=0o700, parents=True, exist_ok=True)
    if BUILD_DIR.stat().st_uid != os.getuid():
        raise PermissionError(f"native build dir {BUILD_DIR} is not ours")
    os.chmod(BUILD_DIR, 0o700)
    return BUILD_DIR


def _compile(src: Path, so: Path) -> None:
    # a private temporary name, then an atomic rename: another process
    # never loads a half-written library
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", "-O3", "-std=c++17", "-shared", "-fPIC", "-fopenmp",
           str(src), "-o", str(tmp)]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
    finally:
        if tmp.exists():
            tmp.unlink()


def library() -> Optional[ctypes.CDLL]:
    """The loaded parser library, compiled first if needed; None when it
    cannot be built or loaded (the numpy fallback)."""
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        tag = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
        try:
            so = _build_dir() / f"fastparse_{tag}.so"
            if not so.exists():
                _compile(SOURCE, so)
            lib = ctypes.CDLL(str(so))
        except Exception as e:  # no compiler, a failed build or load
            log_warning(f"native text parser unavailable ({e}); parsing "
                        "with numpy")
            return None
        lib.ltpu_sniff.restype = ctypes.c_int
        lib.ltpu_sniff.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_char)]
        lib.ltpu_parse_dense.restype = ctypes.c_int64
        lib.ltpu_parse_dense.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_char,
            ctypes.c_int64, ctypes.c_int64,
            np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")]
        _lib = lib
        return lib


def parse_dense_text(path: str, skip_header: bool) -> Optional[np.ndarray]:
    """A delimited numeric file as ``[rows, cols]`` float64 (empty or
    unparseable cells NaN); None when the native parser is unavailable
    or the file has no data row."""
    lib = library()
    if lib is None:
        return None
    with open(path, "rb") as fh:
        buf = fh.read()
    rows = ctypes.c_int64()
    cols = ctypes.c_int64()
    delim = ctypes.c_char()
    rc = lib.ltpu_sniff(buf, len(buf), int(skip_header), ctypes.byref(rows),
                        ctypes.byref(cols), ctypes.byref(delim))
    if rc != 0 or rows.value <= 0 or cols.value <= 0:
        return None
    out = np.empty((rows.value, cols.value), np.float64)
    got = lib.ltpu_parse_dense(buf, len(buf), int(skip_header), delim.value,
                               rows.value, cols.value, out)
    return out[:got] if got != rows.value else out


def parse_dense_rows(buf: bytes, rows: int, cols: int,
                     sep: Optional[str]) -> Optional[np.ndarray]:
    """``rows`` non-empty lines of delimited text (``sep``: ``","``,
    ``"\\t"`` or None for whitespace) as ``[rows, cols]`` float64, by the
    same parser as :func:`parse_dense_text` (short rows NaN-padded, extra
    cells ignored); None when the native parser is unavailable. The
    streaming text sources parse each chunk of lines with it."""
    lib = library()
    if lib is None:
        return None
    out = np.empty((rows, cols), np.float64)
    delim = (sep or " ").encode()
    got = lib.ltpu_parse_dense(buf, len(buf), 0, delim, rows, cols, out)
    return out[:got] if got != rows else out
