"""Crash-safe file writes: same-directory tmp file + ``os.replace``.

A copy of ``lightgbm_tpu/utils/atomic.py``. Model files
(``Booster.save_model``) and checkpoint snapshots
(``resilience/checkpoint.py``) go through here: a process killed
mid-write leaves either the previous complete file or nothing — never
a truncated one.

POSIX ``rename(2)`` is atomic only within a filesystem, which is why the
tmp file is created in the *target's* directory rather than ``$TMPDIR``.
"""

from __future__ import annotations

import os
import tempfile

__all__ = ["atomic_write_bytes", "atomic_write_text"]


def atomic_write_bytes(path, data: bytes) -> None:
    """Write ``data`` to ``path`` so that the file is either fully
    written or untouched (tmp file + fsync + ``os.replace``)."""
    path = os.fspath(path)
    dirname = os.path.dirname(os.path.abspath(path))
    os.makedirs(dirname, exist_ok=True)
    fd, tmp = tempfile.mkstemp(
        dir=dirname, prefix=os.path.basename(path) + ".", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(data)
            f.flush()
            # flush alone leaves the bytes in the page cache; a machine
            # crash after replace() could then surface an empty file
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def atomic_write_text(path, text: str, encoding: str = "utf-8") -> None:
    atomic_write_bytes(path, text.encode(encoding))
