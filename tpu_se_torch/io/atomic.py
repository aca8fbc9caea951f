"""Atomic file writes: tmp + flush + fsync + rename, tmp unlinked on error.

Copy of ``tpu_se/io/atomic.py``.  Training resumes by the existence of a
file, so a present ``.wts`` or pfile must be a complete one.
"""

from __future__ import annotations

import os


def atomic_write(path, write_fn, mode: str = "wb") -> None:
    """Write ``path`` atomically: ``write_fn(f)`` fills ``<path>.tmp.<pid>``,
    which is flushed, fsync'd and renamed over ``path``; on any error the
    tmp file is removed and the exception re-raised.  A present file is
    therefore always a complete one (resume-by-existence relies on it)."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, mode) as f:
            write_fn(f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise
