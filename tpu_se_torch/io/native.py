"""ctypes bindings for the host chunk loader (``csrc/chunk_loader.cc``).

The counterpart of ``tpu_se/io/native.py``: the same four C functions and
the same Python signatures.  Two things differ on purpose:

- the library is the port's own copy of the C++, built at first use by
  ``tpu_se_torch.ops._build.build_host_library`` (the host compiler,
  ``$CXX`` or ``c++``) into ``build/tpu_se_torch/``; nothing is built at
  import, and no ``make`` step exists;
- there is no silent fallback.  ``tpu_se`` reads through numpy when its
  ``.so`` is missing; here a failed build raises with the compiler's output
  from every function that needs the library.  ``available()`` only
  reports whether it builds.

A ``ctypes.CDLL`` call releases the interpreter lock, so the dataset's two
reader threads (noisy and clean file) run at once.  Every row written is
bit for bit the numpy route's ``(rows - mean) * inv_std`` in float32.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np


@functools.cache
def _load() -> ctypes.CDLL:
    """Build (if needed) and load the library, with its argument types;
    raises ``RuntimeError`` with the compiler's output when the build
    fails."""
    from tpu_se_torch.ops._build import build_host_library

    lib = ctypes.CDLL(str(build_host_library()[0]))
    i64, f32p, i32p = (ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
                       ctypes.POINTER(ctypes.c_int32))
    lib.tpuse_read_chunk_normalized.restype = ctypes.c_int
    lib.tpuse_read_chunk_normalized.argtypes = [
        ctypes.c_char_p, i64, i64, i64, i64, f32p, f32p, f32p]
    lib.tpuse_splice_scatter.restype = None
    lib.tpuse_splice_scatter.argtypes = [f32p, i64, i32p, i32p, i64, i64, f32p]
    lib.tpuse_gather_targets.restype = None
    lib.tpuse_gather_targets.argtypes = [f32p, i64, i32p, i32p, i64, i64, f32p]
    lib.tpuse_bswap_f32.restype = None
    lib.tpuse_bswap_f32.argtypes = [
        ctypes.POINTER(ctypes.c_uint32), i64, f32p]
    return lib


def available() -> bool:
    """True when the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _ip(a: np.ndarray | None):
    if a is None:
        return None
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def read_chunk_normalized(path, header_size: int, dim: int, frame_lo: int,
                          frame_hi: int, mean: np.ndarray,
                          inv_std: np.ndarray) -> np.ndarray:
    """Read + byte-swap + Z-score of pfile rows [frame_lo, frame_hi) ->
    float32 [n, dim]; raises ``IOError`` when the rows cannot be read."""
    lib = _load()
    if not 0 <= frame_lo <= frame_hi:
        raise ValueError(f"bad frame range [{frame_lo}, {frame_hi})")
    mean = np.ascontiguousarray(mean, dtype=np.float32)
    inv_std = np.ascontiguousarray(inv_std, dtype=np.float32)
    if mean.shape != (dim,) or inv_std.shape != (dim,):
        raise ValueError(f"statistics of shape {mean.shape}/{inv_std.shape}"
                         f" for {dim} features")
    out = np.empty((frame_hi - frame_lo, dim), dtype=np.float32)
    rc = lib.tpuse_read_chunk_normalized(
        str(path).encode(), header_size, dim, frame_lo, frame_hi,
        _fp(mean), _fp(inv_std), _fp(out))
    if rc != 0:
        raise IOError(f"native chunk read failed (rc={rc}) for {path}")
    return out


def _windows(frames, starts, scatter, span: int):
    """Contiguous copies of the arguments, checked so that the C loop
    stays inside ``frames`` and its output."""
    frames = np.ascontiguousarray(frames, dtype=np.float32)
    starts = np.ascontiguousarray(starts, dtype=np.int32)
    if frames.ndim != 2 or starts.ndim != 1:
        raise ValueError("frames must be [n, dim] and starts [n_windows]")
    if len(starts) and (starts.min() < 0
                        or int(starts.max()) + span > len(frames)):
        raise ValueError(f"window starts outside {len(frames)} frames")
    if scatter is not None:
        scatter = np.ascontiguousarray(scatter, dtype=np.int32)
        if scatter.shape != starts.shape or not np.array_equal(
                np.sort(scatter), np.arange(len(starts))):
            raise ValueError("scatter must be a permutation of the windows")
    return frames, starts, scatter


def splice_scatter(frames: np.ndarray, starts: np.ndarray,
                   scatter: np.ndarray | None, context: int) -> np.ndarray:
    """out[scatter[w]] = frames[starts[w] : starts[w] + context] flattened
    (identity order without ``scatter``) -> [n_windows, context * dim]."""
    lib = _load()
    frames, starts, scatter = _windows(frames, starts, scatter, context)
    n, dim = len(starts), frames.shape[1]
    out = np.empty((n, context * dim), dtype=np.float32)
    lib.tpuse_splice_scatter(_fp(frames), dim, _ip(starts), _ip(scatter),
                             n, context, _fp(out))
    return out


def gather_targets(frames: np.ndarray, starts: np.ndarray,
                   scatter: np.ndarray | None, offset: int) -> np.ndarray:
    """out[scatter[w]] = frames[starts[w] + offset] -> [n_windows, dim]."""
    lib = _load()
    if offset < 0:
        raise ValueError(f"negative target offset {offset}")
    frames, starts, scatter = _windows(frames, starts, scatter, offset + 1)
    n, dim = len(starts), frames.shape[1]
    out = np.empty((n, dim), dtype=np.float32)
    lib.tpuse_gather_targets(_fp(frames), dim, _ip(starts), _ip(scatter),
                             n, offset, _fp(out))
    return out
