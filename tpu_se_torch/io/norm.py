""".norm files: global Z-score statistics, mean and RECIPROCAL std-dev.

Copy of ``tpu_se/io/norm.py``.  Text, ``vec D`` + D means + ``vec D`` + D
inverse std-devs, one ``%.6g`` value per line (QuickNet's qnnorm,
``tools_pfile/get_norm.pl:3``); the headerless variant is read too.
Normalization everywhere is ``x_norm = (x - mean) * inv_std``.
"""

from __future__ import annotations

import numpy as np

from tpu_se_torch.io import pfile


def read_norm(path, dim: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Read a .norm file -> (mean, inv_std) float32 arrays."""
    values = []
    with open(path) as f:
        for line in f:
            tok = line.split()
            if tok and tok[0] != "vec":
                values.append(float(tok[0]))
    arr = np.asarray(values, dtype=np.float32)
    if dim is None:
        if len(arr) % 2:
            raise ValueError(f"odd number of values ({len(arr)}) in norm file")
        dim = len(arr) // 2
    if len(arr) != 2 * dim:
        raise ValueError(f"expected {2 * dim} values, got {len(arr)}")
    return arr[:dim].copy(), arr[dim:].copy()


def write_norm(path, mean: np.ndarray, inv_std: np.ndarray,
               with_headers: bool = True) -> None:
    """Write (mean, inv_std) as a .norm file, ``%.6g`` per value."""
    mean = np.asarray(mean).ravel()
    inv_std = np.asarray(inv_std).ravel()
    if mean.shape != inv_std.shape:
        raise ValueError("mean/inv_std shape mismatch")
    with open(path, "w") as f:
        for block in (mean, inv_std):
            if with_headers:
                f.write(f"vec {len(block)}\n")
            for v in block:
                f.write(f"{v:.6g}\n")


def compute_norm(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """qnnorm: per-dimension mean and reciprocal population std-dev over
    all frames, summed in float64."""
    features = np.asarray(features, dtype=np.float64)
    var = np.maximum(features.var(axis=0), 1e-20)
    return (features.mean(axis=0).astype(np.float32),
            (1.0 / np.sqrt(var)).astype(np.float32))


def compute_norm_pfile(path, block_frames: int | None = None
                       ) -> tuple[np.ndarray, np.ndarray]:
    """Streaming qnnorm over a pfile on disk: float64 sum and
    sum-of-squares over blocks of ``block_frames`` rows (default
    ``pfile.STREAM_BLOCK_FRAMES``), so memory stays O(block) whatever the
    archive's size."""
    if block_frames is None:
        block_frames = pfile.STREAM_BLOCK_FRAMES
    _, n_frames, dim, _ = pfile.read_pfile_meta(path)
    s = np.zeros(dim, dtype=np.float64)
    ss = np.zeros(dim, dtype=np.float64)
    done = 0
    while done < n_frames:
        n = min(block_frames, n_frames - done)
        block = pfile.read_pfile_rows(path, dim, done, done + n).astype(
            np.float64)
        s += block.sum(axis=0)
        ss += np.square(block).sum(axis=0)
        done += n
    mean = s / n_frames
    var = np.maximum(ss / n_frames - mean * mean, 1e-20)
    return mean.astype(np.float32), (1.0 / np.sqrt(var)).astype(np.float32)
