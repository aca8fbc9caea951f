"""HTK feature files (big-endian), the ``.lps`` files of the pipeline.

Copy of ``tpu_se/io/htk.py``.  Layout (reference writer
``fileio.c:187-243``):

    int32  nSamples      (big-endian)
    int32  sampPeriod    (160000 for the LPS files)
    int16  sampSize      (bytes per frame = nDim*4; 1028 for 257 dims)
    int16  paramKind     (9 = USER)
    float32[nSamples, nDim]  big-endian, row-major
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

HTK_HEADER_SIZE = 12


@dataclass
class HTKHeader:
    n_samples: int
    samp_period: int
    samp_size: int
    param_kind: int

    @property
    def n_dim(self) -> int:
        return self.samp_size // 4


def read_htk(path) -> tuple[np.ndarray, HTKHeader]:
    """Read a big-endian HTK feature file -> (float32 [T, D], header)."""
    with open(path, "rb") as f:
        raw = f.read()
    hdr = HTKHeader(*struct.unpack(">iihh", raw[:HTK_HEADER_SIZE]))
    data = np.frombuffer(raw, dtype=">f4", count=hdr.n_samples * hdr.n_dim,
                         offset=HTK_HEADER_SIZE)
    return data.reshape(hdr.n_samples, hdr.n_dim).astype(np.float32), hdr


def frames_in_htk_file(path, n_dim: int = 257) -> int:
    """Frame count from the file size alone, (size - 12) / 4 / n_dim
    (``GetLenForFeaScp.pl:52``)."""
    return (os.path.getsize(path) - HTK_HEADER_SIZE) // 4 // n_dim


def write_htk(path, data: np.ndarray, samp_period: int = 160000,
              param_kind: int = 9, no_header: bool = False) -> None:
    """Write float32 [T, D] as a big-endian HTK file; ``no_header`` omits
    the 12-byte header (the front end's ``-noh``,
    ``Wav2LogSpec_be.c:172,602``)."""
    data = np.asarray(data, dtype=np.float32)
    if data.ndim != 2:
        raise ValueError(f"expected [T, D] array, got shape {data.shape}")
    t, d = data.shape
    with open(path, "wb") as f:
        if not no_header:
            f.write(struct.pack(">iihh", t, samp_period, d * 4, param_kind))
        f.write(data.astype(">f4").tobytes())
