"""Waveform I/O: RIFF/WAVE (PCM16), NIST SPHERE, headerless raw PCM and the
HTK-container waveform.

Copy of ``tpu_se/io/wav.py``.  The reference reads NIST/RAW/HTK inputs in
its front end (``fileio.c:57-113,268-282``, ``Wav2LogSpec_be.c:325-360``);
the containers are decoded natively, with no external tool.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np


@dataclass
class WavInfo:
    sample_rate: int
    num_channels: int
    bits_per_sample: int


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE or NIST SPHERE file -> (int16 mono samples, rate);
    a multi-channel RIFF file gives its first channel."""
    with open(path, "rb") as f:
        magic = f.read(4)
        f.seek(0)
        if magic == b"RIFF":
            return _read_riff(f)
        if magic == b"NIST":
            return _read_nist(f)
        raise ValueError(f"{path}: not a RIFF/WAVE or NIST file "
                         f"(magic={magic!r})")


def _read_riff(f) -> tuple[np.ndarray, int]:
    riff, _size, wave = struct.unpack("<4sI4s", f.read(12))
    if riff != b"RIFF" or wave != b"WAVE":
        raise ValueError("bad RIFF header")
    sample_rate = None
    num_channels = 1
    bits = 16
    data = None
    while True:
        hdr = f.read(8)
        if len(hdr) < 8:
            break
        cid, csize = struct.unpack("<4sI", hdr)
        if cid == b"fmt ":
            fmt = f.read(csize)
            audio_fmt, num_channels, sample_rate, _, _, bits = struct.unpack(
                "<HHIIHH", fmt[:16])
            if audio_fmt != 1:
                raise ValueError(f"only PCM supported, got format {audio_fmt}")
        elif cid == b"data":
            data = f.read(csize)
        else:
            f.seek(csize + (csize & 1), 1)
    if data is None or sample_rate is None:
        raise ValueError("RIFF missing fmt/data chunk")
    if bits != 16:
        raise ValueError(f"only 16-bit PCM supported, got {bits}")
    samples = np.frombuffer(data, dtype="<i2")
    if num_channels > 1:
        samples = samples[::num_channels]
    return np.ascontiguousarray(samples), sample_rate


def _read_nist(f) -> tuple[np.ndarray, int]:
    # "NIST_1A\n   <header size>\n" then "key -tN value" lines.
    line1 = f.readline()
    line2 = f.readline()
    if not line1.startswith(b"NIST_1A"):
        raise ValueError("bad NIST header")
    f.seek(0)
    header = f.read(int(line2.strip())).decode("latin-1")
    fields = {}
    for line in header.splitlines()[2:]:
        parts = line.split()
        if len(parts) >= 3:
            fields[parts[0]] = parts[2]
        if line.strip() == "end_head":
            break
    sample_rate = int(fields.get("sample_rate", 16000))
    dtype = ">i2" if fields.get("sample_byte_format", "01") == "10" else "<i2"
    return np.frombuffer(f.read(), dtype=dtype).astype(np.int16), sample_rate


def write_wav(path, samples: np.ndarray, sample_rate: int = 16000) -> None:
    """Write mono PCM16 RIFF/WAVE."""
    data = np.asarray(samples, dtype="<i2").tobytes()
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 36 + len(data), b"WAVE"))
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 1, sample_rate,
                            sample_rate * 2, 2, 16))
        f.write(struct.pack("<4sI", b"data", len(data)))
        f.write(data)


def read_htk_waveform(path) -> tuple[np.ndarray, int]:
    """HTK-container waveform (sampKind 0): big-endian int16 samples, the
    rate from sampPeriod in 100 ns units (625 -> 16 kHz), as the front
    end's ``-F HTK`` input reads it (``Wav2LogSpec_be.c:325-335``)."""
    with open(path, "rb") as f:
        n, samp_period, _size, _kind = struct.unpack(">iihh", f.read(12))
        samples = np.frombuffer(f.read(n * 2), dtype=">i2").astype(np.int16)
    return samples, int(10 * (1e6 // samp_period))


def read_raw(path, swap: bool = False) -> np.ndarray:
    """Read headerless int16 PCM: little-endian, or big-endian with
    ``swap``."""
    dtype = ">i2" if swap else "<i2"
    with open(path, "rb") as f:
        return np.frombuffer(f.read(), dtype=dtype).astype(np.int16)


def write_raw(path, samples: np.ndarray, swap: bool = False) -> None:
    """Write headerless int16 PCM (big-endian with ``swap``)."""
    dtype = ">i2" if swap else "<i2"
    np.asarray(samples).astype(dtype).tofile(path)
