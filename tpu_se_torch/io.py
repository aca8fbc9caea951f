"""File codecs the port needs: wav, ``.norm``, ``.wts`` and pfile.

A numpy copy of the matching parts of ``tpu_se/io`` (``wav.py``,
``norm.py``, ``wts.py``, ``pfile.py``, ``atomic.py``), byte-compatible
with them, so the port reads and writes the reference's files without
importing the JAX package at all.

- wav: RIFF/WAVE PCM16 (first channel of a multi-channel file) and NIST
  SPHERE in; mono PCM16 RIFF/WAVE out.
- ``.norm``: text, ``vec D`` + D means + ``vec D`` + D inverse std-devs
  (the headerless variant is read too); ``x_norm = (x - mean) * inv_std``.
- ``.wts``: per layer a weights then a bias record, each ``int32[5]
  {10, rows, cols, 0, len(name)+1}``, the NUL-terminated name, then
  float32 row-major data, little-endian.  Weight records store
  ``[n_out, n_in]``; in memory a layer is ``{"w": [n_in, n_out], "b":
  [n_out]}``, so ``w`` is transposed on read and write.
- pfile (QuickNet): a 32 KB NUL-padded ASCII header of ``-key value``
  lines, then R rows of big-endian ``int32 sentence, int32 frame, D
  float32``, then the big-endian int32 sentence table ``[0, end_1, ...,
  end_n]`` (cumulative end frames).

``.wts`` and pfile writes are atomic (``atomic_write``): training resumes
by the existence of a file, so a present one must be complete.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

PFILE_HEADER_SIZE = 32768


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


def read_wav(path) -> tuple[np.ndarray, int]:
    """Read a RIFF/WAVE or NIST SPHERE file -> (int16 mono samples, rate)."""
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


def read_wts(path) -> list[dict]:
    """Read a .wts file -> [{'w': [n_in, n_out] f32, 'b': [n_out] f32}, ...]."""
    layers = []
    with open(path, "rb") as f:
        while True:
            stat = f.read(20)
            if len(stat) < 20:
                break
            magic, rows, cols, _zero, name_len = struct.unpack("<5i", stat)
            if magic != 10:
                raise ValueError(f"bad .wts record magic {magic}")
            name = f.read(name_len).split(b"\0")[0].decode("ascii")
            data = np.frombuffer(f.read(rows * cols * 4), dtype="<f4")
            data = data.reshape(rows, cols)
            if name.startswith("weights"):
                layers.append({"w": data.T.astype(np.float32).copy()})
            elif name.startswith("bias"):
                if not layers or "b" in layers[-1]:
                    raise ValueError(f"unexpected bias record {name}")
                layers[-1]["b"] = data.reshape(-1).astype(np.float32).copy()
            else:
                raise ValueError(f"unknown .wts record {name!r}")
    for i, layer in enumerate(layers):
        if "b" not in layer:
            raise ValueError(f"layer {i} missing bias record")
    return layers


def write_wts(path, layers: list[dict]) -> None:
    """Write [{'w': [n_in, n_out], 'b': [n_out]}, ...] in the reference
    layout, atomically."""
    def records(f):
        for i, layer in enumerate(layers):
            w = np.asarray(layer["w"], dtype=np.float32)
            b = np.asarray(layer["b"], dtype=np.float32).reshape(-1)
            n_in, n_out = w.shape
            if b.shape[0] != n_out:
                raise ValueError(f"layer {i}: bias/weight shape mismatch")
            _write_record(f, f"weights{i + 1}{i + 2}", w.T)
            _write_record(f, f"bias{i + 2}", b.reshape(1, n_out))

    atomic_write(path, records)


def _write_record(f, name: str, data: np.ndarray) -> None:
    name_b = name.encode("ascii") + b"\0"
    rows, cols = data.shape
    f.write(struct.pack("<5i", 10, rows, cols, 0, len(name_b)))
    f.write(name_b)
    f.write(np.ascontiguousarray(data, dtype="<f4").tobytes())


@dataclass
class PFile:
    """In-memory pfile: features plus sentence segmentation."""

    features: np.ndarray      # float32 [num_frames, dim]
    sent_ids: np.ndarray      # int32 [num_frames]
    frame_ids: np.ndarray     # int32 [num_frames]
    sent_ends: np.ndarray     # int32 [num_sentences] cumulative end frames

    @property
    def num_frames(self) -> int:
        return self.features.shape[0]

    @property
    def num_sentences(self) -> int:
        return len(self.sent_ends)

    @property
    def dim(self) -> int:
        return self.features.shape[1]


def read_pfile_header(path) -> dict:
    """Parse the 32 KB ASCII header into a dict of the '-key value' lines."""
    with open(path, "rb") as f:
        hdr = f.read(PFILE_HEADER_SIZE)
    hdr = hdr.split(b"\0", 1)[0].decode("ascii", errors="replace")
    out = {}
    for line in hdr.splitlines():
        line = line.strip()
        if not line.startswith("-"):
            continue
        parts = line[1:].split(None, 1)
        if parts:
            out[parts[0]] = parts[1] if len(parts) > 1 else ""
    return out


def _pfile_counts(hdr: dict) -> tuple[int, int, int]:
    return (int(hdr["num_sentences"].split()[0]),
            int(hdr["num_frames"].split()[0]),
            int(hdr["num_features"].split()[0]))


def read_pfile_meta(path) -> tuple[int, int, int, np.ndarray]:
    """Header-only parse: (num_sentences, num_frames, dim, sent_ends)."""
    num_sents, num_frames, dim = _pfile_counts(read_pfile_header(path))
    with open(path, "rb") as f:
        f.seek(PFILE_HEADER_SIZE + num_frames * (2 + dim) * 4 + 4)
        sent_ends = np.frombuffer(f.read(num_sents * 4),
                                  dtype=">i4").astype(np.int32)
    return num_sents, num_frames, dim, sent_ends


def read_pfile_rows(path, dim: int, frame_lo: int, frame_hi: int
                    ) -> np.ndarray:
    """Feature rows [frame_lo, frame_hi) -> float32 [n, dim]."""
    ncol = 2 + dim
    n = frame_hi - frame_lo
    with open(path, "rb") as f:
        f.seek(PFILE_HEADER_SIZE + frame_lo * ncol * 4)
        rows = np.frombuffer(f.read(n * ncol * 4), dtype=">f4")
    return rows.reshape(n, ncol)[:, 2:].astype(np.float32)


def read_pfile(path) -> PFile:
    """Read a whole pfile into memory."""
    num_sents, num_frames, dim = _pfile_counts(read_pfile_header(path))
    ncol = 2 + dim
    with open(path, "rb") as f:
        f.seek(PFILE_HEADER_SIZE)
        rows = np.frombuffer(f.read(num_frames * ncol * 4), dtype=">i4")
        rows = rows.reshape(num_frames, ncol)
        f.seek(PFILE_HEADER_SIZE + num_frames * ncol * 4 + 4)
        sent_ends = np.frombuffer(f.read(num_sents * 4),
                                  dtype=">i4").astype(np.int32)
    return PFile(rows[:, 2:].view(">f4").astype(np.float32),
                 rows[:, 0].astype(np.int32), rows[:, 1].astype(np.int32),
                 sent_ends)


def _pfile_header(num_sents: int, num_frames: int, dim: int) -> bytes:
    ncol = 2 + dim
    header_lines = [
        f"-pfile_header version 0 size {PFILE_HEADER_SIZE}",
        f"-num_sentences {num_sents}",
        f"-num_frames {num_frames}",
        "-first_feature_column 2",
        f"-num_features {dim}",
        f"-first_label_column {2 + dim}",
        "-num_labels 0",
        "-format dd" + "f" * dim,
        f"-data size {num_frames * ncol} offset 0 ndim 2 nrow {num_frames} "
        f"ncol {ncol}",
        f"-sent_table_data size {num_sents + 1} offset {num_frames * ncol} "
        "ndim 1",
        "-end",
    ]
    header = ("\n".join(header_lines) + "\n").encode("ascii")
    if len(header) > PFILE_HEADER_SIZE:
        raise ValueError("pfile header overflow")
    return header.ljust(PFILE_HEADER_SIZE, b"\0")


def write_pfile(path, utterances: list[np.ndarray],
                desired_lengths: list[int] | None = None) -> None:
    """Write a list of [T_i, D] float32 arrays as a reference-layout pfile,
    atomically.  ``desired_lengths`` truncates each utterance to the given
    frame count (feacat's ``-deslenfile``)."""
    if desired_lengths is not None:
        if len(desired_lengths) != len(utterances):
            raise ValueError("desired_lengths/utterances count mismatch")
        utterances = [u[:n] for u, n in zip(utterances, desired_lengths)]
    if not utterances:
        raise ValueError("no utterances")
    utterances = [np.asarray(u, dtype=np.float32) for u in utterances]
    dim = utterances[0].shape[1] if utterances[0].ndim == 2 else None
    for utt in utterances:
        if utt.ndim != 2:
            raise ValueError(f"utterance must be [T, D], got {utt.shape}")
        if utt.shape[1] != dim:
            raise ValueError("inconsistent feature dims across utterances")
    ends = np.cumsum([len(u) for u in utterances])

    def body(f):
        f.write(_pfile_header(len(utterances), int(ends[-1]), dim))
        for sent, utt in enumerate(utterances):
            rows = np.empty((len(utt), 2 + dim), dtype=">i4")
            rows[:, 0] = sent
            rows[:, 1] = np.arange(len(utt), dtype=np.int32)
            rows[:, 2:] = utt.astype(">f4").view(">i4")
            f.write(rows.tobytes())
        f.write(np.concatenate([[0], ends]).astype(">i4").tobytes())

    atomic_write(path, body)
