"""QuickNet pfiles: reader, streaming writer and concatenation.

Copy of ``tpu_se/io/pfile.py``, byte-compatible with it.  Layout
(``Interface.cc:519-585,988-1024``): a 32 KB NUL-padded ASCII header of
``-key value`` lines, then R rows of big-endian ``int32 sentence, int32
frame, D float32``, then the big-endian int32 sentence table ``[0, end_1,
..., end_n]`` (cumulative end frames).

Writes are atomic: rows stream into ``<path>.tmp.<pid>`` and the final
name appears only once the file is complete.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

PFILE_HEADER_SIZE = 32768
# Block size of the streaming concat and norm: ~16 MB of 257-dim rows.
STREAM_BLOCK_FRAMES = 16384


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


class PfileWriter:
    """Streaming pfile writer holding one utterance in memory at a time.

    A placeholder header is written first, rows are appended per
    utterance, and ``close()`` writes the sentence table, back-patches the
    header with the final counts, fsyncs and renames the tmp file into
    place.  An error inside the ``with`` block (or ``abort()``) removes the
    tmp file and leaves the final path as it was.

        with PfileWriter(path) as w:
            for utt in utterances:      # each [T_i, D] float32
                w.add(utt)
    """

    def __init__(self, path):
        self._path = os.fspath(path)
        self._tmp = f"{self._path}.tmp.{os.getpid()}"
        self._f = open(self._tmp, "wb")
        self._f.write(b"\0" * PFILE_HEADER_SIZE)
        self._dim = None
        self._ends: list[int] = []
        self._cum = 0

    @property
    def num_sentences(self) -> int:
        return len(self._ends)

    @property
    def num_frames(self) -> int:
        return self._cum

    def add(self, utt: np.ndarray) -> None:
        """Append one utterance [T, D] as the next sentence."""
        utt = np.asarray(utt, dtype=np.float32)
        if utt.ndim != 2:
            raise ValueError(f"utterance must be [T, D], got {utt.shape}")
        if self._dim is None:
            self._dim = utt.shape[1]
        elif utt.shape[1] != self._dim:
            raise ValueError("inconsistent feature dims across utterances")
        t = utt.shape[0]
        rows = np.empty((t, 2 + self._dim), dtype=">i4")
        rows[:, 0] = len(self._ends)
        rows[:, 1] = np.arange(t, dtype=np.int32)
        rows[:, 2:] = utt.astype(">f4").view(">i4")
        self._f.write(rows.tobytes())
        self._cum += t
        self._ends.append(self._cum)

    def add_raw_rows(self, raw: bytes | np.ndarray, dim: int,
                     sent_ids: np.ndarray | None = None,
                     frame_ids: np.ndarray | None = None) -> None:
        """Append already-encoded big-endian rows (int32 sent, int32 frame,
        D float32) without decoding the floats; ``end_raw_sentences``
        records their sentence boundaries.  ``sent_ids``/``frame_ids``
        overwrite the two id columns on a copy (the caller's array is never
        changed); omitted, the input ids pass through."""
        if self._dim is None:
            self._dim = dim
        elif dim != self._dim:
            raise ValueError("inconsistent feature dims across inputs")
        ncol = 2 + dim
        if isinstance(raw, np.ndarray):
            rows = np.ascontiguousarray(raw).view(">i4").reshape(-1, ncol)
        else:
            rows = np.frombuffer(raw, dtype=">i4").reshape(-1, ncol)
        if sent_ids is not None or frame_ids is not None:
            rows = rows.copy()
            if sent_ids is not None:
                rows[:, 0] = np.asarray(sent_ids, dtype=np.int64).astype(">i4")
            if frame_ids is not None:
                rows[:, 1] = np.asarray(frame_ids,
                                        dtype=np.int64).astype(">i4")
        self._f.write(rows.tobytes())

    def end_raw_sentences(self, lengths) -> None:
        """Record sentence boundaries for rows added via ``add_raw_rows``."""
        for t in lengths:
            self._cum += int(t)
            self._ends.append(self._cum)

    def abort(self) -> None:
        """Discard the build: close and remove the tmp file.  Every step is
        best-effort (closing may re-raise the write error that caused the
        abort), and the unlink still happens."""
        if self._f is None:
            return
        f, self._f = self._f, None
        try:
            f.close()
        except OSError:
            pass
        try:
            os.unlink(self._tmp)
        except OSError:
            pass

    def close(self) -> None:
        """Finalize: sentence table, header, fsync, rename into place."""
        if self._f is None:
            return
        if not self._ends:
            self.abort()
            raise ValueError("no utterances")
        try:
            table = np.concatenate([[0], self._ends]).astype(">i4")
            self._f.write(table.tobytes())
            self._f.seek(0)
            self._f.write(_pfile_header(len(self._ends), self._cum,
                                        self._dim))
            self._f.flush()
            os.fsync(self._f.fileno())
        except BaseException:
            self.abort()
            raise
        self._f.close()
        self._f = None
        os.replace(self._tmp, self._path)

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is None:
            self.close()
        else:
            self.abort()
        return False


def concat_pfiles(out_path, in_paths: list) -> None:
    """Merge pfiles sentence-wise (QuickNet ``pfile_concat``,
    ``tools_pfile/pfile_noisy.pl:46``), streaming.

    Rows are copied in blocks of ``STREAM_BLOCK_FRAMES`` with only the two
    id columns rewritten, renumbered canonically (sentences 0..n-1, frames
    0..T_i-1 in each) from each input's sentence table, so inputs with
    other id columns still give canonical output.
    """
    with PfileWriter(out_path) as w:
        sent_off = 0
        for p in in_paths:
            n_sents, n_frames, dim, ends = read_pfile_meta(p)
            ncol = 2 + dim
            ends64 = ends.astype(np.int64)
            starts = np.concatenate([[0], ends64[:-1]])
            with open(p, "rb") as f:
                f.seek(PFILE_HEADER_SIZE)
                done = 0
                while done < n_frames:
                    n = min(STREAM_BLOCK_FRAMES, n_frames - done)
                    raw = f.read(n * ncol * 4)
                    idx = np.arange(done, done + n, dtype=np.int64)
                    sent = np.searchsorted(ends64, idx, side="right")
                    w.add_raw_rows(raw, dim, sent_ids=sent + sent_off,
                                   frame_ids=idx - starts[sent])
                    done += n
            w.end_raw_sentences(np.diff(np.concatenate([[0], ends])))
            sent_off += n_sents


def write_pfile(path, utterances: list[np.ndarray],
                desired_lengths: list[int] | None = None) -> None:
    """Write a list of [T_i, D] float32 arrays as a pfile, through
    ``PfileWriter``.  ``desired_lengths`` truncates each utterance to the
    given frame count (feacat's ``-deslenfile``, ``pfile_noisy.pl:34``)."""
    if desired_lengths is not None:
        if len(desired_lengths) != len(utterances):
            raise ValueError("desired_lengths/utterances count mismatch")
        utterances = [u[:n] for u, n in zip(utterances, desired_lengths)]
    if not utterances:
        raise ValueError("no utterances")
    with PfileWriter(path) as w:
        for utt in utterances:
            w.add(utt)
