"""Paired noisy/clean pfile dataset -> normalized per-chunk training data.

A copy of ``tpu_se/data/dataset.py`` on the numpy read path (the
reference's host data engine, ``Interface.cc:719-965``): per chunk, read
the raw rows, Z-score them with the NOISY statistics (targets too,
``Interface.cc:804-810``) and list the chunk's window starts, shuffled by
the caller's ``np.random.Generator``.  The splice itself is a device
gather in the training step.  Everything here is host numpy; the
training loop uploads it.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass

import numpy as np

from tpu_se_torch.data.chunks import ChunkPlan, plan_chunks
from tpu_se_torch.data.splice import splice_frames, window_starts_for_chunk
from tpu_se_torch.io import read_norm, read_pfile_meta, read_pfile_rows


@dataclass
class Chunk:
    """One traincache-sized chunk on the host.

    ``noisy``/``clean`` are the chunk's normalized frames [F, D]; sample i
    is noisy frames [starts[i], starts[i]+context) spliced to context*D
    dims, with target clean frame ``starts[i] + targ_offset``.
    """
    noisy: np.ndarray      # float32 [F, D]
    clean: np.ndarray      # float32 [F, D]
    starts: np.ndarray     # int32 [N] window starts, relative to chunk
    context: int
    targ_offset: int

    @property
    def n_samples(self) -> int:
        return len(self.starts)

    def spliced_inputs(self) -> np.ndarray:
        """Host-side materialized [N, context*D]."""
        return splice_frames(self.noisy, self.starts, self.context)

    def targets(self) -> np.ndarray:
        return self.clean[self.starts + self.targ_offset]


class PfilePairDataset:
    """Noisy/clean pfile pair with the reference's chunking semantics.

    Only the headers and sentence tables are parsed up front; each chunk's
    rows are read and normalized on demand, so memory stays flat for
    large pfiles.
    """

    def __init__(self, noisy_pfile, clean_pfile, norm_file,
                 sent_range: tuple[int, int], traincache: int = 102400,
                 context: int = 7, targ_offset: int = 3):
        self.noisy_path = str(noisy_pfile)
        self.clean_path = str(clean_pfile)
        n_sents, n_frames, dim, sent_ends = read_pfile_meta(noisy_pfile)
        c_sents, c_frames, c_dim, c_ends = read_pfile_meta(clean_pfile)
        if (n_sents, n_frames) != (c_sents, c_frames) or \
                not np.array_equal(sent_ends, c_ends):
            raise ValueError("noisy/clean pfile sentence tables differ "
                             "(Interface.cc:560-580 consistency check)")
        self._dim = dim
        self._clean_dim = c_dim
        self.sent_ends = sent_ends
        self.mean, self.inv_std = read_norm(norm_file, dim)
        self.context = context
        self.targ_offset = targ_offset
        self.plan: ChunkPlan = plan_chunks(
            sent_ends, sent_range, traincache, context)

    @property
    def n_chunks(self) -> int:
        return self.plan.n_chunks

    @property
    def total_samples(self) -> int:
        return self.plan.total_samples

    @property
    def dim(self) -> int:
        return self._dim

    def _read_normalized(self, path: str, dim: int, lo: int, hi: int
                         ) -> np.ndarray:
        # Targets use the NOISY statistics too (Interface.cc:804-810).
        rows = read_pfile_rows(path, dim, lo, hi)
        return ((rows - self.mean) * self.inv_std).astype(np.float32)

    def _read_pair(self, lo: int, hi: int) -> tuple[np.ndarray, np.ndarray]:
        """Normalized (noisy, clean) rows [lo, hi), the two files read on
        two threads."""
        with ThreadPoolExecutor(2) as pool:
            f_noisy = pool.submit(self._read_normalized, self.noisy_path,
                                  self._dim, lo, hi)
            f_clean = pool.submit(self._read_normalized, self.clean_path,
                                  self._clean_dim, lo, hi)
            return f_noisy.result(), f_clean.result()

    def chunk(self, idx: int, rng: np.random.Generator | None = None) -> Chunk:
        """Load chunk ``idx``; pass an rng for shuffled training order."""
        lo = int(self.plan.frame_start[idx])
        hi = int(self.plan.frame_end[idx])
        noisy, clean = self._read_pair(lo, hi)
        starts = window_starts_for_chunk(self.plan, idx, rng) - lo
        return Chunk(noisy, clean, starts.astype(np.int32),
                     self.context, self.targ_offset)

    def epoch_chunks(self, rng: np.random.Generator, skip: int = 0):
        """Shuffled chunk order + shuffled samples (``BPtrain.cc:86-100``).

        ``skip`` replays the rng draws of the first N chunks without
        loading their data, so a mid-epoch resume lands on the exact
        shuffle sequence an uninterrupted epoch would have used.
        """
        for i, idx in enumerate(rng.permutation(self.n_chunks)):
            if i < skip:
                self.chunk_starts(int(idx), rng)   # consume rng identically
            else:
                yield self.chunk(int(idx), rng)

    # -- device-resident mode: the whole span is uploaded once per job and
    # an epoch ships only window starts, relative to the span.

    def frame_span(self) -> tuple[int, int]:
        """Absolute [lo, hi) frame range covered by this sentence range."""
        return int(self.plan.frame_start[0]), int(self.plan.frame_end[-1])

    def span_bytes(self) -> int:
        lo, hi = self.frame_span()
        return (hi - lo) * (self._dim + self._clean_dim) * 4

    def load_span_shard(self, process_index: int, process_count: int
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Normalized (noisy, clean) frames of this rank's
        ``shard_for_host`` slice of the range's rows: 1 / process_count of
        the bytes read from storage."""
        from tpu_se_torch.data.pipeline import shard_for_host

        lo, hi = self.frame_span()
        s = shard_for_host(hi - lo, process_index, process_count)
        return self._read_pair(lo + s.start, lo + s.stop)

    def load_span_normalized(self, process_shard: tuple[int, int] | None = None
                             ) -> tuple[np.ndarray, np.ndarray]:
        """Normalized (noisy, clean) frames of the whole range.

        ``process_shard=(process_index, process_count)``: data-parallel
        input sharding.  This rank reads only its ``load_span_shard`` rows
        and the span is reassembled across the ranks of the default
        process group (``allgather_host_rows``), byte-identical to the
        unsharded read.
        """
        if process_shard is None or process_shard[1] <= 1:
            return self._read_pair(*self.frame_span())
        from tpu_se_torch.parallel.distributed import allgather_host_rows

        pid, pcount = process_shard
        lo, hi = self.frame_span()
        noisy, clean = self.load_span_shard(pid, pcount)
        return (allgather_host_rows(noisy, hi - lo, pid, pcount),
                allgather_host_rows(clean, hi - lo, pid, pcount))

    def chunk_starts(self, idx: int,
                     rng: np.random.Generator | None = None) -> np.ndarray:
        """Window starts for chunk ``idx`` relative to the range span."""
        lo, _ = self.frame_span()
        return (window_starts_for_chunk(self.plan, idx, rng)
                - lo).astype(np.int32)

    def epoch_chunk_starts(self, rng: np.random.Generator):
        for idx in rng.permutation(self.n_chunks):
            yield self.chunk_starts(int(idx), rng)
