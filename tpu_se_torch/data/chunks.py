"""Chunk planner: sentence ranges -> traincache-sized sample chunks.

A numpy copy of ``tpu_se/data/chunks.py`` (itself
``Interface::get_chunk_info``, ``Interface.cc:588-650``):

- A chunk is a contiguous frame range; within it, every run of
  ``fea_context`` consecutive frames lying entirely inside one sentence (and
  inside the chunk) is one training sample, so each sentence segment of
  length L contributes ``max(L - context + 1, 0)`` samples.
- Chunks hold exactly ``traincache`` samples except the last; when a
  sentence straddles a chunk boundary the tail segment loses another
  ``context-1`` frames (windows restart inside the next chunk).
- A trailing chunk with zero samples is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ChunkPlan:
    frame_start: np.ndarray   # int64 [n_chunks] absolute first frame of chunk
    frame_end: np.ndarray     # int64 [n_chunks] absolute one-past-last frame
    n_samples: np.ndarray     # int64 [n_chunks]
    sent_ends: np.ndarray     # cumulative sentence end-frames (global table)
    context: int
    sent_lo: int              # first sentence id in range
    sent_hi: int              # last sentence id in range (inclusive)

    @property
    def n_chunks(self) -> int:
        return len(self.frame_start)

    @property
    def total_samples(self) -> int:
        return int(self.n_samples.sum())


def plan_chunks(sent_ends: np.ndarray, sent_range: tuple[int, int],
                traincache: int, context: int = 7) -> ChunkPlan:
    """Plan chunks over sentences [lo, hi] inclusive (reference range syntax)."""
    sent_ends = np.asarray(sent_ends, dtype=np.int64)
    lo, hi = sent_range
    if not (0 <= lo <= hi < len(sent_ends)):
        raise ValueError(f"sentence range {sent_range} out of bounds "
                         f"(have {len(sent_ends)} sentences)")

    starts = [int(sent_ends[lo - 1]) if lo > 0 else 0]
    cur_frame = starts[0]
    cur_chunk_samples = 0
    samples_per_chunk = []
    for sent in range(lo, hi + 1):
        seg_len = int(sent_ends[sent]) - cur_frame
        cur_frame = int(sent_ends[sent])
        cur_chunk_samples += max(seg_len - (context - 1), 0)
        while cur_chunk_samples >= traincache:
            next_start = cur_frame - (cur_chunk_samples - traincache)
            samples_per_chunk.append(traincache)
            starts.append(next_start)
            tail = cur_frame - next_start
            cur_chunk_samples = max(tail - (context - 1), 0)
    samples_per_chunk.append(cur_chunk_samples)

    frame_start = np.asarray(starts, dtype=np.int64)
    frame_end = np.concatenate([frame_start[1:], [int(sent_ends[hi])]])
    n_samples = np.asarray(samples_per_chunk, dtype=np.int64)

    # A trailing chunk with zero samples (planned when the sample count is
    # an exact traincache multiple) trains nothing: drop it.
    keep = n_samples > 0
    return ChunkPlan(frame_start[keep], frame_end[keep], n_samples[keep],
                     sent_ends, context, lo, hi)


def sentence_windows(plan: ChunkPlan, chunk_idx: int) -> np.ndarray:
    """Absolute start-frame of every context window in a chunk, in the
    reference's sentence-sequential order (``Interface.cc:771-790``)."""
    lo_f = int(plan.frame_start[chunk_idx])
    hi_f = int(plan.frame_end[chunk_idx])
    bounds = np.concatenate([[0], plan.sent_ends])
    out = []
    for s in range(len(plan.sent_ends)):
        seg_lo = max(lo_f, int(bounds[s]))
        seg_hi = min(hi_f, int(bounds[s + 1]))
        if seg_hi - seg_lo >= plan.context:
            out.append(np.arange(seg_lo, seg_hi - plan.context + 1,
                                 dtype=np.int64))
    if not out:
        return np.zeros(0, dtype=np.int64)
    starts = np.concatenate(out)
    expected = int(plan.n_samples[chunk_idx])
    if len(starts) != expected:
        raise AssertionError(f"chunk {chunk_idx}: planned {expected} "
                             f"samples, derived {len(starts)}")
    return starts
