"""Context splicing and per-chunk window starts (numpy).

A copy of ``tpu_se/data/splice.py``'s training half: windows lie entirely
inside one sentence, and the training order is a permutation of the
chunk's window starts drawn from a ``np.random.Generator`` -- the same
draws as the JAX package, so the same seed gives the same shuffles bit
for bit.  The training step itself does not use ``splice_frames``: it
gathers the windows on the device (``tpu_se_torch.train.gather_splice``).
"""

from __future__ import annotations

import numpy as np

from tpu_se_torch.data.chunks import ChunkPlan, sentence_windows


def splice_frames(frames: np.ndarray, starts: np.ndarray,
                  context: int = 7) -> np.ndarray:
    """Gather windows: frames [F, D], starts [N] -> [N, context*D]."""
    frames = np.asarray(frames)
    starts = np.asarray(starts, dtype=np.int64)
    idx = starts[:, None] + np.arange(context)[None, :]
    return frames[idx].reshape(len(starts), context * frames.shape[1])


def window_starts_for_chunk(plan: ChunkPlan, chunk_idx: int,
                            rng: np.random.Generator | None = None
                            ) -> np.ndarray:
    """Window starts for a chunk, shuffled by ``rng.permutation`` when an
    rng is given (training order), sequential otherwise (CV order)."""
    starts = sentence_windows(plan, chunk_idx)
    if rng is not None:
        starts = rng.permutation(starts)
    return starts
