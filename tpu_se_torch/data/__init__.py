"""Data layer (host numpy): pfile chunk planning, normalization, window
starts and prefetch -- copies of ``tpu_se.data`` that give the same
chunks and the same shuffles for the same ``np.random.Generator``.

- ``chunks``   -- chunk planner with the per-sentence edge drop.
- ``splice``   -- host splice and per-chunk (shuffled) window starts.
- ``dataset``  -- paired noisy/clean pfile dataset -> per-chunk data.
- ``pipeline`` -- background prefetch (the producer-thread equivalent) and
                 the per-rank shard of a work list.
"""

from tpu_se_torch.data.chunks import ChunkPlan, plan_chunks, sentence_windows
from tpu_se_torch.data.dataset import Chunk, PfilePairDataset
from tpu_se_torch.data.pipeline import PrefetchIterator, shard_for_host
from tpu_se_torch.data.splice import splice_frames, window_starts_for_chunk

__all__ = [
    "ChunkPlan", "plan_chunks", "sentence_windows",
    "splice_frames", "window_starts_for_chunk",
    "PfilePairDataset", "Chunk", "PrefetchIterator", "shard_for_host",
]
