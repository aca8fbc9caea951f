from tpu_se_torch.infer.decode import (
    Enhancer, decode_files, enhance_utterance,
)
from tpu_se_torch.infer.evaluate import score_files, score_pair
from tpu_se_torch.infer.pesq import pesq
from tpu_se_torch.infer.stoi import pesq_score, stoi
from tpu_se_torch.infer.streaming import StreamingEnhancer

__all__ = ["Enhancer", "enhance_utterance", "decode_files",
           "pesq", "stoi", "pesq_score", "StreamingEnhancer",
           "score_pair", "score_files"]
