from tpu_se_torch.infer.decode import Enhancer, decode_files
from tpu_se_torch.infer.evaluate import score_files, score_pair
from tpu_se_torch.infer.pesq import pesq
from tpu_se_torch.infer.stoi import pesq_score, stoi

__all__ = ["Enhancer", "decode_files", "pesq", "stoi", "pesq_score",
           "score_pair", "score_files"]
