from tpu_se_torch.infer.decode import Enhancer, decode_files

__all__ = ["Enhancer", "decode_files"]
