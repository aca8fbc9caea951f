"""Hand-written Hopper kernels, each beside its plain PyTorch version.

The wrappers launch on CUDA tensors and raise on anything else; callers
choose the plain version for CPU tensors (see ``tpu_se_torch.dsp``).
"""

from tpu_se_torch.ops import lps_kernel
from tpu_se_torch.ops.lps_kernel import lps_cuda, lps_plain

__all__ = ["lps_kernel", "lps_cuda", "lps_plain"]
