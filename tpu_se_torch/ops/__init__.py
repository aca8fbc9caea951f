"""Hand-written Hopper kernels, each beside its plain PyTorch version.

The wrappers launch on CUDA tensors and raise on anything else; callers
choose the plain version for CPU tensors (see ``tpu_se_torch.dsp``,
``tpu_se_torch.losses`` and ``tpu_se_torch.train.optim``).
"""

from tpu_se_torch.ops import ggd_kernel, lps_kernel, sgd_kernel
from tpu_se_torch.ops.ggd_kernel import (
    ggd_colsum_cuda, ggd_colsum_plain, ggd_grad_from_sums_cuda,
    ggd_grad_from_sums_plain, ggd_output_grad_cuda, ggd_output_grad_plain,
)
from tpu_se_torch.ops.lps_kernel import lps_cuda, lps_plain
from tpu_se_torch.ops.sgd_kernel import sgd_update_cuda, sgd_update_plain

__all__ = ["ggd_kernel", "lps_kernel", "sgd_kernel", "ggd_output_grad_cuda",
           "ggd_output_grad_plain", "ggd_colsum_cuda", "ggd_colsum_plain",
           "ggd_grad_from_sums_cuda", "ggd_grad_from_sums_plain",
           "lps_cuda", "lps_plain", "sgd_update_cuda", "sgd_update_plain"]
