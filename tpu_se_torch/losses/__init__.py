from tpu_se_torch.losses.objectives import (
    beta_norm_grad, ggd_alpha, ggd_grad, ggd_loglik, output_grad_and_alpha,
    ref_gamma,
)

__all__ = [
    "beta_norm_grad", "ggd_alpha", "ggd_grad", "ggd_loglik", "ref_gamma",
    "output_grad_and_alpha",
]
