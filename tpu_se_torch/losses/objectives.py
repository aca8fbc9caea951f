"""Training objectives: the beta-norm and the ML-GGD output gradient.

Port of ``tpu_se/losses/objectives.py`` (reference
``Train_code_ML_GGD/BP_GPU.cu:396-426``, ``DevFunc.cu:376-398,468-489``):

- beta-norm (MLflag=0): output gradient ``beta * sign(y - t) *
  |y - t|^(beta-1)`` with the e == 0 branch forced to 0.  No TPU kernel
  carried it, so it stays plain PyTorch on every device.
- ML-GGD (MLflag=1): per-dimension scale factors re-estimated in closed
  form every bunch from the raw error, ``alpha_d = (beta/M * sum_m
  |e_md|^beta)^(1/beta)``, then ``beta * sign(e) * |e|^(beta-1) /
  alpha_d^beta``.  ``output_grad_and_alpha(ml=True)`` runs the fused Hopper
  kernel (``tpu_se_torch.ops.ggd_kernel``) on a CUDA tensor, and the plain
  composition of ``ggd_alpha`` and ``ggd_grad`` on a CPU one.  Under a mesh
  alpha is a statistic of the GLOBAL bunch: the kernel runs in its split
  form, the data axis' column sums all-reduced between its two launches.

Both gradients carry the loss-side 1/M (``DevVecMulNum``); the optimizer
divides by M again in parity mode.  ``ggd_loglik`` and ``ref_gamma`` are
host-side numpy/Python, as in the JAX package.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def _sign_pow(e: torch.Tensor, exponent: float) -> torch.Tensor:
    """sign(e) * |e|^exponent with the e == 0 branch exactly 0 (the
    where-guard also keeps the value finite for exponent < 0, beta < 1)."""
    abs_e = e.abs()
    zero = abs_e == 0.0
    safe = torch.where(zero, 1.0, abs_e)
    return torch.where(zero, 0.0, torch.sign(e) * safe ** exponent)


def beta_norm_grad(out: torch.Tensor, targ: torch.Tensor,
                   beta: float) -> torch.Tensor:
    """d/d_out of sum |targ - out|^beta, elementwise [M, D]."""
    return beta * _sign_pow(out - targ, beta - 1.0)


def ggd_alpha(err: torch.Tensor, beta: float) -> torch.Tensor:
    """Closed-form ML scale factors [D] from the raw error [M, D]:
    ``alpha = (beta * mean_m |e|^beta)^(1/beta)`` (``BP_GPU.cu:413-420``)."""
    mean_pow = torch.mean(err.abs() ** beta, dim=0)
    return (beta * mean_pow) ** (1.0 / beta)


def ggd_grad(err: torch.Tensor, alpha: torch.Tensor,
             beta: float) -> torch.Tensor:
    """ML-GGD output gradient [M, D] given the raw error and the scale
    factors; alpha_d == 0 (all-zero error in dim d) maps to 0, not 0*inf."""
    zero = alpha == 0.0
    safe_alpha = torch.where(zero, 1.0, alpha)
    scale = torch.where(zero, 0.0, beta / safe_alpha ** beta)
    return _sign_pow(err, beta - 1.0) * scale


def output_grad_and_alpha(out: torch.Tensor, targ: torch.Tensor, beta: float,
                          ml: bool, mesh=None
                          ) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's output-layer gradient for one bunch -> (dedx [M, D]
    including the loss-side 1/M, alpha [D]; ones when ``ml`` is false).

    ``ml=True`` on a CUDA tensor launches the GGD kernel (and raises if it
    cannot); on a CPU tensor it runs the kernel's plain version.

    With ``mesh`` (a ``tpu_se_torch.parallel.Mesh``) ``out`` and ``targ``
    are this rank's M / data rows of the bunch: the column sums of
    |e|^beta are added over the data axis (one all-reduce of D floats),
    alpha is the global bunch's on every rank, and the 1/M is the global
    M's.  The ranks of a model line hold the same output bits and compute
    the same sums, so nothing crosses the model axis.  The beta-norm needs
    no statistic, only that 1/M.
    """
    m_global = out.shape[0] * (1 if mesh is None else mesh.data)
    if ml:
        # Imported here: the kernel module's plain versions are built from
        # this module's functions.
        from tpu_se_torch.ops import ggd_kernel

        if out.device.type not in ("cuda", "cpu"):
            raise ValueError(f"no GGD gradient path for device {out.device}")
        on_card = out.device.type == "cuda"
        if mesh is None:
            fused = (ggd_kernel.ggd_output_grad_cuda if on_card
                     else ggd_kernel.ggd_output_grad_plain)
            return fused(out, targ, beta)
        colsum, from_sums = (
            (ggd_kernel.ggd_colsum_cuda, ggd_kernel.ggd_grad_from_sums_cuda)
            if on_card else
            (ggd_kernel.ggd_colsum_plain,
             ggd_kernel.ggd_grad_from_sums_plain))
        sums = mesh.all_reduce_sum(colsum(out, targ, beta), "data")
        return from_sums(out, targ, sums, m_global, beta)
    alpha = torch.ones(out.shape[1], dtype=out.dtype, device=out.device)
    return beta_norm_grad(out, targ, beta) / m_global, alpha


def ggd_loglik(err, alpha, beta: float, use_ref_gamma: bool = True) -> float:
    """GGD log-likelihood of a CV set, as ``CrossValid2`` reports it:
    ``n*D*log(beta/(2*Gamma(1/beta))) - n*sum_d log(alpha_d)
    - sum_{m,d} |e_md / alpha_d|^beta`` (``BP_GPU.cu:254-306``).

    Host numpy; ``use_ref_gamma`` selects the reference's polynomial
    Gamma (digit parity with its logs), otherwise the exact lgamma.
    """
    err = np.asarray(err, dtype=np.float32)
    alpha = np.asarray(alpha, dtype=np.float32)
    n, d = err.shape
    if use_ref_gamma:
        gamma_val = ref_gamma(1.0 / beta)
    else:
        gamma_val = math.exp(math.lgamma(1.0 / beta))
    t1 = n * d * math.log(beta / (2.0 * gamma_val))
    t2 = float(n * np.sum(np.log(alpha)))
    t3 = float(np.sum((np.abs(err) / alpha) ** np.float32(beta)))
    return t1 - t2 - t3


def ref_gamma(x: float) -> float:
    """The reference's polynomial Gamma(x) (``BP_GPU.cu:593-640``): a
    degree-10 polynomial on (2, 3] plus the recurrence Gamma(x+1) =
    x Gamma(x), within ~1e-5 of the exact Gamma on (0, 5]."""
    coeffs = [0.0000677106, -0.0003442342, 0.0015397681, -0.0024467480,
              0.0109736958, -0.0002109075, 0.0742379071, 0.0815782188,
              0.4118402518, 0.4227843370, 1.0000000000]
    if 2.0 < x <= 3.0:
        t = x - 2.0
        acc = 0.0
        for i, c in enumerate(coeffs):
            acc += c * t ** (10 - i)
        return acc
    if 0.0 < x <= 1.0:
        return ref_gamma(x + 2.0) / (x * (x + 1.0))
    if 1.0 < x <= 2.0:
        return ref_gamma(x + 1.0) / x
    if x > 3.0:
        prod = 1.0
        while x > 3.0:
            x -= 1.0
            prod *= x
        return prod * ref_gamma(x)
    return 0.0
