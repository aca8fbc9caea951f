"""Fused ML-GGD output gradient: (out, targ, beta) -> (dedx, alpha).

Port of ``tpu_se/ops/ggd_kernel.py:ggd_output_grad_pallas``: the raw
error, the per-dimension |e|^beta column reduction, the closed-form alpha
and the scaled gradient (with the loss-side 1/M), as one hand-written
Hopper kernel (``csrc/ggd_kernel.cu``).  The TPU kernel is one ungridded
block and takes M <= ~1024; this one tiles M in two launches (column
partial sums, then finalize + elementwise), without atomics, so any
M >= 1 works and reruns are bitwise identical.

- ``ggd_output_grad_cuda``  launches the kernel; CUDA tensors only, never
  falls back.
- ``ggd_output_grad_plain`` is the same function in plain PyTorch (the
  composition of ``tpu_se_torch.losses``' ``ggd_alpha`` and ``ggd_grad``):
  the CPU path and the reference that the kernel is held against on the
  card.
- ``launches`` counts ``ggd_output_grad_cuda``'s calls that launched the
  kernel (and nothing else), so a run can show that its main path went
  through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_se_torch.losses.objectives import ggd_alpha, ggd_grad

TILE_M = 128          # rows per block, as kTileM in csrc/ggd_kernel.cu
MAX_GRID_Y = 65535

launches = 0


def ggd_output_grad_plain(out: torch.Tensor, targ: torch.Tensor,
                          beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, targ) [M, D] -> (dedx [M, D] including 1/M, alpha [D]), in
    PyTorch on the tensors' device."""
    err = out - targ
    alpha = ggd_alpha(err, beta)
    return ggd_grad(err, alpha, beta) / out.shape[0], alpha


def check_ggd_args(out: torch.Tensor, targ: torch.Tensor) -> None:
    """Raise ``ValueError`` unless (out, targ) is what the kernel takes:
    float32, 2-D, contiguous, equal non-empty shapes within the grid, CUDA
    and on one device.  The device is checked last, so every other check
    can be tested on the CPU."""
    for name, x in (("out", out), ("targ", targ)):
        if x.dtype != torch.float32:
            raise ValueError(f"ggd_output_grad_cuda: {name} must be float32, "
                             f"got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"ggd_output_grad_cuda: {name} must be 2-D, got "
                             f"shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"ggd_output_grad_cuda: {name} must be "
                             "contiguous")
    if out.shape != targ.shape:
        raise ValueError(f"ggd_output_grad_cuda: out {tuple(out.shape)} and "
                         f"targ {tuple(targ.shape)} differ in shape")
    m, d = out.shape
    if m == 0 or d == 0:
        raise ValueError(f"ggd_output_grad_cuda: empty bunch {(m, d)}")
    if -(-m // TILE_M) > MAX_GRID_Y:
        raise ValueError(f"ggd_output_grad_cuda: {m} rows exceed the "
                         f"kernel's grid ({MAX_GRID_Y} * {TILE_M})")
    for name, x in (("out", out), ("targ", targ)):
        if x.device.type != "cuda":
            raise ValueError(f"ggd_output_grad_cuda: {name} must be a CUDA "
                             f"tensor, got {x.device}")
    if out.device != targ.device:
        raise ValueError(f"ggd_output_grad_cuda: out on {out.device}, targ "
                         f"on {targ.device}")


def ggd_output_grad_cuda(out: torch.Tensor, targ: torch.Tensor,
                         beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, targ) [M, D] -> (dedx [M, D] including 1/M, alpha [D]) on the
    card.

    Launches ``ggd_output_grad`` on PyTorch's current stream without a
    synchronise; raises on bad arguments or a refused launch.  beta - 1 and
    1 / beta are rounded to float32 here, as JAX's weak-typed scalars are.
    """
    global launches
    from tpu_se_torch.ops._build import load_library

    check_ggd_args(out, targ)
    m, d = out.shape
    dedx = torch.empty_like(out)
    alpha = torch.empty(d, dtype=torch.float32, device=out.device)
    partial = torch.empty((-(-m // TILE_M), d), dtype=torch.float32,
                          device=out.device)
    lib, _ = load_library()
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.ggd_output_grad(
            out.data_ptr(), targ.data_ptr(), dedx.data_ptr(),
            alpha.data_ptr(), partial.data_ptr(), m, d,
            float(np.float32(beta)), float(np.float32(beta - 1.0)),
            float(np.float32(1.0 / beta)), stream)
    if rc != 0:
        raise RuntimeError(f"ggd_output_grad launch failed: CUDA error {rc}")
    launches += 1
    return dedx, alpha
