"""Fused ML-GGD output gradient: (out, targ, beta) -> (dedx, alpha).

Port of ``tpu_se/ops/ggd_kernel.py:ggd_output_grad_pallas``: the raw
error, the per-dimension |e|^beta column reduction, the closed-form alpha
and the scaled gradient (with the loss-side 1/M), as one hand-written
Hopper kernel (``csrc/ggd_kernel.cu``).  The TPU kernel is one ungridded
block and takes M <= ~1024; this one is one launch of thread-block
clusters, one cluster per strip of columns: the blocks of a cluster split
the rows, read ``out`` and ``targ`` once, keep the error on chip and
exchange their column sums through distributed shared memory in a fixed
order, without atomics, so any M >= 1 works and reruns are bitwise
identical.

- ``ggd_output_grad_cuda``  launches the kernel; CUDA tensors only, never
  falls back.
- ``ggd_output_grad_plain`` is the same function in plain PyTorch (the
  composition of ``tpu_se_torch.losses``' ``ggd_alpha`` and ``ggd_grad``):
  the CPU path and the reference that the kernel is held against on the
  card.
- ``plan`` mirrors the C launcher's choice of block shape and of where the
  error is kept, from (M, D) alone (``ggd_plan`` in the library).
- ``launches`` counts ``ggd_output_grad_cuda``'s calls that launched the
  kernel (and nothing else), so a run can show that its main path went
  through the kernel.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from tpu_se_torch.losses.objectives import ggd_alpha, ggd_grad

# As in csrc/ggd_kernel.cu.
CLUSTER = 8                   # blocks per cluster, splitting the rows
THREADS = 256                 # threads per block
WIDE_MAX_M = 1024             # strips of 32 columns up to here, 16 above
TILE_BYTES = 96 * 1024        # most of the error a block keeps on chip
MAX_ROWS = 2**31 - 1          # M and D are C ints

launches = 0


def ggd_output_grad_plain(out: torch.Tensor, targ: torch.Tensor,
                          beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, targ) [M, D] -> (dedx [M, D] including 1/M, alpha [D]), in
    PyTorch on the tensors' device."""
    err = out - targ
    alpha = ggd_alpha(err, beta)
    return ggd_grad(err, alpha, beta) / out.shape[0], alpha


class GgdPlan(NamedTuple):
    """What the launcher does with an [M, D] bunch."""
    cols: int             # columns per strip, one cluster per strip
    threads: int          # threads per block
    cluster: int          # blocks per cluster, splitting the rows
    rows_per_block: int
    keep: int             # 1: out and targ are read once; 0: twice


def plan(m: int, d: int) -> GgdPlan:
    """The C launcher's plan rule (``make_plan`` in csrc/ggd_kernel.cu)."""
    cols = 32 if m <= WIDE_MAX_M else 16
    rows = -(-m // CLUSTER)
    keep = int(rows * cols * 4 <= TILE_BYTES)
    return GgdPlan(cols, THREADS, CLUSTER, rows, keep)


# The last M of each plan but the last (the plan changes at M + 1): the
# strips narrow, then the error no longer fits the shared-memory tile.
PLAN_SWITCH_ROWS = (WIDE_MAX_M, CLUSTER * (TILE_BYTES // (16 * 4)))


def check_ggd_args(out: torch.Tensor, targ: torch.Tensor) -> None:
    """Raise ``ValueError`` unless (out, targ) is what the kernel takes:
    float32, 2-D, contiguous, equal non-empty shapes of at most
    ``MAX_ROWS`` rows and columns, CUDA and on one device.  The device is
    checked last, so every other check can be tested on the CPU."""
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
    if m > MAX_ROWS or d > MAX_ROWS:
        raise ValueError(f"ggd_output_grad_cuda: bunch {(m, d)} exceeds the "
                         f"kernel's int32 rows and columns ({MAX_ROWS})")
    for name, x in (("out", out), ("targ", targ)):
        if x.device.type != "cuda":
            raise ValueError(f"ggd_output_grad_cuda: {name} must be a CUDA "
                             f"tensor, got {x.device}")
    if out.device != targ.device:
        raise ValueError(f"ggd_output_grad_cuda: out on {out.device}, targ "
                         f"on {targ.device}")


@functools.lru_cache(maxsize=8)
def _beta_args(beta: float) -> tuple[float, float, float]:
    """beta, beta - 1 and 1 / beta rounded to float32, as JAX's weak-typed
    scalars are."""
    return (float(np.float32(beta)), float(np.float32(beta - 1.0)),
            float(np.float32(1.0 / beta)))


def ggd_output_grad_cuda(out: torch.Tensor, targ: torch.Tensor, beta: float,
                         *, general: bool = False
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, targ) [M, D] -> (dedx [M, D] including 1/M, alpha [D]) on the
    card.

    Launches ``ggd_output_grad`` once on PyTorch's current stream without a
    synchronise; raises on bad arguments or a refused launch.  Both outputs
    are views of one allocation.  ``general`` (for the checks on the card)
    takes ``powf`` at beta == 1 too, which the kernel otherwise replaces by
    |e| and +-1.
    """
    global launches
    from tpu_se_torch.ops._build import load_library

    check_ggd_args(out, targ)
    m, d = out.shape
    buf = torch.empty((m + 1, d), dtype=torch.float32, device=out.device)
    lib, _ = load_library()
    fn = lib.ggd_output_grad_general if general else lib.ggd_output_grad
    base = buf.data_ptr()
    with torch.cuda.device(out.device):
        rc = fn(out.data_ptr(), targ.data_ptr(), base, base + 4 * m * d, m, d,
                *_beta_args(beta), torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ggd_output_grad launch failed: CUDA error {rc}")
    launches += 1
    return buf[:m], buf[m]
