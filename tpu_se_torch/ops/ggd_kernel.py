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
  through the kernel.  A training bunch replayed from a CUDA graph runs
  the kernel without calling the wrapper: ``train/step.py`` adds one per
  replay and takes back the capture's call, which launched nothing.

The split form, for data-parallel training: alpha is a statistic of the
GLOBAL bunch, of which a rank holds only its rows, so the other ranks'
column sums enter between the sums and the gradient.

- ``ggd_colsum_cuda(out, targ, beta) -> sums [D]`` launches the kernel's
  first three steps (``ggd_colsum`` in the library): sum_m |e|^beta over
  this rank's rows, not yet the mean.
- ``ggd_grad_from_sums_cuda(out, targ, sums, m_global, beta) -> (dedx,
  alpha)`` launches the rest (``ggd_grad_from_sums``): alpha and the scale
  from the given sums over ``m_global`` rows, then the gradient of this
  rank's rows with 1 / ``m_global``.
- The caller adds the ranks' sums in between (an all-reduce of D floats).
  Fed its own sums with ``m_global = M`` the pair gives the fused kernel's
  bits: the three share their device code and their sum order.
- ``ggd_colsum_plain`` / ``ggd_grad_from_sums_plain`` are the same two
  functions in plain PyTorch, and on the CPU their composition at one rank
  is ``ggd_output_grad_plain`` bit for bit.
- ``colsum_launches`` / ``grad_from_sums_launches`` count the two wrappers'
  launches as ``launches`` counts the fused one's.
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
colsum_launches = 0
grad_from_sums_launches = 0


def ggd_output_grad_plain(out: torch.Tensor, targ: torch.Tensor,
                          beta: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(out, targ) [M, D] -> (dedx [M, D] including 1/M, alpha [D]), in
    PyTorch on the tensors' device."""
    err = out - targ
    alpha = ggd_alpha(err, beta)
    return ggd_grad(err, alpha, beta) / out.shape[0], alpha


def ggd_colsum_plain(out: torch.Tensor, targ: torch.Tensor,
                     beta: float) -> torch.Tensor:
    """(out, targ) [M, D] -> sum_m |out - targ|^beta [D], in PyTorch on the
    tensors' device: the numerator of ``ggd_alpha``'s mean."""
    return torch.sum((out - targ).abs() ** beta, dim=0)


def ggd_grad_from_sums_plain(out: torch.Tensor, targ: torch.Tensor,
                             sums: torch.Tensor, m_global: int, beta: float
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (out, targ) [M, D] and the column sums [D] of
    |e|^beta over all ``m_global`` rows of the bunch -> (dedx [M, D]
    including 1 / m_global, alpha [D] of the global bunch)."""
    alpha = (beta * (sums / m_global)) ** (1.0 / beta)
    return ggd_grad(out - targ, alpha, beta) / m_global, alpha


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


def check_ggd_args(out: torch.Tensor, targ: torch.Tensor,
                   fn: str = "ggd_output_grad_cuda") -> None:
    """Raise ``ValueError`` (in the name of wrapper ``fn``) unless (out,
    targ) is what the kernel takes: float32, 2-D, contiguous, equal
    non-empty shapes of at most ``MAX_ROWS`` rows and columns, CUDA and on
    one device.  The device is checked last, so every other check can be
    tested on the CPU."""
    for name, x in (("out", out), ("targ", targ)):
        if x.dtype != torch.float32:
            raise ValueError(f"{fn}: {name} must be float32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"{fn}: {name} must be 2-D, got shape "
                             f"{tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")
    if out.shape != targ.shape:
        raise ValueError(f"{fn}: out {tuple(out.shape)} and targ "
                         f"{tuple(targ.shape)} differ in shape")
    m, d = out.shape
    if m == 0 or d == 0:
        raise ValueError(f"{fn}: empty bunch {(m, d)}")
    if m > MAX_ROWS or d > MAX_ROWS:
        raise ValueError(f"{fn}: bunch {(m, d)} exceeds the kernel's int32 "
                         f"rows and columns ({MAX_ROWS})")
    for name, x in (("out", out), ("targ", targ)):
        if x.device.type != "cuda":
            raise ValueError(f"{fn}: {name} must be a CUDA tensor, got "
                             f"{x.device}")
    if out.device != targ.device:
        raise ValueError(f"{fn}: out on {out.device}, targ on {targ.device}")


def check_sums_arg(sums: torch.Tensor, out: torch.Tensor, m_global: int
                   ) -> None:
    """Raise ``ValueError`` unless ``sums`` and ``m_global`` are what
    ``ggd_grad_from_sums_cuda`` takes beside a checked ``out`` [M, D]:
    float32 [D], contiguous, on ``out``'s device, over at least M and at
    most ``MAX_ROWS`` rows."""
    fn = "ggd_grad_from_sums_cuda"
    if sums.dtype != torch.float32:
        raise ValueError(f"{fn}: sums must be float32, got {sums.dtype}")
    if tuple(sums.shape) != (out.shape[1],) or not sums.is_contiguous():
        raise ValueError(f"{fn}: sums must be a contiguous [{out.shape[1]}] "
                         f"vector, got shape {tuple(sums.shape)}")
    if not out.shape[0] <= m_global <= MAX_ROWS:
        raise ValueError(f"{fn}: m_global {m_global} is not between this "
                         f"rank's {out.shape[0]} rows and {MAX_ROWS}")
    if sums.device != out.device:
        raise ValueError(f"{fn}: sums on {sums.device}, out on {out.device}")


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


def ggd_colsum_cuda(out: torch.Tensor, targ: torch.Tensor, beta: float
                    ) -> torch.Tensor:
    """(out, targ) [M, D] -> sum_m |out - targ|^beta [D] on the card: the
    fused kernel's first three steps, the sums added in its order.

    Launches ``ggd_colsum`` once on PyTorch's current stream without a
    synchronise; raises on bad arguments or a refused launch.
    """
    global colsum_launches
    from tpu_se_torch.ops._build import load_library

    check_ggd_args(out, targ, "ggd_colsum_cuda")
    m, d = out.shape
    sums = torch.empty(d, dtype=torch.float32, device=out.device)
    lib, _ = load_library()
    with torch.cuda.device(out.device):
        rc = lib.ggd_colsum(out.data_ptr(), targ.data_ptr(), sums.data_ptr(),
                            m, d, _beta_args(beta)[0],
                            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ggd_colsum launch failed: CUDA error {rc}")
    colsum_launches += 1
    return sums


def ggd_grad_from_sums_cuda(out: torch.Tensor, targ: torch.Tensor,
                            sums: torch.Tensor, m_global: int, beta: float
                            ) -> tuple[torch.Tensor, torch.Tensor]:
    """This rank's (out, targ) [M, D] and the bunch's column sums [D] over
    ``m_global`` rows -> (dedx [M, D] including 1 / m_global, alpha [D])
    on the card: the fused kernel's alpha arithmetic and gradient step.

    Launches ``ggd_grad_from_sums`` once on PyTorch's current stream without
    a synchronise; raises on bad arguments or a refused launch.  Both
    outputs are views of one allocation.
    """
    global grad_from_sums_launches
    from tpu_se_torch.ops._build import load_library

    check_ggd_args(out, targ, "ggd_grad_from_sums_cuda")
    check_sums_arg(sums, out, m_global)
    m, d = out.shape
    buf = torch.empty((m + 1, d), dtype=torch.float32, device=out.device)
    lib, _ = load_library()
    base = buf.data_ptr()
    with torch.cuda.device(out.device):
        rc = lib.ggd_grad_from_sums(
            out.data_ptr(), targ.data_ptr(), sums.data_ptr(), base,
            base + 4 * m * d, m, d, m_global, *_beta_args(beta),
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ggd_grad_from_sums launch failed: CUDA error "
                           f"{rc}")
    grad_from_sums_launches += 1
    return buf[:m], buf[m]
