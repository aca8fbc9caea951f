"""Fused LPS front end: frames -> log-power spectrum, as one Hopper kernel.

Port of ``tpu_se/ops/lps_kernel.py:lps_pallas``: the product of the frames
with the windowed-DFT basis, ``re^2 + im^2`` and the floored log in one
pass (``csrc/lps_kernel.cu``).  Unlike the TPU kernel it takes the unpadded
``[L, 2K]`` basis and writes ``[T, K]`` directly: no 384-lane padding and no
slice afterwards, and ``L`` is a parameter, so the 8/11 kHz 256-point
framings (129 bins) use it too.  The product is summed in float64 on the
CUDA cores, and only re and im are rounded to float32 before the float32
epilogue: the LPS is the exact product's to within float32 rounding.

- ``lps_cuda``  launches the kernel; CUDA tensors only, never falls back.
- ``lps_plain`` is the same function in plain PyTorch: the CPU path and the
  reference that the kernel is held against on the card.
- ``launches`` counts ``lps_cuda``'s kernel launches (and nothing else), so
  a run can show that its main path went through the kernel.
"""

from __future__ import annotations

import numpy as np
import torch

LOG_FLOOR = -50.0
# The exact float32 constant JAX compares against (tpu_se/dsp/analysis.py);
# passed to the kernel rather than recomputed with expf on the device,
# which could differ by an ulp.
POWER_FLOOR = float(np.float32(np.exp(LOG_FLOOR)))

launches = 0


def floored_log(power: torch.Tensor) -> torch.Tensor:
    """power < e^-50 -> -50, else log(power) (``Wav2LogSpec_be.c:475-479``).

    Python scalars, not tensors, for the constants: a host-to-device copy
    of a constant would synchronise the host with the card on every call.
    """
    return torch.where(power < POWER_FLOOR, LOG_FLOOR, torch.log(power))


def lps_plain(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """frames [T, L] @ basis [L, 2K] -> floored log power [T, K], in PyTorch.

    Like the kernel, the product is summed in float64 and only re/im are
    rounded to float32: an fp32 sum misses the log power of a bin 60 dB
    below its frame by ~1e-3 (see ``csrc/lps_kernel.cu``).
    """
    n_bins = basis.shape[1] // 2
    spec = (frames.double() @ basis.double()).float()
    re, im = spec[:, :n_bins], spec[:, n_bins:]
    return floored_log(re * re + im * im)


def check_lps_args(frames: torch.Tensor, basis: torch.Tensor) -> None:
    """Raise ``ValueError`` unless (frames, basis) is what the kernel takes:
    both CUDA, float32, contiguous, 2-D, on one device, ``basis`` of shape
    [L, 2K] with ``L == frames.shape[1]``, and the grid within launch limits.
    The device is checked last, so every other check can be tested on CPU.
    """
    for name, x in (("frames", frames), ("basis", basis)):
        if x.dtype != torch.float32:
            raise ValueError(f"lps_cuda: {name} must be float32, got {x.dtype}")
        if x.dim() != 2:
            raise ValueError(f"lps_cuda: {name} must be 2-D, got "
                             f"shape {tuple(x.shape)}")
        if not x.is_contiguous():
            raise ValueError(f"lps_cuda: {name} must be contiguous")
    if basis.shape[0] != frames.shape[1]:
        raise ValueError(f"lps_cuda: frame length {frames.shape[1]} != basis "
                         f"rows {basis.shape[0]}")
    if basis.shape[1] % 2 or basis.shape[1] == 0:
        raise ValueError(f"lps_cuda: basis must have 2K columns, got "
                         f"{basis.shape[1]}")
    if frames.shape[0] > 65535 * 64:
        raise ValueError(f"lps_cuda: {frames.shape[0]} frames exceed the "
                         "kernel's grid (65535 * 64)")
    for name, x in (("frames", frames), ("basis", basis)):
        if x.device.type != "cuda":
            raise ValueError(f"lps_cuda: {name} must be a CUDA tensor, "
                             f"got {x.device}")
    if frames.device != basis.device:
        raise ValueError(f"lps_cuda: frames on {frames.device}, basis on "
                         f"{basis.device}")


def lps_cuda(frames: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """frames [T, L] @ basis [L, 2K] -> floored log power [T, K] on the card.

    Launches ``lps_forward`` on PyTorch's current stream without a
    synchronise; raises on bad arguments or a refused launch.  T == 0
    returns an empty result without a launch.
    """
    global launches
    from tpu_se_torch.ops._build import load_library

    check_lps_args(frames, basis)
    t, length = frames.shape
    n_bins = basis.shape[1] // 2
    out = torch.empty((t, n_bins), dtype=torch.float32, device=frames.device)
    if t == 0:
        return out
    lib, _ = load_library()
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.lps_forward(frames.data_ptr(), basis.data_ptr(),
                             out.data_ptr(), t, length, n_bins, LOG_FLOOR,
                             POWER_FLOOR, stream)
    if rc != 0:
        raise RuntimeError(f"lps_forward launch failed: CUDA error {rc}")
    launches += 1
    return out
