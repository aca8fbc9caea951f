"""Device selection for the port: explicit, and never a silent CPU fallback."""

from __future__ import annotations

import torch


def resolve_device(name) -> torch.device:
    """``"cuda"``, ``"cuda:N"``, ``"cpu"`` or a ``torch.device`` -> device.

    Raises ``RuntimeError`` when a CUDA device is asked for and
    ``torch.cuda.is_available()`` is false: a request for the card never
    quietly runs on the CPU.

    Also pins fp32 numerics by setting
    ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False``.  The parity path is IEEE
    fp32 end to end; TF32 keeps about three decimal digits, which would
    move the e^-50 floor of the log-power spectrum and the de-normalized
    network output well past the tolerances the port is held to.  The
    bfloat16 products of ``compute_dtype=bfloat16`` sum in float32
    (``allow_bf16_reduced_precision_reduction = False``), as the reference's
    ``preferred_element_type=float32`` does.
    """
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {str(device)!r} requested but "
                           "torch.cuda.is_available() is false")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {str(device)!r}; "
                         "use 'cuda' or 'cpu'")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    return device


_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def resolve_compute_dtype(dtype) -> torch.dtype:
    """``"float32"``, ``"bfloat16"`` or the ``torch.dtype`` itself -> the
    ``torch.dtype``; anything else raises ``ValueError``.  These are the
    two types the network's products run in: float32 (parity) or bfloat16
    operands with float32 sums."""
    if isinstance(dtype, torch.dtype) and dtype in _COMPUTE_DTYPES.values():
        return dtype
    if isinstance(dtype, str) and dtype in _COMPUTE_DTYPES:
        return _COMPUTE_DTYPES[dtype]
    raise ValueError(f"unsupported compute dtype {dtype!r}; use "
                     f"{' or '.join(map(repr, _COMPUTE_DTYPES))}")
