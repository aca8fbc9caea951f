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
    network output well past the tolerances the port is held to.
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
    return device
