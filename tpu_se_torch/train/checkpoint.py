"""Checkpoints: the reference ``.wts`` plus the full-state sidecar.

Port of ``tpu_se/train/checkpoint.py``:

- ``mlp.N.wts``           -- weights only, byte-compatible with the
  reference (``Interface.cc:484-516``) and with ``tpu_se``.
- ``mlp.N.wts.state.npz`` -- velocity (``vel_w_i``, ``vel_b_i``) and
  ``alpha``, so a resumed run continues bit-identically; the same keys as
  ``tpu_se``'s, so either package reads the other's sidecars.

Both files are written atomically.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_se_torch.io import atomic_write, read_wts, write_wts
from tpu_se_torch.models import params_from_numpy, params_to_numpy
from tpu_se_torch.train.step import TrainState, make_train_state


def save_checkpoint(path_wts: str, state: TrainState,
                    with_state: bool = True) -> None:
    """Write ``path_wts`` and, with ``with_state``, its sidecar."""
    write_wts(path_wts, params_to_numpy(state.model))
    if not with_state:
        return
    arrays = {}
    for i, layer in enumerate(state.velocity):
        arrays[f"vel_w_{i}"] = layer["w"].cpu().numpy()
        arrays[f"vel_b_{i}"] = layer["b"].cpu().numpy()
    arrays["alpha"] = state.alpha.cpu().numpy()
    atomic_write(state_path(path_wts), lambda f: np.savez(f, **arrays))


def load_checkpoint(path_wts: str, device,
                    activation: str = "sigmoid") -> TrainState:
    """Read ``path_wts`` (and its sidecar, when present) onto ``device``."""
    model = params_from_numpy(read_wts(path_wts), device,
                              activation=activation)
    state = make_train_state(model)
    spath = state_path(path_wts)
    if os.path.exists(spath):
        with np.load(spath) as z:
            state.velocity = [
                {"w": torch.from_numpy(z[f"vel_w_{i}"]).to(device),
                 "b": torch.from_numpy(z[f"vel_b_{i}"]).to(device)}
                for i in range(len(state.velocity))]
            state.alpha = torch.from_numpy(z["alpha"]).to(device)
    return state


def state_path(path_wts: str) -> str:
    return path_wts + ".state.npz"
