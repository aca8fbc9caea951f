"""Checkpoints: the reference ``.wts`` plus the full-state sidecar.

Port of ``tpu_se/train/checkpoint.py``:

- ``mlp.N.wts``           -- weights only, byte-compatible with the
  reference (``Interface.cc:484-516``) and with ``tpu_se``.
- ``mlp.N.wts.state.npz`` -- velocity (``vel_w_i``, ``vel_b_i``) and
  ``alpha``, so a resumed run continues bit-identically; the same keys as
  ``tpu_se``'s, so either package reads the other's sidecars.

Both files are written atomically and hold whole tensors.  Under a mesh
with a model axis the shards are gathered over it first, so a mesh writes
the bytes that one device with the same numbers would write, and a resume
reads the whole tensors on every rank and takes its shards.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from tpu_se_torch.io import atomic_write, read_wts, write_wts
from tpu_se_torch.models import params_from_numpy
from tpu_se_torch.parallel.tensor import gather_layers, shard_layers, \
    shard_params
from tpu_se_torch.train.step import TrainState, make_train_state, \
    param_layers


def save_checkpoint(path_wts: str, state: TrainState,
                    with_state: bool = True, mesh=None) -> None:
    """Write ``path_wts`` and, with ``with_state``, its sidecar.

    With ``mesh`` every rank calls it: the ranks of data index 0 gather
    their shards over the model axis, and rank 0 alone writes."""
    if mesh is not None and mesh.data_rank != 0:
        return
    layers = gather_layers(param_layers(state.model), mesh)
    velocity = gather_layers(state.velocity, mesh) if with_state else None
    if mesh is not None and mesh.rank != 0:
        return
    write_wts(path_wts, layers)
    if not with_state:
        return
    arrays = {}
    for i, layer in enumerate(velocity):
        arrays[f"vel_w_{i}"] = layer["w"]
        arrays[f"vel_b_{i}"] = layer["b"]
    arrays["alpha"] = state.alpha.cpu().numpy()
    atomic_write(state_path(path_wts), lambda f: np.savez(f, **arrays))


def model_from_layers(layers: list[dict], device, activation: str = "sigmoid",
                      mesh=None):
    """Whole numpy layers -> an ``FFN`` on ``device``, or with ``mesh`` this
    rank's ``TensorParallelFFN`` shard on the mesh's device."""
    if mesh is None:
        return params_from_numpy(layers, device, activation=activation)
    return shard_params(layers, mesh, activation=activation)


def load_checkpoint(path_wts: str, device, activation: str = "sigmoid",
                    mesh=None) -> TrainState:
    """Read ``path_wts`` (and its sidecar, when present) onto ``device``;
    with ``mesh``, this rank's shards of them."""
    model = model_from_layers(read_wts(path_wts), device, activation, mesh)
    state = make_train_state(model)
    spath = state_path(path_wts)
    if os.path.exists(spath):
        with np.load(spath) as z:
            velocity = [{"w": z[f"vel_w_{i}"], "b": z[f"vel_b_{i}"]}
                        for i in range(len(state.velocity))]
            alpha = z["alpha"]
        if mesh is not None:
            velocity = shard_layers(velocity, mesh)
        state.velocity = [
            {k: torch.from_numpy(np.ascontiguousarray(layer[k])).to(device)
             for k in ("w", "b")} for layer in velocity]
        state.alpha = torch.from_numpy(alpha).to(device)
    return state


def state_path(path_wts: str) -> str:
    return path_wts + ".state.npz"
