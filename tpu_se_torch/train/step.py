"""The training step: one Python loop over the bunches of a chunk.

Port of ``tpu_se/train/step.py`` (reference per-bunch loop
``BP_GPU.cu:152-185,308-440``).  Where JAX runs the bunches of a chunk
inside one ``lax.scan``, the port runs them as a Python loop of eager
launches on the card:

- The 7-frame context splice is a device gather from the chunk's (or the
  resident span's) frame matrix; the chunk's window starts arrive as one
  ``[n_bunches, M]`` device tensor, so the loop itself never copies to or
  from the host and never synchronises.
- The backward pass is ``torch.autograd.grad`` of the forward with an
  EXPLICIT output cotangent, the reference's hand-written gradient chain
  (its 1/M and e==0 conventions), not the gradient of a scalar loss.  The
  cotangent comes from ``output_grad_and_alpha`` -- on the card the GGD
  kernel -- which nothing differentiates through, just as JAX feeds it to
  ``vjp``; so the kernel needs no ``autograd.Function``.
- With ``hyper.compute_dtype = torch.bfloat16`` the products of the forward
  and backward pass take bfloat16 operands and sum in float32
  (``models/ffn.py:reduced_linear``); the weights are cast once per bunch,
  inside the layer that keeps the copies for its backward pass.  The
  network's output, the GGD gradient, alpha, the velocity and the weights
  stay float32.
- Partial bunches are dropped by the caller (``starts[: n_bunches*M]``).
- Under a mesh (``mesh=``, one rank per device) a rank takes M / data
  rows of every bunch.  Where GSPMD turns the reference's batch reductions
  into psums, the port writes them out over the data axis, two collectives
  per bunch: the GGD column sums (D floats) between the split kernel's two
  launches, so that alpha is the global bunch's, and the gradients,
  flattened into one buffer, after the backward pass.  Both are SUMS: the
  reference's explicit 1/M (the global M) is already in the cotangent, so
  nothing is averaged as DistributedDataParallel would.  Every rank then
  applies the same update to its replica.  With bfloat16 products each
  rank rounds its partial ``dW`` to bfloat16 as one device does
  (``_ReducedLinear``) and the all-reduce adds the rounded partials in
  float32: the rounding falls before the sum, per rank, which is how the
  reference's narrowed all-reduce reads.
- With a model axis (``mesh.model > 1``) the state's model is this rank's
  ``TensorParallelFFN`` shard, whose forward and backward passes carry the
  model axis' collectives; the update applies to shards and replicated
  tensors alike, since every rank of a model line holds the same bits in
  what it replicates.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from tpu_se_torch.losses import output_grad_and_alpha
from tpu_se_torch.models import FFN
from tpu_se_torch.parallel.tensor import TensorParallelFFN
from tpu_se_torch.train.optim import sgd_momentum_init, sgd_momentum_update
from tpu_se_torch.utils.device import resolve_compute_dtype


@dataclass(frozen=True)
class TrainHyper:
    """Training hyper-parameters.

    ``grad_scale='parity'`` reproduces the reference's double 1/M (loss
    gradient / M, then the optimizer's grad/n again); ``'natural'``
    applies the bunch mean once.  ``compute_dtype`` (``torch.float32``,
    ``torch.bfloat16`` or their names) is the type of the products'
    operands; ``act_dtype`` optionally narrows the hidden activations.
    Both are throughput knobs: parity keeps the defaults.
    """
    beta: float = 1.0
    ml: bool = True
    momentum: float = 0.9
    weightcost: float = 1e-5
    bunchsize: int = 128
    context: int = 7
    targ_offset: int = 3
    grad_scale: str = "parity"   # "parity" | "natural"
    compute_dtype: Any = torch.float32
    activation: str = "sigmoid"  # "sigmoid" | "relu" (the #ifdef RELU build)
    dropout: tuple | None = None  # (visible_omit, hid_omit) or None
    act_dtype: Any = None        # reduced-precision hidden activations

    def __post_init__(self):
        if self.grad_scale not in ("parity", "natural"):
            raise ValueError(f"bad grad_scale {self.grad_scale!r}")
        # Names become dtypes here (the dataclass is frozen).
        object.__setattr__(self, "compute_dtype",
                           resolve_compute_dtype(self.compute_dtype))
        if self.act_dtype is not None:
            object.__setattr__(self, "act_dtype",
                               resolve_compute_dtype(self.act_dtype))


@dataclass
class TrainState:
    model: FFN | TensorParallelFFN   # trained in place
    velocity: list              # [{"w", "b"}] tensors, like the params
    alpha: torch.Tensor         # last-bunch GGD scale factors [D]


def param_layers(model: FFN) -> list[dict]:
    """The model's parameters as ``[{"w": [n_in, n_out], "b": [n_out]}]``
    (the same tensors, not copies)."""
    return [{"w": w, "b": b} for w, b in zip(model.weights, model.biases)]


def make_train_state(model: FFN) -> TrainState:
    """Zero velocity and unit alpha for ``model``."""
    out_dim = model.biases[-1].shape[0]
    return TrainState(model, sgd_momentum_init(param_layers(model)),
                      torch.ones(out_dim, dtype=torch.float32,
                                 device=model.biases[-1].device))


def gather_splice(frames: torch.Tensor, starts: torch.Tensor, context: int
                  ) -> torch.Tensor:
    """frames [F, D] + starts [M] (int64) -> spliced [M, context*D], a
    gather on the frames' device."""
    idx = starts[:, None] + torch.arange(context, device=starts.device)
    return frames[idx].reshape(starts.shape[0], context * frames.shape[1])


def train_chunk(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
                starts: torch.Tensor, lr: float, hyper: TrainHyper,
                generator: torch.Generator | None = None,
                mesh=None) -> TrainState:
    """Train all full bunches of one chunk, in place; returns ``state``.

    noisy/clean: [F, D] normalized frames; starts: [n_bunches, M] int64
    window starts (shuffled), all on one device.  ``lr`` is rounded to
    float32 first, as JAX's ``jnp.float32(lr)``.  ``generator`` (on that
    device) draws the dropout masks when ``hyper.dropout`` is set.  alpha
    after the call is the last bunch's.

    With ``mesh`` (a ``tpu_se_torch.parallel.Mesh``) ``starts`` holds the
    columns ``[n_bunches, M / mesh.data]`` of this rank's data index
    (``shard_train_args``); the bunch's statistic and gradients are summed
    over the data axis and every rank ends with the same weights (or, with
    ``mesh.model > 1``, the same shards as the other ranks of its model
    index).  Every rank draws the whole bunch's dropout masks from the same
    seed and keeps its rows (and columns).  ``mesh=None`` is the one-device
    step, the fused GGD kernel included.
    """
    opt_n = hyper.bunchsize if hyper.grad_scale == "parity" else 1
    lr = float(np.float32(lr))
    dropout = hyper.dropout if generator is not None else None
    dropout_rows = None
    if mesh is not None:
        rows = starts.shape[1]
        if rows * mesh.data != hyper.bunchsize:
            raise ValueError(f"rank {mesh.rank} of {mesh.size} got {rows} "
                             f"columns of starts for a bunch of "
                             f"{hyper.bunchsize}")
        if mesh.model > 1 and not isinstance(state.model, TensorParallelFFN):
            raise ValueError(f"a mesh with a model axis of {mesh.model} "
                             "trains a TensorParallelFFN (shard_params)")
        dropout_rows = (mesh.data_rank * rows, hyper.bunchsize)
    layers = param_layers(state.model)
    params = [p for layer in layers for p in (layer["w"], layer["b"])]
    alpha = state.alpha
    with torch.enable_grad():
        for bunch in starts:
            x = gather_splice(noisy, bunch, hyper.context)
            targ = clean[bunch + hyper.targ_offset]
            out = state.model(x, dropout=dropout, generator=generator,
                              compute_dtype=hyper.compute_dtype,
                              act_dtype=hyper.act_dtype,
                              dropout_rows=dropout_rows)
            dedx, alpha = output_grad_and_alpha(out.detach(), targ,
                                                hyper.beta, hyper.ml, mesh)
            grads = torch.autograd.grad(out, params, grad_outputs=dedx)
            if mesh is not None:
                grads = mesh.all_reduce_sum_flat(grads, "data")
            sgd_momentum_update(
                layers, state.velocity,
                [{"w": gw, "b": gb} for gw, gb in zip(grads[::2], grads[1::2])],
                lr, hyper.momentum, hyper.weightcost, opt_n)
    state.alpha = alpha
    return state


@torch.no_grad()
def cv_forward(model: FFN | TensorParallelFFN, noisy: torch.Tensor, starts: torch.Tensor,
               context: int = 7,
               compute_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Forward a batch of CV windows: [N] starts -> [N, out_dim] outputs.
    As in the reference, CV takes ``compute_dtype`` but not ``act_dtype``.
    A ``TensorParallelFFN`` runs its sharded forward: every rank of the
    mesh takes part, and every rank gets the same outputs."""
    return model(gather_splice(noisy, starts, context),
                 compute_dtype=compute_dtype)


@torch.no_grad()
def cv_chunk_metrics(model: FFN | TensorParallelFFN, noisy: torch.Tensor, clean: torch.Tensor,
                     starts: torch.Tensor, alpha: torch.Tensor,
                     hyper: TrainHyper) -> torch.Tensor:
    """Device-side CV sums for one batch of windows -> float32 [3]:
    (sum squared err, sum abs err, sum (|err|/alpha)^beta), the three
    reductions behind ``CrossValid``, ``CrossValiddB`` and ``CrossValid2``
    (``BP_GPU.cu:187-306``).  The batch is not padded, so no mask."""
    out = cv_forward(model, noisy, starts, hyper.context,
                     hyper.compute_dtype)
    err = out - clean[starts + hyper.targ_offset]
    abs_e = err.abs()
    return torch.stack([(err * err).sum(), abs_e.sum(),
                        ((abs_e / alpha) ** hyper.beta).sum()])
