"""Data-parallel train step with one all-reduce per layer (the overlap path).

Port of ``tpu_se/parallel/overlap_step.py``, the analog of the reference
CUDA trainer's two-stream overlap of the ``dedx`` GEMM with the update
kernels (``BP_GPU.cu:31-50,430-437``).  ``train_chunk`` sums a bunch's
gradients in ONE flattened all-reduce after the last backward product
(50,422,788 bytes at full width), so the whole ring is exposed.  Here the
backward pass is written out layer by layer and each layer's ``(dW, db)``
all-reduce is started (``Mesh.all_reduce_sum_async``) the moment it
exists, before the earlier layers' backward products are issued: the ring
runs behind them.  Every handle is waited on, in order, before the
momentum-SGD update.  At full width the four messages are 2,106,372 B
(output layer, first), 16,785,408 B twice and 14,745,600 B: together the
flat step's bytes.

The math is the reference gradient chain, ``train_chunk``'s:

- forward: sigmoid/relu hidden layers, linear output (``BP_GPU.cu:308-371``),
  each layer's input kept for its weight gradient;
- output gradient and GGD alpha from ``output_grad_and_alpha`` -- on the
  card the GGD kernel, fused at ``mesh=None`` and split around the
  all-reduce of the D column sums under a mesh (alpha of the global bunch);
- hidden backward ``dedz = h (1 - h) dedy`` for sigmoid (``DevDsigmoid``),
  the mask ``h > 0`` for relu, the identity at the output; ``dW = h^T
  dedz`` (``SgemmNT``), ``db`` the column sum of ``dedz``
  (``DevAccSumrow``), ``dedy = dedz W^T`` for the layer below;
- ``sgd_momentum_update`` (``kernUpdatedelta``) on the summed gradients.

In float32 every operation is the one that ``torch.autograd.grad`` runs in
``train_chunk`` (``addmm``, ``sigmoid_backward``'s ``g (1 - h) h``,
``mm``, ``sum``), so at ``mesh=None`` the two steps give the same bits,
eager or replayed.

On a card (``mesh=None`` or NCCL) a bunch replays one captured CUDA graph,
as ``train_chunk``'s does (``train/step.py:run_chunk``, the same capture
and counters): the per-layer all-reduces are captured with their waits,
which are stream waits, so inside the graph each ring still runs on
NCCL's stream beside the earlier layers' backward products.

With ``hyper.compute_dtype = torch.bfloat16`` the rounding follows
``tpu_se``'s overlap step, not ``_ReducedLinear``: products take bfloat16
operands and sum in float32; under a mesh ``dW`` is rounded to bfloat16
for its ring and widened to float32 after it, ``db`` stays float32 (two
all-reduces per layer then: ``dW`` in bfloat16, ``db`` in float32); and
``dedy`` stays float32, where ``jax.vjp`` and ``_ReducedLinear`` round it.

Left out: ``tpu_se``'s ``tok`` chain (a zero taken from each psum's output
and added to the next layer's ``dW``).  It exists only to stop XLA's
all-reduce combiner from fusing the per-layer psums back into one ring;
``torch.distributed`` issues the collectives it is given and combines
nothing.  Adding 0.0 changes at most a -0.0 into +0.0, which no
comparison of the tests can see (they hold this step to ``tpu_se``'s,
chain and all).
"""

from __future__ import annotations

import numpy as np
import torch

from tpu_se_torch.losses import output_grad_and_alpha
from tpu_se_torch.models.ffn import _ACTIVATIONS, linear, reduced_product
from tpu_se_torch.parallel.mesh import PendingSum, shard_train_args
from tpu_se_torch.train.optim import sgd_momentum_update
from tpu_se_torch.train.step import (
    TrainHyper, TrainState, gather_splice, param_layers, run_chunk,
)


def _product(a: torch.Tensor, b: torch.Tensor, cd: torch.dtype
             ) -> torch.Tensor:
    """float32 ``a @ b`` with the operands in ``cd`` (float32: autograd's
    ``mm``; bfloat16: ``reduced_product``)."""
    if cd == torch.float32:
        return torch.mm(a, b)
    return reduced_product(a.to(cd), b.to(cd))


def _start_sum(mesh, l: int, dedz: torch.Tensor, h: torch.Tensor,
               cd: torch.dtype) -> tuple:
    """Layer ``l``'s weight and bias gradients from its input ``h`` and
    ``dedz``, their all-reduce over the data axis started -> what to wait
    on (at ``mesh=None`` the gradients themselves, nothing to sum)."""
    if mesh is None:
        return (PendingSum(_product(h.t(), dedz, cd)),
                PendingSum(dedz.sum(dim=0)))
    if cd != torch.float32:
        # The weight ring in bfloat16, the biases' in float32.
        gw = _product(h.t(), dedz, cd).to(cd)
        return (mesh.all_reduce_sum_async(gw, "data", slot=(l, "w")),
                mesh.all_reduce_sum_async(dedz.sum(dim=0), "data",
                                          slot=(l, "b")))
    # One float32 message: dW and db side by side, written there by the
    # product and the sum themselves.
    n_in, n_out = h.shape[1], dedz.shape[1]
    flat = torch.empty(n_in * n_out + n_out, dtype=torch.float32,
                       device=dedz.device)
    torch.mm(h.t(), dedz, out=flat[:n_in * n_out].view(n_in, n_out))
    torch.sum(dedz, dim=0, out=flat[n_in * n_out:])
    return (mesh.all_reduce_sum_async(flat, "data", slot=l),)


def _finish_sum(started: tuple, shape: tuple) -> dict:
    """Wait for ``_start_sum``'s all-reduce -> {"w", "b"} float32."""
    if len(started) == 2:
        return {"w": started[0].wait().float(), "b": started[1].wait()}
    flat = started[0].wait()
    n = shape[0] * shape[1]
    return {"w": flat[:n].view(shape), "b": flat[n:]}


def _bunch_grads(layers: list[dict], w_cast: list, x: torch.Tensor,
                 targ: torch.Tensor, hyper: TrainHyper, mesh
                 ) -> tuple[list[dict], torch.Tensor]:
    """Forward and written-out backward for this rank's rows of one bunch
    -> (gradients [{"w", "b"}] summed over the data axis, alpha [D]).
    Each layer's all-reduce starts before the layer below's backward
    products are issued; all are waited on, in the order started, before
    this returns."""
    cd = hyper.compute_dtype
    n_layers = len(layers)
    act = _ACTIVATIONS[hyper.activation]
    # hs[l] is layer l's input; hs[-1] the network's output.
    hs = [x]
    for i, layer in enumerate(layers):
        z = linear(hs[-1], layer["w"], layer["b"], cd, w_cast[i])
        hs.append(act(z) if i < n_layers - 1 else z)
    dedy, alpha = output_grad_and_alpha(hs[-1], targ, hyper.beta, hyper.ml,
                                        mesh)
    started = [None] * n_layers
    for l in range(n_layers - 1, -1, -1):
        if l == n_layers - 1:
            dedz = dedy                                     # linear output
        elif hyper.activation == "sigmoid":
            h = hs[l + 1]
            dedz = dedy * (1.0 - h) * h                     # DevDsigmoid
        else:
            dedz = torch.where(hs[l + 1] > 0.0, dedy, 0.0)  # ReLU branch
        started[l] = _start_sum(mesh, l, dedz, hs[l], cd)   # SgemmNT
        if l > 0:
            w = layers[l]["w"] if w_cast[l] is None else w_cast[l]
            dedy = _product(dedz, w.t(), cd)                # SgemmTN
    grads = [None] * n_layers
    for l in range(n_layers - 1, -1, -1):
        grads[l] = _finish_sum(started[l], tuple(layers[l]["w"].shape))
    return grads, alpha


@torch.no_grad()
def train_chunk_overlap(state: TrainState, noisy: torch.Tensor,
                        clean: torch.Tensor, starts: torch.Tensor, lr: float,
                        hyper: TrainHyper, mesh=None,
                        generator: torch.Generator | None = None,
                        graph: bool = True) -> TrainState:
    """``train_chunk`` with the backward pass written out and one
    all-reduce per layer, in place; returns ``state``.

    Same arguments as ``train_chunk`` (so ``train_one_epoch(step=)`` takes
    either): ``starts`` [n_bunches, M] at ``mesh=None``, this rank's
    ``[n_bunches, M / data]`` columns under a mesh (``shard_overlap_args``).
    Raises ``NotImplementedError``, as ``tpu_se`` does, for dropout (a
    ``generator`` included), for ``act_dtype`` and for a model axis of more
    than one rank; use ``train_chunk`` for those.

    ``graph`` follows ``train_chunk``'s rule (``train/step.py:run_chunk``):
    on a card with ``mesh=None`` or an NCCL mesh each bunch replays one
    captured CUDA graph, its per-layer all-reduces and their waits inside
    (each ``PendingSum.wait`` a stream wait, so the rings still run behind
    the earlier layers' products), bit for bit the eager loop that
    ``graph=False`` runs; gloo (the host copies of every layer's sum) and
    the CPU stay eager.
    """
    if hyper.dropout is not None or generator is not None:
        raise NotImplementedError("overlap step does not support dropout")
    if hyper.act_dtype is not None:
        raise NotImplementedError(
            "overlap step does not support act_dtype (the hand-written "
            "backward keeps float32 activations; silently accepting it "
            "would measure a different program than train_chunk)")
    if mesh is not None:
        if mesh.model != 1:
            raise NotImplementedError("overlap step is DP-only (model axis "
                                      "must be 1; use train_chunk for TP)")
        if starts.shape[1] * mesh.data != hyper.bunchsize:
            raise ValueError(f"rank {mesh.rank} of {mesh.size} got "
                             f"{starts.shape[1]} columns of starts for a "
                             f"bunch of {hyper.bunchsize}")
    opt_n = hyper.bunchsize if hyper.grad_scale == "parity" else 1
    lr = float(np.float32(lr))
    layers = param_layers(state.model)
    params = [p for layer in layers for p in (layer["w"], layer["b"])]

    def bunch_step(bunch: torch.Tensor, rate, masks) -> torch.Tensor:
        """One bunch, in place on the weights and velocity -> its alpha
        (``train_chunk``'s protocol; ``masks`` is always None here)."""
        # The weights' reduced copies, once per bunch, as train_chunk.
        w_cast = [None if hyper.compute_dtype == torch.float32
                  else layer["w"].to(hyper.compute_dtype)
                  for layer in layers]
        x = gather_splice(noisy, bunch, hyper.context)
        targ = clean[bunch + hyper.targ_offset]
        grads, alpha = _bunch_grads(layers, w_cast, x, targ, hyper, mesh)
        sgd_momentum_update(layers, state.velocity, grads, rate,
                            hyper.momentum, hyper.weightcost, opt_n)
        return alpha

    return run_chunk(state, noisy, clean, starts, lr, hyper, bunch_step,
                     params, mesh, None, graph, "overlap")


def shard_overlap_args(mesh, noisy, clean, starts):
    """Chunk arrays for ``train_chunk_overlap``: the frames as they are
    (replicated), and this rank's block of the window starts' bunch
    columns -- ``shard_train_args``'s layout, as in ``tpu_se``."""
    return shard_train_args(mesh, noisy, clean, starts)
