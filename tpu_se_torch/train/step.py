"""The training step: one loop over the bunches of a chunk.

Port of ``tpu_se/train/step.py`` (reference per-bunch loop
``BP_GPU.cu:152-185,308-440``).  Where JAX runs the bunches of a chunk
inside one ``lax.scan``, the port runs them as a Python loop.  On one card
(``mesh=None``, no dropout) the loop replays one captured CUDA graph per
bunch; elsewhere, and with ``graph=False``, each bunch is its eager
launches:

- The graph holds a whole bunch: the splice gather, the forward pass, the
  GGD kernel, the backward pass and the update (one optimizer kernel,
  ``train/optim.py``).  It reads the bunch's
  window starts from a static ``[M]`` buffer, filled by one device copy
  per bunch, and the rate from a 0-dim float32 buffer, so one graph serves
  every epoch's rate; it writes the weights and velocity in place.  The
  replays are bit for bit the eager loop (``graph=False``), which stays as
  the reference.  The graph lives on the ``TrainState`` and is captured
  again when the frames, M, the hyper-parameters or the parameter and
  velocity tensors change: a chunk read per call (``device_resident=
  "never"``) captures once per chunk.  A capture follows one eager warm-up
  bunch of the chunk on a side stream, which loads the kernel library,
  cuBLAS and autograd's state; the capture itself runs nothing, so a chunk
  of n bunches trains n bunches.

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

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from tpu_se_torch.losses import output_grad_and_alpha
from tpu_se_torch.models import FFN
from tpu_se_torch.ops import ggd_kernel, sgd_kernel
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


# Bunches run as replays of a captured graph, and graphs captured (each
# after one eager warm-up bunch), over every state of the process.  A
# replay launches the GGD and optimizer kernels as the eager bunch does,
# so ``ggd_kernel.launches`` and ``sgd_kernel.launches`` gain what one
# replay holds; the capture, which launches nothing, is not counted.
bunches_replayed = 0
graphs_captured = 0


@dataclass
class _BunchGraph:
    """One bunch captured on a card, and what it was captured for."""
    key: tuple                  # _graph_key of the capture
    held: tuple                 # the keyed objects, kept alive with the graph
    graph: torch.cuda.CUDAGraph
    stream: torch.cuda.Stream   # the warm-up's and the capture's
    starts: torch.Tensor        # [M] int64 window starts the graph reads
    lr: torch.Tensor            # 0-dim float32 rate the graph's update takes
    alpha: torch.Tensor         # the graph's alpha [D], in its memory pool
    ggd_launches: int           # GGD kernel launches in one replay
    sgd_launches: int           # optimizer kernel launches in one replay


@dataclass
class TrainState:
    model: FFN | TensorParallelFFN   # trained in place
    velocity: list              # [{"w", "b"}] tensors, like the params
    alpha: torch.Tensor         # last-bunch GGD scale factors [D]
    # train_chunk's captured bunch on a card (one per state).
    _graph: _BunchGraph | None = field(default=None, repr=False,
                                       compare=False)


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
                mesh=None, graph: bool = True) -> TrainState:
    """Train all full bunches of one chunk, in place; returns ``state``.

    noisy/clean: [F, D] normalized frames; starts: [n_bunches, M] int64
    window starts (shuffled), all on one device.  ``lr`` is rounded to
    float32 first, as JAX's ``jnp.float32(lr)``.  ``generator`` (on that
    device) draws the dropout masks when ``hyper.dropout`` is set.  alpha
    after the call is the last bunch's.

    On a card with ``mesh=None`` and no dropout, ``graph`` replays one
    captured CUDA graph per bunch (module docstring), bit for bit the eager
    loop that ``graph=False`` runs; a capture or replay that fails raises.
    These stay eager: a mesh (its collectives; NCCL under capture is not
    done yet, and gloo cannot be captured), dropout with a generator (the
    masks' Philox state would have to advance inside the graph), and the
    CPU (no graphs).

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

    def bunch_step(bunch: torch.Tensor, rate) -> torch.Tensor:
        """One bunch, in place on the weights and velocity -> its alpha.
        ``rate`` is the float32-rounded float or the graph's 0-dim
        buffer: the update's product rounds to the same float32 bits."""
        x = gather_splice(noisy, bunch, hyper.context)
        targ = clean[bunch + hyper.targ_offset]
        out = state.model(x, dropout=dropout, generator=generator,
                          compute_dtype=hyper.compute_dtype,
                          act_dtype=hyper.act_dtype,
                          dropout_rows=dropout_rows)
        dedx, alpha = output_grad_and_alpha(out.detach(), targ, hyper.beta,
                                            hyper.ml, mesh)
        grads = torch.autograd.grad(out, params, grad_outputs=dedx)
        if mesh is not None:
            grads = mesh.all_reduce_sum_flat(grads, "data")
        sgd_momentum_update(
            layers, state.velocity,
            [{"w": gw, "b": gb} for gw, gb in zip(grads[::2], grads[1::2])],
            rate, hyper.momentum, hyper.weightcost, opt_n)
        return alpha

    with torch.enable_grad():
        if graph and starts.shape[0] and _replays(noisy.device, mesh, dropout):
            state.alpha = _replay_chunk(state, noisy, clean, starts, lr,
                                        hyper, bunch_step, params)
        else:
            for bunch in starts:
                state.alpha = bunch_step(bunch, lr)
    return state


def _replays(device: torch.device, mesh, dropout: tuple | None) -> bool:
    """Whether ``train_chunk(graph=True)`` replays a captured bunch: on a
    card, without a mesh, without dropout masks (``dropout`` is
    ``hyper.dropout`` when a generator is given, else None)."""
    return device.type == "cuda" and mesh is None and dropout is None


def _graph_key(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
               params: list, m: int, hyper: TrainHyper) -> tuple[tuple, tuple]:
    """(key, held) of a bunch graph: the objects it reads and writes, by
    identity and address, with M and ``hyper``; ``held`` keeps them alive
    beside the graph, so no identity is reused while the key stands."""
    tensors = (noisy, clean, *params,
               *(v for layer in state.velocity for v in layer.values()))
    held = (state.model, *tensors)
    return ((m, hyper, tuple(map(id, held)),
             tuple(t.data_ptr() for t in tensors)), held)


def _replay_chunk(state: TrainState, noisy: torch.Tensor,
                  clean: torch.Tensor, starts: torch.Tensor, lr: float,
                  hyper: TrainHyper, bunch_step, params: list
                  ) -> torch.Tensor:
    """Every bunch of ``starts`` as a replay of the state's graph, captured
    first (after one eager bunch) if the state has none for these
    tensors -> the last bunch's alpha, copied out of the graph's pool."""
    global bunches_replayed
    key, held = _graph_key(state, noisy, clean, params, starts.shape[1],
                           hyper)
    g = state._graph
    rest = starts
    alpha = None
    with torch.cuda.device(noisy.device):
        if g is None or g.key != key:
            g, alpha = _capture(starts[0], lr, bunch_step, key, held, g)
            state._graph = g          # the old graph and its pool go
            rest = starts[1:]
        if rest.shape[0]:
            g.lr.fill_(lr)
            for bunch in rest:
                g.starts.copy_(bunch)
                g.graph.replay()
            bunches_replayed += rest.shape[0]
            ggd_kernel.launches += g.ggd_launches * rest.shape[0]
            sgd_kernel.launches += g.sgd_launches * rest.shape[0]
            alpha = g.alpha
        return alpha.clone()


def _capture(first: torch.Tensor, lr: float, bunch_step, key: tuple,
             held: tuple, old: _BunchGraph | None
             ) -> tuple[_BunchGraph, torch.Tensor]:
    """Train ``first`` eagerly on a side stream, then capture one bunch on
    it that reads its starts and rate from static buffers -> (the graph,
    the eager bunch's alpha).  Runs with ``first``'s card current.

    A state's next graph is captured into its ``old`` one's memory pool
    and on its stream, while the old graph still holds the pool, and the
    old graph is never replayed after: so a chunk read per call does not
    add a pool and a stream's cached blocks per capture.  Unlike
    ``torch.cuda.graph``, no synchronise and no ``empty_cache`` precede
    the capture: what this capture allocates comes from the pool."""
    global graphs_captured
    if old is not None and old.stream.device != first.device:
        old = None
    current = torch.cuda.current_stream()
    starts = torch.empty(first.shape, dtype=torch.int64, device=first.device)
    rate = torch.empty((), dtype=torch.float32, device=first.device)
    side = torch.cuda.Stream() if old is None else old.stream
    side.wait_stream(current)
    with torch.cuda.stream(side):
        alpha = bunch_step(first, lr)
    # Read by the caller on the current stream, freed after it.
    alpha.record_stream(current)
    graph = torch.cuda.CUDAGraph()
    launches = (ggd_kernel.launches, sgd_kernel.launches)
    with torch.cuda.stream(side):
        graph.capture_begin(pool=None if old is None else old.graph.pool())
        try:
            static_alpha = bunch_step(starts, rate)
        finally:
            graph.capture_end()
    held_launches = (ggd_kernel.launches - launches[0],
                     sgd_kernel.launches - launches[1])
    ggd_kernel.launches, sgd_kernel.launches = launches
    current.wait_stream(side)
    graphs_captured += 1
    return _BunchGraph(key, held, graph, side, starts, rate, static_alpha,
                       *held_launches), alpha


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
