"""The training step: one loop over the bunches of a chunk.

Port of ``tpu_se/train/step.py`` (reference per-bunch loop
``BP_GPU.cu:152-185,308-440``).  Where JAX runs the bunches of a chunk
inside one ``lax.scan``, the port runs them as a Python loop.  On a card
(one device, or one rank of an NCCL mesh; with or without dropout masks)
the loop replays one captured CUDA graph per bunch; elsewhere, and with
``graph=False``, each bunch is its eager launches.  The overlapped step
(``parallel/overlap_step.py``) replays through the same machinery
(``run_chunk``):

- The graph holds a whole bunch: the splice gather, the forward pass, the
  GGD kernel, the backward pass and the update (one optimizer kernel,
  ``train/optim.py``), and under an NCCL mesh the bunch's collectives
  (the GGD column sums, the flat gradients, the model axis' sums and
  gather; the overlapped step's per-layer sums), which NCCL records into
  the graph and runs at each replay, as ``jax.jit`` compiles a bunch under
  its shardings.  It reads the bunch's
  window starts from a static ``[M]`` buffer, filled by one device copy
  per bunch, and the rate from a 0-dim float32 buffer, so one graph serves
  every epoch's rate; it writes the weights and velocity in place.  The
  replays are bit for bit the eager loop (``graph=False``), which stays as
  the reference.  The graph lives on the ``TrainState`` and is captured
  again when the step (flat or overlapped), the frames, M, the
  hyper-parameters, whether masks are drawn, or the parameter and
  velocity tensors change: a chunk read per call (``device_resident=
  "never"``) captures once per chunk.  A capture follows one eager warm-up
  bunch of the chunk on a side stream, which loads the kernel library,
  cuBLAS and autograd's state; the capture itself runs nothing, so a chunk
  of n bunches trains n bunches.
- Dropout masks are drawn inside the graph from a generator of its own,
  registered with it (``CUDAGraph.register_generator_state``): a replay
  reads that generator's Philox seed and offset when it is launched and
  advances the offset by what the bunch's draws take, as the eager bunch
  advances its generator.  The caller's generator is not in the graph
  (the training loop makes one per chunk): before a chunk's replays its
  seed and offset are handed to the graph's generator, and after them the
  caller's offset is set to where the eager loop would have left it.  So
  bunch k of a chunk draws the masks of eager bunch k, and a chunk's
  masks cost no capture.  The warm-up bunch draws eagerly from the
  caller's generator; the capture draws nothing.
- Under a mesh the warm-up bunch also starts NCCL's communicators (the
  default group's and every axis subgroup's) before the capture, and every
  rank captures at the same bunch: the rule that recaptures reads only
  what every rank changes together.  gloo stays eager (its collectives run
  on the host and cannot be captured).
- A capture runs in the ``thread_local`` capture mode: only the capturing
  thread's calls are checked, so another thread of the process (the
  process group's watchdog querying its events, a prefetch thread) cannot
  invalidate the capture.
- A graph captured under a mesh is named to ``release_on_shutdown``:
  leaving the process group releases it first, as NCCL frees a
  communicator only after the graphs that hold its collectives are gone.
- What a replay runs, the counters still count: a capture keeps what its
  bunch added to the kernels' launch counters and to ``Mesh.traffic``,
  takes it back (the capture launched and sent nothing), and each replay
  adds it once.
- The CV pass (``CVPass``) runs ``tpu_se``'s padded batches of
  ``CV_BATCH`` windows with their 0/1 mask and, on a card (one device or
  an NCCL mesh), replays one captured batch per state on the same terms:
  one eager warm-up batch before the capture, ``thread_local``, counters
  taken back and added per replay, a mesh graph named to
  ``release_on_shutdown``.  Its key holds the frames, the parameters and
  ``hyper``; it reads its own copy of alpha, refreshed at every pass, and
  adds each batch's float32 sums into its float64 accumulator.

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
from tpu_se_torch.parallel.distributed import release_on_shutdown
from tpu_se_torch.parallel.tensor import TensorParallelFFN
from tpu_se_torch.train.optim import sgd_momentum_init, sgd_momentum_update
from tpu_se_torch.utils import graphs
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


# A chunk's rows in a CV graph's frame buffers are rounded up to this
# (tpu_se/train/loop.py:35 pads every chunk to it).
FRAME_PAD_BUCKET = 4096

# Bunches run as replays of a captured graph, and graphs captured (each
# after one eager warm-up bunch), over every state of the process.  A
# replay launches the GGD and optimizer kernels and runs the collectives
# as the eager bunch does, so ``KERNEL_COUNTERS`` and ``Mesh.traffic`` gain
# what one replay holds; the capture, which launches nothing, is not
# counted.
bunches_replayed = 0
graphs_captured = 0

# The launch counters a training bunch advances: (module, name).
KERNEL_COUNTERS = ((ggd_kernel, "launches"),
                   (ggd_kernel, "colsum_launches"),
                   (ggd_kernel, "grad_from_sums_launches"),
                   (sgd_kernel, "launches"))


def read_counts(traffic: dict | None) -> tuple[int, ...]:
    """The counters a bunch advances, as one tuple: ``KERNEL_COUNTERS``,
    then ``traffic``'s (``Mesh.traffic``, or None without a mesh) calls
    and bytes per axis and op, in its order."""
    return graphs.read_counts(KERNEL_COUNTERS, traffic)


def add_counts(traffic: dict | None, delta: tuple, times: int = 1) -> None:
    """Add ``times`` x ``delta`` (ordered as ``read_counts``) to the
    counters: ``times=-1`` takes a capture's counts back, ``times=n`` adds
    n replays'."""
    graphs.add_counts(KERNEL_COUNTERS, traffic, delta, times)


@dataclass(eq=False)
class _BunchGraph(graphs.Releasable):
    """One bunch captured on a card, and what it was captured for."""
    key: tuple                  # _graph_key of the capture
    held: tuple                 # the keyed objects, kept alive with the graph
    graph: torch.cuda.CUDAGraph
    stream: torch.cuda.Stream   # the warm-up's and the capture's
    starts: torch.Tensor        # [M] int64 window starts the graph reads
    lr: torch.Tensor            # 0-dim float32 rate the graph's update takes
    alpha: torch.Tensor         # the graph's alpha [D], in its memory pool
    counts: tuple               # what one replay adds (read_counts' order)
    # The generator the graph's masks are drawn from (registered with it),
    # or None for a graph that draws none.
    generator: torch.Generator | None = None


@dataclass
class TrainState:
    model: FFN | TensorParallelFFN   # trained in place
    velocity: list              # [{"w", "b"}] tensors, like the params
    alpha: torch.Tensor         # last-bunch GGD scale factors [D]
    # The captured bunch of train_chunk or train_chunk_overlap on a card
    # (one per state: the last step's).
    _graph: _BunchGraph | None = field(default=None, repr=False,
                                       compare=False)
    # The captured CV batch (CVPass), read by every CV pass of the state.
    _cv_graph: Any = field(default=None, repr=False, compare=False)


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
    device) draws the dropout masks when ``hyper.dropout`` is set, and
    leaves the call at the offset its draws took.  alpha after the call
    is the last bunch's.

    On a card with ``mesh=None`` or an NCCL mesh, ``graph`` replays one
    captured CUDA graph per bunch, masks included (module docstring), bit
    for bit the eager loop that ``graph=False`` runs; a capture or replay
    that fails raises.  These stay eager: a gloo mesh (its collectives run
    on the host) and the CPU (no graphs).

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
    # Masks are drawn only with a generator: without one, hyper.dropout
    # trains the plain bunch.
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

    def bunch_step(bunch: torch.Tensor, rate, masks) -> torch.Tensor:
        """One bunch, in place on the weights and velocity -> its alpha.
        ``rate`` is the float32-rounded float or the graph's 0-dim
        buffer: the update's product rounds to the same float32 bits.
        ``masks`` is the generator the dropout masks are drawn from (the
        caller's, or the graph's own), None without masks."""
        x = gather_splice(noisy, bunch, hyper.context)
        targ = clean[bunch + hyper.targ_offset]
        out = state.model(x, dropout=dropout, generator=masks,
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
        return run_chunk(state, noisy, clean, starts, lr, hyper, bunch_step,
                         params, mesh, None if dropout is None else generator,
                         graph, "flat")


def run_chunk(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
              starts: torch.Tensor, lr: float, hyper: TrainHyper, bunch_step,
              params: list, mesh, generator: torch.Generator | None,
              graph: bool, step: str) -> TrainState:
    """Every bunch of ``starts`` through ``bunch_step(bunch, rate, masks)``
    (-> its alpha), in place; returns ``state`` with the last bunch's
    alpha.  ``lr`` is float32-rounded; ``generator`` draws the masks (None:
    no masks).  With ``graph``, on a card without a mesh or under NCCL,
    the bunches replay the state's graph (``_replay_chunk``); ``step``
    names the step that ``bunch_step`` runs ("flat", "overlap"), so a
    state that changes steps captures anew.  Otherwise the eager loop."""
    if graph and starts.shape[0] and _replays(noisy.device, mesh):
        state.alpha = _replay_chunk(state, noisy, clean, starts, lr, hyper,
                                    bunch_step, params, mesh, generator,
                                    step)
    else:
        for bunch in starts:
            state.alpha = bunch_step(bunch, lr, generator)
    return state


def _replays(device: torch.device, mesh) -> bool:
    """Whether ``run_chunk(graph=True)`` replays a captured bunch
    (``utils.graphs.replays``).  Dropout masks do not matter: the graph
    draws them too."""
    return graphs.replays(device, mesh)


def _graph_key(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
               params: list, m: int, hyper: TrainHyper, mesh=None,
               step: str = "flat", masks: bool = False
               ) -> tuple[tuple, tuple]:
    """(key, held) of a bunch graph: the step it runs and whether it draws
    masks (``hyper.dropout`` draws none without a generator), M,
    ``hyper``, and the objects it reads and writes, by identity and
    address; ``held`` keeps them alive beside the graph, so no identity
    is reused while the key stands.  Under a mesh also the mesh and its
    axis groups, and for the flat step its flat gradient buffer
    (``Mesh._flat``, outside the graph's pool): a buffer allocated anew
    means a capture anew, never a replay into freed memory.  The
    overlapped step reads no such buffer (its sums are in the graph's
    pool), so a flat step's buffer does not recapture it.  The caller's
    generator is not in the key (module docstring)."""
    tensors = (noisy, clean, *params,
               *(v for layer in state.velocity for v in layer.values()))
    held = (state.model, *tensors)
    if mesh is not None:
        held = (*held, mesh, *mesh._groups.values())
        if step == "flat":
            tensors += () if mesh._flat is None else (mesh._flat,)
            held = (*held, mesh._flat)
    return ((step, masks, m, hyper, tuple(map(id, held)),
             tuple(t.data_ptr() for t in tensors)), held)


def _replay_chunk(state: TrainState, noisy: torch.Tensor,
                  clean: torch.Tensor, starts: torch.Tensor, lr: float,
                  hyper: TrainHyper, bunch_step, params: list, mesh=None,
                  generator: torch.Generator | None = None,
                  step: str = "flat") -> torch.Tensor:
    """Every bunch of ``starts`` as a replay of the state's graph, captured
    first (after one eager bunch) if the state has none for these
    tensors -> the last bunch's alpha, copied out of the graph's pool.
    With a ``generator`` the replays draw its masks from its seed and
    offset, and it leaves at the offset the eager loop leaves it."""
    global bunches_replayed

    def key():
        return _graph_key(state, noisy, clean, params, starts.shape[1],
                          hyper, mesh, step, generator is not None)

    g = state._graph
    rest = starts
    alpha = None
    traffic = None if mesh is None else mesh.traffic
    with torch.cuda.device(noisy.device):
        if g is None or g.key != key()[0]:
            g, alpha = _capture(starts[0], lr, bunch_step, key, traffic, g,
                                generator)
            state._graph = g          # the old graph and its pool go
            rest = starts[1:]
        if rest.shape[0]:
            g.lr.fill_(lr)
            if generator is not None:
                g.generator.manual_seed(generator.initial_seed())
                g.generator.set_offset(generator.get_offset())
            for bunch in rest:
                g.starts.copy_(bunch)
                g.graph.replay()
            if generator is not None:
                generator.set_offset(g.generator.get_offset())
            bunches_replayed += rest.shape[0]
            add_counts(traffic, g.counts, rest.shape[0])
            alpha = g.alpha
        return alpha.clone()


def _capture(first: torch.Tensor, lr: float, bunch_step, key,
             traffic: dict | None, old: _BunchGraph | None,
             generator: torch.Generator | None = None
             ) -> tuple[_BunchGraph, torch.Tensor]:
    """Train ``first`` eagerly on a side stream, then capture one bunch on
    it that reads its starts and rate from static buffers -> (the graph,
    the eager bunch's alpha).  Runs with ``first``'s card current.
    ``key()`` gives the graph's (key, held), read after the warm-up,
    which allocates a mesh's flat gradient buffer; ``traffic`` is the
    mesh's ``Mesh.traffic`` (None without one).  The capture is
    ``utils.graphs.capture`` (module docstring).  With a ``generator`` the
    warm-up draws its masks from it, and the graph draws from a generator
    of its own, registered with it before the capture.

    A state's next graph is captured into its ``old`` one's memory pool
    and on its stream, while the old graph still holds the pool, and the
    old graph is never replayed after: so a chunk read per call does not
    add a pool and a stream's cached blocks per capture.  Unlike
    ``torch.cuda.graph``, no synchronise and no ``empty_cache`` precede
    the capture: what this capture allocates comes from the pool."""
    global graphs_captured
    if old is not None and (old.key is None
                            or old.stream.device != first.device):
        old = None
    starts = torch.empty(first.shape, dtype=torch.int64, device=first.device)
    rate = torch.empty((), dtype=torch.float32, device=first.device)
    side = torch.cuda.Stream() if old is None else old.stream
    graph = torch.cuda.CUDAGraph()
    masks = None
    if generator is not None:
        masks = torch.Generator(device=first.device)
        graph.register_generator_state(masks)
    graph, alpha, static_alpha, counts = graphs.capture(
        lambda: bunch_step(starts, rate, masks), side,
        warm=lambda: bunch_step(first, lr, generator),
        pool=None if old is None else old.graph.pool(), graph=graph,
        counts=(KERNEL_COUNTERS, traffic))
    # Read by the caller on the current stream, freed after it.
    alpha.record_stream(torch.cuda.current_stream())
    graph_key, held = key()
    graphs_captured += 1
    captured = _BunchGraph(graph_key, held, graph, side, starts, rate,
                           static_alpha, counts, masks)
    if traffic is not None:
        release_on_shutdown(captured)
    return captured, alpha


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
def cv_chunk_metrics(model: FFN | TensorParallelFFN, noisy: torch.Tensor,
                     clean: torch.Tensor, starts: torch.Tensor,
                     mask: torch.Tensor, alpha: torch.Tensor,
                     hyper: TrainHyper) -> torch.Tensor:
    """Device-side CV sums for one padded batch of windows -> float32 [3]:
    (sum squared err, sum abs err, sum (|err|/alpha)^beta) over the windows
    whose ``mask`` is 1 (0 on the pad rows, whose starts may be any valid
    window), the three reductions behind ``CrossValid``, ``CrossValiddB``
    and ``CrossValid2`` (``BP_GPU.cu:187-306``), as
    ``tpu_se.train.step.cv_chunk_metrics`` takes them."""
    out = cv_forward(model, noisy, starts, hyper.context,
                     hyper.compute_dtype)
    err = (out - clean[starts + hyper.targ_offset]) * mask[:, None]
    abs_e = err.abs()
    return torch.stack([(err * err).sum(), abs_e.sum(),
                        ((abs_e / alpha) ** hyper.beta
                         * mask[:, None]).sum()])


# CV batches run as replays of a captured graph, and CV graphs captured,
# over every state of the process (a capture follows one eager batch).
cv_batches_replayed = 0
cv_graphs_captured = 0


@dataclass(eq=False)
class _CVGraph(graphs.Releasable):
    """One CV batch captured on a card, and the static tensors it reads and
    writes: the frames (the caller's resident span, or buffers of its own
    that a chunk is copied into), the batch's starts and mask, alpha, and
    the pass's float64 sums, which each replay adds its batch to."""
    key: tuple                  # _cv_key of the capture
    held: tuple                 # the keyed objects, kept alive with it
    graph: torch.cuda.CUDAGraph
    stream: torch.cuda.Stream   # the warm-up's and the capture's
    noisy: torch.Tensor
    clean: torch.Tensor
    starts: torch.Tensor        # [CV_BATCH] int64
    mask: torch.Tensor          # [CV_BATCH] float32
    alpha: torch.Tensor         # [D]
    acc: torch.Tensor           # [3] float64
    counts: tuple = ()          # what one replay adds (read_counts' order)
    owns_frames: bool = False   # noisy/clean are the graph's own buffers


def _cv_key(state: TrainState, noisy: torch.Tensor, clean: torch.Tensor,
            hyper: TrainHyper, mesh) -> tuple[tuple, tuple]:
    """(key, held) of a CV graph: ``hyper`` and the frames and parameters
    it reads, by identity and address (and the mesh and its axis groups);
    ``held`` keeps them alive beside the graph.  alpha is not in it: the
    graph reads its own copy, refreshed at every pass."""
    tensors = (noisy, clean, *(p for layer in param_layers(state.model)
                               for p in layer.values()))
    held = (state.model, *tensors)
    if mesh is not None:
        held = (*held, mesh, *mesh._groups.values())
    return ((hyper, tuple(map(id, held)),
             tuple(t.data_ptr() for t in tensors)), held)


class CVPass:
    """One pass of ``cv_chunk_metrics`` over padded batches, its three sums
    accumulated in float64 on the device and read once (``sums``).

    ``frames(noisy, clean)`` sets the frames of the batches that follow:
    device tensors (a resident span) or host arrays (a chunk).
    ``batch(starts, mask)`` takes one batch's ``[CV_BATCH]`` host arrays.
    On a card (one device, or every rank of an NCCL mesh, whose model
    axis' collectives the graph holds) with ``graph``, the batches replay
    one graph kept on the state (``TrainState._cv_graph``), captured after
    one eager batch of a pass whose frames, parameters or ``hyper``
    changed.  The graph reads the weights by address and its own alpha,
    copied from the state's at each pass.  A host chunk is copied into
    the graph's frame buffers (rows rounded up to ``FRAME_PAD_BUCKET``,
    as the reference pads a chunk), so every chunk of every pass replays
    one graph; a longer chunk allocates larger buffers and captures again.
    The CPU, gloo and ``graph=False`` run the batches eagerly: the
    reference, which the replays equal bit for bit.
    """

    def __init__(self, state: TrainState, hyper: TrainHyper, device,
                 graph: bool = True):
        self.state, self.hyper = state, hyper
        self.device = torch.device(device)
        self.mesh = getattr(state.model, "mesh", None)
        self.replays = graph and _replays(self.device, self.mesh)
        self.acc = torch.zeros(3, dtype=torch.float64, device=self.device)
        self.noisy = self.clean = None
        self.own_frames = False       # noisy/clean: a graph's buffers

    def _host(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        return t.pin_memory() if self.device.type == "cuda" else t

    def frames(self, noisy, clean) -> None:
        self.own_frames = False
        if isinstance(noisy, torch.Tensor):
            self.noisy, self.clean = noisy, clean
            return
        if not self.replays:
            self.noisy, self.clean = (
                self._host(a).to(self.device, non_blocking=True)
                for a in (noisy, clean))
            return
        g = self.state._cv_graph
        rows = noisy.shape[0]
        if (g is not None and g.owns_frames and g.key is not None
                and g.noisy.shape[0] >= rows):
            bufs = (g.noisy, g.clean)
        else:
            pad = -(-rows // FRAME_PAD_BUCKET) * FRAME_PAD_BUCKET
            bufs = tuple(torch.zeros((pad, a.shape[1]), dtype=torch.float32,
                                     device=self.device)
                         for a in (noisy, clean))
        for buf, a in zip(bufs, (noisy, clean)):
            buf[:rows].copy_(self._host(a), non_blocking=True)
        self.noisy, self.clean = bufs
        self.own_frames = True

    def batch(self, starts: np.ndarray, mask: np.ndarray) -> None:
        global cv_batches_replayed
        starts_h = self._host(starts.astype(np.int64))
        mask_h = self._host(mask.astype(np.float32))
        if not self.replays:
            self.acc.add_(cv_chunk_metrics(
                self.state.model, self.noisy, self.clean,
                starts_h.to(self.device, non_blocking=True),
                mask_h.to(self.device, non_blocking=True),
                self.state.alpha, self.hyper).double())
            return
        key, held = _cv_key(self.state, self.noisy, self.clean, self.hyper,
                            self.mesh)
        g = self.state._cv_graph
        if g is None or g.key != key:
            self.state._cv_graph = self._capture(key, held, starts_h,
                                                 mask_h)
            return
        if self.acc is not g.acc:     # this pass's first batch on g
            g.alpha.copy_(self.state.alpha)
            g.acc.copy_(self.acc)
            self.acc = g.acc
        g.starts.copy_(starts_h, non_blocking=True)
        g.mask.copy_(mask_h, non_blocking=True)
        g.graph.replay()
        cv_batches_replayed += 1
        add_counts(None if self.mesh is None else self.mesh.traffic,
                   g.counts)

    def _capture(self, key: tuple, held: tuple, starts: torch.Tensor,
                 mask: torch.Tensor) -> _CVGraph:
        """Run one batch eagerly on new static tensors on a side stream,
        then capture it there (``utils.graphs.capture``) ->
        the graph, whose sums now hold this pass's so far and that batch.
        The capture runs nothing: what it added to the counters and to
        ``Mesh.traffic`` comes back off, and each replay adds it."""
        global cv_graphs_captured
        traffic = None if self.mesh is None else self.mesh.traffic
        with torch.cuda.device(self.device):
            g = _CVGraph(
                key, held, torch.cuda.CUDAGraph(), torch.cuda.Stream(),
                self.noisy, self.clean,
                starts.to(self.device, non_blocking=True),
                mask.to(self.device, non_blocking=True),
                self.state.alpha.clone(), self.acc.clone(),
                owns_frames=self.own_frames)
            *_, g.counts = graphs.capture(
                lambda: self._step(g), g.stream, graph=g.graph,
                counts=(KERNEL_COUNTERS, traffic))
        cv_graphs_captured += 1
        if traffic is not None:
            release_on_shutdown(g)
        self.acc = g.acc
        return g

    def _step(self, g: _CVGraph) -> None:
        g.acc.add_(cv_chunk_metrics(self.state.model, g.noisy, g.clean,
                                    g.starts, g.mask, g.alpha,
                                    self.hyper).double())

    def sums(self) -> list[float]:
        """The pass's (squared error, abs error, (|err|/alpha)^beta) sums,
        read from the device once."""
        return self.acc.tolist()
