"""The training mesh: a process group seen as a ``data`` x ``model`` grid.

Port of ``tpu_se/parallel/mesh.py``.  The reference lays its devices out
as ``devices.reshape(data, model)``; the port lays the ranks of its
process group out the same way, rank = d * model + m, one rank per device:

- frames [F, 257]: replicated (every rank gathers its own rows of a bunch
  from the whole chunk or the resident span);
- window starts [n_bunches, M]: split on the bunch axis ``M`` over the
  ``data`` axis in contiguous blocks, data index d taking columns
  [d*M/D, (d+1)*M/D), as the reference's ``NamedSharding(P(None, "data"))``
  lays them out; the ranks of one data index share its block;
- parameters and velocity: laid out by ``param_shardings`` -- replicated
  with a trivial model axis, and with ``model > 1`` the hidden layers
  alternate column- and row-parallel (Megatron-style) while the output
  layer stays replicated (``tpu_se_torch.parallel.tensor``).

Where GSPMD inserts collectives, the port writes them out over one axis
at a time (``Mesh.all_reduce_sum``, ``all_gather``): the GGD column sums
and the flattened gradients over ``data``, the activations of the
tensor-parallel layers over ``model``.  Every rank makes one
``torch.distributed`` subgroup per axis (``make_mesh``).

Where the reference is one process over N local devices, or one process
per host, the port is always one process per device: ``make_mesh`` wraps
the ``torch.distributed`` group this process has joined, and
``launch_local_ranks`` starts the N processes of a one-host mesh.
"""

from __future__ import annotations

import random
import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

from tpu_se_torch.utils.device import resolve_device

AXES = ("data", "model")
COLLECTIVES = ("all_reduce", "all_gather")
# Types that ``Mesh.all_gather`` carries as float32, exactly both ways:
# NCCL has no int16, and one carried type serves every backend.
_CARRIED_AS_FLOAT32 = (torch.int16, torch.bfloat16, torch.float16)


@dataclass(frozen=True)
class MeshConfig:
    """A requested mesh shape, before any process group exists."""
    data: int
    model: int = 1

    @property
    def n_devices(self) -> int:
        return self.data * self.model


def check_mesh_devices(data: int, model: int, have: int) -> None:
    """Raise the reference's error when a ``data`` x ``model`` mesh needs
    more devices than the ``have`` at hand."""
    n = data * model
    if n > have:
        raise ValueError(f"mesh {data}x{model} needs {n} devices, "
                         f"have {have}")


class Mesh:
    """This process's place in a ``data`` x ``model`` mesh: ``rank`` of
    ``size`` ranks (``data_rank`` = rank // model, ``model_rank`` = rank %
    model), its ``device``, and the ``backend`` of the group's collectives
    (``None`` for a mesh of one rank without a group, whose sums are its
    own).

    A collective over an axis that spans the whole group runs on the
    default group, even at one rank (a one-rank NCCL mesh still goes
    through NCCL); over a smaller axis it runs on that axis' subgroup
    (``join_axis_groups``), and an axis of one rank inside a larger group
    has nothing to add and sends nothing.

    ``traffic[axis][op]`` is ``[calls, bytes]``: what this rank put into
    the collectives ``op`` over ``axis`` (the tensor it gave), so a run can
    show what its collectives moved.
    """

    def __init__(self, rank: int, size: int, device, backend: str | None,
                 model: int = 1):
        if model < 1 or size % model != 0:
            raise ValueError(f"a model axis of {model} does not divide "
                             f"{size} ranks")
        self.rank = rank
        self.size = size
        self.model = model
        self.data = size // model
        self.data_rank = rank // model
        self.model_rank = rank % model
        self.device = torch.device(device)
        self.backend = backend
        self.traffic = {axis: {op: [0, 0] for op in COLLECTIVES}
                        for axis in AXES}
        self._groups: dict = {}
        self._staging: torch.Tensor | None = None
        self._flat: torch.Tensor | None = None

    @property
    def all_reduce_calls(self) -> int:
        return sum(self.traffic[axis]["all_reduce"][0] for axis in AXES)

    @property
    def all_reduce_bytes(self) -> int:
        return sum(self.traffic[axis]["all_reduce"][1] for axis in AXES)

    def axis_size(self, axis: str) -> int:
        if axis not in AXES:
            raise ValueError(f"unknown mesh axis {axis!r}")
        return self.data if axis == "data" else self.model

    def axis_ranks(self, axis: str) -> list[int]:
        """The ranks of this rank's line along ``axis``, in axis order."""
        if axis == "data":
            return [d * self.model + self.model_rank for d in range(self.data)]
        self.axis_size(axis)
        return [self.data_rank * self.model + m for m in range(self.model)]

    def join_axis_groups(self) -> None:
        """Make the subgroup of every line of each axis that is smaller than
        the group.  ``torch.distributed.new_group`` must be called by every
        rank for every group, in the same order, so each rank makes them
        all and keeps its own."""
        for axis in AXES:
            n = self.axis_size(axis)
            if n in (1, self.size):
                continue
            lines = ([[d * self.model + m for d in range(self.data)]
                      for m in range(self.model)] if axis == "data" else
                     [[d * self.model + m for m in range(self.model)]
                      for d in range(self.data)])
            for ranks in lines:
                group = dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis] = group

    def _idle(self, axis: str) -> bool:
        """True when a collective over ``axis`` has nothing to do."""
        return (self.backend is None
                or (self.axis_size(axis) == 1 and self.size > 1))

    def _count(self, axis: str, op: str, t: torch.Tensor) -> None:
        entry = self.traffic[axis][op]
        entry[0] += 1
        entry[1] += t.numel() * t.element_size()

    def _host_staging(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned float32 host buffer of at least ``t``'s size, allocated
        once and grown only when a larger tensor comes."""
        if self._staging is None or self._staging.numel() < t.numel():
            self._staging = torch.empty(t.numel(), dtype=torch.float32,
                                        pin_memory=True)
        return self._staging[: t.numel()].view(t.shape)

    def all_reduce_sum(self, t: torch.Tensor, axis: str = "data"
                       ) -> torch.Tensor:
        """Sum float32 ``t`` over the ranks of this rank's ``axis``, in
        place; returns ``t``.

        NCCL reduces on the card.  gloo reduces on the host: a CUDA tensor
        goes through a pinned host buffer and back.  That is the gloo path
        for every CUDA tensor, chosen by the backend's name.
        """
        if t.dtype != torch.float32:
            raise ValueError(f"all_reduce_sum takes float32, got {t.dtype}")
        if self._idle(axis):
            return t
        group = self._groups.get(axis)
        if self.backend == "gloo" and t.device.type == "cuda":
            host = self._host_staging(t)
            host.copy_(t)                 # synchronises with the stream
            dist.all_reduce(host, op=dist.ReduceOp.SUM, group=group)
            t.copy_(host, non_blocking=True)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)
        self._count(axis, "all_reduce", t)
        return t

    def all_reduce_sum_flat(self, tensors, axis: str = "data"
                            ) -> list[torch.Tensor]:
        """Sum a list of float32 tensors over ``axis`` in ONE all-reduce:
        they are copied side by side into a flat buffer allocated once (a
        bunch's gradients: 12,605,697 floats, 50.4 MB, at full width on one
        rank of the model axis), the buffer is reduced, and views of it in
        the tensors' shapes are returned.  The views are overwritten by the
        next call."""
        n = sum(t.numel() for t in tensors)
        if (self._flat is None or self._flat.numel() != n
                or self._flat.device != tensors[0].device):
            self._flat = torch.empty(n, dtype=torch.float32,
                                     device=tensors[0].device)
        torch.cat([t.reshape(-1) for t in tensors], out=self._flat)
        self.all_reduce_sum(self._flat, axis)
        views, lo = [], 0
        for t in tensors:
            views.append(self._flat[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()
        return views

    def all_gather(self, t: torch.Tensor, dim: int, axis: str
                   ) -> torch.Tensor:
        """The ``axis`` ranks' tensors (of one shape) joined along ``dim``
        in axis order -> a new tensor on ``t``'s device.  int16, bfloat16
        and float16 travel as float32 (exact both ways); under gloo a CUDA
        tensor travels through the host."""
        if self._idle(axis):
            return t
        group = self._groups.get(axis)
        kind = t.dtype
        send = t.float() if kind in _CARRIED_AS_FLOAT32 else t
        if self.backend == "gloo":
            send = send.cpu()
        send = send.contiguous()
        parts = [torch.empty_like(send) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, send, group=group)
        self._count(axis, "all_gather", send)
        return torch.cat(parts, dim=dim).to(t.device).to(kind)

    def check_replicas(self, tensors, where: str,
                       axis: str | None = None) -> None:
        """Raise ``RuntimeError`` unless every rank of the group (or, with
        ``axis``, of this rank's line along it) holds the same bits in
        ``tensors`` (float32): each rank sums every tensor's bit patterns
        as integers, the ranks all-gather those few checksums, and each
        compares them.  Replicas that drift are a fault, not noise: every
        rank applies the same update to the same sums, so any difference
        means a collective or an update went wrong.  ``where`` names the
        moment for the message."""
        if self.backend is None or (axis is not None and self._idle(axis)):
            return
        ranks = list(range(self.size)) if axis is None else \
            self.axis_ranks(axis)
        mine = torch.stack([t.detach().contiguous().view(torch.int32)
                            .sum(dtype=torch.int64) for t in tensors])
        mine = mine.to("cuda" if self.backend == "nccl" else "cpu")
        every = [torch.empty_like(mine) for _ in ranks]
        dist.all_gather(every, mine,
                        group=None if axis is None else self._groups.get(axis))
        for rank, theirs in zip(ranks, every):
            if not torch.equal(theirs, every[0]):
                differ = torch.nonzero(theirs != every[0]).flatten().tolist()
                raise RuntimeError(
                    f"replicas differ {where}: rank {rank}'s tensors "
                    f"{differ} (of {len(tensors)}) are not rank {ranks[0]}'s "
                    f"bit for bit (seen on rank {self.rank} of {self.size})")


def make_mesh(data: int | None = None, model: int = 1,
              device="cuda") -> Mesh:
    """The ``data`` x ``model`` mesh over the process group this process
    has joined (``initialize_distributed``), or a mesh of this one process
    without a group.  ``data`` defaults to the group's size over ``model``;
    ``data * model`` must equal the group's size: the port has no
    sub-meshes.  Raises as the reference does when the mesh needs more
    devices than there are ranks.  ``device`` is this rank's (``"cuda"``
    unless the caller asks for the CPU)."""
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if data is None:
        data = max(1, world // model)
    check_mesh_devices(data, model, world)
    if data * model != world:
        raise ValueError(f"mesh {data}x{model} does not span the process "
                         f"group's {world} ranks")
    mesh = Mesh(dist.get_rank() if joined else 0, world,
                resolve_device(device),
                dist.get_backend() if joined else None, model=model)
    if joined:
        mesh.join_axis_groups()
    return mesh


def param_shardings(mesh, n_layers: int) -> list[dict]:
    """Per-layer layout of the parameters and velocity, as the reference's
    ``param_shardings`` gives it (``tpu_se/parallel/mesh.py:62-84``), each
    spec a tuple of the axis name or ``None`` per dimension (``()`` is
    replicated).

    With a trivial model axis everything replicates.  With ``mesh.model >
    1`` the hidden layers alternate column-/row-parallel: even layers ``w
    [in, h]`` on ``h`` with their bias, odd layers ``w [h, out]`` on their
    input dim with a replicated bias; the output layer stays replicated.
    """
    tp = mesh.model > 1
    out = []
    for i in range(n_layers):
        last = i == n_layers - 1
        if not tp or last:
            w_spec = ()
        elif i % 2 == 0:
            w_spec = (None, "model")     # column-parallel
        else:
            w_spec = ("model", None)     # row-parallel
        b_spec = ("model",) if (tp and not last and i % 2 == 0) else ()
        out.append({"w": w_spec, "b": b_spec})
    return out


def shard_train_args(mesh: Mesh, noisy, clean, starts):
    """One chunk's arrays in the training layout: the frames as they are
    (replicated), and this rank's columns of the ``[n_bunches, M]`` window
    starts, the block of M / data of its data index.  Raises when the data
    axis cannot split M evenly."""
    m = starts.shape[1]
    if m % mesh.data != 0:
        raise ValueError(f"a bunch of {m} samples does not split evenly "
                         f"over {mesh.data} ranks of the data axis")
    per = m // mesh.data
    return noisy, clean, starts[:, mesh.data_rank * per:
                                (mesh.data_rank + 1) * per]


# Ports that ``free_port`` draws from: below Linux's default ephemeral
# range (32768-60999), so that no socket the OS numbers itself -- a gloo
# connection of another group on this host, say -- takes the port between
# the draw and the coordinator's bind.
_PORTS = range(20000, 32768)


def free_port() -> int:
    """A TCP port that is free on this host now (for a local mesh's
    coordinator), drawn at random from ``_PORTS``."""
    draw = random.SystemRandom()
    while True:
        port = draw.choice(_PORTS)
        with socket.socket() as s:
            try:
                s.bind(("127.0.0.1", port))
            except OSError:
                continue
            return port


def launch_local_ranks(fn, n: int, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``n`` new processes of this host and wait
    for them: the reference's "one process, N local devices" as PyTorch
    wants it, one process per device.  The processes are spawned, never
    forked (neither CUDA nor a prefetch thread survives a fork).  When one
    fails the others are terminated and its error is raised here."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=args, nprocs=n, join=True,
                       start_method="spawn")
