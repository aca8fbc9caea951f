"""The data mesh of the training engine: a process group seen as one axis.

Port of ``tpu_se/parallel/mesh.py``.  The workload is data-parallel by
nature (each sample is an independent 1799-dim spliced frame; the model
fits one card), so the mesh has one axis that does work, ``data``:

- frames [F, 257]: replicated (every rank gathers its own rows of a bunch
  from the whole chunk or the resident span);
- window starts [n_bunches, M]: split on the bunch axis ``M`` in contiguous
  blocks, rank k taking columns [k*M/P, (k+1)*M/P), as the reference's
  ``NamedSharding(P(None, "data"))`` lays them out;
- parameters and velocity: replicated; what GSPMD turns into psums there is
  written out here: the GGD column sums and the flattened gradients are
  all-reduced (``Mesh.all_reduce_sum``) once per bunch each.

Where the reference is one process over N local devices, or one process
per host, the port is always one process per device: ``make_mesh`` wraps
the ``torch.distributed`` group this process has joined, and
``launch_local_ranks`` starts the N processes of a one-host mesh.  The
``model`` axis (tensor-parallel hidden layers, ``param_shardings``) is not
ported yet: ``make_mesh(model > 1)`` raises.
"""

from __future__ import annotations

import socket
from dataclasses import dataclass

import torch
import torch.distributed as dist

MODEL_AXIS_MESSAGE = ("the model axis (--mesh-model > 1, tensor-parallel "
                      "hidden layers) is not ported to tpu_se_torch yet: it "
                      "is queued after data-parallel training; use "
                      "--mesh-model 1")


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
    """This process's place in a data mesh: ``rank`` of ``size`` ranks, its
    ``device``, and the ``backend`` of the group's collectives (``None``
    for a mesh of one rank without a group, whose sums are its own).

    ``all_reduce_calls`` and ``all_reduce_bytes`` count what
    ``all_reduce_sum`` sent, so a run can show what its collectives moved.
    """

    def __init__(self, rank: int, size: int, device, backend: str | None):
        self.rank = rank
        self.size = size
        self.device = torch.device(device)
        self.backend = backend
        self.all_reduce_calls = 0
        self.all_reduce_bytes = 0
        self._staging: torch.Tensor | None = None
        self._flat: torch.Tensor | None = None

    def _host_staging(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned float32 host buffer of at least ``t``'s size, allocated
        once and grown only when a larger tensor comes."""
        if self._staging is None or self._staging.numel() < t.numel():
            self._staging = torch.empty(t.numel(), dtype=torch.float32,
                                        pin_memory=True)
        return self._staging[: t.numel()].view(t.shape)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """Sum float32 ``t`` over the ranks, in place; returns ``t``.

        NCCL reduces on the card.  gloo reduces on the host: a CUDA tensor
        goes through a pinned host buffer and back.  That is the gloo path
        for every CUDA tensor, chosen by the backend's name.  A mesh
        without a group (one rank) has nothing to add and sends nothing.
        """
        if t.dtype != torch.float32:
            raise ValueError(f"all_reduce_sum takes float32, got {t.dtype}")
        if self.backend is None:
            return t
        if self.backend == "gloo" and t.device.type == "cuda":
            host = self._host_staging(t)
            host.copy_(t)                 # synchronises with the stream
            dist.all_reduce(host, op=dist.ReduceOp.SUM)
            t.copy_(host, non_blocking=True)
        else:
            dist.all_reduce(t, op=dist.ReduceOp.SUM)
        self.all_reduce_calls += 1
        self.all_reduce_bytes += t.numel() * t.element_size()
        return t

    def all_reduce_sum_flat(self, tensors) -> list[torch.Tensor]:
        """Sum a list of float32 tensors over the ranks in ONE all-reduce:
        they are copied side by side into a flat buffer allocated once (a
        bunch's gradients: 12,605,697 floats, 50.4 MB, at full width), the
        buffer is reduced, and views of it in the tensors' shapes are
        returned.  The views are overwritten by the next call."""
        n = sum(t.numel() for t in tensors)
        if (self._flat is None or self._flat.numel() != n
                or self._flat.device != tensors[0].device):
            self._flat = torch.empty(n, dtype=torch.float32,
                                     device=tensors[0].device)
        torch.cat([t.reshape(-1) for t in tensors], out=self._flat)
        self.all_reduce_sum(self._flat)
        views, lo = [], 0
        for t in tensors:
            views.append(self._flat[lo:lo + t.numel()].view(t.shape))
            lo += t.numel()
        return views

    def check_replicas(self, tensors, where: str) -> None:
        """Raise ``RuntimeError`` unless every rank holds the same bits in
        ``tensors`` (float32, the replicated weights): each rank sums every
        tensor's bit patterns as integers, the ranks all-gather those few
        checksums, and each compares them.  Replicas that drift are a
        fault, not noise: every rank applies the same update to the same
        sums, so any difference means a collective or an update went
        wrong.  ``where`` names the moment for the message."""
        if self.backend is None:
            return
        mine = torch.stack([t.detach().contiguous().view(torch.int32)
                            .sum(dtype=torch.int64) for t in tensors])
        mine = mine.to("cuda" if self.backend == "nccl" else "cpu")
        every = [torch.empty_like(mine) for _ in range(self.size)]
        dist.all_gather(every, mine)
        for rank, theirs in enumerate(every):
            if not torch.equal(theirs, every[0]):
                differ = torch.nonzero(theirs != every[0]).flatten().tolist()
                raise RuntimeError(
                    f"replicas differ {where}: rank {rank}'s tensors "
                    f"{differ} (of {len(tensors)}) are not rank 0's bit for "
                    f"bit (seen on rank {self.rank} of {self.size})")


def make_mesh(data: int | None = None, model: int = 1,
              device="cpu") -> Mesh:
    """The data mesh over the process group this process has joined
    (``initialize_distributed``), or a mesh of this one process without a
    group.  ``data`` defaults to the group's size and must equal it: the
    port has no sub-meshes.  Raises as the reference does when the mesh
    needs more devices than there are ranks, and on ``model > 1``."""
    if model > 1:
        raise NotImplementedError(MODEL_AXIS_MESSAGE)
    joined = dist.is_initialized()
    world = dist.get_world_size() if joined else 1
    if data is None:
        data = world
    check_mesh_devices(data, model, world)
    if data != world:
        raise ValueError(f"mesh {data}x{model} does not span the process "
                         f"group's {world} ranks")
    return Mesh(dist.get_rank() if joined else 0, world, device,
                dist.get_backend() if joined else None)


def shard_train_args(mesh: Mesh, noisy, clean, starts):
    """One chunk's arrays in the training layout: the frames as they are
    (replicated), and this rank's columns of the ``[n_bunches, M]`` window
    starts, a contiguous block of M / size.  Raises when the ranks cannot
    split M evenly."""
    m = starts.shape[1]
    if m % mesh.size != 0:
        raise ValueError(f"a bunch of {m} samples does not split evenly "
                         f"over {mesh.size} ranks")
    per = m // mesh.size
    return noisy, clean, starts[:, mesh.rank * per:(mesh.rank + 1) * per]


def free_port() -> int:
    """A TCP port that is free on this host now (for a local mesh's
    coordinator)."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch_local_ranks(fn, n: int, args: tuple = ()) -> None:
    """Run ``fn(rank, *args)`` in ``n`` new processes of this host and wait
    for them: the reference's "one process, N local devices" as PyTorch
    wants it, one process per device.  The processes are spawned, never
    forked (neither CUDA nor a prefetch thread survives a fork).  When one
    fails the others are terminated and its error is raised here."""
    import torch.multiprocessing as mp

    mp.start_processes(fn, args=args, nprocs=n, join=True,
                       start_method="spawn")
