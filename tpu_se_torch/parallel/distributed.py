"""Multi-process runtime glue: ``torch.distributed`` in place of
``jax.distributed``.

Port of ``tpu_se/parallel/distributed.py``.  The reference joins one
process per host into a ``jax.distributed`` cluster and lets GSPMD emit the
collectives; PyTorch's idiom is one process per device, so here a cluster
is a ``torch.distributed`` process group with one rank per device: NCCL
between cards, gloo between CPU ranks (and, with ``cpu_collectives="gloo"``,
between ranks that share one card).  The collectives themselves
(``all_reduce``, ``all_gather``, ``barrier``) stay the library's, as the
reference's psums are XLA's.

- ``initialize_distributed`` joins the group (no-op without a coordinator)
  and returns the reference's summary dict plus the rank's ``device`` and
  the ``backend``;  ``shutdown_distributed`` leaves it.
- ``allgather_rows`` / ``allgather_host_rows`` reassemble a row-sharded
  array (``shard_for_host`` slices, uneven shards padded to the longest).
- ``sync_processes`` is the cross-process barrier.

The default process group is per process: joining twice raises, and code
that joins must leave (``run_training`` does, also on an exception).
"""

from __future__ import annotations

import datetime
import socket

import numpy as np
import torch
import torch.distributed as dist

from tpu_se_torch.data.pipeline import shard_for_host
from tpu_se_torch.utils.device import resolve_device

# A dead peer ends a run after this long instead of hanging it.
DEFAULT_TIMEOUT_S = 300.0


def collective_backend(device: torch.device,
                       cpu_collectives: str | None) -> str:
    """``"nccl"`` for a CUDA device, ``"gloo"`` for the CPU;
    ``cpu_collectives="gloo"`` forces gloo whatever the device."""
    if cpu_collectives:
        if cpu_collectives != "gloo":
            raise ValueError(f"cpu_collectives={cpu_collectives!r}: the only "
                             "host implementation is 'gloo'")
        return "gloo"
    return "nccl" if device.type == "cuda" else "gloo"


def rank_device(device, process_id: int) -> torch.device:
    """The device of rank ``process_id`` for a requested ``device``: a CUDA
    request without an index takes card ``process_id mod`` the cards of
    this host (one card per rank on a host with several, card 0 on a host
    with one); an indexed request and the CPU are taken as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", process_id % torch.cuda.device_count())
    return device


def _device_identity(device: torch.device) -> str:
    """A name that two ranks share exactly when they hold the same card."""
    if device.type != "cuda":
        return f"{socket.gethostname()}/cpu"
    props = torch.cuda.get_device_properties(device)
    return (f"{socket.gethostname()}/cuda:{device.index}/"
            f"{getattr(props, 'uuid', '')}")


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           cpu_collectives: str | None = None,
                           device="cuda",
                           timeout: float = DEFAULT_TIMEOUT_S) -> dict:
    """Join the ``torch.distributed`` group when ``coordinator_address``
    (``"host:port"`` of rank 0) is given; no-op otherwise.

    The backend is NCCL for a CUDA ``device`` and gloo for the CPU, or gloo
    for both with ``cpu_collectives="gloo"``.  NCCL wants one card per
    rank: the ranks exchange their cards' identities through the store and
    every rank raises ``RuntimeError`` if two of them hold the same card,
    before NCCL would fail on its own.  ``timeout`` (seconds) bounds the
    rendezvous and every collective, so a dead peer ends the run.

    Returns the reference's summary (``process_index``, ``process_count``,
    ``local_devices``, ``global_devices``) plus this rank's ``device`` and
    the ``backend`` (``None`` without a group).  ``device`` is ``"cuda"``
    unless the caller asks for the CPU; a CUDA request without a card
    raises (``resolve_device``).
    """
    if coordinator_address is None:
        device = resolve_device(device)
        n_local = (torch.cuda.device_count() if device.type == "cuda" else 1)
        return {"process_index": 0, "process_count": 1,
                "local_devices": n_local, "global_devices": n_local,
                "device": device, "backend": None}
    if dist.is_initialized():
        raise RuntimeError("initialize_distributed: this process already "
                           "belongs to a process group; call "
                           "shutdown_distributed first")
    if num_processes is None or process_id is None:
        raise ValueError("initialize_distributed: a coordinator needs "
                         "num_processes and process_id")
    if not 0 <= process_id < num_processes:
        raise ValueError(f"initialize_distributed: process_id {process_id} "
                         f"is not in [0, {num_processes})")
    host, _, port = coordinator_address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"initialize_distributed: coordinator "
                         f"{coordinator_address!r} is not host:port")
    backend = collective_backend(torch.device(device), cpu_collectives)
    device = rank_device(resolve_device(device), process_id)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    limit = datetime.timedelta(seconds=timeout)
    store = dist.TCPStore(host, int(port), num_processes,
                          is_master=process_id == 0, timeout=limit)
    store.set(f"tpu_se_torch/device/{process_id}", _device_identity(device))
    held = [store.get(f"tpu_se_torch/device/{k}").decode()
            for k in range(num_processes)]
    if backend == "nccl" and len(set(held)) < len(held):
        raise RuntimeError(
            f"NCCL needs one card per rank, but the {num_processes} ranks "
            f"hold {sorted(set(held))}: give every rank its own card, or "
            "pass cpu_collectives='gloo' (--cpu-collectives gloo) to let "
            "ranks share one")
    dist.init_process_group(backend, store=store, rank=process_id,
                            world_size=num_processes, timeout=limit)
    n_local = sum(1 for name in held
                  if name.split("/")[0] == socket.gethostname())
    return {"process_index": process_id, "process_count": num_processes,
            "local_devices": n_local, "global_devices": num_processes,
            "device": device, "backend": backend}


def shutdown_distributed() -> None:
    """Leave the process group that ``initialize_distributed`` joined (no-op
    without one), so the process can join another."""
    if dist.is_initialized():
        dist.destroy_process_group()


def collective_device() -> torch.device:
    """Where the default group's collectives take their tensors: the
    current card under NCCL, the host under gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def allgather_rows(local: torch.Tensor, n_total: int, process_index: int,
                   process_count: int) -> torch.Tensor:
    """Reassemble a row-sharded tensor across the default group, where it
    lies (``collective_device()``): every rank gives the rows of its
    ``shard_for_host`` slice of an ``n_total``-row array and gets the whole
    array.  Uneven shards are padded to the longest for the gather and cut
    back after it, so the result is the unsharded array byte for byte."""
    bounds = [shard_for_host(n_total, p, process_count)
              for p in range(process_count)]
    sizes = [s.stop - s.start for s in bounds]
    if local.shape[0] != sizes[process_index]:
        raise ValueError(f"rank {process_index} of {process_count} holds "
                         f"{local.shape[0]} rows of {n_total}, not its "
                         f"shard's {sizes[process_index]}")
    per_max = max(sizes)
    local = local.contiguous()
    if local.shape[0] < per_max:
        pad = local.new_zeros((per_max - local.shape[0],) + local.shape[1:])
        local = torch.cat([local, pad])
    parts = [torch.empty_like(local) for _ in range(process_count)]
    dist.all_gather(parts, local)
    return torch.cat([part[:n] for part, n in zip(parts, sizes)])


def allgather_host_rows(local: np.ndarray, n_total: int, process_index: int,
                        process_count: int) -> np.ndarray:
    """``allgather_rows`` for a host array: numpy in, numpy out, through
    the card under NCCL.  Each rank reads 1/P of the bytes from storage and
    the interconnect distributes the rest."""
    where = collective_device()
    rows = torch.from_numpy(np.ascontiguousarray(local)).to(where)
    return allgather_rows(rows, n_total, process_index,
                          process_count).cpu().numpy()


def sync_processes(tag: str = "tpu_se_torch") -> None:
    """Cross-process barrier (no-op single-process).  ``tag`` names the
    place for a reader, as in the reference; the barrier itself does not
    take it."""
    del tag
    if dist.is_initialized() and dist.get_world_size() > 1:
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()
