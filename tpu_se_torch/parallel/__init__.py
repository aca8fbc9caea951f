"""Data- and tensor-parallel training over ``torch.distributed``: the port
of ``tpu_se.parallel`` (NCCL between cards, gloo between CPU ranks)."""

from tpu_se_torch.parallel.distributed import (
    allgather_host_rows, allgather_rows, initialize_distributed,
    shutdown_distributed, sync_processes,
)
from tpu_se_torch.parallel.mesh import (
    Mesh, MeshConfig, launch_local_ranks, make_mesh, param_shardings,
    shard_train_args,
)
from tpu_se_torch.parallel.tensor import (
    TensorParallelFFN, gather_params, shard_params,
)

__all__ = [
    "MeshConfig", "Mesh", "make_mesh", "param_shardings", "shard_train_args",
    "TensorParallelFFN", "shard_params", "gather_params",
    "launch_local_ranks", "initialize_distributed", "shutdown_distributed",
    "allgather_rows", "allgather_host_rows", "sync_processes",
]
