"""Time one training epoch as one rank of a data x model mesh.

    python -m tpu_se_torch.bench.dp_epoch --fea-file F --targ-file T \\
        --norm-file N --init-wts W [--coordinator HOST:PORT \\
        --num-processes P --process-id K [--cpu-collectives gloo] \\
        [--mesh-model M]] [--device cuda|cpu]

Run once per rank, like ``python -m tpu_se_torch train``; without
``--coordinator`` it is the one-device step (the fused GGD kernel, no
collective).  Under a coordinator the model is this rank's shard
(``shard_params``) over a model axis of M ranks, the data axis being the
rest.  Each rank uploads the training span (sharded read and all-gather
under a mesh of several ranks, checked against the unsharded read), trains
one warm-up epoch and then times a second one: resident frames, no CV, the
host clock around an epoch that ends in a synchronise and a barrier.  The
last line of its output is one JSON object: the rank and the mesh, ms per
bunch, the GGD kernels' launches and, per axis, the collectives' calls and
bytes in the timed epoch, and whether the gathered span equalled the
unsharded one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpu_se_torch.data import PfilePairDataset
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.parallel import (
    initialize_distributed, make_mesh, shutdown_distributed, sync_processes,
)
from tpu_se_torch.parallel.mesh import AXES, COLLECTIVES
from tpu_se_torch.train import (
    TrainConfig, load_checkpoint, load_device_frames, train_one_epoch,
)
from tpu_se_torch.utils import resolve_device


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sync_processes("dp_epoch")


def timed_epoch(args, device: torch.device, mesh) -> dict:
    lo, hi = (int(x) for x in args.train_sents.split("-"))
    cfg = TrainConfig(train_sent_range=(lo, hi), traincache=args.traincache)
    ds = PfilePairDataset(args.fea_file, args.targ_file, args.norm_file,
                          cfg.train_sent_range, cfg.traincache)
    frames = load_device_frames(ds, device, mesh)
    whole = load_device_frames(ds, device)
    span_equal = all(torch.equal(a, b) for a, b in zip(frames, whole))
    state = load_checkpoint(args.init_wts, device, mesh=mesh)
    hyper = cfg.hyper()
    bunches = int(sum(int(n) // cfg.bunchsize for n in ds.plan.n_samples))

    def epoch(number: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        train_one_epoch(state, ds, hyper, cfg.lr_for_epoch(number),
                        np.random.default_rng(cfg.seed_for_epoch(number)),
                        device, device_frames=frames, log=lambda s: None,
                        mesh=mesh)
        _sync(device)
        return time.perf_counter() - t0

    def counts() -> list[int]:
        sent = ([] if mesh is None else
                [n for axis in AXES for op in COLLECTIVES
                 for n in mesh.traffic[axis][op]])
        return [ggd_kernel.launches, ggd_kernel.colsum_launches,
                ggd_kernel.grad_from_sums_launches, *sent]

    epoch(1)
    before = counts()
    seconds = epoch(2)
    moved = [b - a for a, b in zip(before, counts())]
    traffic = {f"{axis}_{op}_{what}": n for (axis, op, what), n in zip(
        ((axis, op, what) for axis in AXES for op in COLLECTIVES
         for what in ("calls", "bytes")), moved[3:])}
    return {"rank": 0 if mesh is None else mesh.rank,
            "ranks": 1 if mesh is None else mesh.size,
            "data": 1 if mesh is None else mesh.data,
            "model": 1 if mesh is None else mesh.model,
            "backend": None if mesh is None else mesh.backend,
            "device": str(device), "bunches": bunches,
            "rows_per_rank": cfg.bunchsize // (1 if mesh is None
                                               else mesh.data),
            "ms_per_bunch": seconds / bunches * 1e3,
            "ggd_output_grad_launches": moved[0],
            "ggd_colsum_launches": moved[1],
            "ggd_grad_from_sums_launches": moved[2],
            "all_reduce_calls": sum(v for k, v in traffic.items()
                                    if k.endswith("all_reduce_calls")),
            "all_reduce_bytes": sum(v for k, v in traffic.items()
                                    if k.endswith("all_reduce_bytes")),
            **traffic, "span_equal": span_equal}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.dp_epoch",
                                description=__doc__.splitlines()[0])
    p.add_argument("--fea-file", required=True)
    p.add_argument("--targ-file", required=True)
    p.add_argument("--norm-file", required=True)
    p.add_argument("--init-wts", required=True)
    p.add_argument("--train-sents", default="0-19")
    p.add_argument("--traincache", type=int, default=1024)
    p.add_argument("--coordinator", default="")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--cpu-collectives", default="")
    p.add_argument("--mesh-model", type=int, default=1)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    device = resolve_device(args.device)
    if not args.coordinator:
        print(json.dumps(timed_epoch(args, device, None)))
        return 0
    info = initialize_distributed(args.coordinator, args.num_processes,
                                  args.process_id,
                                  args.cpu_collectives or None, device)
    try:
        mesh = make_mesh(None, args.mesh_model, info["device"])
        result = timed_epoch(args, mesh.device, mesh)
    finally:
        shutdown_distributed()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
