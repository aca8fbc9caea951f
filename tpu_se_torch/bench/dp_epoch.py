"""Time one training epoch as one rank of a data x model mesh.

    python -m tpu_se_torch.bench.dp_epoch --fea-file F --targ-file T \\
        --norm-file N --init-wts W [--coordinator HOST:PORT \\
        --num-processes P --process-id K [--cpu-collectives gloo] \\
        [--mesh-model M]] [--overlap] [--lrate LR] \\
        [--compute-dtype float32|bfloat16] [--out W.wts] [--profile] \\
        [--device cuda|cpu]

Run once per rank, like ``python -m tpu_se_torch train``; without
``--coordinator`` it is the one-device step (the fused GGD kernel, no
collective).  Under a coordinator the model is this rank's shard
(``shard_params``) over a model axis of M ranks, the data axis being the
rest.  ``--overlap`` trains with ``train_chunk_overlap`` (one all-reduce
per layer, started as its gradient exists) in place of ``train_chunk``
(one flattened all-reduce after the backward pass): the counterpart of
``tpu_se``'s ``tools/overlap_sweep.py`` measurement.  Each rank uploads
the training span (sharded read and all-gather under a mesh of several
ranks, checked against the unsharded read), trains one warm-up epoch and
then times a second one: resident frames, no CV, the momentum carried
from the first epoch into the second, the host clock around an epoch that
ends in a synchronise and a barrier.  ``--out`` writes the weights after
both epochs (rank 0, whole tensors), so that runs on other meshes or with
the other step can be held to each other (``worst_change``);
``--profile`` then traces ``PROFILE_BUNCHES`` bunches
(``profile_bunches``).  The last line of its output is
one JSON object: the step, the rank and the mesh, ms per bunch, the GGD
kernels' launches (in the timed epoch, and over both), per axis the
collectives' calls and bytes in the timed epoch, and whether the gathered
span equalled the unsharded one.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch

from tpu_se_torch.data import PfilePairDataset
from tpu_se_torch.io import write_wts
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.parallel import (
    gather_params, initialize_distributed, make_mesh, shutdown_distributed,
    sync_processes,
)
from tpu_se_torch.parallel.mesh import AXES, COLLECTIVES, shard_train_args
from tpu_se_torch.parallel.overlap_step import train_chunk_overlap
from tpu_se_torch.train import (
    TrainConfig, load_checkpoint, load_device_frames, train_chunk,
    train_one_epoch,
)
from tpu_se_torch.train.loop import to_device
from tpu_se_torch.utils import resolve_device

PROFILE_BUNCHES = 8     # bunches traced by --profile
HOST_OPS = 8            # host ops listed by self time in the trace


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sync_processes("dp_epoch")


def worst_change(init: list, ref: list, got: list) -> float:
    """Largest over tensors of |dW_got - dW_ref| / |dW_ref|, where dW is a
    run's change from ``init`` (whole numpy layers, as ``read_wts``)."""
    worst = 0.0
    for a, r, g in zip(init, ref, got):
        for k in ("w", "b"):
            d_ref = r[k].astype(np.float64) - a[k]
            d_got = g[k].astype(np.float64) - a[k]
            worst = max(worst, np.linalg.norm(d_got - d_ref)
                        / np.linalg.norm(d_ref))
    return worst


def profile_bunches(state, ds, frames, hyper, step, mesh, n: int,
                    device: torch.device) -> dict:
    """``n`` bunches of the first chunk through ``step`` under
    ``torch.profiler`` (after a warm-up bunch) -> where the gradient
    all-reduces fall among the backward products on the host, and for how
    long NCCL kernels run beside GEMM kernels on the device.

    Per bunch the host issues the GGD column sums' all-reduce (ML), then
    the gradients': one (flat step) or one per layer (overlapped step; two
    in bfloat16).  ``products_in_flight`` counts, per bunch, the backward
    products (``aten::mm``) issued after its first gradient all-reduce was
    started: 0 for the flat step, two per hidden layer for the overlapped
    one.  ``nccl_gemm_overlap_us`` sums the intersections of NCCL kernels'
    and GEMM kernels' device intervals (one NCCL rank launches no kernel
    for an in-place sum).  Where the host's time goes: ``wall_ms`` per
    bunch under the profiler, the device kernels' summed ``kernel_us`` per
    bunch, and the ``HOST_OPS`` host ops of most self time, in µs per
    bunch (the self time of ``Mesh.all_reduce_sum`` and of
    ``PendingSum.wait`` is the wait for a ring, of ``cudaStreamSynchronize``
    a copy to the host waiting for the card)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    starts = ds.chunk_starts(0, np.random.default_rng(0))
    m = hyper.bunchsize
    n = min(n, len(starts) // m)
    starts = starts[:n * m].reshape(n, m)
    if mesh is not None:
        _, _, starts = shard_train_args(mesh, None, None, starts)
    starts = to_device(starts.astype(np.int64), device)
    noisy, clean = frames
    step(state, noisy, clean, starts[:1], 1e-3, hyper, mesh=mesh)
    _sync(device)
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        step(state, noisy, clean, starts, 1e-3, hyper, mesh=mesh)
        _sync(device)
        wall = time.perf_counter() - t0
    events = list(prof.events())
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: e.time_range.start)
    n_layers = len(state.model.weights)
    gradient = (1 if step is train_chunk else n_layers * (
        1 if hyper.compute_dtype == torch.float32 else 2))
    per = gradient + (1 if hyper.ml else 0)
    names = sorted({e.name for e in host if e.name.startswith("c10d::")
                    and "allreduce" in e.name.replace("_", "")})
    op = next((name for name in names
               if sum(e.name == name for e in host) == per * n), None)
    if op is None:
        raise RuntimeError(f"profile: all-reduce host ops {names}, none "
                           f"with {per} per bunch over {n} bunches")
    reduces = [e.time_range.start for e in host if e.name == op]
    mm = [e.time_range.start for e in host if e.name == "aten::mm"]
    first = per - gradient
    in_flight = [sum(1 for t in mm if reduces[per * b + first] < t < (
        reduces[per * (b + 1)] if b + 1 < n else float("inf")))
        for b in range(n)]
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    top = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:HOST_OPS]
    nccl = [e for e in kernels if "nccl" in e.name.lower()]
    gemm = [e for e in kernels if "nccl" not in e.name.lower() and any(
        k in e.name.lower() for k in ("gemm", "gemv", "cutlass", "nvjet"))]
    return {"bunches": n, "all_reduce_op": op, "all_reduces": len(reduces),
            "products_in_flight": in_flight, "nccl_kernels": len(nccl),
            "nccl_us": sum(e.time_range.end - e.time_range.start
                           for e in nccl),
            "gemm_kernels": len(gemm),
            "nccl_gemm_overlap_us": sum(
                max(0.0, min(a.time_range.end, b.time_range.end)
                    - max(a.time_range.start, b.time_range.start))
                for a in nccl for b in gemm),
            "wall_ms": wall / n * 1e3,
            "kernel_us": sum(e.time_range.end - e.time_range.start
                             for e in kernels) / n,
            "host_self_us": {e.key: e.self_cpu_time_total / n
                             for e in top}}


def timed_epoch(args, device: torch.device, mesh) -> dict:
    lo, hi = (int(x) for x in args.train_sents.split("-"))
    cfg = TrainConfig(train_sent_range=(lo, hi), traincache=args.traincache,
                      lrate=args.lrate, compute_dtype=args.compute_dtype)
    ds = PfilePairDataset(args.fea_file, args.targ_file, args.norm_file,
                          cfg.train_sent_range, cfg.traincache)
    frames = load_device_frames(ds, device, mesh)
    whole = load_device_frames(ds, device)
    span_equal = all(torch.equal(a, b) for a, b in zip(frames, whole))
    state = load_checkpoint(args.init_wts, device, mesh=mesh)
    hyper = cfg.hyper()
    bunches = int(sum(int(n) // cfg.bunchsize for n in ds.plan.n_samples))
    step = train_chunk_overlap if args.overlap else train_chunk

    def epoch(number: int) -> float:
        _sync(device)
        t0 = time.perf_counter()
        train_one_epoch(state, ds, hyper, cfg.lr_for_epoch(number),
                        np.random.default_rng(cfg.seed_for_epoch(number)),
                        device, device_frames=frames, log=lambda s: None,
                        mesh=mesh, step=step)
        _sync(device)
        return time.perf_counter() - t0

    def counts() -> list[int]:
        sent = ([] if mesh is None else
                [n for axis in AXES for op in COLLECTIVES
                 for n in mesh.traffic[axis][op]])
        return [ggd_kernel.launches, ggd_kernel.colsum_launches,
                ggd_kernel.grad_from_sums_launches, *sent]

    start = counts()
    epoch(1)
    before = counts()
    seconds = epoch(2)
    after = counts()
    moved = [b - a for a, b in zip(before, after)]
    if args.out:
        whole = gather_params(state.model, mesh)
        if mesh is None or mesh.rank == 0:
            write_wts(args.out, whole)
    profiled = ({"profile": profile_bunches(state, ds, frames, hyper, step,
                                            mesh, PROFILE_BUNCHES,
                                            device)}
                if args.profile else {})
    traffic = {f"{axis}_{op}_{what}": n for (axis, op, what), n in zip(
        ((axis, op, what) for axis in AXES for op in COLLECTIVES
         for what in ("calls", "bytes")), moved[3:])}
    return {"step": "overlap" if args.overlap else "flat",
            "rank": 0 if mesh is None else mesh.rank,
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
            "ggd_launches_both_epochs": [b - a for a, b in
                                         zip(start[:3], after[:3])],
            "all_reduce_calls": sum(v for k, v in traffic.items()
                                    if k.endswith("all_reduce_calls")),
            "all_reduce_bytes": sum(v for k, v in traffic.items()
                                    if k.endswith("all_reduce_bytes")),
            **traffic, "span_equal": span_equal, **profiled}


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
    p.add_argument("--overlap", action="store_true",
                   help="train with train_chunk_overlap")
    p.add_argument("--lrate", type=float, default=TrainConfig.lrate)
    p.add_argument("--compute-dtype", default="float32",
                   choices=("float32", "bfloat16"))
    p.add_argument("--out", default="",
                   help="write the trained weights here (.wts)")
    p.add_argument("--profile", action="store_true",
                   help=f"after the epochs, profile {PROFILE_BUNCHES} "
                        f"bunches")
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
