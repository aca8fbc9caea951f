"""Sweep of the GGD output-gradient kernel's launch plan on the card.

    python -m tpu_se_torch.bench.sweep_ggd [--probe] [--skip-variants]
        [--out build/sweep_ggd.json]

Builds ``csrc/ggd_kernel.cu`` once per variant with the plan forced by
``-DGGD_FORCE_COLS/_THREADS/_CLUSTER/_TILE_KB/_BATCH`` (columns per strip,
threads per block, blocks per cluster, the most shared memory a block
keeps the error in, rows a thread loads at a time; ``--cols`` and the like
narrow the lists), all builds started together, and
times each through its C interface, with no Python wrapper in the way:

- device microseconds per call by CUDA-graph replay (``device_us``), at
  beta = 1 (the shortcut) and beta = 0.9 (``powf`` on every element), for
  M in ``MS`` at D = 257, on inputs that stay in the L2 cache between
  replays ("warm") and, rotating over more than 50 MB of inputs, that do
  not ("cold");
- beside each, the byte bound (3 * M * D * 4 bytes at 3.35 TB/s) and an
  empty kernel launched with the same grid, cluster and block;
- each variant is first held to ``ggd_output_grad_plain`` (rtol 5e-6).

With ``--probe``, a few variants are also built with ``-DGGD_PROBE`` and
report where a launch's time goes, from the blocks' own clocks (no
profiler of kernels' insides runs everywhere): microseconds per step of
the kernel, the spread of the blocks' start times, first start to last
end.

Then, with the library as the package builds it: the wrapper's time per
call by CUDA events over back-to-back calls (host issue time included),
and the host's time for one ``[M + 1, D]`` allocation against two
(``--skip-variants`` runs only this).  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import itertools
import json
import os
import time

import numpy as np
import torch

from tpu_se_torch.bench.fixtures import SEED, card_line, device_us, time_ms
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.ops._build import SRC_DIR, bind_ggd, build_library

D = 257
MS = (128, 1000, 2048, 4096, 8192, 16384)
HBM_BYTES_PER_S = 3.35e12           # published, H100 SXM at 700 W
L2_BYTES = 50e6
RTOL = 5e-6
COLS = (32, 16)
THREADS = (256, 512, 1024)
CLUSTERS = (4, 8, 16)         # 16 is past the portable maximum of 8
TILE_KB = (96, 192)           # 96: two blocks' tiles fit one SM
BATCH = (4, 16)               # rows a thread loads at a time


def bound_us(m: int, d: int = D) -> float:
    """Each input read once, the output written once, at the memory rate."""
    return 3 * m * d * 4 / HBM_BYTES_PER_S * 1e6


def variants(args):
    for cols, threads, cluster, tile_kb, batch in itertools.product(
            args.cols, args.threads, args.clusters, args.tile_kb, args.batch):
        yield {"cols": cols, "threads": threads, "cluster": cluster,
               "tile_kb": tile_kb, "batch": batch}


def defines(v: dict, probe: bool = False) -> tuple[str, ...]:
    return (f"-DGGD_FORCE_COLS={v['cols']}",
            f"-DGGD_FORCE_THREADS={v['threads']}",
            f"-DGGD_FORCE_CLUSTER={v['cluster']}",
            f"-DGGD_FORCE_TILE_KB={v['tile_kb']}",
            f"-DGGD_FORCE_BATCH={v['batch']}",
            *(("-DGGD_PROBE",) if probe else ()))


def inputs(rng, m: int, sets: int, dev):
    """``sets`` seeded (out, targ, buf) triples on the card."""
    made = []
    for _ in range(sets):
        out = rng.standard_normal((m, D)).astype(np.float32)
        targ = (out + rng.standard_normal((m, D)) * 0.5).astype(np.float32)
        targ[2::5] = out[2::5]
        made.append((torch.from_numpy(out).to(dev),
                     torch.from_numpy(targ).to(dev),
                     torch.empty((m + 1, D), device=dev)))
    return made


def caller(lib, sets, m: int, beta: float):
    """A function that launches the kernel on the next input set."""
    args = ggd_kernel._beta_args(beta)
    turn = itertools.cycle(sets)

    def call():
        out, targ, buf = next(turn)
        rc = lib.ggd_output_grad(out.data_ptr(), targ.data_ptr(),
                                 buf.data_ptr(), buf[m].data_ptr(), m, D,
                                 *args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")
    return call


def check(lib, sets, m: int) -> float:
    """Max relative error against plain over beta in {1, 0.9}."""
    out, targ, buf = sets[0]
    worst = 0.0
    for beta in (1.0, 0.9):
        caller(lib, sets[:1], m, beta)()
        torch.cuda.synchronize()
        want_d, want_a = ggd_kernel.ggd_output_grad_plain(out, targ, beta)
        for got, want in ((buf[:m], want_d), (buf[m], want_a)):
            nz = want != 0
            if bool((got[~nz] != 0).any()):
                return float("inf")
            worst = max(worst, ((got - want).abs()[nz]
                                / want.abs()[nz]).max().item())
    return worst


def sweep(dev, args) -> list[dict]:
    source = [SRC_DIR / "ggd_kernel.cu"]
    todo = list(variants(args))
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(os.cpu_count() or 4) as pool:
        paths = list(pool.map(
            lambda v: build_library(source, defines(v))[0], todo))
    print(f"built {len(todo)} variants in {time.perf_counter() - t0:.1f} s")

    rng = np.random.default_rng(SEED)
    rows = []
    for m in MS:
        n_cold = int(L2_BYTES * 2 // (3 * m * D * 4)) + 1
        sets = inputs(rng, m, min(n_cold, 20), dev)
        for v, path in zip(todo, paths):
            lib = bind_ggd(ctypes.CDLL(str(path)))
            row = {**v, "m": m, "bound_us": bound_us(m)}
            plan = (ctypes.c_int * 5)()
            lib.ggd_plan(m, D, plan)
            row.update(rows_per_block=plan[3], keep=plan[4])
            try:
                row["max_rel"] = check(lib, sets, m)
                if not row["max_rel"] <= RTOL:
                    raise RuntimeError(f"max rel {row['max_rel']:.3e}")
                for beta, key in ((1.0, "b1"), (0.9, "b09")):
                    row[f"warm_{key}_us"] = device_us(
                        caller(lib, sets[:1], m, beta))
                    row[f"cold_{key}_us"] = device_us(
                        caller(lib, sets, m, beta), calls=len(sets))
                stream = torch.cuda.current_stream

                def floor():
                    lib.ggd_launch_floor(m, D, stream().cuda_stream)
                row["floor_us"] = device_us(floor)
            except RuntimeError as exc:
                row["error"] = str(exc)
                torch.cuda.synchronize()
            rows.append(row)
            print(json.dumps(row))
    return rows


PROBE_STEPS = ("load+sum", "tree", "cluster.sync", "alpha", "gradient",
               "last sync")
PROBE_VARIANTS = tuple(
    {"cols": cols, "threads": threads, "cluster": cluster, "tile_kb": 96,
     "batch": batch}
    for cols, threads, cluster, batch in (
        (32, 256, 8, 4), (16, 256, 8, 16), (16, 1024, 8, 16)))


def probe(dev) -> list[dict]:
    """Where a launch's time goes: the kernel built with ``-DGGD_PROBE``
    notes each block's clock at every step.  Per variant and M, at
    beta = 1: microseconds per step (mean and slowest block), the spread of
    the blocks' start times, and first start to last end."""
    source = [SRC_DIR / "ggd_kernel.cu"]
    rng = np.random.default_rng(SEED)
    rows = []
    for v in PROBE_VARIANTS:
        path, _ = build_library(source, defines(v, probe=True))
        lib = bind_ggd(ctypes.CDLL(str(path)))
        lib.ggd_set_probe.argtypes = [ctypes.c_void_p]
        for m in MS:
            sets = inputs(rng, m, 1, dev)
            blocks = -(-D // v["cols"]) * v["cluster"]
            notes = torch.zeros((blocks, 16), dtype=torch.int64, device=dev)
            if lib.ggd_set_probe(notes.data_ptr()) != 0:
                raise RuntimeError("ggd_set_probe failed")
            call = caller(lib, sets, m, 1.0)
            for _ in range(5):
                call()
            torch.cuda.synchronize()
            t = notes.cpu().numpy().astype(np.float64)
            ns_per_clock = np.median((t[:, 14] - t[:, 8]) / (t[:, 6] - t[:, 0]))
            steps = (t[:, 1:7] - t[:, 0:6]) * ns_per_clock / 1e3
            row = {**v, "m": m, "blocks": blocks,
                   "ns_per_clock": ns_per_clock,
                   "start_spread_us": (t[:, 8].max() - t[:, 8].min()) / 1e3,
                   "first_start_to_last_end_us":
                       (t[:, 14].max() - t[:, 8].min()) / 1e3,
                   "steps_mean_us": dict(zip(PROBE_STEPS,
                                             steps.mean(axis=0).tolist())),
                   "steps_max_us": dict(zip(PROBE_STEPS,
                                            steps.max(axis=0).tolist()))}
            rows.append(row)
            print(json.dumps(row))
    return rows


def wrapper_times(dev) -> list[dict]:
    rng = np.random.default_rng(SEED)
    rows = []
    for m in (128, 4096):
        (out, targ, _), = inputs(rng, m, 1, dev)
        row = {"m": m, "plan": ggd_kernel.plan(m, D)._asdict()}
        for beta in (1.0, 0.9):
            def call():
                return ggd_kernel.ggd_output_grad_cuda(out, targ, beta)
            row[f"events_us_beta{beta}"] = [time_ms(call) * 1e3
                                            for _ in range(5)]
            row[f"device_us_beta{beta}"] = device_us(call)
        row["plain_events_us"] = time_ms(
            lambda: ggd_kernel.ggd_output_grad_plain(out, targ, 1.0)) * 1e3
        row["plain_device_us"] = device_us(
            lambda: ggd_kernel.ggd_output_grad_plain(out, targ, 1.0))

        def host_us(fn, n=2000):
            fn()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            return (time.perf_counter() - t0) / n * 1e6
        row["host_us_one_alloc"] = host_us(
            lambda: torch.empty((m + 1, D), device=dev))
        row["host_us_two_allocs"] = host_us(
            lambda: (torch.empty_like(out), torch.empty(D, device=dev)))
        rows.append(row)
        print(json.dumps(row))
    return rows


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--out", default="build/sweep_ggd.json")
    parser.add_argument("--skip-variants", action="store_true",
                        help="only the wrapper's times")
    for name, default in (("cols", COLS), ("threads", THREADS),
                          ("clusters", CLUSTERS), ("tile-kb", TILE_KB),
                          ("batch", BATCH)):
        parser.add_argument(f"--{name}", type=int, nargs="+", default=default,
                            help=f"variants to build (default {default})")
    parser.add_argument("--probe", action="store_true",
                        help="also time the kernel's steps from inside")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("sweep_ggd needs a CUDA card")
    dev = torch.device("cuda")
    card = card_line()
    print(f"card    {card}")
    result = {"card": card, "d": D,
              "variants": [] if args.skip_variants else sweep(dev, args),
              "probe": probe(dev) if args.probe else [],
              "wrapper": wrapper_times(dev)}
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"card    {card}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
