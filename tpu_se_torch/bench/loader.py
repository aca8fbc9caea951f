"""The host chunk loader against numpy, on the card's host.

    python -m tpu_se_torch.bench.loader [--frames 50000] [--reps 5]
        [--out PATH] [--device cuda|cpu]

The port of ``tools/bench_loader.py``, with its workload: a pfile of ten
sentences of ``--frames`` / 10 rows of 257 features (~52 MB of raw rows)
from ``np.random.default_rng(0)``, zero mean and unit scale.  Times the
read + byte-swap + normalise of the whole span through the native library
(``io/native.py``, ``csrc/chunk_loader.cc``) and through numpy
(``read_pfile_rows``), and the splice-scatter of half the windows in a
shuffled order by each route; ``--reps`` timings each, the median, the
quartiles and every value.  The work is all on the host: ``--device``
names the machine's card in the record (a run without one needs
``--device cpu``).  Checks: the two routes' rows and spliced windows equal
bit for bit (the reference tool allowed ``allclose``).  The last line of
the output is the record.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np

from tpu_se_torch.bench.timing import (
    Reading, bench_device, device_record, emit,
)
from tpu_se_torch.io import PFILE_HEADER_SIZE, native, read_pfile_rows
from tpu_se_torch.io import write_pfile

DIM = 257
CONTEXT = 7


def seconds(fn, reps: int) -> Reading:
    values = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        values.append(time.perf_counter() - t0)
    return Reading(values)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.loader",
                                description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=50_000)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="write the record here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = bench_device(args.device, p.prog)
    rng = np.random.default_rng(0)
    utts = [rng.standard_normal((args.frames // 10, DIM)).astype(np.float32)
            for _ in range(10)]
    mean = np.zeros(DIM, np.float32)
    inv = np.ones(DIM, np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "bench.pfile")
        write_pfile(path, utts)
        n = sum(len(u) for u in utts)

        def run_native():
            return native.read_chunk_normalized(
                path, PFILE_HEADER_SIZE, DIM, 0, n, mean, inv)

        def run_numpy():
            rows = read_pfile_rows(path, DIM, 0, n)
            return ((rows - mean) * inv).astype(np.float32)

        out_n, out_p = run_native(), run_numpy()      # warm the page cache
        t_native = seconds(run_native, args.reps)
        t_numpy = seconds(run_numpy, args.reps)
    starts = rng.permutation(n - CONTEXT)[: n // 2].astype(np.int32)
    scatter = rng.permutation(len(starts)).astype(np.int32)

    def run_splice_native():
        return native.splice_scatter(out_n, starts, scatter, CONTEXT)

    def run_splice_numpy():
        idx = starts[:, None] + np.arange(CONTEXT)[None, :]
        spliced = out_n[idx].reshape(len(starts), CONTEXT * DIM)
        out = np.empty_like(spliced)
        out[scatter] = spliced
        return out

    splice_equal = np.array_equal(run_splice_native(), run_splice_numpy())
    t_sn = seconds(run_splice_native, args.reps)
    t_sp = seconds(run_splice_numpy, args.reps)
    mb = n * (DIM + 2) * 4 / 1e6
    ms = {name: r.record() for name, r in (
        ("native", t_native), ("numpy", t_numpy),
        ("splice_native", t_sn), ("splice_numpy", t_sp))}
    return emit({
        "metric": "loader_read_swap_normalize_MBps",
        "value": mb / t_native.median, "unit": "MB/s",
        "vs_baseline": t_numpy.median / t_native.median,
        "detail": {"frames": n, "raw_MB": mb,
                   "native_ms": t_native.median * 1e3,
                   "numpy_ms": t_numpy.median * 1e3,
                   "splice_native_ms": t_sn.median * 1e3,
                   "splice_numpy_ms": t_sp.median * 1e3,
                   "numpy_MBps": mb / t_numpy.median,
                   "seconds": ms},
        "device": device_record(device),
        "checks": {"rows_bitwise": bool(np.array_equal(out_n, out_p)),
                   "splice_bitwise": bool(splice_equal)}}, args.out)


if __name__ == "__main__":
    sys.exit(main())
