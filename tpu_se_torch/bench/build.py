"""Corpus-build time, serial against ``--jobs N``, through the CLI.

    python -m tpu_se_torch.bench.build [--wavs 48] [--seconds 30]
        [--jobs N] [--reps 5] [--out PATH] [--device cuda|cpu]

The port of ``tools/bench_build.py``, with its workload: ``--wavs`` 16 kHz
wavs of ``--seconds`` of noise x 3000 from ``np.random.default_rng(0)``,
and ``--jobs`` the host's core count.  Times, in this process, the port's
``lps-extract --scp ... --device D`` (one LPS kernel launch per file on
the card) with ``--jobs 1`` and with ``--jobs N``, then ``make-pfile`` of
the ``.lps`` list the same two ways, ``--reps`` runs of each, alternating;
every run's outputs must equal the first serial run's byte for byte.  The
reference tool prints no metric line; the record is headed by
``lps_extract_files_per_sec`` (files per second of the ``--jobs`` run,
the candidate feature-preparation metric), followed by the keys of
``benchmarks/build_parallel.json``.  The last line of the output is the
record.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import sys
import tempfile
import time

import numpy as np

from tpu_se_torch.bench.timing import (
    Reading, bench_device, device_record, emit, on_card,
)
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.io import write_wav
from tpu_se_torch.ops import lps_kernel

SAMPLE_RATE = 16000


def quiet_cli(argv: list) -> float:
    """Seconds of one in-process CLI command, its output swallowed."""
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(io.StringIO()):
        rc = cli_main(argv)
    if rc:
        raise SystemExit(f"{argv[0]} exited {rc}")
    return time.perf_counter() - t0


def serial_and_jobs(run, outputs, reps: int, jobs: int
                    ) -> tuple[dict, dict]:
    """``run(["--jobs", n])`` ``reps`` times with n = 1 and with n =
    ``jobs``, alternating -> (the build_parallel.json entry, the
    readings); ``outputs()`` reads what a run wrote."""
    times = {"serial": [], "jobs": []}
    identical, first = True, None
    for r in range(reps):
        for mode in (("serial", "jobs") if r % 2 == 0
                     else ("jobs", "serial")):
            times[mode].append(run(
                ["--jobs", "1" if mode == "serial" else str(jobs)]))
            got = outputs()
            first = first or got
            identical &= got == first
    serial, par = Reading(times["serial"]), Reading(times["jobs"])
    return ({"serial_s": serial.median, "jobs_s": par.median,
             "speedup": serial.median / par.median,
             "outputs_identical": identical},
            {"serial_s": serial.record(), "jobs_s": par.record()})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.build",
                                description=__doc__.splitlines()[0])
    p.add_argument("--wavs", type=int, default=48)
    p.add_argument("--seconds", type=int, default=30)
    p.add_argument("--jobs", type=int, default=os.cpu_count() or 2)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--out", default=None, help="write the record here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = bench_device(args.device, p.prog)
    rng = np.random.default_rng(0)
    launches0 = lps_kernel.launches
    with tempfile.TemporaryDirectory() as d:
        paths = []
        for i in range(args.wavs):
            path = os.path.join(d, f"u{i:03d}.wav")
            write_wav(path, (rng.normal(size=SAMPLE_RATE * args.seconds)
                             * 3000).astype("<i2"), SAMPLE_RATE)
            paths.append(path)
        wav_scp, lps_scp = (os.path.join(d, n) for n in ("wav.scp",
                                                         "lps.scp"))
        lps_paths = [path[:-4] + ".lps" for path in paths]
        for scp, items in ((wav_scp, paths), (lps_scp, lps_paths)):
            with open(scp, "w") as f:
                f.write("\n".join(items) + "\n")
        pfile = os.path.join(d, "all.pfile")

        def read_all(files):
            def outputs():
                out = []
                for path in files:
                    with open(path, "rb") as f:
                        out.append(f.read())
                return out
            return outputs

        def extract(flag: list) -> float:
            return quiet_cli(["lps-extract", "--scp", wav_scp, "--device",
                              str(device), *flag])

        extract(["--jobs", "1"])                            # warm-up
        lps, lps_r = serial_and_jobs(extract, read_all(lps_paths),
                                     args.reps, args.jobs)
        pf, pf_r = serial_and_jobs(
            lambda flag: quiet_cli(["make-pfile", lps_scp, "-o", pfile,
                                    *flag]),
            read_all([pfile]), args.reps, args.jobs)
    return emit({
        "metric": "lps_extract_files_per_sec",
        "value": args.wavs / lps["jobs_s"], "unit": "files/s",
        "n_wavs": args.wavs, "jobs": args.jobs,
        "seconds_per_wav": args.seconds, "reps": args.reps,
        "lps_extract": lps, "make_pfile": pf,
        "readings": {"lps_extract": lps_r, "make_pfile": pf_r},
        "lps_launches": on_card(device, lps_kernel.launches - launches0),
        "device": device_record(device),
        "checks": {"lps_extract_outputs_identical": lps["outputs_identical"],
                   "make_pfile_outputs_identical": pf["outputs_identical"]}},
        args.out)


if __name__ == "__main__":
    sys.exit(main())
