"""The overlapped data-parallel step beside the flat one on every local card.

    python -m tpu_se_torch.bench.overlap_cards [--out-dir DIR] \\
        [--device cuda|cpu]

Writes ``chip_smoke.py``'s synthetic training set (24 sentences,
``bench/fixtures.py:write_train_fixtures``) and a full-width initial model
(``gen-rand-net``, seed 1234) into ``--out-dir``, then trains it through
``bench/dp_epoch.py`` at lrate 0.001: once as one process (the flat step,
the fused GGD kernel: the reference), then as one NCCL rank per card
(``launch_local_ranks``), with the flat and the overlapped step in turns
(flat, overlap, overlap, flat), each cluster alone on the cards and traced
(``dp_epoch --profile``) after its epochs.  Prints every rank-0 JSON line,
each run's weight changes against the one process's (``worst_change``),
whether the two runs of a step wrote the same bytes, and the cards' names
and power limits.  Exits non-zero if a rank fails or a run strays more
than 1e-3 from one process.  ``--device cpu`` runs the same on
``CPU_RANKS`` CPU ranks over gloo (a rehearsal: no card number).
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import subprocess
import sys
import time

import torch

from tpu_se_torch.bench import dp_epoch
from tpu_se_torch.bench.fixtures import SEED, write_train_fixtures
from tpu_se_torch.io import read_wts
from tpu_se_torch.parallel import launch_local_ranks
from tpu_se_torch.parallel.mesh import free_port

LRATE = "0.001"
DW_RTOL = 1e-3      # chip_smoke.py's bar for a mesh against one process
CPU_RANKS = 4


def run_epoch(argv: list) -> dict:
    """``dp_epoch.main(argv)`` in this process -> its JSON line."""
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        dp_epoch.main(argv)
    return json.loads(text.getvalue().strip().splitlines()[-1])


def _rank(k: int, argv: list, result_dir: str) -> None:
    """One rank of a cluster: its JSON line into ``result_dir``."""
    result = run_epoch(argv + ["--process-id", str(k)])
    with open(os.path.join(result_dir, f"rank{k}.json"), "w") as f:
        json.dump(result, f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.overlap_cards",
                                description=__doc__.splitlines()[0])
    p.add_argument("--out-dir", default="build/overlap_cards")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = p.parse_args(argv)
    on_card = args.device == "cuda"
    n_ranks = torch.cuda.device_count() if on_card else CPU_RANKS
    if n_ranks < 2:
        raise SystemExit(f"NCCL ranks one per card need 2 cards or more, "
                         f"have {n_ranks}")
    os.makedirs(args.out_dir, exist_ok=True)
    tfx = write_train_fixtures(args.out_dir, SEED)
    init = os.path.join(args.out_dir, "init.wts")
    subprocess.run([sys.executable, "-m", "tpu_se_torch", "gen-rand-net",
                    "-o", init, "--seed", str(SEED)], check=True)
    base = ["--fea-file", tfx["noisy"], "--targ-file", tfx["clean"],
            "--norm-file", tfx["norm"], "--init-wts", init,
            "--train-sents", tfx["train_sents"],
            "--traincache", str(tfx["traincache"]), "--lrate", LRATE,
            "--device", args.device]
    one = os.path.join(args.out_dir, "one.wts")
    print(json.dumps(run_epoch(base + ["--out", one])))
    w0, w_one = read_wts(init), read_wts(one)
    written = {}
    for i, step in enumerate(("flat", "overlap", "overlap", "flat")):
        out = os.path.join(args.out_dir, f"{step}.{i}.wts")
        result_dir = os.path.join(args.out_dir, f"{step}.{i}")
        os.makedirs(result_dir, exist_ok=True)
        t0 = time.perf_counter()
        launch_local_ranks(_rank, n_ranks, (base + [
            "--coordinator", f"127.0.0.1:{free_port()}", "--num-processes",
            str(n_ranks), "--out", out, "--profile",
            *(["--overlap"] if step == "overlap" else [])], result_dir))
        results = []
        for k in range(n_ranks):
            with open(os.path.join(result_dir, f"rank{k}.json")) as f:
                results.append(json.load(f))
        worst = dp_epoch.worst_change(w0, w_one, read_wts(out))
        print(json.dumps(results[0]))
        print(f"{step} run {i}: {n_ranks} {results[0]['backend']} ranks, "
              f"{results[0]['ms_per_bunch']:.3f} ms per bunch (rank 0; "
              f"ranks {[round(r['ms_per_bunch'], 3) for r in results]}), "
              f"weight changes within {worst:.3e} of one process, "
              f"{time.perf_counter() - t0:.1f} s")
        if worst > DW_RTOL:
            raise SystemExit(f"{step} run {i}: {worst:.3e} from one process")
        with open(out, "rb") as f:
            written.setdefault(step, []).append(f.read())
    for step, runs in written.items():
        print(f"{step}: both runs byte-identical = {runs[0] == runs[1]}")
    if on_card:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
