"""Data-parallel weak scaling over the local cards.

    python -m tpu_se_torch.bench.scaling [--meshes 1,2,4,8]
        [--batch-per-device 1024,128] [--bunches 8] [--hidden 0]
        [--reps 5] [--json] [--out PATH] [--device cuda|cpu] [--cpu]

The port of ``tools/bench_scaling.py``, with its workload: 65,536 frames
of noise (noisy and clean) from ``np.random.default_rng(0)``, window
starts drawn from the same generator mesh size after mesh size, weights
``init_params(1)`` at (1799, hidden x 3, 257), ML-GGD beta=1,
``grad_scale="natural"``, lrate 0.01, ``--bunches`` bunches per chunk of
``batch_per_device`` x ranks rows (weak scaling).  A data axis of n ranks,
one rank included, is n new processes, one NCCL rank per local card,
started by ``parallel/mesh.py:launch_local_ranks`` (gloo ranks with
``--device cpu``); each runs ``train_chunk`` under ``make_mesh(n, 1)``,
one warm-up chunk and then ``REPEATS`` timings of ``--reps`` chunks ending
in a synchronise and a barrier.  Frames/s is the global bunch's rows over
that time on rank 0; the efficiency column is frames/s over n times the
one-rank mesh's, every mesh size measured in processes of the same kind.
``--batch-per-device`` takes a list: 1024 (the reference's default) and
128 (the parity bunch at one rank).  ``--hidden 0`` is 2048 on a card and
256 on the CPU, as the reference's; ``--cpu`` is ``--device cpu``.

Besides, at one rank and in this process, ``mesh=None`` (the fused GGD
kernel, no collective) and the one-rank mesh (the split kernels and two
all-reduces per bunch) run in turns: plain, mesh, mesh, plain, the two
mesh turns on one process group.  ms per bunch of each form and their
difference are in the record, and each turn then profiles
``PROFILE_BUNCHES`` bunches: host wall ms and the host ops of most self
time per bunch and, on a card, the device's busy us and launches per
bunch.  These turns compare the two forms in one process; the
efficiency column does not read them.
Checks: every rank of a mesh ends with the same weights, and the one-rank
meshes (spawned and in turns) with the plain step's, bit for bit.  The
last line of the output is the record (printed with or without
``--json``, which is kept for the reference's command line).
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
import tempfile

import numpy as np
import torch

from tpu_se_torch.bench.profile_decode import device_profile
from tpu_se_torch.bench.timing import (
    REPEATS, Reading, bench_device, device_record, emit, host_ops, on_card,
    wall_s,
)
from tpu_se_torch.models import init_params
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.parallel import (
    gather_params, initialize_distributed, launch_local_ranks, make_mesh,
    shard_train_args, shutdown_distributed, sync_processes,
)
from tpu_se_torch.parallel.mesh import free_port
from tpu_se_torch.train import TrainHyper, make_train_state, train_chunk
from tpu_se_torch.train.checkpoint import model_from_layers
from tpu_se_torch.utils import resolve_device

FEA_DIM, CONTEXT, TARG_OFFSET = 257, 7, 3
N_FRAMES = 65536
LRATE = 0.01
PROFILE_BUNCHES = 50    # bunches per profiled window of a one-rank turn
# The GGD kernels' counters in ops/ggd_kernel.py -> the record's keys.
COUNTERS = {"launches": "ggd_output_grad_launches",
            "colsum_launches": "ggd_colsum_launches",
            "grad_from_sums_launches": "ggd_grad_from_sums_launches"}


def problem(meshes: list, n: int, batch_per_device: int, bunches: int):
    """(noisy, clean, starts [bunches, batch_per_device * n]) as the
    reference draws them: the frames, then one set of starts per mesh
    size in ``meshes`` order, up to ``n``."""
    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((N_FRAMES, FEA_DIM), dtype=np.float32)
    clean = rng.standard_normal((N_FRAMES, FEA_DIM), dtype=np.float32)
    for m in meshes:
        starts = rng.integers(0, N_FRAMES - CONTEXT,
                              size=(bunches, batch_per_device * m)
                              ).astype(np.int32)
        if m == n:
            return noisy, clean, starts
    raise ValueError(f"mesh size {n} is not in {meshes}")


def run_turn(cfg: dict, n: int, mesh, device: torch.device,
             profiled: bool = False) -> dict:
    """One rank's warm-up and timed chunks -> its frames/s, the digest of
    its weights after them and its GGD kernel launches; ``profiled``: then
    ``PROFILE_BUNCHES`` one-bunch steps under the profiler, the host's
    ops (``host_ops``) and, on a card, the device's busy time and
    launches per bunch."""
    noisy, clean, starts = problem(cfg["meshes"], n, cfg["batch"],
                                   cfg["bunches"])
    bunch = starts.shape[1]
    layersizes = (FEA_DIM * CONTEXT, *[cfg["hidden"]] * 3, FEA_DIM)
    state = make_train_state(model_from_layers(init_params(1, layersizes),
                                               device, mesh=mesh))
    if mesh is not None:
        _, _, starts = shard_train_args(mesh, None, None, starts)
    noisy_d, clean_d = (torch.from_numpy(a).to(device)
                        for a in (noisy, clean))
    starts_d = torch.from_numpy(starts.astype(np.int64)).to(device)
    hyper = TrainHyper(beta=1.0, ml=True, bunchsize=bunch, context=CONTEXT,
                       targ_offset=TARG_OFFSET, grad_scale="natural")

    def chunks(k: int) -> None:
        for _ in range(k):
            train_chunk(state, noisy_d, clean_d, starts_d, LRATE, hyper,
                        mesh=mesh)
        sync_processes("scaling")

    before = [getattr(ggd_kernel, c) for c in COUNTERS]
    wall_s(lambda: chunks(1), device)
    fps = [cfg["reps"] * cfg["bunches"] * bunch
           / wall_s(lambda: chunks(cfg["reps"]), device)
           for _ in range(REPEATS)]
    digest = hashlib.sha256()
    for layer in gather_params(state.model, mesh):
        digest.update(layer["w"].tobytes())
        digest.update(layer["b"].tobytes())
    profile = None
    if profiled:
        def one_bunch():
            train_chunk(state, noisy_d, clean_d, starts_d[:1], LRATE, hyper,
                        mesh=mesh)

        profile = host_ops(one_bunch, PROFILE_BUNCHES, device)
        if device.type == "cuda":
            busy, launches, _ = device_profile(one_bunch, PROFILE_BUNCHES)
            profile.update(device_busy_us=busy, launches=launches)
    return {"frames_per_sec": fps, "ms_per_bunch": [
                bunch / f * 1e3 for f in fps],
            "weights_sha256": digest.hexdigest(),
            "finite": all(bool(torch.isfinite(p).all())
                          for p in state.model.parameters()),
            "backend": None if mesh is None else mesh.backend,
            "profile": profile,
            **{c: getattr(ggd_kernel, c) - b
               for c, b in zip(COUNTERS, before)}}


def _rank(k: int, cfg: dict, n: int, port: int, result_dir: str) -> None:
    """Rank ``k`` of an n-rank mesh: its turn's result into
    ``result_dir``."""
    info = initialize_distributed(f"127.0.0.1:{port}", n, k,
                                  None, cfg["device"])
    try:
        mesh = make_mesh(n, 1, info["device"])
        result = run_turn(cfg, n, mesh, mesh.device)
    finally:
        shutdown_distributed()
    with open(os.path.join(result_dir, f"rank{k}.json"), "w") as f:
        json.dump(result, f)


def one_rank_turns(cfg: dict, device: torch.device) -> list:
    """plain, mesh, mesh, plain at one rank, in this process, the two mesh
    turns on one process group, each turn profiled after its timings."""
    def plain() -> dict:
        return {"turn": "plain", **run_turn(cfg, 1, None, device, True)}

    out = [plain()]
    info = initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, None,
                                  str(device))
    try:
        mesh = make_mesh(1, 1, info["device"])
        out += [{"turn": "mesh", **run_turn(cfg, 1, mesh, info["device"],
                                            True)} for _ in range(2)]
    finally:
        shutdown_distributed()
    return out + [plain()]


def mesh_turn(cfg: dict, n: int) -> list:
    """One n-rank mesh, its ranks spawned -> their results."""
    with tempfile.TemporaryDirectory() as result_dir:
        launch_local_ranks(_rank, n, (cfg, n, free_port(), result_dir))
        results = []
        for k in range(n):
            with open(os.path.join(result_dir, f"rank{k}.json")) as f:
                results.append(json.load(f))
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.scaling",
                                description=__doc__.splitlines()[0])
    p.add_argument("--meshes", default="1,2,4,8",
                   help="comma-separated data-axis sizes")
    p.add_argument("--batch-per-device", default="1024,128",
                   help="comma-separated rows per rank; the first heads "
                        "the record")
    p.add_argument("--bunches", type=int, default=8)
    p.add_argument("--hidden", type=int, default=0,
                   help="hidden width (0 = 2048 on a card, 256 on the CPU)")
    p.add_argument("--reps", type=int, default=5,
                   help="chunks per timing")
    p.add_argument("--cpu", action="store_true", help="--device cpu")
    p.add_argument("--json", action="store_true",
                   help="the record is always printed; kept for the "
                        "reference's command line")
    p.add_argument("--out", default=None, help="write the record here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = bench_device("cpu" if args.cpu else args.device, p.prog)
    meshes = [int(s) for s in args.meshes.split(",")]
    if meshes[0] != 1:
        raise SystemExit("--meshes starts at 1: the efficiency is against "
                         "the one-rank mesh")
    on_gpu = device.type == "cuda"
    have = torch.cuda.device_count() if on_gpu else max(meshes)
    cfg = {"meshes": meshes, "bunches": args.bunches,
           "hidden": args.hidden or (2048 if on_gpu else 256),
           "reps": args.reps, "device": "cuda" if on_gpu else "cpu"}
    counts = dict.fromkeys(COUNTERS, 0)
    batches, checks = {}, {}
    for bpd in (int(s) for s in args.batch_per_device.split(",")):
        cfg["batch"] = bpd
        turns = one_rank_turns(cfg, resolve_device(cfg["device"]))
        per_n = {}
        for n in meshes:
            if n > have:
                print(f"# skip data={n}: only {have} devices",
                      file=sys.stderr)
                continue
            per_n[n] = mesh_turn(cfg, n)
        checks[f"one_rank_mesh_equals_plain_{bpd}"] = len(
            {r["weights_sha256"] for r in turns + per_n[1]}) == 1
        entry = {"meshes": {}}
        for r in turns + [r for ranks in per_n.values() for r in ranks]:
            for c in COUNTERS:
                counts[c] += r[c]
        for n, ranks in per_n.items():
            checks[f"replicas_equal_{bpd}_data{n}"] = len(
                {r["weights_sha256"] for r in ranks}) == 1
            checks[f"finite_{bpd}_data{n}"] = all(r["finite"] for r in ranks)
            fps = Reading(ranks[0]["frames_per_sec"])
            entry["meshes"][str(n)] = {
                "ranks": n, "backend": ranks[0]["backend"],
                "global_bunch": bpd * n, "frames_per_sec": fps.record(),
                "ms_per_bunch": bpd * n / fps.median * 1e3}
        one = entry["meshes"]["1"]["frames_per_sec"]["median"]
        for n, e in entry["meshes"].items():
            e["efficiency"] = e["frames_per_sec"]["median"] / (one * int(n))
        plain = Reading([v for t in turns if t["turn"] == "plain"
                         for v in t["ms_per_bunch"]])
        mesh1 = Reading([v for t in turns if t["turn"] == "mesh"
                         for v in t["ms_per_bunch"]])
        entry["one_rank"] = {
            "turns": [t["turn"] for t in turns],
            "plain_ms_per_bunch": plain.record(),
            "mesh_ms_per_bunch": mesh1.record(),
            "mesh_minus_plain_ms": mesh1.median - plain.median,
            "profiles": [{"turn": t["turn"], **t["profile"]}
                         for t in turns]}
        batches[str(bpd)] = entry
        print(f"# batch/rank {bpd}: " + ", ".join(
            f"data={n} {e['frames_per_sec']['median'] / 1e3:.1f} kframes/s "
            f"eff {e['efficiency']:.3f}" for n, e in entry["meshes"].items())
            + f"; one rank plain {plain.median:.3f} ms, mesh "
              f"{mesh1.median:.3f} ms per bunch", file=sys.stderr)
    head = next(iter(batches.values()))["meshes"]
    largest = max(head, key=int)
    eff = head[largest]["efficiency"] if int(largest) > 1 else None
    return emit({
        "metric": "dp_weak_scaling_efficiency", "value": eff,
        "unit": f"fraction (1->{largest} devices)", "vs_baseline": eff,
        "detail": {"platform": "gpu" if on_gpu else "cpu",
                   "hidden": cfg["hidden"],
                   "batch_per_device": int(next(iter(batches))),
                   "frames_per_s": {n: e["frames_per_sec"]["median"]
                                    for n, e in head.items()}},
        "bunches": args.bunches, "reps": args.reps,
        "batches": batches,
        **{COUNTERS[c]: on_card(device, v) for c, v in counts.items()},
        "device": device_record(device), "checks": checks}, args.out)


if __name__ == "__main__":
    sys.exit(main())
