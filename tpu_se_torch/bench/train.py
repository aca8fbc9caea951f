"""Training throughput of the flagship configuration on one card.

    python -m tpu_se_torch.bench.train [--bf16] [--bunch 128]
        [--act-dtype bfloat16] [--step flat|overlap] [--reps 20]
        [--bunches N] [--out PATH] [--device cuda|cpu]

The port of ``bench.py``, with its workload: ``DEFAULT_LAYERSIZES``
(1799 -> 2048x3 -> 257), ML-GGD beta=1, ``grad_scale="parity"``, lrate 0.1,
102,400 + 4,096 resident frames of noise (noisy and clean, 109.5 MB each
in float32) and 102,400 / M bunches of window starts, all from
``np.random.default_rng(0)``, weights ``init_params(1)``.  One warm-up
chunk, then ``REPEATS`` timings of ``--reps`` chunks issued back to back
and synchronised once: frames/s as the median of the repeats, with the
quartiles and every value.  ``--step flat`` is ``train_chunk``,
``--step overlap`` ``parallel/overlap_step.py:train_chunk_overlap`` at
``mesh=None`` (the reference's ``gspmd`` and ``overlap``).  On a card a
separate window of ``PROFILE_BUNCHES`` bunches under ``torch.profiler``
gives the device's busy microseconds and launches per bunch, and the idle
share against the timed bunches; another (the host's side only, on the
CPU too) the host ops of most self time per bunch.

``mfu`` replaces the reference's ``sol_frac``/``vs_baseline``: achieved
product FLOP/s (6 FLOPs per weight per frame: forward, input gradient and
weight gradient, 75,595,776 per frame at full width) over the H100's peak
for the type the products run in (``timing.PEAK_FLOPS``).  The last line of
the output is the record, one JSON object.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_se_torch.bench.profile_decode import device_profile
from tpu_se_torch.bench.timing import (
    PEAK_FLOPS, REPEATS, Reading, bench_device, device_record, emit,
    host_ops, layer_sizes, on_card, wall_s,
)
from tpu_se_torch.models import DEFAULT_LAYERSIZES, init_params
from tpu_se_torch.models.ffn import params_from_numpy
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.parallel.overlap_step import train_chunk_overlap
from tpu_se_torch.train import TrainHyper, make_train_state, train_chunk

FEA_DIM, CONTEXT, TARG_OFFSET = 257, 7, 3
CHUNK_FRAMES = 102400            # one traincache chunk
PAD_FRAMES = 4096                # the reference's pad bucket beyond it
LRATE = 0.1
PROFILE_BUNCHES = 50


def flops_per_frame(layersizes) -> int:
    """Product FLOPs per trained frame: forward, input gradient and weight
    gradient, two FLOPs per weight each."""
    return 6 * sum(a * b for a, b in zip(layersizes[:-1], layersizes[1:]))


def workload(layersizes=DEFAULT_LAYERSIZES, bunch: int = 128,
             n_bunches: int | None = None):
    """``bench.py``'s inputs as numpy: (noisy, clean, starts [n_bunches,
    bunch] int32, initial layers)."""
    n_frames = CHUNK_FRAMES + PAD_FRAMES
    n_bunches = n_bunches or CHUNK_FRAMES // bunch
    rng = np.random.default_rng(0)
    noisy = rng.standard_normal((n_frames, FEA_DIM), dtype=np.float32)
    clean = rng.standard_normal((n_frames, FEA_DIM), dtype=np.float32)
    starts = rng.integers(0, n_frames - CONTEXT,
                          size=(n_bunches, bunch)).astype(np.int32)
    return noisy, clean, starts, init_params(1, layersizes)


def hyper_for(bunch: int, compute_dtype="float32", act_dtype=None
              ) -> TrainHyper:
    return TrainHyper(beta=1.0, ml=True, bunchsize=bunch, context=CONTEXT,
                      targ_offset=TARG_OFFSET, grad_scale="parity",
                      compute_dtype=compute_dtype, act_dtype=act_dtype)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.train",
                                description=__doc__.splitlines()[0])
    p.add_argument("--bf16", action="store_true",
                   help="bfloat16 products (float32 sums)")
    p.add_argument("--bunch", type=int, default=128)
    p.add_argument("--act-dtype", default=None, choices=[None, "bfloat16"],
                   help="bfloat16 hidden activations")
    p.add_argument("--frames-dtype", default="float32",
                   choices=["float32", "bfloat16"])
    p.add_argument("--step", default="flat", choices=["flat", "overlap"])
    p.add_argument("--reps", type=int, default=20,
                   help="chunks per timing, issued back to back")
    p.add_argument("--bunches", type=int, default=None,
                   help="bunches per chunk (default 102400 / bunch)")
    p.add_argument("--layersizes", type=layer_sizes,
                   default=DEFAULT_LAYERSIZES,
                   help="comma-separated (default the full width)")
    p.add_argument("--out", default=None,
                   help="also write the record to this file")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if args.frames_dtype != "float32":
        raise SystemExit("--frames-dtype bfloat16: the port trains from "
                         "float32 frames (the GGD kernel takes float32 "
                         "targets); not ported")
    if args.step == "overlap" and args.act_dtype:
        raise SystemExit("--step overlap does not support --act-dtype (the "
                         "hand-written backward keeps float32 activations)")
    device = bench_device(args.device, p.prog)
    layersizes = args.layersizes
    hyper = hyper_for(args.bunch, "bfloat16" if args.bf16 else "float32",
                      args.act_dtype)
    noisy, clean, starts, layers = workload(layersizes, args.bunch,
                                            args.bunches)
    n_bunches = starts.shape[0]
    state = make_train_state(params_from_numpy(layers, device))
    noisy_d = torch.from_numpy(noisy).to(device)
    clean_d = torch.from_numpy(clean).to(device)
    starts_d = torch.from_numpy(starts.astype(np.int64)).to(device)

    def chunk(s=starts_d):
        if args.step == "overlap":
            train_chunk_overlap(state, noisy_d, clean_d, s, LRATE, hyper)
        else:
            train_chunk(state, noisy_d, clean_d, s, LRATE, hyper)

    launches0 = ggd_kernel.launches
    wall_s(chunk, device)                                    # warm-up
    fps = Reading([args.reps * n_bunches * args.bunch / wall_s(
        lambda: [chunk() for _ in range(args.reps)], device)
        for _ in range(REPEATS)])
    ms_per_bunch = args.bunch / fps.median * 1e3
    busy_us = launches = idle = None
    if device.type == "cuda":
        busy_us, launches, _ = device_profile(
            lambda: chunk(starts_d[:1]), PROFILE_BUNCHES)
        idle = 1.0 - busy_us / (ms_per_bunch * 1e3)
    host = host_ops(lambda: chunk(starts_d[:1]), PROFILE_BUNCHES, device)
    fpf = flops_per_frame(layersizes)
    peak = PEAK_FLOPS[hyper.compute_dtype]
    record = {
        "metric": "train_frames_per_sec_per_chip", "value": fps.median,
        "unit": "frames/s", "step": args.step,
        "mfu": on_card(device, fps.median * fpf / peak),
        "peak_tflops": on_card(device, peak / 1e12),
        "frames_per_sec": fps.record(), "ms_per_bunch": ms_per_bunch,
        "bunch": args.bunch, "bunches": n_bunches, "reps": args.reps,
        "dtype": str(hyper.compute_dtype).removeprefix("torch."),
        "act_dtype": args.act_dtype, "frames_dtype": args.frames_dtype,
        "layersizes": list(layersizes), "flops_per_frame": fpf,
        "profiled_bunches": PROFILE_BUNCHES,
        "device_busy_us_per_bunch": busy_us, "idle_share": idle,
        "launches_per_bunch": launches,
        "profiled_wall_ms_per_bunch": host["wall_ms"],
        "host_self_us_per_bunch": host["host_self_us"],
        "ggd_output_grad_launches": on_card(
            device, ggd_kernel.launches - launches0),
        "device": device_record(device),
        "checks": {"weights_finite": all(
            bool(torch.isfinite(t).all()) for t in state.model.parameters())
            and bool(torch.isfinite(state.alpha).all())}}
    print(f"# {record['dtype']} M={args.bunch} {args.step}: "
          f"{ms_per_bunch:.4f} ms per bunch, mfu {record['mfu']}, "
          f"idle {idle}", file=sys.stderr)
    return emit(record, args.out)


if __name__ == "__main__":
    sys.exit(main())
