"""Streaming latency and multi-channel throughput on one card.

    python -m tpu_se_torch.bench.stream [--streams 1 8 128] [--hops 1000]
        [--model M.wts --norm M.norm] [--out PATH] [--device cuda|cpu]

The port of ``tools/bench_stream.py``, with its workload: a full-width
model ``init_params(1)`` and a ``.norm`` from ``np.random.default_rng(0)``
(or ``--model``/``--norm``), per stream count S one ``StreamingEnhancer``
and hops of noise x 1000 from ``default_rng(1)``.  Per S:

- ``push`` of one [S, 256] hop, as a caller sees it (host clock, the copies
  both ways included), over ``--hops`` calls after ``warmup_hops + 4``:
  p50 and p99 in ms and hops/s (stream hops: S per call).  ``--hops``
  defaults to 1000, not the reference's 200, so that ten samples lie
  beyond p99;
- device-only, on a card: the replayed step's time per hop from CUDA events
  around runs of ``K1`` and ``K2`` graph replays, differenced (the
  counterpart of the reference's two-point ``lax.scan`` method), once per
  ``--hops`` pairs: p50 and p99, and the transport overhead (push p50 -
  device p50);
- ``push_many`` of [S, K, 256] chunks, K = ``SCAN_HOPS`` = 8, on the float
  and the int16 wire: hops/s and channels of real time.

Checks: every output finite, every chunk after the warm-up valid.  The last
line of the output is the record.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
import time

import numpy as np

from tpu_se_torch.bench.decode import workload
from tpu_se_torch.bench.fixtures import time_ms
from tpu_se_torch.bench.timing import (
    Reading, bench_device, device_record, emit, layer_sizes, on_card,
)
from tpu_se_torch.infer import StreamingEnhancer, streaming
from tpu_se_torch.models import DEFAULT_LAYERSIZES
from tpu_se_torch.ops import lps_kernel

K1, K2 = 2, 10          # graph replays per timed run, differenced
SHIFT = 256
SAMPLE_RATE = 16000.0


def one_count(wts: str, norm: str, s: int, hops: int, device) -> tuple:
    """-> (the record's entry for S = ``s``, its checks)."""
    hop_ms = SHIFT / SAMPLE_RATE * 1e3
    enh = StreamingEnhancer(wts, norm, n_streams=s, device=device)
    rng = np.random.default_rng(1)
    hop = (rng.normal(size=(s, SHIFT)) * 1000).astype(np.float32)
    for _ in range(enh.warmup_hops + 4):
        enh.push(hop)
    lat, finite = [], True
    t_all0 = time.perf_counter()
    for _ in range(hops):
        t0 = time.perf_counter()
        out = enh.push(hop)
        lat.append((time.perf_counter() - t0) * 1e3)
        finite &= bool(np.isfinite(out).all())
    t_all = time.perf_counter() - t_all0
    lat = Reading(lat)
    dev = None
    if device.type == "cuda":
        dev = Reading([(time_ms(enh._run_step, K2, 0) * K2
                        - time_ms(enh._run_step, K1, 0) * K1) / (K2 - K1)
                       for _ in range(hops)])
    hops_per_sec = hops * s / t_all
    entry = {"n_streams": s, "hop_p50_ms": lat.median,
             "hop_p99_ms": lat.percentile(99), "hop_ms": lat.record(),
             "device_only_p50_ms": dev and dev.median,
             "device_only_p99_ms": dev and dev.percentile(99),
             "device_only_ms": dev and dev.record(),
             "transport_overhead_p50_ms": dev and lat.median - dev.median,
             "hops_per_sec": hops_per_sec,
             "x_realtime_channels": hops_per_sec * hop_ms / 1e3}
    k = enh.SCAN_HOPS
    chunk = (rng.normal(size=(s, k, SHIFT)) * 1000).astype(np.float32)
    n_disp = max(1, hops // k)
    valid_all = True
    for key, wire in (("chunked", chunk), ("chunked_i16",
                                           chunk.astype(np.int16))):
        i16 = wire.dtype == np.int16
        enh.push_many(wire, int16_wire=i16)                  # warm-up
        per = []
        for _ in range(n_disp):
            t0 = time.perf_counter()
            outs, valid = enh.push_many(wire, int16_wire=i16)
            per.append((time.perf_counter() - t0) * 1e3)
            finite &= bool(np.isfinite(outs).all())
            valid_all &= bool(valid.all())
        rate = n_disp * k * s / (sum(per) / 1e3)
        entry[f"{key}_hops_per_sec"] = rate
        entry[f"{key}_x_realtime_channels"] = rate * hop_ms / 1e3
        entry[f"{key}_ms"] = Reading(per).record()
    entry["chunked_k"] = k
    entry["chunked_added_latency_ms"] = k * hop_ms
    entry["algorithmic_latency_ms"] = enh.latency_samples / SAMPLE_RATE * 1e3
    return entry, {f"outputs_finite_s{s}": finite,
                   f"chunks_valid_s{s}": valid_all}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="tpu_se_torch.bench.stream",
                                description=__doc__.splitlines()[0])
    p.add_argument("--streams", type=int, nargs="*", default=[1, 8, 128])
    p.add_argument("--model")
    p.add_argument("--norm")
    p.add_argument("--hops", type=int, default=1000)
    p.add_argument("--layersizes", type=layer_sizes,
                   default=DEFAULT_LAYERSIZES,
                   help="comma-separated (default the full width)")
    p.add_argument("--out", default=None, help="write the record here")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    device = bench_device(args.device, p.prog)
    layersizes = args.layersizes
    launches0 = lps_kernel.launches
    replays0 = streaming.hops_replayed
    entries, checks = [], {}
    with tempfile.TemporaryDirectory() as root:
        wts, norm = ((args.model, args.norm) if args.model
                     else workload(root, layersizes, utts=0)[:2])
        for s in args.streams:
            entry, ok = one_count(wts, norm, s, args.hops, device)
            entries.append(entry)
            checks.update(ok)
            print(f"# S={s}: push p50 {entry['hop_p50_ms']:.3f} ms, device "
                  f"{entry['device_only_p50_ms']} ms, chunked int16 "
                  f"{entry['chunked_i16_hops_per_sec']:.0f} hops/s",
                  file=sys.stderr)
    best = max(entries, key=lambda e: e["chunked_i16_x_realtime_channels"])
    replays = streaming.hops_replayed - replays0
    return emit({
        "metric": "stream_realtime_channels",
        "value": best["chunked_i16_x_realtime_channels"],
        "unit": "channels", "n_streams": best["n_streams"],
        "p99_hop_ms_s1": entries[0]["hop_p99_ms"],
        "device_only_p50_ms_s1": entries[0]["device_only_p50_ms"],
        "hop_samples": SHIFT, "hop_budget_ms": SHIFT / SAMPLE_RATE * 1e3,
        "hops": args.hops, "layersizes": list(layersizes),
        "streams": entries,
        "algorithmic_latency_ms": entries[-1]["algorithmic_latency_ms"],
        "graph_replays": on_card(device, replays),
        "lps_launches": on_card(
            device, lps_kernel.launches - launches0 + replays),
        "device": device_record(device), "checks": checks}, args.out)


if __name__ == "__main__":
    sys.exit(main())
