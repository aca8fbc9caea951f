"""Where the device time of the batched decode goes, on one CUDA card.

    python -m tpu_se_torch.bench.profile_decode [--repeats 5] [--iters 20]

On ``chip_smoke.py``'s fixtures (full-width random model, four 16 kHz
utterances of 1-4 s), for the device-only int16 decode
(``Enhancer.decode_waves_tensor``, inputs already on the card) at batch 4
(the four utterances) and batch 16 (them four times), prints:

- ms per batch by CUDA events over ``--iters`` back-to-back calls, once per
  repeat, with no profiler attached (the method ``chip_smoke.py`` uses);
- host wall ms per batch over the same number of calls, synchronised once;
- device busy us per batch (kernel and memcpy self time from
  ``torch.profiler`` over ``--iters`` calls), device launches per batch,
  and the idle share ``1 - busy / median event time``;
- the device kernels by self time.

Then the LPS kernel against its float64 plain version and a float32
cuBLAS product (time by CUDA events over back-to-back calls, device time
by CUDA-graph replay, max error, the kernel's fp64 TFLOP/s), and the FFN
alone at the decode's row counts.  Exits non-zero without a CUDA card.
"""

from __future__ import annotations

import argparse
import statistics
import sys
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from tpu_se_torch.bench.fixtures import (
    card_line, device_us, pad_batch, time_ms, write_fixtures,
)
from tpu_se_torch.dsp.analysis import dft_basis
from tpu_se_torch.infer import Enhancer
from tpu_se_torch.ops import lps_kernel


def device_profile(fn, iters: int) -> tuple[float, float, list]:
    """(busy us per call, device launches per call, [(name, us per call)])
    of ``fn`` from ``torch.profiler``: the self device time of every
    non-``aten::`` entry (kernels and copies; an ``aten::`` op would count
    its kernels a second time)."""
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    rows = [(e.key, e.self_device_time_total / iters, e.count / iters)
            for e in prof.key_averages()
            if e.self_device_time_total > 0 and not e.key.startswith("aten::")]
    rows.sort(key=lambda r: -r[1])
    return (sum(r[1] for r in rows), sum(r[2] for r in rows),
            [(name, us) for name, us, _ in rows])


def profile_batches(enh: Enhancer, waves: list, repeats: int,
                    iters: int) -> None:
    for label, batch_waves in (("batch4", waves), ("batch16", waves * 4)):
        x, n_valid, frames = pad_batch(batch_waves, enh.device)

        def step():
            return enh.decode_waves_tensor(x, n_valid)

        event_ms = [time_ms(step, iters=iters) for _ in range(repeats)]
        for rep, ms in enumerate(event_ms):
            print(f"{label} rep{rep}: {ms:.4f} ms/batch, {frames} frames, "
                  f"{frames / ms * 1e3:.0f} frames/s (CUDA events)")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / iters * 1e3
        busy, launches, kernels = device_profile(step, iters)
        median = statistics.median(event_ms)
        print(f"{label} host wall {wall:.4f} ms/batch; device busy "
              f"{busy:.1f} us/batch over {launches:.0f} device launches; "
              f"idle share vs median event time {median:.4f} ms = "
              f"{1 - busy / (median * 1e3):.3f}")
        for name, us in kernels[:12]:
            print(f"  {name[:72]:72s} {us:8.1f} us/batch "
                  f"{us / busy:6.3f}")


def profile_lps(dev) -> None:
    basis = dft_basis(512, dev)
    rng = np.random.default_rng(0)

    def fp32_blas(x):
        s = x @ basis
        return lps_kernel.floored_log(s[:, :257] ** 2 + s[:, 257:] ** 2)

    for t in (248, 992, 4096, 16384):
        x = torch.from_numpy(
            (rng.standard_normal((t, 512)) * 1000).astype(np.float32)).to(dev)
        fns = {"cuda": lambda: lps_kernel.lps_cuda(x, basis),
               "plain64": lambda: lps_kernel.lps_plain(x, basis),
               "fp32blas": lambda: fp32_blas(x)}
        us = {name: [] for name in fns}
        for name in ("plain64", "cuda", "fp32blas",
                     "fp32blas", "cuda", "plain64"):
            us[name].append(time_ms(fns[name]) * 1e3)
        dev_us = {name: device_us(fns[name]) for name in ("cuda", "plain64")}
        ref = fns["plain64"]()
        err = {name: (fns[name]() - ref).abs().max().item()
               for name in ("cuda", "fp32blas")}
        tflops = 2 * t * 512 * 514 / (dev_us["cuda"] * 1e-6) / 1e12
        print(f"lps T={t}: events " + ", ".join(
            f"{k} {v[0]:.1f}/{v[1]:.1f} us" for k, v in us.items())
            + f"; device cuda {dev_us['cuda']:.2f} us, plain64 "
              f"{dev_us['plain64']:.2f} us; max err vs plain64: cuda "
              f"{err['cuda']:.2e}, fp32blas {err['fp32blas']:.2e}; cuda "
              f"{tflops:.2f} TFLOP/s fp64 (device time)")


def profile_ffn(enh: Enhancer) -> None:
    sizes = [w.shape for w in enh.model.weights]
    flop_per_row = 2 * sum(n_in * n_out for n_in, n_out in sizes)
    for m in (992, 3968):
        x = torch.randn(m, sizes[0][0], device=enh.device)
        with torch.inference_mode():
            ms = time_ms(lambda: enh.model(x), iters=20)
        print(f"ffn M={m}: {ms * 1e3:.1f} us, "
              f"{m * flop_per_row / (ms * 1e-3) / 1e12:.2f} TFLOP/s fp32")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--repeats", type=int, default=5)
    parser.add_argument("--iters", type=int, default=20)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_decode: needs a CUDA card", file=sys.stderr)
        return 1
    print(f"card {card_line()}")
    dev = torch.device("cuda")
    with tempfile.TemporaryDirectory() as root:
        fx = write_fixtures(root)
        enh = Enhancer(fx["wts"], fx["norm"], device=dev)
        profile_batches(enh, fx["waves"], args.repeats, args.iters)
        profile_lps(dev)
        profile_ffn(enh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
