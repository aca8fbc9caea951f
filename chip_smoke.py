#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_se_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout; it imports
nothing of JAX.  In order, and failing (non-zero exit) at the first fault:

1. reports torch/CUDA versions and the card's name and power limit;
2. requires ``torch.cuda.is_available()``;
3. builds the CUDA kernels from ``tpu_se_torch/csrc`` (timed);
4. kernel phase: ``lps_cuda`` against ``lps_plain`` on the card, for
   T in {1, 37, 256, 4097} and the decode's own shapes, L in {512, 256},
   seeded frames x1000 with zeroed rows (which must give exactly -50);
   atol 1e-5 in the log domain; times both at T = 256, 4096 and the
   batched decode's shape;
5. slice phase: writes a full-width (1799, 2048, 2048, 2048, 257) random
   model, four 16 kHz noisy/clean wav pairs and their ``.norm``, then runs
   ``python -m tpu_se_torch decode`` in-process on the card (plain,
   ``--batch 4``, ``--blend auto --smooth-strength auto``, all with
   ``--clean-scp``, and ``--batch 4`` without it: the int16 fast path),
   counting kernel launches; checks lengths, finite SegSNR/LSD, and waves
   within 1 int16 LSB of the same decode with ``--device cpu``; times the
   device-only batched decode;
6. prints the kernel table as JSON, the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from tpu_se_torch.bench.fixtures import (  # noqa: E402
    SEED, SHIFT, card_line, pad_batch, time_ms, write_fixtures,
)
from tpu_se_torch.cli.main import main as cli_main  # noqa: E402
from tpu_se_torch.dsp.analysis import dft_basis  # noqa: E402
from tpu_se_torch.infer import Enhancer  # noqa: E402
from tpu_se_torch.io import read_wav  # noqa: E402
from tpu_se_torch.ops import lps_kernel  # noqa: E402
from tpu_se_torch.ops._build import load_library  # noqa: E402

# Kernel against plain, log domain.  Both sum in float64 and round only
# re/im to float32, so they agree to a few float32 ulps of the log power
# (1 ulp = 1.9e-6 for |log power| in [16, 32)); a float32 sum in the
# kernel would miss by ~1e-3 at these shapes and fail this limit.
LPS_ATOL = 1e-5
# name -> (with --clean-scp, extra decode flags)
RUNS = {
    "plain": (True, []),
    "batch4": (True, ["--batch", "4"]),
    "quality": (True, ["--blend", "auto", "--smooth-strength", "auto"]),
    "batch4_waves": (False, ["--batch", "4"]),     # int16 fast path
}


def kernel_phase(dev, decode_rows: list[int]) -> dict:
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    for length in (512, 256):
        basis = dft_basis(length, dev)
        shapes = [1, 37, 256, 4097] + (decode_rows if length == 512 else [])
        for t in shapes:
            frames = (rng.standard_normal((t, length)) * 1000).astype(
                np.float32)
            frames[3::7] = 0.0                       # floor rows
            x = torch.from_numpy(frames).to(dev)
            got = lps_kernel.lps_cuda(x, basis)
            torch.cuda.synchronize()
            want = lps_kernel.lps_plain(x, basis)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            floor_ok = bool((got[3::7] == -50.0).all().item()) if t > 3 else True
            print(f"kernel  L={length} T={t:5d}: max|cuda-plain|={err:.3e} "
                  f"floor rows exact={floor_ok}")
            if not (err <= LPS_ATOL and floor_ok
                    and bool(torch.isfinite(got).all().item())):
                raise SystemExit(f"lps_cuda disagrees at L={length} T={t}")
            max_err = max(max_err, err)
        zeros = torch.zeros((64, length), device=dev)
        if not bool((lps_kernel.lps_cuda(zeros, basis) == -50.0).all()):
            raise SystemExit(f"all-zero block is not -50 at L={length}")
        torch.cuda.synchronize()

    basis = dft_basis(512, dev)
    times = {}
    for t in (256, 4096, decode_rows[-1]):
        x = torch.from_numpy((rng.standard_normal((t, 512)) * 1000).astype(
            np.float32)).to(dev)
        cuda_ms = time_ms(lambda: lps_kernel.lps_cuda(x, basis))
        plain_ms = time_ms(lambda: lps_kernel.lps_plain(x, basis))
        times[t] = (cuda_ms, plain_ms)
        print(f"kernel  T={t:5d} L=512: lps_cuda {cuda_ms * 1e3:.1f} us/call, "
              f"lps_plain {plain_ms * 1e3:.1f} us/call")
    return {"max_abs_err": max_err, "times": times}


def run_decode(fx: dict, out_dir: str, device: str, clean: bool,
               extra: list) -> None:
    argv = ["decode", "--scp", fx["scp"], "--wts", fx["wts"],
            "--norm", fx["norm"], "--out-dir", out_dir, "--device", device,
            *(["--clean-scp", fx["cscp"]] if clean else []), *extra]
    rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"decode {argv} returned {rc}")


def wrapped_lsb(a: np.ndarray, b: np.ndarray) -> int:
    """Largest |a - b| in int16 steps, modulo the 16-bit wrap both sides share."""
    d = (a.astype(np.int64) - b.astype(np.int64) + 32768) % 65536 - 32768
    return int(np.abs(d).max()) if d.size else 0


def read_info(path: str) -> tuple[float, float]:
    lines = open(path).read().split("\n")
    return float(lines[1]), float(lines[3])


def slice_phase(root: str, fx: dict) -> int:
    stems = [os.path.splitext(os.path.basename(p))[0]
             for p in open(fx["scp"]).read().split()]
    lps_kernel.launches = 0
    for name, (clean, extra) in RUNS.items():
        run_decode(fx, os.path.join(root, name, "cuda"), "cuda", clean, extra)
    torch.cuda.synchronize()
    launches = lps_kernel.launches
    print(f"slice   lps_kernel.launches over the decode runs: {launches}")
    if launches <= 0:
        raise SystemExit("the decode path never launched lps_cuda")

    for name, (clean, extra) in RUNS.items():
        run_decode(fx, os.path.join(root, name, "cpu"), "cpu", clean, extra)
        worst = 0
        for stem, wave in zip(stems, fx["waves"]):
            got, _ = read_wav(os.path.join(root, name, "cuda",
                                           stem + "_enhanced.wav"))
            ref, _ = read_wav(os.path.join(root, name, "cpu",
                                           stem + "_enhanced.wav"))
            t = len(wave) // SHIFT - 1
            if len(got) != t * SHIFT + SHIFT or len(ref) != len(got):
                raise SystemExit(f"{name}/{stem}: {len(got)} samples, "
                                 f"expected {t * SHIFT + SHIFT}")
            worst = max(worst, wrapped_lsb(got, ref))
            if clean:
                seg, lsd = read_info(os.path.join(root, name, "cuda",
                                                  stem + ".info.txt"))
                seg_c, lsd_c = read_info(os.path.join(root, name, "cpu",
                                                      stem + ".info.txt"))
                if not (np.isfinite(seg) and np.isfinite(lsd)):
                    raise SystemExit(f"{name}/{stem}: SegSNR/LSD not finite")
                if abs(seg - seg_c) > 1e-3 or abs(lsd - lsd_c) > 1e-3:
                    raise SystemExit(f"{name}/{stem}: info differs from CPU "
                                     f"({seg}, {lsd}) vs ({seg_c}, {lsd_c})")
        print(f"slice   {name:12s}: {len(stems)} utterances, max "
              f"|cuda-cpu| = {worst} LSB")
        if worst > 1:
            raise SystemExit(f"{name}: CUDA decode differs from CPU by "
                             f"{worst} LSB")
    return launches


def decode_fps(dev, fx: dict, repeats: int = 5) -> float:
    """Device-only frames/s of the batched int16 decode (4 utterances):
    CUDA events over 20 back-to-back batches, median of ``repeats``."""
    enh = Enhancer(fx["wts"], fx["norm"], device=dev)
    x, n_valid, frames = pad_batch(fx["waves"], dev)
    runs = [time_ms(lambda: enh.decode_waves_tensor(x, n_valid), iters=20)
            for _ in range(repeats)]
    ms = sorted(runs)[repeats // 2]
    fps = frames / (ms / 1e3)
    print(f"slice   device-only batched decode: "
          f"{', '.join(f'{r:.4f}' for r in runs)} ms per batch of "
          f"{len(fx['waves'])} ({frames} frames); median {ms:.4f} ms = "
          f"{fps:.0f} frames/s")
    return fps


def main() -> int:
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this smoke "
              "needs a CUDA card", file=sys.stderr)
        return 1
    card = card_line()
    print(f"card    {card}")
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    _, log = load_library()
    print(f"build   nvcc sm_90a: {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build   {line.strip()}")

    with tempfile.TemporaryDirectory() as root:
        fx = write_fixtures(root)
        ts = [len(w) // SHIFT - 1 for w in fx["waves"]]
        kern = kernel_phase(dev, ts + [len(ts) * max(ts)])
        launches = slice_phase(root, fx)
        decode_fps(dev, fx)

    cuda_ms, plain_ms = kern["times"][len(ts) * max(ts)]
    print(json.dumps({"kernels": [{
        "name": "lps_forward", "route": "cuda",
        "source": "tpu_se_torch/csrc/lps_kernel.cu",
        "replaces": "tpu_se/ops/lps_kernel.py:61",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": cuda_ms, "plain_ms": plain_ms}]}))
    print(f"card    {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
