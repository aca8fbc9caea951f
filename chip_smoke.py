#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``tpu_se_torch``) on one GPU.

    python3 chip_smoke.py

Needs one CUDA card, ``nvcc`` and the repository checkout; it imports
nothing of JAX.  In order, and failing (non-zero exit) at the first fault:

1. reports torch/CUDA versions and the card's name and power limit;
2. requires ``torch.cuda.is_available()``;
3. builds the CUDA kernels from ``tpu_se_torch/csrc`` (timed);
4. kernel phase: counts the ``DMMA`` (fp64 tensor-core) instructions of
   each LPS kernel in the built library's SASS (``cuobjdump -sass``) and
   fails on 0; ``lps_cuda`` against ``lps_plain`` on the card, for T in
   {1, 37, 256, 4097}, both sides of the kernel's tile switch and the
   decode's own shapes, L in {512, 256}, seeded frames x1000 with zeroed
   rows (which must give exactly -50); atol 1e-5 in the log domain, and a
   rerun must be bitwise equal; times both, with the kernel's fp64
   TFLOP/s, at T in {256, 992, 3968, 4096, 16384} and the batched
   decode's shape, by events and, beside the kernel's bound, by device
   time (CUDA-graph replay);
5. slice phase: writes a full-width (1799, 2048, 2048, 2048, 257) random
   model, four 16 kHz noisy/clean wav pairs and their ``.norm``, then runs
   ``python -m tpu_se_torch decode`` in-process on the card (plain,
   ``--batch 4``, ``--blend auto --smooth-strength auto``, all with
   ``--clean-scp``, and ``--batch 4`` without it: the int16 fast path),
   counting kernel launches; checks lengths, finite SegSNR/LSD, and waves
   within 1 int16 LSB of the same decode with ``--device cpu``; times the
   device-only batched decode;
6. GGD kernel phase: ``ggd_output_grad_cuda`` against
   ``ggd_output_grad_plain`` on the card for M in {1, 7, 128, 1000, 4096,
   16384} and both sides of each switch of the launcher's plan, D in
   {257, 129, 5}, beta in {0.5, 0.9, 1, 2}, on seeded inputs with rows
   where out == targ and one column equal throughout (exactly 0 in dedx,
   alpha exactly 0 there); rtol 5e-6 on alpha and dedx; a rerun must be
   bitwise equal, and so must beta = 1 (no ``powf``) and the general path
   at beta = 1; times both at M = 128 and 4096, D = 257, by events and by
   device time (CUDA-graph replay), beside the byte bound and an empty
   kernel launched the same way;
7. training phase: writes a 24-sentence synthetic LPS pfile pair and a
   full-width initial ``.wts`` (``python -m tpu_se_torch gen-rand-net``),
   runs ``python -m tpu_se_torch train --epochs 2`` in-process on the card
   with the defaults (parity, M = 128, ML-GGD, beta = 1, lrate 0.1),
   checks its outputs and that the GGD kernel launched once per ML bunch,
   and that a second card run writes a byte-identical ``mlp.2.wts``; then
   runs the same command at ``--lrate 0.001`` on the card and on
   ``--device cpu`` and holds their weight changes to each other (per
   layer, relative difference <= 1e-3) and their CV metrics to rtol 1e-4;
   times one epoch's training.  (At the default lrate the full-width
   training is chaotic: any float32 rounding difference grows ~30x every 4
   bunches, and two CPU implementations differ by 5-9 % after one epoch, so
   only a smaller step can hold two devices to each other.);
8. pipeline phase: the paper's whole pipeline through the CLI, in-process,
   at full width, from a 24-sentence 16 kHz noisy/clean wav corpus:
   ``lps-extract --device cuda --jobs 4`` over the 48 wavs (one LPS kernel
   launch per file, counted), held against ``--device cpu`` on a copy
   (identical HTK headers, data within atol 1e-5); ``make-pfile`` with
   ``--lenfile`` (noisy) and ``--deslenfile`` (clean), ``get-norm``,
   ``concat-pfile``, ``pfile-info --sents``, ``gen-rand-net`` and
   ``wts-info``, with their counts checked; two chained ``bptrain`` epochs
   on ``device=cuda`` from the ``finetune.pl`` strings (the GGD kernel
   launched once per ML bunch, three finite CV lines in each log, no
   ``.state.npz``), and ``train --epochs 2`` on the card from the same
   init and seed, whose ``mlp.1.wts`` and ``mlp.2.wts`` must be
   byte-identical to the chain's; ``decode --device cuda`` of the 4 CV
   sentences with the chain's weights and the ``get-norm`` statistics
   (its enhanced LPS within atol 1e-3 of the CPU's), and ``eval --json``
   of clean against enhanced (all four metrics finite);
   prints the phase's wall time and ``lps-extract``'s time per file;
9. prints the kernel table as JSON (each kernel's launches summed over
   every path that ran it; its device time, its plain version's and its
   bound at the main path's shape), the card line, and last
   ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import io
import json
import math
import os
import shutil
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from tpu_se_torch.bench.fixtures import (  # noqa: E402
    SEED, SHIFT, card_line, device_us, pad_batch, time_ms,
    write_corpus_fixtures, write_fixtures, write_train_fixtures,
)
from tpu_se_torch.cli.main import main as cli_main  # noqa: E402
from tpu_se_torch.data import PfilePairDataset, plan_chunks  # noqa: E402
from tpu_se_torch.dsp.analysis import dft_basis  # noqa: E402
from tpu_se_torch.infer import Enhancer  # noqa: E402
from tpu_se_torch.io import (  # noqa: E402
    read_norm, read_pfile_meta, read_wav, read_wts,
)
from tpu_se_torch.ops import ggd_kernel, lps_kernel  # noqa: E402
from tpu_se_torch.ops._build import (  # noqa: E402
    load_library, sass_opcode_counts,
)
from tpu_se_torch.train import (  # noqa: E402
    TrainConfig, load_checkpoint, load_device_frames, train_one_epoch,
)

# Kernel against plain, log domain.  Both sum in float64 and round only
# re/im to float32, so they agree to a few float32 ulps of the log power
# (1 ulp = 1.9e-6 for |log power| in [16, 32)); a float32 sum in the
# kernel would miss by ~1e-3 at these shapes and fail this limit.
LPS_ATOL = 1e-5
# Kernel against plain, float32 both: a few ulps, from the sum order and
# powf against torch.pow (the CPU check of plain against JAX saw 6.4e-7).
GGD_RTOL = 5e-6
GGD_BETAS = (0.5, 0.9, 1.0, 2.0)
# The card's published peaks (NVIDIA H100 SXM at 700 W) that the kernels'
# bounds are stated against: device memory, and fp64 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP64_TENSOR_FLOPS = 67e12
# Card against CPU training, 2 epochs at AGREE_LRATE: relative difference
# of the weight CHANGES per layer and of the CV metrics.  At the default
# lrate 0.1 the full-width ML-GGD run is chaotic (the 257 outputs sum 2048
# hidden units, so one step moves them by more than the error scale and
# the sign(e) gradient flips); at 0.001 float32 differences stay ~1e-5.
TRAIN_DW_RTOL = 1e-3
TRAIN_CV_RTOL = 1e-4
# Card against CPU decode of the pipeline's trained model, enhanced LPS in
# the log domain: the FFN's float32 sums in another order move an output of
# ~27 by a few ulps (1.9e-6 each) per layer.
DECODE_LPS_ATOL = 1e-3
AGREE_LRATE = "0.001"
BUNCH = 128
EPOCHS = 2
# name -> (with --clean-scp, extra decode flags)
RUNS = {
    "plain": (True, []),
    "batch4": (True, ["--batch", "4"]),
    "quality": (True, ["--blend", "auto", "--smooth-strength", "auto"]),
    "batch4_waves": (False, ["--batch", "4"]),     # int16 fast path
}
# The finetune.pl chain: epoch 1's init_randem_seed, and the step it adds
# for each later epoch (finetune.pl:86,124).
FINETUNE_SEED = 27870775
SEED_STEP = 345


def tensor_core_check() -> None:
    """The LPS kernels must compute on the fp64 tensor cores: count DMMA
    instructions in each of their functions in the built library."""
    counts = {name: n for name, n in sass_opcode_counts("DMMA").items()
              if "lps_kernel" in name}
    for name, n in counts.items():
        print(f"sass    {n:4d} DMMA in {name}")
    if not counts or min(counts.values()) == 0:
        raise SystemExit(f"LPS kernel without DMMA instructions: {counts}")


def kernel_phase(dev, decode_rows: list[int]) -> dict:
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    switch = [lps_kernel.SMALL_TILE_MAX_T, lps_kernel.SMALL_TILE_MAX_T + 1]
    for length in (512, 256):
        basis = dft_basis(length, dev)
        shapes = ([1, 37, 256, 4097] + switch
                  + (decode_rows if length == 512 else []))
        for t in shapes:
            frames = (rng.standard_normal((t, length)) * 1000).astype(
                np.float32)
            frames[3::7] = 0.0                       # floor rows
            x = torch.from_numpy(frames).to(dev)
            got = lps_kernel.lps_cuda(x, basis)
            again = lps_kernel.lps_cuda(x, basis)
            torch.cuda.synchronize()
            want = lps_kernel.lps_plain(x, basis)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            floor_ok = bool((got[3::7] == -50.0).all().item()) if t > 3 else True
            same = torch.equal(got, again)
            print(f"kernel  L={length} T={t:5d}: max|cuda-plain|={err:.3e} "
                  f"floor rows exact={floor_ok} rerun bitwise={same}")
            if not (err <= LPS_ATOL and floor_ok and same
                    and bool(torch.isfinite(got).all().item())):
                raise SystemExit(f"lps_cuda disagrees at L={length} T={t}")
            max_err = max(max_err, err)
        zeros = torch.zeros((64, length), device=dev)
        if not bool((lps_kernel.lps_cuda(zeros, basis) == -50.0).all()):
            raise SystemExit(f"all-zero block is not -50 at L={length}")
        torch.cuda.synchronize()

    basis = dft_basis(512, dev)
    times = {}
    for t in sorted({256, 992, 3968, 4096, 16384, decode_rows[-1]}):
        x = torch.from_numpy((rng.standard_normal((t, 512)) * 1000).astype(
            np.float32)).to(dev)
        cuda_ms = time_ms(lambda: lps_kernel.lps_cuda(x, basis))
        plain_ms = time_ms(lambda: lps_kernel.lps_plain(x, basis))
        tflops = 2 * t * 512 * 514 / (cuda_ms * 1e-3) / 1e12
        print(f"kernel  T={t:5d} L=512: lps_cuda {cuda_ms * 1e3:.1f} "
              f"us/call ({tflops:.1f} TFLOP/s fp64), lps_plain "
              f"{plain_ms * 1e3:.1f} us/call")
        dev_ms = device_us(lambda: lps_kernel.lps_cuda(x, basis)) / 1e3
        dev_plain_ms = device_us(lambda: lps_kernel.lps_plain(x, basis)) / 1e3
        bound_ms, bound_by = lps_bound_ms(t, 512, 257)
        times[t] = {"ms": dev_ms, "plain_ms": dev_plain_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by}
        print(f"kernel  T={t:5d} L=512: device time lps_cuda "
              f"{dev_ms * 1e3:.2f} us, lps_plain {dev_plain_ms * 1e3:.2f} us; "
              f"bound {bound_ms * 1e3:.2f} us ({bound_by}), "
              f"{bound_ms / dev_ms:.0%} of it reached")
    return {"max_abs_err": max_err, "times": times}


def lps_bound_ms(t: int, length: int, n_bins: int) -> tuple[float, str]:
    """The least the card could take for [t, length] frames: the larger of
    the product's 2 * t * length * 2 * n_bins fp64 operations at the tensor
    cores' peak and of frames + basis read, LPS written, at the memory
    rate."""
    ops_ms = 2 * t * length * 2 * n_bins / FP64_TENSOR_FLOPS * 1e3
    moved = 4 * (t * length + length * 2 * n_bins + t * n_bins)
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


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


def ggd_inputs(rng, m: int, d: int) -> tuple[np.ndarray, np.ndarray]:
    """Seeded (out, targ) [m, d]: every 5th row and column d // 2 have
    out == targ."""
    out = rng.standard_normal((m, d)).astype(np.float32)
    targ = (out + rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    targ[2::5] = out[2::5]
    targ[:, d // 2] = out[:, d // 2]
    return out, targ


def max_rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| / |want| over want != 0; inf if got != 0 where
    want == 0."""
    nz = want != 0
    if bool((got[~nz] != 0).any()):
        return float("inf")
    if not bool(nz.any()):
        return 0.0
    return ((got - want).abs()[nz] / want.abs()[nz]).max().item()


def ggd_bound_ms(m: int, d: int) -> float:
    """The least the card could take for an [m, d] bunch: out and targ read
    once, dedx and alpha written once, at the memory rate (the arithmetic,
    a few operations per element, is far below it)."""
    return 4 * (3 * m * d + d) / HBM_BYTES_PER_S * 1e3


def ggd_phase(dev) -> dict:
    rng = np.random.default_rng(SEED)
    lib, _ = load_library()
    worst = 0.0
    max_abs = 0.0
    switch = [m for last in ggd_kernel.PLAN_SWITCH_ROWS
              for m in (last, last + 1)]
    for m in sorted({1, 7, 128, 1000, 4096, 16384, *switch}):
        plan = ggd_kernel.plan(m, 257)
        for d in (257, 129, 5):
            out_np, targ_np = ggd_inputs(rng, m, d)
            out = torch.from_numpy(out_np).to(dev)
            targ = torch.from_numpy(targ_np).to(dev)
            errs = []
            for beta in GGD_BETAS:
                dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, beta)
                dedx2, alpha2 = ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                                beta)
                want_d, want_a = ggd_kernel.ggd_output_grad_plain(out, targ,
                                                                  beta)
                torch.cuda.synchronize()
                rel = max(max_rel(dedx, want_d), max_rel(alpha, want_a))
                zeros = (bool((dedx[2::5] == 0).all())
                         and bool((dedx[:, d // 2] == 0).all())
                         and alpha[d // 2].item() == 0.0)
                same = (torch.equal(dedx, dedx2)
                        and torch.equal(alpha, alpha2))
                finite = bool(torch.isfinite(dedx).all()
                              and torch.isfinite(alpha).all())
                if not (rel <= GGD_RTOL and zeros and same and finite):
                    raise SystemExit(
                        f"ggd_output_grad_cuda disagrees at M={m} D={d} "
                        f"beta={beta}: max rel {rel:.3e}, exact zeros "
                        f"{zeros}, rerun bitwise {same}, finite {finite}")
                errs.append(rel)
                worst = max(worst, rel)
                max_abs = max(max_abs,
                              (dedx - want_d).abs().max().item(),
                              (alpha - want_a).abs().max().item())
            # beta = 1 skips powf; the general path takes it: same bits.
            dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)
            gen_d, gen_a = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0,
                                                           general=True)
            torch.cuda.synchronize()
            if not (torch.equal(dedx, gen_d) and torch.equal(alpha, gen_a)):
                differ = int((dedx != gen_d).sum() + (alpha != gen_a).sum())
                raise SystemExit(
                    f"beta=1 shortcut differs from the general path at M={m} "
                    f"D={d}: {differ} values, max |diff| "
                    f"{(dedx - gen_d).abs().max().item():.3e}")
            print(f"ggd     M={m:5d} D={d:3d}: max rel |cuda-plain| over "
                  f"beta {GGD_BETAS} = "
                  f"{', '.join(f'{e:.2e}' for e in errs)}; zeros exact, "
                  f"rerun bitwise equal, beta=1 shortcut bitwise equal to "
                  f"the general path; plan: strips of {plan.cols} columns x "
                  f"{plan.cluster} blocks of {plan.rows_per_block} rows, "
                  f"{plan.threads} threads, keep={plan.keep}")
    times = {}
    for m in (128, 4096):
        out_np, targ_np = ggd_inputs(rng, m, 257)
        out = torch.from_numpy(out_np).to(dev)
        targ = torch.from_numpy(targ_np).to(dev)

        def kernel():
            return ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)

        def plain():
            return ggd_kernel.ggd_output_grad_plain(out, targ, 1.0)

        def empty():
            lib.ggd_launch_floor(m, 257,
                                 torch.cuda.current_stream().cuda_stream)

        cuda_ms, plain_ms = time_ms(kernel), time_ms(plain)
        dev_ms, dev_plain_ms = device_us(kernel) / 1e3, device_us(plain) / 1e3
        floor_us = device_us(empty)
        bound_ms = ggd_bound_ms(m, 257)
        times[m] = {"ms": dev_ms, "plain_ms": dev_plain_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes"}
        print(f"ggd     M={m:5d} D=257 beta=1: ggd_output_grad_cuda "
              f"{cuda_ms * 1e3:.1f} us/call, ggd_output_grad_plain "
              f"{plain_ms * 1e3:.1f} us/call")
        print(f"ggd     M={m:5d} D=257 beta=1: device time "
              f"ggd_output_grad_cuda {dev_ms * 1e3:.2f} us, "
              f"ggd_output_grad_plain {dev_plain_ms * 1e3:.2f} us, an empty "
              f"kernel launched the same way {floor_us:.2f} us; bound "
              f"{bound_ms * 1e3:.2f} us (bytes), {bound_ms / dev_ms:.0%} of "
              f"it reached")
    return {"max_rel_err": worst, "max_abs_err": max_abs, "times": times}


def run_train(tfx: dict, init_wts: str, out_dir: str, device: str,
              *extra) -> list:
    """Train through the CLI; check its files; -> metrics.jsonl records."""
    rc = cli_main(["train", "--fea-file", tfx["noisy"],
                   "--targ-file", tfx["clean"], "--norm-file", tfx["norm"],
                   "--init-wts", init_wts, "--out-dir", out_dir,
                   "--train-sents", tfx["train_sents"],
                   "--cv-sents", tfx["cv_sents"],
                   "--traincache", str(tfx["traincache"]),
                   "--epochs", str(EPOCHS), "--device", device, *extra])
    if rc != 0:
        raise SystemExit(f"train on {device} returned {rc}")
    for name in ("mlp.1.wts", "mlp.2.wts", "mlp.1.log", "mlp.2.log",
                 "metrics.jsonl"):
        if not os.path.exists(os.path.join(out_dir, name)):
            raise SystemExit(f"train on {device} wrote no {name}")
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        records = [json.loads(line) for line in f]
    if [r["epoch"] for r in records] != list(range(1, EPOCHS + 1)):
        raise SystemExit(f"{device} metrics.jsonl epochs: {records}")
    for r in records:
        for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
            if not np.isfinite(r[k]):
                raise SystemExit(f"{device} epoch {r['epoch']}: {k} = {r[k]}")
    return records


def ml_bunches(tfx: dict) -> int:
    """ML bunches one training epoch takes: sum over the train range's
    chunks of floor(n_samples / M)."""
    _, _, _, ends = read_pfile_meta(tfx["noisy"])
    lo, hi = (int(x) for x in tfx["train_sents"].split("-"))
    plan = plan_chunks(ends, (lo, hi), tfx["traincache"])
    return int(sum(int(n) // BUNCH for n in plan.n_samples))


def train_phase(dev, root: str) -> dict:
    tfx = write_train_fixtures(root, SEED)
    init_wts = os.path.join(root, "init.wts")
    if cli_main(["gen-rand-net", "-o", init_wts, "--seed", str(SEED)]) != 0:
        raise SystemExit("gen-rand-net failed")
    sizes = [layer["w"].shape[0] for layer in read_wts(init_wts)]
    print(f"train   full-width model {sizes + [257]} from gen-rand-net; "
          f"fixtures {tfx['train_sents']} train / {tfx['cv_sents']} CV "
          f"sentences, traincache {tfx['traincache']}")

    want = ml_bunches(tfx) * EPOCHS
    ggd_kernel.launches = 0
    t0 = time.perf_counter()
    run_train(tfx, init_wts, os.path.join(root, "cuda"), "cuda")
    torch.cuda.synchronize()
    cuda_s = time.perf_counter() - t0
    launches = ggd_kernel.launches
    print(f"train   cuda: {EPOCHS} epochs in {cuda_s:.2f} s; "
          f"ggd_kernel.launches = {launches}, ML bunches = {want}")
    if launches != want:
        raise SystemExit(f"GGD kernel launched {launches} times for {want} "
                         "ML bunches")

    run_train(tfx, init_wts, os.path.join(root, "cuda2"), "cuda")
    with open(os.path.join(root, "cuda", "mlp.2.wts"), "rb") as f1, \
            open(os.path.join(root, "cuda2", "mlp.2.wts"), "rb") as f2:
        identical = f1.read() == f2.read()
    print(f"train   second card run: mlp.2.wts byte-identical = {identical}")
    if not identical:
        raise SystemExit("two card training runs differ")

    lr = ("--lrate", AGREE_LRATE)
    cuda_rec = run_train(tfx, init_wts, os.path.join(root, "cuda_lr"),
                         "cuda", *lr)
    t0 = time.perf_counter()
    cpu_rec = run_train(tfx, init_wts, os.path.join(root, "cpu_lr"), "cpu",
                        *lr)
    print(f"train   cpu at lrate {AGREE_LRATE}: {EPOCHS} epochs in "
          f"{time.perf_counter() - t0:.2f} s")
    w0 = read_wts(init_wts)
    w_cuda = read_wts(os.path.join(root, "cuda_lr", "mlp.2.wts"))
    w_cpu = read_wts(os.path.join(root, "cpu_lr", "mlp.2.wts"))
    worst_dw = 0.0
    for i, (a, g, c) in enumerate(zip(w0, w_cuda, w_cpu)):
        for k in ("w", "b"):
            d_cuda = g[k].astype(np.float64) - a[k]
            d_cpu = c[k].astype(np.float64) - a[k]
            rel = (np.linalg.norm(d_cuda - d_cpu) / np.linalg.norm(d_cpu))
            print(f"train   lrate {AGREE_LRATE} layer {i} {k}: |dW_cuda - "
                  f"dW_cpu| / |dW_cpu| = {rel:.3e} "
                  f"(|dW_cpu| = {np.linalg.norm(d_cpu):.4e})")
            worst_dw = max(worst_dw, rel)
    if not worst_dw <= TRAIN_DW_RTOL:
        raise SystemExit(f"card training moves the weights {worst_dw:.3e} "
                         "away from the CPU run's")
    worst_cv = 0.0
    for rc, rp in zip(cuda_rec, cpu_rec):
        for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
            rel = abs(rc[k] - rp[k]) / abs(rp[k])
            print(f"train   lrate {AGREE_LRATE} epoch {rc['epoch']} {k}: "
                  f"cuda {rc[k]!r} cpu {rp[k]!r} rel {rel:.3e}")
            worst_cv = max(worst_cv, rel)
    if not worst_cv <= TRAIN_CV_RTOL:
        raise SystemExit(f"card CV metrics differ from the CPU run's by "
                         f"{worst_cv:.3e}")
    return {"launches": launches, "dw_rel": worst_dw, "cv_rel": worst_cv,
            "samples_per_s": train_rate(dev, tfx, init_wts)}


def train_rate(dev, tfx: dict, init_wts: str) -> float:
    """Informational: training samples/s of epoch 1 on the card (resident
    frames, no CV), host clock around the epoch ending in a synchronise."""
    cfg = TrainConfig(train_sent_range=tuple(
        int(x) for x in tfx["train_sents"].split("-")),
        traincache=tfx["traincache"])
    ds = PfilePairDataset(tfx["noisy"], tfx["clean"], tfx["norm"],
                          cfg.train_sent_range, cfg.traincache)
    frames = load_device_frames(ds, dev)
    state = load_checkpoint(init_wts, dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    train_one_epoch(state, ds, cfg.hyper(), cfg.lr_for_epoch(1),
                    np.random.default_rng(cfg.seed_for_epoch(1)), dev,
                    device_frames=frames, log=lambda s: None)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    samples = ml_bunches(tfx) * BUNCH
    print(f"train   epoch 1 on the card, no CV: {samples} samples in "
          f"{dt:.4f} s = {samples / dt:.0f} samples/s "
          f"({samples // BUNCH} bunches, {dt / (samples // BUNCH) * 1e3:.3f} "
          f"ms per bunch)")
    return samples / dt


def cli(argv: list) -> str:
    """Run the port's CLI in-process; fail on a non-zero exit; -> stdout."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = cli_main(argv)
    if rc != 0:
        raise SystemExit(f"{' '.join(argv[:2])} ... returned {rc}")
    return out.getvalue()


def read_list(path: str) -> list[str]:
    with open(path) as f:
        return f.read().split()


def write_list(path: str, items: list[str]) -> str:
    with open(path, "w") as f:
        f.write("".join(f"{item}\n" for item in items))
    return path


def lps_path(wav: str) -> str:
    return wav.rsplit(".", 1)[0] + ".lps"


def finetune_args(p: dict, init_wts: str, out_dir: str, epoch: int) -> list:
    """The key=value strings of ``finetune.pl``'s iteration ``epoch``
    (finetune.pl:50-76, as tests/test_bptrain_cli.py lists them), cut to
    the corpus: 20 training and 4 CV sentences, traincache 1024."""
    return [
        "gpu_used=0", "numlayers=4", "layersizes=1799,2048,2048,2048,257",
        "bunchsize=128", "MLflag=1", "shapefactor=1", "momentum=0.9",
        "weightcost=0.00001", "lrate=0.1", "fea_dim=257", "fea_context=7",
        f"traincache={p['traincache']}",
        f"init_randem_seed={FINETUNE_SEED + SEED_STEP * (epoch - 1)}",
        "targ_offset=3", f"initwts_file={init_wts}",
        f"norm_file={p['norm']}", f"fea_file={p['noisy']}",
        f"targ_file={p['clean']}",
        f"outwts_file={out_dir}/mlp.{epoch}.wts",
        f"log_file={out_dir}/mlp.{epoch}.log",
        f"train_sent_range={p['train_sents']}",
        f"cv_sent_range={p['cv_sents']}",
        "dropoutflag=0", "visible_omit=0.1", "hid_omit=0.1", "device=cuda"]


def extract_lps(root: str, cx: dict) -> tuple[int, dict]:
    """``lps-extract`` over the corpus on the card (``--jobs 4``), then on
    the CPU over a copy; holds the two sets of ``.lps`` files to each
    other.  -> (LPS kernel launches of the card runs, ms per file)."""
    cpu_scp = {}
    for kind in ("noisy", "clean"):
        cpu_dir = os.path.join(root, "cpu", kind)
        shutil.copytree(cx[f"{kind}_dir"], cpu_dir)
        cpu_scp[kind] = write_list(
            os.path.join(root, "cpu", f"{kind}.scp"),
            [os.path.join(cpu_dir, os.path.basename(w))
             for w in read_list(cx[f"{kind}_scp"])])
    wavs = read_list(cx["noisy_scp"]) + read_list(cx["clean_scp"])

    ms = {}
    lps_kernel.launches = 0
    t0 = time.perf_counter()
    for kind in ("noisy", "clean"):
        cli(["lps-extract", "--scp", cx[f"{kind}_scp"], "--device", "cuda",
             "--jobs", "4"])
    torch.cuda.synchronize()
    ms["cuda"] = (time.perf_counter() - t0) * 1e3 / len(wavs)
    launches = lps_kernel.launches
    print(f"pipe    lps-extract --device cuda --jobs 4: {len(wavs)} files, "
          f"{ms['cuda']:.3f} ms per file; lps_kernel.launches = {launches}")
    if launches != len(wavs):
        raise SystemExit(f"lps-extract launched the LPS kernel {launches} "
                         f"times for {len(wavs)} files")

    t0 = time.perf_counter()
    for kind in ("noisy", "clean"):
        cli(["lps-extract", "--scp", cpu_scp[kind], "--device", "cpu",
             "--jobs", "4"])
    ms["cpu"] = (time.perf_counter() - t0) * 1e3 / len(wavs)
    worst = 0.0
    for wav in wavs:
        with open(lps_path(wav), "rb") as f:
            got = f.read()
        cpu_wav = os.path.join(root, "cpu", os.path.basename(
            os.path.dirname(wav)), os.path.basename(wav))
        with open(lps_path(cpu_wav), "rb") as f:
            want = f.read()
        if got[:12] != want[:12] or len(got) != len(want):
            raise SystemExit(f"{wav}: card and CPU .lps headers or sizes "
                             "differ")
        a, b = (np.frombuffer(x[12:], ">f4") for x in (got, want))
        if not np.isfinite(a).all():
            raise SystemExit(f"{wav}: non-finite LPS from the card")
        worst = max(worst, float(np.abs(a - b).max()))
    print(f"pipe    lps-extract --device cpu: {ms['cpu']:.3f} ms per file; "
          f"headers identical, max |cuda-cpu| = {worst:.3e}")
    if not worst <= LPS_ATOL:
        raise SystemExit(f"card .lps differ from the CPU's by {worst:.3e}")
    return launches, ms


def pack(root: str, cx: dict) -> dict:
    """``make-pfile`` (noisy with --lenfile, clean with --deslenfile),
    ``get-norm``, ``concat-pfile`` and ``pfile-info --sents``."""
    n = len(read_list(cx["noisy_scp"]))
    p = {k: os.path.join(root, name) for k, name in (
        ("noisy", "noisy.pfile"), ("clean", "clean.pfile"),
        ("len", "frame_numbers.len"), ("norm", "noisy.norm"),
        ("both", "both.pfile"))}
    scp = {kind: write_list(os.path.join(root, f"{kind}_lps.scp"),
                            [lps_path(w) for w in read_list(cx[f"{kind}_scp"])])
           for kind in ("noisy", "clean")}
    cli(["make-pfile", scp["noisy"], "-o", p["noisy"], "--lenfile", p["len"],
         "--jobs", "4"])
    cli(["make-pfile", scp["clean"], "-o", p["clean"],
         "--deslenfile", p["len"]])
    cli(["get-norm", p["noisy"], "-o", p["norm"]])
    lens = [int(x) for x in read_list(p["len"])]
    total = sum(lens)
    for name in ("noisy", "clean"):
        got = read_pfile_meta(p[name])[:3]
        if len(lens) != n or got != (n, total, 257):
            raise SystemExit(f"{name} pfile holds {got}, lenfile {len(lens)} "
                             f"sentences of {total} frames")
    mean, inv_std = read_norm(p["norm"])
    if mean.shape != (257,) or not (np.isfinite(mean).all()
                                    and np.isfinite(inv_std).all()):
        raise SystemExit("get-norm wrote no finite 257-dim statistics")
    cli(["concat-pfile", p["noisy"], p["clean"], "-o", p["both"]])
    if read_pfile_meta(p["both"])[:3] != (2 * n, 2 * total, 257):
        raise SystemExit(f"concat-pfile: {read_pfile_meta(p['both'])[:3]}")
    info = cli(["pfile-info", "--sents", p["noisy"]]).splitlines()
    want = ([f"{p['noisy']}: {n} sentences, {total} frames, 257 features"]
            + [f"  sentence {i}: {t} frames" for i, t in enumerate(lens)])
    if info != want:
        raise SystemExit(f"pfile-info --sents printed {info[:3]} ...")
    print(f"pipe    make-pfile/get-norm/concat-pfile/pfile-info: {n} "
          f"sentences, {total} frames x 257; concat {2 * n} sentences")
    return {**p, "train_sents": cx["train_sents"], "cv_sents": cx["cv_sents"],
            "traincache": cx["traincache"]}


def check_log(path: str) -> list[float]:
    """A bptrain log's three CV values, which must be finite, and its
    device and time lines."""
    with open(path) as f:
        lines = f.read().splitlines()
    values = [float(line.split(":")[1]) for line in lines if line.startswith((
        "CV over. squared error:", "CV over. square root squared error:",
        "CV2 over. CV log likelihood:"))]
    if len(values) != 3 or not all(math.isfinite(v) for v in values):
        raise SystemExit(f"{path}: CV lines {values}")
    if not any(line.startswith("torch device: cuda (") for line in lines) or \
            not any(line.startswith("Total cost time: ") for line in lines):
        raise SystemExit(f"{path}: no card device line or no time line")
    return values


def chain(root: str, p: dict) -> int:
    """``gen-rand-net``, ``wts-info``, two chained ``bptrain`` epochs on the
    card and ``train --epochs 2`` from the same init and seed.
    -> GGD kernel launches of the chain and of ``train``."""
    init = os.path.join(root, "init.wts")
    cli(["gen-rand-net", "-o", init, "--seed", str(SEED)])
    params = sum(layer["w"].size + layer["b"].size for layer in read_wts(init))
    info = cli(["wts-info", init])
    if f"  total: {params} parameters " not in info:
        raise SystemExit(f"wts-info: no 'total: {params} parameters' in "
                         f"{info!r}")
    want = ml_bunches(p)
    out = os.path.join(root, "chain")
    os.makedirs(out)
    launches = 0
    for epoch in (1, 2):
        start = init if epoch == 1 else os.path.join(out, "mlp.1.wts")
        ggd_kernel.launches = 0
        t0 = time.perf_counter()
        cli(["bptrain", *finetune_args(p, start, out, epoch)])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        values = check_log(os.path.join(out, f"mlp.{epoch}.log"))
        print(f"pipe    bptrain epoch {epoch} on the card: {dt:.2f} s; "
              f"ggd_kernel.launches = {ggd_kernel.launches}, ML bunches = "
              f"{want}; CV squared error, abs, GGD loglik = {values}")
        if ggd_kernel.launches != want:
            raise SystemExit(f"bptrain epoch {epoch}: GGD kernel launched "
                             f"{ggd_kernel.launches} times for {want} bunches")
        launches += ggd_kernel.launches
    sidecars = [f for d in (root, out) for f in os.listdir(d)
                if f.endswith(".state.npz")]
    if sidecars:
        raise SystemExit(f"bptrain wrote state sidecars: {sidecars}")

    ggd_kernel.launches = 0
    cli(["train", "--fea-file", p["noisy"], "--targ-file", p["clean"],
         "--norm-file", p["norm"], "--init-wts", init,
         "--out-dir", os.path.join(root, "train"),
         "--train-sents", p["train_sents"], "--cv-sents", p["cv_sents"],
         "--traincache", str(p["traincache"]), "--seed", str(FINETUNE_SEED),
         "--epochs", "2", "--device", "cuda"])
    torch.cuda.synchronize()
    if ggd_kernel.launches != 2 * want:
        raise SystemExit(f"train: GGD kernel launched {ggd_kernel.launches} "
                         f"times for {2 * want} bunches")
    launches += ggd_kernel.launches
    for name in ("mlp.1.wts", "mlp.2.wts"):
        with open(os.path.join(out, name), "rb") as f1, \
                open(os.path.join(root, "train", name), "rb") as f2:
            if f1.read() != f2.read():
                raise SystemExit(f"bptrain chain and train --epochs 2 "
                                 f"differ in {name}")
    print("pipe    train --epochs 2 on the card: mlp.1.wts and mlp.2.wts "
          "byte-identical to the bptrain chain's")
    return launches


def enhance_and_score(root: str, cx: dict, p: dict) -> int:
    """``decode --device cuda`` of the CV sentences with the chain's weights
    and the ``get-norm`` statistics, then ``eval --json`` against the clean
    wavs.  -> LPS kernel launches of the decode."""
    lo, hi = (int(x) for x in p["cv_sents"].split("-"))
    noisy = read_list(cx["noisy_scp"])[lo:hi + 1]
    clean = read_list(cx["clean_scp"])[lo:hi + 1]
    out = os.path.join(root, "enhanced")
    lps_kernel.launches = 0
    cli(["decode", *noisy, "--wts", os.path.join(root, "chain", "mlp.2.wts"),
         "--norm", p["norm"], "--out-dir", out, "--device", "cuda"])
    torch.cuda.synchronize()
    launches = lps_kernel.launches
    if launches <= 0:
        raise SystemExit("decode of the CV sentences launched no LPS kernel")
    enhanced = [os.path.join(out, os.path.splitext(os.path.basename(w))[0]
                             + "_enhanced.wav") for w in noisy]

    # Two epochs at lrate 0.1 leave a model that speaks far louder than the
    # clean speech: its float waves leave the int16 range and wrap, so the
    # card's and the CPU's int16 waves differ after the wrap by far more
    # than 1 LSB.  The decode of this model is held to the CPU's by its
    # enhanced LPS (float32 GEMMs summed in another order).
    wts = os.path.join(root, "chain", "mlp.2.wts")
    card = Enhancer(wts, p["norm"], device="cuda")
    host = Enhancer(wts, p["norm"], device="cpu")
    worst, loud, clean_peak = 0.0, 0.0, 0
    for path, clean_path in zip(noisy, clean):
        wave = read_wav(path)[0]
        _, recon, enh = card.enhance(wave)
        worst = max(worst, float(np.abs(enh - host.enhance(wave)[2]).max()))
        loud = max(loud, float(np.abs(recon).max()))
        clean_peak = max(clean_peak, int(np.abs(
            read_wav(clean_path)[0].astype(np.int32)).max()))
    print(f"pipe    decode of {len(noisy)} CV sentences: max |enhanced LPS "
          f"cuda-cpu| = {worst:.3e}; peak |recon frame| {loud:.1f}, clean "
          f"peak {clean_peak}")
    if not worst <= DECODE_LPS_ATOL:
        raise SystemExit(f"the chain's model decodes {worst:.3e} away from "
                         "the CPU's enhanced LPS")
    text = cli(["eval", "--json", "--clean", *clean, "--test", *enhanced])
    rows = [json.loads(line) for line in text.splitlines()]
    for row in rows:
        print(f"pipe    eval {json.dumps(row)}")
    if [r["name"] for r in rows] != enhanced + ["mean"] or not all(
            math.isfinite(r[m]) for r in rows
            for m in ("segsnr", "lsd", "stoi", "pesq")):
        raise SystemExit("eval: rows missing or metrics not finite")
    return launches


def pipeline_phase(root: str) -> dict:
    """wav -> .lps -> pfile -> .norm -> bptrain chain -> decode -> eval,
    through the CLI on the card."""
    t0 = time.perf_counter()
    cx = write_corpus_fixtures(os.path.join(root, "corpus"), SEED)
    lps_launches, ms = extract_lps(root, cx)
    p = pack(root, cx)
    ggd_launches = chain(root, p)
    lps_launches += enhance_and_score(root, cx, p)
    seconds = time.perf_counter() - t0
    print(f"pipe    pipeline phase wall time: {seconds:.2f} s")
    return {"lps_launches": lps_launches, "ggd_launches": ggd_launches,
            "seconds": seconds, "ms_per_file": ms}


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

    tensor_core_check()

    with tempfile.TemporaryDirectory() as root:
        fx = write_fixtures(root)
        ts = [len(w) // SHIFT - 1 for w in fx["waves"]]
        kern = kernel_phase(dev, ts + [len(ts) * max(ts)])
        launches = slice_phase(root, fx)
        decode_fps(dev, fx)
        ggd = ggd_phase(dev)
        train = train_phase(dev, root)
        pipe = pipeline_phase(os.path.join(root, "pipeline"))

    # Device time (CUDA-graph replay) at the main path's shapes: the
    # batched decode's rows, the parity bunch.  Neither kernel's function
    # is one PyTorch call, so there is no library time.
    print(json.dumps({"kernels": [{
        "name": "lps_forward", "route": "cuda",
        "source": "tpu_se_torch/csrc/lps_kernel.cu",
        "replaces": "tpu_se/ops/lps_kernel.py:61",
        "launches": launches + pipe["lps_launches"],
        "max_abs_err": kern["max_abs_err"],
        **kern["times"][len(ts) * max(ts)], "library_ms": None}, {
        "name": "ggd_output_grad", "route": "cuda",
        "source": "tpu_se_torch/csrc/ggd_kernel.cu",
        "replaces": "tpu_se/ops/ggd_kernel.py:50",
        "launches": train["launches"] + pipe["ggd_launches"],
        "max_abs_err": ggd["max_abs_err"],
        **ggd["times"][BUNCH], "library_ms": None}]}))
    print(f"card    {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
