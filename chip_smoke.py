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
6. GGD kernel phase: ``ggd_output_grad_cuda`` against
   ``ggd_output_grad_plain`` on the card for M in {1, 7, 128, 1000, 4096,
   16384}, D in {257, 129, 5}, beta in {0.5, 0.9, 1, 2}, on seeded inputs
   with rows where out == targ and one column equal throughout (exactly 0
   in dedx, alpha exactly 0 there); rtol 5e-6 on alpha and dedx; a rerun
   must be bitwise equal; times both at M = 128 and 4096, D = 257;
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
8. prints the kernel table as JSON, the card line, and last
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
    write_train_fixtures,
)
from tpu_se_torch.cli.main import main as cli_main  # noqa: E402
from tpu_se_torch.data import PfilePairDataset, plan_chunks  # noqa: E402
from tpu_se_torch.dsp.analysis import dft_basis  # noqa: E402
from tpu_se_torch.infer import Enhancer  # noqa: E402
from tpu_se_torch.io import read_pfile_meta, read_wav, read_wts  # noqa: E402
from tpu_se_torch.ops import ggd_kernel, lps_kernel  # noqa: E402
from tpu_se_torch.ops._build import load_library  # noqa: E402
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
# Card against CPU training, 2 epochs at AGREE_LRATE: relative difference
# of the weight CHANGES per layer and of the CV metrics.  At the default
# lrate 0.1 the full-width ML-GGD run is chaotic (the 257 outputs sum 2048
# hidden units, so one step moves them by more than the error scale and
# the sign(e) gradient flips); at 0.001 float32 differences stay ~1e-5.
TRAIN_DW_RTOL = 1e-3
TRAIN_CV_RTOL = 1e-4
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


def ggd_phase(dev) -> dict:
    rng = np.random.default_rng(SEED)
    worst = 0.0
    max_abs = 0.0
    for m in (1, 7, 128, 1000, 4096, 16384):
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
            print(f"ggd     M={m:5d} D={d:3d}: max rel |cuda-plain| over "
                  f"beta {GGD_BETAS} = "
                  f"{', '.join(f'{e:.2e}' for e in errs)}; zeros exact, "
                  f"rerun bitwise equal")
    times = {}
    for m in (128, 4096):
        out_np, targ_np = ggd_inputs(rng, m, 257)
        out = torch.from_numpy(out_np).to(dev)
        targ = torch.from_numpy(targ_np).to(dev)
        cuda_ms = time_ms(lambda: ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                                  1.0))
        plain_ms = time_ms(lambda: ggd_kernel.ggd_output_grad_plain(out, targ,
                                                                    1.0))
        times[m] = (cuda_ms, plain_ms)
        print(f"ggd     M={m:5d} D=257 beta=1: ggd_output_grad_cuda "
              f"{cuda_ms * 1e3:.1f} us/call, ggd_output_grad_plain "
              f"{plain_ms * 1e3:.1f} us/call")
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
    """ML bunches the training run takes: sum over the train range's chunks
    of floor(n_samples / M), times the epochs."""
    _, _, _, ends = read_pfile_meta(tfx["noisy"])
    lo, hi = (int(x) for x in tfx["train_sents"].split("-"))
    plan = plan_chunks(ends, (lo, hi), tfx["traincache"])
    return int(sum(int(n) // BUNCH for n in plan.n_samples)) * EPOCHS


def train_phase(dev, root: str) -> dict:
    tfx = write_train_fixtures(root, SEED)
    init_wts = os.path.join(root, "init.wts")
    if cli_main(["gen-rand-net", "-o", init_wts, "--seed", str(SEED)]) != 0:
        raise SystemExit("gen-rand-net failed")
    sizes = [layer["w"].shape[0] for layer in read_wts(init_wts)]
    print(f"train   full-width model {sizes + [257]} from gen-rand-net; "
          f"fixtures {tfx['train_sents']} train / {tfx['cv_sents']} CV "
          f"sentences, traincache {tfx['traincache']}")

    want = ml_bunches(tfx)
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
    samples = ml_bunches(tfx) // EPOCHS * BUNCH
    print(f"train   epoch 1 on the card, no CV: {samples} samples in "
          f"{dt:.4f} s = {samples / dt:.0f} samples/s "
          f"({samples // BUNCH} bunches, {dt / (samples // BUNCH) * 1e3:.3f} "
          f"ms per bunch)")
    return samples / dt


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
        ggd = ggd_phase(dev)
        train = train_phase(dev, root)

    cuda_ms, plain_ms = kern["times"][len(ts) * max(ts)]
    ggd_ms, ggd_plain_ms = ggd["times"][BUNCH]
    print(json.dumps({"kernels": [{
        "name": "lps_forward", "route": "cuda",
        "source": "tpu_se_torch/csrc/lps_kernel.cu",
        "replaces": "tpu_se/ops/lps_kernel.py:61",
        "launches": launches, "max_abs_err": kern["max_abs_err"],
        "ms": cuda_ms, "plain_ms": plain_ms}, {
        "name": "ggd_output_grad", "route": "cuda",
        "source": "tpu_se_torch/csrc/ggd_kernel.cu",
        "replaces": "tpu_se/ops/ggd_kernel.py:50",
        "launches": train["launches"], "max_abs_err": ggd["max_abs_err"],
        "ms": ggd_ms, "plain_ms": ggd_plain_ms}]}))
    print(f"card    {card}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
