"""End-to-end pipeline demo on the reference's demo corpus (``Enh_demos``).

The twin of ``examples/demo_pipeline.py`` on the port.  It runs every
layer with the port's own tooling, as the reference's full recipe does
(README.md:5-114):

1. feature extraction: noisy + clean demo wavs -> LPS (on ``--device``);
2. packaging: LPS -> paired pfiles (deslen-aligned) + ``.norm`` statistics;
3. training: an ML-GGD beta=1 DNN at full width on 13 of the 14 demo
   conditions, 40 epochs;
4. decode: enhance the held-out condition (``F-16Cockpit_SNR10``) with
   ``blend="auto"`` and ``smooth_strength="auto"``, and report
   SegSNR/LSD/STOI.

The demo corpus is tiny (13 training utterances); the point is the
plumbing, not the absolute quality.  ``tpu_se``'s script reads the corpus
from a fixed absolute path; here its root is ``--reference`` (the
directory that holds ``Enh_demos/``; default ``reference``, relative to
the working directory).  Usage::

    python -m tpu_se_torch.examples.demo_pipeline [workdir] \\
        [--reference DIR] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import os
import re
import sys

from tpu_se_torch.dsp import wav_to_lps
from tpu_se_torch.infer import decode_files, stoi
from tpu_se_torch.io import (
    compute_norm, read_pfile, read_wav, write_norm, write_pfile,
)
from tpu_se_torch.models import DEFAULT_LAYERSIZES
from tpu_se_torch.train import TrainConfig, run_training

REFERENCE = "reference"
HELD_OUT = "F-16Cockpit_SNR10"


def demo_pairs(reference: str) -> list[tuple[str, str]]:
    """(noisy, clean) wav pairs of ``<reference>/Enh_demos``: each
    ``*_NOISY_*.wav`` with its ``*_CLEAN_*.WAV``."""
    pairs = []
    for nw in sorted(glob.glob(os.path.join(reference, "Enh_demos",
                                            "*_NOISY_*.wav"))):
        cw = re.sub(r"_NOISY_", "_CLEAN_", nw)[:-4] + ".WAV"
        if os.path.exists(cw):
            pairs.append((nw, cw))
    return pairs


def run(work: str, reference: str = REFERENCE, device: str = "cuda",
        layersizes=DEFAULT_LAYERSIZES, epochs: int = 40,
        log=print) -> list[dict]:
    """The four stages -> per held-out utterance ``decode_files``' record
    plus ``stoi`` and ``stoi_noisy``.  ``layersizes`` and ``epochs`` are
    the script's (full width, 40 epochs) unless a caller narrows them."""
    os.makedirs(work, exist_ok=True)
    pairs = demo_pairs(reference)
    train_pairs = [(n, c) for n, c in pairs if HELD_OUT not in n]
    test_pairs = [(n, c) for n, c in pairs if HELD_OUT in n]
    log(f"{len(train_pairs)} train pairs, {len(test_pairs)} held out")

    # -- stage 1+2: features -> pfiles + norm -------------------------------
    noisy_utts, clean_utts = [], []
    for nw, cw in train_pairs:
        n_lps = wav_to_lps(read_wav(nw)[0], device=device)
        c_lps = wav_to_lps(read_wav(cw)[0], device=device)
        t = min(len(n_lps), len(c_lps))          # deslen alignment
        noisy_utts.append(n_lps[:t])
        clean_utts.append(c_lps[:t])
    noisy_pfile = os.path.join(work, "train_noisy.pfile")
    clean_pfile = os.path.join(work, "train_clean.pfile")
    write_pfile(noisy_pfile, noisy_utts)
    write_pfile(clean_pfile, clean_utts)
    mean, inv_std = compute_norm(read_pfile(noisy_pfile).features)
    norm_file = os.path.join(work, "train_noisy.norm")
    write_norm(norm_file, mean, inv_std)
    total = sum(len(u) for u in noisy_utts)
    log(f"packaged {total} frames x 257 from {len(noisy_utts)} utterances")

    # -- stage 3: training --------------------------------------------------
    n_train = len(noisy_utts)
    cfg = TrainConfig(
        fea_file=noisy_pfile, targ_file=clean_pfile, norm_file=norm_file,
        out_dir=os.path.join(work, "MLGGD1"), layersizes=tuple(layersizes),
        ml_flag=True, shapefactor=1.0, epochs=epochs,
        train_sent_range=(0, n_train - 3),
        cv_sent_range=(n_train - 2, n_train - 1),
    )
    final_wts = run_training(cfg, device, log=log)
    log(f"trained -> {final_wts}")

    # -- stage 4: decode the held-out condition -----------------------------
    # The round-5 quality decode (PARITY.md section 4): blend="auto" (the
    # adaptive suppression-depth limiter) and smooth_strength="auto"
    # (impulsiveness-gated fractional smoothing), which rein in a
    # data-starved model where its suppression is unconfident.
    results = decode_files(final_wts, norm_file,
                           [n for n, _ in test_pairs],
                           os.path.join(work, "enhanced"),
                           [c for _, c in test_pairs], log=log,
                           blend="auto", smooth_strength="auto",
                           device=device)
    for (nw, cw), r in zip(test_pairs, results):
        clean, fs = read_wav(cw)
        noisy, _ = read_wav(nw)
        enh, _ = read_wav(r["out"])
        r["stoi"] = stoi(clean[:len(enh)], enh, fs)
        r["stoi_noisy"] = stoi(clean, noisy, fs)
        log(f"{os.path.basename(nw)}: "
            f"segsnr {r['segsnr_noisy']:.2f} -> {r['segsnr']:.2f} dB, "
            f"lsd {r['lsd_noisy']:.2f} -> {r['lsd']:.2f} dB, "
            f"stoi {r['stoi_noisy']:.3f} -> {r['stoi']:.3f}")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_se_torch.examples.demo_pipeline",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("workdir", nargs="?", default="artifacts/demo_pipeline")
    ap.add_argument("--reference", default=REFERENCE,
                    help="directory that holds Enh_demos/")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    run(args.workdir, args.reference, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
