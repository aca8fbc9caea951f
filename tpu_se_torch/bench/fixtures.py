"""Synthetic decode fixtures and timing shared by ``chip_smoke.py`` and
``profile_decode``.

``write_fixtures`` makes, from one seed: a full-width random model
(``DEFAULT_LAYERSIZES``), four 16 kHz noisy/clean wav pairs of 1-4 s
(harmonic tones under an envelope, plus seeded noise), their ``.norm``,
and the two ``.scp`` lists.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from tpu_se_torch.dsp.analysis import frame_signal, lps_from_frames
from tpu_se_torch.io import read_wav, write_norm, write_wav, write_wts
from tpu_se_torch.models import DEFAULT_LAYERSIZES, init_params

SEED = 1234
SAMPLE_RATE = 16000
SHIFT = 256
UTT_SAMPLES = (16000 + 1234, 32000 + 77, 48000 + 500, 64000 - 3)   # 1-4 s


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reports them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean milliseconds per call of ``fn`` over ``iters`` back-to-back
    calls, between two CUDA events on the current stream."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def write_fixtures(root: str, layersizes=DEFAULT_LAYERSIZES,
                   seed: int = SEED) -> dict:
    """Write the model, wavs, .norm and .scp files under ``root``.

    Returns their paths (``wts``, ``norm``, ``scp``, ``cscp``) and the
    noisy waves as read back (``waves``, int16).
    """
    rng = np.random.default_rng(seed)
    wts = os.path.join(root, "model.wts")
    write_wts(wts, init_params(seed, layersizes))
    noisy_paths, clean_paths, noisy_waves = [], [], []
    for i, n in enumerate(UTT_SAMPLES):
        t = np.arange(n) / SAMPLE_RATE
        f0 = 110.0 + 30.0 * i
        envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
        clean = sum(envelope * 2000.0 / h * np.sin(2 * np.pi * h * f0 * t)
                    for h in range(1, 8))
        noisy = clean + 600.0 * rng.standard_normal(n)
        for kind, wave, paths in (("clean", clean, clean_paths),
                                  ("noisy", noisy, noisy_paths)):
            path = os.path.join(root, f"utt{i}_{kind}.wav")
            write_wav(path, np.clip(wave, -32768, 32767).astype(np.int16),
                      SAMPLE_RATE)
            paths.append(path)
        noisy_waves.append(read_wav(noisy_paths[-1])[0])
    lps = np.concatenate([
        lps_from_frames(torch.from_numpy(frame_signal(w))).numpy()
        for w in noisy_waves])
    norm = os.path.join(root, "model.norm")
    write_norm(norm, lps.mean(axis=0), 1.0 / lps.std(axis=0))
    scp = os.path.join(root, "noisy.scp")
    cscp = os.path.join(root, "clean.scp")
    for path, items in ((scp, noisy_paths), (cscp, clean_paths)):
        with open(path, "w") as f:
            f.write("\n".join(items) + "\n")
    return {"wts": wts, "norm": norm, "scp": scp, "cscp": cscp,
            "waves": noisy_waves}


def pad_batch(waves: list, device) -> tuple[torch.Tensor, torch.Tensor, int]:
    """int16 waves -> (``[B, (T+1)*SHIFT]`` int16 batch padded to the
    longest, ``n_valid`` frame counts, total valid frames), on ``device``:
    the inputs of ``Enhancer.decode_waves_tensor``."""
    ts = [len(w) // SHIFT - 1 for w in waves]
    batch = np.zeros((len(ts), (max(ts) + 1) * SHIFT), np.int16)
    for i, (w, t) in enumerate(zip(waves, ts)):
        batch[i, : (t + 1) * SHIFT] = w[: (t + 1) * SHIFT]
    return (torch.from_numpy(batch).to(device),
            torch.tensor(ts, device=device), sum(ts))
