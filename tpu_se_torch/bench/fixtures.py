"""Synthetic fixtures and timing shared by ``chip_smoke.py`` and
``profile_decode``.

``write_fixtures`` makes, from one seed: a full-width random model
(``DEFAULT_LAYERSIZES``), four 16 kHz noisy/clean wav pairs of 1-4 s
(harmonic tones under an envelope, plus seeded noise), their ``.norm``,
and the two ``.scp`` lists.  ``write_train_fixtures`` makes a training
set the same way: a noisy/clean LPS pfile pair of 24 sentences and the
noisy ``.norm``; ``write_corpus_fixtures`` writes those 24 sentences as
noisy/clean wavs instead, the input of the feature-preparation CLI.
``stream_hops`` cuts ``write_fixtures``' waves into the aligned hops a
multi-stream ``StreamingEnhancer`` takes.
"""

from __future__ import annotations

import os
import subprocess

import numpy as np
import torch

from tpu_se_torch.dsp.analysis import frame_signal, lps_from_frames, wav_to_lps
from tpu_se_torch.io import (
    read_wav, write_norm, write_pfile, write_wav, write_wts,
)
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


def device_us(fn, calls: int = 20, repeats: int = 5) -> float:
    """Device microseconds per call of ``fn``: ``calls`` calls captured in
    one CUDA graph and replayed, CUDA events around each replay, median of
    ``repeats``.  Unlike ``time_ms`` it leaves out the host's time to issue
    each call, which sets ``time_ms`` for a kernel of a few microseconds."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    runs = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        runs.append(start.elapsed_time(end) * 1e3 / calls)
    return sorted(runs)[repeats // 2]


# Training set: 24 sentences of 2-4 s; 0-19 train, 20-23 CV.  The traincache
# cuts the ~3600 training windows into 4 chunks (3 full, 1 partial).
TRAIN_SENTENCES = 24
TRAIN_SENTS = "0-19"
CV_SENTS = "20-23"
TRAINCACHE = 1024


def _voiced(n: int, f0: float, rng: np.random.Generator
            ) -> tuple[np.ndarray, np.ndarray]:
    """(clean, noisy) float waves of n samples: harmonic tones of f0 under
    a 3 Hz envelope, and the same plus seeded white noise."""
    t = np.arange(n) / SAMPLE_RATE
    envelope = 0.5 + 0.5 * np.sin(2 * np.pi * 3.0 * t) ** 2
    clean = sum(envelope * 2000.0 / h * np.sin(2 * np.pi * h * f0 * t)
                for h in range(1, 8))
    return clean, clean + 600.0 * rng.standard_normal(n)


def _int16(wave: np.ndarray) -> np.ndarray:
    return np.clip(wave, -32768, 32767).astype(np.int16)


def _corpus(seed: int):
    """The training set's ``TRAIN_SENTENCES`` seeded sentences of 2-4 s, in
    order: (clean, noisy) int16 waves at 16 kHz."""
    rng = np.random.default_rng(seed)
    for i in range(TRAIN_SENTENCES):
        n = int(rng.integers(2 * SAMPLE_RATE, 4 * SAMPLE_RATE + 1))
        clean, noisy = _voiced(n, 90.0 + 7.0 * i, rng)
        yield _int16(clean), _int16(noisy)


def write_train_fixtures(root: str, seed: int = SEED) -> dict:
    """Write a synthetic training set under ``root``.

    The ``_corpus`` sentences (tones plus noise, as ``write_fixtures``),
    their LPS from the port's CPU ``wav_to_lps`` in a noisy and a clean
    pfile, and the noisy statistics as ``.norm``.  Returns the paths
    (``noisy``, ``clean``, ``norm``) and the ``train`` command's
    ``train_sents``, ``cv_sents`` and ``traincache``.
    """
    noisy_lps, clean_lps = [], []
    for clean, noisy in _corpus(seed):
        clean_lps.append(wav_to_lps(clean, device="cpu"))
        noisy_lps.append(wav_to_lps(noisy, device="cpu"))
    paths = {k: os.path.join(root, f"train_{k}.{ext}") for k, ext in
             (("noisy", "pfile"), ("clean", "pfile"), ("norm", "norm"))}
    write_pfile(paths["noisy"], noisy_lps)
    write_pfile(paths["clean"], clean_lps)
    frames = np.concatenate(noisy_lps)
    write_norm(paths["norm"], frames.mean(axis=0), 1.0 / frames.std(axis=0))
    return {**paths, "train_sents": TRAIN_SENTS, "cv_sents": CV_SENTS,
            "traincache": TRAINCACHE}


def write_corpus_fixtures(root: str, seed: int = SEED) -> dict:
    """Write the training set's sentences as a wav corpus under ``root``.

    The same ``_corpus`` sentences as ``write_train_fixtures``, as 16 kHz
    wavs ``noisy/sNN.wav`` and ``clean/sNN.wav``, with the lists
    ``noisy.scp`` and ``clean.scp``: the input of the feature-preparation
    CLI (``lps-extract`` -> ``make-pfile``), which then packs the same LPS
    as ``write_train_fixtures``.  Returns the two directories
    (``noisy_dir``, ``clean_dir``), the two lists (``noisy_scp``,
    ``clean_scp``) and the ``train_sents``, ``cv_sents`` and ``traincache``
    of the training set.
    """
    out = {}
    lists = {"noisy": [], "clean": []}
    for kind in lists:
        out[f"{kind}_dir"] = os.path.join(root, kind)
        os.makedirs(out[f"{kind}_dir"], exist_ok=True)
    for i, (clean, noisy) in enumerate(_corpus(seed)):
        for kind, wave in (("clean", clean), ("noisy", noisy)):
            path = os.path.join(out[f"{kind}_dir"], f"s{i:02d}.wav")
            write_wav(path, wave, SAMPLE_RATE)
            lists[kind].append(path)
    for kind, paths in lists.items():
        out[f"{kind}_scp"] = os.path.join(root, f"{kind}.scp")
        with open(out[f"{kind}_scp"], "w") as f:
            f.write("\n".join(paths) + "\n")
    return {**out, "train_sents": TRAIN_SENTS, "cv_sents": CV_SENTS,
            "traincache": TRAINCACHE}


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
        clean, noisy = _voiced(n, 110.0 + 30.0 * i, rng)
        for kind, wave, paths in (("clean", clean, clean_paths),
                                  ("noisy", noisy, noisy_paths)):
            path = os.path.join(root, f"utt{i}_{kind}.wav")
            write_wav(path, _int16(wave), SAMPLE_RATE)
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


def stream_hops(waves: list, n_streams: int, n_hops: int,
                shift: int = SHIFT) -> np.ndarray:
    """``[n_streams, n_hops, shift]`` int16 hops for ``StreamingEnhancer``:
    stream s plays ``waves[s % len(waves)]`` from hop ``s // len(waves)``
    on and starts again at its end, so no two streams carry the same
    samples at the same time."""
    out = np.empty((n_streams, n_hops, shift), np.int16)
    for s in range(n_streams):
        wave = np.asarray(waves[s % len(waves)], np.int16)
        period = len(wave) // shift
        rows = (s // len(waves) + np.arange(n_hops)) % period
        out[s] = wave[: period * shift].reshape(period, shift)[rows]
    return out
