"""Objective quality scoring of waveform pairs: SegSNR, LSD, STOI, PESQ.

Port of ``tpu_se/infer/evaluate.py`` over the port's numpy ``frame_signal``
and ``dsp/metrics.py``: host-side numpy, the same operations, so the
scores equal ``tpu_se``'s.  SegSNR and LSD are the reference vocoder's
definitions (``LogSpec2Wav.c:595-610,734-795``); STOI and PESQ are the
native implementations in ``infer/stoi.py`` and ``infer/pesq.py``.
"""

from __future__ import annotations

import numpy as np

from tpu_se_torch.dsp.analysis import frame_signal
from tpu_se_torch.dsp.metrics import lsd, power_spectra, segsnr
from tpu_se_torch.infer.pesq import pesq
from tpu_se_torch.infer.stoi import stoi
from tpu_se_torch.io import read_wav

METRICS = ("segsnr", "lsd", "stoi", "pesq")


def score_pair(clean: np.ndarray, test: np.ndarray,
               fs: int = 16000) -> dict:
    """Score an enhanced (or degraded) waveform against its clean original
    -> ``{"segsnr", "lsd", "stoi", "pesq"}``, both cut to the shorter."""
    n = min(len(clean), len(test))
    clean, test = clean[:n], test[:n]
    cf, tf = frame_signal(clean), frame_signal(test)
    return {
        "segsnr": segsnr(cf, tf),
        "lsd": lsd(power_spectra(cf), power_spectra(tf)),
        "stoi": stoi(clean, test, fs),
        "pesq": pesq(clean, test, fs),
    }


def score_files(clean_paths: list, test_paths: list) -> list[dict]:
    """Score matching (clean, test) wav file pairs -> one dict per pair:
    the test file's name under ``"name"`` plus the four metrics.  Raises
    ``ValueError`` on a count or sampling-rate mismatch."""
    if len(clean_paths) != len(test_paths):
        raise ValueError(
            f"{len(clean_paths)} clean vs {len(test_paths)} test files")
    rows = []
    for cpath, tpath in zip(clean_paths, test_paths):
        clean, fs_c = read_wav(cpath)
        test, fs_t = read_wav(tpath)
        if fs_c != fs_t:
            raise ValueError(
                f"rate mismatch: {cpath} {fs_c} Hz vs {tpath} {fs_t} Hz")
        rows.append({"name": str(tpath),
                     **score_pair(np.asarray(clean), np.asarray(test), fs_c)})
    return rows
