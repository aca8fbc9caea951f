"""STOI (short-time objective intelligibility) — Taal et al. 2011.

A copy of ``tpu_se/infer/stoi.py`` (which cannot be imported without JAX),
the same numpy operations in the same order, so both packages give the
same scores bit for bit.

The paper behind the reference compares MMSE vs ML-GGD models with
PESQ/STOI (SURVEY.md §6); the repo itself ships no metric code.  This is a
self-contained numpy implementation of classic STOI for the decode-side
evaluation harness (PESQ's ITU reference implementation is not
redistributable; ``pesq_score`` below gates on an optional package).

Pipeline: resample to 10 kHz -> remove silent frames (40 dB below the
loudest clean frame, 256-sample Hann frames, hop 128) -> STFT (512-pt) ->
15 one-third-octave bands from 150 Hz -> 384 ms segments: normalized
correlation of clipped band envelopes, averaged.
"""

from __future__ import annotations

import numpy as np

FS = 10000
FRAME = 256
HOP = 128
NFFT = 512
NUM_BANDS = 15
MIN_FREQ = 150.0
SEG_LEN = 30          # frames per segment (384 ms)
DYN_RANGE = 40.0      # silent-frame threshold (dB)
BETA_CLIP = -15.0     # signal-to-distortion clip (dB)


def _resample_to_10k(x: np.ndarray, fs: int) -> np.ndarray:
    if fs == FS:
        return x.astype(np.float64)
    from scipy.signal import resample_poly
    from math import gcd
    g = gcd(FS, fs)
    return resample_poly(x.astype(np.float64), FS // g, fs // g)


def _frames(x: np.ndarray) -> np.ndarray:
    n = 1 + (len(x) - FRAME) // HOP if len(x) >= FRAME else 0
    idx = np.arange(FRAME)[None, :] + HOP * np.arange(n)[:, None]
    return x[idx]


def _remove_silent(clean: np.ndarray, other: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray]:
    win = np.hanning(FRAME + 2)[1:-1]
    cf = _frames(clean) * win
    of = _frames(other) * win
    energy = 20.0 * np.log10(np.linalg.norm(cf, axis=1) + 1e-12)
    mask = energy > energy.max() - DYN_RANGE
    # Reconstruct (overlap-add) the kept frames only, as the reference
    # algorithm does, then re-frame for the STFT.
    kept_c = cf[mask]
    kept_o = of[mask]
    n = len(kept_c)
    out_len = FRAME + (n - 1) * HOP
    c = np.zeros(out_len)
    o = np.zeros(out_len)
    for i in range(n):
        c[i * HOP: i * HOP + FRAME] += kept_c[i]
        o[i * HOP: i * HOP + FRAME] += kept_o[i]
    return c, o


def _third_octave_matrix() -> np.ndarray:
    """[NUM_BANDS, NFFT//2+1] binary band-membership matrix."""
    f = np.linspace(0, FS / 2, NFFT // 2 + 1)
    k = np.arange(NUM_BANDS, dtype=np.float64)
    cf = MIN_FREQ * 2.0 ** (k / 3.0)
    lo = MIN_FREQ * 2.0 ** ((2 * k - 1) / 6.0)
    hi = MIN_FREQ * 2.0 ** ((2 * k + 1) / 6.0)
    mat = np.zeros((NUM_BANDS, len(f)))
    for b in range(NUM_BANDS):
        i_lo = np.argmin((f - lo[b]) ** 2)
        i_hi = np.argmin((f - hi[b]) ** 2)
        mat[b, i_lo:i_hi] = 1.0
    del cf
    return mat


def _band_envelopes(x: np.ndarray) -> np.ndarray:
    win = np.hanning(FRAME + 2)[1:-1]
    frames = _frames(x) * win
    spec = np.fft.rfft(frames, NFFT, axis=1)
    power = np.abs(spec) ** 2
    return np.sqrt(power @ _third_octave_matrix().T)  # [T, bands]


def stoi(clean: np.ndarray, degraded: np.ndarray, fs: int = 16000) -> float:
    """Classic STOI in [~0, 1]; higher is more intelligible."""
    if len(clean) != len(degraded):
        n = min(len(clean), len(degraded))
        clean, degraded = clean[:n], degraded[:n]
    c = _resample_to_10k(np.asarray(clean, dtype=np.float64), fs)
    d = _resample_to_10k(np.asarray(degraded, dtype=np.float64), fs)
    c, d = _remove_silent(c, d)
    X = _band_envelopes(c)      # [T, bands]
    Y = _band_envelopes(d)
    t_total = X.shape[0]
    if t_total < SEG_LEN:
        raise ValueError("signal too short for STOI after silence removal")
    clip = 10.0 ** (-BETA_CLIP / 20.0)
    scores = []
    for m in range(SEG_LEN, t_total + 1):
        xs = X[m - SEG_LEN: m]          # [N, bands]
        ys = Y[m - SEG_LEN: m]
        norm = (np.linalg.norm(xs, axis=0, keepdims=True)
                / (np.linalg.norm(ys, axis=0, keepdims=True) + 1e-12))
        ys_n = np.minimum(ys * norm, xs * (1.0 + clip))
        xm = xs - xs.mean(axis=0, keepdims=True)
        ym = ys_n - ys_n.mean(axis=0, keepdims=True)
        num = (xm * ym).sum(axis=0)
        den = (np.linalg.norm(xm, axis=0) * np.linalg.norm(ym, axis=0) + 1e-12)
        scores.append(num / den)
    return float(np.mean(scores))


def pesq_score(clean: np.ndarray, degraded: np.ndarray,
               fs: int = 16000) -> float | None:
    """PESQ MOS-LQO.

    Prefers the ITU-certified optional ``pesq`` package; falls back to the
    native P.862 implementation in :mod:`tpu_se_torch.infer.pesq` (same
    algorithm structure, derived tables — see its module docstring).
    """
    try:
        from pesq import pesq as _pesq
        return float(_pesq(fs, np.asarray(clean, dtype=np.float64),
                           np.asarray(degraded, dtype=np.float64),
                           "wb" if fs == 16000 else "nb"))
    except ImportError:
        from tpu_se_torch.infer.pesq import pesq as _native
        return float(_native(clean, degraded, fs))
