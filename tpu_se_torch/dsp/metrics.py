"""Objective quality metrics: segmental SNR and log-spectral distortion.

Numpy copy of ``tpu_se/dsp/metrics.py`` (which cannot be imported without
JAX), re-implementing the decode-time metrics of
``Test_code/SourceCode_LogSpec2Wav_be/LogSpec2Wav.c``:

- SegSNR (``:595-610,700-710``): per frame, ``10*log10(sum(clean^2) /
  sum((x - clean)^2))`` clamped to [-20, 30] dB, averaged; the enhanced
  side is the de-windowed per-frame reconstruction, not the OLA waveform.
- LSD (``:734-795``): Hamming-windowed power spectra, each floored at its
  own global max * 10^-5 (50 dB range); per-frame RMS of
  ``10*log10(P_x / P_clean)``, averaged.
"""

from __future__ import annotations

import numpy as np

from tpu_se_torch.dsp.analysis import frame_signal, hamming_window, rate_config

LOW_SEGSNR = -20.0
HIGH_SEGSNR = 30.0
DYN_RANGE_DB = 50.0


def segsnr(clean_frames: np.ndarray, test_frames: np.ndarray) -> float:
    """Mean clamped per-frame SNR; inputs are raw (un-windowed) [T, len]."""
    clean = np.asarray(clean_frames, dtype=np.float64)
    test = np.asarray(test_frames, dtype=np.float64)
    sig = (clean * clean).sum(axis=1)
    err = ((test - clean) ** 2).sum(axis=1)
    with np.errstate(divide="ignore", invalid="ignore"):
        snr = 10.0 * np.log10(sig / err)
    snr = np.clip(np.nan_to_num(snr, nan=HIGH_SEGSNR, posinf=HIGH_SEGSNR,
                                neginf=LOW_SEGSNR),
                  LOW_SEGSNR, HIGH_SEGSNR)
    return float(snr.mean())


def power_spectra(frames: np.ndarray) -> np.ndarray:
    """Raw frames [T, len] -> Hamming-windowed power spectra [T, len/2+1]."""
    frame_length = frames.shape[1]
    win = hamming_window(frame_length).astype(np.float64)
    spec = np.fft.rfft(np.asarray(frames, dtype=np.float64) * win[None, :],
                       n=frame_length, axis=-1)
    return (spec.real ** 2 + spec.imag ** 2).astype(np.float32)


def lsd(clean_power: np.ndarray, test_power: np.ndarray) -> float:
    """Mean per-frame log-spectral distortion with a 50 dB floor on each
    spectrogram (``LogSpec2Wav.c:757-788``); inputs are linear power."""
    def _floor(p):
        p = np.asarray(p, dtype=np.float64)
        return np.maximum(p, p.max() * 10.0 ** (-DYN_RANGE_DB / 10.0))

    pc, px = _floor(clean_power), _floor(test_power)
    diff = 10.0 * np.log10(px / pc)
    per_frame = np.sqrt((diff * diff).mean(axis=1))
    return float(per_frame.mean())


def segsnr_lsd_pair(clean_wave: np.ndarray, noisy_wave: np.ndarray,
                    recon_frames: np.ndarray, enhanced_power: np.ndarray,
                    sample_rate: int = 16000) -> dict:
    """The four decode metrics of one utterance, as ``info.txt`` reports them.

    ``recon_frames`` comes from ``reconstruct``/``Enhancer``;
    ``enhanced_power`` is the exp'd (floored) enhanced LPS [T, bins]
    (``LogSpec2Wav.c:565-571``).
    """
    frame_length, frame_shift, _ = rate_config(sample_rate)
    clean_frames = frame_signal(clean_wave, frame_length, frame_shift)
    noisy_frames = frame_signal(noisy_wave, frame_length, frame_shift)
    t = min(len(clean_frames), len(noisy_frames), len(recon_frames))
    clean_frames, noisy_frames = clean_frames[:t], noisy_frames[:t]
    p_clean = power_spectra(clean_frames)
    p_noisy = power_spectra(noisy_frames)
    return {
        "segsnr": segsnr(clean_frames, recon_frames[:t]),
        "segsnr_noisy": segsnr(clean_frames, noisy_frames),
        "lsd": lsd(p_clean, enhanced_power[:t]),
        "lsd_noisy": lsd(p_clean, p_noisy),
    }
