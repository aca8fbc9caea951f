"""LPS analysis front end: waveform -> log-power-spectrum frames.

Port of ``tpu_se/dsp/analysis.py``.  The numpy pieces (rate configs,
Hamming half-table, windowed-DFT basis, framing) are exact copies: the
card's machine has no JAX, so they cannot be imported from ``tpu_se``.
The reference semantics they encode (``Wav2LogSpec_be.c``):

- frame k covers samples [k*shift, k*shift+len); ``floor(N/shift) - 1``
  frames at 50 % overlap (``:401-416``);
- symmetric float32 Hamming half-table, mirrored (``FEfunc.c:80-87``);
- power of rfft bins 0..len/2, natural log floored at -50 (``:469-479``).

``lps_from_frames`` runs the windowed-DFT product with the fused
square/add/log epilogue: the hand-written kernel for CUDA tensors
(``tpu_se_torch.ops.lps_kernel``), its plain PyTorch version for CPU ones.

The dormant ETSI mel/cepstral path (``mel_filterbank``, ``dct_matrix``,
``mfcc_from_frames``, ``wav_to_mfcc``) is here with the status it has in the
reference: available, unused by the LPS pipeline.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from tpu_se_torch.ops.lps_kernel import (
    LOG_FLOOR, floored_log, lps_cuda, lps_plain,
)
from tpu_se_torch.utils.device import resolve_device

__all__ = [
    "FRAME_LENGTH", "FRAME_SHIFT", "FFT_LENGTH", "NUM_BINS", "LOG_FLOOR",
    "RATE_CONFIGS", "rate_config", "hamming_window", "dft_basis",
    "num_frames", "frame_signal", "lps_from_frames", "wav_to_lps",
    "NUM_CHANNELS", "NUM_CEP_COEFF", "MEL_START_FREQ", "mel_filterbank",
    "dct_matrix", "mfcc_from_frames", "wav_to_mfcc",
]

FRAME_LENGTH = 512
FRAME_SHIFT = 256
FFT_LENGTH = 512
NUM_BINS = FFT_LENGTH // 2 + 1  # 257

# sample_rate -> (frame_length, frame_shift, fft_length)
# (Wav2LogSpec_be.c:37-59); the pipeline runs at 16 kHz.
RATE_CONFIGS = {
    8000: (256, 128, 256),
    11000: (256, 110, 256),
    16000: (512, 256, 512),
}


def rate_config(sample_rate: int) -> tuple[int, int, int]:
    """(frame_length, frame_shift, fft_length) for a sampling rate.

    11025 Hz maps to the 11 kHz config like the reference's
    ``10*floor(1e6/sampPeriod)`` header math (``Wav2LogSpec_be.c:333``).
    """
    sr = 11000 if sample_rate == 11025 else sample_rate
    if sr not in RATE_CONFIGS:
        raise ValueError(f"unsupported sampling rate {sample_rate}; "
                         f"supported: {sorted(RATE_CONFIGS)} (+11025)")
    return RATE_CONFIGS[sr]


@functools.lru_cache(maxsize=None)
def hamming_window(length: int = FRAME_LENGTH) -> np.ndarray:
    """Symmetric float32 Hamming window, exactly as the reference builds it:
    a float32 half-table computed in double precision, then mirrored
    (``FEfunc.c:80-87``), so w[len-1-i] == w[i] bit for bit."""
    half = np.array(
        [0.54 - 0.46 * np.cos(2.0 * np.pi * i / (length - 1))
         for i in range(length // 2)],
        dtype=np.float32,
    )
    return np.concatenate([half, half[::-1]])


@functools.lru_cache(maxsize=None)
def _windowed_dft_basis(frame_length: int = FRAME_LENGTH,
                        fft_length: int = FFT_LENGTH) -> np.ndarray:
    """[frame_length, 2*bins] basis: the window folded into the real DFT.

    Column k      (k < bins): w[n] *  cos(2*pi*n*k/N)
    Column bins+k (k < bins): w[n] * -sin(2*pi*n*k/N)

    Built in float64, then cast to float32.
    """
    n = np.arange(frame_length)[:, None].astype(np.float64)
    k = np.arange(fft_length // 2 + 1)[None, :].astype(np.float64)
    ang = 2.0 * np.pi * n * k / fft_length
    w = hamming_window(frame_length).astype(np.float64)[:, None]
    basis = np.concatenate([w * np.cos(ang), w * -np.sin(ang)], axis=1)
    return basis.astype(np.float32)


def dft_basis(frame_length: int, device) -> torch.Tensor:
    """The windowed-DFT basis [len, 2*(len/2+1)] as a tensor on ``device``."""
    return torch.from_numpy(
        _windowed_dft_basis(frame_length, frame_length)).to(device)


@functools.lru_cache(maxsize=None)
def _resident_basis(frame_length: int, device: torch.device) -> torch.Tensor:
    """One ``dft_basis`` per (frame length, device), kept for the life of
    the process: a caller that passes no basis (``wav_to_lps``, once per
    file of ``lps-extract``) then uploads the 1 MB matrix once, not per
    call.  Read-only: every such caller shares it."""
    return dft_basis(frame_length, device)


def num_frames(n_samples: int, frame_length: int = FRAME_LENGTH,
               frame_shift: int = FRAME_SHIFT) -> int:
    """Frames emitted by the reference front end for an n-sample waveform
    (``Wav2LogSpec_be.c:401-416``)."""
    return max(0, (n_samples - (frame_length - frame_shift)) // frame_shift)


def frame_signal(wave: np.ndarray, frame_length: int = FRAME_LENGTH,
                 frame_shift: int = FRAME_SHIFT) -> np.ndarray:
    """int16/float waveform [N] -> float32 frames [T, len]."""
    wave = np.asarray(wave)
    t = num_frames(len(wave), frame_length, frame_shift)
    if t == 0:
        return np.zeros((0, frame_length), dtype=np.float32)
    strided = np.lib.stride_tricks.sliding_window_view(
        wave[: (t - 1) * frame_shift + frame_length], frame_length
    )[::frame_shift]
    return strided.astype(np.float32)


def lps_from_frames(frames: torch.Tensor, method: str = "matmul",
                    basis: torch.Tensor | None = None) -> torch.Tensor:
    """float32 frames [T, L] -> log-power spectrum [T, L/2+1], on their device.

    ``method='matmul'`` (default): the windowed-DFT product with the fused
    epilogue -- ``lps_cuda`` for a CUDA tensor, ``lps_plain`` for a CPU one.
    ``basis`` is that product's [L, 2K] matrix (default: one kept per frame
    length and device).
    ``method='fft'``: ``torch.fft.rfft`` of the windowed frames, the same
    math on another schedule, kept as a cross-check.
    """
    if frames.dim() != 2:
        raise ValueError(f"frames must be [T, L], got {tuple(frames.shape)}")
    frames = frames.to(torch.float32)
    frame_length = frames.shape[1]
    if method == "matmul":
        if basis is None:
            basis = _resident_basis(frame_length, frames.device)
        if frames.device.type == "cuda":
            return lps_cuda(frames.contiguous(), basis.contiguous())
        if frames.device.type == "cpu":
            return lps_plain(frames, basis)
        raise ValueError(f"no LPS path for device {frames.device}")
    if method == "fft":
        win = torch.from_numpy(hamming_window(frame_length)).to(frames.device)
        spec = torch.fft.rfft(frames * win, n=frame_length, dim=-1)
        return floored_log(spec.real ** 2 + spec.imag ** 2)
    raise ValueError(f"unknown method {method!r}")


def wav_to_lps(wave: np.ndarray, method: str = "matmul",
               win_size: int = 0, sample_rate: int = 16000,
               device="cuda") -> np.ndarray:
    """Waveform (int16 samples) -> float32 LPS [T, bins*(2*win_size+1)].

    The ``Wav2LPS_be`` CLI end to end (``Wav2LogSpec_be.c:280-618``), run
    on ``device``.  ``win_size`` is its ``-win`` option: each row stacks
    2*win_size+1 consecutive frames and the frame count drops by
    2*win_size (``:513-542,575``).  ``sample_rate`` selects the per-rate
    framing (``:340-366``).
    """
    device = resolve_device(device)
    frame_length, frame_shift, fft_length = rate_config(sample_rate)
    n_bins = fft_length // 2 + 1
    frames = frame_signal(wave, frame_length, frame_shift)
    t = frames.shape[0]
    if t == 0:
        return np.zeros((0, n_bins * (2 * win_size + 1)), dtype=np.float32)
    out = lps_from_frames(torch.from_numpy(frames).to(device),
                          method=method).cpu().numpy()
    if win_size == 0:
        return out
    stack = 2 * win_size + 1
    if t < stack:
        return np.zeros((0, n_bins * stack), dtype=np.float32)
    cols = [out[i: t - stack + 1 + i] for i in range(stack)]
    return np.concatenate(cols, axis=1)


# --- Dormant ETSI mel/cepstral path -----------------------------------------
#
# The reference front end carries the ETSI Aurora mel-filterbank + DCT
# machinery but ships with it commented out of the frame loop
# (``Wav2LogSpec_be.c:480-505``; kernels ``FEfunc.c:472-739``).  As in
# ``tpu_se`` the chain power -> mel -> log -> DCT is three matrix products;
# the two matrices are numpy copies, equal to ``tpu_se.dsp``'s to the bit.

NUM_CHANNELS = 23      # Wav2LogSpec_be.c:62
NUM_CEP_COEFF = 13     # c1..c12 + c0, Wav2LogSpec_be.c:67
MEL_START_FREQ = 64.0  # Wav2LogSpec_be.c:63-65 (all rates use 64 Hz)


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + f / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (m / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_channels: int = NUM_CHANNELS,
                   start_freq: float = MEL_START_FREQ,
                   sample_freq: float = 16000.0,
                   fft_length: int = FFT_LENGTH) -> np.ndarray:
    """[NUM_BINS, n_channels] triangular mel filterbank as a dense matrix.

    Reproduces ``InitFFTWindows`` + ``ComputeTriangle`` (``FEfunc.c:472-604``)
    exactly: band i spans mel fractions i/(C+1) .. (i+2)/(C+1) of
    [mel(start), mel(fs/2)], edges snapped to FFT bins by round(), lower
    slope (j+1)/low_len, upper slope (high_len-j)/high_len -- applied to the
    power spectrum by ``power @ mel_filterbank()``.
    """
    n_bins = fft_length // 2 + 1
    start_mel = _hz_to_mel(start_freq)
    top_mel = _hz_to_mel(sample_freq / 2.0)

    def edge_bin(i):
        freq = _mel_to_hz(start_mel + i / (n_channels + 1)
                          * (top_mel - start_mel))
        return int(fft_length * freq / sample_freq + 0.5)

    starts = [edge_bin(i) for i in range(n_channels)]
    uppers = [edge_bin(i + 2) for i in range(n_channels)]
    fb = np.zeros((n_bins, n_channels), dtype=np.float32)
    for i in range(n_channels):
        start, upper = starts[i], uppers[i]
        # The low part ends at the NEXT band's start (the previous band's
        # upper edge for the last channel): ComputeTriangle,
        # FEfunc.c:573-604.
        low_end = starts[i + 1] if i + 1 < n_channels else uppers[i - 1]
        low_len = low_end - start + 1
        high_len = (upper - start + 1) - low_len + 1
        for j in range(low_len):
            fb[start + j, i] = (j + 1) / low_len
        for j in range(1, high_len):
            fb[start + low_len + j - 1, i] = (high_len - j) / high_len
    return fb


@functools.lru_cache(maxsize=None)
def dct_matrix(n_cep: int = NUM_CEP_COEFF,
               n_channels: int = NUM_CHANNELS) -> np.ndarray:
    """[n_channels, n_cep] DCT basis in the reference's output order.

    ``InitDCTMatrix``/``DCT`` (``FEfunc.c:674-739``): columns are c1..c12
    (cos(pi*i/C*(j+0.5))) followed by c0 (plain sum) LAST.
    """
    mx = np.zeros((n_channels, n_cep), dtype=np.float32)
    j = np.arange(n_channels)
    for i in range(1, n_cep):
        mx[:, i - 1] = np.cos(np.pi * i / n_channels * (j + 0.5))
    mx[:, n_cep - 1] = 1.0
    return mx


def mfcc_from_frames(frames: torch.Tensor) -> torch.Tensor:
    """float32 frames [T, 512] -> [T, 13] cepstra (c1..c12, c0), on the
    frames' device.

    The dormant reference chain (``Wav2LogSpec_be.c:480-505``): power
    spectrum -> mel filterbank -> natural log with the e^-50 floor
    (``ENERGYFLOOR_FB``) -> DCT.  The spectrum comes from the product that
    ``lps_plain`` uses (float64 sums, re and im rounded to float32): the
    LPS kernel writes log power only.  The two small products are float32.
    """
    if frames.dim() != 2 or frames.shape[1] != FRAME_LENGTH:
        raise ValueError(f"frames must be [T, {FRAME_LENGTH}], got "
                         f"{tuple(frames.shape)}")
    frames = frames.to(torch.float32)
    device = frames.device
    basis = _resident_basis(FRAME_LENGTH, device)
    spec = (frames.double() @ basis.double()).float()
    re, im = spec[:, :NUM_BINS], spec[:, NUM_BINS:]
    mel = (re * re + im * im) @ torch.from_numpy(mel_filterbank()).to(device)
    return floored_log(mel) @ torch.from_numpy(dct_matrix()).to(device)


def wav_to_mfcc(wave: np.ndarray, device="cuda") -> np.ndarray:
    """Waveform -> [T, 13] MFCC via the dormant ETSI path, on ``device``."""
    device = resolve_device(device)
    frames = frame_signal(wave)
    if frames.shape[0] == 0:
        return np.zeros((0, NUM_CEP_COEFF), dtype=np.float32)
    return mfcc_from_frames(torch.from_numpy(frames).to(device)).cpu().numpy()
