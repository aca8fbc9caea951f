"""Waveform synthesis: enhanced LPS + noisy phase -> time-domain waveform.

Port of ``tpu_se/dsp/synthesis.py``; reference semantics
(``Test_code/SourceCode_LogSpec2Wav_be/LogSpec2Wav.c``):

- the enhanced LPS is exponentiated with the analysis floor:
  power = LPS < -50 ? e^-50 : exp(LPS) (``:481-495``);
- each noisy frame is Hamming-windowed and transformed; every bin is scaled
  to magnitude sqrt(power), keeping the noisy phase (``:682-691``);
- the inverse transform is windowed again (OLA_KIND 1, ``:712-713``),
  overlap-added and divided by the summed squared window (``:798-827``),
  then truncated to int16 (``:829``).

``torch.fft`` stands in for ``jnp.fft`` (which the JAX package also runs
outside any Pallas kernel); ``irfft`` divides by N like the reference's
``rifft`` (``FEfunc.c:453-455``).  Every function takes leading batch
dimensions, so a padded batch of utterances is one call.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from tpu_se_torch.dsp.analysis import (
    LOG_FLOOR, frame_signal, hamming_window, rate_config,
)
from tpu_se_torch.ops.lps_kernel import POWER_FLOOR
from tpu_se_torch.utils.device import resolve_device


def _segment_sum(rows: torch.Tensor, frame_shift: int) -> torch.Tensor:
    """[..., T, len] rows overlap-added at ``frame_shift`` -> [..., S].

    A sum over ceil(len/shift) shift-sized hops with zero-padded columns,
    so any (len, shift) works (16 kHz: 2 hops; 11 kHz: 3).
    """
    frame_length = rows.shape[-1]
    n_hops = -(-frame_length // frame_shift)
    rows = F.pad(rows, (0, n_hops * frame_shift - frame_length))
    chunks = rows.reshape(*rows.shape[:-1], n_hops, frame_shift)
    acc = 0
    for j in range(n_hops):
        acc = acc + F.pad(chunks[..., j, :], (0, 0, j, n_hops - 1 - j))
    return acc.flatten(-2)


def _synth_and_ola(lps_enh: torch.Tensor, noisy_frames: torch.Tensor,
                   valid: torch.Tensor, frame_shift: int = 256,
                   ola_kind: int = 1, window: torch.Tensor | None = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """[..., T, bins] LPS + [..., T, len] noisy frames + [..., T] 0/1 mask
    -> (OLA waveform [..., (T + hops - 1) * shift], de-windowed recon
    frames [..., T, len]).

    Rows with ``valid == 0`` contribute nothing to either OLA accumulator.
    ``ola_kind`` mirrors the reference's compile-time ``OLA_KIND``
    (``LogSpec2Wav.c:72,712-715,810-819``): 1 re-windows and divides by
    the summed squared window; 0 de-windows and divides by the overlap count.
    ``window`` is ``hamming_window(len)`` already on the frames' device
    (built here when omitted); constants stay Python scalars, so a decode
    on the card makes no host-to-device copy that would synchronise.
    """
    frame_length = noisy_frames.shape[-1]
    win = window if window is not None else torch.from_numpy(
        hamming_window(frame_length)).to(noisy_frames.device)
    spec = torch.fft.rfft(noisy_frames * win, n=frame_length, dim=-1)
    power = torch.where(lps_enh < LOG_FLOOR, POWER_FLOOR, torch.exp(lps_enh))
    mag = spec.abs()
    scale = torch.where(mag > 0.0,
                        torch.sqrt(power) / torch.clamp(mag, min=1e-30), 0.0)
    synth = torch.fft.irfft(spec * scale, n=frame_length, dim=-1)

    valid = valid.to(synth.dtype)[..., None]
    if ola_kind == 1:
        sw = synth * win * valid
        w2 = win * win * valid
    else:
        sw = synth / win * valid
        w2 = torch.ones_like(win) * valid
    wave = (_segment_sum(sw, frame_shift)
            / torch.clamp(_segment_sum(w2, frame_shift), min=1e-20))
    return wave, synth / win


def reconstruct(lps_enh: np.ndarray, noisy_wave: np.ndarray,
                sample_rate: int = 16000, ola_kind: int = 1,
                device="cuda") -> tuple[np.ndarray, np.ndarray]:
    """Enhanced LPS [T, bins] + noisy waveform -> (int16 wave, recon frames).

    ``recon frames`` [T, len] is the de-windowed per-frame reconstruction
    the reference scores SegSNR on (``DeWindow``, ``LogSpec2Wav.c:693-698``).
    The wave has ``T*shift + (len-shift)`` samples (``:798``), truncated
    toward zero like the C ``(short)`` cast.
    """
    device = resolve_device(device)
    frame_length, frame_shift, fft_length = rate_config(sample_rate)
    n_bins = fft_length // 2 + 1
    noisy_frames = frame_signal(noisy_wave, frame_length, frame_shift)
    t = noisy_frames.shape[0]
    if lps_enh.shape[0] != t:
        raise ValueError(
            f"LPS frames ({lps_enh.shape[0]}) != noisy frames ({t})")
    if lps_enh.shape[1] != n_bins:
        raise ValueError(f"expected {n_bins} bins, got {lps_enh.shape[1]}")
    wave, recon = _synth_and_ola(
        torch.from_numpy(np.ascontiguousarray(lps_enh, np.float32)).to(device),
        torch.from_numpy(noisy_frames).to(device),
        torch.ones(t, device=device), frame_shift, ola_kind)
    wave = wave.cpu().numpy()[: t * frame_shift + (frame_length - frame_shift)]
    return np.trunc(wave).astype(np.int16), recon.cpu().numpy()


def lps_to_wav(lps_enh: np.ndarray, noisy_wave: np.ndarray,
               sample_rate: int = 16000, device="cuda") -> np.ndarray:
    """``reconstruct``'s int16 waveform alone."""
    return reconstruct(lps_enh, noisy_wave, sample_rate, device=device)[0]
