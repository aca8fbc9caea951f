"""tpu_se_torch.dsp.synthesis/metrics against tpu_se on the CPU.

The same enhanced LPS and noisy wave go through both ``reconstruct``s:
int16 waves within 1 LSB (both sides truncate float32 OLA sums that
differ by rounding), recon frames within 1e-2 absolute (samples of up to
~1e4 in float32 FFTs), and the numpy metrics equal to 1e-9.
"""

import numpy as np
import pytest
import torch

from tpu_se.dsp import metrics as jax_metrics
from tpu_se.dsp import synthesis as jax_synthesis
from tpu_se_torch.dsp import analysis, metrics, synthesis


def _wave(n, seed):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    return (2500 * np.sin(2 * np.pi * 300 * t)
            + 700 * rng.standard_normal(n)).astype(np.int16)


def _enhanced_lps(wave, rate, seed):
    lps = analysis.wav_to_lps(wave, sample_rate=rate, device="cpu")
    rng = np.random.default_rng(seed)
    return (lps - np.abs(rng.normal(0.0, 1.0, lps.shape))).astype(np.float32)


@pytest.mark.parametrize("ola_kind", [1, 0])
@pytest.mark.parametrize("rate", [16000, 11025, 8000])
def test_reconstruct_matches_jax(rate, ola_kind):
    wave = _wave(7000 + rate // 100, seed=rate)
    lps = _enhanced_lps(wave, rate, seed=ola_kind)
    got_wave, got_recon = synthesis.reconstruct(lps, wave, rate, ola_kind,
                                                device="cpu")
    want_wave, want_recon = jax_synthesis.reconstruct(lps, wave, rate,
                                                      ola_kind)
    length, shift, _ = analysis.rate_config(rate)
    assert got_wave.dtype == np.int16
    assert len(got_wave) == len(want_wave) == (
        lps.shape[0] * shift + length - shift)
    assert np.abs(got_wave.astype(np.int32) - want_wave).max() <= 1
    np.testing.assert_allclose(got_recon, want_recon, rtol=0, atol=1e-2)


def test_synth_and_ola_batch_masks_padded_rows():
    """A padded batch gives each utterance exactly its own waveform."""
    waves = [_wave(4000, 1), _wave(6100, 2)]
    frames = [analysis.frame_signal(w) for w in waves]
    lps = [analysis.wav_to_lps(w, device="cpu") for w in waves]
    t_max = max(f.shape[0] for f in frames)
    fb = np.zeros((2, t_max, 512), np.float32)
    lb = np.full((2, t_max, 257), -50.0, np.float32)
    valid = np.zeros((2, t_max), np.float32)
    for i, (f, lp) in enumerate(zip(frames, lps)):
        fb[i, : len(f)], lb[i, : len(f)], valid[i, : len(f)] = f, lp, 1.0
    wave_b, recon_b = synthesis._synth_and_ola(
        torch.from_numpy(lb), torch.from_numpy(fb), torch.from_numpy(valid))
    for i, (f, lp) in enumerate(zip(frames, lps)):
        t = len(f)
        wave_1, recon_1 = synthesis._synth_and_ola(
            torch.from_numpy(lp), torch.from_numpy(f), torch.ones(t))
        torch.testing.assert_close(wave_b[i, : (t + 1) * 256], wave_1,
                                   rtol=1e-6, atol=1e-3)
        torch.testing.assert_close(recon_b[i, :t], recon_1, rtol=1e-6,
                                   atol=1e-3)


def test_reconstruct_rejects_mismatched_lps():
    wave = _wave(5000, 3)
    lps = analysis.wav_to_lps(wave, device="cpu")
    with pytest.raises(ValueError, match="noisy frames"):
        synthesis.reconstruct(lps[:-1], wave, device="cpu")
    with pytest.raises(ValueError, match="bins"):
        synthesis.reconstruct(lps[:, :129], wave, device="cpu")


@pytest.mark.parametrize("rate", [16000, 8000])
def test_metrics_match_jax(rate):
    clean, noisy = _wave(9000, 4), _wave(9000, 5)
    lps = _enhanced_lps(noisy, rate, seed=6)
    _, recon = jax_synthesis.reconstruct(lps, noisy, rate)
    power = np.exp(lps)
    got = metrics.segsnr_lsd_pair(clean, noisy, recon, power, rate)
    want = jax_metrics.segsnr_lsd_pair(clean, noisy, recon, power, rate)
    assert got.keys() == want.keys()
    for key in got:
        assert np.isfinite(got[key])
        assert abs(got[key] - want[key]) <= 1e-9, key
    frames = analysis.frame_signal(clean)
    np.testing.assert_array_equal(metrics.power_spectra(frames),
                                  jax_metrics.power_spectra(frames))
