"""tpu_se_torch.dsp.analysis against tpu_se.dsp.analysis on the CPU.

The numpy helpers are copies and must agree bit for bit.  The LPS is held
to atol 1e-3 in the log domain: the port sums the DFT product in float64,
JAX in float32, and a float32 sum misses the log power of a bin ~60 dB
below its frame by up to ~2e-4 on these inputs.  Floor rows (all-zero
frames) must be exactly -50 on both sides.

The dormant MFCC path: ``mel_filterbank`` and ``dct_matrix`` are numpy
copies and must be equal to the bit.  ``wav_to_mfcc`` is held to atol 1e-3:
a mel band sums 4-31 power bins, so the spectrum's float32 against float64
sums move its log by ~1e-6 relative to the band's strongest bin, and the
DCT sums 23 such logs of size ~20-30 in float32 (measured 1.2e-4).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_se.dsp import analysis as jax_analysis
from tpu_se.ops import lps_pallas
from tpu_se_torch.dsp import analysis

LPS_ATOL = 1e-3
RATES = [8000, 11025, 16000]


def _frames(rate, n_frames=45, seed=0):
    length = analysis.rate_config(rate)[0]
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((n_frames, length)) * 1000).astype(
        np.float32)
    frames[5::9] = 0.0                  # floor rows
    return frames


def _wave(n, seed=1):
    rng = np.random.default_rng(seed)
    t = np.arange(n) / 16000
    wave = (3000 * np.sin(2 * np.pi * 440 * t)
            + 800 * rng.standard_normal(n))
    return wave.astype(np.int16)


@pytest.mark.parametrize("rate", RATES)
def test_numpy_helpers_are_exact_copies(rate):
    assert analysis.rate_config(rate) == jax_analysis.rate_config(rate)
    length, shift, fft = analysis.rate_config(rate)
    np.testing.assert_array_equal(analysis.hamming_window(length),
                                  jax_analysis.hamming_window(length))
    np.testing.assert_array_equal(
        analysis._windowed_dft_basis(length, fft),
        jax_analysis._windowed_dft_basis(length, fft))
    wave = _wave(5000)
    for n in (0, length - 1, length, 5000):
        assert (analysis.num_frames(n, length, shift)
                == jax_analysis.num_frames(n, length, shift))
        np.testing.assert_array_equal(
            analysis.frame_signal(wave[:n], length, shift),
            jax_analysis.frame_signal(wave[:n], length, shift))


@pytest.mark.parametrize("method", ["matmul", "fft"])
@pytest.mark.parametrize("rate", RATES)
def test_lps_from_frames_matches_jax(rate, method):
    frames = _frames(rate)
    got = analysis.lps_from_frames(torch.from_numpy(frames),
                                   method=method).numpy()
    want = np.asarray(jax_analysis.lps_from_frames(jnp.asarray(frames),
                                                   method=method))
    assert got.shape == want.shape == (45, frames.shape[1] // 2 + 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=LPS_ATOL)
    np.testing.assert_array_equal(got[5::9], -50.0)
    np.testing.assert_array_equal(want[5::9], -50.0)


@pytest.mark.parametrize("n_frames", [1, 37, 300])
def test_lps_from_frames_matches_pallas_interpret(n_frames):
    """The TPU kernel itself (16 kHz only), run in interpret mode."""
    frames = _frames(16000, n_frames, seed=n_frames)
    got = analysis.lps_from_frames(torch.from_numpy(frames)).numpy()
    want = np.asarray(lps_pallas(jnp.asarray(frames), interpret=True))
    np.testing.assert_allclose(got, want, rtol=0, atol=LPS_ATOL)
    np.testing.assert_array_equal(got[5::9], -50.0)


@pytest.mark.parametrize("rate,win_size,n_samples", [
    (16000, 0, 16000 + 123), (16000, 2, 9000), (11025, 0, 7000),
    (8000, 1, 5000), (16000, 3, 1000), (16000, 0, 300),
])
def test_wav_to_lps_matches_jax(rate, win_size, n_samples):
    wave = _wave(n_samples, seed=n_samples)
    got = analysis.wav_to_lps(wave, win_size=win_size, sample_rate=rate,
                              device="cpu")
    want = jax_analysis.wav_to_lps(wave, win_size=win_size,
                                   sample_rate=rate)
    assert got.shape == want.shape
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=LPS_ATOL)


def test_mel_and_dct_matrices_are_exact_copies():
    for name in ("NUM_CHANNELS", "NUM_CEP_COEFF", "MEL_START_FREQ"):
        assert getattr(analysis, name) == getattr(jax_analysis, name)
    for kw in ({}, {"n_channels": 15, "sample_freq": 8000.0,
                    "fft_length": 256}):
        got = analysis.mel_filterbank(**kw)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, jax_analysis.mel_filterbank(**kw))
    assert analysis.mel_filterbank().shape == (257, 23)
    for args in ((), (8, 15)):
        np.testing.assert_array_equal(analysis.dct_matrix(*args),
                                      jax_analysis.dct_matrix(*args))
    assert analysis.dct_matrix().shape == (23, 13)


@pytest.mark.parametrize("n_samples", [16000 + 123, 3000, 768])
def test_wav_to_mfcc_matches_jax(n_samples):
    wave = _wave(n_samples, seed=n_samples)
    got = analysis.wav_to_mfcc(wave, device="cpu")
    want = jax_analysis.wav_to_mfcc(wave)
    assert got.dtype == np.float32
    assert got.shape == want.shape == (n_samples // 256 - 1, 13)
    np.testing.assert_allclose(got, want, rtol=0, atol=LPS_ATOL)
    frames = analysis.frame_signal(wave)
    frames[0] = 0.0                       # a silent frame: floored mel
    got = analysis.mfcc_from_frames(torch.from_numpy(frames)).numpy()
    want = np.asarray(jax_analysis.mfcc_from_frames(jnp.asarray(frames)))
    np.testing.assert_allclose(got, want, rtol=0, atol=LPS_ATOL)
    assert got[0, -1] == -50.0 * 23       # c0 = the plain sum of the logs


def test_wav_to_mfcc_empty_wave_and_bad_frames():
    for n in (0, 511):
        got = analysis.wav_to_mfcc(np.zeros(n, np.int16), device="cpu")
        assert got.shape == (0, 13) and got.dtype == np.float32
        assert jax_analysis.wav_to_mfcc(np.zeros(n, np.int16)).shape == (0, 13)
    with pytest.raises(ValueError, match="frames must be"):
        analysis.mfcc_from_frames(torch.zeros(3, 256))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            analysis.wav_to_mfcc(np.zeros(4000, np.int16))


def test_lps_from_frames_rejects_bad_input():
    with pytest.raises(ValueError, match="frames must be"):
        analysis.lps_from_frames(torch.zeros(3, 4, 512))
    with pytest.raises(ValueError, match="unknown method"):
        analysis.lps_from_frames(torch.zeros(3, 512), method="dct")
    with pytest.raises(ValueError, match="unsupported sampling rate"):
        analysis.rate_config(44100)
