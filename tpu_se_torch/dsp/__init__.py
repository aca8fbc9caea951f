"""DSP layer: LPS analysis, noisy-phase overlap-add synthesis, metrics."""

from tpu_se_torch.dsp.analysis import (
    FRAME_LENGTH, FRAME_SHIFT, FFT_LENGTH, NUM_BINS, LOG_FLOOR,
    RATE_CONFIGS, rate_config, hamming_window, dft_basis, num_frames,
    frame_signal, lps_from_frames, wav_to_lps,
    NUM_CHANNELS, NUM_CEP_COEFF, MEL_START_FREQ, mel_filterbank, dct_matrix,
    mfcc_from_frames, wav_to_mfcc,
)
from tpu_se_torch.dsp.synthesis import lps_to_wav, reconstruct
from tpu_se_torch.dsp.metrics import segsnr, lsd, power_spectra

__all__ = [
    "FRAME_LENGTH", "FRAME_SHIFT", "FFT_LENGTH", "NUM_BINS", "LOG_FLOOR",
    "RATE_CONFIGS", "rate_config", "hamming_window", "dft_basis",
    "num_frames", "frame_signal", "lps_from_frames", "wav_to_lps",
    "reconstruct", "lps_to_wav", "segsnr", "lsd", "power_spectra",
    "NUM_CHANNELS", "NUM_CEP_COEFF", "MEL_START_FREQ", "mel_filterbank",
    "dct_matrix", "mfcc_from_frames", "wav_to_mfcc",
]
