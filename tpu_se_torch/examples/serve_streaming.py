"""Minimal streaming-serving example: the round-5 quality config, live.

The twin of ``examples/serve_streaming.py`` on the port.  It shows the two
serving shapes of :class:`tpu_se_torch.infer.StreamingEnhancer` with the
quality decode (adaptive suppression limiter + impulsiveness-gated
smoothing, both as causal analogs -- PARITY.md section 4):

1. a single stream in chunks of any size (``feed``/``flush``), as a
   microphone callback would send them;
2. S batched channels on the int16 wire (``push_many``), as a serving
   deployment would batch them.

On the card every hop is one replay of a captured CUDA graph, with the
LPS kernel in it.  Usage::

    python -m tpu_se_torch.examples.serve_streaming [--wts W --norm N] \\
        [--out enhanced_stream.wav] [--device cuda|cpu] [noisy.wav]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from tpu_se_torch.infer import StreamingEnhancer
from tpu_se_torch.io import read_wav, write_wav

# Relative to the working directory, as tpu_se's --wts default is: the
# trained model's artifacts, and the reference tree (linked or copied
# beside the checkout) whose demo corpus holds the default wav.
DEFAULT_ROOT = "artifacts/ab_objectives/big_pt8"
DEFAULT_WAV = ("reference/Enh_demos/"
               "DestroyerEngine_SNR0_NOISY_TEST_DR3_FPKT0_SI1538.wav")
CHUNK = 1024          # samples per feed(); any size, the engine re-buffers
N_STREAMS = 4
CHUNK_HOPS = 8        # hops per push_many call


def serve(wav: str, wts: str, norm: str, out: str, device: str = "cuda",
          log=print) -> dict:
    """Both serving shapes over ``wav`` -> {"enhanced": the single
    stream's int16 output (also written to ``out``), "hops": hops pushed
    per channel in the batched shape, "warm_hops": warm outputs it
    emitted}."""
    noisy, sr = read_wav(wav)
    log(f"{os.path.basename(wav)}: {len(noisy) / sr:.1f} s @ {sr} Hz")

    # --- shape 1: single stream, arbitrary chunks (mic-callback style) ---
    s = StreamingEnhancer(wts, norm, sample_rate=sr, blend="auto",
                          smooth_strength="auto", device=device)
    log(f"algorithmic latency: {s.latency_samples / sr * 1e3:.0f} ms")
    pieces = [s.feed(noisy[i:i + CHUNK]) for i in range(0, len(noisy), CHUNK)]
    pieces.append(s.flush())
    enhanced = np.concatenate(pieces)
    write_wav(out, enhanced, sr)
    log(f"single stream: {len(enhanced)} samples -> {out}")

    # --- shape 2: S channels batched, int16 wire (serving style) ---------
    shift = s.frame_shift
    multi = StreamingEnhancer(wts, norm, n_streams=N_STREAMS,
                              sample_rate=sr, blend="auto",
                              smooth_strength="auto", device=device)
    n_hops = min(40, len(noisy) // shift - (N_STREAMS - 1))
    hops = np.stack([noisy[o: o + n_hops * shift]
                     for o in range(0, N_STREAMS * shift, shift)])
    hops = hops.reshape(N_STREAMS, n_hops, shift).astype(np.int16)
    total = 0
    for j in range(0, n_hops, CHUNK_HOPS):
        _, valid = multi.push_many(hops[:, j:j + CHUNK_HOPS], int16_wire=True)
        total += int(valid.sum()) * N_STREAMS
    log(f"{N_STREAMS} channels x {n_hops} hops pushed, "
        f"{total} warm hops emitted (int16 wire)")
    return {"enhanced": enhanced, "hops": n_hops, "warm_hops": total}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tpu_se_torch.examples.serve_streaming",
                                 description=__doc__.splitlines()[0])
    ap.add_argument("wav", nargs="?", default=DEFAULT_WAV)
    ap.add_argument("--wts", default=f"{DEFAULT_ROOT}/MLGGD1/mlp.50.wts")
    ap.add_argument("--norm", default=f"{DEFAULT_ROOT}/data/train_noisy.norm")
    ap.add_argument("--out", default="enhanced_stream.wav")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    serve(args.wav, args.wts, args.norm, args.out, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
