"""tpu_se_torch command-line interface.

Commands (reference equivalents in parentheses):

- ``decode``  (decode.m + LPS2Wav_be): noisy wavs -> enhanced wavs, on
  ``--device cuda`` (default; fails without a card) or ``--device cpu``.
"""

from __future__ import annotations

import argparse
import sys


def _read_scp(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def cmd_decode(args) -> int:
    from tpu_se_torch.infer import decode_files

    wavs = _read_scp(args.scp) if args.scp else args.wav
    cleans = _read_scp(args.clean_scp) if args.clean_scp else None
    sample_rate = {8: 8000, 11: 11025, 16: 16000}[args.fs]
    decode_files(args.wts, args.norm, wavs, args.out_dir, cleans,
                 noisy_info=args.ni, batch_size=args.batch,
                 postprocess=args.postprocess, smooth=args.smooth,
                 smooth_strength=args.smooth_strength,
                 sample_rate=sample_rate, blend=args.blend,
                 device=args.device)
    return 0


def _blend_arg(text: str):
    return "auto" if text == "auto" else float(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_se_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("decode", help="noisy wavs -> enhanced wavs")
    s.add_argument("wav", nargs="*")
    s.add_argument("--scp")
    s.add_argument("--clean-scp", help="matching clean wavs for SegSNR/LSD")
    s.add_argument("--wts", required=True)
    s.add_argument("--norm", required=True)
    s.add_argument("--out-dir", default="enhanced")
    s.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails when no GPU is available) "
                        "or 'cpu'")
    s.add_argument("--ni", action="store_true",
                   help="also write noisy-baseline SegSNR/LSD to a "
                        "separate <input-name>.info file in --out-dir")
    s.add_argument("--batch", type=int, default=0,
                   help="decode this many utterances per device pass")
    s.add_argument("--postprocess", action="store_true",
                   help="bound max suppression vs the noisy LPS "
                        "(LogSpec2Wav.c:655-679)")
    s.add_argument("--smooth", action="store_true",
                   help="residual-noise running-min smoothing "
                        "(LogSpec2Wav.c:497-546)")
    s.add_argument("--smooth-strength", type=_blend_arg, default=None,
                   help="fractional smoothing (1.0 = the reference's "
                        "binary option, 0 = off) or 'auto' for the "
                        "impulsiveness-gated strength; non-zero implies "
                        "--smooth")
    s.add_argument("--blend", type=_blend_arg, default=0.0,
                   help="interpolate the enhanced LPS this fraction toward "
                        "the noisy LPS (log domain; 0 = reference decode.m "
                        "path), or 'auto' to adapt per utterance")
    s.add_argument("-fs", type=int, default=16, choices=[8, 11, 16],
                   help="sampling rate in kHz — the model's bin count "
                        "must match (129/129/257)")
    s.set_defaults(func=cmd_decode)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(sys.argv[1:] if argv is None else argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main())
