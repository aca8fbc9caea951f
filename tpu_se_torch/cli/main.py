"""tpu_se_torch command-line interface.

Commands (reference equivalents in parentheses):

- ``gen-rand-net`` (Gen_rand_net): random-init ``.wts``.
- ``train``   (finetune.pl + BPtrain): the full training schedule on a
  noisy/clean pfile pair, on ``--device cuda`` (default; fails without a
  card) or ``--device cpu``.
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


def cmd_gen_rand_net(args) -> int:
    from tpu_se_torch.io import write_wts
    from tpu_se_torch.models import init_params

    sizes = tuple(int(s) for s in args.layersizes.split(","))
    write_wts(args.out, init_params(args.seed, sizes, flag=args.flag,
                                    beta=args.beta))
    print(f"layersizes {sizes} flag={args.flag} beta={args.beta} -> {args.out}")
    return 0


def cmd_train(args) -> int:
    from tpu_se_torch.train import TrainConfig, run_training

    cfg = TrainConfig(
        fea_file=args.fea_file, targ_file=args.targ_file,
        norm_file=args.norm_file, init_wts_file=args.init_wts,
        out_dir=args.out_dir,
        layersizes=tuple(int(s) for s in args.layersizes.split(",")),
        bunchsize=args.bunchsize, ml_flag=bool(args.ml_flag),
        shapefactor=args.shapefactor, momentum=args.momentum,
        weightcost=args.weightcost, lrate=args.lrate,
        fea_dim=args.fea_dim, fea_context=args.fea_context,
        traincache=args.traincache, init_seed=args.seed,
        targ_offset=args.targ_offset,
        train_sent_range=tuple(int(s) for s in args.train_sents.split("-")),
        cv_sent_range=tuple(int(s) for s in args.cv_sents.split("-")),
        epochs=args.epochs, grad_scale=args.grad_scale,
        carry_velocity=args.carry_velocity,
        activation=args.activation,
        dropout_flag=bool(args.dropoutflag),
        visible_omit=args.visible_omit, hid_omit=args.hid_omit,
        checkpoint_every_chunks=args.checkpoint_every_chunks,
    )
    if args.init_ranges:
        vals = tuple(float(x) for x in args.init_ranges.split(","))
        if len(vals) != 4:
            raise SystemExit("--init-ranges wants w_min,w_max,b_min,b_max")
        cfg.init_ranges = vals
    last = run_training(cfg, args.device)
    print(f"final weights: {last}")
    return 0


def _blend_arg(text: str):
    return "auto" if text == "auto" else float(text)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="tpu_se_torch", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("gen-rand-net", help="random-init .wts")
    s.add_argument("--layersizes", default="1799,2048,2048,2048,257")
    s.add_argument("--flag", type=int, default=1)
    s.add_argument("--beta", type=float, default=2.0)
    s.add_argument("--seed", type=int, default=27870775)
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(func=cmd_gen_rand_net)

    s = sub.add_parser("train", help="full training schedule")
    s.add_argument("--fea-file", required=True)
    s.add_argument("--targ-file", required=True)
    s.add_argument("--norm-file", required=True)
    s.add_argument("--init-wts", default="")
    s.add_argument("--out-dir", default="mlp_out")
    s.add_argument("--layersizes", default="1799,2048,2048,2048,257")
    s.add_argument("--bunchsize", type=int, default=128)
    s.add_argument("--ml-flag", type=int, default=1)
    s.add_argument("--shapefactor", type=float, default=1.0)
    s.add_argument("--momentum", type=float, default=0.9)
    s.add_argument("--weightcost", type=float, default=1e-5)
    s.add_argument("--lrate", type=float, default=0.1)
    s.add_argument("--fea-dim", type=int, default=257)
    s.add_argument("--fea-context", type=int, default=7)
    s.add_argument("--traincache", type=int, default=102400)
    s.add_argument("--seed", type=int, default=27870775)
    s.add_argument("--targ-offset", type=int, default=3)
    s.add_argument("--train-sents", default="0-7")
    s.add_argument("--cv-sents", default="8-9")
    s.add_argument("--epochs", type=int, default=50)
    s.add_argument("--grad-scale", default="parity",
                   choices=["parity", "natural"])
    s.add_argument("--carry-velocity", action="store_true")
    s.add_argument("--init-ranges", default="",
                   metavar="W_MIN,W_MAX,B_MIN,B_MAX",
                   help="plain uniform random init when no --init-wts "
                        "(init_randem_* keys, Interface.cc:140-143); "
                        "reference defaults -0.1,0.1,-0.1,0.1")
    s.add_argument("--checkpoint-every-chunks", type=int, default=0,
                   help="write a mid-epoch partial checkpoint every N "
                        "chunks (0 = epoch-granular only, like the "
                        "reference)")
    s.add_argument("--activation", default="sigmoid",
                   choices=["sigmoid", "relu"])
    s.add_argument("--dropoutflag", type=int, default=0)
    s.add_argument("--visible-omit", type=float, default=0.1)
    s.add_argument("--hid-omit", type=float, default=0.1)
    s.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails when no GPU is available) "
                        "or 'cpu'")
    s.set_defaults(func=cmd_train)

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
