"""tpu_se_torch command-line interface.

Commands (reference equivalents in parentheses), each the port of its
``tpu_se`` namesake with the same flags and output:

- ``lps-extract``  (LPS_extract.m + Wav2LPS_be): wavs -> big-endian HTK
  ``.lps``, on ``--device cuda`` (default; fails without a card) or
  ``--device cpu``.
- ``make-pfile``   (pfile_noisy.pl + feacat): ``.lps`` list -> pfile.
- ``concat-pfile`` (pfile_concat): merge pfiles.
- ``get-norm``     (get_norm.pl + qnnorm): pfile -> ``.norm``.
- ``pfile-info``   (pfile_info), ``wts-info``: inspect pfiles and ``.wts``.
- ``eval``         score wav pairs with SegSNR/LSD/STOI/PESQ.
- ``gen-rand-net`` (Gen_rand_net): random-init ``.wts``.
- ``train``        (finetune.pl + BPtrain): the full training schedule on a
  noisy/clean pfile pair, on ``--device cuda`` (default) or ``cpu``.
- ``bptrain``      (BPtrain_Sigmoid): the key=value single-epoch front end
  (``tpu_se_torch.cli.bptrain``), ``device=cuda`` (default) or ``cpu``.
- ``decode``       (decode.m + LPS2Wav_be): noisy wavs -> enhanced wavs, on
  ``--device cuda`` (default) or ``cpu``.
"""

from __future__ import annotations

import argparse
import os
import sys


def _read_scp(path: str) -> list[str]:
    with open(path) as f:
        return [line.strip() for line in f if line.strip()]


def cmd_lps_extract(args) -> int:
    """Wav2LPS_be over a list of wavs, one ``.lps`` per input.

    With ``--jobs`` only the file reads run ahead on a thread pool: the LPS
    (one kernel launch per file on the card), the ``.lps`` write and the
    printed line stay in the calling thread, in scp order, so the output
    equals a serial run's and one thread issues all the device work.
    """
    from tpu_se_torch.dsp import wav_to_lps
    from tpu_se_torch.io import (
        ordered_readahead, read_htk_waveform, read_raw, read_wav, write_htk,
    )
    from tpu_se_torch.utils import resolve_device

    device = resolve_device(args.device)
    wavs = _read_scp(args.scp) if args.scp else args.wav

    def read(path: str):
        if args.format == "RAW":
            return read_raw(path, swap=args.swap), args.fs * 1000
        if args.format == "HTK":
            return read_htk_waveform(path)
        return read_wav(path)          # WAV: RIFF or NIST, by magic

    for path, (wave, sr) in zip(wavs, ordered_readahead(wavs, read,
                                                        args.jobs)):
        lps = wav_to_lps(wave, win_size=args.win, sample_rate=sr,
                         device=device)
        out = args.out if args.out and len(wavs) == 1 else (
            path.rsplit(".", 1)[0] + ".lps")
        # sampPeriod 160000 at every rate, as the reference hardcodes it
        # (Wav2LogSpec_be.c:371).
        write_htk(out, lps, samp_period=160000 * (2 * args.win + 1),
                  no_header=args.noh)
        print(f"{path}: {lps.shape[0]} frames -> {out}")
    return 0


def cmd_make_pfile(args) -> int:
    """feacat: ``.lps`` list -> pfile, streaming through ``PfileWriter``;
    with ``--jobs`` the HTK reads run ahead while the writer takes them in
    scp order."""
    from tpu_se_torch.io import PfileWriter, ordered_readahead, read_htk

    paths = _read_scp(args.scp)
    desired = None
    if args.deslenfile:
        desired = [int(line) for line in _read_scp(args.deslenfile)]
        if len(desired) != len(paths):
            raise SystemExit("deslenfile/scp count mismatch")

    lengths = []
    with PfileWriter(args.out) as w:
        utts = ordered_readahead(paths, lambda p: read_htk(p)[0], args.jobs)
        for i, (p, u) in enumerate(zip(paths, utts)):
            t = u.shape[0]
            # GetLenForFeaScp.pl:57-67: < 300 ms or > 30 s at the 16 ms
            # frame shift is implausible.
            if t < 300 // 16:
                print(f"warning: {p}: only {t} frames (< 300 ms)",
                      file=sys.stderr)
            elif t > 30000 // 16:
                print(f"warning: {p}: {t} frames (> 30 s)", file=sys.stderr)
            lengths.append(t)          # the .lps's own count, untruncated
            if desired is not None:
                u = u[:desired[i]]
            w.add(u)
        n_sents, n_frames = w.num_sentences, w.num_frames
    # Printed only once close() has renamed the file into place.
    print(f"{n_sents} sentences, {n_frames} frames -> {args.out}")
    if args.lenfile:
        with open(args.lenfile, "w") as f:
            for t in lengths:
                f.write(f"{t}\n")
    return 0


def cmd_concat_pfile(args) -> int:
    from tpu_se_torch.io import concat_pfiles, read_pfile_meta

    concat_pfiles(args.out, args.pfile)
    n_sents, n_frames, dim, _ = read_pfile_meta(args.out)
    print(f"{n_sents} sentences, {n_frames} frames x {dim} -> {args.out}")
    return 0


def cmd_get_norm(args) -> int:
    from tpu_se_torch.io import compute_norm_pfile, read_pfile_meta, write_norm

    mean, inv_std = compute_norm_pfile(args.pfile)
    write_norm(args.out, mean, inv_std, with_headers=not args.no_headers)
    _, n_frames, dim, _ = read_pfile_meta(args.pfile)
    print(f"{n_frames} frames x {dim} dims -> {args.out}")
    return 0


def cmd_pfile_info(args) -> int:
    # QuickNet's pfile_info: the header's counts and, with --sents, the
    # sentence lengths from the cumulative table.
    import numpy as np

    from tpu_se_torch.io import read_pfile_meta

    for path in args.pfile:
        n_sents, n_frames, dim, ends = read_pfile_meta(path)
        print(f"{path}: {n_sents} sentences, {n_frames} frames, "
              f"{dim} features")
        if args.sents:
            for i, t in enumerate(np.diff(np.concatenate([[0], ends]))):
                print(f"  sentence {i}: {t} frames")
    return 0


def cmd_wts_info(args) -> int:
    from tpu_se_torch.io import read_wts

    for path in args.wts:
        total = 0
        print(path + ":")
        for i, layer in enumerate(read_wts(path)):
            for key, name in (("w", f"weights{i+1}{i+2}"),
                              ("b", f"bias{i+2}")):
                data = layer[key].reshape(layer[key].shape[0], -1)
                total += data.size
                rms = float((data.astype("float64") ** 2).mean()) ** 0.5
                shape = " x ".join(map(str, layer[key].shape))
                print(f"  {name:12s} [{shape:>12s}]"
                      f"  min {data.min():+.6f}  max {data.max():+.6f}"
                      f"  rms {rms:.6f}")
        print(f"  total: {total} parameters "
              f"({total * 4 / 1e6:.1f} MB float32)")
    return 0


def cmd_eval(args) -> int:
    import json

    from tpu_se_torch.infer.evaluate import METRICS, score_files

    cleans = _read_scp(args.clean_scp) if args.clean_scp else args.clean
    tests = _read_scp(args.test_scp) if args.test_scp else args.test
    if not cleans or not tests:
        raise SystemExit("eval: give matching --clean/--test wavs "
                         "(or --clean-scp/--test-scp lists)")
    try:
        rows = score_files(cleans, tests)
    except ValueError as e:
        raise SystemExit(f"eval: {e}")
    if args.json:
        for row in rows:
            print(json.dumps(row))
    else:
        print(f"{'file':40s} {'SegSNR':>8s} {'LSD':>8s} "
              f"{'STOI':>7s} {'PESQ':>6s}")
        for row in rows:
            name = os.path.basename(row["name"])
            print(f"{name:40s} {row['segsnr']:8.2f} {row['lsd']:8.2f} "
                  f"{row['stoi']:7.3f} {row['pesq']:6.2f}")
    if len(rows) > 1:
        mean = {m: sum(r[m] for r in rows) / len(rows) for m in METRICS}
        if args.json:
            print(json.dumps({"name": "mean", **mean}))
        else:
            print(f"{'mean':40s} {mean['segsnr']:8.2f} {mean['lsd']:8.2f} "
                  f"{mean['stoi']:7.3f} {mean['pesq']:6.2f}")
    return 0


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

    s = sub.add_parser("lps-extract", help="wav -> LPS features (HTK)")
    s.add_argument("wav", nargs="*", help="input wav files")
    s.add_argument("--scp", help="list file of wavs")
    s.add_argument("-F", "--format", default="WAV",
                   choices=["WAV", "RAW", "HTK", "NIST"])
    s.add_argument("-fs", type=int, default=16, choices=[8, 11, 16],
                   help="sampling rate in kHz for RAW inputs "
                        "(Wav2LPS_be -fs)")
    s.add_argument("--swap", action="store_true",
                   help="RAW inputs are big-endian")
    s.add_argument("--win", type=int, default=0,
                   help="stack 2*win+1 frames per row (Wav2LPS_be -win)")
    s.add_argument("--jobs", type=int, default=1,
                   help="read-ahead workers for the wav reads (the LPS and "
                        "the writes stay in scp order)")
    s.add_argument("--noh", action="store_true",
                   help="omit the HTK header on output (Wav2LPS_be -noh)")
    s.add_argument("-o", "--out", help="output path (single input only)")
    s.add_argument("--device", default="cuda",
                   help="'cuda' (default; fails when no GPU is available) "
                        "or 'cpu'")
    s.set_defaults(func=cmd_lps_extract)

    s = sub.add_parser("make-pfile", help=".lps list -> pfile")
    s.add_argument("scp")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--jobs", type=int, default=1,
                   help="read-ahead workers (writer stays in scp order)")
    s.add_argument("--lenfile", help="also write frame_numbers.len")
    s.add_argument("--deslenfile",
                   help="truncate utterances to these lengths "
                        "(feacat -deslenfile)")
    s.set_defaults(func=cmd_make_pfile)

    s = sub.add_parser("concat-pfile", help="merge pfiles (pfile_concat)")
    s.add_argument("pfile", nargs="+")
    s.add_argument("-o", "--out", required=True)
    s.set_defaults(func=cmd_concat_pfile)

    s = sub.add_parser("get-norm", help="pfile -> .norm stats")
    s.add_argument("pfile")
    s.add_argument("-o", "--out", required=True)
    s.add_argument("--no-headers", action="store_true",
                   help="omit 'vec N' lines (Test_code variant)")
    s.set_defaults(func=cmd_get_norm)

    s = sub.add_parser("pfile-info", help="inspect pfiles (pfile_info)")
    s.add_argument("pfile", nargs="+")
    s.add_argument("--sents", action="store_true",
                   help="also print per-sentence frame counts")
    s.set_defaults(func=cmd_pfile_info)

    s = sub.add_parser("wts-info", help="inspect .wts weight files")
    s.add_argument("wts", nargs="+")
    s.set_defaults(func=cmd_wts_info)

    s = sub.add_parser("eval", help="score (clean, test) wav pairs: "
                                    "SegSNR/LSD/STOI/PESQ")
    s.add_argument("--clean", nargs="*", default=[])
    s.add_argument("--test", nargs="*", default=[])
    s.add_argument("--clean-scp")
    s.add_argument("--test-scp")
    s.add_argument("--json", action="store_true",
                   help="one JSON object per line instead of a table")
    s.set_defaults(func=cmd_eval)

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
    raw = sys.argv[1:] if argv is None else list(argv)
    if raw and raw[0] == "bptrain":
        # BPtrain_Sigmoid's key=value strings (Interface.cc:150-315) bypass
        # argparse, so a finetune.pl-style script works by swapping the
        # binary name.
        from tpu_se_torch.cli.bptrain import main as bptrain_main
        return bptrain_main(raw[1:])
    args = build_parser().parse_args(raw)
    try:
        return args.func(args)
    except BrokenPipeError:
        # The reader of stdout (e.g. ``| head``) closed early: not an error.
        os.dup2(os.open(os.devnull, os.O_WRONLY), sys.stdout.fileno())
        return 0


if __name__ == "__main__":
    sys.exit(main())
