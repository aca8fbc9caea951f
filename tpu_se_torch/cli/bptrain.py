"""``tpu_se_torch bptrain key=value ...`` — the ``BPtrain_Sigmoid`` front end.

Port of ``tpu_se/cli/bptrain.py``.  The reference trainer is one process
per epoch invoked as ``BPtrain_Sigmoid key=value ...`` (parser
``Interface.cc:150-315``; the script ``finetune.pl:50-76`` builds those
strings).  This accepts the same strings, so a ``finetune.pl``-style
script drives the port by swapping only the binary name:

    $exe = "python -m tpu_se_torch bptrain";

Semantics are the reference binary's: ONE epoch -- load ``initwts_file``
(or random-init from the ``init_randem_*`` ranges,
``Interface.cc:140-143``), train over ``train_sent_range``, write
``outwts_file`` (weights only: momentum restarts at zero in every epoch
process), run CV over ``cv_sent_range`` and write the reference's metric
lines to ``log_file`` (``BPtrain.cc:105,131-139``).  The return code is 1
when the CV squared error is not finite.

An argument without ``=`` is a format error; an unknown key is ignored
silently (that is how the reference swallows ``numlayers=``).  The
``tpu_se`` extension keys parse the same way, plus ``device`` (``cuda``,
the default, or ``cpu``).  ``compute_dtype=bfloat16``, ``mesh_data>1`` and
``mesh_model>1`` are not supported by the port and stop the run.
"""

from __future__ import annotations

import math
import os
import sys
import time

import numpy as np

# Interface.cc string / int / float key sets (:150-315).
_STR_KEYS = {"fea_file", "norm_file", "targ_file", "outwts_file",
             "log_file", "initwts_file", "train_sent_range",
             "cv_sent_range"}
_INT_KEYS = {"fea_dim", "fea_context", "targ_offset", "dropoutflag",
             "MLflag", "traincache", "bunchsize", "gpu_used",
             "init_randem_seed"}
_FLOAT_KEYS = {"momentum", "shapefactor", "weightcost", "lrate",
               "visible_omit", "hid_omit", "init_randem_weight_min",
               "init_randem_weight_max", "init_randem_bias_min",
               "init_randem_bias_max"}
# Extensions on the same key=value surface: tpu_se's, and the port's device.
_EXT_STR = {"grad_scale", "compute_dtype", "activation", "device_resident",
            "device"}
_EXT_INT = {"mesh_data", "mesh_model", "device_resident_max_bytes"}

_DEFAULTS = {
    # Interface.cc:140-148 defaults (only the init ranges have reference
    # defaults; the rest mirror finetune.pl:10-40 so partial commands work).
    "init_randem_weight_min": -0.1, "init_randem_weight_max": 0.1,
    "init_randem_bias_min": -0.1, "init_randem_bias_max": 0.1,
    "fea_dim": 257, "fea_context": 7, "targ_offset": 3,
    "dropoutflag": 0, "MLflag": 1, "traincache": 102400, "bunchsize": 128,
    "gpu_used": 0, "init_randem_seed": 27870775,
    "momentum": 0.9, "shapefactor": 1.0, "weightcost": 1e-5, "lrate": 0.1,
    "visible_omit": 0.1, "hid_omit": 0.1,
    "layersizes": (1799, 2048, 2048, 2048, 257),
    "train_sent_range": "0-7", "cv_sent_range": "8-9",
    "fea_file": "", "norm_file": "", "targ_file": "",
    "outwts_file": "", "log_file": "", "initwts_file": "",
    "grad_scale": "parity", "compute_dtype": "float32",
    "activation": "sigmoid", "device_resident": "auto",
    "device_resident_max_bytes": 0,  # 0 = TrainConfig default
    "mesh_data": 1, "mesh_model": 1,
    "device": "cuda",
}


def parse_kv(argv: list[str]) -> dict:
    """``Interface.cc:150-161`` arg loop: '=' required, unknown keys with
    '=' silently ignored."""
    cfg = dict(_DEFAULTS)
    for arg in argv:
        if "=" not in arg:
            # Interface.cc:153-157: "Arg: %s  Format Error" + exit.
            raise SystemExit(f"Arg: {arg}  Format Error")
        key, val = arg.split("=", 1)
        if key in _STR_KEYS or key in _EXT_STR:
            cfg[key] = val
        elif key in _INT_KEYS or key in _EXT_INT:
            cfg[key] = int(float(val)) if val else 0
        elif key in _FLOAT_KEYS:
            cfg[key] = float(val)
        elif key == "layersizes":
            cfg[key] = tuple(int(x) for x in val.split(","))
    return cfg


def _parse_range(text: str) -> tuple[int, int]:
    lo, hi = text.split("-")
    return int(lo), int(hi)


def _check_supported(cfg: dict) -> None:
    """Stop on a setting the port does not run, rather than run another."""
    for req in ("fea_file", "targ_file", "norm_file", "outwts_file"):
        if not cfg[req]:
            raise SystemExit(f"bptrain: {req}= is required")
    if cfg["compute_dtype"] != "float32":
        raise SystemExit(f"bptrain: compute_dtype={cfg['compute_dtype']} is "
                         "not supported by tpu_se_torch (float32 only); "
                         "run it with tpu_se")
    if cfg["mesh_data"] > 1 or cfg["mesh_model"] > 1:
        raise SystemExit(f"bptrain: mesh_data={cfg['mesh_data']} "
                         f"mesh_model={cfg['mesh_model']}: tpu_se_torch "
                         "trains on one device; run a mesh with tpu_se")
    if cfg["device_resident"] not in ("auto", "always", "never"):
        raise SystemExit(f"bptrain: device_resident="
                         f"{cfg['device_resident']} is not auto, always "
                         "or never")


def run_bptrain(cfg: dict, log=print) -> int:
    """One reference-binary epoch: train, write .wts, CV, write log."""
    import torch

    from tpu_se_torch.data import PfilePairDataset
    from tpu_se_torch.models import init_params_uniform, params_from_numpy
    from tpu_se_torch.train.checkpoint import load_checkpoint, save_checkpoint
    from tpu_se_torch.train.loop import (
        TrainConfig, evaluate_cv, load_device_frames, train_one_epoch,
    )
    from tpu_se_torch.train.step import make_train_state
    from tpu_se_torch.utils import resolve_device

    _check_supported(cfg)
    device = resolve_device(cfg["device"])
    tc = TrainConfig(
        bunchsize=cfg["bunchsize"], ml_flag=bool(cfg["MLflag"]),
        shapefactor=cfg["shapefactor"], momentum=cfg["momentum"],
        weightcost=cfg["weightcost"], fea_context=cfg["fea_context"],
        targ_offset=cfg["targ_offset"], grad_scale=cfg["grad_scale"],
        activation=cfg["activation"], dropout_flag=bool(cfg["dropoutflag"]),
        visible_omit=cfg["visible_omit"], hid_omit=cfg["hid_omit"])
    hyper = tc.hyper()
    resident_max = (cfg["device_resident_max_bytes"]
                    or tc.device_resident_max_bytes)

    def dataset(sent_range):
        ds = PfilePairDataset(
            cfg["fea_file"], cfg["targ_file"], cfg["norm_file"],
            _parse_range(sent_range), cfg["traincache"],
            cfg["fea_context"], cfg["targ_offset"])
        if cfg["device_resident"] == "never" or (
                cfg["device_resident"] == "auto"
                and ds.span_bytes() > resident_max):
            return ds, None
        return ds, load_device_frames(ds, device)

    train_ds, train_frames = dataset(cfg["train_sent_range"])
    cv_ds, cv_frames = dataset(cfg["cv_sent_range"])

    if cfg["initwts_file"]:
        # The .wts carries WEIGHTS ONLY (Interface.cc:429-468): momentum
        # restarts at zero in every epoch process, so the state is rebuilt
        # from the model even if a sidecar sits beside initwts_file.
        model = load_checkpoint(cfg["initwts_file"], device,
                                cfg["activation"]).model
    else:
        model = params_from_numpy(init_params_uniform(
            cfg["init_randem_seed"], cfg["layersizes"],
            cfg["init_randem_weight_min"], cfg["init_randem_weight_max"],
            cfg["init_randem_bias_min"], cfg["init_randem_bias_max"]),
            device, activation=cfg["activation"])
    state = make_train_state(model)

    # The device is recorded on its own line, not among the parameters.
    lines: list[str] = ["parameters input:"]
    lines += [f"{k}: {cfg[k]}" for k in sorted(cfg) if k != "device"]
    name = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    lines.append(f"torch device: {device.type} ({name})")

    t0 = time.time()
    rng = np.random.default_rng(cfg["init_randem_seed"])
    state = train_one_epoch(state, train_ds, hyper, cfg["lrate"], rng,
                            device, device_frames=train_frames,
                            log=lines.append)
    lines.append(f"Total cost time: {time.time() - t0:.1f} s.")
    save_checkpoint(cfg["outwts_file"], state, with_state=False)
    log(f"weights -> {cfg['outwts_file']}")

    lines.append("Starting CV.")
    metrics = evaluate_cv(state, cv_ds, hyper, device,
                          device_frames=cv_frames)
    n = max(1, metrics["cv_frames"])
    # Reference per-sample metric lines, BPtrain.cc:131-139.
    lines.append(f"CV over. squared error: "
                 f"{metrics['cv_squared_error'] / n:f}")
    lines.append(f"CV over. square root squared error: "
                 f"{metrics['cv_abs_error'] / n:f}")
    if cfg["MLflag"]:
        lines.append(f"CV2 over. CV log likelihood: "
                     f"{metrics['cv_ggd_loglik'] / n:f}")
    if cfg["log_file"]:
        log_dir = os.path.dirname(cfg["log_file"])
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
        with open(cfg["log_file"], "w") as f:
            f.write("\n".join(lines) + "\n")
    log(f"CV squared error {metrics['cv_squared_error'] / n:.6f}, "
        f"abs {metrics['cv_abs_error'] / n:.6f}, "
        f"GGD loglik {metrics['cv_ggd_loglik'] / n:.6f}")
    return 0 if math.isfinite(metrics["cv_squared_error"]) else 1


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    return run_bptrain(parse_kv(argv))


if __name__ == "__main__":
    sys.exit(main())
