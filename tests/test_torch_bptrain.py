"""tpu_se_torch's ``bptrain`` key=value front end against tpu_se's, on the CPU.

- ``parse_kv``: the same dict as ``tpu_se.cli.bptrain.parse_kv`` for the
  ``finetune.pl`` strings (the port adds one key, ``device``); the same
  format error, unknown keys ignored alike.
- One epoch at (1799, 64, 64, 257) on ``device=cpu`` against ``tpu_se``
  bptrain on JAX-CPU: weights within rtol 2e-5, atol 1e-6 (float32 GEMMs
  summed in another order, as ``tests/test_torch_train.py`` holds
  ``run_training``), the CV log values within rtol 1e-4 (they are printed
  with six decimals), and the same log lines apart from the time and
  backend lines.
- Against the port's own ``train``: one ``bptrain`` epoch bitwise equal to
  ``train --epochs 1``, a chained 2-epoch ``bptrain`` bitwise equal to
  ``train --epochs 2`` with no sidecar written, and a stray sidecar beside
  ``initwts_file`` changes nothing (momentum restarts every epoch).
- The random-init path at lrate 0 writes bitwise ``tpu_se``'s ``.wts``.
- ``compute_dtype=bfloat16``: a chained 2-epoch ``bptrain`` bitwise equal
  to ``train --compute-dtype bfloat16 --epochs 2``; one epoch against
  ``tpu_se`` bptrain with the same key: each tensor's change within 5 % in
  norm and each weight within atol 5e-4 (the port rounds the backward
  cotangent to bfloat16, and weights that differ in their last digits
  round to neighbouring bfloat16 values; ``tests/test_torch_train.py``),
  the CV log values within rtol 1e-4.
- Settings the port does not run stop it: ``compute_dtype=float16``, a
  ``mesh_model`` that does not divide a hidden width, a ``mesh_data`` that
  does not divide the bunch, a bad ``device`` or ``device_resident``, and
  ``device=cuda`` without a card (``mesh_data=2`` runs:
  ``tests/test_torch_distributed.py``; ``mesh_model=2``:
  ``tests/test_torch_tensor_parallel.py``).

Fixtures are written with the ``tpu_se.io`` writers inside the tests.
"""

import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_se.io as ref_io
from tpu_se.cli import bptrain as ref_bptrain
from tpu_se.cli.main import main as ref_main
from tpu_se_torch.cli import bptrain
from tpu_se_torch.cli.main import main
from tpu_se_torch.io import read_wts
from tpu_se_torch.models import init_params
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.train import make_train_state, save_checkpoint
from tpu_se_torch.train.checkpoint import load_checkpoint

ROOT = pathlib.Path(__file__).resolve().parent.parent
SIZES = "1799,64,64,257"
WTS_RTOL, WTS_ATOL = 2e-5, 1e-6
LOG_RTOL = 1e-4


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A synthetic 10-sentence noisy/clean pfile pair, its .norm and a
    narrow initial .wts."""
    root = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 250, size=10)
    noisy = [(rng.normal(size=(n, 257)) * 2 + 3).astype(np.float32)
             for n in lens]
    clean = [(x * 0.8 + rng.normal(scale=0.3, size=x.shape)).astype(np.float32)
             for x in noisy]
    paths = {"fea": str(root / "noisy.pfile"), "targ": str(root / "clean.pfile"),
             "norm": str(root / "noisy.norm"), "init": str(root / "init.wts")}
    ref_io.write_pfile(paths["fea"], noisy)
    ref_io.write_pfile(paths["targ"], clean)
    frames = np.concatenate(noisy)
    ref_io.write_norm(paths["norm"], frames.mean(0), 1.0 / frames.std(0))
    ref_io.write_wts(paths["init"],
                     init_params(3, tuple(int(s) for s in SIZES.split(","))))
    return paths


def finetune_args(pair, out, epoch=1, initwts=None, seed=777, lrate=0.1,
                  layersizes=SIZES, extra=()):
    """The key=value strings finetune.pl:50-76 assembles, one per
    fragment, in its order (traincache cut to 512 so an epoch has chunks)."""
    numlayers = len(layersizes.split(",")) - 1
    initwts = pair["init"] if initwts is None else initwts
    return [
        "gpu_used=0", f"numlayers={numlayers}", f"layersizes={layersizes}",
        "bunchsize=128", "MLflag=1", "shapefactor=1", "momentum=0.9",
        "weightcost=0.00001", f"lrate={lrate}", "fea_dim=257",
        "fea_context=7", "traincache=512", f"init_randem_seed={seed}",
        "targ_offset=3", f"initwts_file={initwts}",
        f"norm_file={pair['norm']}", f"fea_file={pair['fea']}",
        f"targ_file={pair['targ']}", f"outwts_file={out}/mlp.{epoch}.wts",
        f"log_file={out}/mlp.{epoch}.log", "train_sent_range=0-7",
        "cv_sent_range=8-9", "dropoutflag=0", "visible_omit=0.1",
        "hid_omit=0.1", *extra]


def train_argv(pair, out, epochs, seed=777, extra=()):
    return ["train", "--fea-file", pair["fea"], "--targ-file", pair["targ"],
            "--norm-file", pair["norm"], "--init-wts", pair["init"],
            "--out-dir", str(out), "--layersizes", SIZES,
            "--epochs", str(epochs), "--seed", str(seed),
            "--traincache", "512", "--train-sents", "0-7",
            "--cv-sents", "8-9", "--device", "cpu", *extra]


def _cv_values(log):
    return {line.split(":")[0]: float(line.split(":")[1])
            for line in log.splitlines() if line.startswith("CV")}


@pytest.mark.parametrize("argv", [
    [],
    "finetune",
    ["numlayers=4", "some_future_key=zzz", "bunchsize=64", "MLflag=0",
     "lrate=", "traincache=1e3", "layersizes=1799,32,257"],
    ["device_resident_max_bytes=1073741824", "mesh_data=2",
     "compute_dtype=bfloat16", "grad_scale=natural", "activation=relu"],
], ids=["defaults", "finetune", "mixed", "extensions"])
def test_parse_kv_matches_tpu_se(argv, tmp_path):
    if argv == "finetune":
        argv = finetune_args({"fea": "a", "targ": "b", "norm": "c",
                              "init": "d"}, tmp_path)
    if "lrate=" in argv:
        with pytest.raises(ValueError):
            bptrain.parse_kv(argv)
        with pytest.raises(ValueError):
            ref_bptrain.parse_kv(argv)
        argv = [a for a in argv if a != "lrate="]
    got = bptrain.parse_kv(argv)
    assert got.pop("device") == "cuda"
    assert got == ref_bptrain.parse_kv(argv)
    assert "numlayers" not in got
    assert bptrain.parse_kv(["device=cpu"])["device"] == "cpu"


def test_parse_kv_format_error():
    for parse in (bptrain.parse_kv, ref_bptrain.parse_kv):
        with pytest.raises(SystemExit, match="Arg: bunchsize  Format Error"):
            parse(["bunchsize"])


@pytest.fixture(scope="module")
def one_epoch(pair, tmp_path_factory):
    """One bptrain epoch through each package's CLI."""
    root = tmp_path_factory.mktemp("one")
    out = {"port": root / "port", "jax": root / "jax"}
    for d in out.values():
        d.mkdir()
    ggd_kernel.launches = 0
    assert main(["bptrain", *finetune_args(pair, out["port"],
                                           extra=["device=cpu"])]) == 0
    assert ggd_kernel.launches == 0
    assert ref_main(["bptrain", *finetune_args(pair, out["jax"])]) == 0
    return out


def test_bptrain_weights_match_tpu_se(one_epoch):
    got = read_wts(one_epoch["port"] / "mlp.1.wts")
    want = ref_io.read_wts(one_epoch["jax"] / "mlp.1.wts")
    assert [g["w"].shape for g in got] == [(1799, 64), (64, 64), (64, 257)]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["w"], w["w"], rtol=WTS_RTOL,
                                   atol=WTS_ATOL)
        np.testing.assert_allclose(g["b"], w["b"], rtol=WTS_RTOL,
                                   atol=WTS_ATOL)
    assert sorted(os.listdir(one_epoch["port"])) == ["mlp.1.log", "mlp.1.wts"]


def test_bptrain_log_matches_tpu_se(one_epoch):
    got, want = ((one_epoch[k] / "mlp.1.log").read_text().replace(
        str(one_epoch[k]), "<out>") for k in ("port", "jax"))
    got_cv, want_cv = _cv_values(got), _cv_values(want)
    assert sorted(got_cv) == sorted(want_cv) == [
        "CV over. square root squared error", "CV over. squared error",
        "CV2 over. CV log likelihood"]
    for k in got_cv:
        assert np.isfinite(got_cv[k])
        assert got_cv[k] == pytest.approx(want_cv[k], rel=LOG_RTOL)

    def same_lines(log, backend):
        lines = log.splitlines()
        assert sum(line.startswith(backend) for line in lines) == 1
        assert sum(line.startswith("Total cost time: ") for line in lines) == 1
        return [line for line in lines if not line.startswith(
            (backend, "Total cost time: ", "CV"))]

    assert (same_lines(got, "torch device: cpu (cpu)")
            == same_lines(want, "jax backend: "))
    assert "  chunk 1/" in got


def test_bptrain_equals_train_epoch1(pair, one_epoch, tmp_path):
    assert main(train_argv(pair, tmp_path, 1)) == 0
    assert ((tmp_path / "mlp.1.wts").read_bytes()
            == (one_epoch["port"] / "mlp.1.wts").read_bytes())


def test_bptrain_chain_equals_train_2_epochs(pair, one_epoch, tmp_path):
    """Epoch 2 of a finetune.pl chain: initwts = epoch 1's output, seed
    +345 (finetune.pl:86,124), lrate unchanged through epoch 10."""
    chain = one_epoch["port"]
    epoch2 = tmp_path / "chain"
    epoch2.mkdir()
    assert main(["bptrain", *finetune_args(
        pair, epoch2, epoch=2, initwts=chain / "mlp.1.wts", seed=777 + 345,
        extra=["device=cpu"])]) == 0
    assert not list(chain.glob("*.state.npz"))
    assert not list(epoch2.glob("*.state.npz"))
    assert main(train_argv(pair, tmp_path / "train", 2)) == 0
    for got, want in ((chain / "mlp.1.wts", "mlp.1.wts"),
                      (epoch2 / "mlp.2.wts", "mlp.2.wts")):
        assert got.read_bytes() == (tmp_path / "train" / want).read_bytes()


def test_bptrain_bf16_chain_equals_train_and_matches_tpu_se(pair, one_epoch,
                                                            tmp_path):
    bf16 = ["compute_dtype=bfloat16"]
    out = {name: tmp_path / name for name in ("port", "jax", "train")}
    for d in out.values():
        d.mkdir()
    ggd_kernel.launches = 0
    assert main(["bptrain", *finetune_args(
        pair, out["port"], extra=bf16 + ["device=cpu"])]) == 0
    assert main(["bptrain", *finetune_args(
        pair, out["port"], epoch=2, initwts=out["port"] / "mlp.1.wts",
        seed=777 + 345, extra=bf16 + ["device=cpu"])]) == 0
    assert ggd_kernel.launches == 0
    assert main(train_argv(pair, out["train"], 2,
                           extra=["--compute-dtype", "bfloat16"])) == 0
    for name in ("mlp.1.wts", "mlp.2.wts"):
        assert ((out["port"] / name).read_bytes()
                == (out["train"] / name).read_bytes())
    assert ((out["port"] / "mlp.1.wts").read_bytes()
            != (one_epoch["port"] / "mlp.1.wts").read_bytes())
    assert "compute_dtype: bfloat16" in (out["port"] / "mlp.1.log").read_text()

    assert ref_main(["bptrain", *finetune_args(pair, out["jax"],
                                               extra=bf16)]) == 0
    start = ref_io.read_wts(pair["init"])
    got = read_wts(out["port"] / "mlp.1.wts")
    want = ref_io.read_wts(out["jax"] / "mlp.1.wts")
    for g, w, a in zip(got, want, start):
        for k in ("w", "b"):
            assert g[k].dtype == np.float32
            np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-4)
            if np.any(w[k] != a[k]):
                rel = (np.linalg.norm(g[k].astype(np.float64) - w[k])
                       / np.linalg.norm(w[k].astype(np.float64) - a[k]))
                assert rel <= 0.05, (k, rel)
    got_cv = _cv_values((out["port"] / "mlp.1.log").read_text())
    want_cv = _cv_values((out["jax"] / "mlp.1.log").read_text())
    assert sorted(got_cv) == sorted(want_cv) and len(got_cv) == 3
    for k in got_cv:
        assert got_cv[k] == pytest.approx(want_cv[k], rel=LOG_RTOL)


def test_stray_sidecar_is_ignored(pair, one_epoch, tmp_path):
    """A velocity sidecar beside initwts_file must not carry momentum into
    the epoch: the result equals the run without it."""
    init = tmp_path / "init.wts"
    init.write_bytes(pathlib.Path(pair["init"]).read_bytes())
    state = make_train_state(load_checkpoint(str(init), "cpu").model)
    for layer in state.velocity:
        for v in layer.values():
            v.fill_(0.01)
    state.alpha.fill_(3.0)
    save_checkpoint(str(init), state)
    assert (tmp_path / "init.wts.state.npz").exists()
    assert main(["bptrain", *finetune_args(
        pair, tmp_path, initwts=init, extra=["device=cpu"])]) == 0
    assert ((tmp_path / "mlp.1.wts").read_bytes()
            == (one_epoch["port"] / "mlp.1.wts").read_bytes())


def test_random_init_path_matches_tpu_se(pair, tmp_path):
    """No initwts_file: uniform init from init_randem_* seeded by
    init_randem_seed; at lrate 0 the epoch leaves it as it is, so both
    packages must write the same bytes."""
    ranges = ["init_randem_weight_min=-0.05", "init_randem_weight_max=0.05",
              "init_randem_bias_min=0", "init_randem_bias_max=0.02"]
    for name, run, extra in (("port", main, ["device=cpu"]),
                             ("jax", ref_main, [])):
        (tmp_path / name).mkdir()
        args = finetune_args(pair, tmp_path / name, initwts="", seed=11,
                             lrate=0, layersizes="1799,32,257",
                             extra=ranges + extra)
        assert run(["bptrain", *args]) == 0
    got = (tmp_path / "port" / "mlp.1.wts").read_bytes()
    assert got == (tmp_path / "jax" / "mlp.1.wts").read_bytes()
    layers = read_wts(tmp_path / "port" / "mlp.1.wts")
    assert [layer["w"].shape for layer in layers] == [(1799, 32), (32, 257)]
    assert 0 < np.abs(layers[0]["w"]).max() <= 0.05
    assert 0 <= layers[0]["b"].min() and layers[0]["b"].max() <= 0.02


@pytest.mark.parametrize("extra,error,match", [
    (["compute_dtype=float16"], SystemExit,
     "compute_dtype=float16 is not float32 or bfloat16"),
    (["mesh_data=3"], SystemExit, "mesh_data=3"),
    (["mesh_model=3"], SystemExit, "hidden width 64 .*mesh_model=3"),
    (["device_resident=sometimes"], SystemExit, "device_resident"),
    (["outwts_file="], SystemExit, "outwts_file= is required"),
    (["device=meta"], ValueError, "unsupported device"),
    ([], RuntimeError, "is_available"),
])
def test_unsupported_settings_raise(pair, tmp_path, extra, error, match):
    if error is RuntimeError and torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cpu = [] if error is RuntimeError or "device=meta" in extra else [
        "device=cpu"]
    with pytest.raises(error, match=match):
        main(["bptrain", *finetune_args(pair, tmp_path, extra=extra + cpu)])
    assert not list(tmp_path.iterdir())


def test_bptrain_subprocess_on_cpu(pair, one_epoch, tmp_path):
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch", "bptrain",
         *finetune_args(pair, tmp_path, extra=["device=cpu"])],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert f"weights -> {tmp_path}/mlp.1.wts" in r.stdout
    assert ((tmp_path / "mlp.1.wts").read_bytes()
            == (one_epoch["port"] / "mlp.1.wts").read_bytes())
