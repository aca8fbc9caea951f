"""tpu_se_torch.train against tpu_se.train on the CPU.

- ``train_chunk`` on ``tests/test_train.py``'s tiny problem, the same five
  (ml, beta, grad_scale) cases: rtol 2e-5, atol 1e-7 (float32 GEMMs summed
  in another order, compounded over three bunches);
- ``sgd_momentum_update``: rtol 1e-6 (the same float32 operations);
- ``init_params_uniform``: bit-identical;
- checkpoints: each package reads the other's ``.wts`` + sidecar exactly;
- a 2-epoch ``run_training`` at (1799, 64, 257) on a synthetic 10-sentence
  pfile pair: final weights within rtol 2e-5, atol 1e-6 (the JAX
  package's own bar for two runs of one schedule,
  ``tests/test_distributed.py:99``), the ``mlp.N.log`` CV lines within
  rtol 1e-5, the chunk lines and the shuffles identical;
- resume-by-existence, and a mid-epoch interrupted run resumed to a
  byte-identical ``mlp.1.wts``;
- dropout, statistically (``jax.random``'s bits cannot be matched), and
  the shuffles with dropout on still JAX's;
- the ``train`` and ``gen-rand-net`` CLI;
- ``compute_dtype=bfloat16`` (and ``act_dtype``): the port rounds the
  backward cotangent to bfloat16 where JAX multiplies it unrounded
  (relative 2^-9 per element before the sum), and weights that differ in
  the last float32 digits round to neighbouring bfloat16 values in the
  next bunch.  So ``train_chunk`` after three bunches is held by each
  tensor's CHANGE, |dW_port - dW_jax| <= 2^-6 |dW_jax| in norm (measured
  3e-3), alpha to rtol 2^-6; a 2-epoch ``run_training`` at (1799, 64, 257)
  by 5 % of each tensor's change (measured 2.2 % in the first layer, whose
  gradient sums to far less than its terms) and atol 5e-4 per weight, its
  CV lines to rtol 1e-4; ``cv_chunk_metrics`` to rtol 1e-5.  With the
  default arguments the float32 results are bit for bit what they were.

Fixtures are written with the ``tpu_se.io`` writers inside the tests.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_se.io as ref_io
import tpu_se.train as ref_train
import tpu_se.train.loop as ref_loop
import tpu_se.train.step as ref_step
from tpu_se.models import init_params as jax_init_params
from tpu_se.models import init_params_uniform as jax_init_params_uniform
from tpu_se_torch import train
from tpu_se_torch.cli.main import build_parser
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.data import PfilePairDataset
from tpu_se_torch.io import read_wts
from tpu_se_torch.models import FFN, init_params_uniform, params_from_numpy
from tpu_se_torch.ops import ggd_kernel
from tpu_se_torch.train import loop

ROOT = pathlib.Path(__file__).resolve().parent.parent
NARROW = (1799, 64, 257)


def _np_layers(params):
    return [{"w": np.asarray(l["w"]).copy(), "b": np.asarray(l["b"]).copy()}
            for l in params]


def _tiny_problem(seed=0, n_frames=64, dim=5, ctx=3, m=8, n_bunches=3):
    """``tests/test_train.py``'s tiny problem, as numpy."""
    rng = np.random.default_rng(seed)
    noisy = rng.normal(size=(n_frames, dim)).astype(np.float32)
    clean = (noisy * 0.8 + rng.normal(scale=0.1, size=(n_frames, dim))
             ).astype(np.float32)
    starts = rng.integers(0, n_frames - ctx, size=(n_bunches, m)
                          ).astype(np.int32)
    layersizes = (dim * ctx, 11, 7, dim)
    return noisy, clean, starts, _np_layers(jax_init_params(seed + 1,
                                                            layersizes))


@pytest.mark.parametrize("ml,beta,grad_scale", [
    (False, 2.0, "parity"),
    (False, 1.0, "parity"),
    (True, 1.0, "parity"),
    (True, 0.9, "parity"),
    (False, 2.0, "natural"),
])
def test_train_chunk_matches_jax(ml, beta, grad_scale):
    noisy, clean, starts, layers = _tiny_problem()
    kw = dict(beta=beta, ml=ml, momentum=0.9, weightcost=1e-5, bunchsize=8,
              context=3, targ_offset=1, grad_scale=grad_scale)
    lr = 0.05
    want = ref_train.train_chunk(
        ref_train.make_train_state(
            [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], 5),
        jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(starts),
        jnp.float32(lr), ref_train.TrainHyper(**kw))
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    got = train.train_chunk(state, torch.from_numpy(noisy),
                            torch.from_numpy(clean),
                            torch.from_numpy(starts.astype(np.int64)), lr,
                            train.TrainHyper(**kw))
    assert got is state
    for p, v, w in zip(train.param_layers(got.model), got.velocity,
                       want.params):
        for k in ("w", "b"):
            np.testing.assert_allclose(p[k].detach().numpy(),
                                       np.asarray(w[k]), rtol=2e-5, atol=1e-7)
    for v, w in zip(got.velocity, want.velocity):
        for k in ("w", "b"):
            np.testing.assert_allclose(v[k].numpy(), np.asarray(w[k]),
                                       rtol=2e-5, atol=1e-7)
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=2e-5)
    assert ggd_kernel.launches == 0


def test_gather_splice_matches_jax():
    noisy, _, starts, _ = _tiny_problem()
    got = train.gather_splice(torch.from_numpy(noisy),
                              torch.from_numpy(starts[0].astype(np.int64)), 3)
    want = ref_train.gather_splice(jnp.asarray(noisy), jnp.asarray(starts[0]),
                                   3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n", [1, 128])
def test_sgd_momentum_update_matches_jax(n):
    rng = np.random.default_rng(n)

    def tree():
        return [{"w": rng.standard_normal((6, 4)).astype(np.float32),
                 "b": rng.standard_normal(4).astype(np.float32)}
                for _ in range(2)]

    params, vel, grads = tree(), tree(), tree()
    want_p, want_v = ref_train.sgd_momentum_update(
        params, vel, grads, jnp.float32(0.1), 0.9, 1e-3, n)
    t = [[{k: torch.from_numpy(v.copy()) for k, v in l.items()} for l in x]
         for x in (params, vel, grads)]
    train.sgd_momentum_update(t[0], t[1], t[2], 0.1, 0.9, 1e-3, n)
    for got_tree, want_tree in ((t[0], want_p), (t[1], want_v)):
        for g, w in zip(got_tree, want_tree):
            for k in ("w", "b"):
                np.testing.assert_allclose(g[k].numpy(), np.asarray(w[k]),
                                           rtol=1e-6, atol=1e-12)


def test_init_params_uniform_bit_identical():
    ours = init_params_uniform(9, NARROW, -0.2, 0.3, -0.05, 0.1)
    theirs = jax_init_params_uniform(9, NARROW, -0.2, 0.3, -0.05, 0.1)
    for a, b in zip(ours, theirs):
        assert a["w"].dtype == a["b"].dtype == np.float32
        np.testing.assert_array_equal(a["w"], np.asarray(b["w"]))
        np.testing.assert_array_equal(a["b"], np.asarray(b["b"]))


def test_checkpoint_round_trips_with_jax(tmp_path):
    layers = _np_layers(jax_init_params(3, (15, 11, 5)))
    rng = np.random.default_rng(0)
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    for v in state.velocity:
        for k in v:
            v[k] += torch.from_numpy(rng.standard_normal(tuple(v[k].shape))
                                     .astype(np.float32))
    state.alpha = torch.from_numpy(rng.uniform(0.5, 2, 5).astype(np.float32))
    port_path = str(tmp_path / "port.wts")
    train.save_checkpoint(port_path, state)
    back = ref_train.load_checkpoint(port_path)
    for g, w, vj, vp in zip(back.params, layers, back.velocity,
                            state.velocity):
        for k in ("w", "b"):
            np.testing.assert_array_equal(np.asarray(g[k]), w[k])
            np.testing.assert_array_equal(np.asarray(vj[k]), vp[k].numpy())
    np.testing.assert_array_equal(np.asarray(back.alpha), state.alpha.numpy())

    jax_path = str(tmp_path / "jax.wts")
    ref_train.save_checkpoint(jax_path, back)
    assert (tmp_path / "jax.wts").read_bytes() == \
        (tmp_path / "port.wts").read_bytes()
    again = train.load_checkpoint(jax_path, "cpu")
    for a, b in zip(again.velocity, state.velocity):
        for k in ("w", "b"):
            torch.testing.assert_close(a[k], b[k], rtol=0, atol=0)
    torch.testing.assert_close(again.alpha, state.alpha, rtol=0, atol=0)
    for a, b in zip(again.model.weights, state.model.weights):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    train.save_checkpoint(str(tmp_path / "no_side.wts"), state,
                          with_state=False)
    assert not (tmp_path / "no_side.wts.state.npz").exists()
    fresh = train.load_checkpoint(str(tmp_path / "no_side.wts"), "cpu")
    assert all(not bool(v["w"].any()) for v in fresh.velocity)
    assert bool((fresh.alpha == 1).all())


@pytest.fixture(scope="module")
def pfile_pair(tmp_path_factory):
    """A synthetic 10-sentence noisy/clean pfile pair and its .norm."""
    root = tmp_path_factory.mktemp("pair")
    rng = np.random.default_rng(0)
    lens = rng.integers(100, 250, size=10)
    noisy = [(rng.normal(size=(n, 257)) * 2 + 3).astype(np.float32)
             for n in lens]
    clean = [(x * 0.8 + rng.normal(scale=0.3, size=x.shape)).astype(np.float32)
             for x in noisy]
    paths = {"fea_file": str(root / "noisy.pfile"),
             "targ_file": str(root / "clean.pfile"),
             "norm_file": str(root / "noisy.norm")}
    ref_io.write_pfile(paths["fea_file"], noisy)
    ref_io.write_pfile(paths["targ_file"], clean)
    frames = np.concatenate(noisy)
    ref_io.write_norm(paths["norm_file"], frames.mean(0), 1.0 / frames.std(0))
    return paths


def _kw(pfile_pair, **change):
    kw = dict(pfile_pair, layersizes=NARROW, epochs=2, traincache=512,
              init_seed=11, train_sent_range=(0, 7), cv_sent_range=(8, 9))
    kw.update(change)
    return kw


def _cv_lines(path):
    return {line.split(":")[0]: float(line.split(":")[1])
            for line in open(path).read().splitlines()
            if line.startswith("CV ")}


@pytest.fixture(scope="module")
def two_epoch_runs(pfile_pair, tmp_path_factory):
    """The same 2-epoch schedule through both packages."""
    root = tmp_path_factory.mktemp("runs")
    jax_cfg = ref_train.TrainConfig(out_dir=str(root / "jax"),
                                    **_kw(pfile_pair))
    port_cfg = train.TrainConfig(out_dir=str(root / "port"),
                                 **_kw(pfile_pair))
    jax_last = ref_train.run_training(jax_cfg, log=lambda s: None)
    seen = []
    port_last = train.run_training(port_cfg, "cpu", log=seen.append)
    return jax_cfg, port_cfg, jax_last, port_last, seen


def test_run_training_matches_jax(two_epoch_runs):
    jax_cfg, port_cfg, jax_last, port_last, _ = two_epoch_runs
    assert os.path.basename(port_last) == "mlp.2.wts"
    for e in (1, 2):
        got = read_wts(os.path.join(port_cfg.out_dir, f"mlp.{e}.wts"))
        want = ref_io.read_wts(os.path.join(jax_cfg.out_dir, f"mlp.{e}.wts"))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g["w"], w["w"], rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(g["b"], w["b"], rtol=2e-5, atol=1e-6)
    assert ggd_kernel.launches == 0


def test_run_training_logs_match_jax(two_epoch_runs):
    jax_cfg, port_cfg, _, _, seen = two_epoch_runs
    for e in (1, 2):
        got_log = os.path.join(port_cfg.out_dir, f"mlp.{e}.log")
        want_log = os.path.join(jax_cfg.out_dir, f"mlp.{e}.log")
        got, want = _cv_lines(got_log), _cv_lines(want_log)
        assert sorted(got) == sorted(want) == [
            "CV GGD loglik", "CV abs error", "CV squared error"]
        for k in got:
            assert got[k] == pytest.approx(want[k], rel=1e-5)
        same = [line for line in open(want_log).read().splitlines()
                if "chunk" in line or line.startswith("epoch ")]
        assert same == [line for line in open(got_log).read().splitlines()
                        if "chunk" in line or line.startswith("epoch ")]
    records = [[json.loads(line) for line in open(
        os.path.join(cfg.out_dir, "metrics.jsonl"))]
        for cfg in (port_cfg, jax_cfg)]
    assert len(records[0]) == len(records[1]) == 2
    for got, want in zip(*records):
        assert sorted(got) == sorted(want)
        assert got["epoch"] == want["epoch"]
        assert got["cv_frames"] == want["cv_frames"]
        for k in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
            assert got[k] == pytest.approx(want[k], rel=1e-5)
    assert any(s.startswith("train span resident on cpu") for s in seen)


def test_resume_by_existence(two_epoch_runs):
    _, port_cfg, _, port_last, _ = two_epoch_runs
    before = pathlib.Path(port_last).read_bytes()
    seen = []
    assert train.run_training(port_cfg, "cpu", log=seen.append) == port_last
    epoch_lines = [s for s in seen if s.startswith("epoch")]
    assert len(epoch_lines) == port_cfg.epochs
    assert all("skipping (resume)" in s for s in epoch_lines)
    assert pathlib.Path(port_last).read_bytes() == before


def test_epoch_carry_matches_disk_resume(pfile_pair, tmp_path):
    """Two epochs in one run equal epoch 1, then a resumed epoch 2."""
    kw = _kw(pfile_pair, layersizes=(1799, 32, 257))
    train.run_training(train.TrainConfig(out_dir=str(tmp_path / "a"), **kw),
                       "cpu", log=lambda s: None)
    b = dict(kw, epochs=1)
    train.run_training(train.TrainConfig(out_dir=str(tmp_path / "b"), **b),
                       "cpu", log=lambda s: None)
    train.run_training(train.TrainConfig(out_dir=str(tmp_path / "b"), **kw),
                       "cpu", log=lambda s: None)
    assert (tmp_path / "a" / "mlp.2.wts").read_bytes() == \
        (tmp_path / "b" / "mlp.2.wts").read_bytes()
    assert not (tmp_path / "a" / "mlp.2.wts.state.npz").exists()


@pytest.mark.parametrize("resident", ["never", "always"])
def test_midepoch_resume_is_byte_identical(pfile_pair, tmp_path, monkeypatch,
                                           resident):
    kw = _kw(pfile_pair, layersizes=(1799, 32, 257), epochs=1,
             traincache=256, bunchsize=32, checkpoint_every_chunks=1,
             device_resident=resident)
    a = train.TrainConfig(out_dir=str(tmp_path / "a"), **kw)
    train.run_training(a, "cpu", log=lambda s: None)
    want = (tmp_path / "a" / "mlp.1.wts").read_bytes()

    orig = loop.train_chunk
    calls = {"n": 0}

    def crash_after_chunk_one(*args, **kwargs):
        calls["n"] += 1
        if calls["n"] == 2:
            raise KeyboardInterrupt("simulated crash")
        return orig(*args, **kwargs)

    b = train.TrainConfig(out_dir=str(tmp_path / "b"), **kw)
    monkeypatch.setattr(loop, "train_chunk", crash_after_chunk_one)
    with pytest.raises(KeyboardInterrupt):
        train.run_training(b, "cpu", log=lambda s: None)
    monkeypatch.setattr(loop, "train_chunk", orig)
    meta = tmp_path / "b" / "mlp.1.partial.wts.meta.json"
    assert json.loads(meta.read_text()) == {"epoch": 1, "chunks_done": 1}
    assert (tmp_path / "b" / "mlp.1.partial.1.wts.state.npz").exists()
    assert not (tmp_path / "b" / "mlp.1.wts").exists()

    seen = []
    train.run_training(b, "cpu", log=seen.append)
    assert (tmp_path / "b" / "mlp.1.wts").read_bytes() == want
    assert not meta.exists()
    assert not list((tmp_path / "b").glob("mlp.1.partial.*"))


def test_partial_meta_without_checkpoint_restarts_epoch(pfile_pair, tmp_path):
    kw = _kw(pfile_pair, layersizes=(1799, 32, 257), epochs=1,
             traincache=256, bunchsize=32, checkpoint_every_chunks=1)
    train.run_training(train.TrainConfig(out_dir=str(tmp_path / "a"), **kw),
                       "cpu", log=lambda s: None)
    c = tmp_path / "c"
    c.mkdir()
    (c / "mlp.1.partial.wts.meta.json").write_text(
        json.dumps({"epoch": 1, "chunks_done": 2}))
    seen = []
    train.run_training(train.TrainConfig(out_dir=str(c), **kw), "cpu",
                       log=seen.append)
    assert any("restarting epoch" in s for s in seen), seen
    assert (c / "mlp.1.wts").read_bytes() == \
        (tmp_path / "a" / "mlp.1.wts").read_bytes()


def _identity_model(n, layers, activation="sigmoid"):
    eye = np.eye(n, dtype=np.float32)
    return params_from_numpy([{"w": eye, "b": np.zeros(n, np.float32)}
                              for _ in range(layers)], "cpu",
                             activation=activation)


@pytest.mark.parametrize("p", [0.1, 0.5])
def test_dropout_visible_layer_keep_rate_and_scale(p):
    """Single linear layer with identity weights: the output IS the
    dropped input; layer 0 uses visible_omit, not hid_omit."""
    model = _identity_model(256, 1)
    gen = torch.Generator().manual_seed(3)
    with torch.no_grad():
        y = model(torch.ones(512, 256), dropout=(p, 0.9), generator=gen)
    n = y.numel()
    kept = y != 0
    rate = kept.float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / n)
    assert bool((y[kept] == torch.tensor(1.0) / (1.0 - p)).all())


def test_dropout_hidden_layers_use_hid_omit():
    """Identity weights, relu: layer 0 sees no dropout (visible 0), layer 1
    drops its input with hid_omit."""
    model = _identity_model(256, 2, activation="relu")
    gen = torch.Generator().manual_seed(4)
    p = 0.3
    with torch.no_grad():
        y = model(torch.ones(512, 256), dropout=(0.0, p), generator=gen)
    rate = (y != 0).float().mean().item()
    assert abs(rate - (1 - p)) <= 4 * np.sqrt(p * (1 - p) / y.numel())
    assert bool((y[y != 0] == torch.tensor(1.0) / (1.0 - p)).all())


def test_dropout_reproducible_and_needs_generator():
    model = _identity_model(64, 1)
    x = torch.ones(32, 64)
    runs = [model(x, dropout=(0.5, 0.5),
                  generator=torch.Generator().manual_seed(s)) for s in (1, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    with pytest.raises(ValueError, match="Generator"):
        model(x, dropout=(0.5, 0.5))
    assert isinstance(model, FFN)


@pytest.mark.parametrize("dropout_flag", [False, True])
@pytest.mark.parametrize("resident", [False, True])
def test_epoch_shuffles_match_jax(pfile_pair, monkeypatch, dropout_flag,
                                  resident):
    """The bunches each package trains, in order, are identical -- with
    dropout on too (its seed draw precedes the chunk permutation)."""
    kw = _kw(pfile_pair, traincache=300, dropout_flag=dropout_flag)
    hyper = train.TrainConfig(**kw).hyper()
    ds = PfilePairDataset(kw["fea_file"], kw["targ_file"], kw["norm_file"],
                          (0, 7), 300)
    seen = {"port": [], "jax": []}

    def record(name):
        def fake(state, noisy, clean, starts, *args, **kwargs):
            seen[name].append(np.asarray(starts).copy())
            return state
        return fake

    monkeypatch.setattr(loop, "train_chunk", record("port"))
    monkeypatch.setattr(ref_loop, "train_chunk", record("jax"))
    frames = loop.load_device_frames(ds, "cpu") if resident else None
    rng_p, rng_j = np.random.default_rng(5), np.random.default_rng(5)
    loop.train_one_epoch(None, ds, hyper, 0.1, rng_p, "cpu",
                         device_frames=frames, log=lambda s: None)
    ref_ds = ref_train.loop.PfilePairDataset(
        kw["fea_file"], kw["targ_file"], kw["norm_file"], (0, 7), 300,
        use_native=False)
    ref_hyper = ref_train.TrainConfig(**kw).hyper()
    ref_frames = ref_train.load_device_frames(ref_ds) if resident else None
    ref_train.train_one_epoch(None, ref_ds, ref_hyper, 0.1, rng_j,
                              device_frames=ref_frames, log=lambda s: None)
    assert len(seen["port"]) == len(seen["jax"]) >= 3
    for a, b in zip(seen["port"], seen["jax"]):
        np.testing.assert_array_equal(a, b)
    assert rng_p.integers(2 ** 31) == rng_j.integers(2 ** 31)


def test_dropout_training_runs_and_moves_weights(pfile_pair, tmp_path):
    kw = _kw(pfile_pair, layersizes=(1799, 32, 257), epochs=1,
             dropout_flag=True, visible_omit=0.2, hid_omit=0.3)
    outs = []
    for name in ("a", "b"):
        cfg = train.TrainConfig(out_dir=str(tmp_path / name), **kw)
        outs.append(pathlib.Path(train.run_training(
            cfg, "cpu", log=lambda s: None)).read_bytes())
    assert outs[0] == outs[1]                   # seeded: reproducible
    metrics = json.loads((tmp_path / "a" / "metrics.jsonl").read_text())
    assert np.isfinite(metrics["cv_ggd_loglik"])


def test_gen_rand_net_cli_bytes_match_jax(tmp_path):
    out = tmp_path / "port.wts"
    assert cli_main(["gen-rand-net", "--layersizes", "1799,64,64,257",
                     "--seed", "5", "--flag", "0", "--beta", "1.5",
                     "-o", str(out)]) == 0
    ref_io.write_wts(tmp_path / "jax.wts",
                     _np_layers(jax_init_params(5, (1799, 64, 64, 257),
                                                flag=0, beta=1.5)))
    assert out.read_bytes() == (tmp_path / "jax.wts").read_bytes()


def _train_argv(pfile_pair, out_dir, *extra):
    return ["train", "--fea-file", pfile_pair["fea_file"],
            "--targ-file", pfile_pair["targ_file"],
            "--norm-file", pfile_pair["norm_file"], "--out-dir", str(out_dir),
            "--layersizes", "1799,32,257", "--epochs", "1",
            "--traincache", "512", *extra]


def test_train_cli_subprocess_on_cpu(pfile_pair, tmp_path):
    init = tmp_path / "init.wts"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch", "gen-rand-net",
         "--layersizes", "1799,32,257", "--seed", "3", "-o", str(init)],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch",
         *_train_argv(pfile_pair, tmp_path / "out", "--init-wts", str(init),
                      "--device", "cpu")],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "final weights:" in r.stdout
    assert (tmp_path / "out" / "mlp.1.wts").exists()
    # The same run in-process from the same .wts gives the same bytes.
    assert cli_main(_train_argv(pfile_pair, tmp_path / "in", "--init-wts",
                                str(init), "--device", "cpu")) == 0
    assert (tmp_path / "in" / "mlp.1.wts").read_bytes() == \
        (tmp_path / "out" / "mlp.1.wts").read_bytes()


def test_train_cli_cuda_raises_without_gpu(pfile_pair, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(_train_argv(pfile_pair, tmp_path / "out"))
    assert not (tmp_path / "out" / "mlp.1.wts").exists()


@pytest.mark.parametrize("flag,message", [
    (["--compute-dtype", "float16"], "invalid choice: 'float16'"),
    (["--mesh-data", "two"], "invalid int value: 'two'"),
    (["--coordinator"], "expected one argument")])
def test_train_parser_rejects_left_out_flags(flag, message, capsys):
    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args(["train", "--fea-file", "a",
                                   "--targ-file", "b", "--norm-file", "c",
                                   *flag])
    assert exc.value.code == 2
    assert message in capsys.readouterr().err


def _change_rel(got, want, start):
    """|got - want| / |want - start| in norm: how far two runs' weight
    changes are from each other."""
    return (np.linalg.norm(got.astype(np.float64) - want)
            / np.linalg.norm(want.astype(np.float64) - start))


@pytest.mark.parametrize("act_dtype", [None, "bfloat16"])
@pytest.mark.parametrize("ml,beta", [(True, 1.0), (False, 2.0)])
def test_train_chunk_bf16_matches_jax(ml, beta, act_dtype):
    noisy, clean, starts, layers = _tiny_problem()
    kw = dict(beta=beta, ml=ml, momentum=0.9, weightcost=1e-5, bunchsize=8,
              context=3, targ_offset=1, grad_scale="parity")
    lr = 0.05
    want = ref_train.train_chunk(
        ref_train.make_train_state(
            [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], 5),
        jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(starts),
        jnp.float32(lr), ref_train.TrainHyper(
            compute_dtype=jnp.bfloat16,
            act_dtype=None if act_dtype is None else jnp.bfloat16, **kw))
    hyper = train.TrainHyper(compute_dtype="bfloat16", act_dtype=act_dtype,
                             **kw)
    assert hyper.compute_dtype == torch.bfloat16
    assert hyper.act_dtype in (None, torch.bfloat16)
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    got = train.train_chunk(state, torch.from_numpy(noisy),
                            torch.from_numpy(clean),
                            torch.from_numpy(starts.astype(np.int64)), lr,
                            hyper)
    for p, v, w, start in zip(train.param_layers(got.model), got.velocity,
                              want.params, layers):
        for k in ("w", "b"):
            assert p[k].dtype == v[k].dtype == torch.float32
            assert _change_rel(p[k].detach().numpy(), np.asarray(w[k]),
                               start[k]) <= 2.0 ** -6, k
    assert got.alpha.dtype == torch.float32
    np.testing.assert_allclose(got.alpha.numpy(), np.asarray(want.alpha),
                               rtol=2.0 ** -6)
    # bfloat16 is another run than float32: further from it than from JAX.
    plain = train.train_chunk(
        train.make_train_state(params_from_numpy(layers, "cpu")),
        torch.from_numpy(noisy), torch.from_numpy(clean),
        torch.from_numpy(starts.astype(np.int64)), lr, train.TrainHyper(**kw))
    w_last = train.param_layers(got.model)[-1]["w"].detach().numpy()
    assert (np.abs(plain.model.weights[-1].detach().numpy() - w_last).max()
            > 0)
    assert ggd_kernel.launches == 0


def test_train_hyper_defaults_keep_the_float32_bits():
    noisy, clean, starts, layers = _tiny_problem()
    kw = dict(beta=1.0, ml=True, bunchsize=8, context=3, targ_offset=1)
    runs = []
    for extra in ({}, {"compute_dtype": "float32", "act_dtype": None},
                  {"compute_dtype": torch.float32}):
        hyper = train.TrainHyper(**kw, **extra)
        assert hyper.compute_dtype == torch.float32
        state = train.make_train_state(params_from_numpy(layers, "cpu"))
        train.train_chunk(state, torch.from_numpy(noisy),
                          torch.from_numpy(clean),
                          torch.from_numpy(starts.astype(np.int64)), 0.05,
                          hyper)
        runs.append(state)
    for other in runs[1:]:
        for a, b in zip(runs[0].model.parameters(), other.model.parameters()):
            assert torch.equal(a, b)
        assert torch.equal(runs[0].alpha, other.alpha)
    for bad in ("float16", torch.float16, "bf16", 32):
        with pytest.raises(ValueError, match="unsupported compute dtype"):
            train.TrainHyper(compute_dtype=bad)
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        train.TrainHyper(act_dtype="float16")
    assert train.TrainConfig().compute_dtype == "float32"
    assert train.TrainConfig(compute_dtype="bfloat16").hyper(
        ).compute_dtype == torch.bfloat16


def test_cv_bf16_matches_jax():
    noisy, clean, starts, layers = _tiny_problem()
    params = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    alpha = np.linspace(0.5, 1.5, 5).astype(np.float32)
    kw = dict(beta=0.9, context=3, targ_offset=1)
    s = starts[0]
    want = ref_step.cv_chunk_metrics(
        params, jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(s),
        jnp.ones(len(s), jnp.float32), jnp.asarray(alpha),
        ref_train.TrainHyper(compute_dtype=jnp.bfloat16, **kw))
    model = params_from_numpy(layers, "cpu")
    got = train.cv_chunk_metrics(
        model, torch.from_numpy(noisy), torch.from_numpy(clean),
        torch.from_numpy(s.astype(np.int64)), torch.ones(len(s)),
        torch.from_numpy(alpha),
        train.TrainHyper(compute_dtype="bfloat16", **kw))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), [float(x) for x in want],
                               rtol=1e-5)
    out = train.cv_forward(model, torch.from_numpy(noisy),
                           torch.from_numpy(s.astype(np.int64)), 3,
                           compute_dtype=torch.bfloat16)
    out_j = ref_step.cv_forward(params, jnp.asarray(noisy), jnp.asarray(s),
                                 3, compute_dtype=jnp.bfloat16)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=0,
                               atol=2.0 ** -8 * np.abs(out_j).max())
    assert not torch.equal(out, train.cv_forward(
        model, torch.from_numpy(noisy), torch.from_numpy(s.astype(np.int64)),
        3))


@pytest.fixture(scope="module")
def bf16_runs(pfile_pair, tmp_path_factory):
    """The 2-epoch schedule in bfloat16 through both packages."""
    root = tmp_path_factory.mktemp("bf16_runs")
    kw = _kw(pfile_pair, compute_dtype="bfloat16")
    ref_train.run_training(
        ref_train.TrainConfig(out_dir=str(root / "jax"), **kw),
        log=lambda s: None)
    train.run_training(train.TrainConfig(out_dir=str(root / "port"), **kw),
                       "cpu", log=lambda s: None)
    return root


def test_run_training_bf16_matches_jax(bf16_runs, two_epoch_runs):
    start = jax_init_params(11, NARROW)
    for e in (1, 2):
        got = read_wts(bf16_runs / "port" / f"mlp.{e}.wts")
        want = ref_io.read_wts(bf16_runs / "jax" / f"mlp.{e}.wts")
        for g, w, a in zip(got, want, start):
            for k in ("w", "b"):
                assert g[k].dtype == np.float32
                np.testing.assert_allclose(g[k], w[k], rtol=0, atol=5e-4)
                assert _change_rel(g[k], w[k], np.asarray(a[k])) <= 0.05
        got_cv = _cv_lines(bf16_runs / "port" / f"mlp.{e}.log")
        want_cv = _cv_lines(bf16_runs / "jax" / f"mlp.{e}.log")
        for k in want_cv:
            assert got_cv[k] == pytest.approx(want_cv[k], rel=1e-4)
    # Another run than the float32 one, and its config line says so.
    plain = read_wts(os.path.join(two_epoch_runs[1].out_dir, "mlp.2.wts"))
    assert not np.array_equal(plain[0]["w"], got[0]["w"])
    log = (bf16_runs / "port" / "mlp.1.log").read_text()
    assert "compute_dtype = bfloat16" in log
    assert not (bf16_runs / "port" / "mlp.2.wts.state.npz").exists()


def test_train_cli_bf16_on_cpu(pfile_pair, bf16_runs, tmp_path):
    """``train --compute-dtype bfloat16`` is the library's bfloat16 run."""
    assert cli_main([
        "train", "--fea-file", pfile_pair["fea_file"],
        "--targ-file", pfile_pair["targ_file"],
        "--norm-file", pfile_pair["norm_file"], "--out-dir", str(tmp_path),
        "--layersizes", "1799,64,257", "--epochs", "2", "--traincache", "512",
        "--seed", "11", "--train-sents", "0-7", "--cv-sents", "8-9",
        "--compute-dtype", "bfloat16", "--device", "cpu"]) == 0
    for e in (1, 2):
        assert (tmp_path / f"mlp.{e}.wts").read_bytes() == \
            (bf16_runs / "port" / f"mlp.{e}.wts").read_bytes()


@pytest.mark.parametrize("beta,n_valid", [(1.0, 8), (0.9, 5), (2.0, 1)])
def test_masked_cv_chunk_metrics_matches_jax(beta, n_valid):
    """The batch padded as ``tpu_se`` pads it: pad rows (start 0, mask 0)
    add nothing, and the sums are the unpadded batch's."""
    noisy, clean, starts, layers = _tiny_problem()
    params = [{k: jnp.asarray(v) for k, v in l.items()} for l in layers]
    alpha = np.linspace(0.5, 1.5, 5).astype(np.float32)
    s = starts[0].copy()
    s[n_valid:] = 0
    mask = (np.arange(len(s)) < n_valid).astype(np.float32)
    kw = dict(beta=beta, context=3, targ_offset=1)
    want = ref_step.cv_chunk_metrics(
        params, jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(s),
        jnp.asarray(mask), jnp.asarray(alpha), ref_train.TrainHyper(**kw))
    model = params_from_numpy(layers, "cpu")
    args = (model, torch.from_numpy(noisy), torch.from_numpy(clean))
    got = train.cv_chunk_metrics(
        *args, torch.from_numpy(s.astype(np.int64)), torch.from_numpy(mask),
        torch.from_numpy(alpha), train.TrainHyper(**kw))
    np.testing.assert_allclose(got.numpy(), [float(x) for x in want],
                               rtol=1e-5)
    unpadded = train.cv_chunk_metrics(
        *args, torch.from_numpy(s[:n_valid].astype(np.int64)),
        torch.ones(n_valid), torch.from_numpy(alpha), train.TrainHyper(**kw))
    np.testing.assert_allclose(got.numpy(), unpadded.numpy(), rtol=1e-6)


@pytest.fixture(scope="module")
def cv_pair(tmp_path_factory):
    """A 24-sentence pfile pair whose CV set (sentences 4-23, 5,293
    windows) takes one full CV batch and a partial one when resident, and
    a partial batch in each chunk of 1,200 frames when read per chunk
    (5,269 windows)."""
    root = tmp_path_factory.mktemp("cv_pair")
    rng = np.random.default_rng(4)
    lens = rng.integers(200, 330, size=24)
    noisy = [(rng.normal(size=(n, 257)) * 2 + 3).astype(np.float32)
             for n in lens]
    clean = [(x * 0.8 + rng.normal(scale=0.3, size=x.shape)
              ).astype(np.float32) for x in noisy]
    paths = (str(root / "noisy.pfile"), str(root / "clean.pfile"),
             str(root / "noisy.norm"))
    ref_io.write_pfile(paths[0], noisy)
    ref_io.write_pfile(paths[1], clean)
    frames = np.concatenate(noisy)
    ref_io.write_norm(paths[2], frames.mean(0), 1.0 / frames.std(0))
    return paths


@pytest.mark.parametrize("resident", [True, False],
                         ids=["resident", "per-chunk"])
def test_evaluate_cv_matches_jax_with_a_partial_batch(cv_pair, resident):
    """``evaluate_cv`` against ``tpu_se``'s: the same padded batches, the
    three sums within rtol 1e-5 (float32 sums in another order), the
    frame count equal; ``graph=False`` the same bits on the CPU."""
    from tpu_se.data import PfilePairDataset as RefDataset

    layers = _np_layers(jax_init_params(5, NARROW))
    alpha = np.linspace(0.6, 1.4, 257).astype(np.float32)
    hyper = dict(beta=0.9)
    traincache = 1200 if not resident else 102400
    ref_ds = RefDataset(*cv_pair, (4, 23), traincache)
    ds = PfilePairDataset(*cv_pair, (4, 23), traincache)
    ref_state = ref_step.TrainState(
        [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], None,
        jnp.asarray(alpha))
    want = ref_loop.evaluate_cv(
        ref_state, ref_ds, ref_train.TrainHyper(**hyper),
        device_frames=(tuple(map(jnp.asarray, ref_ds.load_span_normalized()))
                       if resident else None))
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    state.alpha = torch.from_numpy(alpha)
    frames = loop.load_device_frames(ds, "cpu") if resident else None
    got = loop.evaluate_cv(state, ds, train.TrainHyper(**hyper), "cpu",
                           device_frames=frames)
    # A chunk boundary cuts the windows that would cross it.
    assert got["cv_frames"] == want["cv_frames"] == (5293 if resident
                                                     else 5269)
    n_batches = (-(-5293 // train.CV_BATCH) if resident
                 else sum(-(-len(ds.chunk(i).starts) // train.CV_BATCH)
                          for i in range(ds.n_chunks)))
    assert n_batches == (2 if resident else ds.n_chunks) and n_batches > 1
    for key in ("cv_squared_error", "cv_abs_error", "cv_ggd_loglik"):
        assert got[key] == pytest.approx(want[key], rel=1e-5), key
    eager = loop.evaluate_cv(state, ds, train.TrainHyper(**hyper), "cpu",
                             device_frames=frames, graph=False)
    assert eager == got
    assert state._cv_graph is None
