"""Real multi-process data-parallel runs of the port, on the CPU over gloo.

The port's twin of ``tests/test_distributed.py``: every test starts its
ranks as child processes (``tests/torch_mp_worker.py`` or ``python -m
tpu_se_torch``), so no process group outlives a test; each cluster has its
own time limit and its ranks are killed when it ends.  Fixtures are
written with the ``tpu_se.io`` writers inside the tests.

- ``allgather_host_rows`` on uneven shards over 2 and 3 ranks: exact;
- sharded ``load_span_normalized`` and ``load_device_frames(mesh=)``:
  byte-identical to the unsharded read on every rank;
- a replica that differs by one ulp makes ``check_replicas`` raise on
  every rank;
- the whole training command, two ranks of ``python -m tpu_se_torch train
  --coordinator ... --cpu-collectives gloo --device cpu`` at (1799, 64,
  257), 2 epochs: against one process of the port and against ``tpu_se``
  under ``make_mesh(2, 1)`` on the same pfiles, rtol 2e-5, atol 1e-6 (the
  reference's own bar for two runs of one schedule,
  ``tests/test_distributed.py:99``; measured here: |diff| <= 1.2e-7); only
  rank 0 writes; a rerun is byte-identical;
- ``--mesh-data 2 --device cpu`` and ``bptrain mesh_data=2`` write the
  explicit two-rank run's bytes;
- both ranks hard-killed mid-epoch, then restarted: the final ``.wts`` is
  byte-identical to an uninterrupted two-rank run
  (``tests/test_distributed.py:131-174``);
- a bunch that the ranks cannot split stops the run.
"""

import os
import pathlib

import jax
import numpy as np
import pytest

import tpu_se.io as ref_io
import tpu_se.train as ref_train
from torch_mp_worker import GATHER_ROWS, gather_problem, run_ranks
from tpu_se.models import init_params
from tpu_se.parallel import make_mesh as ref_make_mesh
from tpu_se_torch import train
from tpu_se_torch.data import PfilePairDataset
from tpu_se_torch.io import read_wts
from tpu_se_torch.parallel.mesh import free_port

ROOT = pathlib.Path(__file__).resolve().parent.parent
WORKER = str(ROOT / "tests" / "torch_mp_worker.py")
SIZES = "1799,64,257"


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


@pytest.mark.parametrize("size", [2, 3])
def test_allgather_host_rows_on_uneven_shards(size, tmp_path):
    assert GATHER_ROWS % size != 0
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "allgather", str(k), str(size), str(port),
                   str(tmp_path)], size, timeout=90)
    assert codes == [0] * size, "\n".join(logs)
    for rank in range(size):
        np.testing.assert_array_equal(
            np.load(tmp_path / f"gathered.{rank}.npy"), gather_problem())


def test_sharded_span_read_is_byte_identical(pair, tmp_path):
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "span", str(k), "2", str(port), str(tmp_path),
                   pair["fea"], pair["targ"], pair["norm"]], 2, timeout=90)
    assert codes == [0, 0], "\n".join(logs)
    ds = PfilePairDataset(pair["fea"], pair["targ"], pair["norm"], (0, 7),
                          512)
    noisy, clean = ds.load_span_normalized()
    lo, hi = ds.frame_span()
    assert (hi - lo) % 2 == 1                       # uneven shards
    shard = ds.load_span_shard(1, 2)
    assert len(shard[0]) == (hi - lo) // 2
    np.testing.assert_array_equal(shard[1], clean[(hi - lo + 1) // 2:])
    for rank in (0, 1):
        got = np.load(tmp_path / f"span.{rank}.npz")
        for name, want in (("noisy", noisy), ("clean", clean),
                           ("dev_noisy", noisy), ("dev_clean", clean)):
            assert got[name].tobytes() == want.tobytes(), (rank, name)


def test_a_replica_one_ulp_off_raises_on_every_rank(tmp_path):
    port = free_port()
    codes, logs = run_ranks(
        lambda k: [WORKER, "replicas", str(k), "2", str(port),
                   str(tmp_path)], 2, timeout=90, expect_failure=True)
    assert codes == [5, 5], "\n".join(logs)
    for log in logs:
        assert ("replicas differ in the test: rank 1's tensors [0] (of 2) "
                "are not rank 0's bit for bit") in log


def train_argv(pair, out, epochs=2, extra=()):
    return ["--fea-file", pair["fea"], "--targ-file", pair["targ"],
            "--norm-file", pair["norm"], "--init-wts", pair["init"],
            "--out-dir", str(out), "--layersizes", SIZES,
            "--epochs", str(epochs), "--seed", "11", "--traincache", "512",
            "--train-sents", "0-7", "--cv-sents", "8-9", "--device", "cpu",
            *extra]


def two_ranks(argv, timeout=240, module=True, **kw):
    """Both ranks of an explicit two-rank gloo cluster on the CPU."""
    port = free_port()
    front = ["-m", "tpu_se_torch", "train"] if module else [WORKER, "train"]
    return run_ranks(
        lambda k: [*front, *argv, "--coordinator", f"127.0.0.1:{port}",
                   "--num-processes", "2", "--process-id", str(k),
                   "--cpu-collectives", "gloo"], 2, timeout=timeout, **kw)


@pytest.fixture(scope="module")
def two_rank_run(pair, tmp_path_factory):
    out = tmp_path_factory.mktemp("two_ranks") / "out"
    codes, logs = two_ranks(train_argv(pair, out))
    assert codes == [0, 0], "\n".join(logs)
    return out, logs


def _assert_weights_close(got_path, want_layers):
    got = read_wts(got_path)
    worst = 0.0
    for g, w in zip(got, want_layers):
        for k in ("w", "b"):
            np.testing.assert_allclose(g[k], w[k], rtol=2e-5, atol=1e-6)
            worst = max(worst, float(np.abs(g[k] - w[k]).max()))
    return worst


def test_two_rank_training_matches_one_process(pair, two_rank_run, tmp_path):
    out, logs = two_rank_run
    cfg = train.TrainConfig(
        fea_file=pair["fea"], targ_file=pair["targ"], norm_file=pair["norm"],
        init_wts_file=pair["init"], out_dir=str(tmp_path / "one"),
        layersizes=(1799, 64, 257), epochs=2, init_seed=11, traincache=512,
        train_sent_range=(0, 7), cv_sent_range=(8, 9))
    train.run_training(cfg, "cpu", log=lambda s: None)
    for e in (1, 2):
        _assert_weights_close(out / f"mlp.{e}.wts",
                              read_wts(tmp_path / "one" / f"mlp.{e}.wts"))
    for rank, log in enumerate(logs):
        assert f"data mesh: data=2, model=1, rank {rank} on cpu (gloo)" in log
        assert "replicas equal at 2 epoch ends" in log
        assert "ggd_colsum 0 launches" in log      # the CPU ran plain


def test_two_rank_training_matches_tpu_se_under_a_mesh(pair, two_rank_run,
                                                      tmp_path):
    out, _ = two_rank_run
    cfg = ref_train.TrainConfig(
        fea_file=pair["fea"], targ_file=pair["targ"], norm_file=pair["norm"],
        init_wts_file=pair["init"], out_dir=str(tmp_path / "jax"),
        layersizes=(1799, 64, 257), epochs=2, init_seed=11, traincache=512,
        train_sent_range=(0, 7), cv_sent_range=(8, 9),
        mesh=ref_make_mesh(2, 1, devices=jax.devices()[:2]))
    final = ref_train.run_training(cfg, log=lambda s: None)
    _assert_weights_close(out / "mlp.2.wts", ref_io.read_wts(final))


def test_only_rank_0_writes(two_rank_run):
    out, logs = two_rank_run
    assert sorted(os.listdir(out)) == [
        "metrics.jsonl", "mlp.1.log", "mlp.1.wts", "mlp.2.log", "mlp.2.wts"]
    with open(out / "metrics.jsonl") as f:
        assert len(f.read().splitlines()) == 2      # one record per epoch
    assert all(f"final weights: {out}/mlp.2.wts" in log for log in logs)


def test_two_rank_rerun_is_byte_identical(pair, two_rank_run, tmp_path):
    out, _ = two_rank_run
    codes, logs = two_ranks(train_argv(pair, tmp_path / "again"))
    assert codes == [0, 0], "\n".join(logs)
    for e in (1, 2):
        assert ((tmp_path / "again" / f"mlp.{e}.wts").read_bytes()
                == (out / f"mlp.{e}.wts").read_bytes())


def test_mesh_data_flag_runs_the_two_ranks_itself(pair, two_rank_run,
                                                  tmp_path):
    out, _ = two_rank_run
    codes, logs = run_ranks(
        lambda k: ["-m", "tpu_se_torch", "train",
                   *train_argv(pair, tmp_path / "local",
                               extra=["--mesh-data", "2"])], 1, timeout=240)
    assert codes == [0], logs[0]
    assert "data mesh: starting 2 local ranks on cpu" in logs[0]
    assert logs[0].count("epoch 2: sq=") == 1       # rank 1 stays quiet
    for e in (1, 2):
        assert ((tmp_path / "local" / f"mlp.{e}.wts").read_bytes()
                == (out / f"mlp.{e}.wts").read_bytes())


def test_bptrain_mesh_data_runs_the_two_ranks_itself(pair, two_rank_run,
                                                     tmp_path):
    out, _ = two_rank_run
    argv = ["-m", "tpu_se_torch", "bptrain", f"layersizes={SIZES}",
            "bunchsize=128", "MLflag=1", "shapefactor=1", "lrate=0.1",
            "traincache=512", "init_randem_seed=11",
            f"initwts_file={pair['init']}", f"norm_file={pair['norm']}",
            f"fea_file={pair['fea']}", f"targ_file={pair['targ']}",
            f"outwts_file={tmp_path}/mlp.1.wts",
            f"log_file={tmp_path}/mlp.1.log", "train_sent_range=0-7",
            "cv_sent_range=8-9", "mesh_data=2", "device=cpu"]
    codes, logs = run_ranks(lambda k: argv, 1, timeout=240)
    assert codes == [0], logs[0]
    assert sorted(os.listdir(tmp_path)) == ["mlp.1.log", "mlp.1.wts"]
    assert ((tmp_path / "mlp.1.wts").read_bytes()
            == (out / "mlp.1.wts").read_bytes())
    log = (tmp_path / "mlp.1.log").read_text()
    assert "mesh_data: 2" in log and "CV2 over. CV log likelihood" in log


def test_two_rank_midepoch_kill_resume_is_byte_exact(pair, tmp_path):
    """Both ranks ``os._exit(7)`` on their 4th chunk dispatch (chunks 1-3
    trained, the partial checkpoint of chunk 3 committed by rank 0); the
    restarted ranks both resume from what rank 0 committed."""
    def argv(out):
        return train_argv(pair, out, epochs=1, extra=[
            "--layersizes", "1799,32,257", "--init-wts", "",
            "--traincache", "256", "--bunchsize", "32",
            "--checkpoint-every-chunks", "1"])

    codes, logs = two_ranks(argv(tmp_path / "a"), module=False)
    assert codes == [0, 0], "\n".join(logs)
    want = (tmp_path / "a" / "mlp.1.wts").read_bytes()

    codes, logs = two_ranks(
        argv(tmp_path / "b"), module=False, expect_failure=True,
        env={"TPU_SE_TORCH_CRASH_AFTER_CHUNKS": "3"})
    assert codes == [7, 7], (codes, "\n".join(logs))
    assert (tmp_path / "b" / "mlp.1.partial.wts.meta.json").exists()
    assert (tmp_path / "b" / "mlp.1.partial.3.wts").exists()
    assert not (tmp_path / "b" / "mlp.1.wts").exists()

    codes, logs = two_ranks(argv(tmp_path / "b"), module=False)
    assert codes == [0, 0], "\n".join(logs)
    for log in logs:
        assert "resuming mid-epoch at chunk 3" in log, log
    assert (tmp_path / "b" / "mlp.1.wts").read_bytes() == want
    assert sorted(os.listdir(tmp_path / "b")) == [
        "metrics.jsonl", "mlp.1.log", "mlp.1.wts"]


def test_a_bunch_the_ranks_cannot_split_stops_the_run(pair, tmp_path):
    codes, logs = two_ranks(
        train_argv(pair, tmp_path / "out", extra=["--bunchsize", "33"]),
        timeout=90, expect_failure=True)
    assert all(code != 0 for code in codes), "\n".join(logs)
    assert all("bunchsize 33 does not split evenly over 2 ranks" in log
               for log in logs)
    assert not (tmp_path / "out" / "mlp.1.wts").exists()
