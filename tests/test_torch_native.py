"""The port's host chunk loader (``tpu_se_torch.io.native``) on the CPU.

The library is built here, with the host compiler, from
``tpu_se_torch/csrc/chunk_loader.cc`` at first use.  Everything is held
bit for bit (float32 bit patterns, not a tolerance: the C loop does one
float32 subtraction and one float32 product per element, as numpy does):

- the cases of ``tests/test_native.py`` that need no reference tree:
  splice/scatter with and without scatter, gather targets, against numpy;
  and the byte swap the library binds;
- ``read_chunk_normalized`` on pfiles written by ``tpu_se``'s
  ``write_pfile``/``write_norm``: the port's numpy route, and ``tpu_se``'s
  ``PfilePairDataset(use_native=False)._read_normalized``;
- chunks, ``load_span_normalized`` and ``load_span_shard`` through
  ``use_native=None`` and ``False``;
- a one-epoch ``train --device cpu`` (resident frames) and a per-chunk
  ``run_training`` write the same ``.wts`` bytes by either route;
- a compiler that cannot run raises from every entry point, the dataset
  included: nothing falls back to numpy; builds started at once by many
  threads end in one whole library.
"""

import ctypes
import functools
import threading

import numpy as np
import pytest

import tpu_se.data as ref_data
import tpu_se.io as ref_io
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.data import PfilePairDataset
from tpu_se_torch.io import PFILE_HEADER_SIZE, native, read_pfile_rows
from tpu_se_torch.ops import _build
from tpu_se_torch.train import TrainConfig, run_training
from tpu_se_torch.train import loop as loop_mod

DIM = 257


def _bits(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)


def test_native_splice_scatter():
    rng = np.random.default_rng(0)
    frames = rng.normal(size=(50, 5)).astype(np.float32)
    starts = np.array([0, 10, 20, 3], dtype=np.int32)
    scatter = np.array([2, 0, 3, 1], dtype=np.int32)
    out = native.splice_scatter(frames, starts, scatter, context=3)
    assert out.shape == (4, 15)
    want = np.empty_like(out)
    for s, d in zip(starts, scatter):
        want[d] = frames[s:s + 3].ravel()
    np.testing.assert_array_equal(_bits(out), _bits(want))
    # Identity order without a scatter.
    out2 = native.splice_scatter(frames, starts, None, context=3)
    np.testing.assert_array_equal(
        _bits(out2), _bits(np.stack([frames[s:s + 3].ravel()
                                     for s in starts])))


@pytest.mark.parametrize("scatter", [None, [1, 2, 0]])
def test_native_gather_targets(scatter):
    rng = np.random.default_rng(1)
    frames = rng.normal(size=(30, 4)).astype(np.float32)
    starts = np.array([0, 5, 9], dtype=np.int32)
    out = native.gather_targets(frames, starts, scatter, offset=3)
    want = frames[starts + 3]
    if scatter is not None:
        want = want[np.argsort(scatter)]
    np.testing.assert_array_equal(_bits(out), _bits(want))


@pytest.mark.parametrize("call,match", [
    (lambda f: native.splice_scatter(f, np.array([8]), None, 3),
     "outside 10 frames"),
    (lambda f: native.splice_scatter(f, np.array([-1]), None, 3),
     "outside 10 frames"),
    (lambda f: native.splice_scatter(f, np.array([0, 1]),
                                     np.array([0, 0]), 3), "permutation"),
    (lambda f: native.gather_targets(f, np.array([7]), None, 3),
     "outside 10 frames"),
    (lambda f: native.gather_targets(f, np.array([0]), None, -1),
     "negative"),
], ids=["past-end", "negative-start", "not-a-permutation", "target-past-end",
        "negative-offset"])
def test_native_windows_are_checked_before_the_call(call, match):
    with pytest.raises(ValueError, match=match):
        call(np.zeros((10, 2), np.float32))


def test_native_bswap_binding():
    rng = np.random.default_rng(2)
    values = (rng.standard_normal(1001) * 1e3).astype(np.float32)
    values[:3] = [0.0, -0.0, np.inf]
    raw = np.ascontiguousarray(values.astype(">f4").view(np.uint32))
    out = np.empty(len(raw), np.float32)
    lib = native._load()
    lib.tpuse_bswap_f32(raw.ctypes.data_as(
        lib.tpuse_bswap_f32.argtypes[0]), len(raw), native._fp(out))
    np.testing.assert_array_equal(_bits(out), _bits(values))


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 12-sentence noisy/clean pfile pair and its .norm, written by
    tpu_se's writers (LPS-like: a few tens around a mean of 10)."""
    root = tmp_path_factory.mktemp("native")
    rng = np.random.default_rng(3)
    lengths = [40, 75, 9, 130, 52, 61, 88, 17, 120, 33, 70, 64]
    noisy = [(rng.standard_normal((n, DIM)) * 4 + 10).astype(np.float32)
             for n in lengths]
    clean = [(u * 0.7 - 1).astype(np.float32) for u in noisy]
    paths = {k: str(root / f"{k}.pfile") for k in ("noisy", "clean")}
    ref_io.write_pfile(paths["noisy"], noisy)
    ref_io.write_pfile(paths["clean"], clean)
    frames = np.concatenate(noisy)
    paths["norm"] = str(root / "noisy.norm")
    ref_io.write_norm(paths["norm"], frames.mean(0), 1.0 / frames.std(0))
    return paths


@pytest.mark.parametrize("lo,hi", [(0, 1), (100, 400), (0, 759), (758, 759),
                                   (5, 5)])
def test_read_chunk_normalized_bitwise_numpy_and_tpu_se(pair, lo, hi):
    ours = PfilePairDataset(pair["noisy"], pair["clean"], pair["norm"],
                            (0, 11), use_native=False)
    theirs = ref_data.PfilePairDataset(pair["noisy"], pair["clean"],
                                       pair["norm"], (0, 11),
                                       use_native=False)
    for path in (pair["noisy"], pair["clean"]):
        got = native.read_chunk_normalized(path, PFILE_HEADER_SIZE, DIM, lo,
                                           hi, ours.mean, ours.inv_std)
        assert got.shape == (hi - lo, DIM) and got.dtype == np.float32
        np.testing.assert_array_equal(
            _bits(got), _bits(ours._read_normalized(path, DIM, lo, hi)))
        np.testing.assert_array_equal(
            _bits(got), _bits(theirs._read_normalized(path, DIM, lo, hi)))
        rows = read_pfile_rows(path, DIM, lo, hi)
        np.testing.assert_array_equal(
            _bits(got), _bits((rows - ours.mean) * ours.inv_std))


def test_read_chunk_normalized_refusals(pair):
    ds = PfilePairDataset(pair["noisy"], pair["clean"], pair["norm"], (0, 11))
    with pytest.raises(IOError, match="rc=3"):
        native.read_chunk_normalized(pair["noisy"], PFILE_HEADER_SIZE, DIM,
                                     700, 800, ds.mean, ds.inv_std)
    with pytest.raises(IOError, match="rc=1"):
        native.read_chunk_normalized(pair["noisy"] + ".missing",
                                     PFILE_HEADER_SIZE, DIM, 0, 1, ds.mean,
                                     ds.inv_std)
    with pytest.raises(ValueError, match="frame range"):
        native.read_chunk_normalized(pair["noisy"], PFILE_HEADER_SIZE, DIM,
                                     5, 4, ds.mean, ds.inv_std)
    with pytest.raises(ValueError, match="statistics"):
        native.read_chunk_normalized(pair["noisy"], PFILE_HEADER_SIZE, DIM,
                                     0, 1, ds.mean[:9], ds.inv_std)


@pytest.mark.parametrize("what", ["chunks", "span", "shard0", "shard1",
                                  "shard2"])
def test_dataset_routes_are_bitwise_equal(pair, what):
    args = (pair["noisy"], pair["clean"], pair["norm"], (1, 10), 256)
    by_lib = PfilePairDataset(*args)
    assert by_lib.use_native
    by_numpy = PfilePairDataset(*args, use_native=False)
    if what == "chunks":
        assert by_lib.n_chunks > 1
        got = [by_lib.chunk(i, np.random.default_rng(i))
               for i in range(by_lib.n_chunks)]
        want = [by_numpy.chunk(i, np.random.default_rng(i))
                for i in range(by_numpy.n_chunks)]
        pairs = [(g.noisy, w.noisy) for g, w in zip(got, want)] + [
            (g.clean, w.clean) for g, w in zip(got, want)]
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.starts, w.starts)
    elif what == "span":
        pairs = list(zip(by_lib.load_span_normalized(),
                         by_numpy.load_span_normalized()))
    else:
        k = int(what[-1])
        pairs = list(zip(by_lib.load_span_shard(k, 3),
                         by_numpy.load_span_shard(k, 3)))
    for got, want in pairs:
        assert got.size
        np.testing.assert_array_equal(_bits(got), _bits(want))


def _numpy_route(monkeypatch):
    monkeypatch.setattr(loop_mod, "PfilePairDataset", functools.partial(
        PfilePairDataset, use_native=False))


@pytest.mark.parametrize("form", ["train-cli-resident", "per-chunk"])
def test_training_writes_the_same_bytes_by_either_route(pair, tmp_path,
                                                        monkeypatch, form):
    def train(out_dir):
        if form == "per-chunk":
            return run_training(TrainConfig(
                fea_file=pair["noisy"], targ_file=pair["clean"],
                norm_file=pair["norm"], out_dir=str(out_dir),
                layersizes=(1799, 16, DIM), train_sent_range=(0, 9),
                cv_sent_range=(10, 11), traincache=256, epochs=1,
                device_resident="never"), "cpu", log=lambda s: None)
        assert cli_main([
            "train", "--fea-file", pair["noisy"], "--targ-file",
            pair["clean"], "--norm-file", pair["norm"], "--out-dir",
            str(out_dir), "--layersizes", f"1799,16,{DIM}",
            "--train-sents", "0-9", "--cv-sents", "10-11", "--traincache",
            "256", "--epochs", "1", "--device", "cpu"]) == 0
        return str(out_dir / "mlp.1.wts")

    by_lib = train(tmp_path / "native")
    _numpy_route(monkeypatch)
    by_numpy = train(tmp_path / "numpy")
    with open(by_lib, "rb") as a, open(by_numpy, "rb") as b:
        assert a.read() == b.read()


def test_a_failing_compiler_raises_instead_of_reading_with_numpy(
        pair, monkeypatch, tmp_path):
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-c++"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    native._load.cache_clear()
    try:
        assert not native.available()
        with pytest.raises(RuntimeError, match="cannot run"):
            native.splice_scatter(np.zeros((4, 2), np.float32),
                                  np.array([0]), None, 2)
        ds = PfilePairDataset(pair["noisy"], pair["clean"], pair["norm"],
                              (0, 11))
        with pytest.raises(RuntimeError, match="no-such-c"):
            ds.chunk(0)
        with pytest.raises(RuntimeError, match="no-such-c"):
            ds.load_span_normalized()
        # A compiler that runs and fails: its output is in the message.
        fails = tmp_path / "fails"
        fails.write_text("#!/bin/sh\necho 'broken compiler' >&2\nexit 3\n")
        fails.chmod(0o755)
        monkeypatch.setenv("CXX", str(fails))
        with pytest.raises(RuntimeError, match=r"failed \(3\)"
                                               r"(.|\n)*broken compiler"):
            native._load()
        assert not list((tmp_path / "build").glob("*"))
    finally:
        native._load.cache_clear()


def test_builds_started_at_once_end_in_one_library(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    results, errors = [], []

    def build():
        try:
            results.append(_build.build_host_library()[0])
        except Exception as e:      # reported below, with the others
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors and len(set(results)) == 1 and len(results) == 8
    assert sorted(p.name for p in (tmp_path / "build").iterdir()) == [
        results[0].name]
    assert ctypes.CDLL(str(results[0])).tpuse_read_chunk_normalized
