"""tpu_se_torch.io and tpu_se_torch.bench against the reference codecs.

The port's codecs (wav, raw, HTK, pfile, ``.norm``, ``.wts``) are numpy
copies of ``tpu_se.io``'s: every file written here must be byte-identical
to the reference writer's (the streaming ``PfileWriter`` and
``concat_pfiles`` included, at any block size), every file read must give
identical arrays, and ``compute_norm_pfile`` must give identical
statistics.  ``ordered_readahead`` keeps order and raises where the item
failed.
"""

import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_se.io as ref_io
import tpu_se.io.norm as ref_norm
import tpu_se.io.pfile as ref_pfile
import tpu_se.io.wav as ref_wav
from tpu_se_torch import io
from tpu_se_torch.bench import fixtures
from tpu_se_torch.models import init_params

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _wave(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) * 8000).clip(-32768, 32767).astype(np.int16)


@pytest.mark.parametrize("rate,n", [(8000, 1), (11025, 777), (16000, 16000)])
def test_write_wav_bytes_match_reference(tmp_path, rate, n):
    wave = _wave(n, seed=n)
    io.write_wav(tmp_path / "port.wav", wave, rate)
    ref_io.write_wav(tmp_path / "ref.wav", wave, rate)
    assert ((tmp_path / "port.wav").read_bytes()
            == (tmp_path / "ref.wav").read_bytes())
    got, sr = io.read_wav(tmp_path / "ref.wav")
    assert sr == rate and got.dtype == np.int16
    np.testing.assert_array_equal(got, wave)


def _riff_stereo_with_list_chunk(path, left, right, rate):
    data = np.stack([left, right], axis=1).astype("<i2").tobytes()
    extra = b"INFOabc"                       # odd size: padded to even
    with open(path, "wb") as f:
        f.write(struct.pack("<4sI4s", b"RIFF", 0, b"WAVE"))
        f.write(struct.pack("<4sI", b"LIST", len(extra)) + extra + b"\0")
        f.write(struct.pack("<4sIHHIIHH", b"fmt ", 16, 1, 2, rate,
                            rate * 4, 4, 16))
        f.write(struct.pack("<4sI", b"data", len(data)) + data)


def _nist(path, wave, rate, byte_format):
    header = (f"NIST_1A\n   1024\nsample_rate -i {rate}\n"
              f"sample_byte_format -s2 {byte_format}\nend_head\n").encode()
    dtype = ">i2" if byte_format == "10" else "<i2"
    with open(path, "wb") as f:
        f.write(header.ljust(1024, b" "))
        f.write(wave.astype(dtype).tobytes())


@pytest.mark.parametrize("kind", ["riff-stereo-list", "nist-le", "nist-be"])
def test_read_wav_matches_reference(tmp_path, kind):
    path = tmp_path / "in.wav"
    wave = _wave(501, seed=7)
    if kind == "riff-stereo-list":
        _riff_stereo_with_list_chunk(path, wave, _wave(501, seed=8), 11025)
    else:
        _nist(path, wave, 8000, "01" if kind == "nist-le" else "10")
    got, sr = io.read_wav(path)
    want, sr_ref = ref_io.read_wav(path)
    assert sr == sr_ref
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, wave)


def test_read_wav_rejects_unknown_container(tmp_path):
    (tmp_path / "x.wav").write_bytes(b"OggS" + bytes(40))
    with pytest.raises(ValueError, match="not a RIFF/WAVE or NIST"):
        io.read_wav(tmp_path / "x.wav")


@pytest.mark.parametrize("with_headers", [True, False])
def test_norm_bytes_match_reference(tmp_path, with_headers):
    rng = np.random.default_rng(3)
    mean = rng.standard_normal(257).astype(np.float32) * 10
    inv_std = rng.uniform(0.05, 2.0, 257).astype(np.float32)
    io.write_norm(tmp_path / "port.norm", mean, inv_std, with_headers)
    ref_io.write_norm(tmp_path / "ref.norm", mean, inv_std, with_headers)
    assert ((tmp_path / "port.norm").read_bytes()
            == (tmp_path / "ref.norm").read_bytes())
    for got, want in zip(io.read_norm(tmp_path / "ref.norm"),
                         ref_io.read_norm(tmp_path / "ref.norm", 257)):
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_read_norm_rejects_wrong_count(tmp_path):
    (tmp_path / "odd.norm").write_text("1\n2\n3\n")
    with pytest.raises(ValueError, match="odd number"):
        io.read_norm(tmp_path / "odd.norm")
    with pytest.raises(ValueError, match="expected 4 values"):
        io.read_norm(tmp_path / "odd.norm", 2)


@pytest.mark.parametrize("layersizes", [(1799, 64, 64, 257), (903, 32, 129)])
def test_wts_bytes_match_reference(tmp_path, layersizes):
    layers = init_params(5, layersizes)
    io.write_wts(tmp_path / "port.wts", layers)
    ref_io.write_wts(tmp_path / "ref.wts", layers)
    assert ((tmp_path / "port.wts").read_bytes()
            == (tmp_path / "ref.wts").read_bytes())
    for got, want in zip(io.read_wts(tmp_path / "ref.wts"),
                         ref_io.read_wts(tmp_path / "ref.wts")):
        for key in ("w", "b"):
            assert got[key].dtype == np.float32
            np.testing.assert_array_equal(got[key], want[key])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["port.wts",
                                                          "ref.wts"]


def test_write_wts_failure_leaves_no_file(tmp_path):
    bad = [{"w": np.zeros((4, 3), np.float32), "b": np.zeros(2, np.float32)}]
    with pytest.raises(ValueError, match="shape mismatch"):
        io.write_wts(tmp_path / "bad.wts", bad)
    assert list(tmp_path.iterdir()) == []


def test_fixtures_are_readable_by_the_reference(tmp_path):
    fx = fixtures.write_fixtures(str(tmp_path), layersizes=(1799, 8, 257))
    layers = ref_io.read_wts(fx["wts"])
    assert [layer["w"].shape for layer in layers] == [(1799, 8), (8, 257)]
    mean, inv_std = ref_io.read_norm(fx["norm"], 257)
    assert np.isfinite(mean).all() and (inv_std > 0).all()
    noisy = open(fx["scp"]).read().split()
    clean = open(fx["cscp"]).read().split()
    assert len(noisy) == len(clean) == len(fixtures.UTT_SAMPLES)
    for path, wave, n in zip(noisy, fx["waves"], fixtures.UTT_SAMPLES):
        ref, sr = ref_io.read_wav(path)
        assert sr == fixtures.SAMPLE_RATE and len(ref) == n
        np.testing.assert_array_equal(ref, wave)
    x, n_valid, frames = fixtures.pad_batch(fx["waves"], "cpu")
    ts = [n // fixtures.SHIFT - 1 for n in fixtures.UTT_SAMPLES]
    assert x.dtype == torch.int16
    assert tuple(x.shape) == (len(ts), (max(ts) + 1) * fixtures.SHIFT)
    assert n_valid.tolist() == ts and frames == sum(ts)


@pytest.mark.parametrize("no_header", [False, True])
@pytest.mark.parametrize("shape,period", [((0, 257), 160000),
                                          ((37, 257), 480000),
                                          ((5, 129), 160000), ((3, 1), 625)])
def test_write_htk_bytes_match_reference(tmp_path, shape, period, no_header):
    data = (np.random.default_rng(shape[0]).standard_normal(shape) * 9
            ).astype(np.float32)
    io.write_htk(tmp_path / "port.htk", data, samp_period=period,
                 no_header=no_header)
    ref_io.write_htk(tmp_path / "ref.htk", data, samp_period=period,
                     no_header=no_header)
    assert ((tmp_path / "port.htk").read_bytes()
            == (tmp_path / "ref.htk").read_bytes())
    if no_header:
        return
    got, hdr = io.read_htk(tmp_path / "ref.htk")
    want, ref_hdr = ref_io.read_htk(str(tmp_path / "ref.htk"))
    assert (hdr.n_samples, hdr.samp_period, hdr.samp_size, hdr.param_kind,
            hdr.n_dim) == (ref_hdr.n_samples, ref_hdr.samp_period,
                           ref_hdr.samp_size, ref_hdr.param_kind,
                           ref_hdr.n_dim)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, data)
    assert (io.frames_in_htk_file(tmp_path / "ref.htk", shape[1])
            == ref_io.frames_in_htk_file(str(tmp_path / "ref.htk"), shape[1])
            == shape[0])
    with pytest.raises(ValueError, match="expected"):
        io.write_htk(tmp_path / "bad.htk", data.ravel())


@pytest.mark.parametrize("swap", [False, True])
def test_raw_and_htk_waveform_match_reference(tmp_path, swap):
    wave = _wave(999, seed=int(swap))
    io.write_raw(tmp_path / "port.raw", wave, swap=swap)
    ref_io.write_raw(tmp_path / "ref.raw", wave, swap=swap)
    assert ((tmp_path / "port.raw").read_bytes()
            == (tmp_path / "ref.raw").read_bytes())
    got = io.read_raw(tmp_path / "ref.raw", swap=swap)
    assert got.dtype == np.int16
    np.testing.assert_array_equal(got, ref_io.read_raw(tmp_path / "ref.raw",
                                                       swap=swap))
    np.testing.assert_array_equal(got, wave)
    for period, rate in ((625, 16000), (1250, 8000), (907, 11020)):
        path = tmp_path / f"w{period}.htk"
        path.write_bytes(struct.pack(">iihh", len(wave), period, 2, 0)
                         + wave.astype(">i2").tobytes())
        got, sr = io.read_htk_waveform(path)
        want, sr_ref = ref_wav.read_htk_waveform(path)
        assert sr == sr_ref == rate
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, wave)


def _utts(lengths, dim=257, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, dim)) * 3 + 1).astype(np.float32)
            for n in lengths]


@pytest.mark.parametrize("lengths,dim", [([4, 0, 9], 257), ([1], 3),
                                         ([40, 17], 129)])
def test_pfile_writer_matches_reference(tmp_path, lengths, dim):
    utts = _utts(lengths, dim, seed=dim)
    for path, writer in ((tmp_path / "port.pfile", io.PfileWriter),
                         (tmp_path / "ref.pfile", ref_io.PfileWriter)):
        with writer(path) as w:
            for u in utts:
                w.add(u)
            assert (w.num_sentences, w.num_frames) == (len(lengths),
                                                       sum(lengths))
    want = (tmp_path / "ref.pfile").read_bytes()
    assert (tmp_path / "port.pfile").read_bytes() == want
    io.write_pfile(tmp_path / "one.pfile", utts)
    assert (tmp_path / "one.pfile").read_bytes() == want
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "one.pfile", "port.pfile", "ref.pfile"]


def test_pfile_writer_raw_rows_match_reference(tmp_path):
    """add_raw_rows with and without id columns given, then
    end_raw_sentences; the caller's array is not changed."""
    src = tmp_path / "src.pfile"
    ref_io.write_pfile(src, _utts([5, 8, 3], seed=1))
    n_sents, n_frames, dim, ends = ref_io.read_pfile_meta(src)
    raw = np.fromfile(src, ">i4", offset=io.PFILE_HEADER_SIZE,
                      count=n_frames * (2 + dim)).reshape(n_frames, 2 + dim)
    before = raw.copy()
    for path, writer in ((tmp_path / "port.pfile", io.PfileWriter),
                         (tmp_path / "ref.pfile", ref_io.PfileWriter)):
        with writer(path) as w:
            w.add(_utts([2], seed=2)[0])
            w.add_raw_rows(raw, dim, sent_ids=np.repeat([1, 2, 3], [5, 8, 3]),
                           frame_ids=np.arange(n_frames) % 7)
            w.add_raw_rows(raw[:6].tobytes(), dim)
            w.end_raw_sentences([5, 8, 3, 6])
    assert ((tmp_path / "port.pfile").read_bytes()
            == (tmp_path / "ref.pfile").read_bytes())
    np.testing.assert_array_equal(raw, before)
    pf = io.read_pfile(tmp_path / "port.pfile")
    np.testing.assert_array_equal(pf.sent_ends, [2, 7, 15, 18, 24])
    np.testing.assert_array_equal(pf.frame_ids[2:18],
                                  np.arange(16) % 7)


def test_pfile_writer_abort_and_errors_leave_nothing(tmp_path):
    w = io.PfileWriter(tmp_path / "a.pfile")
    w.add(_utts([3])[0])
    w.abort()
    w.abort()                                    # idempotent
    w.close()                                    # no-op after abort
    with pytest.raises(ValueError, match="inconsistent"):
        with io.PfileWriter(tmp_path / "b.pfile") as w:
            w.add(_utts([3], dim=5)[0])
            w.add(_utts([3], dim=6)[0])
    with pytest.raises(ValueError, match="no utterances"):
        io.PfileWriter(tmp_path / "c.pfile").close()
    with pytest.raises(ValueError, match=r"must be \[T, D\]"):
        io.PfileWriter(tmp_path / "d.pfile").add(np.zeros(4, np.float32))
    with pytest.raises(ValueError, match="inconsistent feature dims across "
                                         "inputs"):
        w = io.PfileWriter(tmp_path / "e.pfile")
        try:
            w.add(_utts([2], dim=4)[0])
            w.add_raw_rows(b"", 5)
        finally:
            w.abort()
    with pytest.raises(ValueError, match="no utterances"):
        io.write_pfile(tmp_path / "f.pfile", [])
    leftover = [p.name for p in tmp_path.iterdir() if not p.name.startswith("d.")]
    assert leftover == []


def _noncanonical_pfile(path):
    """A pfile whose id columns are not 0..n-1 / 0..T-1."""
    io.write_pfile(path, _utts([6, 4], dim=7, seed=3))
    data = bytearray(path.read_bytes())
    rows = np.frombuffer(bytes(data[io.PFILE_HEADER_SIZE:
                                    io.PFILE_HEADER_SIZE + 10 * 9 * 4]),
                         ">i4").reshape(10, 9).copy()
    rows[:, 0] = 42
    rows[:, 1] = np.arange(100, 110)
    data[io.PFILE_HEADER_SIZE: io.PFILE_HEADER_SIZE + rows.nbytes] = \
        rows.tobytes()
    path.write_bytes(bytes(data))


@pytest.mark.parametrize("case", ["single", "multi-block", "noncanonical"])
def test_concat_pfiles_matches_reference(tmp_path, monkeypatch, case):
    if case == "single":
        inputs = [tmp_path / "a.pfile"]
        io.write_pfile(inputs[0], _utts([9, 3, 11], seed=4))
    elif case == "multi-block":
        # Blocks of 5 rows, so blocks straddle sentence and file ends.
        monkeypatch.setattr(io.pfile, "STREAM_BLOCK_FRAMES", 5)
        monkeypatch.setattr(ref_pfile, "STREAM_BLOCK_FRAMES", 5)
        inputs = [tmp_path / "a.pfile", tmp_path / "b.pfile"]
        io.write_pfile(inputs[0], _utts([9, 3, 11], seed=4))
        io.write_pfile(inputs[1], _utts([1, 17], seed=5))
        inputs.append(inputs[0])
    else:
        inputs = [tmp_path / "a.pfile", tmp_path / "n.pfile"]
        io.write_pfile(inputs[0], _utts([2, 5], dim=7, seed=6))
        _noncanonical_pfile(inputs[1])
    io.concat_pfiles(tmp_path / "port.pfile", inputs)
    ref_io.concat_pfiles(str(tmp_path / "ref.pfile"), [str(p) for p in inputs])
    got = (tmp_path / "port.pfile").read_bytes()
    assert got == (tmp_path / "ref.pfile").read_bytes()
    pf = io.read_pfile(tmp_path / "port.pfile")
    starts = np.concatenate([[0], pf.sent_ends[:-1]])
    sent = np.searchsorted(pf.sent_ends, np.arange(pf.num_frames),
                           side="right")
    np.testing.assert_array_equal(pf.sent_ids, sent)
    np.testing.assert_array_equal(pf.frame_ids,
                                  np.arange(pf.num_frames) - starts[sent])


@pytest.mark.parametrize("block", [1, 7, None])
def test_compute_norm_pfile_matches_reference(tmp_path, block):
    path = tmp_path / "x.pfile"
    io.write_pfile(path, _utts([30, 1, 44], seed=8))
    mean, inv_std = io.compute_norm_pfile(path, block)
    want = ref_norm.compute_norm_pfile(str(path), block)
    np.testing.assert_array_equal(mean, want[0])
    np.testing.assert_array_equal(inv_std, want[1])
    io.write_norm(tmp_path / "port.norm", mean, inv_std)
    ref_io.write_norm(tmp_path / "ref.norm", *want)
    assert ((tmp_path / "port.norm").read_bytes()
            == (tmp_path / "ref.norm").read_bytes())
    frames = np.concatenate(_utts([30, 1, 44], seed=8))
    for got, ref in zip(io.compute_norm(frames),
                        ref_norm.compute_norm(frames)):
        np.testing.assert_array_equal(got, ref)


def test_ordered_readahead_keeps_order_and_raises(monkeypatch):
    import threading
    import time

    seen = []
    lock = threading.Lock()

    def slow(i):
        time.sleep(0.002 * ((7 * i) % 5))
        with lock:
            seen.append(i)
        return i * i

    for jobs in (0, 1, 3):
        seen.clear()
        assert list(io.ordered_readahead(range(20), slow, jobs)) == [
            i * i for i in range(20)]
        assert sorted(seen) == list(range(20))

    def fail_at_5(i):
        if i == 5:
            raise KeyError("item 5")
        return i

    got = []
    with pytest.raises(KeyError, match="item 5"):
        for x in io.ordered_readahead(range(10), fail_at_5, 4):
            got.append(x)
    assert got == [0, 1, 2, 3, 4]
    assert list(io.ordered_readahead([], slow, 4)) == []


@pytest.mark.parametrize("argv", [
    [sys.executable, "chip_smoke.py"],
    [sys.executable, "-m", "tpu_se_torch.bench.profile_decode"],
], ids=["chip_smoke", "profile_decode"])
def test_card_scripts_refuse_without_cuda(argv):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
