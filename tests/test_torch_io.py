"""tpu_se_torch.io and tpu_se_torch.bench against the reference codecs.

The port's wav, ``.norm`` and ``.wts`` codecs are numpy copies of
``tpu_se.io``'s: every file written here must be byte-identical to the
reference writer's, and every file read must give identical arrays.
"""

import pathlib
import struct
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_se.io as ref_io
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
