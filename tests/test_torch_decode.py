"""tpu_se_torch.infer against tpu_se.infer on the CPU, and the port's CLI.

Both packages read the same ``.wts``/``.norm`` (written with the
``tpu_se.io`` writers from a seeded model and synthetic waves).
Tolerances: int16 waves within 1 LSB (float32 sums in another order can
flip a truncation); enhanced LPS within atol 1e-3 (the port's LPS sums in
float64, JAX's in float32, ~2e-4 apart on near-empty bins, then the FFN
and blend); info.txt SegSNR/LSD within 1e-3.

Under a data mesh (``Enhancer(mesh=)``, two gloo ranks of
``tests/torch_mp_worker.py``, the twins of ``tests/test_parallel.py:116-219``)
every rank returns the same; against the port's one process the waves are
within 1 LSB and the int16 fast path bitwise, as the reference holds its
sharded decode to its own one device, and the enhanced LPS within rtol
1e-5, atol 1e-5 (a rank's products have fewer rows; measured 4.4e-6);
against ``tpu_se``'s ``Enhancer`` under ``make_mesh(2, 1)`` the waves are
within 1 LSB and the LPS within the same 1e-5.  ``decode --mesh-data 2``
writes one process's files, from rank 0 alone.

``compute_dtype=bfloat16`` decodes are compared by their enhanced LPS.  On
the SAME noisy LPS (``enhance_lps``) the two packages differ only in the
order of their float32 sums, which can round a hidden activation to the
neighbouring bfloat16 value; one such flip moves a de-normalized output by
at most 2^-8 * max|w_last| / min(inv_std) = 3.8e-3, the test's atol
(measured: 1.9e-6, one float32 ulp, where the float32 decode is 4e-3 to
2e-2 away).
Through ``enhance`` the noisy LPS itself differs (float64 against float32
sums, ~2e-4 on near-empty bins), so many inputs round to another bfloat16
value: atol 0.05 on an LPS of scale ~26 (measured 0.011; the bfloat16 and
float32 decodes are 0.02 apart).  bfloat16 waves need not be within 1 LSB
of each other and are not gated.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_se.infer import Enhancer as JaxEnhancer
from tpu_se.infer import decode_files as jax_decode_files
from tpu_se.io import read_wav, write_norm, write_wav, write_wts
from tpu_se.io import read_norm, read_wts
from torch_mp_worker import run_decode_cluster, write_decode_problem
from tpu_se.parallel import make_mesh as ref_make_mesh
from tpu_se_torch.bench.mesh_decode import decode_all
from tpu_se_torch.cli.main import build_parser
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.dsp.analysis import rate_config, wav_to_lps
from tpu_se_torch.infer import Enhancer, decode_files, enhance_utterance
from tpu_se_torch.infer.decode import trunc_int16
from tpu_se_torch.models import init_params
from tpu_se_torch.ops import lps_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPS_ATOL = 1e-3
BF16_LPS_ATOL = 0.05
INFO_ATOL = 1e-3
LENGTHS = (9000, 12345, 6000)
BLENDS = [0.0, 0.4, "auto"]


def _lsb(a, b):
    assert len(a) == len(b)
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()) if d.size else 0


def _waves(rate, seed):
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(LENGTHS):
        t = np.arange(n) / rate
        clean = (2000 * np.sin(2 * np.pi * (150 + 40 * i) * t)
                 + 900 * np.sin(2 * np.pi * 700 * t))
        out.append((clean, clean + 500 * rng.standard_normal(n)))
    return [(c.astype(np.int16), n.astype(np.int16)) for c, n in out]


def _model(tmp, rate, seed):
    bins = rate_config(rate)[2] // 2 + 1
    wts = os.path.join(tmp, f"m{rate}.wts")
    write_wts(wts, init_params(seed, (7 * bins, 64, 64, bins)))
    pairs = _waves(rate, seed)
    lps = np.concatenate([wav_to_lps(n, sample_rate=rate, device="cpu")
                          for _, n in pairs])
    norm = os.path.join(tmp, f"m{rate}.norm")
    write_norm(norm, lps.mean(axis=0), 1.0 / lps.std(axis=0))
    return wts, norm, pairs


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("decode"))
    wts, norm, pairs = _model(tmp, 16000, seed=7)
    noisy_paths, clean_paths = [], []
    for i, (clean, noisy) in enumerate(pairs):
        for kind, wave, paths in (("clean", clean, clean_paths),
                                  ("noisy", noisy, noisy_paths)):
            path = os.path.join(tmp, f"u{i}_{kind}.wav")
            write_wav(path, wave, 16000)
            paths.append(path)
    return {"tmp": tmp, "wts": wts, "norm": norm,
            "noisy": [n for _, n in pairs], "noisy_paths": noisy_paths,
            "clean_paths": clean_paths}


def _pair(fx, **kw):
    return (Enhancer(fx["wts"], fx["norm"], device="cpu", **kw),
            JaxEnhancer(fx["wts"], fx["norm"], **kw))


def _check_triple(got, want):
    wave, recon, enh = got
    assert wave.dtype == np.int16
    assert _lsb(wave, want[0]) <= 1
    assert recon.shape == want[1].shape
    np.testing.assert_allclose(enh, want[2], rtol=0, atol=LPS_ATOL)


@pytest.mark.parametrize("blend", BLENDS)
def test_enhance_matches_jax(fx, blend):
    ours, theirs = _pair(fx, blend=blend)
    for wave in fx["noisy"]:
        got = ours.enhance(wave)
        t = len(wave) // 256 - 1
        assert got[0].shape == (t * 256 + 256,)
        assert got[2].shape == (t, 257)
        _check_triple(got, theirs.enhance(wave))


@pytest.mark.parametrize("blend", BLENDS)
def test_enhance_batch_matches_jax(fx, blend):
    ours, theirs = _pair(fx, blend=blend)
    waves = fx["noisy"] + [fx["noisy"][0][:200]]     # last: no full frame
    got = ours.enhance_batch(waves)
    want = theirs.enhance_batch(waves)
    assert len(got) == len(want) == len(waves)
    assert got[-1][0].shape == want[-1][0].shape == (0,)
    for g, w in zip(got, want):
        _check_triple(g, w)
    assert ours.enhance_batch([]) == theirs.enhance_batch([]) == []
    for g, wave in zip(got, fx["noisy"]):           # batch == single
        assert _lsb(g[0], ours.enhance(wave)[0]) <= 1


@pytest.mark.parametrize("blend", BLENDS)
def test_enhance_batch_waves_matches_jax(fx, blend):
    ours, theirs = _pair(fx, blend=blend)
    got = ours.enhance_batch_waves(fx["noisy"] + [fx["noisy"][0][:200]])
    want = theirs.enhance_batch_waves(fx["noisy"] + [fx["noisy"][0][:200]])
    assert len(got[-1]) == len(want[-1]) == 0
    for g, w in zip(got, want):
        assert g.dtype == np.int16
        assert _lsb(g, w) <= 1


@pytest.mark.parametrize("kw", [
    {"smooth_strength": "auto"},
    {"smooth": True},
    {"postprocess": True},
    {"blend": "auto", "smooth_strength": "auto", "postprocess": True},
], ids=["smooth-auto", "smooth", "postprocess", "quality+postprocess"])
def test_staged_options_match_jax(fx, kw):
    ours, theirs = _pair(fx, **kw)
    for wave in fx["noisy"][:2]:
        _check_triple(ours.enhance(wave), theirs.enhance(wave))
    got = ours.enhance_batch_waves(fx["noisy"][:2])
    want = theirs.enhance_batch_waves(fx["noisy"][:2])
    for g, w in zip(got, want):
        assert _lsb(g, w) <= 1


def test_enhance_lps_matches_jax(fx):
    ours, theirs = _pair(fx, blend="auto")
    lps = wav_to_lps(fx["noisy"][1], device="cpu")
    np.testing.assert_allclose(ours.enhance_lps(lps), theirs.enhance_lps(lps),
                               rtol=0, atol=LPS_ATOL)


@pytest.mark.parametrize("blend", BLENDS)
def test_enhance_lps_bf16_matches_jax(fx, blend):
    import jax.numpy as jnp

    ours = Enhancer(fx["wts"], fx["norm"], device="cpu", blend=blend,
                    compute_dtype="bfloat16")
    theirs = JaxEnhancer(fx["wts"], fx["norm"], blend=blend,
                         compute_dtype=jnp.bfloat16)
    plain = Enhancer(fx["wts"], fx["norm"], device="cpu", blend=blend)
    assert ours.compute_dtype == torch.bfloat16
    assert [w.dtype for w in ours.cast_weights] == [torch.bfloat16] * 3
    assert all(w.dtype == torch.float32 for w in ours.model.weights)
    flip = (2.0 ** -8 * np.abs(read_wts(fx["wts"])[-1]["w"]).max()
            / read_norm(fx["norm"], 257)[1].min())
    for wave in fx["noisy"]:
        lps = wav_to_lps(wave, device="cpu")
        got, want = ours.enhance_lps(lps), theirs.enhance_lps(lps)
        assert got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=flip)
        # The knob is on: the float32 decode is far further away.
        assert (np.abs(plain.enhance_lps(lps) - want).max()
                > 100 * np.abs(got - want).max())


@pytest.mark.parametrize("blend", [0.0, "auto"])
def test_enhance_bf16_matches_jax(fx, blend):
    import jax.numpy as jnp

    ours = Enhancer(fx["wts"], fx["norm"], device="cpu", blend=blend,
                    compute_dtype=torch.bfloat16)
    theirs = JaxEnhancer(fx["wts"], fx["norm"], blend=blend,
                         compute_dtype=jnp.bfloat16)
    for wave in fx["noisy"]:
        got, want = ours.enhance(wave), theirs.enhance(wave)
        assert got[0].dtype == np.int16 and got[0].shape == want[0].shape
        np.testing.assert_allclose(got[2], want[2], rtol=0,
                                   atol=BF16_LPS_ATOL)
    got = ours.enhance_batch(fx["noisy"])
    want = theirs.enhance_batch(fx["noisy"])
    for g, w, wave in zip(got, want, fx["noisy"]):
        np.testing.assert_allclose(g[2], w[2], rtol=0, atol=BF16_LPS_ATOL)
        # batch == single within the port (another product shape).
        np.testing.assert_allclose(g[2], ours.enhance(wave)[2], rtol=0,
                                   atol=BF16_LPS_ATOL)
    # The int16 fast path is the same decode.
    for g, w in zip(ours.enhance_batch_waves(fx["noisy"]), got):
        np.testing.assert_array_equal(g, w[0])


def test_enhancer_compute_dtype_default_and_names(fx):
    wave = fx["noisy"][0]
    default = Enhancer(fx["wts"], fx["norm"], device="cpu")
    assert default.compute_dtype == torch.float32
    assert default.cast_weights is None
    named = Enhancer(fx["wts"], fx["norm"], device="cpu",
                     compute_dtype="float32")
    for a, b in zip(default.enhance(wave), named.enhance(wave)):
        np.testing.assert_array_equal(a, b)
    for bad in ("float16", torch.float16, None):
        with pytest.raises(ValueError, match="unsupported compute dtype"):
            Enhancer(fx["wts"], fx["norm"], device="cpu", compute_dtype=bad)
    got = enhance_utterance(fx["wts"], fx["norm"], wave, device="cpu",
                            compute_dtype="bfloat16")
    want = Enhancer(fx["wts"], fx["norm"], device="cpu",
                    compute_dtype=torch.bfloat16).enhance(wave)[0]
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, default.enhance(wave)[0])


@pytest.mark.parametrize("rate", [8000, 11025])
def test_enhance_low_rates_match_jax(tmp_path, rate):
    """256-point framings: 129 bins; 11 kHz is the 3-hop OLA."""
    wts, norm, pairs = _model(str(tmp_path), rate, seed=3)
    ours = Enhancer(wts, norm, device="cpu", sample_rate=rate)
    theirs = JaxEnhancer(wts, norm, sample_rate=rate)
    _, noisy = pairs[1]
    _check_triple(ours.enhance(noisy), theirs.enhance(noisy))
    got = ours.enhance_batch([n for _, n in pairs])
    want = theirs.enhance_batch([n for _, n in pairs])
    for g, w in zip(got, want):
        _check_triple(g, w)


def _info(path):
    lines = open(path).read().split("\n")
    return float(lines[1]), float(lines[3])


@pytest.mark.parametrize("batch_size,kw", [
    (0, {}), (4, {}), (0, {"blend": "auto", "smooth_strength": "auto"}),
], ids=["single", "batch4", "quality"])
def test_decode_files_matches_jax(fx, tmp_path, batch_size, kw):
    args = (fx["wts"], fx["norm"], fx["noisy_paths"])
    got = decode_files(*args, str(tmp_path / "torch"), fx["clean_paths"],
                       log=lambda s: None, noisy_info=True,
                       batch_size=batch_size, device="cpu", **kw)
    want = jax_decode_files(*args, str(tmp_path / "jax"), fx["clean_paths"],
                            log=lambda s: None, noisy_info=True,
                            batch_size=batch_size, **kw)
    for g, w in zip(got, want):
        for key in ("segsnr", "segsnr_noisy", "lsd", "lsd_noisy"):
            assert np.isfinite(g[key])
            assert abs(g[key] - w[key]) <= INFO_ATOL, key
        assert _lsb(read_wav(g["out"])[0], read_wav(w["out"])[0]) <= 1
        stem = os.path.splitext(os.path.basename(g["wav"]))[0]
        info_g = _info(tmp_path / "torch" / f"{stem}.info.txt")
        info_w = _info(tmp_path / "jax" / f"{stem}.info.txt")
        np.testing.assert_allclose(info_g, info_w, rtol=0, atol=INFO_ATOL)
        ni = os.path.basename(g["wav"]) + ".info"
        assert _info(tmp_path / "torch" / ni) == _info(tmp_path / "jax" / ni)


@pytest.mark.parametrize("rate", [8000, 11025])
def test_decode_files_low_rate_metrics(tmp_path, rate):
    """Metrics use the decode's own framing.  ``tpu_se.infer.decode_files``
    drops ``sample_rate`` here and fails on 256-point frames, so the port
    is held to ``tpu_se.dsp.metrics`` called with the rate."""
    from tpu_se.dsp.metrics import segsnr_lsd_pair

    wts, norm, pairs = _model(str(tmp_path), rate, seed=5)
    clean, noisy = pairs[0]
    write_wav(tmp_path / "c.wav", clean, rate)
    write_wav(tmp_path / "n.wav", noisy, rate)
    got = decode_files(wts, norm, [tmp_path / "n.wav"], str(tmp_path / "o"),
                       [tmp_path / "c.wav"], log=lambda s: None,
                       sample_rate=rate, device="cpu")[0]
    _, recon, enh = JaxEnhancer(wts, norm, sample_rate=rate).enhance(noisy)
    power = np.where(enh < -50.0, np.exp(-50.0), np.exp(enh))
    want = segsnr_lsd_pair(clean, noisy, recon, power, rate)
    for key, val in want.items():
        assert np.isfinite(got[key])
        assert abs(got[key] - val) <= INFO_ATOL, key


def test_cli_decode_subprocess_on_cpu(fx, tmp_path):
    scp = tmp_path / "noisy.scp"
    scp.write_text("\n".join(fx["noisy_paths"]) + "\n")
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch", "decode", "--scp", str(scp),
         "--wts", fx["wts"], "--norm", fx["norm"], "--out-dir", str(out),
         "--device", "cpu", "--batch", "2", "--blend", "auto"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    ours = Enhancer(fx["wts"], fx["norm"], device="cpu", blend="auto")
    for path, wave in zip(fx["noisy_paths"], fx["noisy"]):
        stem = os.path.splitext(os.path.basename(path))[0]
        got, sr = read_wav(out / f"{stem}_enhanced.wav")
        assert sr == 16000
        assert _lsb(got, ours.enhance(wave)[0]) <= 1


def test_cuda_requests_raise_without_gpu(fx, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        Enhancer(fx["wts"], fx["norm"], device="cuda")
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["decode", fx["noisy_paths"][0], "--wts", fx["wts"],
                  "--norm", fx["norm"], "--out-dir", str(tmp_path)])
    assert not os.listdir(tmp_path)


def test_cpu_decode_never_launches_the_kernel(fx):
    before = lps_kernel.launches
    ours = Enhancer(fx["wts"], fx["norm"], device="cpu")
    ours.enhance(fx["noisy"][0])
    ours.enhance_batch_waves(fx["noisy"])
    assert lps_kernel.launches == before == 0


@pytest.mark.parametrize("flag", [["--mesh-data", "2"]])
def test_cli_rejects_unported_options(flag):
    """``--mesh-data`` was the last flag of the reference's ``decode``
    that the parser refused; it parses now, and asks for as many cards."""
    argv = ["decode", "a.wav", "--wts", "m.wts", "--norm", "m.norm"]
    assert build_parser().parse_args(argv + flag).mesh_data == 2
    assert build_parser().parse_args(argv).mesh_data == 1
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            cli_main(argv + flag)


def test_trunc_int16_wraps_like_numpy():
    x = np.array([0.9, -0.9, 1.5, -1.5, 32767.9, -32768.9, 40000.7,
                  -40000.7, 70000.0, -70000.0], np.float32)
    np.testing.assert_array_equal(trunc_int16(torch.from_numpy(x)).numpy(),
                                  np.trunc(x).astype(np.int16))


@pytest.fixture(scope="module")
def mesh_decode(tmp_path_factory):
    """The decoder forms over two gloo ranks, and over one process."""
    where = tmp_path_factory.mktemp("mesh_decode")
    problem = write_decode_problem(where)
    ranks = run_decode_cluster(where, 2)
    one = decode_all(str(where / "m.wts"), str(where / "m.norm"), problem,
                     None, "cpu")
    waves = np.split(problem["waves"], np.cumsum(problem["lengths"])[:-1])
    return where, waves, ranks, one


MESH_FORMS = ["plain", "auto", "batch", "fast"]


@pytest.mark.parametrize("form", MESH_FORMS)
def test_sharded_decode_matches_one_process(mesh_decode, form):
    _, waves, ranks, one = mesh_decode
    keys = sorted(k for k in one if k.startswith(f"{form}_"))
    assert len(keys) == (3 if form == "fast" else 6)
    for key in keys:
        for rank in ranks[1:]:
            np.testing.assert_array_equal(rank[key], ranks[0][key])
        got, want = ranks[0][key], one[key]
        if "_wave" in key and form == "fast":
            np.testing.assert_array_equal(got, want)
        elif "_wave" in key:
            assert _lsb(got, want) <= 1, key
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("form", MESH_FORMS)
def test_sharded_decode_matches_jax_sharded(mesh_decode, form):
    where, waves, ranks, _ = mesh_decode
    ref = JaxEnhancer(str(where / "m.wts"), str(where / "m.norm"),
                      blend="auto" if form == "auto" else 0.0,
                      mesh=ref_make_mesh(2, 1))
    if form == "fast":
        want = [(w, None, None) for w in ref.enhance_batch_waves(waves)]
    elif form == "batch":
        want = ref.enhance_batch(waves)
    else:
        want = [ref.enhance(w) for w in waves]
    for i, (wave, _, lps) in enumerate(want):
        assert _lsb(ranks[0][f"{form}_wave{i}"], wave) <= 1
        if lps is not None:
            np.testing.assert_allclose(ranks[0][f"{form}_lps{i}"], lps,
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("extra", [[], ["--batch", "2"]], ids=["one", "batch"])
def test_cli_decode_mesh_data_writes_one_process_files(mesh_decode, tmp_path,
                                                      extra):
    where, waves, _, _ = mesh_decode
    paths = []
    for i, wave in enumerate(waves):
        paths.append(str(tmp_path / f"u{i}.wav"))
        write_wav(paths[-1], wave, 16000)
    (tmp_path / "noisy.scp").write_text("\n".join(paths) + "\n")

    def decode(out, *flags):
        r = subprocess.run(
            [sys.executable, "-m", "tpu_se_torch", "decode", "--scp",
             str(tmp_path / "noisy.scp"), "--clean-scp",
             str(tmp_path / "noisy.scp"), "--wts", str(where / "m.wts"),
             "--norm", str(where / "m.norm"), "--out-dir", str(out),
             "--device", "cpu", *extra, *flags],
            cwd=ROOT, capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        return r.stdout

    log = decode(tmp_path / "mesh", "--mesh-data", "2")
    decode(tmp_path / "one")
    assert log.count("segsnr=") == len(waves)        # rank 0 logs alone
    assert (sorted(os.listdir(tmp_path / "mesh"))
            == sorted(os.listdir(tmp_path / "one")))
    for i in range(len(waves)):
        got, sr = read_wav(tmp_path / "mesh" / f"u{i}_enhanced.wav")
        want, _ = read_wav(tmp_path / "one" / f"u{i}_enhanced.wav")
        assert sr == 16000 and _lsb(got, want) <= 1
        np.testing.assert_allclose(
            _info(tmp_path / "mesh" / f"u{i}.info.txt"),
            _info(tmp_path / "one" / f"u{i}.info.txt"), rtol=0,
            atol=INFO_ATOL)
