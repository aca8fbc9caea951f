"""The decoder's pad buckets and its captured CUDA graphs.

On the CPU every entry point of ``tpu_se_torch.infer.Enhancer`` (``enhance``,
``enhance_batch``, ``enhance_batch_waves``, ``enhance_lps``) runs eagerly at
the padded shape -- frames to a multiple of 64, a batch to a multiple of 4
-- and is held to ``tpu_se.infer.Enhancer`` on the same ``.wts``/``.norm``
and seeded waves, at utterances on both sides of a bucket edge (63, 64, 65
frames) and of one frame, batches of 1, 3, 4 and 5, float32 and bfloat16
products, ``blend`` 0 and ``"auto"``.  Tolerances are
``tests/test_torch_decode.py``'s: float32 waves within 1 int16 LSB and the
enhanced LPS within atol 1e-3; bfloat16 through ``enhance`` and the batch
by their enhanced LPS at atol 0.05, through ``enhance_lps`` (the same noisy
LPS) at one bfloat16 flip of a hidden activation, 2^-8 max|w_last| /
min(inv_std); bfloat16 waves are not gated against JAX.  Within the port
``enhance_batch_waves`` is ``enhance_batch``'s waves bit for bit.  The
padded shapes and the cut-back lengths are checked themselves.

On a card (tests marked ``cuda``, no JAX imported) each entry point's
replayed graph is bit for bit ``Enhancer(graph=False)`` at the same padded
shape, float32 and bfloat16, blend 0 and ``"auto"``; a replay adds one LPS
launch (its capture's) and one to ``decodes_replayed``, a new shape one
capture; a capture that fails raises and keeps no graph; at most
``MAX_DECODE_GRAPHS`` graphs are kept.  Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_graph.py
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_se_torch.dsp.analysis import wav_to_lps
from tpu_se_torch.infer import Enhancer
from tpu_se_torch.infer import decode as decode_mod
from tpu_se_torch.io import read_norm, read_wts, write_norm, write_wts
from tpu_se_torch.models import init_params
from tpu_se_torch.ops import lps_kernel

SHIFT = 256
FRAMES = (63, 64, 65, 1)         # both sides of a bucket edge, and one frame
BATCHES = (1, 3, 4, 5)
CASES = [("float32", 0.0), ("float32", "auto"), ("bfloat16", 0.0),
         ("bfloat16", "auto")]
LPS_ATOL = 1e-3
BF16_LPS_ATOL = 0.05


def _lsb(a, b):
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()) if d.size else 0


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    """A (1799, 64, 64, 257) model, its ``.norm`` and one noisy wave per
    frame count of ``FRAMES`` (a few samples past the last frame)."""
    tmp = str(tmp_path_factory.mktemp("decode_graph"))
    rng = np.random.default_rng(20)
    waves = []
    for i, t in enumerate(FRAMES):
        n = (t + 1) * SHIFT + 37
        x = np.arange(n) / 16000
        wave = (2000 * np.sin(2 * np.pi * (150 + 40 * i) * x)
                + 900 * np.sin(2 * np.pi * 700 * x)
                + 500 * rng.standard_normal(n))
        waves.append(wave.astype(np.int16))
    wts = os.path.join(tmp, "m.wts")
    write_wts(wts, init_params(20, (1799, 64, 64, 257)))
    lps = np.concatenate([wav_to_lps(w, device="cpu") for w in waves])
    norm = os.path.join(tmp, "m.norm")
    write_norm(norm, lps.mean(axis=0), 1.0 / lps.std(axis=0))
    return {"wts": wts, "norm": norm, "waves": waves}


def _batch(fx, n):
    """``n`` of the waves, the frame counts in turn."""
    return [fx["waves"][i % len(FRAMES)] for i in range(n)]


def _pair(fx, dtype, blend):
    import jax.numpy as jnp

    from tpu_se.infer import Enhancer as JaxEnhancer

    ours = Enhancer(fx["wts"], fx["norm"], device="cpu", blend=blend,
                    compute_dtype=dtype)
    theirs = JaxEnhancer(fx["wts"], fx["norm"], blend=blend,
                         compute_dtype=getattr(jnp, dtype))
    return ours, theirs


def _check_lps(got, want, dtype):
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(
        got, want, rtol=0,
        atol=LPS_ATOL if dtype == "float32" else BF16_LPS_ATOL)


# -- on the CPU, against tpu_se ------------------------------------------------

@pytest.mark.parametrize("dtype,blend", CASES)
def test_enhance_at_bucket_edges_matches_jax(fx, dtype, blend):
    ours, theirs = _pair(fx, dtype, blend)
    for t, wave in zip(FRAMES, fx["waves"]):
        got, want = ours.enhance(wave), theirs.enhance(wave)
        assert got[0].shape == (t * SHIFT + SHIFT,) == want[0].shape
        assert got[1].shape == (t, 2 * SHIFT) and got[2].shape == (t, 257)
        if dtype == "float32":
            assert _lsb(got[0], want[0]) <= 1
        _check_lps(got[2], want[2], dtype)


@pytest.mark.parametrize("dtype,blend", CASES)
def test_enhance_batch_matches_jax(fx, dtype, blend):
    ours, theirs = _pair(fx, dtype, blend)
    for n in BATCHES:
        waves = _batch(fx, n)
        got, want = ours.enhance_batch(waves), theirs.enhance_batch(waves)
        assert len(got) == len(want) == n
        for g, w, wave in zip(got, want, waves):
            t = len(wave) // SHIFT - 1
            assert g[0].shape == w[0].shape == (t * SHIFT + SHIFT,)
            assert g[1].shape == (t, 2 * SHIFT)
            if dtype == "float32":
                assert _lsb(g[0], w[0]) <= 1
            _check_lps(g[2], w[2], dtype)


@pytest.mark.parametrize("dtype,blend", CASES)
def test_enhance_batch_waves_matches_jax(fx, dtype, blend):
    ours, theirs = _pair(fx, dtype, blend)
    for n in BATCHES:
        waves = _batch(fx, n)
        got = ours.enhance_batch_waves(waves)
        want = theirs.enhance_batch_waves(waves)
        for g, w in zip(got, want):
            assert g.dtype == np.int16 and g.shape == w.shape
            if dtype == "float32":
                assert _lsb(g, w) <= 1


@pytest.mark.parametrize("dtype,blend", CASES)
def test_enhance_lps_matches_jax(fx, dtype, blend):
    ours, theirs = _pair(fx, dtype, blend)
    flip = (2.0 ** -8 * np.abs(read_wts(fx["wts"])[-1]["w"]).max()
            / read_norm(fx["norm"], 257)[1].min())
    for t, wave in zip(FRAMES, fx["waves"]):
        lps = wav_to_lps(wave, device="cpu")
        assert lps.shape == (t, 257)
        got, want = ours.enhance_lps(lps), theirs.enhance_lps(lps)
        assert got.shape == want.shape == (t, 257)
        np.testing.assert_allclose(
            got, want, rtol=0, atol=LPS_ATOL if dtype == "float32" else flip)


@pytest.mark.parametrize("dtype,blend", CASES)
def test_enhance_batch_waves_is_enhance_batch_bitwise(fx, dtype, blend):
    ours = Enhancer(fx["wts"], fx["norm"], device="cpu", blend=blend,
                    compute_dtype=dtype)
    for n in BATCHES:
        waves = _batch(fx, n)
        for g, w in zip(ours.enhance_batch_waves(waves),
                        ours.enhance_batch(waves)):
            np.testing.assert_array_equal(g, w[0])


def test_padded_shapes(fx):
    enh = Enhancer(fx["wts"], fx["norm"], device="cpu")
    one = {t: enh._padded_shape(1, t, batch=False) for t in (1, 63, 64, 65,
                                                             128, 129, 448)}
    assert one == {1: (1, 64), 63: (1, 64), 64: (1, 64), 65: (1, 128),
                   128: (1, 128), 129: (1, 192), 448: (1, 448)}
    assert [enh._padded_shape(b, 65, batch=True)[0]
            for b in (1, 3, 4, 5, 16)] == [4, 4, 4, 8, 16]
    assert enh._padded_shape(16, 448, batch=True) == (16, 448)
    # Under a data axis of 3 the batch bucket is 6, as the reference's.
    enh.mesh = SimpleNamespace(data=3)
    assert [enh._padded_shape(b, 65, batch=True)[0]
            for b in (1, 6, 7)] == [6, 6, 12]


def test_programs_run_at_the_padded_shape_and_cut_back(fx, monkeypatch):
    """What the programs receive and what the callers get back."""
    enh = Enhancer(fx["wts"], fx["norm"], device="cpu")
    seen = []
    core, lps_core = enh._core, enh._lps_core

    def spy(fn):
        def run(x, n_valid):
            seen.append((tuple(x.shape), n_valid.tolist()))
            return fn(x, n_valid)
        return run

    monkeypatch.setattr(enh, "_core", spy(core))
    monkeypatch.setattr(enh, "_lps_core", spy(lps_core))
    waves = _batch(fx, 3)                  # 63, 64 and 65 frames
    enh.enhance(waves[2])
    enh.enhance_batch(waves)
    enh.enhance_batch_waves(waves)
    enh.enhance_lps(wav_to_lps(waves[0], device="cpu"))
    assert seen == [((1, 128, 512), [65]),
                    ((4, 128, 512), [63, 64, 65, 0]),
                    ((4, 128, 512), [63, 64, 65, 0]),
                    ((1, 64, 257), [63])]
    # _decode at a shape that is no bucket pads it and cuts back.
    frames = torch.from_numpy(np.random.default_rng(1).normal(
        scale=1000, size=(3, 100, 512)).astype(np.float32))
    seen.clear()
    wave, recon, lps = enh._decode(frames, torch.tensor([100, 7, 0]))
    assert seen == [((4, 128, 512), [100, 7, 0, 0])]
    assert (wave.shape, recon.shape, lps.shape) == (
        (3, 101 * SHIFT), (3, 100, 512), (3, 100, 257))
    padded = torch.zeros(4, 128, 512)
    padded[:3, :100] = frames
    with torch.inference_mode():
        want = core(padded, torch.tensor([100, 7, 0, 0]))
    for got, full in zip((wave, recon, lps), want):
        np.testing.assert_array_equal(got.numpy(),
                                      full[:3, :got.shape[1]].numpy())


def test_the_cpu_decodes_eagerly(fx):
    """No graphs on the CPU: ``graph`` changes no bit, no counter moves."""
    counts = (decode_mod.decodes_replayed, decode_mod.decode_graphs_captured,
              lps_kernel.launches)
    waves = _batch(fx, 5)
    default = Enhancer(fx["wts"], fx["norm"], device="cpu", blend="auto")
    eager = Enhancer(fx["wts"], fx["norm"], device="cpu", blend="auto",
                     graph=False)
    assert not default.replays and not eager.replays
    for a, b in zip(default.enhance_batch(waves), eager.enhance_batch(waves)):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for a, b in zip(default.enhance_batch_waves(waves),
                    eager.enhance_batch_waves(waves)):
        np.testing.assert_array_equal(a, b)
    assert not default._graphs
    assert counts == (decode_mod.decodes_replayed,
                      decode_mod.decode_graphs_captured, lps_kernel.launches)


# -- on the card ---------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _calls(fx):
    """Each entry point at several padded shapes, as (name, call)."""
    lps = [wav_to_lps(w, device="cpu") for w in fx["waves"]]
    out = [(f"enhance{t}", lambda e, w=w: e.enhance(w))
           for t, w in zip(FRAMES, fx["waves"])]
    out += [(f"batch{n}", lambda e, n=n: e.enhance_batch(_batch(fx, n)))
            for n in (3, 5)]
    out += [(f"waves{n}",
             lambda e, n=n: e.enhance_batch_waves(_batch(fx, n)))
            for n in (3, 5)]
    out += [(f"lps{t}", lambda e, x=x: e.enhance_lps(x))
            for t, x in zip(FRAMES, lps)]
    return out


def _flat(result):
    if isinstance(result, np.ndarray):
        return [result]
    return [a for item in result for a in _flat(item)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blend", CASES)
def test_replays_equal_eager_on_the_card(card, fx, dtype, blend):
    """Every entry point, first call (the eager run before the capture)
    and two replays, bit for bit ``graph=False``."""
    kw = dict(device=card, blend=blend, compute_dtype=dtype)
    replayed = Enhancer(fx["wts"], fx["norm"], **kw)
    eager = Enhancer(fx["wts"], fx["norm"], graph=False, **kw)
    assert replayed.replays and not eager.replays
    for name, call in _calls(fx):
        want = _flat(call(eager))
        for _ in range(3):
            got = _flat(call(replayed))
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_array_equal(g, w, err_msg=name)
    assert not eager._graphs
    # enhance at 63, 64 and 1 frames share (1, 64); 65 is (1, 128).
    assert len(replayed._graphs) == 2 + 2 + 2 + 2


@pytest.mark.cuda
def test_replay_counters_on_the_card(card, fx):
    enh = Enhancer(fx["wts"], fx["norm"], device=card)
    waves = _batch(fx, 5)

    def counts():
        torch.cuda.synchronize()
        return (lps_kernel.launches, decode_mod.decodes_replayed,
                decode_mod.decode_graphs_captured)

    before = counts()
    enh.enhance_batch_waves(waves)              # eager run, then capture
    assert np.subtract(counts(), before).tolist() == [1, 0, 1]
    before = counts()
    for _ in range(4):
        enh.enhance_batch_waves(waves)
    assert np.subtract(counts(), before).tolist() == [4, 4, 0]
    before = counts()
    enh.enhance_batch(waves)                    # another program
    enh.enhance_batch(waves)
    assert np.subtract(counts(), before).tolist() == [2, 1, 1]


@pytest.mark.cuda
def test_a_failed_capture_raises(card, fx, monkeypatch):
    """A program that cannot be captured (it reads a device value on the
    host) raises; no graph is kept and no eager decode takes its place."""
    real = decode_mod._decode_core

    def syncs(model, frames, *args):
        args[2].tolist()                       # n_valid to the host
        return real(model, frames, *args)

    enh = Enhancer(fx["wts"], fx["norm"], device=card)
    monkeypatch.setattr(decode_mod, "_decode_core", syncs)
    captured = decode_mod.decode_graphs_captured
    with pytest.raises(RuntimeError):
        enh.enhance(fx["waves"][0])
    assert not enh._graphs
    assert decode_mod.decode_graphs_captured == captured
    monkeypatch.setattr(decode_mod, "_decode_core", real)
    want = Enhancer(fx["wts"], fx["norm"], device=card,
                    graph=False).enhance(fx["waves"][0])[0]
    for _ in range(2):
        np.testing.assert_array_equal(enh.enhance(fx["waves"][0])[0], want)
    assert len(enh._graphs) == 1


@pytest.mark.cuda
def test_graphs_are_bounded_least_recently_used_out(card, fx, monkeypatch):
    monkeypatch.setattr(decode_mod, "MAX_DECODE_GRAPHS", 2)
    enh = Enhancer(fx["wts"], fx["norm"], device=card)
    eager = Enhancer(fx["wts"], fx["norm"], device=card, graph=False)
    order = [0, 2, 0, 3, 2, 0]           # 63 -> 64 frames, 65 -> 128, 1 -> 64
    for i in order:
        np.testing.assert_array_equal(enh.enhance(fx["waves"][i])[0],
                                      eager.enhance(fx["waves"][i])[0])
        assert len(enh._graphs) <= 2
    assert [key[1][0] for key in enh._graphs] == [(1, 128, 512),
                                                  (1, 64, 512)]
