"""tpu_se_torch.infer.StreamingEnhancer on the CPU: against the port's own
batch decode, against ``tpu_se``'s streamer, and through the CLI.

Both packages read the same ``.wts``/``.norm`` (written with the
``tpu_se.io`` writers from a seeded model and synthetic waves); the port
runs with ``device="cpu"`` (the plain versions of its kernels).
Tolerances: int16 waves within 1 LSB (float32 sums in another order, and
the port's float64 LPS sums against JAX's float32, can flip a truncation),
with fewer than 2 % of the samples differing where the stream is held to
its batch decode; the normalized LPS ring within atol 1e-3 of JAX's
(near-empty bins, as ``tests/test_torch_decode.py``); the sample ring and
the counters exact.  ``push_many`` against ``push``, the int16 against the
float wire, and one stream against itself beside other neighbours are
exact; S batched streams against S separate ones are held to rtol 1e-4,
atol 0.5 (another GEMM shape sums in another order).

``compute_dtype=bfloat16``: two float32 sum orders can round a hidden
activation (or, against JAX, a normalized input: the LPS sums differ) to
the neighbouring bfloat16 value, which moves an enhanced log power by up to
~0.02 and so a sample by up to exp(0.01) - 1 = 1 % of the wave's peak: the
bfloat16 stream is held to the port's bfloat16 batch decode and to JAX's
bfloat16 streamer at 1 % of the peak, with fewer than 2 % of the samples
more than 1 LSB apart (measured: 1 LSB everywhere).

Under a data mesh (``StreamingEnhancer(mesh=)``, two gloo ranks of
``tests/torch_mp_worker.py``, the twin of ``tests/test_parallel.py:222-242``)
8 streams on the int16 wire are bitwise the port's one process on every
rank, and within 1 LSB of ``tpu_se``'s streamer under ``make_mesh(2, 1)``;
at a data axis of 4 (2 channels a rank) each rank's rows are one
process's bits too, in one process (a ``Mesh`` without a group) and over
four gloo ranks against one: every rank runs the network at the mesh's 8
rows, since a 2-row product sums in another order than an 8-row one.

The tests that need a card are marked ``cuda`` and skip without one;
on a card (no JAX there) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_streaming.py

which is why this module imports ``tpu_se`` only inside the tests and
fixtures that use it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from tpu_se_torch.bench.fixtures import stream_hops
from tpu_se_torch.cli.main import main as cli_main
from tpu_se_torch.dsp.analysis import rate_config, wav_to_lps
from tpu_se_torch.infer import Enhancer, StreamingEnhancer, enhance_utterance
from tpu_se_torch.infer import streaming
from tpu_se_torch.infer.decode import SM_AUTO_D0, SM_AUTO_D1
from tpu_se_torch.io import read_wav, write_norm, write_wav, write_wts
from tpu_se_torch.models import init_params
from tpu_se_torch.ops import lps_kernel

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LPS_ATOL = 1e-3
LENGTHS = (9000, 12345, 6000)
BLENDS = [0.0, 0.4, "auto"]
STRENGTHS = [None, 0.5, "auto"]


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
        out.append((clean + 500 * rng.standard_normal(n)).astype(np.int16))
    return out


def _model(tmp, rate, seed):
    """A (7K, 64, 64, K) model and the waves' own LPS statistics, written
    with ``tpu_se``'s writers where JAX is installed (the port's are held
    byte for byte to them by ``tests/test_torch_io.py``)."""
    try:
        from tpu_se.io import write_norm as norm_writer
        from tpu_se.io import write_wts as wts_writer
    except ImportError:
        norm_writer, wts_writer = write_norm, write_wts
    bins = rate_config(rate)[2] // 2 + 1
    wts = os.path.join(tmp, f"m{rate}.wts")
    wts_writer(wts, init_params(seed, (7 * bins, 64, 64, bins)))
    waves = _waves(rate, seed)
    lps = np.concatenate([wav_to_lps(w, sample_rate=rate, device="cpu")
                          for w in waves])
    norm = os.path.join(tmp, f"m{rate}.norm")
    norm_writer(norm, lps.mean(axis=0), 1.0 / lps.std(axis=0))
    return wts, norm, waves


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("streaming"))
    return {rate: _model(tmp, rate, seed=7) for rate in (16000, 8000, 11025)}


@pytest.fixture(scope="module")
def fx(models):
    wts, norm, waves = models[16000]
    return {"wts": wts, "norm": norm, "waves": waves}


def _stream(wave, wts, norm, chunks=None, cls=StreamingEnhancer, **kw):
    """feed() over ``chunks``-seeded random piece sizes (or in one piece),
    then flush() -> (int16 wave, the enhancer)."""
    if cls is StreamingEnhancer:
        kw["device"] = "cpu"
    s = cls(wts, norm, **kw)
    pieces, i = [], 0
    rng = np.random.default_rng(chunks)
    while i < len(wave):
        n = len(wave) if chunks is None else int(rng.integers(1, 2000))
        pieces.append(s.feed(wave[i:i + n]))
        i += n
    pieces.append(s.flush())
    return np.concatenate(pieces), s


def _push_all(s, sig):
    """push() every hop of ``sig`` [S, n*shift], then drain -> [S, m*shift]."""
    shift = s.frame_shift
    outs = []
    for h in range(sig.shape[1] // shift):
        out = s.push(sig[:, h * shift:(h + 1) * shift])
        if out is not None:
            outs.append(out)
    outs.extend(s.flush_hops())
    return np.concatenate(outs, axis=1)


@pytest.mark.parametrize("rate", [16000, 8000, 11025])
def test_stream_matches_batch(models, rate):
    """feed()+flush() over random chunk sizes == the port's batch Enhancer.
    The 50-sample tail takes flush's partial-hop branch at 11 kHz
    (need = 256 - 2*110 = 36) and is dropped at 8 and 16 kHz (need = shift),
    as the batch framer's ``num_frames`` has it."""
    wts, norm, waves = models[rate]
    shift = rate_config(rate)[1]
    wave = waves[1][: (len(waves[1]) // shift - 2) * shift + 50]
    batch = Enhancer(wts, norm, device="cpu",
                     sample_rate=rate).enhance(wave)[0]
    stream, _ = _stream(wave, wts, norm, chunks=rate, sample_rate=rate)
    assert stream.dtype == np.int16
    assert stream.shape == batch.shape
    diff = np.abs(stream.astype(np.int32) - batch.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02


@pytest.mark.parametrize("strength", STRENGTHS, ids=str)
@pytest.mark.parametrize("blend", BLENDS, ids=str)
def test_stream_matches_jax(fx, blend, strength):
    from tpu_se.infer import StreamingEnhancer as JaxStreamingEnhancer

    wave = fx["waves"][1]
    kw = {"blend": blend, "smooth_strength": strength}
    got, _ = _stream(wave, fx["wts"], fx["norm"], chunks=3, **kw)
    want, _ = _stream(wave, fx["wts"], fx["norm"],
                      cls=JaxStreamingEnhancer, **kw)
    assert _lsb(got, want) <= 1


def _bf16_close(got, want):
    assert got.shape == want.shape
    diff = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert diff.max() <= 0.01 * np.abs(want.astype(np.int32)).max()
    assert (diff > 1).mean() < 0.02


@pytest.mark.parametrize("kw", [{}, {"blend": "auto",
                                     "smooth_strength": "auto"}],
                         ids=["plain", "quality"])
def test_stream_bf16_matches_jax_and_batch(fx, kw):
    import jax.numpy as jnp

    from tpu_se.infer import StreamingEnhancer as JaxStreamingEnhancer

    wave = fx["waves"][1]
    got, s = _stream(wave, fx["wts"], fx["norm"], chunks=3,
                     compute_dtype=torch.bfloat16, **kw)
    assert s.compute_dtype == torch.bfloat16
    assert [w.dtype for w in s._step_args.cast_weights] == [torch.bfloat16] * 3
    want, _ = _stream(wave, fx["wts"], fx["norm"], cls=JaxStreamingEnhancer,
                      compute_dtype=jnp.bfloat16, **kw)
    _bf16_close(got, want)
    plain, _ = _stream(wave, fx["wts"], fx["norm"], chunks=3, **kw)
    assert not np.array_equal(got, plain)          # the knob is on
    if not kw:
        batch = Enhancer(fx["wts"], fx["norm"], device="cpu",
                         compute_dtype="bfloat16").enhance(wave)[0]
        _bf16_close(got, batch)


def test_stream_compute_dtype_default_and_names(fx):
    wave = fx["waves"][2]
    default, s = _stream(wave, fx["wts"], fx["norm"])
    assert s.compute_dtype == torch.float32
    assert s._step_args.cast_weights is None
    named, _ = _stream(wave, fx["wts"], fx["norm"], compute_dtype="float32")
    np.testing.assert_array_equal(default, named)
    with pytest.raises(ValueError, match="unsupported compute dtype"):
        StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                          compute_dtype="float16")


def test_stream_blend_matches_batch_blend(fx):
    """A fixed blend streams to the batch decode with the same blend, and
    differs from the stream without it."""
    wave = fx["waves"][0]
    batch = Enhancer(fx["wts"], fx["norm"], device="cpu",
                     blend=0.5).enhance(wave)[0]
    stream, _ = _stream(wave, fx["wts"], fx["norm"], blend=0.5)
    diff = np.abs(stream.astype(np.int32) - batch.astype(np.int32))
    assert diff.max() <= 1
    assert (diff > 0).mean() < 0.02
    plain, _ = _stream(wave, fx["wts"], fx["norm"])
    assert _lsb(plain, stream) > 1


def test_multistream_push_equals_single(fx):
    """S batched streams give what S separate streams give, to float32
    rounding (the FFN's [3, 1799] product sums in another order than three
    [1, 1799] ones: rtol 1e-4, atol 0.5 on the int16 scale, as
    ``tests/test_streaming.py`` holds the JAX streamer); and a stream's
    samples do not depend at all on what the other streams carry, since no
    step takes a decision for all streams at once."""
    n = 24 * 256
    kw = {"device": "cpu", "blend": "auto", "smooth_strength": "auto"}
    sig = np.stack([fx["waves"][0][:n], fx["waves"][1][1000:1000 + n],
                    fx["waves"][1][::-1][:n]]).astype(np.float32)
    multi = _push_all(StreamingEnhancer(fx["wts"], fx["norm"], n_streams=3,
                                        **kw), sig)
    assert multi.shape == (3, (24 - 1) * 256)
    for i in range(3):
        single = _push_all(StreamingEnhancer(fx["wts"], fx["norm"], **kw),
                           sig[i:i + 1])
        np.testing.assert_allclose(single[0], multi[i], rtol=1e-4, atol=0.5)
    other = sig.copy()
    other[1] = 0.0                      # silence: every bin at the floor
    other[2, : n // 2] *= 7.0           # a burst: another gate, another EMA
    multi2 = _push_all(StreamingEnhancer(fx["wts"], fx["norm"], n_streams=3,
                                         **kw), other)
    np.testing.assert_array_equal(multi2[0], multi[0])
    assert np.abs(multi2[2] - multi[2]).max() > 1.0
    assert np.isfinite(multi2).all()


@pytest.mark.parametrize("int16_wire", [False, True], ids=["f32", "i16"])
def test_push_many_equals_pushes(fx, int16_wire):
    hops = stream_hops(fx["waves"], 2, 20)
    a = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=2, device="cpu")
    b = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=2, device="cpu")
    outs = [a.push(hops[:, j].astype(np.float32)) for j in range(20)]
    got = np.concatenate([b.push_many(hops[:, :12], int16_wire)[0],
                          b.push_many(hops[:, 12:], int16_wire)[0]], axis=1)
    for j, out in enumerate(outs):
        if out is not None:
            want = np.trunc(out).astype(np.int16) if int16_wire else out
            np.testing.assert_array_equal(got[:, j], want)
    for x, y in zip(a.state, b.state):
        assert torch.equal(x, y)


def test_warmup_and_latency_accounting(fx):
    """push() returns None exactly warmup_hops-1 times, then a hop each."""
    s = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu")
    assert s.latency_samples == 3 * 256 + 512
    rng = np.random.default_rng(2)
    outs = [s.push(rng.normal(size=(1, 256)).astype(np.float32) * 100)
            for _ in range(s.warmup_hops + 3)]
    n_none = sum(o is None for o in outs)
    assert n_none == s.warmup_hops - 1
    assert all(o is not None for o in outs[n_none:])
    assert outs[-1].shape == (1, 256) and outs[-1].dtype == np.float32
    _, valid = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu"
                                 ).push_many(np.zeros((1, 8, 256)))
    assert list(valid) == [j >= s.warmup_hops - 1 for j in range(8)]


def test_short_utterance_stream(fx):
    """An utterance shorter than the context window still matches batch."""
    short = fx["waves"][0][: 256 * 5 + 128]     # 4 frames + a dropped part
    batch = Enhancer(fx["wts"], fx["norm"], device="cpu").enhance(short)[0]
    stream, _ = _stream(short, fx["wts"], fx["norm"])
    assert stream.shape == batch.shape == (5 * 256,)
    assert _lsb(stream, batch) <= 1


def test_push_many_int16_wire_matches_float(fx):
    """The int16 wire == the truncated float32 wire, for PCM input."""
    rng = np.random.default_rng(11)
    hops = (rng.normal(size=(2, 24, 256)) * 2000).astype(np.int16)
    a = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=2, device="cpu")
    out_f, valid_f = a.push_many(hops.astype(np.float32))
    b = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=2, device="cpu")
    out_i, valid_i = b.push_many(hops, int16_wire=True)
    assert out_f.dtype == np.float32 and out_i.dtype == np.int16
    np.testing.assert_array_equal(valid_f, valid_i)
    np.testing.assert_array_equal(np.trunc(out_f).astype(np.int16), out_i)


@pytest.mark.parametrize("kind", ["loud", "fractional"])
def test_feed_keeps_non_pcm_input_off_the_int16_wire(fx, kind, monkeypatch):
    """Integer-valued floats beyond the int16 range would wrap on the int16
    wire, and fractional samples would be truncated: feed() sends both
    through the float wire, and matches the explicit push() path."""
    rng = np.random.default_rng(7)
    n = 256 * (StreamingEnhancer.SCAN_HOPS + 2)
    wave = (np.trunc(rng.normal(size=n) * 70000.0) if kind == "loud"
            else rng.normal(size=n) * 3000.0).astype(np.float32)
    wires = []
    push_many = StreamingEnhancer.push_many
    monkeypatch.setattr(
        StreamingEnhancer, "push_many",
        lambda self, hops, int16_wire=False: (
            wires.append(int16_wire) or push_many(self, hops, int16_wire)))
    a = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu")
    got = np.concatenate([a.feed(wave), a.flush()])
    assert wires == [False]
    b = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu")
    pieces = []
    for h in range(n // 256):
        out = b.push(wave[h * 256:(h + 1) * 256][None, :])
        if out is not None:
            pieces.append(np.trunc(out[0]).astype(np.int16))
    pieces.append(b.flush())
    np.testing.assert_array_equal(got, np.concatenate(pieces))
    wires.clear()
    StreamingEnhancer(fx["wts"], fx["norm"], device="cpu").feed(
        np.trunc(np.clip(wave, -32767, 32767)))
    assert wires == [True]


@pytest.mark.parametrize("tail,extra", [(20, 0), (35, 0), (36, 1), (109, 1)])
def test_stream_tail_11k(models, tail, extra):
    """At 11 kHz a tail below ``need`` (36 samples) forms no frame; at or
    above it, one more: the stream's length follows the batch framer's."""
    wts, norm, waves = models[11025]
    shift, hops = 110, 40
    wave = waves[0][: hops * shift + tail]
    batch = Enhancer(wts, norm, device="cpu",
                     sample_rate=11025).enhance(wave)[0]
    stream, _ = _stream(wave, wts, norm, sample_rate=11025)
    frames = hops - 2 + extra
    assert stream.shape == batch.shape == (frames * shift + 256 - shift,)
    assert _lsb(stream, batch) <= 1


def test_streaming_smooth_causal_analog(fx):
    """A fixed strength alters the output; 'auto' ramps the strength in for
    quasi-stationary input (the dyn EMA falls below SM_AUTO_D0) and keeps
    it off for impulsive bursts (the EMA stays at or above SM_AUTO_D1);
    a stream starts with smoothing off."""
    rng = np.random.default_rng(5)
    n = 32000
    stationary = (rng.normal(size=n) * 3000.0).astype(np.float32)
    bursts = np.zeros(n, dtype=np.float32)
    bursts[(np.arange(n) // 1600) % 4 == 0] = 1.0
    bursts *= rng.normal(size=n).astype(np.float32) * 15000.0

    plain, _ = _stream(stationary, fx["wts"], fx["norm"])
    smoothed, _ = _stream(stationary, fx["wts"], fx["norm"],
                          smooth_strength=0.5)
    assert smoothed.shape == plain.shape
    assert _lsb(smoothed, plain) > 1

    s0 = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                           smooth_strength="auto")
    assert float(s0.state.dyn_ema[0]) >= SM_AUTO_D1
    auto_st, s_st = _stream(stationary, fx["wts"], fx["norm"],
                            smooth_strength="auto")
    _, s_im = _stream(bursts, fx["wts"], fx["norm"], smooth_strength="auto")
    assert float(s_st.state.dyn_ema[0]) < SM_AUTO_D0
    assert float(s_im.state.dyn_ema[0]) >= SM_AUTO_D1
    assert _lsb(auto_st, plain) > 1
    for bad in (-0.1, 1.5, "Auto"):
        with pytest.raises(ValueError):
            StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                              smooth_strength=bad)
    with pytest.raises(ValueError):
        StreamingEnhancer(fx["wts"], fx["norm"], device="cpu", blend=1.0)


@pytest.mark.parametrize("strength", [0.5, 1.0, "auto"], ids=str)
def test_streaming_smooth_short_utterance(fx, strength):
    """Smoothing on an utterance SHORTER than the noise-floor window
    (NOISE_FRAME_NUM = 10 frames): finite, the un-smoothed stream's length,
    and the JAX streamer's samples."""
    from tpu_se.infer import StreamingEnhancer as JaxStreamingEnhancer

    short = fx["waves"][0][: 256 * 7]                  # 6 frames
    got, s = _stream(short, fx["wts"], fx["norm"], smooth_strength=strength)
    plain, _ = _stream(short, fx["wts"], fx["norm"])
    want, _ = _stream(short, fx["wts"], fx["norm"],
                      cls=JaxStreamingEnhancer, smooth_strength=strength)
    assert got.shape == plain.shape == (6 * 256 + 256,)
    assert all(bool(torch.isfinite(x).all()) for x in s.state)
    assert _lsb(got, want) <= 1


@pytest.mark.parametrize("rate", [16000, 11025])
def test_stream_state_matches_jax(models, rate):
    """The state after N hops, field by field: the per-module check of the
    module that holds the LPS kernel (here its plain version)."""
    from tpu_se.infer import StreamingEnhancer as JaxStreamingEnhancer

    wts, norm, waves = models[rate]
    shift = rate_config(rate)[1]
    hops = stream_hops(waves, 2, 9, shift).astype(np.float32)
    kw = {"n_streams": 2, "sample_rate": rate, "blend": "auto",
          "smooth_strength": "auto"}
    ours = StreamingEnhancer(wts, norm, device="cpu", **kw)
    theirs = JaxStreamingEnhancer(wts, norm, **kw)
    for j in range(9):
        got, want = ours.push(hops[:, j]), theirs.push(hops[:, j])
        assert (got is None) == (want is None)
    assert got is not None
    np.testing.assert_allclose(got, want, rtol=0, atol=0.5)
    state = {k: np.asarray(v) for k, v in theirs.state._asdict().items()}
    for name in ("ring", "hops", "count"):
        np.testing.assert_array_equal(getattr(ours.state, name).numpy(),
                                      state[name])
    assert ours.state.hops.dtype == ours.state.count.dtype == torch.int32
    np.testing.assert_allclose(ours.state.lps_ring.numpy(),
                               state["lps_ring"], rtol=0, atol=LPS_ATOL)
    # Raw spectra of int16-scaled frames (|X| up to ~1e6) and the OLA of
    # synthesized frames: float32 relative error, scaled to the field.
    for name in ("spec_ring", "acc", "w2"):
        ref = state[name]
        np.testing.assert_allclose(getattr(ours.state, name).numpy(), ref,
                                   rtol=0, atol=1e-5 * np.abs(ref).max())
    for name in ("supp_ema", "sm_prev_db", "dyn_ema"):
        np.testing.assert_allclose(getattr(ours.state, name).numpy(),
                                   state[name], rtol=0, atol=LPS_ATOL)
    for name in ("noise_max", "sm_prev"):
        np.testing.assert_allclose(getattr(ours.state, name).numpy(),
                                   state[name], rtol=1e-3, atol=1e-30)


def test_reset_starts_a_new_stream(fx):
    s = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                          blend="auto", smooth_strength="auto")
    tensors = [x.data_ptr() for x in s.state]
    first = np.concatenate([s.feed(fx["waves"][2]), s.flush()])
    s.reset()
    again = np.concatenate([s.feed(fx["waves"][2]), s.flush()])
    np.testing.assert_array_equal(first, again)
    assert [x.data_ptr() for x in s.state] == tensors


def test_bad_arguments_raise(fx, models):
    s = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=2, device="cpu")
    with pytest.raises(ValueError, match="single-stream"):
        s.feed(np.zeros(256))
    with pytest.raises(ValueError, match="single-stream"):
        s.flush()
    with pytest.raises(ValueError, match="shape"):
        s.push(np.zeros((1, 256)))
    with pytest.raises(ValueError, match="push_many"):
        s.push_many(np.zeros((2, 4, 128)))
    with pytest.raises(ValueError, match="129 bins"):
        StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                          sample_rate=8000)


def test_cpu_stream_never_launches_the_kernel(fx):
    before = lps_kernel.launches, streaming.hops_replayed
    s = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu")
    s.feed(fx["waves"][2])
    assert (lps_kernel.launches, streaming.hops_replayed) == before


def test_enhance_utterance(fx):
    got = enhance_utterance(fx["wts"], fx["norm"], fx["waves"][2],
                            device="cpu")
    want = Enhancer(fx["wts"], fx["norm"], device="cpu").enhance(
        fx["waves"][2])[0]
    np.testing.assert_array_equal(got, want)


def test_stream_hops_fixture():
    waves = [np.arange(256 * 3, dtype=np.int16),
             -np.arange(256 * 2 + 9, dtype=np.int16)]
    hops = stream_hops(waves, 3, 4)
    assert hops.shape == (3, 4, 256) and hops.dtype == np.int16
    np.testing.assert_array_equal(hops[0, :3].ravel(), waves[0])
    np.testing.assert_array_equal(hops[0, 3], waves[0][:256])
    np.testing.assert_array_equal(hops[1, 2], waves[1][:256])
    np.testing.assert_array_equal(hops[2, 0], waves[0][256:512])


@pytest.fixture(scope="module")
def wav_files(fx, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("streaming_wavs")
    paths = []
    for i, wave in enumerate(fx["waves"][:2]):
        paths.append(str(tmp / f"u{i}.wav"))
        write_wav(paths[-1], wave, 16000)
    return paths


def test_cli_stream_subprocess_on_cpu(fx, wav_files, tmp_path):
    out = tmp_path / "out"
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch", "decode", *wav_files,
         "--wts", fx["wts"], "--norm", fx["norm"], "--out-dir", str(out),
         "--stream", "1000", "--device", "cpu", "--blend", "auto",
         "--smooth"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert "warning" not in r.stderr
    lines = r.stdout.splitlines()
    for i, (path, wave) in enumerate(zip(wav_files, fx["waves"])):
        s = StreamingEnhancer(fx["wts"], fx["norm"], device="cpu",
                              blend="auto", smooth_strength=1.0)
        want = np.concatenate(
            [s.feed(wave[j:j + 1000]) for j in range(0, len(wave), 1000)]
            + [s.flush()])
        got, sr = read_wav(out / f"u{i}_enhanced.wav")
        assert sr == 16000
        np.testing.assert_array_equal(got, want)
        assert lines[i] == (f"u{i}: streamed (1000-sample chunks, 80 ms "
                            f"algorithmic latency) -> "
                            f"{out / f'u{i}_enhanced.wav'}")


def test_cli_stream_warns_of_ignored_options(fx, wav_files, tmp_path, capsys):
    scp = tmp_path / "clean.scp"
    scp.write_text(wav_files[0] + "\n")
    rc = cli_main(["decode", wav_files[0], "--wts", fx["wts"],
                   "--norm", fx["norm"], "--out-dir", str(tmp_path / "o"),
                   "--stream", "700", "--device", "cpu", "--ni", "--batch",
                   "4", "--clean-scp", str(scp), "--postprocess", "-fs", "8",
                   "--mesh-data", "2"])
    assert rc == 0
    captured = capsys.readouterr()
    assert captured.err.strip() == ("warning: --stream ignores --mesh-data, "
                                    "--ni, --batch, --clean-scp, "
                                    "--postprocess, -fs")
    assert "80 ms algorithmic latency" in captured.out
    assert not (tmp_path / "o" / "u0.info.txt").exists()
    got, _ = read_wav(tmp_path / "o" / "u0_enhanced.wav")
    want, _ = _stream(fx["waves"][0], fx["wts"], fx["norm"])
    np.testing.assert_array_equal(got, want)


def test_cli_stream_picks_the_framing_from_the_header(models, tmp_path):
    wts, norm, waves = models[11025]
    path = str(tmp_path / "low.wav")
    write_wav(path, waves[2], 11025)
    assert cli_main(["decode", path, "--wts", wts, "--norm", norm,
                     "--out-dir", str(tmp_path), "--stream", "333",
                     "--device", "cpu"]) == 0
    got, sr = read_wav(tmp_path / "low_enhanced.wav")
    assert sr == 11025
    want = Enhancer(wts, norm, device="cpu",
                    sample_rate=11025).enhance(waves[2])[0]
    assert _lsb(got, want) <= 1


def test_stream_cuda_requests_raise_without_gpu(fx, wav_files, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="is_available"):
        StreamingEnhancer(fx["wts"], fx["norm"])
    with pytest.raises(RuntimeError, match="is_available"):
        cli_main(["decode", wav_files[0], "--wts", fx["wts"],
                  "--norm", fx["norm"], "--out-dir", str(tmp_path / "o"),
                  "--stream", "1000"])
    assert not (tmp_path / "o").exists() or not os.listdir(tmp_path / "o")


@pytest.mark.cuda
@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_replayed_step_equals_eager_step_on_the_card(tmp_path, compute_dtype):
    """The captured step replayed per hop against the same step run eagerly
    on the card: outputs and the final state bit for bit, over 50 hops at
    S = 8, through push and push_many; one kernel launch per eager hop.
    In bfloat16 the card's waves are held to the CPU's at 1 % of the peak
    (rounding flips), in float32 at 1 LSB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    wts, norm, waves = _model(str(tmp_path), 16000, seed=7)
    hops = stream_hops(waves, 8, 50)
    kw = {"n_streams": 8, "blend": "auto", "smooth_strength": "auto",
          "compute_dtype": compute_dtype}
    replayed = StreamingEnhancer(wts, norm, **kw)
    before = lps_kernel.launches
    streaming.hops_replayed = 0
    eager = StreamingEnhancer(wts, norm, graph=False, **kw)
    for j in range(10):
        got = replayed.push(hops[:, j].astype(np.float32))
        want = eager.push(hops[:, j].astype(np.float32))
        assert (got is None) == (want is None)
        if got is not None:
            np.testing.assert_array_equal(got, want)
    for lo in range(10, 50, 8):
        got, valid = replayed.push_many(hops[:, lo:lo + 8], int16_wire=True)
        want, _ = eager.push_many(hops[:, lo:lo + 8], int16_wire=True)
        assert valid.all()
        np.testing.assert_array_equal(got, want)
    for got, want in zip(replayed.flush_hops(), eager.flush_hops()):
        np.testing.assert_array_equal(got, want)
    assert streaming.hops_replayed == 50
    assert lps_kernel.launches == before + 50
    for name, x, y in zip(replayed.state._fields, replayed.state,
                          eager.state):
        assert torch.equal(x, y), name
    host = StreamingEnhancer(wts, norm, device="cpu", **kw)
    cpu_out, _ = host.push_many(hops, int16_wire=True)
    replayed.reset()
    card_out, _ = replayed.push_many(hops, int16_wire=True)
    if compute_dtype == "bfloat16":
        _bf16_close(card_out.ravel(), cpu_out.ravel())
    else:
        assert _lsb(card_out.ravel(), cpu_out.ravel()) <= 1


@pytest.fixture(scope="module")
def mesh_stream(tmp_path_factory):
    """8 streams over two gloo ranks, and over one process."""
    from torch_mp_worker import run_decode_cluster, write_decode_problem

    where = tmp_path_factory.mktemp("mesh_stream")
    problem = write_decode_problem(where)
    ranks = run_decode_cluster(where, 2)
    one = StreamingEnhancer(str(where / "m.wts"), str(where / "m.norm"),
                            n_streams=8, device="cpu")
    return where, problem, ranks, one.push_many(problem["hops"],
                                                int16_wire=True)


def test_sharded_streaming_matches_single(mesh_stream):
    _, problem, ranks, (out, valid) = mesh_stream
    for rank in ranks:
        np.testing.assert_array_equal(rank["stream_valid"], valid)
        np.testing.assert_array_equal(rank["stream"], out)
    assert rank["stream"].shape == problem["hops"].shape
    assert valid.sum() == problem["hops"].shape[1] - 4      # warm-up hops


def test_sharded_streaming_matches_jax_sharded(mesh_stream):
    from tpu_se.infer import StreamingEnhancer as JaxStreamer
    from tpu_se.parallel import make_mesh

    where, problem, ranks, _ = mesh_stream
    ref = JaxStreamer(str(where / "m.wts"), str(where / "m.norm"),
                      n_streams=8, mesh=make_mesh(2, 1))
    out, valid = ref.push_many(problem["hops"], int16_wire=True)
    np.testing.assert_array_equal(ranks[0]["stream_valid"], valid)
    got = ranks[0]["stream"]
    assert np.abs(got.astype(np.int32) - np.asarray(out)).max() <= 1


def _narrow_stream_problem(where):
    """The smoke's utterances and 8 x 16 hops of them, with a model of
    hidden width 64 (where the CPU's 2-row and 8-row products differ)."""
    from tpu_se_torch.bench.fixtures import write_fixtures

    fx = write_fixtures(str(where), layersizes=(1799, 64, 64, 64, 257))
    return fx, stream_hops(fx["waves"], 8, 16)


def test_a_mesh_rank_streams_one_process_bits(tmp_path):
    """Each rank of a data axis of 4 (2 channels a rank; a ``Mesh``
    without a group, whose gathers return the rank's own rows) streams
    its rows of one process's 8 channels bit for bit.  A 2-row product
    sums in another order than an 8-row one (at this width on the CPU, at
    every width on a card, where cuBLAS picks another kernel), so the
    streams drifted by 1 LSB until every rank ran its products at the
    mesh's 8 rows."""
    from tpu_se_torch.parallel import Mesh

    fx, hops = _narrow_stream_problem(tmp_path)
    one, valid = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=8,
                                   device="cpu").push_many(
                                       hops, int16_wire=True)
    for k in range(4):
        mine, got_valid = StreamingEnhancer(
            fx["wts"], fx["norm"], n_streams=8, device="cpu",
            mesh=Mesh(k, 4, "cpu", None)).push_many(hops, int16_wire=True)
        np.testing.assert_array_equal(got_valid, valid)
        np.testing.assert_array_equal(mine, one[2 * k:2 * k + 2])


def test_sharded_streaming_over_four_ranks_matches_one_rank(tmp_path):
    """8 streams over four gloo ranks against one rank (the same worker,
    so the same BLAS threads), bit for bit on every rank."""
    from torch_mp_worker import run_decode_cluster

    fx, hops = _narrow_stream_problem(tmp_path)
    os.replace(fx["wts"], tmp_path / "m.wts")
    os.replace(fx["norm"], tmp_path / "m.norm")
    np.savez(tmp_path / "decode.npz", waves=np.concatenate(fx["waves"]),
             lengths=np.array([len(w) for w in fx["waves"]]), hops=hops)
    one, = run_decode_cluster(tmp_path, 1)
    for rank in run_decode_cluster(tmp_path, 4):
        np.testing.assert_array_equal(rank["stream_valid"],
                                      one["stream_valid"])
        np.testing.assert_array_equal(rank["stream"], one["stream"])


@pytest.mark.parametrize("n_streams", [1, 3])
def test_mesh_streams_must_split_over_the_data_axis(fx, n_streams):
    from tpu_se_torch.parallel import Mesh

    with pytest.raises(ValueError, match=f"n_streams {n_streams} not "
                                         "divisible by mesh data axis 2"):
        StreamingEnhancer(fx["wts"], fx["norm"], n_streams=n_streams,
                          mesh=Mesh(0, 2, "cpu", None))
    # A model axis takes no channels: a 1 x 2 mesh streams them all.
    s = StreamingEnhancer(fx["wts"], fx["norm"], n_streams=n_streams,
                          mesh=Mesh(1, 2, "cpu", None, model=2))
    assert s.state.ring.shape[0] == n_streams
