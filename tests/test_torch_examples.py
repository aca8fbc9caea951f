"""The port's example scripts (``tpu_se_torch.examples``) on the CPU.

Twins of ``examples/serve_streaming.py`` and ``examples/demo_pipeline.py``
with the same flags and defaults plus ``--device``; here they run with
``--device cpu`` on small synthetic inputs (a (1799, 32, 257) model, a
1.2 s wav; a 6-condition stand-in of the demo corpus, a (1799, 16, 257)
network and 2 epochs through ``run``'s keyword arguments):

- the streaming twin's single stream is the same int16 samples as a
  direct ``StreamingEnhancer`` ``feed``/``flush`` over the same 1024-sample
  chunks with the same options (bitwise: the same program), and its
  batched shape emits every warm hop of its 4 channels;
- the pipeline twin trains, decodes the held-out condition and writes
  finite SegSNR, LSD and STOI;
- both command lines keep ``tpu_se``'s flags and defaults, and ``python
  -m tpu_se_torch.examples.serve_streaming`` runs as a module.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from tpu_se_torch.bench.fixtures import (
    DEMO_CONDITIONS, _voiced, write_demo_corpus,
)
from tpu_se_torch.examples import demo_pipeline, serve_streaming
from tpu_se_torch.infer import StreamingEnhancer
from tpu_se_torch.io import read_wav, write_norm, write_wav, write_wts
from tpu_se_torch.models import init_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A (1799, 32, 257) model, its .norm and a 1.2 s noisy wav."""
    root = tmp_path_factory.mktemp("examples")
    paths = {"wts": str(root / "m.wts"), "norm": str(root / "m.norm"),
             "wav": str(root / "noisy.wav")}
    write_wts(paths["wts"], init_params(7, (1799, 32, 257)))
    rng = np.random.default_rng(8)
    write_norm(paths["norm"], (rng.normal(size=257) + 8).astype(np.float32),
               (0.2 + 0.1 * rng.random(257)).astype(np.float32))
    _, noisy = _voiced(19200, 140.0, rng)
    write_wav(paths["wav"], np.clip(noisy, -32768, 32767).astype(np.int16))
    return paths


def test_serve_streaming_single_stream_is_a_direct_feed_flush(model,
                                                              tmp_path):
    out = str(tmp_path / "enhanced_stream.wav")
    lines = []
    got = serve_streaming.serve(model["wav"], model["wts"], model["norm"],
                                out, "cpu", log=lines.append)
    noisy, sr = read_wav(model["wav"])
    direct = StreamingEnhancer(model["wts"], model["norm"], sample_rate=sr,
                               blend="auto", smooth_strength="auto",
                               device="cpu")
    pieces = [direct.feed(noisy[i:i + 1024])
              for i in range(0, len(noisy), 1024)]
    pieces.append(direct.flush())
    want = np.concatenate(pieces)
    written, _ = read_wav(out)
    assert got["enhanced"].dtype == np.int16
    np.testing.assert_array_equal(got["enhanced"], want)
    np.testing.assert_array_equal(written, want)
    assert len(want) == len(noisy)
    # The batched shape: 4 channels, every hop past the warm-up emitted.
    multi = StreamingEnhancer(model["wts"], model["norm"], n_streams=4,
                              device="cpu")
    assert got["hops"] == min(40, len(noisy) // 256 - 3)
    assert got["warm_hops"] == 4 * (got["hops"] - multi.warmup_hops + 1)
    assert lines[-1] == (f"4 channels x {got['hops']} hops pushed, "
                         f"{got['warm_hops']} warm hops emitted (int16 wire)")


def test_serve_streaming_runs_as_a_module(model, tmp_path):
    out = str(tmp_path / "module.wav")
    proc = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch.examples.serve_streaming",
         model["wav"], "--wts", model["wts"], "--norm", model["norm"],
         "--out", out, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=ROOT))
    assert proc.returncode == 0, proc.stderr
    assert "single stream:" in proc.stdout and os.path.exists(out)


def test_demo_pipeline_writes_finite_metrics(tmp_path):
    conditions = DEMO_CONDITIONS[:6]
    assert "F-16Cockpit_SNR10" in conditions
    reference = write_demo_corpus(str(tmp_path / "ref"), conditions,
                                  seconds=1.2)
    lines = []
    results = demo_pipeline.run(str(tmp_path / "work"), reference, "cpu",
                                layersizes=(1799, 16, 257), epochs=2,
                                log=lines.append)
    assert lines[0] == "5 train pairs, 1 held out"
    assert [os.path.basename(r["wav"]) for r in results] == [
        "F-16Cockpit_SNR10_NOISY_TEST_DR3_FPKT0_SI1538.wav"]
    r = results[0]
    for key in ("segsnr", "segsnr_noisy", "lsd", "lsd_noisy", "stoi",
                "stoi_noisy"):
        assert np.isfinite(r[key]), (key, r[key])
    enhanced, _ = read_wav(r["out"])
    assert len(enhanced) and np.abs(enhanced).max() > 0
    trained = sorted(os.listdir(tmp_path / "work" / "MLGGD1"))
    assert {"mlp.1.wts", "mlp.2.wts"} <= set(trained)


def test_demo_corpus_stand_in_holds_one_held_out_pair(tmp_path):
    pairs = demo_pipeline.demo_pairs(write_demo_corpus(str(tmp_path),
                                                       seconds=0.1))
    assert len(pairs) == 14
    held = [n for n, _ in pairs if demo_pipeline.HELD_OUT in n]
    assert len(held) == 1
    for noisy, clean in pairs:
        assert clean.endswith(".WAV") and "_CLEAN_" in clean


@pytest.mark.parametrize("script,argv,want", [
    (demo_pipeline, [], ("artifacts/demo_pipeline", "reference", "cuda")),
    (demo_pipeline, ["w", "--reference", "r", "--device", "cpu"],
     ("w", "r", "cpu")),
    (serve_streaming, [],
     (serve_streaming.DEFAULT_WAV,
      "artifacts/ab_objectives/big_pt8/MLGGD1/mlp.50.wts",
      "artifacts/ab_objectives/big_pt8/data/train_noisy.norm",
      "enhanced_stream.wav", "cuda")),
    (serve_streaming, ["x.wav", "--wts", "a", "--norm", "b", "--out", "o",
                       "--device", "cpu"], ("x.wav", "a", "b", "o", "cpu")),
], ids=["pipeline-defaults", "pipeline-flags", "stream-defaults",
        "stream-flags"])
def test_command_lines_keep_the_reference_flags(monkeypatch, script, argv,
                                                want):
    seen = []
    name = "run" if script is demo_pipeline else "serve"
    monkeypatch.setattr(script, name, lambda *a: seen.append(a))
    assert script.main(argv) == 0
    assert seen == [want]
