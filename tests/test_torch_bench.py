"""The port's measurement modules (``tpu_se_torch/bench/{train,decode,
stream,loader,build,scaling}.py``) on the CPU.

- Each runs end to end with ``--device cpu`` at a narrow width
  ((1799, 64, 257) or a hidden width of 16) and few repeats; its last line
  is one JSON object headed by the reference tool's ``metric``, ``value``
  and ``unit``, with the reference record's keys, ``null`` in every
  device-only field and every one of its own checks held.
- Without ``--device cpu`` on a machine without a card each exits
  non-zero (decided inside the test).
- ``mfu``'s count is 75,595,776 FLOPs per frame at the full width.
- Parity with ``tpu_se`` on the benches' own inputs: two bunches of
  ``bench/train.py``'s workload at (1799, 64, 257) through both
  ``train_chunk``s (rtol 2e-5, atol 1e-6: ``tests/test_torch_train.py``'s
  bar for a run at that width, float32 sums in another order), and four of
  ``bench/decode.py``'s utterances through both ``Enhancer``s (waves within
  1 int16 LSB, ``tests/test_torch_decode.py``'s bar).
"""

import contextlib
import io
import json
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_se.train as ref_train
from tpu_se.infer import Enhancer as JaxEnhancer
from tpu_se_torch import train
from tpu_se_torch.bench import build, decode, loader, scaling, stream
from tpu_se_torch.bench import train as train_bench
from tpu_se_torch.bench.timing import Reading
from tpu_se_torch.infer import Enhancer
from tpu_se_torch.models import DEFAULT_LAYERSIZES, params_from_numpy

ROOT = pathlib.Path(__file__).resolve().parent.parent
NARROW = "1799,64,257"
CPU_FIELDS = {"platform": "cpu", "kind": None, "count": None, "card": None}

# name -> (module, small CPU arguments, reference keys, device-only keys)
BENCHES = {
    "train": (train_bench, ["--layersizes", NARROW, "--bunches", "2",
                            "--reps", "1"],
              ["step", "mfu", "peak_tflops"],
              ["mfu", "peak_tflops", "device_busy_us_per_bunch",
               "idle_share", "launches_per_bunch",
               "ggd_output_grad_launches"]),
    "decode": (decode, ["--layersizes", NARROW, "--utts", "4", "--frames",
                        "40", "--batch", "2", "--reps", "2",
                        "--latency-utts", "3"],
               ["per_utt", "utts", "frames_per_utt", "reps", "batch_size"]
               + [f"{p}_{k}" for p in ("per_utt", "batched", "wave_only")
                  for k in ("frames_per_sec", "x_realtime")],
               [f"device_only_{p}_{k}"
                for p in ("per_utt", "batched", "wave_only")
                for k in ("frames_per_sec", "x_realtime")]
               + ["mfu", "lps_launches"]),
    "stream": (stream, ["--layersizes", NARROW, "--streams", "1", "3",
                        "--hops", "12"],
               ["n_streams", "p99_hop_ms_s1", "device_only_p50_ms_s1",
                "hop_samples", "hop_budget_ms", "streams",
                "algorithmic_latency_ms"],
               ["device_only_p50_ms_s1", "graph_replays", "lps_launches"]),
    "loader": (loader, ["--frames", "2000"], ["vs_baseline", "detail"], []),
    "build": (build, ["--wavs", "3", "--seconds", "1", "--jobs", "2"],
              ["n_wavs", "jobs", "seconds_per_wav", "lps_extract",
               "make_pfile"], ["lps_launches"]),
    "scaling": (scaling, ["--meshes", "1", "--batch-per-device", "16,8",
                          "--hidden", "16", "--bunches", "2", "--reps", "1"],
                ["vs_baseline", "detail"],
                ["ggd_output_grad_launches", "ggd_colsum_launches",
                 "ggd_grad_from_sums_launches"]),
}
METRICS = {"train": "train_frames_per_sec_per_chip",
           "decode": "decode_frames_per_sec",
           "stream": "stream_realtime_channels",
           "loader": "loader_read_swap_normalize_MBps",
           "build": "lps_extract_files_per_sec",
           "scaling": "dp_weak_scaling_efficiency"}
STREAM_KEYS = ["n_streams", "hop_p50_ms", "hop_p99_ms", "device_only_p50_ms",
               "device_only_p99_ms", "transport_overhead_p50_ms",
               "hops_per_sec", "x_realtime_channels", "chunked_k",
               "chunked_added_latency_ms", "chunked_hops_per_sec",
               "chunked_x_realtime_channels", "chunked_i16_hops_per_sec",
               "chunked_i16_x_realtime_channels"]


def _last_line(module, argv) -> tuple[int, dict]:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = module.main(argv)
    return rc, json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("name", sorted(BENCHES))
def test_bench_runs_on_cpu(name, tmp_path):
    module, argv, keys, device_only = BENCHES[name]
    path = tmp_path / "record.json"
    rc, rec = _last_line(module, argv + ["--device", "cpu",
                                         "--out", str(path)])
    assert rc == 0
    assert list(rec)[:3] == ["metric", "value", "unit"]
    assert rec["metric"] == METRICS[name]
    assert set(keys) <= set(rec)
    assert rec["device"] == CPU_FIELDS
    for key in device_only:
        assert rec[key] is None, key
    assert rec["checks"] and all(rec["checks"].values()), rec["checks"]
    assert json.loads(path.read_text()) == rec
    if name == "train":
        assert "sol_frac" not in rec and "vs_baseline" not in rec
        assert rec["value"] > 0 and rec["frames_per_sec"]["n"] == 5
    if name == "stream":
        for entry in rec["streams"]:
            assert set(STREAM_KEYS) <= set(entry)
            for key in ("device_only_p50_ms", "device_only_p99_ms",
                        "transport_overhead_p50_ms", "hop_p99_ms"):
                assert entry[key] is None, key      # 12 hops: no p99
    if name == "scaling":
        one = rec["batches"]["16"]["one_rank"]
        assert one["turns"] == ["plain", "mesh", "mesh", "plain"]
        # the efficiency's one rank is a spawned rank, as every mesh size
        assert rec["batches"]["16"]["meshes"]["1"]["backend"] == "gloo"
        assert rec["value"] is None                 # one rank: no ratio


def test_scaling_bench_spawns_gloo_ranks():
    r = subprocess.run(
        [sys.executable, "-m", "tpu_se_torch.bench.scaling", "--device",
         "cpu", "--meshes", "1,2", "--batch-per-device", "8", "--hidden",
         "16", "--bunches", "2", "--reps", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    rec = json.loads(r.stdout.strip().splitlines()[-1])
    assert rec["unit"] == "fraction (1->2 devices)"
    two = rec["batches"]["8"]["meshes"]["2"]
    assert (two["backend"], two["global_bunch"]) == ("gloo", 16)
    assert rec["value"] == two["efficiency"] > 0
    assert all(rec["checks"].values()), rec["checks"]


@pytest.mark.parametrize("name", sorted(BENCHES))
def test_bench_without_a_card_exits_nonzero(name):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(SystemExit) as e:
        BENCHES[name][0].main([])
    assert e.value.code not in (0, None)
    assert "CUDA card" in str(e.value.code)


@pytest.mark.parametrize("argv", [["--frames-dtype", "bfloat16"],
                                  ["--step", "overlap", "--act-dtype",
                                   "bfloat16"]], ids=["frames", "overlap"])
def test_train_bench_refuses_what_the_port_lacks(argv):
    with pytest.raises(SystemExit, match="frames|overlap"):
        train_bench.main(argv + ["--device", "cpu"])


def test_mfu_counts_six_flops_per_weight():
    assert train_bench.flops_per_frame(DEFAULT_LAYERSIZES) == 75_595_776


@pytest.mark.parametrize("n,q,want", [(20, 50, 9.5), (19, 50, None),
                                      (100, 90, 89.1), (99, 90, None),
                                      (1000, 99, 989.01), (300, 99, None)])
def test_reading_percentile_needs_ten_samples_beyond(n, q, want):
    r = Reading(range(n))
    got = r.percentile(q)
    assert got is None if want is None else got == pytest.approx(want)
    rec = r.record()
    assert (rec["n"], rec["median"], rec["values"]) == (
        n, (n - 1) / 2, list(map(float, range(n))))
    assert rec["q1"] <= rec["median"] <= rec["q3"]


def test_train_bench_workload_matches_jax():
    """Two bunches of the bench's workload at (1799, 64, 257) through
    ``tpu_se``'s ``train_chunk`` and the port's."""
    layersizes = tuple(int(x) for x in NARROW.split(","))
    noisy, clean, starts, layers = train_bench.workload(layersizes, 128, 2)
    assert noisy.shape == clean.shape == (102400 + 4096, 257)
    hyper = train_bench.hyper_for(128)
    kw = dict(beta=hyper.beta, ml=hyper.ml, bunchsize=128,
              context=hyper.context, targ_offset=hyper.targ_offset,
              grad_scale=hyper.grad_scale)
    want = ref_train.train_chunk(
        ref_train.make_train_state(
            [{k: jnp.asarray(v) for k, v in l.items()} for l in layers], 257),
        jnp.asarray(noisy), jnp.asarray(clean), jnp.asarray(starts),
        jnp.float32(train_bench.LRATE), ref_train.TrainHyper(**kw))
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    train.train_chunk(state, torch.from_numpy(noisy), torch.from_numpy(clean),
                      torch.from_numpy(starts.astype(np.int64)),
                      train_bench.LRATE, hyper)
    for got, v, w, wv in zip(train.param_layers(state.model), state.velocity,
                             want.params, want.velocity):
        for k in ("w", "b"):
            np.testing.assert_allclose(got[k].detach().numpy(),
                                       np.asarray(w[k]), rtol=2e-5, atol=1e-6)
            np.testing.assert_allclose(v[k].numpy(), np.asarray(wv[k]),
                                       rtol=2e-5, atol=1e-6)
    np.testing.assert_allclose(state.alpha.numpy(), np.asarray(want.alpha),
                               rtol=2e-5, atol=1e-6)


def test_decode_bench_utterances_match_jax(tmp_path):
    """Four of the bench's 448-frame utterances (its own model and
    ``.norm``, at (1799, 64, 257)) through both ``Enhancer``s."""
    layersizes = tuple(int(x) for x in NARROW.split(","))
    wts, norm, waves = decode.workload(str(tmp_path), layersizes, utts=4)
    assert [len(w) for w in waves] == [449 * 256] * 4
    port = Enhancer(wts, norm, device="cpu")
    ref = JaxEnhancer(wts, norm)
    for w in waves:
        got, want = port.enhance(w)[0], np.asarray(ref.enhance(w)[0])
        assert decode.lsb(got, want) <= 1
    got = port.enhance_batch_waves(waves)
    want = ref.enhance_batch_waves(waves)
    assert max(decode.lsb(a, np.asarray(b))
               for a, b in zip(got, want)) <= 1
