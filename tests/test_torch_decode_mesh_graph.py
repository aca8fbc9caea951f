"""The decoder under a data mesh at its padded shapes, and the staged
(smooth/postprocess) decode as two programs per padded shape.

On the CPU (JAX imported inside the tests that use it):

- ``Enhancer(mesh=)`` on two gloo ranks of ``tests/torch_mp_worker.py
  padded`` -- ``enhance`` plain and with ``blend="auto"``, ``enhance_lps``,
  ``enhance_batch`` and ``enhance_batch_waves`` at batches of 1, 3, 4 and
  5, at utterances of 1 and 10 frames (rank 1's block of the 64-frame axis
  wholly past the utterance), 63, 64 and 65 -- and the staged path with
  each option set of ``STAGED_OPTIONS``: every rank returns the same;
  against ``tpu_se``'s ``Enhancer`` under ``make_mesh(2, 1)`` and against
  the port's one process the waves are within 1 int16 LSB and the
  enhanced LPS within rtol 1e-5, atol 1e-5 (the bars of
  ``tests/test_torch_decode.py``'s mesh tests);
- the staged path in one process against ``tpu_se``'s at 63, 64 and 65
  frames: waves within 1 LSB, enhanced LPS within atol 1e-3 (the bar of
  ``tests/test_torch_decode.py``'s staged test);
- what the staged and the mesh programs receive (the padded shape, zeros
  or ``LOG_FLOOR`` rows past the utterance) and what the callers get back
  (cut to each utterance), with a stand-in data axis of 2 and 3.

On a card (marked ``cuda``, no JAX imported): the staged path's two
replayed graphs bit for bit ``graph=False`` in float32 and bfloat16, with
their counters; one NCCL rank (a 1x1 group joined in the test) replaying
every form of ``Enhancer(mesh=)``, blend 0 and ``"auto"``, float32 and
bfloat16, bit for bit ``graph=False`` on the same mesh, with equal LPS
launches and ``Mesh.traffic``, every graph released when the group goes.
Run them there with

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_decode_mesh_graph.py
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from torch_mp_worker import (
    PADDED_BATCHES, PADDED_FRAMES, STAGED_OPTIONS, STAGED_WAVES,
    decode_padded, run_padded_cluster, write_padded_problem,
)
from tpu_se_torch.dsp.analysis import LOG_FLOOR, wav_to_lps
from tpu_se_torch.infer import Enhancer
from tpu_se_torch.infer import decode as decode_mod
from tpu_se_torch.ops import lps_kernel

SHIFT = 256
FORMS = ["enhance_plain", "enhance_auto", "lps_plain", "lps_auto",
         "batch_plain", "batch_auto", "fast_plain", "fast_auto",
         *(f"staged_{name}" for name in STAGED_OPTIONS)]
LPS_ATOL = 1e-3


def _lsb(a, b):
    assert a.shape == b.shape
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return int(d.max()) if d.size else 0


def _form(key: str) -> str:
    """``enhance_plain_3_wave`` -> ``enhance_plain``."""
    return "_".join(key.split("_")[:2])


def _hold(got: dict, want: dict, form: str) -> None:
    keys = sorted(k for k in want if _form(k) == form)
    assert keys and keys == sorted(k for k in got if _form(k) == form)
    for key in keys:
        if got[key].dtype == np.int16:
            assert _lsb(got[key], want[key]) <= 1, key
        else:
            np.testing.assert_allclose(got[key], want[key], rtol=1e-5,
                                       atol=1e-5, err_msg=key)


@pytest.fixture(scope="module")
def problem(tmp_path_factory):
    where = tmp_path_factory.mktemp("padded")
    waves = write_padded_problem(where)
    return {"wts": str(where / "m.wts"), "norm": str(where / "m.norm"),
            "waves": waves, "where": where}


@pytest.fixture(scope="module")
def ranks(problem):
    return run_padded_cluster(problem["where"], 2)


@pytest.fixture(scope="module")
def jax_mesh(problem):
    """``decode_padded``'s forms through ``tpu_se``'s ``Enhancer`` under
    ``make_mesh(2, 1)``, by the same names."""
    from tpu_se.infer import Enhancer as JaxEnhancer
    from tpu_se.parallel import make_mesh

    mesh = make_mesh(2, 1)
    waves = problem["waves"]
    out = {}
    for blend in (0.0, "auto"):
        tag = "auto" if blend else "plain"
        enh = JaxEnhancer(problem["wts"], problem["norm"], blend=blend,
                          mesh=mesh)
        for i, w in enumerate(waves):
            wave, _, lps = enh.enhance(w)
            out[f"enhance_{tag}_{i}_wave"] = wave
            out[f"enhance_{tag}_{i}_lps"] = lps
            out[f"lps_{tag}_{i}"] = enh.enhance_lps(
                wav_to_lps(w, device="cpu"))
        for n in PADDED_BATCHES:
            for j, (wave, _, lps) in enumerate(enh.enhance_batch(waves[:n])):
                out[f"batch_{tag}_{n}_{j}_wave"] = wave
                out[f"batch_{tag}_{n}_{j}_lps"] = lps
            for j, wave in enumerate(enh.enhance_batch_waves(waves[:n])):
                out[f"fast_{tag}_{n}_{j}_wave"] = wave
    for name, kw in STAGED_OPTIONS.items():
        enh = JaxEnhancer(problem["wts"], problem["norm"], mesh=mesh, **kw)
        for i in STAGED_WAVES:
            wave, _, lps = enh.enhance(waves[i])
            out[f"staged_{name}_{i}_wave"] = wave
            out[f"staged_{name}_{i}_lps"] = lps
    return out


# -- on the CPU ----------------------------------------------------------------

@pytest.mark.parametrize("form", FORMS)
def test_padded_mesh_decode_matches_jax(ranks, jax_mesh, form):
    for rank in ranks[1:]:
        for key, value in ranks[0].items():
            np.testing.assert_array_equal(rank[key], value, err_msg=key)
    _hold(ranks[0], jax_mesh, form)


@pytest.fixture(scope="module")
def one(problem):
    return decode_padded(problem["wts"], problem["norm"], problem["waves"],
                         None, "cpu")


@pytest.mark.parametrize("form", FORMS)
def test_padded_mesh_decode_matches_one_process(ranks, one, form):
    _hold(ranks[0], one, form)


@pytest.mark.parametrize("name", list(STAGED_OPTIONS))
def test_staged_at_bucket_edges_matches_jax(problem, name):
    from tpu_se.infer import Enhancer as JaxEnhancer

    kw = STAGED_OPTIONS[name]
    ours = Enhancer(problem["wts"], problem["norm"], device="cpu", **kw)
    theirs = JaxEnhancer(problem["wts"], problem["norm"], **kw)
    for i in STAGED_WAVES:
        t = PADDED_FRAMES[i]
        got, want = ours.enhance(problem["waves"][i]), theirs.enhance(
            problem["waves"][i])
        assert got[0].shape == want[0].shape == (t * SHIFT + SHIFT,)
        assert got[1].shape == want[1].shape == (t, 2 * SHIFT)
        assert _lsb(got[0], want[0]) <= 1
        np.testing.assert_allclose(got[2], want[2], rtol=0, atol=LPS_ATOL)


def _spy(enh, monkeypatch, names) -> list:
    """Record (program, input shapes, n_valid) of each call of ``names``."""
    seen = []
    for name in names:
        fn = getattr(enh, name)

        def run(*inputs, fn=fn, name=name):
            seen.append((name, *(tuple(x.shape) for x in inputs[:-1]),
                         inputs[-1].tolist()))
            if name == "_synth_core":
                lps, frames, n_valid = inputs
                t = int(n_valid[0])
                assert bool((lps[:, t:] == LOG_FLOOR).all())
                assert not frames[:, t:].any()
            return fn(*inputs)
        monkeypatch.setattr(enh, name, run)
    return seen


def test_staged_programs_run_at_the_padded_shape_and_cut_back(problem,
                                                              monkeypatch):
    enh = Enhancer(problem["wts"], problem["norm"], device="cpu",
                   smooth_strength="auto", postprocess=True)
    seen = _spy(enh, monkeypatch, ("_staged_core", "_synth_core"))
    for i in STAGED_WAVES + (0,):
        t = PADDED_FRAMES[i]
        wave, recon, lps = enh.enhance(problem["waves"][i])
        assert wave.shape == (t * SHIFT + SHIFT,)
        assert recon.shape == (t, 2 * SHIFT) and lps.shape == (t, 257)
    assert seen == [
        ("_staged_core", (1, 64, 512), [63]),
        ("_synth_core", (1, 64, 257), (1, 64, 512), [63]),
        ("_staged_core", (1, 64, 512), [64]),
        ("_synth_core", (1, 64, 257), (1, 64, 512), [64]),
        ("_staged_core", (1, 128, 512), [65]),
        ("_synth_core", (1, 128, 257), (1, 128, 512), [65]),
        ("_staged_core", (1, 64, 512), [1]),
        ("_synth_core", (1, 64, 257), (1, 64, 512), [1])]
    # Too short for a frame: no program, the reference's zeros.
    seen.clear()
    wave, recon, lps = enh.enhance(np.zeros(300, np.int16))
    assert (wave.shape, recon.shape, lps.shape) == ((SHIFT,), (0, 512),
                                                    (0, 257))
    assert not wave.any() and not seen


class _DataAxis:
    """A stand-in for a mesh's data axis of ``data`` ranks, this one
    ``data_rank``: a gather repeats this rank's block, a sum is its own."""

    def __init__(self, data, data_rank):
        self.data, self.data_rank = data, data_rank
        self.device = torch.device("cpu")
        self.backend = "gloo"

    def all_gather(self, t, dim, axis):
        return torch.cat([t] * self.data, dim)

    def all_reduce_sum(self, t, axis):
        return t


def test_frame_blocks():
    block = decode_mod._frame_block
    assert block(64, 7, SimpleNamespace(data=2, data_rank=0)) == (0, 0, 32,
                                                                  35)
    assert block(64, 7, SimpleNamespace(data=2, data_rank=1)) == (29, 32,
                                                                  64, 64)
    assert block(66, 7, SimpleNamespace(data=3, data_rank=1)) == (19, 22,
                                                                  44, 47)
    assert block(64, 7, SimpleNamespace(data=1, data_rank=0)) == (0, 0, 64,
                                                                  64)


@pytest.mark.parametrize("data,rank", [(2, 1), (3, 2)])
def test_mesh_programs_run_at_the_padded_shape_and_cut_back(problem,
                                                            monkeypatch,
                                                            data, rank):
    enh = Enhancer(problem["wts"], problem["norm"], device="cpu",
                   mesh=_DataAxis(data, rank))
    seen = _spy(enh, monkeypatch, ("_block_core", "_core", "_lps_core"))
    waves = problem["waves"]
    bucket = 64 if data == 2 else 66     # 64 up to a multiple of the axis
    for i, t in enumerate(PADDED_FRAMES):
        wave, recon, lps = enh.enhance(waves[i])
        assert (wave.shape, recon.shape, lps.shape) == (
            (t * SHIFT + SHIFT,), (t, 512), (t, 257))
        assert np.isfinite(lps).all()
    got = enh.enhance_batch(waves[:3])
    assert [g[2].shape for g in got] == [(t, 257) for t in
                                         PADDED_FRAMES[:3]]
    fast = enh.enhance_batch_waves(waves[:3])
    assert [len(w) for w in fast] == [t * SHIFT + SHIFT
                                      for t in PADDED_FRAMES[:3]]
    out = enh.enhance_lps(wav_to_lps(waves[1], device="cpu"))
    assert out.shape == (10, 257) and np.isfinite(out).all()
    # A batch of 3 pads to 4 rows (6 at a data axis of 3), 2 a rank.
    rows = (list(PADDED_FRAMES[:3]) + [0] * 3)[2 * rank:2 * rank + 2]
    assert seen == (
        [("_block_core", (1, -(-t // bucket) * bucket, 512), [t])
         for t in PADDED_FRAMES]
        + [("_core", (2, bucket, 512), rows)] * 2
        + [("_lps_core", (1, bucket, 257), [10])])


# -- on the card ----------------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (a CUDA graph has no CPU mode)")
    return torch.device("cuda")


def _flat(result):
    if isinstance(result, np.ndarray):
        return [result]
    if isinstance(result, torch.Tensor):
        return [result.cpu().numpy()]
    return [a for item in result for a in _flat(item)]


def _counts():
    torch.cuda.synchronize()
    return np.array([lps_kernel.launches, decode_mod.decodes_replayed,
                     decode_mod.decode_graphs_captured])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_staged_replays_equal_eager_on_the_card(card, problem, dtype):
    """Each option set: ``enhance`` of every wave, first call (the eager
    runs before the captures) and a replay, bit for bit ``graph=False``;
    two programs a call, one LPS launch a call, four graphs (two T
    buckets)."""
    for name, kw in STAGED_OPTIONS.items():
        kw = dict(kw, device=card, compute_dtype=dtype)
        replayed = Enhancer(problem["wts"], problem["norm"], **kw)
        eager = Enhancer(problem["wts"], problem["norm"], graph=False, **kw)
        before = _counts()
        for w in problem["waves"]:
            want = _flat(eager.enhance(w))
            for _ in range(2):
                for g, x in zip(_flat(replayed.enhance(w)), want):
                    np.testing.assert_array_equal(g, x, err_msg=name)
        n = len(problem["waves"])
        launches, replays, captures = _counts() - before
        assert (launches, replays, captures) == (3 * n, 4 * n - 4, 4), name
        assert not eager._graphs and len(replayed._graphs) == 4


def _mesh_calls(problem, card):
    """Every form of ``Enhancer(mesh=)`` at several padded shapes, as
    (name, call)."""
    waves = problem["waves"]
    lps = [wav_to_lps(w, device="cpu") for w in waves]
    out = [(f"enhance{t}", lambda e, w=w: e.enhance(w))
           for t, w in zip(PADDED_FRAMES, waves)]
    out += [(f"lps{t}", lambda e, x=x: e.enhance_lps(x))
            for t, x in zip(PADDED_FRAMES, lps)]
    out += [(f"batch{n}", lambda e, n=n: e.enhance_batch(waves[:n]))
            for n in (3, 5)]
    out += [(f"waves{n}", lambda e, n=n: e.enhance_batch_waves(waves[:n]))
            for n in (3, 5)]
    x = torch.zeros((3, 66 * SHIFT), dtype=torch.int16)
    for i, w in enumerate(waves[2:]):
        m = min(len(w), x.shape[1])
        x[i, :m] = torch.from_numpy(w[:m])
    n_valid = torch.tensor([63, 64, 65])
    out.append(("tensor", lambda e: e.decode_waves_tensor(
        x.to(card), n_valid.to(card)).clone()))
    return out


def _traffic(mesh):
    return [n for ops in mesh.traffic.values() for e in ops.values()
            for n in e]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,blend", [("float32", 0.0),
                                         ("float32", "auto"),
                                         ("bfloat16", 0.0),
                                         ("bfloat16", "auto")])
def test_one_nccl_rank_replays_every_form(card, problem, dtype, blend):
    from tpu_se_torch.parallel import (
        initialize_distributed, make_mesh, shutdown_distributed,
    )
    from tpu_se_torch.parallel.mesh import free_port

    initialize_distributed(f"127.0.0.1:{free_port()}", 1, 0, None, "cuda")
    try:
        mesh = make_mesh(1, 1, "cuda")
        kw = dict(device=card, compute_dtype=dtype, blend=blend, mesh=mesh)
        pairs = [(Enhancer(problem["wts"], problem["norm"], **kw),
                  Enhancer(problem["wts"], problem["norm"], graph=False,
                           **kw), _mesh_calls(problem, card))]
        staged = dict(kw, smooth_strength="auto", postprocess=True)
        pairs.append((Enhancer(problem["wts"], problem["norm"], **staged),
                      Enhancer(problem["wts"], problem["norm"],
                               graph=False, **staged),
                      [(f"staged{PADDED_FRAMES[i]}",
                        lambda e, w=problem["waves"][i]: e.enhance(w))
                       for i in STAGED_WAVES]))
        kept = []
        for replayed, eager, calls in pairs:
            assert replayed.replays and not eager.replays
            before = _counts()
            for name, call in calls:
                start, sent = _counts(), _traffic(mesh)
                want = _flat(call(eager))
                launches = (_counts() - start)[0]
                moved = np.subtract(_traffic(mesh), sent)
                for _ in range(2):
                    start, sent = _counts(), _traffic(mesh)
                    got = _flat(call(replayed))
                    assert len(got) == len(want)
                    for g, w in zip(got, want):
                        np.testing.assert_array_equal(g, w, err_msg=name)
                    assert (_counts() - start)[0] == launches, name
                    np.testing.assert_array_equal(
                        np.subtract(_traffic(mesh), sent), moved,
                        err_msg=name)
            _, replays, captures = _counts() - before
            assert captures == len(replayed._graphs) > 0
            assert replays + captures == 2 * sum(
                2 if name.startswith("staged") else 1 for name, _ in calls)
            assert not eager._graphs
            kept += list(replayed._graphs.values())
    finally:
        shutdown_distributed()
    assert kept and all(g.key is None for g in kept)
