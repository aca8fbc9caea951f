"""tpu_se_torch's pfile codec and data layer against tpu_se on the CPU.

The port's pfile writer must be byte-identical to ``tpu_se.io``'s and its
readers must give identical arrays; the chunk plans, window starts and
shuffles (the same ``np.random.default_rng`` draws) must be identical,
element for element, to ``tpu_se.data``'s.
"""

import numpy as np
import pytest

import tpu_se.data as ref_data
import tpu_se.io as ref_io
from tpu_se_torch import data, io


def _utterances(lengths, dim=257, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((n, dim)) * 3 + 1).astype(np.float32)
            for n in lengths]


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """A 10-sentence noisy/clean pfile pair and its .norm, written with
    the tpu_se writers."""
    root = tmp_path_factory.mktemp("pair")
    lengths = [53, 140, 6, 7, 90, 211, 120, 33, 77, 150]
    noisy = _utterances(lengths, seed=1)
    clean = [(u * 0.5).astype(np.float32) for u in noisy]
    paths = {k: str(root / f"{k}.pfile") for k in ("noisy", "clean")}
    ref_io.write_pfile(paths["noisy"], noisy)
    ref_io.write_pfile(paths["clean"], clean)
    frames = np.concatenate(noisy)
    paths["norm"] = str(root / "noisy.norm")
    ref_io.write_norm(paths["norm"], frames.mean(0), 1.0 / frames.std(0))
    return paths


@pytest.mark.parametrize("lengths,dim", [([5], 1), ([1, 30, 0, 7], 257),
                                         ([300, 129], 129)])
def test_write_pfile_bytes_match_reference(tmp_path, lengths, dim):
    utts = _utterances(lengths, dim, seed=len(lengths))
    io.write_pfile(tmp_path / "port.pfile", utts)
    ref_io.write_pfile(tmp_path / "ref.pfile", utts)
    assert ((tmp_path / "port.pfile").read_bytes()
            == (tmp_path / "ref.pfile").read_bytes())
    assert not list(tmp_path.glob("*.tmp.*"))


def test_write_pfile_desired_lengths_and_errors(tmp_path):
    utts = _utterances([20, 30])
    io.write_pfile(tmp_path / "port.pfile", utts, desired_lengths=[10, 25])
    ref_io.write_pfile(tmp_path / "ref.pfile", utts, desired_lengths=[10, 25])
    assert ((tmp_path / "port.pfile").read_bytes()
            == (tmp_path / "ref.pfile").read_bytes())
    with pytest.raises(ValueError, match="no utterances"):
        io.write_pfile(tmp_path / "x.pfile", [])
    with pytest.raises(ValueError, match="inconsistent"):
        io.write_pfile(tmp_path / "x.pfile", [utts[0], utts[1][:, :9]])
    with pytest.raises(ValueError, match="count mismatch"):
        io.write_pfile(tmp_path / "x.pfile", utts, desired_lengths=[1])
    assert not (tmp_path / "x.pfile").exists()
    assert not list(tmp_path.glob("*.tmp.*"))


def test_pfile_readers_match_reference(pair):
    path = pair["noisy"]
    assert io.read_pfile_header(path) == ref_io.read_pfile_header(path)
    got = io.read_pfile_meta(path)
    want = ref_io.read_pfile_meta(path)
    assert got[:3] == want[:3]
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(io.read_pfile_rows(path, 257, 50, 400),
                                  ref_io.read_pfile_rows(path, 257, 50, 400))
    a, b = io.read_pfile(path), ref_io.read_pfile(path)
    assert (a.num_frames, a.num_sentences, a.dim) == (
        b.num_frames, b.num_sentences, b.dim)
    for field in ("features", "sent_ids", "frame_ids", "sent_ends"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))


# Sentence lengths in frames; with context 7 each gives max(L - 6, 0)
# windows, so three sentences of 19 frames give 3 x 13 windows: traincache
# 13 makes the plan an exact multiple, and the planner's zero-sample
# trailing chunk must be dropped.
ENDS_CASES = {
    "exact-multiple": np.cumsum([19, 19, 19]),
    "short-sentences": np.cumsum([3, 6, 7, 50, 2, 90, 8]),
    "long": np.cumsum([200, 151, 333, 64, 12, 99]),
}


@pytest.mark.parametrize("name", sorted(ENDS_CASES))
@pytest.mark.parametrize("traincache", [13, 64, 1000])
def test_plan_chunks_and_windows_match_reference(name, traincache):
    ends = ENDS_CASES[name]
    n = len(ends)
    for rng_ in [(0, n - 1), (1, n - 2), (n - 1, n - 1)]:
        got = data.plan_chunks(ends, rng_, traincache)
        want = ref_data.plan_chunks(ends, rng_, traincache)
        for field in ("frame_start", "frame_end", "n_samples"):
            np.testing.assert_array_equal(getattr(got, field),
                                          getattr(want, field))
        assert (got.sent_lo, got.sent_hi, got.n_chunks, got.total_samples) \
            == (want.sent_lo, want.sent_hi, want.n_chunks,
                want.total_samples)
        for c in range(got.n_chunks):
            np.testing.assert_array_equal(data.sentence_windows(got, c),
                                          ref_data.sentence_windows(want, c))
            assert got.n_samples[c] > 0


@pytest.mark.parametrize("t,dim,context", [(1, 257, 7), (2, 3, 7),
                                            (50, 257, 7), (9, 5, 3)])
def test_splice_replicated_matches_reference(t, dim, context):
    frames = np.random.default_rng(t).standard_normal((t, dim)
                                                      ).astype(np.float32)
    got = data.splice.splice_replicated(frames, context)
    want = ref_data.splice.splice_replicated(frames, context)
    assert got.shape == (t, context * dim) and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_zero_sample_trailing_chunk_is_dropped():
    plan = data.plan_chunks(ENDS_CASES["exact-multiple"], (0, 2), 13)
    np.testing.assert_array_equal(plan.n_samples, [13, 13, 13])
    np.testing.assert_array_equal(plan.frame_start, [0, 19, 38])
    np.testing.assert_array_equal(plan.frame_end, [19, 38, 57])
    with pytest.raises(ValueError, match="out of bounds"):
        data.plan_chunks(ENDS_CASES["long"], (2, 9), 64)


@pytest.mark.parametrize("sent_range,traincache", [((0, 7), 256),
                                                    ((8, 9), 102400),
                                                    ((2, 6), 100)])
def test_dataset_chunks_and_shuffles_match_reference(pair, sent_range,
                                                     traincache):
    args = (pair["noisy"], pair["clean"], pair["norm"], sent_range,
            traincache)
    ours = data.PfilePairDataset(*args)
    theirs = ref_data.PfilePairDataset(*args, use_native=False)
    assert (ours.n_chunks, ours.total_samples, ours.dim,
            ours.span_bytes(), ours.frame_span()) == (
        theirs.n_chunks, theirs.total_samples, theirs.dim,
        theirs.span_bytes(), theirs.frame_span())
    for idx in range(ours.n_chunks):
        for seed in (None, 3):
            r1 = None if seed is None else np.random.default_rng(seed)
            r2 = None if seed is None else np.random.default_rng(seed)
            a, b = ours.chunk(idx, r1), theirs.chunk(idx, r2)
            for field in ("noisy", "clean", "starts"):
                np.testing.assert_array_equal(getattr(a, field),
                                              getattr(b, field))
            np.testing.assert_array_equal(a.spliced_inputs(),
                                          b.spliced_inputs())
            np.testing.assert_array_equal(a.targets(), b.targets())
            np.testing.assert_array_equal(ours.chunk_starts(idx),
                                          theirs.chunk_starts(idx))
    r1, r2 = np.random.default_rng(42), np.random.default_rng(42)
    for a, b in zip(ours.epoch_chunk_starts(r1), theirs.epoch_chunk_starts(r2),
                    strict=True):
        np.testing.assert_array_equal(a, b)
    for skip in (0, 1):
        r1, r2 = np.random.default_rng(7), np.random.default_rng(7)
        got = list(ours.epoch_chunks(r1, skip=skip))
        want = list(theirs.epoch_chunks(r2, skip=skip))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.starts, b.starts)
            np.testing.assert_array_equal(a.noisy, b.noisy)
        assert r1.integers(2 ** 31) == r2.integers(2 ** 31)
    for a, b in zip(ours.load_span_normalized(),
                    theirs.load_span_normalized()):
        np.testing.assert_array_equal(a, b)


def test_dataset_rejects_mismatched_pair(pair, tmp_path):
    ref_io.write_pfile(tmp_path / "short.pfile", _utterances([5, 6]))
    with pytest.raises(ValueError, match="sentence tables differ"):
        data.PfilePairDataset(pair["noisy"], tmp_path / "short.pfile",
                              pair["norm"], (0, 1))


def test_prefetch_iterator_order_and_error():
    assert list(data.PrefetchIterator(iter(range(5)))) == list(range(5))
    assert list(data.PrefetchIterator([lambda: 1, lambda: 2])) == [1, 2]

    def broken():
        yield 1
        raise OSError("disk gone")

    it = data.PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="disk gone"):
        next(it)
