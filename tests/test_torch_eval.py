"""tpu_se_torch.infer.{stoi,pesq,evaluate} against tpu_se's, on the CPU.

The port's STOI, PESQ and scoring are numpy copies of ``tpu_se``'s, the
same operations in the same order, so every score must be EXACTLY equal
(tolerance 0): seeded pairs at 16 kHz (wideband) and 8 kHz (narrowband),
identity pairs, and a pair whose second utterance arrives 12 ms late,
which only the P.862 fine alignment puts right.  ``score_pair`` and
``score_files`` must give equal dicts and raise the same ``ValueError``s.
"""

import importlib

import numpy as np
import pytest

import tpu_se.io as ref_io

# The packages' ``infer/__init__`` export functions named ``pesq`` and
# ``stoi`` that hide the submodules from attribute access.
pesq, stoi, evaluate, ref_pesq, ref_stoi, ref_evaluate = (
    importlib.import_module(f"{pkg}.infer.{mod}")
    for pkg in ("tpu_se_torch", "tpu_se")
    for mod in ("pesq", "stoi", "evaluate"))


def _speechlike(n, fs, seed):
    """Harmonic tones under a floored 2.5 Hz envelope (no internal 200 ms
    silences, so each is one P.862 utterance)."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    x = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 6.28)) * a
            for f, a in ((220, 1.0), (440, 0.7), (880, 0.4), (1760, 0.2),
                         (3000, 0.1)) if f < fs / 2)
    envelope = 0.25 + 0.75 * np.clip(np.sin(2 * np.pi * 2.5 * t), 0, None)
    return x * envelope * 8000


def _pair(kind, fs):
    rng = np.random.default_rng(fs)
    if kind == "delayed":
        sil = np.zeros(int(0.35 * fs))
        u1, u2 = (_speechlike(int(0.9 * fs), fs, s) for s in (3, 4))
        ref = np.concatenate([sil, u1, sil, u2, sil])
        deg = ref + rng.normal(size=len(ref)) * 300.0
        s = len(sil) * 2 + len(u1)
        shift = int(0.012 * fs)
        deg[s + shift: s + len(u2) + shift] = deg[s: s + len(u2)].copy()
        return ref, deg
    ref = _speechlike(int(1.25 * fs), fs, 1)
    if kind == "identity":
        return ref, ref.copy()
    return ref, ref + rng.normal(size=len(ref)) * 600.0


CASES = [(kind, fs) for kind in ("noisy", "identity", "delayed")
         for fs in (16000, 8000)]


@pytest.mark.parametrize("kind,fs", CASES)
def test_scores_equal_tpu_se(kind, fs):
    ref, deg = _pair(kind, fs)
    assert stoi.stoi(ref, deg, fs) == ref_stoi.stoi(ref, deg, fs)
    got = pesq.pesq(ref, deg, fs)
    assert got == ref_pesq.pesq(ref, deg, fs)
    assert (pesq.pesq(ref, deg, fs, return_raw=True)
            == ref_pesq.pesq(ref, deg, fs, return_raw=True))
    assert stoi.pesq_score(ref, deg, fs) == ref_stoi.pesq_score(ref, deg, fs)
    crude = pesq.pesq(ref, deg, fs, fine_align=False)
    assert crude == ref_pesq.pesq(ref, deg, fs, fine_align=False)
    if kind == "delayed":          # the fine alignment really ran
        assert got > crude
    if kind == "identity":
        assert got == pytest.approx(ref_pesq.mos_lqo_map(4.5, fs))


@pytest.mark.parametrize("fs", [16000, 8000])
def test_score_pair_equals_tpu_se(fs):
    ref, deg = _pair("noisy", fs)
    clean = ref.astype(np.int16)
    test = np.clip(deg, -32768, 32767).astype(np.int16)[:-77]
    got = evaluate.score_pair(clean, test, fs)
    assert list(got) == list(evaluate.METRICS) == list(ref_evaluate.METRICS)
    assert got == ref_evaluate.score_pair(clean, test, fs)
    assert all(np.isfinite(v) for v in got.values())


def test_score_files_equals_tpu_se(tmp_path):
    paths = {"clean": [], "test": []}
    for i, kind in enumerate(("noisy", "identity")):
        ref, deg = _pair(kind, 16000)
        for name, wave in (("clean", ref), ("test", deg)):
            path = str(tmp_path / f"{name}{i}.wav")
            ref_io.write_wav(path, np.clip(wave, -32768, 32767)
                             .astype(np.int16), 16000)
            paths[name].append(path)
    got = evaluate.score_files(paths["clean"], paths["test"])
    assert got == ref_evaluate.score_files(paths["clean"], paths["test"])
    assert [row["name"] for row in got] == paths["test"]

    ref_io.write_wav(tmp_path / "fast.wav", np.zeros(8000, np.int16), 8000)
    for bad, match in (((paths["clean"], paths["test"][:1]),
                        "2 clean vs 1 test files"),
                       (([paths["clean"][0]], [str(tmp_path / "fast.wav")]),
                        "rate mismatch")):
        for score_files in (evaluate.score_files, ref_evaluate.score_files):
            with pytest.raises(ValueError, match=match):
                score_files(*bad)
