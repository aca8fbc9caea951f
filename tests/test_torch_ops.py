"""tpu_se_torch.ops: the LPS kernel's plain version, argument checks, build.

``lps_plain`` is held against the TPU kernel ``tpu_se.ops.lps_pallas``
(interpret mode) and its XLA twin at atol 1e-3 in the log domain (the
port sums in float64, JAX in float32); floor rows must be exactly -50.
The CUDA kernel itself runs only on a card: ``test_lps_cuda_matches_plain``
is marked ``cuda`` and skips without one.  It holds the kernel to
``lps_plain`` at atol 1e-5: both sum in float64, so they agree to a few
float32 ulps of the log power, and a float32 sum would miss by ~1e-3.  On a card (no JAX there) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ops.py

which is why this module imports JAX only inside the tests that use it.
"""

import os
import pathlib

import numpy as np
import pytest
import torch

from tpu_se_torch.dsp.analysis import dft_basis, lps_from_frames
from tpu_se_torch.ops import _build, lps_kernel

LPS_ATOL = 1e-3          # port (float64 sums) against JAX (float32)
CUDA_ATOL = 1e-5         # kernel against lps_plain, both float64 sums


def _frames(t, length=512, seed=0):
    rng = np.random.default_rng(seed)
    frames = (rng.standard_normal((t, length)) * 1000).astype(np.float32)
    frames[3::7] = 0.0
    return frames


@pytest.mark.parametrize("t", [1, 37, 256])
def test_lps_plain_matches_pallas_and_reference(t):
    import jax.numpy as jnp

    from tpu_se.ops import lps_pallas, lps_reference

    frames = _frames(t, seed=t)
    got = lps_kernel.lps_plain(torch.from_numpy(frames),
                               dft_basis(512, "cpu")).numpy()
    pallas = np.asarray(lps_pallas(jnp.asarray(frames), interpret=True))
    ref = np.asarray(lps_reference(jnp.asarray(frames)))
    assert got.shape == (t, 257)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=LPS_ATOL)
    np.testing.assert_allclose(got, ref, rtol=0, atol=LPS_ATOL)
    np.testing.assert_array_equal(got[3::7], -50.0)


@pytest.mark.parametrize("length", [512, 256])
def test_lps_plain_floor_branch_is_exact(length):
    got = lps_kernel.lps_plain(torch.zeros(8, length),
                               dft_basis(length, "cpu"))
    assert got.shape == (8, length // 2 + 1)
    assert bool((got == -50.0).all())
    assert lps_kernel.POWER_FLOOR == float(np.float32(np.exp(-50.0)))


def _args(**change):
    frames = torch.zeros(4, 512)
    basis = torch.zeros(512, 514)
    args = {"frames": frames, "basis": basis}
    args.update(change)
    return args["frames"], args["basis"]


@pytest.mark.parametrize("frames,basis,match", [
    (*_args(frames=torch.zeros(4, 512, dtype=torch.float64)), "float32"),
    (*_args(basis=torch.zeros(512, 514, dtype=torch.float16)), "float32"),
    (*_args(frames=torch.zeros(2, 4, 512)), "2-D"),
    (*_args(frames=torch.zeros(512, 4).t()), "contiguous"),
    (*_args(basis=torch.zeros(256, 514)), "frame length"),
    (*_args(basis=torch.zeros(512, 513)), "2K columns"),
    (*_args(frames=torch.zeros(65535 * 64 + 1, 1),
            basis=torch.zeros(1, 2)), "grid"),
    (*_args(), "CUDA tensor"),
], ids=["frames-f64", "basis-f16", "3-D", "non-contiguous", "length",
        "odd-columns", "too-many-frames", "cpu"])
def test_check_lps_args_rejects(frames, basis, match):
    with pytest.raises(ValueError, match=match):
        lps_kernel.check_lps_args(frames, basis)


def test_lps_cuda_raises_on_cpu_without_launch():
    before = lps_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        lps_kernel.lps_cuda(torch.zeros(4, 512), dft_basis(512, "cpu"))
    assert lps_kernel.launches == before


def test_cpu_lps_path_never_launches_the_kernel():
    before = lps_kernel.launches
    lps_from_frames(torch.from_numpy(_frames(20)))
    lps_from_frames(torch.from_numpy(_frames(20)), method="fft")
    assert lps_kernel.launches == before == 0


def test_nvcc_command_targets_sm90a_without_fast_math():
    sources = _build.cuda_sources()
    assert _build.SRC_DIR / "lps_kernel.cu" in sources
    assert _build.SRC_DIR / "ggd_kernel.cu" in sources
    cmd = _build.nvcc_command("cuda/bin/nvcc", sources, "out/lib.so")
    assert cmd[0] == "cuda/bin/nvcc"
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    for flag in ("-std=c++17", "-O3", "-shared", "-fPIC"):
        assert flag in cmd
    assert cmd[cmd.index("-o") + 1] == "out/lib.so"
    assert cmd[-len(sources):] == [str(s) for s in sources]
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)


def test_find_nvcc_order_and_missing(tmp_path, monkeypatch):
    nvcc = tmp_path / "bin" / "nvcc"
    nvcc.parent.mkdir()
    nvcc.write_text("#!/bin/sh\n")
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    assert _build.find_nvcc() == str(nvcc)
    monkeypatch.setattr(os, "access", lambda *a, **k: False)
    monkeypatch.setattr(_build.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_library_path_is_keyed_by_source_content(tmp_path):
    src = tmp_path / "k.cu"
    src.write_text("// one\n")
    first = _build.library_path([src])
    assert _build.library_path([src]) == first
    src.write_text("// two\n")
    second = _build.library_path([src])
    assert second != first
    assert second.parent == _build.BUILD_DIR
    assert pathlib.Path(_build.BUILD_DIR).parts[-2:] == ("build",
                                                         "tpu_se_torch")


@pytest.mark.cuda
@pytest.mark.parametrize("length", [512, 256])
def test_lps_cuda_matches_plain(length):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    basis = dft_basis(length, "cuda")
    for t in (1, 37, 256, 4097):
        x = torch.from_numpy(_frames(t, length, seed=t)).cuda()
        before = lps_kernel.launches
        got = lps_kernel.lps_cuda(x, basis)
        torch.cuda.synchronize()
        assert lps_kernel.launches == before + 1
        want = lps_kernel.lps_plain(x, basis)
        torch.testing.assert_close(got, want, rtol=0, atol=CUDA_ATOL)
        assert bool((got[3::7] == -50.0).all())
