"""tpu_se_torch.ops: the LPS kernel's plain version, argument checks, build.

``lps_plain`` is held against the TPU kernel ``tpu_se.ops.lps_pallas``
(interpret mode) and its XLA twin at atol 1e-3 in the log domain (the
port sums in float64, JAX in float32); floor rows must be exactly -50.
The CUDA kernel itself runs only on a card: ``test_lps_cuda_matches_plain``
is marked ``cuda`` and skips without one.  It holds the kernel to
``lps_plain`` at atol 1e-5: both sum in float64, so they agree to a few
float32 ulps of the log power, and a float32 sum would miss by ~1e-3.
``test_kernel_summation_order_keeps_the_tolerance`` makes that argument on
the CPU with the kernel's own blocked order.  On a card (no JAX there) run

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
MMA_DEPTH = 8            # samples per mma.sync.m16n8k8 in csrc/lps_kernel.cu
# Frame counts for the card: the decode's row counts (992 at --batch 4,
# 3968 at 16), ragged ones, and both sides of the tile switch.
CUDA_TS = (1, 37, 255, 256, 992, 3968, 4097, 16384,
           lps_kernel.SMALL_TILE_MAX_T, lps_kernel.SMALL_TILE_MAX_T + 1)


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
    (torch.empty(2**31, 32, device="meta"),
     torch.empty(32, 2, device="meta"), "int32"),
    (torch.empty(2**31 - 1, 32, device="meta"),
     torch.empty(32, 2 * 1009, device="meta"), "grid"),
    (*_args(frames=torch.zeros(4, 100), basis=torch.zeros(100, 514)),
     "multiple of 32"),
    (*_args(frames=torch.zeros(4 * 512 + 1)[1:].view(4, 512)), "aligned"),
    (*_args(), "CUDA tensor"),
], ids=["frames-f64", "basis-f16", "3-D", "non-contiguous", "length",
        "odd-columns", "too-many-frames", "grid",
        "length-not-stage-multiple", "misaligned", "cpu"])
def test_check_lps_args_rejects(frames, basis, match):
    with pytest.raises(ValueError, match=match):
        lps_kernel.check_lps_args(frames, basis)


def test_check_lps_args_accepts_at_the_grid_limit():
    # 2**31 - 1 frames need 2**25 frame tiles; 1008 bins are 63 bin tiles
    # of 16, 2**31 - 2**25 blocks, inside the limit (1009 bins, 64 tiles,
    # are one tile row over it: the "grid" case above).  Meta tensors pass
    # every check but the device.
    frames = torch.empty(2**31 - 1, 32, device="meta")
    basis = torch.empty(32, 2 * 1008, device="meta")
    assert lps_kernel.grid_blocks(2**31 - 1, 1008) == 2**31 - 2**25
    with pytest.raises(ValueError, match="CUDA tensor"):
        lps_kernel.check_lps_args(frames, basis)


@pytest.mark.parametrize("t,n_bins,blocks", [
    (1, 257, 33), (248, 257, 4 * 33), (992, 257, 16 * 33),
    (2560, 257, 40 * 33), (2561, 257, 41 * 17), (3968, 257, 62 * 17),
    (4097, 129, 65 * 9), (992, 129, 16 * 17),
])
def test_grid_blocks_tile_rule(t, n_bins, blocks):
    # 64 frames per block; 8 bins per block up to SMALL_TILE_MAX_T frames
    # (so the decode's 992 rows fill 132 SMs), 16 above it.
    assert lps_kernel.SMALL_TILE_MAX_T == 2560
    assert lps_kernel.grid_blocks(t, n_bins) == blocks
    assert lps_kernel.grid_blocks(992, 257) >= 132


def _lps_blocked(frames, basis, dtype):
    """The kernel's summation order on the CPU: each block of MMA_DEPTH
    samples summed (one mma), then added to a per-(frame, column)
    accumulator, blocks in ascending sample order; all in ``dtype``."""
    x = torch.from_numpy(frames).to(dtype)
    b = basis.to(dtype)
    acc = torch.zeros(x.shape[0], b.shape[1], dtype=dtype)
    for k0 in range(0, x.shape[1], MMA_DEPTH):
        acc += x[:, k0:k0 + MMA_DEPTH] @ b[k0:k0 + MMA_DEPTH]
    spec = acc.float()
    n_bins = b.shape[1] // 2
    re, im = spec[:, :n_bins], spec[:, n_bins:]
    return lps_kernel.floored_log(re * re + im * im)


@pytest.mark.parametrize("length", [512, 256])
def test_kernel_summation_order_keeps_the_tolerance(length):
    # The design's precision argument: in float64 the kernel's blocked
    # order stays within CUDA_ATOL of lps_plain on the adversarial x1000
    # frames; the same order in float32 (what TF32 tensor cores would at
    # best give) misses by more than 1e-4.
    frames = _frames(4097, length, seed=4097)
    basis = dft_basis(length, "cpu")
    want = lps_kernel.lps_plain(torch.from_numpy(frames), basis)
    err64 = (_lps_blocked(frames, basis, torch.float64) - want).abs().max()
    err32 = (_lps_blocked(frames, basis, torch.float32) - want).abs().max()
    assert err64.item() <= CUDA_ATOL
    assert err32.item() > 1e-4


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


def test_count_sass_opcode_per_function():
    sass = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_110lps_kernelINS_7LpsTileE
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0b20*/                   DMMA.16x8x8 R24, R40, R52, R24 ;
        /*0b30*/              @P0 DMMA.16x8x8 R28, R40, R56, R28 ;
        /*0b40*/                   DMUL R2, R4, R6 ;
\t\tFunction : _ZN12_GLOBAL__N_110ggd_kernelILi32ELi256ELb1ELb1EEEvPKfS2_PfS3_iiifff
        /*0000*/                   FADD R1, R2, R3 ;
"""
    counts = _build.count_sass_opcode(sass, "DMMA")
    assert counts == {"_ZN12_GLOBAL__N_110lps_kernelINS_7LpsTileE": 2,
                      "_ZN12_GLOBAL__N_110ggd_kernelILi32ELi256ELb1ELb1EEEvPKfS2_PfS3_iiifff": 0}
    assert _build.count_sass_opcode(sass, "DMUL")[
        "_ZN12_GLOBAL__N_110lps_kernelINS_7LpsTileE"] == 1


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
    for t in CUDA_TS:
        x = torch.from_numpy(_frames(t, length, seed=t)).cuda()
        before = lps_kernel.launches
        got = lps_kernel.lps_cuda(x, basis)
        again = lps_kernel.lps_cuda(x, basis)
        torch.cuda.synchronize()
        assert lps_kernel.launches == before + 2
        want = lps_kernel.lps_plain(x, basis)
        torch.testing.assert_close(got, want, rtol=0, atol=CUDA_ATOL)
        assert torch.equal(got, again), f"rerun differs at T={t}"
        assert bool((got[3::7] == -50.0).all())
        assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
def test_lps_grid_rule_matches_the_library():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the library is built there)")
    lib, _ = _build.load_library()
    for t in (1, 63, 64, 65, 248, 992, 2560, 2561, 16384, 2**31 - 1):
        for n_bins in (1, 8, 9, 129, 257, 1009):
            assert (lib.lps_grid_blocks(t, n_bins)
                    == lps_kernel.grid_blocks(t, n_bins)), (t, n_bins)
