"""tpu_se_torch.losses and the GGD kernel's plain version against tpu_se.

``ggd_output_grad_plain`` is held to the TPU kernel
``tpu_se.ops.ggd_output_grad_pallas`` (interpret mode, M <= 128: the
ungridded kernel is meant for small M) and to its XLA twin
``ggd_output_grad_reference`` at rtol 5e-6 (a few float32 ulps: both sum
|e|^beta in float32, in another order; measured <= 6.4e-7).  Entries with
e == 0 and the all-zero column must be exactly 0.  The beta-norm gradient
is held to rtol 1e-6, ``ref_gamma`` and ``ggd_loglik`` to 1e-12 where the
float32 sums are exact.

The CUDA kernel runs only on a card: ``test_ggd_cuda_matches_plain`` is
marked ``cuda`` and skips without one.  On a card (no JAX there) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_ggd.py

which is why this module imports JAX only inside the tests that use it.
"""

import math

import numpy as np
import pytest
import torch

from tpu_se_torch.losses import (
    beta_norm_grad, ggd_loglik, output_grad_and_alpha, ref_gamma,
)
from tpu_se_torch.ops import ggd_kernel

GGD_RTOL = 5e-6
BETAS = [0.5, 0.9, 1.0, 2.0]


def _inputs(m, d, seed=0):
    """Seeded (out, targ): every 5th row and column d // 2 have e == 0."""
    rng = np.random.default_rng(seed)
    out = rng.standard_normal((m, d)).astype(np.float32)
    targ = (out + rng.standard_normal((m, d)) * 0.5).astype(np.float32)
    targ[2::5] = out[2::5]
    targ[:, d // 2] = out[:, d // 2]
    return out, targ


def _plain(out, targ, beta):
    dedx, alpha = ggd_kernel.ggd_output_grad_plain(
        torch.from_numpy(out), torch.from_numpy(targ), beta)
    return dedx.numpy(), alpha.numpy()


def _assert_zeros(dedx, alpha, d):
    np.testing.assert_array_equal(dedx[2::5], 0.0)
    np.testing.assert_array_equal(dedx[:, d // 2], 0.0)
    assert alpha[d // 2] == 0.0


@pytest.mark.parametrize("d", [257, 5])
@pytest.mark.parametrize("m", [7, 128])
@pytest.mark.parametrize("beta", BETAS)
def test_ggd_plain_matches_pallas_interpret(beta, m, d):
    import jax.numpy as jnp

    from tpu_se.ops import ggd_output_grad_pallas

    out, targ = _inputs(m, d, seed=m * d)
    dedx, alpha = _plain(out, targ, beta)
    want_d, want_a = ggd_output_grad_pallas(jnp.asarray(out),
                                            jnp.asarray(targ), beta,
                                            interpret=True)
    np.testing.assert_allclose(dedx, np.asarray(want_d), rtol=GGD_RTOL,
                               atol=0)
    np.testing.assert_allclose(alpha, np.asarray(want_a), rtol=GGD_RTOL,
                               atol=0)
    _assert_zeros(dedx, alpha, d)


@pytest.mark.parametrize("d", [257, 5])
@pytest.mark.parametrize("m", [7, 128, 1000, 4096])
@pytest.mark.parametrize("beta", BETAS)
def test_ggd_plain_matches_reference(beta, m, d):
    import jax.numpy as jnp

    from tpu_se.ops import ggd_output_grad_reference

    out, targ = _inputs(m, d, seed=m + d)
    dedx, alpha = _plain(out, targ, beta)
    want_d, want_a = ggd_output_grad_reference(jnp.asarray(out),
                                               jnp.asarray(targ), beta)
    assert dedx.shape == (m, d) and alpha.shape == (d,)
    np.testing.assert_allclose(dedx, np.asarray(want_d), rtol=GGD_RTOL,
                               atol=0)
    np.testing.assert_allclose(alpha, np.asarray(want_a), rtol=GGD_RTOL,
                               atol=0)
    _assert_zeros(dedx, alpha, d)


@pytest.mark.parametrize("beta", BETAS)
def test_output_grad_ml_on_cpu_is_plain_without_launch(beta):
    out, targ = _inputs(64, 9, seed=3)
    before = ggd_kernel.launches
    dedx, alpha = output_grad_and_alpha(torch.from_numpy(out),
                                        torch.from_numpy(targ), beta, True)
    want_d, want_a = _plain(out, targ, beta)
    np.testing.assert_array_equal(dedx.numpy(), want_d)
    np.testing.assert_array_equal(alpha.numpy(), want_a)
    assert ggd_kernel.launches == before == 0


@pytest.mark.parametrize("beta", BETAS)
def test_beta_norm_grad_matches_reference(beta):
    import jax.numpy as jnp

    from tpu_se.losses import beta_norm_grad as jax_beta_norm_grad
    from tpu_se.losses import output_grad_and_alpha as jax_output_grad

    out, targ = _inputs(50, 257, seed=11)
    got = beta_norm_grad(torch.from_numpy(out), torch.from_numpy(targ), beta)
    want = jax_beta_norm_grad(jnp.asarray(out), jnp.asarray(targ), beta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    dedx, alpha = output_grad_and_alpha(torch.from_numpy(out),
                                        torch.from_numpy(targ), beta, False)
    want_d, want_a = jax_output_grad(jnp.asarray(out), jnp.asarray(targ),
                                     beta, False)
    np.testing.assert_allclose(dedx.numpy(), np.asarray(want_d), rtol=1e-6,
                               atol=0)
    np.testing.assert_array_equal(alpha.numpy(), np.asarray(want_a))
    np.testing.assert_array_equal(dedx.numpy()[2::5], 0.0)


@pytest.mark.parametrize("x", [0.3, 1.0, 1.0 / 0.9, 1.5, 2.0, 2.5, 3.0,
                               4.7, -1.0])
def test_ref_gamma_matches_reference(x):
    from tpu_se.losses import ref_gamma as jax_ref_gamma

    assert ref_gamma(x) == pytest.approx(jax_ref_gamma(x), rel=1e-12,
                                         abs=1e-12)
    if x > 0:     # the reference's polynomial is good to ~1e-5
        assert ref_gamma(x) == pytest.approx(math.gamma(x), rel=2e-5)


@pytest.mark.parametrize("beta", [1.0, 2.0])
@pytest.mark.parametrize("use_ref_gamma", [True, False])
def test_ggd_loglik_matches_reference_exact_sums(beta, use_ref_gamma):
    """Dyadic errors and unit alpha make every float32 term and sum exact,
    so the two packages must agree to 1e-12."""
    from tpu_se.losses import ggd_loglik as jax_ggd_loglik

    rng = np.random.default_rng(5)
    err = (rng.integers(-64, 65, size=(40, 257)) / 16.0).astype(np.float32)
    alpha = np.ones(257, np.float32)
    got = ggd_loglik(err, alpha, beta, use_ref_gamma)
    want = jax_ggd_loglik(err, alpha, beta, use_ref_gamma)
    assert got == pytest.approx(want, rel=1e-12, abs=1e-12)


@pytest.mark.parametrize("beta", [0.5, 0.9])
def test_ggd_loglik_matches_reference_float32(beta):
    """General inputs: float32 sums in another order, rel 1e-6."""
    from tpu_se.losses import ggd_loglik as jax_ggd_loglik

    rng = np.random.default_rng(6)
    err = rng.standard_normal((300, 257)).astype(np.float32)
    alpha = rng.uniform(0.5, 2.0, 257).astype(np.float32)
    got = ggd_loglik(err, alpha, beta)
    assert got == pytest.approx(jax_ggd_loglik(err, alpha, beta), rel=1e-6)


def _args(**change):
    args = {"out": torch.zeros(4, 257), "targ": torch.zeros(4, 257)}
    args.update(change)
    return args["out"], args["targ"]


@pytest.mark.parametrize("out,targ,match", [
    (*_args(out=torch.zeros(4, 257, dtype=torch.float64)), "float32"),
    (*_args(targ=torch.zeros(4, 257, dtype=torch.bfloat16)), "float32"),
    (*_args(out=torch.zeros(2, 4, 257)), "2-D"),
    (*_args(targ=torch.zeros(257, 4).t()), "contiguous"),
    (*_args(targ=torch.zeros(4, 256)), "differ in shape"),
    (*_args(out=torch.zeros(0, 257), targ=torch.zeros(0, 257)), "empty"),
    (*_args(out=torch.zeros(65535 * 128 + 1, 1),
            targ=torch.zeros(65535 * 128 + 1, 1)), "grid"),
    (*_args(), "CUDA tensor"),
], ids=["out-f64", "targ-bf16", "3-D", "non-contiguous", "shape",
        "empty", "too-many-rows", "cpu"])
def test_check_ggd_args_rejects(out, targ, match):
    with pytest.raises(ValueError, match=match):
        ggd_kernel.check_ggd_args(out, targ)


def test_ggd_cuda_raises_on_cpu_without_launch():
    before = ggd_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ggd_kernel.ggd_output_grad_cuda(torch.ones(8, 5), torch.zeros(8, 5),
                                        1.0)
    assert ggd_kernel.launches == before


@pytest.mark.cuda
def test_ggd_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for m in (1, 7, 128, 1000, 4096, 16384):
        for d in (257, 129, 5):
            out_np, targ_np = _inputs(m, d, seed=m * 3 + d)
            out = torch.from_numpy(out_np).cuda()
            targ = torch.from_numpy(targ_np).cuda()
            for beta in BETAS:
                before = ggd_kernel.launches
                dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, beta)
                dedx2, alpha2 = ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                                beta)
                torch.cuda.synchronize()
                assert ggd_kernel.launches == before + 2
                want_d, want_a = ggd_kernel.ggd_output_grad_plain(out, targ,
                                                                  beta)
                torch.testing.assert_close(dedx, want_d, rtol=GGD_RTOL,
                                           atol=0)
                torch.testing.assert_close(alpha, want_a, rtol=GGD_RTOL,
                                           atol=0)
                assert torch.equal(dedx, dedx2) and torch.equal(alpha, alpha2)
                _assert_zeros(dedx.cpu().numpy(), alpha.cpu().numpy(), d)
