"""tpu_se_torch.losses and the GGD kernel's plain version against tpu_se.

``ggd_output_grad_plain`` is held to the TPU kernel
``tpu_se.ops.ggd_output_grad_pallas`` (interpret mode, M <= 128: the
ungridded kernel is meant for small M) and to its XLA twin
``ggd_output_grad_reference`` at rtol 5e-6 (a few float32 ulps: both sum
|e|^beta in float32, in another order; measured <= 6.4e-7).  Entries with
e == 0 and the all-zero column must be exactly 0.  The beta-norm gradient
is held to rtol 1e-6, ``ref_gamma`` and ``ggd_loglik`` to 1e-12 where the
float32 sums are exact.

The split form for data-parallel training (``ggd_colsum`` +
``ggd_grad_from_sums``): the plain pair at one rank is the fused plain
result bit for bit, and over P in {2, 4, 8} row shards within rtol 5e-6 of
it and of ``ggd_output_grad_reference`` on the whole bunch.

The CUDA kernel runs only on a card: ``test_ggd_cuda_matches_plain``,
``test_ggd_plan_matches_the_library`` and the two ``test_ggd_split_cuda_*``
are marked ``cuda`` and skip without one.  What the CPU can hold of the kernel is held here: ``_kernel_model``
repeats its float32 summation order in numpy (each thread's rows in order,
the block's tree over its row threads, the cluster's ranks in order) from
the launcher's plan (``_colsum_model`` and ``_from_sums_model`` are its two
halves, the split entry points), ``plan`` mirrors the launcher's rule, and
the beta == 1 shortcut is compared with the general formula bit for bit.  On a
card (no JAX there) run

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


def _f32_pow(x, exponent):
    return np.power(x, np.float32(exponent), dtype=np.float32)


def _colsum_model(out, targ, beta, shortcut=True):
    """``ggd_colsum`` of csrc/ggd_kernel.cu in numpy float32, sum order and
    all (the fused kernel's first three steps): thread (ty, column) adds
    its rows ty, ty + row_threads, ... of the block in order; the block
    adds its row threads in a halving tree; the ranks are added in order.
    ``shortcut`` takes the beta == 1 path where it applies."""
    m, d = out.shape
    plan = ggd_kernel.plan(m, d)
    row_threads = plan.threads // plan.cols
    one = shortcut and np.float32(beta) == np.float32(1.0)
    e = out - targ
    abs_e = np.abs(e)
    if one:
        term = abs_e
    else:
        term = np.where(e == 0, np.float32(0),
                        _f32_pow(np.where(e == 0, np.float32(1), abs_e), beta))
    total = np.zeros(d, np.float32)
    for rank in range(plan.cluster):
        rows = term[rank * plan.rows_per_block:
                    (rank + 1) * plan.rows_per_block]
        sums = np.zeros((row_threads, d), np.float32)
        for ty in range(row_threads):
            mine = rows[ty::row_threads]
            if len(mine):
                sums[ty] = np.add.accumulate(mine, axis=0,
                                             dtype=np.float32)[-1]
        half = row_threads // 2
        while half:
            sums[:half] = sums[:half] + sums[half:2 * half]
            half //= 2
        total = total + sums[0]
    return total


def _from_sums_model(out, targ, total, m_global, beta, shortcut=True):
    """``ggd_grad_from_sums`` in numpy float32 (the fused kernel's alpha
    arithmetic and its fourth step): alpha and the scale from the column
    sums over ``m_global`` rows, then the gradient of these rows."""
    one = shortcut and np.float32(beta) == np.float32(1.0)
    e = out - targ
    abs_e = np.abs(e)
    m32 = np.float32(m_global)
    mean_term = np.float32(beta) * (total / m32)
    alpha = mean_term if one else _f32_pow(mean_term, 1.0 / beta)
    safe = np.where(alpha == 0, np.float32(1), alpha)
    scale = np.where(alpha == 0, np.float32(0),
                     np.float32(beta) / (safe if one
                                         else _f32_pow(safe, beta)))
    if one:
        grad = np.copysign(scale / m32, e)
    else:
        safe_e = np.where(e == 0, np.float32(1), abs_e)
        grad = np.copysign(_f32_pow(safe_e, beta - 1.0), e) * scale / m32
    dedx = np.where(e == 0, np.float32(0), grad)
    assert dedx.dtype == alpha.dtype == np.float32
    return dedx, alpha


def _kernel_model(out, targ, beta, shortcut=True):
    """The fused kernel in numpy float32: its column sums, then alpha and
    the gradient from them over its own M rows.  The split entry points
    are these two halves, so at one rank they give the fused bits."""
    total = _colsum_model(out, targ, beta, shortcut)
    return _from_sums_model(out, targ, total, out.shape[0], beta, shortcut)


# One M on either side of each plan switch, and the sizes in use.
MODEL_MS = [1, 7, 128, 1000, 4096,
            ggd_kernel.PLAN_SWITCH_ROWS[-1] + 1]


@pytest.mark.parametrize("d", [257, 5])
@pytest.mark.parametrize("m", MODEL_MS)
@pytest.mark.parametrize("beta", BETAS)
def test_kernel_summation_order_matches_plain_and_reference(beta, m, d):
    import jax.numpy as jnp

    from tpu_se.ops import ggd_output_grad_reference

    out, targ = _inputs(m, d, seed=m + 7 * d)
    dedx, alpha = _kernel_model(out, targ, beta)
    plain_d, plain_a = _plain(out, targ, beta)
    ref_d, ref_a = ggd_output_grad_reference(jnp.asarray(out),
                                             jnp.asarray(targ), beta)
    for want_d, want_a in ((plain_d, plain_a),
                           (np.asarray(ref_d), np.asarray(ref_a))):
        np.testing.assert_allclose(dedx, want_d, rtol=GGD_RTOL, atol=0)
        np.testing.assert_allclose(alpha, want_a, rtol=GGD_RTOL, atol=0)
    _assert_zeros(dedx, alpha, d)
    assert np.isfinite(dedx).all() and np.isfinite(alpha).all()


@pytest.mark.parametrize("d", [257, 5])
@pytest.mark.parametrize("m", [7, 128, 1000, 1025])
def test_beta_one_shortcut_is_bitwise_the_general_formula(m, d):
    # |e| for |e|^1, +-1 for |e|^0 and (+-1 * scale) / M = +-(scale / M):
    # exact identities in IEEE float32, so the bits must agree.
    out, targ = _inputs(m, d, seed=3 * m + d)
    short_d, short_a = _kernel_model(out, targ, 1.0, shortcut=True)
    gen_d, gen_a = _kernel_model(out, targ, 1.0, shortcut=False)
    np.testing.assert_array_equal(short_d.view(np.uint32),
                                  gen_d.view(np.uint32))
    np.testing.assert_array_equal(short_a.view(np.uint32),
                                  gen_a.view(np.uint32))


@pytest.mark.parametrize("m,cols,rows,keep", [
    (1, 32, 1, 1), (7, 32, 1, 1), (128, 32, 16, 1), (1024, 32, 128, 1),
    (1025, 16, 129, 1), (4096, 16, 512, 1), (12288, 16, 1536, 1),
    (12289, 16, 1537, 0), (16384, 16, 2048, 0),
    (2**31 - 1, 16, 2**28, 0),
])
def test_plan_rule_at_the_edges(m, cols, rows, keep):
    # 256 threads and clusters of 8 throughout; strips of 32 columns up to
    # M = 1024 and of 16 above; the error stays in shared memory while a
    # block's rows x columns x 4 bytes fit 96 KB.
    assert ggd_kernel.PLAN_SWITCH_ROWS == (1024, 12288)
    assert ggd_kernel.plan(m, 257) == ggd_kernel.GgdPlan(cols, 256, 8, rows,
                                                        keep)
    assert ggd_kernel.plan(m, 5) == ggd_kernel.plan(m, 257)
    p = ggd_kernel.plan(m, 257)
    assert p.rows_per_block * p.cluster >= m > (p.rows_per_block - 1) * 8
    assert p.keep == (p.rows_per_block * p.cols * 4 <= 96 * 1024)


def test_check_ggd_args_accepts_at_the_int32_limit():
    # Meta tensors pass every check but the device.
    for shape in ((2**31 - 1, 1), (1, 2**31 - 1)):
        x = torch.empty(shape, device="meta")
        with pytest.raises(ValueError, match="CUDA tensor"):
            ggd_kernel.check_ggd_args(x, x)


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
    (torch.empty(2**31, 1, device="meta"),
     torch.empty(2**31, 1, device="meta"), "int32"),
    (torch.empty(1, 2**31, device="meta"),
     torch.empty(1, 2**31, device="meta"), "int32"),
    (*_args(), "CUDA tensor"),
], ids=["out-f64", "targ-bf16", "3-D", "non-contiguous", "shape",
        "empty", "too-many-rows", "too-many-columns", "cpu"])
def test_check_ggd_args_rejects(out, targ, match):
    with pytest.raises(ValueError, match=match):
        ggd_kernel.check_ggd_args(out, targ)


def test_ggd_cuda_raises_on_cpu_without_launch():
    before = ggd_kernel.launches
    with pytest.raises(ValueError, match="CUDA tensor"):
        ggd_kernel.ggd_output_grad_cuda(torch.ones(8, 5), torch.zeros(8, 5),
                                        1.0)
    assert ggd_kernel.launches == before


SPLIT_BETAS = [1.0, 0.9, 2.0]


def _split_plain(out, targ, beta, n_shards):
    """The split plain functions over ``n_shards`` contiguous row shards,
    the shards' sums added in rank order: what P ranks compute."""
    o, t = torch.from_numpy(out), torch.from_numpy(targ)
    m = out.shape[0]
    per = m // n_shards
    sums = None
    for k in range(n_shards):
        part = ggd_kernel.ggd_colsum_plain(o[k * per:(k + 1) * per],
                                           t[k * per:(k + 1) * per], beta)
        sums = part if sums is None else sums + part
    pieces = [ggd_kernel.ggd_grad_from_sums_plain(
        o[k * per:(k + 1) * per], t[k * per:(k + 1) * per], sums, m, beta)
        for k in range(n_shards)]
    for _, alpha in pieces[1:]:
        assert torch.equal(alpha, pieces[0][1])     # every rank's alpha
    return (torch.cat([d for d, _ in pieces]).numpy(),
            pieces[0][1].numpy())


@pytest.mark.parametrize("d", [257, 5])
@pytest.mark.parametrize("m", [7, 128, 1000])
@pytest.mark.parametrize("beta", SPLIT_BETAS)
def test_split_plain_at_one_rank_is_bitwise_the_fused_plain(beta, m, d):
    out, targ = _inputs(m, d, seed=5 * m + d)
    dedx, alpha = _split_plain(out, targ, beta, 1)
    want_d, want_a = _plain(out, targ, beta)
    np.testing.assert_array_equal(dedx.view(np.uint32),
                                  want_d.view(np.uint32))
    np.testing.assert_array_equal(alpha.view(np.uint32),
                                  want_a.view(np.uint32))


@pytest.mark.parametrize("n_shards", [2, 4, 8])
@pytest.mark.parametrize("m", [128, 1024])
@pytest.mark.parametrize("beta", SPLIT_BETAS)
def test_split_plain_over_shards_matches_plain_and_reference(beta, m,
                                                             n_shards):
    # The shards' partial sums are added in another order than one sum over
    # M rows: a few float32 ulps, the kernel's own bar (rtol 5e-6).
    import jax.numpy as jnp

    from tpu_se.ops import ggd_output_grad_reference

    out, targ = _inputs(m, 257, seed=m + n_shards)
    dedx, alpha = _split_plain(out, targ, beta, n_shards)
    plain_d, plain_a = _plain(out, targ, beta)
    ref_d, ref_a = ggd_output_grad_reference(jnp.asarray(out),
                                             jnp.asarray(targ), beta)
    for want_d, want_a in ((plain_d, plain_a),
                           (np.asarray(ref_d), np.asarray(ref_a))):
        np.testing.assert_allclose(dedx, want_d, rtol=GGD_RTOL, atol=0)
        np.testing.assert_allclose(alpha, want_a, rtol=GGD_RTOL, atol=0)
    _assert_zeros(dedx, alpha, 257)


@pytest.mark.parametrize("n_shards", [1, 2, 4, 8])
@pytest.mark.parametrize("beta", SPLIT_BETAS)
def test_split_kernel_summation_order_matches_plain(beta, n_shards):
    """The numpy model of ``ggd_colsum`` on each rank's rows (its plan is
    that of M / P rows), the ranks' sums added in rank order as the
    all-reduce of two ranks adds them, then ``ggd_grad_from_sums``: within
    rtol 5e-6 of the plain whole-bunch result, and at one rank the fused
    model's bits."""
    m, d = 128, 257
    out, targ = _inputs(m, d, seed=17 + n_shards)
    per = m // n_shards
    total = np.zeros(d, np.float32)
    for k in range(n_shards):
        total = total + _colsum_model(out[k * per:(k + 1) * per],
                                      targ[k * per:(k + 1) * per], beta)
    pieces = [_from_sums_model(out[k * per:(k + 1) * per],
                               targ[k * per:(k + 1) * per], total, m, beta)
              for k in range(n_shards)]
    dedx = np.concatenate([p[0] for p in pieces])
    alpha = pieces[0][1]
    plain_d, plain_a = _plain(out, targ, beta)
    np.testing.assert_allclose(dedx, plain_d, rtol=GGD_RTOL, atol=0)
    np.testing.assert_allclose(alpha, plain_a, rtol=GGD_RTOL, atol=0)
    _assert_zeros(dedx, alpha, d)
    if n_shards == 1:
        fused_d, fused_a = _kernel_model(out, targ, beta)
        np.testing.assert_array_equal(dedx.view(np.uint32),
                                      fused_d.view(np.uint32))
        np.testing.assert_array_equal(alpha.view(np.uint32),
                                      fused_a.view(np.uint32))


def test_split_wrappers_raise_on_cpu_without_launch():
    out, targ = torch.ones(8, 5), torch.zeros(8, 5)
    with pytest.raises(ValueError, match="ggd_colsum_cuda.*CUDA tensor"):
        ggd_kernel.ggd_colsum_cuda(out, targ, 1.0)
    with pytest.raises(ValueError,
                       match="ggd_grad_from_sums_cuda.*CUDA tensor"):
        ggd_kernel.ggd_grad_from_sums_cuda(out, targ, torch.ones(5), 8, 1.0)
    assert ggd_kernel.colsum_launches == 0
    assert ggd_kernel.grad_from_sums_launches == 0


@pytest.mark.parametrize("sums,m_global,match", [
    (torch.ones(5, dtype=torch.float64), 8, "sums must be float32"),
    (torch.ones(4), 8, "contiguous \\[5\\] vector"),
    (torch.ones(5, 2)[:, 0], 8, "contiguous \\[5\\] vector"),
    (torch.ones(5), 7, "m_global 7 is not between"),
    (torch.ones(5), 2**31, "m_global"),
], ids=["f64", "short", "strided", "fewer-rows-than-mine", "past-int32"])
def test_check_sums_arg_rejects(sums, m_global, match):
    with pytest.raises(ValueError, match=match):
        ggd_kernel.check_sums_arg(sums, torch.zeros(8, 5), m_global)


# Sizes for the card: those in use and both sides of each plan switch.
CUDA_MS = sorted({1, 7, 128, 1000, 4096, 16384,
                  *(m for last in ggd_kernel.PLAN_SWITCH_ROWS
                    for m in (last, last + 1))})


@pytest.mark.cuda
def test_ggd_cuda_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for m in CUDA_MS:
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
                assert bool(torch.isfinite(dedx).all())
                _assert_zeros(dedx.cpu().numpy(), alpha.cpu().numpy(), d)
            # beta = 1 skips powf; the general path takes it: same bits.
            dedx, alpha = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0)
            gen_d, gen_a = ggd_kernel.ggd_output_grad_cuda(out, targ, 1.0,
                                                           general=True)
            assert torch.equal(dedx, gen_d) and torch.equal(alpha, gen_a)
            # The numpy model has the kernel's sum order: alpha to the bit.
            _, model_a = _kernel_model(out_np, targ_np, 1.0)
            np.testing.assert_array_equal(alpha.cpu().numpy(), model_a)


@pytest.mark.cuda
def test_ggd_plan_matches_the_library():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the library is built there)")
    import ctypes

    from tpu_se_torch.ops._build import load_library

    lib, _ = load_library()
    got = (ctypes.c_int * 5)()
    for m in (1, 7, 8, 9, 128, 1000, 1024, 1025, 4096, 12288, 12289, 16384,
              2**31 - 1):
        for d in (1, 5, 16, 17, 129, 257, 1000):
            lib.ggd_plan(m, d, got)
            assert tuple(got) == tuple(ggd_kernel.plan(m, d)), (m, d)


@pytest.mark.cuda
def test_ggd_split_cuda_matches_plain_and_the_fused_kernel():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    for m in (64, 128, 1024, 4096):
        out_np, targ_np = _inputs(m, 257, seed=m * 7)
        out = torch.from_numpy(out_np).cuda()
        targ = torch.from_numpy(targ_np).cuda()
        for beta in SPLIT_BETAS:
            before = (ggd_kernel.colsum_launches,
                      ggd_kernel.grad_from_sums_launches)
            sums = ggd_kernel.ggd_colsum_cuda(out, targ, beta)
            dedx, alpha = ggd_kernel.ggd_grad_from_sums_cuda(out, targ, sums,
                                                             m, beta)
            torch.cuda.synchronize()
            assert (ggd_kernel.colsum_launches,
                    ggd_kernel.grad_from_sums_launches) == (before[0] + 1,
                                                            before[1] + 1)
            want_s = ggd_kernel.ggd_colsum_plain(out, targ, beta)
            want_d, want_a = ggd_kernel.ggd_grad_from_sums_plain(
                out, targ, want_s, m, beta)
            torch.testing.assert_close(sums, want_s, rtol=GGD_RTOL, atol=0)
            torch.testing.assert_close(dedx, want_d, rtol=GGD_RTOL, atol=0)
            torch.testing.assert_close(alpha, want_a, rtol=GGD_RTOL, atol=0)
            _assert_zeros(dedx.cpu().numpy(), alpha.cpu().numpy(), 257)
            # Fed its own sums, the pair is the fused kernel bit for bit.
            fused_d, fused_a = ggd_kernel.ggd_output_grad_cuda(out, targ,
                                                               beta)
            assert torch.equal(dedx, fused_d) and torch.equal(alpha, fused_a)
        # The numpy model has the kernel's sum order: the sums to the bit.
        sums = ggd_kernel.ggd_colsum_cuda(out, targ, 1.0)
        np.testing.assert_array_equal(sums.cpu().numpy(),
                                      _colsum_model(out_np, targ_np, 1.0))


@pytest.mark.cuda
def test_ggd_split_cuda_two_half_bunches_give_the_bunch_alpha():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    out_np, targ_np = _inputs(128, 257, seed=99)
    out = torch.from_numpy(out_np).cuda()
    targ = torch.from_numpy(targ_np).cuda()
    for beta in SPLIT_BETAS:
        sums = (ggd_kernel.ggd_colsum_cuda(out[:64], targ[:64], beta)
                + ggd_kernel.ggd_colsum_cuda(out[64:], targ[64:], beta))
        halves = [ggd_kernel.ggd_grad_from_sums_cuda(
            out[lo:lo + 64], targ[lo:lo + 64], sums, 128, beta)
            for lo in (0, 64)]
        want_d, want_a = ggd_kernel.ggd_output_grad_cuda(out, targ, beta)
        assert torch.equal(halves[0][1], halves[1][1])
        torch.testing.assert_close(halves[0][1], want_a, rtol=GGD_RTOL,
                                   atol=0)
        torch.testing.assert_close(torch.cat([h[0] for h in halves]), want_d,
                                   rtol=GGD_RTOL, atol=0)
