"""tpu_se_torch.models against tpu_se.models on the CPU.

``init_params`` must be bit-identical (same numpy RNG); the forward pass
is held to rtol 1e-5 / atol 1e-5 (float32 GEMMs summed in another order).

The reduced-precision path (``compute_dtype=bfloat16``, ``act_dtype``):

- one layer against JAX: bfloat16 x bfloat16 products are exact in
  float32, so only the order of the float32 sums differs: 1e-5 of the
  output's scale;
- a whole network against JAX: two sum orders that differ by one float32
  ulp in ``z`` can round a hidden activation h to the neighbouring
  bfloat16 value, which moves an output by at most |w| * 2^-8 * |h|
  (``_flip``); four such flips are allowed (measured: none, 5e-7, where
  the float32 network is 1e-3 to 1e-2 away);
- the layer's backward pass against ``jax.vjp``: the port rounds the
  cotangent ``g`` to bfloat16 where JAX multiplies it unrounded, so
  |dW - dW_jax| <= 2^-9 * |h|^T |g| (the rounding of g, worst case) +
  2^-7 * |dW_jax| (both results are rounded to bfloat16: half an ulp
  each), and the same for dh; the bias gradient is the float32 column sum
  of the unrounded g on both sides (rtol 1e-5);
- the layer against a numpy model of its own roundings, on integer-valued
  inputs whose sums are exact in float32 whatever their order: exact.

With the default arguments the float32 path is bit for bit what it was.
The tests that need a card are marked ``cuda`` and skip without one; on a
card (no JAX there) run

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_model.py

which is why this module imports JAX only inside the tests that use it.
"""

import numpy as np
import pytest
import torch

from tpu_se_torch.models import (
    DEFAULT_LAYERSIZES, FFN, init_params, params_from_numpy, params_to_numpy,
)
from tpu_se_torch.models.ffn import reduced_linear, reduced_product

NARROW = (1799, 64, 64, 257)
BF16 = torch.bfloat16
# (compute_dtype, act_dtype) of the reduced-precision modes.
MODES = [(BF16, None), (BF16, BF16), (torch.float32, BF16)]
MODE_IDS = ["bf16", "bf16+act", "f32+act"]


def _jax():
    """The JAX side, imported where it is used (the card has no JAX)."""
    import types

    import jax
    import jax.numpy as jnp

    from tpu_se.io import read_wts, write_wts
    from tpu_se.models import (
        forward, init_params, params_from_wts, params_to_wts,
    )
    return types.SimpleNamespace(
        jax=jax, jnp=jnp, read_wts=read_wts, write_wts=write_wts,
        forward=forward, init_params=init_params,
        params_from_wts=params_from_wts, params_to_wts=params_to_wts,
        dtype={BF16: jnp.bfloat16, torch.float32: jnp.float32, None: None})


def bf16_round(x: np.ndarray) -> np.ndarray:
    """float32 -> the nearest bfloat16 (ties to even), as float32."""
    u = np.asarray(x, np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32)


def _flip(layers, x, activation):
    """The most one flipped bfloat16 rounding of a hidden activation moves
    an output: max over the layers l >= 1 of max|w_l| * 2^-8 * max|h_l-1|,
    from a float64 forward pass."""
    h = x.astype(np.float64)
    worst = 0.0
    for i, layer in enumerate(layers):
        if i:
            worst = max(worst, np.abs(layer["w"]).max() * np.abs(h).max())
        z = h @ layer["w"] + layer["b"]
        h = 1 / (1 + np.exp(-z)) if activation == "sigmoid" else np.maximum(
            z, 0)
    return 2.0 ** -8 * worst


def _biased_layers(layersizes, seed):
    layers = init_params(11, layersizes)
    rng = np.random.default_rng(seed)
    for layer in layers:                       # non-zero biases
        layer["b"] = rng.uniform(-0.1, 0.1, layer["b"].shape).astype(
            np.float32)
    return layers, rng


@pytest.mark.parametrize("seed,flag,beta", [(7, 1, 2.0), (3, 0, 1.0)])
def test_init_params_bit_identical(seed, flag, beta):
    j = _jax()
    ours = init_params(seed, NARROW, flag=flag, beta=beta)
    theirs = j.params_to_wts(j.init_params(seed, NARROW, flag=flag,
                                           beta=beta))
    assert len(ours) == len(theirs) == 3
    for a, b in zip(ours, theirs):
        assert a["w"].dtype == np.float32
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


@pytest.mark.parametrize("activation,m,layersizes", [
    ("sigmoid", 16, NARROW), ("sigmoid", 128, NARROW),
    ("relu", 16, NARROW), ("sigmoid", 16, DEFAULT_LAYERSIZES),
], ids=["sigmoid-16", "sigmoid-128", "relu-16", "full-width-16"])
def test_ffn_matches_jax_forward(activation, m, layersizes):
    j = _jax()
    layers, rng = _biased_layers(layersizes, m)
    x = rng.standard_normal((m, layersizes[0])).astype(np.float32)
    model = params_from_numpy(layers, "cpu", activation=activation)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(j.forward(j.params_from_wts(layers), j.jnp.asarray(x),
                                activation=activation))
    assert got.shape == (m, layersizes[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("compute_dtype,act_dtype", MODES, ids=MODE_IDS)
@pytest.mark.parametrize("activation", ["sigmoid", "relu"])
@pytest.mark.parametrize("layersizes", [(24, 8), (24, 16, 16, 8),
                                        (1799, 64, 257)], ids=str)
def test_ffn_reduced_precision_matches_jax_forward(layersizes, activation,
                                                   compute_dtype, act_dtype):
    j = _jax()
    layers, rng = _biased_layers(layersizes, len(layersizes))
    x = rng.standard_normal((16, layersizes[0])).astype(np.float32)
    model = params_from_numpy(layers, "cpu", activation=activation)
    with torch.no_grad():
        got = model(torch.from_numpy(x), compute_dtype=compute_dtype,
                    act_dtype=act_dtype)
    assert got.dtype == torch.float32
    want = np.asarray(j.forward(
        j.params_from_wts(layers), j.jnp.asarray(x), activation=activation,
        compute_dtype=j.dtype[compute_dtype], act_dtype=j.dtype[act_dtype]))
    assert want.dtype == np.float32
    atol = (1e-5 * max(1.0, np.abs(want).max()) if len(layers) == 1
            else 4 * _flip(layers, x, activation))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)
    # The knob does something (one layer has no activation to narrow): the
    # float32 network is far further away than the two reduced ones are
    # from each other.
    if compute_dtype == BF16 or len(layers) > 1:
        with torch.no_grad():
            plain = model(torch.from_numpy(x)).numpy()
        assert (np.abs(plain - want).max()
                > 10 * np.abs(got.numpy() - want).max())


def test_ffn_cast_weights_give_the_same_bits():
    """Weights cast beforehand (a decoder's) against the cast per call."""
    layers, rng = _biased_layers((24, 16, 16, 8), 0)
    x = torch.from_numpy(rng.standard_normal((5, 24)).astype(np.float32))
    model = params_from_numpy(layers, "cpu")
    cast = model.cast_weights(BF16)
    assert [w.dtype for w in cast] == [BF16] * 3
    assert not any(w.requires_grad for w in cast)
    with torch.no_grad():
        assert torch.equal(model(x, compute_dtype=BF16, cast_weights=cast),
                           model(x, compute_dtype=BF16))


def test_ffn_default_arguments_keep_the_float32_bits():
    layers, rng = _biased_layers((24, 16, 16, 8), 1)
    x = torch.from_numpy(rng.standard_normal((9, 24)).astype(np.float32))
    model = params_from_numpy(layers, "cpu")
    h = x
    for i, layer in enumerate(layers):
        z = torch.addmm(torch.from_numpy(layer["b"]), h,
                        torch.from_numpy(layer["w"]))
        h = torch.sigmoid(z) if i < 2 else z
    with torch.no_grad():
        assert torch.equal(model(x), h)
        assert torch.equal(model(x, compute_dtype=torch.float32,
                                 act_dtype=None), h)
    # float32 autograd, as before: the gradient of the plain addmm chain.
    out = model(x)
    grads = torch.autograd.grad(out, list(model.weights), torch.ones_like(out))
    ref_w = [torch.from_numpy(layer["w"]).requires_grad_() for layer in layers]
    h = x
    for i, (w, layer) in enumerate(zip(ref_w, layers)):
        z = torch.addmm(torch.from_numpy(layer["b"]), h, w)
        h = torch.sigmoid(z) if i < 2 else z
    for g, r in zip(grads, torch.autograd.grad(h, ref_w, torch.ones_like(h))):
        assert torch.equal(g, r)


def _layer_problem(rng, m=32, k=40, n=24):
    return ((rng.standard_normal((m, k))).astype(np.float32),
            (rng.standard_normal((k, n)) * 0.2).astype(np.float32),
            rng.standard_normal(n).astype(np.float32),
            rng.standard_normal((m, n)).astype(np.float32))


def _layer_grads(h, w, b, g, device="cpu"):
    ht, wt, bt = (torch.from_numpy(a).to(device).requires_grad_()
                  for a in (h, w, b))
    z = reduced_linear(ht, wt, bt, BF16)
    assert z.dtype == torch.float32
    grads = torch.autograd.grad(z, (ht, wt, bt),
                                torch.from_numpy(g).to(device))
    assert all(x.dtype == torch.float32 for x in grads)
    return [x.detach().cpu().numpy() for x in (z, *grads)]


def test_reduced_linear_backward_matches_jax_vjp():
    j = _jax()
    jnp = j.jnp
    h, w, b, g = _layer_problem(np.random.default_rng(0))

    def layer(h, w, b):
        return jnp.dot(h.astype(jnp.bfloat16), w.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32) + b

    z_j, vjp = j.jax.vjp(layer, jnp.asarray(h), jnp.asarray(w),
                         jnp.asarray(b))
    dh_j, dw_j, db_j = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    z, dh, dw, db = _layer_grads(h, w, b, g)
    np.testing.assert_allclose(z, np.asarray(z_j), rtol=0, atol=1e-5)
    abs_h = np.abs(bf16_round(h)).astype(np.float64)
    abs_w = np.abs(bf16_round(w)).astype(np.float64)
    abs_g = np.abs(g).astype(np.float64)
    bound_w = 2.0 ** -9 * (abs_h.T @ abs_g) + 2.0 ** -7 * np.abs(dw_j)
    bound_h = 2.0 ** -9 * (abs_g @ abs_w.T) + 2.0 ** -7 * np.abs(dh_j)
    assert (np.abs(dw - dw_j) <= bound_w).all()
    assert (np.abs(dh - dh_j) <= bound_h).all()
    # Not vacuous: the bounds are a small part of the gradients' scale.
    assert bound_w.max() < 0.05 * np.abs(dw_j).max()
    assert bound_h.max() < 0.05 * np.abs(dh_j).max()
    np.testing.assert_allclose(db, db_j, rtol=1e-5, atol=1e-6)
    # Both round dW and dh to bfloat16 before they go on as float32.
    for x in (dw, dh, dw_j, dh_j):
        np.testing.assert_array_equal(x, bf16_round(x))


def test_reduced_linear_equals_a_numpy_model_of_its_roundings():
    """Integer-valued inputs: every product and sum is an integer below
    2^24, exact in float32 in any order, so the model must match exactly."""
    rng = np.random.default_rng(1)
    h = rng.integers(-300, 301, (16, 12)).astype(np.float32)
    w = rng.integers(-300, 301, (12, 10)).astype(np.float32)
    b = rng.integers(-5, 6, 10).astype(np.float32)
    g = rng.integers(-1000, 1001, (16, 10)).astype(np.float32)
    z, dh, dw, db = _layer_grads(h, w, b, g)
    h_c, w_c, g_c = bf16_round(h), bf16_round(w), bf16_round(g)
    np.testing.assert_array_equal(z, h_c @ w_c + b)
    np.testing.assert_array_equal(dh, bf16_round(g_c @ w_c.T))
    np.testing.assert_array_equal(dw, bf16_round(h_c.T @ g_c))
    np.testing.assert_array_equal(db, g.sum(axis=0))
    # Each rounding of the model changes something on these inputs.
    assert not np.array_equal(h_c, h) and not np.array_equal(g_c, g)
    assert not np.array_equal(h_c.T @ g_c, h_c.T @ g)
    assert not np.array_equal(bf16_round(h_c.T @ g_c), h_c.T @ g_c)


def test_reduced_linear_skips_the_input_gradient_it_does_not_need():
    h, w, b, g = _layer_problem(np.random.default_rng(2))
    wt = torch.from_numpy(w).requires_grad_()
    z = reduced_linear(torch.from_numpy(h), wt, torch.from_numpy(b), BF16)
    (dw,) = torch.autograd.grad(z, (wt,), torch.from_numpy(g))
    np.testing.assert_array_equal(dw.numpy(), _layer_grads(h, w, b, g)[2])


def test_params_round_trip_through_wts(tmp_path):
    layers = init_params(5, NARROW)
    layers[-1]["b"] = np.linspace(-1, 1, 257, dtype=np.float32)
    model = params_from_numpy(layers, "cpu")
    assert isinstance(model, FFN)
    assert [tuple(w.shape) for w in model.weights] == [(1799, 64), (64, 64),
                                                       (64, 257)]
    j = _jax()
    path = tmp_path / "m.wts"
    j.write_wts(path, params_to_numpy(model))
    for a, b in zip(j.read_wts(path), layers):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_params_from_numpy_rejects_bad_layers():
    layers = init_params(5, NARROW)
    layers[1]["w"] = layers[1]["w"][:10]
    with pytest.raises(ValueError, match="do not chain"):
        params_from_numpy(layers, "cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        FFN(NARROW, "cpu", activation="tanh")


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 8, 128, 992])
def test_ffn_reduced_precision_on_the_card_matches_cpu(m):
    """The tensor-core products (float32 result) against the CPU's widened
    operands, at full width.  One product is tight (sum order only).  In
    the whole network a first flipped rounding moves the next layer's 2048
    inputs, which flips ~1 % of their roundings, and so on, so two bfloat16
    evaluations end as far apart as part of bfloat16's own rounding noise:
    within 0.75 of the float32 network's distance, measured here."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from tpu_se_torch.utils import resolve_device

    resolve_device("cuda")
    layers, rng = _biased_layers(DEFAULT_LAYERSIZES, m)
    x = rng.standard_normal((m, DEFAULT_LAYERSIZES[0])).astype(np.float32)
    a = torch.from_numpy(x).to(BF16)
    w0 = torch.from_numpy(layers[0]["w"]).to(BF16)
    card = reduced_product(a.cuda(), w0.cuda())
    assert card.dtype == torch.float32
    want = reduced_product(a, w0)
    torch.testing.assert_close(card.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    host = params_from_numpy(layers, "cpu")
    dev = params_from_numpy(layers, "cuda")
    for act_dtype in (None, BF16):
        with torch.no_grad():
            want = host(torch.from_numpy(x), compute_dtype=BF16,
                        act_dtype=act_dtype)
            got = dev(torch.from_numpy(x).cuda(), compute_dtype=BF16,
                      act_dtype=act_dtype,
                      cast_weights=dev.cast_weights(BF16))
            gap = (dev(torch.from_numpy(x).cuda()).cpu() - want).abs().max()
        assert got.dtype == torch.float32
        torch.testing.assert_close(got.cpu(), want, rtol=0,
                                   atol=0.75 * float(gap))


@pytest.mark.cuda
def test_reduced_linear_backward_on_the_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    h, w, b, g = _layer_problem(np.random.default_rng(3), 128, 2048, 2048)
    want = _layer_grads(h, w, b, g)
    got = _layer_grads(h, w, b, g, device="cuda")
    for name, x, y in zip(("z", "dh", "dw", "db"), got, want):
        # Both sides round dh and dw to bfloat16: a float32 sum order can
        # flip that rounding, one bfloat16 ulp (2^-7 relative).
        tol = 2.0 ** -7 if name in ("dh", "dw") else 1e-5
        assert np.abs(x - y).max() <= tol * np.abs(y).max(), name
