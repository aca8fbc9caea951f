"""tpu_se_torch.models against tpu_se.models on the CPU.

``init_params`` must be bit-identical (same numpy RNG); the forward pass
is held to rtol 1e-5 / atol 1e-5 (float32 GEMMs summed in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_se.io import read_wts, write_wts
from tpu_se.models import forward as jax_forward
from tpu_se.models import init_params as jax_init_params
from tpu_se.models import params_from_wts, params_to_wts
from tpu_se_torch.models import (
    DEFAULT_LAYERSIZES, FFN, init_params, params_from_numpy, params_to_numpy,
)

NARROW = (1799, 64, 64, 257)


@pytest.mark.parametrize("seed,flag,beta", [(7, 1, 2.0), (3, 0, 1.0)])
def test_init_params_bit_identical(seed, flag, beta):
    ours = init_params(seed, NARROW, flag=flag, beta=beta)
    theirs = params_to_wts(jax_init_params(seed, NARROW, flag=flag,
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
    layers = init_params(11, layersizes)
    rng = np.random.default_rng(m)
    for layer in layers:                       # non-zero biases
        layer["b"] = rng.uniform(-0.1, 0.1, layer["b"].shape).astype(
            np.float32)
    x = rng.standard_normal((m, layersizes[0])).astype(np.float32)
    model = params_from_numpy(layers, "cpu", activation=activation)
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_forward(params_from_wts(layers), jnp.asarray(x),
                                  activation=activation))
    assert got.shape == (m, layersizes[-1])
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_params_round_trip_through_wts(tmp_path):
    layers = init_params(5, NARROW)
    layers[-1]["b"] = np.linspace(-1, 1, 257, dtype=np.float32)
    model = params_from_numpy(layers, "cpu")
    assert isinstance(model, FFN)
    assert [tuple(w.shape) for w in model.weights] == [(1799, 64), (64, 64),
                                                       (64, 257)]
    path = tmp_path / "m.wts"
    write_wts(path, params_to_numpy(model))
    for a, b in zip(read_wts(path), layers):
        np.testing.assert_array_equal(a["w"], b["w"])
        np.testing.assert_array_equal(a["b"], b["b"])


def test_params_from_numpy_rejects_bad_layers():
    layers = init_params(5, NARROW)
    layers[1]["w"] = layers[1]["w"][:10]
    with pytest.raises(ValueError, match="do not chain"):
        params_from_numpy(layers, "cpu")
    with pytest.raises(ValueError, match="unknown activation"):
        FFN(NARROW, "cpu", activation="tanh")
