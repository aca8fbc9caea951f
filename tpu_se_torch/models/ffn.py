"""The regression DNN: 1799 -> 2048 x3 (sigmoid) -> 257 (linear).

Port of ``tpu_se/models/ffn.py`` (reference forward ``BP_GPU.cu:334-370``:
x_l = W_l y_{l-1} + b_l, sigmoid on hidden layers, identity at the output).

The weights keep the JAX layout ``w [n_in, n_out]`` -- the layout of the
``.wts`` codec's output and of ``tpu_se.models`` -- so a layer is
``torch.addmm(b, h, w)`` and no conversion transposes anything.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

DEFAULT_LAYERSIZES = (1799, 2048, 2048, 2048, 257)

_ACTIVATIONS = {"sigmoid": torch.sigmoid, "relu": torch.relu}


def init_params(seed: int, layersizes=DEFAULT_LAYERSIZES,
                flag: int = 1, beta: float = 2.0) -> list[dict]:
    """Random init matching Gen_rand_net (``Gen_rand_net.cpp:84-103``), as
    numpy ``[{"w": [n_in, n_out], "b": [n_out]}]``, bit-identical to
    ``tpu_se.models.init_params`` for the same arguments.

    flag=1: W ~ U(+-beta*sqrt(6)/sqrt(n_in+n_out));
    flag=0: W ~ U(+-beta/sqrt(n_in)).  Biases zero.
    """
    rng = np.random.default_rng(seed)
    params = []
    for n_in, n_out in zip(layersizes[:-1], layersizes[1:]):
        if flag:
            bound = beta * np.sqrt(6.0) / np.sqrt(n_in + n_out)
        else:
            bound = beta / np.sqrt(n_in)
        w = rng.uniform(-bound, bound, size=(n_in, n_out)).astype(np.float32)
        params.append({"w": w, "b": np.zeros(n_out, dtype=np.float32)})
    return params


def init_params_uniform(seed: int, layersizes=DEFAULT_LAYERSIZES,
                        weight_min: float = -0.1, weight_max: float = 0.1,
                        bias_min: float = -0.1, bias_max: float = 0.1
                        ) -> list[dict]:
    """The trainer's plain-uniform init when no initial ``.wts`` is given
    (``Interface.cc:140-143``, keys ``init_randem_{weight,bias}_{min,max}``),
    bit-identical to ``tpu_se.models.init_params_uniform``."""
    rng = np.random.default_rng(seed)
    params = []
    for n_in, n_out in zip(layersizes[:-1], layersizes[1:]):
        w = rng.uniform(weight_min, weight_max,
                        size=(n_in, n_out)).astype(np.float32)
        b = rng.uniform(bias_min, bias_max, size=n_out).astype(np.float32)
        params.append({"w": w, "b": b})
    return params


class FFN(nn.Module):
    """Fully connected network; ``weights[i]`` is ``[n_in, n_out]``.

    ``activation`` is the hidden nonlinearity: "sigmoid" (the reference)
    or "relu" (its ``#ifdef RELU`` build, ``DevFunc.cu:40-49``).
    """

    def __init__(self, layersizes, device, activation: str = "sigmoid"):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        pairs = list(zip(layersizes[:-1], layersizes[1:]))
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(n_in, n_out, device=device))
            for n_in, n_out in pairs)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(n_out, device=device))
            for _, n_out in pairs)

    def forward(self, x: torch.Tensor, dropout: tuple | None = None,
                generator: torch.Generator | None = None) -> torch.Tensor:
        """x [M, n_in] -> [M, n_out].

        ``dropout=(visible_omit, hid_omit)`` is the reference's input-side
        dropout (``BP_GPU.cu:344-356``): the input of layer 0 is zeroed
        with probability ``visible_omit`` and that of every later layer
        with ``hid_omit``; kept values are scaled by 1/(1-p) (inverted
        dropout, so inference needs no weight rescaling).  The masks come
        from ``generator``, which must lie on ``x``'s device.
        """
        if dropout is not None and generator is None:
            raise ValueError("dropout needs a torch.Generator")
        act = _ACTIVATIONS[self.activation]
        h = x
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            p = 0.0 if dropout is None else dropout[0 if i == 0 else 1]
            if p > 0.0:
                keep = torch.rand(h.shape, generator=generator,
                                  device=h.device) < 1.0 - p
                h = torch.where(keep, h / (1.0 - p), 0.0)
            z = torch.addmm(b, h, w)
            h = act(z) if i < last else z
        return h


def params_from_numpy(layers: list[dict], device,
                      activation: str = "sigmoid") -> FFN:
    """``[{"w": [n_in, n_out], "b": [n_out]}]`` numpy layers -- as ``read_wts``
    and ``tpu_se.models.params_to_wts`` give them -> an ``FFN`` on ``device``
    (same layout, no transpose)."""
    sizes = [layers[0]["w"].shape[0]]
    for i, layer in enumerate(layers):
        n_in, n_out = layer["w"].shape
        if n_in != sizes[-1] or np.shape(layer["b"]) != (n_out,):
            raise ValueError(f"layer {i}: w {layer['w'].shape} / b "
                             f"{np.shape(layer['b'])} do not chain")
        sizes.append(n_out)
    model = FFN(sizes, device=device, activation=activation)
    with torch.no_grad():
        for p, layer in zip(model.weights, layers):
            p.copy_(torch.from_numpy(np.asarray(layer["w"], np.float32)))
        for p, layer in zip(model.biases, layers):
            p.copy_(torch.from_numpy(np.asarray(layer["b"], np.float32)))
    return model


def params_to_numpy(model: FFN) -> list[dict]:
    """``FFN`` -> ``[{"w": [n_in, n_out], "b": [n_out]}]`` host numpy, the
    ``write_wts`` input."""
    return [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
            for w, b in zip(model.weights, model.biases)]
