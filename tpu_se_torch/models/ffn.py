"""The regression DNN: 1799 -> 2048 x3 (sigmoid) -> 257 (linear).

Port of ``tpu_se/models/ffn.py`` (reference forward ``BP_GPU.cu:334-370``:
x_l = W_l y_{l-1} + b_l, sigmoid on hidden layers, identity at the output).

The weights keep the JAX layout ``w [n_in, n_out]`` -- the layout of the
``.wts`` codec's output and of ``tpu_se.models`` -- so a layer is
``torch.addmm(b, h, w)`` and no conversion transposes anything.

``compute_dtype=torch.bfloat16`` is the reference's throughput knob
(``tpu_se/models/ffn.py:92-111``): the operands of every product are
rounded to bfloat16, the products are summed in float32, and everything
else -- ``z``, the bias, the nonlinearity, the master weights, the output
layer -- stays float32.  ``reduced_linear`` is that layer with the
backward pass of ``jax.vjp``'s, rounding for rounding (see
``_ReducedLinear``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

DEFAULT_LAYERSIZES = (1799, 2048, 2048, 2048, 257)

_ACTIVATIONS = {"sigmoid": torch.sigmoid, "relu": torch.relu}


def reduced_product(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for two reduced-precision (bfloat16) matrices, summed and
    returned in float32.

    On a CUDA device this is the tensor cores' product with a float32
    result (``torch.mm(..., out_dtype=torch.float32)``); a bfloat16 result
    would round ``z`` by 2^-9, which the reference never does.  On the CPU,
    where PyTorch has no such product, the operands are widened first:
    a bfloat16 x bfloat16 product is exact in float32, so this is the same
    function up to the order of the float32 sums.  The choice follows the
    tensors' device and nothing else.
    """
    if a.device.type == "cuda":
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


class _ReducedLinear(torch.autograd.Function):
    """``z = h.to(dtype) @ w.to(dtype) + b`` with float32 sums, and the
    backward pass that ``jax.vjp`` gives the reference's layer.

    JAX's transpose of ``dot(h.astype(bf16), w.astype(bf16),
    preferred_element_type=f32)`` multiplies the float32 cotangent ``g``
    with the saved bfloat16 operand and rounds each result to bfloat16
    before it goes on as float32.  A GPU has no float32 x bfloat16 product,
    so here ``g`` is rounded to bfloat16 for the two products (one rounding
    of relative 2^-9 per element more than JAX, on the CPU and the card
    alike); ``dW`` and ``dh`` are rounded to bfloat16 as in the reference,
    and the bias gradient is the float32 column sum of the unrounded ``g``.
    """

    @staticmethod
    def forward(ctx, h, w, b, dtype, w_cast):
        h_c = h.to(dtype)
        w_c = w.to(dtype) if w_cast is None else w_cast
        ctx.save_for_backward(h_c, w_c)
        ctx.dtype = dtype
        ctx.h_dtype = h.dtype
        z = reduced_product(h_c, w_c)
        return z if b is None else z.add_(b)

    @staticmethod
    def backward(ctx, g):
        h_c, w_c = ctx.saved_tensors
        g_c = g.to(ctx.dtype)
        dh = dw = db = None
        if ctx.needs_input_grad[0]:
            dh = reduced_product(g_c, w_c.t()).to(ctx.dtype).to(ctx.h_dtype)
        if ctx.needs_input_grad[1]:
            dw = reduced_product(h_c.t(), g_c).to(ctx.dtype).float()
        if ctx.needs_input_grad[2]:
            db = g.sum(dim=0)
        return dh, dw, db, None, None


def reduced_linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
                   dtype: torch.dtype,
                   w_cast: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's ``z`` [M, n_out] (float32) from ``h`` [M, n_in], the
    float32 master weight ``w`` [n_in, n_out] and bias ``b``, with the
    product's operands in ``dtype``.  ``w_cast`` is ``w.to(dtype)`` made
    beforehand, for callers whose weights are frozen; without it the cast
    is made here, once per call, and kept for the backward pass.
    ``b=None`` gives the bare product (a row-parallel layer's partial
    ``z``, whose bias is added after the sum over the model axis)."""
    return _ReducedLinear.apply(h, w, b, dtype, w_cast)


def linear(h: torch.Tensor, w: torch.Tensor, b: torch.Tensor | None,
           compute_dtype: torch.dtype = torch.float32,
           w_cast: torch.Tensor | None = None) -> torch.Tensor:
    """One layer's float32 ``z = h @ w (+ b)`` with the products' operands
    in ``compute_dtype``: ``torch.addmm`` (``torch.mm`` without a bias) in
    float32, ``reduced_linear`` otherwise."""
    if compute_dtype == torch.float32:
        # .float() is the tensor itself unless act_dtype made it narrower.
        if b is None:
            return torch.mm(h.float(), w)
        return torch.addmm(b, h.float(), w)
    return reduced_linear(h, w, b, compute_dtype, w_cast)


def input_dropout(h: torch.Tensor, p: float, generator: torch.Generator,
                  rows: tuple | None = None,
                  cols: tuple | None = None) -> torch.Tensor:
    """The reference's inverted input dropout (``BP_GPU.cu:344-356``): each
    value of ``h`` is zeroed with probability ``p`` and the kept ones are
    scaled by 1/(1-p).

    ``rows=(lo, m_global)`` says that ``h`` holds rows [lo, lo + M) of a
    bunch of ``m_global`` rows, and ``cols=(k, n)`` that it holds the k-th
    of n equal blocks of columns: the mask of the whole bunch at full width
    is drawn from ``generator`` and this block of it is kept, so ranks that
    share the generator's seed draw together what one process draws.
    Inside a captured training bunch the draw reads the generator's
    Philox seed and offset when the graph is replayed (``train/step.py``).
    """
    m, width = h.shape
    lo, m_global = (0, m) if rows is None else rows
    k, n = (0, 1) if cols is None else cols
    draw = torch.rand((m_global, width * n), generator=generator,
                      device=h.device)[lo:lo + m, k * width:(k + 1) * width]
    return torch.where(draw < 1.0 - p, h / (1.0 - p), 0.0)


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

    @torch.no_grad()
    def cast_weights(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """The weight matrices as ``dtype`` copies, for ``forward``'s
        ``cast_weights``: a caller with frozen weights (a decoder) makes
        them once, where training casts once per step."""
        return [w.to(dtype) for w in self.weights]

    def forward(self, x: torch.Tensor, dropout: tuple | None = None,
                generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = torch.float32,
                act_dtype: torch.dtype | None = None,
                cast_weights: list | None = None,
                dropout_rows: tuple | None = None) -> torch.Tensor:
        """x [M, n_in] -> [M, n_out], float32.

        ``compute_dtype`` is the type of the products' operands
        (``torch.float32``, the parity default, or ``torch.bfloat16`` with
        float32 sums; ``cast_weights`` then optionally holds
        ``self.cast_weights(compute_dtype)``).  ``act_dtype`` casts the
        hidden activations after the nonlinearity, never the output layer,
        with either ``compute_dtype``.

        ``dropout=(visible_omit, hid_omit)`` is the reference's input-side
        dropout (``BP_GPU.cu:344-356``): the input of layer 0 is zeroed
        with probability ``visible_omit`` and that of every later layer
        with ``hid_omit``; kept values are scaled by 1/(1-p) (inverted
        dropout, so inference needs no weight rescaling).  The masks come
        from ``generator``, which must lie on ``x``'s device.
        ``dropout_rows=(lo, m_global)`` says that ``x`` is rows [lo, lo + M)
        of a bunch of ``m_global`` rows shared with other ranks: the masks
        of the whole bunch are drawn and this rank keeps its rows, so the
        ranks together draw what one process would.
        """
        if dropout is not None and generator is None:
            raise ValueError("dropout needs a torch.Generator")
        act = _ACTIVATIONS[self.activation]
        h = x
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            p = 0.0 if dropout is None else dropout[0 if i == 0 else 1]
            if p > 0.0:
                h = input_dropout(h, p, generator, dropout_rows)
            z = linear(h, w, b, compute_dtype,
                       None if cast_weights is None else cast_weights[i])
            h = act(z) if i < last else z
            if act_dtype is not None and i < last:
                h = h.to(act_dtype)
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
