"""Tensor-parallel hidden layers over the mesh's ``model`` axis.

The port of what ``tpu_se/parallel/mesh.py:param_shardings`` lays out and
GSPMD then runs.  A rank holds its shard of every layer
(``shard_params``): column-parallel layers (even hidden layers) keep their
block of output columns and of the bias, row-parallel layers (odd hidden
layers) their block of input rows, and the output layer and the
row-parallel biases are whole on every rank.  The collectives that GSPMD
inserts are written out as ``torch.autograd.Function``s, as Megatron-LM
does:

- the input of a column-parallel layer: identity forward, all-reduce of
  its gradient over ``model`` backward (each rank's columns give a part of
  it);
- the partial ``z`` of a row-parallel layer: all-reduce over ``model``
  forward, identity backward; its replicated bias is added after the sum;
- a column-parallel output that feeds a replicated layer (the output layer
  of the full-width network, after layer 2): all-gather of the columns
  forward, this rank's columns of the gradient backward.

So the network's output, the GGD gradient built from it and the gradients
of every replicated tensor are bitwise the same on every rank of a model
line; no collective has to keep them so.  With a model axis of one rank
every layer is replicated and the forward pass is ``FFN.forward``'s, op for
op.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from tpu_se_torch.models.ffn import _ACTIVATIONS, input_dropout, linear
from tpu_se_torch.parallel.mesh import Mesh, MeshConfig, param_shardings

COLUMN = (None, "model")
ROW = ("model", None)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient summed over the model axis."""

    @staticmethod
    def forward(ctx, h, mesh):
        ctx.mesh = mesh
        return h

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.float32, copy=True)
        ctx.mesh.all_reduce_sum(total, "model")
        return total.to(g.dtype), None


class _ReduceFromModel(torch.autograd.Function):
    """The model axis' partial sums added forward; identity backward."""

    @staticmethod
    def forward(ctx, z, mesh):
        return mesh.all_reduce_sum(z.clone(), "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    """The model axis' column blocks joined forward; this rank's block of
    the (replicated) gradient backward."""

    @staticmethod
    def forward(ctx, h, mesh):
        ctx.block = (mesh.model_rank, h.shape[1])
        return mesh.all_gather(h, 1, "model")

    @staticmethod
    def backward(ctx, g):
        k, width = ctx.block
        return g[:, k * width:(k + 1) * width], None


class TensorParallelFFN(nn.Module):
    """One rank's shard of the FFN: ``weights[i]`` and ``biases[i]`` are
    its blocks of the layers as ``specs`` (``param_shardings``) lay them
    out over ``mesh``'s model axis.  Build it with ``shard_params``."""

    def __init__(self, shapes: list[dict], specs: list[dict], mesh: Mesh,
                 device, activation: str = "sigmoid"):
        super().__init__()
        if activation not in _ACTIVATIONS:
            raise ValueError(f"unknown activation {activation!r}")
        self.activation = activation
        self.mesh = mesh
        self.specs = specs
        self.weights = nn.ParameterList(
            nn.Parameter(torch.zeros(s["w"], device=device)) for s in shapes)
        self.biases = nn.ParameterList(
            nn.Parameter(torch.zeros(s["b"], device=device)) for s in shapes)

    @torch.no_grad()
    def cast_weights(self, dtype: torch.dtype) -> list[torch.Tensor]:
        """The weight shards as ``dtype`` copies (``FFN.cast_weights``)."""
        return [w.to(dtype) for w in self.weights]

    def forward(self, x: torch.Tensor, dropout: tuple | None = None,
                generator: torch.Generator | None = None,
                compute_dtype: torch.dtype = torch.float32,
                act_dtype: torch.dtype | None = None,
                cast_weights: list | None = None,
                dropout_rows: tuple | None = None) -> torch.Tensor:
        """x [M, n_in] (whole on every rank of the model line) -> [M, n_out]
        float32, the same bits on every rank of the line.  The arguments
        are ``FFN.forward``'s; dropout masks are drawn for the whole bunch
        at full width and each rank keeps its rows and, where a layer's
        input is split, its columns.  Products in bfloat16 round each
        rank's partial ``dh`` as one device rounds its own, and the
        all-reduce adds the rounded partials in float32."""
        if dropout is not None and generator is None:
            raise ValueError("dropout needs a torch.Generator")
        act = _ACTIVATIONS[self.activation]
        mesh = self.mesh
        h, split = x, False          # split: h holds this rank's columns
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            kind = self.specs[i]["w"]
            if split and kind != ROW:
                h, split = _GatherFromModel.apply(h, mesh), False
            p = 0.0 if dropout is None else dropout[0 if i == 0 else 1]
            if p > 0.0:
                h = input_dropout(h, p, generator, dropout_rows,
                                  (mesh.model_rank, mesh.model) if split
                                  else None)
            if kind == COLUMN and h.requires_grad:
                h = _CopyToModel.apply(h, mesh)
            w_cast = None if cast_weights is None else cast_weights[i]
            if kind == ROW:
                z = _ReduceFromModel.apply(
                    linear(h, w, None, compute_dtype, w_cast), mesh) + b
            else:
                z = linear(h, w, b, compute_dtype, w_cast)
            h = act(z) if i < last else z
            split = kind == COLUMN
            if act_dtype is not None and i < last:
                h = h.to(act_dtype)
        return h

    def check_replicas(self, where: str) -> None:
        """``Mesh.check_replicas`` for this layout: the replicated tensors
        over the whole group, each shard over its data axis."""
        whole, shards = [], []
        for w, b, spec in zip(self.weights, self.biases, self.specs):
            for t, axes in ((w, spec["w"]), (b, spec["b"])):
                (shards if "model" in axes else whole).append(t)
        self.mesh.check_replicas(whole, where)
        if shards:
            self.mesh.check_replicas(shards, where, axis="data")


def _unsplit(layer: int, width: int, model: int) -> ValueError:
    return ValueError(f"layer {layer}: hidden width {width} does not split "
                      f"evenly over {model} ranks of the model axis")


def check_model_split(layersizes, model: int) -> None:
    """Raise ``ValueError`` unless every width that ``param_shardings``
    splits over a model axis of ``model`` ranks divides by it; a run checks
    this before it starts its ranks."""
    specs = param_shardings(MeshConfig(1, model), len(layersizes) - 1)
    for i, spec in enumerate(specs):
        for n, axis in zip(layersizes[i:i + 2], spec["w"]):
            if axis == "model" and n % model:
                raise _unsplit(i, n, model)


def _block(shape: tuple, axes: tuple, mesh: Mesh, layer: int) -> tuple:
    """The index of this rank's block of a tensor of ``shape`` laid out as
    ``axes``; raises when the model axis does not split a width."""
    index = []
    for dim, n in enumerate(shape):
        if dim < len(axes) and axes[dim] == "model":
            if n % mesh.model:
                raise _unsplit(layer, n, mesh.model)
            per = n // mesh.model
            index.append(slice(mesh.model_rank * per,
                               (mesh.model_rank + 1) * per))
        else:
            index.append(slice(None))
    return tuple(index)


def shard_layers(layers: list[dict], mesh: Mesh) -> list[dict]:
    """``[{"w", "b"}]`` whole layers (numpy or tensors: the weights, or the
    velocity shaped like them) -> this rank's blocks of them."""
    specs = param_shardings(mesh, len(layers))
    return [{k: layer[k][_block(np.shape(layer[k]), spec[k], mesh, i)]
             for k in ("w", "b")}
            for i, (layer, spec) in enumerate(zip(layers, specs))]


def shard_params(layers: list[dict], mesh: Mesh, device=None,
                 activation: str = "sigmoid") -> TensorParallelFFN:
    """Whole numpy layers ``[{"w": [n_in, n_out], "b": [n_out]}]`` (as
    ``read_wts`` gives them: the layers ``tpu_se``'s ``param_shardings``
    places) -> this rank's ``TensorParallelFFN`` on ``device`` (default:
    the mesh's).  Raises ``ValueError`` when the layers do not chain or a
    hidden width does not split over the model axis."""
    for i, layer in enumerate(layers):
        n_in, n_out = layer["w"].shape
        if (np.shape(layer["b"]) != (n_out,)
                or (i and n_in != layers[i - 1]["w"].shape[1])):
            raise ValueError(f"layer {i}: w {layer['w'].shape} / b "
                             f"{np.shape(layer['b'])} do not chain")
    pieces = shard_layers(layers, mesh)
    model = TensorParallelFFN(
        [{k: piece[k].shape for k in ("w", "b")} for piece in pieces],
        param_shardings(mesh, len(layers)), mesh,
        mesh.device if device is None else device, activation)
    with torch.no_grad():
        for params, key in ((model.weights, "w"), (model.biases, "b")):
            for p, piece in zip(params, pieces):
                p.copy_(torch.from_numpy(
                    np.ascontiguousarray(piece[key], np.float32)))
    return model


def gather_layers(layers: list[dict], mesh: Mesh | None) -> list[dict]:
    """This rank's blocks ``[{"w", "b"}]`` (tensors) -> the whole layers as
    host numpy, joined over the model axis.  Every rank of the model line
    calls it together; ``mesh=None`` only copies to the host."""
    specs = (param_shardings(mesh, len(layers)) if mesh is not None
             else [{"w": (), "b": ()}] * len(layers))
    out = []
    for layer, spec in zip(layers, specs):
        whole = {}
        for k in ("w", "b"):
            t = layer[k].detach()
            if "model" in spec[k]:
                t = mesh.all_gather(t, spec[k].index("model"), "model")
            whole[k] = t.cpu().numpy()
        out.append(whole)
    return out


def gather_params(model, mesh: Mesh | None) -> list[dict]:
    """The inverse of ``shard_params``: the whole numpy layers, on the
    ranks of the model line that ask together."""
    return gather_layers([{"w": w, "b": b} for w, b in
                          zip(model.weights, model.biases)], mesh)
