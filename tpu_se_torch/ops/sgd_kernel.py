"""Fused momentum-SGD update: ``v = m*v - lr*(g/n + wc*w); w += v`` over a
list of tensors, in place.

The reference's update (``tpu_se/train/optim.py:23-37``) is one XLA fusion
inside its jitted step; it reaches no Pallas kernel.  Here it is one
hand-written Hopper kernel (``csrc/sgd_kernel.cu``) that updates every
tensor of the list in one pass and one launch, bit for bit the plain
version's eager operations on the card.

- ``sgd_update_cuda`` launches the kernel; CUDA tensors only, never falls
  back.
- ``sgd_update_plain`` is the same update as eager PyTorch operations (the
  body ``train/optim.py:sgd_momentum_update`` had before the kernel): the
  CPU path and the reference that the kernel is held against on the card.
- ``check_sgd_args`` raises on what the kernel does not take; everything
  but the device type can be checked on the CPU.
- ``launches`` counts ``sgd_update_cuda``'s kernel launches (and nothing
  else).  A training bunch replayed from a CUDA graph runs the kernel
  without calling the wrapper: ``train/step.py`` adds one per replay and
  takes back the capture's call, which launched nothing.

The kernel follows the card's eager rounding, which differs from the
CPU's in one place: PyTorch's CUDA ``g / n`` by a host scalar is ``g *
(1/n)``, the reciprocal rounded to float32 on the host, while the CPU
divides.  At n = 1 and n = 128 (the natural and parity scales of the
cells) the two are the same function; at n = 3 they differ in the last
bit of some elements (ROADMAP "Parity rules").
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

# As in csrc/sgd_kernel.cu.
MAX_TENSORS = 32              # table entries per launch
MAX_NUMEL = 2**31 - 1         # a tensor's length is a C int

launches = 0


class _Entry(ctypes.Structure):
    """``SgdEntry`` of csrc/sgd_kernel.cu: one tensor of the list."""
    _fields_ = [("p", ctypes.c_void_p), ("v", ctypes.c_void_p),
                ("g", ctypes.c_void_p), ("n", ctypes.c_int),
                ("has_wc", ctypes.c_int), ("wc", ctypes.c_float)]


@torch.no_grad()
def sgd_update_plain(params: list[dict], velocity: list[dict],
                     grads: list[dict], lr: float | torch.Tensor,
                     momentum: float, weightcost: float, n: int) -> None:
    """One reference-exact update, IN PLACE on ``params`` and ``velocity``
    (lists of ``{"w", "b"}`` tensors), as eager PyTorch operations on the
    tensors' device; arguments as ``train.optim.sgd_momentum_update``."""
    for p_l, v_l, g_l in zip(params, velocity, grads):
        for key, wc in (("w", weightcost), ("b", 0.0)):
            p, v = p_l[key], v_l[key]
            step = g_l[key] / n
            if wc:
                step = step + wc * p
            v.mul_(momentum).sub_(lr * step)
            p.add_(v)


def _triples(params: list[dict], velocity: list[dict], grads: list[dict],
             weightcost: float) -> list[tuple]:
    """(p, v, g, wc) per tensor, in the plain version's order."""
    return [(p_l[key], v_l[key], g_l[key], wc)
            for p_l, v_l, g_l in zip(params, velocity, grads)
            for key, wc in (("w", weightcost), ("b", 0.0))]


def check_sgd_args(params: list[dict], velocity: list[dict],
                   grads: list[dict], lr: float | torch.Tensor) -> None:
    """Raise ``ValueError`` unless the lists are what the kernel takes:
    equally long lists of ``{"w", "b"}`` tensors, each p, v and g float32,
    contiguous, of one shape and at most ``MAX_NUMEL`` elements, all on
    one device; ``lr`` a number or a 0-dim float32 tensor on that device.
    The device type is not checked here."""
    fn = "sgd_update_cuda"
    if not len(params) == len(velocity) == len(grads):
        raise ValueError(f"{fn}: {len(params)} parameter layers, "
                         f"{len(velocity)} velocity, {len(grads)} gradient")
    for i, layers in enumerate(zip(params, velocity, grads)):
        for name, layer in zip(("params", "velocity", "grads"), layers):
            if set(layer) != {"w", "b"}:
                raise ValueError(f"{fn}: {name}[{i}] has keys "
                                 f"{sorted(layer)}, not w and b")
    triples = _triples(params, velocity, grads, 0.0)
    device = triples[0][0].device if triples else None
    for p, v, g, _ in triples:
        for name, x in (("p", p), ("v", v), ("g", g)):
            if x.dtype != torch.float32:
                raise ValueError(f"{fn}: {name} must be float32, got "
                                 f"{x.dtype}")
            if not x.is_contiguous():
                raise ValueError(f"{fn}: {name} {tuple(x.shape)} must be "
                                 "contiguous")
            if x.device != device:
                raise ValueError(f"{fn}: {name} on {x.device}, the first "
                                 f"parameter on {device}")
        if not p.shape == v.shape == g.shape:
            raise ValueError(f"{fn}: p {tuple(p.shape)}, v {tuple(v.shape)} "
                             f"and g {tuple(g.shape)} differ in shape")
        if p.numel() > MAX_NUMEL:
            raise ValueError(f"{fn}: {p.numel()} elements exceed the "
                             f"kernel's int32 lengths ({MAX_NUMEL})")
    if isinstance(lr, torch.Tensor):
        if lr.dim() != 0 or lr.dtype != torch.float32:
            raise ValueError(f"{fn}: a tensor lr must be 0-dim float32, got "
                             f"{lr.dtype} of shape {tuple(lr.shape)}")
        if device is not None and lr.device != device:
            raise ValueError(f"{fn}: lr on {lr.device}, the parameters on "
                             f"{device}")


def _inv_n(n: int) -> float:
    """1 / n rounded to float32, as PyTorch's CUDA division by a host
    scalar forms its multiplier."""
    with np.errstate(divide="ignore"):
        return float(np.float32(1.0) / np.float32(n))


def sgd_update_cuda(params: list[dict], velocity: list[dict],
                    grads: list[dict], lr: float | torch.Tensor,
                    momentum: float, weightcost: float, n: int) -> None:
    """``sgd_update_plain`` on the card: every tensor updated in place by
    one launch of ``sgd_momentum_update`` (one per ``MAX_TENSORS``
    tensors) on PyTorch's current stream, without a synchronise or an
    allocation; raises on bad arguments or a refused launch.  A tensor
    ``lr`` is read by the kernel on the device."""
    global launches
    from tpu_se_torch.ops._build import load_library

    check_sgd_args(params, velocity, grads, lr)
    triples = _triples(params, velocity, grads, weightcost)
    if not triples:
        return
    device = triples[0][0].device
    if device.type != "cuda":
        raise ValueError(f"sgd_update_cuda: the tensors must be CUDA "
                         f"tensors, got {device}")
    table = (_Entry * len(triples))(*(
        _Entry(p.data_ptr(), v.data_ptr(), g.data_ptr(), p.numel(),
               int(bool(wc)), wc) for p, v, g, wc in triples))
    if isinstance(lr, torch.Tensor):
        lr_ptr, lr_value = lr.data_ptr(), 0.0
    else:
        lr_ptr, lr_value = None, float(lr)
    lib, _ = load_library()
    with torch.cuda.device(device):
        rc = lib.sgd_momentum_update(table, len(triples), lr_ptr, lr_value,
                                     momentum, _inv_n(n),
                                     torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"sgd_momentum_update launch failed: CUDA error "
                           f"{rc}")
    launches += -(-len(triples) // MAX_TENSORS)
    # As the eager in-place operations do, so that autograd still refuses
    # a saved parameter that was changed.
    for p, v, _, _ in triples:
        torch.autograd.graph.increment_version(p)
        torch.autograd.graph.increment_version(v)
