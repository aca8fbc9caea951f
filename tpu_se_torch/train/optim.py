"""Momentum-SGD with weight decay, matching ``kernUpdatedelta`` exactly.

``v = momentum*v - lr*(grad/n + weightcost*w);  w += v``
(``DevFunc.cu:490-507``; port of ``tpu_se/train/optim.py``).

- ``grad`` is the SUM over the bunch of per-sample gradients, already
  carrying the loss-side 1/M in parity mode, so the effective step is
  lr/M^2 on the loss gradient.
- Weight decay applies to weights only; biases use weightcost 0
  (``BP_GPU.cu:433-435``).
- On a card the update is one launch of a hand-written kernel over every
  tensor (``ops/sgd_kernel.py``), bit for bit the eager operations there;
  on the CPU it is those eager operations (``sgd_update_plain``).

Not ``torch.optim.SGD``: its momentum keeps lr outside the velocity
(``v = momentum*v + g; w -= lr*v``) and adds the decay to the gradient
before the momentum, so its steps differ from the reference's.
"""

from __future__ import annotations

import torch

from tpu_se_torch.ops.sgd_kernel import sgd_update_cuda, sgd_update_plain


def sgd_momentum_init(params: list[dict]) -> list[dict]:
    """Zero velocity shaped like ``[{"w": ..., "b": ...}]`` params."""
    return [{k: torch.zeros_like(v) for k, v in layer.items()}
            for layer in params]


@torch.no_grad()
def sgd_momentum_update(params: list[dict], velocity: list[dict],
                        grads: list[dict], lr: float | torch.Tensor,
                        momentum: float, weightcost: float, n: int) -> None:
    """One reference-exact update, IN PLACE on ``params`` and ``velocity``
    (lists of ``{"w", "b"}`` tensors); ``grads`` are bunch-summed and ``n``
    is the bunch size (1 for the ``natural`` scale).  Each operation rounds
    to float32 where the JAX expression does.  ``lr`` is a float32-valued
    float or a 0-dim float32 tensor on the params' device (a captured
    graph's rate): ``lr * step`` is the same float32 product either way.

    The tensors' device picks the route: CUDA tensors take the fused
    kernel (``sgd_update_cuda``, which raises on what it cannot take),
    anything else the eager operations (``sgd_update_plain``)."""
    first = next((p for layer in params for p in layer.values()), None)
    if first is not None and first.device.type == "cuda":
        sgd_update_cuda(params, velocity, grads, lr, momentum, weightcost, n)
    else:
        sgd_update_plain(params, velocity, grads, lr, momentum, weightcost,
                         n)
