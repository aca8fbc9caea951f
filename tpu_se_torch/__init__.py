"""tpu_se_torch — the PyTorch/CUDA port of ``tpu_se`` for NVIDIA Hopper.

``tpu_se`` (JAX) stays the reference; every module here mirrors its
namesake there so each counterpart is easy to find.  The port imports
``torch`` and never ``jax``, and nothing of ``tpu_se``: it carries its own
numpy copies of the helpers and file codecs it needs.

Layers:

- ``tpu_se_torch.io``     — wav, ``.norm`` and ``.wts`` codecs
                             (byte-compatible with ``tpu_se.io``).
- ``tpu_se_torch.utils``  — device resolution (explicit, never a silent CPU).
- ``tpu_se_torch.dsp``    — LPS analysis, noisy-phase OLA synthesis, metrics.
- ``tpu_se_torch.ops``    — hand-written Hopper kernels and their plain
                             PyTorch versions (``lps_kernel``).
- ``tpu_se_torch.models`` — the FFN regression model as an ``nn.Module``.
- ``tpu_se_torch.infer``  — batch decode (wav -> enhanced wav + metrics).
- ``tpu_se_torch.parallel`` — data-parallel training over
                             ``torch.distributed``, one process per device.
- ``tpu_se_torch.cli``    — ``python -m tpu_se_torch decode``.
"""

__version__ = "0.1.0"
