"""Measurement helpers for the port: synthetic decode fixtures, CUDA-event
timing, and ``python -m tpu_se_torch.bench.profile_decode``."""
