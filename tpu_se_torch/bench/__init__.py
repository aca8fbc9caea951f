"""Measurement helpers for the port: synthetic decode fixtures, CUDA-event
timing, ``python -m tpu_se_torch.bench.profile_decode``, and ``python -m
tpu_se_torch.bench.dp_epoch`` (one rank's timed training epoch)."""
