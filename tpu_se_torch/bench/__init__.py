"""Measurement entry points of the port, each run as ``python -m
tpu_se_torch.bench.<name>`` on the card (``--device cpu`` on the CPU):

- the ports of the reference's measurement tools, each ending in one JSON
  record headed by the reference's metric: ``train`` (``bench.py``),
  ``decode``, ``stream``, ``loader``, ``build`` and ``scaling``
  (``tools/bench_*.py``), with what they share in ``timing``;
- ``profile_decode`` (where a batched decode's device time goes),
  ``dp_epoch`` (one rank's timed training epoch), ``overlap_cards``,
  ``mesh_decode`` and ``sweep_ggd``;
- ``fixtures``: the synthetic inputs and CUDA-event timing that
  ``chip_smoke.py`` and the benches share."""
