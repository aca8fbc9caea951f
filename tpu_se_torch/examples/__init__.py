"""Example scripts of the port, twins of ``examples/*.py``.

Run them as ``python -m tpu_se_torch.examples.serve_streaming`` and
``python -m tpu_se_torch.examples.demo_pipeline``: the same flags and
defaults as the ``tpu_se`` scripts, plus ``--device`` (``cuda`` unless
told ``cpu``).
"""
