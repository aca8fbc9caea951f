"""Per-epoch training logs, as ``tpu_se.utils.EpochLogger`` writes them.

The reference logs a per-epoch text file (config echo, chunk progress, CV
metrics; ``Interface.cc:338-371``, ``BPtrain.cc:96,132-139``).
``EpochLogger`` writes that file as ``mlp.N.log`` and appends one JSON
record per epoch to ``metrics.jsonl``; the lines and records are the JAX
package's apart from the times and the config fields the port leaves out.
"""

from __future__ import annotations

import json
import logging
import os
import time


def get_logger(name: str = "tpu_se_torch") -> logging.Logger:
    """A stream logger at INFO with the package's line format; repeated
    calls return the same logger without adding handlers."""
    logger = logging.getLogger(name)
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
        logger.setLevel(logging.INFO)
    return logger


class EpochLogger:
    """Per-epoch text log + appended metrics.jsonl, reference-style."""

    def __init__(self, out_dir: str, epoch: int):
        self.out_dir = out_dir
        self.epoch = epoch
        self.lines: list[str] = []
        self.t0 = time.time()
        os.makedirs(out_dir, exist_ok=True)

    def __call__(self, line: str) -> None:
        self.lines.append(line)

    def config(self, cfg) -> None:
        self("---- config ----")
        for k, v in sorted(vars(cfg).items()):
            self(f"{k} = {v}")
        self("----------------")

    def finish(self, metrics: dict) -> None:
        dt = time.time() - self.t0
        self(f"CV squared error: {metrics.get('cv_squared_error', 0):.6f}")
        self(f"CV abs error: {metrics.get('cv_abs_error', 0):.6f}")
        self(f"CV GGD loglik: {metrics.get('cv_ggd_loglik', 0):.6f}")
        self(f"Total cost time: {dt:.1f} s")
        with open(os.path.join(self.out_dir, f"mlp.{self.epoch}.log"),
                  "w") as f:
            f.write("\n".join(self.lines) + "\n")
        record = {"epoch": self.epoch, "wall_time_s": round(dt, 2), **metrics}
        with open(os.path.join(self.out_dir, "metrics.jsonl"), "a") as f:
            f.write(json.dumps(record) + "\n")
