"""What every ``tpu_se_torch.bench`` measurement module shares.

- ``Reading``: repeated timings of one quantity, reported as the median,
  the quartiles, the sample count and every value; a percentile only
  where at least ten samples lie beyond it.  A timed quantity is taken
  ``REPEATS`` times.
- ``bench_device``: the device a bench runs on.  ``cuda`` (the default of
  every bench) without a card exits non-zero with a message; a bench never
  carries on on the CPU unless ``--device cpu`` asked for it.
- ``layer_sizes``: the ``--layersizes`` argument a test narrows a bench
  with.
- ``device_record``: the device a record names (the card's name, count and
  ``nvidia-smi`` line; ``None`` on the CPU).
- ``host_ops``: where the host's time goes over a window of calls, from
  ``torch.profiler``'s CPU side (the ops of most self time).
- ``emit``: the record as the last line of the output (and in ``--out``),
  and the exit code from its ``checks``: each bench checks its own outputs.
- The published peaks of one NVIDIA H100 SXM at 700 W that the benches'
  ``mfu`` is stated against.  The port's float32 products are IEEE float32
  on the CUDA cores (``resolve_device`` turns TF32 off), so their peak is
  67 TFLOP/s; bfloat16 products run on the tensor cores at 989 TFLOP/s.

Device busy time comes from ``profile_decode.device_profile`` (kernel and
memcpy self time from ``torch.profiler``).
"""

from __future__ import annotations

import json
import sys
import time
from dataclasses import dataclass

import numpy as np
import torch

from tpu_se_torch.bench.fixtures import card_line
from tpu_se_torch.utils import resolve_device

PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
TAIL_SAMPLES = 10       # samples that must lie beyond a reported percentile
REPEATS = 5             # timings of each timed quantity


@dataclass(frozen=True)
class Reading:
    """Repeated values of one quantity, in the order they were taken."""
    values: tuple

    def __post_init__(self):
        object.__setattr__(self, "values", tuple(float(v)
                                                 for v in self.values))
        if not self.values:
            raise ValueError("a reading needs at least one value")

    @property
    def n(self) -> int:
        return len(self.values)

    @property
    def median(self) -> float:
        return float(np.median(self.values))

    def percentile(self, q: float) -> float | None:
        """The q-th percentile, or ``None`` when fewer than
        ``TAIL_SAMPLES`` values lie beyond it."""
        if self.n * (100.0 - q) / 100.0 < TAIL_SAMPLES:
            return None
        return float(np.percentile(self.values, q))

    def record(self) -> dict:
        q1, q3 = np.percentile(self.values, [25, 75])
        return {"median": self.median, "q1": float(q1), "q3": float(q3),
                "n": self.n, "values": list(self.values)}


def layer_sizes(text: str) -> tuple:
    """``--layersizes`` ("1799,64,257") -> the tuple of widths."""
    return tuple(int(x) for x in text.split(","))


def bench_device(name: str, prog: str) -> torch.device:
    """``--device`` -> the device; without a card, a ``cuda`` request
    exits non-zero with a message instead of falling back to the CPU."""
    if torch.device(name).type == "cuda" and not torch.cuda.is_available():
        raise SystemExit(f"{prog}: needs a CUDA card (torch.cuda."
                         f"is_available() is false); --device cpu runs it "
                         f"on the CPU, with null device fields")
    return resolve_device(name)


def device_record(device: torch.device) -> dict:
    """The device a record's numbers come from."""
    if device.type != "cuda":
        return {"platform": "cpu", "kind": None, "count": None,
                "card": None}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": torch.cuda.device_count(), "card": card_line()}


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def wall_s(fn, device: torch.device) -> float:
    """Host seconds of ``fn()``, ending in a synchronise of ``device``."""
    sync(device)
    t0 = time.perf_counter()
    fn()
    sync(device)
    return time.perf_counter() - t0


def host_ops(fn, iters: int, device: torch.device, top: int = 8) -> dict:
    """Host wall ms per call of ``fn`` over ``iters`` calls under
    ``torch.profiler`` (CPU activity only), and the ``top`` host ops by
    self time, in us per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wall = wall_s(lambda: [fn() for _ in range(iters)], device)
    ops = sorted((e for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU),
                 key=lambda e: -e.self_cpu_time_total)[:top]
    return {"wall_ms": wall / iters * 1e3,
            "host_self_us": {e.key: e.self_cpu_time_total / iters
                             for e in ops}}


def on_card(device: torch.device, value):
    """``value`` on a card, ``None`` on the CPU: a device-only field."""
    return value if device.type == "cuda" else None


def emit(record: dict, out: str | None) -> int:
    """Print ``record`` as one JSON line, the last of the output, and write
    it to ``out`` if given -> 0, or 1 when one of its ``checks`` failed."""
    line = json.dumps(record)
    if out:
        with open(out, "w") as f:
            f.write(line + "\n")
    failed = [name for name, ok in record["checks"].items() if not ok]
    if failed:
        print(f"{record['metric']}: failed checks {failed}", file=sys.stderr)
    print(line)
    return 1 if failed else 0
