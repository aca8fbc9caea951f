"""tpu_se_torch.utils.profiling: ``StepTimer`` against ``tpu_se``'s on the
same recorded times (the same dict, exactly), and ``profile_trace`` writing
a Chrome trace of a training bunch on the CPU.  The card's side of the
trace (CUDA kernels in it) is checked by ``chip_smoke.py``.
"""

import json
import logging
import time

import numpy as np
import pytest
import torch

from tpu_se.utils import StepTimer as JaxStepTimer
from tpu_se_torch import train
from tpu_se_torch.models import init_params, params_from_numpy
from tpu_se_torch.utils import StepTimer, get_logger, profile_trace


@pytest.mark.parametrize("times", [[], [0.25], [0.003, 0.001, 0.002],
                                   [0.5, 0.1, 0.4, 0.2]], ids=len)
def test_step_timer_summary_matches_tpu_se(times):
    ours, theirs = StepTimer(), JaxStepTimer()
    ours.times, theirs.times = list(times), list(times)
    assert ours.summary() == theirs.summary()
    assert ours.summary()["count"] == len(times)


def test_step_timer_times_a_block():
    timer = StepTimer()
    for _ in range(3):
        with timer:
            time.sleep(0.002)
    summary = timer.summary()
    assert summary["count"] == 3 and timer._t0 is None
    assert 2.0 <= summary["min_ms"] <= summary["p50_ms"] <= summary["max_ms"]
    assert summary["min_ms"] <= summary["mean_ms"] <= summary["max_ms"]
    with pytest.raises(ZeroDivisionError):      # the block's error goes on
        with timer:
            1 / 0
    assert timer.summary()["count"] == 4


def test_profile_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    rng = np.random.default_rng(0)
    layers = init_params(1, (15, 11, 5))
    state = train.make_train_state(params_from_numpy(layers, "cpu"))
    noisy = torch.from_numpy(rng.normal(size=(40, 5)).astype(np.float32))
    starts = torch.from_numpy(rng.integers(0, 37, (1, 8)))
    hyper = train.TrainHyper(bunchsize=8, context=3, targ_offset=1,
                             compute_dtype="bfloat16")
    log_dir = tmp_path / "traces" / "run"
    with profile_trace(str(log_dir)):
        train.train_chunk(state, noisy, noisy * 0.8, starts, 0.05, hyper)
    files = list(log_dir.glob("*.pt.trace.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::sigmoid" in names and "_ReducedLinear" in names
    with pytest.raises(KeyError):               # written on an error too
        with profile_trace(str(log_dir)):
            {}["missing"]
    assert len(list(log_dir.glob("*.pt.trace.json"))) == 2


def test_get_logger_adds_one_handler():
    name = "tpu_se_torch.test_profiling"
    logger = get_logger(name)
    assert get_logger(name) is logger
    assert len(logger.handlers) == 1 and logger.level == logging.INFO
    assert get_logger().name == "tpu_se_torch"
