from tpu_se_torch.utils.device import resolve_compute_dtype, resolve_device
from tpu_se_torch.utils.logging import EpochLogger, get_logger
from tpu_se_torch.utils.profiling import StepTimer, profile_trace

__all__ = ["EpochLogger", "get_logger", "resolve_device",
           "resolve_compute_dtype", "profile_trace", "StepTimer"]
