from tpu_se_torch.utils.device import resolve_device
from tpu_se_torch.utils.logging import EpochLogger

__all__ = ["EpochLogger", "resolve_device"]
