from tpu_se_torch.models.ffn import (
    DEFAULT_LAYERSIZES, FFN, init_params, init_params_uniform,
    params_from_numpy, params_to_numpy,
)

__all__ = ["DEFAULT_LAYERSIZES", "FFN", "init_params", "init_params_uniform",
           "params_from_numpy", "params_to_numpy"]
