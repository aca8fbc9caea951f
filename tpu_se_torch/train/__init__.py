"""Training: the ML-GGD / beta-norm step, optimizer, checkpoints and the
epoch loop -- the port of ``tpu_se.train``, for one device or, with
``tpu_se_torch.parallel``, a data mesh of them."""

from tpu_se_torch.train.checkpoint import load_checkpoint, save_checkpoint
from tpu_se_torch.train.loop import (
    CV_BATCH, TrainConfig, evaluate_cv, load_device_frames, run_training,
    train_one_epoch,
)
from tpu_se_torch.train.optim import sgd_momentum_init, sgd_momentum_update
from tpu_se_torch.train.step import (
    TrainHyper, TrainState, cv_chunk_metrics, cv_forward, gather_splice,
    make_train_state, param_layers, train_chunk,
)

__all__ = [
    "sgd_momentum_init", "sgd_momentum_update",
    "TrainHyper", "TrainState", "make_train_state", "param_layers",
    "train_chunk", "cv_forward", "cv_chunk_metrics", "gather_splice",
    "save_checkpoint", "load_checkpoint",
    "CV_BATCH", "TrainConfig", "run_training", "train_one_epoch",
    "evaluate_cv", "load_device_frames",
]
