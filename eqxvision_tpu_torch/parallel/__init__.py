"""Training on one card (eqxvision_tpu/parallel/): the train, scan and eval
steps and the EMA. The mesh and multi-host halves are not ported yet
(ROADMAP A.11b)."""
from .ema import ema_init, ema_params, ema_update
from .train import (
    evaluate,
    make_eval_step,
    make_scan_epoch,
    make_train_step,
    param_groups,
    softmax_cross_entropy,
)

__all__ = [
    "ema_init",
    "ema_params",
    "ema_update",
    "evaluate",
    "make_eval_step",
    "make_scan_epoch",
    "make_train_step",
    "param_groups",
    "softmax_cross_entropy",
]
