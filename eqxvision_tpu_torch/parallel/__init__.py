"""Training and evaluation (eqxvision_tpu/parallel/): the train, scan and
eval steps and the EMA on one card, and on several processes the
(data, model) mesh with synchronised BatchNorm and Megatron tensor
parallel, multi-process evaluation and ``launch``'s worlds of local
processes."""
from .ema import ema_init, ema_params, ema_update
from .mesh import (
    Mesh,
    Shard,
    all_reduce_grads,
    join_state_dicts,
    make_mesh,
    param_shardings,
    parallelize,
    replicate,
    seed_rank,
    shard_batch,
    shard_params_tp,
    shard_state_dict,
    sync_batchnorm,
    tp_spec_for_path,
)
from .multihost import evaluate_multihost, local_shard, make_global_eval_step, process_count, process_index
from .multihost import initialize as initialize_multihost
from .train import (
    evaluate,
    make_eval_step,
    make_scan_epoch,
    make_train_step,
    param_groups,
    softmax_cross_entropy,
)

__all__ = [
    "Mesh",
    "Shard",
    "all_reduce_grads",
    "ema_init",
    "ema_params",
    "ema_update",
    "evaluate",
    "evaluate_multihost",
    "initialize_multihost",
    "join_state_dicts",
    "local_shard",
    "make_eval_step",
    "make_global_eval_step",
    "make_mesh",
    "make_scan_epoch",
    "make_train_step",
    "param_groups",
    "param_shardings",
    "parallelize",
    "process_count",
    "process_index",
    "replicate",
    "seed_rank",
    "shard_batch",
    "shard_params_tp",
    "shard_state_dict",
    "softmax_cross_entropy",
    "sync_batchnorm",
    "tp_spec_for_path",
]
