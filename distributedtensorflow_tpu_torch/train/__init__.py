"""Training of the port: state, optimizer, step engine, losses, the
Trainer's fit loop and the sidecar evaluator."""

from .engine import (  # noqa: F401
    accumulate_gradients,
    accumulate_gradients_dp,
    dropout_keys,
    make_eval_step,
    make_multi_train_step,
    make_train_step,
    split_microbatches,
    step_generator,
    step_seed,
)
from .losses import classification_eval, classification_loss  # noqa: F401
from .optimizers import (  # noqa: F401
    adafactor,
    adagrad,
    adamw,
    build_optimizer,
    build_schedule,
    exclude_bias_and_norm_mask,
    lamb,
    lars,
    lion,
    sgd,
    warmup_cosine_decay_schedule,
)
from .sidecar import SidecarEvaluator  # noqa: F401
from .state import TrainState, create_sharded_state  # noqa: F401
from .trainer import (  # noqa: F401
    Callback,
    Trainer,
    TrainerConfig,
    device_memory_stats,
    weighted_evaluate,
)
