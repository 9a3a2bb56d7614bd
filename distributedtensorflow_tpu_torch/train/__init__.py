"""Training step of the port: state, optimizer, step engine, losses."""

from .engine import (  # noqa: F401
    accumulate_gradients,
    accumulate_gradients_dp,
    make_eval_step,
    make_train_step,
    split_microbatches,
    step_generator,
)
from .losses import classification_eval, classification_loss  # noqa: F401
from .optimizers import (  # noqa: F401
    adagrad,
    adamw,
    build_optimizer,
    build_schedule,
    exclude_bias_and_norm_mask,
    sgd,
    warmup_cosine_decay_schedule,
)
from .state import TrainState  # noqa: F401
