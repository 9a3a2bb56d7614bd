"""Training step of the port: state, optimizer, step engine."""

from .engine import (  # noqa: F401
    accumulate_gradients,
    make_eval_step,
    make_train_step,
    split_microbatches,
    step_generator,
)
from .optimizers import (  # noqa: F401
    adamw,
    build_optimizer,
    build_schedule,
    exclude_bias_and_norm_mask,
)
from .state import TrainState  # noqa: F401
