"""Models of the port: the decode-mode GPT decoder LM and generation."""

from .convert import init_params, params_from_flax, params_to_flax  # noqa: F401
from .generate import decode_step, generate, prefill  # noqa: F401
from .gpt import (  # noqa: F401
    GPTConfig,
    GPTLM,
    gpt_medium,
    gpt_small,
    gpt_tiny,
    lm_eval,
    lm_loss,
)
