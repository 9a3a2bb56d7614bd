"""Models of the port: the GPT decoder LM (training and decode mode),
generation, and the GPT-MoE LM."""

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
from .gpt_moe import (  # noqa: F401
    GPTMoEConfig,
    GPTMoELM,
    gpt_moe_small,
    gpt_moe_tiny,
    moe_lm_eval,
    moe_lm_loss,
)
