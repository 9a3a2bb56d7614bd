"""Models of the port: the GPT decoder LM (training and decode mode),
generation, the GPT-MoE LM, and the BASELINE.json models (LeNet-5,
ResNet-20/50, BERT MLM, Wide&Deep)."""

from .bert import (  # noqa: F401
    BertConfig,
    BertForMLM,
    bert_base,
    bert_tiny,
    gathered_positions,
    max_predictions_for,
    mlm_eval,
    mlm_loss,
)
from .convert import (  # noqa: F401
    init_params,
    opt_state_from_optax,
    opt_state_to_optax,
    params_from_flax,
    params_to_flax,
)
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
from .lenet import LeNet5, LeNetConfig  # noqa: F401
from .resnet import (  # noqa: F401
    CifarResNet,
    CifarResNetConfig,
    ImageNetResNet,
    ImageNetResNetConfig,
    ResNet20,
    ResNet50,
)
from .widedeep import (  # noqa: F401
    WideDeep,
    WideDeepConfig,
    widedeep_eval,
    widedeep_loss,
    widedeep_test_config,
)
