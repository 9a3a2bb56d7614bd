"""Models of the port: the GPT decoder LM (training and decode mode),
generation, the GPT-MoE LM, the BASELINE.json models (LeNet-5,
ResNet-20/50, BERT MLM, Wide&Deep), the BERT-MoE encoder, the ViT and the
seq2seq
encoder-decoder (training, teacher-forced eval and cached decoding), and
the NaN-provenance tap forward (:func:`make_nan_taps`)."""

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
from .bert_moe import (  # noqa: F401
    BertMoEConfig,
    BertMoEForMLM,
    bert_moe_base,
    bert_moe_tiny,
    moe_mlm_loss,
)
from .convert import (  # noqa: F401
    flax_modules,
    flax_paths,
    flax_views,
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
    nan_taps,
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
from .seq2seq import (  # noqa: F401
    Seq2SeqConfig,
    Seq2SeqLM,
    seq2seq_eval,
    seq2seq_generate,
    seq2seq_loss,
    seq2seq_small,
    seq2seq_tiny,
    shift_right,
)
from .vit import ViT, ViTConfig, vit_s16, vit_tiny  # noqa: F401
from .widedeep import (  # noqa: F401
    WideDeep,
    WideDeepConfig,
    widedeep_eval,
    widedeep_loss,
    widedeep_test_config,
)


def make_nan_taps(model):
    """The NaN-provenance tap forward for ``obs.dynamics`` (JAX
    ``models/__init__.py:61-71``): ``tap_fn(batch) -> {"NNN_module":
    nonfinite_count}`` with the forward position in the key (``000_wte``,
    ``001_h0``, ...), or None for a model without activation taps
    (provenance then falls back to the model-agnostic parameter and
    gradient censuses).  The GPT LM has taps; the GPT-MoE LM, as in JAX,
    has none."""
    if isinstance(model, GPTLM):
        return nan_taps(model)
    return None
