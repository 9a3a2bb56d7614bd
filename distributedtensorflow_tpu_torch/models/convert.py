"""Parameters for the port's models: from and to a JAX tree, or seeded.

GPT (``GPTLM`` and ``GPTMoELM``):

``params_from_flax`` and ``init_params`` return a ``state_dict`` of fp32
CPU tensors for the model's ``load_state_dict``; ``params_to_flax`` maps
such a dict (or one of gradients, by parameter name) back to the JAX
tree.  The JAX tree is the nested dict of arrays that the JAX model's
``init`` returns under ``"params"`` (numpy arrays, or anything
``np.asarray`` takes); nothing of JAX is imported here.  Flax Dense
kernels are (in, out) and become (out, in) ``nn.Linear`` weights;
embedding, LayerNorm and the MoE blocks' ``moe_mlp/router``,
``experts_in`` and ``experts_out`` parameters keep their shapes.  The
config says which tree: a ``GPTMoEConfig`` has MoE blocks where
``is_moe_layer`` says so, GPT blocks elsewhere.

The BASELINE models (``LeNet5``, ``CifarResNet``, ``ImageNetResNet``,
``BertForMLM``, ``WideDeep``), the ``BertMoEForMLM`` and the ``ViT`` and
``Seq2SeqLM`` (their configs select them) name their submodules as the
flax tree does, so a parameter's path is its name (a MoE block's
``moe_mlp/router``, ``experts_in`` and ``experts_out`` keep their
shapes).
For them the JAX tree is the whole flax variables dict, ``{"params":
...}`` plus ``"batch_stats"`` (BatchNorm's running ``mean`` and ``var``,
the port's buffers) for the ResNets, and the state holds the buffers too.
Conv kernels are (kh, kw, in, out) in flax and (out, in, kh, kw) here;
Dense kernels (in, out) are (out, in), the ``DenseGeneral`` kernels of
BERT's and seq2seq's attention ((E, H, D), (E, Hkv, D) and (H, D, E))
and biases ((H, D)) flattened to that matrix; embedding tables are
``embedding`` in flax and ``weight`` here; the ViT's ``pos_embed`` and
the RMSNorm ``scale`` keep their shapes.

Optimizer state: ``opt_state_from_optax`` gives the ``state_dict`` of a
port optimizer (``train.optimizers``) for the optax state of its JAX twin
(``build_optimizer``'s chains: sgd, nesterov momentum, adam, adamw with
or without its decay mask, adagrad, each behind ``clip_by_global_norm``
or not, and lamb, lars, adafactor and lion), and ``opt_state_to_optax``
the optax state for a port optimizer, so a run can move from one package
to the other mid-way.
The optax ``count`` is the parameter groups' ``"count"`` (and AdamW's
``step``, which ``load_state_dict`` moves to the card for a capturable
AdamW); ``mu``/``nu``, the momentum ``trace`` and adagrad's
``sum_of_squares`` are AdamW's (and LAMB's) ``exp_avg``/``exp_avg_sq``,
SGD's (and LARS's) ``momentum_buffer``, :class:`~..train.optimizers.
Adagrad`'s ``sos`` and Lion's ``exp_avg``, each a tree of the parameters
mapped as the parameters are; adafactor's factored ``v_row``, ``v_col``
and ``v`` are kept in the flax layout (:func:`flax_views`) and move leaf
for leaf.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .bert import BertConfig, BertForMLM
from .bert_moe import BertMoEConfig, BertMoEForMLM
from .gpt import GPTConfig
from .gpt_moe import GPTMoEConfig, MoEMLP
from .layers import BatchNorm, Conv, Dense, FusedLayerNorm, RMSNorm
from .lenet import LeNet5, LeNetConfig
from .resnet import (
    CifarResNet,
    CifarResNetConfig,
    ImageNetResNet,
    ImageNetResNetConfig,
)
from .seq2seq import Seq2SeqConfig, Seq2SeqLM
from .vit import ViT, ViTConfig
from .widedeep import WideDeep, WideDeepConfig

#: The models whose submodules carry the flax names, by their config's
#: class.
MODELS = {LeNetConfig: LeNet5, CifarResNetConfig: CifarResNet,
          ImageNetResNetConfig: ImageNetResNet, BertConfig: BertForMLM,
          WideDeepConfig: WideDeep, ViTConfig: ViT,
          Seq2SeqConfig: Seq2SeqLM, BertMoEConfig: BertMoEForMLM}
#: Modules that hold parameters of their own: the flax layers' twins, the
#: routed MLP and the ViT (its ``pos_embed``).
_LEAF_MODULES = (BatchNorm, Conv, Dense, FusedLayerNorm, RMSNorm,
                 nn.Embedding, MoEMLP, ViT)


def _shapes(cfg: GPTConfig) -> dict[str, tuple[int, ...]]:
    """Port parameter name -> (out, in) shape for dense weights, the
    tensor shape otherwise."""
    e, f = cfg.hidden_size, cfg.intermediate_size
    q, kv = cfg.num_heads * cfg.head_dim, cfg.kv_heads * cfg.head_dim
    attn = {"attn.qkv.weight": (q + 2 * kv, e), "attn.proj.weight": (e, q)}
    mlp = {"fc_in.weight": (f, e), "fc_out.weight": (e, f)}
    moe = isinstance(cfg, GPTMoEConfig)
    if moe:
        n = cfg.n_experts
        moe_mlp = {"moe_mlp.router": (e, n), "moe_mlp.experts_in": (n, e, f),
                   "moe_mlp.experts_out": (n, f, e)}
    shapes = {"wte.weight": (cfg.vocab_size, e),
              "ln_f.scale": (e,), "ln_f.bias": (e,)}
    for i in range(cfg.num_layers):
        for ln in ("ln1", "ln2"):
            shapes[f"h.{i}.{ln}.scale"] = (e,)
            shapes[f"h.{i}.{ln}.bias"] = (e,)
        ffn = moe_mlp if moe and cfg.is_moe_layer(i) else mlp
        for name, shape in {**attn, **ffn}.items():
            shapes[f"h.{i}.{name}"] = shape
    return shapes


def _flax_path(name: str) -> tuple[tuple[str, ...], bool]:
    """Port parameter name -> (path in the flax tree, is a Dense kernel)."""
    if name == "wte.weight":
        return ("wte", "embedding"), False
    parts = name.split(".")
    if parts[0] == "h":
        parts = [f"h{parts[1]}"] + parts[2:]
    if parts[-1] == "weight":
        return tuple(parts[:-1]) + ("kernel",), True
    return tuple(parts), False


def _leaves(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, prefix + (key,))
        else:
            yield prefix + (key,)


def _baseline_leaves(cfg):
    """Port state name -> (flax path, owning module, attribute) for a
    model of :data:`MODELS`, read from the model built on the meta
    device."""
    model = MODELS[type(cfg)](cfg, device="meta")
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        tensors = list(mod.named_parameters(recurse=False)) \
            + list(mod.named_buffers(recurse=False))
        if tensors and not isinstance(mod, _LEAF_MODULES):
            raise TypeError(f"{mod_name}: no flax twin for {type(mod)}")
        for attr, _ in tensors:
            leaf = attr
            if isinstance(mod, nn.Embedding):
                leaf = "embedding"
            elif attr == "weight":
                leaf = "kernel"
            coll = "batch_stats" if attr in ("mean", "var") else "params"
            out[".".join(prefix + (attr,))] = ((coll,) + prefix + (leaf,),
                                               mod, attr)
    return out


def _to_port(arr, mod, attr):
    """A flax leaf as the port's tensor of ``mod.attr``."""
    if isinstance(mod, Conv) and attr == "weight":
        return arr.transpose(3, 2, 0, 1)
    if isinstance(mod, Dense) and attr == "weight":
        if arr.shape != mod.kernel_shape:
            raise ValueError(f"shape {arr.shape}, expected {mod.kernel_shape}")
        return arr.reshape(mod.in_features, mod.out_features).T
    if isinstance(mod, Dense) and attr == "bias":
        if arr.shape != mod.bias_shape:
            raise ValueError(f"shape {arr.shape}, expected {mod.bias_shape}")
        return arr.reshape(mod.out_features)
    return arr


def _to_flax(arr, mod, attr):
    """The inverse of :func:`_to_port`."""
    if isinstance(mod, Conv) and attr == "weight":
        return arr.transpose(2, 3, 1, 0)
    if isinstance(mod, Dense) and attr == "weight":
        return arr.T.reshape(mod.kernel_shape)
    if isinstance(mod, Dense) and attr == "bias":
        return arr.reshape(mod.bias_shape)
    return arr


def _baseline_from_flax(variables, cfg, params_only=False
                        ) -> dict[str, torch.Tensor]:
    state, used = {}, set()
    for name, (path, mod, attr) in _baseline_leaves(cfg).items():
        if params_only and path[0] != "params":
            continue
        leaf = variables
        for key in path:
            if not isinstance(leaf, Mapping) or key not in leaf:
                raise ValueError(f"the variables have no {'/'.join(path)}")
            leaf = leaf[key]
        try:
            arr = _to_port(np.asarray(leaf, dtype=np.float32), mod, attr)
        except ValueError as e:
            raise ValueError(f"{'/'.join(path)}: {e}") from None
        want = tuple(getattr(mod, attr).shape)
        if arr.shape != want:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {want} for {name}")
        state[name] = torch.tensor(np.ascontiguousarray(arr))
        used.add(path)
    extra = [p for p in _leaves(variables) if p not in used]
    if extra:
        raise ValueError(f"unexpected variables in the tree: {extra}")
    return state


def _baseline_to_flax(state, cfg) -> dict:
    leaves = _baseline_leaves(cfg)
    extra = sorted(set(state) - set(leaves))
    if extra:
        raise ValueError(f"unexpected parameters in the state: {extra}")
    tree: dict = {}
    for name, (path, mod, attr) in leaves.items():
        if name not in state:
            if path[0] == "batch_stats":
                continue  # gradients carry no running statistics
            raise ValueError(f"the state has no {name}")
        arr = state[name].detach().to("cpu", torch.float32).numpy()
        if tuple(arr.shape) != tuple(getattr(mod, attr).shape):
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{tuple(getattr(mod, attr).shape)}")
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(_to_flax(arr, mod, attr))
    return tree


def _baseline_init(cfg, generator) -> dict[str, torch.Tensor]:
    state = {}
    for name, (_, mod, attr) in _baseline_leaves(cfg).items():
        shape = tuple(getattr(mod, attr).shape)
        if isinstance(mod, nn.Embedding):
            t = torch.randn(shape, generator=generator) / math.sqrt(shape[1])
        elif attr in ("pos_embed", "router"):
            t = torch.randn(shape, generator=generator) * 0.02
        elif attr.startswith("experts_"):  # fan-in E x in, as flax's
            t = torch.randn(shape, generator=generator) \
                / math.sqrt(shape[0] * shape[1])
        elif attr == "weight":
            t = torch.randn(shape, generator=generator) \
                / math.sqrt(math.prod(shape[1:]))
        elif attr in ("scale", "var"):
            t = torch.zeros(shape) if getattr(mod, "zero_scale", False) \
                and attr == "scale" else torch.ones(shape)
        else:  # biases, running means
            t = torch.zeros(shape)
        state[name] = t
    return state


def params_from_flax(tree, cfg) -> dict[str, torch.Tensor]:
    """The port's state for the JAX model's ``tree``: the parameter tree
    for a GPT config, the whole variables dict for a model of
    :data:`MODELS`.
    Raises when a leaf is missing, left over or of the wrong shape."""
    if type(cfg) in MODELS:
        return _baseline_from_flax(tree, cfg)
    state = {}
    used = set()
    for name, shape in _shapes(cfg).items():
        path, is_kernel = _flax_path(name)
        leaf = tree
        for key in path:
            if not isinstance(leaf, Mapping) or key not in leaf:
                raise ValueError(f"the tree has no {'/'.join(path)}")
            leaf = leaf[key]
        arr = np.asarray(leaf, dtype=np.float32)
        if is_kernel:
            arr = arr.T
        if arr.shape != shape:
            raise ValueError(f"{'/'.join(path)}: shape {arr.shape}, "
                             f"expected {shape} for {name}")
        state[name] = torch.tensor(arr)  # a copy the port owns
        used.add(path)

    extra = [p for p in _leaves(tree) if p not in used]
    if extra:
        raise ValueError(f"unexpected parameters in the tree: {extra}")
    return state


def params_to_flax(state, cfg) -> dict:
    """The JAX model's parameter tree (nested dicts of fp32 numpy
    arrays) for the port's ``state`` (parameter name -> tensor): the
    inverse of :func:`params_from_flax`, so gradients compare leaf by
    leaf.  For a model of :data:`MODELS` the variables dict; a state
    without the running statistics (gradients) gives one without
    ``batch_stats``.
    Raises when a name is missing, left over or misshapen."""
    if type(cfg) in MODELS:
        return _baseline_to_flax(state, cfg)
    shapes = _shapes(cfg)
    extra = sorted(set(state) - set(shapes))
    if extra:
        raise ValueError(f"unexpected parameters in the state: {extra}")
    tree: dict = {}
    for name, shape in shapes.items():
        if name not in state:
            raise ValueError(f"the state has no {name}")
        arr = state[name].detach().to("cpu", torch.float32).numpy()
        if tuple(arr.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(arr.shape)}, expected "
                             f"{shape}")
        path, is_kernel = _flax_path(name)
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = np.array(arr.T if is_kernel else arr)
    return tree


def init_params(cfg, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """Seeded random state on the CPU: normal embeddings and dense
    weights at std 1/sqrt(fan_in) (flax's default scales, untruncated;
    flax counts a stacked (E, in, out) expert kernel's fan-in as E x
    in), routers at std 0.02 as flax's ``normal(0.02)``, LayerNorm scale
    1 and bias 0.  The BASELINE models, the ViT and the seq2seq LM: conv
    weights at std 1/sqrt(in x kh x kw), embedding tables at
    1/sqrt(width) (flax's ``Embed`` default), the ViT's ``pos_embed`` at
    0.02 (its ``normal(0.02)``), biases 0, BatchNorm, LayerNorm and
    RMSNorm scales 1 (0 where flax starts one at 0), running mean 0 and
    variance 1; the BERT-MoE's routers and experts as GPT-MoE's."""
    if type(cfg) in MODELS:
        return _baseline_init(cfg, generator)
    state = {}
    for name, shape in _shapes(cfg).items():
        if name.endswith(".scale"):
            state[name] = torch.ones(shape)
        elif name.endswith(".bias"):
            state[name] = torch.zeros(shape)
        else:
            std = 0.02 if name.endswith(".router") else \
                1.0 / math.sqrt(shape[0] * shape[1] if len(shape) == 3
                                else shape[1])
            state[name] = torch.randn(shape, generator=generator) * std
    return state


def _param_leaves(cfg) -> dict[str, tuple]:
    """Port parameter name -> ``(path in the flax params tree, perm,
    flax shape)``: the flax leaf is the port tensor permuted by ``perm``
    and reshaped to that shape."""
    out = {}
    if type(cfg) in MODELS:
        for name, (path, mod, attr) in _baseline_leaves(cfg).items():
            if path[0] != "params":
                continue
            shape = tuple(getattr(mod, attr).shape)
            perm = tuple(range(len(shape)))
            if isinstance(mod, Conv) and attr == "weight":
                perm = (2, 3, 1, 0)
                shape = tuple(shape[i] for i in perm)
            elif isinstance(mod, Dense) and attr == "weight":
                perm, shape = (1, 0), tuple(mod.kernel_shape)
            elif isinstance(mod, Dense) and attr == "bias":
                shape = tuple(mod.bias_shape)
            out[name] = (path[1:], perm, shape)
        return out
    for name, shape in _shapes(cfg).items():
        path, is_kernel = _flax_path(name)
        out[name] = (path, (1, 0), shape[::-1]) if is_kernel \
            else (path, tuple(range(len(shape))), shape)
    return out


def flax_paths(cfg) -> dict[str, tuple[str, ...]]:
    """Port parameter name -> its path in the flax ``params`` tree."""
    return {n: path for n, (path, _, _) in _param_leaves(cfg).items()}


def flax_modules(cfg) -> dict[str, str]:
    """Port parameter name -> the first component of its path in the flax
    ``params`` tree (``wte``, ``h0``, ``ln_f``, a BERT's ``bert``, a
    ResNet's ``conv_init``, ...): the top-level module that
    ``obs.dynamics`` groups by, so every ``module=`` label is the JAX
    package's."""
    return {n: path[0] for n, (path, _, _) in _param_leaves(cfg).items()}


def flax_views(cfg) -> dict[str, tuple[tuple[int, ...], tuple[int, ...]]]:
    """Port parameter name -> ``(perm, shape)``: the parameter's flax
    layout is ``p.permute(perm).reshape(shape)``.  Adafactor
    (``train.optimizers``) factors its second moments over the flax
    layout's two largest dims, as optax does, and keeps them in it."""
    return {n: (perm, shape)
            for n, (_, perm, shape) in _param_leaves(cfg).items()}


# ------------------------------------------------------------- optimizers

#: optax moment field -> the port optimizer's state slot.
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer",
            "sum_of_squares": "sos"}
#: adafactor's factored moments: the same names in both, flax layouts.
_FACTORED = ("v_row", "v_col", "v")


def _params_from(tree, cfg) -> dict[str, torch.Tensor]:
    """A tree shaped like the JAX parameters (the ``params`` collection)
    by port parameter name."""
    if type(cfg) in MODELS:
        return _baseline_from_flax({"params": tree}, cfg, params_only=True)
    return params_from_flax(tree, cfg)


def _params_to(named, cfg) -> dict:
    if type(cfg) in MODELS:
        return _baseline_to_flax(named, cfg)["params"]
    return params_to_flax(named, cfg)


def _optax_parts(state, out: dict) -> dict:
    """``count`` and the moment trees of an optax state (nested chain
    tuples of NamedTuples, ``MaskedState`` included), by field name."""
    fields = getattr(state, "_fields", None)
    if fields is not None:
        for field in fields:
            val = getattr(state, field)
            if field == "count":
                out.setdefault("count", int(np.asarray(val)))
            elif field in _MOMENTS or field in _FACTORED:
                out[field] = val
            else:
                _optax_parts(val, out)
    elif isinstance(state, (tuple, list)):
        for val in state:
            _optax_parts(val, out)
    return out


def _slots(optimizer) -> tuple[str, ...]:
    """The optax moment fields the port optimizer keeps per parameter."""
    from ..train.optimizers import (
        SGD,
        Adafactor,
        Adagrad,
        Lamb,
        Lars,
        Lion,
    )

    if isinstance(optimizer, (torch.optim.AdamW, Lamb)):
        return ("mu", "nu")
    if isinstance(optimizer, Adagrad):
        return ("sum_of_squares",)
    if isinstance(optimizer, Lion):
        return ("mu",)
    if isinstance(optimizer, Adafactor):
        return _FACTORED
    if isinstance(optimizer, Lars):
        return ("trace",)
    if isinstance(optimizer, (SGD, torch.optim.SGD)):
        momentum = optimizer.param_groups[0]["momentum"]
        return ("trace",) if momentum else ()
    raise TypeError(f"no optax twin for {type(optimizer).__name__}")


def opt_state_from_optax(opt_state, cfg, optimizer, model) -> dict:
    """The ``state_dict`` of ``optimizer`` (a port optimizer over
    ``model``'s parameters) for ``opt_state``, the optax state of its JAX
    twin over the JAX model's parameters; ``optimizer.load_state_dict``
    takes it.  The count becomes every parameter group's ``"count"``
    (optax keeps none for a constant-rate sgd, whose count then stays as
    it is: no update reads it).  Raises when the optax state lacks a
    moment the optimizer keeps."""
    parts = _optax_parts(opt_state, {})
    fields = _slots(optimizer)
    missing = [f for f in fields if f not in parts]
    if missing:
        raise ValueError(f"the optax state has no {missing} for "
                         f"{type(optimizer).__name__}")
    trees = {f: _factored_from(parts[f], cfg) if f in _FACTORED
             else _params_from(parts[f], cfg) for f in fields}
    count = parts.get("count")
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd = optimizer.state_dict()
    sd["state"] = {}
    for i, p in enumerate(params):
        entry = {_MOMENTS.get(f, f): trees[f][names[id(p)]] for f in fields}
        if _counts_on_device(optimizer):
            entry["step"] = torch.tensor(float(count or 0))
        if entry:
            sd["state"][i] = entry
    if count is not None:
        for group in sd["param_groups"]:
            group["count"] = count
    return sd


def _counts_on_device(optimizer) -> bool:
    """The optimizers that keep optax's count per parameter (``"step"``)."""
    from ..train.optimizers import Adafactor, Lamb

    return isinstance(optimizer, (torch.optim.AdamW, Lamb, Adafactor))


def _factored_from(tree, cfg) -> dict[str, torch.Tensor]:
    """An adafactor moment tree (flax layout, any leaf shapes) by port
    parameter name, leaf for leaf."""
    out = {}
    for name, (path, _, _) in _param_leaves(cfg).items():
        leaf = tree
        for key in path:
            leaf = leaf[key]
        out[name] = torch.tensor(np.array(leaf, dtype=np.float32))
    return out


def _factored_to(state, cfg) -> dict:
    tree: dict = {}
    for name, (path, _, _) in _param_leaves(cfg).items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = state[name].detach().to("cpu", torch.float32).numpy()
    return tree


def opt_state_to_optax(optimizer, cfg, model, like):
    """The optax state of ``optimizer``'s JAX twin, in the structure of
    ``like`` (that twin's ``init``; NamedTuples are rebuilt with
    ``_replace``, so nothing of optax is imported): the inverse of
    :func:`opt_state_from_optax`.  A moment the optimizer has not made yet
    (no update so far) is optax's initial value: 0, or 0.1 for adagrad's
    sum of squares."""
    count = optimizer.param_groups[0].get("count", 0)
    named = dict(model.named_parameters())

    def moments(field, like_tree):
        if field in _FACTORED:
            # before the first update, optax's zeros from ``like``
            have = _factored_from(like_tree, cfg)
            return _factored_to({
                n: optimizer.state.get(p, {}).get(field, have[n])
                for n, p in named.items()}, cfg)
        slot = _MOMENTS[field]
        return _params_to({
            n: optimizer.state[p][slot] if slot in optimizer.state.get(p, {})
            else torch.full_like(p, 0.1 if field == "sum_of_squares" else 0.0)
            for n, p in named.items()}, cfg)

    def rebuild(state):
        fields = getattr(state, "_fields", None)
        if fields is not None:
            if not fields:
                return state
            return state._replace(**{
                f: np.asarray(count, np.asarray(getattr(state, f)).dtype)
                if f == "count"
                else moments(f, getattr(state, f))
                if f in _MOMENTS or f in _FACTORED
                else rebuild(getattr(state, f)) for f in fields})
        if isinstance(state, tuple):
            return tuple(rebuild(v) for v in state)
        return state

    return rebuild(like)


# ------------------------------------------------------------- scale-out


def _model_for(cfg, device="cpu"):
    """A model of ``cfg``'s class (the GPT LMs, or one of :data:`MODELS`)."""
    from .gpt import GPTLM
    from .gpt_moe import GPTMoELM

    if type(cfg) in MODELS:
        return MODELS[type(cfg)](cfg, device=device)
    return (GPTMoELM if isinstance(cfg, GPTMoEConfig) else GPTLM)(
        cfg, device=device)


def _map_tree(fn, tree):
    """``fn`` on every leaf of a nested dict."""
    return {k: _map_tree(fn, v) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def pipeline_state(state: dict, cfg, *, stage: int, n_stages: int,
                   n_virtual: int = 1) -> dict:
    """Pipe rank ``stage``'s entries of a whole GPT ``state``: its
    blocks (``models.gpt_pipeline.stage_layers``), the table and
    ``ln_f``: what its ``PipelinedGPT`` loads."""
    from .gpt_pipeline import stage_layers

    held = {i for chunk in stage_layers(cfg.num_layers, n_stages, n_virtual,
                                        stage) for i in chunk}
    return {k: v for k, v in state.items()
            if not k.startswith("h.") or int(k.split(".")[1]) in held}


def pipeline_params_from_flax(tree, cfg, *, stage: int, n_stages: int,
                              n_virtual: int = 1) -> dict:
    """Pipe rank ``stage``'s state from the JAX ``PipelinedGPT``'s
    parameter tree: ``wte``, ``ln_f`` and ``blocks``, each block leaf
    stacked ``(n_stages, lps, ...)``, or ``(n_virtual, n_stages, lps,
    ...)`` for the circular layouts (layer ``(c*n + p)*lps + j`` at
    ``[c, p, j]``, JAX's ``params_to_dense``)."""
    return pipeline_state(
        params_from_flax(_pipeline_dense(tree, cfg, n_stages, n_virtual),
                         cfg),
        cfg, stage=stage, n_stages=n_stages, n_virtual=n_virtual)


def _pipeline_dense(tree, cfg, n_stages: int, n_virtual: int) -> dict:
    """The dense flax tree (``h<k>`` a layer) of a tree shaped like the
    JAX ``PipelinedGPT``'s parameters (its stacked ``blocks``)."""
    lps = cfg.num_layers // (n_stages * n_virtual)
    dense = {"wte": tree["wte"], "ln_f": tree["ln_f"]}
    for k in range(cfg.num_layers):
        c, rest = divmod(k, n_stages * lps)
        p, j = divmod(rest, lps)
        index = (c, p, j) if n_virtual > 1 else (p, j)
        dense[f"h{k}"] = _map_tree(lambda a: np.asarray(a)[index],
                                   tree["blocks"])
    return dense


def _map_moments(state, fn):
    """An optax state with each moment tree (``mu``, ``nu``, ``trace``,
    ``sum_of_squares``) replaced by ``fn`` of it; NamedTuples rebuilt with
    ``_replace``.  Raises for adafactor's factored moments, whose shapes
    follow the stacked leaves."""
    fields = getattr(state, "_fields", None)
    if fields is not None:
        if any(f in _FACTORED for f in fields):
            raise NotImplementedError(
                "adafactor's factored moments of a pipelined model are not "
                "ported (they factor the stacked stage leaves)")
        return state._replace(**{
            f: fn(getattr(state, f)) if f in _MOMENTS
            else _map_moments(getattr(state, f), fn)
            for f in fields if f != "count"})
    if isinstance(state, tuple):
        return tuple(_map_moments(v, fn) for v in state)
    return state


def pipeline_params_to_flax(states, cfg, *, n_virtual: int = 1) -> dict:
    """The JAX ``PipelinedGPT``'s parameter tree from every pipe rank's
    state (rank order; parameters or gradients by name): the inverse of
    :func:`pipeline_params_from_flax`, so gradients compare leaf by
    leaf."""
    from .gpt_pipeline import params_to_dense

    n_stages = len(states)
    lps = cfg.num_layers // (n_stages * n_virtual)
    dense = params_to_flax(params_to_dense(states, cfg), cfg)
    lead = (n_virtual, n_stages, lps) if n_virtual > 1 else (n_stages, lps)
    layers = [dense.pop(f"h{k}") for k in range(cfg.num_layers)]

    def stack(*leaves):
        return np.stack(leaves).reshape(*lead, *leaves[0].shape)

    def stack_tree(trees):
        return {k: stack_tree([t[k] for t in trees])
                if isinstance(trees[0][k], Mapping) else
                stack(*[t[k] for t in trees]) for k in trees[0]}

    return {**dense, "blocks": stack_tree(layers)}


def shards_for_rank(tree, cfg, coords: dict, shape: dict, *, layout=None,
                    opt_state=None, make_optimizer=None,
                    n_virtual: int = 1) -> dict:
    """A rank's part of the JAX package's whole state: ``{"params": ...}``
    with each parameter ``layout`` shards over ``model`` cut to the
    rank's slice (``parallel.sharding.tp_rules``: the slicing
    ``bind_tensor_parallel`` applies to a whole model) and each expert
    stack it shards over ``expert`` cut to the rank's experts
    (``parallel.sharding.ep_rules``, ``parallel.moe.local_experts``, as
    ``parallel.sharding.shard_expert_stacks`` cuts them), and with an optax
    ``opt_state`` (and ``make_optimizer``, the port optimizer's factory)
    ``"opt_state"``, the port optimizer's ``state_dict`` converted by
    :func:`opt_state_from_optax`, its slots cut as their parameters, then,
    over more than one replica (``data`` x ``fsdp``), chunked to ZeRO's
    ``(degree, chunk)`` view and cut to the rank's row: what a
    ``TrainState`` built with ``zero=`` loads.  ``tree`` is the JAX
    parameter tree (a GPT config) or variables dict (a model of
    :data:`MODELS`); ``coords`` and ``shape`` a mesh's (axis -> index,
    axis -> size).  Over a ``pipe`` axis ``tree`` is the JAX
    ``PipelinedGPT``'s (``n_virtual`` chunks a stage) and the rank keeps
    its stage's blocks (:func:`pipeline_params_from_flax`); its optax
    state (moments shaped as that tree) becomes the ``state_dict`` of the
    optimizer over the stage's parameters."""
    from ..parallel import sharding, zero as zero_lib
    from ..parallel.moe import local_experts

    pipe = shape.get("pipe", 1) > 1
    if pipe:
        def dense_of(t):
            return _pipeline_dense(t, cfg, shape["pipe"], n_virtual)

        state = pipeline_params_from_flax(
            tree, cfg, stage=coords.get("pipe", 0), n_stages=shape["pipe"],
            n_virtual=n_virtual)
        if opt_state is not None:
            opt_state = _map_moments(opt_state, dense_of)
            whole = params_from_flax(dense_of(tree), cfg)
    else:
        state = whole = params_from_flax(tree, cfg)
    n, r = shape.get("model", 1), coords.get("model", 0)
    ne, re_ = shape.get("expert", 1), coords.get("expert", 0)
    rules = {}
    if layout is not None and n > 1:
        rules = sharding.tp_rules(_model_for(cfg, "meta"), cfg, layout)
    experts = set()
    if layout is not None and ne > 1:
        experts = set(sharding.ep_rules(cfg, layout))

    def cut(name, v):
        if name in rules:
            v = sharding.shard_tensor(v, rules[name][0], r, n, rules[name][1])
        if name in experts:
            v = local_experts(v, ne, re_)
        return v

    out = {"params": {k: cut(k, v) for k, v in state.items()}}
    if opt_state is None:
        return out
    model = _model_for(cfg)
    model.load_state_dict(whole)
    optimizer = make_optimizer(list(model.named_parameters()))
    sd = opt_state_from_optax(opt_state, cfg, optimizer, model)
    names = {id(p): name for name, p in model.named_parameters()}
    order = [names[id(p)] for g in optimizer.param_groups
             for p in g["params"]]
    if pipe:  # the optimizer over the stage's parameters alone
        index = {name: i for i, name in enumerate(order)}
        staged = make_optimizer([(k, p) for k, p in model.named_parameters()
                                 if k in state])
        order = [names[id(p)] for g in staged.param_groups
                 for p in g["params"]]
        groups = [dict(w, params=g["params"]) for w, g in zip(
            sd["param_groups"], staged.state_dict()["param_groups"])]
        sd = {"state": {j: sd["state"][index[k]] for j, k in enumerate(order)
                        if index[k] in sd["state"]},
              "param_groups": groups}
    degree = shape.get("data", 1) * shape.get("fsdp", 1)
    row = coords.get("data", 0) * shape.get("fsdp", 1) + coords.get("fsdp", 0)
    for i, entry in sd["state"].items():
        name = order[int(i)]
        for k, v in entry.items():
            if not torch.is_tensor(v) or v.shape != state[name].shape:
                continue
            v = cut(name, v)
            if degree > 1:
                v = zero_lib.chunk_array(v, degree)[row].clone()
            entry[k] = v
    out["opt_state"] = sd
    return out


# ------------------------------------------------------------ MPMD stages


def _mpmd_name(path: tuple[str, ...]) -> tuple[str, bool]:
    """A JAX MPMD stage's parameter path -> (the port stage's name, is a
    Dense kernel): ``wte/embedding`` is ``wte.weight``, block ``h<i>``'s
    leaves ``h.<i>....`` as :func:`_flax_path` maps them, ``kernel``
    leaves ``weight``."""
    if path == ("wte", "embedding"):
        return "wte.weight", False
    parts = list(path)
    if parts[0][:1] == "h" and parts[0][1:].isdigit():
        parts = ["h", parts[0][1:]] + parts[1:]
    if parts[-1] == "kernel":
        return ".".join(parts[:-1] + ["weight"]), True
    return ".".join(parts), False


def mpmd_stage_params_from_flax(tree) -> dict[str, torch.Tensor]:
    """The port's ``parallel.pipeline_mpmd.StageModel`` state for a JAX
    MPMD stage's parameter tree (numpy arrays: ``wte/embedding`` on the
    first stage, the blocks ``h<i>`` numbered within the stage, ``ln_f``
    and the untied ``head/kernel`` on the last): Dense kernels (in, out)
    become ``nn.Linear``'s (out, in) weights, the rest keep their
    shapes."""
    state = {}
    for path in _leaves(tree):
        leaf = tree
        for key in path:
            leaf = leaf[key]
        name, is_kernel = _mpmd_name(path)
        arr = np.asarray(leaf, dtype=np.float32)
        state[name] = torch.tensor(arr.T if is_kernel else arr)
    return state


def mpmd_stage_params_to_flax(state) -> dict:
    """The JAX MPMD stage's tree for a port stage's ``state`` (or its
    gradients by parameter name): the inverse of
    :func:`mpmd_stage_params_from_flax`."""
    tree: dict = {}
    for name, t in state.items():
        parts = name.split(".")
        if parts[0] == "h":
            parts = [f"h{parts[1]}"] + parts[2:]
        arr = t.detach().to("cpu", torch.float32).numpy()
        if name == "wte.weight":
            parts = ["wte", "embedding"]
        elif parts[-1] == "weight":
            parts[-1], arr = "kernel", arr.T
        node = tree
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = np.array(arr)
    return tree
