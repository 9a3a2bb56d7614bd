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
``BertForMLM``, ``WideDeep``; their configs select them) name their
submodules as the flax tree does, so a parameter's path is its name.
For them the JAX tree is the whole flax variables dict, ``{"params":
...}`` plus ``"batch_stats"`` (BatchNorm's running ``mean`` and ``var``,
the port's buffers) for the ResNets, and the state holds the buffers too.
Conv kernels are (kh, kw, in, out) in flax and (out, in, kh, kw) here;
Dense kernels (in, out) are (out, in), the ``DenseGeneral`` kernels of
BERT's attention ((E, H, D) and (H, D, E)) and biases ((H, D)) flattened
to that matrix; embedding tables are ``embedding`` in flax and
``weight`` here.

Optimizer state: ``opt_state_from_optax`` gives the ``state_dict`` of a
port optimizer (``train.optimizers``) for the optax state of its JAX twin
(``build_optimizer``'s chains: sgd, nesterov momentum, adam, adamw with
or without its decay mask, adagrad, each behind ``clip_by_global_norm``
or not), and ``opt_state_to_optax`` the optax state for a port
optimizer, so a run can move from one package to the other mid-way.
The optax ``count`` is the parameter groups' ``"count"`` (and AdamW's
``step``); ``mu``/``nu``, the momentum ``trace`` and adagrad's
``sum_of_squares`` are AdamW's ``exp_avg``/``exp_avg_sq``, SGD's
``momentum_buffer`` and :class:`~..train.optimizers.Adagrad`'s ``sos``,
each a tree of the parameters mapped as the parameters are.
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch
from torch import nn

from .bert import BertConfig, BertForMLM
from .gpt import GPTConfig
from .gpt_moe import GPTMoEConfig
from .layers import BatchNorm, Conv, Dense, FusedLayerNorm
from .lenet import LeNet5, LeNetConfig
from .resnet import (
    CifarResNet,
    CifarResNetConfig,
    ImageNetResNet,
    ImageNetResNetConfig,
)
from .widedeep import WideDeep, WideDeepConfig

#: The BASELINE models by their config's class.
MODELS = {LeNetConfig: LeNet5, CifarResNetConfig: CifarResNet,
          ImageNetResNetConfig: ImageNetResNet, BertConfig: BertForMLM,
          WideDeepConfig: WideDeep}


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
    BASELINE model, read from the model built on the meta device."""
    model = MODELS[type(cfg)](cfg, device="meta")
    out = {}
    for mod_name, mod in model.named_modules():
        prefix = tuple(mod_name.split(".")) if mod_name else ()
        tensors = list(mod.named_parameters(recurse=False)) \
            + list(mod.named_buffers(recurse=False))
        if tensors and not isinstance(
                mod, (BatchNorm, Conv, Dense, FusedLayerNorm, nn.Embedding)):
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
    for a GPT config, the whole variables dict for a BASELINE model's.
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
    leaf.  For a BASELINE model the variables dict; a state without the
    running statistics (gradients) gives one without ``batch_stats``.
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
    1 and bias 0.  The BASELINE models: conv weights at std
    1/sqrt(in x kh x kw), embedding tables at 1/sqrt(width) (flax's
    ``Embed`` default), biases 0, BatchNorm scale 1 (0 where flax starts
    it at 0), running mean 0 and variance 1."""
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


# ------------------------------------------------------------- optimizers

#: optax moment field -> the port optimizer's state slot.
_MOMENTS = {"mu": "exp_avg", "nu": "exp_avg_sq", "trace": "momentum_buffer",
            "sum_of_squares": "sos"}


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
            elif field in _MOMENTS:
                out[field] = val
            else:
                _optax_parts(val, out)
    elif isinstance(state, (tuple, list)):
        for val in state:
            _optax_parts(val, out)
    return out


def _slots(optimizer) -> tuple[str, ...]:
    """The optax moment fields the port optimizer keeps per parameter."""
    from ..train.optimizers import Adagrad

    if isinstance(optimizer, torch.optim.AdamW):
        return ("mu", "nu")
    if isinstance(optimizer, Adagrad):
        return ("sum_of_squares",)
    if isinstance(optimizer, torch.optim.SGD):
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
    trees = {f: _params_from(parts[f], cfg) for f in fields}
    count = parts.get("count")
    names = {id(p): n for n, p in model.named_parameters()}
    params = [p for g in optimizer.param_groups for p in g["params"]]
    sd = optimizer.state_dict()
    sd["state"] = {}
    for i, p in enumerate(params):
        entry = {_MOMENTS[f]: trees[f][names[id(p)]] for f in fields}
        if isinstance(optimizer, torch.optim.AdamW):
            entry["step"] = torch.tensor(float(count or 0))
        if entry:
            sd["state"][i] = entry
    if count is not None:
        for group in sd["param_groups"]:
            group["count"] = count
    return sd


def opt_state_to_optax(optimizer, cfg, model, like):
    """The optax state of ``optimizer``'s JAX twin, in the structure of
    ``like`` (that twin's ``init``; NamedTuples are rebuilt with
    ``_replace``, so nothing of optax is imported): the inverse of
    :func:`opt_state_from_optax`.  A moment the optimizer has not made yet
    (no update so far) is optax's initial value: 0, or 0.1 for adagrad's
    sum of squares."""
    count = optimizer.param_groups[0].get("count", 0)
    named = dict(model.named_parameters())

    def moments(field):
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
                if f == "count" else moments(f) if f in _MOMENTS
                else rebuild(getattr(state, f)) for f in fields})
        if isinstance(state, tuple):
            return tuple(rebuild(v) for v in state)
        return state

    return rebuild(like)
