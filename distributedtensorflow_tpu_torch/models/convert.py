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


def _baseline_from_flax(variables, cfg) -> dict[str, torch.Tensor]:
    state, used = {}, set()
    for name, (path, mod, attr) in _baseline_leaves(cfg).items():
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
