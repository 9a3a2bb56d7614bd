"""Parameters for the port's ``GPTLM`` and ``GPTMoELM``: from and to a
JAX tree, or seeded.

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
"""

from __future__ import annotations

import math
from collections.abc import Mapping

import numpy as np
import torch

from .gpt import GPTConfig
from .gpt_moe import GPTMoEConfig


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


def params_from_flax(tree, cfg: GPTConfig) -> dict[str, torch.Tensor]:
    """The port's state for the JAX model's parameter ``tree``.  Raises
    when a leaf is missing, left over or of the wrong shape."""
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

    def leaves(node, prefix=()):
        for key, val in node.items():
            if isinstance(val, Mapping):
                yield from leaves(val, prefix + (key,))
            else:
                yield prefix + (key,)

    extra = [p for p in leaves(tree) if p not in used]
    if extra:
        raise ValueError(f"unexpected parameters in the tree: {extra}")
    return state


def params_to_flax(state, cfg: GPTConfig) -> dict:
    """The JAX model's parameter tree (nested dicts of fp32 numpy
    arrays) for the port's ``state`` (parameter name -> tensor): the
    inverse of :func:`params_from_flax`, so gradients compare leaf by
    leaf.  Raises when a name is missing, left over or misshapen."""
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


def init_params(cfg: GPTConfig, generator: torch.Generator
                ) -> dict[str, torch.Tensor]:
    """Seeded random state on the CPU: normal embeddings and dense
    weights at std 1/sqrt(fan_in) (flax's default scales, untruncated;
    flax counts a stacked (E, in, out) expert kernel's fan-in as E x
    in), routers at std 0.02 as flax's ``normal(0.02)``, LayerNorm scale
    1 and bias 0."""
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
