"""Run-to-run determinism switch and A/B helpers.

Twin of ``distributedtensorflow_tpu/utils/determinism.py`` (``:31-70``).
XLA on the TPU compiles a fixed schedule, so JAX pins only its PRNG
partitioning and matmul precision; a CUDA run also varies with the
algorithms cuBLAS and cuDNN pick and with kernels that add in the order
their atomics land, which :func:`enable_determinism` pins.
:func:`derive_seed` folds names into a base seed (the same integers as
JAX's) and :func:`tree_fingerprint` hashes a whole state to one digest
for golden-run comparisons.
"""

from __future__ import annotations

import hashlib
import os
from collections.abc import Mapping
from typing import Any

import torch


def enable_determinism() -> None:
    """Make the run's CUDA arithmetic repeat from run to run.

    ``torch.use_deterministic_algorithms(True)`` (an op without a
    deterministic CUDA version then raises instead of running), cuBLAS's
    fixed workspace (``CUBLAS_WORKSPACE_CONFIG``, read when cuBLAS starts:
    call this before the first matrix product), cuDNN's deterministic
    algorithms without autotuning, and TF32 off for products and
    convolutions (the counterpart of JAX's ``"highest"`` matmul
    precision).  Idempotent."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def derive_seed(base: int, *names: int | str) -> int:
    """A distinct 31-bit seed from a base seed and a name path:
    ``derive_seed(seed, "shuffle", epoch, host)``, stable across runs and
    distinct across consumers (JAX's function, integer for integer)."""
    h = hashlib.sha256(str(base).encode())
    for n in names:
        h.update(b"\x00" + str(n).encode())
    return int.from_bytes(h.digest()[:4], "little") & 0x7FFFFFFF


def flatten(tree: Any, prefix: str = "") -> dict[str, Any]:
    """The leaves of nested dicts, lists and tuples by their ``/``-joined
    path (dict keys as strings, sequence items by index)."""
    if isinstance(tree, Mapping):
        items = ((str(k), v) for k, v in tree.items())
    elif isinstance(tree, (list, tuple)):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix: tree}
    out: dict[str, Any] = {}
    for key, val in items:
        out.update(flatten(val, f"{prefix}/{key}" if prefix else key))
    return out


def tree_fingerprint(tree: Any) -> str:
    """SHA-256 over a state: each leaf's path (:func:`flatten`) in sorted
    order, then a tensor's dtype, shape and raw bytes (fetched to the
    host), or another leaf's ``repr``.  Two states with the same fingerprint are
    bit-identical: the golden-run A/B check.  ``tree`` is a
    ``state_dict`` or any nesting of dicts, lists and tuples of them
    (an optimizer's ``state_dict`` included)."""
    h = hashlib.sha256()
    for path, leaf in sorted(flatten(tree).items()):
        h.update(path.encode() + b"\x00")
        if isinstance(leaf, torch.Tensor):
            t = leaf.detach().to("cpu").contiguous()
            h.update(f"{str(t.dtype)}{tuple(t.shape)}".encode())
            h.update(memoryview(t.reshape(-1).view(torch.uint8).numpy()))
        else:
            h.update(repr(leaf).encode())
    return h.hexdigest()
