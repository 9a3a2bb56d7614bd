"""Checkpoint integrity: per-tensor checksum manifests.

Twin of ``distributedtensorflow_tpu/checkpoint/integrity.py``
(``:60-188``), with the same manifest document, written beside the step
directories as ``<dir>/manifests/<step>.json``::

    {"version": 1, "step": 40, "t": 1690000000.0,
     "arrays": {"params/h.0.attn.qkv.weight": {
         "crc32": 123456, "shape": [384, 128], "dtype": "float32",
         "nbytes": 196608}, ...}}

A key is a leaf's path in the saved tree, its parts joined by ``/``
(``utils.determinism.flatten``):
``step``, ``params/<name>``, ``model_state/<buffer>`` and
``opt_state/...`` (the optimizer's ``state_dict``: ``state/<index>/
<slot>`` and ``param_groups/<group>/<field>``).  Tensors and numbers
(ints, floats, bools, as 0-d tensors of int64, float64 and bool) have a
record; other leaves (``None``, strings) are settings, not state, and
have none.  The CRC32 is taken over a tensor's raw contiguous bytes
(``tensor.view(torch.uint8)``): numpy has no bfloat16, so the bytes never
pass through it as numbers.

The manifest is written from the state as it was when the save began (the
host copy the checkpoint is written from), atomically (temporary file +
``os.replace``) and by the chief only.  ``CheckpointManager.restore_latest``
checks a step's payload against it and falls back to the next-newest step
on a mismatch.
"""

from __future__ import annotations

import json
import logging
import os
import time
import zlib
from typing import Any

import torch

from ..utils.determinism import flatten

logger = logging.getLogger(__name__)

__all__ = [
    "CheckpointCorruptError",
    "load_manifest",
    "manifest_path",
    "prune_manifests",
    "tree_checksums",
    "verify_tree",
    "write_manifest",
]

#: Manifest directory under the checkpoint root, kept out of the numbered
#: step directories (those are renamed into place at commit).
MANIFEST_DIRNAME = "manifests"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed restore or checksum verification."""


def manifest_path(directory: str, step: int) -> str:
    return os.path.join(str(directory), MANIFEST_DIRNAME, f"{int(step)}.json")


def _as_tensor(leaf) -> torch.Tensor | None:
    """A tensor leaf, or a number as a 0-d tensor; None for other leaves."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    if isinstance(leaf, bool):
        return torch.tensor(leaf, dtype=torch.bool)
    if isinstance(leaf, int):
        return torch.tensor(leaf, dtype=torch.int64)
    if isinstance(leaf, float):
        return torch.tensor(leaf, dtype=torch.float64)
    return None


def tensor_record(t: torch.Tensor) -> dict:
    """The manifest record of one tensor: CRC32 of its row-major bytes,
    shape, dtype and byte count (a CUDA tensor is fetched first)."""
    t = t.detach().to("cpu").contiguous()
    raw = t.reshape(-1).view(torch.uint8)
    return {
        "crc32": zlib.crc32(memoryview(raw.numpy())) & 0xFFFFFFFF,
        "shape": list(t.shape),
        "dtype": str(t.dtype).removeprefix("torch."),
        "nbytes": raw.numel(),
    }


def tree_checksums(tree: Any) -> dict[str, dict]:
    """Checksum records of every tensor and number of ``tree``, by path."""
    out = {}
    for key, leaf in flatten(tree).items():
        t = _as_tensor(leaf)
        if t is not None:
            out[key] = tensor_record(t)
    return out


def write_manifest(directory: str, step: int, checksums: dict[str, dict]
                   ) -> str:
    """Atomically write the manifest of ``step``; returns its path.  The
    caller is the chief (the manager writes from the chief only)."""
    path = manifest_path(directory, step)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    doc = {"version": 1, "step": int(step), "t": time.time(),
           "arrays": checksums}
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)
    return path


def load_manifest(directory: str, step: int) -> dict | None:
    """The parsed manifest of ``step``, or None when it is absent or
    unreadable (the step then restores unverified, guarded only by the
    load raising, rather than being rejected)."""
    path = manifest_path(directory, step)
    try:
        with open(path) as f:
            doc = json.load(f)
    except FileNotFoundError:
        return None
    except (OSError, ValueError):
        logger.warning("checkpoint manifest %s unreadable; treating step "
                       "as unverified", path)
        return None
    if not isinstance(doc, dict) or not isinstance(doc.get("arrays"), dict):
        logger.warning("checkpoint manifest %s malformed; treating step "
                       "as unverified", path)
        return None
    return doc


def verify_tree(tree: Any, manifest: dict) -> list[str]:
    """The mismatches between ``tree`` and its save-time manifest; an
    empty list means verified.  A changed shape or dtype is a mismatch: a
    checkpoint that comes back in another geometry did not round-trip."""
    got = tree_checksums(tree)
    problems: list[str] = []
    for key, rec in manifest.get("arrays", {}).items():
        if "crc32" not in rec:
            continue
        here = got.get(key)
        if here is None:
            problems.append(f"{key}: missing from restored state")
        elif list(rec.get("shape", [])) != here["shape"] or \
                str(rec.get("dtype", "")) != here["dtype"]:
            problems.append(
                f"{key}: geometry changed ({rec.get('shape')}/"
                f"{rec.get('dtype')} -> {here['shape']}/{here['dtype']})")
        elif int(rec["crc32"]) != here["crc32"]:
            problems.append(f"{key}: checksum mismatch (saved "
                            f"{int(rec['crc32'])}, restored {here['crc32']})")
    return problems


def prune_manifests(directory: str, keep_steps: list[int]) -> None:
    """Remove the manifests of steps that rotation deleted."""
    mdir = os.path.join(str(directory), MANIFEST_DIRNAME)
    try:
        names = os.listdir(mdir)
    except OSError:
        return
    keep = {f"{int(s)}.json" for s in keep_steps}
    for name in names:
        if name.endswith(".json") and name not in keep:
            try:
                os.remove(os.path.join(mdir, name))
            except OSError:
                pass
