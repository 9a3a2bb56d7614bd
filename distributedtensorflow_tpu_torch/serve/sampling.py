"""The host sampler's logits -> probabilities reference.

Twin of ``logits_to_probs`` in ``distributedtensorflow_tpu/serve/sampling.py``
(``:49-83``), the numpy form the engine's host sampler uses.  The fused
on-device sampler (``sample_burst``/``sample_one``) belongs to the fused
decode path, which is not ported yet.
"""

from __future__ import annotations

import numpy as np

__all__ = ["logits_to_probs"]


def logits_to_probs(logits, temperature, top_k) -> np.ndarray:
    """``(..., V)`` logits -> fp32 probabilities.

    ``temperature`` and ``top_k`` broadcast against the leading dims.
    ``top_k=0`` disables truncation; ``temperature <= 0`` is greedy and
    returns the exact one-hot of the first argmax, so ties resolve as
    ``argmax`` does.  fp32 throughout, as the device sampler computes."""
    logits = np.asarray(logits, dtype=np.float32)
    v = logits.shape[-1]
    rows = logits.shape[:-1]
    t = np.broadcast_to(np.asarray(temperature, np.float32), rows)[..., None]
    k = np.broadcast_to(np.asarray(top_k, np.int32), rows)[..., None]
    scaled = logits / np.maximum(t, np.float32(1e-6))
    # dynamic per-row top-k: threshold at the k-th largest via one sort
    srt = np.sort(scaled, axis=-1)
    kth = np.take_along_axis(srt, np.clip(v - k, 0, v - 1), axis=-1)
    scaled = np.where((k > 0) & (scaled < kth), np.float32(-np.inf), scaled)
    p = np.exp(scaled - scaled.max(axis=-1, keepdims=True))
    soft = p / p.sum(axis=-1, keepdims=True)
    am = np.argmax(logits, axis=-1)
    onehot = (np.arange(v)[None, :] == np.reshape(am, (-1, 1))).reshape(
        logits.shape)
    return np.where(t <= 0, onehot.astype(np.float32), soft)
