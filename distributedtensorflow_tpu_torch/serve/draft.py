"""Model-free draft proposals for self-speculative decoding.

Twin of ``distributedtensorflow_tpu/serve/draft.py``, numpy only and
copied whole.  Prompt-lookup (n-gram) drafting: the request's OWN token
history (prompt plus everything generated so far) is the proposal
source.  If the sequence's final n-gram occurred earlier in the history,
the tokens that followed that occurrence are proposed as the next draft;
the fused verify program then scores all of them in one pass and the
rejection sampler keeps the model-consistent prefix (``serve.sampling``).
It costs microseconds of host numpy per decode iteration and needs no
second model; novel text yields no proposal, and the engine then runs the
one-token fused program.
"""

from __future__ import annotations

import numpy as np

__all__ = ["propose"]


def propose(history, k: int, *, max_ngram: int = 3,
            min_ngram: int = 1) -> list[int]:
    """Up to ``k`` draft tokens continuing ``history``, or ``[]``.

    Tries suffix n-grams from ``max_ngram`` down to ``min_ngram``; the
    first length with an earlier occurrence wins, and among occurrences
    the MOST RECENT is used (locality: the continuation closest to the
    current context is likeliest to repeat).  The match may overlap the
    suffix itself, which is exactly what extends a periodic tail.
    Pure lookup — no state, no model."""
    if k < 1:
        return []
    h = np.asarray(history, dtype=np.int64)
    n_total = int(h.size)
    if n_total < min_ngram + 1:
        return []
    for n in range(min(max_ngram, n_total - 1), min_ngram - 1, -1):
        suffix = h[-n:]
        windows = np.lib.stride_tricks.sliding_window_view(h[:-1], n)
        hits = np.flatnonzero((windows == suffix).all(axis=1))
        if hits.size:
            i = int(hits[-1])
            cont = h[i + n:i + n + k]
            if cont.size:
                return [int(t) for t in cont]
    return []
