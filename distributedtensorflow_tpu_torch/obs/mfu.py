"""MFU fields for the live metric stream.

Twin of ``distributedtensorflow_tpu/obs/mfu.py`` for NVIDIA cards: the
model's FLOPs per step over the step's wall time, over the card's
published dense bf16 peak.  The peak comes from a table of NVIDIA kinds
keyed by ``torch.cuda.get_device_name``; a kind the table does not know
gives no fields at all, never a guessed peak.  The JAX package's TPU
peaks and its XLA cost-analysis path are left out (there is no XLA), and
so is its delegation to the repository root's ``bench_probe``: the two
numeric fields it returns, ``mfu`` and its alias ``mfu_analytic``, are
computed here with the same rounding.

FLOP-counting convention: one multiply-add is **2 FLOPs**
(:func:`matmul_flops`), as in the JAX package, so a ``flops_per_step``
fed into these fields must count MACs x 2 — the closed form 6 N + 6 L S E
per token of ``PERF.md`` does, and so does ``torch.utils.flop_counter``.
"""

from __future__ import annotations

__all__ = ["PEAK_FLOPS_BY_KIND", "matmul_flops", "mfu_record_fields",
           "peak_flops"]

#: Published dense bf16 FLOP/s (tensor cores, no sparsity) by a substring
#: of ``torch.cuda.get_device_name``, most specific first.  The H100 SXM
#: part reports "NVIDIA H100 80GB HBM3"; the PCIe part "NVIDIA H100 PCIe".
PEAK_FLOPS_BY_KIND = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
    ("A100", 312e12),
)


def peak_flops(device_kind: str) -> float | None:
    """Peak dense bf16 FLOP/s of an NVIDIA card by its name, or None for
    a kind the table does not hold."""
    for sub, peak in PEAK_FLOPS_BY_KIND:
        if sub in device_kind:
            return peak
    return None


def matmul_flops(m: int, n: int, k: int) -> float:
    """FLOPs of an ``(m, k) @ (k, n)`` matmul under the MACs x 2
    convention."""
    return 2.0 * m * n * k


def _device_kind() -> str:
    import torch  # noqa: PLC0415

    if not torch.cuda.is_available():
        return ""
    return torch.cuda.get_device_name(torch.cuda.current_device())


def mfu_record_fields(
    flops_per_step: float,
    dt_per_step: float,
    device_kind: str | None = None,
) -> dict[str, float]:
    """Numeric MFU fields for one metric record: ``mfu`` and
    ``mfu_analytic`` (the same number, the JAX package's two names).

    ``flops_per_step`` is this device's model FLOPs per optimizer step,
    ``dt_per_step`` the measured wall seconds per step, ``device_kind``
    the card's name (default: the current CUDA device's; "" without
    one).  Returns ``{}`` when either number is unknown or the kind has
    no known peak.
    """
    if not flops_per_step or not dt_per_step or dt_per_step <= 0:
        return {}
    if device_kind is None:
        device_kind = _device_kind()
    peak = peak_flops(device_kind)
    if peak is None:
        return {}
    mfu = round(flops_per_step / dt_per_step / peak, 4)
    return {"mfu": mfu, "mfu_analytic": mfu}
