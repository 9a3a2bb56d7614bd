"""Quantised matmuls (int8, fp8) with a straight-through backward, and
dynamic loss scaling.

Twin of ``distributedtensorflow_tpu/ops/quant.py``: symmetric
per-channel absmax quantisation (``absmax / 127`` for int8, ``absmax /
448`` for ``float8_e4m3fn``; a zero channel takes the scale ``1 /
qmax``), :func:`int8_dot` (lhs rows and rhs columns scaled, the
contraction accumulated in int32, or fp32 for fp8, rescaled by ``sx *
sw``), :func:`quantized_matmul` (:class:`QuantMatmulFn`: the forward
pays the narrow product, the backward is the exact fp32 gradient of the
full-width product from the saved operands) and the loss-scale
controller (:class:`DynamicLossScale`, :func:`scale_loss`,
:func:`unscale_grads`, :func:`grads_finite`, :func:`loss_scale_update`).

The narrow products are plain GEMMs, which XLA runs in the reference: no
Pallas kernel, so the card runs cuBLASLt through PyTorch
(``torch._int_mm``: int8 in, int32 out; ``torch._scaled_mm``: fp8 in
with unit tensor scales, fp32 out, then ``* sx * sw`` as JAX's
``:171``).  A shape outside what those calls take raises, naming the
shape: there is no fallback to the plain product on the card.  A CPU
tensor takes the plain product: int8 as an exact int32 matmul, fp8 as
the fp8 values widened to fp32 and multiplied in fp32.

``int8_stochastic`` rounds ``floor(x / s + u)`` with ``u`` uniform in
[0, 1) from the port's Philox (``ops.dropout.uniform``) under a seed
and a site (a seed may be an int64 tensor on the device, so a CUDA
graph of k steps replays fresh draws).  JAX draws from
``jax.random.uniform``: the two agree only in distribution.
"""

from __future__ import annotations

import dataclasses

import torch

from .dropout import uniform

__all__ = [
    "QUANT_MODES",
    "validate_mode",
    "quantize",
    "dequantize",
    "int8_dot",
    "quantized_matmul",
    "DynamicLossScale",
    "scale_loss",
    "unscale_grads",
    "grads_finite",
    "loss_scale_update",
]

#: The quantised-compute modes ("none" = full width).
QUANT_MODES = ("none", "int8", "int8_stochastic", "fp8")

_INT8_MAX = 127.0
_FP8_MAX = 448.0  # float8_e4m3fn's largest finite value
FP8 = torch.float8_e4m3fn


def validate_mode(mode: str | None) -> str:
    mode = mode or "none"
    if mode not in QUANT_MODES:
        raise ValueError(
            f"unknown quant mode {mode!r}; expected one of {QUANT_MODES}")
    return mode


def _absmax_scale(x32: torch.Tensor, dim: int, qmax: float) -> torch.Tensor:
    """Per-channel ``absmax / qmax`` (fp32, keepdim); a zero channel
    gets ``1 / qmax`` (never 0, which would make the divide NaN)."""
    amax = x32.abs().amax(dim=dim, keepdim=True)
    return torch.where(amax > 0, amax, torch.ones_like(amax)) / qmax


def quantize(x: torch.Tensor, *, dim: int = -1, mode: str = "int8",
             key=None) -> tuple[torch.Tensor, torch.Tensor]:
    """``(q, scale)`` of ``x`` quantised along ``dim`` (the contraction
    axis): ``q`` int8 (or fp8), ``scale`` fp32 keepdim over ``dim``.
    ``mode="int8_stochastic"`` (or a ``key``) rounds stochastically with
    the uniforms of ``key = (seed, site)``, so ``E[q * scale] == x``."""
    mode = validate_mode(mode)
    if mode == "none":
        raise ValueError("quantize called with mode='none'")
    x32 = x.float()
    if mode == "fp8":
        scale = _absmax_scale(x32, dim, _FP8_MAX)
        return (x32 / scale).to(FP8), scale
    scale = _absmax_scale(x32, dim, _INT8_MAX)
    y = x32 / scale
    if mode == "int8_stochastic" or key is not None:
        if key is None:
            raise ValueError("stochastic rounding needs a (seed, site) key")
        seed, site = key
        y = torch.floor(y + uniform(y.shape, seed, site, y.device))
    else:
        y = torch.round(y)  # half to even, as jnp.round
    return y.clamp(-_INT8_MAX, _INT8_MAX).to(torch.int8), scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def _check_shape(what: str, m: int, k: int, n: int, mult: int,
                 min_m: int) -> None:
    if m <= min_m or k % mult or n % mult:
        raise ValueError(
            f"{what} on the card takes M > {min_m} and K, N multiples of "
            f"{mult}; got M={m}, K={k}, N={n}")


def narrow_product(xq: torch.Tensor, wq_t: torch.Tensor) -> torch.Tensor:
    """The accumulator of ``xq`` (M, K) times ``wq_t.T``, where ``wq_t``
    is (N, K) (the port's (out, in) weight layout): int32 for int8 (an
    exact int32 matmul on the CPU, ``torch._int_mm`` on the card), fp32
    for fp8 (the fp8 values widened to fp32 on the CPU,
    ``torch._scaled_mm`` with unit scales on the card)."""
    m, k = xq.shape
    n = wq_t.shape[0]
    if xq.device.type == "cpu":
        if xq.dtype == torch.int8:
            return xq.to(torch.int32) @ wq_t.to(torch.int32).T
        return xq.float() @ wq_t.float().T
    if xq.dtype == torch.int8:
        _check_shape("torch._int_mm", m, k, n, 8, 16)
        return torch._int_mm(xq.contiguous(), wq_t.contiguous().T)
    _check_shape("torch._scaled_mm", m, k, n, 16, 0)
    one = torch.ones((), dtype=torch.float32, device=xq.device)
    # the rhs column-major: the (N, K) row-major weight, transposed
    return torch._scaled_mm(xq.contiguous(), wq_t.contiguous().T,
                            scale_a=one, scale_b=one,
                            out_dtype=torch.float32)


def int8_dot(x: torch.Tensor, w_t: torch.Tensor, *, mode: str = "int8",
             key=None) -> torch.Tensor:
    """``x @ w_t.T`` through the quantised path, fp32: ``x`` (..., K),
    ``w_t`` (N, K) (the twin of JAX's ``w`` (K, N), transposed).  lhs
    rows and rhs columns (the rows of ``w_t``) each get their own absmax
    scale; the accumulator is rescaled by ``sx * sw``.  ``key = (seed,
    site)`` for ``int8_stochastic``: x draws at ``2 site``, w at
    ``2 site + 1``."""
    mode = validate_mode(mode)
    kx = kw = None
    if mode == "int8_stochastic":
        if key is None:
            raise ValueError("mode 'int8_stochastic' needs a (seed, site) key")
        seed, site = key
        kx, kw = (seed, 2 * site), (seed, 2 * site + 1)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1])
    xq, sx = quantize(x2, dim=-1, mode=mode, key=kx)    # (M, K), (M, 1)
    wq, sw = quantize(w_t, dim=-1, mode=mode, key=kw)   # (N, K), (N, 1)
    acc = narrow_product(xq, wq)
    return (acc.float() * sx * sw[:, 0]).reshape(*lead, w_t.shape[0])


class QuantMatmulFn(torch.autograd.Function):
    """Twin of the custom VJP ``_qmatmul`` (``:174-211``): the forward is
    :func:`int8_dot` cast to ``x.dtype``; the backward is the exact
    gradient of the full-width product, fp32 products of the saved
    operands (``dx = g w``, ``dw = g^T x``), cast to the operands'
    dtypes."""

    @staticmethod
    def forward(ctx, x, w_t, mode, key):
        ctx.save_for_backward(x, w_t)
        return int8_dot(x, w_t, mode=mode, key=key).to(x.dtype)

    @staticmethod
    def backward(ctx, g):
        x, w_t = ctx.saved_tensors
        g32 = g.float()
        dx = (g32 @ w_t.float()).to(x.dtype)
        g2 = g32.reshape(-1, g.shape[-1])
        x2 = x.reshape(-1, x.shape[-1]).float()
        dw = (g2.T @ x2).to(w_t.dtype)
        return dx, dw, None, None


def quantized_matmul(x: torch.Tensor, w_t: torch.Tensor, *,
                     mode: str = "int8", key=None) -> torch.Tensor:
    """Differentiable quantised ``x @ w_t.T`` (straight-through
    estimator): ``x`` (..., K), ``w_t`` (N, K), output (..., N) in
    ``x.dtype``.  ``mode="none"`` is the plain product;
    ``"int8_stochastic"`` needs ``key = (seed, site)``."""
    mode = validate_mode(mode)
    if mode == "none":
        return x @ w_t.T
    if mode == "int8_stochastic" and key is None:
        raise ValueError("mode 'int8_stochastic' needs a (seed, site) key")
    return QuantMatmulFn.apply(x, w_t, mode, key)


# --- dynamic loss scaling ----------------------------------------------------


@dataclasses.dataclass
class DynamicLossScale:
    """The loss-scale controller's state (JAX's NamedTuple): ``scale``
    multiplies the loss and divides the gradients back; ``good_steps``
    counts the finite steps since the last change.  The AMP defaults:
    2^15, doubled every 2000 clean steps, halved on overflow, never
    below 1."""

    scale: torch.Tensor
    good_steps: torch.Tensor

    @classmethod
    def init(cls, initial: float = 2.0 ** 15, device=None
             ) -> "DynamicLossScale":
        return cls(torch.tensor(initial, dtype=torch.float32, device=device),
                   torch.zeros((), dtype=torch.int32, device=device))


def scale_loss(loss: torch.Tensor, state: DynamicLossScale) -> torch.Tensor:
    return loss * state.scale.to(loss.dtype)


def unscale_grads(grads, state: DynamicLossScale):
    """Every gradient times ``1 / scale`` in fp32, back in its dtype; a
    dict or a list, as given."""
    inv = (1.0 / state.scale).float()

    def one(g):
        return (g.float() * inv).to(g.dtype)

    if isinstance(grads, dict):
        return {k: one(g) for k, g in grads.items()}
    return [one(g) for g in grads]


def grads_finite(grads) -> torch.Tensor:
    """Scalar bool tensor: every gradient entirely finite."""
    leaves = list(grads.values()) if isinstance(grads, dict) else list(grads)
    if not leaves:
        return torch.tensor(True)
    out = torch.isfinite(leaves[0]).all()
    for g in leaves[1:]:
        out = out & torch.isfinite(g).all()
    return out


def loss_scale_update(state: DynamicLossScale, finite: torch.Tensor, *,
                      growth_interval: int = 2000, factor: float = 2.0,
                      min_scale: float = 1.0) -> DynamicLossScale:
    """The next state: grow after ``growth_interval`` consecutive finite
    steps, shrink at once on a non-finite one (whose update the caller
    skips)."""
    good = torch.where(finite, state.good_steps + 1,
                       torch.zeros_like(state.good_steps))
    grow = finite & (good >= growth_interval)
    scale = torch.where(
        grow, state.scale * factor,
        torch.where(finite, state.scale,
                    torch.clamp(state.scale / factor, min=min_scale)))
    return DynamicLossScale(scale, torch.where(grow, torch.zeros_like(good),
                                               good))
