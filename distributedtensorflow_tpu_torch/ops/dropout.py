"""Dropout with a counter-based mask, seeded from device memory.

The JAX package leaves dropout to flax's ``nn.Dropout`` (the rate set in
``distributedtensorflow_tpu/models/bert.py:38``); its bits come from the
TPU's generator inside the compiled step.  The port draws its own: the
mask is a pure function of a seed, a site index and the element's flat
index (Philox4x32-10, :func:`philox4x32`), so

- a CUDA graph that replays k training steps reads each step's seeds from
  a device buffer that the host fills before the replay, and draws fresh
  masks without being captured again;
- a recomputation (block remat) and the backward draw the same mask;
- the kernel ``csrc/dropout.cu`` (for a CUDA tensor) and
  :func:`_plain_dropout` (for a CPU tensor) give the same bits.

The kernel is bound by bytes: ``n * (in + out)`` over 3.35 TB/s.  A seed
is a Python int or an int64 tensor of one element on ``x``'s device; the
site tells apart the dropout calls that share one seed.  Like the JAX
package's dropout and the port's earlier one, the bits match flax's only
in distribution.
"""

from __future__ import annotations

import ctypes

import torch

from . import _cuda

_DTYPES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}
_SIGNATURES = {"dtf_dropout": [ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_longlong, ctypes.c_void_p,
                               ctypes.c_uint, ctypes.c_uint, ctypes.c_float,
                               ctypes.c_int, ctypes.c_int, ctypes.c_void_p]}
_M32 = 0xFFFFFFFF
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)


def threshold(rate: float) -> int:
    """The 24-bit threshold of ``rate``: an element is kept when its 24
    random bits are at least ``ceil(rate * 2**24)``, so it is kept with
    probability ``1 - rate`` up to 2**-24."""
    if not 0.0 <= rate < 1.0:
        raise ValueError(f"dropout rate must be in [0, 1), got {rate}")
    return -int(-rate * 2**24 // 1)


def _mulhilo(a: int, b: torch.Tensor):
    """``(hi, lo)`` 32-bit halves of the 64-bit product of the constant
    ``a`` and ``b`` (int64 tensor of 32-bit values), in 16-bit limbs so
    that no int64 product overflows."""
    a0, a1 = a & 0xFFFF, a >> 16
    b0, b1 = b & 0xFFFF, b >> 16
    p00, p01, p10, p11 = b0 * a0, b0 * a1, b1 * a0, b1 * a1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox4x32(counter: torch.Tensor, key: tuple[int, int]) -> torch.Tensor:
    """Philox4x32-10 of ``counter`` (..., 4) int64 tensor of 32-bit words
    under ``key`` (two 32-bit ints): (..., 4) int64 words, the function
    ``csrc/dropout.cu`` computes on the card."""
    c = [counter[..., i] for i in range(4)]
    k0, k1 = key
    for r in range(10):
        if r:
            k0, k1 = (k0 + _PHILOX_W[0]) & _M32, (k1 + _PHILOX_W[1]) & _M32
        hi0, lo0 = _mulhilo(_PHILOX_M[0], c[0])
        hi1, lo1 = _mulhilo(_PHILOX_M[1], c[2])
        c = [hi1 ^ c[1] ^ k0, lo1, hi0 ^ c[3] ^ k1, lo0]
    return torch.stack(c, -1)


def _words(shape, seed, site: int, device) -> torch.Tensor:
    """Philox words of ``shape``: element ``i`` (flat) takes word
    ``i % 4`` of Philox over the counter ``(i // 4, site)`` under
    ``seed`` (an int, or an int64 tensor of one element, read on its
    device)."""
    n = 1
    for s in shape:
        n *= s
    groups = torch.arange((n + 3) // 4, dtype=torch.int64, device=device)
    counter = torch.stack([groups & _M32, groups >> 32,
                           torch.full_like(groups, site),
                           torch.zeros_like(groups)], -1)
    if torch.is_tensor(seed):
        seed = seed.reshape(())
        key = (seed & _M32, (seed >> 32) & _M32)
    else:
        seed &= (1 << 64) - 1
        key = (seed & _M32, seed >> 32)
    return philox4x32(counter, key).reshape(-1)[:n].reshape(shape)


def keep_mask(shape, seed: int, site: int, rate: float,
              device="cpu") -> torch.Tensor:
    """The bool mask of ``shape`` that seed ``seed`` and ``site`` give:
    element ``i`` (flat) takes word ``i % 4`` of Philox over the counter
    ``(i // 4, site)``."""
    return (_words(shape, seed, site, device) >> 8) >= threshold(rate)


def uniform(shape, seed, site: int, device="cpu") -> torch.Tensor:
    """fp32 uniforms in [0, 1) of ``shape``, 24 bits each, from the words
    :func:`keep_mask` reads for the same ``seed`` and ``site``.  ``seed``
    may be an int64 tensor of one element on ``device`` (a CUDA graph's
    seed slot): the words are then computed on the device from it."""
    return (_words(shape, seed, site, device) >> 8).float() * 2.0 ** -24


def _plain_dropout(x: torch.Tensor, seed: int, site: int,
                   rate: float) -> torch.Tensor:
    """What the kernel computes, in torch ops: kept elements are
    ``float(x) / float32(1 - rate)`` rounded once to ``x.dtype``, the
    others 0."""
    keep = keep_mask(x.shape, seed, site, rate, x.device)
    # a tensor divisor, not a Python number: PyTorch's CUDA division by a
    # host scalar multiplies by its reciprocal, which rounds otherwise
    prob = torch.full((), 1.0 - rate, dtype=torch.float32, device=x.device)
    kept = (x.float() / prob).to(x.dtype)
    return torch.where(keep, kept, torch.zeros_like(x))


def dropout_cuda(x: torch.Tensor, seed: torch.Tensor, site: int,
                 rate: float) -> torch.Tensor:
    """Launch ``csrc/dropout.cu`` on ``x``'s current stream; ``seed`` is an
    int64 tensor of one element on ``x``'s device, read by the kernel."""
    if x.device.type != "cuda":
        raise ValueError(f"dropout_cuda needs a CUDA tensor, got {x.device}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dropout kernel takes fp32/bf16/fp16, got {x.dtype}")
    if (seed.dtype != torch.int64 or seed.numel() != 1
            or seed.device != x.device):
        raise ValueError("dropout kernel needs an int64 seed of one element "
                         f"on {x.device}, got {seed.dtype} {tuple(seed.shape)} "
                         f"on {seed.device}")
    if not 0 <= site < 2**32:
        raise ValueError(f"dropout site {site} out of 32 bits")
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    lib = _cuda.load("dropout", _SIGNATURES)
    err = lib.dtf_dropout(
        x.data_ptr(), out.data_ptr(), x.numel(), seed.data_ptr(), site,
        threshold(rate), float(torch.tensor(1.0 - rate, dtype=torch.float32)),
        _DTYPES[x.dtype], x.device.index or 0,
        _cuda.stream_handle(x.device))
    _cuda.check(lib, err, "dropout")
    _cuda.launches["dropout"] += 1
    return out


def _apply(x, seed, site, rate):
    if x.device.type == "cpu":
        return _plain_dropout(x, int(seed), site, rate)
    if not torch.is_tensor(seed):
        # a fill kernel: the seed reaches the card without a host sync
        seed = torch.full((1,), seed, dtype=torch.int64, device=x.device)
    return dropout_cuda(x, seed, site, rate)


class DropoutFn(torch.autograd.Function):
    """The backward is the same mask and scale on the gradient: only the
    seed is saved, never the mask."""

    @staticmethod
    def forward(ctx, x, seed, site, rate):
        ctx.seed, ctx.site, ctx.rate = seed, site, rate
        return _apply(x, seed, site, rate)

    @staticmethod
    def backward(ctx, dy):
        return _apply(dy, ctx.seed, ctx.site, ctx.rate), None, None, None


def dropout(x: torch.Tensor, rate: float, seed, site: int = 0
            ) -> torch.Tensor:
    """flax ``nn.Dropout`` in training: each element kept with
    probability ``1 - rate`` and scaled by ``1 / (1 - rate)``, the mask
    drawn from ``(seed, site)`` (module docstring).  ``rate`` 0 is the
    identity."""
    if not rate:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return DropoutFn.apply(x, seed, site, rate)
    return _apply(x, seed, site, rate)
