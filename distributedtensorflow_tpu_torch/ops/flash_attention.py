"""Flash attention, BSHD, differentiable: the kernels K2, K3 and K3f.

Twin of ``distributedtensorflow_tpu/ops/flash_attention.py``.
:func:`flash_attention` is a :class:`torch.autograd.Function` whose
forward saves ``(q, k, v, o, lse)`` and whose backward computes
``delta = rowsum(dO * O)`` in fp32 outside the kernels (as JAX does with
XLA, ``:801-804``) and hands ``lse`` and ``delta`` to
:func:`flash_backward`, the launcher that ring attention can reuse
(``_flash_backward_pallas_core``, ``:818``).

A CUDA tensor goes to the hand-written kernels: ``csrc/flash_fwd.cu``
(the port of ``_fwd_kernel``/``_fwd_kernel_1k``, ``:333``/``:396``),
``csrc/flash_bwd_fused.cu`` (the single-sweep ``_bwd_fused_kernel``,
``:586``) and ``csrc/flash_bwd.cu`` (the split pair ``_bwd_dq_kernel``/
``_bwd_dkv_kernel``, ``:671``/``:724``).  In bf16 every kernel runs
every product on the tensor cores (``mma.sync`` on bf16 tiles that
``cp.async`` brings to shared memory); in fp32 the products are FMAs on
the CUDA cores (:func:`kernel_variant`).  :func:`flash_backward` picks
between the two backwards as ``_flash_backward_pallas_bhsd`` does
(``:859``): the single sweep while ``S * D * 4`` fits
:data:`FUSED_BWD_DQ_SCRATCH_BYTES`, the split pair beyond it or under
``backward_impl="pallas_split"``.  A CPU tensor goes to the plain twins
:func:`_plain_flash_forward`, :func:`_plain_flash_bwd_fused`,
:func:`_plain_flash_bwd_dq` and :func:`_plain_flash_bwd_dkv`, which the
kernels are checked against on the card.  The twins round where the
kernels round: p to V's dtype before P.V, p to dO's dtype before the dv
product, ds once to q's dtype before the dq and dk products; in fp32
those roundings vanish.

Masking (``_masked_scores``, ``:225``): scale 1/sqrt(D); keys after the
query (causal) or at or below ``q - window`` are left out; keys that the
padding mask drops or of another packed segment get ``NEG_INF = -1e9``.
A row that only such keys reach is finite: it averages V over its causal
band, whatever the tiling (on the TPU the value depends on which blocks
the kernel skipped; on both it is finite, never NaN).

``kv_segment_ids`` (``:436-458``): the keys' segments where they are not
the queries' (ring attention's rotated K/V chunk carries its own), read
by every kernel and twin in place of ``segment_ids`` on the key side;
None reads ``segment_ids`` for both, the kernels' path as before.
"""

from __future__ import annotations

import ctypes
import os

import torch

from . import _cuda

NEG_INF = -1e9


def min_seq_from_env(environ) -> int:
    """The seed of :data:`MIN_SEQ_FOR_PALLAS`: ``DTF_MIN_SEQ_FOR_PALLAS``
    in ``environ`` as an int, 1024 when unset (the JAX package's rule,
    ``flash_attention.py:117``)."""
    return int(environ.get("DTF_MIN_SEQ_FOR_PALLAS", "1024"))


#: Auto-dispatch threshold, seeded from the environment as in the JAX
#: package, whose default 1024 was measured on a TPU
#: (``flash_attention.py:117``); the H100's own gate awaits a measurement
#: of this port's kernels against the plain path.  A mutable module
#: global, read at every call.
MIN_SEQ_FOR_PALLAS = min_seq_from_env(os.environ)
#: Head dims the kernels are built for (templates in ``csrc/``).
HEAD_DIMS = (32, 64)
#: The backward that :func:`flash_attention` takes when its caller names
#: none: "pallas" (the single sweep K3f while ``S * D * 4`` fits
#: :data:`FUSED_BWD_DQ_SCRATCH_BYTES`, else the split pair K3) or
#: "pallas_split" (always the split pair), as ``BACKWARD_IMPL`` (``:574``)
#: in the JAX package.  Read when the backward runs.  JAX's third value,
#: "xla", is this port's ``dot_product_attention(implementation="xla")``.
BACKWARD_IMPL = "pallas"
BACKWARD_IMPLS = ("pallas", "pallas_split")
#: Dispatch threshold of the single-sweep backward, copied from the JAX
#: package (``:583``): there it is the TPU's VMEM budget for the (S, D)
#: fp32 dq scratch.  The kernel here keeps that sum in device memory, so
#: the H100's own threshold waits for the two backwards' measured times.
FUSED_BWD_DQ_SCRATCH_BYTES = 2 * 2**20
#: Query and key rows of a kernel tile (``kBQ``/``kBK`` in
#: ``csrc/flash_common.cuh``).
_TILE = 64
#: The kernels' launch-count keys.
_KERNELS = ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq", "flash_bwd_dkv")

_FWD_SIGNATURES = {"dtf_flash_fwd": [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]}
_FUSED_SIGNATURES = {
    "dtf_flash_bwd_fused": [ctypes.c_void_p] * 15 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p]}
_BWD_SIGNATURES = {
    "dtf_flash_bwd_dq": [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
    "dtf_flash_bwd_dkv": [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
    + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p],
}


def kernel_variant(dtype, kernel="flash_fwd") -> str:
    """Which version of ``kernel`` (a launch-count key) runs for operands
    of ``dtype``: "mma" (bf16 tiles, every product on the tensor cores:
    every kernel in bf16) or "fma" (fp32 products on the CUDA cores:
    every kernel in fp32, since the tensor cores have no full-precision
    fp32 product).  Another dtype raises, as the kernels do."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"flash kernels take fp32/bf16, got {dtype}")
    if kernel not in _KERNELS:
        raise ValueError(f"unknown flash kernel {kernel!r}")
    return "mma" if dtype == torch.bfloat16 else "fma"


def _gqa_ok(qshape, kshape) -> bool:
    """Same (B, S, D) and q heads an integer multiple of kv heads."""
    return (qshape[0] == kshape[0] and qshape[1] == kshape[1]
            and qshape[3] == kshape[3] and kshape[2] > 0
            and qshape[2] % kshape[2] == 0)


def _is_padding_mask(mask, qshape) -> bool:
    """(B, S) or its broadcast form (B, 1, 1, S)."""
    b, s = qshape[0], qshape[1]
    return tuple(mask.shape) in ((b, s), (b, 1, 1, s))


def _is_segment_ids(segment_ids, qshape) -> bool:
    return (tuple(segment_ids.shape) == (qshape[0], qshape[1])
            and not segment_ids.dtype.is_floating_point
            and segment_ids.dtype != torch.bool)


def supported(q, k, v, *, mask=None, segment_ids=None) -> bool:
    """True when ``implementation="auto"`` should take the kernels: a
    CUDA tensor, seq >= :data:`MIN_SEQ_FOR_PALLAS` in multiples of 8, the
    shape rules of the JAX gate (``:129-142``), and a head dim the
    kernels are built for."""
    if q.dim() != 4 or k.shape != v.shape or not _gqa_ok(q.shape, k.shape):
        return False
    if q.device.type != "cuda":
        return False
    seq = q.shape[1]
    if seq < MIN_SEQ_FOR_PALLAS or seq % 8:
        return False
    if q.dtype not in (torch.bfloat16, torch.float32) \
            or q.shape[3] not in HEAD_DIMS:
        return False
    if segment_ids is not None and not _is_segment_ids(segment_ids, q.shape):
        return False
    return mask is None or _is_padding_mask(mask, q.shape)


def flash_attention(q, k, v, *, mask=None, segment_ids=None, causal=False,
                    window=None, backward_impl=None, kv_segment_ids=None):
    """Flash attention of q (B, S, H, D) against k, v (B, S, Hkv, D).

    ``mask`` is a key padding mask (B, S) or (B, 1, 1, S), True = attend;
    ``segment_ids`` an int (B, S) tensor of packed sequences and
    ``kv_segment_ids`` the keys' own, where they differ; ``window``
    (needs ``causal``) keeps keys in ``(i - window, i]``;
    ``backward_impl`` picks the backward (None = :data:`BACKWARD_IMPL`).
    Raises for shapes the kernels cannot take, as the JAX entry does."""
    if q.dim() != 4 or k.shape != v.shape or not _gqa_ok(q.shape, k.shape):
        raise ValueError(
            f"flash_attention needs BSHD q/k/v with matching (B, S, D) and "
            f"q heads a multiple of kv heads (GQA), got {tuple(q.shape)} "
            f"{tuple(k.shape)} {tuple(v.shape)}")
    if q.shape[1] % 8:
        raise ValueError(f"sequence length {q.shape[1]} is not a multiple "
                         "of 8")
    if mask is not None and not _is_padding_mask(mask, q.shape):
        raise ValueError(f"mask shape {tuple(mask.shape)} unsupported: need "
                         "(B, S) or (B, 1, 1, S) padding mask")
    if segment_ids is not None and not _is_segment_ids(segment_ids, q.shape):
        raise ValueError(
            f"segment_ids shape/dtype unsupported: need int (B, S), got "
            f"{tuple(segment_ids.shape)} {segment_ids.dtype}")
    _check_kv_segments(segment_ids, kv_segment_ids, q.shape)
    if window is not None:
        if not causal:
            raise ValueError("window (sliding-window attention) requires "
                             "causal=True")
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        if window >= q.shape[1]:
            window = None
    if backward_impl is not None:
        _check_backward_impl(backward_impl)
    if mask is not None:
        mask = mask.reshape(q.shape[0], q.shape[1]).to(torch.bool)
    return FlashAttentionFn.apply(q, k, v, mask, segment_ids, bool(causal),
                                  window, backward_impl, kv_segment_ids)


def _check_kv_segments(segment_ids, kv_segment_ids, qshape):
    """A key-side segment array goes with a query-side one, shaped and
    typed like it."""
    if kv_segment_ids is None:
        return
    if segment_ids is None:
        raise ValueError("kv_segment_ids needs segment_ids (the queries')")
    if not _is_segment_ids(kv_segment_ids, qshape):
        raise ValueError(
            f"kv_segment_ids shape/dtype unsupported: need int (B, S), got "
            f"{tuple(kv_segment_ids.shape)} {kv_segment_ids.dtype}")


class FlashAttentionFn(torch.autograd.Function):
    """Twin of the custom VJP ``_flash`` (``:1090-1140``)."""

    @staticmethod
    def forward(ctx, q, k, v, mask, segment_ids, causal, window,
                backward_impl, kv_segment_ids=None):
        o, lse = flash_forward(q, k, v, mask=mask, segment_ids=segment_ids,
                               causal=causal, window=window,
                               kv_segment_ids=kv_segment_ids)
        ctx.save_for_backward(q, k, v, o, lse, mask, segment_ids,
                              kv_segment_ids)
        ctx.causal, ctx.window = causal, window
        ctx.backward_impl = backward_impl
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse, mask, segment_ids, kv_segment_ids = \
            ctx.saved_tensors
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dq, dk, dv = flash_backward(
            q, k, v, do, lse, delta, mask=mask, segment_ids=segment_ids,
            causal=ctx.causal, window=ctx.window,
            backward_impl=ctx.backward_impl, kv_segment_ids=kv_segment_ids)
        return dq, dk, dv, None, None, None, None, None, None


def flash_forward(q, k, v, *, mask=None, segment_ids=None, causal=False,
                  window=None, kv_segment_ids=None):
    """``(o, lse)``: o (B, S, H, D) in q's dtype, lse (B, H, S) fp32.  The
    kernel for CUDA tensors, :func:`_plain_flash_forward` for CPU ones
    (``_flash_forward``, ``:484``)."""
    if q.device.type == "cpu":
        return _plain_flash_forward(q, k, v, mask, segment_ids, causal,
                                    window, kv_segment_ids)
    return flash_forward_cuda(q, k, v, mask, segment_ids, causal, window,
                              kv_segment_ids)


def _check_backward_impl(impl):
    if impl not in BACKWARD_IMPLS:
        raise ValueError(
            f"backward_impl={impl!r}: expected one of {BACKWARD_IMPLS} (the "
            "XLA path is dot_product_attention(implementation=\"xla\"))")


def uses_fused_backward(seq: int, depth: int, backward_impl=None) -> bool:
    """Whether :func:`flash_backward` takes the single sweep (K3f) for
    this sequence length and head dim: under "pallas" while the (S, D)
    fp32 dq sum fits :data:`FUSED_BWD_DQ_SCRATCH_BYTES`, as JAX decides
    (``:859``); never under "pallas_split"."""
    impl = backward_impl or BACKWARD_IMPL
    _check_backward_impl(impl)
    return impl == "pallas" and seq * depth * 4 <= FUSED_BWD_DQ_SCRATCH_BYTES


def flash_backward(q, k, v, do, lse, delta, *, mask=None, segment_ids=None,
                   causal=False, window=None, backward_impl=None,
                   kv_segment_ids=None):
    """``(dq, dk, dv)`` from the forward's ``lse`` and ``delta =
    rowsum(dO * O)``, both (B, H, S) fp32, passed in: the K3f/K3 launcher
    (the kernels for CUDA tensors, the plain twins for CPU ones), the
    single sweep or the split pair as :func:`uses_fused_backward` says
    (``_flash_backward_pallas_core``, ``:819``; ring attention passes its
    global ``lse``)."""
    args = (q, k, v, do, lse, delta, mask, segment_ids, causal, window,
            kv_segment_ids)
    fused = uses_fused_backward(q.shape[1], q.shape[3], backward_impl)
    if q.device.type == "cpu":
        if fused:
            return _plain_flash_bwd_fused(*args)
        return (_plain_flash_bwd_dq(*args),) + _plain_flash_bwd_dkv(*args)
    if fused:
        return flash_bwd_fused_cuda(*args)
    return (flash_bwd_dq_cuda(*args),) + flash_bwd_dkv_cuda(*args)


# --------------------------------------------------------------- plain twins


def _repeat_kv(x, group):
    return x if group == 1 else x.repeat_interleave(group, dim=2)


def _scores(q, k, mask, segment_ids, causal, window, kv_segment_ids=None):
    """The (B, H, S, S) fp32 masked, scaled scores of the kernels; the
    keys' segments are ``kv_segment_ids`` when given."""
    b, s, h, d = q.shape
    kf = _repeat_kv(k.float(), h // k.shape[2])
    sc = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf) * (1.0 / d ** 0.5)
    pos = torch.arange(s, device=q.device)
    out = torch.zeros((s, s), dtype=torch.bool, device=q.device)
    if causal:
        out |= pos[None, :] > pos[:, None]
    if window is not None:
        out |= pos[None, :] <= pos[:, None] - window
    drop = torch.zeros((b, 1, 1, s), dtype=torch.bool, device=q.device)
    if mask is not None:
        drop = drop | ~mask.reshape(b, 1, 1, s).to(torch.bool)
    if segment_ids is not None:
        kseg = segment_ids if kv_segment_ids is None else kv_segment_ids
        drop = drop | (segment_ids[:, None, :, None]
                       != kseg[:, None, None, :])
    sc = torch.where(drop, NEG_INF, sc)
    return torch.where(out, float("-inf"), sc)


def _plain_flash_forward(q, k, v, mask=None, segment_ids=None, causal=False,
                         window=None, kv_segment_ids=None):
    """The forward in one pass over the whole row (``_fwd_kernel_1k``):
    fp32 softmax, p rounded to V's dtype before P.V, the unrounded sum
    of p as the divisor; lse = max + log(sum)."""
    h = q.shape[2]
    sc = _scores(q, k, mask, segment_ids, causal, window, kv_segment_ids)
    m = sc.amax(-1, keepdim=True)
    p = torch.exp(sc - m)
    l = p.sum(-1, keepdim=True)
    vf = _repeat_kv(v, h // v.shape[2]).float()
    o = torch.einsum("bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf) / l
    return o.transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _plain_grads(q, k, v, do, lse, delta, mask, segment_ids, causal, window,
                 kv_segment_ids=None):
    """p and ds (rounded to q's dtype) of the backward, (B, H, S, S)."""
    h = q.shape[2]
    sc = _scores(q, k, mask, segment_ids, causal, window, kv_segment_ids)
    p = torch.exp(sc - lse[..., None])
    vf = _repeat_kv(v.float(), h // v.shape[2])
    dp = torch.einsum("bqhd,bkhd->bhqk", do.float(), vf)
    scale = 1.0 / q.shape[3] ** 0.5
    ds = (p * (dp - delta[..., None])) * scale
    return p, ds.to(q.dtype).float()


def _dq_from(ds, q, k):
    kf = _repeat_kv(k.float(), q.shape[2] // k.shape[2])
    return torch.einsum("bhqk,bkhd->bqhd", ds, kf).to(q.dtype)


def _dkv_from(p, ds, q, k, v, do):
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(do.dtype).float(), do.float())
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, q.float())
    dk = dk.reshape(b, s, hkv, h // hkv, d).sum(3)
    dv = dv.reshape(b, s, hkv, h // hkv, d).sum(3)
    return dk.to(k.dtype), dv.to(v.dtype)


def _plain_flash_bwd_dq(q, k, v, do, lse, delta, mask=None, segment_ids=None,
                        causal=False, window=None, kv_segment_ids=None):
    """dq = ds k, ds rounded to q's dtype, fp32 sums (``_bwd_dq_kernel``)."""
    _, ds = _plain_grads(q, k, v, do, lse, delta, mask, segment_ids, causal,
                         window, kv_segment_ids)
    return _dq_from(ds, q, k)


def _plain_flash_bwd_dkv(q, k, v, do, lse, delta, mask=None,
                         segment_ids=None, causal=False, window=None,
                         kv_segment_ids=None):
    """(dk, dv) = (ds^T q, p^T dO), p rounded to dO's dtype, the query
    heads of a GQA group summed in fp32 before one rounding
    (``_bwd_dkv_kernel``)."""
    p, ds = _plain_grads(q, k, v, do, lse, delta, mask, segment_ids, causal,
                         window, kv_segment_ids)
    return _dkv_from(p, ds, q, k, v, do)


def _plain_flash_bwd_fused(q, k, v, do, lse, delta, mask=None,
                           segment_ids=None, causal=False, window=None,
                           kv_segment_ids=None):
    """(dq, dk, dv) from one p and one ds (``_bwd_fused_kernel``): the
    split twins' values at the same rounding points, ds rounded once to
    q's dtype for both the dq and the dk product (``:645``)."""
    p, ds = _plain_grads(q, k, v, do, lse, delta, mask, segment_ids, causal,
                         window, kv_segment_ids)
    return (_dq_from(ds, q, k),) + _dkv_from(p, ds, q, k, v, do)


# ------------------------------------------------------------------- kernels


def _kernel_operand(t, dtype, device):
    """``t`` as the kernels read it: on ``device``, of ``dtype``, head dim
    contiguous, rows 16-byte aligned (a copy only where it is not)."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"flash kernels need all operands {dtype} on "
                         f"{device}, got {t.dtype} on {t.device}")
    vec = 16 // t.element_size()
    if t.stride(3) != 1 or any(st % vec for st in t.stride()[:3]) \
            or t.data_ptr() % 16:
        t = t.contiguous()
    return t


def _kernel_masks(q, mask, segment_ids, kv_segment_ids=None):
    """The mask as bytes and the segment arrays as int32, each (B, S)
    contiguous on q's device; the key-side array only where one is given
    (the kernels then read it for the keys)."""
    b, s = q.shape[0], q.shape[1]
    m = None if mask is None else \
        mask.reshape(b, s).to(device=q.device, dtype=torch.bool).contiguous()
    seg, kseg = (None if t is None else
                 t.to(device=q.device, dtype=torch.int32).contiguous()
                 for t in (segment_ids, kv_segment_ids))
    if kseg is not None and seg is None:
        raise ValueError("kv_segment_ids needs segment_ids (the queries')")
    return m, seg, kseg


def _check_kernel_shapes(q, k, v, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what} kernel needs CUDA tensors, got {q.device}")
    if q.dim() != 4 or k.shape != v.shape or not _gqa_ok(q.shape, k.shape):
        raise ValueError(f"{what} kernel needs BSHD q/k/v with GQA heads, "
                         f"got {tuple(q.shape)} {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"{what} kernel takes fp32/bf16, got {q.dtype}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"{what} kernel is built for head dims {HEAD_DIMS}, "
                         f"got {q.shape[3]}")


def _ptr(t):
    return None if t is None else t.data_ptr()


def _window_arg(window):
    return 0 if window is None else int(window)


def flash_forward_cuda(q, k, v, mask=None, segment_ids=None, causal=False,
                       window=None, kv_segment_ids=None):
    """Launch ``csrc/flash_fwd.cu`` on the current stream; returns
    ``(o, lse)``.

    The port of ``_fwd_kernel``/``_fwd_kernel_1k``
    (``distributedtensorflow_tpu/ops/flash_attention.py:333``/``:396``).
    Bound on the H100 by operations: ``4 * B * H * S^2 * D`` flops (half
    under the causal mask) over 989 TFLOP/s in bf16.  bf16: Q.K^T and P.V
    on the tensor cores, Q as register fragments, K and V tiles
    double-buffered by ``cp.async``, P from registers; fp32: FMAs on the
    CUDA cores (:func:`kernel_variant`)."""
    _check_kernel_shapes(q, k, v, "flash forward")
    q, k, v = (_kernel_operand(t, q.dtype, q.device) for t in (q, k, v))
    m, seg, kseg = _kernel_masks(q, mask, segment_ids, kv_segment_ids)
    b, s, h, d = q.shape
    o = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3],
                                      *v.stride()[:3])
    lib = _cuda.load("flash_fwd", _FWD_SIGNATURES)
    err = lib.dtf_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
        lse.data_ptr(), _ptr(m), _ptr(seg), _ptr(kseg),
        ctypes.addressof(strides), b, h,
        k.shape[2], s, d, int(causal), _window_arg(window), 1.0 / d ** 0.5,
        q.dtype == torch.bfloat16, q.device.index or 0,
        _cuda.stream_handle(q.device))
    _cuda.launches["flash_fwd"] += 1
    _cuda.check(lib, err, "flash_fwd")
    return o, lse


def _bwd_operands(q, k, v, do, lse, delta, mask, segment_ids, what,
                  kv_segment_ids=None):
    _check_kernel_shapes(q, k, v, what)
    if do.shape != q.shape:
        raise ValueError(f"{what}: dO {tuple(do.shape)} is not shaped like "
                         f"q {tuple(q.shape)}")
    b, s, h, _ = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.shape != (b, h, s) or t.dtype != torch.float32 \
                or t.device != q.device:
            raise ValueError(f"{what}: {name} must be fp32 (B, H, S) = "
                             f"{(b, h, s)} on {q.device}, got "
                             f"{tuple(t.shape)} {t.dtype} on {t.device}")
    q, k, v, do = (_kernel_operand(t, q.dtype, q.device)
                   for t in (q, k, v, do))
    m, seg, kseg = _kernel_masks(q, mask, segment_ids, kv_segment_ids)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3],
                                       *v.stride()[:3], *do.stride()[:3])
    return (q, k, v, do, lse.contiguous(), delta.contiguous(), m, seg, kseg,
            strides)


def flash_bwd_fused_cuda(q, k, v, do, lse, delta, mask=None,
                         segment_ids=None, causal=False, window=None,
                         kv_segment_ids=None):
    """Launch ``csrc/flash_bwd_fused.cu``; returns ``(dq, dk, dv)``, dq
    shaped like q, dk and dv like k and v.

    The port of ``_bwd_fused_kernel``
    (``distributedtensorflow_tpu/ops/flash_attention.py:586``).  Bound by
    operations: five products (s, dp, dv, dk, dq) of ``2 * B * H * S^2 *
    D`` flops, half under the causal mask.  Scratch: an fp32 sum of dq,
    (B, H, S rounded up to whole tiles, D), and one int counter per (B, H,
    query tile), plus a ticket.
    bf16: all five products on the tensor cores, two blocks per SM; fp32:
    FMAs on the CUDA cores (:func:`kernel_variant`).  Bit-identical on a
    rerun in both."""
    q, k, v, do, lse, delta, m, seg, kseg, strides = _bwd_operands(
        q, k, v, do, lse, delta, mask, segment_ids, "flash fused backward",
        kv_segment_ids)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, s, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, hkv, d), dtype=v.dtype, device=q.device)
    tiles = -(-s // _TILE)
    dq_acc = torch.empty((b, h, tiles * _TILE, d), dtype=torch.float32,
                         device=q.device)
    counters = torch.empty(1 + b * h * tiles, dtype=torch.int32,
                           device=q.device)
    lib = _cuda.load("flash_bwd_fused", _FUSED_SIGNATURES)
    err = lib.dtf_flash_bwd_fused(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), dq_acc.data_ptr(), counters.data_ptr(), _ptr(m),
        _ptr(seg), _ptr(kseg), ctypes.addressof(strides), b, h, hkv, s, d,
        int(causal),
        _window_arg(window), 1.0 / d ** 0.5, q.dtype == torch.bfloat16,
        q.device.index or 0, _cuda.stream_handle(q.device))
    _cuda.launches["flash_bwd_fused"] += 1
    _cuda.check(lib, err, "flash_bwd_fused")
    return dq, dk, dv


def flash_bwd_dq_cuda(q, k, v, do, lse, delta, mask=None, segment_ids=None,
                      causal=False, window=None, kv_segment_ids=None):
    """Launch the dq kernel of ``csrc/flash_bwd.cu``; returns dq.

    The port of ``_bwd_dq_kernel``
    (``distributedtensorflow_tpu/ops/flash_attention.py:671``).  Bound by
    operations: three products (s, dp, dq) of ``2 * B * H * S^2 * D``
    flops, half under the causal mask.  bf16: the three products on the
    tensor cores, Q and dO as register fragments, K and V tiles
    double-buffered by ``cp.async``; fp32: FMAs on the CUDA cores."""
    q, k, v, do, lse, delta, m, seg, kseg, strides = _bwd_operands(
        q, k, v, do, lse, delta, mask, segment_ids, "flash dq",
        kv_segment_ids)
    b, s, h, d = q.shape
    dq = torch.empty((b, s, h, d), dtype=q.dtype, device=q.device)
    lib = _cuda.load("flash_bwd", _BWD_SIGNATURES)
    err = lib.dtf_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), _ptr(m), _ptr(seg),
        _ptr(kseg), ctypes.addressof(strides), b, h, k.shape[2], s, d,
        int(causal),
        _window_arg(window), 1.0 / d ** 0.5, q.dtype == torch.bfloat16,
        q.device.index or 0, _cuda.stream_handle(q.device))
    _cuda.launches["flash_bwd_dq"] += 1
    _cuda.check(lib, err, "flash_bwd_dq")
    return dq


def flash_bwd_dkv_cuda(q, k, v, do, lse, delta, mask=None, segment_ids=None,
                       causal=False, window=None, kv_segment_ids=None):
    """Launch the dk/dv kernel of ``csrc/flash_bwd.cu``; returns
    ``(dk, dv)`` shaped like k and v.

    The port of ``_bwd_dkv_kernel``
    (``distributedtensorflow_tpu/ops/flash_attention.py:724``).  Bound by
    operations: four products (s, dp, dv, dk) of ``2 * B * H * S^2 * D``
    flops, half under the causal mask.  bf16: the four products on the
    tensor cores, K and V as register fragments, Q and dO tiles
    double-buffered by ``cp.async``, scores transposed; fp32: FMAs on the
    CUDA cores."""
    q, k, v, do, lse, delta, m, seg, kseg, strides = _bwd_operands(
        q, k, v, do, lse, delta, mask, segment_ids, "flash dk/dv",
        kv_segment_ids)
    b, s, h, d = q.shape
    hkv = k.shape[2]
    dk = torch.empty((b, s, hkv, d), dtype=k.dtype, device=q.device)
    dv = torch.empty((b, s, hkv, d), dtype=v.dtype, device=q.device)
    lib = _cuda.load("flash_bwd", _BWD_SIGNATURES)
    err = lib.dtf_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(),
        _ptr(m), _ptr(seg), _ptr(kseg), ctypes.addressof(strides), b, h, hkv,
        s, d, int(causal), _window_arg(window), 1.0 / d ** 0.5,
        q.dtype == torch.bfloat16, q.device.index or 0,
        _cuda.stream_handle(q.device))
    _cuda.launches["flash_bwd_dkv"] += 1
    _cuda.check(lib, err, "flash_bwd_dkv")
    return dk, dv
