"""The port's flash attention (K2, K3, K3f) and attention dispatch against
JAX.

The JAX side runs its Pallas kernels in interpret mode on the CPU, as
``tests/test_flash_attention.py`` does; the port's side is the plain
twins that its CUDA kernels are checked against on the card
(``chip_smoke.py``).  Inputs come from numpy with a fixed seed.

Tolerance: fp32 forward at atol 2e-5 and gradients at atol 5e-5, the
JAX package's own flash-vs-XLA tolerances: both sides compute in fp32,
only the summation order differs (online softmax over blocks in JAX, one
pass here).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.ops.attention import (
    dot_product_attention as jax_dpa,
)
from distributedtensorflow_tpu.ops.flash_attention import (
    flash_attention as jax_flash,
)
from distributedtensorflow_tpu_torch.ops import _cuda
from distributedtensorflow_tpu_torch.ops import attention as tattn
from distributedtensorflow_tpu_torch.ops import flash_attention as fa
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

B, S, H, D = 2, 64, 4, 32

CASES = {
    "causal": dict(causal=True),
    "causal_window": dict(causal=True, window=24),
    "gqa_half": dict(causal=True, hkv=2),
    "gqa_quarter": dict(causal=True, hkv=1),
    "padding": dict(causal=True, padding=True),
    "segments": dict(causal=True, segments=True),
    "noncausal_padding": dict(causal=False, padding=True),
}
#: (block_q, block_k, backward_impl) of the JAX kernels: one k block
#: (``_fwd_kernel_1k``) or several (``_fwd_kernel``); the fused backward
#: or the split dq/dkv pair.
VARIANTS = {
    "one_block_fused": (S, S, "pallas"),
    "blocks_split": (16, 32, "pallas_split"),
    "blocks_fused": (32, 16, "pallas"),
}


def _inputs(case, seed=0, dtype=np.float32, seq=S):
    spec = CASES[case]
    rng = np.random.default_rng(seed)
    hkv = spec.get("hkv", H)
    q = rng.standard_normal((B, seq, H, D)).astype(dtype)
    k = rng.standard_normal((B, seq, hkv, D)).astype(dtype)
    v = rng.standard_normal((B, seq, hkv, D)).astype(dtype)
    do = rng.standard_normal((B, seq, H, D)).astype(dtype)
    mask = seg = None
    if spec.get("padding"):
        lens = np.array([seq, 37 * seq // S])
        mask = np.arange(seq)[None, :] < lens[:, None]
    if spec.get("segments"):
        seg = np.cumsum(rng.random((B, seq)) < 0.08, axis=1).astype(np.int32)
    kw = dict(causal=spec["causal"], window=spec.get("window"))
    return (q, k, v, do), mask, seg, kw


def _jax_run(arrs, mask, seg, kw, *, block_q, block_k, impl):
    q, k, v, do = (jnp.asarray(a) for a in arrs)

    def f(q, k, v):
        return jax_flash(q, k, v, mask=None if mask is None else
                         jnp.asarray(mask),
                         segment_ids=None if seg is None else jnp.asarray(seg),
                         interpret=True, backward_impl=impl, block_q=block_q,
                         block_k=block_k, **kw)

    o, vjp = jax.vjp(jax.jit(f), q, k, v)
    return [np.asarray(t, np.float32) for t in (o, *vjp(do))]


def _port_run(arrs, mask, seg, kw, impl=None):
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    o = fa.flash_attention(
        q, k, v, mask=None if mask is None else torch.from_numpy(mask),
        segment_ids=None if seg is None else torch.from_numpy(seg),
        backward_impl=impl, **kw)
    o.backward(torch.from_numpy(arrs[3]))
    return [t.detach().float().numpy() for t in (o, q.grad, k.grad, v.grad)]


@pytest.mark.parametrize("variant", sorted(VARIANTS))
@pytest.mark.parametrize("case", sorted(CASES))
def test_forward_and_grads_match_jax(case, variant):
    """Both sides take the variant's backward: the single sweep (K3f's
    twin) or the split pair (K3's twins)."""
    block_q, block_k, impl = VARIANTS[variant]
    arrs, mask, seg, kw = _inputs(case)
    ref = _jax_run(arrs, mask, seg, kw, block_q=block_q, block_k=block_k,
                   impl=impl)
    got = _port_run(arrs, mask, seg, kw, impl)
    for name, a, r, tol in zip(("o", "dq", "dk", "dv"), got, ref,
                               (2e-5, 5e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(a, r, rtol=0, atol=tol, err_msg=name)


def _twin_args(case, seed, dtype=torch.float32, seq=S):
    """The backward's inputs: q, k, v, dO and the forward's lse and delta
    = rowsum(dO * O), with the case's masks."""
    arrs, mask, seg, kw = _inputs(case, seed=seed, seq=seq)
    q, k, v, do = (torch.from_numpy(a).to(dtype) for a in arrs)
    tmask = None if mask is None else torch.from_numpy(mask)
    tseg = None if seg is None else torch.from_numpy(seg)
    o, lse = fa.flash_forward(q, k, v, mask=tmask, segment_ids=tseg, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    return (arrs, mask, seg, kw), (q, k, v, do, lse, delta, tmask, tseg,
                                   kw["causal"], kw["window"])


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_twin_matches_jax_fused_kernel(case):
    """``_plain_flash_bwd_fused``, fed the forward's lse and delta, against
    JAX's single-sweep kernel (``backward_impl="pallas"``, several q and
    k blocks, interpret mode): dq, dk, dv at atol 5e-5 in fp32."""
    (arrs, mask, seg, kw), args = _twin_args(case, seed=12)
    _, *ref = _jax_run(arrs, mask, seg, kw, block_q=32, block_k=16,
                       impl="pallas")
    got = fa._plain_flash_bwd_fused(*args)
    for name, a, r in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=5e-5,
                                   err_msg=name)


@pytest.mark.parametrize("case", sorted(CASES))
def test_fused_twin_bf16_equals_split_twins(case):
    """In bf16 the single-sweep twin rounds where the split twins round
    (p to dO's dtype, ds once to q's dtype): the same bits."""
    _, args = _twin_args(case, seed=13, dtype=torch.bfloat16)
    fused = fa._plain_flash_bwd_fused(*args)
    split = (fa._plain_flash_bwd_dq(*args),) + fa._plain_flash_bwd_dkv(*args)
    for name, a, b in zip(("dq", "dk", "dv"), fused, split):
        assert a.dtype == torch.bfloat16, name
        assert torch.equal(a, b), name


# The tensor-core kernels (csrc/flash_fwd.cu and csrc/flash_bwd_fused.cu in
# bf16) in PyTorch, tile by tile: the order of their sums and their rounding
# points.  The CUDA kernels run only on the card; this pins what they follow.

#: Three key tiles of the kernels' size.
TILED_SEQ = 3 * fa._TILE


def _tiled_forward(q, k, v, mask, seg, causal, window, tile=fa._TILE):
    """K2: key tiles of ``tile`` rows in ascending order, the running max
    and sum in fp32, p rounded to V's dtype tile by tile before P.V, l
    summing the unrounded p, the output rescaled by exp(m_old - m_new);
    o = acc / l once, lse = m + log(l)."""
    b, s, h, d = q.shape
    sc = fa._scores(q, k, mask, seg, causal, window)
    vf = fa._repeat_kv(v, h // v.shape[2]).float()
    m = torch.full((b, h, s, 1), float("-inf"))
    l = torch.zeros((b, h, s, 1))
    acc = torch.zeros((b, h, s, d))
    for k0 in range(0, s, tile):
        st = sc[..., k0:k0 + tile]
        m_new = torch.maximum(m, st.amax(-1, keepdim=True))
        # no key reached yet: the kernel subtracts 0 and gets p = 0
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new), m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(st - m_use)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum(
            "bhqk,bkhd->bhqd", p.to(v.dtype).float(), vf[:, k0:k0 + tile])
        m = m_new
    return (acc / l).transpose(1, 2).to(q.dtype), (m + torch.log(l))[..., 0]


def _tiled_bwd_fused(q, k, v, do, lse, delta, mask, seg, causal, window,
                     tile=fa._TILE):
    """K3f: p rounded to dO's dtype for dv, ds rounded once to q's dtype
    for dk and dq; a key tile's dk and dv sum the query tiles in ascending
    order for each query head of its GQA group in turn, in fp32, and round
    once; dq sums the key tiles' partials in ascending order in fp32 and
    rounds once."""
    b, s, h, d = q.shape
    hkv = k.shape[2]
    group = h // hkv
    p, ds = fa._plain_grads(q, k, v, do, lse, delta, mask, seg, causal,
                            window)
    pr = p.to(do.dtype).float()
    kf = fa._repeat_kv(k.float(), group)
    dq = torch.zeros((b, s, h, d))
    for k0 in range(0, s, tile):
        dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + tile],
                               kf[:, k0:k0 + tile])
    dk = torch.zeros((b, s, hkv, d))
    dv = torch.zeros((b, s, hkv, d))
    for hg in range(group):
        heads = slice(hg, None, group)  # head hk * group + hg of each kv head
        for q0 in range(0, s, tile):
            rows = slice(q0, q0 + tile)
            dv = dv + torch.einsum("bhqk,bqhd->bkhd", pr[:, heads, rows],
                                   do[:, rows, heads].float())
            dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds[:, heads, rows],
                                   q[:, rows, heads].float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _tiled_run(case, seed, dtype):
    _, args = _twin_args(case, seed=seed, dtype=dtype, seq=TILED_SEQ)
    q, k, v, do, lse, delta, *masks = args
    o, tlse = _tiled_forward(q, k, v, *masks)
    tdelta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    grads = _tiled_bwd_fused(q, k, v, do, tlse, tdelta, *masks)
    return args, (o, tlse, *grads)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["fp32", "bf16"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_kernels_match_plain_twins(case, dtype):
    """The tile-by-tile order of the tensor-core kernels against the plain
    twins (one pass over the whole row), at the tolerances the card's
    check holds the kernels to in bf16 (o atol 2e-2, lse atol 1e-3,
    gradients 1e-2 of their max) and 1e-5 in fp32, where only the order of
    the fp32 sums differs."""
    args, (o, lse, dq, dk, dv) = _tiled_run(case, 15, dtype)
    q, k, v, do, rlse, rdelta, *masks = args
    ro = fa.flash_forward(q, k, v, mask=masks[0], segment_ids=masks[1],
                          causal=masks[2], window=masks[3])[0]
    rdq, rdk, rdv = fa._plain_flash_bwd_fused(*args)
    bf16 = dtype == torch.bfloat16
    assert o.dtype == dq.dtype == dk.dtype == dv.dtype == dtype
    assert (o.float() - ro.float()).abs().max() <= (2e-2 if bf16 else 1e-5)
    assert (lse - rlse).abs().max() <= (1e-3 if bf16 else 1e-5)
    for name, a, r in (("dq", dq, rdq), ("dk", dk, rdk), ("dv", dv, rdv)):
        err = (a.float() - r.float()).abs().max()
        tol = 1e-2 * r.float().abs().max() if bf16 else 1e-5
        assert err <= tol, (name, err)


@pytest.mark.parametrize("case", sorted(CASES))
def test_tiled_kernels_match_jax(case):
    """The same tile-by-tile order against the JAX kernels in interpret
    mode with blocks of the kernels' tile size (the online forward, the
    single-sweep backward), fp32, at this file's tolerances."""
    arrs, mask, seg, kw = _inputs(case, seed=15, seq=TILED_SEQ)
    ref = _jax_run(arrs, mask, seg, kw, block_q=fa._TILE, block_k=fa._TILE,
                   impl="pallas")
    _, (o, _, dq, dk, dv) = _tiled_run(case, 15, torch.float32)
    for name, a, r, tol in zip(("o", "dq", "dk", "dv"), (o, dq, dk, dv), ref,
                               (2e-5, 5e-5, 5e-5, 5e-5)):
        np.testing.assert_allclose(a.numpy(), r, rtol=0, atol=tol,
                                   err_msg=name)


def test_tiled_dq_is_rounded_once():
    """In bf16 the dq partials of the key tiles stay fp32 until the last
    one: rounding each partial would differ from the kernel's sum."""
    args, (_, _, dq, _, _) = _tiled_run("causal", 16, torch.bfloat16)
    q, k, v, do, lse, delta, *masks = args
    _, ds = fa._plain_grads(*args)
    kf = k.float()
    each = sum(torch.einsum("bhqk,bkhd->bqhd", ds[..., k0:k0 + fa._TILE],
                            kf[:, k0:k0 + fa._TILE]).to(torch.bfloat16).float()
               for k0 in range(0, TILED_SEQ, fa._TILE))
    assert not torch.equal(dq.float(), each.to(torch.bfloat16).float())
    once = fa._plain_flash_bwd_dq(*args)
    assert (dq.float() - once.float()).abs().max() \
        <= 2.0**-7 * once.float().abs().max()


def test_kernel_variant_by_dtype():
    """bf16 takes the tensor-core version of every flash kernel ("mma":
    the forward, the single sweep and, since the split pair went to the
    tensor cores, dq and dk/dv too), fp32 the CUDA-core one ("fma");
    anything else raises."""
    for kernel in ("flash_fwd", "flash_bwd_fused", "flash_bwd_dq",
                   "flash_bwd_dkv"):
        assert fa.kernel_variant(torch.bfloat16, kernel) == "mma"
        assert fa.kernel_variant(torch.float32, kernel) == "fma"
        for dtype in (torch.float16, torch.float64, torch.int32):
            with pytest.raises(TypeError, match="fp32/bf16"):
                fa.kernel_variant(dtype, kernel)
    assert fa.kernel_variant(torch.bfloat16) == "mma"
    with pytest.raises(ValueError, match="unknown flash kernel"):
        fa.kernel_variant(torch.bfloat16, "decode_attention")


def test_min_seq_for_pallas_seed():
    """``MIN_SEQ_FOR_PALLAS`` is seeded from ``DTF_MIN_SEQ_FOR_PALLAS``
    (1024 when unset), read as the JAX package reads it."""
    from distributedtensorflow_tpu.ops import flash_attention as jfa

    assert fa.min_seq_from_env({}) == 1024
    assert fa.min_seq_from_env({"DTF_MIN_SEQ_FOR_PALLAS": "512"}) == 512
    assert fa.min_seq_from_env(os.environ) == fa.MIN_SEQ_FOR_PALLAS \
        == jfa.MIN_SEQ_FOR_PALLAS
    with pytest.raises(ValueError):
        fa.min_seq_from_env({"DTF_MIN_SEQ_FOR_PALLAS": "long"})


def test_fused_backward_threshold_is_jaxs():
    """K3f while ``S * D * 4 <= 2 MiB`` (seq 8192 at D 64 exactly fits,
    as on the TPU), the split pair beyond it or under "pallas_split"; a
    value the port does not have raises."""
    assert fa.FUSED_BWD_DQ_SCRATCH_BYTES == 2 * 2**20
    assert fa.BACKWARD_IMPL == "pallas"
    for seq, depth, fused in ((2048, 64, True), (8192, 64, True),
                              (8200, 64, False), (16384, 32, True),
                              (16392, 32, False)):
        assert fa.uses_fused_backward(seq, depth) is fused, (seq, depth)
        assert fa.uses_fused_backward(seq, depth, "pallas") is fused
        assert not fa.uses_fused_backward(seq, depth, "pallas_split")
    with pytest.raises(ValueError, match="implementation"):
        fa.uses_fused_backward(2048, 64, "xla")
    q = torch.zeros(1, 64, 4, 32)
    with pytest.raises(ValueError, match="backward_impl"):
        fa.flash_attention(q, q, q, backward_impl="xla")


@pytest.mark.parametrize("impl,module_default,want", [
    (None, "pallas", "fused"), ("pallas", "pallas_split", "fused"),
    ("pallas_split", "pallas", "split"), (None, "pallas_split", "split")])
def test_backward_dispatch_on_the_cpu(monkeypatch, impl, module_default,
                                      want):
    """``flash_attention``'s backward reaches the twin of the kernel that
    ``backward_impl`` (or, when it is None, ``BACKWARD_IMPL`` as it reads
    when the backward runs) picks, and nothing else."""
    calls = []
    for name in ("_plain_flash_bwd_fused", "_plain_flash_bwd_dq",
                 "_plain_flash_bwd_dkv"):
        real = getattr(fa, name)
        monkeypatch.setattr(fa, name, lambda *a, real=real, name=name: (
            calls.append(name), real(*a))[1])
    arrs, _, _, kw = _inputs("causal", seed=14)
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    o = fa.flash_attention(q, k, v, backward_impl=impl, **kw)
    monkeypatch.setattr(fa, "BACKWARD_IMPL", module_default)
    o.backward(torch.from_numpy(arrs[3]))
    assert calls == (["_plain_flash_bwd_fused"] if want == "fused" else
                     ["_plain_flash_bwd_dq", "_plain_flash_bwd_dkv"])


def test_bf16_rounding_points_match_pallas():
    """At bf16 with one k block, JAX's forward is the one-pass softmax of
    the plain twin: p rounded to V's dtype before P.V; its backward
    rounds p to dO's dtype and ds to q's dtype, as the twins do.  Both
    sides then round the same fp32 values: outputs agree to one bf16 ulp
    of their largest entry."""
    arrs, mask, seg, kw = _inputs("gqa_half", seed=3)
    ref = _jax_run([a.astype(jnp.bfloat16) for a in arrs], mask, seg, kw,
                   block_q=S, block_k=S, impl="pallas")
    q, k, v, do = (torch.from_numpy(a).to(torch.bfloat16) for a in arrs)
    o, lse = fa.flash_forward(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2)
    grads = fa.flash_backward(q, k, v, do, lse, delta, **kw)
    for name, a, r in zip(("o", "dq", "dk", "dv"), (o, *grads), ref):
        assert a.dtype == torch.bfloat16, name
        err = np.abs(a.float().numpy() - r).max()
        assert err <= 2.0**-7 * np.abs(r).max(), (name, err)


def test_fully_masked_rows_are_finite_band_averages():
    """A row that only padding-masked keys reach gets NEG_INF scores, so
    it averages V over its causal band: finite, never NaN, and the same
    whatever the tiling (JAX's value depends on its blocks, so rows like
    this are pinned against the definition, not against JAX)."""
    arrs, _, _, kw = _inputs("causal", seed=5)
    mask = np.ones((B, S), bool)
    mask[1] = False
    q, k, v = (torch.from_numpy(a).requires_grad_(True) for a in arrs[:3])
    o = fa.flash_attention(q, k, v, mask=torch.from_numpy(mask), **kw)
    o.backward(torch.from_numpy(arrs[3]))
    assert all(torch.isfinite(t).all() for t in (o, q.grad, k.grad, v.grad))
    band_mean = np.cumsum(arrs[2][1], axis=0) / np.arange(1, S + 1)[:, None,
                                                                     None]
    np.testing.assert_allclose(o[1].detach().numpy(), band_mean, rtol=0,
                               atol=1e-5)
    # rows that attend at least one key still match JAX
    ref = _jax_run(arrs, mask, None, kw, block_q=32, block_k=32,
                   impl="pallas_split")
    np.testing.assert_allclose(o[0].detach().numpy(), ref[0][0], rtol=0,
                               atol=2e-5)


def test_backward_takes_external_lse_and_delta():
    """``flash_backward`` with the forward's lse and delta = rowsum(dO * O)
    passed in (the ring-attention entry) gives autograd's gradients."""
    arrs, mask, seg, kw = _inputs("segments", seed=7)
    got = _port_run(arrs, mask, seg, kw)
    q, k, v, do = (torch.from_numpy(a) for a in arrs)
    segt = torch.from_numpy(seg)
    o, lse = fa.flash_forward(q, k, v, segment_ids=segt, **kw)
    assert lse.shape == (B, H, S) and lse.dtype == torch.float32
    delta = (do * o).sum(-1).transpose(1, 2)
    grads = fa.flash_backward(q, k, v, do, lse, delta, segment_ids=segt,
                              **kw)
    for a, r in zip(grads, got[1:]):
        np.testing.assert_array_equal(a.numpy(), r)


@pytest.mark.parametrize("case", ["causal", "causal_window", "gqa_quarter",
                                  "segments", "noncausal_padding"])
def test_xla_path_matches_jax(case):
    """``dot_product_attention(implementation="xla")`` against the JAX
    XLA path (``xla_attention`` behind the same dispatch), fp32."""
    arrs, mask, seg, kw = _inputs(case, seed=9)
    jmask = None if mask is None else jnp.asarray(mask)[:, None, None, :]
    ref = np.asarray(jax_dpa(*(jnp.asarray(a) for a in arrs[:3]), mask=jmask,
                             segment_ids=None if seg is None else
                             jnp.asarray(seg), implementation="xla", **kw))
    tmask = None if mask is None else torch.from_numpy(mask)[:, None, None, :]
    got = tattn.dot_product_attention(
        *(torch.from_numpy(a) for a in arrs[:3]), mask=tmask,
        segment_ids=None if seg is None else torch.from_numpy(seg),
        implementation="xla", **kw)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-6)


def test_xla_path_bf16_rounds_where_jax_rounds():
    """bf16: scores rounded to bf16 before the fp32 softmax, weights
    rounded before the product with V, as the JAX XLA path does."""
    arrs, _, _, kw = _inputs("gqa_half", seed=10)
    ref = np.asarray(jax_dpa(*(jnp.asarray(a).astype(jnp.bfloat16)
                               for a in arrs[:3]), implementation="xla",
                             **kw).astype(jnp.float32))
    got = tattn.dot_product_attention(
        *(torch.from_numpy(a).to(torch.bfloat16) for a in arrs[:3]),
        implementation="xla", **kw)
    assert got.dtype == torch.bfloat16
    assert np.abs(got.float().numpy() - ref).max() <= 2.0**-7 * \
        np.abs(ref).max()


def test_dispatch():
    """On the CPU "auto" takes the XLA path (the kernel gate needs a CUDA
    tensor), "pallas" the flash twins; a bad name raises."""
    arrs, _, _, kw = _inputs("causal", seed=11)
    q, k, v = (torch.from_numpy(a) for a in arrs[:3])
    qs = torch.zeros(1, 1024, H, D)
    assert not fa.supported(qs, qs, qs)  # CPU tensor
    _cuda.launches.clear()
    auto = tattn.dot_product_attention(q, k, v, **kw)
    assert torch.equal(auto, tattn.xla_attention(q, k, v, **kw))
    pallas = tattn.dot_product_attention(q, k, v, implementation="pallas",
                                         **kw)
    assert torch.equal(pallas, fa.flash_forward(q, k, v, **kw)[0])
    assert not _cuda.launches
    with pytest.raises(ValueError, match="implementation"):
        tattn.dot_product_attention(q, k, v, implementation="flash")


def test_flash_validation():
    q = torch.zeros(1, 64, 4, 32)
    with pytest.raises(ValueError, match="mask shape"):
        fa.flash_attention(q, q, q, mask=torch.ones(1, 64, 64, dtype=bool))
    with pytest.raises(ValueError, match="requires causal"):
        fa.flash_attention(q, q, q, window=8)
    with pytest.raises(ValueError, match="multiple of 8"):
        fa.flash_attention(q[:, :60], q[:, :60], q[:, :60])
    with pytest.raises(ValueError, match="GQA"):
        fa.flash_attention(q, q[:, :, :3], q[:, :, :3])
    with pytest.raises(ValueError, match="segment_ids"):
        fa.flash_attention(q, q, q, segment_ids=torch.zeros(1, 64))


@pytest.mark.parametrize("launcher", ["flash_forward_cuda",
                                      "flash_bwd_dq_cuda",
                                      "flash_bwd_dkv_cuda",
                                      "flash_bwd_fused_cuda"])
def test_kernel_wrappers_refuse_cpu_tensors(launcher):
    q = torch.zeros(1, 64, 4, 32)
    rows = torch.zeros(1, 4, 64)
    args = (q, q, q) if launcher == "flash_forward_cuda" else \
        (q, q, q, q, rows, rows)
    with pytest.raises(ValueError, match="CUDA"):
        getattr(fa, launcher)(*args)
