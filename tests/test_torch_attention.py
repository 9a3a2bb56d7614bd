"""The port's attention ops against the JAX package's.

``_plain_decode_attention`` is the twin of the TPU decode kernel
``_decode_attn_kernel``, run here as the JAX tests run it on the CPU
(interpret mode); on the card the port's CUDA kernel is held against
the plain twin by ``chip_smoke.py``.  Inputs come from numpy with a
fixed seed and feed both packages.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.ops import attention as jattn
from distributedtensorflow_tpu_torch.ops import _cuda
from distributedtensorflow_tpu_torch.ops import attention as tattn
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: only the summation order differs.  bf16: q/K/V are the same bf16
# values on both sides, but a weight near a bf16 rounding boundary may
# round the other way after the normalisation, and the output is rounded
# to bf16 (~4e-3 relative at these magnitudes).
TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _rand(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _to(x, dt):
    j, t = DTYPES[dt]
    return jnp.asarray(x).astype(j), torch.from_numpy(x).to(t)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2)])
@pytest.mark.parametrize("window", [None, 8])
def test_plain_decode_matches_pallas_interpret(dt, h, h_kv, window):
    b, s, d, ix = 2, 64, 32, 40
    lo = 0 if window is None else ix - window + 1
    rng = np.random.default_rng(h_kv * 10 + (window or 0))
    jq, tq = _to(_rand(rng, (b, 1, h, d)), dt)
    jk, tk = _to(_rand(rng, (b, h_kv, s, d)), dt)
    jv, tv = _to(_rand(rng, (b, h_kv, s, d)), dt)
    k_idx = np.arange(s)
    valid = ((k_idx >= lo) & (k_idx <= ix)).astype(np.int32)[None]
    ref = jattn._pallas_decode_attention(jq, jk, jv, jnp.asarray(valid),
                                         interpret=True)
    got = tattn._plain_decode_attention(tq, tk, tv, lo, ix + 1)
    assert got.shape == (b, 1, h, d) and got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=TOL[dt])


@pytest.mark.parametrize("s_new", [1, 4])
@pytest.mark.parametrize("h,h_kv,window", [(4, 4, None), (4, 2, None),
                                           (4, 2, 6)])
def test_cached_decode_attention_matches(s_new, h, h_kv, window):
    """One step (s_new=1: the JAX side runs its kernel in interpret mode,
    the port its plain twin) and a prefill chunk (s_new=4: the grouped
    einsum path on both sides), against a cache already holding 10
    positions; the new K/V land at the index and the index advances."""
    b, s, d, ix = 2, 32, 16, 10
    rng = np.random.default_rng(s_new + h_kv)
    q = _rand(rng, (b, s_new, h, d))
    k_new = _rand(rng, (b, s_new, h_kv, d))
    v_new = _rand(rng, (b, s_new, h_kv, d))
    ck = _rand(rng, (b, h_kv, s, d))
    cv = _rand(rng, (b, h_kv, s, d))
    j_out, j_k, j_v, j_ix = jattn.cached_decode_attention(
        jnp.asarray(q), jnp.asarray(k_new), jnp.asarray(v_new),
        jnp.asarray(ck), jnp.asarray(cv), jnp.int32(ix), window=window)
    t_ck, t_cv = torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy())
    t_out, t_k, t_v, t_ix = tattn.cached_decode_attention(
        torch.from_numpy(q), torch.from_numpy(k_new), torch.from_numpy(v_new),
        t_ck, t_cv, ix, window=window)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(t_k.numpy(), np.asarray(j_k))
    np.testing.assert_array_equal(t_v.numpy(), np.asarray(j_v))
    assert t_ix == int(j_ix) == ix + s_new
    assert t_k is t_ck  # written in place, the caller's tensor returned


def test_cached_decode_attention_refuses_overflow():
    ck = torch.zeros(1, 2, 8, 16)
    x = torch.zeros(1, 2, 2, 16)
    with pytest.raises(ValueError, match="cannot take"):
        tattn.cached_decode_attention(x, x, x, ck, ck.clone(), 7)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (4, 2)])
def test_paged_decode_attention_matches(dt, h, h_kv):
    b, d, bs, max_blocks = 3, 8, 4, 3
    rng = np.random.default_rng(h_kv)
    num_blocks = b * max_blocks
    jq, tq = _to(_rand(rng, (b, h, d)), dt)
    jk, tk = _to(_rand(rng, (num_blocks + 1, bs, h_kv, d)), dt)
    jv, tv = _to(_rand(rng, (num_blocks + 1, bs, h_kv, d)), dt)
    tables = rng.permutation(num_blocks).reshape(b, max_blocks).astype(
        np.int32)
    tables[2, 2] = num_blocks  # an unallocated entry: the scratch block
    seq_lens = np.array([5, 12, 7], np.int32)
    ref = jattn.paged_decode_attention(jq, jk, jv, jnp.asarray(tables),
                                       jnp.asarray(seq_lens))
    got = tattn.paged_decode_attention(
        tq, tk, tv, torch.from_numpy(tables).long(),
        torch.from_numpy(seq_lens).long())
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=TOL[dt])


def test_cpu_dispatch_launches_nothing_and_kernel_refuses_cpu():
    rng = np.random.default_rng(0)
    q = torch.from_numpy(_rand(rng, (1, 1, 2, 16)))
    k = torch.from_numpy(_rand(rng, (1, 2, 8, 16)))
    _cuda.launches.clear()
    out = tattn.decode_attention(q, k, k, 0, 5)
    assert torch.equal(out, tattn._plain_decode_attention(q, k, k, 0, 5))
    assert not _cuda.launches
    with pytest.raises(ValueError, match="CUDA"):
        tattn.decode_attention_cuda(q, k, k, 0, 5)


def test_kernel_shared_memory_budget():
    """One block of a split of ``chunk`` rows: the scores launch holds the
    group's queries and scores, the output launch the group's weights,
    8 warps' partial outputs of one pass of at most 8 heads, the band's
    max and sum per head and a flag; the larger of the two counts."""
    assert tattn.decode_smem_bytes(12, 12, 64, 352) == \
        4 * (352 + 8 * 64 + 2 + 1)
    assert tattn.decode_smem_bytes(12, 1, 64, 32) == \
        4 * (12 * 32 + 8 * 8 * 64 + 2 * 12 + 1)
    assert tattn.decode_smem_bytes(16, 1, 64, 4096) == \
        4 * (16 * 4096 + 8 * 8 * 64 + 2 * 16 + 1)
    # a group of 128 heads: the queries of the scores launch dominate
    assert tattn.decode_smem_bytes(128, 1, 16, 8) == 4 * 128 * (16 + 8)
    # what the first version refused now fits: the plan's chunks at 12
    # query heads a group, and 16 a group at 65536 positions
    for b, h, h_kv, s in ((4, 12, 1, 2048), (4, 16, 2, 8192),
                          (1, 16, 1, 65536), (1, 12, 12, 65536)):
        _, chunk = tattn.decode_plan(b, h, h_kv, 64, 0, s)
        assert tattn.decode_smem_bytes(h, h_kv, 64, chunk) <= tattn.SMEM_LIMIT


#: (B, H, Hkv, D, lo, hi, SMs) of the plans checked below.
PLAN_CASES = [(4, 12, 12, 64, 0, 2048, 132), (4, 12, 1, 64, 0, 2048, 132),
              (4, 16, 2, 64, 0, 8192, 132), (1, 12, 12, 64, 0, 65536, 132),
              (1, 16, 1, 64, 0, 65536, 132), (1, 16, 1, 256, 0, 65536, 132),
              (1, 64, 1, 128, 0, 65536, 132), (2, 12, 1, 64, 5, 6001, 132),
              (4, 12, 4, 64, 1536, 2048, 132), (4, 12, 12, 64, 40, 41, 132),
              (3, 6, 3, 32, 7, 1000, 16), (1, 8, 8, 16, 0, 100, 1)]


@pytest.mark.parametrize("case", PLAN_CASES, ids=str)
def test_decode_plan_covers_the_band(case):
    """The splits cover [lo, hi) exactly, none empty, each block's shared
    memory inside the H100's 227 KB; short bands take one split, long ones
    as many splits as two blocks a SM take."""
    b, h, h_kv, d, lo, hi, sms = case
    splits, chunk = tattn.decode_plan(b, h, h_kv, d, lo, hi, sms)
    bounds = [(lo + i * chunk, min(hi, lo + (i + 1) * chunk))
              for i in range(splits)]
    assert bounds[0][0] == lo and bounds[-1][1] == hi
    assert all(a < z for a, z in bounds)
    assert all(z == a2 for (_, z), (a2, _) in zip(bounds, bounds[1:]))
    assert tattn.decode_smem_bytes(h, h_kv, d, chunk) <= tattn.SMEM_LIMIT
    n, unit = hi - lo, tattn._ROW_UNIT
    if n <= unit:
        assert splits == 1
    # a chunk is whole row units (but a band shorter than one), the
    # smallest that keeps the blocks within two a SM (one wave), unless
    # shared memory cuts it shorter
    want = max(1, 2 * sms // (b * h_kv))
    if tattn.decode_smem_bytes(h, h_kv, d, chunk + 1) <= tattn.SMEM_LIMIT:
        assert chunk == n or chunk % unit == 0
        assert splits <= want
        assert chunk <= unit or -(-n // (chunk - unit)) > want
    else:
        assert splits >= want


def test_decode_plan_refuses_an_empty_band():
    with pytest.raises(ValueError, match="empty band"):
        tattn.decode_plan(1, 4, 4, 32, 5, 5)


def _split_decode(q, k, v, bounds):
    """The kernel's split formulation in PyTorch: per split the scores'
    max m_i and sum l_i = sum exp(s - m_i); the band's M = max m_i and L =
    sum l_i exp(m_i - M) in split order; w = exp(s - M) / L rounded to V's
    dtype; per split the partial w.V in fp32; the partials summed in split
    order, rounded to q's dtype."""
    b, _, h, d = q.shape
    h_kv = k.shape[1]
    g = h // h_kv
    qg = q[:, 0].reshape(b, h_kv, g, d).float()
    scores = [torch.einsum("bhgd,bhsd->bhgs", qg, k[:, :, a:z].float())
              * (1.0 / d ** 0.5) for a, z in bounds]
    m = [s.amax(-1) for s in scores]
    l_ = [torch.exp(s - mi[..., None]).sum(-1) for s, mi in zip(scores, m)]
    big = torch.stack(m).amax(0)
    total = torch.zeros_like(big)
    for mi, li in zip(m, l_):
        total = total + li * torch.exp(mi - big)
    out = torch.zeros(b, h_kv, g, d)
    for s, (a, z) in zip(scores, bounds):
        w = (torch.exp(s - big[..., None]) / total[..., None]).to(v.dtype)
        out = out + torch.einsum("bhgs,bhsd->bhgd", w.float(),
                                 v[:, :, a:z].float())
    return out.reshape(b, 1, h, d).to(q.dtype)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("splits", ["plan_1", "plan_16", "uneven"])
@pytest.mark.parametrize("h,h_kv", [(4, 4), (12, 1), (16, 2)])
def test_split_formulation_matches_plain_and_jax(dt, splits, h, h_kv):
    """The split formulation against the plain twin and JAX's kernel in
    interpret mode, over the kernel's plans (one split; 16 SMs' worth)
    and uneven splits, at the module's tolerances."""
    b, s, d, lo, hi = 2, 96, 32, 3, 90
    rng = np.random.default_rng(h * 7 + h_kv)
    jq, tq = _to(_rand(rng, (b, 1, h, d)), dt)
    jk, tk = _to(_rand(rng, (b, h_kv, s, d)), dt)
    jv, tv = _to(_rand(rng, (b, h_kv, s, d)), dt)
    if splits == "uneven":
        cuts = [lo, 4, 31, 32, 70, hi]
        bounds = list(zip(cuts, cuts[1:]))
    else:
        sms = 1 if splits == "plan_1" else 16
        n_split, chunk = tattn.decode_plan(b, h, h_kv, d, lo, hi, sms)
        bounds = [(lo + i * chunk, min(hi, lo + (i + 1) * chunk))
                  for i in range(n_split)]
        assert (n_split == 1) == (splits == "plan_1")
    got = _split_decode(tq, tk, tv, bounds)
    plain = tattn._plain_decode_attention(tq, tk, tv, lo, hi)
    k_idx = np.arange(s)
    valid = ((k_idx >= lo) & (k_idx < hi)).astype(np.int32)[None]
    ref = jattn._pallas_decode_attention(jq, jk, jv, jnp.asarray(valid),
                                         interpret=True)
    assert got.dtype == tq.dtype
    np.testing.assert_allclose(_np(got), _np(plain), rtol=0, atol=TOL[dt])
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=TOL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("h,h_kv,window", [(6, 1, None), (16, 1, None),
                                           (16, 2, 9)])
def test_cached_decode_large_groups_match_jax_kernel(dt, h, h_kv, window):
    """One-token steps at 6 and 16 query heads a kv head (groups the
    first K5 refused): the port's path (the plain twin on the CPU)
    against JAX's kernel in interpret mode."""
    b, s, d, ix = 2, 48, 16, 30
    rng = np.random.default_rng(h + h_kv)
    arrs = [_rand(rng, shape) for shape in
            ((b, 1, h, d), (b, 1, h_kv, d), (b, 1, h_kv, d),
             (b, h_kv, s, d), (b, h_kv, s, d))]
    jx, tx = zip(*(_to(a, dt) for a in arrs))
    j_out = jattn.cached_decode_attention(*jx, jnp.int32(ix),
                                          window=window)[0]
    t_out = tattn.cached_decode_attention(
        *tx[:3], tx[3].clone(), tx[4].clone(), ix, window=window)[0]
    assert t_out.dtype == tx[0].dtype
    np.testing.assert_allclose(_np(t_out), _np(j_out), rtol=0, atol=TOL[dt])


@pytest.mark.parametrize("h,h_kv,window", [(4, 4, None), (12, 1, None),
                                           (4, 2, 6)])
def test_decode_impl_xla_takes_the_einsum_path(monkeypatch, h, h_kv, window):
    """``DECODE_IMPL = "xla"`` on both packages: a one-token step takes
    the grouped einsum path (the port's never reaches
    ``decode_attention``) and the two agree in fp32."""
    b, s, d, ix = 2, 32, 16, 10
    rng = np.random.default_rng(h * 3 + h_kv)
    q = _rand(rng, (b, 1, h, d))
    kn, vn = _rand(rng, (b, 1, h_kv, d)), _rand(rng, (b, 1, h_kv, d))
    ck, cv = _rand(rng, (b, h_kv, s, d)), _rand(rng, (b, h_kv, s, d))
    monkeypatch.setattr(jattn, "DECODE_IMPL", "xla")
    monkeypatch.setattr(tattn, "DECODE_IMPL", "xla")

    def refuse(*args):
        raise AssertionError("decode_attention reached under 'xla'")

    monkeypatch.setattr(tattn, "decode_attention", refuse)
    j_out = jattn.cached_decode_attention(
        jnp.asarray(q), jnp.asarray(kn), jnp.asarray(vn), jnp.asarray(ck),
        jnp.asarray(cv), jnp.int32(ix), window=window)[0]
    t_out, _, _, t_ix = tattn.cached_decode_attention(
        torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
        torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), ix,
        window=window)
    assert t_ix == ix + 1
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), rtol=0,
                               atol=1e-5)
    # "auto" on the same inputs reaches the kernel's wrapper
    monkeypatch.setattr(tattn, "DECODE_IMPL", "auto")
    with pytest.raises(AssertionError, match="reached"):
        tattn.cached_decode_attention(
            torch.from_numpy(q), torch.from_numpy(kn), torch.from_numpy(vn),
            torch.from_numpy(ck.copy()), torch.from_numpy(cv.copy()), ix)


def test_decode_impl_seed_and_validation(monkeypatch):
    """``DECODE_IMPL`` is seeded from ``DTF_DECODE_IMPL`` ("auto" when
    unset), as the JAX package seeds its own; a value other than "auto"
    or "xla" raises when a step runs."""
    assert tattn.decode_impl_from_env({}) == "auto"
    assert tattn.decode_impl_from_env({"DTF_DECODE_IMPL": "xla"}) == "xla"
    assert tattn.decode_impl_from_env(os.environ) == \
        os.environ.get("DTF_DECODE_IMPL", "auto") == jattn.DECODE_IMPL
    assert tattn.DECODE_IMPL == jattn.DECODE_IMPL
    monkeypatch.setattr(tattn, "DECODE_IMPL", "pallas")
    x = torch.zeros(1, 1, 2, 16)
    with pytest.raises(ValueError, match="DECODE_IMPL"):
        tattn.cached_decode_attention(x, x, x, torch.zeros(1, 2, 8, 16),
                                      torch.zeros(1, 2, 8, 16), 0)
