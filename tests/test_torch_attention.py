"""The port's attention ops against the JAX package's.

``_plain_decode_attention`` is the twin of the TPU decode kernel
``_decode_attn_kernel``, run here as the JAX tests run it on the CPU
(interpret mode); on the card the port's CUDA kernel is held against
the plain twin by ``chip_smoke.py``.  Inputs come from numpy with a
fixed seed and feed both packages.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.ops import attention as jattn
from distributedtensorflow_tpu_torch.ops import _cuda
from distributedtensorflow_tpu_torch.ops import attention as tattn

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
    # scores of one block: group * band * 4 bytes, plus 8 warps' partial
    # outputs; gpt_small at 2048 positions is far inside 227 KB
    assert tattn.decode_smem_bytes(12, 12, 64, 0, 2048) == (2048 + 8 * 64) * 4
    assert tattn.decode_smem_bytes(12, 4, 64, 0, 2048) < tattn.SMEM_LIMIT
    assert tattn.decode_smem_bytes(12, 4, 64, 0, 32768) > tattn.SMEM_LIMIT
