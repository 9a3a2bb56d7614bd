"""The port's LayerNorm against the JAX Pallas LayerNorm kernel.

The JAX side runs its kernel as ``tests/test_layernorm.py`` does on the
CPU, in interpret mode; the port's side is the plain PyTorch twin that
its CUDA kernel is checked against on the card (``chip_smoke.py``).
Inputs come from numpy with a fixed seed and feed both packages.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.ops.layernorm import layer_norm as jax_layer_norm
from distributedtensorflow_tpu_torch.ops import _cuda
from distributedtensorflow_tpu_torch.ops.layernorm import (
    LayerNormFn,
    _plain_layer_norm,
    _plain_layer_norm_bwd,
    layer_norm,
    layer_norm_bwd_cuda,
    layer_norm_cuda,
)

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (2.0 * rng.standard_normal(shape) + 0.5).astype(np.float32)
    g = (1.0 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


def _both(x, g, b, dt_in, dt_out, eps=1e-6):
    (j_in, t_in), (j_out, t_out) = DTYPES[dt_in], DTYPES[dt_out]
    ref = jax_layer_norm(jnp.asarray(x).astype(j_in), jnp.asarray(g),
                         jnp.asarray(b), eps=eps, out_dtype=j_out,
                         impl="pallas", interpret=True)
    got = _plain_layer_norm(torch.from_numpy(x).to(t_in), torch.from_numpy(g),
                            torch.from_numpy(b), eps, t_out)
    assert got.dtype == t_out
    return (got.float().numpy(),
            np.asarray(ref.astype(jnp.float32)))


def _bf16_ulps(got, ref):
    """Largest |got - ref| in units of one bf16 ulp of ``ref`` (8
    significant bits: an ulp is 2**(e - 8) for |ref| in [2**(e-1), 2**e))."""
    _, e = np.frexp(np.maximum(np.abs(ref), 2.0**-100))
    return float(np.max(np.abs(got - ref) / np.ldexp(1.0, e - 8)))


# Ragged row counts: 37 and 517 are not multiples of the kernel's
# 512-row block, so the JAX side pads and slices.
@pytest.mark.parametrize("n", [37, 517])
@pytest.mark.parametrize("dt_in,dt_out",
                         [("fp32", "fp32"), ("bf16", "bf16"), ("bf16", "fp32")])
def test_plain_matches_pallas_interpret(n, dt_in, dt_out):
    got, ref = _both(*_inputs((n, 128), seed=n), dt_in, dt_out)
    if dt_out == "fp32":
        # fp32 statistics on both sides; only the summation order differs
        np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)
    else:
        # one rounding to bf16 from fp32 values a few fp32 ulps apart
        assert _bf16_ulps(got, ref) <= 1.0


@pytest.mark.parametrize("eps", [1e-3, 1e-5])
def test_custom_eps_and_leading_dims(eps):
    # 3-D input: the op normalises the last axis of any leading shape
    got, ref = _both(*_inputs((2, 5, 64), seed=7), "fp32", "fp32", eps=eps)
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-5)


def test_default_eps_is_flax_not_torch():
    # one entry of 2**-7 in a row of zeros: every sum is exact and the
    # variance (63 * 2**-26, about 9.4e-7) is close to eps, so flax's
    # 1e-6 and torch's 1e-5 give outputs a factor of ~2 apart
    x = np.zeros((1, 64), np.float32)
    x[0, 0] = 2.0**-7
    g, b = np.ones(64, np.float32), np.zeros(64, np.float32)
    got = layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                     torch.from_numpy(b)).numpy()
    ref = np.asarray(jax_layer_norm(jnp.asarray(x), jnp.asarray(g),
                                    jnp.asarray(b), impl="xla"))
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=0)
    torch_eps = _plain_layer_norm(torch.from_numpy(x), torch.from_numpy(g),
                                  torch.from_numpy(b), 1e-5,
                                  torch.float32).numpy()
    assert abs(torch_eps[0, 0] - got[0, 0]) > 1.0


def test_cpu_tensor_takes_plain_path_and_launches_nothing():
    x, g, b = _inputs((9, 32), seed=3)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    _cuda.launches.clear()
    y = layer_norm(xt, torch.from_numpy(g), torch.from_numpy(b),
                   out_dtype=torch.float32)
    assert y.dtype == torch.float32 and y.shape == (9, 32)
    assert torch.equal(y, _plain_layer_norm(
        xt, torch.from_numpy(g), torch.from_numpy(b), 1e-6, torch.float32))
    assert not _cuda.launches


def test_kernel_wrapper_refuses_cpu_tensors():
    # no silent plain path behind the kernel's entry
    x, g, b = _inputs((4, 32), seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_cuda(torch.from_numpy(x), torch.from_numpy(g),
                        torch.from_numpy(b), 1e-6, torch.float32)


# ---------------------------------------------------------------- backward


def _grads_both(n, dt_in, dt_out, seed):
    """(port dx, dscale, dbias), (JAX ...): the port through autograd on
    ``layer_norm`` (the plain twin of K1b on the CPU), JAX through
    ``jax.vjp`` of its interpret-mode Pallas kernel."""
    (j_in, t_in), (j_out, t_out) = DTYPES[dt_in], DTYPES[dt_out]
    x, g, b = _inputs((n, 128), seed=seed)
    dy = np.random.default_rng(seed + 1).standard_normal(
        (n, 128)).astype(np.float32)

    def f(x, g, b):
        return jax_layer_norm(x, g, b, out_dtype=j_out, impl="pallas",
                              interpret=True)

    _, vjp = jax.vjp(f, jnp.asarray(x).astype(j_in), jnp.asarray(g),
                     jnp.asarray(b))
    ref = [np.asarray(t.astype(jnp.float32))
           for t in vjp(jnp.asarray(dy).astype(j_out))]
    xt = torch.from_numpy(x).to(t_in).requires_grad_(True)
    gt = torch.from_numpy(g).requires_grad_(True)
    bt = torch.from_numpy(b).requires_grad_(True)
    y = layer_norm(xt, gt, bt, out_dtype=t_out)
    assert y.grad_fn is not None and "LayerNormFn" in type(y.grad_fn).__name__
    y.backward(torch.from_numpy(dy).to(t_out))
    assert xt.grad.dtype == t_in and gt.grad.dtype == torch.float32
    return [t.grad.float().numpy() for t in (xt, gt, bt)], ref


@pytest.mark.parametrize("n", [37, 517])
@pytest.mark.parametrize("dt_in,dt_out",
                         [("fp32", "fp32"), ("bf16", "bf16"), ("bf16", "fp32")])
def test_backward_matches_pallas_interpret(n, dt_in, dt_out):
    """K1b's plain twin against ``jax.vjp`` of the Pallas LayerNorm: dx,
    dscale, dbias.  dscale/dbias are fp32 sums over the rows on both
    sides (only the order differs): 1e-5 of their largest entry.  dx in
    fp32 at atol 1e-5; in bf16 the same fp32 value is rounded once on
    each side, so the two agree to one bf16 ulp of the largest entry."""
    (dx, dg, db), (rdx, rdg, rdb) = _grads_both(n, dt_in, dt_out, seed=n)
    for got, ref in ((dg, rdg), (db, rdb)):
        np.testing.assert_allclose(got, ref, rtol=0,
                                   atol=1e-5 * np.abs(ref).max())
    if dt_in == "fp32":
        np.testing.assert_allclose(dx, rdx, rtol=0, atol=1e-5)
    else:
        assert np.abs(dx - rdx).max() <= 2.0**-7 * np.abs(rdx).max()


def test_backward_twin_matches_torch_autograd():
    """The explicit backward formulas equal autograd through the plain
    forward (fp32, leading dims, non-default eps)."""
    x, g, b = _inputs((3, 7, 64), seed=11)
    dy = torch.from_numpy(np.random.default_rng(12).standard_normal(
        (3, 7, 64)).astype(np.float32))
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, g, b)]
    y = _plain_layer_norm(*leaves, 1e-5, torch.float32)
    want = torch.autograd.grad(y, leaves, dy)
    got = _plain_layer_norm_bwd(leaves[0].detach().reshape(-1, 64),
                                leaves[1].detach(), dy.reshape(-1, 64), 1e-5)
    for a, w in zip(got, want):
        torch.testing.assert_close(a.reshape(w.shape), w, rtol=0, atol=2e-5)


def test_no_grad_path_runs_the_forward_only():
    """The serving path (no autograd) calls the forward directly, as
    before the backward existed; LayerNormFn only when grads are
    recorded."""
    x, g, b = (torch.from_numpy(a) for a in _inputs((5, 32), seed=13))
    with torch.no_grad():
        y = layer_norm(x, g.requires_grad_(True), b)
    assert y.grad_fn is None
    assert torch.equal(y, _plain_layer_norm(x, g, b, 1e-6, torch.float32))
    y = layer_norm(x, g, b)
    assert type(y.grad_fn).__name__ == "LayerNormFnBackward"
    assert torch.equal(y, LayerNormFn.apply(x, g, b, 1e-6, torch.float32))


def test_backward_kernel_wrapper_refuses_cpu_tensors():
    x, g, _ = _inputs((4, 32), seed=14)
    with pytest.raises(ValueError, match="CUDA"):
        layer_norm_bwd_cuda(torch.from_numpy(x), torch.from_numpy(g),
                            torch.from_numpy(x), 1e-6)


# ------------------------------------------------------- K1b's grid


@pytest.mark.parametrize("n,sms,blocks", [
    (16384, 132, 264), (16384, 114, 228), (4 * 1024, 132, 256),
    (2047, 132, 128), (17, 132, 2), (16, 132, 1), (1, 132, 1), (0, 132, 1)])
def test_bwd_blocks_is_pure_in_rows_and_sms(n, sms, blocks):
    """K1b's main pass runs one wave of BWD_BLOCKS_PER_SM blocks an SM
    (the training step's 16384 rows on 132 SMs: 264 blocks), fewer where
    the rows run out at 16 a block; the same inputs give the same grid."""
    from distributedtensorflow_tpu_torch.ops import layernorm as ln

    assert ln.bwd_blocks(n, sms) == blocks == ln.bwd_blocks(n, sms)
    assert blocks <= sms * ln.BWD_BLOCKS_PER_SM


@pytest.mark.parametrize("n,d,sms", [(16384, 768, 132), (1000, 1024, 132),
                                     (37, 128, 4)])
def test_bwd_workspace_matches_the_grid(n, d, sms):
    """The partial workspace holds one (2, D) fp32 row per block of the
    grid, and the kernel's launch bounds promise the blocks an SM that
    the grid counts on."""
    from distributedtensorflow_tpu_torch.ops import layernorm as ln

    ws = ln.bwd_workspace(n, d, sms, "cpu")
    assert ws.shape == (ln.bwd_blocks(n, sms), 2, d)
    assert ws.dtype == torch.float32
    src = (_cuda.CSRC / "layernorm_bwd.cu").read_text()
    assert f"constexpr int kBlocksPerSm = {ln.BWD_BLOCKS_PER_SM};" in src
    assert "__launch_bounds__(kWarps * 32, kBlocksPerSm)" in src
