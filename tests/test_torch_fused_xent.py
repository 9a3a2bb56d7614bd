"""The port's fused LM head (K4f/K4b and their plain twins) against the
JAX package's ``ops/fused_xent.py``.

The same numpy-seeded inputs go through the JAX ``fused_softmax_xent``
in Pallas interpret mode (``tests/test_fused_xent.py``'s small tiles, so
the grids have several blocks) and through the port on the CPU, where
the wrapper takes the kernels' plain twins.  The JAX package is only
called.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.ops import fused_xent as jfx
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.models.gpt import _pick_xent
from distributedtensorflow_tpu_torch.ops import _cuda
from distributedtensorflow_tpu_torch.ops import fused_xent as fx
from distributedtensorflow_tpu_torch.ops.xent import chunked_softmax_xent
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

BLOCKS = dict(block_tokens=16, block_vocab=128,
              block_tokens_dx=32, block_vocab_dx=64)


def _setup(b=2, s=24, d=32, v=300, seed=0, mask_frac=0.0, bad_frac=0.0):
    rng = np.random.default_rng(seed)
    hidden = rng.standard_normal((b, s, d)).astype(np.float32)
    targets = rng.integers(0, v, size=(b, s)).astype(np.int32)
    mask = None
    if mask_frac:
        mask = (rng.random((b, s)) > mask_frac).astype(np.float32)
    if bad_frac:
        bad = rng.random((b, s)) < bad_frac
        targets = np.where(bad, -100, targets).astype(np.int32)
        targets.flat[:2] = [v, v + 3]  # past the vocabulary, weight 0 too
    wte = (rng.standard_normal((v, d)) * 0.05).astype(np.float32)
    return hidden, wte, targets, mask


def _both(hidden, wte, targets, mask, *, jax_dtype=None, torch_dtype=None,
          blocks=BLOCKS):
    """(loss, dhidden, dwte) of the JAX head and of the port's."""
    jmask = None if mask is None else jnp.asarray(mask)

    def jf(h, w):
        return jfx.fused_softmax_xent(h, w, jnp.asarray(targets), jmask,
                                      compute_dtype=jax_dtype,
                                      interpret=True, **blocks)

    jl, (jdh, jdw) = jax.value_and_grad(jf, argnums=(0, 1))(
        jnp.asarray(hidden), jnp.asarray(wte))
    h = torch.from_numpy(hidden).requires_grad_(True)
    w = torch.from_numpy(wte).requires_grad_(True)
    loss = fx.fused_softmax_xent(
        h, w, torch.from_numpy(targets),
        None if mask is None else torch.from_numpy(mask),
        compute_dtype=torch_dtype)
    loss.backward()
    return ((float(loss.detach()), h.grad.numpy(), w.grad.numpy()),
            (float(jl), np.asarray(jdh), np.asarray(jdw)))


@pytest.mark.parametrize("mask_frac,bad_frac", [(0.0, 0.0), (0.3, 0.0),
                                                (0.2, 0.15)])
def test_fused_value_matches_jax(mask_frac, bad_frac):
    """fp32 loss with no mask, a partial mask, and targets at -100 or
    past V (weight 0)."""
    (loss, _, _), (jloss, _, _) = _both(
        *_setup(mask_frac=mask_frac, bad_frac=bad_frac))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("mask_frac,bad_frac", [(0.25, 0.1), (0.0, 0.0)])
def test_fused_grads_match_jax(mask_frac, bad_frac):
    (_, dh, dw), (_, jdh, jdw) = _both(
        *_setup(mask_frac=mask_frac, bad_frac=bad_frac))
    np.testing.assert_allclose(dh, jdh, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(dw, jdw, rtol=2e-4, atol=1e-6)


def test_fused_ragged_shapes_match_jax():
    """22 tokens and a vocabulary of 171: no multiple of any tile."""
    (loss, dh, dw), (jloss, jdh, jdw) = _both(
        *_setup(b=1, s=22, v=171, mask_frac=0.2, bad_frac=0.1))
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dh, jdh, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(dw, jdw, rtol=2e-4, atol=1e-6)


def test_fused_bf16_compute_dtype_matches_jax():
    """bf16 operands (and dlog rounded to bf16 before each product): the
    loss to rtol 2e-3, the gradients to 2e-3 of their max (a rounding of
    dlog may fall the other way where the two frameworks' p differ in the
    last fp32 bit)."""
    (loss, dh, dw), (jloss, jdh, jdw) = _both(
        *_setup(mask_frac=0.25, bad_frac=0.1), jax_dtype=jnp.bfloat16,
        torch_dtype=torch.bfloat16)
    np.testing.assert_allclose(loss, jloss, rtol=2e-3)
    np.testing.assert_allclose(dh, jdh, rtol=0, atol=2e-3 * np.abs(jdh).max())
    np.testing.assert_allclose(dw, jdw, rtol=0, atol=2e-3 * np.abs(jdw).max())


def test_fused_wide_hidden_small_vocab_matches_jax():
    """D 1024 (gpt_medium's width) with a small vocabulary, through the
    JAX entry's own default tiles for that width."""
    rng = np.random.default_rng(5)
    n, d, v = 64, 1024, 640
    hidden = (0.05 * rng.standard_normal((n, d))).astype(np.float32)
    wte = (0.05 * rng.standard_normal((v, d))).astype(np.float32)
    targets = rng.integers(0, v, n).astype(np.int32)
    (loss, dh, dw), (jloss, jdh, jdw) = _both(hidden, wte, targets, None,
                                              blocks={})
    np.testing.assert_allclose(loss, jloss, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(dh, jdh, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(dw, jdw, rtol=1e-4, atol=1e-6)


def test_fused_matches_chunked_head():
    """The fused head is a drop-in for the port's chunked head."""
    hidden, wte, targets, mask = _setup(mask_frac=0.25, bad_frac=0.1)
    out = []
    for fn in (fx.fused_softmax_xent, chunked_softmax_xent):
        h = torch.from_numpy(hidden).requires_grad_(True)
        w = torch.from_numpy(wte).requires_grad_(True)
        loss = fn(h, w, torch.from_numpy(targets), torch.from_numpy(mask))
        loss.backward()
        out.append((loss.detach(), h.grad, w.grad))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, rtol=2e-4, atol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_twins_match_jax_kernels(dtype):
    """Each plain twin against the JAX kernel it stands for, called on
    the same padded operands in interpret mode: ``xent_fwd_plain``
    against ``_fused_fwd_arrays`` (lse, tgt), ``xent_dx_plain`` and
    ``xent_dw_plain`` against ``_fused_bwd_arrays``."""
    rng = np.random.default_rng(7)
    n, d, v, bn, bv = 48, 32, 256, 16, 128
    x = rng.standard_normal((n, d)).astype(np.float32)
    w = (0.1 * rng.standard_normal((v, d))).astype(np.float32)
    t = rng.integers(0, v, n).astype(np.int32)
    t[:3] = [-100, v, 5]
    c = rng.random(n).astype(np.float32) / n
    c[:2] = 0.0  # the weight of an out-of-range target
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    jx, jw = jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt)
    jlse, jtgt = jfx._fused_fwd_arrays(jx, jw, jnp.asarray(t), block_n=bn,
                                       block_v=bv, v_true=v, interpret=True)
    jdx, jdw = jfx._fused_bwd_arrays(
        jx, jw, jnp.asarray(t), jlse, jnp.asarray(c), block_n_dx=bn,
        block_v_dx=bv // 2, block_n_dw=bn, block_v_dw=bv, v_true=v,
        interpret=True)
    tx = torch.from_numpy(x).to(tdt)
    tw = torch.from_numpy(w).to(tdt)
    tt = torch.from_numpy(t)
    lse, tgt = fx.xent_fwd_plain(tx, tw, tt)
    valid = (t >= 0) & (t < v)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=1e-5,
                               atol=1e-5)
    # JAX gathers NEG_INF for a target inside its padded rows; both weigh 0
    np.testing.assert_allclose(tgt.numpy()[valid], np.asarray(jtgt)[valid],
                               rtol=1e-5, atol=1e-5)
    assert (tgt.numpy()[~valid] == 0).all()
    args = (tx, tw, tt, torch.from_numpy(np.array(jlse)),
            torch.from_numpy(c))
    tol = dict(rtol=0, atol=1e-5) if dtype == "float32" else \
        dict(rtol=0, atol=2e-3 * np.abs(np.asarray(jdx)).max())
    np.testing.assert_allclose(fx.xent_dx_plain(*args).numpy(),
                               np.asarray(jdx), **tol)
    tol = tol if dtype == "float32" else \
        dict(rtol=0, atol=2e-3 * np.abs(np.asarray(jdw)).max())
    np.testing.assert_allclose(fx.xent_dw_plain(*args).numpy(),
                               np.asarray(jdw)[:v], **tol)


def test_cuda_wrappers_refuse_cpu_tensors():
    """The kernels' wrappers launch or raise: a CPU tensor is refused
    before any build or launch (the plain twins are taken only by the
    dispatchers, for CPU tensors)."""
    x = torch.zeros(8, 128)
    w = torch.zeros(16, 128)
    t = torch.zeros(8, dtype=torch.int32)
    r = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.xent_fwd_cuda(x, w, t)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.xent_dx_cuda(x, w, t, r, r)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.xent_dw_cuda(x, w, t, r, r)


def test_lm_loss_fused_head_matches_jax():
    """gpt_tiny at fp32 with ``xent_impl="fused"`` on both sides (the JAX
    kernels in interpret mode, the port's plain twins), from one JAX
    init: the loss and every gradient leaf, mapped back with
    ``params_to_flax``, to 1e-4 of each leaf's max-abs."""
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32,
                               xent_impl="fused")
    tcfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32,
                               xent_impl="fused")
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 32), jnp.int32))["params"]
    ids = np.random.default_rng(1).integers(0, 512, (2, 32))
    mask = np.ones((2, 32), np.float32)
    mask[1, 20:] = 0
    batch = {"input_ids": jnp.asarray(ids), "mask": jnp.asarray(mask)}
    loss_fn = jax_lm_loss(JaxGPTLM(jcfg))
    jloss, jgrads = jax.value_and_grad(
        lambda p: loss_fn(p, {}, batch, jax.random.PRNGKey(0))[0])(params)
    model = tm.GPTLM(tcfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, tcfg))
    loss, _ = tm.lm_loss(model)({"input_ids": torch.as_tensor(ids),
                                 "mask": torch.from_numpy(mask)})
    names, leaves = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)
    got = tm.params_to_flax(dict(zip(names, grads)), tcfg)

    def flat(tree, prefix=()):
        for k, val in tree.items():
            if isinstance(val, dict):
                yield from flat(val, prefix + (k,))
            else:
                yield prefix + (k,), np.asarray(val)

    ref = dict(flat(jax.tree.map(np.asarray, jgrads)))
    got = dict(flat(got))
    assert got.keys() == ref.keys()
    for path, r in ref.items():
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=1e-4 * np.abs(r).max(),
                                   err_msg="/".join(path))


def test_pick_xent_auto_follows_the_device():
    """``auto`` is the chunked head on the CPU and the fused head for a
    model on ``cuda`` (decided from the device, no card touched);
    ``fused`` is taken on every device."""
    cfg = tm.gpt_tiny()
    assert _pick_xent(cfg, torch.device("cpu")) is chunked_softmax_xent
    assert _pick_xent(cfg, torch.device("cuda")) is fx.fused_softmax_xent
    assert _pick_xent(cfg, "cuda:0") is fx.fused_softmax_xent
    fused = dataclasses.replace(cfg, xent_impl="fused")
    assert _pick_xent(fused, torch.device("cpu")) is fx.fused_softmax_xent
    chunked = dataclasses.replace(cfg, xent_impl="chunked")
    assert _pick_xent(chunked, torch.device("cuda")) is chunked_softmax_xent


# ------------------------------------------------------- K4b's launch plan

GPT_LM_HEAD = {"dx": (16376, 50257), "dw": (50257, 16376)}


@pytest.mark.parametrize("which", ["dx", "dw"])
@pytest.mark.parametrize("d", fx.HIDDEN_SIZES)
def test_bwd_plan_fits_the_block(d, which):
    """At gpt_lm's head, each width's bf16 plan fits a block's shared
    memory, keeps at most 128 fp32 outputs a thread, splits D into
    slices of a multiple of 64 columns, at most 256, and rings at least
    two stages."""
    n_own, n_str = GPT_LM_HEAD[which]
    plan = fx.xent_bwd_plan(n_own, n_str, d)
    dk = d // plan.k
    assert plan.variant == "wgmma_cluster"
    assert plan.k * dk == d and dk % 64 == 0 and dk <= 256
    assert plan.smem <= fx.SMEM_LIMIT == 232448
    assert plan.m * dk / plan.threads <= 128
    assert plan.m % 64 == 0 and plan.s % 16 == 0 and plan.stages >= 2


@pytest.mark.parametrize("n_own", [1000, 16376, 50257])
@pytest.mark.parametrize("d", fx.HIDDEN_SIZES)
def test_bwd_plan_grid_covers_every_row_once(n_own, d):
    """The grid is whole clusters, and the (cluster, rank) of each block
    maps (owned rows, output columns) so that every (row, column) of a
    ragged N or V is covered by exactly one block."""
    plan = fx.xent_bwd_plan(n_own, 64, d)
    assert plan.grid == plan.clusters * plan.k
    dk = d // plan.k
    cover = np.zeros((n_own, d), np.int32)
    for block in range(plan.grid):
        cluster, rank = divmod(block, plan.k)
        cover[cluster * plan.m:(cluster + 1) * plan.m,
              rank * dk:(rank + 1) * dk] += 1
    assert (cover == 1).all()
    assert (plan.clusters - 1) * plan.m < n_own <= plan.clusters * plan.m


@pytest.mark.parametrize("d", fx.HIDDEN_SIZES)
def test_bwd_plan_is_one_the_kernel_is_built_for(d):
    """The C entry launches only the (D, K, stages) it instantiates and
    the M, S of its constants: the plan names one of them (bf16), and the
    fp32 plan is the CUDA-core kernel's."""
    src = (_cuda.CSRC / "fused_xent_bwd.cu").read_text()
    plan = fx.xent_bwd_plan(16376, 50257, d)
    assert f"constexpr int kM = {plan.m};" in src
    assert f"constexpr int kS = {plan.s};" in src
    assert f"constexpr int kWgThreads = {plan.threads};" in src
    assert (f"d == {d} && kc == {plan.k} && stages == {plan.stages}"
            in src)
    fma = fx.xent_bwd_plan(16376, 50257, d, torch.float32)
    assert (fma.variant, fma.k, fma.m, fma.s) == ("fma", 1, 32, 128)
    assert fma.smem <= fx.SMEM_LIMIT


@pytest.mark.parametrize("which", ["dx", "dw"])
@pytest.mark.parametrize("d", [512, 768])
def test_bwd_wrappers_refuse_bad_width_and_cpu(which, d):
    """A width outside HIDDEN_SIZES has no plan, and the wrappers raise
    on CPU tensors at any width, before any build or launch."""
    if d not in fx.HIDDEN_SIZES:
        with pytest.raises(ValueError, match="hidden sizes"):
            fx.xent_bwd_plan(64, 64, d)
    x, w = torch.zeros(8, d), torch.zeros(16, d)
    t, r = torch.zeros(8, dtype=torch.int32), torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        getattr(fx, f"xent_{which}_cuda")(x, w, t, r, r)


# ------------------------------------------------------- K4f's launch plan

GPT_LM_VOCAB = 50257


@pytest.mark.parametrize("d", [64, 128, 192, 768, 1024, 2048])
def test_fwd_plan_fits_the_block(d):
    """At every width from 64 to 2048, the bf16 plan is the wgmma kernel's
    (a ring of at least two stages of 128 + 256 rows of 64 bf16 columns
    in the shared memory of one block, two consumer warpgroups and a
    producer warpgroup), and the fp32 plan the CUDA-core kernel's; both fit
    ``SMEM_LIMIT``."""
    plan = fx.xent_fwd_plan(16376, GPT_LM_VOCAB, d)
    assert plan.variant == "wgmma"
    assert plan.smem <= fx.SMEM_LIMIT == 232448
    assert plan.stages >= 2
    assert plan.smem >= plan.stages * (plan.m + plan.tile) * 64 * 2
    assert plan.threads == 3 * 128 and plan.m == 2 * 64
    fma = fx.xent_fwd_plan(4096, GPT_LM_VOCAB, d, torch.float32)
    assert (fma.variant, fma.cluster) == ("fma", 1)
    assert fma.smem <= fx.SMEM_LIMIT


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("n", [1, 127, 1000, 16376, 16384, 16385])
def test_fwd_plan_grid_covers_every_token_once(n, dtype):
    """The grid is whole clusters of blocks of ``m`` tokens; every token
    of a ragged N falls in exactly one block, and no block lies wholly
    past N but those that complete the last cluster."""
    plan = fx.xent_fwd_plan(n, GPT_LM_VOCAB, 768, dtype)
    assert plan.grid % plan.cluster == 0
    cover = np.zeros(plan.grid * plan.m, np.int32)
    for block in range(plan.grid):
        cover[block * plan.m:(block + 1) * plan.m] += 1
    assert (cover[:n] == 1).all()
    assert (plan.grid - plan.cluster) * plan.m < n <= plan.grid * plan.m


@pytest.mark.parametrize("v", [1, 256, 257, GPT_LM_VOCAB])
def test_fwd_plan_tiles_cover_the_vocabulary(v):
    """The sweep's vocab tiles cover [0, V) once, the last one ragged
    where V is not a multiple of the tile (gpt_lm's 50257 leaves 81 rows
    in its 197th tile): the kernel masks the rest to -inf before the
    max."""
    plan = fx.xent_fwd_plan(16376, v, 768)
    tiles = -(-v // plan.tile)
    cover = np.zeros(tiles * plan.tile, np.int32)
    for i in range(tiles):
        cover[i * plan.tile:(i + 1) * plan.tile] += 1
    assert (cover[:v] == 1).all() and (tiles - 1) * plan.tile < v
    if v == GPT_LM_VOCAB:
        assert (tiles, v - (tiles - 1) * plan.tile) == (197, 81)


@pytest.mark.parametrize("d,dtype,error", [
    (96, torch.bfloat16, ValueError), (100, torch.bfloat16, ValueError),
    (32, torch.float32, ValueError), (0, torch.bfloat16, ValueError),
    (768, torch.float16, TypeError), (768, torch.float64, TypeError)])
def test_fwd_plan_refuses_what_it_was_not_built_for(d, dtype, error):
    """A width that is not a positive multiple of 64, or a dtype other
    than bf16 and fp32, has no plan."""
    with pytest.raises(error):
        fx.xent_fwd_plan(64, 300, d, dtype)


def test_fwd_plan_is_one_the_kernel_is_built_for():
    """The C entry launches only the (M, tile, stages, threads) of its
    constants and no cluster: the bf16 plan names them, and the fp32 plan
    is the CUDA-core kernel's."""
    src = (_cuda.CSRC / "fused_xent_fwd.cu").read_text()
    plan = fx.xent_fwd_plan(16376, GPT_LM_VOCAB, 768)
    assert f"constexpr int kM = {plan.m};" in src
    assert f"constexpr int kTile = {plan.tile};" in src
    assert f"constexpr int kStages = {plan.stages};" in src
    assert f"constexpr int kThreadsWg = {plan.threads};" in src
    assert plan.cluster == 1 and "cluster != 1" in src
    assert plan.smem == 1024 + plan.stages * ((plan.m + plan.tile) * 128
                                              + 16)
    fma = fx.xent_fwd_plan(4096, GPT_LM_VOCAB, 768, torch.float32)
    assert f"constexpr int kOwn = {fma.m};" in src


@pytest.mark.parametrize("d", [96, 768])
def test_fwd_wrapper_refuses_bad_width_and_cpu(d):
    """The K4f wrapper raises on CPU tensors at any width, and on a width
    that is not a multiple of 64, before any build or launch."""
    x, w = torch.zeros(8, d), torch.zeros(16, d)
    t = torch.zeros(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fx.xent_fwd_cuda(x, w, t)
    if d % 64:
        with pytest.raises(ValueError, match="multiples of 64"):
            fx.xent_fwd_plan(8, 16, d)
