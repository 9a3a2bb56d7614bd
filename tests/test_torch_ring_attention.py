"""The port's ring and Ulysses attention and the flash kernels' key-side
segments against the JAX package's.

``parallel.ring_attention`` over the ``seq`` ranks of a ``data=2,
seq=2`` mesh of four thread ranks (``testing.run_mesh``) against JAX's
``make_sequence_parallel_attention`` on ``MeshSpec(data=2, seq=2)``:
causal and not, plain and packed, the ring (auto: the plain ring on the
CPU) and Ulysses; each rank holds its data rows' sequence chunk and
back-propagates its share of ``sum(out ** 2)``, and the chunks' outputs
and q/k/v gradients put together are JAX's.  One test forces the flash
ring on both sides at a tiny size (JAX's Pallas kernels in interpret
mode, the port's plain twins of K2/K3f/K3): the port's ring loop, its
lse merge and its backward from the global lse, against JAX's.  The
plain twins of K2, K3f and the K3 pair with a key-side segment array
(``kv_segment_ids``) against JAX's ``_flash_forward`` and
``_flash_backward_pallas_core`` in interpret mode.

Tolerances: ring and Ulysses outputs and gradients 2e-5 (atol and rtol),
the reference's own (``tests/test_ring_attention.py:32-56,182-205``);
the kernels' twins 2e-5 forward and 5e-5 backward, as
``tests/test_torch_flash_attention.py``.  fp32 throughout.
"""

import functools
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from distributedtensorflow_tpu.ops import flash_attention as jfa
from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu.parallel.ring_attention import (
    make_sequence_parallel_attention,
)
from distributedtensorflow_tpu_torch.ops import flash_attention as fa
from distributedtensorflow_tpu_torch.parallel import ring_attention as ra
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

# the parallel package re-exports a *function* named ring_attention
jra = importlib.import_module(
    "distributedtensorflow_tpu.parallel.ring_attention")

TOL = 2e-5


def _qkv(b=2, s=64, h=4, d=16, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.standard_normal((b, s, h, d)).astype(np.float32)
                 for _ in range(3))


def _segments(b, s):
    """Packed rows whose segments cross the chunk boundaries."""
    cuts = [0, 5, s // 2 + 3, s - 7, s]
    seg = np.zeros((b, s), np.int32)
    for i in range(len(cuts) - 1):
        seg[:, cuts[i]:cuts[i + 1]] = i
    seg[1] = seg[1][::-1]
    return seg


@pytest.fixture(scope="module")
def jmesh():
    return jbuild_mesh(JMeshSpec(data=2, seq=2), jax.devices()[:4])


def _jax_ref(fn, q, k, v, seg):
    """JAX's output and the q/k/v gradients of ``sum(out ** 2)``."""
    args = tuple(jnp.asarray(x) for x in (q, k, v))
    kw = {} if seg is None else {"segment_ids": jnp.asarray(seg)}

    def loss(q, k, v):
        return jnp.sum(fn(q, k, v, **kw) ** 2)

    out = fn(*args, **kw)
    grads = jax.grad(loss, argnums=(0, 1, 2))(*args)
    return [np.asarray(out)] + [np.asarray(g) for g in grads]


def _port(body, q, k, v, seg, spec=MeshSpec(data=2, seq=2)):
    """Each rank's (rows of its data coordinate, its seq chunk) of q, k,
    v and ``seg``; ``body(mesh, q, k, v, seg) -> out``, whose
    ``sum(out ** 2)`` the rank back-propagates.  Returns the output and
    the q/k/v gradients put together."""
    world = spec.data * spec.seq

    def rank_fn(rank, mesh):
        nb, ns = mesh.shape["data"], mesh.shape["seq"]
        b, s = q.shape[0] // nb, q.shape[1] // ns
        rows = slice(mesh.coords["data"] * b, (mesh.coords["data"] + 1) * b)
        cols = slice(mesh.coords["seq"] * s, (mesh.coords["seq"] + 1) * s)
        local = [torch.tensor(x[rows, cols]).requires_grad_()
                 for x in (q, k, v)]
        sg = None if seg is None else torch.tensor(seg[rows, cols])
        out = body(mesh, *local, sg)
        (out ** 2).sum().backward()
        return mesh.coords, [out.detach()] + [x.grad for x in local]

    outs = run_mesh(rank_fn, spec, world)
    by = {(c["data"], c["seq"]): t for c, t in outs}
    return [torch.cat([torch.cat([by[(d, s)][i] for s in range(spec.seq)],
                                 1) for d in range(spec.data)]).numpy()
            for i in range(4)]


def _close(got, ref, tol=TOL):
    for g, r, name in zip(got, ref, ("out", "dq", "dk", "dv")):
        np.testing.assert_allclose(g, r, atol=tol, rtol=tol, err_msg=name)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("scheme", ["ring", "ulysses"])
def test_sequence_parallel_matches_jax(jmesh, scheme, causal, packed):
    """``sequence_parallel_attention_fn`` (the models' entry) over the
    ranks' chunks against JAX's jitted entry on the global arrays."""
    q, k, v = _qkv(seed=3)
    seg = _segments(2, 64) if packed else None
    ref = _jax_ref(make_sequence_parallel_attention(
        jmesh, scheme=scheme, causal=causal), q, k, v, seg)

    def body(mesh, q, k, v, seg):
        attn = ra.sequence_parallel_attention_fn(mesh, scheme=scheme,
                                                 causal=causal)
        return attn(q, k, v, segment_ids=seg)

    _close(_port(body, q, k, v, seg), ref)


@pytest.mark.parametrize("packed", [False, True])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_ring_matches_jax_flash_ring(jmesh, causal, packed):
    """The flash ring on both sides at a tiny size: JAX's
    ``ring_attention(impl="flash")`` (Pallas in interpret mode) inside
    ``shard_map`` against the port's ``impl="flash"`` (the plain twins of
    K2 and K3f per chunk, the merge by lse, the global-lse backward)."""
    q, k, v = _qkv(b=2, s=32, h=2, d=16, seed=7)
    seg = _segments(2, 32) if packed else None
    spec = JP(("data", "fsdp"), "seq", None, None)
    seg_spec = JP(("data", "fsdp"), "seq")
    kernel = functools.partial(jra.ring_attention, axis_name="seq",
                               causal=causal, impl="flash")
    plain = jax.shard_map(kernel, mesh=jmesh, in_specs=(spec,) * 3,
                          out_specs=spec, check_vma=False)
    packed = jax.shard_map(
        lambda q, k, v, seg: kernel(q, k, v, segment_ids=seg), mesh=jmesh,
        in_specs=(spec,) * 3 + (seg_spec,), out_specs=spec, check_vma=False)

    def fn(q, k, v, segment_ids=None):
        return plain(q, k, v) if segment_ids is None \
            else packed(q, k, v, segment_ids)

    ref = _jax_ref(fn, q, k, v, seg)

    def body(mesh, q, k, v, seg):
        return ra.ring_attention(q, k, v, mesh.seq_group, causal=causal,
                                 impl="flash", segment_ids=seg)

    _close(_port(body, q, k, v, seg), ref)


def test_ulysses_refuses_heads_the_axis_does_not_divide():
    def body(rank, mesh):
        x = torch.zeros(1, 8, 3, 16)
        with pytest.raises(ValueError, match="not divisible"):
            ra.ulysses_attention(x, x, x, mesh.seq_group, causal=True)
        return True

    assert run_mesh(body, MeshSpec(data=1, seq=2), 2) == [True, True]


def test_world_of_one_is_plain_attention():
    """Over a ``seq`` axis of 1 the ring is one diagonal chunk: the flash
    ring's output and gradients are the flash attention's."""
    q, k, v = (torch.tensor(x) for x in _qkv(b=1, s=32, h=2, d=16))
    outs = []
    for fn in (lambda a, b, c: ra.ring_attention(a, b, c, None, causal=True,
                                                 impl="flash"),
               lambda a, b, c: fa.flash_attention(a, b, c, causal=True)):
        args = [x.clone().requires_grad_() for x in (q, k, v)]
        out = fn(*args)
        (out ** 2).sum().backward()
        outs.append([out.detach()] + [x.grad for x in args])
    for got, ref in zip(*outs):
        torch.testing.assert_close(got, ref, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------- kv segments

KV_B, KV_S, KV_H, KV_D = 2, 64, 2, 32


def _kv_inputs(seed=11):
    rng = np.random.default_rng(seed)
    q, k, v, do = (rng.standard_normal((KV_B, KV_S, KV_H, KV_D)).astype(
        np.float32) for _ in range(4))
    qseg = _segments(KV_B, KV_S)
    # the keys' own segments: every fifth key moved to the next segment
    # (no segment starts at such a position, so every query still reaches
    # a key of its own segment under the causal mask: a row that reaches
    # none depends on the kernel's tiling on the TPU)
    kseg = qseg.copy()
    moved = np.arange(KV_S) % 5 == 3
    kseg[:, moved] = (qseg[:, moved] + 1) % 4
    return q, k, v, do, qseg, kseg


@pytest.mark.parametrize("causal", [False, True])
def test_kv_segment_forward_matches_jax(causal):
    """``flash_forward(..., kv_segment_ids=)`` (K2's plain twin) against
    JAX's ``_flash_forward`` with a separate key-side array: o and lse."""
    q, k, v, _, qseg, kseg = _kv_inputs()
    jo, jlse = jfa._flash_forward(
        *(jnp.asarray(x) for x in (q, k, v)), None, jnp.asarray(qseg),
        jnp.asarray(kseg), causal=causal, interpret=True)
    o, lse = fa.flash_forward(
        *(torch.tensor(x) for x in (q, k, v)), segment_ids=torch.tensor(qseg),
        kv_segment_ids=torch.tensor(kseg), causal=causal)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), atol=2e-5,
                               rtol=1e-6)
    # the key side matters: the queries' own segments give another result
    o_self, _ = fa.flash_forward(
        *(torch.tensor(x) for x in (q, k, v)), segment_ids=torch.tensor(qseg),
        causal=causal)
    assert not torch.allclose(o, o_self)


@pytest.mark.parametrize("impl", ["pallas", "pallas_split"])
@pytest.mark.parametrize("causal", [False, True])
def test_kv_segment_backward_matches_jax(causal, impl):
    """``flash_backward(..., kv_segment_ids=)`` from an external lse and
    delta (K3f's twin, or the K3 pair's under "pallas_split") against
    JAX's ``_flash_backward_pallas_core`` (fused, or ``force_split``):
    dq, dk, dv."""
    q, k, v, do, qseg, kseg = _kv_inputs(seed=12)
    jargs = [jnp.asarray(x) for x in (q, k, v)]
    jo, jlse = jfa._flash_forward(*jargs, None, jnp.asarray(qseg),
                                  jnp.asarray(kseg), causal=causal,
                                  interpret=True)
    delta = jnp.einsum("bqhd,bqhd->bhq", jnp.asarray(do), jo)
    jgrads = jfa._flash_backward_pallas_core(
        *jargs, None, jnp.asarray(do), jlse, delta,
        segment_ids=jnp.asarray(qseg), kv_segment_ids=jnp.asarray(kseg),
        causal=causal, interpret=True, force_split=impl == "pallas_split")
    grads = fa.flash_backward(
        *(torch.tensor(x) for x in (q, k, v, do)),
        torch.tensor(np.asarray(jlse)), torch.tensor(np.asarray(delta)),
        segment_ids=torch.tensor(qseg), kv_segment_ids=torch.tensor(kseg),
        causal=causal, backward_impl=impl)
    for got, ref, name in zip(grads, jgrads, ("dq", "dk", "dv")):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=5e-5,
                                   err_msg=name)


def test_kv_segments_need_query_segments():
    x = torch.zeros(1, 8, 1, 16)
    seg = torch.zeros(1, 8, dtype=torch.int32)
    with pytest.raises(ValueError, match="needs segment_ids"):
        fa.flash_attention(x, x, x, kv_segment_ids=seg)
    with pytest.raises(ValueError, match="kv_segment_ids shape"):
        fa.flash_attention(x, x, x, segment_ids=seg,
                           kv_segment_ids=seg[:, :4])
