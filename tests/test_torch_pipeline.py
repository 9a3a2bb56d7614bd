"""The port's pipeline schedules and executors against JAX's.

``parallel/pipeline.py`` of the port: the 1F1B-family tables
(``fb_schedule``: every table cell, ``n_slots``, ``ticks`` and the bubble
fractions equal JAX's over a grid of stages, microbatches and virtual
chunks, and the same inputs are refused), the lock-step handoff
(``collectives.exchange``) over thread ranks, and the generic GPipe and
circular executors on a residual MLP stage: ``make_pipelined_fn`` over
``pipe=4`` thread ranks against JAX's ``make_pipelined_fn`` /
``make_circular_pipelined_fn`` on four of the conftest's eight CPU
devices, from the same weights, for the outputs and for the gradients of
``sum(out ** 2)`` with respect to every stage's weights and the input.

Tolerances: fp32, outputs 1e-5 (JAX's own ``tests/test_pipeline.py``),
gradients 1e-4 of each one's max-abs (``tests/test_torch_dp.py``'s rule:
through twelve residual stages some reach 300); the schedule tables
exactly.
"""

import itertools

import jax
import jax.numpy as jnp
import flax.linen as nn
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.parallel import MeshSpec as JMeshSpec
from distributedtensorflow_tpu.parallel import build_mesh as jbuild_mesh
from distributedtensorflow_tpu.parallel import pipeline as jpipe
from distributedtensorflow_tpu_torch.parallel import collectives as coll
from distributedtensorflow_tpu_torch.parallel import pipeline as tpipe
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh, run_ranks
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

WIDTH = 16
STAGES = 4


# ------------------------------------------------------------ the schedules


GRID = list(itertools.product(range(1, 5), range(1, 9), range(1, 4)))


@pytest.mark.parametrize("n,m,v", GRID)
def test_fb_schedule_equals_jax(n, m, v):
    """Every table cell, the slot bound, the ticks and the bubble fraction
    of the port's schedule equal JAX's; an input JAX refuses is refused
    with the same error."""
    try:
        ref = jpipe.fb_schedule(n, m, v)
    except ValueError as e:
        with pytest.raises(ValueError, match="interleaved schedule needs"):
            tpipe.fb_schedule(n, m, v)
        assert "interleaved schedule needs" in str(e)
        return
    got = tpipe.fb_schedule(n, m, v)
    assert (got.n_stages, got.n_micro, got.n_virtual, got.n_slots,
            got.ticks) == (ref.n_stages, ref.n_micro, ref.n_virtual,
                           ref.n_slots, ref.ticks)
    assert got.tables.keys() == ref.tables.keys()
    for k, table in ref.tables.items():
        np.testing.assert_array_equal(got.tables[k], table, err_msg=k)
    assert got.bubble_fraction() == ref.bubble_fraction()
    assert tpipe.gpipe_bubble_fraction(n, m) == \
        jpipe.gpipe_bubble_fraction(n, m)
    assert tpipe.circular_bubble_fraction(n, m, v) == \
        jpipe.circular_bubble_fraction(n, m, v)


def test_fb_schedule_validation():
    assert tpipe.SCHEDULES == jpipe.SCHEDULES
    with pytest.raises(ValueError, match="multiple"):
        tpipe.fb_schedule(4, 6, 2)
    with pytest.raises(ValueError, match="n_stages"):
        tpipe.fb_schedule(0, 4)
    with pytest.raises(ValueError, match="n_virtual"):
        tpipe.fb_schedule(2, 4, 0)
    s = tpipe.fb_schedule(4, 16)
    assert s.n_slots <= 2 * 4 - 1 < 16
    assert s.tables["f_on"].sum() == s.tables["b_on"].sum() == 16 * 4


# ------------------------------------------------------------- the handoff


@pytest.mark.parametrize("world", [1, 2, 3])
def test_exchange_sends_both_ways_in_lock_step(world):
    """Each stage's ``to_next`` reaches the next stage and its ``to_prev``
    the previous one, the ring wrapping; a bf16 wire rounds the payload
    and the receiver gets the sent dtype back; a direction nobody sends
    comes back None."""

    def body(rank, group):
        act = torch.full((2, 3), 1.0 + rank / 3, dtype=torch.float32)
        cot = torch.full((4,), 10.0 * rank, dtype=torch.float64)
        got = [coll.exchange(act, cot, group) for _ in range(3)]
        wired, none = coll.exchange(act, None, group,
                                    next_wire=torch.bfloat16)
        assert none is None
        return got, wired

    outs = run_ranks(body, world)
    for rank, (got, wired) in enumerate(outs):
        prev, nxt = (rank - 1) % world, (rank + 1) % world
        for from_prev, from_next in got:
            assert torch.equal(from_prev, torch.full(
                (2, 3), 1.0 + prev / 3, dtype=torch.float32))
            assert from_next.dtype == torch.float64
            assert torch.equal(from_next, torch.full((4,), 10.0 * nxt,
                                                     dtype=torch.float64))
        want = torch.full((2, 3), 1.0 + prev / 3).to(torch.bfloat16).float()
        assert wired.dtype == torch.float32 and torch.equal(wired, want)


# ---------------------------------------------------- the generic executors


class StageMLP(nn.Module):
    width: int = WIDTH

    @nn.compact
    def __call__(self, x):
        h = nn.Dense(self.width * 2, name="up")(x)
        return x + nn.Dense(self.width, name="down")(nn.relu(h))


class TorchStageMLP(torch.nn.Module):
    """The port's twin of ``StageMLP`` from one stage's flax params."""

    def __init__(self, params):
        super().__init__()
        self.up = torch.nn.Linear(WIDTH, 2 * WIDTH)
        self.down = torch.nn.Linear(2 * WIDTH, WIDTH)
        with torch.no_grad():
            for name in ("up", "down"):
                lin = getattr(self, name)
                lin.weight.copy_(torch.tensor(np.asarray(
                    params[name]["kernel"]).T))
                lin.bias.copy_(torch.tensor(np.asarray(params[name]["bias"])))

    def forward(self, x):
        return x + self.down(torch.relu(self.up(x)))


def _stage(mod, x):
    return mod(x)


@pytest.fixture(scope="module")
def jmesh(devices):
    return jbuild_mesh(JMeshSpec(data=1, pipe=STAGES), devices[:STAGES])


def _jax_run(jmesh, n_micro, n_virtual, remat):
    """JAX's outputs and gradients of ``sum(out ** 2)`` (stacked params,
    then the input) for the generic entry points."""
    model = StageMLP(WIDTH)
    init_fn = lambda r: model.init(r, jnp.zeros((1, WIDTH)))["params"]  # noqa: E731
    stage_fn = lambda p, x: model.apply({"params": p}, x)  # noqa: E731
    if n_virtual is None:
        stacked, specs = jpipe.stack_stage_params(
            init_fn, STAGES, jax.random.PRNGKey(0), jmesh)
        fn = jpipe.make_pipelined_fn(stage_fn, jmesh, specs,
                                     n_microbatches=n_micro, remat=remat)
    else:
        stacked, specs = jpipe.stack_circular_stage_params(
            init_fn, STAGES, n_virtual, jax.random.PRNGKey(0), jmesh)
        fn = jpipe.make_circular_pipelined_fn(
            stage_fn, jmesh, specs, n_microbatches=n_micro,
            n_virtual=n_virtual, remat=remat)
    x = jax.random.normal(jax.random.PRNGKey(1), (n_micro * 2, WIDTH))
    out = fn(stacked, x)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(fn(p, xx) ** 2),
                      argnums=(0, 1))(stacked, x)
    return (jax.device_get(stacked), np.asarray(x), np.asarray(out),
            jax.device_get(gp), np.asarray(gx))


def _chunk_params(stacked, n_virtual, c, p):
    index = (p,) if n_virtual is None else (c, p)
    return jax.tree.map(lambda a: a[index], stacked)


@pytest.mark.parametrize("n_micro,n_virtual,remat", [
    (8, None, False), (4, None, True), (4, 1, False), (4, 2, False),
    (8, 3, False), (4, 2, True)])
def test_generic_pipeline_matches_jax(jmesh, n_micro, n_virtual, remat):
    """``make_pipelined_fn`` (GPipe: ``n_virtual`` None) and its circular
    twin: the outputs on every stage, each stage's chunk gradients and
    the input's gradient equal JAX's."""
    stacked, x, ref_out, ref_gp, ref_gx = _jax_run(jmesh, n_micro,
                                                   n_virtual, remat)
    v = n_virtual or 1

    def body(rank, mesh):
        p = mesh.coords["pipe"]
        chunks = [TorchStageMLP(_chunk_params(stacked, n_virtual, c, p))
                  for c in range(v)]
        fn = tpipe.make_pipelined_fn(_stage, mesh, n_microbatches=n_micro,
                                     remat=remat)
        xt = torch.tensor(x, requires_grad=True)
        out = fn(chunks, xt)
        params = [t for c in chunks for t in c.parameters()]
        gs = torch.autograd.grad((out ** 2).sum(), [xt, *params])
        return out.detach().numpy(), gs[0].numpy(), \
            [g.numpy() for g in gs[1:]]

    outs = run_mesh(body, MeshSpec(data=1, pipe=STAGES), STAGES)
    for p, (out, gx, grads) in enumerate(outs):
        np.testing.assert_allclose(out, ref_out, rtol=1e-5, atol=1e-5)
        _close(gx, ref_gx)
        got = iter(grads)
        for c in range(v):
            ref = _chunk_params(ref_gp, n_virtual, c, p)
            for name in ("up", "down"):
                _close(next(got), ref[name]["kernel"].T)
                _close(next(got), ref[name]["bias"])


def _close(got, ref):
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-4 * np.abs(ref).max())


def test_generic_pipeline_refusals():
    """A circular schedule with fewer microbatches than stages and a
    batch the microbatches do not divide are refused, as in JAX."""

    def body(rank, mesh):
        chunk = torch.nn.Linear(WIDTH, WIDTH)
        fn = tpipe.make_pipelined_fn(_stage, mesh, n_microbatches=3)
        with pytest.raises(ValueError, match="not divisible"):
            fn([chunk], torch.zeros(8, WIDTH))
        with pytest.raises(ValueError, match="n_micro >= n_ranks"):
            tpipe.circular_pipeline_apply(
                _stage, [chunk, chunk], torch.zeros(1, 2, WIDTH),
                mesh.pipe_group)
        return True

    assert run_mesh(body, MeshSpec(data=1, pipe=2), 2) == [True, True]


def test_stack_stage_params_keeps_the_ranks_chunks():
    """Stage ``k = c*n + p`` is chunk ``c`` of pipe rank ``p``, every rank
    drawing every stage from the same generator."""

    def body(rank, mesh):
        g = torch.Generator().manual_seed(3)
        chunks = tpipe.stack_stage_params(lambda gen: torch.randn(
            2, generator=gen), 2, g, mesh, n_virtual=3)
        return [c.tolist() for c in chunks]

    outs = run_mesh(body, MeshSpec(data=1, pipe=2), 2)
    g = torch.Generator().manual_seed(3)
    stages = [torch.randn(2, generator=g).tolist() for _ in range(6)]
    assert outs == [[stages[c * 2 + p] for c in range(3)] for p in range(2)]
