"""The layer-wise optimizers over split parameters against optax's.

``optax.lamb`` and ``optax.lars`` scale each parameter's update by a
trust ratio of the whole parameter's norm over the whole update's; under
GSPMD a parameter sharded over ``model`` or ``expert`` is still one
logical array.  Here each rank holds its piece, so the ratio's two norms
are summed over the piece's group (``parallel.placement``, bound by
``create_sharded_state``).  One LAMB and one LARS update of gpt_tiny
over ``data=1,model=2`` and of gpt_moe_tiny over ``data=1,expert=2``
(two thread ranks, fp32), from JAX's flax init converted, with the same
numpy-seeded gradients (each rank given its cut of them by
``models.convert.shards_for_rank``): the ranks' parameters put back
together (``parallel.sharding.unshard_states``, the expert halves in
rank order) equal optax's update of the whole tree.  Adafactor's
factored moments over a split parameter are not ported: ``train_torch``
exits "not ported" and ``create_sharded_state`` raises.  Without a split
axis no ``split`` is bound and the update is the one-process one.

Tolerance: each updated parameter within 1e-5 of its update's max-abs
(fp32, as ``tests/test_torch_optimizers2.py``) plus one fp32 ulp of the
parameter's max-abs (where ``p + u`` rounds).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_moe as jax_gpt_moe
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.train import optimizers as jax_opt
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.parallel import sharding
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
from distributedtensorflow_tpu_torch.train import (
    TrainState,
    create_sharded_state,
)
from distributedtensorflow_tpu_torch.train.optimizers import build_optimizer
import train_torch

TOL = 1e-5


def _init(name):
    """JAX's flax params of the preset's test config, and the port's
    workload and fp32 config."""
    if name == "gpt_lm":
        jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
        jmodel = JaxGPTLM(jcfg)
    else:
        jcfg = dataclasses.replace(jax_gpt_moe.gpt_moe_tiny(),
                                   dtype=jnp.float32)
        jmodel = jax_gpt_moe.GPTMoELM(jcfg)
    params = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"])
    wl = tw.get_workload(name, test_size=True)
    return params, wl, dataclasses.replace(wl.cfg, dtype=torch.float32)


def _grads(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                        .astype(np.float32), params)


#: (optimizer, learning rate, weight decay); LARS at a rate of its own
#: recipes' scale, so its update stands above the parameters' rounding
OPTS = {"lamb": ("lamb", 1e-2, 0.01), "lars": ("lars", 1.0, 1e-4)}
#: (preset, mesh axes)
LAYOUTS = {"model2": ("gpt_lm", dict(data=1, model=2)),
           "expert2": ("gpt_moe", dict(data=1, expert=2))}


def _whole(outs, wl, cfg, axes):
    """The ranks' parameters put back together (rank order)."""
    states = [s for _, s in sorted(outs, key=lambda o: o[0])]
    if axes.get("model", 1) > 1:
        rules = sharding.tp_rules(wl.model_cls(cfg, device="meta"), cfg,
                                  wl.layout)
        return sharding.unshard_states(states, rules)
    stacks = set(sharding.ep_rules(cfg, wl.layout))
    return {k: torch.cat([s[k] for s in states]) if k in stacks else v
            for k, v in states[0].items()}


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_layerwise_update_over_split_axis_matches_optax(opt, layout):
    name, lr, wd = OPTS[opt]
    preset, axes = LAYOUTS[layout]
    params, wl, cfg = _init(preset)
    grads = _grads(params, 7)
    tx = jax_opt.build_optimizer(name, lr, weight_decay=wd)
    updates, _ = tx.update(grads, tx.init(params), params)
    ref = tm.params_from_flax(jax.device_get(updates), cfg)
    whole = tm.params_from_flax(params, cfg)
    world = int(np.prod(list(axes.values())))

    def body(rank, mesh):
        bound = wl.for_mesh(mesh)
        model = bound.model_cls(cfg, device="cpu",
                                **({"group": mesh}
                                   if bound.model_takes_group else {}))
        model.load_state_dict(whole)
        state, _ = create_sharded_state(
            model, build_optimizer(name, lr, weight_decay=wd), mesh,
            cfg=cfg, rules=bound.layout)
        cut = tm.convert.shards_for_rank(grads, cfg, mesh.coords, mesh.shape,
                                         layout=bound.layout)["params"]
        state.apply_gradients(cut)
        return rank, {k: p.detach().clone()
                      for k, p in model.named_parameters()}

    got = _whole(run_mesh(body, MeshSpec(**axes), world), wl, cfg, axes)
    assert got.keys() == ref.keys()
    for k, u in ref.items():
        u, p = u.numpy(), whole[k].numpy()
        np.testing.assert_allclose(
            got[k].numpy(), p + u, rtol=0, err_msg=k,
            atol=TOL * np.abs(u).max() + np.spacing(np.abs(p).max()))


@pytest.mark.parametrize("mesh", ["data=1,model=2", "data=1,expert=2"])
def test_adafactor_over_split_axis_exits_not_ported(mesh):
    args = train_torch.parse_args(["--workload", "gpt_moe", "--test-size",
                                   "--device", "cpu", "--mesh", mesh,
                                   "--optimizer", "adafactor", "--lr",
                                   "1e-2"])
    with pytest.raises(SystemExit, match="adafactor over a model or expert "
                                         "axis is not ported"):
        train_torch.check_flags(args)


def test_adafactor_over_model_axis_refuses_to_build():
    """Built past the flags, the split state refuses adafactor rather
    than update with a shard's factored moments."""
    _, wl, cfg = _init("gpt_lm")
    whole = wl.init_params(cfg, torch.Generator().manual_seed(0))

    def body(rank, mesh):
        model = wl.model_cls(cfg, device="cpu")
        model.load_state_dict(whole)
        with pytest.raises(NotImplementedError, match="adafactor"):
            create_sharded_state(model, build_optimizer(
                "adafactor", 1e-2, views=tm.flax_views(cfg)), mesh,
                cfg=cfg, rules=wl.layout)

    run_mesh(body, MeshSpec(data=1, model=2), 2)


def test_no_split_axis_binds_nothing():
    """Over a data axis alone nothing is split: no placement, no
    ``split`` on the optimizer, and the LAMB update equals one
    process's bit for bit."""
    _, wl, cfg = _init("gpt_lm")
    whole = wl.init_params(cfg, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(3)
    grads = {k: 0.1 * torch.randn(v.shape, generator=gen)
             for k, v in whole.items()}
    make = build_optimizer("lamb", 1e-2, weight_decay=0.01)
    model = wl.model_cls(cfg, device="cpu")
    model.load_state_dict(whole)
    TrainState.create(model, make).apply_gradients(
        {k: g.clone() for k, g in grads.items()})
    ref = {k: p.detach().clone() for k, p in model.named_parameters()}

    def body(rank, mesh):
        m = wl.model_cls(cfg, device="cpu")
        m.load_state_dict(whole)
        state, _ = create_sharded_state(m, make, mesh, cfg=cfg,
                                        rules=wl.layout)
        assert state.placement is None
        assert getattr(state.optimizer, "split", None) is None
        state.apply_gradients({k: g.clone() for k, g in grads.items()})
        return {k: p.detach().clone() for k, p in m.named_parameters()}

    for got in run_mesh(body, MeshSpec(data=2), 2):
        for k, v in ref.items():
            assert torch.equal(got[k], v), k
