"""The port's lamb, lars, adafactor and lion against optax's.

Each optimizer of ``train.optimizers.build_optimizer`` runs the same
numpy-seeded gradient sequence as its optax chain from JAX's
``build_optimizer`` (``distributedtensorflow_tpu/train/optimizers.py``):
on loose tensors (a parameter that adafactor factors, one it does not,
a bias), with a schedule, clipping and the decay mask, and on BERT-tiny
through the flax layouts (its (E, H, D) attention kernels, which
adafactor leaves unfactored where the port's (E, E) matrix would
factor).  The optimizer state moves to optax and back
(``opt_state_to_optax``/``opt_state_from_optax``) and through
``state_dict()``, and the resumed update repeats bit for bit.
Tolerance: parameters and moments within 1e-5 of a leaf's max-abs after
every update (fp32; the two sides round the same formulas in other
orders).
"""

import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu.train import optimizers as jax_opt
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch.train import optimizers as topt
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

TOL = 1e-5
UPDATES = 5
SHAPES = {"w_factored": (256, 160), "w_small": (24, 40), "bias": (40,)}


def _close(got, ref, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=tol * max(np.abs(ref).max(), 1e-30))


def _schedule(kind):
    """The same schedule on both sides (optax's and the port's copy)."""
    if kind is None:
        return 3e-3, 3e-3
    return (jax_opt.build_schedule(kind, 3e-3, warmup_steps=2,
                                   total_steps=UPDATES),
            topt.build_schedule(kind, 3e-3, warmup_steps=2,
                                total_steps=UPDATES))


#: (optimizer, weight decay, schedule, global clipnorm, decay mask)
CASES = {
    "lamb_mask_cosine": ("lamb", 0.01, "cosine", 0.0, True),
    "lamb_clip": ("lamb", 0.0, None, 0.5, False),
    "lars_decay_linear_clip": ("lars", 1e-4, "linear", 1.0, False),
    "adafactor_cosine": ("adafactor", 0.0, "cosine", 0.0, False),
    "adafactor_clip": ("adafactor", 0.0, None, 0.5, False),
    "lion_mask": ("lion", 0.1, None, 0.0, True),
    "lion_cosine_clip": ("lion", 0.0, "cosine", 1.0, False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_optimizer_matches_optax_update_for_update(case):
    """Five updates of a factored (256 x 160) and an unfactored (24 x 40)
    matrix and a bias: the parameters equal optax's after every update,
    and the learning rate is optax's count's."""
    name, wd, sched, clip, masked = CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in SHAPES.items()}
    grads = [{k: (rng.standard_normal(s) * 0.1).astype(np.float32)
              for k, s in SHAPES.items()} for _ in range(UPDATES)]
    jlr, tlr = _schedule(sched)
    mask = {k: k != "bias" for k in SHAPES} if masked else None
    tx = jax_opt.build_optimizer(name, jlr, weight_decay=wd,
                                 global_clipnorm=clip, decay_mask=mask)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = tx.init(jparams)
    update = jax.jit(tx.update)
    named = [(k, torch.nn.Parameter(torch.tensor(v)))
             for k, v in params.items()]
    opt = tt.build_optimizer(name, tlr, weight_decay=wd,
                             global_clipnorm=clip, decay_mask=mask)(named)
    for i, g in enumerate(grads):
        upd, jstate = update({k: jnp.asarray(v) for k, v in g.items()},
                             jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        for k, p in named:
            p.grad = torch.tensor(g[k])
        opt.step()
        assert opt.param_groups[0]["lr"] == topt.learning_rate(tlr, i)
        for k, p in named:
            _close(p, jparams[k])


def _bert():
    cfg = tm.bert_tiny()
    model = tm.BertForMLM(cfg, device="cpu")
    model.load_state_dict(tm.init_params(cfg,
                                         torch.Generator().manual_seed(0)))
    return cfg, model


def _grads(model, seed):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.randn(p.shape, generator=g) * 0.01
            for n, p in model.named_parameters()}


def _step(opt, model, grads):
    for n, p in model.named_parameters():
        p.grad = grads[n].clone()
    opt.step()


@pytest.mark.parametrize("name", ["lamb", "lars", "adafactor", "lion"])
def test_state_moves_to_optax_and_back_on_bert(name):
    """BERT-tiny through the flax layouts, on a warm-up cosine schedule:
    two updates equal optax's on the converted tree; the port's state
    converted to optax equals optax's own state leaf for leaf; a fresh
    port optimizer loaded from optax's state (and one from
    ``state_dict()`` bytes) takes the third update bit for bit as the
    uninterrupted one, and equal to optax's."""
    cfg, model = _bert()
    wd = 0.0 if name == "adafactor" else 0.01
    # a schedule, so that every optax chain keeps the count
    jlr = jax_opt.build_schedule("cosine", 1e-3, warmup_steps=1,
                                 total_steps=10)
    tlr = topt.build_schedule("cosine", 1e-3, warmup_steps=1,
                              total_steps=10)
    make = tt.build_optimizer(name, tlr, weight_decay=wd,
                              views=tm.flax_views(cfg))
    opt = make(list(model.named_parameters()))
    tx = jax_opt.build_optimizer(name, jlr, weight_decay=wd)
    jparams = jax.tree.map(
        jnp.asarray, tm.params_to_flax(model.state_dict(), cfg)["params"])
    jstate = tx.init(jparams)
    like, update = jstate, jax.jit(tx.update)
    seq = [_grads(model, s) for s in range(3)]
    for grads in seq[:2]:
        jg = jax.tree.map(jnp.asarray,
                          tm.params_to_flax(grads, cfg)["params"])
        upd, jstate = update(jg, jstate, jparams)
        jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
        _step(opt, model, grads)
    got = tm.params_to_flax(model.state_dict(), cfg)["params"]
    for path, ref in jax.tree_util.tree_leaves_with_path(jparams):
        leaf = got
        for key in path:
            leaf = leaf[key.key]
        _close(leaf, ref)
    # the port's state as optax's, leaf for leaf
    mine = tm.opt_state_to_optax(opt, cfg, model, like)
    for a, b in zip(jax.tree_util.tree_leaves(mine),
                    jax.tree_util.tree_leaves(jstate)):
        assert np.shape(a) == np.shape(b)
        _close(a, b)
    # resume from optax's state and from the port's state_dict bytes
    saved = io.BytesIO()
    torch.save(opt.state_dict(), saved)
    resumed = []
    for source in ("optax", "state_dict"):
        _, twin = _bert()
        twin.load_state_dict(model.state_dict())
        opt2 = make(list(twin.named_parameters()))
        if source == "optax":
            opt2.load_state_dict(tm.opt_state_from_optax(
                jax.device_get(jstate), cfg, opt2, twin))
        else:
            saved.seek(0)
            opt2.load_state_dict(torch.load(saved))
        resumed.append((opt2, twin))
    _step(opt, model, seq[2])
    for opt2, twin in resumed:
        _step(opt2, twin, seq[2])
        assert opt2.param_groups[0]["count"] == 3
    ref = model.state_dict()
    for k, v in resumed[1][1].state_dict().items():
        assert torch.equal(v, ref[k]), k
    for k, v in resumed[0][1].state_dict().items():  # optax's rounding
        _close(v, ref[k])


def test_adafactor_factors_the_flax_layout():
    """BERT-tiny's query kernel is (128, 4, 32) in flax: optax keeps a
    full ``v`` for it (its second-largest dim is 32 < 128), so the port
    does too, though the port's weight is a (128, 128) matrix; the MLM
    head's (128, 1024) kernel is factored, with optax's row and column
    shapes."""
    cfg, model = _bert()
    opt = tt.build_optimizer("adafactor", 1e-3,
                             views=tm.flax_views(cfg))(
        list(model.named_parameters()))
    _step(opt, model, _grads(model, 0))
    q = opt.state[model.encoder.layer_0.attention.query.weight]
    assert q["v"].shape == (128, 4, 32) and q["v_row"].shape == (1,)
    head = opt.state[model.mlm_out.weight]
    assert head["v_row"].shape == (128,) and head["v_col"].shape == (1024,)
    assert float(head["step"]) == 1.0
