"""The port's training dynamics (``obs/dynamics.py``, the step's
``dynamics_every`` and the GPT NaN taps) against the JAX package's.

A tiny GPT from one flax init takes one step of the port's
``make_train_step(dynamics_every=1)``; JAX's ``cadence_stats`` runs on
the same old parameters, gradients and new parameters (converted to the
flax tree): the same keys, the norms and ratios within 1e-5 relative
(fp32; the two sum the leaves of a module in different orders), the
non-finite counts exactly.  The module names and their order equal
JAX's ``group_names`` for the presets, and the overflow cap folds the
same names.  No row lands off the cadence, k = 2 books the rows k = 1
books bit for bit, two data-parallel ranks hold one process's rows on
the whole batch, and a poisoned ``h1`` is named by both packages'
provenance passes.
"""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import make_nan_taps as jax_nan_taps
from distributedtensorflow_tpu.obs import dynamics as jdyn
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import train as tt
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.obs import dynamics as dyn
from tools import check_metrics_schema
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

#: Relative tolerance of the fp32 norms and ratios against JAX's.
RTOL = 1e-5


@functools.lru_cache(maxsize=None)
def _init(seed=0):
    return jax.jit(JaxGPTLM(jax_gpt_tiny()).init)(
        jax.random.PRNGKey(seed), jnp.zeros((2, 16), jnp.int32))["params"]


def _tiny(seed=0):
    """``(flax params, port model)`` of gpt_tiny from one flax init."""
    params = _init(seed)
    cfg = tm.gpt_tiny()
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(params, cfg))
    return params, model


def _batch(seed=0, shape=(4, 16)):
    rng = np.random.default_rng(seed)
    return {"input_ids": torch.as_tensor(rng.integers(0, 512, shape))}


def _flax(named, cfg):
    return jax.tree.map(jnp.asarray, tm.params_to_flax(
        {n: t.detach().float() for n, t in named.items()}, cfg))


def test_cadence_stats_match_jax():
    """One port step with ``dynamics_every=1`` against JAX's
    ``cadence_stats`` on the same old parameters, gradients (before the
    optimizer's clipping) and new parameters."""
    _, model = _tiny()
    cfg = model.cfg
    wl = tw.get_workload("gpt_lm", test_size=True)
    loss_fn = tm.lm_loss(model)
    state = tt.TrainState.create(model, wl.make_optimizer)
    batch = _batch()
    old = {n: p.detach().clone() for n, p in model.named_parameters()}
    grads, _ = tt.accumulate_gradients(loss_fn, model, batch, seed=0, step=0)
    step = tt.make_train_step(loss_fn, dynamics_every=1,
                              dynamics_modules=tm.flax_modules(cfg))
    state, metrics = step(state, batch)
    got = {k: float(v) for k, v in metrics.items()
           if k.startswith(dyn.METRIC_PREFIX)}
    new = dict(model.named_parameters())
    want = jdyn.cadence_stats(_flax(old, cfg), _flax(new, cfg),
                              _flax(grads, cfg), step=jnp.int32(0), every=1)
    want = {k: float(v) for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        if "/nonfinite/" in key:
            assert got[key] == value == 0.0
        else:
            np.testing.assert_allclose(got[key], value, rtol=RTOL,
                                       err_msg=key)
    assert got["dynamics/update_ratio/h0"] > 0


def test_cadence_counts_nonfinite_grads_as_jax():
    """Non-finite gradient elements counted by module, as JAX counts."""
    params, model = _tiny()
    names = [n for n, _ in model.named_parameters()]
    grads = {n: torch.zeros_like(p) for n, p in model.named_parameters()}
    grads["h.1.fc_in.weight"][0, :3] = float("nan")
    grads["wte.weight"][2, 1] = float("inf")
    stats = dyn.StepStats(names, tm.flax_modules(model.cfg))
    got = {k: float(v)
           for k, v in stats.after(model, *stats.before(model, grads)).items()}
    want = jdyn.cadence_stats(params, params, _flax(grads, model.cfg),
                              step=jnp.int32(4), every=5)
    for module, count in (("h0", 0), ("h1", 3), ("ln_f", 0), ("wte", 1)):
        key = f"dynamics/nonfinite/{module}"
        assert got[key] == float(want[key]) == count
    assert not np.isfinite(got["dynamics/global_grad_norm"])
    assert not np.isfinite(float(want["dynamics/global_grad_norm"]))


#: Presets whose module names are checked against JAX's group_names.
GROUP_PRESETS = ("gpt_lm", "gpt_moe", "mnist_lenet", "cifar_resnet20",
                 "bert_mlm", "widedeep", "imagenet_vit", "t5_seq2seq")


@pytest.mark.parametrize("name", GROUP_PRESETS)
def test_group_names_match_jax(name):
    """Every ``module=`` label and its place: JAX's sorted first path
    components of the flax params tree (its shapes only), and the port's
    through ``models.flax_modules``, which covers every parameter."""
    jw = jax_workloads.get_workload(name, test_size=True)
    shapes = jax.eval_shape(jw.init_fn, jax.random.PRNGKey(0))["params"]
    pw = tw.get_workload(name, test_size=True)
    modules = tm.flax_modules(pw.cfg)
    model = pw.model_cls(pw.cfg, device="cpu")
    assert set(modules) == {n for n, _ in model.named_parameters()}
    assert dyn.group_names(list(modules), modules) == \
        jdyn.group_names(shapes)


def test_group_overflow_folds_as_jax():
    """Past MAX_MODULES the same names fold into ``_other``."""
    tree = {f"m{i}": {"w": 0.0} for i in range(40)}
    names = [f"m{i}.w" for i in range(40)]
    got = dyn.group_names(names)
    assert got == jdyn.group_names(tree)
    assert len(got) == dyn.MAX_MODULES and got[-1] == dyn.OVERFLOW_MODULE


@pytest.mark.parametrize("vals", [(0, 0, 0), (0, 0, 3), (5, 1, 0),
                                  (0, 2, 0, 1), ()])
def test_first_bad_index_matches_jax(vals):
    jprefix = jnp.cumsum(jnp.asarray(vals, jnp.int32)) > 0
    prefix = torch.cumsum(torch.as_tensor(vals, dtype=torch.int32), 0) > 0
    assert dyn.first_bad_index(prefix) == jdyn.first_bad_index(jprefix)


def _run(k, logdir, every=2, steps=4):
    """``steps`` steps of gpt_tiny at ``k`` steps a call under a
    DynamicsMonitor (log every 2): the dynamics.jsonl rows, each call's
    dynamics keys."""
    _, model = _tiny()
    wl = tw.get_workload("gpt_lm", test_size=True)
    state = tt.TrainState.create(model, wl.make_optimizer)
    mon = dyn.DynamicsMonitor(every, logdir=str(logdir), log_every=2,
                              steps_per_call=k,
                              modules=tm.flax_modules(model.cfg))
    seen = []

    def raw_step(state, batch):
        state, metrics = inner(state, batch)
        seen.append(sorted(m for m in metrics
                           if m.startswith(dyn.METRIC_PREFIX)))
        return state, metrics

    inner = tt.make_multi_train_step(
        tm.lm_loss(model), steps_per_call=k, dynamics_every=every,
        dynamics_modules=tm.flax_modules(model.cfg))
    step = mon.wrap_train_step(raw_step)
    mon.on_fit_begin(None, state)
    batches = [_batch(i) for i in range(steps)]
    for c in range(steps // k):
        chunk = batches[c * k:(c + 1) * k]
        batch = chunk[0] if k == 1 else {
            "input_ids": torch.stack([b["input_ids"] for b in chunk])}
        state, metrics = step(state, batch)
        assert not any(m.startswith(dyn.METRIC_PREFIX) for m in metrics)
        mon.on_step_end(None, state.step, state, metrics)
    mon.on_fit_end(None, state)
    mon.close()
    with open(logdir / "dynamics.jsonl") as f:
        rows = [json.loads(line) for line in f]
    return rows, seen


def test_no_row_off_cadence_and_k2_equals_k1(tmp_path):
    """Rows land on steps 2 and 4 only; a call of one off-cadence step
    carries no dynamics keys; k = 2 books the same rows bit for bit; the
    file passes the schema checker."""
    rows1, seen1 = _run(1, tmp_path / "k1")
    rows2, _ = _run(2, tmp_path / "k2")
    assert [r["step"] for r in rows1] == [2, 4]
    assert seen1[0] == [] and seen1[2] == [] and seen1[1]
    strip = [{k: v for k, v in r.items() if k != "t"} for r in rows1]
    assert strip == [{k: v for k, v in r.items() if k != "t"}
                     for r in rows2]
    assert check_metrics_schema.main(
        [str(tmp_path / "k1" / "dynamics.jsonl")]) == 0


def test_nan_taps_forward_order_as_jax():
    """The tap keys of both packages, in forward order, all zero on clean
    weights."""
    params, model = _tiny()
    batch = _batch(shape=(2, 8))
    jtaps = jax.jit(jax_nan_taps(JaxGPTLM(jax_gpt_tiny())))(
        params, {"input_ids": jnp.asarray(batch["input_ids"].numpy())})
    taps = tm.make_nan_taps(model)(batch)
    assert list(taps) == sorted(jtaps)
    assert all(int(v) == 0 for v in taps.values())
    assert tm.make_nan_taps(tm.GPTMoELM(tm.gpt_moe_tiny(), device="cpu")) \
        is None


class _JaxState:
    def __init__(self, params, step):
        self.params, self.step, self.model_state = params, step, {}


def test_provenance_names_poisoned_h1_in_both(tmp_path):
    """A NaN block ``h1``: both packages' passes name it by the
    activation taps, and their parameter censuses agree."""
    params, model = _tiny()
    batch = _batch(shape=(2, 8))
    poisoned = dict(params)
    poisoned["h1"] = jax.tree.map(lambda x: jnp.full_like(x, jnp.nan),
                                  params["h1"])
    jmon = jdyn.DynamicsMonitor(5, tap_fn=jax_nan_taps(
        JaxGPTLM(jax_gpt_tiny())))
    jmon._last = (_JaxState(poisoned, 7),
                  {"input_ids": jnp.asarray(batch["input_ids"].numpy())},
                  jax.random.PRNGKey(0))
    jdoc = jmon.maybe_provenance(7, "non_finite_loss")

    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith("h.1."):
                p.fill_(float("nan"))
    wl = tw.get_workload("gpt_lm", test_size=True)
    state = tt.TrainState.create(model, wl.make_optimizer)
    mon = dyn.DynamicsMonitor(5, logdir=str(tmp_path),
                              loss_fn=tm.lm_loss(model),
                              tap_fn=tm.make_nan_taps(model),
                              modules=tm.flax_modules(model.cfg))
    mon._last = (state, batch)
    doc = mon.maybe_provenance(7, "non_finite_loss")
    assert doc["module"] == jdoc["module"] == "h1"
    assert doc["method"] == jdoc["method"] == "activation_taps"
    assert doc["first_bad_param_module"] == \
        jdoc["first_bad_param_module"] == "h1"
    assert doc["nonfinite_param_counts"] == jdoc["nonfinite_param_counts"]
    assert doc["modules_searched"] == jdoc["modules_searched"] == 4
    assert mon.maybe_provenance(7, "non_finite_loss") is None  # once a step
    assert dyn.last_provenance()["module"] == "h1"
    status, payload = mon.dynamicz("n=1")
    assert status == 200 and payload["provenance"]["module"] == "h1"
    manifest = tmp_path / "incidents" / "0007-nan_provenance" / \
        "manifest.json"
    assert json.loads(manifest.read_text())["labels"] == {"module": "h1"}


def test_data_parallel_rows_are_the_global_batchs():
    """Two gloo thread ranks, each on its half of the batch: the stats
    come from the summed gradients, so both ranks hold the same rows,
    equal to one process's on the whole batch within RTOL."""
    import dataclasses

    from distributedtensorflow_tpu_torch.parallel.mesh import (
        MeshSpec,
        build_mesh,
    )
    from distributedtensorflow_tpu_torch.testing import run_ranks

    params = _init()
    cfg = dataclasses.replace(tm.gpt_tiny(), dtype=torch.float32)
    state_dict = tm.params_from_flax(params, cfg)
    batch = _batch(shape=(4, 16))
    wl = tw.get_workload("gpt_lm", test_size=True)

    def run(model, loss_fn, part, mesh=None):
        state = tt.TrainState.create(model, wl.make_optimizer, mesh)
        step = tt.make_train_step(loss_fn, mesh=mesh, dynamics_every=1,
                                  dynamics_modules=tm.flax_modules(cfg))
        _, metrics = step(state, part)
        return {k: float(v) for k, v in metrics.items()
                if k.startswith(dyn.METRIC_PREFIX)}

    def body(rank, group):
        mesh = build_mesh(MeshSpec(data=2), group)
        model = tm.GPTLM(cfg, device="cpu")
        model.load_state_dict(state_dict)
        part = {"input_ids": batch["input_ids"][2 * rank:2 * rank + 2]}
        return run(model, tm.lm_loss(model, group=mesh), part, mesh)

    ranks = run_ranks(body, 2)
    model = tm.GPTLM(cfg, device="cpu")
    model.load_state_dict(state_dict)
    one = run(model, tm.lm_loss(model), batch)
    assert ranks[0] == ranks[1]
    assert sorted(ranks[0]) == sorted(one)
    for key, value in one.items():
        np.testing.assert_allclose(ranks[0][key], value, rtol=RTOL,
                                   atol=0.0, err_msg=key)
