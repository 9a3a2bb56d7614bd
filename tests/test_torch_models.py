"""The port's BASELINE.json models against the JAX package's.

LeNet-5, ResNet-20, the bottleneck ImageNet ResNet (both stems), BERT
MLM and Wide&Deep: each starts from one flax ``init`` moved across with
``params_from_flax`` and runs the same numpy-seeded inputs in fp32 at
dropout 0.  Tolerances: 1e-5 relative for forward outputs, losses and
running statistics; 1e-4 of a leaf's max-abs for gradients.  The JAX
package is only called.
"""

import dataclasses

import flax.linen as flax_nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from distributedtensorflow_tpu.models import bert as jax_bert
from distributedtensorflow_tpu.models import lenet as jax_lenet
from distributedtensorflow_tpu.models import resnet as jax_resnet
from distributedtensorflow_tpu.models import widedeep as jax_widedeep
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch.models.layers import (
    Conv,
    QuantDense,
    same_padding,
)
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401

RTOL = 1e-5
GRAD_TOL = 1e-4


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(val)


def _assert_trees_close(got, ref, rel, zero=()):
    """Each leaf of ``got`` within ``rel`` of the max-abs of ``ref``'s.
    A leaf whose path ends in one of ``zero`` is 0 in exact arithmetic
    (its values are rounding): both sides must stay below 1e-6 of the
    largest leaf of ``ref``."""
    got, ref = dict(_flat(got)), dict(_flat(ref))
    assert got.keys() == ref.keys()
    top = max(np.abs(r).max() for r in ref.values())
    for path, r in ref.items():
        if "/".join(path).endswith(zero):
            assert max(np.abs(r).max(), np.abs(got[path]).max()) <= 1e-6 * top
            continue
        np.testing.assert_allclose(got[path], r, rtol=0,
                                   atol=rel * np.abs(r).max(),
                                   err_msg="/".join(path))


def _close(got, ref, rtol=RTOL):
    """|got - ref| <= rtol * max|ref| (outputs near 0 compare to the
    output's scale, not their own)."""
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * np.abs(ref).max())


def _to_jax(variables):
    return jax.tree.map(jnp.asarray, variables)


def _port(cfg, variables):
    model = tm.convert.MODELS[type(cfg)](cfg, device="cpu")
    model.load_state_dict(tm.params_from_flax(variables, cfg))
    return model


# ------------------------------------------------------------------- LeNet


@pytest.fixture(scope="module")
def lenet():
    model = jax_lenet.LeNet5()
    variables = jax.jit(model.init)(jax.random.PRNGKey(1),
                                    jnp.zeros((2, 28, 28, 1)))
    return model, jax.device_get(variables)


def test_lenet_forward_matches_jax(lenet):
    """The logits agree; flattening the NCHW maps instead of NHWC (the
    trap: Dense_0's rows are (h, w, c)) gives other logits."""
    jmodel, variables = lenet
    x = np.random.default_rng(0).standard_normal((3, 28, 28, 1)).astype(
        np.float32)
    ref = jmodel.apply(_to_jax(variables), jnp.asarray(x))
    port = _port(tm.LeNetConfig(), variables)
    got = port(torch.from_numpy(x))
    _close(got, ref)
    h = torch.from_numpy(x).permute(0, 3, 1, 2)
    h = F.avg_pool2d(torch.tanh(port.Conv_0(h)), 2)
    h = F.avg_pool2d(torch.tanh(port.Conv_1(h)), 2)
    h = torch.tanh(port.Dense_1(torch.tanh(port.Dense_0(h.flatten(1)))))
    wrong = port.Dense_2(h)
    assert (wrong - got).abs().max() > 100 * RTOL * got.abs().max()


# ------------------------------------------------------------------ ResNets


def test_same_padding_is_flax_same():
    """flax "SAME" pads a stride-2 3x3 conv on an even input (0, 1); the
    port's Conv gives flax's output where a symmetric (1, 1) does not."""
    assert same_padding(32, 3, 2) == (0, 1)
    assert same_padding(33, 3, 2) == (1, 1)
    assert same_padding(32, 3, 1) == (1, 1)
    assert same_padding(32, 1, 2) == (0, 0)
    assert same_padding(28, 5, 1) == (2, 2)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 8, 3)).astype(np.float32)
    conv = flax_nn.Conv(4, (3, 3), strides=(2, 2), padding="SAME",
                        use_bias=False)
    variables = conv.init(jax.random.PRNGKey(0), jnp.asarray(x))
    ref = np.asarray(conv.apply(variables, jnp.asarray(x)))
    port = Conv(3, 4, (3, 3), strides=2, use_bias=False,
                dtype=torch.float32, device="cpu")
    kernel = np.asarray(variables["params"]["kernel"])
    port.weight.data = torch.from_numpy(kernel.transpose(3, 2, 0, 1).copy())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    _close(port(xt).permute(0, 2, 3, 1), ref)
    symmetric = F.conv2d(xt, port.weight, stride=2, padding=1)
    assert np.abs(symmetric.permute(0, 2, 3, 1).detach().numpy()
                  - ref).max() > 1e-2


#: (JAX model, port config, image side, tolerance of the logits).  The
#: bottleneck net's logits get 3e-5 of their max: its last stage
#: normalises 16 values a channel (B 4 at 2x2), and JAX's own fp32 logits
#: lie 1.2e-5 of their max from an fp64 evaluation of the same weights
#: (the port's 3.2e-6); the running statistics keep 1e-5.
RESNET_CASES = {
    "resnet20": (lambda: jax_resnet.ResNet20(dtype=jnp.float32),
                 lambda: tm.CifarResNetConfig(dtype=torch.float32), 32,
                 RTOL),
    "imagenet_1111": (
        lambda: jax_resnet.ImageNetResNet(stage_sizes=(1, 1, 1, 1),
                                          dtype=jnp.float32),
        lambda: tm.ImageNetResNetConfig(stage_sizes=(1, 1, 1, 1),
                                        dtype=torch.float32), 64, 3e-5),
    "imagenet_1111_s2d": (
        lambda: jax_resnet.ImageNetResNet(stage_sizes=(1, 1, 1, 1),
                                          dtype=jnp.float32,
                                          space_to_depth=True),
        lambda: tm.ImageNetResNetConfig(stage_sizes=(1, 1, 1, 1),
                                        dtype=torch.float32,
                                        space_to_depth=True), 64, 3e-5),
}


@pytest.mark.parametrize("case", sorted(RESNET_CASES))
def test_resnet_matches_jax(case):
    """Train-mode logits of two batches in turn, the running statistics
    after them (flax momentum 0.9 on the biased batch variance), and the
    eval-mode logits on those statistics.  The init's BatchNorm scales
    are randomised first, so the zero-init last scales do not hide a
    block's residual branch."""
    make_jax, make_cfg, side, tol = RESNET_CASES[case]
    jmodel, cfg = make_jax(), make_cfg()
    rng = np.random.default_rng(3)
    xs = [rng.standard_normal((4, side, side, 3)).astype(np.float32)
          for _ in range(3)]
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(0), jnp.asarray(xs[0])))
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
                      if p[-1].key == "scale" else v), variables["params"])
    variables = {"params": params, "batch_stats": variables["batch_stats"]}
    port = _port(cfg, variables)
    jvars = _to_jax(variables)
    apply_train = jax.jit(lambda v, x: jmodel.apply(
        v, x, train=True, mutable=["batch_stats"]))
    for x in xs[:2]:
        ref, new = apply_train(jvars, jnp.asarray(x))
        jvars = {"params": jvars["params"], **new}
        _close(port(torch.from_numpy(x), train=True), ref, tol)
    state = tm.params_to_flax(port.state_dict(), cfg)
    _assert_trees_close(state["batch_stats"],
                        jax.device_get(jvars["batch_stats"]), RTOL)
    ref = jmodel.apply(jvars, jnp.asarray(xs[2]), train=False)
    before = {k: v.clone() for k, v in port.state_dict().items()}
    _close(port(torch.from_numpy(xs[2]), train=False), ref, tol)
    assert all(torch.equal(before[k], v)
               for k, v in port.state_dict().items())


def test_resnet_param_counts():
    """The port's ResNet-50 and ResNet-20 count the flax trees'
    parameters exactly, inside ``tests/test_models.py``'s published
    bounds; the running statistics are buffers, not parameters."""
    def count(model):
        return sum(p.numel() for p in model.parameters())

    r50 = tm.ResNet50(device="meta")
    shapes = jax.eval_shape(lambda r: jax_resnet.ResNet50().init(
        r, jnp.zeros((1, 224, 224, 3))), jax.random.PRNGKey(0))
    flax50 = sum(np.prod(s.shape) for s in jax.tree.leaves(shapes["params"]))
    assert count(r50) == flax50 and 25_000_000 < count(r50) < 26_000_000
    r20 = tm.ResNet20(device="meta", dtype=torch.float32)
    shapes = jax.eval_shape(lambda r: jax_resnet.ResNet20().init(
        r, jnp.zeros((1, 32, 32, 3))), jax.random.PRNGKey(0))
    flax20 = sum(np.prod(s.shape) for s in jax.tree.leaves(shapes["params"]))
    assert count(r20) == flax20 and 260_000 < count(r20) < 280_000
    assert {n for n, _ in r20.named_buffers()} \
        == {n for n, _ in r20.named_buffers() if n.endswith(("mean", "var"))}


# --------------------------------------------------------------------- BERT


def _bert_cfgs():
    jcfg = dataclasses.replace(jax_bert.bert_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    tcfg = dataclasses.replace(tm.bert_tiny(), dtype=torch.float32,
                               dropout_rate=0.0)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def bert():
    jcfg, tcfg = _bert_cfgs()
    variables = jax.device_get(jax.jit(jax_bert.BertForMLM(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((2, 32), jnp.int32)))
    return jcfg, tcfg, variables


def _mlm_batch(packed, seq=32, b=3, vocab=1024):
    rng = np.random.default_rng(4)
    ids = rng.integers(4, vocab, (b, seq))
    masked = rng.random((b, seq)) < 0.3
    masked[0, :12] = True  # more masked positions than P = 7
    batch = {"input_ids": np.where(masked, 3, ids),
             "labels": np.where(masked, ids, -100)}
    if packed:
        seg = np.zeros((b, seq), np.int64)
        seg[:, :20], seg[:, 20:29] = 1, 2  # two examples and padding
        pos = np.where(seg == 1, np.arange(seq), np.arange(seq) - 20)
        batch.update(segment_ids=seg, position_ids=np.where(seg > 0, pos, 0))
        batch["labels"] = np.where(seg > 0, batch["labels"], -100)
    else:
        mask = np.ones((b, seq), np.int64)
        mask[2, 25:] = 0
        batch["attention_mask"] = mask
    return {k: v.astype(np.int32) for k, v in batch.items()}


@pytest.mark.parametrize("head,packed", [("gathered", False),
                                         ("dense", False),
                                         ("gathered", True)])
def test_bert_mlm_loss_and_grads_match_jax(bert, head, packed):
    """BERT-tiny's masked-LM loss, metrics and gradients with the
    gathered head (P = 32 // 5 + 1 = 7 of up to 12 masked positions a
    row), the dense head, and a packed batch (segment and position ids,
    padding)."""
    jcfg, tcfg, variables = bert
    p = tm.max_predictions_for(32) if head == "gathered" else None
    batch = _mlm_batch(packed)
    jloss_fn = jax_bert.mlm_loss(jax_bert.BertForMLM(jcfg),
                                 max_predictions=p)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jm, _)), jgrads = jax.value_and_grad(
        lambda prm: jloss_fn(prm, {}, jbatch, None), has_aux=True)(
        _to_jax(variables["params"]))
    model = _port(tcfg, variables)
    loss, m = tm.mlm_loss(model, max_predictions=p)(
        {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()})
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    assert m.keys() == jm.keys()
    for k in m:
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=RTOL)
    if head == "gathered":
        assert float(m["mlm_clipped_rows"]) > 0
    # a key bias shifts a query's scores by one constant: no gradient
    _assert_trees_close(tm.params_to_flax(dict(zip(names, grads)), tcfg),
                        {"params": jax.device_get(jgrads)}, GRAD_TOL,
                        zero=("key/bias",))


def test_bert_eval_matches_jax(bert):
    jcfg, tcfg, variables = bert
    batch = _mlm_batch(False)
    p = tm.max_predictions_for(32)
    ref = jax_bert.mlm_eval(jax_bert.BertForMLM(jcfg), max_predictions=p)(
        _to_jax(variables["params"]), {},
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = tm.mlm_eval(_port(tcfg, variables), max_predictions=p)(
        {k: torch.as_tensor(v, dtype=torch.long) for k, v in batch.items()})
    assert got.keys() == ref.keys()
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(ref[k]), rtol=RTOL)


def test_gathered_positions_keep_the_first_masked_in_order():
    """A row with more masked tokens than P keeps its first P, lowest
    index first, as ``lax.top_k`` of the 0/1 mask does; a row with fewer
    fills up with its first unmasked positions at weight 0."""
    assert [tm.max_predictions_for(s) for s in (128, 512, 32)] == [26, 103, 7]
    valid = np.zeros((3, 32), bool)
    valid[0, [1, 3, 4, 8, 9, 12, 17, 20, 25, 31]] = True  # 10 > P = 7
    valid[1, [30, 2]] = True
    valid[2] = True
    p = tm.max_predictions_for(32)
    jw, jpos = jax.lax.top_k(jnp.asarray(valid.astype(np.int32)), p)
    w, pos = tm.gathered_positions(torch.from_numpy(valid), p)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    assert pos[0].tolist() == [1, 3, 4, 8, 9, 12, 17]
    assert pos[1].tolist() == [2, 30, 0, 1, 3, 4, 5]


def test_bert_refuses_quant():
    """An unknown quant mode raises; the ported modes build the
    quantised attention and MLP layers (``tests/test_torch_quant.py``
    holds them to JAX)."""
    with pytest.raises(ValueError, match="quant mode"):
        tm.BertForMLM(dataclasses.replace(tm.bert_tiny(), quant="int4"),
                      device="cpu")
    model = tm.BertForMLM(dataclasses.replace(tm.bert_tiny(), quant="int8"),
                          device="cpu")
    assert isinstance(model.encoder.layer_0.mlp_in, QuantDense)
    assert isinstance(model.encoder.layer_0.attention.query, QuantDense)
    assert not isinstance(model.mlm_out, QuantDense)


# ---------------------------------------------------------------- Wide&Deep


def test_widedeep_loss_and_grads_match_jax():
    """fp32 Wide&Deep at the test config: the sigmoid cross-entropy, the
    accuracy and every gradient, embedding tables included (dense, as
    JAX's)."""
    jcfg = dataclasses.replace(jax_widedeep.widedeep_test_config(),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tm.widedeep_test_config(), dtype=torch.float32)
    jmodel = jax_widedeep.WideDeep(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((2, 2), jnp.int32),
        jnp.zeros((2, 4))))
    rng = np.random.default_rng(5)
    batch = {"categorical": np.stack([rng.integers(0, 512, 16),
                                      rng.integers(0, 128, 16)], 1),
             "dense": rng.standard_normal((16, 4)).astype(np.float32),
             "label": rng.integers(0, 2, 16)}
    batch["categorical"][:4, 0] = 7  # repeated ids add their gradients
    jloss_fn = jax_widedeep.widedeep_loss(jmodel)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (jloss, (jm, _)), jgrads = jax.value_and_grad(
        lambda prm: jloss_fn(prm, {}, jbatch, None), has_aux=True)(
        _to_jax(variables["params"]))
    model = _port(tcfg, variables)
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, m = tm.widedeep_loss(model)(tbatch)
    names, params = zip(*model.named_parameters())
    grads = torch.autograd.grad(loss, params)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=RTOL)
    np.testing.assert_allclose(float(m["accuracy"]), float(jm["accuracy"]))
    _assert_trees_close(tm.params_to_flax(dict(zip(names, grads)), tcfg),
                        {"params": jax.device_get(jgrads)}, GRAD_TOL)
    ev = tm.widedeep_eval(model)(tbatch)
    assert set(ev) == {"accuracy", "log_loss"}
    np.testing.assert_allclose(float(ev["log_loss"]), float(jloss),
                               rtol=RTOL)


# -------------------------------------------------------------- conversion


@pytest.mark.parametrize("name", ["lenet", "resnet", "bert", "widedeep"])
def test_params_round_trip_and_refusals(name, lenet, bert):
    """flax variables -> port state -> flax variables is bit-identical
    (BatchNorm statistics included); a missing, stray or misshapen leaf
    is refused; the port's own init builds the same state names."""
    if name == "lenet":
        cfg, variables = tm.LeNetConfig(), lenet[1]
    elif name == "bert":
        cfg, variables = bert[1], bert[2]
    elif name == "widedeep":
        cfg = tm.widedeep_test_config()
        variables = jax.device_get(jax_widedeep.WideDeep(
            jax_widedeep.widedeep_test_config()).init(
            jax.random.PRNGKey(0), jnp.zeros((2, 2), jnp.int32),
            jnp.zeros((2, 4))))
    else:
        cfg = tm.ImageNetResNetConfig(stage_sizes=(1, 1, 1, 1))
        variables = jax.device_get(jax.eval_shape(
            lambda r: jax_resnet.ImageNetResNet(stage_sizes=(1, 1, 1, 1)).init(
                r, jnp.zeros((1, 64, 64, 3))), jax.random.PRNGKey(0)))
        rng = np.random.default_rng(0)
        variables = jax.tree.map(
            lambda s: rng.standard_normal(s.shape).astype(np.float32),
            variables)
    state = tm.params_from_flax(variables, cfg)
    back = tm.params_to_flax(state, cfg)
    ref, got = dict(_flat(variables)), dict(_flat(back))
    assert got.keys() == ref.keys()
    for path, arr in ref.items():
        np.testing.assert_array_equal(got[path], arr)
    seeded = tm.init_params(cfg, torch.Generator().manual_seed(0))
    assert {k: tuple(v.shape) for k, v in seeded.items()} \
        == {k: tuple(v.shape) for k, v in state.items()}
    with pytest.raises(ValueError, match="unexpected"):
        tm.params_to_flax({**state, "stray": torch.zeros(1)}, cfg)
    (path, arr), = list(ref.items())[:1]
    with pytest.raises(ValueError, match="shape"):
        tm.params_from_flax(_with_leaf(back, path, arr[..., None]), cfg)
    with pytest.raises(ValueError, match="unexpected"):
        tm.params_from_flax(_with_leaf(back, ("params", "stray"), arr), cfg)
    with pytest.raises(ValueError, match="have no"):
        tm.params_from_flax({"params": {}}, cfg)


def _with_leaf(tree, path, value):
    """A copy of ``tree`` with ``value`` at ``path``."""
    out = dict(tree)
    out[path[0]] = value if len(path) == 1 else _with_leaf(
        tree.get(path[0], {}), path[1:], value)
    return out
