"""Tensor parallelism over ``model`` and the layout rules, against JAX.

The port's ``parallel/sharding.py`` beside the reference's: the spec
tables that ``specs_for_tree`` gives each preset's layout on the JAX
model's own parameter tree (and ``auto_fsdp_spec`` under ``fsdp``), and
the ``model=2`` step of gpt_tiny, BERT, the ViT, seq2seq with GQA (one
K/V head, so both model ranks read it whole) and Wide&Deep on two thread
ranks (``testing.run_mesh``) against the JAX loss and gradients on the
same batch.  GSPMD's tensor parallelism computes the unsharded model's
values, so the reference is the JAX model on one device; each rank's
gradients are its shards', put back together with the layout's cut
(``parallel.sharding.unshard_states``).  A ``data=2,model=2`` mesh of
four ranks runs gpt_tiny's data-parallel gradient sum over the tensor
shards against JAX's on the global batch.  fp32 at dropout 0.

The vocab-sharded head's plain twins over token tiles (the chunked
heads' path) match the untiled twins, the scale-out combinations the
port has not ported refuse (train_torch's flags) while checkpoints and
clipping over the split axes pass them, and the MoE presets bind over a
model axis (their experts over ``expert``).

Tolerances: the spec tables exactly; losses 1e-5 relative (the vocab
shards' logsumexp combines over the ranks); gradients 1e-4 of each
leaf's max-abs (as ``tests/test_torch_dp.py``), BERT's key bias left out
as there (its gradient is rounding noise on both sides); the tiled head
1e-6 of each max-abs (dw sums its tiles' products in another order).
"""

import dataclasses
import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributedtensorflow_tpu import workloads as jax_workloads
from distributedtensorflow_tpu.models import bert as jax_bert
from distributedtensorflow_tpu.models import seq2seq as jax_s2s
from distributedtensorflow_tpu.models import vit as jax_vit
from distributedtensorflow_tpu.models import widedeep as jax_wd
from distributedtensorflow_tpu.models import GPTLM as JaxGPTLM
from distributedtensorflow_tpu.models import gpt_tiny as jax_gpt_tiny
from distributedtensorflow_tpu.models import lm_loss as jax_lm_loss
from distributedtensorflow_tpu.parallel import sharding as jax_sharding
from distributedtensorflow_tpu.train import engine as jax_engine
from distributedtensorflow_tpu.train import losses as jax_losses
from distributedtensorflow_tpu_torch import models as tm
from distributedtensorflow_tpu_torch import workloads as tw
from distributedtensorflow_tpu_torch.data import InputContext, device_put_batch
from distributedtensorflow_tpu_torch.parallel import sharding
from distributedtensorflow_tpu_torch.parallel.mesh import MeshSpec
from distributedtensorflow_tpu_torch.testing import run_mesh
from distributedtensorflow_tpu_torch.train.engine import (
    accumulate_gradients_dp,
)
from distributedtensorflow_tpu_torch.train.state import create_sharded_state
from distributedtensorflow_tpu_torch.ops import fused_xent
from distributedtensorflow_tpu_torch.models.layers import VocabShard
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401
import train_torch

RTOL = 1e-5
GRAD_TOL = 1e-4


@dataclasses.dataclass
class Case:
    jloss: object
    variables: dict
    tcfg: object
    pw: object
    batch: int
    loss_builder: object
    skip: tuple = ()


def _gpt():
    pw = tw.get_workload("gpt_lm", test_size=True)
    jcfg = dataclasses.replace(jax_gpt_tiny(), dtype=jnp.float32)
    params = jax.jit(JaxGPTLM(jcfg).init)(
        jax.random.PRNGKey(0), jnp.zeros((2, 64), jnp.int32))["params"]
    return Case(jax_lm_loss(JaxGPTLM(jcfg)), {"params": params},
                dataclasses.replace(pw.cfg, dtype=torch.float32), pw, 8,
                tm.lm_loss)


def _bert():
    pw = tw.get_workload("bert_mlm", test_size=True)
    jcfg = dataclasses.replace(jax_bert.bert_tiny(), dtype=jnp.float32,
                               dropout_rate=0.0)
    p = tm.max_predictions_for(pw.seq_len)
    variables = jax.jit(jax_bert.BertForMLM(jcfg).init)(
        jax.random.PRNGKey(2), jnp.zeros((2, pw.seq_len), jnp.int32))
    return Case(jax_bert.mlm_loss(jax_bert.BertForMLM(jcfg),
                                  max_predictions=p), dict(variables),
                dataclasses.replace(pw.cfg, dtype=torch.float32,
                                    dropout_rate=0.0), pw, 8,
                functools.partial(tm.mlm_loss, max_predictions=p),
                skip=("key/bias",))


def _vit():
    jw = jax_workloads.get_workload("imagenet_vit", test_size=True)
    pw = tw.get_workload("imagenet_vit", test_size=True)
    jmodel = jax_vit.ViT(dataclasses.replace(jw.model.cfg, dtype=jnp.float32))
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(5), jnp.zeros((2, 32, 32, 3))))
    return Case(jax_losses.classification_loss(jmodel), dict(variables),
                dataclasses.replace(pw.cfg, dtype=torch.float32), pw, 8,
                pw.loss_fn)


def _seq2seq():
    """One K/V head: the layout keeps key and value whole, and both model
    ranks' query heads read it."""
    jw = jax_workloads.get_workload("t5_seq2seq", test_size=True,
                                    kv_heads=1)
    pw = tw.get_workload("t5_seq2seq", test_size=True, kv_heads=1)
    jmodel = jax_s2s.Seq2SeqLM(dataclasses.replace(jw.model.cfg,
                                                   dtype=jnp.float32))
    z = jnp.zeros((2, pw.seq_len), jnp.int32)
    variables = jax.device_get(jax.jit(jmodel.init)(jax.random.PRNGKey(4),
                                                    z, z))
    return Case(jax_s2s.seq2seq_loss(jmodel), dict(variables),
                dataclasses.replace(pw.cfg, dtype=torch.float32), pw, 8,
                tm.seq2seq_loss)


def _widedeep():
    pw = tw.get_workload("widedeep", test_size=True, global_batch_size=16)
    jcfg = dataclasses.replace(jax_wd.widedeep_test_config(),
                               dtype=jnp.float32)
    jmodel = jax_wd.WideDeep(jcfg)
    variables = jax.device_get(jax.jit(jmodel.init)(
        jax.random.PRNGKey(3), jnp.zeros((2, 2), jnp.int32),
        jnp.zeros((2, jcfg.num_dense_features))))
    return Case(jax_wd.widedeep_loss(jmodel), dict(variables),
                dataclasses.replace(pw.cfg, dtype=torch.float32), pw, 16,
                tm.widedeep_loss)


CASES = {"gpt_tiny": _gpt, "bert": _bert, "vit": _vit,
         "seq2seq_gqa": _seq2seq, "widedeep": _widedeep}


@functools.lru_cache(maxsize=None)
def _case(name):
    return CASES[name]()


def _flat(tree, prefix=()):
    for key, val in tree.items():
        if isinstance(val, dict):
            yield from _flat(val, prefix + (key,))
        else:
            yield "/".join(prefix + (key,)), val


def _state_dict(case):
    baseline = type(case.tcfg) in tm.convert.MODELS
    return tm.params_from_flax(
        case.variables if baseline else case.variables["params"], case.tcfg)


#: the preset whose layout each case's tree takes
PRESETS = {"gpt_tiny": "gpt_lm", "bert": "bert_mlm", "vit": "imagenet_vit",
           "seq2seq_gqa": "t5_seq2seq", "widedeep": "widedeep"}


@pytest.mark.parametrize("fsdp", [False, True])
@pytest.mark.parametrize("name,workload", list(PRESETS.items()))
def test_spec_tables_match_jax(name, workload, fsdp):
    """``specs_for_tree`` of the preset's layout on the JAX parameter
    tree, over a mesh of data 1, fsdp 2, model 2: the same spec for every
    leaf as the reference's (with ``fsdp``, ``auto_fsdp_spec`` fills the
    leaves no rule shards)."""
    case = _case(name)
    kw = {"kv_heads": 1} if workload == "t5_seq2seq" else {}
    jw = jax_workloads.get_workload(workload, test_size=True, **kw)
    pw = tw.get_workload(workload, test_size=True, **kw)
    params = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                          case.variables["params"])
    devices = np.array(jax.devices()[:4]).reshape(1, 2, 2)
    jmesh = jax.sharding.Mesh(devices, ("data", "fsdp", "model"))
    ref = jax_sharding.specs_for_tree(params, jmesh, jw.layout, fsdp=fsdp)
    mesh = types.SimpleNamespace(shape={"data": 1, "fsdp": 2, "model": 2})
    got = sharding.specs_for_tree(params, mesh, pw.layout, fsdp=fsdp)
    ref_flat = dict(jax.tree_util.tree_flatten_with_path(
        ref, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0])
    ref_flat = {jax_sharding.path_str(k): tuple(v)
                for k, v in ref_flat.items()}
    got_flat = {k: tuple(v) for k, v in _flat(got)}
    assert got_flat == ref_flat
    assert any(v for v in got_flat.values())  # the layout shards something


def _port_grads(case, batch, rank, mesh, whole):
    model = case.pw.model_cls(case.tcfg, device="cpu")
    model.load_state_dict(whole)
    sharding.bind_tensor_parallel(model, case.tcfg, case.pw.layout, mesh)
    loss, _ = case.loss_builder(model)(device_put_batch(batch, "cpu"), None)
    loss.backward()
    return float(loss.detach()), {n: p.grad for n, p in
                                  model.named_parameters()}


@pytest.mark.parametrize("name", list(CASES))
def test_model2_step_matches_jax(name):
    """Two model ranks, one replica: each rank's loss is JAX's on the
    batch, and the ranks' gradient shards put together are JAX's."""
    case = _case(name)
    batch = next(case.pw.input_fn(InputContext(1, 0, case.batch), 0))
    jl, jg = jax.jit(jax.value_and_grad(lambda p: case.jloss(
        p, {k: v for k, v in case.variables.items() if k != "params"},
        jax.tree.map(jnp.asarray, batch), jax.random.PRNGKey(0))[0]))(
            case.variables["params"])
    whole = _state_dict(case)
    outs = run_mesh(lambda r, mesh: _port_grads(case, batch, r, mesh, whole),
                    MeshSpec(data=1, model=2), 2)
    rules = sharding.tp_rules(case.pw.model_cls(case.tcfg, device="meta"),
                              case.tcfg, case.pw.layout)
    assert rules  # the model runs split
    for loss, _ in outs:
        np.testing.assert_allclose(loss, float(jl), rtol=RTOL)
    grads = sharding.unshard_states([g for _, g in outs], rules)
    got = tm.params_to_flax(grads, case.tcfg)
    got = dict(_flat(got.get("params", got)))
    for path, ref in _flat(jax.device_get(jg)):
        if any(s in path for s in case.skip):
            continue
        ref = np.asarray(ref)
        np.testing.assert_allclose(got[path], ref, rtol=0,
                                   atol=GRAD_TOL * np.abs(ref).max(),
                                   err_msg=path)


def test_data2_model2_gpt_gradients_match_jax_global_batch():
    """Four ranks as data 2 x model 2: each replica's two model ranks read
    their replica's pipeline, the data-parallel step sums the tensor
    shards' gradients over the replicas, and the result is JAX's on the
    global batch (the replicas' batches, rank-major)."""
    case = _case("gpt_tiny")
    batches = [next(case.pw.input_fn(InputContext(2, r, case.batch), 0))
               for r in range(2)]
    glob = {k: jnp.asarray(np.concatenate([b[k] for b in batches]))
            for k in batches[0]}
    jgrads = jax.device_get(jax.jit(
        lambda p: jax_engine.accumulate_gradients(
            case.jloss, p, {}, glob, jax.random.PRNGKey(0), 1)[0])(
                case.variables["params"]))
    whole = _state_dict(case)

    def body(rank, mesh):
        model = tm.GPTLM(case.tcfg, device="cpu")
        model.load_state_dict(whole)
        sharding.bind_tensor_parallel(model, case.tcfg, case.pw.layout, mesh)
        batch = device_put_batch(batches[mesh.coords["data"]], "cpu", mesh)
        grads, metrics = accumulate_gradients_dp(
            tm.lm_loss(model, group=mesh), model, batch, mesh, seed=0,
            step=0)
        return mesh.coords, grads

    outs = run_mesh(body, MeshSpec(data=2, model=2), 4)
    rules = sharding.tp_rules(tm.GPTLM(case.tcfg, device="meta"), case.tcfg,
                              case.pw.layout)
    by_coords = {(c["data"], c["model"]): g for c, g in outs}
    for d in range(2):
        grads = sharding.unshard_states([by_coords[(d, 0)],
                                         by_coords[(d, 1)]], rules)
        got = dict(_flat(tm.params_to_flax(grads, case.tcfg)))
        for path, ref in _flat(jgrads):
            ref = np.asarray(ref)
            np.testing.assert_allclose(got[path], ref, rtol=0,
                                       atol=GRAD_TOL * np.abs(ref).max(),
                                       err_msg=path)


def test_shard_tensor_round_trip_uneven_vocab():
    """A 50257-row table over two ranks: 25129 and 25128 rows (GSPMD's
    padded split), put back together whole; a fused q/k/v block cut
    head-major."""
    t = torch.arange(50257 * 2).reshape(50257, 2)
    parts = [sharding.shard_tensor(t, 0, r, 2) for r in range(2)]
    assert [p.shape[0] for p in parts] == [25129, 25128]
    assert torch.equal(sharding.unshard_tensors(parts, 0), t)
    qkv = torch.arange(12)[:, None]
    parts = [sharding.shard_tensor(qkv, 0, r, 2, (8, 2, 2)) for r in range(2)]
    assert parts[0][:, 0].tolist() == [0, 1, 2, 3, 8, 10]
    assert torch.equal(sharding.unshard_tensors(parts, 0, (8, 2, 2)), qkv)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_vocab_parallel_plain_tiles_match_untiled(dtype, monkeypatch):
    """The chunked heads' vocab-shard path (``kernels=False``) runs the
    plain twins over tiles of tokens (7 here, an uneven tail over 40
    tokens): its loss and gradients equal the untiled twins' on a shard
    of 14 of 37 rows, with targets inside and outside the shard."""
    gen = torch.Generator().manual_seed(0)
    hidden = torch.randn(4, 10, 16, generator=gen)
    table = torch.randn(14, 16, generator=gen)
    targets = torch.randint(0, 37, (4, 10), generator=gen)
    mask = (torch.rand(4, 10, generator=gen) > 0.2).float()
    shard = VocabShard(offset=10, vocab=37, group=None)

    def run(kernels):
        h = hidden.clone().requires_grad_()
        w = table.clone().requires_grad_()
        loss = fused_xent.vocab_parallel_xent(
            h, w, targets, mask, shard=shard, compute_dtype=dtype,
            kernels=kernels)
        loss.backward()
        return loss.detach(), h.grad, w.grad

    whole = run(True)  # CPU tensors: the untiled plain twins
    monkeypatch.setattr(fused_xent, "DEFAULT_CHUNK_TOKENS", 7)
    tiled = run(False)
    for got, ref in zip(tiled, whole):
        torch.testing.assert_close(got, ref, rtol=0,
                                   atol=1e-6 * float(ref.abs().max()))


#: the refusals of ``test_unported_scaleout_flags_refuse`` that PR 22
#: lifted, by their old messages
LIFTED = ("--dynamics-every with --zero", "--zero and --overlap over",
          "--dynamics-every over")


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "data=1,model=2", "--optimizer", "adafactor", "--lr", "0.1"],
     "adafactor over a model or expert axis"),
    (["--zero", "--dynamics-every", "2"], "--dynamics-every with --zero"),
    (["--zero", "--steps-per-call", "2"], "--steps-per-call > 1 with"),
    (["--overlap", "--steps-per-call", "2"], "--steps-per-call > 1 with"),
    (["--mesh", "data=1,expert=2", "--optimizer", "adafactor", "--lr",
      "0.1"], "adafactor over a model or expert axis"),
    (["--mesh", "data=1,seq=2", "--zero"], "--zero and --overlap over"),
    (["--mesh", "data=1,expert=2", "--overlap"], "--zero and --overlap over"),
    (["--mesh", "data=1,seq=2", "--steps-per-call", "2"],
     "--steps-per-call > 1 over"),
    (["--mesh", "data=1,expert=2", "--dynamics-every", "2"],
     "--dynamics-every over"),
])
def test_unported_scaleout_flags_refuse(argv, match):
    """The combinations no run has tried exit "not ported"; the ``seq``
    and ``expert`` axes themselves run (``--mesh data=1,seq=2`` and
    ``data=1,expert=2`` pass the checks).  ``--dynamics-every`` with
    ``--zero``, and ``--zero``, ``--overlap`` and ``--dynamics-every``
    over ``seq`` and ``expert`` (refused until PR 22, their messages
    in LIFTED) pass the checks now."""
    args = train_torch.parse_args(["--test-size", "--device", "cpu", *argv])
    if match in LIFTED:
        train_torch.check_flags(args)  # runs
    else:
        with pytest.raises(SystemExit, match=match):
            train_torch.check_flags(args)
    for mesh in ("data=1,seq=2", "data=1,expert=2"):
        train_torch.check_flags(train_torch.parse_args(
            ["--test-size", "--device", "cpu", "--mesh", mesh]))


@pytest.mark.parametrize("mesh", ["data=1,model=2", "data=1,expert=2",
                                  "data=1,pipe=2"])
@pytest.mark.parametrize("flag", [("--checkpoint-dir", "ck"),
                                  ("--clipnorm", "1.0")], ids=lambda f: f[0])
def test_checkpoints_and_clipping_pass_over_split_axes(mesh, flag):
    """``--checkpoint-dir`` and ``--clipnorm`` over ``model``, ``expert``
    and ``pipe`` (once refused) pass the checks, with the layer-wise
    optimizers (``parallel.placement``)."""
    for opt in ([], ["--optimizer", "lamb", "--lr", "1e-3"]):
        train_torch.check_flags(train_torch.parse_args(
            ["--workload", "gpt_lm", "--test-size", "--device", "cpu",
             "--mesh", mesh, *flag, *opt]))


@pytest.mark.parametrize("name", ["gpt_moe", "bert_moe"])
def test_moe_presets_refuse_a_model_axis(name):
    """The MoE presets bind over ``model`` (no longer refused: their
    layouts shard the expert stacks over ``expert`` and the dense layers
    over ``model``): over ``model=2`` the dense layers split and every
    rank holds all experts; over ``expert=2,model=2`` the experts halve,
    replicated over ``model``, and the all-to-all region is bound; over
    ``data=2`` the preset is itself."""
    wl = tw.get_workload(name, test_size=True)
    cfg = dataclasses.replace(wl.cfg, dtype=torch.float32)
    n = cfg.n_experts

    def bind(rank, mesh):
        bound = wl.for_mesh(mesh)
        model = bound.model_cls(cfg, device="cpu", group=mesh)
        model.load_state_dict(bound.init_params(
            cfg, torch.Generator().manual_seed(0)))
        create_sharded_state(model, bound.make_optimizer, mesh, cfg=cfg,
                             rules=bound.layout)
        stacks = {p.shape[0] for k, p in model.named_parameters()
                  if k.endswith("experts_in")}
        tp = any(getattr(m, "tp", None) is not None
                 for m in model.modules())
        return bound is wl, model.moe_fn is not None, stacks, tp

    assert run_mesh(bind, MeshSpec(data=2), 2) == [(True, False, {n},
                                                    False)] * 2
    assert run_mesh(bind, MeshSpec(data=1, model=2), 2) == \
        [(True, False, {n}, True)] * 2
    assert run_mesh(bind, MeshSpec(data=1, expert=2, model=2), 4) == \
        [(False, True, {n // 2}, True)] * 4
