"""The port's record files, wire and record datasets against the JAX
package's, and ``train_torch.py --data-dir/--config`` on the CPU.

The port builds its own copy of the repo's C++ record library
(``native/src``) and must write the same bytes, compute the same
CRC32-C, and read the JAX package's shards as the JAX package reads its
(raw wire and legacy npz records).  ``record_dataset`` yields the JAX
package's batches under every AutoShard policy over one and two hosts,
with and without the shuffle buffer: in order with one reader thread, as
a multiset with two.  All comparisons are exact.
"""

import json

import numpy as np
import pytest
import torch

import train_torch
from distributedtensorflow_tpu import native as jax_native
from distributedtensorflow_tpu.data import InputContext as JaxInputContext
from distributedtensorflow_tpu.data import recordio_dataset as jax_rd
from distributedtensorflow_tpu.data import wire as jax_wire
from distributedtensorflow_tpu_torch import native as tn
from distributedtensorflow_tpu_torch.checkpoint import CheckpointManager
from distributedtensorflow_tpu_torch.data import InputContext
from distributedtensorflow_tpu_torch.data import recordio_dataset as trd
from distributedtensorflow_tpu_torch.data import wire as twire
from distributedtensorflow_tpu_torch.testing import two_intra_op_threads  # noqa: F401


def _examples(n=40, seed=0):
    rng = np.random.default_rng(seed)
    return [{"image": rng.standard_normal((4, 4, 3)).astype(np.float32),
             "label": np.int32(i)} for i in range(n)]


def _assert_batches_equal(got, ref):
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        assert a.keys() == b.keys()
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_writer_bytes_and_crc_match_jax(tmp_path):
    """The same records give byte-identical files; CRC32-C (the RFC 3720
    vector among them) and its masked form agree."""
    records = [b"", b"a", b"123456789", bytes(range(256)) * 9]
    for mod, name in ((tn, "port.rec"), (jax_native, "jax.rec")):
        with mod.RecordWriter(str(tmp_path / name)) as w:
            for r in records:
                w.write(r)
    assert (tmp_path / "port.rec").read_bytes() \
        == (tmp_path / "jax.rec").read_bytes()
    assert tn.crc32c(b"123456789") == 0xE3069283
    for r in records:
        assert tn.crc32c(r) == jax_native.crc32c(r)
        assert tn.masked_crc32c(r) == jax_native.masked_crc32c(r)
    assert list(tn.RecordReader([str(tmp_path / "jax.rec")])) == records


def test_wire_matches_jax():
    """``encode_tensors`` gives JAX's bytes (with the checksum, which the
    port takes from its own library); each decodes the other's."""
    ex = _examples(1)[0]
    ours = twire.encode_tensors(ex, crc=True)
    assert ours == jax_wire.encode_tensors(ex, crc=True)
    assert "crc" in twire.peek_header(ours)
    back = jax_wire.decode_tensors(ours)
    for k in ex:
        np.testing.assert_array_equal(back[k], ex[k])
    bad = bytearray(ours)
    bad[-1] ^= 1
    with pytest.raises(twire.WireError, match="CRC32C"):
        twire.decode_tensors(bytes(bad))


@pytest.mark.parametrize("wire", ["raw", "npz"])
def test_packages_read_each_others_shards(tmp_path, wire):
    """Shards written by either package (raw tensor wire or npz records)
    read back in both to the written examples."""
    exs = _examples(12)
    paths = {}
    for tag, mod in (("port", trd), ("jax", jax_rd)):
        paths[tag] = [str(tmp_path / f"{tag}-{i}.rec") for i in range(2)]
        writers = [(tn if tag == "port" else jax_native).RecordWriter(p)
                   for p in paths[tag]]
        for i, ex in enumerate(exs):
            writers[i % 2].write(mod.encode_example(ex, wire))
        for w in writers:
            w.close()
    for tag in ("port", "jax"):
        for mod in (trd, jax_rd):
            got = list(mod.record_dataset(paths[tag], num_threads=1,
                                          policy="OFF"))
            want = [exs[i] for i in range(0, 12, 2)] \
                + [exs[i] for i in range(1, 12, 2)]
            _assert_batches_equal(got, want)


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """Five shards of 40 examples, written by the port."""
    d = tmp_path_factory.mktemp("shards")
    return trd.write_record_shards(iter(_examples(40)),
                                   str(d / "train-{:03d}.rec"), num_shards=5)


@pytest.mark.parametrize("shuffle", [0, 16])
@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("policy", ["AUTO", "FILE", "DATA", "OFF"])
def test_record_dataset_batches_match_jax(shards, policy, hosts, shuffle):
    """Every host's batches equal JAX's: in order with one reader thread
    (FILE with 2 hosts takes files 0, 2, 4 and 1, 3; AUTO is DATA there,
    5 files over 2 hosts), as a multiset of examples with two threads."""
    files = shards if policy != "FILE" or hosts == 1 else shards[:4]
    for host in range(hosts):
        kw = dict(batch_size=4, policy=policy, shuffle_buffer=shuffle,
                  seed=3, drop_remainder=False)
        got = list(trd.record_dataset(files, InputContext(hosts, host, 8),
                                      num_threads=1, **kw))
        want = list(jax_rd.record_dataset(
            files, JaxInputContext(hosts, host, 8), num_threads=1, **kw))
        _assert_batches_equal(got, want)
        threaded = list(trd.record_dataset(
            files, InputContext(hosts, host, 8), num_threads=2, **kw))
        assert _labels(threaded) == _labels(want)


def _labels(batches):
    return sorted(int(x) for b in batches for x in b["label"])


def test_repeated_epochs_reshuffle_as_jax(shards):
    """``repeated_record_dataset`` cycles the files (its default reader
    threads interleave them, so epochs compare as multisets): every epoch
    holds each example once, as JAX's; an undersized shard raises."""
    kw = dict(batch_size=8, shuffle_buffer=16, seed=1)
    got = trd.repeated_record_dataset(shards, InputContext(1, 0, 8), **kw)
    want = jax_rd.repeated_record_dataset(shards, JaxInputContext(1, 0, 8),
                                          **kw)
    try:
        for _ in range(2):  # an epoch is 5 batches of 8
            mine = [next(got) for _ in range(5)]
            assert _labels(mine) == _labels([next(want) for _ in range(5)])
            assert _labels(mine) == list(range(40))
    finally:  # join the readers' threads
        got.close()
        want.close()
    with pytest.raises(ValueError, match="0 batches"):
        next(trd.repeated_record_dataset(shards[:1], batch_size=64))


def test_corruption_raises(tmp_path):
    p = str(tmp_path / "bad.rec")
    with tn.RecordWriter(p) as w:
        w.write(b"hello world, this will be corrupted")
    raw = bytearray(open(p, "rb").read())
    raw[14] ^= 0xFF  # one payload byte
    open(p, "wb").write(bytes(raw))
    with pytest.raises(tn.RecordCorruptionError):
        list(tn.RecordReader([p]))
    open(p, "wb").write(bytes(raw[:5]))  # a cut header
    with pytest.raises(tn.RecordCorruptionError):
        list(trd.record_dataset([p], num_threads=1))


# --------------------------------------------------------- train_torch.py

BATCH = 8


@pytest.fixture(scope="module")
def mnist_records(tmp_path_factory):
    """mnist_lenet-shaped records (28x28x1 images, labels): 44 examples,
    so an eval pass ends on a ragged batch of 4, in one shard, which one
    reader thread reads (more would interleave in their own order)."""
    d = tmp_path_factory.mktemp("mnist")
    rng = np.random.default_rng(0)
    exs = [{"image": rng.standard_normal((28, 28, 1)).astype(np.float32),
            "label": np.int32(rng.integers(10))} for _ in range(44)]
    trd.write_record_shards(iter(exs), str(d / "train-{:02d}.rec"),
                            num_shards=1)
    return d


def _argv(data_dir, *extra):
    return ["--workload", "mnist_lenet", "--test-size", "--device", "cpu",
            "--batch-size", str(BATCH), "--data-dir", str(data_dir),
            "--shuffle-buffer", "16", "--log-every", "1", *extra]


def test_data_dir_trains_resumes_and_evaluates(mnist_records, tmp_path):
    """``--data-dir``: the first batch the step sees is the records'
    first; a run resumed from the checkpoint of step 2 fast-forwards to
    the records' third batch; eval is one unshuffled pass over all 44
    examples, the ragged last batch weighted by its 4 rows."""
    records = trd.repeated_record_dataset(
        train_torch.record_files(mnist_records), InputContext(1, 0, BATCH),
        batch_size=BATCH, shuffle_buffer=16, seed=0)
    want = [next(records) for _ in range(3)]
    args = train_torch.parse_args(_argv(mnist_records, "--prefetch-depth",
                                        "0"))
    _, _, _, batches = train_torch.build(args)
    first = next(batches)
    batches.close()  # joins the reader's threads
    records.close()
    for k in want[0]:
        np.testing.assert_array_equal(first[k].numpy(), want[0][k])
    ck = tmp_path / "ck"
    train_torch.main(_argv(mnist_records, "--steps", "2",
                           "--checkpoint-dir", str(ck)))
    args = train_torch.parse_args(_argv(mnist_records, "--steps", "4",
                                        "--prefetch-depth", "0"))
    _, state, _, batches = train_torch.build(args, CheckpointManager(str(ck)))
    assert state.step == 2
    third = next(batches)
    batches.close()
    for k in want[2]:
        np.testing.assert_array_equal(third[k].numpy(), want[2][k])
    # eval over the records: one unshuffled pass, weighted by rows
    logdir = tmp_path / "run"
    train_torch.main(_argv(mnist_records, "--steps", "1", "--eval-every",
                           "1", "--logdir", str(logdir)))
    rows = [json.loads(x) for x in (logdir / "metrics.jsonl").read_text()
            .splitlines()]
    got = next(r for r in rows if "eval_loss" in r)
    passes = list(train_torch.record_eval_source(
        args, InputContext(1, 0, BATCH)))
    assert [len(b["label"]) for b in passes] == [8] * 5 + [4]
    assert np.isfinite(got["eval_loss"])


def test_config_file_defaults_cli_wins(mnist_records, tmp_path):
    """``--config``: a JSON file of flag defaults (types applied, the
    port's own flags accepted), a flag typed on the command line wins, an
    unknown key and an abbreviated flag are errors, and a preset name
    selects the workload."""
    cfg = tmp_path / "run.json"
    cfg.write_text(json.dumps({
        "workload": "mnist_lenet", "steps": "3", "batch-size": BATCH,
        "test_size": True, "device": "cpu", "dtype": "float32",
        "data_dir": str(mnist_records), "shuffle_buffer": 0,
        "log_every": 1}))
    args = train_torch.parse_args(["--config", str(cfg), "--steps", "2"])
    assert (args.steps, args.batch_size, args.test_size, args.device,
            args.dtype, args.shuffle_buffer) == (2, BATCH, True, "cpu",
                                                 "float32", 0)
    records = train_torch.main(["--config", str(cfg), "--steps=2"])
    assert [r["step"] for r in records] == [1, 2]
    assert all(np.isfinite(r["loss"]) for r in records)
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"no_such_flag": 1}))
    with pytest.raises(SystemExit, match="not a known flag"):
        train_torch.parse_args(["--config", str(bad)])
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--work", "gpt_lm"])
    assert train_torch.parse_args(["--config", "bert_moe"]).workload \
        == "bert_moe"
    with pytest.raises(SystemExit):
        train_torch.parse_args(["--config", "no_such_preset"])


def test_record_batches_feed_the_step(mnist_records):
    """Record batches put on the device as the synthetic ones are:
    integer labels as ``torch.long``, images fp32."""
    args = train_torch.parse_args(_argv(mnist_records, "--prefetch-depth",
                                        "0"))
    _, _, _, batches = train_torch.build(args)
    b = next(batches)
    batches.close()
    assert b["label"].dtype == torch.long
    assert b["image"].dtype == torch.float32
    assert b["image"].shape == (BATCH, 28, 28, 1)


def test_reader_closed_once_when_collected_with_its_generator(tmp_path):
    """A generator reading a ``RecordReader``, both garbage of one cycle
    (a data worker's cached pipeline once the worker stopped): the
    collector runs the reader's finalizer before the generator's
    ``finally`` calls ``close``, and the handle is closed once (a second
    close freed it twice and crashed the process)."""
    import gc

    from distributedtensorflow_tpu_torch.native.recordio import RecordReader

    files = trd.write_record_shards(
        iter([{"x": np.zeros(4, np.float32)} for _ in range(50)]),
        str(tmp_path / "t-{:02d}.rec"), num_shards=1)

    def read():
        with RecordReader(files) as reader:
            yield from reader

    class Cycle:
        pass

    for _ in range(10):
        holder = Cycle()
        holder.self, holder.records = holder, read()
        assert next(holder.records)
        del holder
        gc.collect()
    reader = RecordReader(files)
    reader._finalizer()  # as the collector would
    reader.close()
    assert reader._h is None
