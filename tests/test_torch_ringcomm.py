"""The port's host ring collectives (``native/ringcomm.py`` over
``native/src/ringcomm.cc`` in the port's library) against numpy and the
JAX package's ``HostCollectives``.

The ranks are threads of this process (the library's calls release the
GIL), so no process is spawned: every op (sum, max, min, prod) and dtype
(fp32, fp64, int32, int64) at 2 and 3 ranks on arrays of an odd length
(chunks of unequal size) and on one larger than a socket buffer,
``all_gather``, ``all_gather_bytes`` of uneven blobs, ``broadcast`` from
a non-zero root, the barrier, the errors (``ValueError``, ``TypeError``,
``ConnectionError`` on a rendezvous that times out), and a ring whose
ranks mix the two packages.  Integer results are exact; float sums over
2-3 ranks are compared at 1e-6 relative (the ring's summation order is
not numpy's), max and min exactly.
"""

import threading

import numpy as np
import pytest

from distributedtensorflow_tpu.native import HostCollectives as JaxHostCollectives
from distributedtensorflow_tpu_torch import native
from distributedtensorflow_tpu_torch.native import HostCollectives
from distributedtensorflow_tpu_torch.testing import pick_unused_port

DTYPES = (np.float32, np.float64, np.int32, np.int64)
OPS = {"sum": np.sum, "max": np.max, "min": np.min, "prod": np.prod}
RTOL = 1e-6


def _ring(world, body, classes=None, timeout_ms=30_000):
    """``[body(comm) for each rank]``, each rank a thread with its own
    ``HostCollectives`` of ``classes[rank]`` (default the port's) over a
    fresh loopback ring."""
    classes = classes or [HostCollectives] * world
    peers = [f"127.0.0.1:{pick_unused_port()}" for _ in range(world)]
    results, errors = [None] * world, []

    def run(rank):
        try:
            with classes[rank](rank, peers, timeout_ms=timeout_ms) as comm:
                results[rank] = body(comm)
        except BaseException as e:  # re-raised below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(r,), daemon=True)
               for r in range(world)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout_ms / 1000 + 30)
    assert not any(t.is_alive() for t in threads), "a rank hung"
    if errors:
        raise errors[0]
    return results


def _inputs(rank, dtype, n=7):
    """Rank ``rank``'s array: small values, so a product of 3 ranks stays
    exact in every dtype."""
    rng = np.random.default_rng(10 + rank)
    if np.dtype(dtype).kind == "f":
        return rng.uniform(-2, 2, n).astype(dtype)
    return rng.integers(-3, 4, n).astype(dtype)


def test_library_carries_the_ring():
    lib = native.load_native_library()
    assert lib.dtf_comm_create.restype is not None
    assert native.build_native_library().name == "libdtf_native.so"
    assert "HostCollectives" in native.__all__


@pytest.mark.parametrize("dtype", DTYPES, ids=lambda d: np.dtype(d).name)
@pytest.mark.parametrize("world", [2, 3])
def test_all_reduce_every_op(world, dtype):
    xs = [_inputs(r, dtype) for r in range(world)]
    big = [np.full(300_001, r + 1, dtype=dtype) for r in range(world)]

    def body(comm):
        out = {op: comm.all_reduce(xs[comm.rank], op=op) for op in OPS}
        out["big"] = comm.all_reduce(big[comm.rank])
        return out

    stacked = np.stack(xs)
    for out in _ring(world, body):
        for op, fn in OPS.items():
            want = fn(stacked, axis=0)
            assert out[op].dtype == np.dtype(dtype)
            if np.dtype(dtype).kind == "f" and op in ("sum", "prod"):
                np.testing.assert_allclose(out[op], want, rtol=RTOL)
            else:
                np.testing.assert_array_equal(out[op], want)
        np.testing.assert_array_equal(
            out["big"], np.full(300_001, sum(range(1, world + 1)), dtype))


@pytest.mark.parametrize("world", [2, 3])
def test_gather_broadcast_and_barrier(world):
    def body(comm):
        r = comm.rank
        blob = bytes([65 + r]) * (5 * r + 1)  # uneven lengths
        return (comm.all_gather(np.arange(6, dtype=np.int64).reshape(2, 3)
                                + 10 * r),
                comm.all_gather_bytes(blob, max_len=64),
                comm.broadcast(np.full(4, float(r), np.float32),
                               root=world - 1),
                comm.barrier())

    for gathered, blobs, cast, _ in _ring(world, body):
        assert gathered.shape == (world, 2, 3)
        for r in range(world):
            np.testing.assert_array_equal(
                gathered[r], np.arange(6).reshape(2, 3) + 10 * r)
        assert blobs == [bytes([65 + r]) * (5 * r + 1) for r in range(world)]
        np.testing.assert_array_equal(cast, np.full(4, world - 1.0))


def test_world_of_one_and_the_errors():
    with HostCollectives(0, [f"127.0.0.1:{pick_unused_port()}"]) as comm:
        x = np.arange(5, dtype=np.float32)
        np.testing.assert_array_equal(comm.all_reduce(x), x)
        assert comm.all_gather(x).shape == (1, 5)
        comm.barrier()
        with pytest.raises(TypeError, match="unsupported dtype"):
            comm.all_reduce(x.astype(np.float16))
        with pytest.raises(ValueError, match="exceeds max_len"):
            comm.all_gather_bytes(b"x" * 9, max_len=8)
    with pytest.raises(ValueError, match="out of range"):
        HostCollectives(2, ["127.0.0.1:1", "127.0.0.1:2"])


def test_rendezvous_timeout_raises_connection_error():
    """Two peers, only rank 0 starts: the setup fails within its
    timeout."""
    peers = [f"127.0.0.1:{pick_unused_port()}" for _ in range(2)]
    with pytest.raises(ConnectionError, match="ring setup failed"):
        HostCollectives(0, peers, timeout_ms=1500)


@pytest.mark.parametrize("order", ["jax_first", "port_first"])
def test_mixed_ring_of_both_packages(order):
    """One wire serves both: a ring of a JAX rank and a port rank gives
    the same results on both, and those numpy gives."""
    classes = [JaxHostCollectives, HostCollectives]
    if order == "port_first":
        classes.reverse()
    xs = [_inputs(r, np.float64, 1001) for r in range(2)]

    def body(comm):
        r = comm.rank
        return (comm.all_reduce(xs[r]), comm.all_reduce(xs[r], op="max"),
                comm.all_gather(xs[r]),
                comm.all_gather_bytes(b"rank%d" % r * (r + 1)),
                comm.broadcast(xs[r], root=1))

    got = _ring(2, body, classes)
    for out in got:
        np.testing.assert_allclose(out[0], xs[0] + xs[1], rtol=RTOL)
        np.testing.assert_array_equal(out[1], np.maximum(xs[0], xs[1]))
        np.testing.assert_array_equal(out[2], np.stack(xs))
        assert out[3] == [b"rank0", b"rank1rank1"]
        np.testing.assert_array_equal(out[4], xs[1])
    for a, b in zip(got[0], got[1]):
        if isinstance(a, list):
            assert a == b
        else:
            assert a.tobytes() == b.tobytes()
