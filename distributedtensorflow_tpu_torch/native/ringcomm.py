"""Host collectives: a numpy surface over the C++ TCP ring.

Twin of ``distributedtensorflow_tpu/native/ringcomm.py``, over the same
``native/src/ringcomm.cc`` built into the port's library (:mod:`.lib`):
CPU-resident arrays moving between processes (metric aggregation,
input-pipeline coordination, control values of the multi-process test
runner).  It is a host-memory ring by design, so it takes no device: a
tensor on the card goes through ``torch.distributed`` (NCCL), and one
that must cross here is copied to the host by its caller.  The wire is
the reference's, byte for byte, so a ring may mix ranks of either
package.
"""

from __future__ import annotations

import ctypes
from collections.abc import Sequence

import numpy as np

from .lib import load_native_library

_DTYPES = {
    np.dtype(np.float32): 0,
    np.dtype(np.float64): 1,
    np.dtype(np.int32): 2,
    np.dtype(np.int64): 3,
}
_OPS = {"sum": 0, "max": 1, "min": 2, "prod": 3}


class HostCollectives:
    """A ring communicator over TCP among ``world`` host processes (or
    threads: the library's calls release the GIL).

    Every rank passes the same ``peers`` list ("host:port" per rank);
    rank ``r`` listens on ``peers[r]`` and connects to
    ``peers[(r+1)%world]``.  Construction is a rendezvous: it returns once
    both neighbour links are up, and raises :class:`ConnectionError` when
    they are not up within ``timeout_ms``."""

    def __init__(self, rank: int, peers: Sequence[str], *,
                 timeout_ms: int = 300_000):
        self._h = None
        self._lib = load_native_library()
        world = len(peers)
        if not 0 <= rank < world:
            raise ValueError(f"rank {rank} out of range for {world} peers")
        arr = (ctypes.c_char_p * world)(*[p.encode() for p in peers])
        self._h = self._lib.dtf_comm_create(rank, world, arr, timeout_ms)
        if not self._h:
            raise ConnectionError(
                f"ring setup failed (rank {rank}, peers {list(peers)})")
        self.rank = rank
        self.world = world

    def _check(self, status: int, what: str) -> None:
        if status != 0:
            raise ConnectionError(f"{what} failed (rank {self.rank})")

    def all_reduce(self, x: np.ndarray, op: str = "sum") -> np.ndarray:
        """Ring all-reduce (``op`` sum, max, min or prod over fp32, fp64,
        int32 or int64); a new array with the reduced values."""
        dt = _DTYPES.get(np.dtype(x.dtype))
        if dt is None:
            raise TypeError(f"unsupported dtype {x.dtype}")
        out = np.ascontiguousarray(x).copy()
        self._check(self._lib.dtf_comm_allreduce(
            self._h, out.ctypes.data_as(ctypes.c_void_p), out.size, dt,
            _OPS[op]), "all_reduce")
        return out

    def all_gather(self, x: np.ndarray) -> np.ndarray:
        """Equal-shaped arrays of every rank under a leading ``world``
        axis, in rank order."""
        x = np.ascontiguousarray(x)
        out = np.empty((self.world,) + x.shape, dtype=x.dtype)
        self._check(self._lib.dtf_comm_allgather(
            self._h, x.ctypes.data_as(ctypes.c_void_p), x.nbytes,
            out.ctypes.data_as(ctypes.c_void_p)), "all_gather")
        return out

    def all_gather_bytes(self, blob: bytes,
                         max_len: int = 1 << 20) -> list[bytes]:
        """Byte strings of any length up to ``max_len``, one a rank: each
        rank sends a u64 LE length and its bytes padded to ``max_len``."""
        if len(blob) > max_len:
            raise ValueError(
                f"blob of {len(blob)} bytes exceeds max_len={max_len}")
        buf = np.zeros(max_len + 8, dtype=np.uint8)
        buf[:8] = np.frombuffer(len(blob).to_bytes(8, "little"),
                                dtype=np.uint8)
        buf[8:8 + len(blob)] = np.frombuffer(blob, dtype=np.uint8)
        gathered = self.all_gather(buf)
        out = []
        for r in range(self.world):
            n = int.from_bytes(gathered[r, :8].tobytes(), "little")
            out.append(gathered[r, 8:8 + n].tobytes())
        return out

    def broadcast(self, x: np.ndarray, root: int = 0) -> np.ndarray:
        """``root``'s ``x`` on every rank (the others' values are ignored;
        their shape and dtype must match)."""
        out = np.ascontiguousarray(x).copy()
        self._check(self._lib.dtf_comm_broadcast(
            self._h, out.ctypes.data_as(ctypes.c_void_p), out.nbytes, root),
            "broadcast")
        return out

    def barrier(self) -> None:
        self._check(self._lib.dtf_comm_barrier(self._h), "barrier")

    def close(self) -> None:
        if self._h is not None:
            self._lib.dtf_comm_destroy(self._h)
            self._h = None

    def __enter__(self) -> "HostCollectives":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
