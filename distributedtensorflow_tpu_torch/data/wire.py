"""Raw tensor wire format for the input plane.

Twin of ``distributedtensorflow_tpu/data/wire.py`` (framework-free; a
copy, with the checksum from the port's ``native``).

Replaces per-batch ``np.savez``/``np.load`` on the data-service and
record-file hot paths.  The npz archive costs a zip container per batch
(central directory, per-member headers, a full payload memcpy through the
``ZipFile`` machinery on BOTH ends); at pod-scale input rates that is pure
protocol tax.  This format is one JSON header describing the tensors plus
their raw bytes back to back:

``"DTW1" | uint32 LE header_len | header JSON | payload``

- header: ``{"v": 1, "t": [{"name", "dtype", "shape"}, ...], "crc": int?}``
  — tensor order is the dict's insertion order; each tensor's byte length
  is ``prod(shape) * itemsize``, so no offsets are stored;
- payload: each tensor's C-contiguous bytes, concatenated in header order;
- ``crc``: optional CRC32C of the payload (hardware-accelerated via the
  native layer when available — the same ``crc32c`` the record framing
  uses).  Encoding with ``crc=True`` degrades to no checksum when the
  native library cannot load; decoding verifies only when both sides have
  the checksum.

Decoding is zero-copy: each array is a read-only ``np.frombuffer`` view
into the received buffer (consumers that mutate batches must copy — the
training path stacks/places them, which already does).

Legacy npz payloads start with the zip magic ``PK\\x03\\x04``, so
:func:`is_raw` lets one decoder sniff both formats (rolling-upgrade and
old-file compatibility).
"""

from __future__ import annotations

import json
import math
import struct
from typing import Any, Mapping

import numpy as np

MAGIC = b"DTW1"
_HEADER_LEN = struct.Struct("<I")

#: Wire formats the service negotiates per request.
WIRE_FORMATS = ("raw", "npz")


class WireError(ValueError):
    """Malformed, truncated, or checksum-failing raw wire payload."""


def _crc32c(data) -> int | None:
    """CRC32C via the native layer; None when it cannot load (the wire
    then carries / verifies no checksum rather than failing the batch)."""
    try:
        from ..native import crc32c
        return int(crc32c(bytes(data)))
    except Exception:  # missing toolchain, load failure — degrade, not die
        return None


def encode_tensors(tensors: Mapping[str, Any], *, crc: bool = False,
                   trace: Mapping[str, str] | None = None) -> bytes:
    """Serialize a dict of arrays to the raw wire format.

    Arrays are made C-contiguous (a copy only when the input is not);
    object/void dtypes are rejected — the wire carries numeric/bool bytes
    only, never pickle.

    ``trace`` (a ``{"trace_id", "span_id"}`` dict — the distributed
    request-tracing context of ``obs.tracing``) is echoed verbatim in the
    header so a traced batch carries its trace id end to end; decoders
    that don't care ignore it, :func:`peek_trace` reads it back.
    """
    meta = []
    parts: list[bytes | memoryview] = []
    for name, value in tensors.items():
        a = np.asarray(value)
        if not a.flags["C_CONTIGUOUS"]:
            # NOT ascontiguousarray unconditionally: that helper promotes
            # 0-d arrays to shape (1,), silently changing the decoded rank.
            a = np.ascontiguousarray(a)
        if a.dtype.hasobject or a.dtype.kind == "V":
            raise WireError(
                f"tensor {name!r} has non-wire dtype {a.dtype!r} "
                "(numeric/bool arrays only)"
            )
        meta.append({
            "name": str(name),
            "dtype": a.dtype.str,
            "shape": list(a.shape),
        })
        # memoryview.cast rejects 0-d and zero-size views; tobytes() on
        # those copies nothing meaningful anyway.
        if a.ndim == 0 or a.size == 0:
            parts.append(a.tobytes())
        else:
            parts.append(memoryview(a).cast("B"))
    header: dict = {"v": 1, "t": meta}
    if trace:
        header["trace"] = {str(k): str(v) for k, v in dict(trace).items()}
    if crc:
        # The checksum needs the contiguous payload; this path pays one
        # extra full-payload copy.
        payload = b"".join(parts)
        c = _crc32c(payload)
        if c is not None:
            header["crc"] = c
        parts = [payload]
    hdr = json.dumps(header, separators=(",", ":")).encode()
    # One join = one copy of the tensor bytes (the memcpy the npz zip
    # container paid twice is the tax this format exists to remove).
    return b"".join([MAGIC, _HEADER_LEN.pack(len(hdr)), hdr, *parts])


def is_raw(data) -> bool:
    """True when ``data`` starts with the raw-wire magic."""
    return bytes(data[:4]) == MAGIC


def peek_header(data) -> dict:
    """Parse and return just the JSON header of a raw payload (no tensor
    decode, no CRC verification) — cheap wire introspection."""
    mv = memoryview(data)
    if bytes(mv[:4]) != MAGIC:
        raise WireError("not a raw tensor payload (bad magic)")
    if len(mv) < 8:
        raise WireError("truncated header length")
    (hlen,) = _HEADER_LEN.unpack(mv[4:8])
    if 8 + hlen > len(mv):
        raise WireError("truncated header")
    try:
        header = json.loads(bytes(mv[8:8 + hlen]))
    except json.JSONDecodeError as e:
        raise WireError(f"bad header JSON: {e}") from e
    if not isinstance(header, dict):
        raise WireError("header is not an object")
    return header


def peek_trace(data) -> dict | None:
    """The echoed trace context of a raw payload (``encode_tensors``'s
    ``trace=``), or None — including for npz payloads, which carry none."""
    if not is_raw(data):
        return None
    trace = peek_header(data).get("trace")
    return trace if isinstance(trace, dict) else None


def decode_tensors(data) -> dict[str, np.ndarray]:
    """Parse a raw wire payload into ``{name: read-only array view}``."""
    mv = memoryview(data)
    if bytes(mv[:4]) != MAGIC:
        raise WireError("not a raw tensor payload (bad magic)")
    if len(mv) < 8:
        raise WireError("truncated header length")
    (hlen,) = _HEADER_LEN.unpack(mv[4:8])
    if 8 + hlen > len(mv):
        raise WireError("truncated header")
    try:
        header = json.loads(bytes(mv[8:8 + hlen]))
    except json.JSONDecodeError as e:
        raise WireError(f"bad header JSON: {e}") from e
    if not isinstance(header, dict) or header.get("v") != 1:
        raise WireError(f"unsupported wire version {header.get('v')!r}")
    payload = mv[8 + hlen:]
    want_crc = header.get("crc")
    if want_crc is not None:
        got = _crc32c(payload)
        if got is not None and got != want_crc:
            raise WireError(
                f"payload CRC32C mismatch (got {got}, header {want_crc})"
            )
    out: dict[str, np.ndarray] = {}
    offset = 0
    for t in header.get("t", ()):
        try:
            dt = np.dtype(t["dtype"])
            shape = tuple(int(d) for d in t["shape"])
            name = t["name"]
        except (KeyError, TypeError, ValueError) as e:
            raise WireError(f"bad tensor entry {t!r}: {e}") from e
        count = math.prod(shape)
        nbytes = count * dt.itemsize
        if offset + nbytes > len(payload):
            raise WireError(
                f"tensor {name!r} overruns payload "
                f"({offset + nbytes} > {len(payload)} bytes)"
            )
        out[name] = np.frombuffer(
            payload, dtype=dt, count=count, offset=offset
        ).reshape(shape)
        offset += nbytes
    if offset != len(payload):
        raise WireError(
            f"{len(payload) - offset} trailing payload bytes after the "
            "declared tensors"
        )
    return out


def tensor_bytes(tensors: Mapping[str, Any]) -> int:
    """Host bytes of a batch (the adaptive-prefetch budget unit)."""
    return sum(np.asarray(v).nbytes for v in tensors.values())
