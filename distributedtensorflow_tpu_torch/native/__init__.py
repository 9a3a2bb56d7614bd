"""ctypes bindings for the repo's C++ record IO, built for the port.

Twin of the record-IO half of ``distributedtensorflow_tpu/native/``: the
threaded record reader and writer and CRC32-C of ``native/src/``
(``crc32c.cc``, ``recordio.cc``), compiled with g++ on first use into
the port's own ``build/torch_native/`` (:mod:`.lib`).  The host
collectives (``ringcomm.cc``, ``HostCollectives``) are not ported.
"""

from .lib import build_native_library, load_native_library, native_available
from .recordio import (
    RecordCorruptionError,
    RecordReader,
    RecordWriter,
    available_cpus,
    crc32c,
    masked_crc32c,
)

__all__ = [
    "RecordCorruptionError",
    "RecordReader",
    "RecordWriter",
    "available_cpus",
    "build_native_library",
    "crc32c",
    "load_native_library",
    "masked_crc32c",
    "native_available",
]
