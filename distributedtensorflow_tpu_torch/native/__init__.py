"""ctypes bindings for the repo's C++ runtime library, built for the port.

Twin of ``distributedtensorflow_tpu/native/``: the threaded record
reader and writer and CRC32-C (``crc32c.cc``, ``recordio.cc``) and the
host ring collectives (``ringcomm.cc``, :class:`HostCollectives`) of
``native/src/``, compiled with g++ on first use into the port's own
``build/torch_native/`` (:mod:`.lib`).
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
from .ringcomm import HostCollectives

__all__ = [
    "HostCollectives",
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
