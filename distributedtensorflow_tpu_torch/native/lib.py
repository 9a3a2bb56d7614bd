"""Build (if needed) and load the port's native library.

The shared object is compiled from the repo's C++ sources
(``native/src/crc32c.cc``, ``recordio.cc`` and ``ringcomm.cc``: the
record IO, CRC32-C and the host ring collectives) with the system g++
into ``build/torch_native/libdtf_native.so`` at the repo root, never
downloaded and never written beside the sources.  Concurrent builds
(test workers, ranks) take turns on an exclusive lock file, and the
library is linked to a temporary name and renamed, so a reader never
loads a half-written file.  ``DTF_TORCH_NATIVE_LIB`` names a prebuilt
library instead.
"""

from __future__ import annotations

import ctypes
import fcntl
import logging
import os
import subprocess
from pathlib import Path

logger = logging.getLogger(__name__)

_REPO = Path(__file__).resolve().parent.parent.parent
_NATIVE_DIR = _REPO / "native"
_SOURCES = ("src/crc32c.cc", "src/recordio.cc", "src/ringcomm.cc")
_HEADERS = ("src/crc32c.h",)

_lib: ctypes.CDLL | None = None


def _lib_path() -> Path:
    override = os.environ.get("DTF_TORCH_NATIVE_LIB")
    if override:
        return Path(override)
    return _REPO / "build" / "torch_native" / "libdtf_native.so"


def _needs_build(so: Path) -> bool:
    if not so.exists():
        return True
    so_mtime = so.stat().st_mtime
    return any((_NATIVE_DIR / rel).exists()
               and (_NATIVE_DIR / rel).stat().st_mtime > so_mtime
               for rel in _SOURCES + _HEADERS)


def build_native_library(force: bool = False) -> Path:
    """Compile the library from ``native/src`` if missing or stale."""
    so = _lib_path()
    if not force and not _needs_build(so):
        return so
    if not (_NATIVE_DIR / "src").is_dir():
        raise FileNotFoundError(
            f"native sources not found under {_NATIVE_DIR}; set "
            "DTF_TORCH_NATIVE_LIB to a prebuilt library")
    so.parent.mkdir(parents=True, exist_ok=True)
    with open(so.with_suffix(".lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            if not force and not _needs_build(so):
                return so  # another process built it while we waited
            tmp = so.with_suffix(f".tmp.{os.getpid()}.so")
            cmd = [os.environ.get("CXX", "g++"), "-O3", "-std=c++17",
                   "-fPIC", "-Wall", "-Wextra", "-pthread",
                   *[str(_NATIVE_DIR / s) for s in _SOURCES],
                   "-shared", "-pthread", "-o", str(tmp)]
            logger.info("building the native library: %s", " ".join(cmd))
            subprocess.run(cmd, check=True, capture_output=True, text=True)
            os.replace(tmp, so)
        except subprocess.CalledProcessError as e:
            raise RuntimeError(f"native build failed:\n{e.stderr}") from e
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)
    return so


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    c = ctypes
    u8p = c.POINTER(c.c_uint8)
    lib.dtf_writer_open.restype = c.c_void_p
    lib.dtf_writer_open.argtypes = [c.c_char_p]
    lib.dtf_writer_write.restype = c.c_int
    lib.dtf_writer_write.argtypes = [c.c_void_p, c.c_char_p, c.c_uint64]
    lib.dtf_writer_flush.restype = c.c_int
    lib.dtf_writer_flush.argtypes = [c.c_void_p]
    lib.dtf_writer_close.restype = None
    lib.dtf_writer_close.argtypes = [c.c_void_p]
    lib.dtf_reader_open.restype = c.c_void_p
    lib.dtf_reader_open.argtypes = [
        c.POINTER(c.c_char_p), c.c_int, c.c_int, c.c_int, c.c_uint64, c.c_int,
    ]
    lib.dtf_reader_next.restype = c.c_int64
    lib.dtf_reader_next.argtypes = [c.c_void_p, c.POINTER(u8p)]
    lib.dtf_reader_next_packed.restype = c.c_int64
    lib.dtf_reader_next_packed.argtypes = [
        c.c_void_p, c.POINTER(u8p), c.POINTER(c.POINTER(c.c_uint64)),
        c.c_int64, c.c_int64,
    ]
    lib.dtf_reader_batch_records.restype = c.c_int64
    lib.dtf_reader_batch_records.argtypes = []
    lib.dtf_reader_batch_bytes.restype = c.c_int64
    lib.dtf_reader_batch_bytes.argtypes = []
    lib.dtf_reader_close.restype = None
    lib.dtf_reader_close.argtypes = [c.c_void_p]
    lib.dtf_free.restype = None
    lib.dtf_free.argtypes = [c.c_void_p]
    lib.dtf_crc32c.restype = c.c_uint32
    lib.dtf_crc32c.argtypes = [c.c_char_p, c.c_uint64]
    lib.dtf_crc32c_masked.restype = c.c_uint32
    lib.dtf_crc32c_masked.argtypes = [c.c_char_p, c.c_uint64]
    # the host ring collectives (``ringcomm.cc``)
    lib.dtf_comm_create.restype = c.c_void_p
    lib.dtf_comm_create.argtypes = [
        c.c_int, c.c_int, c.POINTER(c.c_char_p), c.c_int,
    ]
    lib.dtf_comm_rank.restype = c.c_int
    lib.dtf_comm_rank.argtypes = [c.c_void_p]
    lib.dtf_comm_size.restype = c.c_int
    lib.dtf_comm_size.argtypes = [c.c_void_p]
    lib.dtf_comm_destroy.restype = None
    lib.dtf_comm_destroy.argtypes = [c.c_void_p]
    lib.dtf_comm_allreduce.restype = c.c_int
    lib.dtf_comm_allreduce.argtypes = [
        c.c_void_p, c.c_void_p, c.c_uint64, c.c_int, c.c_int,
    ]
    lib.dtf_comm_allgather.restype = c.c_int
    lib.dtf_comm_allgather.argtypes = [
        c.c_void_p, c.c_void_p, c.c_uint64, c.c_void_p,
    ]
    lib.dtf_comm_broadcast.restype = c.c_int
    lib.dtf_comm_broadcast.argtypes = [
        c.c_void_p, c.c_void_p, c.c_uint64, c.c_int,
    ]
    lib.dtf_comm_barrier.restype = c.c_int
    lib.dtf_comm_barrier.argtypes = [c.c_void_p]
    return lib


def load_native_library() -> ctypes.CDLL:
    """Load (building first if necessary) the library, once."""
    global _lib
    if _lib is None:
        _lib = _declare(ctypes.CDLL(str(build_native_library())))
    return _lib


def native_available() -> bool:
    """True when the library can be loaded on this machine."""
    try:
        load_native_library()
        return True
    except Exception as e:  # no g++, unwritable checkout, ...
        logger.warning("native library unavailable: %s", e)
        return False
