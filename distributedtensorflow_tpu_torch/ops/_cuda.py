"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` compiles with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens at first use, from the sources in the checkout only, into
``build/torch_kernels/`` at the repository root, under a file name keyed
by a hash of the source and the flags, so an edited kernel is rebuilt
and an unchanged one is not.  Every missing library is compiled by its
own ``nvcc`` process, all started together.  A missing ``nvcc`` or a
failed build raises: there is no plain-path fallback.

``launches`` counts kernel launches by name.  Each wrapper adds one
where it launches its kernel, and nowhere else, so a run can show that
its path went through the kernels.  A CUDA graph replays launches
without calling the wrappers: ``train.engine.make_multi_train_step``
takes out what its capture counted and adds it back on every replay
(:func:`captured_launches`).  Every launcher takes the current PyTorch
stream (:func:`stream_handle`), which under a capture is the capturing
stream.
"""

from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
KERNELS = ("layernorm_fwd", "decode_attention", "layernorm_bwd", "flash_fwd",
           "flash_bwd", "flash_bwd_fused", "fused_xent_fwd", "fused_xent_bwd",
           "dropout")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

#: Dynamic shared memory one block may use on the H100 (227 KB).
SMEM_LIMIT = 232448

#: kernel name -> launches since the caller last reset it.
launches: collections.Counter = collections.Counter()

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        from torch.utils.cpp_extension import CUDA_HOME

        if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
            path = os.path.join(CUDA_HOME, "bin", "nvcc")
    if path is None:
        raise RuntimeError(
            "nvcc not found (neither on PATH nor under CUDA_HOME); the "
            "port's CUDA kernels cannot be built"
        )
    return path


def lib_path(name: str) -> Path:
    """Where the library built from ``csrc/<name>.cu`` lives (keyed by
    the source, the shared headers ``csrc/*.cuh`` and the flags)."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=KERNELS) -> dict[str, str]:
    """Compile every library of ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the compiler's
    ``-Xptxas -v`` report (registers, shared memory, spills) by name;
    raises after all processes ended if any of them failed."""
    with _lock:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = None
        procs = {}
        for name in names:
            out = lib_path(name)
            if out.exists():
                continue
            nvcc = nvcc or _nvcc()
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, out)
        reports, failed = {}, []
        for name, (proc, tmp, out) in procs.items():
            reports[name] = proc.communicate()[0]
            if proc.returncode:
                failed.append(name)
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("nvcc failed for " + ", ".join(
                f"{n}:\n{reports[n]}" for n in failed))
        return reports


def load(name: str, signatures: dict) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed.
    ``signatures`` maps each launcher to its ``argtypes`` (pointers and
    the stream as ``c_void_p``); every launcher returns a CUDA error."""
    lib = _libs.get(name)
    if lib is None:
        build((name,))
        with _lock:
            lib = _libs.get(name)
            if lib is None:
                lib = ctypes.CDLL(str(lib_path(name)))
                lib.dtf_error_string.argtypes = [ctypes.c_int]
                lib.dtf_error_string.restype = ctypes.c_char_p
                for fn, argtypes in signatures.items():
                    getattr(lib, fn).argtypes = argtypes
                    getattr(lib, fn).restype = ctypes.c_int
                _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if err:
        msg = lib.dtf_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> ctypes.c_void_p:
    """The current PyTorch stream of ``device`` as a C pointer."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class captured_launches:
    """Context manager: the launches counted inside it (a CUDA-graph
    capture, which runs nothing) are taken out of ``launches`` and kept
    in ``self.counts``, which :meth:`replayed` adds back once a replay."""

    def __enter__(self):
        self._before = collections.Counter(launches)
        self.counts = collections.Counter()
        return self

    def __exit__(self, *exc):
        self.counts = collections.Counter(launches)
        self.counts.subtract(self._before)
        self.counts = +self.counts
        launches.subtract(self.counts)
        for name in [n for n, c in launches.items() if c == 0]:
            if name not in self._before:
                del launches[name]

    def replayed(self) -> None:
        launches.update(self.counts)
