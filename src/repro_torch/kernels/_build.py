"""Build the port's CUDA sources into one shared library and bind it.

Every ``.cu`` file in ``repro_torch/csrc/`` is compiled for Hopper
(``sm_90a``) by its own ``nvcc`` process, all started together, and the
objects are linked into one ``.so`` under ``build/repro_torch/<hash>/`` at
the root of the checkout, keyed by a hash of the sources and flags. The
first call of :func:`library` builds; later calls, and later processes
with the same sources, load the cached library. The entry points are plain
C functions bound with ``ctypes``: every pointer and the stream is a
``c_void_p`` and every size an integer, and each returns
``cudaGetLastError()``, which :func:`check` turns into an exception.

Nothing here runs at import time, so the CPU tests import every kernel
module without ``nvcc``.

A missing ``nvcc``, a failed compile or link, and any CUDA error a launch
reports raise :class:`KernelError`, which callers that retry transient
failures (the serve scheduler) re-raise: a kernel that cannot build or
launch fails the run, it never degrades an answer.

``launches`` counts kernel launches by name. Each kernel module adds one
where it launches its kernel and nowhere else, so a run can show that its
main path went through the kernels: set the counts to 0 with
:func:`reset_launches`, drive the path, read them.

``load_seconds`` holds the host seconds :func:`library`'s first call took
(digest, build if one is needed, ``dlopen``, binding), for a benchmark's
set-up breakdown.

``recorder`` is where a measurement listens to the launches
(``repro_torch.obs.probe``): while one is active, each wrapper that
counts a launch also passes it the kernel's name, the bytes its kernel
loads from and stores to device memory (re-reads counted) and the
operations it performs, from a cost function of the launch's own
arguments beside the launch. ``None``, the default, costs nothing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

launches: dict[str, int] = {
    "symhollow": 0,
    "center_matvec": 0,
    "inverse_orders": 0,
    "permute_reduce": 0,
    "permute_reduce_finish": 0,
    "pairwise_panel": 0,
    "pairwise_sparse_panel": 0,
    "center_pass1": 0,
    "center_finish": 0,
    "center_pass2": 0,
    "mantel_corr": 0,
    "mantel_corr_finish": 0,
    "rmsnorm": 0,
    "rmsnorm_bwd": 0,
}

#: host seconds of :func:`library`'s first call: digest, build if needed,
#: ``dlopen`` and binding; 0.0 until the library is loaded
load_seconds = 0.0

#: the active measurement's ``(name, bytes, operations)`` callback, or None
recorder: Optional[Callable[[str, float, float], None]] = None

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_IP = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    "repro_symhollow": [_P, _I, _P, _P],
    "repro_center_matvec": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "repro_center_matvec_clusters": [_I, _I, _IP],
    "repro_inverse_orders": [_P, _P, _P, _P, _I, _I, _I, _P],
    "repro_permute_reduce_grid": [_I, _I, _I, _IP],
    "repro_permute_reduce_partials": [_P, _P, _L, _P, _P, _P, _I, _I, _I,
                                      _I, _P],
    "repro_permute_reduce_finish": [_P, _P, _I, _I, _P],
    "repro_pairwise_panel": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_pairwise_sparse_panel": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                    _P],
    "repro_center_pass1": [_P, _P, _I, _I, _I, _P],
    "repro_center_finish": [_P, _P, _P, _I, _P],
    "repro_center_pass2": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    "repro_mantel_corr_grid": [_I, _I, _IP],
    "repro_mantel_corr_partials": [_P, _P, _P, _P, _P, _I, _I, _I, _I,
                                   _I, _P],
    "repro_mantel_corr_finish": [_P, _P, _I, _I, _P],
    "repro_rmsnorm": [_P, _P, _P, _P, _L, _I, _I, _I, _F, _P],
    "repro_rmsnorm_bwd": [_P, _P, _P, _P, _P, _P, _P, _L, _I, _L, _I, _I,
                          _P],
}


class KernelError(RuntimeError):
    """A kernel could not be built or launched: ``nvcc`` missing, a failed
    compile or link, or a CUDA error a launch reported. A CUDA error is
    sticky, so no retry can succeed."""


_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def reset_launches() -> None:
    for name in launches:
        launches[name] = 0


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    fallback = Path("/usr/local/cuda/bin/nvcc")
    if fallback.exists():
        return str(fallback)
    raise KernelError("nvcc not found: the CUDA toolkit is needed to "
                      "build the repro_torch kernels")


def build() -> Path:
    """Compile the sources if this hash is not built yet; return the .so."""
    out_dir = BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_ROOT) as tmp:
        tmp = Path(tmp)
        procs = []
        for src in _sources():
            obj = tmp / (src.stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
            procs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log, failed = [], []
        for src, _, proc in procs:
            output, _ = proc.communicate()
            log.append(f"== {src.name}\n{output}")
            if proc.returncode:
                failed.append(src.name)
        if failed:
            raise KernelError(f"nvcc failed on {', '.join(failed)}:\n"
                              + "\n".join(log))
        link = subprocess.run(
            [nvcc, *ARCH, "-shared", "-o", str(tmp / LIB_NAME),
             *[str(obj) for _, obj, _ in procs]],
            capture_output=True, text=True)
        if link.returncode:
            raise KernelError(f"nvcc link failed:\n{link.stdout}"
                              f"{link.stderr}")
        (tmp / "ptxas.log").write_text("\n".join(log))
        out_dir.mkdir(parents=True, exist_ok=True)
        os.replace(tmp / "ptxas.log", out_dir / "ptxas.log")
        os.replace(tmp / LIB_NAME, lib_path)    # atomic: readers never see half a file
    return lib_path


def build_log() -> str:
    """What ``nvcc -Xptxas -v`` said about each kernel of the current build."""
    path = BUILD_ROOT / _digest() / "ptxas.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The bound library, built on first use (timed in ``load_seconds``)."""
    global _lib, load_seconds
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _lib = lib
            load_seconds += time.perf_counter() - t0
        return _lib


def check(err: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err:
        name = library().repro_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err} ({name})")


@functools.lru_cache(maxsize=None)
def resident_grid(entry: str, *sizes: int) -> int:
    """The grid a row-striding kernel runs at these sizes, as its C entry
    ``entry`` reports it for the current card: as many blocks as the card
    holds at once, capped at the rows. Asked once per sizes."""
    grid = ctypes.c_int(0)
    check(getattr(library(), entry)(*sizes, ctypes.byref(grid)), entry)
    return grid.value


def stream_handle(device: torch.device) -> int:
    """The raw ``cudaStream_t`` of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream
