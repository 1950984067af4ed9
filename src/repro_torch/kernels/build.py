"""Build the hand-written CUDA kernels at first use and load them.

Each source in ``csrc/`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``.  All missing libraries are compiled in parallel, one ``nvcc``
each.  A library's file name carries a hash of its source, every header
in ``csrc/`` and the flags, so an edited source or header is rebuilt and
a stale library is never loaded.  The libraries go to ``_build/`` beside
this file (listed in ``.gitignore``).

Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).parent / "csrc"
BUILD_DIR = Path(__file__).parent / "_build"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: kernel name -> argtypes of its ``<name>_launch`` C function (every
#: pointer and the stream as c_void_p, so ctypes never cuts them to 32 bits)
SIGNATURES = {
    # device, addrs, n, starts, ends, k, counts, kind, blocks, cluster,
    # threads, smem, stream
    "object_histogram": [_I, _P, _L, _P, _P, _I, _P, _I, _I, _I, _I, _I,
                         _P],
    # device, addrs, tbins, n, base, shift, n_blocks, n_tbins, hist, kind,
    # blocks, cluster, threads, smem, stream
    "hotness_histogram": [_I, _P, _P, _L, _I, _I, _I, _I, _P, _I, _I, _I,
                          _I, _I, _P],
    # device, addrs, tbins, n, starts, ends, k, base, shift, n_blocks,
    # n_tbins, counts, hist, clusters, cluster, threads, smem, stream
    "trace_aggregate": [_I, _P, _P, _L, _P, _P, _I, _I, _I, _I, _I, _P, _P,
                        _I, _I, _I, _I, _P],
    # device, x, w, out, trace, m, k, n, is_bf16, split, bytes_read,
    # bytes_written, stream
    "instrumented_matmul": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                            _P],
}

_libs: dict = {}        # kernel name -> loaded ctypes.CDLL (process-wide)


def nvcc() -> str:
    """Path of the CUDA compiler; raises when there is none."""
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built from source at first use")


def _library_path(name: str) -> Path:
    """Where kernel ``name``'s library goes: its file name hashes the
    source, every header in ``csrc/`` (a superset of those it includes)
    and the flags."""
    h = hashlib.sha256()
    for f in (CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build_all() -> list:
    """Compile every kernel whose library is missing, all in parallel.
    Returns the names that were compiled; raises on any failure."""
    todo = {n: _library_path(n) for n in SIGNATURES
            if not _library_path(n).exists()}
    if not todo:
        return []
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cc = nvcc()
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [cc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return list(todo)


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building all kernels first
    when any library is missing."""
    lib = _libs.get(name)
    if lib is None:
        build_all()
        lib = ctypes.CDLL(str(_library_path(name)))
        fn = getattr(lib, f"{name}_launch")
        fn.argtypes = SIGNATURES[name]
        fn.restype = ctypes.c_int
        lib.pasta_error_string.argtypes = [ctypes.c_int]
        lib.pasta_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return lib
