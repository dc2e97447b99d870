"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for ``sm_90a`` into its own shared library, loaded with
``ctypes``. The build happens at first use (the first CUDA tensor that
reaches a kernel) into ``_build/`` inside the package, a directory git
ignores; the library name carries a hash of the source and the flags,
so an edited source is rebuilt and a stale library is never loaded.
Importing this module needs no ``nvcc``. A failed build raises with
``nvcc``'s output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
KERNELS = ("corr_lookup", "corr_lookup_bwd", "nconv", "nconv_bwd")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas=-v",
)

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_logs: dict[str, str] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError(
        "nvcc not found on PATH or under CUDA_HOME; the CUDA kernels of "
        "raft_ncup_tpu_torch/csrc cannot be built"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def library_path(name: str) -> str:
    h = hashlib.sha256()
    with open(source_path(name), "rb") as fh:
        h.update(fh.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names=KERNELS) -> dict[str, float]:
    """Compile every library of ``names`` that is not built yet, all
    ``nvcc`` processes started together; returns seconds per name
    (0.0 for one already built). Raises with ``nvcc``'s output on a
    failed build."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = None
    procs = []
    t0 = time.perf_counter()
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        nvcc = nvcc or nvcc_path()
        tmp = f"{out}.tmp{os.getpid()}.{threading.get_ident()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, source_path(name)]
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )
        procs.append((name, out, tmp, cmd, proc))
    seconds = {name: 0.0 for name in names}
    failures = []
    for name, out, tmp, cmd, proc in procs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        _logs[name] = log
        if proc.returncode != 0:
            failures.append(
                f"nvcc failed ({proc.returncode}) for {name}:\n"
                f"{' '.join(cmd)}\n{log}"
            )
            continue
        os.replace(tmp, out)  # atomic: a concurrent build sees all or none
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(name: str) -> str:
    """``nvcc``'s output of this process's build of ``name`` (register
    and shared-memory use per kernel, from ``-Xptxas=-v``); empty when
    the library was already built."""
    return _logs.get(name, "")


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, building it first if
    needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _libs[name] = lib
        return lib


def check(rc: int, lib: ctypes.CDLL, what: str) -> None:
    """Raise if a launcher returned a CUDA error code."""
    if rc != 0:
        lib.kernel_error_string.restype = ctypes.c_char_p
        lib.kernel_error_string.argtypes = [ctypes.c_int]
        msg = lib.kernel_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc}: {msg}")
