"""Build and load the host image decoders of ``csrc/*.cpp``.

Each ``csrc/<name>.cpp`` (``webp_decode``, ``jpeg_decode``) exposes a
plain C interface and is compiled by the system C++ compiler (``$CXX``,
else ``c++``) into its own shared library under the package's git-ignored
``_build/``, named by a hash of the source and the flags, with the same
atomic rename as the CUDA kernels' build (``ops/cuda_build.py``), so
concurrent builds are safe and an edited source is rebuilt.

The libraries are loaded with ``ctypes.CDLL``, which releases the GIL for
the length of each call: loader threads decode in parallel. This is a
host build, not a device compile, so it is not reported to the runtime
guards' watchdog; datasets holding WebP or JPEG frames load it when they
are built (:func:`load_all`), before the first step. Importing this
module needs no compiler; a failed build raises with the compiler's
output, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

from raft_ncup_tpu_torch.ops.cuda_build import (
    BUILD_DIR,
    CSRC_DIR,
    compile_libraries,
    hashed_library_path,
)

CODECS = ("webp_decode", "jpeg_decode")
CXX_FLAGS = ("-std=c++17", "-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def cxx_path() -> str:
    for cand in (os.environ.get("CXX"), "c++", "g++", "clang++"):
        found = cand and shutil.which(cand)
        if found:
            return found
    raise RuntimeError(
        "no C++ compiler ($CXX, c++, g++ or clang++) on PATH; the image decoders "
        "of raft_ncup_tpu_torch/csrc cannot be built"
    )


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cpp")


def library_path(name: str) -> str:
    return hashed_library_path(name, source_path(name), CXX_FLAGS, BUILD_DIR)


def build(names=CODECS) -> dict[str, float]:
    """Compile every decoder of ``names`` that is not built yet, all
    compilers started together; returns seconds per name (0.0 for one
    already built). Raises with the compiler's output on a failed build."""
    todo = [name for name in names if not os.path.exists(library_path(name))]
    prefix = [cxx_path(), *CXX_FLAGS] if todo else []
    return compile_libraries(
        [(name, library_path(name), prefix, source_path(name)) for name in names],
        {}, "the C++ compiler")


def load(name: str) -> ctypes.CDLL:
    """The loaded decoder library ``name``, building it first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build((name,))
            lib = ctypes.CDLL(library_path(name))
            _declare(name, lib)
            _libs[name] = lib
        return lib


def load_all() -> None:
    """Build (in parallel) and load every decoder."""
    if all(name in _libs for name in CODECS):
        return
    build(CODECS)
    for name in CODECS:
        load(name)


def _declare(name: str, lib: ctypes.CDLL) -> None:
    p, n, i = ctypes.c_void_p, ctypes.c_size_t, ctypes.POINTER(ctypes.c_int)
    s, c = ctypes.c_char_p, ctypes.c_int
    if name == "webp_decode":
        lib.webp_probe.argtypes = [s, n, i, i, i, s, n]
        lib.webp_decode_rgb.argtypes = [s, n, p, c, c, s, n]
    else:
        lib.jpeg_probe.argtypes = [s, n, i, i, i, s, n]
        lib.jpeg_decode.argtypes = [s, n, p, c, c, c, s, n]
