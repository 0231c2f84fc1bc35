"""Build and load the native BVH builder (bvh_builder.cpp).

g++ compiles the source into a shared library with a plain C ABI,
loaded with ctypes, at its first use: ``-O3 -std=c++17 -shared -fPIC``,
no fast math (the tree must equal the numpy builder's bit for bit).
The library goes into ``_build/`` beside the package, named by a digest
of the source and the compile command, so a changed source (or
compiler) rebuilds, and a stale library is never loaded.  A lock keeps
one build per process; a build writes a temporary file and renames it
into place, so processes that build at once do not clash.  A failed
build raises ``NativeBuildError`` with the compiler's output; the
caller decides whether numpy may take over (accel/bvh.py).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict

_DIR = os.path.dirname(os.path.abspath(__file__))
_SOURCE = os.path.join(_DIR, "bvh_builder.cpp")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
#: the C++ compiler
COMPILER = "g++"
FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
_failed: Dict[str, str] = {}


class NativeBuildError(RuntimeError):
    """The native library could not be compiled or loaded."""


def library_path() -> str:
    h = hashlib.sha256(" ".join((COMPILER,) + FLAGS).encode())
    with open(_SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_BUILD, f"bvh_builder_{h.hexdigest()[:16]}.so")


def _compile(so: str) -> None:
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    cmd = [COMPILER, *FLAGS, "-o", tmp, _SOURCE]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=300)
    except (OSError, subprocess.SubprocessError) as e:
        raise NativeBuildError(f"{' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        raise NativeBuildError(f"{' '.join(cmd)} failed:\n{proc.stderr}")
    os.replace(tmp, so)


def load_library() -> ctypes.CDLL:
    """Compile (once per source and compiler) and load the library.
    Raises NativeBuildError when the build or the load fails; a failure
    is remembered, so a process tries each build once."""
    so = library_path()
    with _lock:
        if so in _libs:
            return _libs[so]
        if so in _failed:
            raise NativeBuildError(_failed[so])
        try:
            if not os.path.exists(so):
                _compile(so)
            lib = ctypes.CDLL(so)
        except (NativeBuildError, OSError) as e:
            _failed[so] = str(e)
            raise NativeBuildError(str(e)) from e
        lib.bvh_build.restype = ctypes.c_int
        lib.bvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_double),  # prim_min
            ctypes.POINTER(ctypes.c_double),  # prim_max
            ctypes.c_int,  # n
            ctypes.c_int,  # max_leaf
            ctypes.c_int,  # bins
            ctypes.POINTER(ctypes.c_int64),  # sorted_order out
            ctypes.POINTER(ctypes.c_double),  # node_bounds out
            ctypes.POINTER(ctypes.c_int64),  # node_info out
            ctypes.c_int,  # cap
        ]
        _libs[so] = lib
        return lib
