"""Build and load the port's CUDA kernels.

Each kernel source under ``ops/csrc/`` has a plain C interface and is
compiled by nvcc into a shared library that ctypes loads: no PyTorch
headers, so a build takes seconds.  Libraries go into ``_build/``
beside the package, named by a digest of every file under ``csrc/`` and
the compiler flags, so a changed source or flag rebuilds.  A build
happens at a kernel's first launch (``load_library``), or for several
sources at once, one nvcc process each (``build_all``).  A failed build
raises; there is no fallback.

Flags shared by every kernel: ``sm_90a``, ``-fmad=false`` and no fast
math, so a kernel rounds as its plain PyTorch version does (IEEE
division and sqrt, no FMA contraction); ``-Xptxas -v``, whose report
(registers, spills, shared memory per kernel) is kept beside the
library and read back by ``ptxas_report``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from typing import Dict, Iterable, Sequence, Tuple

_CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
_BUILD = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build"
)
_libs: Dict[Tuple[str, Tuple[str, ...]], ctypes.CDLL] = {}


def source_path(name: str) -> str:
    return os.path.join(_CSRC, f"{name}.cu")


def nvcc_command(src: str, out: str, defines: Sequence[str] = ()):
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    return [
        nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
        "-fPIC",
        *(f"-D{d}" for d in defines), "-o", out, src,
    ]


def _library_path(name: str, defines: Sequence[str]) -> str:
    h = hashlib.sha256(" ".join(nvcc_command("", "", defines)).encode())
    for fname in sorted(os.listdir(_CSRC)):  # sources and shared headers
        with open(os.path.join(_CSRC, fname), "rb") as f:
            h.update(fname.encode() + f.read())
    return os.path.join(_BUILD, f"{name}_{h.hexdigest()[:16]}.so")


def _start_build(name: str, defines: Sequence[str], so: str):
    os.makedirs(_BUILD, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    proc = subprocess.Popen(
        nvcc_command(source_path(name), tmp, defines),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    return proc, tmp


def _finish_build(name: str, proc, tmp: str, so: str) -> None:
    out, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed building {source_path(name)}:\n{out}")
    with open(f"{so}.log", "w") as f:
        f.write(out)
    os.replace(tmp, so)


def build_all(specs: Iterable[Tuple[str, Sequence[str]]]) -> None:
    """Build every (name, defines) not built yet, all nvcc processes
    started together."""
    started = []
    for name, defines in specs:
        so = _library_path(name, defines)
        if not os.path.exists(so):
            started.append((name, *_start_build(name, defines, so), so))
    for name, proc, tmp, so in started:
        _finish_build(name, proc, tmp, so)


def load_library(name: str, defines: Sequence[str] = ()) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` (once per sources and flags) and load
    it.  Raises if nvcc fails."""
    key = (name, tuple(defines))
    if key not in _libs:
        so = _library_path(name, defines)
        if not os.path.exists(so):
            _finish_build(name, *_start_build(name, defines, so), so)
        _libs[key] = ctypes.CDLL(so)
    return _libs[key]


def ptxas_report(name: str, defines: Sequence[str] = ()) -> list:
    """What ptxas said of each kernel of a built library: one line per
    entry function (mangled name), its registers, spill stores/loads and
    shared memory; empty where the library was built without a report."""
    log = f"{_library_path(name, defines)}.log"
    if not os.path.exists(log):
        return []
    lines, entry = [], None
    with open(log) as f:
        for raw in f:
            line = raw.split(":", 1)[-1].strip()
            if line.startswith("Compiling entry function"):
                entry = line.split("'")[1] if "'" in line else line
            elif entry and (line.startswith("Used") or "spill" in line):
                lines.append(f"{entry}: {line}")
    return lines
