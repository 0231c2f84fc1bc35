"""The port's kernels as a whole: their build and their names.  With
the system files (``systems/<name>.py``, which drive the port's
renderers), the only code of the benchmark that imports the port."""

from __future__ import annotations

import importlib
import os
from typing import Dict


def build_kernels() -> None:
    """Build every kernel source of the port in one step (one nvcc each,
    in parallel) into its fixed build directory; a later run loads what
    is there.  A source's -D flags come from its module's
    ``build_defines``, where the module of that name has one."""
    from cuda_raytracer_tpu_torch.ops import _build

    csrc = os.path.dirname(_build.source_path("x"))
    specs = []
    for fname in sorted(os.listdir(csrc)):
        if not fname.endswith(".cu"):
            continue
        name = fname[:-3]
        defines = ()
        try:
            mod = importlib.import_module(
                f"cuda_raytracer_tpu_torch.ops.{name}")
        except ModuleNotFoundError:
            mod = None
        if mod is not None and hasattr(mod, "build_defines"):
            defines = tuple(mod.build_defines())
        specs.append((name, defines))
    _build.build_all(specs)


def kernel_names() -> set:
    """The names of the kernels defined in the port's CUDA sources."""
    import re

    from cuda_raytracer_tpu_torch.ops import _build

    csrc = os.path.dirname(_build.source_path("x"))
    names = set()
    bounds = re.compile(r"__launch_bounds__\s*\([^)]*\)")
    pat = re.compile(r"__global__[^(;{]*?\b(\w+)\s*\(")
    for fname in os.listdir(csrc):
        if fname.endswith((".cu", ".cuh")):
            with open(os.path.join(csrc, fname)) as f:
                names.update(pat.findall(bounds.sub("", f.read())))
    return names
