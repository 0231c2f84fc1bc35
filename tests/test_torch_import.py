"""The port stands alone: it imports neither jax nor the JAX package, and
its entry points never drop to the CPU unasked."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import cuda_raytracer_tpu_torch
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.ops import packet_dfs
from cuda_raytracer_tpu_torch.render import flatscene
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

PKG_DIR = os.path.dirname(cuda_raytracer_tpu_torch.__file__)
REPO = os.path.dirname(PKG_DIR)
FORBIDDEN = ("jax", "jaxlib", "flax", "cuda_raytracer_tpu")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(
            [PKG_DIR], prefix="cuda_raytracer_tpu_torch.")
    )


def test_modules_import_without_jax():
    mods = _modules()
    for name in ("_build", "packet_dfs", "partition", "wavefront2"):
        assert f"cuda_raytracer_tpu_torch.ops.{name}" in mods
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "print(len(sys.modules), bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_sources_name_no_jax():
    files = [os.path.join(root, f) for root, _, fs in os.walk(PKG_DIR)
             for f in fs if f.endswith(".py")]
    files.append(os.path.join(REPO, "chip_smoke.py"))
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""] if node.level == 0 else []
            else:
                continue
            for name in names:
                assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_entry_points_need_a_device(monkeypatch):
    """Without CUDA and without device='cpu' the entry points raise."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        WavefrontRenderer()
    with pytest.raises(RuntimeError, match="CUDA"):
        flatscene.flatten_scene(cornell_box_scene())
    scene, _ = flatscene.flatten_scene(cornell_box_scene(), device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        flatscene.from_jax_arrays({}, {})
    # the traversal follows its tensors: no path for other devices
    o = torch.zeros((4, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        packet_dfs.trace_closest_packets(
            scene.to("meta"), o, o, torch.ones(4, dtype=torch.bool,
                                               device="meta"))
