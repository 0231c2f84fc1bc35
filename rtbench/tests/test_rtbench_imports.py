"""Nothing the benchmark runs imports JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's),
and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from rtb import catalog

BANNED = {"jax", "jaxlib", "flax", "cuda_raytracer_tpu"}
PORT = "cuda_raytracer_tpu_torch"


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.JoinedStr)):
            head = node.args[0].values[0]
            assert isinstance(head, ast.Constant), path
            yield head.value.split(".")[0]


def _sources():
    for d, _, files in os.walk(catalog.BENCH):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_jax_anywhere():
    for path in _sources():
        if os.sep + "tests" + os.sep in path:
            continue
        found = set(_imports(path)) & BANNED
        assert not found, (path, found)


@pytest.mark.parametrize("module", [
    "rtb/reference.py", "rtb/check.py", "rtb/control.py", "rtb/stats.py",
    "rtb/catalog.py"] + sorted(
        "lights/" + f for f in os.listdir(os.path.join(catalog.BENCH,
                                                         "lights"))
        if f.endswith(".py")))
def test_reference_side_imports_no_port(module):
    path = os.path.join(catalog.BENCH, module)
    assert PORT not in set(_imports(path))


def test_banned_names_compare_whole(monkeypatch):
    from rtb import runner

    monkeypatch.setitem(sys.modules, "cuda_raytracer_tpu_torch_x", sys)
    assert "cuda_raytracer_tpu" not in runner.banned_modules()
    monkeypatch.setitem(sys.modules, "cuda_raytracer_tpu.render", sys)
    assert runner.banned_modules() == ["cuda_raytracer_tpu"]


def test_no_card_no_result():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible")
    run = os.path.join(catalog.BENCH, "run.py")
    p = subprocess.run([sys.executable, run, "--workload",
                        "cbspheres_classic.offline64", "--seed", "1",
                        "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120)
    assert p.returncode != 0 and p.stdout.strip() == ""
