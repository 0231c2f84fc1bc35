"""Everything a run reads, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its workload file (``workloads/<cell>.json``),
the scene builder (``scenes/<builder>.py``) and each light kind
(``lights/<kind>.py``) that the configuration names, the system adapter
that the workload file names (``systems/<system>.py``), and the reader
of each metric (``metrics/<metric>.json`` or ``.py``).  A new cell,
configuration, scene, light kind, system or metric is a new file;
nothing here names one."""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Dict, List

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def cell(name: str) -> Dict:
    """The cell ``name``: its BENCHMARK.json entry, its configuration
    (with ``scene``: the builder's input) and its workload file, and the
    metrics it reports at each trace setting."""
    bench = benchmark()
    entries = {w["name"]: w for w in bench["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    entry = entries[name]
    cfgs = {c["name"]: c for c in bench["configs"]}
    config = load_json(os.path.join(ROOT, cfgs[entry["config"]]["file"]))
    job = load_json(os.path.join(BENCH, "workloads", f"{name}.json"))
    for key in ("config", "traffic"):
        if job[key] != entry[key]:
            raise ValueError(f"workloads/{name}.json: {key} {job[key]!r}, "
                             f"BENCHMARK.json says {entry[key]!r}")

    def mine(metrics: List[Dict]) -> List[Dict]:
        return [m for m in metrics
                if name in m.get("workloads", [name])]

    return {"name": name, "entry": entry, "config": config, "job": job,
            "end_to_end": mine(bench["end_to_end"]),
            "per_layer": mine(bench["per_layer"])}


def scene_builder(name: str):
    """``scenes/<name>.py``'s ``build``."""
    return _module(os.path.join(BENCH, "scenes", f"{name}.py")).build


def light_kind(name: str):
    """``lights/<name>.py``: the light kind's reference arithmetic and
    its class in the port."""
    return _module(os.path.join(BENCH, "lights", f"{name}.py"))


def system(name: str):
    """``systems/<name>.py``: the adapter that drives the port."""
    return _module(os.path.join(BENCH, "systems", f"{name}.py"))


def metric_reader(name: str):
    """The reader of metric ``name``: ``metrics/<name>.py``'s ``read``,
    or the generic reader that ``metrics/<name>.json`` names.  A name
    split by kind of cell (``trace_ms.realtime``) with no file of its own
    reads the file of the quantity it begins with (``trace_ms``)."""
    for stem in (name, name.split(".")[0]):
        py = os.path.join(BENCH, "metrics", f"{stem}.py")
        if os.path.exists(py):
            return _module(py).read
        js = os.path.join(BENCH, "metrics", f"{stem}.json")
        if os.path.exists(js):
            spec = load_json(js)
            from . import readers

            return lambda ctx: readers.READERS[spec["reader"]](spec, ctx)
    raise FileNotFoundError(f"no reader for metric {name!r} in metrics/")


def _module(path: str):
    name = "rtbench_" + os.path.relpath(path, BENCH).replace(
        os.sep, "_").replace(".", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
