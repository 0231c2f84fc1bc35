"""Every file of the benchmark loads, and a cell, a configuration or a
metric added as a new file is found by its name with no edit."""

import json
import os
import shutil

import pytest

from rtb import catalog


def test_every_cell_loads():
    bench = catalog.benchmark()
    for w in bench["workloads"]:
        cell = catalog.cell(w["name"])
        assert cell["job"]["config"] == w["config"]
        assert cell["end_to_end"] and cell["per_layer"]
        scene = catalog.scene_builder(cell["config"]["builder"])
        assert callable(scene)
        for m in cell["per_layer"]:
            assert callable(catalog.metric_reader(m["name"]))


def test_configs_name_their_files():
    bench = catalog.benchmark()
    for c in bench["configs"]:
        data = catalog.load_json(os.path.join(catalog.ROOT, c["file"]))
        assert data["name"] == c["name"]
        assert data["reduced"] == c["reduced"]
        assert data["source"] == c["source"]


def test_metrics_move_reported_metrics():
    bench = catalog.benchmark()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    for m in bench["per_layer"]:
        target = e2e[m["moves"]]
        for w in m.get("workloads", []):
            assert w in target.get("workloads", [w])


def test_new_files_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = catalog.benchmark()
    bench["workloads"].append(
        {"name": "cbspheres_classic.extra", "config": "cbspheres_classic",
         "traffic": "extra", "chips": 1, "why": "a test"})
    bench["per_layer"].append(
        {"name": "frames_seen", "unit": "frames", "better": "higher",
         "source": "device_trace", "layer": "device", "moves":
         "mrays_per_s", "workloads": ["cbspheres_classic.extra"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    job = catalog.load_json(os.path.join(
        catalog.BENCH, "workloads", "cbspheres_classic.offline64.json"))
    job.update(name="cbspheres_classic.extra", traffic="extra")
    (root / "rtbench" / "workloads" / "cbspheres_classic.extra.json"
     ).write_text(json.dumps(job))
    (root / "rtbench" / "metrics" / "frames_seen.py").write_text(
        "def read(ctx):\n    return ctx['trace'].frames\n")
    monkeypatch.setattr(catalog, "BENCH", str(root / "rtbench"))
    monkeypatch.setattr(catalog, "ROOT", str(root))
    cell = catalog.cell("cbspheres_classic.extra")
    assert [m["name"] for m in cell["per_layer"]] == ["frames_seen"]

    class T:
        frames = 7

    assert catalog.metric_reader("frames_seen")({"trace": T}) == 7


def test_workload_must_match_its_entry(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(catalog.ROOT, "BENCHMARK.json"), root)
    path = root / "rtbench" / "workloads" / "cbspheres_classic.realtime2.json"
    job = json.loads(path.read_text())
    job["traffic"] = "offline64"
    path.write_text(json.dumps(job))
    monkeypatch.setattr(catalog, "BENCH", str(root / "rtbench"))
    monkeypatch.setattr(catalog, "ROOT", str(root))
    with pytest.raises(ValueError):
        catalog.cell("cbspheres_classic.realtime2")


def test_split_metric_reads_its_stems_file():
    # trace_ms.realtime has no file: it reads trace_ms.json
    assert not os.path.exists(os.path.join(catalog.BENCH, "metrics",
                                           "trace_ms.realtime.json"))
    spec = catalog.load_json(os.path.join(catalog.BENCH, "metrics",
                                          "trace_ms.json"))
    from rtb.trace import Op, Trace

    tr = Trace(device=[Op(spec["kernels"][0], 0.0, 0.002)], host=[],
               start=0.0, end=1.0, frames=2)
    assert catalog.metric_reader("trace_ms.realtime")({"trace": tr}) == \
        pytest.approx(1.0)
    with pytest.raises(FileNotFoundError):
        catalog.metric_reader("no_such_metric")


def test_light_kind_and_system_found_by_name(tmp_path, monkeypatch):
    root = tmp_path / "checkout"
    shutil.copytree(catalog.BENCH, root / "rtbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "rtbench" / "lights" / "point.py").write_text(
        "PORT_CLASS = 'PointLight'\nPORT_ARGS = ('radiance', 'position')\n")
    (root / "rtbench" / "systems" / "other.py").write_text(
        "class Renderer:\n    devices = ['cuda:0', 'cuda:1']\n")
    monkeypatch.setattr(catalog, "BENCH", str(root / "rtbench"))
    assert catalog.light_kind("point").PORT_CLASS == "PointLight"
    assert catalog.light_kind("area").PORT_CLASS == "AreaLight"
    assert len(catalog.system("other").Renderer.devices) == 2
    assert callable(catalog.system("wavefront").Renderer)


def test_every_light_kind_is_the_ports():
    from cuda_raytracer_tpu_torch.scene import static_scene as st

    for f in os.listdir(os.path.join(catalog.BENCH, "lights")):
        if f.endswith(".py"):
            kind = catalog.light_kind(f[:-3])
            assert issubclass(getattr(st, kind.PORT_CLASS), st.SceneLight)
