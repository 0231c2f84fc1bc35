"""The port's render_cli and its standard-library PNG I/O.

The CLI renders test_torch_collada.py's document on the CPU
(``--device cpu``); its PNG must decode with Pillow to ``to_uint8`` of
the image it was given, and read back identically with the port's
``load_png``.  The PNG reader is held against Pillow on rows written with
each of the five filter types.
"""

import json
import struct
import zlib

import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.apps import render_cli as jax_cli
from cuda_raytracer_tpu.render import engine as jax_engine

from cuda_raytracer_tpu_torch.apps import render_cli
from cuda_raytracer_tpu_torch.render import engine
from cuda_raytracer_tpu_torch.utils import image

from test_torch_collada import document
from torch_threads import _one_torch_thread  # noqa: F401

@pytest.fixture
def pil_image():
    return pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module")
def doc_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dae") / "scene.dae"
    path.write_text(document())
    return str(path)


def test_cli_writes_png(doc_path, tmp_path, monkeypatch, capsys, pil_image):
    out = str(tmp_path / "out.png")
    given = []
    save = image.save_png
    monkeypatch.setattr(image, "save_png",
                        lambda path, img: given.append(img) or save(path, img))
    assert render_cli.main([doc_path, "-w", out, "--device", "cpu",
                            "--size", "32x16", "-s", "2", "--bench"]) == 0
    bench = json.loads(capsys.readouterr().out.splitlines()[0])
    # mrays_per_s is rounded to 0.01: on a slow CPU it may read 0.0
    assert bench["spp"] == 2 and bench["render_s"] > 0
    assert bench["mrays_per_s"] >= 0
    img = given[0]
    assert img.shape == (16, 32, 3) and np.isfinite(img).all()
    assert img.mean() > 0.05
    with pil_image.open(out) as im:
        assert im.mode == "RGB"
        decoded = np.asarray(im)
    assert np.array_equal(decoded, image.to_uint8(img))
    assert np.array_equal(image.load_png(out),
                          decoded.astype(np.float32) / 255.0)


def test_cli_envmap(doc_path, tmp_path, monkeypatch):
    """-e attaches an environment light read from a PNG (load_png)."""
    env = str(tmp_path / "env.png")
    image.save_png(env, np.full((8, 16, 3), 0.5))
    lights = []
    load = engine.WavefrontRenderer.load_static_scene

    def spy(self, sscene, *args, **kw):
        lights.append([type(l).__name__ for l in sscene.lights])
        return load(self, sscene, *args, **kw)

    monkeypatch.setattr(engine.WavefrontRenderer, "load_static_scene", spy)
    assert render_cli.main([doc_path, "-w", str(tmp_path / "o.png"),
                            "--device", "cpu", "--size", "16x8", "-s", "1",
                            "-e", env]) == 0
    assert lights[-1][-1] == "EnvironmentLight" and len(lights) == 2


def test_cli_envmap_palette_png(doc_path, tmp_path, monkeypatch,
                                pil_image):
    """-e takes a palette PNG (which the port's reader once refused), read
    as the JAX package's load_png reads it."""
    from cuda_raytracer_tpu.utils.image import load_png as jax_load_png

    env = str(tmp_path / "env.png")
    idx = np.random.default_rng(5).integers(0, 4, (8, 16), np.uint8)
    im = pil_image.frombytes("P", (16, 8), idx.tobytes())
    im.putpalette(bytes([200, 180, 160, 40, 60, 90, 250, 250, 250, 0, 0,
                         0]))
    im.save(env)
    maps = []
    load = engine.WavefrontRenderer.load_static_scene

    def spy(self, sscene, *args, **kw):
        maps.extend(l.envmap for l in sscene.lights
                    if type(l).__name__ == "EnvironmentLight")
        return load(self, sscene, *args, **kw)

    monkeypatch.setattr(engine.WavefrontRenderer, "load_static_scene", spy)
    out = str(tmp_path / "o.png")
    assert render_cli.main([doc_path, "-w", out, "--device", "cpu",
                            "--size", "16x8", "-s", "1", "-e", env]) == 0
    assert np.array_equal(np.asarray(maps[-1]), jax_load_png(env))
    assert image.load_png(out).mean() > 0.0


def test_bench_keys_match_jax_cli(doc_path, tmp_path, monkeypatch, capsys):
    """Both CLIs print the same --bench keys (the JAX CLI here drives a
    stand-in renderer: only its printing is under test)."""

    class Stub:
        mrays_per_frame = 1.0

        def __init__(self, cfg, camera_mode):
            self.cfg = cfg

        def load_scene(self, path):
            pass

        def render_to(self, spp):
            return np.zeros((self.cfg.height, self.cfg.width, 3), np.float32)

    monkeypatch.setattr(jax_engine, "WavefrontRenderer", Stub)
    monkeypatch.setattr("cuda_raytracer_tpu.utils.image.save_png",
                        lambda path, img: None)
    args = [doc_path, "-w", str(tmp_path / "o.png"), "--size", "8x8",
            "-s", "1", "--bench"]
    assert jax_cli.main(args) == 0
    want = json.loads(capsys.readouterr().out.splitlines()[0])
    assert render_cli.main(args + ["--device", "cpu"]) == 0
    got = json.loads(capsys.readouterr().out.splitlines()[0])
    assert list(got) == list(want)


def test_cli_refuses(doc_path, tmp_path, monkeypatch):
    """--chips N shards over N devices: on the CPU it renders; with fewer
    GPUs visible, or with a missing GPU, it exits with an error (no
    fallback); the cutracer camera is refused by sharded frames."""
    out = str(tmp_path / "o.png")
    assert render_cli.main([doc_path, "-w", out, "--device", "cpu", "-s",
                            "2", "--size", "8x8", "--chips", "2"]) == 0
    img = image.load_png(out)
    assert img.shape == (8, 8, 3) and img.mean() > 0.0
    with pytest.raises(ValueError, match="cutracer"):
        render_cli.main([doc_path, "-w", out, "--device", "cpu", "-s", "2",
                         "--size", "8x8", "--chips", "2", "--camera-mode",
                         "cutracer"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit, match="only 1 device"):
        render_cli.main([doc_path, "-w", out, "--chips", "2"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        render_cli.main([doc_path, "-w", out, "-s", "1"])
    # tree width 16: the default traversal ("auto") takes the torch
    # traversal; the fast preset's explicit "dfs" refuses it
    assert render_cli.main([doc_path, "-w", out, "--device", "cpu", "-s",
                            "1", "--size", "8x8", "--tree-width", "16"]) == 0
    with pytest.raises(ValueError, match="tree_width <= 8"):
        render_cli.main([doc_path, "-w", out, "--device", "cpu", "-s", "1",
                         "--size", "8x8", "--tree-width", "16",
                         "--preset", "fast"])


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data)))


def _write_png(path, w, h, rows, color=2, depth=8, interlace=0):
    data = zlib.compress(b"".join(rows))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color,
                                              0, 0, interlace))
                # the image data split over two IDAT chunks
                + _chunk(b"IDAT", data[:40]) + _chunk(b"IDAT", data[40:])
                + _chunk(b"IEND", b""))


def _filtered_rows(pixels, filters):
    """Rows of pixels [H, W, C] uint8, row y filtered by
    filters[y % len(filters)] (PNG spec section 9.2)."""
    h, w, c = pixels.shape
    rows, prev = [], np.zeros(w * c, np.int64)
    for y in range(h):
        line = pixels[y].reshape(-1).astype(np.int64)
        left = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        up_left = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        kind = filters[y % len(filters)]
        if kind == 0:
            pred = np.zeros_like(line)
        elif kind == 1:
            pred = left
        elif kind == 2:
            pred = prev
        elif kind == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - up_left
            pa, pb, pc = abs(p - left), abs(p - prev), abs(p - up_left)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, up_left))
        rows.append(bytes([kind]) + ((line - pred) % 256).astype(
            np.uint8).tobytes())
        prev = line
    return rows


@pytest.mark.parametrize("channels", [3, 4])
def test_load_png_filters(tmp_path, channels, pil_image):
    g = np.random.default_rng(4)
    pixels = g.integers(0, 256, (10, 7, channels), dtype=np.uint8)
    path = str(tmp_path / "f.png")
    _write_png(path, 7, 10, _filtered_rows(pixels, [0, 1, 2, 3, 4]),
               color={3: 2, 4: 6}[channels])
    got = image.load_png(path)
    assert got.dtype == np.float32 and got.shape == (10, 7, 3)
    assert np.array_equal(got, pixels[:, :, :3].astype(np.float32) / 255.0)
    with pil_image.open(path) as im:
        assert np.array_equal(np.asarray(im.convert("RGB")),
                              pixels[:, :, :3])


def test_png_round_trip_and_refusals(tmp_path):
    img = np.random.default_rng(2).random((5, 9, 3)) * 1.2 - 0.1
    path = str(tmp_path / "rt.png")
    image.save_png(path, img)
    assert np.array_equal(image.load_png(path),
                          image.to_uint8(img).astype(np.float32) / 255.0)
    bad = str(tmp_path / "bad.png")
    rows = [bytes(1 + 4 * 3)] * 4
    # depths the colour type does not allow, an unknown colour type or
    # interlace method; a palette image without its PLTE; short data
    for kw, msg in ((dict(depth=4), "header"), (dict(color=3, depth=16),
                    "header"), (dict(color=5), "header"),
                    (dict(interlace=2), "header"), (dict(color=3), "PLTE"),
                    (dict(depth=16), "fewer")):
        _write_png(bad, 4, 4, rows, **kw)
        with pytest.raises(ValueError, match=msg):
            image.load_png(bad)
    with pytest.raises(ValueError, match="not a PNG"):
        image.load_png(__file__)
    with pytest.raises(ValueError, match=r"\[H, W, 3\]"):
        image.save_png(path, np.zeros((4, 4)))
