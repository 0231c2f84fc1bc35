"""render_cli's default preset (``--preset reference``) against the JAX
engine.

``render_cli scene.dae`` with no ``--preset`` renders the reference
configuration: raster order, one draw per ray (``rng_granule=1``), no
roulette (``rr_start_depth=0``), ``traversal="auto"`` on every pass (the
packet-DFS up to tree width 8, the torch traversal above), 2 spp per
pass and an NEE schedule of (l, 1/l) per depth, under the flags users
turn: ``-l``, ``-m``, ``--hemisphere``, ``--reference-compat`` and
``--tree-width``.  Each case builds the port's config with
``render_cli.render_config`` from the CLI's own arguments, checks that
the JAX CLI builds the same config from them, and renders 2 frames of 2
spp at 64x32 in both engines: on the Cornell box with spheres and on
terrain n=8 under ``max_leaf_size=4`` (three BVH levels), and, for the
reference-compat cutracer camera, on test_torch_collada.py's document.
The JAX engine traces with its XLA scan (``traversal="xla"``, what its
"auto" is on the CPU); the port runs the DFS's plain version (the torch
traversal at width 16), with torch's default thread count.

Held, as in test_torch_engine.py: per pixel rtol=1e-4, atol=1e-5 on the
raw and on the median-filtered image, at most 1% of pixels outside it,
reported.  One case drives both packages' ``render_cli.main`` on the
same document and compares the saved PNGs: at most 1% of pixels differ
in any 8-bit channel.
"""

import dataclasses

import numpy as np
import pytest

from cuda_raytracer_tpu.apps import render_cli as jax_cli
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.render import engine as jax_engine

from cuda_raytracer_tpu_torch.apps import render_cli
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.render import backends
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.utils.image import load_png

from test_torch_collada import document
from torch_threads import _one_torch_thread  # noqa: F401

W, H, SPF, FRAMES = 64, 32, 2, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
SIZE = ["--size", f"{W}x{H}", "-s", str(SPF * FRAMES)]

#: case -> the CLI flags it adds to the default preset
CASES = {
    "default": [],
    "cosine": ["--hemisphere", "cosine"],
    "light-samples-2": ["-l", "2"],
    "max-depth-4": ["-m", "4"],
    "width-2": ["--tree-width", "2"],
    "width-8": ["--tree-width", "8"],
    "width-16": ["--tree-width", "16"],
    "compat-cutracer": ["--reference-compat", "--camera-mode", "cutracer"],
}
#: scene -> (port scene, JAX scene, viewpoint, config fields over the CLI's)
SCENES = {
    "cornell": (lambda: cornell_box_scene(with_spheres=True),
                lambda: jax_cornell(with_spheres=True),
                ([0, 0.75, 2.5], [0, 0.75, 0]), {}),
    "terrain": (lambda: terrain_scene(n=8), lambda: jax_terrain(n=8),
                ([0, 1.3, 1.3], [0, 0, 0]), dict(max_leaf_size=4)),
}


class _Stop(Exception):
    pass


def _argv(case):
    return ["scene.dae", *SIZE, *CASES[case]]


def jax_cli_config(argv):
    """The config the JAX CLI builds from ``argv`` (its renderer class is
    replaced by one that keeps the config and stops)."""
    got = []

    def keep(cfg, **kw):
        got.append(cfg)
        raise _Stop

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_engine, "WavefrontRenderer", keep)
        with pytest.raises(_Stop):
            jax_cli.main(argv)
    return got[0]


def configs(case, **over):
    """(port config, JAX config, camera mode) of one case: the CLI's
    own, with ``over`` on both; the JAX one traces with its XLA scan."""
    args = render_cli.build_parser().parse_args(_argv(case))
    cfg = dataclasses.replace(render_cli.render_config(args), **over)
    jcfg = jax_cli_config(_argv(case)).replace(
        traversal="xla", traversal_secondary="xla", traversal_rr="xla",
        **over)
    return cfg, jcfg, args.camera_mode


@pytest.mark.parametrize("case", list(CASES))
def test_cli_config_matches_jax_cli(case):
    """Both CLIs build the same RenderConfig from the same flags, and it
    is the reference preset: raster order, per-ray draws, no roulette,
    "auto" traversal, 2 spp per pass, (l, 1/l) NEE per depth."""
    argv = _argv(case)
    cfg = render_cli.render_config(render_cli.build_parser().parse_args(argv))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        jax_cli_config(argv))
    assert (cfg.sample_order, cfg.rng_granule, cfg.rr_start_depth) == (
        "raster", 1, 0)
    assert cfg.traversal == "auto" and not cfg.traversal_secondary
    assert not cfg.traversal_rr and not cfg.compact_depths
    assert cfg.samples_per_frame == SPF
    l = 2 if case == "light-samples-2" else 1
    m = 4 if case == "max-depth-4" else 3
    assert cfg.nee_schedule == ((l, 1.0 / l),) * m


def _count_traces(mp):
    """Count the port's traces by traversal: (DFS calls as (tree width,
    whether a t_limit was passed), torch-traversal calls)."""
    dfs, xla = [], []
    real_dfs, real_xla = backends.trace_closest_packets, backends.trace_closest

    def count_dfs(scene, o, d, valid, t_limit, *a, **kw):
        dfs.append((scene.bvh.width, t_limit is not None))
        return real_dfs(scene, o, d, valid, t_limit, *a, **kw)

    def count_xla(*a, **kw):
        xla.append(1)
        return real_xla(*a, **kw)

    mp.setattr(backends, "trace_closest_packets", count_dfs)
    mp.setattr(backends, "trace_closest", count_xla)
    return dfs, xla


def _check(got, want, what):
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{what}: {int(bad.sum())} of {H * W} pixels outside rtol={RTOL} "
          f"atol={ATOL}")
    assert bad.mean() <= MAX_BAD, what


def _loaded(r, load, view):
    load(r)
    if view is not None:
        r.set_viewpoint(*view)
    return r


def _hold(case, port_load, jax_load, view, what, frames=FRAMES, **over):
    """Render the case in both engines and hold the port's frames and
    traces: every trace through the DFS at the config's width (the
    torch traversal above 8), as many as the NEE schedule gives, shadow
    traces bounded by their t_limit but under --reference-compat.
    ``frames`` is a frame count, or counts at which to hold the frames
    rendered so far.  Returns the port's renderer."""
    cfg, jcfg, mode = configs(case, **over)
    ref = _loaded(jax_engine.WavefrontRenderer(jcfg, camera_mode=mode),
                  jax_load, view)
    r = _loaded(WavefrontRenderer(cfg, camera_mode=mode, device="cpu"),
                port_load, view)
    done = 0
    for upto in (frames,) if isinstance(frames, int) else frames:
        with pytest.MonkeyPatch.context() as mp:
            dfs, xla = _count_traces(mp)
            for _ in range(upto - done):
                r.render()
        for _ in range(upto - done):
            ref.render()
        _hold_frames(r, ref, cfg, dfs, xla, upto - done,
                     f"{what}, {upto} frames")
        done = upto
    return r


def _hold_frames(r, ref, cfg, dfs, xla, frames, what):
    """The checks of ``_hold`` on ``frames`` frames just rendered, whose
    traces ``dfs`` and ``xla`` counted."""
    assert r.dropped == 0 and r.scene.bvh.width == cfg.tree_width
    shadow = frames * sum(n * r.scene.num_lights
                          for n, _ in cfg.nee_schedule)
    traces = frames * len(cfg.nee_schedule) + shadow
    assert r.traces_per_frame * frames == traces
    if cfg.tree_width <= 8:
        assert not xla and len(dfs) == traces
        assert {w for w, _ in dfs} == {cfg.tree_width}
        bounded = sum(limited for _, limited in dfs)
        assert bounded == (0 if cfg.reference_compat else shadow)
    else:
        assert len(xla) == traces and not dfs
    raw = r.get_raw_image()
    assert raw.mean() > 0.01
    _check(raw, ref.get_raw_image(), f"{what}: raw image")
    _check(r.get_image(), ref.get_image(), f"{what}: median-filtered image")


@pytest.fixture(scope="module")
def default_cornell():
    """The default case on the Cornell box in both engines, held after
    FRAMES frames and after 17 (34 spp, past post_process_threshold):
    one render serves test_frames_match_jax_engine's case and
    test_median_stops_at_threshold.  The port's renderer."""
    port_scene, jax_scene, view, over = SCENES["cornell"]
    return _hold("default", lambda r: r.load_static_scene(port_scene()),
                 lambda r: r.load_static_scene(jax_scene()), view,
                 "default, cornell", frames=(FRAMES, 17), **over)


@pytest.mark.parametrize("scene", list(SCENES))
@pytest.mark.parametrize("case", [c for c in CASES if c != "compat-cutracer"])
def test_frames_match_jax_engine(case, scene, request):
    if (case, scene) == ("default", "cornell"):
        request.getfixturevalue("default_cornell")  # held at FRAMES there
        return
    port_scene, jax_scene, view, over = SCENES[scene]
    _hold(case, lambda r: r.load_static_scene(port_scene()),
          lambda r: r.load_static_scene(jax_scene()), view,
          f"{case}, {scene}", **over)


@pytest.fixture(scope="module")
def doc_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dae") / "scene.dae"
    path.write_text(document())
    return str(path)


def test_compat_cutracer_matches_jax_engine(doc_path):
    """--reference-compat with the cutracer camera on a COLLADA document:
    the compat camera's frustum, no emission at hits, two-sided lights
    and the compat shadow rule, through load_scene."""
    load = lambda r: r.load_scene(doc_path)  # noqa: E731
    _hold("compat-cutracer", load, load, None, "compat, cutracer, document")


def test_median_stops_at_threshold(default_cornell):
    """17 passes of 2 spp on the Cornell box: the 17th starts at 32
    accumulated samples (post_process_threshold), so the film skips the
    median there, in both engines."""
    r = default_cornell
    assert r.image_samples == 34 > r.config.post_process_threshold
    assert np.array_equal(r.get_image(), r.get_raw_image())


def test_cli_images_match_jax_cli(doc_path, tmp_path):
    """Both packages' render_cli.main on the same document, no --preset:
    the saved PNGs agree pixel for pixel but for at most 1%."""
    pytest.importorskip("PIL.Image")  # the JAX CLI writes with Pillow
    jax_png, port_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    assert jax_cli.main([doc_path, *SIZE, "-w", jax_png]) == 0
    assert render_cli.main([doc_path, *SIZE, "-w", port_png,
                            "--device", "cpu"]) == 0
    a, b = load_png(port_png), load_png(jax_png)
    assert a.shape == (H, W, 3) and a.mean() > 0.05
    bad = (a != b).any(-1)
    print(f"CLI PNGs: {int(bad.sum())} of {H * W} pixels differ")
    assert bad.mean() <= MAX_BAD
