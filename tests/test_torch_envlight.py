"""The infinite lights against the JAX package: the environment map
(``render_cli -e``, read from EXR or PNG), the directional light and the
default ambient light (an infinite hemisphere).

Their NEE samples lie at an infinite distance, which ``nee_shadow_rays``
turns into the traversals' no-limit max_t (1e30), so their shadow rays
take the traversals' no-limit branch; the environment also samples a
CDF over its texels and looks escaped rays up in its lat-long map.
Held on the same inputs, stage by stage and whole:

* ``load_exr`` on files written here by ``chip_smoke.write_exr``
  (uncompressed, ZIPS and ZIP with a height that is not a multiple of
  16, float and half channels, written B, G, R): both packages' arrays
  bit-equal to each other and to the data written; a file that declares
  PIZ is refused by both with ValueError;
* the lights' host classes (the environment's pdf and cdf tables,
  ``sample_L``, ``sample_dir``), ``dynamic_scene``'s wrappers and
  ``init_light``, and the flattened tables;
* ``sample_light``'s three branches (the environment texel index
  exactly, the values within rtol 1e-5 / atol 1e-6), ``env_radiance``
  (equal at texel centres; on random directions the count that lands on
  another texel is reported), ``env_miss_radiance`` and
  ``nee_shadow_rays`` (max_t exactly 1e30);
* the furnace test of tests/test_envlight.py on the port, at its sizes;
* frames against the JAX engine (2 frames of 2 spp at 64x32, depth 4,
  per pixel rtol 1e-4 / atol 1e-5, at most 1% of pixels outside,
  reported), under the fast preset as shipped and under the reference
  defaults: a diffuse and a mirror sphere under an environment map with
  a bright texel, and terrain n=8 under max_leaf_size=4 (three
  wavefront levels) under a directional light, the hemisphere light,
  and all three with its area light;
* both packages' ``render_cli.main`` on test_torch_collada.py's document
  with a directional light added and ``-e`` an EXR, and on the lightless
  document: the PNGs differ in any 8-bit channel in at most 1% of
  pixels.

The JAX engine traces with its XLA scan (``traversal*="xla"``) as in
test_torch_engine.py; the port runs its kernels' plain versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.apps import render_cli as jax_cli
from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.config import fast_preset_kwargs as jax_fast
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops import shade as JS
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import bsdf as jax_bsdf
from cuda_raytracer_tpu.scene import dynamic_scene as jax_dyn
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.collada_info import LightInfo as JaxLightInfo
from cuda_raytracer_tpu.scene.collada_info import LightType as JaxLightType
from cuda_raytracer_tpu.utils.image import load_exr as jax_load_exr

from cuda_raytracer_tpu_torch.apps import render_cli
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import shade as PS
from cuda_raytracer_tpu_torch.render import backends
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.flatscene import (
    LIGHT_AREA,
    LIGHT_DIRECTIONAL,
    LIGHT_ENV,
    LIGHT_HEMISPHERE,
    flatten_scene,
)
from cuda_raytracer_tpu_torch.scene import bsdf as port_bsdf
from cuda_raytracer_tpu_torch.scene import dynamic_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.collada_info import LightInfo, LightType
from cuda_raytracer_tpu_torch.utils.image import load_exr, load_png

from chip_smoke import write_exr
from test_torch_collada import assert_same, document
from test_torch_flatscene import jax_fields

W, H, SPF, FRAMES = 64, 32, 2, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
STAGE_RTOL, STAGE_ATOL = 1e-5, 1e-6
T_NO_LIMIT = 1e30
BASE = dict(width=W, height=H, total_samples=SPF * FRAMES, max_depth=4,
            nee_schedule=((1, 1.0),) * 4, samples_per_frame=SPF)
#: cameras (origin, look-at): at the spheres, and above the terrain
VIEW_SPHERES = ([0, 0.75, 2.5], [0, 0.75, 0])
VIEW_TERRAIN = ([0, 1.3, 1.3], [0, 0, 0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py, whose fixture
    names the rounding it once guarded against (torch's CPU float32
    ``sqrt``; the plain traversals now take ``sqrt_rn``)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def env_map(h=8, w=16):
    """A lat-long map with a dim gradient and one bright texel."""
    theta = (np.arange(h) + 0.5) / h * np.pi
    env = np.empty((h, w, 3))
    env[:] = (0.2 + 0.3 * np.cos(theta))[:, None, None].clip(0.05)
    env *= np.array([0.8, 0.9, 1.0])
    env[2, 5] = [40.0, 36.0, 30.0]
    return env


# ---------------------------------------------------------------------------
# load_exr
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
@pytest.mark.parametrize("compression", ["none", "zips", "zip"])
def test_load_exr_layouts(tmp_path, compression, half):
    """37 rows (the last ZIP block holds 5), 13 columns: both loaders
    return the data written, to the bit (half channels as float16 read
    into float32)."""
    img = np.random.default_rng(3).uniform(0.0, 50.0, (37, 13, 3))
    img = img.astype(np.float32)
    path = str(tmp_path / "env.exr")
    write_exr(path, img, compression, half)
    want = img.astype(np.float16).astype(np.float32) if half else img
    ours, ref = load_exr(path), jax_load_exr(path)
    assert ours.dtype == ref.dtype == np.float32
    assert ours.shape == ref.shape == (37, 13, 3)
    assert np.array_equal(ours.view(np.uint32), ref.view(np.uint32))
    assert np.array_equal(ours.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("half", [False, True], ids=["float", "half"])
def test_load_exr_refuses_piz(tmp_path, half):
    """Both loaders list the PIZ code (4) but decode none of it: a file
    that declares PIZ, its blocks coded shorter than their raw size (here
    zlib streams stand in for PIZ's wavelet and Huffman coding, which no
    code of the repository writes), is refused with ValueError."""
    path = tmp_path / "piz.exr"
    img = np.random.default_rng(4).uniform(0.0, 1.0, (40, 16, 3))
    write_exr(str(path), np.round(img, 1), "zip", half)
    data = path.read_bytes()
    tag = b"compression\0compression\0" + (1).to_bytes(4, "little")
    at = data.index(tag) + len(tag)
    assert data[at] == 3
    path.write_bytes(data[:at] + bytes([4]) + data[at + 1:])
    for load in (load_exr, jax_load_exr):
        with pytest.raises(ValueError, match="underrun"):
            load(str(path))


# ---------------------------------------------------------------------------
# the lights' host classes and tables
# ---------------------------------------------------------------------------


def test_host_lights_equal():
    """EnvironmentLight's pdf and cdf tables, sample_L and sample_dir;
    DirectionalLight's direction; InfiniteHemisphereLight's sample_L:
    equal in both packages under the same generator."""
    env = env_map()
    ours, ref = st.EnvironmentLight(env), jst.EnvironmentLight(env)
    assert np.array_equal(ours._pdf, ref._pdf)
    assert np.array_equal(ours._cdf, ref._cdf)
    lights = [(ours, ref),
              (st.DirectionalLight([1.0, 0.9, 0.8], [-0.3, -0.5, -1.0]),
               jst.DirectionalLight([1.0, 0.9, 0.8], [-0.3, -0.5, -1.0])),
              (st.InfiniteHemisphereLight([0.5, 0.6, 0.7]),
               jst.InfiniteHemisphereLight([0.5, 0.6, 0.7]))]
    p = np.zeros(3)
    for a, b in lights:
        assert_same(a, b, type(a).__name__)
        ga, gb = np.random.default_rng(9), np.random.default_rng(9)
        for _ in range(64):
            assert_same(a.sample_L(p, ga), b.sample_L(p, gb),
                        type(a).__name__)
    d = np.random.default_rng(10).standard_normal((256, 3))
    for v in d:
        assert np.array_equal(ours.sample_dir(v), ref.sample_dir(v))


def test_dynamic_lights_equal():
    """dynamic_scene's ambient, directional and environment wrappers,
    through init_light where it selects them, to the same static
    lights."""
    xf = np.array([[0.0, -1.0, 0.0, 0.4], [1.0, 0.0, 0.0, -0.2],
                   [0.0, 0.0, 1.0, 1.5], [0.0, 0.0, 0.0, 1.0]])
    for kind in ("AMBIENT", "DIRECTIONAL"):
        ours, ref = LightInfo(), JaxLightInfo()
        ours.light_type = getattr(LightType, kind)
        ref.light_type = getattr(JaxLightType, kind)
        ours.spectrum = ref.spectrum = np.array([0.9, 0.8, 0.7])
        a, b = dynamic_scene.init_light(ours, xf), jax_dyn.init_light(ref, xf)
        assert_same(a, b, kind)
        assert_same(a.get_static_light(), b.get_static_light(), kind)
    env = env_map()
    assert_same(dynamic_scene.EnvironmentLight(env).get_static_light(),
                jax_dyn.EnvironmentLight(env).get_static_light(), "env")


def spheres_under_env(stm, bsdf, env):
    """A diffuse and a mirror sphere at VIEW_SPHERES' target under the
    environment map alone."""
    return stm.Scene(
        [stm.SphereObject(np.array([-0.5, 0.75, 0.0]), 0.45,
                          bsdf.DiffuseBSDF(np.full(3, 0.6))),
         stm.SphereObject(np.array([0.5, 0.75, 0.0]), 0.45,
                          bsdf.MirrorBSDF(np.full(3, 0.9)))],
        [stm.EnvironmentLight(env)])


def terrain_under(stm, terrain, lights):
    """Terrain n=8 with its lights replaced: a directional light low over
    the hills (so they shadow each other), the hemisphere light, or all
    three infinite lights beside its own area light."""
    scene = terrain(n=8)
    sun = stm.DirectionalLight([1.5, 1.4, 1.2], [-0.8, -0.35, -0.3])
    sky = stm.InfiniteHemisphereLight([0.5, 0.55, 0.6])
    by_name = {"directional": [sun], "hemisphere": [sky],
               "all": [scene.lights[0], sun, sky,
                       stm.EnvironmentLight(env_map())]}
    return stm.Scene(scene.objects, by_name[lights])


#: scene -> (port scene, JAX scene, viewpoint, config fields, light kinds)
SCENES = {
    "env-spheres": (lambda: spheres_under_env(st, port_bsdf, env_map()),
                    lambda: spheres_under_env(jst, jax_bsdf, env_map()),
                    VIEW_SPHERES, {}, (LIGHT_ENV,)),
    "terrain-directional": (
        lambda: terrain_under(st, terrain_scene, "directional"),
        lambda: terrain_under(jst, jax_terrain, "directional"),
        VIEW_TERRAIN, dict(max_leaf_size=4), (LIGHT_DIRECTIONAL,)),
    "terrain-hemisphere": (
        lambda: terrain_under(st, terrain_scene, "hemisphere"),
        lambda: terrain_under(jst, jax_terrain, "hemisphere"),
        VIEW_TERRAIN, dict(max_leaf_size=4), (LIGHT_HEMISPHERE,)),
    "terrain-all": (
        lambda: terrain_under(st, terrain_scene, "all"),
        lambda: terrain_under(jst, jax_terrain, "all"),
        VIEW_TERRAIN, dict(max_leaf_size=4),
        (LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE, LIGHT_ENV)),
}


def _flat_both(scene):
    port_scene, jax_scene = SCENES[scene][:2]
    kw = dict(tree_width=4, max_leaf_size=4)
    return (flatten_scene(port_scene(), device="cpu", **kw)[0],
            jax_flatten(jax_scene(), **kw)[0])


@pytest.mark.parametrize("scene", list(SCENES))
def test_flatten_tables_equal(scene):
    """Every FlatScene table equal to the JAX package's, the light
    kinds, env_map, env_cdf, env_pdf and has_env among them."""
    ours, ref = _flat_both(scene)
    fields, static = jax_fields(ref)
    for name, want in fields.items():
        obj = ours.bvh if name.startswith("bvh.") else ours
        got = getattr(obj, name.split(".")[-1]).numpy()
        assert got.dtype == want.dtype, name
        assert np.array_equal(got, want), name
    for name, want in static.items():
        obj = ours.bvh if name.startswith("bvh.") else ours
        assert getattr(obj, name.split(".")[-1]) == want, name
    assert tuple(ours.light_kinds) == SCENES[scene][4]
    assert ours.has_env == (LIGHT_ENV in SCENES[scene][4])


# ---------------------------------------------------------------------------
# shading stages
# ---------------------------------------------------------------------------


def close(got, want, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=STAGE_RTOL,
                                   atol=STAGE_ATOL, err_msg=name)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def all_lights():
    """terrain-all flattened by both packages, and 4096 shading points
    and uniform pairs from a seed."""
    ours, ref = _flat_both("terrain-all")
    g = np.random.default_rng(21)
    pt = g.uniform([-1, 0, -1], [1, 0.3, 1], (4096, 3)).astype(np.float32)
    u = g.random((4096, 2)).astype(np.float32)
    return ours, ref, pt, u


@pytest.mark.parametrize("kind", [LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE,
                                  LIGHT_ENV],
                         ids=["directional", "hemisphere", "environment"])
def test_sample_light(all_lights, kind):
    """One branch of sample_light on the same points and uniforms: Le /
    pdf and wi within the stage tolerance, dist infinite in both; for
    the environment the texel each uniform picks equal exactly."""
    ours, ref, pt, u = all_lights
    li = list(ours.light_kinds).index(kind)
    got = PS.sample_light(ours, li, T(pt), T(u))
    want = JS.sample_light(ref, li, jnp.asarray(pt), jnp.asarray(u))
    for name, a, b in zip(("le_over_pdf", "wi", "dist"), got, want):
        close(a, b, name)
    assert torch.isinf(got[2]).all() and np.isinf(np.asarray(want[2])).all()
    assert float(got[0].abs().sum()) > 0.0
    if kind == LIGHT_ENV:
        idx = torch.searchsorted(ours.env_cdf, T(u[:, 0]))
        jidx = np.asarray(jnp.searchsorted(ref.env_cdf, jnp.asarray(u[:, 0])))
        assert np.array_equal(idx.numpy(), jidx)
        # the bright texel draws most samples
        h, w, _ = ours.env_map.shape
        assert np.mean(idx.numpy() == 2 * w + 5) > 0.5


def _texel_map(h=16, w=32):
    """A map whose texels all differ: a lookup names its texel."""
    return np.arange(h * w * 3, dtype=np.float64).reshape(h, w, 3) / 7.0


def test_env_radiance_texel_centres():
    """The lookup along each texel's centre direction returns that texel
    in both packages; on 65,536 random directions the count that lands on
    another texel than the JAX package's is reported (a direction on a
    texel boundary can flip with the last bit of arccos or atan2)."""
    env = _texel_map()
    ours, _ = flatten_scene(spheres_under_env(st, port_bsdf, env),
                            device="cpu")
    ref, _ = jax_flatten(spheres_under_env(jst, jax_bsdf, env))
    h, w, _ = env.shape
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2 * np.pi
    st_ = np.sin(theta)[:, None]
    d = np.stack(np.broadcast_arrays(st_ * np.cos(phi), np.cos(theta)[:, None],
                                     st_ * np.sin(phi)), -1)
    d = d.reshape(-1, 3).astype(np.float32)
    want = env.reshape(-1, 3).astype(np.float32)
    got = PS.env_radiance(ours, T(d)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(np.asarray(JS.env_radiance(ref, jnp.asarray(d))),
                          want)

    r = np.random.default_rng(12).standard_normal((65536, 3))
    r = (r / np.linalg.norm(r, axis=1, keepdims=True)).astype(np.float32)
    a = PS.env_radiance(ours, T(r)).numpy()
    b = np.asarray(JS.env_radiance(ref, jnp.asarray(r)))
    flips = int((a != b).any(-1).sum())
    print(f"env_radiance: {flips} of {len(r)} random directions on another "
          f"texel than the JAX package's")
    assert flips <= MAX_BAD * len(r)


def test_env_miss_radiance():
    """Escaped rays on counted paths pick up importance x the map."""
    env = env_map()
    ours, _ = flatten_scene(spheres_under_env(st, port_bsdf, env),
                            device="cpu")
    ref, _ = jax_flatten(spheres_under_env(jst, jax_bsdf, env))
    g = np.random.default_rng(13)
    n = 4096
    d = g.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    imp = g.uniform(0.1, 2.0, (n, 3)).astype(np.float32)
    miss, ce = g.random(n) < 0.6, g.random(n) < 0.7
    got = PS.env_miss_radiance(ours, T(d), T(imp), T(miss), T(ce))
    want = JS.env_miss_radiance(ref, jnp.asarray(d), jnp.asarray(imp),
                                jnp.asarray(miss), jnp.asarray(ce))
    close(got, want, "env_miss_radiance")
    assert int((got.abs().sum(-1) > 0).sum()) == int((miss & ce).sum())


@pytest.fixture(scope="module")
def all_hits(all_lights):
    """Hit records of 4096 rays from above into terrain-all, made by both
    packages from the same closest hits (the JAX brute force), once for
    the light kinds' cases; and the importance weights."""
    ours, ref, _, u = all_lights
    g = np.random.default_rng(22)
    n = u.shape[0]
    o = np.tile(np.float32([[0.0, 1.3, 1.3]]), (n, 1))
    tgt = g.uniform([-0.9, -0.1, -0.9], [0.9, 0.1, 0.9], (n, 3))
    d = (tgt - o) / np.linalg.norm(tgt - o, axis=1, keepdims=True)
    d = d.astype(np.float32)
    tr = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                          jnp.ones(n, bool))
    t, prim = np.asarray(tr.t), np.asarray(tr.prim)
    hj = JS.compute_hits(ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t),
                         jnp.asarray(prim))
    hp = PS.compute_hits(ours, T(o), T(d), T(t), T(prim))
    imp = g.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    return hj, hp, imp


@pytest.mark.parametrize("kind", [LIGHT_DIRECTIONAL, LIGHT_HEMISPHERE,
                                  LIGHT_ENV],
                         ids=["directional", "hemisphere", "environment"])
def test_nee_shadow_rays_no_limit(all_lights, all_hits, kind):
    """Shadow rays toward an infinite light: o, d, li and ok as the JAX
    package builds them from the same hit records, and max_t exactly
    the no-limit 1e30 on every lane in both."""
    ours, ref, _, u = all_lights
    hj, hp, imp = all_hits
    n = u.shape[0]
    li = list(ours.light_kinds).index(kind)
    got = PS.nee_shadow_rays(ours, hp, T(imp), li, T(u), 1.0)
    want = JS.nee_shadow_rays(ref, hj, jnp.asarray(imp), li, jnp.asarray(u),
                              1.0)
    for name, a, b in zip(("o", "d", "max_t", "li", "ok"), got, want):
        close(a, b, name)
    assert (got[2] == T_NO_LIMIT).all()
    assert (np.asarray(want[2]) == np.float32(T_NO_LIMIT)).all()
    assert int(got[4].sum()) > n // 2


# ---------------------------------------------------------------------------
# frames
# ---------------------------------------------------------------------------


def test_furnace():
    """tests/test_envlight.py's furnace on the port, at its sizes: a
    uniform environment L around a white sphere; the background reads L,
    the sphere converges to L."""
    L = 0.7
    r = WavefrontRenderer(
        RenderConfig(width=32, height=24, samples_per_frame=8, max_depth=10,
                     hemisphere_sampling="uniform"), device="cpu")
    r.load_static_scene(st.Scene(
        [st.SphereObject(np.zeros(3), 1.0, port_bsdf.DiffuseBSDF(np.ones(3)))],
        [st.EnvironmentLight(np.full((8, 16, 3), L))]))
    r.set_viewpoint([0, 0, 4], [0, 0, 0])
    for _ in range(6):
        r.render()
    img = r.get_raw_image()
    assert np.isfinite(img).all()
    np.testing.assert_allclose(img[:2, :2].mean(), L, rtol=1e-3)
    center = img[10:14, 14:18].mean()
    assert abs(center - L) / L < 0.2, f"furnace failed: {center} vs {L}"


def configs(preset, **over):
    """(port config, JAX config) of a preset: the fast preset as shipped
    (only the frame cut to SPF spp), or the reference defaults (raster
    order, a draw per ray, no roulette, "auto" traversal); the JAX
    engine traces with its XLA scan."""
    xla = dict(traversal="xla", traversal_secondary="xla",
               traversal_rr="xla")
    if preset == "fast":
        kw = fast_preset_kwargs(W, H, SPF * FRAMES)
        jkw = jax_fast(W, H, SPF * FRAMES)
        for d in (kw, jkw):
            d.update(BASE, **over)
        jkw.update(xla)
        return RenderConfig(**kw), JaxConfig(**jkw)
    return RenderConfig(**BASE, **over), JaxConfig(**BASE, **over, **xla)


def _count_traces(mp):
    """Record each shadow trace of the port's traversals: (traversal,
    whether every lane has the no-limit max_t)."""
    seen = []
    for name in ("trace_closest_packets", "trace_closest_wavefront"):
        real = getattr(backends, name)

        def keep(scene, o, d, valid, t_limit, *a, _real=real, _name=name,
                 **kw):
            if t_limit is not None:
                seen.append((_name, bool((t_limit >= T_NO_LIMIT).all())))
            return _real(scene, o, d, valid, t_limit, *a, **kw)

        mp.setattr(backends, name, keep)
    return seen


def _check(got, want, what):
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{what}: {int(bad.sum())} of {H * W} pixels outside rtol={RTOL} "
          f"atol={ATOL}; max |diff| {float(np.abs(got - want).max()):.3g}")
    assert bad.mean() <= MAX_BAD, what


@pytest.mark.parametrize("preset", ["fast", "reference"])
@pytest.mark.parametrize("scene", list(SCENES))
def test_frames_match_jax_engine(scene, preset):
    """Both engines on the same scene and config: the port's frames per
    pixel against the JAX engine's, and each infinite light's shadow
    traces through the no-limit branch (under the fast preset the DFS at
    depths 0-1 and the compacted wavefront at depths 2-3)."""
    port_scene, jax_scene, view, over, kinds = SCENES[scene]
    cfg, jcfg = configs(preset, **over)
    ref = JaxRenderer(jcfg, camera_mode="collada")
    ref.load_static_scene(jax_scene())
    ref.set_viewpoint(*view)
    for _ in range(FRAMES):
        ref.render()
    with pytest.MonkeyPatch.context() as mp:
        seen = _count_traces(mp)
        r = WavefrontRenderer(cfg, camera_mode="collada", device="cpu")
        r.load_static_scene(port_scene())
        r.set_viewpoint(*view)
        for _ in range(FRAMES):
            r.render()
            assert r.dropped == 0
    assert tuple(r.scene.light_kinds) == kinds
    if "max_leaf_size" in over:
        assert len(r.scene.bvh.wf_sched) == 3
    infinite = sum(k != LIGHT_AREA for k in kinds)
    want = FRAMES * cfg.max_depth * infinite
    no_limit = [name for name, unbounded in seen if unbounded]
    assert len(no_limit) == want
    if preset == "fast":
        rr = FRAMES * (cfg.max_depth - cfg.rr_start_depth) * infinite
        assert no_limit.count("trace_closest_wavefront") == rr
    raw = r.get_raw_image()
    assert raw.mean() > 0.01
    _check(raw, ref.get_raw_image(), f"{scene}, {preset}: raw image")
    _check(r.get_image(), ref.get_image(),
           f"{scene}, {preset}: median-filtered image")


# ---------------------------------------------------------------------------
# both CLIs
# ---------------------------------------------------------------------------

#: a directional light for test_torch_collada.py's document, and its
#: node (its direction toward the light, world (0.3, 0.5, 1), is the
#: document point (-0.3, 1, 0.5) the node's translation carries the
#: default direction (0, 0, -1) to)
SUN_LIGHT = ('<light id="sun"><technique_common><directional><color>1.5 '
             '1.4 1.2</color></directional></technique_common></light>')
SUN_NODE = ('<node id="sun-node" name="sun-node"><translate>-0.3 1.0 1.5'
            '</translate><instance_light url="#sun"/></node>')


def document_with_sun():
    doc = document()
    out = doc.replace("</library_lights>", SUN_LIGHT + "</library_lights>")
    out = out.replace('<node id="cam-node"', SUN_NODE + '<node id="cam-node"')
    assert out.count('id="sun') == 2
    return out


def _both_clis(doc, tmp_path, extra=()):
    """Both packages' render_cli.main on ``doc`` (the default preset,
    64x32, 4 spp): the PNGs differ in at most 1% of pixels.  Returns the
    light kinds the port's engine flattened."""
    pytest.importorskip("PIL.Image")  # the JAX CLI writes with Pillow
    path = tmp_path / "scene.dae"
    path.write_text(doc)
    argv = [str(path), "--size", f"{W}x{H}", "-s", "4", *extra]
    jax_png, port_png = str(tmp_path / "jax.png"), str(tmp_path / "port.png")
    kinds = []
    load = WavefrontRenderer.load_static_scene

    def spy(self, sscene, *a, **kw):
        load(self, sscene, *a, **kw)
        kinds.append(tuple(self.scene.light_kinds))

    assert jax_cli.main([*argv, "-w", jax_png]) == 0
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(WavefrontRenderer, "load_static_scene", spy)
        assert render_cli.main([*argv, "-w", port_png,
                                "--device", "cpu"]) == 0
    a, b = load_png(port_png), load_png(jax_png)
    assert a.shape == (H, W, 3) and a.mean() > 0.05
    bad = (a != b).any(-1)
    print(f"CLI PNGs: {int(bad.sum())} of {H * W} pixels differ")
    assert bad.mean() <= MAX_BAD
    return kinds[-1]


def test_clis_directional_and_exr(tmp_path):
    """The document with a directional light added, -e a float ZIP EXR:
    area, point, spot, directional and environment lights."""
    exr = str(tmp_path / "env.exr")
    write_exr(exr, env_map(16, 32), "zip")
    kinds = _both_clis(document_with_sun(), tmp_path, ["-e", exr])
    assert kinds[-2:] == (LIGHT_DIRECTIONAL, LIGHT_ENV)
    assert len(kinds) == 5


def test_clis_lightless_document(tmp_path):
    """A document with no light: both loaders add the default ambient
    light, an infinite hemisphere, and both CLIs render under it."""
    kinds = _both_clis(document(lights=False), tmp_path)
    assert kinds == (LIGHT_HEMISPHERE,)



def test_clis_env_loses_the_document_camera(tmp_path):
    """-e loads the scene again without the document's camera, in both
    packages (a finding shared by both, kept in the port): the collada
    mode falls back to the canonical placement, as the PNGs above compare,
    and the cutracer mode, which needs the document's camera, refuses
    with the same ValueError."""
    path = tmp_path / "scene.dae"
    path.write_text(document_with_sun())
    exr = str(tmp_path / "env.exr")
    write_exr(exr, env_map(), "zips")
    argv = [str(path), "--size", "16x8", "-s", "1", "-e", exr,
            "--camera-mode", "cutracer", "-w", str(tmp_path / "o.png")]
    for main, extra in ((jax_cli.main, []),
                        (render_cli.main, ["--device", "cpu"])):
        with pytest.raises(ValueError, match="no collada camera"):
            main([*argv, *extra])
