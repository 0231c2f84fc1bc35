"""The port's COLLADA path against the JAX package's, on one document.

The document below (Z_UP, written here so no media is needed) holds a
polylist of quads and a closed triangles mesh with a NORMAL input, nodes
placed by translate/rotate/scale and by a 16-float matrix, a camera
under a 15-float matrix, phong diffuse and CMU462 mirror, glass,
refraction and emission materials, a sphere extra, and area, point and
spot lights.  Both packages parse it; the SceneInfo, the static scene
and the flattened tables must be equal exactly (the port's parser is a
copy, so its float64 arithmetic is the same).  Frames loaded through
``load_scene`` are held against the JAX engine per pixel (rtol 1e-4,
atol 1e-5, at most 1% of pixels outside, as in test_torch_engine.py).
"""

import enum

import jax
import numpy as np
import pytest
import torch

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.config import fast_preset_kwargs as jax_fast
from cuda_raytracer_tpu.ops import shade as jax_shade
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import collada as jax_collada
from cuda_raytracer_tpu.scene import dynamic_scene as jax_dyn
from cuda_raytracer_tpu.scene.collada_info import SceneInfo as JaxSceneInfo

from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.ops import shade
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.flatscene import (
    flatten_scene,
    from_jax_arrays,
)
from cuda_raytracer_tpu_torch.scene import collada, dynamic_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.collada_info import SceneInfo

from test_torch_flatscene import jax_fields

_PHONG = ('<effect id="{0}"><profile_COMMON><technique sid="common"><phong>'
          '<diffuse><color>{1} 1</color></diffuse></phong></technique>'
          '</profile_COMMON></effect>')
_CMU = ('<effect id="{0}"><profile_COMMON><technique sid="common"><phong>'
        '<diffuse><color>0.5 0.5 0.5 1</color></diffuse></phong></technique>'
        '</profile_COMMON><extra><technique profile="CMU462">{1}</technique>'
        '</extra></effect>')


def _node(nid, placement, inst):
    return f'<node id="{nid}" name="{nid}">{placement}{inst}</node>'


def _geom(url, material):
    return (f'<instance_geometry url="#{url}"><bind_material>'
            f'<technique_common><instance_material symbol="m" '
            f'target="#{material}"/></technique_common></bind_material>'
            f'</instance_geometry>')


#: a square pyramid, closed and consistently wound (base v0-v3, apex v4)
PYRAMID_P = "-0.2 -0.2 0 0.2 -0.2 0 0.2 0.2 0 -0.2 0.2 0 0 0 0.35"
PYRAMID_N = "0 -0.87 0.5 0.87 0 0.5 0 0.87 0.5 -0.87 0 0.5 0 0 -1"
PYRAMID_TRIS = [(0, 1, 4, 0), (1, 2, 4, 1), (2, 3, 4, 2), (3, 0, 4, 3),
                (0, 3, 2, 4), (0, 2, 1, 4)]

LIGHT_NODES = "".join([
    _node("area-node", "<scale>0.5 0.4 1</scale>"
          "<translate>0 0 1.45</translate>",
          '<instance_light url="#area"/>'),
    _node("point-node", "<translate>0.5 0.5 1.0</translate>",
          '<instance_light url="#point"/>'),
    _node("spot-node", "<matrix>1 0 0 -0.5 0 1 0 0.5 0 0 1 1.2 0 0 0 1"
          "</matrix>", '<instance_light url="#spot"/>'),
])
#: camera at world (0, 0.2, 3) looking down -z (0.95 with the .dae
#: camera's +0.75 lift); 15 floats, the last row's 1 missing
CAMERA_NODE = _node("cam-node", "<matrix>-1 0 0 0 0 0 1 3 0 1 0 0.2 0 0 0"
                    "</matrix>", '<instance_camera url="#cam"/>')


def document(lights=True, camera=True):
    """The test document (Z_UP): world = (-x, z, y) of the document's."""
    effects = "".join([
        _PHONG.format("fx-white", "0.8 0.8 0.8"),
        _PHONG.format("fx-red", "0.8 0.1 0.1"),
        _CMU.format("fx-mirror",
                    "<mirror><reflectance>0.9 0.9 0.9</reflectance></mirror>"),
        _CMU.format("fx-glass",
                    "<glass><transmittance>0.9 0.9 0.9</transmittance>"
                    "<reflectance>0.9 0.9 0.9</reflectance>"
                    "<roughness>0</roughness><ior>1.5</ior></glass>"),
        _CMU.format("fx-refr",
                    "<refraction><transmittance>0.8 0.9 0.8</transmittance>"
                    "<roughness>0</roughness><ior>1.33</ior></refraction>"),
        _CMU.format("fx-emit",
                    "<emission><radiance>4 4 4</radiance></emission>"),
    ])
    materials = "".join(
        f'<material id="{m}"><instance_effect url="#fx-{m}"/></material>'
        for m in ("white", "red", "mirror", "glass", "refr", "emit"))
    walls = ("-1 -1 0 1 -1 0 1 1 0 -1 1 0 "
             "-1 -1 0 -1 -1 1.5 1 -1 1.5 1 -1 0 "
             "1 -1 0 1 1 0 1 1 1.5 1 -1 1.5")
    tris_p = " ".join(f"{a} {n} {b} {n} {c} {n}"
                      for a, b, c, n in PYRAMID_TRIS)
    geometries = "".join([
        '<geometry id="walls"><mesh><source id="walls-pos"><float_array '
        f'id="walls-arr" count="36">{walls}</float_array></source>'
        '<vertices id="walls-v"><input semantic="POSITION" '
        'source="#walls-pos"/></vertices><polylist count="3">'
        '<input semantic="VERTEX" source="#walls-v" offset="0"/>'
        '<vcount>4 4 4</vcount><p>0 1 2 3 4 5 6 7 8 9 10 11</p></polylist>'
        '</mesh></geometry>',
        '<geometry id="pyramid"><mesh><source id="pyr-pos"><float_array '
        f'id="pyr-parr" count="15">{PYRAMID_P}</float_array></source>'
        '<source id="pyr-nrm"><float_array id="pyr-narr" count="15">'
        f'{PYRAMID_N}</float_array></source><vertices id="pyr-v">'
        '<input semantic="POSITION" source="#pyr-pos"/></vertices>'
        '<triangles count="6"><input semantic="VERTEX" source="#pyr-v" '
        'offset="0"/><input semantic="NORMAL" source="#pyr-nrm" offset="1"/>'
        f'<p>{tris_p}</p></triangles></mesh></geometry>',
        '<geometry id="patch"><mesh><source id="patch-pos"><float_array '
        'id="patch-arr" count="12">-0.5 -0.5 0 0.5 -0.5 0 0.5 0.5 0 '
        '-0.5 0.5 0</float_array></source><vertices id="patch-v">'
        '<input semantic="POSITION" source="#patch-pos"/></vertices>'
        '<polylist count="1"><input semantic="VERTEX" source="#patch-v" '
        'offset="0"/><vcount>4</vcount><p>0 3 2 1</p></polylist></mesh>'
        '</geometry>',
        '<geometry id="ball"><extra><technique profile="CMU462"><sphere>'
        '<radius>0.25</radius></sphere></technique></extra></geometry>',
    ])
    nodes = "".join([
        _node("walls-node", "", _geom("walls", "white")),
        _node("pyramid-node", "<matrix>0.8 -0.6 0 0.3 0.6 0.8 0 0.2 0 0 1 0 "
              "0 0 0 1</matrix>", _geom("pyramid", "red")),
        _node("emit-node", "<translate>0 0 1.49</translate>"
              "<rotate>0 0 1 30</rotate><scale>0.3 0.3 1</scale>",
              _geom("patch", "emit")),
        _node("mirror-node", "<translate>0.5 -0.3 0.25</translate>",
              _geom("ball", "mirror")),
        _node("glass-node", "<translate>-0.4 0.1 0.25</translate>",
              _geom("ball", "glass")),
        _node("refr-node", "<scale>0.6 0.6 0.6</scale>"
              "<translate>0 0.5 0.15</translate>", _geom("ball", "refr")),
        LIGHT_NODES if lights else "",
        CAMERA_NODE if camera else "",
    ])
    return (
        '<?xml version="1.0" encoding="utf-8"?>\n'
        '<COLLADA xmlns="http://www.collada.org/2005/11/COLLADASchema" '
        'version="1.4.1"><asset><up_axis>Z_UP</up_axis></asset>'
        '<library_cameras><camera id="cam" name="cam"><optics>'
        '<technique_common><perspective><xfov>50</xfov><yfov>35</yfov>'
        '<znear>0.01</znear><zfar>100</zfar></perspective>'
        '</technique_common></optics></camera></library_cameras>'
        '<library_lights>'
        '<light id="area"><extra><technique profile="CMU462"><area>'
        '<color>6 6 6</color></area></technique></extra></light>'
        '<light id="point"><technique_common><point><color>0.5 0.4 0.3'
        '</color><constant_attenuation>1</constant_attenuation>'
        '<linear_attenuation>0.1</linear_attenuation>'
        '<quadratic_attenuation>0.01</quadratic_attenuation></point>'
        '</technique_common></light>'
        '<light id="spot"><technique_common><spot><color>0.3 0.3 0.6'
        '</color><falloff_angle>30</falloff_angle><falloff_exponent>0.5'
        '</falloff_exponent></spot></technique_common></light>'
        f'</library_lights><library_effects>{effects}</library_effects>'
        f'<library_materials>{materials}</library_materials>'
        f'<library_geometries>{geometries}</library_geometries>'
        f'<library_visual_scenes><visual_scene id="vs">{nodes}'
        '</visual_scene></library_visual_scenes>'
        '<scene><instance_visual_scene url="#vs"/></scene></COLLADA>\n'
    )


@pytest.fixture(scope="module")
def doc_path(tmp_path_factory):
    path = tmp_path_factory.mktemp("dae") / "scene.dae"
    path.write_text(document())
    return str(path)


def assert_same(a, b, where="scene"):
    """The same value in both packages: classes by name, dataclasses and
    plain objects field by field, arrays equal in dtype and value."""
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, where
        assert np.array_equal(a, b), where
    elif isinstance(a, enum.Enum):
        assert type(a).__name__ == type(b).__name__, where
        assert a.name == b.name, where
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{where}[{i}]")
    elif hasattr(a, "__dict__"):
        assert type(a).__name__ == type(b).__name__, where
        va, vb = vars(a), vars(b)
        assert sorted(va) == sorted(vb), where
        for k in va:
            assert_same(va[k], vb[k], f"{where}.{k}")
    else:
        assert type(a) is type(b) and a == b, (where, a, b)


def _load_both(path):
    return collada.load_scene_info(path), jax_collada.load_scene_info(path)


def test_scene_info_equal(doc_path):
    ours, ref = _load_both(doc_path)
    kinds = [n.instance.type.name for n in ours.nodes]
    assert kinds == ["POLYMESH"] * 3 + ["SPHERE"] * 3 + ["LIGHT"] * 3 \
        + ["CAMERA"]
    assert_same(ours, ref)
    # the 15-float matrix: the missing entry falls back to the identity's
    assert ours.nodes[-1].transform[3, 3] == 1.0
    # the triangles mesh kept its NORMAL input
    assert ours.nodes[1].instance.normals.shape == (5, 3)
    assert [p.normal_indices for p in ours.nodes[1].instance.polygons] == \
        [[n] * 3 for *_, n in PYRAMID_TRIS]


def test_static_scene_and_flatten_tables_equal(doc_path):
    ours, ref = _load_both(doc_path)
    dyn, cam, cam_xf, cut = dynamic_scene.load_from_scene_info(ours)
    jdyn, jcam, jcam_xf, jcut = jax_dyn.load_from_scene_info(ref)
    assert_same((cam, cam_xf, cut), (jcam, jcam_xf, jcut))
    ss, jss = dyn.get_static_scene(), jdyn.get_static_scene()
    assert [type(o).__name__ for o in ss.objects] == \
        ["Mesh"] * 3 + ["SphereObject"] * 3
    assert [type(l).__name__ for l in ss.lights] == \
        ["AreaLight", "PointLight", "SpotLight"]
    assert_same(ss, jss)
    # the Z_UP basis: the walls' floor lies at world y = 0, the area
    # light below the ceiling, pointing down
    assert ss.objects[0].positions[:4, 1].tolist() == [0.0] * 4
    np.testing.assert_array_equal(ss.lights[0].direction, [0.0, -1.0, 0.0])

    flat, _ = flatten_scene(ss, max_leaf_size=2, device="cpu")
    fields, static = jax_fields(jax_flatten(jss, max_leaf_size=2)[0])
    loaded = from_jax_arrays(fields, static, device="cpu")
    for name in fields:
        parts = name.split(".")
        got = getattr(flat.bvh if len(parts) == 2 else flat, parts[-1])
        want = getattr(loaded.bvh if len(parts) == 2 else loaded, parts[-1])
        assert got.dtype == want.dtype, name
        assert torch.equal(got, want), name
    for name, want in static.items():
        obj = flat.bvh if name.startswith("bvh.") else flat
        assert getattr(obj, name.split(".")[-1]) == want, name


def test_default_ambient_light(tmp_path):
    path = tmp_path / "dark.dae"
    path.write_text(document(lights=False))
    ours, ref = _load_both(str(path))
    ss = dynamic_scene.load_from_scene_info(ours)[0].get_static_scene()
    jss = jax_dyn.load_from_scene_info(ref)[0].get_static_scene()
    assert [type(l).__name__ for l in ss.lights] == ["InfiniteHemisphereLight"]
    assert_same(ss, jss)


def test_error_paths(tmp_path):
    missing = str(tmp_path / "missing.dae")
    bad = tmp_path / "bad.dae"
    bad.write_text("<nope/>")
    broken = tmp_path / "broken.dae"
    broken.write_text("<COLLADA><scene>")
    for path in (missing, str(bad), str(broken)):
        assert collada.ColladaParser.load(path, SceneInfo()) == -1
        assert jax_collada.ColladaParser.load(path, JaxSceneInfo()) == -1
        with pytest.raises(IOError, match="COLLADA parsing failed"):
            collada.load_scene_info(path)


def test_writer_bytes_and_round_trip(doc_path, tmp_path):
    ours, ref = _load_both(doc_path)
    a, b = tmp_path / "port.dae", tmp_path / "jax.dae"
    assert collada.ColladaParser.save(str(a), ours) == 0
    assert jax_collada.ColladaParser.save(str(b), ref) == 0
    assert a.read_bytes() == b.read_bytes()

    # save -> load keeps the geometry, lights and camera (the writer
    # keeps no materials: every object comes back with the default BSDF)
    back = collada.load_scene_info(str(a))
    s1, cam1, xf1, _ = dynamic_scene.load_from_scene_info(ours)
    s2, cam2, xf2, _ = dynamic_scene.load_from_scene_info(back)
    ss1, ss2 = s1.get_static_scene(), s2.get_static_scene()
    assert_same(ss1.lights, ss2.lights)
    assert (cam1.hFov, cam1.vFov) == (cam2.hFov, cam2.vFov)
    assert np.array_equal(xf1, xf2)
    assert len(ss1.objects) == len(ss2.objects)
    for o1, o2 in zip(ss1.objects, ss2.objects):
        if isinstance(o1, st.Mesh):
            for f in ("positions", "normals", "indices"):
                assert np.array_equal(getattr(o1, f), getattr(o2, f)), f
        else:
            assert np.array_equal(o1.o, o2.o) and o1.r == o2.r


#: (edit, element kind, element index): one dynamic_scene edit each
EDITS = [
    ("flip_selected_edge", "edges", 2),
    ("split_selected_edge", "edges", 1),
    ("collapse_selected_element", "edges", 1),
    ("collapse_selected_element", "faces", 0),
    ("erase_selected_element", "edges", 1),
    ("erase_selected_element", "vertices", 4),
    ("upsample_selected_mesh", None, None),
    ("downsample_selected_mesh", None, None),
    ("resample_selected_mesh", None, None),
    ("triangulate_selection", None, None),
    ("subdivide_selection", None, None),
]


def _edit(mod, info, op, kind, index):
    scene = mod.load_from_scene_info(info)[0]
    mesh = next(o for o in scene.objects
                if o.source_node.id == "pyramid-node")
    element = (None if kind is None
               else getattr(mesh.halfedge_mesh(), kind)[index])
    scene.select(mesh, element)
    ok = getattr(scene, op)()
    return ok, mesh.mesh.vertices, mesh.mesh.polygons


@pytest.mark.parametrize("op,kind,index", EDITS,
                         ids=[f"{o}-{k}" for o, k, _ in EDITS])
def test_mesh_edit(doc_path, op, kind, index):
    ours, ref = _load_both(doc_path)
    ok, verts, polys = _edit(dynamic_scene, ours, op, kind, index)
    jok, jverts, jpolys = _edit(jax_dyn, ref, op, kind, index)
    assert ok and jok
    assert verts.dtype == jverts.dtype and np.array_equal(verts, jverts)
    assert [list(p) for p in polys] == [list(p) for p in jpolys]


@pytest.mark.parametrize("order", [None, "tiles32s"])
def test_cutracer_rays(doc_path, order):
    ours, ref = _load_both(doc_path)
    cut = dynamic_scene.load_from_scene_info(ours)[3]
    jcut = jax_dyn.load_from_scene_info(ref)[3]
    w, h, spp = 64, 40, 2
    o, d = shade.generate_camera_rays_cutracer(
        rng.fold_in(rng.PRNGKey(3), 0), w, h, spp, *cut.as_arrays(),
        pix_order=order, device="cpu")
    jo, jd = jax_shade.generate_camera_rays_cutracer(
        jax.random.fold_in(jax.random.PRNGKey(3), 0), w, h, spp,
        *jcut.as_arrays(), pix_order=order)
    assert o.shape == d.shape == (w * h * spp, 3)
    assert np.array_equal(o.numpy(), np.asarray(jo))
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                               atol=1e-7)


# -- frames through load_scene, against the JAX engine -----------------------

W, H, SPF, FRAMES = 64, 32, 2, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
BASE = dict(width=W, height=H, total_samples=SPF * FRAMES, max_depth=4,
            nee_schedule=((1, 1.0),) * 4)
VIEW = ([0.3, 1.0, 2.6], [0.0, 0.4, 0.0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py, whose fixture
    names the rounding it once guarded against (torch's CPU float32
    ``sqrt``, now ``ops.intersect.sqrt_rn`` in the plain versions):
    these frames are compared to the JAX engine's to the last bits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _render(renderer, path, frames=FRAMES):
    renderer.load_scene(path)
    for _ in range(frames):
        renderer.render()
    raw, post = renderer.get_raw_image(), renderer.get_image()
    renderer.set_viewpoint(*VIEW)
    renderer.render()
    return raw, post, renderer.get_raw_image()


@pytest.fixture(scope="module")
def jax_frames(doc_path):
    """The JAX engine's frames per camera mode (made once each)."""
    made = {}

    def get(mode):
        if mode not in made:
            kw = jax_fast(W, H, SPF * FRAMES)
            kw.update(traversal="xla", traversal_secondary="xla",
                      traversal_rr="xla", samples_per_frame=SPF)
            made[mode] = _render(
                JaxRenderer(JaxConfig(**BASE, **kw), camera_mode=mode),
                doc_path)
        return made[mode]

    return get


def port_config():
    kw = fast_preset_kwargs(W, H, SPF * FRAMES)
    kw.update(samples_per_frame=SPF)
    return RenderConfig(**BASE, **kw)


def _check(got, want, what):
    assert got.shape == (H, W, 3) and np.isfinite(got).all()
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{what}: {int(bad.sum())} of {H * W} pixels outside rtol={RTOL} "
          f"atol={ATOL}")
    assert bad.mean() <= MAX_BAD, what


@pytest.mark.parametrize("mode", ["collada", "cutracer"])
def test_frames_match_jax_engine(doc_path, jax_frames, mode):
    """Two frames of the fast preset through load_scene, then one more
    after set_viewpoint (in cutracer mode it moves the cutracer camera's
    origin and look_at)."""
    r = WavefrontRenderer(port_config(), camera_mode=mode, device="cpu")
    raw, post, moved = _render(r, doc_path)
    assert r.dropped == 0 and r.static_scene is not None
    assert r.dynamic_scene is not None and r.cutracer_camera is not None
    assert r.scene.num_lights == 3 and r.traces_per_frame == 16
    assert raw.mean() > 0.01
    ref_raw, ref_post, ref_moved = jax_frames(mode)
    _check(raw, ref_raw, f"{mode}: raw image")
    _check(post, ref_post, f"{mode}: median-filtered image")
    _check(moved, ref_moved, f"{mode}: after set_viewpoint")
    assert not np.array_equal(moved, raw)
    if mode == "cutracer":
        np.testing.assert_array_equal(r.cutracer_camera.origin, VIEW[0])


def test_camera_mode_checks(tmp_path):
    with pytest.raises(ValueError, match="camera_mode"):
        WavefrontRenderer(port_config(), camera_mode="orbit", device="cpu")
    path = tmp_path / "nocam.dae"
    path.write_text(document(camera=False))
    r = WavefrontRenderer(port_config(), camera_mode="cutracer", device="cpu")
    r.load_scene(str(path))
    assert r.cutracer_camera is None
    with pytest.raises(ValueError, match="no collada camera"):
        r.render()
