"""The shading stages' kernels (ops/csrc/shade.cu) and their dispatch, on
the CPU.

* On CPU tensors each stage of ``ops/shade_stages.py`` is its plain
  version, the same tensors as calling ``*_plain``; the kernel's wrapper
  is never reached.
* A CUDA tensor reaches the kernel's wrapper, never the plain version;
  another device is refused.  Each wrapper hands its kernel the argument
  block of each branch (pointers, row strides, flags, the light's kind,
  the folded constants), launches nothing for no lanes, counts each
  launch, and refuses what the kernel does not cover.  A library that
  fails to build raises; nothing falls back to the torch ops.
* The counters are in ``render/graphs.COUNTERS``; the stage calls of a
  frame shaded stage by stage (the CPU) are ``chip_smoke.stage_calls``'
  schedule, and a frame on the card launches no stage kernel but one
  fused gap (``shade_gap``) after each trace:
  ``chip_smoke.stage_launches``, as many as the frame's traces.
* The fused chain built for the host is held lane by lane against the
  plain stages chained the same way (``shade_gap_plain``), and to the
  bit against the stage kernels chained, on single depths of every
  sample count, light kind, sampling mode, roulette and the last depth,
  and on the small frames (``chip_smoke._probe_chain``, as phase 14
  holds it on the card); its frames are the stage kernels' to the bit.
* The kernel source built for the host (g++: the CUDA qualifiers as
  macros, one loop over lanes) is held against the plain stages on every
  branch of chip_smoke.py's phase 14 in small frames, lane by lane
  within rtol 1e-5 / atol 1e-6 (the host's libm in place of CUDA's), as
  the script holds the kernels on the card.
* The roulette that moved from run_depth into the scatter stage is
  run_depth's, bit for bit, and each stage's call must read what
  ``chip_smoke.stage_reads`` counts for its bytes bound.

The plain stages are the op chains the JAX package's stages are held
against already: at the stage level in test_torch_shade.py and
test_torch_envlight.py (every light kind, the environment's miss
radiance), at the frame level in test_torch_reference_preset.py (cosine
sampling; reference_compat's two-sided area light, shadow test and no
emission), test_torch_collada.py (point and spot lights, the mirror,
glass and refraction lobes) and the fast-preset frames of
test_torch_engine.py (the fold and the roulette).
"""

import ctypes
import dataclasses
import math
import os
import shutil
import subprocess

import numpy as np
import pytest

import torch

import chip_smoke
from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import _build
from cuda_raytracer_tpu_torch.ops import shade_stages as SS
from cuda_raytracer_tpu_torch.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu_torch.render import graphs
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from cuda_raytracer_tpu_torch.render.flatscene import (
    LIGHT_AREA, LIGHT_DIRECTIONAL, LIGHT_ENV, LIGHT_POINT, LIGHT_SPOT,
    flatten_scene)
from cuda_raytracer_tpu_torch.scene import bsdf as port_bsdf
from cuda_raytracer_tpu_torch.scene import static_scene as st
from torch_threads import _one_torch_thread  # noqa: F401

N = 4096
STAGES = ("shade_hit", "nee_prep", "nee_accum", "scatter")


def T(a):
    return torch.from_numpy(np.array(a))


def env_map():
    g = np.random.default_rng(7)
    return (0.2 + g.random((8, 16, 3))).astype(np.float32)


def lit_box():
    """The Cornell box with its mirror and glass spheres and a refractive
    one, lit by its area light, a point light, a spot light aimed at the
    floor, a directional light and an environment map (which also lights
    escaped rays)."""
    box = cornell_box_scene(with_spheres=True, sphere_bsdfs="classic")
    objects = list(box.objects) + [st.SphereObject(
        np.array([0.0, 0.9, -0.5]), 0.25,
        port_bsdf.RefractionBSDF(np.full(3, 0.9), 0.0, 1.45))]
    return st.Scene(objects, list(box.lights) + [
        st.PointLight(np.full(3, 2.0), np.array([0.5, 1.2, 0.4])),
        st.SpotLight(np.full(3, 3.0), np.array([-0.5, 1.4, 0.5]),
                     np.array([0.3, -1.0, -0.2]), 50.0),
        st.DirectionalLight(np.array([1.5, 1.4, 1.2]),
                            np.array([-0.8, -0.35, -0.3])),
        st.EnvironmentLight(env_map())])


@pytest.fixture(scope="module")
def box():
    """lit_box flattened, N rays from the camera and from inside the box
    (half of them through the open front, so some escape) traced by brute
    force, their hit records, importance, count_emission and a uniform
    pair per lane."""
    ours, _ = flatten_scene(lit_box(), tree_width=4, max_leaf_size=4,
                            device="cpu")
    g = np.random.default_rng(31)
    o = np.where(np.arange(N)[:, None] % 2 == 0, [0.0, 0.75, 2.5],
                 g.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 0.9], (N, 3)))
    tgt = g.uniform([-1.2, -0.2, -1.0], [1.2, 1.7, 3.0], (N, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    # the port's brute-force trace: its t and prim are the JAX oracle's
    # (tests/test_torch_traverse.py), at a fraction of its eager cost
    tr = trace_bruteforce(ours, T(o), T(d), torch.ones(N, dtype=torch.bool))
    t, prim = tr.t.numpy(), tr.prim.numpy()
    hp = SS.shade_hit_plain(ours, T(o), T(d), T(t), T(prim),
                            torch.ones(N, dtype=torch.bool), T(np.ones(
                                (N, 3), np.float32)), T(np.zeros(
                                    (N, 3), np.float32)),
                            torch.ones(N, dtype=torch.bool), 1e-3, True)[0]
    imp = g.uniform(0.2, 1.0, (N, 3)).astype(np.float32)
    ce = g.random(N) < 0.7
    u = g.random((N, 2)).astype(np.float32)
    return dict(ours=ours, o=o, d=d, t=t, prim=prim, hp=hp, imp=imp, ce=ce,
                u=u)


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------


def stage_args(b, stage):
    """The arguments of one call of ``stage`` on the box's lanes."""
    ours, hp = b["ours"], b["hp"]
    imp = T(b["imp"])
    if stage == "shade_hit":
        return (ours, T(b["o"]), T(b["d"]), T(b["t"]), T(b["prim"]),
                torch.ones(N, dtype=torch.bool), imp,
                torch.full((N, 3), 0.25), T(b["ce"]), 1e-3, False)
    if stage == "nee_prep":
        return (ours, hp, imp, 0, T(b["u"]), 1.0, False)
    if stage == "nee_accum":
        g = np.random.default_rng(5)
        return (torch.full((N, 3), 0.5), T(g.uniform(0, 3, N)
                                           .astype(np.float32)),
                T(g.integers(-1, 20, N).astype(np.int32)),
                T(g.uniform(0, 3, N).astype(np.float32)), imp,
                T(g.random(N) < 0.5), 1e-3, True)
    key = rng.fold_in(rng.PRNGKey(9), 2001)
    return (ours, hp, imp, rng.split(key), None, False, rng.fold_in(key, 3),
            1e-3, "uniform")


@pytest.mark.parametrize("stage", STAGES)
def test_cpu_stage_is_the_plain_version(box, stage, monkeypatch):
    def kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran for CPU tensors")

    monkeypatch.setattr(SS, f"{stage}_cuda", kernel)
    args = stage_args(box, stage)
    got = getattr(SS, stage)(*args)
    want = getattr(SS, f"{stage}_plain")(*args)
    got, want = chip_smoke._tensors(got), chip_smoke._tensors(want)
    assert len(got) == len(want) > 0
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


class _OnCard:
    """Stands in for a CUDA tensor where a stage reads only the device."""
    device = torch.device("cuda", 0)


@pytest.mark.parametrize("stage", STAGES)
def test_cuda_tensor_goes_to_the_kernel(box, stage, monkeypatch):
    """A CUDA tensor never reaches the plain version: the stage calls its
    kernel's wrapper (which launches or raises) with its own arguments.
    Other devices are refused."""
    seen = []

    def kernel(*args):
        seen.append(args)
        return "launched"

    def plain(*a, **k):
        raise AssertionError("the plain version ran for a CUDA tensor")

    monkeypatch.setattr(SS, f"{stage}_cuda", kernel)
    monkeypatch.setattr(SS, f"{stage}_plain", plain)
    args = list(stage_args(box, stage))
    # the argument whose device decides: importance, or nee_accum's light
    at = {"shade_hit": 6, "nee_prep": 2, "nee_accum": 0, "scatter": 2}[stage]
    args[at] = _OnCard()
    assert getattr(SS, stage)(*args) == "launched"
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0], args))
    args[at] = torch.empty((N, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        getattr(SS, stage)(*args)


@pytest.fixture
def launches(monkeypatch):
    """The wrappers on CPU tensors with the launch recorded instead of
    made: (kernel name, its argument block) per launch."""
    out = []

    def launch(name, args, dev):
        if args.n == 0:
            return False
        out.append((name, args))
        return True

    monkeypatch.setattr(SS, "_device", lambda x: x.device)
    monkeypatch.setattr(SS, "_launch", launch)
    return out


def test_shade_hit_arguments(box, launches):
    """shade_hit's block: the camera's stride-0 origin, a packed path
    state's importance (row stride 16), the prim table, the flags of
    each branch, the outputs."""
    ours = box["ours"]
    o = torch.tensor([0.0, 0.75, 2.5]).expand(N, 3)
    packed = torch.zeros((N, 16))
    imp = packed[:, 8:11]
    before = SS.shade_hit_launches
    args = (ours, o, T(box["d"]), T(box["t"]), T(box["prim"]),
            torch.ones(N, dtype=torch.bool), imp, torch.zeros((N, 3)),
            T(box["ce"]), 1e-3)
    hit, light = SS.shade_hit_cuda(*args, False)
    (name, a), = launches
    assert name == "shade_hit" and a.n == N
    assert (a.o, a.o_stride) == (o.data_ptr(), 0)
    assert (a.importance, a.imp_stride) == (imp.data_ptr(), 16)
    assert a.shade_packed == ours.shade_packed.data_ptr()
    assert a.num_prims == ours.num_prims
    assert (a.emission, a.has_env) == (1, 1) and ours.has_env
    assert (a.env_h, a.env_w) == (8, 16)
    assert a.origin_eps == np.float32(1e-3)
    assert a.pt == hit.pt.data_ptr() and a.light_out == light.data_ptr()
    assert hit.bsdf.dtype == torch.int64 and hit.valid.dtype == torch.bool
    # reference_compat: no emission, light returned as it is
    hit, light2 = SS.shade_hit_cuda(*args, True)
    assert launches[-1][1].emission == 0 and light2 is args[7]
    assert SS.shade_hit_launches == before + 2


@pytest.mark.parametrize("kind", [LIGHT_AREA, LIGHT_POINT, LIGHT_SPOT,
                                  LIGHT_ENV],
                         ids=["area", "point", "spot", "environment"])
@pytest.mark.parametrize("two_sided", [False, True])
def test_nee_prep_arguments(box, launches, kind, two_sided):
    ours, hp = box["ours"], box["hp"]
    li = list(ours.light_kinds).index(kind)
    u = T(box["u"])
    o, wi, max_t, lo, ok = SS.nee_prep_cuda(ours, hp, T(box["imp"]), li, u,
                                            0.5, two_sided)
    (name, a), = launches
    assert name == "nee_prep" and (a.kind, a.light) == (kind, li)
    assert a.two_sided == int(two_sided and kind == LIGHT_AREA)
    assert a.weight == 0.5 and (a.u, a.u_stride) == (u.data_ptr(), 2)
    assert o is hp.pt and a.wi == wi.data_ptr() and a.ok == ok.data_ptr()
    assert a.light_area == ours.light_area.data_ptr()
    if kind == LIGHT_ENV:
        h, w = ours.env_map.shape[:2]
        assert (a.env_h, a.env_w) == (h, w)
        assert a.env_cdf == ours.env_cdf.data_ptr()
        # folded in double as sample_light folds its Python constant
        assert a.env_solid == np.float32((2 * math.pi / w) * (math.pi / h))


@pytest.mark.parametrize("compat", [False, True])
def test_nee_accum_arguments(box, launches, compat):
    args = list(stage_args(box, "nee_accum"))
    out = SS.nee_accum_cuda(*args[:7], compat)
    (name, a), = launches
    assert name == "nee_accum" and a.reference_compat == int(compat)
    assert a.prim_s == args[2].data_ptr()
    assert a.shadow_eps == np.float32(1e-3)
    assert a.light_out == out.data_ptr() and out is not args[0]
    # the traversals' prim is int32; another type is refused
    args[2] = args[2].long()
    with pytest.raises(ValueError, match="prim_s"):
        SS.nee_accum_cuda(*args[:7], compat)


@pytest.mark.parametrize("case", ["per-lane uniform", "cosine", "fold",
                                  "fold + roulette"])
def test_scatter_arguments(box, launches, case, monkeypatch):
    """scatter's draws are the plain version's (the same keys and shapes,
    hemisphere, Fresnel, roulette), then one launch in the branch's
    mode."""
    ours, hp = box["ours"], box["hp"]
    key = rng.fold_in(rng.PRNGKey(9), 2001)
    keys, rr = rng.split(key), rng.fold_in(key, 3)
    fold = case.startswith("fold")
    u = T(box["u"]) if fold else None
    drawn, draw = [], rng.uniform

    def record(k, shape, device, repeat=1):
        out = draw(k, shape, device, repeat)
        drawn.append((k, tuple(shape), out))
        return out

    monkeypatch.setattr(rng, "uniform", record)
    SS.scatter_cuda(ours, hp, T(box["imp"]), keys, u, fold,
                    rr if case in ("fold + roulette", "cosine") else None,
                    1e-3, "cosine" if case == "cosine" else "uniform")
    (name, a), = launches
    assert name == "scatter"
    assert a.mode == {"per-lane uniform": 0, "cosine": 1}.get(case, 2)
    want = ([] if fold else [(keys[0], (N, 2))]) + [(keys[1], (N,))]
    if case in ("fold + roulette", "cosine"):
        want.append((rr, (N,)))
    assert [(k, s) for k, s, _ in drawn] == want
    assert a.u == (u.data_ptr() if fold else drawn[0][2].data_ptr())
    assert a.u_fresnel == drawn[0 if fold else 1][2].data_ptr()
    assert bool(a.u_rr) == (want[-1][0] == rr)


def test_wrappers_refuse_what_the_kernels_do_not_cover(box, launches):
    ours, hp = box["ours"], box["hp"]
    imp = T(box["imp"])
    keys = rng.split(rng.PRNGKey(1))
    with pytest.raises(ValueError, match="hemisphere sampling"):
        SS.scatter_cuda(ours, hp, imp, keys, None, False, None, 1e-3,
                        "stratified")
    with pytest.raises(ValueError, match="fold"):
        SS.scatter_cuda(ours, hp, imp, keys, T(box["u"]), True, None, 1e-3,
                        "cosine")
    with pytest.raises(ValueError, match="importance"):
        SS.nee_prep_cuda(ours, hp, imp.double(), 0, T(box["u"]), 1.0)
    with pytest.raises(ValueError, match="importance"):
        SS.nee_prep_cuda(ours, hp, imp.t().contiguous().t(), 0, T(box["u"]),
                         1.0)
    lying = dataclasses.replace(
        ours, light_kinds=(7,) + tuple(ours.light_kinds[1:]))
    with pytest.raises(ValueError, match="light kind 7"):
        SS.nee_prep_cuda(lying, hp, imp, 0, T(box["u"]), 1.0)
    assert launches == []


def test_no_lanes_no_launch(launches):
    before = SS.nee_accum_launches
    out = SS.nee_accum_cuda(torch.zeros((0, 3)), torch.zeros(0),
                            torch.zeros(0, dtype=torch.int32),
                            torch.zeros(0), torch.zeros((0, 3)),
                            torch.zeros(0, dtype=torch.bool), 1e-3, False)
    assert out.shape == (0, 3) and launches == []
    assert SS.nee_accum_launches == before


def test_a_library_that_fails_to_build_raises(box, monkeypatch):
    """No fallback: a stage whose kernel cannot be built raises, and the
    plain version never runs."""
    def nvcc_fails(name, defines=()):
        raise RuntimeError(f"nvcc failed building {name}.cu")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", nvcc_fails)
    monkeypatch.setattr(SS, "_lib", None)
    monkeypatch.setattr(SS, "_on", lambda x: "cuda")
    monkeypatch.setattr(SS, "_device", lambda x: x.device)
    monkeypatch.setattr(SS, "nee_accum_plain", plain)
    with pytest.raises(RuntimeError, match="nvcc failed building shade"):
        SS.nee_accum(*stage_args(box, "nee_accum"))


def test_counters_join_the_graphs():
    """Every shading kernel's counter is in the graphs' and chip_smoke's
    tables; the shipped preset's frame launches the chain's variants
    of one sample and light a depth, no stage kernel (chip_smoke's
    OFF_PATH, which phase 14 drives)."""
    for stage in STAGES:
        assert (SS, f"{stage}_launches") in graphs.COUNTERS
        assert chip_smoke.COUNTERS[stage] == ("shade_stages",
                                              f"{stage}_launches")
        assert stage in chip_smoke.OFF_PATH
    assert chip_smoke.GAP_VARIANTS == SS.GAPS
    on_path = {g for g, v in chip_smoke.gap_schedule(
        chip_smoke.fast_config(), 1).items() if v}
    assert on_path == {"open_nee", "open_nee_store", "close_scatter",
                       "close_stored"}
    for g in SS.GAPS:
        assert (SS, f"{g}_launches") in graphs.COUNTERS
        assert chip_smoke.COUNTERS[f"gap_{g}"] == ("shade_stages",
                                                   f"{g}_launches")
        assert (f"gap_{g}" in chip_smoke.OFF_PATH) == (g not in on_path)


W, H, SPF = 32, 16, 2


def _fast(**over):
    kw = fast_preset_kwargs(W, H, 4 * SPF)
    kw.update(samples_per_frame=SPF, **over)
    return RenderConfig(width=W, height=H, total_samples=4 * SPF,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


def _reference(**over):
    return RenderConfig(width=W, height=H, total_samples=SPF,
                        samples_per_frame=SPF, **over)


def _terrain():
    scene = terrain_scene(n=8)
    return st.Scene(scene.objects, [scene.lights[0],
                                    st.InfiniteHemisphereLight(
                                        [0.5, 0.55, 0.6])])


VIEW_A = ([0, 0.75, 2.5], [0, 0.75, 0])
VIEW_B = ([0, 1.3, 1.3], [0, 0, 0])
#: small frames: (config, scene, viewpoint); every case but
#: compact_depths is probed, and between them they reach every branch
#: of chip_smoke.SHADE_BRANCHES and every lobe
FRAMES = {
    # fold, fold + roulette, the area light, the emitter
    "fast": (_fast, lambda: cornell_box_scene(with_spheres=True), VIEW_A),
    "compact_depths": (lambda: _fast(compact_depths=True, fuse_frame="yes"),
                       lambda: cornell_box_scene(with_spheres=True), VIEW_A),
    # uniform, the point, spot, directional and environment lights, the
    # environment's miss radiance, the mirror, glass and refraction lobes
    "all lights": (_reference, lit_box, VIEW_A),
    # no emission, the two-sided area light, the shadow test's
    # prim_s >= 0, cosine sampling
    "reference_compat, cosine": (
        lambda: _reference(reference_compat=True,
                           hemisphere_sampling="cosine"),
        lambda: cornell_box_scene(with_spheres=True), VIEW_A),
    # interpolated vertex normals, the hemisphere light
    "terrain": (lambda: _reference(max_leaf_size=4), _terrain, VIEW_B),
    # depths with no NEE sample: one that scatters, the last that does
    # not
    "short schedule": (lambda: _reference(nee_schedule=((1, 1.0),)),
                       lambda: cornell_box_scene(with_spheres=True), VIEW_A),
}


def _renderer(case):
    cfg, scene, view = FRAMES[case]
    r = WavefrontRenderer(cfg(), camera_mode="collada", device="cpu")
    r.load_static_scene(scene())
    r.set_viewpoint(*view)
    return r


@pytest.mark.parametrize("case", ["fast", "compact_depths", "all lights"])
def test_stage_calls_per_frame_are_the_schedule(case, monkeypatch):
    r = _renderer(case)
    calls = dict.fromkeys(STAGES, 0)
    for stage in STAGES:
        fn = getattr(SS, stage)

        def counted(*a, _fn=fn, _stage=stage, **k):
            calls[_stage] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(SS, stage, counted)
    r.render()
    assert calls == chip_smoke.stage_calls(r.config, r.scene.num_lights)
    assert all(calls.values())


# ---------------------------------------------------------------------------
# the kernel source, built for the host, against the plain stages
# ---------------------------------------------------------------------------

#: the CUDA qualifiers and intrinsics shade.cu uses, for g++, and
#: rt_common.cuh's NaN-propagating min and max
_HOST_PRELUDE = r'''
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __ldg(p) (*(p))
struct Dim { unsigned x; };
static Dim blockIdx, threadIdx;
static inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
#define T_NO_LIMIT 1e30f
static inline float nan_min(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fminf(a, b); }
static inline float nan_max(float a, float b) {
  return (a != a || b != b) ? __int_as_float(0x7fc00000) : fmaxf(a, b); }
'''


def _host_source():
    """shade.cu's kernels as host C++: the source up to its C interface,
    each kernel run by a loop over the lanes behind the same C names."""
    with open(_build.source_path("shade")) as f:
        src = f.read()
    cut = src.index("// C interface")
    src = src[:cut].replace('#include "rt_common.cuh"', "").replace(
        "#include <cuda_runtime.h>", "")
    loops = "".join(
        f'extern "C" int {k}(const {a}* p, void* s) {{\n'
        f"  for (long long i = 0; i < p->n; ++i) {{\n"
        f"    blockIdx.x = (unsigned)(i / SBLOCK);\n"
        f"    threadIdx.x = (unsigned)(i % SBLOCK);\n"
        f"    {k}_kernel(*p);\n  }}\n  return 0;\n}}\n"
        for k, a in (("shade_hit", "ShadeHitArgs"), ("nee_prep", "NeePrepArgs"),
                     ("nee_accum", "NeeAccumArgs"), ("scatter", "ScatterArgs")))
    gaps = ('#define HOST_GAP(v, f, k) case v: k<f>(*p); break;\n'
            'extern "C" int shade_gap(const GapArgs* p, void* s) {\n'
            "  for (long long i = 0; i < p->n; ++i) {\n"
            "    blockIdx.x = (unsigned)(i / SBLOCK);\n"
            "    threadIdx.x = (unsigned)(i % SBLOCK);\n"
            "    switch (p->variant) { GAP_VARIANTS(HOST_GAP) default: "
            "return -1; }\n  }\n  return 0;\n}\n")
    sizes = ('extern "C" long long shade_args_size(int w) {\n'
             "  return w == 0 ? sizeof(ShadeHitArgs) : w == 1 ? "
             "sizeof(NeePrepArgs) : w == 2 ? sizeof(NeeAccumArgs) : "
             "w == 3 ? sizeof(ScatterArgs) : sizeof(GapArgs);\n}\n")
    return _HOST_PRELUDE + src + loops + gaps + sizes


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    """shade.cu built by g++ as a host library (no FMA contraction, no
    fast math), loaded as the wrappers load the card's."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel source for the host")
    d = tmp_path_factory.mktemp("shade_host")
    cpp, so = os.path.join(d, "shade_host.cpp"), os.path.join(d, "shade.so")
    with open(cpp, "w") as f:
        f.write(_host_source())
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", so, cpp], check=True)
    lib = ctypes.CDLL(so)
    lib.shade_args_size.restype = ctypes.c_longlong
    for which, args in enumerate(SS._ARGS):
        assert lib.shade_args_size(which) == ctypes.sizeof(args)
    return lib


@pytest.fixture(scope="module")
def probed(host_kernels):
    """Every stage call of one small frame per case but compact_depths
    (which reaches no branch the fast frame does not), the host-built
    kernel against the plain version on the same inputs
    (chip_smoke._probe_stages); the frame is shaded by the kernel."""
    mp = pytest.MonkeyPatch()

    def launch(name, args, dev):
        if args.n == 0:
            return False
        assert getattr(host_kernels, name)(ctypes.byref(args), None) == 0
        return True

    mp.setattr(SS, "_device", lambda x: x.device)
    mp.setattr(SS, "_launch", launch)
    log, lobes, frames = {}, set(), {}
    try:
        for case in (c for c in FRAMES if c != "compact_depths"):
            r = _renderer(case)
            with chip_smoke._probe_stages(log, None, lobes):
                r.render()
            frames[case] = r.get_raw_image()
    finally:
        mp.undo()
    return log, lobes, frames


@pytest.mark.parametrize("stage", STAGES)
def test_host_built_kernel_matches_the_plain_stage(probed, stage):
    log, lobes, _ = probed
    entries = {b: e for (s, b), e in log.items() if s == stage}
    assert chip_smoke.SHADE_BRANCHES[stage] <= set(entries)
    for branch, e in entries.items():
        assert e["far"] == 0, (branch, e)
        assert e["lanes"] > 0
    if stage == "scatter":
        assert chip_smoke.SHADE_LOBES <= lobes


@pytest.mark.parametrize("case", ["fast", "all lights"])
def test_host_built_kernels_shade_the_plain_frame(probed, case):
    """A frame shaded by the host-built kernels (launch by launch, the
    probe held each) against the same frame shaded by the plain stages:
    per pixel within the card-vs-CPU gate."""
    got = probed[2][case]
    r = _renderer(case)
    r.render()
    want = r.get_raw_image()
    bad = ~np.isclose(got, want, rtol=chip_smoke.PIXEL_RTOL,
                      atol=chip_smoke.PIXEL_ATOL).all(-1)
    assert float(bad.mean()) <= chip_smoke.MAX_BAD
    assert np.isfinite(got).all() and float(got.mean()) > 0


# ---------------------------------------------------------------------------
# the roulette in the scatter stage, and what each stage's call must read
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("hs,fold", [("uniform", True), ("uniform", False),
                                     ("cosine", False)],
                         ids=["fold", "uniform", "cosine"])
def test_scatter_stage_roulette_is_run_depths(box, hs, fold):
    """The roulette that moved into the scatter stage is the one
    run_depth ran after it, bit for bit: p = clamp(max importance, 0.05,
    1) from the stage's importance, u_rr from the depth's roulette key,
    valid &= u_rr < p, importance / p."""
    ours, hp = box["ours"], box["hp"]
    key = rng.fold_in(rng.PRNGKey(9), 2001)
    keys, rr = rng.split(key), rng.fold_in(key, 3)
    u = T(box["u"]) if fold else None
    args = (ours, hp, T(box["imp"]), keys)
    o, d, imp, valid, ce = SS.scatter(*args, u, fold, None, 1e-3, hs)
    p = torch.clamp(imp.amax(-1), 0.05, 1.0)
    u_rr = rng.uniform(rr, tuple(p.shape), p.device)
    want = (o, d, imp / p[:, None], valid & (u_rr < p), ce)
    got = SS.scatter(*args, u, fold, rr, 1e-3, hs)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    assert 0 < int(got[3].sum()) < int(valid.sum())


def _reads(stage, ak, out=None):
    """What the stage's call must read, from its plain version's
    outputs on CPU tensors."""
    if out is None:
        out = getattr(SS, f"{stage}_plain")(*ak)
    return chip_smoke.stage_reads(stage, ak, out)


def _lanes_of(reads, x):
    """The lanes of x a stage's call reads (None: all), or False where
    it reads none of x."""
    got = [lanes for t, lanes in reads if t is x]
    assert len(got) <= 1
    return got[0] if got else False


def _same(lanes, want):
    return lanes is None and want is None or (
        lanes is not None and want is not None and torch.equal(lanes, want))


@pytest.mark.parametrize("case", ["emission + env miss", "no env",
                                  "reference_compat"])
def test_shade_hit_reads_what_the_data_needs(box, case):
    """shade_hit's bytes bound: valid only for the environment's miss
    test, importance and count_emission only on the lanes that add
    emission, nothing of them under reference_compat, t on the lanes that
    hit, one shade_packed row per prim hit."""
    args = list(stage_args(box, "shade_hit"))
    if case == "no env":
        args[0] = dataclasses.replace(args[0], has_env=False)
    args[10] = case == "reference_compat"
    o, d, t, prim, valid, imp, light, ce = args[1:9]
    reads = _reads("shade_hit", tuple(args))
    hit = prim >= 0
    assert _same(_lanes_of(reads, t), hit)
    assert _same(_lanes_of(reads, o), None) and _same(_lanes_of(reads, d),
                                                      None)
    rows = _lanes_of(reads, args[0].shade_packed)
    assert int(rows.sum()) == torch.unique(prim[hit]).numel()
    if case == "reference_compat":
        assert all(_lanes_of(reads, x) is False for x in (valid, imp, light,
                                                          ce))
        return
    rec = SS.shade_hit_plain(*args)[0]
    emitter = hit & (args[0].bsdf_fn[rec.bsdf] == port_bsdf.BSDF_EMISSION)
    assert int(emitter.sum()) > 0
    miss = ~hit & valid if case != "no env" else torch.zeros_like(hit)
    assert _same(_lanes_of(reads, ce), emitter | miss)
    assert _same(_lanes_of(reads, imp), (emitter | miss) & ce)
    assert _same(_lanes_of(reads, light), None)
    if case == "no env":
        assert _lanes_of(reads, valid) is False
    else:
        assert _same(_lanes_of(reads, valid), ~hit) and int(miss.sum()) > 0


@pytest.mark.parametrize("kind", [LIGHT_AREA, LIGHT_POINT, LIGHT_DIRECTIONAL],
                         ids=["area", "point", "directional"])
def test_nee_prep_reads_what_the_data_needs(box, kind):
    """nee_prep's: importance on the lanes whose sample counts (ok), the
    uniforms only for a light that samples them, the hit point only for
    a light at a finite distance."""
    ours, hp = box["ours"], box["hp"]
    li = list(ours.light_kinds).index(kind)
    args = (ours, hp, T(box["imp"]), li, T(box["u"]), 1.0, False)
    reads = _reads("nee_prep", args)
    ok = SS.nee_prep_plain(*args)[4]
    assert _same(_lanes_of(reads, args[2]), ok) and int(ok.sum()) > 0
    assert (_lanes_of(reads, args[4]) is False) == (kind != LIGHT_AREA)
    assert (_lanes_of(reads, hp.pt) is False) == (kind == LIGHT_DIRECTIONAL)
    assert _same(_lanes_of(reads, hp.bsdf), hp.valid)


@pytest.mark.parametrize("compat", [False, True])
def test_nee_accum_reads_what_the_data_needs(box, compat):
    """nee_accum's: t_s and max_t where the sample counts, prim_s (under
    reference_compat) where the distance test passes, the sample's light
    where both do."""
    args = list(stage_args(box, "nee_accum"))
    args[7] = compat
    light, t_s, prim_s, max_t, li, ok = args[:6]
    reads = _reads("nee_accum", tuple(args))
    passes = ok & (t_s > max_t - 1e-3)
    assert _same(_lanes_of(reads, t_s), ok)
    assert _same(_lanes_of(reads, prim_s), passes) if compat else (
        _lanes_of(reads, prim_s) is False)
    want = passes & (prim_s >= 0) if compat else passes
    assert _same(_lanes_of(reads, li), want) and 0 < int(want.sum()) < N


@pytest.mark.parametrize("fold", [True, False], ids=["fold", "uniform"])
def test_scatter_reads_what_the_data_needs(box, fold):
    """scatter's: the frame (dpdu, dpdv) off the diffuse lanes where the
    fold needs none there, wo_local off them, the Fresnel uniform on the
    glass lanes, the roulette's where the path lives on."""
    ours, hp = box["ours"], box["hp"]
    key = rng.fold_in(rng.PRNGKey(9), 2001)
    keys, rr = rng.split(key), rng.fold_in(key, 3)
    u0 = T(box["u"]) if fold else None
    imp = T(box["imp"])
    out = SS.scatter_plain(ours, hp, imp, keys, u0, fold, rr, 1e-3,
                           "uniform")
    u, u_f, u_rr = SS.scatter_draws(keys, u0, rr, N, "cpu")
    args = (ours, hp, imp, u, u_f, u_rr, fold, 1e-3, "uniform")
    reads = _reads("scatter", args, out)
    fn = ours.bsdf_fn[hp.bsdf]
    diffuse = fn == port_bsdf.BSDF_DIFFUSE
    assert 0 < int(diffuse.sum()) < N
    assert _same(_lanes_of(reads, hp.dpdu), ~diffuse if fold else None)
    assert _same(_lanes_of(reads, hp.wo_local), ~diffuse)
    assert _same(_lanes_of(reads, u), diffuse)
    assert _same(_lanes_of(reads, u_f), (fn == port_bsdf.BSDF_GLASS)
                 | (fn == port_bsdf.BSDF_EMISSION))
    emit = fn == port_bsdf.BSDF_EMISSION
    lives = hp.valid & ~emit & (out[2].amax(-1) > 0)
    assert _same(_lanes_of(reads, u_rr), lives)
    assert int(out[3].sum()) < int(lives.sum())


# ---------------------------------------------------------------------------
# the fused chain: one kernel after each trace of a depth
# ---------------------------------------------------------------------------


def _gap_kw(**kw):
    return dict(dict(opened=None, accum=None, sample=None, store=False,
                     scatter=None, origin_eps=1e-3, shadow_eps=1e-3,
                     reference_compat=False, hemisphere_sampling="uniform"),
                **kw)


def _gap_args(b):
    return (b["ours"], T(b["o"]), T(b["d"]), T(b["t"]), T(b["prim"]),
            T(b["imp"]), torch.full((N, 3), 0.25))


def test_cpu_gap_is_the_plain_chain(box, monkeypatch):
    def kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran for CPU tensors")

    monkeypatch.setattr(SS, "shade_gap_cuda", kernel)
    args = _gap_args(box)
    kw = _gap_kw(opened=(torch.ones(N, dtype=torch.bool), T(box["ce"])),
                 sample=SS.Nee(0, T(box["u"]), 1.0))
    got = chip_smoke._tensors(SS.shade_gap(*args, **kw))
    want = chip_smoke._tensors(SS.shade_gap_plain(*args, **kw))
    assert len(got) == len(want) == 5
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not SS.chained(args[5])


def test_cuda_gap_goes_to_the_kernel(box, monkeypatch):
    seen = []

    def kernel(*args, **kw):
        seen.append((args, kw))
        return "launched"

    def plain(*a, **k):
        raise AssertionError("the plain chain ran for a CUDA tensor")

    monkeypatch.setattr(SS, "shade_gap_cuda", kernel)
    monkeypatch.setattr(SS, "shade_gap_plain", plain)
    args = list(_gap_args(box))
    args[5] = _OnCard()
    kw = _gap_kw(sample=SS.Nee(0, T(box["u"]), 1.0))
    assert SS.chained(args[5])
    assert SS.shade_gap(*args, **kw) == "launched"
    assert len(seen) == 1 and all(a is b for a, b in zip(seen[0][0], args))
    assert seen[0][1] == kw
    args[5] = torch.empty((N, 3), device="meta")
    with pytest.raises(ValueError, match="device"):
        SS.shade_gap(*args, **kw)


def _shadow(stored=False):
    z = torch.zeros((N, 3))
    return SS.Shadow(z, z, torch.zeros(N), torch.zeros(N, dtype=torch.bool),
                     z if stored else None)


def test_gap_variants_are_the_kernels():
    """gap_variant names what each gap does, refuses what no gap does, and
    its names are GAP_VARIANTS of shade.cu, in order: the flags of each,
    and the word of the stage it opens in its kernel's name."""
    acc = (SS.Nee(0, None, 1.0), _shadow(), None, None)
    stored = (SS.Nee(0, None, 1.0), _shadow(True), None, None)
    cases = {
        "open_nee": (True, None, True, False, False),
        "open_nee_store": (True, None, True, True, False),
        "open_scatter": (True, None, False, False, True),
        "open": (True, None, False, False, False),
        "step": (False, acc, True, False, False),
        "step_store": (False, acc, True, True, False),
        "close_scatter": (False, acc, False, False, True),
        "close_stored": (False, stored, False, False, False),
    }
    assert tuple(cases) == SS.GAPS
    for name, c in cases.items():
        assert SS.gap_variant(*c) == name
    for bad in ((False, None, True, False, False),
                (True, acc, True, False, False),
                (True, None, True, False, True),
                (False, stored, True, False, False),
                (False, stored, False, False, True),
                (True, None, False, True, True),
                (False, acc, False, False, False)):
        with pytest.raises(ValueError):
            SS.gap_variant(*bad)
    with open(_build.source_path("shade")) as f:
        src = f.read()
    rows = [line.strip().rstrip("\\").strip()
            for line in src.splitlines()
            if line.strip().startswith("X(")]
    assert len(rows) == len(SS.GAPS)
    for i, (name, row) in enumerate(zip(SS.GAPS, rows)):
        index, flags, kernel = (x.strip() for x in row[2:-1].split(","))
        flags = set(f.strip() for f in flags.split("|"))
        assert int(index) == i
        assert ("G_OPEN" in flags) == name.startswith("open") == (
            kernel == "shade_hit_kernel")
        assert kernel in ("shade_hit_kernel", "nee_accum_kernel")
        assert ("G_SAMPLE" in flags) == name.startswith(("open_nee", "step"))
        assert ("G_STORE" in flags) == name.endswith("_store")
        assert ("G_SCATTER" in flags) == name.endswith("scatter")
        assert ("G_STORED" in flags) == (name == "close_stored")
        assert ("G_ACCUM" in flags) == (not name.startswith("open"))


def test_gap_arguments(box, launches):
    """A depth's gaps on the card: the camera's stride-0 origin and a
    packed path state's importance (row stride 16), the variant, the
    flags, the samples' lights and uniforms, the shadow ray written by
    the first gap and its origin kept by the next, the stored li read
    back, scatter's draws and outputs; one launch each, counted by
    variant."""
    ours = box["ours"]
    o = torch.tensor([0.0, 0.75, 2.5]).expand(N, 3)
    packed = torch.zeros((N, 16))
    imp = packed[:, 8:11]
    args = (ours, o, T(box["d"]), T(box["t"]), T(box["prim"]), imp,
            torch.zeros((N, 3)))
    before = {g: getattr(SS, f"{g}_launches") for g in SS.GAPS}
    u0, u1 = T(box["u"]), T(box["u"][::-1].copy())
    area = list(ours.light_kinds).index(LIGHT_AREA)
    env = list(ours.light_kinds).index(LIGHT_ENV)
    nee0, nee1 = SS.Nee(area, u0, 0.5), SS.Nee(env, u1, 0.5)
    valid, ce = torch.ones(N, dtype=torch.bool), T(box["ce"])
    light, sh0, path = SS.shade_gap_cuda(
        *args, **_gap_kw(opened=(valid, ce), sample=nee0))
    (name, a), = launches
    assert name == "shade_gap" and a.variant == SS.GAPS.index("open_nee")
    assert (a.o, a.o_stride) == (o.data_ptr(), 0)
    assert (a.importance, a.imp_stride) == (imp.data_ptr(), 16)
    assert (a.emission, a.has_env, a.reference_compat) == (1, 1, 0)
    assert a.valid == valid.data_ptr() and a.count_emission == ce.data_ptr()
    assert (a.smp.light, a.smp.kind, a.smp.two_sided) == (area, LIGHT_AREA,
                                                          0)
    assert (a.smp.u, a.smp.u_stride, a.smp.weight) == (u0.data_ptr(), 2, 0.5)
    assert a.light_out == light.data_ptr() and path is None
    assert [a.s_o, a.s_d, a.s_max_t, a.s_ok] == [
        x.data_ptr() for x in sh0[:4]]
    assert sh0.li is None and not a.s_li
    assert a.env_solid == np.float32((2 * math.pi / 16) * (math.pi / 8))
    t_s, prim_s = T(box["t"]), T(box["prim"])
    light2, sh1, _ = SS.shade_gap_cuda(
        *args[:6], light, **_gap_kw(accum=(nee0, sh0, t_s, prim_s),
                                    sample=nee1, store=True))
    a = launches[-1][1]
    assert a.variant == SS.GAPS.index("step_store")
    assert (a.acc.light, a.acc.kind, a.acc.u) == (area, LIGHT_AREA,
                                                  u0.data_ptr())
    assert (a.smp.light, a.smp.kind, a.smp.u) == (env, LIGHT_ENV,
                                                  u1.data_ptr())
    assert (a.t_s, a.prim_s) == (t_s.data_ptr(), prim_s.data_ptr())
    assert a.light == light.data_ptr() and a.light_out == light2.data_ptr()
    # the depth's shadow rays share the first one's origin
    assert sh1.o is sh0.o and not a.s_o and a.s_li == sh1.li.data_ptr()
    light3, sh, _ = SS.shade_gap_cuda(
        *args[:6], light2, **_gap_kw(accum=(nee1, sh1, t_s, prim_s),
                                     reference_compat=True))
    a = launches[-1][1]
    assert a.variant == SS.GAPS.index("close_stored") and sh is None
    assert (a.li, a.li_stride) == (sh1.li.data_ptr(), 3)
    assert (a.max_t, a.ok) == (sh1.max_t.data_ptr(), sh1.ok.data_ptr())
    assert not a.o and not a.acc.u and a.reference_compat == 1
    keys = rng.split(rng.fold_in(rng.PRNGKey(9), 2001))
    rr = rng.fold_in(rng.PRNGKey(9), 3001)
    light4, _, path = SS.shade_gap_cuda(
        *args[:6], light3, **_gap_kw(
            accum=(nee0, sh0, t_s, prim_s), scatter=(keys, u1, True, rr)))
    a = launches[-1][1]
    assert a.variant == SS.GAPS.index("close_scatter") and a.mode == 2
    assert (a.u, a.u_stride) == (u1.data_ptr(), 2) and a.u_fresnel
    assert a.u_rr and [a.o_out, a.d_out, a.imp_out, a.valid_out,
                       a.ce_out] == [x.data_ptr() for x in path]
    # reference_compat: no emission, light as it is, the two-sided area
    light5, _, _ = SS.shade_gap_cuda(
        *args, **_gap_kw(opened=(valid, ce), sample=nee0,
                         reference_compat=True))
    a = launches[-1][1]
    assert (a.emission, a.has_env, a.smp.two_sided) == (0, 0, 1)
    assert light5 is args[6] and not a.light_out
    after = {g: getattr(SS, f"{g}_launches") for g in SS.GAPS}
    assert {g: after[g] - before[g] for g in SS.GAPS if after[g] != before[g]
            } == {"open_nee": 2, "step_store": 1, "close_stored": 1,
                  "close_scatter": 1}
    with pytest.raises(ValueError, match="fold"):
        SS.shade_gap_cuda(*args[:6], light3, **_gap_kw(
            accum=(nee0, sh0, t_s, prim_s), scatter=(keys, u1, True, rr),
            hemisphere_sampling="cosine"))
    assert len(launches) == 5


def _flat_scene(scene):
    return flatten_scene(scene, tree_width=4, max_leaf_size=4,
                         device="cpu")[0]


def _three_lights():
    """The lit box under its area light, the directional light and the
    environment map alone."""
    box_ = lit_box()
    keep = (st.AreaLight, st.DirectionalLight, st.EnvironmentLight)
    lights = [x for x in box_.lights if isinstance(x, keep)]
    assert len(lights) == 3
    return st.Scene(box_.objects, lights)


def _cfg(make, **over):
    return make().replace(**over) if over else make()


#: single depths of the fused chain on the box's rays: (config, scene,
#: depth, packed importance rows, the variants its gaps are)
CHAIN_CASES = {
    "S=0, fold + roulette": (
        lambda: _cfg(_fast, nee_schedule=((0, 0.0),) * 4), "lit", 1, False,
        {"open_scatter"}),
    "S=0, last depth": (
        lambda: _cfg(_fast, nee_schedule=((0, 0.0),) * 4), "lit", 3, False,
        {"open"}),
    "S=1 L=1, fold": (_fast, "cornell", 0, False,
                      {"open_nee", "close_scatter"}),
    "S=1 L=1, last depth": (_fast, "cornell", 3, False,
                            {"open_nee_store", "close_stored"}),
    "S=2 L=3, uniform + roulette": (
        lambda: _reference(rr_start_depth=1), "three", 0, False,
        {"open_nee", "step", "close_scatter"}),
    "S=2 L=3, last depth": (
        lambda: _reference(nee_schedule=((2, 0.5),) * 3), "three", 2, False,
        {"open_nee", "step", "step_store", "close_stored"}),
    "reference_compat, cosine": (
        lambda: _reference(reference_compat=True,
                           hemisphere_sampling="cosine"), "cornell", 0,
        False, {"open_nee", "step", "close_scatter"}),
    "16-float rows (compact_depths)": (
        lambda: _fast(compact_depths=True, fuse_frame="yes"), "cornell", 2,
        True, {"open_nee", "close_scatter"}),
}


@pytest.fixture(scope="module")
def chain_scenes(box):
    return dict(lit=box["ours"],
                cornell=_flat_scene(cornell_box_scene(
                    with_spheres=True, sphere_bsdfs="classic")),
                three=_flat_scene(_three_lights()))


def _on_host(mp, lib):
    """The wrappers' launches through the host-built library."""
    def launch(name, args, dev):
        if args.n == 0:
            return False
        assert getattr(lib, name)(ctypes.byref(args), None) == 0
        return True

    mp.setattr(SS, "_device", lambda x: x.device)
    mp.setattr(SS, "_launch", launch)


@pytest.mark.parametrize("case", CHAIN_CASES)
def test_host_built_chain_matches_the_plain_chain(box, chain_scenes,
                                                  host_kernels, case,
                                                  monkeypatch):
    """One depth of ``run_depth`` on the box's rays through the fused
    chain built for the host, every trace by brute force: each gap held
    lane by lane against the plain stages chained on the same inputs
    (within rtol 1e-5 / atol 1e-6 but near a branch) and to the bit
    against the stage kernels chained (chip_smoke._probe_chain)."""
    from cuda_raytracer_tpu_torch.render.bounce import (frame_keys,
                                                        make_stage_fns,
                                                        run_depth)

    make, which, depth, packed, variants = CHAIN_CASES[case]
    cfg, scene = make(), chain_scenes[which]
    _on_host(monkeypatch, host_kernels)
    monkeypatch.setattr(SS, "chained", lambda x: True)

    def trace(scene, o, d, valid, t_limit=None):
        return trace_bruteforce(scene, o, d, valid)

    J = dict(make_stage_fns(cfg), trace=trace, trace_secondary=trace,
             trace_secondary_compact=trace)
    keys = frame_keys(cfg, scene.num_lights, rng.PRNGKey(depth + 11))
    imp = T(box["imp"])
    if packed:
        state = torch.zeros((N, 16))
        state[:, 8:11] = imp
        imp = state[:, 8:11]
    valid = torch.arange(N) % 7 != 0
    carry = (T(box["o"]), T(box["d"]), valid, imp, torch.full((N, 3), 0.25),
             T(box["ce"]), torch.zeros((), dtype=torch.int64))
    log = {}
    with chip_smoke._probe_chain(log):
        out = run_depth(J, cfg, scene, carry, keys, depth)
    assert {b.split("; ")[0] for s, b in log if s == "gap"} == variants
    for (stage, branch), e in log.items():
        assert e["far"] == 0, (stage, branch, e)
        assert e.get("unequal", 0) == 0, (stage, branch, e)
        assert e["lanes"] == N * e["calls"]
    light = out[4]
    assert torch.isfinite(light).all() and bool((light != 0.25).any())
    if depth + 1 < cfg.max_depth:
        assert out[0] is not carry[0] and 0 < int(out[2].sum()) < N


@pytest.fixture(scope="module")
def chain_frames(host_kernels):
    """Each small frame shaded by the host-built stage kernels stage by
    stage and by the host-built fused chain (its launches counted by
    variant, and the stage kernels'); and the chain's gaps probed
    (chip_smoke._probe_chain) in a second chained render."""
    mp = pytest.MonkeyPatch()
    counters = [f"{g}_launches" for g in SS.GAPS] + [
        f"{s}_launches" for s in STAGES]
    images, launches, log = {}, {}, {}
    try:
        _on_host(mp, host_kernels)
        mp.setattr(SS, "_on", lambda x: "cuda")
        for case in FRAMES:
            for chained in (False, True):
                mp.setattr(SS, "chained", lambda x, c=chained: c)
                r = _renderer(case)
                before = {c: getattr(SS, c) for c in counters}
                r.render()
                images[case, chained] = r.get_raw_image()
                if chained:
                    launches[case] = (r, {c[:-9]: getattr(SS, c) - before[c]
                                          for c in counters})
            r = _renderer(case)
            with chip_smoke._probe_chain(log):
                r.render()
    finally:
        mp.undo()
    return images, launches, log


@pytest.mark.parametrize("case", list(FRAMES))
def test_host_built_chain_frames_are_the_stage_kernels(chain_frames, case):
    images = chain_frames[0]
    assert np.array_equal(images[case, True], images[case, False])
    assert np.isfinite(images[case, True]).all()


@pytest.mark.parametrize("case", list(FRAMES))
def test_chain_launches_per_frame_are_the_traces(chain_frames, case):
    """A chained frame launches no stage kernel and one gap after each
    trace: the variants as chip_smoke.gap_schedule gives them, as many
    as the frame's traces (1 + samples x lights per depth)."""
    r, got = chain_frames[1][case]
    cfg, lights = r.config, r.scene.num_lights
    assert all(got[s] == 0 for s in STAGES)
    assert {g: got[g] for g in SS.GAPS} == chip_smoke.gap_schedule(cfg,
                                                                   lights)
    traces = sum(1 + (cfg.nee_schedule[d][0] * lights
                      if d < len(cfg.nee_schedule) else 0)
                 for d in range(cfg.max_depth))
    assert sum(got[g] for g in SS.GAPS) == traces
    want = chip_smoke.stage_launches(cfg, lights)
    assert want == dict(dict.fromkeys(STAGES, 0),
                        **{f"gap_{g}": got[g] for g in SS.GAPS})


def test_host_built_chain_meets_every_branch(chain_frames):
    """The small frames' gaps, held as phase 14 holds them on the card,
    reach every part of chip_smoke.CHAIN_BRANCHES; no lane is off but
    near a branch, and every gap is the stage kernels' to the bit."""
    log = chain_frames[2]
    met = {p for s, b in log if s == "gap" for p in b.split("; ")}
    assert chip_smoke.CHAIN_BRANCHES <= met, sorted(
        chip_smoke.CHAIN_BRANCHES - met)
    for (stage, branch), e in log.items():
        assert e["far"] == 0, (stage, branch, e)
        assert e.get("unequal", 0) == 0, (stage, branch, e)
