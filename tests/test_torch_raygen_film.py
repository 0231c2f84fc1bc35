"""The camera rays' and the film's kernels (ops/csrc/raygen.cu,
ops/csrc/film.cu) and their dispatch, on the CPU.

* On CPU tensors ``generate_camera_rays`` (both camera modes, the three
  sample orders, a partial last tiles32s tile row, a slab's
  ``row_offset``) and ``reconstruct`` / ``film`` / ``accumulate`` /
  ``median_filter_3x3`` (pixel- and sample-major, with and without
  ``inv_order``, both median modes) are their plain versions and agree
  with the JAX package's functions within rtol 1e-5 / atol 1e-6 (the
  median bit for bit).
* The kernel sources built for the host (g++: the CUDA qualifiers and
  intrinsics as macros and functions, a kernel's phases between its
  barriers each a loop over a block's threads, block by block over its
  grid) are held against the plain versions on every branch: d within
  rtol 1e-5 / atol 1e-6 in every sample order and an index table, at
  shapes whose divisors are not powers of two, the draws through their
  effect on d; the film within rtol 1e-5 / atol 1e-6; the median
  bit-equal in both modes on images from 1x1 to 37x29 with NaN (two
  payloads), +-0, +-inf and ties.  The median's selection alone: its
  networks by the 0-1 principle, its pick against numpy's stable
  argsort on sets with many ties.  raygen's magic divisors against //
  and % for every lane of an 800x600 frame of 32 spp.
* A CUDA device or tensor reaches the kernel's wrapper, never the plain
  version; another device is refused; a library that fails to build
  raises.  Each wrapper's argument block (key and camera pointers,
  order and its divisors, layouts, flags) is read through a recording
  launcher; a tile order at a width off its tile is refused; no launch
  for no lanes; the engine's film launches the median only in a
  ``with_median`` program.
* The counters are in ``render/graphs.COUNTERS`` and chip_smoke.py's
  table, and the calls of small CPU frames (the engine's, fast and
  reference presets over two frames; the sharded renderer's) are what
  ``chip_smoke.expected_launches`` schedules.
"""

import ctypes
import math
import os
import shutil
import subprocess

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

import chip_smoke
from cuda_raytracer_tpu.ops import filters as JF
from cuda_raytracer_tpu.ops import shade as JS
from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.ops import _build
from cuda_raytracer_tpu_torch.ops import filters as F
from cuda_raytracer_tpu_torch.ops import shade as S
from cuda_raytracer_tpu_torch.parallel.shard import ShardedRenderer
from cuda_raytracer_tpu_torch.render import graphs
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
from torch_threads import _one_torch_thread  # noqa: F401

RTOL, ATOL = 1e-5, 1e-6
SEED, DATA = 15618, 7
POS = [0.1, 0.75, 2.5]
C2W = np.array([[0.96, 0.0, 0.28], [0.0, 1.0, 0.0], [-0.28, 0.0, 0.96]])
TAN = (math.tan(math.radians(50.0) / 2), math.tan(math.radians(35.0) / 2))
#: the cutracer basis: origin, look_at, up, left
CUT = ([0.0, 0.75, 2.5], [0.0, -0.05, -0.99], [0.0, -0.99, 0.05],
       [-1.0, 0.0, 0.0])


def T(a):
    return torch.from_numpy(np.array(a))


def _key():
    kj = jax.random.fold_in(jax.random.PRNGKey(SEED), DATA)
    return kj, tuple(int(x) for x in np.asarray(kj))


def close(got, want, name=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=name)


#: raygen cases: (camera, width, height, spp, pix_order, row_offset,
#: full_height); 96x40 has a partial last tiles32s tile row (40 % 32)
RAYS = {
    "pinhole raster": ("pinhole", 64, 32, 2, None, 0, None),
    "pinhole tiles8": ("pinhole", 64, 32, 2, "tiles8", 0, None),
    "pinhole tiles32s, partial row": ("pinhole", 96, 40, 2, "tiles32s", 0,
                                      None),
    "pinhole slab, row_offset": ("pinhole", 64, 8, 3, None, 16, 32),
    "cutracer tiles32s, partial row": ("cutracer", 96, 40, 2, "tiles32s", 0,
                                       None),
}


#: more raygen cases for the host-built kernel, every divisor of the
#: order not a power of two: spp 3 or 5; W 40 (tiles8: 5 tiles a row);
#: tiles32s at W 96 (3 tiles, 3,072 slots a tile row) over 44 rows (a
#: partial row of 12: 384 slots a tile), and a 22-row slab with no full
#: tile row (704 slots a tile) at row_offset 33 of 77
KERNEL_RAYS = dict(RAYS, **{
    "pinhole raster, odd": ("pinhole", 40, 12, 3, None, 0, None),
    "pinhole tiles8, odd": ("pinhole", 40, 24, 3, "tiles8", 0, None),
    "pinhole tiles32s, odd partial row": ("pinhole", 96, 44, 3, "tiles32s",
                                          0, None),
    "pinhole tiles32s slab, partial row only": ("pinhole", 96, 22, 5,
                                                "tiles32s", 33, 77),
    "cutracer tiles8, odd": ("cutracer", 40, 24, 3, "tiles8", 0, None),
})


def _rays(fn, case, key, order=None):
    """``fn`` (a port function of generate_camera_rays' or the cutracer's
    signature) on case's arguments, with ``order`` (an index table) in
    place of the case's order where given."""
    cam, w, h, spp, pix, ro, fh = KERNEL_RAYS[case]
    pix = pix if order is None else order
    if cam == "cutracer":
        return fn(key, w, h, spp, *CUT, pix_order=pix, device="cpu")
    return fn(key, w, h, spp, POS, C2W, *TAN, pix_order=pix, row_offset=ro,
              full_height=fh, device="cpu")


@pytest.mark.parametrize("case", list(RAYS))
def test_cpu_rays_are_the_plain_version_and_the_jax_function(case,
                                                             monkeypatch):
    def kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran for the CPU")

    monkeypatch.setattr(S, "generate_camera_rays_cuda", kernel)
    monkeypatch.setattr(S, "generate_camera_rays_cutracer_cuda", kernel)
    cam, w, h, spp, pix, ro, fh = RAYS[case]
    kj, kp = _key()
    fn = (S.generate_camera_rays_cutracer if cam == "cutracer"
          else S.generate_camera_rays)
    o, d = _rays(fn, case, kp)
    o2, d2 = _rays(getattr(S, f"{fn.__name__}_plain"), case, kp)
    assert torch.equal(o, o2) and torch.equal(d, d2)
    # jitted: the JAX function op by op takes seconds at these sizes
    if cam == "cutracer":
        oj, dj = jax.jit(lambda k, *v: JS.generate_camera_rays_cutracer(
            k, w, h, spp, *v, pix_order=pix))(
                kj, *(jnp.asarray(v, jnp.float32) for v in CUT))
    else:
        oj, dj = jax.jit(lambda k, p, c: JS.generate_camera_rays(
            k, w, h, spp, p, c, *TAN, pix_order=pix, row_offset=ro,
            full_height=fh))(kj, jnp.asarray(POS, jnp.float32),
                             jnp.asarray(C2W, jnp.float32))
    close(o, oj, "o")
    close(d, dj, "d")


#: film cases: (width, height, spp, order of inv_order, sample-major)
FILMS = {
    "pixel-major": (64, 32, 2, None, False),
    "pixel-major, tiles8 inv_order": (64, 32, 3, "tiles8", False),
    "sample-major, tiles32s inv_order": (96, 40, 4, "tiles32s", True),
}


def _film_inputs(case, seed=3):
    w, h, spp, order, major = FILMS[case]
    g = np.random.default_rng(seed)
    light = g.random((w * h * spp, 3)).astype(np.float32)
    inv = {None: None, "tiles8": S.tiles8_rank,
           "tiles32s": S.tiles32s_rank}[order]
    inv = None if inv is None else T(inv(w, h))
    prev = g.random((h, w, 3)).astype(np.float32)
    return light, inv, prev


@pytest.mark.parametrize("case", list(FILMS))
def test_cpu_film_is_the_plain_version_and_the_jax_function(case,
                                                            monkeypatch):
    def kernel(*a, **k):
        raise AssertionError("the kernel's wrapper ran for CPU tensors")

    for name in ("reconstruct_cuda", "film_cuda", "accumulate_cuda",
                 "median_filter_3x3_cuda"):
        monkeypatch.setattr(F, name, kernel)
    w, h, spp, order, major = FILMS[case]
    light, inv, prev = _film_inputs(case)
    img = F.reconstruct(T(light), w, h, spp, inv, major)
    assert torch.equal(img, F.reconstruct_plain(T(light), w, h, spp, inv,
                                                major))
    fin = F.film(T(light), T(prev), 6.0, float(spp), w, h, spp, inv, major)
    assert torch.equal(fin, F.accumulate(T(prev), img, 6.0, float(spp)))
    assert torch.equal(fin, F.film_plain(T(light), T(prev), 6.0, float(spp),
                                         w, h, spp, inv, major))
    # one jitted JAX film: reconstruct, accumulate, both medians
    inv_j = None if inv is None else jnp.asarray(inv.numpy())

    def jax_film(light, prev):
        ij = JF.reconstruct(light, w, h, spp, inv_j, major)
        fj = JF.accumulate(prev, ij, jnp.float32(6.0), jnp.float32(spp))
        return ij, fj, [JF.median_filter_3x3(fj, c) for c in (False, True)]

    ij, fj, mj = jax.jit(jax_film)(jnp.asarray(light), jnp.asarray(prev))
    close(img, ij, "reconstruct")
    close(fin, fj, "film")
    for compat in (False, True):
        med = F.median_filter_3x3(fin, compat)
        assert torch.equal(med, F.median_filter_3x3_plain(fin, compat))
        # of the JAX film's image: the medians select, bit for bit
        np.testing.assert_array_equal(
            F.median_filter_3x3(T(np.asarray(fj)), compat).numpy(),
            np.asarray(mj[compat]))


# ---------------------------------------------------------------------------
# the kernel sources, built for the host, against the plain versions
# ---------------------------------------------------------------------------

#: the CUDA qualifiers, built-ins and intrinsics the two sources use, for
#: g++: a kernel's shared arrays become statics and its barrier nothing,
#: since the harness runs a kernel as its phases (``_kernel``)
_HOST_PRELUDE = r"""
#include <math.h>
#include <stdint.h>
#include <string.h>
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __shared__ static
#define __syncthreads()
struct Dim { unsigned x, y, z; };
static Dim blockIdx, threadIdx, blockDim, gridDim;
static inline uint32_t min(uint32_t a, uint32_t b) { return a < b ? a : b; }
static inline uint32_t max(uint32_t a, uint32_t b) { return a < b ? b : a; }
static inline unsigned __umulhi(unsigned a, unsigned b) {
  return (unsigned)(((unsigned long long)a * b) >> 32); }
static inline float __uint_as_float(uint32_t i) { float f; memcpy(&f, &i, 4); return f; }
static inline uint32_t __float_as_uint(float f) { uint32_t i; memcpy(&i, &f, 4); return i; }
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, int r) {
  return (hi << r) | (lo >> (32 - r)); }
"""


def _source(name):
    """csrc/<name>.cu up to its C interface, threefry.cuh inlined, the
    CUDA headers left out."""
    with open(_build.source_path(name)) as f:
        src = f.read()
    src = src[:src.index("// C interface")]
    with open(os.path.join(os.path.dirname(_build.source_path(name)),
                           "threefry.cuh")) as f:
        header = f.read().replace("#pragma once", "")
    src = src.replace('#include "threefry.cuh"', header)
    return src.replace("#include <cuda_runtime.h>", "")


def _kernel(fn, args, grid, block, phases, shared=""):
    """A kernel as host C++ behind its C name ``fn``: block by block over
    ``grid`` (x, y), each of its ``phases`` (the code between two
    barriers) a loop over the block's threads (``block`` x, y), the
    block's ``shared`` arrays declared once.  Grid and block are C
    expressions of the argument block ``p``."""
    loops = "".join(
        "    for (unsigned ty = 0; ty < blockDim.y; ++ty)\n"
        "      for (unsigned tx = 0; tx < blockDim.x; ++tx) {\n"
        f"        threadIdx = {{tx, ty, 0}};\n        {phase};\n      }}\n"
        for phase in phases)
    return (f'extern "C" int {fn}(const {args}* p, void* s) {{\n'
            f"  {shared}\n"
            f"  gridDim = {{(unsigned)({grid[0]}), (unsigned)({grid[1]}), "
            f"1}};\n"
            f"  blockDim = {{{block[0]}, {block[1]}, 1}};\n"
            "  for (unsigned by = 0; by < gridDim.y; ++by)\n"
            "  for (unsigned bx = 0; bx < gridDim.x; ++bx) {\n"
            "    blockIdx = {bx, by, 0};\n"
            f"{loops}  }}\n  return 0;\n}}\n")


def _host_source():
    """raygen.cu's and film.cu's kernels as host C++ behind their C
    names, each run by ``_kernel``; and the median's selection alone
    (``host_pick9``: the picked neighbour's number, and the key the
    network selects)."""
    med = "p->compat ? median_{0}<true>(*p, t) : median_{0}<false>(*p, t)"
    return (_HOST_PRELUDE + _source("raygen") + _source("film")
            + _kernel("raygen", "RaygenArgs",
                      ("(p->n + GBLOCK - 1) / GBLOCK", 1), ("GBLOCK", 1),
                      ("raygen_kernel(*p)",))
            + _kernel("film", "FilmArgs",
                      ("(p->n_pix + FBLOCK - 1) / FBLOCK", 1), ("FBLOCK", 1),
                      ("film_kernel(*p)",))
            + _kernel("median3x3", "MedianArgs",
                      ("(p->w + MW - 1) / MW", "(p->h + MH - 1) / MH"),
                      ("MW", "MH"), (med.format("load"), med.format("pixel")),
                      "static MedianTile t;")
            + 'extern "C" int host_pick9(const uint32_t* key, int compat,\n'
              "                          uint32_t* m) {\n"
              "  uint32_t k[9];\n"
              "  for (int i = 0; i < 9; ++i) k[i] = key[i];\n"
              "  *m = compat ? select9<5>(k) : select9<4>(k);\n"
              "  return compat ? stable_pick9<5>(key) : stable_pick9<4>(key);"
              "\n}\n"
            + 'extern "C" long long raygen_args_size(void) {\n'
              "  return sizeof(RaygenArgs);\n}\n"
            + 'extern "C" long long film_args_size(int w) {\n'
              "  return w == 0 ? sizeof(FilmArgs) : sizeof(MedianArgs);\n}\n")


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    """The two sources built by g++ as one host library (no FMA
    contraction, no fast math), its argument blocks the size of the
    wrappers' ctypes mirrors."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("no g++ to build the kernel sources for the host")
    d = tmp_path_factory.mktemp("raygen_film_host")
    cpp, so = os.path.join(d, "host.cpp"), os.path.join(d, "host.so")
    with open(cpp, "w") as f:
        f.write(_host_source())
    subprocess.run([gxx, "-O2", "-ffp-contract=off", "-fno-fast-math",
                    "-shared", "-fPIC", "-o", so, cpp], check=True)
    lib = ctypes.CDLL(so)
    lib.raygen_args_size.restype = ctypes.c_longlong
    lib.film_args_size.restype = ctypes.c_longlong
    assert lib.raygen_args_size() == ctypes.sizeof(S._RaygenArgs)
    for which, args in enumerate(F._ARGS.values()):
        assert lib.film_args_size(which) == ctypes.sizeof(args)
    return lib


@pytest.fixture
def on_host(host_lib, monkeypatch):
    """The wrappers on the CPU with the host library as the kernels."""
    def launch(name, args, dev, n=None):
        if (args.n if n is None else n) == 0:
            return False
        assert getattr(host_lib, name)(ctypes.byref(args), None) == 0
        return True

    monkeypatch.setattr(S, "_cuda_device", lambda device: torch.device(
        "cpu"))
    monkeypatch.setattr(S, "_launch", launch)
    monkeypatch.setattr(F, "_device", lambda x: x.device)
    monkeypatch.setattr(F, "_launch", lambda name, a, n, dev: launch(
        name, a, dev, n))
    return host_lib


@pytest.mark.parametrize("case", list(KERNEL_RAYS))
@pytest.mark.parametrize("key_kind", ["int key", "KeyTable key"])
def test_host_raygen_kernel_against_the_plain_version(on_host, case,
                                                      key_kind):
    cam = KERNEL_RAYS[case][0]
    _, kp = _key()
    key = kp
    if key_kind == "KeyTable key":
        table = rng.KeyTable(["raygen"], "cpu")
        table.load({"raygen": kp})
        key = table["raygen"]
    suffix = "_cutracer" if cam == "cutracer" else ""
    fk = getattr(S, f"generate_camera_rays{suffix}_cuda")
    fp = getattr(S, f"generate_camera_rays{suffix}_plain")
    w, h = KERNEL_RAYS[case][1:3]
    # the case's order, and an index table (the tiles32s rank's inverse:
    # slot -> pixel)
    table = torch.as_tensor(np.argsort(S.tiles32s_rank(w, h)))
    for order in (None, table):
        before = S.raygen_launches
        o, d = _rays(fk, case, key, order)
        o2, d2 = _rays(fp, case, kp, order)
        assert S.raygen_launches == before + 1
        assert o.stride(0) == 0 and torch.equal(o, o2)
        close(d, d2, f"{case}, order {type(order).__name__}")
        # one wrong draw moves d by up to a pixel's width in the frustum
        assert float((d - d2).abs().max()) < 1e-5


#: divisors of the frames' layouts (800x600 at 32 spp: spp, W, W / 8,
#: 25 tile columns' 25,600 slots, a 24-row partial tile row's 768, W * H)
#: and of the odd cases, 1, and the largest the kernel can meet
DIVISORS = (1, 2, 3, 5, 7, 32, 100, 384, 704, 768, 800, 3072, 25_600,
            480_000, 15_360_000, (1 << 30) + 1, (1 << 31) - 1)


@pytest.mark.parametrize("d", DIVISORS)
def test_magic_division_is_exact(d):
    """raygen.cu's quotient __umulhi(2n, m) >> s (``_div``'s pair), and
    the remainder n - q * d, against // and % for every n of run A's
    15,360,000 lanes and the last 2^20 below 2^31."""
    v = S._div(d)
    assert v.d == d and v.m < 1 << 32 and v.s <= 31
    m, s, du = np.uint64(v.m), np.uint64(v.s), np.uint64(d)
    for lo, hi in ((0, 15_360_000), ((1 << 31) - (1 << 20), 1 << 31)):
        for start in range(lo, hi, 1 << 17):
            n = np.arange(start, min(start + (1 << 17), hi), dtype=np.uint64)
            q = (((n + n) * m) >> np.uint64(32)) >> s
            # q * d <= n (else the u64 difference wraps) and n - q * d < d:
            # q is n // d and n - q * d is n % d
            assert (n - q * du < du).all()


#: median images (h, w): one pixel, a row, a column, 2x2, odd sizes across
#: 32 x 8 tiles, each with NaN (two payloads), +-0, +-inf and runs
MEDIAN_IMAGES = ((1, 1), (1, 5), (5, 1), (2, 2), (29, 37), (37, 29),
                 (24, 20))


@pytest.mark.parametrize("compat", [False, True])
def test_host_median_kernel_is_bit_equal(on_host, compat):
    for h, w in MEDIAN_IMAGES:
        img = chip_smoke.tie_image(h, w, seed=100 * h + w)
        before = F.median_launches
        got = F.median_filter_3x3_cuda(T(img), compat)
        want = F.median_filter_3x3_plain(T(img), compat)
        assert F.median_launches == before + 1
        np.testing.assert_array_equal(got.numpy().view(np.uint32),
                                      want.numpy().view(np.uint32),
                                      err_msg=f"{h}x{w}")


def _pick9(lib, keys, compat):
    m = ctypes.c_uint32()
    arr = (ctypes.c_uint32 * 9)(*(int(k) for k in keys))
    return lib.host_pick9(arr, int(compat), ctypes.byref(m)), m.value


@pytest.mark.parametrize("compat", [False, True])
def test_host_median_selection(host_lib, compat):
    """The median's selection alone: the network's key is the K-th
    smallest for every 0-1 input (so for every input, by the 0-1
    principle), and the picked neighbour is the stable sort's K-th, on
    random 9-key sets with many ties."""
    k = 5 if compat else 4
    for bits in range(512):
        keys = [(bits >> i) & 1 for i in range(9)]
        pick, m = _pick9(host_lib, keys, compat)
        assert m == sorted(keys)[k]
        assert pick == int(np.argsort(keys, kind="stable")[k])
    g = np.random.default_rng(16)
    for _ in range(2000):
        keys = g.integers(0, g.integers(1, 5), 9) * 0x3F800000
        pick, m = _pick9(host_lib, keys, compat)
        assert pick == int(np.argsort(keys, kind="stable")[k])
        assert m == np.sort(keys)[k]


@pytest.mark.parametrize("case", list(FILMS))
def test_host_film_kernel_against_the_plain_version(on_host, case):
    w, h, spp, order, major = FILMS[case]
    light, inv, prev = _film_inputs(case)
    img = F.reconstruct_cuda(T(light), w, h, spp, inv, major)
    want = F.reconstruct_plain(T(light), w, h, spp, inv, major)
    close(img, want, "reconstruct")
    for old in (0.0, 6.0, torch.tensor(6.0)):
        close(F.film_cuda(T(light), T(prev), old, float(spp), w, h, spp, inv,
                          major),
              F.film_plain(T(light), T(prev), old, float(spp), w, h, spp,
                           inv, major), f"film, old weight {old}")
    # the sharded renderer's accumulate: a mean of one sample is exact
    acc = F.accumulate_cuda(T(prev), want, torch.tensor(4.0), 2.0)
    close(acc, F.accumulate_plain(T(prev), want, 4.0, 2.0), "accumulate")


# ---------------------------------------------------------------------------
# dispatch and argument blocks
# ---------------------------------------------------------------------------


class _OnCard:
    """Stands in for a CUDA tensor where a function reads only the
    device."""
    device = torch.device("cuda", 0)


def test_cuda_goes_to_the_kernels(monkeypatch):
    """A CUDA device or tensor never reaches a plain version: each
    function calls its kernel's wrapper with its own arguments.  Other
    devices are refused."""
    seen = []

    def kernel(name):
        def k(*args):
            seen.append((name, args))
            return name
        return k

    def plain(*a, **k):
        raise AssertionError("a plain version ran for the card")

    for mod, names in ((S, ("generate_camera_rays",
                            "generate_camera_rays_cutracer")),
                       (F, ("reconstruct", "film", "accumulate",
                            "median_filter_3x3"))):
        for name in names:
            monkeypatch.setattr(mod, f"{name}_cuda", kernel(name))
            monkeypatch.setattr(mod, f"{name}_plain", plain)
    _, kp = _key()
    card = _OnCard()
    calls = {
        "generate_camera_rays": lambda dev: S.generate_camera_rays(
            kp, 8, 8, 1, POS, C2W, *TAN, device=dev),
        "generate_camera_rays_cutracer":
            lambda dev: S.generate_camera_rays_cutracer(kp, 8, 8, 1, *CUT,
                                                        device=dev),
        "reconstruct": lambda x: F.reconstruct(x, 8, 8, 1),
        "film": lambda x: F.film(x, None, 0.0, 1.0, 8, 8, 1),
        "accumulate": lambda x: F.accumulate(None, x, 0.0, 1.0),
        "median_filter_3x3": lambda x: F.median_filter_3x3(x, True),
    }
    for name, call in calls.items():
        on = "cuda" if name.startswith("generate") else card
        assert call(on) == name and seen[-1][0] == name
        other = ("meta" if name.startswith("generate")
                 else torch.empty(3, device="meta"))
        with pytest.raises(ValueError, match="device"):
            call(other)
    assert seen[-1][1] == (card, True)


def test_a_library_that_fails_to_build_raises(monkeypatch):
    """No fallback: a kernel that cannot be built raises, and the plain
    version never runs."""
    def nvcc_fails(name, defines=()):
        raise RuntimeError(f"nvcc failed building {name}.cu")

    def plain(*a, **k):
        raise AssertionError("fell back to the plain version")

    monkeypatch.setattr(_build, "load_library", nvcc_fails)
    monkeypatch.setattr(S, "_lib", None)
    monkeypatch.setattr(F, "_lib", None)
    monkeypatch.setattr(S, "_cuda_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(S, "generate_camera_rays_plain", plain)
    monkeypatch.setattr(F, "_path", lambda x: "cuda")
    monkeypatch.setattr(F, "_device", lambda x: x.device)
    monkeypatch.setattr(F, "median_filter_3x3_plain", plain)
    with pytest.raises(RuntimeError, match="nvcc failed building raygen"):
        S.generate_camera_rays(_key()[1], 8, 8, 1, POS, C2W, *TAN,
                               device="cuda")
    with pytest.raises(RuntimeError, match="nvcc failed building film"):
        F.median_filter_3x3(torch.zeros((4, 4, 3)))


@pytest.fixture
def recorded(monkeypatch):
    """The wrappers on CPU tensors with each launch recorded instead of
    made: (kernel name, its argument block)."""
    out = []

    def launch(name, args, dev, n=None):
        if (args.n if n is None else n) == 0:
            return False
        out.append((name, args))
        return True

    monkeypatch.setattr(S, "_cuda_device", lambda d: torch.device("cpu"))
    monkeypatch.setattr(S, "_launch", launch)
    monkeypatch.setattr(F, "_device", lambda x: x.device)
    monkeypatch.setattr(F, "_launch", lambda name, a, n, dev: launch(
        name, a, dev, n))
    return out


def test_raygen_arguments(recorded):
    """The key by value or by two device pointers (a KeyTable entry), the
    camera buffer's pointers (the fused frame's, which a move rewrites),
    the order's code or table, the slab and the field of view as
    float32."""
    _, kp = _key()
    cam = torch.arange(12, dtype=torch.float32)
    table = rng.KeyTable(["raygen", "other"], "cpu")
    table.load({"raygen": kp, "other": (1, 2)})
    o, d = S.generate_camera_rays_cuda(
        table["raygen"], 32, 16, 2, cam[0:3], cam[3:12].view(3, 3), *TAN,
        pix_order="tiles32s", row_offset=16, full_height=48)
    (name, a), = recorded
    assert name == "raygen" and a.n == 32 * 16 * 2
    assert (a.kp0, a.kp1) == (table.buf[0, 0].data_ptr(),
                              table.buf[0, 1].data_ptr())
    assert a.cam0 == cam[3:].data_ptr() and not a.cutracer
    assert o.data_ptr() == cam.data_ptr() and o.stride() == (0, 1)
    assert a.d == d.data_ptr() and d.shape == (1024, 3)
    assert (a.order, a.row_offset, a.full_height) == (2, 16, 48)
    assert (a.tan_h, a.tan_v) == tuple(float(np.float32(t)) for t in TAN)
    assert (a.width, a.height, a.spp) == (32, 16, 2)
    # the order's divisors from the static shape: W * H lanes a sample,
    # one 1,024-slot tile a tile row, no full tile row (16 of 32 rows): a
    # partial row of 16 x 32 slots a tile from slot 0, row 0
    divs = [(v.d, v.m, v.s) for v in (a.lane_div, a.pix_div, a.part_div)]
    assert divs == [(512, 1 << 31, 9), (1024, 1 << 31, 10),
                    (512, 1 << 31, 9)]
    assert (a.q_full_end, a.part_y0) == (0, 0)
    S.generate_camera_rays_cuda(kp, 32, 16, 1, POS, C2W, *TAN,
                                pix_order="tiles8")
    a = recorded[-1][1]
    assert (a.kp0, a.kp1, a.h0, a.h1) == (None, None) + kp
    assert (a.order, a.full_height, a.spp) == (1, 16, 1)
    # spp 1, 4 tiles a row
    assert [(v.d, v.s) for v in (a.lane_div, a.pix_div, a.part_div)] == [
        (1, 0), (4, 2), (0, 0)]
    S.generate_camera_rays_cuda(kp, 96, 44, 3, POS, C2W, *TAN,
                                pix_order="tiles32s")
    a = recorded[-1][1]
    assert [v.d for v in (a.lane_div, a.pix_div, a.part_div)] == [
        96 * 44, 3 * 1024, 12 * 32]
    assert (a.q_full_end, a.part_y0) == (3 * 1024, 32)
    assert a.lane_div.m == -(-(1 << (31 + 13)) // (96 * 44))
    inv = torch.arange(32 * 16, dtype=torch.int64).flip(0)
    S.generate_camera_rays_cutracer_cuda(kp, 32, 16, 1, *(
        cam[3 * i:3 * i + 3] for i in range(4)), pix_order=inv)
    a = recorded[-1][1]
    # origin, look_at, up, left: the kernel reads left, up, look_at
    assert a.cutracer == 1 and (a.order, a.table) == (3, inv.data_ptr())
    assert (a.cam0, a.cam1, a.cam2) == tuple(
        cam[i:].data_ptr() for i in (9, 6, 3))
    # a table and raster order: spp lanes a slot, W pixels a row
    assert [v.d for v in (a.lane_div, a.pix_div, a.part_div)] == [1, 32, 0]
    # no launch for no lanes; refused: a table of another type, an
    # unknown order, a camera of another shape or dtype
    before = S.raygen_launches
    o, d = S.generate_camera_rays_cuda(kp, 32, 16, 0, POS, C2W, *TAN)
    assert d.shape == (0, 3) and len(recorded) == 4
    assert S.raygen_launches == before
    with pytest.raises(ValueError, match="pix_order"):
        S.generate_camera_rays_cuda(kp, 32, 16, 1, POS, C2W, *TAN,
                                    pix_order=inv.int())
    # the tile orders' closed forms need whole tiles across
    for order, w, tile in (("tiles32s", 48, 32), ("tiles8", 36, 8)):
        with pytest.raises(ValueError, match=f"multiple of {tile}, not {w}"):
            S.generate_camera_rays_cuda(kp, w, 16, 1, POS, C2W, *TAN,
                                        pix_order=order)
    with pytest.raises(ValueError, match="unknown pix_order"):
        S.generate_camera_rays_cuda(kp, 32, 16, 1, POS, C2W, *TAN,
                                    pix_order="tiles16")
    with pytest.raises(ValueError, match="c2w"):
        S.generate_camera_rays_cuda(kp, 32, 16, 1, POS, cam[:9].double()
                                    .view(3, 3), *TAN)


def test_film_arguments(recorded):
    light = torch.rand(8 * 4 * 3, 3)
    inv = torch.as_tensor(S.tiles8_rank(8, 4))
    final = torch.rand(4, 8, 3)
    samples = torch.tensor(6.0)
    out = F.film_cuda(light, final, samples, 3.0, 8, 4, 3, inv, True)
    (name, a), = recorded
    assert name == "film" and (a.n_pix, a.spp) == (32, 3)
    assert (a.samples, a.inv_order, a.final_in) == (
        light.data_ptr(), inv.data_ptr(), final.data_ptr())
    assert (a.sample_major, a.accumulate, a.old_ptr) == (
        1, 1, samples.data_ptr())
    assert a.new_weight == 3.0 and a.out == out.data_ptr()
    F.accumulate_cuda(final, out, 64.0, 32.0)
    a = recorded[-1][1]
    assert (a.spp, a.inv_order, a.old_ptr, a.old_weight) == (
        1, None, None, 64.0)
    assert a.samples == out.data_ptr() and a.accumulate == 1
    F.reconstruct_cuda(light, 8, 4, 3)
    a = recorded[-1][1]
    assert (a.accumulate, a.final_in, a.sample_major) == (0, None, 0)
    for compat in (False, True):
        med = F.median_filter_3x3_cuda(final, compat)
        name, a = recorded[-1]
        assert name == "median3x3" and (a.h, a.w, a.compat) == (
            4, 8, int(compat))
        assert (a.img, a.out) == (final.data_ptr(), med.data_ptr())
    n = len(recorded)
    before = (F.film_launches, F.median_launches)
    F.reconstruct_cuda(torch.zeros((0, 3)), 0, 4, 3)
    F.median_filter_3x3_cuda(torch.zeros((0, 8, 3)))
    assert len(recorded) == n and before == (F.film_launches,
                                             F.median_launches)
    # the samples must be one contiguous [P * spp, 3] block
    with pytest.raises(ValueError, match="sample_light"):
        F.reconstruct_cuda(light.t().contiguous().t(), 8, 4, 3)
    with pytest.raises(ValueError, match="inv_order"):
        F.reconstruct_cuda(light, 8, 4, 3, inv.int())


@pytest.mark.parametrize("with_median", [False, True])
@pytest.mark.parametrize("compat", [False, True])
def test_engine_film_launches_the_median_in_its_program(recorded,
                                                        monkeypatch,
                                                        with_median,
                                                        compat):
    """The film program ("film", with_median) is one film launch, plus
    the median's in its with_median form, in the configured mode; the
    sample count read on the device."""
    r = WavefrontRenderer(RenderConfig(width=16, height=8, total_samples=4,
                                       samples_per_frame=2,
                                       reference_compat=compat),
                          device="cpu")
    r.load_static_scene(cornell_box_scene())
    r.setup()
    monkeypatch.setattr(F, "_path", lambda x: "cuda")
    samples = torch.tensor(2.0)
    final, post = r._film(torch.rand(16 * 8 * 2, 3), with_median,
                          torch.zeros(8, 16, 3), samples)
    names = [n for n, _ in recorded]
    assert names == (["film", "median3x3"] if with_median else ["film"])
    assert recorded[0][1].old_ptr == samples.data_ptr()
    if with_median:
        assert recorded[1][1].compat == int(compat)
    else:
        assert post is final


def test_counters_join_the_graphs():
    for mod, attr, name in ((S, "raygen_launches", "raygen"),
                            (F, "film_launches", "film"),
                            (F, "median_launches", "median3x3")):
        assert (mod, attr) in graphs.COUNTERS
        assert chip_smoke.COUNTERS[name] == (mod.__name__.rsplit(".")[-1],
                                             attr)
        assert name not in chip_smoke.OFF_PATH


W, H = 16, 8


def _fast():
    kw = fast_preset_kwargs(W, H, 64)
    kw.update(samples_per_frame=2)
    return RenderConfig(width=W, height=H, total_samples=64, max_depth=2,
                        nee_schedule=((1, 1.0),) * 2, **kw)


def _reference():
    return RenderConfig(width=W, height=H, total_samples=64,
                        samples_per_frame=16, max_depth=2)


@pytest.mark.parametrize("case", ["fast", "reference", "sharded"])
def test_calls_per_frame_are_the_schedule(case, monkeypatch):
    """raygen, film and median calls of small CPU frames (the fast preset
    below the median's threshold, the reference preset crossing it at 32
    spp, 2 shards of the card's schedule in samples mode) against
    chip_smoke's schedule, whose median count comes from the frames."""
    calls = dict.fromkeys(("raygen", "film", "median3x3"), 0)
    for mod, name, what in ((S, "generate_camera_rays", "raygen"),
                            (S, "generate_camera_rays_cutracer", "raygen"),
                            (F, "film", "film"),
                            (F, "reconstruct", "film"),
                            (F, "accumulate", "film"),
                            (F, "median_filter_3x3", "median3x3")):
        def counted(*a, _fn=getattr(mod, name), _what=what, **k):
            calls[_what] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(mod, name, counted)
    if case == "sharded":
        r = ShardedRenderer(_fast().replace(shard_mode="samples"),
                            [torch.device("cpu")] * 2)
    else:
        r = WavefrontRenderer(_fast() if case == "fast" else _reference(),
                              camera_mode="collada", device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.set_viewpoint([0, 0.75, 2.5], [0, 0.75, 0])
    chip_smoke.reset_launches()
    frames = 3
    for _ in range(frames):
        r.render()
    want = (chip_smoke.sharded_launches(r, frames) if case == "sharded"
            else chip_smoke.expected_launches(r, frames))
    assert calls == {k: want[k] for k in calls}
    # the fast and sharded frames all run the median (6 spp < 32); the
    # reference frames at 0 and 16 spp, not at 32
    assert want["median3x3"] == (2 if case == "reference" else frames)
