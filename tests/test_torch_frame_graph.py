"""The fused frame's programs (render/engine.py, render/graphs.py) on the
CPU: what a CUDA graph of them replays on the card, run eagerly.

* ``rng.uniform`` with its key words as 0-d int64 tensors (a
  ``rng.KeyTable``'s entries, what a captured frame reads) is bit-equal
  to the int form and to ``jax.random.uniform``.
* ``bounce.frame_keys`` is the fold_in/split chain the JAX package's
  bounce loop derives (depths 3 and 4, NEE 1x1.0 and 2x0.5, 1-3
  lights), and a KeyTable loaded with it holds the same words.
* ``filters.accumulate`` with the sample count as a 0-d tensor, and
  ``run_depth_compacted`` with the live count as the partition's 0-d
  tensor, are bit-equal to their host-number forms.
* Whole frames: the Cornell box and terrain n=8 under
  ``max_leaf_size=4``, at 32x32, 2 spp per frame, the fast preset, the
  reference defaults and the fast preset under ``compact_depths``; 3
  frames, a camera move before the third.  The fused frame
  (``fuse_frame="yes"``: the programs reading keys, camera and sample
  count from their static buffers) is bit-equal, raw and shown image,
  to the frame computed stage by stage from host numbers (``host_frame``
  below: keys as ints, the camera's arrays, a host live count, host
  floats in the film, as the engine computed it before its programs
  read buffers) and, unfused, to ``fuse_frame="no"``; and it is held
  against the JAX engine's ``fuse_frame="yes"`` frame (its "xla"
  traversal, interpret-mode partition) within tests/test_torch_engine.py's
  tolerance: rtol 1e-4, atol 1e-5, at most 1% of pixels outside.
* The "xla" traversal (tree width 16 under "auto"): the fused frame
  refuses graphs, naming the route (a warning where graphs are on), and
  runs its programs eagerly, bit-equal to the unfused frame.
"""

import warnings

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.config import fast_preset_kwargs as jax_fast
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops.pallas import partition as jax_partition
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer

import torch

from cuda_raytracer_tpu_torch import rng
from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import filters as F
from cuda_raytracer_tpu_torch.ops.partition import compact_live_payload
from cuda_raytracer_tpu_torch.render import bounce
from cuda_raytracer_tpu_torch.render.backends import xla_passes
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

W, H, SPF, FRAMES = 32, 32, 2, 3
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
VIEWS = {"cornell": ([0, 0.75, 2.5], [0, 0.75, 0]),
         "terrain": ([0, 1.3, 1.3], [0, 0, 0])}
#: the camera move before the last frame
MOVED = {"cornell": ([0.05, 0.8, 2.45], [0, 0.75, 0]),
         "terrain": ([0.05, 1.25, 1.35], [0, 0, 0])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py (whose fixture
    names the rounding it guards against); these tests compare to the
    bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed,data", [(0, 0), (7, 3), (1234, 2000),
                                       (-5, 3001)])
@pytest.mark.parametrize("shape", [(1,), (257, 2), (1024, 3)])
def test_uniform_tensor_key_words(seed, data, shape):
    key = rng.fold_in(rng.PRNGKey(seed), data)
    table = rng.KeyTable(["k"], "cpu")
    table.load({"k": key})
    words = table["k"]
    assert all(w.dtype == torch.int64 and w.dim() == 0 for w in words)
    got = rng.uniform(words, shape, "cpu")
    want = rng.uniform(key, shape, "cpu")
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    j = jax.random.uniform(
        jax.random.fold_in(jax.random.PRNGKey(seed), data), shape,
        jnp.float32)
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(j).view(np.int32))


def _jax_chain(cfg, num_lights, key):
    """The keys the JAX package's bounce loop derives inline, by name."""
    out = {"raygen": jax.random.fold_in(key, 0)}
    for depth in range(cfg.max_depth):
        num_nee = (cfg.nee_schedule[depth][0]
                   if depth < len(cfg.nee_schedule) else 0)
        k_d = jax.random.fold_in(key, 1000 + depth)
        for s in range(num_nee):
            k_s = jax.random.fold_in(k_d, s)
            for li in range(num_lights):
                out["nee", depth, s, li] = jax.random.fold_in(k_s, li)
        if depth + 1 < cfg.max_depth:
            k_b = jax.random.fold_in(key, 2000 + depth)
            out["shared", depth] = jax.random.fold_in(k_b, 17)
            out["hemi", depth], out["fresnel", depth] = jax.random.split(k_b)
            out["rr", depth] = jax.random.fold_in(key, 3000 + depth)
    return out


@pytest.mark.parametrize("depth", [3, 4])
@pytest.mark.parametrize("nee", [(1, 1.0), (2, 0.5)])
@pytest.mark.parametrize("lights", [1, 2, 3])
def test_frame_keys_are_the_chain(depth, nee, lights):
    cfg = RenderConfig(max_depth=depth, nee_schedule=(nee,) * depth)
    frame = 5
    host = bounce.frame_keys(
        cfg, lights, rng.fold_in(rng.PRNGKey(cfg.seed), frame))
    want = _jax_chain(cfg, lights,
                      jax.random.fold_in(jax.random.PRNGKey(cfg.seed), frame))
    assert host.keys() == want.keys()
    assert len(host) == 1 + depth * nee[0] * lights + 4 * (depth - 1)
    for name, k in want.items():
        assert host[name] == tuple(int(x) for x in np.asarray(k)), name
    table = rng.KeyTable(bounce.frame_keys(cfg, lights, (0, 0)), "cpu")
    table.load(host)
    for name, k in host.items():
        assert tuple(int(w) for w in table[name]) == k, name


def test_key_table_refuses_other_names():
    cfg = RenderConfig(max_depth=3)
    table = rng.KeyTable(bounce.frame_keys(cfg, 1, (0, 0)), "cpu")
    with pytest.raises(ValueError, match="other keys"):
        table.load(bounce.frame_keys(cfg, 2, (0, 0)))


# ---------------------------------------------------------------------------
# the film's sample count and the compacted depth's live count as tensors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("old", [0, 2, 30, 96, 1022])
def test_accumulate_tensor_weight(old):
    g = np.random.default_rng(old)
    final = torch.from_numpy(g.random((H, W, 3), dtype=np.float32) * 3)
    new = torch.from_numpy(g.random((H, W, 3), dtype=np.float32) * 3)
    want = F.accumulate(final, new, float(old), float(SPF))
    got = F.accumulate(final, new, torch.tensor(float(old)), float(SPF))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


# ---------------------------------------------------------------------------
# whole frames
# ---------------------------------------------------------------------------


def port_config(setting, scene, **over):
    extra = dict(max_leaf_size=4) if scene == "terrain" else {}
    if setting == "reference":
        return RenderConfig(width=W, height=H, total_samples=SPF * FRAMES,
                            samples_per_frame=SPF, **extra, **over)
    kw = fast_preset_kwargs(W, H, SPF * FRAMES)
    kw.update(samples_per_frame=SPF, compact_depths=setting == "compact",
              **extra, **over)
    return RenderConfig(width=W, height=H, total_samples=SPF * FRAMES,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


def jax_config(setting, scene):
    extra = dict(max_leaf_size=4) if scene == "terrain" else {}
    if setting == "reference":
        return JaxConfig(width=W, height=H, total_samples=SPF * FRAMES,
                         samples_per_frame=SPF, fuse_frame="yes",
                         traversal="xla", **extra)
    kw = jax_fast(W, H, SPF * FRAMES)
    kw.update(traversal="xla", traversal_secondary="xla",
              traversal_rr="xla", samples_per_frame=SPF, fuse_frame="yes",
              compact_depths=setting == "compact", **extra)
    return JaxConfig(width=W, height=H, total_samples=SPF * FRAMES,
                     max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


def _frames(r, scene):
    """FRAMES frames of r (the last after the camera move): (raw, shown)
    images per frame."""
    out = []
    for f in range(FRAMES):
        if f == FRAMES - 1:
            r.set_viewpoint(*MOVED[scene])
        r.render()
        assert r.dropped == 0
        out.append((r.get_raw_image(), r.get_image()))
    return out


def _port(setting, scene, **over):
    r = WavefrontRenderer(port_config(setting, scene, **over),
                          camera_mode="collada", device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True)
                        if scene == "cornell" else terrain_scene(n=8))
    r.set_viewpoint(*VIEWS[scene])
    return r


def _host_depth_compacted(J, cfg, scene, packed, nl, light, keys, depth, m):
    """A compacted depth with the live count ``nl`` a host int, the
    radiance added over the live prefix only."""
    sl = packed[:m]
    o, d, alive, importance, ce, ids = bounce.unpack_state(sl, nl)
    tr = J["trace_rr_dense"]
    Jd = dict(J, trace=tr, trace_secondary=tr, trace_secondary_compact=tr)
    light_m = torch.zeros((m, 3), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.int64)
    o, d, valid, importance, light_m, ce, dropped = bounce.run_depth(
        Jd, cfg, scene, (o, d, alive, importance, light_m, ce, zero),
        keys, depth)
    packed_new = (bounce.pack_state(o, d, valid & alive, importance, ce, ids)
                  if depth + 1 < cfg.max_depth else sl)
    k = min(nl, m)
    light.index_add_(0, torch.where(alive[:k], ids[:k], 0).long(),
                     torch.where(alive[:k, None], light_m[:k], 0.0))
    return packed_new, dropped


def host_frame(r, final, image_samples, frame_index, buckets):
    """One frame of renderer ``r``'s config from host numbers, stage by
    stage: (final, shown image).  ``buckets`` a renderer whose sticky
    bucket rule the compacted depths use."""
    cfg, scene = r.config, r.scene
    J = bounce.make_stage_fns(cfg)
    keys = bounce.frame_keys(cfg, scene.num_lights,
                             rng.fold_in(rng.PRNGKey(cfg.seed), frame_index))
    o, d = r._raygen(keys["raygen"])
    carry = bounce.initial_carry(o, d)
    dense = cfg.rr_start_depth if cfg.compact_depths else cfg.max_depth
    for depth in range(dense):
        carry = bounce.run_depth(J, cfg, scene, carry, keys, depth)
    light = carry[4]
    if cfg.compact_depths:
        o, d, valid, imp, light, ce, _ = carry
        ids = torch.arange(o.shape[0], dtype=torch.int32)
        packed, n_live = compact_live_payload(
            bounce.pack_state(o, d, valid, imp, ce, ids))
        nl = int(n_live)
        for depth in range(cfg.rr_start_depth, cfg.max_depth):
            if nl == 0:
                break
            m = buckets.bucket(depth, nl, packed.shape[0])
            packed_m, dr = _host_depth_compacted(J, cfg, scene, packed, nl,
                                                 light, keys, depth, m)
            assert int(dr) == 0
            if depth + 1 < cfg.max_depth:
                packed, n_live = compact_live_payload(packed_m)
                nl = int(n_live)
    return r._film(light, image_samples < cfg.post_process_threshold, final,
                   float(image_samples))


def _host_frames(setting, scene):
    r = _port(setting, scene, fuse_frame="yes")
    r.setup()
    buckets = WavefrontRenderer(r.config, device="cpu")
    final = torch.zeros((H, W, 3), dtype=torch.float32)
    samples, out = 0, []
    for f in range(FRAMES):
        if f == FRAMES - 1:
            r.set_viewpoint(*MOVED[scene])
            final, samples = torch.zeros_like(final), 0
        final, post = host_frame(r, final, samples, f, buckets)
        samples += SPF
        shown = post if samples < r.config.post_process_threshold else final
        out.append((final.numpy().copy(), shown.numpy().copy()))
    return out


CASES = [(setting, scene) for scene in ("cornell", "terrain")
         for setting in ("fast", "reference", "compact")]


@pytest.fixture(scope="module")
def jax_frames():
    """The JAX engine's fused frames (last frame's raw image) per case."""
    old, jax_partition._INTERPRET = jax_partition._INTERPRET, True
    out = {}
    try:
        for setting, scene in CASES:
            jr = JaxRenderer(jax_config(setting, scene), camera_mode="collada")
            jr.load_static_scene(jax_cornell(with_spheres=True)
                                 if scene == "cornell" else jax_terrain(n=8))
            jr.set_viewpoint(*VIEWS[scene])
            for f in range(FRAMES):
                if f == FRAMES - 1:
                    jr.set_viewpoint(*MOVED[scene])
                jr.render()
            out[setting, scene] = jr.get_raw_image()
    finally:
        jax_partition._INTERPRET = old
    return out


@pytest.mark.parametrize("setting,scene", CASES)
def test_fused_frame_bit_equal(setting, scene, jax_frames):
    r = _port(setting, scene, fuse_frame="yes")
    assert r.fused and not r.graphed  # the programs, called on the CPU
    assert r.compacting == (setting == "compact")
    fused = _frames(r, scene)
    host = _host_frames(setting, scene)
    unfused = (None if setting == "compact" else
               _frames(_port(setting, scene, fuse_frame="no"), scene))
    for f in range(FRAMES):
        for i in (0, 1):
            np.testing.assert_array_equal(fused[f][i], host[f][i])
            if unfused is not None:
                np.testing.assert_array_equal(fused[f][i], unfused[f][i])
    got, want = fused[-1][0], jax_frames[setting, scene]
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{setting} {scene}: {int(bad.sum())} of {bad.size} pixels "
          f"outside rtol={RTOL} atol={ATOL} against the JAX engine")
    assert np.isfinite(got).all() and got.mean() > 0.01
    assert bad.mean() <= MAX_BAD


def test_compacted_depth_tensor_live_count():
    """run_depth_compacted with the partition's 0-d live count equals the
    host-count form (radiance over the live prefix only) to the bit."""
    r = _port("compact", "cornell", fuse_frame="yes")
    r.setup()
    cfg, scene = r.config, r.scene
    keys = bounce.frame_keys(cfg, scene.num_lights, rng.PRNGKey(3))
    carry = bounce.initial_carry(*r._raygen(keys["raygen"]))
    for depth in range(cfg.rr_start_depth):
        carry = bounce.run_depth(r._stages, cfg, scene, carry, keys, depth)
    o, d, valid, imp, light, ce, _ = carry
    ids = torch.arange(o.shape[0], dtype=torch.int32)
    packed, n_live = compact_live_payload(
        bounce.pack_state(o, d, valid, imp, ce, ids))
    nl = int(n_live)
    assert 0 < nl < o.shape[0]
    m = r.bucket(cfg.rr_start_depth, nl, packed.shape[0])
    assert m > nl  # lanes past the live count exist
    got_light, want_light = light.clone(), light.clone()
    got, _, dr = bounce.run_depth_compacted(
        r._stages, cfg, scene, packed, n_live, got_light, keys,
        cfg.rr_start_depth, m)
    want, want_dr = _host_depth_compacted(
        r._stages, cfg, scene, packed, nl, want_light, keys,
        cfg.rr_start_depth, m)
    assert torch.equal(got_light.view(torch.int32),
                       want_light.view(torch.int32))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert int(dr) == int(want_dr) == 0


# ---------------------------------------------------------------------------
# the "xla" route
# ---------------------------------------------------------------------------


def test_xla_passes():
    assert xla_passes(RenderConfig(traversal="dfs"), 16) == ()
    assert xla_passes(RenderConfig(), 8) == ()
    assert xla_passes(RenderConfig(), 16) == ("camera", "secondary")
    assert xla_passes(RenderConfig(traversal_rr="xla"), 4) == ()
    assert xla_passes(RenderConfig(traversal_rr="xla", rr_start_depth=2),
                      4) == ("roulette",)
    assert xla_passes(RenderConfig(traversal_secondary="xla"), 4) == (
        "secondary",)


def test_xla_route_runs_eagerly():
    """Tree width 16 under "auto" traces through "xla": the fused frame
    refuses graphs naming the route (a warning where they are on) and
    runs its programs eagerly, bit-equal to the unfused frame."""
    r = _port("reference", "terrain", fuse_frame="yes", tree_width=16,
              max_depth=2)
    assert r.graph_refusal is not None and "'xla'" in r.graph_refusal
    assert "tree width 16" in r.graph_refusal
    r.graphs.enabled = True  # as on the card
    with pytest.warns(UserWarning, match="'xla'"):
        r.setup()
    assert r.fused and not r.graphed
    got = _frames(r, "terrain")
    e = _port("reference", "terrain", fuse_frame="no", tree_width=16,
              max_depth=2)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        want = _frames(e, "terrain")
    assert len(r.graphs) == 0 and r.graphs.captures == 0
    for f in range(FRAMES):
        np.testing.assert_array_equal(got[f][0], want[f][0])
        np.testing.assert_array_equal(got[f][1], want[f][1])
    r8 = _port("reference", "terrain", fuse_frame="yes", tree_width=8)
    assert r8.graph_refusal is None
