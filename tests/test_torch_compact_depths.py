"""Whole-depth compaction in the port (cfg.compact_depths), on the CPU,
against the JAX package.

* ``ops/compact.compact`` against the JAX ``compact``: outputs, count
  and dropped equal, overflow included.
* ``pack_state`` / ``unpack_state``: the port's entry-major [N', 16]
  payload holds, field by field, what the JAX package's [16, N'] payload
  holds (ray ids as int32 bit patterns here, bias-encoded there), and
  the round trip returns the state exactly.
* The 16-field partition (plain version) against one interpret-mode JAX
  ``compact_live_payload``: n_live equal, the live prefix equal.
* A compacted frame (``compact_depths=True, fuse_frame="yes"``,
  ``rr_start_depth=1`` as the JAX package's own test has it): the Cornell
  box at 64x32, 17 spp per frame (34,816 lanes, past the 32,768 at
  which the first bucket's grain outgrows 1024 lanes), 2 frames, depth
  4, against the JAX engine's compacted frame (its "xla" traversal,
  interpret-mode partition): per pixel within
  rtol 1e-4 + atol 1e-5 on at least 99% of pixels (the tolerance of
  tests/test_torch_engine.py), and the per-depth capacity buckets equal
  to the JAX engine's after each frame.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.config import RenderConfig as JaxConfig
from cuda_raytracer_tpu.config import fast_preset_kwargs as jax_fast
from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.ops.compact import compact as jax_compact
from cuda_raytracer_tpu.ops.pallas import partition as jax_partition
from cuda_raytracer_tpu.ops.pallas.wavefront2 import RID_BIAS
from cuda_raytracer_tpu.render import bounce as jax_bounce
from cuda_raytracer_tpu.render.engine import WavefrontRenderer as JaxRenderer

import torch

from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.ops import partition
from cuda_raytracer_tpu_torch.ops.compact import compact
from cuda_raytracer_tpu_torch.render import bounce
from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

W, H, SPF, FRAMES = 64, 32, 17, 2
RTOL, ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
VIEW = ([0, 0.75, 2.5], [0, 0.75, 0])


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in test_torch_engine.py, whose fixture
    names the rounding it once guarded against (torch's CPU float32
    ``sqrt``, now replaced by ``ops.intersect.sqrt_rn`` in the plain
    versions); these tests compare to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("n,capacity", [(1000, 1000), (1000, 150), (0, 8)])
def test_compact_matches_jax(n, capacity):
    rng = np.random.default_rng(n + capacity)
    mask = rng.random(n) < 0.3
    a = rng.standard_normal((n, 3)).astype(np.float32)
    b = rng.integers(0, 100, n).astype(np.int32)
    outs, count, dropped = compact(torch.from_numpy(mask),
                                   [torch.from_numpy(a), torch.from_numpy(b)],
                                   capacity)
    j_outs, j_count, j_dropped = jax_compact(
        jnp.asarray(mask), [jnp.asarray(a), jnp.asarray(b)], capacity)
    for x, y in zip(outs, j_outs):
        assert x.dtype == torch.from_numpy(np.asarray(y)).dtype
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    assert int(count) == int(j_count) and int(dropped) == int(j_dropped)
    assert int(dropped) == max(int(mask.sum()) - capacity, 0)


def _random_state(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, 3)).astype(np.float32),
            rng.normal(size=(n, 3)).astype(np.float32),
            rng.random(n) < 0.3,
            rng.random((n, 3)).astype(np.float32),
            rng.random(n) < 0.5,
            rng.permutation(n).astype(np.int32))


@pytest.mark.parametrize("n", [1024, 1500])
def test_pack_state_matches_jax(n):
    """Field by field against the JAX payload, padding to the 1024-lane
    block included; then the round trip."""
    state = _random_state(n, seed=n)
    ours = bounce.pack_state(*(torch.from_numpy(x) for x in state))
    ref = np.asarray(jax_bounce.pack_state(*(jnp.asarray(x)
                                              for x in state))).T
    assert ours.shape == ref.shape == (-(-n // 1024) * 1024, 16)
    p = ours.numpy()
    fields = [f for f in range(16) if f != 6]
    np.testing.assert_array_equal(p[:, fields], ref[:, fields])
    np.testing.assert_array_equal(p.view(np.int32)[:, 6],
                                  ref.view(np.int32)[:, 6] & (RID_BIAS - 1))
    assert np.all(p[n:, 7] < 0)

    o, d, alive, imp, ce, ids = bounce.unpack_state(ours, n)
    jo, jd, jalive, jimp, jce, jids = jax_bounce.unpack_state(
        jnp.asarray(ref.T), jnp.int32(n))
    for got, want, ref_j in ((o, state[0], jo), (d, state[1], jd),
                             (alive, state[2], jalive),
                             (imp, state[3], jimp), (ce, state[4], jce),
                             (ids, state[5], jids)):
        np.testing.assert_array_equal(got.numpy()[:n], want)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref_j))


def test_unpack_state_bounds_by_n_live():
    """Lanes at or past n_live are dead whatever they hold (the
    partition leaves them undefined)."""
    state = _random_state(2048, seed=3)
    packed = bounce.pack_state(*(torch.from_numpy(x) for x in state))
    packed[:, 7] = 1.0
    _, _, alive, _, _, _ = bounce.unpack_state(packed, torch.tensor(700))
    assert alive[:700].all() and not alive[700:].any()


def test_state_partition_matches_pallas(monkeypatch):
    """The 16-field payload partition against the JAX kernel (interpret
    mode) on the same state: n_live, and the live prefix, equal (ray ids
    stay sorted: the radiance scatter needs unique ids)."""
    monkeypatch.setattr(jax_partition, "_INTERPRET", True)
    state = list(_random_state(4096, seed=5))
    state[5] = np.arange(4096, dtype=np.int32)  # the engine's ray ids
    ours = bounce.pack_state(*(torch.from_numpy(x) for x in state))
    packed, n_live = partition.compact_live_payload(ours)
    j_packed, j_live = jax_partition.compact_live_payload(
        jax_bounce.pack_state(*(jnp.asarray(x) for x in state)))
    k = int(n_live)
    assert k == int(j_live) == int(state[2].sum())
    ref = np.asarray(j_packed).T[:k]
    got = packed.numpy()[:k]
    fields = [f for f in range(16) if f != 6]
    np.testing.assert_array_equal(got[:, fields], ref[:, fields])
    ids = got.view(np.int32)[:, 6]
    np.testing.assert_array_equal(ids,
                                  ref.view(np.int32)[:, 6] & (RID_BIAS - 1))
    np.testing.assert_array_equal(ids, np.nonzero(state[2])[0])


BASE = dict(width=W, height=H, total_samples=SPF * FRAMES, max_depth=4,
            nee_schedule=((1, 1.0),) * 4)
OVER = dict(samples_per_frame=SPF, rr_start_depth=1, compact_depths=True,
            fuse_frame="yes")


@pytest.fixture(scope="module")
def frames():
    """Both engines' compacted frames: (port image, JAX image, port
    buckets after each frame, JAX buckets after each frame)."""
    jax_partition._INTERPRET, old = True, jax_partition._INTERPRET
    try:
        kw = jax_fast(W, H, SPF * FRAMES)
        kw.update(traversal="xla", traversal_secondary="xla",
                  traversal_rr="xla", **OVER)
        jr = JaxRenderer(JaxConfig(**BASE, **kw), camera_mode="collada")
        jr.load_static_scene(jax_cornell(with_spheres=True))
        jr.set_viewpoint(*VIEW)
        j_buckets = []
        for _ in range(FRAMES):
            jr.render()
            j_buckets.append(dict(jr._depth_buckets))
    finally:
        jax_partition._INTERPRET = old

    kw = fast_preset_kwargs(W, H, SPF * FRAMES)
    kw.update(**OVER)
    r = WavefrontRenderer(RenderConfig(**BASE, **kw), camera_mode="collada",
                          device="cpu")
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.set_viewpoint(*VIEW)
    assert r.compacting
    buckets = []
    for _ in range(FRAMES):
        r.render()
        assert r.dropped == 0
        buckets.append(dict(r._depth_buckets))
    return r.get_raw_image(), jr.get_raw_image(), buckets, j_buckets


def test_compacted_frame_matches_jax(frames):
    got, want, _, _ = frames
    bad = ~np.isclose(got, want, rtol=RTOL, atol=ATOL).all(-1)
    print(f"{int(bad.sum())} of {bad.size} pixels outside rtol={RTOL} "
          f"atol={ATOL}; max |diff| {float(np.abs(got - want).max()):.3g}")
    assert np.isfinite(got).all() and got.mean() > 0.05
    assert bad.mean() <= MAX_BAD


def test_depth_buckets_match_jax(frames):
    """The sticky buckets: equal to the JAX engine's after each frame,
    below the full population; the first on a 2048-lane grain
    (n / 32 rounded up to 1024), the later ones on the grain of the
    bucket before them."""
    _, _, buckets, j_buckets = frames
    print(f"buckets per frame {buckets}")
    assert buckets == j_buckets
    n = W * H * SPF
    for b in buckets:
        assert sorted(b) == [1, 2, 3]
        assert b[1] % 2048 == 0 and b[1] < n
        assert all(m % 1024 == 0 for m in b.values())


def test_compaction_only_when_fused():
    """The JAX engine's rule: compaction needs a fused frame ("yes", or
    "auto" on the accelerator) and 0 < rr_start_depth < max_depth; the
    buckets reset with the stages (a scene load)."""
    def renderer(**over):
        return WavefrontRenderer(RenderConfig(**{**BASE, **OVER, **over}),
                                 device="cpu")

    assert renderer().compacting
    assert not renderer(fuse_frame="auto").compacting  # the CPU
    assert not renderer(fuse_frame="no").compacting
    assert not renderer(rr_start_depth=0).compacting
    assert not renderer(rr_start_depth=4).compacting
    assert not renderer(compact_depths=False).compacting
    r = renderer()
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.setup()
    assert r.bucket(1, 5000, 65536) == 6144
    assert r.bucket(1, 3000, 65536) == 6144  # sticky
    assert r.bucket(1, 7000, 65536) == 8192  # grows
    r.load_static_scene(cornell_box_scene(with_spheres=True))
    r.setup()
    assert r._depth_buckets == {}
