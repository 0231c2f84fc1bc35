"""The port's shading and film stages against the JAX package's, stage by
stage, on the same inputs and the same uniforms.

Tolerance rtol=1e-5, atol=1e-6: the stages take sin/cos/sqrt/acos and
3-term dot products and cross-product norms, whose last bits differ
between XLA's and torch's CPU kernels (and whose sums may be taken in
another order); integer and boolean outputs (valid, bsdf, lobe masks)
are exact.
"""

import math

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.ops import filters as JF
from cuda_raytracer_tpu.ops import shade as JS
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten

import torch

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.ops import filters as PF
from cuda_raytracer_tpu_torch.ops import shade as PS
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here: with its CPU thread pool, the
    chunk of a large elementwise op that one worker thread computes has
    been seen to round differently in an occasional process (a block of
    rays' t off in the last bits, amplified by cancellation), never with
    one thread; these tests compare to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, name=""):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, name
    if want.dtype.kind in "biu":
        np.testing.assert_array_equal(got, want, err_msg=name)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=name)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def hits():
    """Both scenes (classic spheres: a mirror and a glass lobe), 4096
    rays from the camera and from inside the box, traced once by the
    JAX oracle; both packages' hit records from the same (o, d, t,
    prim)."""
    ours, _ = flatten_scene(cornell_box_scene(sphere_bsdfs="classic"),
                            tree_width=4, max_leaf_size=4, device="cpu")
    ref, _ = jax_flatten(jax_cornell(sphere_bsdfs="classic"), tree_width=4,
                         max_leaf_size=4)
    rng = np.random.default_rng(21)
    n = 4096
    o = np.where(np.arange(n)[:, None] % 2 == 0, [0.0, 0.75, 2.5],
                 rng.uniform([-0.9, 0.1, -0.9], [0.9, 1.4, 0.9], (n, 3)))
    tgt = rng.uniform([-1, 0, -1], [1, 1.5, -0.5], (n, 3))
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    o, d = o.astype(np.float32), d.astype(np.float32)
    tr = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                          jnp.ones(n, bool))
    t, prim = np.asarray(tr.t), np.asarray(tr.prim)
    hj = JS.compute_hits(ref, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(t), jnp.asarray(prim))
    hp = PS.compute_hits(ours, T(o), T(d), T(t), T(prim))
    imp = rng.uniform(0.2, 1.0, (n, 3)).astype(np.float32)
    return ours, ref, hp, hj, o, d, imp


@pytest.mark.parametrize("order", [None, "tiles8", "tiles32s"])
def test_camera_rays(order):
    args = (32, 16, 2, [0.1, 0.75, 2.5],
            np.eye(3) @ np.array([[0.96, 0, 0.28], [0, 1, 0],
                                  [-0.28, 0, 0.96]]),
            math.tan(math.radians(50.0) / 2),
            math.tan(math.radians(35.0) / 2))
    kj = jax.random.fold_in(jax.random.PRNGKey(15618), 0)
    oj, dj = JS.generate_camera_rays(
        kj, *args[:3], jnp.asarray(args[3], jnp.float32),
        jnp.asarray(args[4], jnp.float32), *args[5:], pix_order=order)
    op, dp = PS.generate_camera_rays(
        tuple(int(x) for x in np.asarray(kj)), *args, pix_order=order,
        device="cpu")
    close(op, oj, "o")
    close(dp, dj, "d")


def test_tile_ranks():
    for w, h in ((64, 32), (96, 40)):
        assert np.array_equal(PS.tiles32s_rank(w, h), JS.tiles32s_rank(w, h))
    assert np.array_equal(PS.tiles8_rank(64, 32), JS.tiles8_rank(64, 32))


def test_compute_hits(hits):
    _, _, hp, hj, _, _, _ = hits
    assert int(hp.valid.sum()) > 3000
    for f in hj._fields:
        close(getattr(hp, f), getattr(hj, f), f)


def test_nee_and_emission(hits):
    ours, ref, hp, hj, _, _, imp = hits
    rng = np.random.default_rng(3)
    u = rng.random((len(imp), 2)).astype(np.float32)
    out_j = JS.nee_shadow_rays(ref, hj, jnp.asarray(imp), 0,
                               jnp.asarray(u), 1.0)
    out_p = PS.nee_shadow_rays(ours, hp, T(imp), 0, T(u), 1.0)
    for name, a, b in zip(("o", "d", "max_t", "li", "ok"), out_p, out_j):
        close(a, b, name)
    assert int(out_p[4].sum()) > 1000
    ce = rng.random(len(imp)) < 0.7
    close(PS.emission_at_hits(ours, hp, T(imp), T(ce)),
          JS.emission_at_hits(ref, hj, jnp.asarray(imp), jnp.asarray(ce)),
          "emission")


@pytest.mark.parametrize("mode", ["key", "u", "w_shared"])
def test_scatter(hits, mode):
    ours, ref, hp, hj, _, _, imp = hits
    rng = np.random.default_rng(4)
    n = len(imp)
    kj = jax.random.fold_in(jax.random.PRNGKey(9), 2001)
    kp = tuple(int(x) for x in np.asarray(kj))
    kw_j, kw_p = {}, {}
    if mode == "u":
        u = rng.random((n, 2)).astype(np.float32)
        kw_j, kw_p = dict(u=jnp.asarray(u)), dict(u=T(u))
    elif mode == "w_shared":
        u = np.repeat(rng.random((n // 1024, 2)), 1024, 0).astype(np.float32)
        w_j = JS._spherical_sample(jnp.asarray(u))
        w_p = PS._spherical_sample(T(u))
        close(w_p, w_j, "w_shared")
        kw_j, kw_p = dict(w_shared=w_j), dict(w_shared=w_p)
    out_j = JS.scatter(ref, hj, jnp.asarray(imp), kj, **kw_j)
    out_p = PS.scatter(ours, hp, T(imp), kp, **kw_p)
    for name, a, b in zip(("o", "d", "importance", "valid",
                           "count_emission"), out_p, out_j):
        close(a, b, name)
    # every lobe is exercised: diffuse, mirror and glass vertices
    fn = ours.bsdf_fn[hp.bsdf][hp.valid]
    assert {0, 1, 3} <= set(fn.tolist())


def test_film():
    rng = np.random.default_rng(5)
    w, h, spp = 64, 32, 2
    light = rng.random((w * h * spp, 3)).astype(np.float32)
    for sample_major, order in ((False, None), (True, "tiles32s")):
        inv = None if order is None else JS.tiles32s_rank(w, h)
        ij = JF.reconstruct(jnp.asarray(light), w, h, spp,
                            inv_order=None if inv is None
                            else jnp.asarray(inv),
                            sample_major=sample_major)
        ip = PF.reconstruct(T(light), w, h, spp,
                            inv_order=None if inv is None else T(inv),
                            sample_major=sample_major)
        close(ip, ij, f"reconstruct {order}")
    prev = rng.random((h, w, 3)).astype(np.float32)
    acc_j = JF.accumulate(jnp.asarray(prev), ij, jnp.float32(2.0),
                          jnp.float32(2.0))
    acc_p = PF.accumulate(T(prev), ip, 2.0, 2.0)
    close(acc_p, acc_j, "accumulate")
    for compat in (False, True):
        close(PF.median_filter_3x3(acc_p, compat),
              JF.median_filter_3x3(acc_j, compat), f"median {compat}")
    close(PF.tonemap(acc_p), JF.tonemap(acc_j), "tonemap")
