"""The port's wavefront traversal (plain versions, on the CPU) against
the JAX package: the brute-force oracle, and the Pallas count and pack
kernels in interpret mode.

Tolerances.  Against ``trace_bruteforce`` (op-by-op jnp, which rounds
as torch does): hit/miss exact, t equal to the bit, prim equal except
where two prims tie at a bit-equal t (the wavefront keeps the largest
prim of the tied hits it recorded, the oracle the lowest index).  Shadow
decisions ``t > max_t - eps`` exact.  ``compact=True`` equals
``compact=False`` to the bit.  Against interpret-mode Pallas, which
runs under jit where XLA's CPU fusion contracts multiply-adds: counts
exact, routed entries equal as sets per child with the carried bound
within rtol 1e-5 + atol 1e-6, hits likewise.

The fixtures are those of tests/test_wavefront2.py, rebuilt in the
port.  Its "box" scene (Cornell box with spheres, max_leaf_size=4) is
one leaf under the root in both packages, so the per-level comparison
runs on the soup scene, whose level 3 has inner and leaf children.
The CUDA kernels are held against these plain versions on the card by
chip_smoke.py.
"""

import bisect

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.models.cornell import cornell_box_scene as jax_cornell
from cuda_raytracer_tpu.models.terrain import terrain_scene as jax_terrain
from cuda_raytracer_tpu.ops.pallas import wavefront2 as jax_wf2
from cuda_raytracer_tpu.ops.traverse import trace_bruteforce
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse

import torch

from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF

#: against jitted JAX (interpret-mode Pallas)
JIT_RTOL, JIT_ATOL = 1e-5, 1e-6


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Run torch single-threaded here.  The rounding once put down to
    threads is torch's vectorized CPU float32 ``sqrt``, one ulp off the
    IEEE result on some hosts: threads only move where an op's vector
    body ends and its correctly rounded scalar tail begins, so one
    thread made it rarer without curing it.  The plain versions now take
    their roots from ``ops.intersect.sqrt_rn``; these tests compare to
    the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _soup(mod, bsdf):
    rng = np.random.default_rng(5)
    ntri = 1200
    base = rng.random((ntri, 3)) * 4 - 2
    v = base[:, None, :] + rng.random((ntri, 3, 3)) * 0.3
    mesh = mod.Mesh(
        v.reshape(-1, 3),
        np.tile([[0.0, 0.0, 1.0]], (ntri * 3, 1)),
        np.arange(ntri * 3).reshape(-1, 3),
        bsdf([1, 1, 1]),
    )
    return mod.Scene([mesh], [])


#: name -> (port scene, JAX scene, max_leaf, ray origin box)
SCENES = {
    "box": (lambda: cornell_box_scene(with_spheres=True),
            lambda: jax_cornell(with_spheres=True), 4, 0.9),
    "soup": (lambda: _soup(st, DiffuseBSDF), lambda: _soup(jst, JaxDiffuse),
             8, 3.0),
    "root_leaf": (lambda: cornell_box_scene(with_spheres=False),
                  lambda: jax_cornell(with_spheres=False), 64, 0.9),
    # three levels: pack 0 counts level 1, which has inner children
    "terrain": (lambda: terrain_scene(n=8), lambda: jax_terrain(n=8), 4,
                0.9),
    # width 8: levels [1, 8, 64, 15], packs 0 and 1 count for the next
    "soup8": (lambda: _soup(st, DiffuseBSDF), lambda: _soup(jst, JaxDiffuse),
              4, 3.0, 8),
}
_cache = {}


def scenes(name):
    if name not in _cache:
        mk_port, mk_jax, ml, box, *width = SCENES[name]
        width = width[0] if width else 4
        ours, _ = flatten_scene(mk_port(), tree_width=width,
                                max_leaf_size=ml, device="cpu")
        ref, _ = jax_flatten(mk_jax(), tree_width=width, max_leaf_size=ml)
        _cache[name] = (ours, ref, box)
    return _cache[name]


def random_rays(n, seed, origin_box):
    rng = np.random.default_rng(seed)
    o = ((rng.random((n, 3)) * 2 - 1) * origin_box).astype(np.float32)
    d = rng.standard_normal((n, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return o, d


def _trace(scene, o, d, valid, t_limit=None, **kw):
    res = wf.trace_closest_wavefront(
        scene, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(valid),
        None if t_limit is None else torch.from_numpy(t_limit), **kw)
    return res.t.numpy(), res.prim.numpy(), int(res.dropped)


def _oracle(ref, o, d, valid):
    r = trace_bruteforce(ref, jnp.asarray(o), jnp.asarray(d),
                         jnp.asarray(valid))
    return np.asarray(r.t), np.asarray(r.prim)


def check_closest(ta, pa, tb, pb):
    np.testing.assert_array_equal(pa < 0, pb < 0)
    np.testing.assert_array_equal(ta.view(np.int32), tb.view(np.int32))
    hit = pa >= 0
    ties = int((pa != pb)[hit].sum())
    print(f"{hit.sum()} hits, {ties} prim ties at bit-equal t")
    assert ties <= 0.01 * max(hit.sum(), 1)


@pytest.mark.parametrize("name,n,seed", [
    ("box", 1024, 1), ("soup", 777, 4), ("root_leaf", 1024, 2),
])
def test_closest_matches_bruteforce(name, n, seed):
    """Also an unpadded count (777 rays: the first 777 of 1024, so the
    oracle compiles one shape per scene), the root-is-leaf scene, which
    traverses through its one forced leaf slot, and invalid lanes, which
    miss."""
    ours, ref, box = scenes(name)
    assert ours.bvh.root_is_leaf == (name != "soup")
    o, d = random_rays(1024, seed, box)
    valid = np.arange(1024) % 5 != 0
    tb, pb = _oracle(ref, o, d, valid)
    o, d, valid = o[:n], d[:n], valid[:n]
    ta, pa, dropped = _trace(ours, o, d, valid)
    assert dropped == 0 and ta.shape == (n,)
    assert (pa >= 0).sum() > 50
    assert np.all(pa[~valid] == -1) and np.all(np.isinf(ta[~valid]))
    check_closest(ta, pa, tb[:n], pb[:n])


def _shadow_case(ref, n, seed, box, valid):
    o, d = random_rays(n, seed, box)
    tb, pb = _oracle(ref, o, d, valid)
    t_hit = np.where(pb >= 0, tb, 2.0).astype(np.float32)
    scale = np.where(np.arange(n) % 3 == 0, 0.5, 1.5).astype(np.float32)
    return o, d, tb, t_hit * scale


@pytest.mark.parametrize("compact", [False, True])
def test_shadow_decisions_match(compact):
    """Shadow mode (t_limit + kill) decides t > max_t - eps exactly as a
    full closest-hit trace of the oracle does."""
    ours, ref, box = scenes("soup")
    n = 1024
    valid = np.arange(n) % 4 != 1
    o, d, tb, max_t = _shadow_case(ref, n, 6, box, valid)
    ta, _, dropped = _trace(ours, o, d, valid, max_t, compact=compact)
    assert dropped == 0
    eps = np.float32(1e-3)
    np.testing.assert_array_equal(ta > max_t - eps, tb > max_t - eps)
    assert 0 < (ta > max_t - eps).sum() < n


def test_compacted_matches_plain():
    """compact=True must give the same bits: hits merge by ray id, so
    the compacted queue needs no inverse permutation."""
    ours, _, box = scenes("soup")
    n = 2048
    o, d = random_rays(n, 21, box)
    valid = (np.arange(n) * 2654435761 % 97) < 30
    ta, pa, _ = _trace(ours, o, d, valid)
    tb, pb, dropped = _trace(ours, o, d, valid, compact=True)
    assert dropped == 0
    np.testing.assert_array_equal(ta.view(np.int32), tb.view(np.int32))
    np.testing.assert_array_equal(pa, pb)
    assert np.all(pb[~valid] == -1) and (pb >= 0).sum() > 50


def test_compact_all_dead():
    ours, _, box = scenes("soup")
    o, d = random_rays(1024, 23, box)
    t, p, dropped = _trace(ours, o, d, np.zeros(1024, bool), compact=True)
    assert np.all(p == -1) and np.all(np.isinf(t)) and dropped == 0


def test_want_prim_false_same_t():
    """Shadow passes skip the prim ids: same t, prim -2 on a hit and -1
    on a miss."""
    ours, ref, box = scenes("soup")
    n = 1024
    valid = np.arange(n) % 7 != 3
    o, d, _, max_t = _shadow_case(ref, n, 33, box, valid)
    ta, pa, _ = _trace(ours, o, d, valid, max_t)
    tb, pb, _ = _trace(ours, o, d, valid, max_t, want_prim=False)
    np.testing.assert_array_equal(ta.view(np.int32), tb.view(np.int32))
    np.testing.assert_array_equal(pa >= 0, pb == -2)
    np.testing.assert_array_equal(pa < 0, pb == -1)


def test_capacity_matches_jax_rule():
    ours, _, _ = scenes("soup")
    sched = ours.bvh.wf_sched
    widest = max(len(lv[0]) for lv in sched[1:])
    assert wf.queue_capacity(2048, 2, sched) == (4 + widest + 2) * 1024
    assert wf.queue_capacity(1024, 2, scenes("box")[0].bvh.wf_sched) \
        == (2 + 1 + 2) * 1024


def test_queue_overflow_is_counted(monkeypatch):
    """A queue too small for a level loses that level's later segments:
    their entries are counted in dropped, nothing is written out of
    range, and every hit still reported is a true hit."""
    ours, _, box = scenes("soup")
    n = 1024
    o, d = random_rays(n, 9, box)
    valid = np.ones(n, bool)
    ta, pa, dropped = _trace(ours, o, d, valid)
    assert dropped == 0
    monkeypatch.setattr(wf, "queue_capacity", lambda *a: 1500)
    tb, pb, dropped = _trace(ours, o, d, valid)
    assert dropped > 0
    got = pb >= 0
    assert 0 < got.sum() < (pa >= 0).sum()
    assert np.all(pa[got] >= 0) and np.all(tb[got] >= ta[got])


# ---------------------------------------------------------------------------
# one level against the Pallas count and pack kernels (interpret mode)
# ---------------------------------------------------------------------------

C = jax_wf2.CHUNK


def _level_state(scene, o, d, valid, level, t_limit=None):
    """The port's level loop up to ``level`` (plain versions, a count at
    every level): (queue, seg_base, bound, cap) entering it."""
    bvh = scene.bvh
    W = bvh.width
    queue = wf.make_payload(
        torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(valid),
        None if t_limit is None else torch.from_numpy(t_limit))
    n = len(o)
    cap = wf.queue_capacity(n, 2, bvh.wf_sched)
    seg_base = torch.tensor([0, n], dtype=torch.int32)
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    bound = n
    for lv in bvh.wf_levels[:level]:
        counts = wf.count_plain(queue, seg_base, lv, bvh.wf_node_rows, W)
        seg_base_next, route, cursor, _ = wf.plan_regions(counts, lv, cap)
        out = torch.zeros((cap, 8))
        wf.pack_plain(queue, seg_base, lv, route, cursor, bvh.wf_node_rows,
                      scene.wf_prim_rows, W, t_limit is not None, 1e-3, out,
                      keys, dropped)
        queue, seg_base, bound = out, seg_base_next, cap
    return queue, seg_base, bound, cap


def _chunked_regions(counts):
    """The JAX layout's CHUNK-aligned regions of segments with these
    entry counts: (base in CHUNK units, total chunks)."""
    chunks = -(-counts // C)
    return np.cumsum(chunks) - chunks, int(chunks.sum())


def _to_jax_queue(queue, seg_base):
    """The port's entry-major dense queue as the JAX [8, cols] queue
    with CHUNK-aligned segments and bias-encoded ray ids."""
    sb = seg_base.numpy()
    counts = np.diff(sb)
    base, nchunks = _chunked_regions(counts)
    q = np.zeros((8, (nchunks + 1) * C), np.float32)
    q[7] = -1.0
    ent = queue.numpy()
    rid = ent.view(np.int32)[:, 6]
    for s, c in enumerate(counts):
        rows = ent[sb[s]:sb[s] + c].T.copy()
        rows[6] = (rid[sb[s]:sb[s] + c] | jax_wf2.RID_BIAS).view(np.float32)
        q[:, base[s] * C: base[s] * C + c] = rows
    return q, base.astype(np.int32), counts.astype(np.int32)


def _i32(vals, size, fill=0):
    a = np.full((size,), fill, np.int32)
    a[: len(vals)] = vals
    return jnp.asarray(a)


def _jax_pack(ref, bvh, level, queue, seg_base, count_next, do_kill,
              fused_gc=False):
    """The JAX package's _run_pack on the port's queue of ``level``,
    with the next level's regions from ``count_next``: (CHUNK-unit
    region bases, its outputs).  With ``fused_gc`` it counts every inner
    grandchild, as its trace does when the next level has inner
    children."""
    seg_nodes, kind, pair, lstart, lcnt, forced = bvh.wf_sched[level]
    W, S, n = bvh.width, len(seg_nodes), queue.shape[0]
    q_j, base_j, cnt_j = _to_jax_queue(queue, seg_base)
    Sp = jax_wf2._bucket(S)
    base_next, nchunks_next = _chunked_regions(count_next)
    cdest = np.where(np.asarray(kind) == 1,
                     base_next[np.maximum(np.asarray(pair), 0)], -1)
    cgc = []
    if fused_gc:
        kind_next = bvh.wf_sched[level + 1][1]
        for k, c in zip(kind, pair):
            bits = sum(1 << w2 for w2 in range(W)
                       if k == 1 and kind_next[c * W + w2] == 1)
            cgc.append((1 << 8) | bits if k == 1 else 0)
    logcap = 2 * n
    k8 = max(-(-bvh.max_leaf // 8) * 8, 8)
    return base_next, jax_wf2._run_pack(
        jnp.asarray(q_j), ref.bvh.node_packed, ref.prim_packed,
        jnp.zeros((4, logcap + C), jnp.float32),
        _i32(seg_nodes, Sp), _i32(base_j, Sp), _i32(cnt_j, Sp),
        _i32(cdest, Sp * W, -1), _i32(kind, Sp * W), _i32(lstart, Sp * W),
        _i32(lcnt, Sp * W), _i32(forced, Sp * W), _i32(cgc, Sp * W),
        jnp.zeros((1,), jnp.int32), jnp.asarray([S], jnp.int32),
        jnp.arange(q_j.shape[1] // C, dtype=jnp.int32),
        _i32([], Sp * W, -1),
        W, k8, (nchunks_next + 2) * C, do_kill, 1e-3, logcap,
        fused_gc=fused_gc,
    )


def test_level_matches_pallas_kernels(monkeypatch):
    """count_plain and pack_plain against _run_count and _run_pack on
    level 3 of the soup scene (63 segments; 7 inner and 195 leaf
    children), entered by 1024 shadow rays with a limit of 0.6: the
    shadow kill ends some lineages, which are routed with tub = -1."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref, _ = scenes("soup")
    level = 3
    n = 1024
    o, d = random_rays(n, 2, 0.5)
    valid = np.arange(n) % 9 != 4
    queue, seg_base, bound, cap = _level_state(
        ours, o, d, valid, level, np.full(n, 0.6, np.float32))
    bvh = ours.bvh
    W = bvh.width
    lv = bvh.wf_levels[level]
    seg_nodes, kind, pair, lstart, lcnt, forced = bvh.wf_sched[level]
    S = len(seg_nodes)
    assert lv.has_inner and 2 in kind and int(seg_base[-1]) > 500

    # the port
    counts = wf.count_plain(queue, seg_base, lv, bvh.wf_node_rows, W)
    seg_base_next, route, cursor, lost = wf.plan_regions(counts, lv, cap)
    assert int(lost) == 0
    out = torch.zeros((cap, 8))
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    stats = {}
    wf.pack_plain(queue, seg_base, lv, route, cursor, bvh.wf_node_rows,
                  ours.wf_prim_rows, W, True, 1e-3, out, keys, dropped,
                  stats=stats)
    sbn = seg_base_next.numpy()
    killed = int((out[:sbn[-1], 7] == -1.0).sum())
    assert 0 < killed < sbn[-1]
    assert int(dropped) == 0 and stats["survivors"] == sbn[-1]
    np.testing.assert_array_equal(cursor.numpy(), sbn[1:])

    # the JAX kernels on the same queue
    q_j, base_j, cnt_j = _to_jax_queue(queue, seg_base)
    Sp = jax_wf2._bucket(S)
    sched_a = dict(
        seg_node=_i32(seg_nodes, Sp), seg_base=_i32(base_j, Sp),
        seg_count=_i32(cnt_j, Sp), nsegs=jnp.asarray([S], jnp.int32),
    )
    cmask = _i32([1 if k == 1 else 0 for k in kind], Sp * W)
    counts_j = jax_wf2._run_count(
        jnp.asarray(q_j), ref.bvh.node_packed, sched_a["seg_node"],
        sched_a["seg_base"], sched_a["seg_count"], cmask, sched_a["nsegs"],
        W)
    counts_j = np.asarray(counts_j)[:S, :W].reshape(-1).astype(np.int32)
    np.testing.assert_array_equal(counts.numpy(), counts_j)
    assert counts_j.sum() > 50

    count_next = counts_j[lv.parent.numpy()]
    base_next, (queue_new, log, currow, _, _, _) = _jax_pack(
        ref, bvh, level, queue, seg_base, count_next, True)
    queue_new, log, currow = map(np.asarray, (queue_new, log, currow))
    assert currow[0, 1] == 0

    # routed entries, per next-level segment, as sets (sorted by ray id)
    got = out.numpy()
    for c, cnt in enumerate(count_next):
        a = got[sbn[c]:sbn[c + 1]]
        b = queue_new[:, base_next[c] * C: base_next[c] * C + cnt].T
        assert len(a) == len(b) == cnt
        a = a[np.argsort(a.view(np.int32)[:, 6], kind="stable")]
        rid_b = b.view(np.int32)[:, 6] & (jax_wf2.RID_BIAS - 1)
        order = np.argsort(rid_b, kind="stable")
        b = b[order]
        np.testing.assert_array_equal(a.view(np.int32)[:, 6], rid_b[order])
        np.testing.assert_array_equal(a[:, :6], b[:, :6])
        np.testing.assert_allclose(a[:, 7], b[:, 7], rtol=JIT_RTOL,
                                   atol=JIT_ATOL)

    # hits: the JAX log merged by its rule against the port's keys
    used = int(currow[0, 0])
    assert used == stats["hits"] > 20
    rid_l = log[2, :used].view(np.int32) & (jax_wf2.RID_BIAS - 1)
    keys_j = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    keys_j.scatter_reduce_(
        0, torch.from_numpy(rid_l.astype(np.int64)),
        wf.hit_keys(torch.from_numpy(log[0, :used].copy()),
                    torch.from_numpy(log[1, :used].astype(np.int64))),
        "amin")
    ta, pa = (x.numpy() for x in wf.decode_keys(keys))
    tb, pb = (x.numpy() for x in wf.decode_keys(keys_j))
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert np.mean(pa[hit] == pb[hit]) > 0.99


def test_trace_matches_pallas_wavefront(monkeypatch):
    """The whole trace against the JAX package's own, in interpret mode,
    on the box scene (its one forced leaf level)."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref, box = scenes("box")
    n = 1024
    o, d = random_rays(n, 12, box)
    valid = np.arange(n) % 6 != 0
    ta, pa, dropped = _trace(ours, o, d, valid, compact=True)
    res = jax_wf2.trace_closest_wavefront(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        compact=True)
    assert dropped == 0 and int(res.dropped) == 0
    tb, pb = np.asarray(res.t), np.asarray(res.prim)
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    assert hit.sum() > 400
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    differ = hit & (pa != pb)
    np.testing.assert_allclose(ta[differ], tb[differ], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert differ.mean() < 0.01


# ---------------------------------------------------------------------------
# wrappers and derived tables
# ---------------------------------------------------------------------------


def test_tie_inside_a_leaf_keeps_the_first_prim():
    """Two identical triangles in one leaf tie at a bit-equal t: the
    leaf keeps its first prim (the Pallas kernel's argmin), and one
    entry records one hit, so the ray reports prim 0."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [0, 1, 0]], float)
    mesh = st.Mesh(np.concatenate([v, v]), np.tile([[0.0, 0, 1]], (6, 1)),
                   np.arange(6).reshape(2, 3), DiffuseBSDF([1, 1, 1]))
    scene, _ = flatten_scene(st.Scene([mesh], []), tree_width=4,
                             max_leaf_size=8, device="cpu")
    assert scene.bvh.root_is_leaf and scene.num_prims == 2
    rng = np.random.default_rng(8)
    o = np.concatenate([rng.uniform(-0.3, 0.3, (64, 2)),
                        np.full((64, 1), 2.0)], 1).astype(np.float32)
    d = np.tile(np.float32([0, 0, -1]), (64, 1))
    t, p, _ = _trace(scene, o, d, np.ones(64, bool))
    assert np.all(p == 0) and np.allclose(t, 2.0)


def test_hit_keys_merge_rule():
    """The JAX merge's rule in one min over keys: the least t by int32
    bit order (so -0.0 sorts below every positive t), and the largest
    prim among bit-equal t; a ray without a hit decodes to (inf, -1)."""
    t = torch.tensor([0.5, 0.25, 0.25, 0.25, 3.0, -0.0, 1e-30],
                     dtype=torch.float32)
    prim = torch.tensor([9, 3, 7, 5, 11, 2, 4])
    ray = torch.tensor([0, 0, 0, 0, 1, 2, 2])
    keys = torch.full((4,), wf.KEY_MISS, dtype=torch.int64)
    keys.scatter_reduce_(0, ray, wf.hit_keys(t, prim), "amin")
    got_t, got_p = wf.decode_keys(keys)
    assert got_p.tolist() == [7, 11, 2, -1] and got_p.dtype == torch.int32
    assert got_t[:2].tolist() == [0.25, 3.0] and got_t[3] == float("inf")
    assert got_t[2] == 0.0 and torch.signbit(got_t[2])
    _, lite = wf.decode_keys(keys, want_prim=False)
    assert lite.tolist() == [-2, -2, -2, -1]
    # the largest prim id the tables allow survives the low word
    big = wf.hit_keys(torch.tensor([1.0]), torch.tensor([(1 << 24) - 1]))
    assert wf.decode_keys(big)[1].item() == (1 << 24) - 1


def test_derived_tables():
    ours, ref, _ = scenes("soup")
    np.testing.assert_array_equal(
        ours.wf_prim_rows.numpy(), np.asarray(ref.prim_packed)[:, 9:25])
    np.testing.assert_array_equal(
        ours.bvh.wf_node_rows.numpy(), np.asarray(ref.bvh.node_packed)[:, :32])
    assert np.all(np.asarray(ref.prim_packed)[:, 22:] == 0.0)
    for lv, (segs, kind, pair, lstart, lcnt, forced) in zip(
            ours.bvh.wf_levels, ours.bvh.wf_sched):
        assert lv.seg_node.tolist() == list(segs)
        assert lv.child.tolist() == [list(c) for c in
                                     zip(kind, lstart, lcnt, forced)]
        for c, slot in enumerate(lv.parent.tolist()):
            assert kind[slot] == 1 and pair[slot] == c


def test_cuda_tensors_never_take_plain_path(monkeypatch):
    """count_level, pack_level (with fused counts) and decode_keys: CPU
    tensors run the plain versions, CUDA tensors the kernels' launches,
    any other device raises; the launches themselves refuse CPU
    tensors.  No try/fallback."""
    ours, _, box = scenes("soup")
    bvh = ours.bvh
    W = bvh.width
    o, d = random_rays(64, 3, box)
    queue, seg_base, bound, cap = _level_state(ours, o, d, np.ones(64, bool),
                                               1)
    lv, nxt = bvh.wf_levels[1], bvh.wf_levels[2]
    assert nxt.has_inner
    ws = wf.workspace(bvh.wf_levels, W, "cpu")
    tile_base = wf.tile_prefix(seg_base)
    keys = torch.full((64,), wf.KEY_MISS, dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    calls = []
    names = ("count_plain", "plan_plain", "pack_plain", "decode_plain",
             "count_cuda", "pack_cuda", "decode_cuda")
    real = {k: getattr(wf, k) for k in names}
    for k in real:
        monkeypatch.setattr(
            wf, k, lambda *a, _k=k, **kw: calls.append(_k)
            or (real[_k](*a, **kw) if _k.endswith("plain") else None))
    before = (wf.count_launches, wf.pack_launches, wf.decode_launches)
    plan = ws.plans[1]
    count_args = (seg_base, tile_base, lv, bvh.wf_node_rows, W, bound,
                  ws.counts[1], plan, cap, dropped, ws.ticket)
    fused = wf.Fused(nxt, ws.counts[2], ws.plans[2], cap, ws.ticket)
    pack_args = (seg_base, tile_base, lv, plan.route, plan.cursor,
                 bvh.wf_node_rows, ours.wf_prim_rows, W, False, 1e-3,
                 torch.zeros((cap, 8)), keys, dropped, bound, fused)
    wf.count_level(queue, *count_args)
    wf.pack_level(queue, *pack_args)
    wf.decode_keys(keys)
    assert calls == ["count_plain", "plan_plain", "pack_plain", "plan_plain",
                     "decode_plain"]
    assert int(ws.counts[2].sum()) > 0 and int(dropped) == 0
    assert (wf.count_launches, wf.pack_launches, wf.decode_launches) \
        == before

    class OnCard:
        device = torch.device("cuda", 0)

    wf.count_level(OnCard(), *count_args)
    wf.pack_level(OnCard(), *pack_args)
    wf.decode_keys(OnCard())
    assert calls[5:] == ["count_cuda", "pack_cuda", "decode_cuda"]
    meta = queue.to("meta")
    with pytest.raises(ValueError, match="device"):
        wf.count_level(meta, *count_args)
    with pytest.raises(ValueError, match="device"):
        wf.pack_level(meta, *pack_args)
    with pytest.raises(ValueError, match="device"):
        wf.decode_keys(keys.to("meta"))
    with pytest.raises(ValueError, match="CUDA"):
        real["count_cuda"](queue, *count_args)
    with pytest.raises(ValueError, match="CUDA"):
        real["pack_cuda"](queue, *pack_args)
    with pytest.raises(ValueError, match="CUDA"):
        real["decode_cuda"](keys)


# ---------------------------------------------------------------------------
# fused counts, the region plan, tiles and the key decode
# ---------------------------------------------------------------------------


def _fused_level(name, level, shadow, n=1024, seed=5):
    """Level ``level`` entered by n rays (shadow rays with a limit of
    5, which lets soup level 2's one leaf child kill a few lineages),
    counted and planned; then pack_plain with fused counts.
    Returns (scene, queue written, its seg_base, next level, counts the
    pack made for it, killed entries written, the entering state)."""
    ours, _, _ = scenes(name)
    bvh = ours.bvh
    W = bvh.width
    o, d = random_rays(n, seed, 0.5)
    valid = np.arange(n) % 9 != 4
    t_limit = np.full(n, 5.0, np.float32) if shadow else None
    queue, seg_base, _, cap = _level_state(ours, o, d, valid, level, t_limit)
    lv, nxt = bvh.wf_levels[level], bvh.wf_levels[level + 1]
    assert nxt.has_inner
    counts = wf.count_plain(queue, seg_base, lv, bvh.wf_node_rows, W)
    seg_base_next, route, cursor, lost = wf.plan_regions(counts, lv, cap)
    assert int(lost) == 0
    out = torch.zeros((cap, 8))
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    counts_next = torch.zeros((nxt.num_segs * W,), dtype=torch.int32)
    wf.pack_plain(queue, seg_base, lv, route, cursor, bvh.wf_node_rows,
                  ours.wf_prim_rows, W, shadow, 1e-3, out, keys, dropped,
                  counts_next=counts_next, lv_next=nxt)
    assert int(dropped) == 0
    total = int(seg_base_next[-1])
    killed = int((out[:total, 7] == -1.0).sum())
    return ours, out, seg_base_next, nxt, counts_next, killed, \
        (queue, seg_base, counts)


@pytest.mark.parametrize("name,level,shadow", [
    ("soup", 2, False), ("soup", 2, True), ("soup8", 1, False),
])
def test_fused_counts_equal_count_of_written_queue(name, level, shadow):
    """The counts pack_plain makes for the next level are count_plain of
    the queue it wrote, exactly.  Soup level 2 is the deepest whose next
    level has inner children (level 3's next has none); in shadow mode
    its leaf child kills lineages, which are routed with tub = -1 and
    count nothing.  The W = 8 soup's level 1 counts for its level 2."""
    ours, out, sbn, nxt, counts_next, killed, _ = _fused_level(
        name, level, shadow)
    bvh = ours.bvh
    want = wf.count_plain(out, sbn, nxt, bvh.wf_node_rows, bvh.width)
    np.testing.assert_array_equal(counts_next.numpy(), want.numpy())
    assert want.sum() > 50
    if shadow:
        assert killed > 0


def test_fused_counts_match_pallas_fused_gc(monkeypatch):
    """The same counts against the JAX package's pack kernel with
    fused_gc in interpret mode (its gc_out: lane w*W + w' of segment s is
    the survivors of child w entering grandchild w'), shadow mode with
    the kill, soup level 2."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    level = 2
    ours, out, sbn, nxt, counts_next, killed, (queue, seg_base, counts) = \
        _fused_level("soup", level, True)
    ref = scenes("soup")[1]
    bvh = ours.bvh
    W = bvh.width
    lv = bvh.wf_levels[level]
    count_next = counts.numpy()[lv.parent.numpy()]
    _, res = _jax_pack(ref, bvh, level, queue, seg_base, count_next, True,
                       fused_gc=True)
    assert int(np.asarray(res[2])[0, 1]) == 0
    gc = np.asarray(res[3])[:lv.num_segs, :W * W].reshape(-1, W)
    pair = lv.pair.numpy()
    got = counts_next.numpy().reshape(-1, W)
    inner = pair >= 0
    np.testing.assert_array_equal(got[pair[inner]],
                                  gc[inner].astype(np.int32))
    assert killed > 0 and got.sum() > 50


def _trace_pair(name, n, seed, valid_mod, shadow=False, **kw):
    ours, ref, box = scenes(name)
    o, d = random_rays(n, seed, box)
    valid = np.arange(n) % valid_mod != 2
    t_limit = None
    if shadow:
        tb, pb = _oracle(ref, o, d, valid)
        t_limit = np.where(pb >= 0, tb, 2.0).astype(np.float32) * np.where(
            np.arange(n) % 3 == 0, 0.5, 1.5).astype(np.float32)
    a = _trace(ours, o, d, valid, t_limit, **kw)
    b = _trace(ours, o, d, valid, t_limit, fused_counts=False, **kw)
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]
    return (o, d, valid, t_limit), a


def test_fused_trace_matches_unfused_and_pallas(monkeypatch):
    """trace_closest_wavefront with fused counts (the default) equals
    fused_counts=False to the bit, and the JAX package's trace with
    fused_counts=True (interpret mode) under the bar of
    test_trace_matches_pallas_wavefront, on terrain n=8 (three levels:
    pack 0 counts level 1)."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    (o, d, valid, _), (ta, pa, dropped) = _trace_pair(
        "terrain", 1024, 17, 7, compact=True)
    ref = scenes("terrain")[1]
    res = jax_wf2.trace_closest_wavefront(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        compact=True, fused_counts=True)
    assert dropped == 0 and int(res.dropped) == 0
    tb, pb = np.asarray(res.t), np.asarray(res.prim)
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    assert hit.sum() > 200
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert (hit & (pa != pb)).mean() < 0.01


@pytest.mark.parametrize("name", ["terrain", "soup"])
def test_fused_shadow_trace_matches_unfused(name):
    """Shadow mode with the kill: fused counts equal a count sweep to
    the bit, and decide t > max_t - eps as the oracle does."""
    (o, d, valid, t_limit), (ta, _, dropped) = _trace_pair(
        name, 1024, 19, 5, shadow=True)
    tb, _ = _oracle(scenes(name)[1], o, d, valid)
    eps = np.float32(1e-3)
    assert dropped == 0
    np.testing.assert_array_equal(ta > t_limit - eps, tb > t_limit - eps)
    assert 0 < (ta > t_limit - eps).sum() < len(o)


def test_fused_counts_under_overflow(monkeypatch):
    """With a queue too small, fused counts count only the survivors
    that were written: the same t, prim and dropped as a count sweep."""
    monkeypatch.setattr(wf, "queue_capacity", lambda *a: 1500)
    _, (_, p, dropped) = _trace_pair("soup", 1024, 9, 1000)
    assert dropped > 0 and (p >= 0).sum() > 50


def test_width8_matches_bruteforce():
    """Width 8 (the kernels' widest): the fused trace against the
    oracle, t to the bit, and against a count sweep."""
    ours, ref, box = scenes("soup8")
    assert ours.bvh.width == 8 and len(ours.bvh.wf_levels) == 4
    (o, d, valid, _), (ta, pa, dropped) = _trace_pair("soup8", 1024, 4, 5)
    tb, pb = _oracle(ref, o, d, valid)
    assert dropped == 0 and (pa >= 0).sum() > 50
    check_closest(ta, pa, tb, pb)


def _tile_ranges(seg_base, tile_base):
    """The entry range of every tile, found as the kernels find it: the
    largest s with tile_base[s] <= t, then the tile's place in s."""
    sb, tb = seg_base.tolist(), tile_base.tolist()
    out = []
    for t in range(tb[-1]):
        s = bisect.bisect_right(tb, t) - 1
        lo = sb[s] + (t - tb[s]) * wf.TILE
        hi = min(lo + wf.TILE, sb[s + 1])
        assert sb[s] <= lo < hi <= sb[s + 1], "a tile outside its segment"
        out.append((lo, hi))
    return out


@pytest.mark.parametrize("fused,cap", [
    (True, None), (False, None), (True, 1500),
])
def test_region_plan_matches_plan_regions(monkeypatch, fused, cap):
    """On every level of a trace, the plan the level loop gets (on the
    card from the last block of the kernel that counted, here from
    plan_plain) equals plan_regions of the counts, lost entries included
    (the 1500-entry queue overflows) and added to dropped once; and its
    tiles cover every entry of the next level exactly once, each tile
    inside one segment, with fewer than TILE idle lanes per segment.
    chip_smoke.py holds the kernels' own plans to plan_regions."""
    if cap is not None:
        monkeypatch.setattr(wf, "queue_capacity", lambda *a: cap)
    real = wf.plan_plain
    lost_seen = []

    def checked(counts, lv, cap_, plan, dropped):
        before = int(dropped)
        real(counts, lv, cap_, plan, dropped)
        sb, route, cursor, lost = wf.plan_regions(counts, lv, cap_)
        for got, want in ((plan.seg_base, sb), (plan.route, route),
                          (plan.cursor, cursor),
                          (plan.tile_base, wf.tile_prefix(sb))):
            np.testing.assert_array_equal(got.numpy(), want.numpy())
        assert int(dropped) - before == int(lost)
        lost_seen.append(int(lost))
        ranges = _tile_ranges(plan.seg_base, plan.tile_base)
        flat = [x for r in ranges for x in r]
        assert flat[1:-1:2] == flat[2::2] if ranges else True
        total = int(sb[-1])
        assert (flat[0], flat[-1]) == (0, total) if ranges else total == 0
        assert len(ranges) * wf.TILE - total < lv.num_next * wf.TILE

    monkeypatch.setattr(wf, "plan_plain", checked)
    ours, _, box = scenes("soup")
    n = 1024
    o, d = random_rays(n, 9, box)
    _, p, dropped = _trace(ours, o, d, np.ones(n, bool), fused_counts=fused)
    assert len(lost_seen) == 4  # soup levels 0-3 have inner children
    assert dropped == sum(lost_seen) and (dropped > 0) == (cap is not None)
    assert (p >= 0).sum() > 50


def test_decode_plain_hits_misses():
    """decode_plain (the decode kernel's plain version): a hit gives its
    t to the bit (0, -0, a denormal, the largest float) and its prim, a
    miss (inf, -1); with want_prim=False a hit gives -2."""
    t = torch.tensor([0.0, -0.0, 1e-40, 3.5, 3.4028235e38],
                     dtype=torch.float32)
    prim = torch.tensor([0, 5, (1 << 24) - 1, 123456, 7])
    keys = torch.cat([wf.hit_keys(t, prim), torch.tensor([wf.KEY_MISS])])
    got_t, got_p = wf.decode_plain(keys)
    assert got_t.dtype == torch.float32 and got_p.dtype == torch.int32
    np.testing.assert_array_equal(got_t[:5].view(torch.int32).numpy(),
                                  t.view(torch.int32).numpy())
    assert got_t[5] == float("inf")
    assert got_p.tolist() == [0, 5, (1 << 24) - 1, 123456, 7, -1]
    lite_t, lite_p = wf.decode_plain(keys, want_prim=False)
    assert lite_p.tolist() == [-2] * 5 + [-1]
    np.testing.assert_array_equal(lite_t.numpy(), got_t.numpy())
