"""The port's dyn_alloc form of the wavefront traversal (plain versions,
on the CPU) against the JAX package's ``trace_closest_wavefront(...,
dyn_alloc=True)`` in interpret mode, and against the port's shipped
layout (count, region plan, pack).

Tolerances.  Against jitted JAX (interpret-mode Pallas, where XLA's CPU
fusion contracts multiply-adds): hit/miss exact, t within rtol 1e-5 +
atol 1e-6, prim equal but for ties at a bit-equal t, dropped equal and
0, shadow decisions ``t > max_t - eps`` exact.  Against the port's
shipped trace of the same rays: t equal to the bit, prim exact, dropped
equal (0).  Per level, the plain dyn_alloc pack's written counts equal
the counts the shipped plan is made from, and the next queue read
through its table equals the shipped next queue (the plain versions
keep queue order within a segment; the card's kernels are held to it as
a set per segment by chip_smoke.py).  Drops: no write past the queue's
capacity, and at the first level that drops, written + dropped equals
count's total for that level's queue.

The JAX cases run the soup of tests/test_torch_wavefront2.py under
max_leaf_size=32 (three levels) or 128 (two): an interpret-mode level
costs about 3-4 s whatever the ray count.  The port-only cases run
terrain n=8 under max_leaf_size=4 (three levels).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.ops.pallas import wavefront2 as jax_wf2
from cuda_raytracer_tpu.render.flatscene import flatten_scene as jax_flatten
from cuda_raytracer_tpu.scene import static_scene as jst
from cuda_raytracer_tpu.scene.bsdf import DiffuseBSDF as JaxDiffuse

import torch

from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
from cuda_raytracer_tpu_torch.ops.seeds import seed_hits
from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
from cuda_raytracer_tpu_torch.scene import static_scene as st
from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF

from test_torch_wavefront2 import _soup, random_rays, scenes

#: against jitted JAX (interpret-mode Pallas)
JIT_RTOL, JIT_ATOL = 1e-5, 1e-6
EPS = np.float32(1e-3)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Single-threaded torch, as in tests/test_torch_wavefront2.py, whose
    fixture names the rounding it once guarded against (torch's CPU
    float32 ``sqrt``, now ``ops.intersect.sqrt_rn`` in the plain
    versions); these tests compare to the bit."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_soups = {}


def soup(max_leaf):
    """(port scene, JAX scene) of the soup under ``max_leaf``: 32 gives
    three levels, 128 two."""
    if max_leaf not in _soups:
        _soups[max_leaf] = (
            flatten_scene(_soup(st, DiffuseBSDF), tree_width=4,
                          max_leaf_size=max_leaf, device="cpu")[0],
            jax_flatten(_soup(jst, JaxDiffuse), tree_width=4,
                        max_leaf_size=max_leaf)[0])
    return _soups[max_leaf]


def _trace(scene, o, d, valid, t_limit=None, **kw):
    res = wf.trace_closest_wavefront(
        scene, torch.from_numpy(o), torch.from_numpy(d),
        torch.from_numpy(valid),
        None if t_limit is None else torch.from_numpy(t_limit), **kw)
    return res.t.numpy(), res.prim.numpy(), int(res.dropped)


def _jax(ref, o, d, valid, t_limit=None, **kw):
    res = jax_wf2.trace_closest_wavefront(
        ref, jnp.asarray(o), jnp.asarray(d), jnp.asarray(valid),
        None if t_limit is None else jnp.asarray(t_limit), dyn_alloc=True,
        **kw)
    return np.asarray(res.t), np.asarray(res.prim), int(res.dropped)


def _limits(t_hit, prim):
    """max_t per ray: the hit's t (2.0 on a miss) times 0.5 for every
    third ray (blocked) and 1.5 otherwise (reaches its light)."""
    t = np.where(prim >= 0, t_hit, 2.0)
    scale = np.where(np.arange(len(t)) % 3 == 0, 0.5, 1.5)
    return (t * scale).astype(np.float32)


def _same(a, b):
    """Two port traces equal: t to the bit, prim exact, dropped equal."""
    np.testing.assert_array_equal(a[0].view(np.int32), b[0].view(np.int32))
    np.testing.assert_array_equal(a[1], b[1])
    assert a[2] == b[2]


def _near_jax(ours, ref, min_hits):
    ta, pa, da = ours
    tb, pb, db = ref
    assert da == db == 0
    np.testing.assert_array_equal(pa < 0, pb < 0)
    hit = pa >= 0
    assert hit.sum() >= min_hits
    np.testing.assert_allclose(ta[hit], tb[hit], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    differ = hit & (pa != pb)
    np.testing.assert_allclose(ta[differ], tb[differ], rtol=JIT_RTOL,
                               atol=JIT_ATOL)
    assert differ.mean() < 0.01


# ---------------------------------------------------------------------------
# the trace against the JAX package's dyn_alloc trace (interpret mode)
# ---------------------------------------------------------------------------


def test_closest_matches_jax_dyn_alloc(monkeypatch):
    """2 x CHUNK closest-hit rays, every seventh lane invalid: the port's
    dyn_alloc trace against the JAX package's, and to the bit against
    the port's shipped trace."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref = soup(32)
    n = 2 * wf.CHUNK
    o, d = random_rays(n, 43, 1.0)
    valid = np.arange(n) % 7 != 3
    a = _trace(ours, o, d, valid, dyn_alloc=True)
    _same(a, _trace(ours, o, d, valid))
    _near_jax(a, _jax(ref, o, d, valid), 400)


def test_shadow_compact_matches_jax_dyn_alloc(monkeypatch):
    """CHUNK shadow rays with compact=True: the port's dyn_alloc trace
    against the JAX package's (the same shadow decisions), and to the
    bit against the port's shipped compacted trace."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref = soup(32)
    n = wf.CHUNK
    o, d = random_rays(n, 44, 1.0)
    valid = np.arange(n) % 5 != 1
    t, p, _ = _trace(ours, o, d, valid)
    max_t = _limits(t, p)
    a = _trace(ours, o, d, valid, max_t, compact=True, dyn_alloc=True)
    _same(a, _trace(ours, o, d, valid, max_t, compact=True))
    b = _jax(ref, o, d, valid, max_t, compact=True)
    _near_jax(a, b, 100)
    np.testing.assert_array_equal(a[0] > max_t - EPS, b[0] > max_t - EPS)
    assert 0 < (a[0] > max_t - EPS)[valid].sum() < valid.sum()


# ---------------------------------------------------------------------------
# the trace against the port's shipped layout (terrain n=8, three levels)
# ---------------------------------------------------------------------------


def _terrain_case(case):
    ours, _, box = scenes("terrain")
    n = 1024
    o, d = random_rays(n, 21, box)
    valid = np.arange(n) % 6 != 4
    t_limit, kw = None, {}
    if case in ("shadow", "no_prim", "compact_shadow"):
        t, p, _ = _trace(ours, o, d, valid)
        t_limit = _limits(t, p)
    if case == "compact_shadow":
        kw = dict(compact=True)
    elif case == "no_prim":
        kw = dict(want_prim=False)
    elif case == "bf16":
        kw = dict(box_bf16=True)
    elif case == "seeded":
        sd = seed_hits(ours, torch.from_numpy(o), torch.from_numpy(d),
                       torch.from_numpy(valid), k=32)
        kw = dict(seed_t=sd.t, seed_prim=sd.prim)
    return ours, (o, d, valid, t_limit), kw


@pytest.mark.parametrize("case", ["closest", "shadow", "compact_shadow",
                                  "bf16", "no_prim", "seeded"])
def test_terrain_equals_shipped(case):
    """Each option the form composes with: the dyn_alloc trace equals
    the shipped trace of the same rays to the bit."""
    ours, rays, kw = _terrain_case(case)
    a = _trace(ours, *rays, dyn_alloc=True, **kw)
    b = _trace(ours, *rays, **kw)
    _same(a, b)
    assert a[2] == 0 and (a[1] != -1).sum() > 100


def test_fused_counts_ignored_and_no_count(monkeypatch):
    """Under dyn_alloc, fused_counts changes nothing, and no count (plain
    or kernel) and no region plan runs."""
    ours, rays, _ = _terrain_case("shadow")
    a = _trace(ours, *rays, dyn_alloc=True, fused_counts=True)

    def never(*a, **k):
        raise AssertionError("a count ran under dyn_alloc")

    for name in ("count_level", "count_plain", "count_cuda", "plan_plain",
                 "plan_regions"):
        monkeypatch.setattr(wf, name, never)
    _same(a, _trace(ours, *rays, dyn_alloc=True, fused_counts=False))
    _same(a, _trace(ours, *rays, dyn_alloc=True))


# ---------------------------------------------------------------------------
# level by level: the form's written counts, tables and next queue
# ---------------------------------------------------------------------------


def _dense(queue, seg_base, read):
    """A level's entries in dense order (through its read table)."""
    total = int(seg_base[-1])
    if read is None:
        return queue[:total]
    return queue[wf.queue_positions(read, 0, total)]


def _level0(ours, o, d, valid, t_limit):
    queue = wf.make_payload(torch.from_numpy(o), torch.from_numpy(d),
                            torch.from_numpy(valid),
                            None if t_limit is None
                            else torch.from_numpy(t_limit))
    seg_base = torch.tensor([0, len(o)], dtype=torch.int32)
    return queue, seg_base


def _dyn_level(ours, lv, queue, seg_base, read, bound, cap, keys, do_kill,
               guard=0):
    """One dyn_alloc pack of level ``lv`` (plain) into a queue of ``cap``
    rows followed by ``guard`` rows of NaN.  Returns (queue written, its
    guard rows, runs (None at a leaf-only level), dropped)."""
    W = ours.bvh.width
    runs = wf.dyn_workspace((lv,), W, bound, cap, "cpu").get(0)
    buf = torch.full((cap + guard, wf.ROWS), float("nan"))
    dropped = torch.zeros((), dtype=torch.int64)
    wf.pack_plain(queue, seg_base, lv, lv.pair, None, ours.bvh.wf_node_rows,
                  ours.wf_prim_rows, W, do_kill, 1e-3, buf[:cap], keys,
                  dropped, dyn=wf.Dyn(read, runs))
    return buf[:cap], buf[cap:], runs, int(dropped)


def _sorted_by_segment(queue, seg_base):
    """Entries ordered by (segment, ray id): a set per segment."""
    total = int(seg_base[-1])
    seg = torch.searchsorted(seg_base[1:].contiguous(),
                             torch.arange(total, dtype=torch.int32),
                             right=True).long()
    rid = queue.view(torch.int32)[:, 6].long()
    return queue[torch.argsort(seg * (1 << 32) + rid)]


@pytest.mark.parametrize("shadow", [False, True])
def test_levels_match_shipped_plan(shadow):
    """Terrain n=8, every level that routes: the written counts per next
    segment equal the counts the shipped plan is made from (the next
    seg_base equal), every run is at most one tile of one child slot,
    tagged with the slot's next segment, the runs cover the written
    positions once, and the next queue read through the sorted runs
    equals the shipped next queue, in order and as a set per segment;
    the hit keys equal."""
    ours, (o, d, valid, t_limit), _ = _terrain_case(
        "shadow" if shadow else "closest")
    bvh = ours.bvh
    W = bvh.width
    n = len(o)
    cap = wf.queue_capacity(n, 2, bvh.wf_sched)
    queue, seg_base = _level0(ours, o, d, valid, t_limit)
    q_s, sb_s = queue, seg_base
    keys_d = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    keys_s = keys_d.clone()
    read, bound = None, n
    for lv in bvh.wf_levels:
        if not lv.has_inner:
            break
        counts = wf.count_plain(q_s, sb_s, lv, bvh.wf_node_rows, W)
        sb_next, route, cursor, lost = wf.plan_regions(counts, lv, cap)
        out_s = torch.empty((cap, wf.ROWS))
        drop_s = torch.zeros((), dtype=torch.int64)
        wf.pack_plain(q_s, sb_s, lv, route, cursor, bvh.wf_node_rows,
                      ours.wf_prim_rows, W, shadow, 1e-3, out_s, keys_s,
                      drop_s)
        out_d, _, runs, dropped = _dyn_level(
            ours, lv, queue, seg_base, read, bound, cap, keys_d, shadow)
        assert int(lost) == int(drop_s) == dropped == 0
        np.testing.assert_array_equal(runs.written[lv.parent.long()],
                                      counts[lv.parent.long()])
        # the run table
        k = int(runs.cursor[1])
        table = runs.table[:, :k]
        assert 0 < k <= runs.table.shape[1]
        assert int((runs.table[:, k:] != 0).sum()) == 0
        assert int(table[2].min()) >= 1 and int(table[2].max()) <= wf.TILE
        start = table[1].long()
        order = torch.argsort(start)
        ends = (start + table[2])[order]
        assert int(start[order][0]) == 0
        np.testing.assert_array_equal(start[order][1:], ends[:-1])
        assert int(ends[-1]) == int(runs.cursor[0]) == int(sb_next[-1])
        slot = lv.parent[table[0].long()].long()
        np.testing.assert_array_equal(lv.pair[slot], table[0])
        # the next level
        seg_base, tile_base, read = wf.dyn_next_level(runs, lv)
        np.testing.assert_array_equal(seg_base, sb_next)
        np.testing.assert_array_equal(tile_base, wf.tile_prefix(sb_next))
        dense = _dense(out_d, seg_base, read)
        total = int(sb_next[-1])
        np.testing.assert_array_equal(dense.view(torch.int32),
                                      out_s[:total].view(torch.int32))
        np.testing.assert_array_equal(
            _sorted_by_segment(dense, seg_base).view(torch.int32),
            _sorted_by_segment(out_s[:total], sb_next).view(torch.int32))
        queue, bound, q_s, sb_s = out_d, cap, out_s, sb_next
    np.testing.assert_array_equal(keys_d, keys_s)


def _finish(ours, first, queue, seg_base, read, keys, do_kill):
    """The levels from ``first`` on (plain, dyn_alloc form); the keys."""
    bvh = ours.bvh
    cap = wf.queue_capacity(len(keys), 2, bvh.wf_sched)
    for lv in bvh.wf_levels[first:]:
        if not lv.has_inner:
            _dyn_level(ours, lv, queue, seg_base, read, cap, 1, keys,
                       do_kill)
            break
        queue, _, runs, _ = _dyn_level(ours, lv, queue, seg_base, read, cap,
                                       cap, keys, do_kill)
        seg_base, _, read = wf.dyn_next_level(runs, lv)
    return keys


def test_any_run_order_reads_the_same():
    """The card hands out runs in no fixed order.  Level 0's runs moved
    to other positions of the queue, in a shuffled order of positions and
    of table slots (as other block timings would leave them): the next
    level has the same seg_base and the same entries per segment, and the
    rest of the trace the same keys."""
    ours, (o, d, valid, t_limit), _ = _terrain_case("shadow")
    bvh = ours.bvh
    lv = bvh.wf_levels[0]
    n = len(o)
    cap = wf.queue_capacity(n, 2, bvh.wf_sched)
    queue, seg_base = _level0(ours, o, d, valid, t_limit)
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    out, _, runs, _ = _dyn_level(ours, lv, queue, seg_base, None, n, cap,
                                 keys, True)
    k = int(runs.cursor[1])
    assert k > 10
    perm = torch.from_numpy(np.random.default_rng(4).permutation(k))
    tag, start, length = runs.table[:, :k][:, perm]
    moved = torch.cumsum(length, 0) - length
    out2 = torch.full_like(out, float("nan"))
    for a, b, m in zip(start.tolist(), moved.tolist(), length.tolist()):
        out2[b:b + m] = out[a:a + m]
    runs2 = wf.Runs(torch.zeros_like(runs.table), runs.written,
                    runs.cursor)
    runs2.table[:, :k] = torch.stack([tag, moved.to(torch.int32), length])
    nxt, nxt2 = wf.dyn_next_level(runs, lv), wf.dyn_next_level(runs2, lv)
    np.testing.assert_array_equal(nxt[0], nxt2[0])
    total = int(nxt[0][-1])
    a = _dense(out, nxt[0], nxt[2])
    b = _dense(out2, nxt2[0], nxt2[2])
    assert not torch.equal(a.view(torch.int32), b.view(torch.int32))
    np.testing.assert_array_equal(
        _sorted_by_segment(a, nxt[0]).view(torch.int32),
        _sorted_by_segment(b, nxt2[0]).view(torch.int32))
    assert total == len(a)
    keys_a = _finish(ours, 1, out, nxt[0], nxt[2], keys.clone(), True)
    keys_b = _finish(ours, 1, out2, nxt2[0], nxt2[2], keys.clone(), True)
    np.testing.assert_array_equal(keys_a, keys_b)
    t, p, _ = _trace(ours, o, d, valid, t_limit)
    tb, pb = wf.decode_plain(keys_b)
    np.testing.assert_array_equal(tb.numpy().view(np.int32), t.view(np.int32))
    np.testing.assert_array_equal(pb.numpy(), p)


# ---------------------------------------------------------------------------
# a forced small capacity
# ---------------------------------------------------------------------------


def _grazing(n, seed):
    """Rays across terrain n=8 just above its surface: about two entries
    per ray at level 2, so 8 x CHUNK of them overflow the queue that
    queue_multiplier=0 gives."""
    g = np.random.default_rng(seed)
    o = np.stack([np.full(n, -1.5), g.uniform(-0.05, 0.15, n),
                  g.uniform(-1.0, 1.0, n)], 1)
    d = np.stack([np.ones(n), g.uniform(-0.05, 0.05, n),
                  g.uniform(-0.2, 0.2, n)], 1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def test_overflow_levels():
    """queue_multiplier=0 on 8 x CHUNK grazing rays: level 0's pack
    fits; level 1's drops.  There no position at or past the capacity
    is written, the runs stay inside it, and written + dropped equals
    count's total for the level's queue; the trace reports the same
    drops."""
    ours, _, _ = scenes("terrain")
    bvh = ours.bvh
    W = bvh.width
    n = 8 * wf.CHUNK
    o, d = _grazing(n, 3)
    valid = np.ones(n, bool)
    cap = wf.queue_capacity(n, 0, bvh.wf_sched)
    queue, seg_base = _level0(ours, o, d, valid, None)
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64)
    read, bound, drops = None, n, []
    for lv in bvh.wf_levels:
        if not lv.has_inner:
            break
        want = int(wf.count_plain(_dense(queue, seg_base, read), seg_base,
                                  lv, bvh.wf_node_rows, W).sum())
        out, guard, runs, dropped = _dyn_level(
            ours, lv, queue, seg_base, read, bound, cap, keys, False,
            guard=wf.TILE)
        assert bool(torch.isnan(guard).all())
        k = int(runs.cursor[1])
        assert int((runs.table[1, :k] + runs.table[2, :k]).max()) <= cap
        assert int(runs.written.sum()) + dropped == want
        assert int(runs.cursor[0]) == want
        drops.append(dropped)
        seg_base, _, read = wf.dyn_next_level(runs, lv)
        queue, bound = out, cap
    assert drops[0] == 0 and drops[1] > 0
    assert int(seg_base[-1]) == cap
    t, p, dropped = _trace(ours, o, d, valid, queue_multiplier=0,
                           dyn_alloc=True)
    assert dropped == sum(drops)
    t0, p0, _ = _trace(ours, o, d, valid)
    got = p >= 0
    assert 0 < got.sum() < (p0 >= 0).sum()
    assert np.all(p0[got] >= 0) and np.all(t[got] >= t0[got])


def test_overflow_is_counted_in_both_packages(monkeypatch):
    """queue_multiplier=0 on 4 x CHUNK rays in the soup under
    max_leaf_size=128 (two levels: level 1 overflows): both packages'
    dyn_alloc traces drop (the JAX package whole chunks, sticky per
    child, so not the same entries), and every hit either still reports
    is a true hit."""
    monkeypatch.setattr(jax_wf2, "_INTERPRET", True)
    ours, ref = soup(128)
    n = 4 * wf.CHUNK
    o, d = random_rays(n, 43, 1.0)
    valid = np.ones(n, bool)
    t0, p0, _ = _trace(ours, o, d, valid)
    for t, p, dropped in (
            _trace(ours, o, d, valid, queue_multiplier=0, dyn_alloc=True),
            _jax(ref, o, d, valid, queue_multiplier=0)):
        assert dropped > 0
        got = p >= 0
        assert 0 < got.sum() < (p0 >= 0).sum()
        assert np.all(p0[got] >= 0)
        assert np.all(t[got] >= t0[got] - (JIT_ATOL
                                           + JIT_RTOL * np.abs(t0[got])))


# ---------------------------------------------------------------------------
# the wrappers
# ---------------------------------------------------------------------------


def test_cuda_tensors_never_take_plain_path(monkeypatch):
    """pack_level in the dyn_alloc form: CPU tensors run pack_plain, CUDA
    tensors pack_cuda, any other device raises; pack_cuda refuses CPU
    tensors, and the form refuses fused counts.  No try/fallback."""
    ours, (o, d, valid, _), _ = _terrain_case("closest")
    bvh = ours.bvh
    W = bvh.width
    lv = bvh.wf_levels[0]
    queue, seg_base = _level0(ours, o, d, valid, None)
    cap = wf.queue_capacity(len(o), 2, bvh.wf_sched)
    runs = wf.dyn_workspace(bvh.wf_levels, W, len(o), cap, "cpu")[0]
    keys = torch.full((len(o),), wf.KEY_MISS, dtype=torch.int64)
    dropped = torch.zeros((), dtype=torch.int64)
    args = (seg_base, wf.tile_prefix(seg_base), lv, lv.pair, None,
            bvh.wf_node_rows, ours.wf_prim_rows, W, False, 1e-3,
            torch.empty((cap, wf.ROWS)), keys, dropped, len(o))
    calls = []
    real = {k: getattr(wf, k) for k in ("pack_plain", "pack_cuda")}
    for k in real:
        monkeypatch.setattr(
            wf, k, lambda *a, _k=k, **kw: calls.append(
                (_k, kw.get("dyn", a[-1])))
            or (real[_k](*a, **kw) if _k == "pack_plain" else None))
    before = (wf.pack_launches, wf.pack_dyn_launches)
    wf.pack_level(queue, *args, dyn=wf.Dyn(None, runs))
    assert calls == [("pack_plain", wf.Dyn(None, runs))]
    assert int(runs.cursor[1]) > 0 and int(runs.written.sum()) > 0
    assert (wf.pack_launches, wf.pack_dyn_launches) == before

    class OnCard:
        device = torch.device("cuda", 0)

    wf.pack_level(OnCard(), *args, dyn=wf.Dyn(None, runs))
    assert calls[1] == ("pack_cuda", wf.Dyn(None, runs))
    with pytest.raises(ValueError, match="device"):
        wf.pack_level(queue.to("meta"), *args, dyn=wf.Dyn(None, runs))
    with pytest.raises(ValueError, match="CUDA"):
        real["pack_cuda"](queue, *args, dyn=wf.Dyn(None, runs))
    fused = wf.Fused(bvh.wf_levels[1], torch.zeros(1, dtype=torch.int32),
                     None, cap, torch.zeros(1, dtype=torch.int32))
    with pytest.raises(ValueError, match="fused"):
        wf.pack_level(queue, *args, fused, dyn=wf.Dyn(None, runs))


def test_run_capacity_bounds_the_runs():
    """One run per tile and child slot at most, and no more runs than
    entries the queue holds."""
    ours, _, _ = scenes("terrain")
    lv = ours.bvh.wf_levels[0]
    W = ours.bvh.width
    assert wf.run_capacity(1000, lv, W, 1 << 20) == (8 + 1) * W
    assert wf.run_capacity(1 << 20, lv, W, 100) == 100
    assert wf.run_capacity(0, lv, W, 0) == 1
