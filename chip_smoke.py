#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from the sources in this checkout, holds
each against its plain PyTorch version on the card, drives the port's
main path at full size, checks the card against the CPU per pixel, and
prints one JSON line for the kernels and, last, the device line.  Phases:

1. set-up: the card's name and power limit, nvcc's version, the build of
   packet_dfs.cu, partition.cu, wavefront2.cu, rng.cu, shade.cu,
   raygen.cu and film.cu (one nvcc each, started together) and what
   ptxas reports for each kernel (registers, stack frame, spills, shared
   memory);
2. the packet-DFS kernel against its plain version on 262,144 rays of
   terrain n=121 (28,800 tris): hit/miss, prim and t bit-equal, shadow
   decisions equal, dropped == 0; kernel, plain and bound times; and the
   partition kernel (ray form and payload form), the count and pack
   kernels and the whole wavefront trace on the same rays, as in phase 3;
   then the wavefront kernels and trace on the same kind of ray sets of
   terrain n=121 at tree width 8 and of terrain n=40 under
   max_leaf_size=64, whose segments with more leaf prims than the pack
   kernel stages in shared memory read them from global memory;
3. the main path at full size: the fast preset as shipped (packet-DFS at
   depths 0-1, the compacted wavefront at the roulette depths 2-3),
   800x600, depth 4, NEE 1x1.0 per depth — run A is bench.py's
   configuration and procedural scene (Cornell box with spheres, one
   leaf: 2 frames of 32 spp), run B terrain n=121 seen from above so it
   fills the frame (1 frame of 32 spp; six wavefront levels); the launch
   counts of all six kernels must equal what the scene's schedule
   gives (the payload form of the partition is off the main path: 0;
   one count per wavefront trace, on its level-0 queue, since each pack
   counts the level after it).  Then run B once more with
   traversal_rr="dfs" (every trace through packet-DFS), for the two
   frame times side by side.  Then every kernel against its plain
   version on the runs' own traces: the DFS kernel on 15,360,000-lane
   traces; both partition forms on run A's and run B's depth-2 traces;
   the count and pack kernels level by level (counts, keys, cursors, the
   next level's counts and each kernel's region plan exact, the next
   queue as sets per region) on run B's depth-2 closest-hit and shadow
   traces, run A's depth-2 closest-hit trace and run B's 15,360,000
   camera rays (all live, six levels); the whole wavefront trace against
   the DFS kernel on the same rays; and the decode kernel on two
   traces' 15,360,000 keys;
4. the same small frames on the card and on the CPU, per pixel: the
   Cornell box, and terrain n=8 under max_leaf_size=4 (three levels);
5. run C, a scene file: a Z_UP COLLADA document written here (run B's
   terrain n=121 as a triangles mesh with normals, the Cornell walls as
   polylist quads, a mirror and a glass sphere, an area light, a camera)
   rendered through ``render_cli.main`` at 800x600, fast preset, 64 spp
   (2 frames of 32), depth 4, once with ``--camera-mode collada`` and
   once with ``cutracer``: the loaded tables equal to those of the same
   scene built in Python, dropped == 0, the launches the schedule gives,
   the PNG read back by the port's load_png; the load time by step; and
   the same document at terrain n=8 under max_leaf_size=4 on the card
   and on the CPU, per pixel, in both camera modes; the BVH built by
   the native builder;
6. run D, the viewer, session and animation apps on run C's file, at
   800x600, fast preset, 32 spp per frame: the native BVH builder against
   the numpy one on run C's prims (bit for bit) and the load time by step
   (parse, dynamic scene, BVH build, wide flatten, upload); the viewer
   (``InteractiveViewer``): 2 progressive frames, the orbit key, a session
   saved and reloaded through its W/L keys in a temporary working
   directory (the tables equal after the reload but for the BSDF table:
   the session keeps no materials), the launches of each frame as the
   schedule gives; ``raytrace_video`` on run C's terrain rigged with a
   three-joint skeleton, 4 frames of 32 spp, each re-skinned, rebuilt
   natively and rendered by the kernels, read back with load_png; and
   tree width 16 through ``traversal="auto"`` (the torch traversal of
   ops/traverse.py, no kernel): its traces against trace_bruteforce on
   262,144 terrain n=121 rays, a full frame, and card vs CPU on terrain
   n=8 under max_leaf_size=4;
7. run E, the config fields whose paths the shipped preset does not take,
   at 800x600, 32 spp, depth 4, on run B's terrain and run C's document,
   each field on its own beside the shipped preset (a warm-up frame, then
   a counted one): ``compact_depths=True`` (whole-depth compaction: the
   payload form of the partition on the frame's path state, n_live and
   the bucket per roulette depth, the launches the schedule gives, and
   card vs CPU on the small frames of phase 4 with ``fuse_frame="yes"``);
   ``traversal_secondary="pallas"`` (seeded wavefront passes) and
   ``traversal="dfs", seed_primary=True`` (seeded DFS passes): the seeded
   trace against the unseeded one on all its lanes, the seed sweep's time,
   and, on run B, the seeded kernels against their seeded plain versions
   on the frame's first seeded traces, all their lanes (the DFS camera
   and depth-0 shadow passes; the wavefront's depth-1 bounce and its
   shadow pass); ``slab_bf16=True``: every trace of the warm-up frame
   against its f32 twin to the bit, and the bf16 DFS, count and pack
   against their plain versions and against the f32 forms (time, visits
   per ray, entries per level) on run B's camera trace and depth-2
   closest-hit trace, all their lanes;
8. run F, multi-card rendering and the PathTracer oracle: run B's terrain
   through ``parallel/shard.ShardedRenderer`` (fast preset, 800x600, 32
   spp per frame) over one entry of the card, over four in samples mode
   (4 shards of 8 spp) and over four in tiles mode (slabs of 150 rows,
   tiles32s), a warm-up frame then a counted one each, beside the
   WavefrontRenderer's frame: dropped == 0, launches = shards x one
   shard's schedule, the frame against its shards traced one by one
   through ``_render_chunk`` (samples, rtol 1e-6) or ``_trace_slab``
   (tiles, to the bit), a profiled frame's kernel time and busy share;
   the small sharded frames of tests/test_torch_shard.py (8 shards) on
   the card and on the CPU, per pixel; ``render_cli --chips`` past the
   visible cards (exits naming how many) and ``--chips 1``; and
   ``render/pathtracer.PathTracer`` on the card: against the CPU
   (Cornell box 64x48, ns_aa=16, buffers within rtol 1e-9 / atol
   1e-12), against the card's engine by tests/test_radiance.py's z-test
   (ns_aa=64, 4 worker threads), and one 32x32 tile of run C's document
   at ns_aa=16, timed on the card and on this machine's CPU;
9. the wavefront's dyn_alloc form (no count: pack places each tile's
   survivors for a child as one run at a bump cursor, and the next level
   reads through the runs sorted by segment): what ptxas says of pack's
   four instantiations, then on run B's 15,360,000 camera rays (all
   live, six levels) and its warm-up frame's depth-2 closest-hit and
   shadow traces (compacted) the whole trace with dyn_alloc=True,
   fused_counts=True and fused_counts=False (t and prim bit-equal across
   the three, dropped 0, no count launched under dyn_alloc, device
   launches and times in turns), and the form's pack kernel against its
   plain version level by level (keys bit-equal, written counts equal to
   each other and to count_plain's, the run table tiling the positions
   handed out, the next queue equal as a set per segment; kernel, plain,
   the next level's table and the bound timed); the box_bf16 and seeded
   forms once each on the camera trace;
10. run G, render_cli's default preset (``--preset reference``: raster
   order, a draw per ray, no roulette, ``traversal="auto"``, 2 spp per
   pass) on run C's document at 800x600: 64 spp at tree width 4 and at
   width 2, then 4 spp each under ``--hemisphere cosine``,
   ``--reference-compat --camera-mode cutracer``, ``-l 2 -m 4`` and
   ``--tree-width 8``: dropped == 0, the DFS launches the NEE schedule
   gives (no other kernel), the PNG read back; the DFS kernel at tree
   width 2 against its plain version on that run's camera and depth-0
   shadow traces (hit/miss, prim and t bit-equal; kernel, plain and
   bound times); and each setting on the card and on the CPU, per pixel,
   on the document at terrain n=8 under max_leaf_size=4;
11. run H, the infinite lights, whose NEE samples lie at an infinite
   distance (max_t 1e30, the traversals' no-limit bound): run C's
   document with a directional light beside its area light and a
   256x512 sky map written as a float ZIP EXR, through
   ``render_cli.main`` at 800x600 with ``-e``: the fast preset at 64 spp
   (2 frames of 32) and the default preset at 4 spp; and the lightless
   document (the loader's default ambient light, an infinite
   hemisphere) under the fast preset at 4 spp: dropped == 0, the
   launches the schedule gives at the scene's lights, the PNG read
   back, ms per frame and a profiled frame's busy share; the DFS on the
   fast run's depth-0 shadow traces toward the directional and the
   environment light, and the ray form of the partition, count, pack
   and decode on its first roulette depth's, against their plain
   versions (bit-equal as in phase 3), and the wavefront trace against
   the DFS there (hit/miss and shadow decisions; any hit may stop a
   shadow ray, so t is counted); each setting on the card and on the
   CPU, per pixel, on the document at terrain n=8 under
   max_leaf_size=4; and the card's engine against the card's
   PathTracer under the sky map (phase 8's z-test);
12. run I, the frame as CUDA graphs (render/graphs.py) against the eager
   frame in six settings (RUN_I), 3 frames each, the last after a camera
   move: bit-equal, launches as the schedule gives, each graph captured
   once, times in turns, busy share, peak memory;
13. the uniform kernel (ops/csrc/rng.cu, every rng.uniform of a frame on
   the card): what ptxas says of it; no launch for an empty draw; a
   captured draw replayed under three keys loaded into its KeyTable;
   run A (eager and graphed), run G's default pass and run H's
   three-light reference pass drawn by the kernel and again by
   uniform_plain (the script swaps rng.uniform; the package has no
   switch), all bit-equal, launches as the schedule gives, times in
   turns and a profiled frame each; and the kernel against uniform_plain
   at the shapes run A's frame draws ([15,360,000], (15,000, 2)
   repeated 1,024 times), at [15,360,000, 2] (the per-lane draw;
   raygen's own is hashed in raygen.cu) and at 15,360,001, with an int
   key and a KeyTable key, bit for bit, timed beside its bound;
14. run K, the shading kernels (ops/csrc/shade.cu: the four stages
   shade_hit, nee_prep, nee_accum, scatter with its roulette, and the
   fused chain a frame runs on the card, one gap kernel after each
   trace): what ptxas says of them; every stage call of eight eager
   frames shaded stage by stage (run A; run C's document under the fast
   preset: mirror and glass; a refractive sphere, a point and a spot
   light under the default preset, and with NEE at depth 0 only; run G's
   --hemisphere cosine and --reference-compat; run H's directional light
   and sky map; the lightless document's hemisphere), then every gap of
   the same frames shaded by the chain (the plain chain started from the
   stage kernel's hit record; the stage kernels chained, to the bit),
   held against its plain version on the same inputs, within
   rtol 1e-5 / atol 1e-6 per float field (scatter's importance on a
   diffuse lane whose weight is ill-conditioned: rtol 1e-5 plus the
   weight's conditioning, from the inputs), bool and index fields exact,
   every lane that differs near a threshold, every branch, lobe and gap
   variant reached; each stage kernel timed at run A's shapes beside the
   bytes its call needs and its plain version, each gap variant beside
   the bytes it needs and moves and the stage kernels it replaces; and
   runs A, B, B under compact_depths, G's pass and H's reference pass,
   graphed, shaded by the chain and again by the plain stages (the
   script swaps the stage functions; the package has no switch) in one
   process: pixels within
   the card-vs-CPU gate, launches as the schedule gives, times in turns
   and a profiled frame each;
15. run L, the frame's two ends (ops/csrc/raygen.cu: the camera rays with
   their draws hashed in place; film.cu: reconstruct + accumulate, and the
   3x3 median): what ptxas says of them; run A, run G's default pass, its
   ``--reference-compat --camera-mode cutracer`` setting and run F's four
   shards, 3 frames each (the last after a camera move) on the kernels,
   eager and graphed, and on the plain routes, graphed (the script swaps
   raygen and the film; the package has no switch): eager and graphed
   bit-equal, kernel frames within the card-vs-CPU gate of plain ones,
   launches as the schedule gives (raygen and the film once a frame, the
   median where the accumulated samples are below the threshold), times
   in turns and a profiled frame each; raygen against its plain version
   (d within rtol 1e-5 / atol 1e-6 on every lane) on run A's camera
   (tiles32s, and tiles8), run G's raster pass, the cutracer basis, a
   tiles shard of run F (row_offset 450 of 600, a partial tile row) and
   1248x702 at 5 spp (tiles32s: no divisor of the layout a power of
   two); the film on the frames' own inputs (within rtol 1e-5 / atol
   1e-6, the sample count on the device and by value; reconstruct and
   accumulate alone) and the median in both modes bit-equal to the plain
   median; the median on an 800x600 image with NaN payloads, +-0, +-inf
   and ties, bit-equal to the plain median on the CPU in both modes (and
   on the card up to the order of equal keys, which torch.sort there
   need not keep); each timed beside its bound (L2 emptied first) and
   its plain version, and the film beside torch's mean over the samples
   (the reconstruct without inv_order or the accumulate).

16. run M, the dragon-class mesh (terrain n=660, 868,562 triangles) on
   the fast preset through run B's camera: the DFS kernel bit-equal to
   its plain version on the warm-up frame's four DFS traces (camera,
   shadow, bounce, shadow), each launch's work tally equal to the plain
   version's count (as on every measure_kernel call), the wavefront's
   levels on the depth-2 traces and the camera trace, the whole
   wavefront trace against the DFS; the tally on the frame path (a
   profiled frame's tally kernels timed from the frame, the frame after
   it counted); then the tally's cost, dfs_kernel without a tally, with
   it not counting (unprofiled frames) and counting in turns, on run A's
   and run M's camera traces.  Its row: dfs_tally, launches a frame, ms
   a launch in a profiled frame, ms counting the camera trace.

Needs one CUDA card; exits non-zero (and prints no result) without one,
or when run outside a checkout of the repository.  Imports nothing of
JAX or of the JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: published H100 SXM peaks (NVIDIA data sheet): HBM bytes/s and
#: float32 FLOP/s outside the tensor cores
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: float operations the traversal needs, counted from ops/intersect.py's
#: packed_prim_test and the slab test (adds, products, divisions, sqrt,
#: min/max, compares): per non-empty child box, per triangle test, per
#: sphere test (a prim is tested by its own type only; pads cost
#: nothing), and per ray (the three reciprocals of d)
BOX_FLOPS = 25
#: bfloat16 FLOP/s outside the tensor cores: twice the float32 rate
#: (NVIDIA's H100 architecture white paper), the rate of the bf16
#: products and min/max of a slab_bf16 box test
BF16_FLOPS = 2 * F32_FLOPS
#: a bf16 box test (config slab_bf16), split by type: in f32 the 6
#: differences, their 6 roundings to bf16, the widening of tnear and
#: tfar (3 each: a product and two sums; |t| is an operand modifier) and
#: the 3 compares; in bf16 the 6 products and the 10 min/max
BOX_BF16_F32_OPS = 6 + 6 + 6 + 3
BOX_BF16_OPS = 6 + 10
#: and once per ray the roundings of 1/d to bf16, once per DFS node
#: visit the widening of the bound a child is entered under (the
#: wavefront's count and pack compare with the bound as it is)
RAY_BF16_F32_OPS = 3
VISIT_BF16_F32_OPS = 3
TRI_FLOPS = 38
SPH_FLOPS = 37
RAY_FLOPS = 3
#: 32-bit integer operations per second outside the tensor cores: the
#: issue limit, one 32-lane instruction per clock from each of an SM's
#: four schedulers (128 lane operations per SM and clock), 132 SMs at the
#: 1.98 GHz that F32_FLOPS implies (which counts a fused multiply-add as
#: two).  Not the 64 INT32 lanes per SM of the white paper: the compiler
#: also issues integer adds to the FMA pipes (IMAD), and rng.cu's kernel
#: ran past the 64-lane rate on the H100
INT32_OPS = F32_FLOPS / 2
#: u32 operations of one draw of ops/csrc/rng.cu, counted from its draw():
#: 2 counter adds, 20 rounds of add, funnel shift and xor, 5 key
#: injections of 2 adds, and xor, shift and or of the map to [1, 2)
RNG_INT_OPS = 2 + 20 * 3 + 5 * 2 + 3

#: the main path's device (the script checks there is a card)
DEVICE = "cuda"
N_RAYS = 262_144
WIDTH, HEIGHT = 800, 600
PIXEL_RTOL, PIXEL_ATOL, MAX_BAD = 1e-4, 1e-5, 0.01
#: camera (origin, look-at) of run A (bench.py's fallback viewpoint) and
#: of run B (above the terrain, which then fills the frame)
VIEW_A = ([0, 0.75, 2.5], [0, 0.75, 0])
VIEW_B = ([0, 1.3, 1.3], [0, 0, 0])


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int, prep=None) -> float:
    """Device time of fn() per call: CUDA events around each call, behind
    a device sleep long enough for the host to queue every call, so no
    host gap between launches is timed.  prep() (not timed) runs before
    each call."""
    import torch

    if prep is not None:
        prep()
    fn()  # warm
    torch.cuda.synchronize()
    torch.cuda._sleep(20_000_000)
    evs = []
    for _ in range(reps):
        if prep is not None:
            prep()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        evs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in evs) / reps


def fast_config(**over):
    """bench.py's configuration: the fast preset as shipped."""
    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs

    kw = fast_preset_kwargs(WIDTH, HEIGHT, 64)
    kw.update(**over)
    return RenderConfig(width=WIDTH, height=HEIGHT, total_samples=64,
                        max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)


#: the fused shading chain's variants (ops/shade_stages.py GAPS)
GAP_VARIANTS = ("open_nee", "open_nee_store", "open_scatter", "open",
                "step", "step_store", "close_scatter", "close_stored")
#: the kernels and their bf16 forms: name -> (module of its wrapper, its
#: launch counter there)
COUNTERS = {
    "packet_dfs": ("packet_dfs", "launches"),
    "packet_dfs_bf16": ("packet_dfs", "bf16_launches"),
    "dfs_tally": ("packet_dfs", "tally_launches"),
    "partition_rays": ("partition", "ray_launches"),
    "partition": ("partition", "launches"),
    "wf2_count": ("wavefront2", "count_launches"),
    "wf2_count_bf16": ("wavefront2", "count_bf16_launches"),
    "wf2_pack": ("wavefront2", "pack_launches"),
    "wf2_pack_bf16": ("wavefront2", "pack_bf16_launches"),
    "wf2_pack_dyn": ("wavefront2", "pack_dyn_launches"),
    "wf2_pack_dyn_bf16": ("wavefront2", "pack_dyn_bf16_launches"),
    "wf2_decode": ("wavefront2", "decode_launches"),
    "rng_uniform": ("rng", "launches"),
    "shade_hit": ("shade_stages", "shade_hit_launches"),
    "nee_prep": ("shade_stages", "nee_prep_launches"),
    "nee_accum": ("shade_stages", "nee_accum_launches"),
    "scatter": ("shade_stages", "scatter_launches"),
    **{f"gap_{g}": ("shade_stages", f"{g}_launches") for g in GAP_VARIANTS},
    "raygen": ("shade", "raygen_launches"),
    "film": ("filters", "film_launches"),
    "median3x3": ("filters", "median_launches"),
}
#: leaf prims a pack block stages in shared memory (WF_STAGE_PRIMS of
#: ops/csrc/wavefront2.cu); a segment with more reads them from global
WF_STAGE_PRIMS = 128
#: kernels and forms the shipped preset does not launch: the partition's
#: payload form (whole-depth compaction) and the bf16 forms (slab_bf16),
#: which phase 7 drives, pack's dyn_alloc forms, which phase 9 drives,
#: and the four shading stages and the fused chain's variants for more
#: than one sample and light at a depth or for none (the preset's one
#: sample of one light at every depth), which phase 14 drives
OFF_PATH = ("partition", "packet_dfs_bf16", "wf2_count_bf16",
            "wf2_pack_bf16", "wf2_pack_dyn", "wf2_pack_dyn_bf16",
            "shade_hit", "nee_prep", "nee_accum", "scatter",
            "gap_open_scatter", "gap_open", "gap_step", "gap_step_store")


def _ops_module(name):
    """The module of a kernel wrapper: under ops/, or the package's rng."""
    import importlib

    pkg = "cuda_raytracer_tpu_torch" + ("" if name == "rng" else ".ops")
    return importlib.import_module(f"{pkg}.{name}")


def reset_launches():
    from cuda_raytracer_tpu_torch.render import graphs

    for mod, attr in COUNTERS.values():
        setattr(_ops_module(mod), attr, 0)
    graphs.warmup_launches.clear()
    _median_frames.clear()
    _watch_medians()


#: frames rendered since reset_launches() whose film runs the median
#: (the accumulated samples below cfg.post_process_threshold), by id of
#: the renderer
_median_frames = {}


def _watch_medians():
    """Note each frame of a WavefrontRenderer or ShardedRenderer that runs
    the median in _median_frames (their render() wrapped once): the
    schedule of median3x3 launches, read by expected_launches."""
    from cuda_raytracer_tpu_torch.parallel.shard import ShardedRenderer
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    for cls in (WavefrontRenderer, ShardedRenderer):
        render = cls.render
        if getattr(render, "notes_medians", False):
            continue

        def noted(self, _render=render):
            cfg = getattr(self, "config", None) or self.cfg
            if self.image_samples < cfg.post_process_threshold:
                _median_frames[id(self)] = _median_frames.get(id(self), 0) + 1
            return _render(self)

        noted.notes_medians = True
        cls.render = noted


def read_launches():
    """Launches per kernel since reset_launches(), a graph's replays
    included, the warm-up frames before a capture (render/graphs.py)
    left out: what the frames' schedule gives."""
    from cuda_raytracer_tpu_torch.render import graphs

    warm = graphs.warmup_launches
    return {k: getattr(_ops_module(mod), attr) - warm.get((mod, attr), 0)
            for k, (mod, attr) in COUNTERS.items()}


def phase_setup():
    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.ops import _build, filters, packet_dfs
    from cuda_raytracer_tpu_torch.ops import partition, shade, shade_stages
    from cuda_raytracer_tpu_torch.ops import wavefront2

    print(f"[setup] card: {smi_line()}")
    nvcc = _build.nvcc_command("", "")[0]
    ver = subprocess.run([nvcc, "--version"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    print(f"[setup] nvcc: {ver[-1]}")
    t0 = time.perf_counter()
    sources = (("packet_dfs", packet_dfs.build_defines()),
               ("partition", ()), ("wavefront2", ()), ("rng", ()),
               ("shade", ()), ("raygen", ()), ("film", ()))
    _build.build_all(sources)
    for mod in (packet_dfs, partition, wavefront2, rng, shade_stages, shade,
                filters):
        mod._load_library()
    print(f"[setup] {', '.join(f'{s}.cu' for s, _ in sources)} built (one "
          f"nvcc each, in parallel) and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    for name, defines in sources:
        for line in _build.ptxas_report(name, defines):
            print(f"[setup] ptxas, {name}.cu: {line}")


def closest_ray_set(r, g):
    """N_RAYS closest-hit rays for renderer r's scene on its device: camera
    rays of r's camera (half), random incoherent rays drawn from numpy
    generator g, and invalid lanes (the last N_RAYS // 32)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.ops import shade as S

    dev = r.device
    n_cam, n_inv = N_RAYS // 2, N_RAYS // 32
    n_rnd = N_RAYS - n_cam - n_inv
    o_c, d_c = S.generate_camera_rays(
        rng.PRNGKey(7), 512, n_cam // 512, 1, r.camera.pos, r.camera.c2w,
        math.tan(math.radians(r.camera.hFov) / 2),
        math.tan(math.radians(r.camera.vFov) / 2),
        pix_order="tiles32s", device=dev,
    )
    o_r = g.uniform([-1.0, -0.2, -1.0], [1.0, 0.6, 1.0], (n_rnd + n_inv, 3))
    d_r = g.standard_normal((n_rnd + n_inv, 3))
    d_r /= np.linalg.norm(d_r, axis=1, keepdims=True)
    o = torch.cat([o_c, torch.as_tensor(o_r, dtype=torch.float32,
                                         device=dev)])
    d = torch.cat([d_c, torch.as_tensor(d_r, dtype=torch.float32,
                                         device=dev)])
    valid = torch.arange(N_RAYS, device=dev) < n_cam + n_rnd
    return o, d, valid


def terrain_ray_set(dev, n=121, **over):
    """262,144 rays on terrain n (fast_config(**over)): camera rays of
    the slice, random incoherent rays and invalid lanes (closest-hit
    set), plus shadow rays from the camera hits toward the area light."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import shade as S
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(**over), device=dev)
    r.load_static_scene(terrain_scene(n=n))
    r.setup()
    scene = r.scene
    g = np.random.default_rng(11)
    o, d, valid = closest_ray_set(r, g)

    # shadow rays: camera hits of the closest set toward the light
    res = packet_dfs.trace_closest_packets(scene, o, d, valid)
    hit = S.compute_hits(scene, o, d, res.t, res.prim)
    u = torch.as_tensor(g.random((N_RAYS, 2)), dtype=torch.float32,
                        device=dev)
    o_s, d_s, max_t, _, _ = S.nee_shadow_rays(
        scene, hit, torch.ones_like(o), 0, u, 1.0
    )
    return scene, (o, d, valid, None), (o_s, d_s, hit.valid, max_t)


def _plain_chunked(args, chunk, stats):
    """The plain version over chunks of the rays (rays are independent,
    so the result is the same; it bounds the plain version's [N, stack]
    stack and leaf temporaries at main-path sizes)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs

    rays, tables = args[:4], args[4:]
    parts = [
        packet_dfs.dfs_trace_plain(
            *(None if x is None else x[i:i + chunk] for x in rays),
            *tables, stats=stats)
        for i in range(0, rays[0].shape[0], chunk)
    ]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]),
            sum(p[2] for p in parts))


def measure_kernel(label, scene, rays, do_kill, chunk=1 << 20, bf16=False,
                   max_t=None):
    """The kernel against its plain version on one ray set (o, d, valid,
    t_start: a shadow ray's t_limit, or a seeded start bound):
    hit/miss, prim and t bit-equal, shadow decisions equal (against
    ``max_t``, by default t_start), dropped == 0.  ``do_kill`` (shadow
    mode) and ``bf16`` select the form.  Then kernel time (CUDA events),
    plain time (host clock) and the bound from these rays' bytes and the
    work this data needs, as the plain version counted it."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs

    b = scene.bvh
    rays = tuple(None if x is None else x.contiguous() for x in rays)
    args = (*rays, b.dfs_node_rows, b.dfs_prim_rows, b.node_meta, b.width,
            1e-3, packet_dfs.stack_entries(b), do_kill, bf16)
    if max_t is None and do_kill:
        max_t = rays[3]
    tally, on = dfs_tally_tensors(True)
    tk, pk, dropped = packet_dfs.launch_trace(*args, tally, on)
    tallied = dict(zip(packet_dfs.TALLY_KEYS, tally.sum(0).tolist()))
    stats = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tp, pp, dropped_plain = _plain_chunked(args, chunk, stats)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    want = dict(stats, **packet_dfs.launch_counts(n_rays(rays), *args[3:7]))
    want = {k: want.get(k, 0) for k in packet_dfs.TALLY_KEYS}
    print(f"[kernel] {label}: the launch's tally {tallied}")
    check(tallied == want, f"{label}: the kernel's tally {tallied} is not "
          f"the plain version's count {want}")
    hm = int(((pk < 0) != (pp < 0)).sum())
    prim_bad = int((pk != pp).sum())
    t_bad = int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
    both = (pk >= 0) & (pp >= 0)
    err = float((tk - tp).abs()[both].max()) if bool(both.any()) else 0.0
    ulp = ((tk.view(torch.int32).long() - tp.view(torch.int32).long())
           .abs()[both])
    max_ulp = int(ulp.max()) if ulp.numel() else 0
    dropped, dropped_plain = int(dropped), int(dropped_plain)
    n = rays[0].shape[0]
    print(f"[kernel] {label}: {n} rays, hit/miss mismatches {hm}, prim "
          f"mismatches {prim_bad}, t bit mismatches {t_bad}, max ulp gap "
          f"{max_ulp}, max |dt| {err}, dropped {dropped} (plain "
          f"{dropped_plain}), hits {int((pk >= 0).sum())}")
    check(hm == 0 and prim_bad == 0 and t_bad == 0,
          f"{label}: kernel disagrees with its plain version")
    check(dropped == 0 and dropped_plain == 0, f"{label}: dropped rays")
    if max_t is not None:
        eps = 1e-3
        dec_bad = int(((tk > max_t - eps) != (tp > max_t - eps)).sum())
        print(f"[kernel] {label}: shadow decisions differing: {dec_bad}")
        check(dec_bad == 0, f"{label}: shadow decisions differ")

    # the trace alone, with no tally kernel behind it
    ms = cuda_time_ms(lambda: packet_dfs.launch_trace(*args), 5)
    # each input read once, each output (t, prim, dropped) written once
    nbytes = sum(x.numel() * x.element_size()
                 for x in args[:7] if x is not None) + 8 * n + 8
    flops, bf16_ops = box_ops(stats["boxes"], n, bf16, stats["visits"])
    flops += stats["tris"] * TRI_FLOPS + stats["spheres"] * SPH_FLOPS
    bound = _bound(nbytes, flops, bf16_ops)
    bytes_ms, ops_ms, bound_ms = (bound["bytes_ms"], bound["ops_ms"],
                                  bound["bound_ms"])
    print(f"[kernel] {label}: kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, "
          f"bound {bound_ms:.5f} ms, {bound_ms / ms:.3f} of it reached "
          f"(bytes {nbytes} -> {bytes_ms:.5f} ms; {flops} f32 and "
          f"{bf16_ops} bf16 operations from "
          f"{stats['visits']} visits ({stats['visits'] / n:.3f} per ray, "
          f"stack {args[9]}), {stats['boxes']} box tests, "
          f"{stats['tris']} triangle and {stats['spheres']} sphere tests "
          f"-> {ops_ms:.5f} ms)")
    return dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                bound_by=bound["bound_by"], max_abs_err=err,
                visits=stats["visits"] / n, t=tk, prim=pk)


def phase_kernel(dev):
    """The DFS kernel on the terrain ray sets; then, on the same rays
    (a dense population with a deep descent, which the main path's
    roulette-thinned traces are not), the partition, count and pack
    kernels against their plain versions and the whole wavefront trace
    against the DFS kernel."""
    scene, closest, shadow = terrain_ray_set(dev)
    a = measure_kernel("terrain closest-hit", scene, closest, False)
    b = measure_kernel("terrain shadow", scene, shadow, True)
    for label, rays in (("terrain closest-hit", closest),
                        ("terrain shadow", shadow)):
        measure_partition(label, rays)
        measure_wavefront(label, scene, rays)
        compare_traces(label, scene, rays)
    # the widest tree the kernels take, and segments whose leaf prims do
    # not fit the pack kernel's staging buffer (terrain n=40 under
    # max_leaf_size=64: 14 segments of its level 2)
    for tag, n, over in (("W=8 terrain", 121, dict(tree_width=8)),
                         ("terrain n=40, max_leaf_size=64", 40,
                          dict(max_leaf_size=64))):
        scene_x, closest_x, shadow_x = terrain_ray_set(dev, n, **over)
        for label, rays in ((f"{tag} closest-hit", closest_x),
                            (f"{tag} shadow", shadow_x)):
            got = measure_wavefront(label, scene_x, rays)
            compare_traces(label, scene_x, rays)
            if "max_leaf_size" in over:
                check(got["n_global"] > 0, f"{label}: no segment read its "
                      f"leaf prims from global memory")
    return max(a["max_abs_err"], b["max_abs_err"])


def draws_per_frame(cfg, num_lights):
    """Launches of the uniform kernel in one frame of ``cfg`` over
    ``num_lights`` lights: at each depth one per NEE sample and light;
    below max depth two for scatter (the hemisphere draw, or draw_u2's
    shared one under rng_granule > 1, and the Fresnel pick) and one for
    roulette from rr_start_depth on.  Compacted depths draw the same over
    their bucket.  Raygen's draw is hashed inside its own kernel (on the
    CPU, raygen's plain version makes one more rng.uniform call)."""
    n = 0
    for depth in range(cfg.max_depth):
        if depth < len(cfg.nee_schedule):
            n += cfg.nee_schedule[depth][0] * num_lights
        if depth + 1 < cfg.max_depth:
            n += 2 + bool(cfg.rr_start_depth
                          and depth + 1 >= cfg.rr_start_depth)
    return n


def stage_calls(cfg, num_lights):
    """Calls of each shading stage in one frame of ``cfg`` over
    ``num_lights`` lights shaded stage by stage (the CPU's plain stages):
    shade_hit once per depth, nee_prep and nee_accum once per NEE sample
    and light, scatter (with its roulette) once per depth below max
    depth.  Compacted depths call the same over their bucket."""
    nee = sum(cfg.nee_schedule[depth][0] * num_lights
              for depth in range(min(cfg.max_depth, len(cfg.nee_schedule))))
    return dict(shade_hit=cfg.max_depth, nee_prep=nee, nee_accum=nee,
                scatter=cfg.max_depth - 1)


def gap_schedule(cfg, num_lights):
    """Launches of each variant of the fused chain (shade_stages.GAPS) in
    one frame of ``cfg`` over ``num_lights`` lights: one after each trace
    of a depth.  A depth with k = samples x lights > 0: open_nee (its
    _store form where k is 1 and the depth does not scatter), k - 1
    steps (the last a step_store where it does not scatter), then
    close_scatter, or close_stored at the last depth; with k = 0,
    open_scatter, or open at the last depth.  Together they are the
    frame's traces."""
    want = dict.fromkeys(GAP_VARIANTS, 0)
    for depth in range(cfg.max_depth):
        k = (cfg.nee_schedule[depth][0] * num_lights
             if depth < len(cfg.nee_schedule) else 0)
        scatters = depth + 1 < cfg.max_depth
        if k == 0:
            want["open_scatter" if scatters else "open"] += 1
            continue
        want["open_nee_store" if k == 1 and not scatters else "open_nee"] += 1
        if k > 1:
            want["step"] += k - 1 - (not scatters)
            want["step_store"] += not scatters
        want["close_scatter" if scatters else "close_stored"] += 1
    return want


def stage_launches(cfg, num_lights):
    """Launches of each shading kernel (ops/csrc/shade.cu) in one frame of
    ``cfg`` over ``num_lights`` lights on the card: the fused chain's by
    variant (``gap_schedule``, as ``gap_<variant>``), none of the four
    stage kernels.  Compacted depths launch the same over their
    bucket."""
    return dict(dict.fromkeys(SHADE_KERNELS, 0),
                **{f"gap_{g}": v
                   for g, v in gap_schedule(cfg, num_lights).items()})


def expected_launches(r, frames, medians=None):
    """Launches per kernel that ``frames`` frames must make, from the
    config's pass classes and the scene's wavefront schedule: a depth
    makes one closest-hit trace and one shadow trace per NEE sample and
    light; a DFS trace is one launch; a wavefront trace is one
    partition, one count if it has a level with inner children (the
    level-0 queue's: each pack counts the level after it), one pack per
    level it visits and one decode of the keys.  Under slab_bf16 the DFS,
    count and pack launches are their bf16 forms'; under whole-depth
    compaction the roulette depths' traces have no partition of their
    own, and the path state's partition runs before the first of them
    and after each but the last.  The uniform kernel: draws_per_frame;
    the shading kernels: stage_launches; raygen and the film one each a
    frame, the median ``medians`` times (None: the frames of r that ran
    it since reset_launches(), _median_frames)."""
    cfg, bvh = r.config, r.scene.bvh
    inner = [lv.has_inner for lv in bvh.wf_levels]
    n_pack = inner.index(False) + 1 if False in inner else len(inner)
    n_count = int(inner[0])
    want = dict.fromkeys(COUNTERS, 0)
    want["rng_uniform"] = draws_per_frame(cfg, r.scene.num_lights)
    want.update(stage_launches(cfg, r.scene.num_lights))
    want.update(raygen=1, film=1)
    bf = "_bf16" if cfg.slab_bf16 else ""
    # whole-depth compaction: one payload partition before the first
    # roulette depth and one after each roulette depth but the last; its
    # depths trace without the ray-form partition
    compacting = r.compacting
    if compacting:
        want["partition"] = cfg.max_depth - cfg.rr_start_depth
    for depth in range(cfg.max_depth):
        num_nee = (cfg.nee_schedule[depth][0]
                   if depth < len(cfg.nee_schedule) else 0)
        traces = 1 + num_nee * r.scene.num_lights
        rr = cfg.rr_start_depth and depth >= cfg.rr_start_depth
        kind = cfg.traversal
        if depth:
            kind = cfg.traversal_secondary or kind
        if rr:
            kind = cfg.traversal_rr or kind
        if kind in ("dfs", "auto"):
            want["packet_dfs" + bf] += traces
        else:
            want["partition_rays"] += (
                traces if rr and cfg.compact_secondary and not compacting
                else 0)
            want["wf2_pack" + bf] += traces * n_pack
            want["wf2_count" + bf] += traces * n_count
            want["wf2_decode"] += traces
    # the work tally's kernel behind every DFS trace, f32 or bf16
    want["dfs_tally"] = want["packet_dfs"] + want["packet_dfs_bf16"]
    want = {k: v * frames for k, v in want.items()}
    want["median3x3"] = (_median_frames.get(id(r), 0) if medians is None
                         else medians)
    return want


def sharded_launches(sr, frames):
    """Launches ``frames`` frames of ShardedRenderer sr make: each shard
    one shard's schedule (its raygen, bounce loop and reconstruct, one
    film launch), and on mesh[0] each frame's accumulate (one film launch)
    and, where the frame runs it, the median."""
    want = {k: v * len(sr.mesh) for k, v in
            expected_launches(sr._host, frames, medians=0).items()}
    want["film"] += frames
    want["median3x3"] = _median_frames.get(id(sr), 0)
    return want


def run_slice(label, scene_fn, frames, viewpoint=None, **over):
    """Drive the main path (warm-up frame, then ``frames`` counted
    frames) under fast_config(**over).  Returns a dict: the counted
    ``launches`` per kernel, the renderer ``r``, ``ms`` per frame, and
    the rays (o, d, valid, t_limit) of the warm-up frame's first DFS
    closest-hit trace (``dfs[True]``) and shadow trace (``dfs[False]``)
    and first wavefront closest-hit and shadow trace (``wf``), and those
    of every DFS trace of the warm-up frame in order (``dfs_all``)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(**over), camera_mode="collada",
                          device=DEVICE)
    t0 = time.perf_counter()
    r.load_static_scene(scene_fn())
    load_s = time.perf_counter() - t0
    if viewpoint is not None:
        r.set_viewpoint(*viewpoint)
    # warm-up frame (allocator, first launches); keeps the inputs of the
    # first closest-hit and first shadow trace of each traversal
    seen_dfs, seen_wf, dfs_all = {}, {}, []
    launch, trace_wf = packet_dfs.dfs_trace_cuda, backends.trace_closest_wavefront

    def keep_dfs(*args):
        seen_dfs.setdefault(args[3] is None, args[:4])
        dfs_all.append(args[:4])
        return launch(*args)

    def keep_wf(scene, o, d, valid, t_limit, *args, **kw):
        seen_wf.setdefault(t_limit is None, (o, d, valid, t_limit))
        return trace_wf(scene, o, d, valid, t_limit, *args, **kw)

    packet_dfs.dfs_trace_cuda = keep_dfs
    backends.trace_closest_wavefront = keep_wf
    try:
        r.render()
    finally:
        packet_dfs.dfs_trace_cuda = launch
        backends.trace_closest_wavefront = trace_wf
    r._reset_accumulation()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    reset_launches()
    t0 = time.perf_counter()
    dropped = 0
    for _ in range(frames):
        r.render()
        dropped += r.dropped
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launches = read_launches()

    img = r.get_image()
    peak = torch.cuda.max_memory_allocated() / 2**30
    mrays = r.mrays_per_frame * frames / elapsed
    want = expected_launches(r, frames)
    levels = [len(lv[0]) for lv in r.scene.bvh.wf_sched]
    print(f"[slice {label}] traversal_rr={r.config.traversal_rr!r}, "
          f"{r.scene.num_prims} prims, wavefront segments per level "
          f"{levels}, flatten {load_s:.2f} s, {frames} frame(s) of "
          f"{r.config.samples_per_frame} spp: {mrays:.3f} Mrays/s, "
          f"{elapsed / frames * 1e3:.1f} ms/frame, dropped {dropped}, image "
          f"mean {float(img.mean()):.6f}, finite "
          f"{bool(np.isfinite(img).all())}, peak device memory {peak:.2f} "
          f"GiB, launches {launches} (want {want})")
    check(img.shape == (HEIGHT, WIDTH, 3), "image shape")
    check(bool(np.isfinite(img).all()), f"run {label}: non-finite image")
    check(float(img.mean()) > 0.0, f"run {label}: black image")
    check(dropped == 0, f"run {label}: dropped rays")
    check(r.traces_per_frame == 8, f"run {label}: traces per frame")
    check(launches == want, f"run {label}: kernel launches {launches} != "
          f"the schedule's {want}")
    return dict(launches=launches, r=r, ms=elapsed / frames * 1e3,
                dfs=seen_dfs, wf=seen_wf, dfs_all=dfs_all)


def n_rays(rays):
    return rays[0].shape[0]


def dfs_tally_tensors(counting: bool):
    """A DFS work tally of chip_smoke's own, apart from the renderer's
    (utils/timing.py): zeroed counters [tally_slots(), len(TALLY_KEYS)]
    and its flag, 1 where ``counting``."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs

    tally = torch.zeros((packet_dfs.tally_slots(),
                         len(packet_dfs.TALLY_KEYS)), dtype=torch.int64,
                        device=DEVICE)
    on = torch.full((1,), int(counting), dtype=torch.int64, device=DEVICE)
    return tally, on


def measure_tally_cost(label, scene, rays, do_kill=False, turns=2):
    """The DFS trace alone (no tally), with its tally kernel and the
    flag off (an unprofiled frame's launch) and with the flag on (a
    counted frame's), on one ray set, through the library call
    (packet_dfs.launch_trace), in turns (none, off, on, on, off, none,
    ...): each form's cost as a share of the trace alone."""
    from cuda_raytracer_tpu_torch.ops import packet_dfs

    b = scene.bvh
    args = (*(None if x is None else x.contiguous() for x in rays),
            b.dfs_node_rows, b.dfs_prim_rows, b.node_meta, b.width, 1e-3,
            packet_dfs.stack_entries(b), do_kill, False)
    tallies = {"none": (None, None), "off": dfs_tally_tensors(False),
               "on": dfs_tally_tensors(True)}
    forms = tuple(tallies)
    ms = {f: [] for f in forms}
    for i in range(turns):
        for form in (forms if i % 2 == 0 else forms[::-1]):
            ms[form].append(cuda_time_ms(
                lambda: packet_dfs.launch_trace(*args, *tallies[form]), 5))
    mean = {f: sum(v) / turns for f, v in ms.items()}
    cost = {f: mean[f] / mean["none"] - 1 for f in ("off", "on")}
    print(f"[tally] {label}: {n_rays(rays)} lanes, dfs_kernel without a "
          f"tally {[f'{x:.4f}' for x in ms['none']]} ms; with it, not "
          f"counting {[f'{x:.4f}' for x in ms['off']]} ms "
          f"({100 * cost['off']:+.2f}%), counting "
          f"{[f'{x:.4f}' for x in ms['on']]} ms ({100 * cost['on']:+.2f}%) "
          f"[{smi_line()}]")
    return dict(ms=ms, mean=mean, cost=cost)


def _frame_kernel_ms(render, words):
    """Device ms and launches, per word of ``words``, of the kernels
    whose names hold that word, in one render() under torch.profiler."""
    import re

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    out = {w: [0.0, 0] for w in words}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        for w in words:
            if re.search(rf"\b{w}\b", e.key):
                out[w][0] += e.self_device_time_total / 1e3
                out[w][1] += e.count
    return out


def tally_on_frames(label, r, launches):
    """The DFS tally on run ``label``'s frame path (renderer r, warm,
    whose frame makes ``launches`` DFS traces): one frame under the
    profiler, whose tally kernels must return at once (their device ms
    per launch, and dfs_kernel's, read from the frame), then one frame
    after it, which the renderer's tally (utils/timing.py) counts: one
    frame, ``launches`` launches.  Returns the launch's ms."""
    import torch

    from cuda_raytracer_tpu_torch.utils import timing

    got = _frame_kernel_ms(r.render, ("dfs_tally_kernel", "dfs_kernel"))
    (tally_ms, n_tally), (dfs_ms, n_dfs) = (got["dfs_tally_kernel"],
                                            got["dfs_kernel"])
    check(n_tally == launches and n_dfs == launches,
          f"run {label}: the profiled frame launched dfs_kernel {n_dfs} and "
          f"dfs_tally_kernel {n_tally} times, not {launches}")
    r.render()
    torch.cuda.synchronize()
    c = timing.counters()["dfs"]
    print(f"[tally] run {label}: a profiled frame's {n_tally} tally "
          f"launches {tally_ms:.4f} ms ({tally_ms / n_tally * 1e3:.2f} us "
          f"each, {100 * tally_ms / dfs_ms:.3f}% of its dfs_kernel "
          f"{dfs_ms:.4f} ms); the frame after it counted {c}")
    check(c["frames"] == 1 and c["launches"] == launches and c["rays"] > 0,
          f"run {label}: the frame after the profiled one counted {c}")
    return tally_ms / n_tally


def phase_dragon(n=660):
    """Phase 16 (run M): the dragon-class mesh, terrain n=660 (868,562
    triangles, the benchmark's dragon_terrain mesh), on the fast preset
    at 800x600x32 through run B's camera.  The DFS kernel against its
    plain version on the warm-up frame's own DFS traces (camera, its
    shadow pass, the depth-1 bounce and its shadow pass: bit-equal, the
    launch's tally equal to the plain version's count), the wavefront's
    levels against theirs on the depth-2 traces and the camera trace,
    the whole wavefront trace against the DFS kernel; the tally on the
    frame path (tally_on_frames); then the tally's cost on run A's camera
    trace and on this run's.  Returns the tally kernel's row."""
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    t0 = time.perf_counter()
    run_m = run_slice(f"M dragon terrain n={n}", lambda: terrain_scene(n=n),
                      1, viewpoint=VIEW_B)
    rm = run_m["r"]
    # the warm-up frame's eager traces (its graph captures follow them)
    names = ("camera", "depth-0 shadow", "depth-1 bounce", "depth-1 shadow")
    check(len(run_m["dfs_all"]) >= len(names),
          f"run M: {len(run_m['dfs_all'])} DFS traces in the warm-up frame")
    for name, rays in zip(names, run_m["dfs_all"]):
        measure_kernel(f"run M {name} trace", rm.scene, rays,
                       rays[3] is not None, chunk=1 << 18)
    closest, shadow = run_m["wf"][True], run_m["wf"][False]
    measure_wavefront("run M depth-2 closest-hit trace", rm.scene, closest)
    measure_wavefront("run M depth-2 shadow trace", rm.scene, shadow)
    measure_wavefront("run M camera trace", rm.scene, run_m["dfs"][True])
    compare_traces("run M depth-2 closest-hit", rm.scene, closest)
    compare_traces("run M depth-2 shadow", rm.scene, shadow)
    compare_traces("run M camera trace", rm.scene, run_m["dfs"][True])
    per_frame = run_m["launches"]["dfs_tally"]
    launch_ms = tally_on_frames("M", rm, per_frame)
    cost_m = measure_tally_cost("run M camera trace", rm.scene,
                                run_m["dfs"][True])
    del run_m, rm
    run_a = run_slice("A cornell", lambda: cornell_box_scene(
        with_spheres=True), 1, viewpoint=VIEW_A)
    cost_a = measure_tally_cost("run A camera trace", run_a["r"].scene,
                                run_a["dfs"][True])
    print(f"[run M] phase 16 took {time.perf_counter() - t0:.1f} s; the "
          f"tally costs unprofiled launches "
          f"{100 * cost_a['cost']['off']:+.2f}% (run A) and "
          f"{100 * cost_m['cost']['off']:+.2f}% (run M) of dfs_kernel's "
          f"time, counted ones {100 * cost_a['cost']['on']:+.2f}% and "
          f"{100 * cost_m['cost']['on']:+.2f}%")
    mean = cost_m["mean"]
    return dict(name="dfs_tally", route="cuda",
                source="cuda_raytracer_tpu_torch/ops/csrc/packet_dfs.cu",
                replaces=None, launches=per_frame, max_abs_err=0.0,
                ms=launch_ms, counting_ms=mean["on"] - mean["none"],
                plain_ms=None, bound_ms=None, bound_by=None,
                library_ms=None)


def _host_ms(fn):
    """Host-clock time of fn() on the card, synchronised both sides."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def box_ops(boxes, rays, bf16, visits=0):
    """(f32 ops, bf16 ops) of ``boxes`` box tests of ``rays`` rays (the
    reciprocals of d included), and of ``visits`` DFS node visits."""
    if not bf16:
        return boxes * BOX_FLOPS + rays * RAY_FLOPS, 0
    return (boxes * BOX_BF16_F32_OPS + rays * (RAY_FLOPS + RAY_BF16_F32_OPS)
            + visits * VISIT_BF16_F32_OPS), boxes * BOX_BF16_OPS


def _bound(nbytes, flops, bf16_ops=0, int_ops=0):
    """The least time for ``nbytes`` of memory traffic and ``flops`` f32,
    ``bf16_ops`` bf16 and ``int_ops`` INT32 operations, each at its own
    peak (the types share the issue slots, so their times add)."""
    bytes_ms = nbytes / HBM_BPS * 1e3
    ops_ms = (flops / F32_FLOPS + bf16_ops / BF16_FLOPS
              + int_ops / INT32_OPS) * 1e3
    return dict(bound_ms=max(bytes_ms, ops_ms),
                bound_by="bytes" if bytes_ms >= ops_ms else "operations",
                bytes_ms=bytes_ms, ops_ms=ops_ms)


def _nbytes(*tensors):
    return sum(x.numel() * x.element_size() for x in tensors)


def measure_partition(label, rays=None, payload=None):
    """Both forms of the partition kernel against their plain versions on
    one captured trace's rays: n_live equal, the live prefix equal to the
    bit (past it both leave entries undefined).  Payload form: on
    ``payload`` (a frame's path state, [N, 16]) or else make_payload's
    [N, 8] payload of the rays, timed beside the one PyTorch call that
    computes the same function (boolean-mask indexing; used nowhere in
    the port).  Ray form, given rays: on the rays, timed beside what it
    replaces on the main path, make_payload and the payload form, and
    beside boolean-mask indexing of the packed [N, 8] rays (make_payload's,
    made outside the timing), the same compaction in one PyTorch call.
    Returns {"payload": row, "rays": row}."""
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    forms = []
    if rays is not None:
        rays = tuple(None if x is None else x.contiguous() for x in rays)
        forms.append(("rays", partition.partition_rays_cuda,
                      partition.compact_rays_plain, rays))
    if payload is None:
        payload = wf.make_payload(*rays)
    forms.insert(0, ("payload", partition.partition_cuda,
                     partition.partition_plain, (payload,)))
    n, rows = payload.shape
    out = {}
    for form, launch, plain, inputs in forms:
        q_k, n_k = launch(*inputs)
        (q_p, n_p), plain_ms = _host_ms(lambda: plain(*inputs))
        k = int(n_k)
        bad = int((q_k[:k].view(torch.int32)
                   != q_p[:k].view(torch.int32)).sum())
        err = float((q_k[:k] - q_p[:k]).abs().max()) if k else 0.0
        print(f"[kernel] partition ({form}), {label}: {n} entries of "
              f"{inputs[0].shape[-1] if form == 'payload' else 8} floats, "
              f"n_live {k} (plain {int(n_p)}), {bad} words of the live "
              f"prefix differ")
        check(k == int(n_p) and bad == 0,
              f"partition ({form}), {label}: kernel disagrees with its "
              f"plain version")
        ms = cuda_time_ms(lambda: launch(*inputs), 10)
        if form == "payload":
            other = "boolean-mask call"
            other_ms = lib_ms = cuda_time_ms(
                lambda: payload[payload[:, 7] >= 0.0], 10)
            # every entry read once, every live entry and n_live written
            nbytes = (n + k) * rows * 4 + 4
        else:
            other = "make_payload + payload form"
            other_ms = cuda_time_ms(
                lambda: partition.partition_cuda(wf.make_payload(*rays)), 10)
            packed = wf.make_payload(*rays)
            lib_ms = cuda_time_ms(lambda: packed[packed[:, 7] >= 0.0], 10)
            other += (f" {other_ms:.4f} ms, boolean-mask call on the "
                      f"packed rays")
            other_ms = lib_ms
            del packed
            # valid (and t_limit) of every lane, o and d of the live lanes
            # read once; the live entries and n_live written
            nbytes = n * (1 + (4 if rays[3] is not None else 0)) \
                + k * (24 + 32) + 4
        b = _bound(nbytes, 0)
        print(f"[kernel] partition ({form}), {label}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.2f} ms, {other} {other_ms:.4f} ms, bound "
              f"{b['bound_ms']:.5f} ms (bytes), {b['bound_ms'] / ms:.3f} of "
              f"it reached")
        out[form] = dict(ms=ms, plain_ms=plain_ms, max_abs_err=err,
                         n_live=k, other_ms=other_ms, library_ms=lib_ms,
                         **b)
    return out


def _sorted_regions(queue, seg_base, total):
    """The first ``total`` entries ordered by (region, ray id): entries
    of one region are one node's, so a ray is there at most once."""
    import torch

    pos = torch.arange(total, dtype=torch.int32, device=queue.device)
    region = torch.searchsorted(seg_base[1:].contiguous(), pos, right=True)
    rid = queue[:total].view(torch.int32)[:, 6].long()
    return queue[:total][torch.argsort(region * (1 << 32) + rid)]


def _plan_tensors(n_slots, n_next):
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    def z(k):
        return torch.full((k,), -7, dtype=torch.int32, device=DEVICE)

    return wf.Plan(z(n_next + 1), z(n_next + 1), z(n_slots), z(n_next))


def _check_plan(where, plan, counts, lv, cap):
    """A region plan a kernel's last block made against plan_regions and
    tile_prefix of the same counts: every word equal.  Returns the
    entries it lost."""
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    sb, route, cursor, lost = wf.plan_regions(counts, lv, cap)
    bad = sum(int((a != b).sum()) for a, b in (
        (plan.seg_base, sb), (plan.route, route), (plan.cursor, cursor),
        (plan.tile_base, wf.tile_prefix(sb))))
    check(bad == 0, f"{where}: the kernel's region plan differs from "
          f"plan_regions in {bad} words")
    return int(lost)


def _level0(rays, seed=None):
    """The level-0 queue of a captured trace as the main path makes it:
    the live lanes (the partition kernel's ray form), or with ``seed`` =
    (seed_t, seed_prim) every lane with its seeded bound and key.
    Returns (queue, seg_base, tile_base, keys)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    n = rays[0].shape[0]
    keys = torch.full((n,), wf.KEY_MISS, dtype=torch.int64, device=DEVICE)
    if seed is None:
        queue, n_live = partition.partition_rays_cuda(
            *(None if x is None else x.contiguous() for x in rays))
    else:
        from cuda_raytracer_tpu_torch.ops.seeds import seeded_bound

        o, d, valid, t_limit = rays
        seed_t, seed_prim = seed
        queue = wf.make_payload(o, d, valid,
                                seeded_bound(seed_t, t_limit, 1e-3))
        n_live = torch.tensor(n, dtype=torch.int32, device=DEVICE)
        hit = (seed_t < wf.T_NO_LIMIT) & valid & (seed_prim >= 0)
        keys = torch.where(hit, wf.hit_keys(seed_t, seed_prim), keys)
    zero = torch.zeros_like(n_live)
    seg_base = torch.stack([zero, n_live]).reshape(2)
    tile_base = torch.stack([zero, torch.div(
        n_live + wf.TILE - 1, wf.TILE, rounding_mode="floor")]).reshape(2)
    return queue, seg_base, tile_base, keys


def measure_wavefront(label, scene, rays, bf16=False, seed=None):
    """The count and pack kernels against their plain versions, level by
    level, on one captured trace (compacted, as the main path runs it,
    and with fused counts: each pack counts the next level and plans
    it).  At every level with inner children the count kernel runs too
    (the main path runs it on the level-0 queue only): counts exact, and
    equal to what the previous pack counted for this level.  After each
    kernel its region plan (seg_base, tile_base, cursors, route) equals
    plan_regions of the plain counts, word for word.  After pack the ray
    keys (hits) equal to the bit, the region cursors and the next
    level's counts exact, and the next queue equal as a set of entries
    per region (ranks come from atomic cursors, so both sides are sorted
    by ray id within a region first).  Every level is timed.  ``bf16``:
    the box_bf16 forms.  ``seed`` = (seed_t, seed_prim): a seeded pass,
    as the main path runs one (every lane queued, bounds and keys from
    the seeds, no partition).  Returns the level-0 row (count on the
    main path), the row of the inner level with the most entries, every
    row, the sums and the final keys."""
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bvh = scene.bvh
    W = bvh.width
    levels = bvh.wf_levels
    node_rows, prim_rows = bvh.wf_node_rows, scene.wf_prim_rows
    row_bytes = node_rows.shape[1] * 4
    do_kill = rays[3] is not None
    n = rays[0].shape[0]
    cap = wf.queue_capacity(n + (-n) % wf.CHUNK, 2, bvh.wf_sched)
    queue, seg_base, tile_base, keys = _level0(rays, seed)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=DEVICE)

    bound = n
    plan = None  # this level's regions, once a pack has planned them
    counted = None  # this level's counts, as the previous pack made them
    rows, best, n_global = [], None, 0
    sums = dict(count_ms=0.0, pack_ms=0.0, count_plain=0.0, pack_plain=0.0,
                count_bound=0.0, pack_bound=0.0)
    for lvl, lv in enumerate(levels):
        total, tiles = int(seg_base[-1]), int(tile_base[-1])
        # the level's schedule and the table rows it refers to, once
        # each: one node row per segment, 64 B per prim of its leaf
        # children
        tables = (_nbytes(seg_base, tile_base, lv.seg_node, lv.child)
                  + lv.num_segs * row_bytes)
        leaf = torch.where(lv.child[:, 0] == 2, lv.child[:, 2], 0)
        leaf_prims = int(leaf.sum())
        over = int((leaf.view(-1, W).sum(1) > WF_STAGE_PRIMS).sum())
        n_global += over
        nxt = levels[lvl + 1] if lv.has_inner else None
        fuse = nxt is not None and nxt.has_inner
        row = dict(level=lvl, entries=total, idle=tiles * wf.TILE - total)
        if lv.has_inner:
            counts, ticket, drop_c = zeros(lv.num_segs * W), zeros(1), \
                zeros(dtype=torch.int64)
            plan_c = _plan_tensors(lv.num_segs * W, lv.num_next)
            cargs = (queue, seg_base, tile_base, lv, node_rows, W, bound,
                     counts, plan_c, cap, drop_c, ticket, bf16)
            wf.count_cuda(*cargs)
            cstats = {}
            counts_p, row["count_plain_ms"] = _host_ms(
                lambda: wf.count_plain(queue, seg_base, lv, node_rows, W,
                                       stats=cstats, bf16=bf16))
            row["count_err"] = int((counts - counts_p).abs().max())
            check(row["count_err"] == 0,
                  f"count, {label} level {lvl}: kernel disagrees with its "
                  f"plain version")
            lost = _check_plan(f"count, {label} level {lvl}", plan_c,
                               counts_p, lv, cap)
            check(lost == 0 and int(drop_c) == 0 and int(ticket) == 0,
                  f"count, {label} level {lvl}: lost {lost}, dropped "
                  f"{int(drop_c)}, ticket {int(ticket)}")
            if counted is not None:
                check(torch.equal(counted, counts_p),
                      f"pack, {label} level {lvl - 1}: its counts of this "
                      f"level differ from the count of the queue it wrote")
            else:
                plan = plan_c
            row["count_ms"] = cuda_time_ms(lambda: wf.count_cuda(*cargs), 5,
                                           prep=counts.zero_)
            # entries, schedule and node rows read once; counts and the
            # plan written
            row["count_bound"] = _bound(
                total * 32 + tables + _nbytes(lv.parent, lv.pair)
                + counts.numel() * 4 + _nbytes(*plan_c),
                *box_ops(cstats.get("boxes", 0), total, bf16))
            total_next = int(plan.seg_base[-1])
            route, cursor0 = plan.route, plan.cursor.clone()
        else:
            total_next = 0
            route, cursor0 = lv.pair, zeros(1)
        out_k = torch.empty((max(total_next, 1), 8), dtype=torch.float32,
                            device=DEVICE)
        out_p = torch.empty_like(out_k)
        cur_k, cur_p = cursor0.clone(), cursor0.clone()
        keys_k, keys_p = keys.clone(), keys.clone()
        drop_k, drop_p = zeros(dtype=torch.int64), zeros(dtype=torch.int64)
        fused, counts_np = None, None
        if fuse:
            fused = wf.Fused(nxt, zeros(nxt.num_segs * W),
                             _plan_tensors(nxt.num_segs * W, nxt.num_next),
                             cap, zeros(1))
            counts_np = zeros(nxt.num_segs * W)

        def pack(cur, drop):
            wf.pack_cuda(queue, seg_base, tile_base, lv, route, cur,
                         node_rows, prim_rows, W, do_kill, 1e-3, out_k,
                         keys_k, drop, bound, fused, bf16)

        pack(cur_k, drop_k)
        pstats = {}
        _, row["pack_plain_ms"] = _host_ms(lambda: wf.pack_plain(
            queue, seg_base, lv, route, cur_p, node_rows, prim_rows, W,
            do_kill, 1e-3, out_p, keys_p, drop_p, stats=pstats,
            counts_next=counts_np, lv_next=nxt if fuse else None,
            bf16=bf16))
        key_bad = int((keys_k != keys_p).sum())
        cur_bad = int((cur_k != cur_p).sum())
        q_bad = cnt_bad = 0
        if total_next:
            a = _sorted_regions(out_k, plan.seg_base, total_next)
            b = _sorted_regions(out_p, plan.seg_base, total_next)
            q_bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        if fuse:
            cnt_bad = int((fused.counts != counts_np).sum())
        tk, _ = wf.decode_plain(keys_k)
        tp, _ = wf.decode_plain(keys_p)
        hit = torch.isfinite(tp)
        row["pack_err"] = (float((tk - tp)[hit].abs().max())
                           if bool(hit.any()) else 0.0)
        check(key_bad == 0 and cur_bad == 0 and q_bad == 0 and cnt_bad == 0,
              f"pack, {label} level {lvl}: kernel disagrees with its plain "
              f"version ({key_bad} keys, {cur_bad} cursors, {q_bad} queue "
              f"words, {cnt_bad} next-level counts)")
        check(int(drop_k) == 0 and int(drop_p) == 0,
              f"pack, {label} level {lvl}: dropped")
        if fuse:
            lost = _check_plan(f"pack, {label} level {lvl}", fused.plan,
                               counts_np, nxt, cap)
            check(lost == 0 and int(fused.ticket) == 0,
                  f"pack, {label} level {lvl}: lost {lost}, ticket "
                  f"{int(fused.ticket)}")
        scratch, drop_t = cursor0.clone(), zeros(dtype=torch.int64)

        def prep():
            scratch.copy_(cursor0)
            if fuse:
                fused.counts.zero_()

        row["pack_ms"] = cuda_time_ms(lambda: pack(scratch, drop_t), 5,
                                      prep=prep)
        # entries, schedule, node and prim rows read once (and, counting
        # for the next level, its schedule and node rows); survivors, hit
        # keys, region cursors (and the next counts and plan) written
        fused_bytes = 0
        if fuse:
            fused_bytes = (_nbytes(nxt.seg_node, nxt.child, nxt.parent,
                                   nxt.pair, fused.counts, *fused.plan)
                           + nxt.num_segs * row_bytes)
        flops, bf16_ops = box_ops(
            pstats.get("boxes", 0) + pstats.get("fused_boxes", 0), total, bf16)
        row["pack_bound"] = _bound(
            total * 32 + tables + _nbytes(route, cursor0) + leaf_prims * 64
            + pstats.get("survivors", 0) * 32 + pstats.get("hits", 0) * 8
            + fused_bytes,
            flops + pstats.get("tris", 0) * TRI_FLOPS
            + pstats.get("spheres", 0) * SPH_FLOPS, bf16_ops)
        print(f"[kernel] wavefront, {label}, level {lvl}: {lv.num_segs} "
              f"segments ({over} with more than {WF_STAGE_PRIMS} leaf prims), "
              f"{total} entries in {tiles} tiles ({row['idle']} idle lanes) "
              f"-> {total_next}; "
              + (f"count {row['count_ms']:.4f} ms (plain "
                 f"{row['count_plain_ms']:.1f} ms, bound "
                 f"{row['count_bound']['bound_ms']:.5f} ms by "
                 f"{row['count_bound']['bound_by']}), "
                 if lv.has_inner else "no count, ")
              + f"pack{' with fused counts' if fuse else ''} "
              f"{row['pack_ms']:.4f} ms (plain {row['pack_plain_ms']:.1f} ms, "
              f"bound {row['pack_bound']['bound_ms']:.5f} ms by "
              f"{row['pack_bound']['bound_by']}); work {pstats}")
        sums["pack_ms"] += row["pack_ms"]
        sums["pack_plain"] += row["pack_plain_ms"]
        sums["count_ms"] += row.get("count_ms", 0.0)
        sums["count_plain"] += row.get("count_plain_ms", 0.0)
        sums["pack_bound"] += row["pack_bound"]["bound_ms"]
        if lv.has_inner:
            sums["count_bound"] += row["count_bound"]["bound_ms"]
        rows.append(row)
        if best is None or (lv.has_inner and total > best["entries"]):
            best = row
        if not lv.has_inner:
            break
        keys = keys_k
        queue, seg_base, tile_base = out_k, plan.seg_base, plan.tile_base
        bound = cap
        plan, counted = (fused.plan, fused.counts) if fuse else (None, None)
    print(f"[kernel] wavefront, {label}: all levels: pack "
          f"{sums['pack_ms']:.4f} ms (bound {sums['pack_bound']:.5f} ms); "
          f"count {rows[0].get('count_ms', 0.0):.4f} ms on the level-0 queue "
          f"(the main path's), {sums['count_ms']:.4f} ms at every level "
          f"(bound {sums['count_bound']:.5f} ms); plain versions "
          f"{sums['count_plain']:.1f} and {sums['pack_plain']:.1f} ms; "
          f"{n_global} segments read leaf prims from global memory; all "
          f"comparisons equal; the JSON line takes level {best['level']} "
          f"({best['entries']} entries)")
    return dict(level0=rows[0], best=best, rows=rows, sums=sums, keys=keys,
                n_global=n_global)


def measure_decode(label, keys):
    """The decode kernel against its plain version on one trace's keys,
    with and without prim ids: t and prim equal to the bit.  Kernel and
    plain (torch ops on the card) times; the bound is 8 B read and 8 B
    written per key."""
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bad, errs = 0, [torch.zeros((), device=keys.device)]
    for want_prim in (True, False):
        tk, pk = wf.decode_cuda(keys, want_prim)
        tp, pp = wf.decode_plain(keys, want_prim)
        bad += int((tk.view(torch.int32) != tp.view(torch.int32)).sum())
        bad += int((pk != pp).sum())
        fin = torch.isfinite(tp)
        if bool(fin.any()):
            errs.append((tk - tp)[fin].abs().max())
    # torch's max keeps a NaN (a NaN t from the kernel shows as NaN)
    err = float(torch.stack(errs).max())
    n = keys.shape[0]
    print(f"[kernel] decode, {label}: {n} keys ({int((pk == -2).sum())} "
          f"hits), {bad} words differ from the plain version, max abs "
          f"error in t {err}")
    check(err == 0.0, f"decode, {label}: t differs from the plain version "
          f"by {err}")
    check(bad == 0, f"decode, {label}: kernel disagrees with its plain "
          f"version")
    ms = cuda_time_ms(lambda: wf.decode_cuda(keys), 10)
    plain_ms = cuda_time_ms(lambda: wf.decode_plain(keys), 10)
    b = _bound(n * 16, 0)
    print(f"[kernel] decode, {label}: kernel {ms:.4f} ms, plain (torch on "
          f"the card) {plain_ms:.4f} ms, bound {b['bound_ms']:.5f} ms "
          f"(bytes), {b['bound_ms'] / ms:.3f} of it reached")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **b)


def compare_traces(label, scene, rays, any_hit=False):
    """The whole compacted wavefront trace against the DFS kernel on the
    same rays: hit/miss equal, t bit-equal (both run packed_prim_test in
    one op order without FMA contraction), prim equal except where two
    prims tie at a bit-equal t (the DFS keeps its first group's winner,
    the wavefront the largest prim), shadow decisions equal.  With
    ``any_hit`` the shadow rays' limit is one no hit reaches (an
    infinite light's): a ray with several occluders may stop at any of
    them (the DFS at the first it meets, the wavefront at the closest
    of the level where it meets one), so t is counted, not held."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    o, d, valid, t_limit = rays
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a = wf.trace_closest_wavefront(scene, o, d, valid, t_limit, compact=True)
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**30
    b = packet_dfs.trace_closest_packets(scene, o, d, valid, t_limit)
    hm = int(((a.prim < 0) != (b.prim < 0)).sum())
    t_bad = int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum())
    ties = int(((a.prim != b.prim) & (a.prim >= 0)).sum())
    print(f"[trace] {label}: wavefront vs packet-DFS on {o.shape[0]} lanes "
          f"({int(valid.sum())} live): hit/miss mismatches {hm}, t bit "
          f"mismatches {t_bad}, prims differing at a bit-equal t {ties}, "
          f"hits {int((a.prim >= 0).sum())}, dropped {int(a.dropped)}; "
          f"the wavefront trace took {peak:.3f} GiB of device memory above "
          f"what was allocated before it (torch.cuda.max_memory_allocated)")
    check(hm == 0 and (any_hit or t_bad == 0),
          f"{label}: wavefront and DFS disagree")
    check(int(a.dropped) == 0, f"{label}: dropped")
    if t_limit is not None:
        eps = 1e-3
        dec = int(((a.t > t_limit - eps) != (b.t > t_limit - eps)).sum())
        print(f"[trace] {label}: shadow decisions differing: {dec}")
        check(dec == 0, f"{label}: shadow decisions differ")
    ms_wf = cuda_time_ms(lambda: wf.trace_closest_wavefront(
        scene, o, d, valid, t_limit, compact=True,
        want_prim=t_limit is None), 3)
    ms_dfs = cuda_time_ms(lambda: packet_dfs.trace_closest_packets(
        scene, o, d, valid, t_limit), 3)
    print(f"[trace] {label}: whole trace {ms_wf:.3f} ms through the "
          f"wavefront, {ms_dfs:.3f} ms through packet-DFS")
    return dict(wf_ms=ms_wf, dfs_ms=ms_dfs, peak_gib=peak)


def kernel_row(name, source, replaces, launches, k, err, library_ms=None):
    """One entry of the kernels JSON line: ``k`` holds ms, plain_ms,
    bound_ms and bound_by; ``source`` is under ops/csrc, ``replaces``
    under the JAX package's ops/pallas."""
    return dict(name=name, route="cuda",
                source="cuda_raytracer_tpu_torch/ops/csrc/" + source,
                replaces="cuda_raytracer_tpu/ops/pallas/" + replaces,
                launches=launches, max_abs_err=err, ms=k["ms"],
                plain_ms=k["plain_ms"], bound_ms=k["bound_ms"],
                bound_by=k["bound_by"], library_ms=library_ms)


def phase_slice():
    """Runs A and B as shipped, run B again with traversal_rr="dfs";
    then every kernel against its plain version on the runs' own traces
    (the main path's shapes).  Returns the JSON rows of the kernels."""
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    run_a = run_slice(
        "A cornell", lambda: cornell_box_scene(with_spheres=True), 2,
        viewpoint=VIEW_A,
    )
    run_b = run_slice("B terrain", lambda: terrain_scene(n=121), 1,
                      viewpoint=VIEW_B)
    run_b_dfs = run_slice("B terrain, roulette depths through DFS",
                          lambda: terrain_scene(n=121), 1, viewpoint=VIEW_B,
                          traversal_rr="dfs")
    print(f"[slice B] frame with the roulette depths through the wavefront "
          f"{run_b['ms']:.1f} ms, through packet-DFS {run_b_dfs['ms']:.1f} ms")
    for k in COUNTERS:
        if k not in OFF_PATH:
            check(run_b["launches"][k] > 0, f"run B never launched {k}")

    ra, rb = run_a["r"], run_b["r"]
    dfs = measure_kernel("run A camera trace", ra.scene, run_a["dfs"][True],
                         False)
    measure_kernel("run A first shadow trace", ra.scene, run_a["dfs"][False],
                   True)
    measure_kernel("run B camera trace", rb.scene, run_b["dfs"][True], False,
                   chunk=1 << 18)

    closest, shadow = run_b["wf"][True], run_b["wf"][False]
    part = measure_partition("run B depth-2 closest-hit trace", closest)
    measure_partition("run B depth-2 shadow trace", shadow)
    measure_partition("run A depth-2 closest-hit trace", run_a["wf"][True])
    measure_partition("run A depth-2 shadow trace", run_a["wf"][False])
    wfb = measure_wavefront("run B depth-2 closest-hit trace", rb.scene,
                            closest)
    wfb_s = measure_wavefront("run B depth-2 shadow trace", rb.scene, shadow)
    measure_wavefront("run A depth-2 closest-hit trace", ra.scene,
                      run_a["wf"][True])
    # many lanes live and a deep tree: all 15,360,000 camera rays of run B
    cam = measure_wavefront("run B camera trace", rb.scene,
                            run_b["dfs"][True])
    compare_traces("run B depth-2 closest-hit", rb.scene, closest)
    compare_traces("run B depth-2 shadow", rb.scene, shadow)
    compare_traces("run A depth-2 closest-hit", ra.scene, run_a["wf"][True])
    compare_traces("run B camera trace", rb.scene, run_b["dfs"][True])
    dec = measure_decode("run B depth-2 closest-hit trace", wfb["keys"])
    measure_decode("run B camera trace", cam["keys"])

    launches = run_b["launches"]

    def row(name, source, replaces, k, err, library_ms=None):
        return kernel_row(name, source, replaces, launches[name], k, err,
                          library_ms)

    # count: the main path's, on the level-0 queue; pack: the level with
    # the most entries
    cnt, pk = wfb["level0"], wfb["best"]
    return [
        row("packet_dfs", "packet_dfs.cu", "packet_dfs.py:99", dfs,
            dfs["max_abs_err"]),
        row("partition_rays", "partition.cu", "partition.py:38",
            part["rays"], part["rays"]["max_abs_err"],
            part["rays"]["library_ms"]),
        row("partition", "partition.cu", "partition.py:38",
            part["payload"], part["payload"]["max_abs_err"],
            part["payload"]["library_ms"]),
        row("wf2_count", "wavefront2.cu", "wavefront2.py:262",
            dict(ms=cnt["count_ms"], plain_ms=cnt["count_plain_ms"],
                 **cnt["count_bound"]),
            float(max(cnt["count_err"], wfb_s["level0"]["count_err"]))),
        row("wf2_pack", "wavefront2.cu", "wavefront2.py:377",
            dict(ms=pk["pack_ms"], plain_ms=pk["pack_plain_ms"],
                 **pk["pack_bound"]),
            max(pk["pack_err"], wfb_s["best"]["pack_err"])),
        row("wf2_decode", "wavefront2.cu", "wavefront2.py:1420", dec,
            dec["max_abs_err"]),
    ]

def phase_cpu_vs_cuda(extra=None, tag="cpu-vs-cuda"):
    """The shipped preset (with ``extra`` config fields) at 64x32 on the
    card and on the CPU: the Cornell box (one leaf), and terrain n=8
    under max_leaf_size=4 (three wavefront levels, so count and routing
    are on the small frame's path too)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    w, h, spf, frames = 64, 32, 2, 2
    cases = (
        ("cornell", lambda: cornell_box_scene(with_spheres=True), VIEW_A, {}),
        ("terrain n=8, max_leaf_size=4", lambda: terrain_scene(n=8), VIEW_B,
         dict(max_leaf_size=4)),
    )
    for name, scene_fn, view, over in cases:
        kw = fast_preset_kwargs(w, h, spf * frames)
        kw.update(samples_per_frame=spf, **over, **(extra or {}))
        cfg = RenderConfig(width=w, height=h, total_samples=spf * frames,
                           max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)
        imgs = []
        for dev in (DEVICE, "cpu"):
            r = WavefrontRenderer(cfg, camera_mode="collada", device=dev)
            r.load_static_scene(scene_fn())
            r.set_viewpoint(*view)
            check(r.compacting == cfg.compact_depths,
                  f"{tag} {name} on {dev}: compacting {r.compacting}")
            for _ in range(frames):
                r.render()
                check(r.dropped == 0, f"{tag} {name}: dropped")
            imgs.append(r.get_raw_image())
        a, b = imgs
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        print(f"[{tag}] {name}, {extra or 'as shipped'}, "
              f"traversal_rr={cfg.traversal_rr!r}, "
              f"{len(r.scene.bvh.wf_sched)} wavefront level(s), {w}x{h}, "
              f"{frames} frames of {spf} spp: {int(bad.sum())} of {w * h} "
              f"pixels outside rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max "
              f"|diff| {float(np.abs(a - b).max()):.3g}")
        check(float(bad.mean()) <= MAX_BAD,
              f"{tag}: card and CPU frames differ ({name})")


#: run C: the area light (world position, full extents, radiance) and
#: the camera node's world position, which the .dae camera lifts by
#: 0.75 in y (collada and cutracer modes): VIEW_A's origin
RUN_C_LIGHT = ((0.0, 1.49, 0.0), (0.6, 0.5), 10.0)
RUN_C_CAMERA = (0.0, 0.0, 2.5)
#: run C's PNG (gamma-2.2 tonemapped) must be brighter than this mean;
#: a frame that lost its light or its camera reads near 0
RUN_C_PNG_FLOOR = 0.05
#: run H's directional light: the world direction toward it (through
#: run C's open front, above the terrain) and its radiance
RUN_H_SUN_LIGHT = ((0.3, 0.5, 1.0), (2.0, 1.9, 1.7))


def run_c_objects(n):
    """Run C's objects in world coordinates, in the document's node order:
    terrain n as a triangles mesh (its vertex normals as a NORMAL input,
    its reflectance 0.7), the Cornell box's walls without its floor (the
    terrain takes its place) as polylist quads by material, and a mirror
    and a glass sphere above the terrain.  Meshes are (name, positions,
    polygons, normals or None, material), spheres (name, centre, radius,
    material); a material is (kind, parameters)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    terrain = terrain_scene(n=n).objects[0]
    v = lambda *p: np.array(p, dtype=np.float64)  # noqa: E731
    walls = {
        "white": [[v(-1, 1.5, -1), v(-1, 1.5, 1), v(1, 1.5, 1), v(1, 1.5, -1)],
                  [v(-1, 0, -1), v(-1, 1.5, -1), v(1, 1.5, -1), v(1, 0, -1)]],
        "red": [[v(-1, 0, -1), v(-1, 0, 1), v(-1, 1.5, 1), v(-1, 1.5, -1)]],
        "blue": [[v(1, 0, -1), v(1, 1.5, -1), v(1, 1.5, 1), v(1, 0, 1)]],
    }
    albedo = {"white": (0.8, 0.8, 0.8), "red": (0.8, 0.1, 0.1),
              "blue": (0.1, 0.1, 0.8)}
    meshes = [("terrain", terrain.positions, terrain.indices.tolist(),
               terrain.normals, ("phong", (0.7, 0.7, 0.7)))]
    for name, quads in walls.items():
        meshes.append((name, np.concatenate([np.stack(q) for q in quads]),
                       [list(range(4 * k, 4 * k + 4))
                        for k in range(len(quads))],
                       None, ("phong", albedo[name])))
    spheres = [
        ("mirror", v(-0.45, 0.45, -0.1), 0.3, ("mirror", (0.9, 0.9, 0.9))),
        ("glass", v(0.45, 0.45, 0.2), 0.3,
         ("glass", (0.9, 0.9, 0.9), (0.9, 0.9, 0.9), 0.0, 1.5)),
    ]
    return meshes, spheres


def _doc(points):
    """World points as the Z_UP document writes them: the inverse of the
    parser's basis, which maps a document's (x, y, z) to (-x, z, y)."""
    import numpy as np

    p = np.asarray(points, dtype=np.float64).reshape(-1, 3)
    return np.stack([-p[:, 0], p[:, 2], p[:, 1]], axis=1)


def _text(values) -> str:
    import numpy as np

    return " ".join(repr(float(x)) for x in np.asarray(values).reshape(-1))


def run_c_document(n, lights=("area",)) -> str:
    """Run C's COLLADA document (Z_UP, floats written with repr), with
    the ``lights`` it places: "area" (RUN_C_LIGHT) and "directional"
    (RUN_H_SUN_LIGHT).  With none the loader adds its default ambient
    light (an infinite hemisphere)."""
    meshes, spheres = run_c_objects(n)
    effects, materials, geometries, nodes = [], [], [], []

    def material(name, mat):
        kind, *par = mat
        if kind == "phong":
            body = ('<profile_COMMON><technique sid="common"><phong><diffuse>'
                    f'<color>{_text(par[0])} 1.0</color></diffuse></phong>'
                    '</technique></profile_COMMON>')
        elif kind == "mirror":
            body = ('<extra><technique profile="CMU462"><mirror><reflectance>'
                    f'{_text(par[0])}</reflectance></mirror></technique>'
                    '</extra>')
        else:
            body = ('<extra><technique profile="CMU462"><glass>'
                    f'<transmittance>{_text(par[0])}</transmittance>'
                    f'<reflectance>{_text(par[1])}</reflectance>'
                    f'<roughness>{par[2]!r}</roughness><ior>{par[3]!r}</ior>'
                    '</glass></technique></extra>')
        effects.append(f'<effect id="fx-{name}">{body}</effect>')
        materials.append(f'<material id="mat-{name}"><instance_effect '
                         f'url="#fx-{name}"/></material>')
        return (f'<bind_material><technique_common><instance_material '
                f'symbol="m" target="#mat-{name}"/></technique_common>'
                f'</bind_material>')

    for name, pos, polys, normals, mat in meshes:
        src = (f'<source id="{name}-pos"><float_array id="{name}-pos-arr" '
               f'count="{3 * len(pos)}">{_text(_doc(pos))}</float_array>'
               f'</source>')
        vin = f'<input semantic="VERTEX" source="#{name}-v" offset="0"/>'
        if normals is not None:
            src += (f'<source id="{name}-nrm"><float_array id="{name}-nrm-arr"'
                    f' count="{3 * len(normals)}">{_text(_doc(normals))}'
                    f'</float_array></source>')
            prim = (f'<triangles count="{len(polys)}">{vin}<input '
                    f'semantic="NORMAL" source="#{name}-nrm" offset="1"/><p>'
                    + " ".join(f"{i} {i}" for p in polys for i in p)
                    + "</p></triangles>")
        else:
            prim = (f'<polylist count="{len(polys)}">{vin}<vcount>'
                    + " ".join(str(len(p)) for p in polys) + "</vcount><p>"
                    + " ".join(str(i) for p in polys for i in p)
                    + "</p></polylist>")
        geometries.append(
            f'<geometry id="{name}"><mesh>{src}<vertices id="{name}-v">'
            f'<input semantic="POSITION" source="#{name}-pos"/></vertices>'
            f'{prim}</mesh></geometry>')
        nodes.append(f'<node id="{name}-node"><instance_geometry '
                     f'url="#{name}">{material(name, mat)}'
                     f'</instance_geometry></node>')
    for name, centre, radius, mat in spheres:
        geometries.append(
            f'<geometry id="{name}"><extra><technique profile="CMU462">'
            f'<sphere><radius>{radius!r}</radius></sphere></technique>'
            f'</extra></geometry>')
        nodes.append(f'<node id="{name}-node"><translate>'
                     f'{_text(_doc(centre))}</translate><instance_geometry '
                     f'url="#{name}">{material(name, mat)}'
                     f'</instance_geometry></node>')
    (lx, ly, lz), (ex, ey), rad = RUN_C_LIGHT
    if "area" in lights:
        # the light's default frame (facing -z, up +y) is the world's
        # facing -y under the Z_UP basis; the scale gives its extents
        nodes.append(f'<node id="light-node"><scale>{ex!r} {ey!r} 1.0'
                     f'</scale><translate>{_text(_doc((lx, ly, lz)))}'
                     f'</translate><instance_light url="#light"/></node>')
    to_sun, sun_rad = RUN_H_SUN_LIGHT
    sun_def = ""
    if "directional" in lights:
        # the loader takes the light's default direction (0, 0, -1) as a
        # point through the node's transform and points the light along
        # it (dynamic_scene.DirectionalLight): translated by the document
        # point of to_sun plus (0, 0, 1), it lands on to_sun
        at = _doc(to_sun)[0] + (0.0, 0.0, 1.0)
        nodes.append(f'<node id="sun-node"><translate>{_text(at)}'
                     f'</translate><instance_light url="#sun"/></node>')
        sun_def = ('<light id="sun"><technique_common><directional>'
                   f'<color>{_text(sun_rad)}</color></directional>'
                   '</technique_common></light>')
    # the camera's rotation is the basis' own inverse, so in the world it
    # looks down -z with +y up
    cx, cy, cz = (float(x) for x in _doc(RUN_C_CAMERA)[0])
    nodes.append(f'<node id="camera-node"><matrix>-1.0 0.0 0.0 {cx!r} '
                 f'0.0 0.0 1.0 {cy!r} 0.0 1.0 0.0 {cz!r} 0.0 0.0 0.0 1.0'
                 f'</matrix><instance_camera url="#camera"/></node>')
    return (
        '<?xml version="1.0" encoding="utf-8"?>\n<COLLADA xmlns="http://www.'
        'collada.org/2005/11/COLLADASchema" version="1.4.1"><asset><up_axis>'
        'Z_UP</up_axis></asset><library_cameras><camera id="camera"><optics>'
        '<technique_common><perspective><xfov>50.0</xfov><yfov>38.0</yfov>'
        '<znear>0.01</znear><zfar>100.0</zfar></perspective>'
        '</technique_common></optics></camera></library_cameras>'
        '<library_lights><light id="light"><extra><technique '
        f'profile="CMU462"><area><color>{_text((rad,) * 3)}</color></area>'
        '</technique></extra></light>' + sun_def + '</library_lights>'
        '<library_effects>'
        + "".join(effects) + "</library_effects><library_materials>"
        + "".join(materials) + "</library_materials><library_geometries>"
        + "".join(geometries) + "</library_geometries><library_visual_scenes>"
        '<visual_scene id="vs">' + "".join(nodes) + "</visual_scene>"
        '</library_visual_scenes><scene><instance_visual_scene url="#vs"/>'
        "</scene></COLLADA>\n"
    )


def run_c_reference(n):
    """Run C's scene built in Python from the same objects, as
    dynamic_scene builds a static mesh (fan triangulation, area-weighted
    vertex normals; a document's NORMAL input is not used)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.scene import static_scene as st
    from cuda_raytracer_tpu_torch.scene.bsdf import (
        DiffuseBSDF,
        GlassBSDF,
        MirrorBSDF,
    )
    from cuda_raytracer_tpu_torch.scene.mesh import PolygonMesh

    def bsdf(mat):
        kind, *par = mat
        return {"phong": DiffuseBSDF, "mirror": MirrorBSDF,
                "glass": GlassBSDF}[kind](*par)

    meshes, spheres = run_c_objects(n)
    objects = []
    for _, pos, polys, _, mat in meshes:
        pm = PolygonMesh(np.asarray(pos, dtype=np.float64), polys)
        tris = pm.triangulate()
        objects.append(st.Mesh(pm.vertices, pm.vertex_normals(tris), tris,
                               bsdf(mat)))
    for _, centre, radius, mat in spheres:
        objects.append(st.SphereObject(centre, radius, bsdf(mat)))
    (lx, ly, lz), (ex, ey), rad = RUN_C_LIGHT
    light = st.AreaLight([rad] * 3, [lx, ly, lz], [0.0, -1.0, 0.0],
                         [ex, 0.0, 0.0], [0.0, 0.0, ey])
    return st.Scene(objects, [light])


def _cli_run(argv, tag="run C"):
    """render_cli.main(argv) in this process; returns (the renderer it
    made, its --bench JSON).  The renderer class is wrapped only to keep
    the instance, each frame's host time (render() waits for its frame)
    and the dropped rays of every frame.  ``tag`` heads the lines it
    prints."""
    import contextlib
    import io

    from cuda_raytracer_tpu_torch.apps import render_cli
    from cuda_raytracer_tpu_torch.render import engine

    base, made = engine.WavefrontRenderer, []

    class Kept(base):
        def __init__(self, *args, **kw):
            super().__init__(*args, **kw)
            self.frame_ms, self.dropped_sum = [], 0
            made.append(self)

        def render(self):
            t0 = time.perf_counter()
            super().render()
            self.frame_ms.append((time.perf_counter() - t0) * 1e3)
            self.dropped_sum += self.dropped

    out = io.StringIO()
    engine.WavefrontRenderer = Kept
    try:
        with contextlib.redirect_stdout(out):
            rc = render_cli.main(argv)
    finally:
        engine.WavefrontRenderer = base
    for line in out.getvalue().splitlines():
        print(f"[{tag}] render_cli: {line}")
    check(rc == 0 and len(made) == 1, "render_cli did not render")
    return made[0], json.loads(out.getvalue().splitlines()[0])


def _check_tables(where, scene, want_scene, cfg):
    """Every table of the loaded FlatScene equal to flatten_tables of the
    scene built in Python under the same config, array for array."""
    import numpy as np

    from cuda_raytracer_tpu_torch.render.flatscene import flatten_tables

    fields, static, _ = flatten_tables(want_scene, cfg.tree_width,
                                       cfg.max_leaf_size, cfg.sah_bins)
    bad = []
    for name, want in fields.items():
        obj = scene.bvh if name.startswith("bvh.") else scene
        got = getattr(obj, name.split(".")[-1]).cpu().numpy()
        if got.dtype != want.dtype or not np.array_equal(got, want):
            bad.append(name)
    for name, want in static.items():
        obj = scene.bvh if name.startswith("bvh.") else scene
        if getattr(obj, name.split(".")[-1]) != want:
            bad.append(name)
    print(f"[run C] {where}: {len(fields)} tables and {len(static)} static "
          f"fields against the scene built in Python: "
          f"{'all equal' if not bad else 'differing: ' + ', '.join(bad)}")
    check(not bad, f"{where}: tables differ from the scene built in Python")


def phase_run_c(n=121, size=(WIDTH, HEIGHT), spp=64, small_n=8):
    """Run C: a COLLADA document of terrain n, the Cornell walls, two
    spheres, an area light and a camera, rendered through render_cli at
    full width (fast preset, depth 4, ``spp`` in frames of 32), once per
    camera mode that reads the document's camera; then the same document
    at terrain ``small_n`` on the card and on the CPU, per pixel."""
    import tempfile

    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer
    from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
    from cuda_raytracer_tpu_torch.scene.collada import load_scene_info
    from cuda_raytracer_tpu_torch.scene.dynamic_scene import (
        load_from_scene_info,
    )
    from cuda_raytracer_tpu_torch.utils.image import load_png

    w, h = size
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        t0 = time.perf_counter()
        text = run_c_document(n)
        with open(path, "w") as f:
            f.write(text)
        print(f"[run C] wrote {len(text)} bytes of COLLADA (terrain n={n}) "
              f"in {time.perf_counter() - t0:.2f} s")
        want_scene = run_c_reference(n)
        for mode in ("collada", "cutracer"):
            out = os.path.join(tmp, f"{mode}.png")
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
            r, bench = _cli_run([
                path, "-w", out, "-s", str(spp), "-m", "4",
                "--size", f"{w}x{h}", "--preset", "fast",
                "--camera-mode", mode, "--bench", "--device", DEVICE])
            torch.cuda.synchronize()
            launches = read_launches()
            peak = torch.cuda.max_memory_allocated() / 2**30
            frames = len(r.frame_ms)
            want = expected_launches(r, frames)
            levels = [len(lv[0]) for lv in r.scene.bvh.wf_sched]
            steady = r.mrays_per_frame / (r.frame_ms[-1] / 1e3)
            print(f"[run C] {mode}: {r.scene.num_prims} prims, wavefront "
                  f"segments per level {levels}, {frames} frames of "
                  f"{r.config.samples_per_frame} spp, ms per frame "
                  f"{[round(x, 1) for x in r.frame_ms]}, Mrays/s (bench.py's "
                  f"accounting) {bench['mrays_per_s']} over the render, "
                  f"{steady:.3f} over its last frame; load_s "
                  f"{bench['load_s']}; dropped {r.dropped_sum}; "
                  f"torch.cuda.max_memory_allocated {peak:.2f} GiB; launches "
                  f"{launches} (want {want})")
            _check_tables(f"{mode}: loaded scene", r.scene, want_scene,
                          r.config)
            print(f"[run C] {mode}: BVH built by the {r.bvh.backend_used} "
                  f"builder")
            check(r.bvh.backend_used == "native",
                  f"run C {mode}: the CLI did not build the BVH natively")
            check(r.dropped_sum == 0, f"run C {mode}: dropped rays")
            check(launches == want, f"run C {mode}: kernel launches "
                  f"{launches} != the schedule's {want}")
            for k in COUNTERS:
                if k not in OFF_PATH:
                    check(launches[k] > 0, f"run C {mode} never launched {k}")
            png = load_png(out)
            mean = float(png.mean())
            print(f"[run C] {mode}: the PNG decodes to {png.shape}, mean "
                  f"{mean:.6f} (floor {RUN_C_PNG_FLOOR})")
            check(png.shape == (h, w, 3), f"run C {mode}: PNG shape")
            check(bool(np.isfinite(png).all()) and mean > RUN_C_PNG_FLOOR,
                  f"run C {mode}: PNG mean {mean} at or below the floor")

        # the CLI's load_scene, step by step
        cfg = r.config
        t0 = time.perf_counter()
        info = load_scene_info(path)
        t1 = time.perf_counter()
        sscene = load_from_scene_info(info)[0].get_static_scene()
        t2 = time.perf_counter()
        flatten_scene(sscene, tree_width=cfg.tree_width,
                      max_leaf_size=cfg.max_leaf_size, sah_bins=cfg.sah_bins,
                      device=DEVICE)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        print(f"[run C] load_s by step: parse {t1 - t0:.3f} s, dynamic scene "
              f"+ get_static_scene {t2 - t1:.3f} s, flatten (BVH build and "
              f"tables onto the card) {t3 - t2:.3f} s; total {t3 - t0:.3f} s")

        # the card against the CPU on the same document at terrain small_n
        small = os.path.join(tmp, "run_c_small.dae")
        with open(small, "w") as f:
            f.write(run_c_document(small_n))
        sw, sh, spf, frames = 64, 32, 2, 2
        kw = fast_preset_kwargs(sw, sh, spf * frames)
        kw.update(samples_per_frame=spf, max_leaf_size=4)
        small_cfg = RenderConfig(width=sw, height=sh,
                                 total_samples=spf * frames, max_depth=4,
                                 nee_schedule=((1, 1.0),) * 4, **kw)
        for mode in ("collada", "cutracer"):
            imgs = []
            for dev in (DEVICE, "cpu"):
                rr = WavefrontRenderer(small_cfg, camera_mode=mode,
                                       device=dev)
                rr.load_scene(small)
                for _ in range(frames):
                    rr.render()
                    check(rr.dropped == 0, f"run C small {mode}: dropped")
                imgs.append(rr.get_raw_image())
            a, b = imgs
            bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
            nlev = len(rr.scene.bvh.wf_sched)
            print(f"[run C] card vs CPU, terrain n={small_n} document, "
                  f"max_leaf_size=4 ({nlev} wavefront levels), {mode}, "
                  f"{sw}x{sh}, {frames} frames of {spf} spp: "
                  f"{int(bad.sum())} of {sw * sh} pixels outside "
                  f"rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max |diff| "
                  f"{float(np.abs(a - b).max()):.3g}")
            check(nlev > 1, "run C small: the wavefront has one level")
            check(float(bad.mean()) <= MAX_BAD,
                  f"run C small {mode}: card and CPU frames differ")


#: the FlatScene tables that hold the BSDFs: the session's COLLADA writer
#: keeps no materials (in both packages), so a session reload gives every
#: object the parser's default diffuse BSDF and changes only these
MATERIAL_TABLES = ("bsdf_fn", "bsdf_albedo", "bsdf_radiance", "bsdf_ior")
#: the video's camera, held fixed (VIEW_A's origin, looking down -z)
VIDEO_POS = (0.0, 0.75, 2.5)
#: t of the width-16 traversal against trace_bruteforce on the card
W16_RTOL, W16_ATOL = 1e-5, 1e-6


def _flat_fields(scene):
    """Every field of a FlatScene and of its FlatBVH, tensors on the CPU."""
    import dataclasses

    import torch

    out = {}
    for obj, prefix in ((scene, ""), (scene.bvh, "bvh.")):
        for f in dataclasses.fields(obj):
            if f.name != "bvh":
                x = getattr(obj, f.name)
                out[prefix + f.name] = (x.cpu() if isinstance(x, torch.Tensor)
                                        else x)
    return out


def _differing(a, b):
    import torch

    return [k for k, x in a.items() if not (
        torch.equal(x, b[k]) if isinstance(x, torch.Tensor) else x == b[k])]


def _tree_nodes(bvh):
    """A binary BVH's nodes in preorder: (bounds as int64 bits, start,
    range, is_leaf)."""
    import numpy as np

    out, stack = [], [bvh.root]
    while stack:
        n = stack.pop()
        out.append((np.concatenate([n.bb_min, n.bb_max]).view(np.int64)
                    .tolist(), n.start, n.range, n.is_leaf))
        if not n.is_leaf:
            stack += [n.r, n.l]
    return out


def _native_vs_numpy(path, cfg):
    """Run C's prims built by the native and the numpy builder: the same
    tree, bit for bit; each one's build time."""
    import numpy as np

    from cuda_raytracer_tpu_torch import native
    from cuda_raytracer_tpu_torch.accel.bvh import BVHAccel
    from cuda_raytracer_tpu_torch.render.flatscene import flatten_tables
    from cuda_raytracer_tpu_torch.scene.collada import load_scene_info
    from cuda_raytracer_tpu_torch.scene.dynamic_scene import (
        load_from_scene_info,
    )

    # the library is built and loaded by now (every load since phase 2
    # builds natively); a fresh build into a scratch path times g++
    t0 = time.perf_counter()
    native.build._compile(os.path.join(os.path.dirname(path), "bvh.so"))
    print(f"[run D] native builder: one g++ build of bvh_builder.cpp "
          f"{time.perf_counter() - t0:.3f} s (a process pays it once, at its "
          f"first BVH build, unless {native.build.library_path()} exists); "
          f"loaded {native.load_library() is not None}")
    sscene = load_from_scene_info(load_scene_info(path))[0].get_static_scene()
    _, _, bvh = flatten_tables(sscene, cfg.tree_width, cfg.max_leaf_size,
                               cfg.sah_bins)
    trees = {b: BVHAccel(bvh.prim_min, bvh.prim_max, cfg.max_leaf_size,
                         cfg.sah_bins, backend=b) for b in ("native", "numpy")}
    nat, num = trees["native"], trees["numpy"]
    same_order = np.array_equal(nat.sorted_order, num.sorted_order)
    nodes_n, nodes_p = _tree_nodes(nat), _tree_nodes(num)
    print(f"[run D] BVH build of {len(bvh.prim_min)} prims (leaf "
          f"{cfg.max_leaf_size}, {cfg.sah_bins} bins): native "
          f"{nat.build_s * 1e3:.2f} ms, numpy {num.build_s * 1e3:.2f} ms; "
          f"{len(nodes_n)} nodes; sorted_order equal {same_order}, nodes "
          f"equal bit for bit {nodes_n == nodes_p}")
    check(nat.backend_used == "native", "the native builder did not run")
    check(same_order and nodes_n == nodes_p,
          "native and numpy BVH trees differ")


def _load_by_step(path, cfg):
    """load_scene's steps on run C's file: parse, dynamic scene, and
    flatten_scene's BVH build, wide flatten and upload."""
    import torch

    from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene
    from cuda_raytracer_tpu_torch.scene.collada import load_scene_info
    from cuda_raytracer_tpu_torch.scene.dynamic_scene import (
        load_from_scene_info,
    )

    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        info = load_scene_info(path)
        t1 = time.perf_counter()
        sscene = load_from_scene_info(info)[0].get_static_scene()
        t2 = time.perf_counter()
        times = {}
        _, bvh = flatten_scene(sscene, tree_width=cfg.tree_width,
                               max_leaf_size=cfg.max_leaf_size,
                               sah_bins=cfg.sah_bins, device=DEVICE,
                               times=times)
        t3 = time.perf_counter()
        print(f"[run D] load_s by step ({bvh.backend_used} build): parse "
              f"{t1 - t0:.3f} s, dynamic scene + get_static_scene "
              f"{t2 - t1:.3f} s, BVH build {times['bvh_build']:.3f} s, wide "
              f"flatten and tables {times['flatten']:.3f} s, upload "
              f"{times['upload']:.3f} s; total {t3 - t0:.3f} s")
        check(bvh.backend_used == "native", "load_scene did not build natively")


def _viewer_frames(v, n, where):
    """n progressive frames; checks the launches against the schedule.
    Returns each frame's ms (the engine's stage_times["frame"])."""
    reset_launches()
    ms = []
    for _ in range(n):
        v.frame()
        ms.append(v.renderer.stage_times["frame"] * 1e3)
        check(v.renderer.dropped == 0, f"viewer {where}: dropped rays")
    launches, want = read_launches(), expected_launches(v.renderer, n)
    print(f"[run D] viewer {where}: {n} frame(s), ms {[round(x, 1) for x in ms]}"
          f", spp {v.status()['spp']:.0f}, launches {launches} (want {want})")
    check(launches == want, f"viewer {where}: launches {launches} != the "
          f"schedule's {want}")
    return ms


def _viewer(path):
    """The viewer on run C's file: progressive frames, a move, a session
    save and reload through its keys."""
    import numpy as np

    from cuda_raytracer_tpu_torch.apps.viewer import InteractiveViewer

    t0 = time.perf_counter()
    v = InteractiveViewer(fast_config(), path, device=DEVICE)
    r = v.renderer
    print(f"[run D] viewer: loaded in {time.perf_counter() - t0:.3f} s "
          f"({r.bvh.backend_used} build {r.stage_times['bvh_build']:.3f} s, "
          f"flatten {r.stage_times['flatten']:.3f} s, upload "
          f"{r.stage_times['upload']:.3f} s); {r.scene.num_prims} prims")
    check(r.bvh.backend_used == "native", "viewer: BVH not built natively")
    ms = _viewer_frames(v, 2, "first frames")
    check(v.status()["spp"] == 64, f"viewer: spp {v.status()['spp']} != 64")
    steady = ms[-1]
    print(f"[run D] viewer steady frame {steady:.1f} ms, "
          f"{r.mrays_per_frame / (steady / 1e3):.3f} Mrays/s (bench.py's "
          f"accounting: {r.mrays_per_frame:.2f} Mrays per frame)")
    img = v.renderer.get_image()
    check(img.shape == (HEIGHT, WIDTH, 3) and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, "viewer: bad image")

    check(v.key("h") and v.status()["spp"] == 0, "viewer: h did not reset")
    _viewer_frames(v, 1, "after the orbit key")
    before = _flat_fields(r.scene)
    check(not v.key("W") and not v.key("1"), "viewer: W1 moved the view")
    check(os.path.exists("Scene_1.dae"), "viewer: W1 wrote no session")
    check(v.key("w"), "viewer: w did not move")
    t0 = time.perf_counter()
    check(not v.key("L") and v.key("1"), "viewer: L1 did not reload")
    reload_s = time.perf_counter() - t0
    after = _flat_fields(v.renderer.scene)
    diff = _differing(before, after)
    print(f"[run D] viewer: session saved (W1) and reloaded (L1) in "
          f"{reload_s:.3f} s; of {len(before)} tables and fields, those that "
          f"differ after the reload: {diff} (the session keeps no materials)")
    check(sorted(after) == sorted(before), "viewer: reload changed the fields")
    check(set(diff) <= set(MATERIAL_TABLES),
          f"viewer: the reload changed {diff}")
    _viewer_frames(v, 1, "after the reload")


def _rigged_run_c(path):
    """Run C's dynamic scene with its terrain mesh rigged: a three-joint
    skeleton along x, keyed straight at t=0 and bent at t=3."""
    import numpy as np

    from cuda_raytracer_tpu_torch.scene.collada import load_scene_info
    from cuda_raytracer_tpu_torch.scene.dynamic_scene import (
        Mesh,
        load_from_scene_info,
    )
    from cuda_raytracer_tpu_torch.scene.skeleton import Skeleton

    dscene = load_from_scene_info(load_scene_info(path))[0]
    terrain = next(o for o in dscene.objects if isinstance(o, Mesh))
    sk = Skeleton(offset=(-1.0, 0.0, 0.0))
    j1 = sk.create_joint([2.0 / 3, 0.0, 0.0])
    j2 = sk.create_joint([2.0 / 3, 0.0, 0.0], parent=j1)
    j3 = sk.create_joint([2.0 / 3, 0.0, 0.0], parent=j2)
    terrain.skeleton = sk
    terrain.keyframe(0.0)
    j2.angle = np.array([0.0, 0.0, 12.0])
    j3.angle = np.array([0.0, 0.0, 18.0])
    terrain.keyframe(3.0)
    return dscene, len(terrain.mesh.vertices)


def _video(path, tmp):
    """raytrace_video on the rigged run C scene: 4 frames of 32 spp, each
    re-skinned, rebuilt natively, uploaded and rendered by the kernels."""
    import numpy as np

    from cuda_raytracer_tpu_torch.apps import animate
    from cuda_raytracer_tpu_torch.utils.image import load_png

    dscene, n_vert = _rigged_run_c(path)
    base, frames = animate.WavefrontRenderer, []
    skin = dscene.get_transformed_static_scene

    def timed_skin(t):
        t0 = time.perf_counter()
        out = skin(t)
        frames.append({"skin": (time.perf_counter() - t0) * 1e3})
        return out

    class Kept(base):
        def load_static_scene(self, *args, **kw):
            super().load_static_scene(*args, **kw)
            frames[-1].update(backend=self.bvh.backend_used, **{
                k: self.stage_times[k] * 1e3
                for k in ("bvh_build", "flatten", "upload")})

        def render(self):
            reset_launches()
            super().render()
            f = frames[-1]
            f["render"] = self.stage_times["frame"] * 1e3
            f["launches"], f["want"] = (read_launches(),
                                        expected_launches(self, 1))
            f["dropped"] = self.dropped

    dscene.get_transformed_static_scene = timed_skin
    animate.WavefrontRenderer = Kept
    try:
        t0 = time.perf_counter()
        paths = animate.raytrace_video(
            dscene, fast_config(), max_frame=4, out_dir=os.path.join(tmp, "v"),
            prefix="Video_run_c_", spp=32,
            camera_pose=(np.array(VIDEO_POS), np.eye(3)), device=DEVICE)
        total = time.perf_counter() - t0
    finally:
        animate.WavefrontRenderer = base
    names = [os.path.basename(p) for p in paths]
    check(names == [f"Video_run_c_{i:04d}.png" for i in range(4)],
          f"video: files {names}")
    pngs = []
    for i, (p, f) in enumerate(zip(paths, frames)):
        png = load_png(p)
        pngs.append(png)
        print(f"[run D] video frame {i}: skin ({n_vert} vertices x 3 joints) "
              f"{f['skin']:.1f} ms, BVH build ({f['backend']}) "
              f"{f['bvh_build']:.1f} ms, wide flatten {f['flatten']:.1f} ms, "
              f"upload {f['upload']:.1f} ms, render (32 spp) "
              f"{f['render']:.1f} ms; PNG mean {float(png.mean()):.6f}; "
              f"launches {f['launches']}")
        check(f["backend"] == "native", f"video frame {i}: numpy build")
        check(f["launches"] == f["want"], f"video frame {i}: launches "
              f"{f['launches']} != the schedule's {f['want']}")
        check(f["dropped"] == 0, f"video frame {i}: dropped rays")
        check(png.shape == (HEIGHT, WIDTH, 3) and float(png.mean())
              > RUN_C_PNG_FLOOR, f"video frame {i}: PNG mean at or below "
              f"the floor {RUN_C_PNG_FLOOR}")
        if i:
            check(not np.array_equal(pngs[i - 1], png),
                  f"video frames {i - 1} and {i} are the same")
    print(f"[run D] raytrace_video: {len(paths)} frames in {total:.2f} s")


def _width16(n=121, small_n=8):
    """Tree width 16 through "auto" (the torch traversal): its traces
    against trace_bruteforce on the card, a full frame, and the card
    against the CPU on a small frame."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.config import RenderConfig, fast_preset_kwargs
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops.traverse import trace_bruteforce
    from cuda_raytracer_tpu_torch.render.backends import make_trace_fn
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    # the queue holds 4 entries per ray: at the default 2, run B's view
    # peaks near 2 per ray at width 16 and a full frame drops entries
    auto = dict(tree_width=16, traversal="auto", traversal_secondary="",
                traversal_rr="", queue_multiplier=4)
    cfg = fast_config(**auto)
    r = WavefrontRenderer(cfg, camera_mode="collada", device=DEVICE)
    r.load_static_scene(terrain_scene(n=n))
    o, d, valid = closest_ray_set(r, np.random.default_rng(11))
    trace = make_trace_fn(cfg)
    res, ms = _host_ms(lambda: trace(r.scene, o, d, valid))
    step = 1 << 16  # rays per brute-force call: bounds its [rays, 512]
    bf, bf_ms = _host_ms(lambda: [
        trace_bruteforce(r.scene, o[i:i + step], d[i:i + step],
                         valid[i:i + step]) for i in range(0, N_RAYS, step)])
    bt = torch.cat([b.t for b in bf])
    bp = torch.cat([b.prim for b in bf])
    hit = res.prim >= 0
    same_hit = bool(torch.equal(hit, bp >= 0))
    ok_t = bool(torch.isclose(res.t[hit], bt[hit], rtol=W16_RTOL,
                              atol=W16_ATOL).all())
    ulp = int((res.t[hit].view(torch.int32).long()
               - bt[hit].view(torch.int32).long()).abs().max())
    differ = hit & (res.prim != bp)
    ties = bool(torch.equal(res.t[differ], bt[differ]))
    print(f"[run D] W=16 terrain n={n}: {r.scene.num_prims} prims, "
          f"{r.scene.bvh.num_levels} levels; trace_closest through \"auto\" "
          f"on {N_RAYS} rays {ms:.1f} ms, trace_bruteforce {bf_ms:.1f} ms; "
          f"{int(hit.sum())} hits, hit/miss equal {same_hit}, t max ulp gap "
          f"{ulp}, prims differing {int(differ.sum())} (all at bit-equal t: "
          f"{ties}), dropped {int(res.dropped)}")
    check(same_hit and ok_t and ties and int(res.dropped) == 0,
          "W=16: trace_closest disagrees with trace_bruteforce")

    r.set_viewpoint(*VIEW_B)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    r.render()
    launches = read_launches()
    img = r.get_image()
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"[run D] W=16 frame ({WIDTH}x{HEIGHT}, {cfg.samples_per_frame} "
          f"spp, every trace through the torch traversal): "
          f"{r.stage_times['frame'] * 1e3:.1f} ms, dropped {r.dropped}, image "
          f"mean {float(img.mean()):.6f}, torch.cuda.max_memory_allocated "
          f"{peak:.2f} GiB, kernel launches {launches}")
    check(r.dropped == 0 and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, "W=16 frame: bad image")
    draws = draws_per_frame(r.config, r.scene.num_lights)
    shading = stage_launches(r.config, r.scene.num_lights)
    ends = dict(raygen=1, film=1, median3x3=_median_frames.get(id(r), 0))
    check(launches == dict(dict.fromkeys(COUNTERS, 0), rng_uniform=draws,
                           **shading, **ends),
          f"W=16 frame launched a traversal kernel (want only its {draws} "
          f"draws, the shading kernels {shading} and its ends {ends})")

    w, h, spf, frames = 64, 32, 2, 2
    kw = fast_preset_kwargs(w, h, spf * frames)
    kw.update(samples_per_frame=spf, max_leaf_size=4, **auto)
    small = RenderConfig(width=w, height=h, total_samples=spf * frames,
                         max_depth=4, nee_schedule=((1, 1.0),) * 4, **kw)
    imgs = []
    for dev in (DEVICE, "cpu"):
        rr = WavefrontRenderer(small, camera_mode="collada", device=dev)
        rr.load_static_scene(terrain_scene(n=small_n))
        rr.set_viewpoint(*VIEW_B)
        for _ in range(frames):
            rr.render()
            check(rr.dropped == 0, f"W=16 small frame on {dev}: dropped")
        imgs.append(rr.get_raw_image())
    a, b = imgs
    bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
    print(f"[run D] W=16 card vs CPU, terrain n={small_n}, max_leaf_size=4 "
          f"({rr.scene.bvh.num_levels} levels), {w}x{h}, {frames} frames of "
          f"{spf} spp: {int(bad.sum())} of {w * h} pixels outside "
          f"rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max |diff| "
          f"{float(np.abs(a - b).max()):.3g}")
    check(rr.scene.bvh.num_levels > 1, "W=16 small: one level")
    check(float(bad.mean()) <= MAX_BAD, "W=16: card and CPU frames differ")


def phase_run_d(n=121):
    """Run D: the viewer, session and animation apps on run C's file, the
    native BVH builder, and tree width 16 (phase 6)."""
    import tempfile

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        with open(path, "w") as f:
            f.write(run_c_document(n))
        os.chdir(tmp)  # the viewer's session slots go to the working dir
        try:
            cfg = fast_config()
            _native_vs_numpy(path, cfg)
            _load_by_step(path, cfg)
            _viewer(path)
            _video(path, tmp)
        finally:
            os.chdir(cwd)
    _width16(n)


def drive_e(label, load, **over):
    """Phase 7's run of one config (fast_config(**over)) on one scene
    (``load(r)`` loads it and places the camera): a warm-up frame whose
    traces are kept (the first of each traversal, closest-hit and shadow,
    seeded or not, with its arguments; the first path-state payload) and
    in which, under slab_bf16, every trace is traced again with f32 box
    tests and compared to the bit; then one counted frame: its launches
    against expected_launches, pack launches inside seeded wavefront
    traces, the compaction's n_live and bucket per depth, dropped, ms.
    The hooks read traces back to the host and count inside them, so
    these two frames run the fused programs uncaptured (graphs off); a
    second renderer then renders the same two frames as CUDA graphs,
    and its counted frame must equal the first's to the bit, with the
    launches the schedule gives."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.ops import partition
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    r = WavefrontRenderer(fast_config(**over), camera_mode="collada",
                          device=DEVICE)
    r.graphs.enabled = False
    load(r)
    buckets = []
    real_bucket = r.bucket

    def bucket(depth, n_live, n_cur):
        m = real_bucket(depth, n_live, n_cur)
        buckets.append((depth, n_live, n_cur, m))
        return m

    r.bucket = bucket
    kept, payloads = {}, []
    state = dict(warm=True, twins=0, twin_bad=0, seeded_packs=0)
    real = dict(dfs=backends.trace_closest_packets,
                pallas=backends.trace_closest_wavefront,
                part=partition.partition_cuda)

    def hooked(kind, flag):
        def trace(scene, o, d, valid, t_limit=None, *args, **kw):
            seeded = kw.get("seed_t") is not None
            packs = wf.pack_launches + wf.pack_bf16_launches
            res = real[kind](scene, o, d, valid, t_limit, *args, **kw)
            if seeded and kind == "pallas":
                state["seeded_packs"] += (wf.pack_launches
                                          + wf.pack_bf16_launches - packs)
            if not state["warm"]:
                return res
            kept.setdefault((kind, t_limit is None, seeded),
                            (scene, (o, d, valid, t_limit), kw))
            if kw.get(flag):  # the f32 twin of a bf16 trace
                twin = real[kind](scene, o, d, valid, t_limit, *args,
                                  **{**kw, flag: False})
                state["twins"] += 1
                state["twin_bad"] += int(
                    (twin.prim != res.prim).sum()
                    + (twin.t.view(torch.int32)
                       != res.t.view(torch.int32)).sum())
            return res
        return trace

    def keep_payload(payload):
        if state["warm"] and not payloads:
            payloads.append(payload)
        return real["part"](payload)

    backends.trace_closest_packets = hooked("dfs", "slab_bf16")
    backends.trace_closest_wavefront = hooked("pallas", "box_bf16")
    partition.partition_cuda = keep_payload
    try:
        r.render()
        r._reset_accumulation()
        state["warm"] = False
        buckets.clear()
        state["seeded_packs"] = 0
        torch.cuda.synchronize()
        reset_launches()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
    finally:
        backends.trace_closest_packets = real["dfs"]
        backends.trace_closest_wavefront = real["pallas"]
        partition.partition_cuda = real["part"]
    launches = read_launches()
    want = expected_launches(r, 1)
    img = r.get_image()
    on = {k: v for k, v in launches.items() if v}
    print(f"[run E] {label}: {over or 'as shipped'}: {ms:.1f} ms/frame, "
          f"dropped {r.dropped}, image mean {float(img.mean()):.6f}, "
          f"launches {on} (as the schedule gives: {want == launches}), "
          f"compacting {r.compacting}"
          + (f", buckets (depth, n_live, lanes, m) {buckets}"
             if buckets else "")
          + (f", pack launches in seeded traces {state['seeded_packs']}"
             if state["seeded_packs"] else "")
          + (f"; warm-up frame: {state['twins']} bf16 traces against their "
             f"f32 twins, {state['twin_bad']} words differ"
             if state["twins"] else ""))
    check(r.dropped == 0 and bool(np.isfinite(img).all())
          and float(img.mean()) > 0.0, f"run E {label}: bad frame")
    check(launches == want, f"run E {label}: launches {launches} != the "
          f"schedule's {want}")
    check(state["twin_bad"] == 0, f"run E {label}: a bf16 trace differs "
          f"from its f32 twin")
    g = WavefrontRenderer(fast_config(**over), camera_mode="collada",
                          device=DEVICE)
    load(g)
    g.render()
    g._reset_accumulation()
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    g.render()
    torch.cuda.synchronize()
    g_ms = (time.perf_counter() - t0) * 1e3
    g_launches = read_launches()
    same = (np.array_equal(g.get_raw_image(), r.get_raw_image())
            and np.array_equal(g.get_image(), img))
    print(f"[run E] {label}, as CUDA graphs ({g.graphs.captures} "
          f"captured): {g_ms:.1f} ms/frame, the counted frame bit-equal to "
          f"the uncaptured one: {same}, launches as the schedule gives: "
          f"{g_launches == want}")
    check(g.graphed and same and g.dropped == 0,
          f"run E {label}: the graphed frame differs")
    check(g_launches == want, f"run E {label}: graphed launches "
          f"{g_launches} != the schedule's {want}")
    del g
    cfg = r.config
    if cfg.compact_depths:
        check(r.compacting
              and len(buckets) == cfg.max_depth - cfg.rr_start_depth,
              f"run E {label}: not compacted")
    if cfg.slab_bf16:
        check(state["twins"] == r.traces_per_frame,
              f"run E {label}: {state['twins']} bf16 traces checked")
    return dict(r=r, ms=ms, launches=launches, kept=kept, payloads=payloads,
                buckets=buckets, seeded_packs=state["seeded_packs"])


def _seeded_vs_unseeded(label, kept, kind, measure):
    """The first seeded closest-hit and shadow trace of a run, traced
    again without their seeds on all their lanes: closest hit, hit/miss
    must agree (a seed is a real hit); shadow, the decisions (a seeded
    shadow ray reports its seed even beyond its light, an unseeded one a
    miss there); rays whose t or prim differ are counted.  The seed
    sweep is timed on their rays.  With ``measure``, the seeded kernels
    against their seeded plain versions on those traces, all their
    lanes.  Returns the sweep times and the kernel rows (by closest-hit
    or not)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf
    from cuda_raytracer_tpu_torch.ops.seeds import seed_hits, seeded_bound

    trace = (packet_dfs.trace_closest_packets if kind == "dfs"
             else wf.trace_closest_wavefront)
    out = dict(sweep_ms=[], rows={})
    for closest in (True, False):
        scene, rays, kw = kept[(kind, closest, True)]
        o, d, valid, t_limit = rays
        base = {k: v for k, v in kw.items()
                if k not in ("seed_t", "seed_prim")}
        a = trace(scene, o, d, valid, t_limit, **kw)
        b = trace(scene, o, d, valid, t_limit, **base)
        hm = int(((a.prim < 0) != (b.prim < 0)).sum())
        t_bad = int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum())
        p_bad = int((a.prim != b.prim).sum())
        sweep_ms = cuda_time_ms(lambda: seed_hits(scene, o, d, valid, 16), 3)
        out["sweep_ms"].append(sweep_ms)
        dec = ""
        if t_limit is not None:
            eps = 1e-3
            n_dec = int(((a.t > t_limit - eps)
                         != (b.t > t_limit - eps)).sum())
            dec = f", shadow decisions differing {n_dec}"
            check(n_dec == 0, f"{label}: seeded shadow decisions differ")
        seeded = int((kw["seed_prim"] >= 0).sum())
        what = "closest-hit" if closest else "shadow"
        print(f"[run E] {label}, {what} trace, seeded against unseeded on "
              f"{o.shape[0]} lanes ({int(valid.sum())} valid, {seeded} with "
              f"a seed hit): hit/miss mismatches {hm}, rays whose t differs "
              f"{t_bad}, whose prim differs {p_bad}{dec}; the seed sweep "
              f"(K=16) {sweep_ms:.3f} ms")
        check(hm == 0 or t_limit is not None,
              f"{label}: the seeded trace loses or adds hits")
        if not measure:
            continue
        tag = f"{label}, seeded {what}"
        if kind == "dfs":
            start = seeded_bound(kw["seed_t"], t_limit, 1e-3)
            out["rows"][closest] = measure_kernel(
                tag, scene, (o, d, valid, start), t_limit is not None,
                chunk=1 << 18, max_t=t_limit)
        else:
            out["rows"][closest] = measure_wavefront(
                tag, scene, rays, seed=(kw["seed_t"], kw["seed_prim"]))
    return out


def phase_run_e(n=121):
    """Run E (phase 7): the configs whose paths the shipped preset does
    not take, at full width on run B's terrain and run C's document:
    whole-depth compaction, seeded passes (traversal_secondary="pallas";
    traversal="dfs" with seed_primary) and slab_bf16, each beside the
    shipped preset in this call.  Returns the payload partition's
    measurement on a frame's path state, its launches there, and the
    kernels JSON rows of the new forms (run B's)."""
    import tempfile

    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    def load_b(r):
        r.load_static_scene(terrain_scene(n=n))
        r.set_viewpoint(*VIEW_B)

    configs = (
        ("shipped", {}),
        ("compact_depths", dict(compact_depths=True)),
        ("seeded wavefront", dict(traversal_secondary="pallas")),
        ("seeded DFS", dict(traversal="dfs", seed_primary=True)),
        ("slab_bf16", dict(slab_bf16=True)),
    )
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        with open(path, "w") as f:
            f.write(run_c_document(n))
        for scene_label, load in (("B", load_b),
                                  ("C", lambda r: r.load_scene(path))):
            for name, over in configs:
                runs[scene_label, name] = drive_e(
                    f"run {scene_label}, {name}", load, **over)
            print(f"[run E] run {scene_label}: ms per frame "
                  + ", ".join(f"{name} {runs[scene_label, name]['ms']:.1f}"
                              for name, _ in configs))
            # keep only what the checks below read
            for name, _ in configs:
                if scene_label == "C" and "seeded" not in name:
                    runs[scene_label, name].update(kept={}, payloads=[])

    # whole-depth compaction: the payload partition on the frame's state,
    # and the small frames on the card and on the CPU
    comp = runs["B", "compact_depths"]
    part = measure_partition("run B path state before depth 2",
                             payload=comp["payloads"][0])["payload"]
    phase_cpu_vs_cuda(dict(compact_depths=True, fuse_frame="yes"),
                      tag="run E compact_depths, cpu-vs-cuda")

    # seeded passes: on run C's document, whose walls seed most rays, and
    # on run B's terrain, whose largest prims are terrain triangles; the
    # kernels against their plain versions on run B's traces, all lanes
    for scene_label in ("C", "B"):
        seeded_wf = _seeded_vs_unseeded(
            f"run {scene_label} seeded wavefront",
            runs[scene_label, "seeded wavefront"].pop("kept"), "pallas",
            scene_label == "B")
        seeded_dfs = _seeded_vs_unseeded(
            f"run {scene_label} seeded DFS",
            runs[scene_label, "seeded DFS"].pop("kept"), "dfs",
            scene_label == "B")

    # slab_bf16: the bf16 forms and the f32 forms on the same rays, the
    # frame's camera trace and depth-2 closest-hit trace
    bf = runs["B", "slab_bf16"]
    scene, cam, _ = bf["kept"][("dfs", True, False)]
    dfs_f32 = measure_kernel("run B camera trace, f32 box tests", scene, cam,
                             False, chunk=1 << 18)
    dfs_bf = measure_kernel("run B camera trace, slab_bf16", scene, cam,
                            False, chunk=1 << 18, bf16=True)
    same = (int((dfs_f32["prim"] != dfs_bf["prim"]).sum())
            + int((dfs_f32["t"].view(-1) != dfs_bf["t"].view(-1)).sum()))
    print(f"[run E] DFS on run B's camera trace: visits per ray f32 "
          f"{dfs_f32['visits']:.3f}, bf16 {dfs_bf['visits']:.3f}; kernel "
          f"{dfs_f32['ms']:.4f} against {dfs_bf['ms']:.4f} ms; "
          f"{same} words of t and prim differ")
    check(same == 0, "slab_bf16 DFS differs from the f32 DFS")
    scene, rr, _ = bf["kept"][("pallas", True, False)]
    wf_f32 = measure_wavefront("run B depth-2 closest-hit, f32 box tests",
                               scene, rr)
    wf_bf = measure_wavefront("run B depth-2 closest-hit, box_bf16", scene,
                              rr, bf16=True)
    print(f"[run E] wavefront on run B's depth-2 closest-hit trace: entries "
          f"per level f32 {[x['entries'] for x in wf_f32['rows']]}, bf16 "
          f"{[x['entries'] for x in wf_bf['rows']]}; count on level 0 "
          f"{wf_f32['level0']['count_ms']:.4f} against "
          f"{wf_bf['level0']['count_ms']:.4f} ms; pack, all levels "
          f"{wf_f32['sums']['pack_ms']:.4f} against "
          f"{wf_bf['sums']['pack_ms']:.4f} ms")
    check(bool((wf_f32["keys"] == wf_bf["keys"]).all()),
          "box_bf16 keys differ from the f32 keys")

    lb = bf["launches"]
    cnt, pk = wf_bf["level0"], wf_bf["best"]
    sw = seeded_wf["rows"]
    sd = seeded_dfs["rows"]
    return part, comp["launches"]["partition"], [
        kernel_row("packet_dfs_bf16", "packet_dfs.cu", "packet_dfs.py:99",
                   lb["packet_dfs_bf16"], dfs_bf, dfs_bf["max_abs_err"]),
        kernel_row("packet_dfs_seeded", "packet_dfs.cu", "packet_dfs.py:99",
                   runs["B", "seeded DFS"]["launches"]["packet_dfs"],
                   sd[True], max(sd[True]["max_abs_err"],
                                 sd[False]["max_abs_err"])),
        kernel_row("wf2_count_bf16", "wavefront2.cu", "wavefront2.py:262",
                   lb["wf2_count_bf16"],
                   dict(ms=cnt["count_ms"], plain_ms=cnt["count_plain_ms"],
                        **cnt["count_bound"]), float(cnt["count_err"])),
        kernel_row("wf2_pack_bf16", "wavefront2.cu", "wavefront2.py:377",
                   lb["wf2_pack_bf16"],
                   dict(ms=pk["pack_ms"], plain_ms=pk["pack_plain_ms"],
                        **pk["pack_bound"]), pk["pack_err"]),
        kernel_row("wf2_pack_seeded", "wavefront2.cu", "wavefront2.py:377",
                   runs["B", "seeded wavefront"]["seeded_packs"],
                   dict(ms=sw[True]["best"]["pack_ms"],
                        plain_ms=sw[True]["best"]["pack_plain_ms"],
                        **sw[True]["best"]["pack_bound"]),
                   max(sw[True]["best"]["pack_err"],
                       sw[False]["best"]["pack_err"])),
    ]


#: run F (phase 8): the sharded frames on the one card, (label, shards,
#: shard_mode); a mesh may repeat a device, so 4 shards share the card
RUN_F_MESHES = (("1 shard, samples", 1, "samples"),
                ("4 shards, samples", 4, "samples"),
                ("4 shards, tiles", 4, "tiles"))
#: the small sharded frames of tests/test_torch_shard.py: 32x16, 8 shards
#: of 1 spp (samples) or of 2 rows (tiles, tiles32s slabs), depth 2
SMALL_SHARDED = dict(width=32, height=16, samples_per_frame=8, max_depth=2,
                     nee_schedule=((1, 1.0), (1, 1.0)))
#: the oracle held against itself on the CPU (rtol, atol: float64 over a
#: path's few dozen operations, tests/test_torch_pathtracer.py)
ORACLE_RTOL, ORACLE_ATOL = 1e-9, 1e-12
#: tests/test_radiance.py's engine frames for the z-test, and its bounds:
#: mean |z|, share of pixels beyond 4 sigma, max |z|, global mean
ZTEST_FRAMES, ZTEST_SPF = 12, 4
ZTEST_BOUNDS = (1.6, 0.01, 10.0, 0.05)


def _device_busy(render, frame_ms):
    """Device kernel ms of one render() under torch.profiler, its share
    of the unprofiled frame's ``frame_ms``, and the device launches."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        render()
        torch.cuda.synchronize()
    # the renderer's crt.* host ranges show on the device's timeline too
    rows = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and not e.key.startswith("crt.")]
    dev_ms = sum(e.self_device_time_total for e in rows) / 1e3
    return dev_ms, dev_ms / frame_ms, sum(e.count for e in rows)


def _drive_sharded(label, n_shards, mode, n, spf):
    """One ShardedRenderer on run B's terrain (fast_config, ``spf`` spp
    per frame) over ``n_shards`` entries of the card: a warm-up frame,
    then one counted frame, its launches against n_shards times one
    shard's schedule, and the frame against its shards rendered one by
    one; last, one profiled frame.  Returns (ms, device busy share)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.parallel import shard

    cfg = fast_config(shard_mode=mode, samples_per_frame=spf)
    sr = shard.ShardedRenderer(cfg, [torch.device(DEVICE)] * n_shards)
    sr.load_static_scene(terrain_scene(n=n))
    sr.set_viewpoint(*VIEW_B)
    sr.render()  # warm-up
    sr._reset_accumulation()  # the counted frame alone: raw == its image
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    sr.render()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    launches = read_launches()
    want = sharded_launches(sr, 1)
    img = sr.get_raw_image()
    check(img.shape == (cfg.height, cfg.width, 3)
          and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
          f"run F {label}: image")
    check(sr.dropped == 0, f"run F {label}: dropped {sr.dropped}")
    check(launches == want, f"run F {label}: launches {launches} != "
          f"{n_shards} x one shard's schedule {want}")

    key = rng.fold_in(rng.PRNGKey(cfg.seed), sr.frame_index - 1)
    cam = sr._camera_arrays()
    if mode == "samples":
        spp = max(cfg.samples_per_frame // n_shards, 1)
        chunks = [shard._render_chunk(sr._scenes[i], cfg, cam,
                                      rng.fold_in(key, i), *sr._tan, spp)
                  for i in range(n_shards)]
        want_img = torch.stack(chunks).mean(0).cpu().numpy()
        close = np.isclose(img, want_img, rtol=1e-6, atol=0)
        what = (f"the mean of {n_shards} chunk(s) of {spp} spp traced one "
                f"by one: {int((~close).sum())} values off rtol 1e-6")
        check(bool(close.all()), f"run F {label}: frame != its chunks")
    else:
        rows = cfg.height // n_shards
        tile_cfg = shard._slab_config(cfg, rows)
        diff = 0
        for i in range(n_shards):
            slab, _ = shard._trace_slab(
                sr._scenes[i], tile_cfg, cam, rng.fold_in(key, i), *sr._tan,
                cfg.samples_per_frame, row_offset=i * rows,
                full_height=cfg.height)
            diff += int((slab.cpu().numpy()
                         != img[i * rows:(i + 1) * rows]).sum())
        what = (f"{n_shards} slabs of {rows} rows ({tile_cfg.sample_order}) "
                f"traced alone: {diff} values differ")
        check(diff == 0, f"run F {label}: slabs differ")
    dev_ms, busy, dev_launches = _device_busy(sr.render, ms)
    print(f"[run F] {label}: {ms:.1f} ms per frame of {cfg.samples_per_frame}"
          f" spp ({cfg.width}x{cfg.height}, terrain n={n}), "
          f"{sum(launches.values())} launches ({launches}), dropped "
          f"{sr.dropped}, image mean {float(img.mean()):.6f}; against {what};"
          f" profiled frame {dev_ms:.1f} ms of kernel time in {dev_launches} "
          f"device launches, busy share {busy:.3f} [{smi_line()}]")
    return ms, busy


def _sharded_card_vs_cpu():
    """tests/test_torch_shard.py's small frames, both modes, on the card
    (8 shards of the card) and on the CPU (8 of the CPU), per pixel."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.config import RenderConfig
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.parallel import shard
    from cuda_raytracer_tpu_torch.render.flatscene import flatten_scene

    cam = (np.array([0.0, 0.75, 2.5], np.float32), np.eye(3, dtype=np.float32))
    tan = (math.tan(math.radians(50.0) / 2), math.tan(math.radians(35.0) / 2))
    for mode, over in (("samples", {}),
                       ("tiles", dict(sample_order="tiles32s",
                                      rng_granule=128))):
        cfg = RenderConfig(**SMALL_SHARDED, shard_mode=mode, **over)
        imgs = []
        for dev in (DEVICE, "cpu"):
            scene, _ = flatten_scene(cornell_box_scene(with_spheres=True),
                                     device=dev)
            imgs.append(shard.render_frame_sharded(
                [torch.device(dev)] * 8, scene, cfg, cam, rng.PRNGKey(7),
                *tan).cpu().numpy())
        a, b = imgs
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        print(f"[run F] cpu-vs-cuda, sharded {mode} ({cfg.sample_order}), "
              f"8 shards, 32x16: {int(bad.sum())} of {bad.shape[0] * bad.shape[1]}"
              f" pixels outside rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max "
              f"|diff| {float(np.abs(a - b).max()):.3g}")
        check(float(bad.mean()) <= MAX_BAD,
              f"run F: sharded {mode} frames differ on the card and the CPU")


def _cli_chips(small_n):
    """render_cli --chips past the visible cards exits naming how many
    there are; --chips 1 renders with the WavefrontRenderer."""
    import tempfile

    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.apps import render_cli
    from cuda_raytracer_tpu_torch.utils.image import load_png

    visible = torch.cuda.device_count()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        with open(path, "w") as f:
            f.write(run_c_document(small_n))
        png = os.path.join(tmp, "out.png")
        args = [path, "-w", png, "-s", "2", "--size", "64x32", "-m", "4",
                "--preset", "fast"]
        try:
            render_cli.main(args + ["--chips", str(visible + 1)])
            msg = ""
        except SystemExit as e:
            msg = str(e)
        print(f"[run F] render_cli --chips {visible + 1}: {msg}")
        check(f"only {visible} device" in msg,
              "render_cli --chips past the visible cards did not exit")
        # _cli_run keeps the WavefrontRenderer the CLI makes (and fails
        # if it made none)
        r, bench = _cli_run(args + ["--chips", "1", "--bench"])
        img = load_png(png)
        check(r.dropped_sum == 0 and img.shape == (32, 64, 3)
              and bool(np.isfinite(img).all()) and float(img.mean()) > 0.0,
              "render_cli --chips 1 did not render")
        print(f"[run F] render_cli --chips 1: {bench}")


def _pinhole(w, h, pos, target):
    """tests/test_pathtracer.py's camera: at pos, looking at target."""
    import numpy as np

    from cuda_raytracer_tpu_torch.scene.camera import Camera

    cam = Camera()
    cam.ar = w / h
    cam.pos = np.array(pos, dtype=np.float64)
    back = cam.pos - np.array(target, dtype=np.float64)
    back /= np.linalg.norm(back)
    right = np.cross(np.array([0.0, 1.0, 0.0]), back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    cam.c2w = np.stack([right, up, back], axis=1)
    return cam


def _oracle(scene, size, ns_aa, threads, device, depth=3):
    """A PathTracer's full render of ``scene`` at ``size`` (VIEW_A's
    camera); returns (tracer, seconds)."""
    from cuda_raytracer_tpu_torch.render.pathtracer import PathTracer

    w, h = size
    pt = PathTracer(ns_aa=ns_aa, max_ray_depth=depth, num_threads=threads,
                    device=device)
    pt.set_frame_size(w, h)
    pt.set_camera(_pinhole(w, h, *VIEW_A))
    pt.set_scene(scene)
    pt.raytrace_pixel(0, 0)  # untimed: the first calls' library set-up
    t0 = time.perf_counter()
    pt.start_raytracing()
    deadline = time.time() + 300
    while not pt.is_done():
        check(time.time() < deadline, "PathTracer render timed out")
        time.sleep(0.005)
    return pt, time.perf_counter() - t0


def _oracle_close(a, b):
    """Values of the two tracers' buffers outside the float64 tolerance,
    and the largest difference."""
    import numpy as np

    off, worst = 0, 0.0
    for name in ("sample_buffer", "se2_buffer"):
        x, y = getattr(a, name), getattr(b, name)
        off += int((~np.isclose(x, y, rtol=ORACLE_RTOL,
                                atol=ORACLE_ATOL)).sum())
        worst = max(worst, float(np.abs(x - y).max()))
    return off, worst


def _oracle_card_vs_cpu(size, ns_aa):
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene

    scene = cornell_box_scene(with_spheres=True)
    card, s_card = _oracle(scene, size, ns_aa, 1, DEVICE)
    cpu, s_cpu = _oracle(scene, size, ns_aa, 1, "cpu")
    tiles = card.update_screen()[1]
    off, worst = _oracle_close(card, cpu)
    print(f"[run F] PathTracer, cornell {size[0]}x{size[1]}, ns_aa={ns_aa}, "
          f"depth 3, 1 thread: {s_card * 1e3 / tiles:.1f} ms per tile on the "
          f"card [{smi_line()}], {s_cpu * 1e3 / tiles:.1f} ms per tile on "
          f"this machine's CPU ({tiles} tiles); {off} buffer values outside "
          f"rtol={ORACLE_RTOL} atol={ORACLE_ATOL}, max |diff| {worst:.3g}")
    check(off == 0, "PathTracer: card and CPU buffers differ")


def _oracle_ztest(size, ns_aa, scene=None, what="cornell", tag="run F"):
    """The card's engine against the card's oracle on ``scene`` (by
    default the Cornell box with spheres), both at VIEW_A:
    tests/test_radiance.py's per-pixel z statistic and bounds."""
    import numpy as np

    from cuda_raytracer_tpu_torch.config import RenderConfig
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    w, h = size
    if scene is None:
        scene = cornell_box_scene(with_spheres=True)
    pt, s_pt = _oracle(scene, size, ns_aa, 4, DEVICE)
    r = WavefrontRenderer(RenderConfig(width=w, height=h,
                                       samples_per_frame=ZTEST_SPF,
                                       max_depth=3), device=DEVICE)
    r.load_static_scene(scene)
    r.set_viewpoint(*VIEW_A)
    per_frame, prev = [], np.zeros((h, w, 3))
    for k in range(1, ZTEST_FRAMES + 1):
        r.render()
        check(r.dropped == 0, "z-test engine frame dropped rays")
        acc = r.get_raw_image().astype(np.float64)
        per_frame.append(acc * k - prev * (k - 1))
        prev = acc
    per_frame = np.stack(per_frame)
    eng_mean = per_frame.mean(axis=0)
    eng_se2 = per_frame.var(axis=0, ddof=1) / ZTEST_FRAMES
    z = (eng_mean - pt.sample_buffer) / np.sqrt(eng_se2 + pt.se2_buffer
                                                + 1e-12)
    stats = (float(np.abs(z).mean()), float((np.abs(z) > 4.0).mean()),
             float(np.abs(z).max()),
             abs(eng_mean.mean() - pt.sample_buffer.mean())
             / pt.sample_buffer.mean())
    print(f"[{tag}] z-test, the card's engine ({ZTEST_FRAMES} frames of "
          f"{ZTEST_SPF} spp) against the card's PathTracer (ns_aa={ns_aa}, "
          f"4 threads, {s_pt:.2f} s), {what} {w}x{h}, depth 3: mean |z| "
          f"{stats[0]:.3f} (< {ZTEST_BOUNDS[0]}), beyond 4 sigma "
          f"{stats[1]:.4f} (< {ZTEST_BOUNDS[1]}), max |z| {stats[2]:.2f} "
          f"(< {ZTEST_BOUNDS[2]}), global mean off by {stats[3]:.4f} "
          f"(< {ZTEST_BOUNDS[3]})")
    check(all(s < b for s, b in zip(stats, ZTEST_BOUNDS)),
          "z-test: the card's engine and oracle disagree")


def _oracle_large_tile(n, ns_aa):
    """One 32x32 tile of run C's document (terrain n) at ns_aa on the card
    and on the CPU (the same generator): ms per tile, buffers compared."""
    import tempfile

    import numpy as np

    from cuda_raytracer_tpu_torch.render.pathtracer import (
        PathTracer,
        WorkItem,
    )
    from cuda_raytracer_tpu_torch.scene.collada import load_scene_info
    from cuda_raytracer_tpu_torch.scene.dynamic_scene import (
        load_from_scene_info,
    )

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        with open(path, "w") as f:
            f.write(run_c_document(n))
        scene = load_from_scene_info(load_scene_info(path))[0]
    scene = scene.get_static_scene()
    item = WorkItem(WIDTH // 2 - 16, HEIGHT // 2 - 16, 32, 32)
    out = {}
    for dev in (DEVICE, "cpu"):
        pt = PathTracer(ns_aa=ns_aa, max_ray_depth=3, num_threads=1,
                        device=dev)
        pt.set_frame_size(WIDTH, HEIGHT)
        pt.set_camera(_pinhole(WIDTH, HEIGHT, *VIEW_A))
        pt.set_scene(scene)
        pt.raytrace_pixel(0, 0)  # untimed: the first calls' library set-up
        t0 = time.perf_counter()
        pt.raytrace_tile(item, np.random.default_rng(15618))
        out[dev] = (pt, (time.perf_counter() - t0) * 1e3)
    (card, ms_card), (cpu, ms_cpu) = out[DEVICE], out["cpu"]
    off, worst = _oracle_close(card, cpu)
    tile = card.sample_buffer[item.tile_y:item.tile_y + 32,
                              item.tile_x:item.tile_x + 32]
    print(f"[run F] PathTracer, run C's document ({card._flat['v0'].shape[0]}"
          f" prims), one 32x32 tile at ns_aa={ns_aa}, depth 3: "
          f"{ms_card:.1f} ms on the card [{smi_line()}], {ms_cpu:.1f} ms on "
          f"this machine's CPU; tile mean {float(tile.mean()):.6f}; {off} "
          f"buffer values outside rtol={ORACLE_RTOL} atol={ORACLE_ATOL}, "
          f"max |diff| {worst:.3g}")
    check(bool(np.isfinite(tile).all()) and float(tile.mean()) > 0.0,
          "PathTracer: run C tile")
    check(off == 0, "PathTracer: run C tile differs on the card and the CPU")


def phase_run_f(n=121, small_n=8, spf=32, oracle_size=(64, 48),
                big_ns=16):
    """Run F (phase 8): sharded frames and the PathTracer oracle.  Run B's
    terrain n through ShardedRenderer over 1 and 4 entries of the card
    (``spf`` spp per frame), beside the WavefrontRenderer's frame; the
    small sharded frames on the card and on the CPU; render_cli --chips;
    the PathTracer on the card against the CPU, against the card's engine
    (z-test), and on one tile of run C's document."""
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene

    base = run_slice("B terrain, beside the sharded frames",
                     lambda: terrain_scene(n=n), 1, viewpoint=VIEW_B,
                     samples_per_frame=spf)
    dev_ms, busy, dev_launches = _device_busy(base["r"].render, base["ms"])
    print(f"[run F] WavefrontRenderer: {base['ms']:.1f} ms per frame; "
          f"profiled frame {dev_ms:.1f} ms of kernel time in {dev_launches} "
          f"device launches, busy share {busy:.3f} [{smi_line()}]")
    runs = {label: _drive_sharded(label, shards, mode, n, spf)
            for label, shards, mode in RUN_F_MESHES}
    print(f"[run F] ms per frame (terrain n={n}, {spf} spp): "
          f"WavefrontRenderer {base['ms']:.1f}, "
          + ", ".join(f"{label} {ms:.1f}" for label, (ms, _) in runs.items()))
    _sharded_card_vs_cpu()
    _cli_chips(small_n)
    _oracle_card_vs_cpu(oracle_size, 16)
    _oracle_ztest(oracle_size, 64)
    _oracle_large_tile(n, big_ns)


# ---------------------------------------------------------------------------
# phase 9: the wavefront's dyn_alloc form
# ---------------------------------------------------------------------------

#: pack's instantiations by their template arguments <BF16, DYN>, as
#: ptxas names them
PACK_FORMS = {"ILb0ELb0E": "f32", "ILb1ELb0E": "box_bf16",
              "ILb0ELb1E": "dyn_alloc", "ILb1ELb1E": "dyn_alloc box_bf16"}


def _dense_order(queue, seg_base, read):
    """A level's entries in dense order (seg_base's): through its read
    table, for a level a dyn_alloc pack wrote, or as they lie."""
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    total = int(seg_base[-1])
    if read is None:
        return queue[:total]
    return queue[wf.queue_positions(read, 0, total)]


def _check_runs(where, runs, cap):
    """A run table as the kernel left it: within its capacity, each run
    one to TILE entries, the runs covering [0, entries handed out) once,
    inside the queue's capacity.  Returns the runs."""
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    k, handed = int(runs.cursor[1]), int(runs.cursor[0])
    check(k <= runs.table.shape[1], f"{where}: {k} runs past the table's "
          f"{runs.table.shape[1]}")
    if k == 0:
        check(handed == 0, f"{where}: entries without runs")
        return 0
    start, length = runs.table[1, :k].long(), runs.table[2, :k].long()
    order = torch.argsort(start)
    ends = (start + length)[order]
    ok = (int(length.min()) >= 1 and int(length.max()) <= wf.TILE
          and int(start[order][0]) == 0
          and bool((start[order][1:] == ends[:-1]).all())
          and int(ends[-1]) == handed <= cap)
    check(ok, f"{where}: the runs do not tile the positions handed out")
    return k


def measure_dyn(label, scene, rays, bf16=False, seed=None, qm=2):
    """The dyn_alloc form of the pack kernel against its plain version,
    level by level, on one captured trace (its level-0 queue as
    ``_level0`` makes it).  Both read the kernel's previous level (its
    queue and read table).  At each level: the hit keys equal to the
    bit; the written counts per child slot equal between the two and
    equal to count_plain of the level's queue (the counts the shipped
    layout plans from); dropped 0; the run table as ``_check_runs``
    wants it; the next level (``dyn_next_level``: seg_base equal) read
    in dense order equal as a set of entries per segment.  Each level's
    kernel is timed, and the glue that makes the next level's read
    table.  The bound: the shipped pack's bytes and operations (the
    form counts nothing for the next level), plus 8 B per run of the
    read table, 12 B per run written and the written counts.  Returns
    every row, the row of the inner level with the most entries, the
    sums and the final keys.  ``qm``: the queue_multiplier that sizes
    the queues."""
    import torch

    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    bvh = scene.bvh
    W = bvh.width
    node_rows, prim_rows = bvh.wf_node_rows, scene.wf_prim_rows
    row_bytes = node_rows.shape[1] * 4
    do_kill = rays[3] is not None
    n = rays[0].shape[0]
    cap = wf.queue_capacity(n + (-n) % wf.CHUNK, qm, bvh.wf_sched)
    queue, seg_base, tile_base, keys = _level0(rays, seed)

    def zeros(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=DEVICE)

    read, bound, runs_in = None, n, 0
    rows, best = [], None
    sums = dict(pack_ms=0.0, pack_plain=0.0, pack_bound=0.0, glue_ms=0.0)
    for lvl, lv in enumerate(bvh.wf_levels):
        last = not lv.has_inner
        total, tiles = int(seg_base[-1]), int(tile_base[-1])
        tables = (_nbytes(seg_base, tile_base, lv.seg_node, lv.child, lv.pair)
                  + lv.num_segs * row_bytes)
        leaf = torch.where(lv.child[:, 0] == 2, lv.child[:, 2], 0)
        row = dict(level=lvl, entries=total, idle=tiles * wf.TILE - total)

        def fresh():
            return (None if last else
                    wf.dyn_workspace((lv,), W, bound, cap, DEVICE)[0],
                    torch.empty((1 if last else cap, 8), dtype=torch.float32,
                                device=DEVICE),
                    zeros(dtype=torch.int64), keys.clone())

        def pack(runs, out, drop, k):
            wf.pack_cuda(queue, seg_base, tile_base, lv, lv.pair, None,
                         node_rows, prim_rows, W, do_kill, 1e-3, out, k, drop,
                         bound, bf16=bf16, dyn=wf.Dyn(read, runs))

        (runs_k, out_k, drop_k, keys_k), (runs_p, out_p, drop_p, keys_p) = \
            fresh(), fresh()
        pack(runs_k, out_k, drop_k, keys_k)
        pstats = {}
        _, row["pack_plain_ms"] = _host_ms(lambda: wf.pack_plain(
            queue, seg_base, lv, lv.pair, None, node_rows, prim_rows, W,
            do_kill, 1e-3, out_p, keys_p, drop_p, stats=pstats, bf16=bf16,
            dyn=wf.Dyn(read, runs_p)))
        key_bad = int((keys_k != keys_p).sum())
        tk, _ = wf.decode_plain(keys_k)
        tp, _ = wf.decode_plain(keys_p)
        hit = torch.isfinite(tp)
        row["pack_err"] = (float((tk - tp)[hit].abs().max())
                           if bool(hit.any()) else 0.0)
        written_bad = q_bad = runs_out = 0
        if not last:
            counts = wf.count_plain(_dense_order(queue, seg_base, read),
                                    seg_base, lv, node_rows, W, bf16=bf16)
            written_bad = (int((runs_k.written != runs_p.written).sum())
                           + int((runs_k.written != counts).sum()))
            runs_out = _check_runs(f"pack (dyn_alloc), {label} level {lvl}",
                                   runs_k, cap)
            nxt_k = wf.dyn_next_level(runs_k, lv)
            nxt_p = wf.dyn_next_level(runs_p, lv)
            check(torch.equal(nxt_k[0], nxt_p[0]),
                  f"pack (dyn_alloc), {label} level {lvl}: next seg_base "
                  f"differs from the plain version's")
            t_next = int(nxt_k[0][-1])
            a = _sorted_regions(_dense_order(out_k, nxt_k[0], nxt_k[2]),
                                nxt_k[0], t_next)
            b = _sorted_regions(_dense_order(out_p, nxt_p[0], nxt_p[2]),
                                nxt_p[0], t_next)
            q_bad = int((a.view(torch.int32) != b.view(torch.int32)).sum())
        check(key_bad == 0 and written_bad == 0 and q_bad == 0,
              f"pack (dyn_alloc), {label} level {lvl}: kernel disagrees with "
              f"its plain version ({key_bad} keys, {written_bad} written "
              f"counts, {q_bad} queue words)")
        check(int(drop_k) == 0 and int(drop_p) == 0,
              f"pack (dyn_alloc), {label} level {lvl}: dropped")

        runs_t, out_t, drop_t, keys_t = fresh()

        def prep():
            if runs_t is not None:
                for x in runs_t:
                    x.zero_()

        row["pack_ms"] = cuda_time_ms(
            lambda: pack(runs_t, out_t, drop_t, keys_t), 5, prep=prep)
        row["glue_ms"] = 0.0 if last else cuda_time_ms(
            lambda: wf.dyn_next_level(runs_k, lv), 5)
        flops, bf16_ops = box_ops(pstats.get("boxes", 0), total, bf16)
        row["pack_bound"] = _bound(
            total * 32 + tables + int(leaf.sum()) * 64
            + pstats.get("survivors", 0) * 32 + pstats.get("hits", 0) * 8
            + runs_in * 8 + runs_out * 12
            + (0 if last else _nbytes(runs_k.written, runs_k.cursor)),
            flops + pstats.get("tris", 0) * TRI_FLOPS
            + pstats.get("spheres", 0) * SPH_FLOPS, bf16_ops)
        print(f"[dyn_alloc] {label}, level {lvl}: {lv.num_segs} segments, "
              f"{total} entries in {tiles} tiles ({row['idle']} idle lanes), "
              f"read through {runs_in} runs -> "
              f"{pstats.get('survivors', 0)} entries in {runs_out} runs; pack "
              f"{row['pack_ms']:.4f} ms (plain {row['pack_plain_ms']:.1f} ms, "
              f"bound {row['pack_bound']['bound_ms']:.5f} ms by "
              f"{row['pack_bound']['bound_by']}), next level's table "
              f"{row['glue_ms']:.4f} ms; keys, written counts and next queue "
              f"equal; work {pstats}")
        sums["pack_ms"] += row["pack_ms"]
        sums["pack_plain"] += row["pack_plain_ms"]
        sums["pack_bound"] += row["pack_bound"]["bound_ms"]
        sums["glue_ms"] += row["glue_ms"]
        rows.append(row)
        if best is None or (lv.has_inner and total > best["entries"]):
            best = row
        keys = keys_k
        if last:
            break
        queue, bound, runs_in = out_k, cap, runs_out
        seg_base, tile_base, read = nxt_k
    print(f"[dyn_alloc] {label}: all levels: pack {sums['pack_ms']:.4f} ms "
          f"(bound {sums['pack_bound']:.5f} ms), the tables between levels "
          f"{sums['glue_ms']:.4f} ms, plain {sums['pack_plain']:.1f} ms")
    return dict(rows=rows, best=best, sums=sums, keys=keys)


def _three_layouts(label, scene, rays, compact=True, **kw):
    """The whole trace with dyn_alloc=True, fused_counts=True (the
    default) and fused_counts=False on the same rays: t and prim equal to
    the bit across the three, and (unseeded) t and hit/miss equal to the
    packet-DFS kernel's (compare_traces' bar), dropped 0, the dyn_alloc
    trace's kernel launches (no count; one pack of its form per level
    visited, one partition when compacting, one decode), each layout's
    device launches (torch.profiler: kernels and glue) and times, in
    turns.  ``kw`` goes to the trace (queue_multiplier, box_bf16,
    seeds)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.ops import wavefront2 as wf

    o, d, valid, t_limit = rays
    layouts = {"dyn_alloc": dict(dyn_alloc=True), "fused": {},
               "sweep": dict(fused_counts=False)}

    def trace(name):
        return wf.trace_closest_wavefront(scene, o, d, valid, t_limit,
                                          compact=compact, **layouts[name],
                                          **kw)

    res, launches = {}, {}
    for name in layouts:
        reset_launches()
        res[name] = trace(name)
        torch.cuda.synchronize()
        launches[name] = read_launches()
    dropped = {name: int(r.dropped) for name, r in res.items()}
    check(not any(dropped.values()), f"{label}: dropped {dropped}")
    if "seed_t" not in kw:  # a seed's t may differ from the kernels' by ulps
        dfs = packet_dfs.trace_closest_packets(scene, o, d, valid, t_limit)
        off = {name: int((r.t.view(torch.int32)
                          != dfs.t.view(torch.int32)).sum())
               + int(((r.prim < 0) != (dfs.prim < 0)).sum())
               for name, r in res.items()}
        print(f"[dyn_alloc] {label}: words of t and hit/miss off "
              f"packet-DFS's: {off}")
        check(not any(off.values()), f"{label}: a layout disagrees with "
              f"packet-DFS: {off}")
    a = res["dyn_alloc"]
    for name in ("fused", "sweep"):
        b = res[name]
        bad = (int((a.t.view(torch.int32) != b.t.view(torch.int32)).sum())
               + int((a.prim != b.prim).sum()))
        check(bad == 0, f"{label}: the dyn_alloc trace differs from the "
              f"{name} layout's in {bad} words")
    inner = [lv.has_inner for lv in scene.bvh.wf_levels]
    want = dict.fromkeys(COUNTERS, 0)
    bf = "_bf16" if kw.get("box_bf16") else ""
    want["wf2_pack_dyn" + bf] = (inner.index(False) + 1 if False in inner
                                 else len(inner))
    want["wf2_decode"] = 1
    want["partition_rays"] = int(compact)
    check(launches["dyn_alloc"] == want, f"{label}: dyn_alloc launches "
          f"{launches['dyn_alloc']} != {want}")
    device = {name: _device_busy(lambda: trace(name), 1.0)[2]
              for name in layouts}
    ms = {name: [] for name in layouts}
    for name in ("dyn_alloc", "fused", "sweep", "sweep", "fused",
                 "dyn_alloc"):
        ms[name].append(cuda_time_ms(lambda: trace(name), 5))
    n_live = int(valid.sum())
    print(f"[dyn_alloc] {label}: whole trace ({o.shape[0]} lanes, {n_live} "
          f"live, {'compacted' if compact else 'every lane queued'}"
          + "".join(f", {k}" if k.startswith("seed") else f", {k}={v}"
                    for k, v in kw.items())
          + "), ms in turns: "
          + "; ".join(f"{name} {', '.join(f'{x:.4f}' for x in ms[name])}"
                      for name in layouts)
          + "; device launches " + ", ".join(f"{name} {device[name]}"
                                              for name in layouts)
          + f"; kernel launches {launches}; t and prim equal across the "
          f"three, dropped 0 [{smi_line()}]")
    return dict(ms=ms, launches=launches, device=device)


def phase_dyn_alloc(n=121):
    """Phase 9: pack's dyn_alloc form on run B's terrain n at full size:
    the camera trace (all lanes live) and the warm-up frame's depth-2
    closest-hit and shadow traces (compacted), each through the three
    layouts (``_three_layouts``) and level by level against the plain
    version (``measure_dyn``); the box_bf16 and seeded forms once each on
    the camera trace.  Returns the kernels JSON row of the form."""
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.ops import _build
    from cuda_raytracer_tpu_torch.ops.seeds import seed_hits

    for line in _build.ptxas_report("wavefront2"):
        form = next((v for k, v in PACK_FORMS.items()
                     if "wf_pack_kernel" + k in line), None)
        if form is not None:
            print(f"[dyn_alloc] ptxas, pack ({form}): {line.split(': ', 1)[1]}")
    run_b = run_slice("B terrain, for dyn_alloc", lambda: terrain_scene(n=n),
                      1, viewpoint=VIEW_B)
    scene = run_b["r"].scene
    cam = run_b["dfs"][True]
    sets = (("run B depth-2 closest-hit trace", run_b["wf"][True]),
            ("run B depth-2 shadow trace", run_b["wf"][False]),
            ("run B camera trace", cam))
    got = {}
    for label, rays in sets:
        _three_layouts(label, scene, rays)
        got[label] = measure_dyn(label, scene, rays)
    # box_bf16 admits more entries: at queue_multiplier=2 the camera
    # trace's level 4 overflows its queue (every layout drops)
    _three_layouts("run B camera trace", scene, cam, box_bf16=True,
                   queue_multiplier=4)
    bf = measure_dyn("run B camera trace, box_bf16", scene, cam, bf16=True,
                     qm=4)
    sd = seed_hits(scene, *cam[:3])
    _three_layouts("run B camera trace", scene, cam, compact=False,
                   seed_t=sd.t, seed_prim=sd.prim)
    seeded = measure_dyn("run B camera trace, seeded", scene, cam,
                         seed=(sd.t, sd.prim))
    check(bool((bf["keys"] == got["run B camera trace"]["keys"]).all()),
          "run B camera trace: the box_bf16 dyn_alloc keys differ from the "
          "f32 ones")
    pk = got["run B depth-2 closest-hit trace"]["best"]
    err = max(max(r["pack_err"] for r in x["rows"])
              for x in (*got.values(), bf, seeded))
    return kernel_row(
        "wf2_pack_dyn", "wavefront2.cu",
        "wavefront2.py:444 (_pack_kernel, dyn_alloc)",
        run_b["launches"]["wf2_pack_dyn"],
        dict(ms=pk["pack_ms"], plain_ms=pk["pack_plain_ms"],
             **pk["pack_bound"]), err)


#: run G: render_cli's default preset (no --preset) on run C's document,
#: (label, flags, spp): the first two at 64 spp (32 passes of 2), the
#: flags users turn at 4
RUN_G = (
    ("default", [], 64),
    ("tree width 2", ["--tree-width", "2"], 64),
    ("cosine", ["--hemisphere", "cosine"], 4),
    ("compat, cutracer", ["--reference-compat", "--camera-mode",
                          "cutracer"], 4),
    ("-l 2 -m 4", ["-l", "2", "-m", "4"], 4),
    ("tree width 8", ["--tree-width", "8"], 4),
)


def _cli_config(argv, **over):
    """(RenderConfig, camera mode) that render_cli builds from ``argv``,
    with ``over`` replaced."""
    import dataclasses

    from cuda_raytracer_tpu_torch.apps import render_cli

    args = render_cli.build_parser().parse_args(argv)
    cfg = dataclasses.replace(render_cli.render_config(args), **over)
    return cfg, args.camera_mode


def _run_g_cli(path, tmp, label, flags, spp, size):
    """One run G setting through render_cli.main, counted; returns the
    renderer, its launches, and the rays (o, d, valid, t_start) of its
    first DFS camera trace (``True``) and first shadow trace
    (``False``)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.utils.image import load_png

    w, h = size
    out = os.path.join(tmp, "run_g.png")
    seen, launch = {}, packet_dfs.dfs_trace_cuda

    def keep(*args):
        seen.setdefault(args[3] is None, args[:4])
        return launch(*args)

    packet_dfs.dfs_trace_cuda = keep
    reset_launches()
    try:
        r, bench = _cli_run([path, "-w", out, "-s", str(spp),
                             "--size", f"{w}x{h}", "--bench",
                             "--device", DEVICE, *flags],
                            tag=f"run G {label}")
    finally:
        packet_dfs.dfs_trace_cuda = launch
    launches = read_launches()
    cfg, passes = r.config, len(r.frame_ms)
    want = expected_launches(r, passes)
    png = load_png(out)
    mean = float(png.mean())
    print(f"[run G] {label}: tree width {r.scene.bvh.width}, "
          f"{r.scene.num_prims} prims, {r.scene.num_lights} light(s), NEE "
          f"{cfg.nee_schedule[0]} x {cfg.max_depth} depths, "
          f"{cfg.hemisphere_sampling} hemisphere, reference_compat "
          f"{cfg.reference_compat}, {passes} passes of "
          f"{cfg.samples_per_frame} spp, ms per pass first "
          f"{r.frame_ms[0]:.1f}, median "
          f"{float(np.median(r.frame_ms)):.1f}, last {r.frame_ms[-1]:.1f}; "
          f"Mrays/s {bench['mrays_per_s']} over the render; load_s "
          f"{bench['load_s']}; dropped {r.dropped_sum}; launches {launches} "
          f"(want {want}); PNG {png.shape}, mean {mean:.6f}")
    check((cfg.rng_granule, cfg.rr_start_depth, cfg.traversal,
           cfg.sample_order) == (1, 0, "auto", "raster"),
          f"run G {label}: not the reference preset")
    check(r.dropped_sum == 0, f"run G {label}: dropped rays")
    check(launches == want and launches["packet_dfs"] > 0,
          f"run G {label}: kernel launches {launches} != the NEE "
          f"schedule's {want}")
    check(png.shape == (h, w, 3), f"run G {label}: PNG shape")
    check(bool(np.isfinite(png).all()) and mean > RUN_C_PNG_FLOOR,
          f"run G {label}: PNG mean {mean} at or below the floor")
    return r, launches, seen


def _run_g_card_vs_cpu(small):
    """Each run G setting on the small document (max_leaf_size=4), 64x32,
    2 passes of 2 spp, on the card and on the CPU, per pixel."""
    import numpy as np

    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    for label, flags, _ in RUN_G:
        cfg, mode = _cli_config([small, "--size", "64x32", "-s", "4", *flags],
                                max_leaf_size=4)
        imgs = []
        for dev in (DEVICE, "cpu"):
            rr = WavefrontRenderer(cfg, camera_mode=mode, device=dev)
            rr.load_scene(small)
            for _ in range(2):
                rr.render()
                check(rr.dropped == 0, f"run G small {label}: dropped")
            imgs.append(rr.get_raw_image())
        a, b = imgs
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        print(f"[run G] card vs CPU, {label}, small document, max_leaf_size=4,"
              f" tree width {rr.scene.bvh.width}, 64x32, 2 passes of 2 spp: "
              f"{int(bad.sum())} of {a.shape[0] * a.shape[1]} pixels outside "
              f"rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max |diff| "
              f"{float(np.abs(a - b).max()):.3g}; image mean "
              f"{float(a.mean()):.6f}")
        check(float(a.mean()) > 0.0, f"run G small {label}: black image")
        check(float(bad.mean()) <= MAX_BAD,
              f"run G small {label}: card and CPU frames differ")


def phase_run_g(n=121, size=(WIDTH, HEIGHT), small_n=8):
    """Run G: render_cli's default preset on run C's document at full
    width: per setting of RUN_G, dropped == 0, the DFS launches the NEE
    schedule gives and the PNG read back; the DFS kernel at tree width 2
    against its plain version on that run's camera and depth-0 shadow
    traces (and at widths 4 and 8 on their runs' camera traces); and
    each setting on the card and the CPU on the document at terrain
    ``small_n``.  Returns the width-2 kernel's JSON row."""
    import tempfile

    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run_c.dae")
        with open(path, "w") as f:
            f.write(run_c_document(n))
        rows = {}
        for label, flags, spp in RUN_G:
            rows[label] = _run_g_cli(path, tmp, label, flags, spp, size)
        r, launches, seen = rows["tree width 2"]
        check(r.scene.bvh.width == 2 and set(seen) == {True, False},
              "run G tree width 2: no width-2 DFS traces kept")
        cam = measure_kernel("run G tree width 2, camera trace", r.scene,
                             seen[True], False)
        shadow = measure_kernel("run G tree width 2, depth-0 shadow trace",
                                r.scene, seen[False], True)
        # the same document's camera traces at widths 4 and 8, for the
        # width-2 time beside them
        for label in ("default", "tree width 8"):
            rw, _, seen_w = rows[label]
            measure_kernel(f"run G tree width {rw.scene.bvh.width}, camera "
                           f"trace", rw.scene, seen_w[True], False)
        small = os.path.join(tmp, "run_c_small.dae")
        with open(small, "w") as f:
            f.write(run_c_document(small_n))
        _run_g_card_vs_cpu(small)
    print(f"[run G] phase 10 took {time.perf_counter() - t0:.1f} s")
    return kernel_row(
        "packet_dfs_w2", "packet_dfs.cu", "packet_dfs.py:99 (tree width 2)",
        launches["packet_dfs"], cam,
        max(cam["max_abs_err"], shadow["max_abs_err"]))


# ---------------------------------------------------------------------------
# phase 11: run H, the infinite lights
# ---------------------------------------------------------------------------

#: the layouts write_exr writes: compression name -> (the file's
#: compression code, scanlines per block)
EXR_LAYOUTS = {"none": (0, 1), "zips": (2, 1), "zip": (3, 16)}


def write_exr(path, img, compression="zip", half=False):
    """Write [H, W, 3] radiance as a single-part scanline OpenEXR file:
    channels B, G, R (the format's alphabetical order), all float or all
    half, uncompressed or zlib-coded after the format's byte split and
    delta predictor (ZIPS: one scanline per block; ZIP: 16, the last
    block short when H is not a multiple of 16).  Data window (0, 0) -
    (W - 1, H - 1), the top row first."""
    import struct
    import zlib

    import numpy as np

    img = np.asarray(img, dtype=np.float16 if half else np.float32)
    h, w, _ = img.shape
    code, lines = EXR_LAYOUTS[compression]

    def attr(name, kind, value):
        return (name.encode() + b"\0" + kind.encode() + b"\0"
                + struct.pack("<i", len(value)) + value)

    # per channel: name, pixel type (1 half, 2 float), pLinear, three
    # reserved bytes, x and y sampling
    chlist = b"".join(c.encode() + b"\0"
                      + struct.pack("<iB3xii", 1 if half else 2, 0, 1, 1)
                      for c in "BGR") + b"\0"
    window = struct.pack("<4i", 0, 0, w - 1, h - 1)
    header = (b"\x76\x2f\x31\x01" + struct.pack("<i", 2)
              + attr("channels", "chlist", chlist)
              + attr("compression", "compression", bytes([code]))
              + attr("dataWindow", "box2i", window)
              + attr("displayWindow", "box2i", window)
              + attr("lineOrder", "lineOrder", b"\0")
              + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
              + attr("screenWindowCenter", "v2f", struct.pack("<2f", 0, 0))
              + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
              + b"\0")
    chunks = []
    for y in range(0, h, lines):
        # a block holds its lines in turn, a line its channels in turn
        raw = np.ascontiguousarray(
            img[y:y + lines, :, ::-1].transpose(0, 2, 1)).tobytes()
        if code:
            b = np.frombuffer(raw, np.uint8)
            t = np.concatenate([b[0::2], b[1::2]]).astype(np.int16)
            t[1:] = (np.diff(t) + 128) % 256
            raw = zlib.compress(t.astype(np.uint8).tobytes())
        chunks.append(struct.pack("<ii", y, len(raw)) + raw)
    offsets, pos = [], len(header) + 8 * len(chunks)
    for c in chunks:
        offsets.append(pos)
        pos += len(c)
    with open(path, "wb") as f:
        f.write(header + struct.pack(f"<{len(chunks)}Q", *offsets)
                + b"".join(chunks))


#: run H's sky map: rows and columns; the sun's centre (polar angle from
#: +y, azimuth from +x toward +z), angular radius (degrees) and
#: radiance; the sky's radiance at the zenith and at the horizon, and
#: the ground's below it
RUN_H_SKY_SIZE = (256, 512)
RUN_H_SUN = (55.0, 90.0, 3.0, 100.0)
RUN_H_ZENITH = (0.25, 0.45, 0.9)
RUN_H_HORIZON = (0.9, 0.9, 1.0)
RUN_H_GROUND = (0.15, 0.12, 0.1)


def sky_map(size=RUN_H_SKY_SIZE):
    """Run H's lat-long environment map, float32 [rows, columns, 3] as
    EnvironmentLight reads it (texel (i, j) looks along polar angle
    (i + 0.5) / rows * pi from +y and azimuth (j + 0.5) / columns * 2 pi
    from +x toward +z): a gradient from the horizon to the zenith, flat
    ground below, and a sun patch that shines through run C's open
    front."""
    import numpy as np

    h, w = size
    theta = (np.arange(h) + 0.5) / h * np.pi
    phi = (np.arange(w) + 0.5) / w * 2.0 * np.pi
    st_, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    dirs = np.stack(np.broadcast_arrays(st_ * np.cos(phi), ct,
                                        st_ * np.sin(phi)), -1)
    zen, hor, gnd = (np.array(c) for c in (RUN_H_ZENITH, RUN_H_HORIZON,
                                           RUN_H_GROUND))
    up = dirs[..., 1:2]
    img = np.where(up > 0, hor + (zen - hor) * up, gnd)
    pol, azi, radius, rad = RUN_H_SUN
    pol, azi = math.radians(pol), math.radians(azi)
    sun = np.array([math.sin(pol) * math.cos(azi), math.cos(pol),
                    math.sin(pol) * math.sin(azi)])
    img[dirs @ sun > math.cos(math.radians(radius))] = rad
    return img.astype(np.float32)


def _attach_env(r, env):
    """What render_cli -e does once the scene is loaded: the environment
    light appended to the scene's lights, the scene loaded again."""
    from cuda_raytracer_tpu_torch.scene import static_scene as st

    sscene = r.static_scene
    sscene.lights.append(st.EnvironmentLight(env))
    r.load_static_scene(sscene)


#: run H (phase 11): (label, the document's lights, whether -e attaches
#: the sky map, render_cli flags, spp, the light kinds the scene must
#: flatten to, by flatscene's LIGHT_* codes: 0 area, 2 directional, 3
#: hemisphere, 5 environment)
RUN_H = (
    ("fast, -e", ("area", "directional"), True,
     ["--preset", "fast", "-m", "4"], 64, (0, 2, 5)),
    ("reference, -e", ("area", "directional"), True, [], 4, (0, 2, 5)),
    ("lightless, fast", (), False, ["--preset", "fast", "-m", "4"], 4,
     (3,)),
)
#: the infinite lights' shadow rays: max_t, the traversals' no-limit
#: sentinel (ops/shade.nee_shadow_rays clamps an infinite distance to it)
T_NO_LIMIT = 1e30


def _run_h_cli(doc, sky, tmp, setting, size):
    """One run H setting through render_cli.main, counted: the renderer,
    its launches, and the rays (o, d, valid, t_limit) of the first three
    shadow traces of each traversal (the DFS's at depth 0, the
    wavefront's at the first roulette depth: one per light, in the
    scene's light order)."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.ops import packet_dfs
    from cuda_raytracer_tpu_torch.render import backends
    from cuda_raytracer_tpu_torch.utils.image import load_png

    label, _, env, flags, spp, kinds = setting
    w, h = size
    out = os.path.join(tmp, "run_h.png")
    dfs, wf = [], []
    launch, trace_wf = packet_dfs.dfs_trace_cuda, backends.trace_closest_wavefront

    def keep_dfs(*args):
        if args[3] is not None and len(dfs) < 3:
            dfs.append(args[:4])
        return launch(*args)

    def keep_wf(scene, o, d, valid, t_limit, *args, **kw):
        if t_limit is not None and len(wf) < 3:
            wf.append((o, d, valid, t_limit))
        return trace_wf(scene, o, d, valid, t_limit, *args, **kw)

    packet_dfs.dfs_trace_cuda = keep_dfs
    backends.trace_closest_wavefront = keep_wf
    reset_launches()
    try:
        r, bench = _cli_run([doc, "-w", out, "-s", str(spp), "--size",
                             f"{w}x{h}", "--bench", "--device", DEVICE,
                             *flags, *(["-e", sky] if env else [])],
                            tag=f"run H {label}")
    finally:
        packet_dfs.dfs_trace_cuda = launch
        backends.trace_closest_wavefront = trace_wf
    torch.cuda.synchronize()
    launches = read_launches()
    cfg, frames = r.config, len(r.frame_ms)
    want = expected_launches(r, frames)
    png = load_png(out)
    mean = float(png.mean())
    # past the process's first frames: one more frame, then one profiled
    r.render()
    steady = r.frame_ms[-1]
    dev_ms, busy, dev_launches = _device_busy(r.render, steady)
    print(f"[run H] {label}: lights {r.scene.light_kinds} (want {kinds}), "
          f"{r.scene.num_prims} prims, {frames} frames of "
          f"{cfg.samples_per_frame} spp, depth {cfg.max_depth}, ms per "
          f"frame {[round(x, 1) for x in r.frame_ms[:frames]]}, one more "
          f"frame {steady:.1f}; Mrays/s (bench.py's accounting) "
          f"{bench['mrays_per_s']} over the render; load_s "
          f"{bench['load_s']}; dropped {r.dropped_sum}; launches "
          f"{launches} (want {want}); PNG {png.shape}, mean {mean:.6f}; a "
          f"profiled frame: {dev_ms:.1f} ms of kernel time in "
          f"{dev_launches} device launches, busy share {busy:.3f} of the "
          f"frame before it [{smi_line()}]")
    check(tuple(r.scene.light_kinds) == kinds,
          f"run H {label}: light kinds {r.scene.light_kinds}")
    check(r.dropped_sum == 0, f"run H {label}: dropped rays")
    check(launches == want, f"run H {label}: kernel launches {launches} "
          f"!= the schedule's {want}")
    check(png.shape == (h, w, 3), f"run H {label}: PNG shape")
    check(bool(np.isfinite(png).all()) and mean > RUN_C_PNG_FLOOR,
          f"run H {label}: PNG mean {mean} at or below the floor")
    return r, launches, dfs, wf


def _no_limit(rays):
    """Whether every lane of a shadow trace has the no-limit max_t."""
    return bool((rays[3] >= T_NO_LIMIT).all())


def _run_h_kernels(r, dfs, wf):
    """The kernels against their plain versions on the fast run's own
    shadow sets toward the directional and the environment light (all
    lanes at the no-limit max_t), and toward the area light (finite) for
    their times beside them: the DFS on the depth-0 sets, the ray form
    of the partition, count, pack and decode on the first roulette
    depth's; and on the infinite lights' the whole wavefront trace
    against the DFS.  Returns the measurements by light."""
    check(len(dfs) == 3 and len(wf) == 3,
          "run H: fewer than three shadow traces kept")
    check(not _no_limit(dfs[0]) and not _no_limit(wf[0]),
          "run H: the area light's shadow rays have the no-limit max_t")
    check(all(_no_limit(x) for x in (*dfs[1:], *wf[1:])),
          "run H: the infinite lights' shadow rays have a finite max_t")
    got = {}
    for kind, d_rays, w_rays in zip(("area", "directional", "environment"),
                                    dfs, wf):
        dfs_k = measure_kernel(f"run H depth-0 shadow trace, {kind} light",
                               r.scene, d_rays, True, chunk=1 << 18)
        label = f"run H depth-2 shadow trace, {kind} light"
        part = measure_partition(label, w_rays)["rays"]
        wfr = measure_wavefront(label, r.scene, w_rays)
        dec = measure_decode(label, wfr["keys"])
        if kind != "area":
            compare_traces(label, r.scene, w_rays, any_hit=True)
        got[kind] = dict(dfs=dfs_k, part=part, wf=wfr, dec=dec)
    for kind in ("directional", "environment"):
        k, a = got[kind], got["area"]
        print(f"[run H] {kind} light against the area light's shadow sets "
              f"(kernel ms): DFS {k['dfs']['ms']:.4f} / {a['dfs']['ms']:.4f}"
              f", partition {k['part']['ms']:.4f} / {a['part']['ms']:.4f} "
              f"({k['part']['n_live']} / {a['part']['n_live']} live), count "
              f"{k['wf']['level0']['count_ms']:.4f} / "
              f"{a['wf']['level0']['count_ms']:.4f}, pack (all levels) "
              f"{k['wf']['sums']['pack_ms']:.4f} / "
              f"{a['wf']['sums']['pack_ms']:.4f}, decode "
              f"{k['dec']['ms']:.4f} / {a['dec']['ms']:.4f}")
    return got


def _run_h_card_vs_cpu(docs, sky):
    """Each run H setting on the document at terrain n=8 under
    max_leaf_size=4, 64x32, 2 passes of 2 spp, on the card and on the
    CPU, per pixel."""
    import numpy as np

    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    for label, lights, env, flags, _, _ in RUN_H:
        doc = docs[lights]
        cfg, mode = _cli_config([doc, "--size", "64x32", "-s", "4",
                                 "--spp-per-pass", "2", *flags],
                                max_leaf_size=4)
        imgs = []
        for dev in (DEVICE, "cpu"):
            rr = WavefrontRenderer(cfg, camera_mode=mode, device=dev)
            rr.load_scene(doc)
            if env:
                _attach_env(rr, sky)
            for _ in range(2):
                rr.render()
                check(rr.dropped == 0, f"run H small {label}: dropped")
            imgs.append(rr.get_raw_image())
        a, b = imgs
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        print(f"[run H] card vs CPU, {label}, small document, "
              f"max_leaf_size=4 ({len(rr.scene.bvh.wf_sched)} wavefront "
              f"levels), lights {rr.scene.light_kinds}, 64x32, 2 passes of "
              f"2 spp: {int(bad.sum())} of {a.shape[0] * a.shape[1]} pixels"
              f" outside rtol={PIXEL_RTOL} atol={PIXEL_ATOL}; max |diff| "
              f"{float(np.abs(a - b).max()):.3g}; image mean "
              f"{float(a.mean()):.6f}")
        check(float(a.mean()) > 0.0, f"run H small {label}: black image")
        check(float(bad.mean()) <= MAX_BAD,
              f"run H small {label}: card and CPU frames differ")


def env_spheres(env):
    """A diffuse and a mirror sphere at VIEW_A's target under the
    environment map ``env`` alone (the z-test's scene)."""
    import numpy as np

    from cuda_raytracer_tpu_torch.scene import static_scene as st
    from cuda_raytracer_tpu_torch.scene.bsdf import DiffuseBSDF, MirrorBSDF

    return st.Scene(
        [st.SphereObject(np.array([-0.5, 0.75, 0.0]), 0.45,
                         DiffuseBSDF(np.full(3, 0.6))),
         st.SphereObject(np.array([0.5, 0.75, 0.0]), 0.45,
                         MirrorBSDF(np.full(3, 0.9)))],
        [st.EnvironmentLight(env)])


def phase_run_h(n=121, size=(WIDTH, HEIGHT), small_n=8,
                oracle_size=(64, 48)):
    """Run H: the infinite lights through render_cli at full width on
    run C's document: with a directional light beside the area light and
    the sky map written as a float ZIP EXR (-e), under the fast preset
    (64 spp) and the default preset (4 spp), and the lightless document
    (the default ambient hemisphere) under the fast preset (4 spp); per
    setting dropped == 0, the launches the schedule gives at its lights,
    the PNG read back, ms per frame and busy share.  Then the kernels on
    the fast run's no-limit shadow sets, each setting card vs CPU on the
    document at terrain ``small_n``, and the card's engine against the
    card's PathTracer under the sky map (z-test).  Returns the JSON rows
    of the kernels on the environment light's shadow sets."""
    import tempfile

    from cuda_raytracer_tpu_torch.utils.image import load_exr

    t0 = time.perf_counter()
    sky_img = sky_map()
    with tempfile.TemporaryDirectory() as tmp:
        sky = os.path.join(tmp, "sky.exr")
        write_exr(sky, sky_img)
        back = load_exr(sky)
        print(f"[run H] sky.exr: {RUN_H_SKY_SIZE[0]}x{RUN_H_SKY_SIZE[1]} "
              f"float ZIP, {os.path.getsize(sky)} bytes, reads back "
              f"{'bit-equal' if (back == sky_img).all() else 'DIFFERENT'}")
        check(bool((back == sky_img).all()), "run H: sky.exr reads back "
              "different")
        docs, small = {}, {}
        for lights in {x[1] for x in RUN_H}:
            tag = "_".join(lights) or "none"
            docs[lights] = os.path.join(tmp, f"run_h_{tag}.dae")
            small[lights] = os.path.join(tmp, f"run_h_{tag}_small.dae")
            with open(docs[lights], "w") as f:
                f.write(run_c_document(n, lights))
            with open(small[lights], "w") as f:
                f.write(run_c_document(small_n, lights))
        runs = {}
        for setting in RUN_H:
            runs[setting[0]] = _run_h_cli(docs[setting[1]], sky, tmp,
                                          setting, size)
        r, launches, dfs, wf = runs[RUN_H[0][0]]
        got = _run_h_kernels(r, dfs, wf)
        _run_h_card_vs_cpu(small, back)
    _oracle_ztest(oracle_size, 64, env_spheres(sky_img),
                  "two spheres under the sky map", "run H")
    print(f"[run H] phase 11 took {time.perf_counter() - t0:.1f} s")
    env, dirl = got["environment"], got["directional"]

    def row(name, source, replaces, k, err):
        return kernel_row(name, source, replaces + " (shadow rays toward "
                          "an infinite light, max_t 1e30)",
                          launches[name.rsplit("_", 1)[0]], k, err,
                          k.get("library_ms"))

    cnt, pk = env["wf"]["level0"], env["wf"]["best"]
    return [
        row("packet_dfs_nolimit", "packet_dfs.cu", "packet_dfs.py:99",
            env["dfs"], max(env["dfs"]["max_abs_err"],
                            dirl["dfs"]["max_abs_err"])),
        row("partition_rays_nolimit", "partition.cu", "partition.py:38",
            env["part"], max(env["part"]["max_abs_err"],
                             dirl["part"]["max_abs_err"])),
        row("wf2_count_nolimit", "wavefront2.cu", "wavefront2.py:262",
            dict(ms=cnt["count_ms"], plain_ms=cnt["count_plain_ms"],
                 **cnt["count_bound"]),
            float(max(cnt["count_err"],
                      dirl["wf"]["level0"]["count_err"]))),
        row("wf2_pack_nolimit", "wavefront2.cu", "wavefront2.py:377",
            dict(ms=pk["pack_ms"], plain_ms=pk["pack_plain_ms"],
                 **pk["pack_bound"]),
            max(pk["pack_err"], dirl["wf"]["best"]["pack_err"])),
        row("wf2_decode_nolimit", "wavefront2.cu", "wavefront2.py:1420",
            env["dec"], max(env["dec"]["max_abs_err"],
                            dirl["dec"]["max_abs_err"])),
    ]


#: run I (phase 12): the settings whose graphed frames are held against
#: their eager frames: (label, how the renderer is made (``_run_i_make``),
#: frames; the last after a small camera move)
RUN_I = (
    ("run A", "run_a", 3),
    ("run G default pass", "run_g", 3),
    ("run H reference, three lights", "run_h", 3),
    ("lightless, 4 spp", "lightless", 3),
    ("run F, 4 shards of the card", "shards", 3),
    ("run B, compact_depths", "compact", 3),
)


def _run_i_make(kind, graphed, docs, sky, n):
    """One phase-12 renderer, loaded and placed: ``graphed`` renders with
    CUDA graphs (the default on the card), else eagerly (fuse_frame="no";
    under compact_depths the per-depth programs called without capture,
    since compaction needs a fused frame)."""
    import torch

    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.models.terrain import terrain_scene
    from cuda_raytracer_tpu_torch.parallel.shard import ShardedRenderer
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    fuse = {} if graphed else {"fuse_frame": "no"}
    size = ["--size", f"{WIDTH}x{HEIGHT}"]
    if kind == "run_a":
        r = WavefrontRenderer(fast_config(**fuse), camera_mode="collada",
                              device=DEVICE)
        r.load_static_scene(cornell_box_scene(with_spheres=True))
        r.set_viewpoint(*VIEW_A)
        return r
    if kind == "run_b":
        r = WavefrontRenderer(fast_config(**fuse), camera_mode="collada",
                              device=DEVICE)
        r.load_static_scene(terrain_scene(n=n))
        r.set_viewpoint(*VIEW_B)
        return r
    if kind == "shards":
        r = ShardedRenderer(fast_config(shard_mode="samples", **fuse),
                            [torch.device(DEVICE)] * 4)
        r.load_static_scene(terrain_scene(n=n))
        r.set_viewpoint(*VIEW_B)
        return r
    if kind == "compact":
        r = WavefrontRenderer(fast_config(compact_depths=True),
                              camera_mode="collada", device=DEVICE)
        r.graphs.enabled = graphed  # not graphed: the programs uncaptured
        r.load_static_scene(terrain_scene(n=n))
        r.set_viewpoint(*VIEW_B)
        return r
    doc, flags = {
        "run_g": (docs[("area",)], []),
        "run_h": (docs[("area", "directional")], []),
        "lightless": (docs[()], ["--preset", "fast", "-m", "4", "-s", "4"]),
        "cutracer": (docs[("area",)], ["--reference-compat", "--camera-mode",
                                       "cutracer"]),
    }[kind]
    cfg, mode = _cli_config([doc, *size, *flags], **fuse)
    r = WavefrontRenderer(cfg, camera_mode=mode, device=DEVICE)
    r.load_scene(doc)
    if kind == "run_h":
        _attach_env(r, sky)
    return r


def _run_i_frames(r, frames):
    """``frames`` frames of r, the last after a small camera move (2 cm
    along the camera's x): per frame the raw and the shown image,
    dropped, the graphs captured so far, the host ms and, compacted, the
    live counts."""
    import numpy as np
    import torch

    out = []
    for f in range(frames):
        if f == frames - 1:
            cam = r.camera
            origin = cam.pos + 0.02 * cam.c2w[:, 0]
            r.set_viewpoint(origin, origin - cam.c2w[:, 2])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        g = r.graphs
        out.append(dict(raw=r.get_raw_image(), img=r.get_image(),
                        dropped=r.dropped, ms=ms,
                        captures=g.captures if g is not None else 0,
                        capture_s=g.capture_s if g is not None else 0.0,
                        warmup_s=g.warmup_s if g is not None else 0.0,
                        keys=list(g) if g is not None else [],
                        live=list(getattr(r, "live_counts", [])),
                        buckets=dict(getattr(r, "_depth_buckets", {}))))
        check(bool(np.isfinite(out[-1]["raw"]).all()),
              f"run I: frame {f} not finite")
    return out


def _run_i_want(r, frames):
    """The launches ``frames`` frames of r make by its schedule."""
    if hasattr(r, "mesh"):
        return sharded_launches(r, frames)
    return expected_launches(r, frames)


def _run_i_setting(label, kind, frames, docs, sky, n):
    """One phase-12 setting: the eager renderer's frames, then the
    graphed one's (warm-up and capture in its first), held to the bit;
    dropped 0; the graphed frames' launches (replays, warm-up left out)
    equal to the schedule; each graph captured once and none in the
    frame after the move (under compact_depths only a new bucket may
    add one); peak memory of each; then one frame each in turns (eager,
    graphed, graphed, eager) and a profiled frame each."""
    import gc

    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch.render import graphs

    runs, peaks, launches = {}, {}, {}
    rs = {}
    for graphed in (False, True):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        r = _run_i_make(kind, graphed, docs, sky, n)
        reset_launches()
        runs[graphed] = _run_i_frames(r, frames)
        launches[graphed] = read_launches()
        warm = dict(graphs.warmup_launches)
        peaks[graphed] = torch.cuda.max_memory_allocated() / 2**30
        rs[graphed] = r
        want = _run_i_want(r, frames)
        check(launches[graphed] == want, f"run I {label} "
              f"({'graphed' if graphed else 'eager'}): launches "
              f"{launches[graphed]} != the schedule's {want}")
        if graphed:
            check(r.graphs.enabled, f"run I {label}: graphs not enabled")
    e, g = rs[False], rs[True]
    bad = [f for f in range(frames)
           if not (np.array_equal(runs[False][f]["raw"], runs[True][f]["raw"])
                   and np.array_equal(runs[False][f]["img"],
                                      runs[True][f]["img"]))]
    check(not bad, f"run I {label}: graphed frames {bad} differ from the "
          f"eager ones")
    for graphed in (False, True):
        check(all(x["dropped"] == 0 for x in runs[graphed]),
              f"run I {label}: dropped rays")
    caps = [x["captures"] for x in runs[True]]
    check(all(x["captures"] == len(x["keys"]) for x in runs[True]),
          f"run I {label}: a graph was captured twice ({caps})")
    # after the first frame a new graph is only a key not needed before:
    # the film without the median (once past post_process_threshold) or,
    # under compaction, the programs of a bucket that grew
    new_keys = []
    for a, b in zip(runs[True], runs[True][1:]):
        new = [k for k in b["keys"] if k not in a["keys"]]
        new_keys.append(new)
        grew = a["buckets"] != b["buckets"]
        check(all(k[0] == "film" or (grew and len(k) == 3) for k in new),
              f"run I {label}: captured anew {new} (buckets "
              f"{a['buckets']} -> {b['buckets']})")
    live = [x["live"] for x in runs[True]]
    if kind == "compact":
        check(live[0] != live[1], f"run I {label}: frames 1 and 2 read the "
              f"same live counts {live[0]}")
    # one frame each in turns, then a profiled frame each
    turns = {False: [], True: []}
    for graphed in (False, True, True, False):
        r = rs[graphed]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r.render()
        torch.cuda.synchronize()
        turns[graphed].append((time.perf_counter() - t0) * 1e3)
    busy = {}
    for graphed in (False, True):
        ms = min(turns[graphed])
        busy[graphed] = _device_busy(rs[graphed].render, ms)
    res = dict(label=label, eager_ms=turns[False], graphed_ms=turns[True],
               first_ms=runs[True][0]["ms"],
               eager_first_ms=runs[False][0]["ms"],
               capture_s=runs[True][0]["capture_s"],
               warmup_s=runs[True][0]["warmup_s"], captures=caps,
               peak_eager=peaks[False], peak_graphed=peaks[True],
               busy=busy, launches=launches[True], warmup=warm, live=live)
    print(f"[run I] {label}: {frames} frames bit-equal graphed vs eager "
          f"(raw and shown images; the last after a camera move), dropped "
          f"0, launches {launches[True]} = the schedule (warm-up's "
          f"{warm} apart); graphs captured after each frame {caps}, new "
          f"keys in frames 2.. {new_keys}"
          f"{f', live counts {live}, buckets' if kind == 'compact' else ''}"
          f"{[x['buckets'] for x in runs[True]] if kind == 'compact' else ''};"
          f" first frame {runs[True][0]['ms']:.1f} ms graphed (warm-up "
          f"{runs[True][0]['warmup_s'] * 1e3:.1f} ms and captures "
          f"{runs[True][0]['capture_s'] * 1e3:.1f} ms of it) against "
          f"{runs[False][0]['ms']:.1f} eager; in turns eager "
          f"{turns[False][0]:.2f}, graphed {turns[True][0]:.2f}, graphed "
          f"{turns[True][1]:.2f}, eager {turns[False][1]:.2f} ms; profiled "
          f"frame eager {busy[False][0]:.1f} ms of kernels in "
          f"{busy[False][2]} device launches, busy {busy[False][1]:.3f}; "
          f"graphed {busy[True][0]:.1f} ms in {busy[True][2]}, busy "
          f"{busy[True][1]:.3f}; peak device memory eager "
          f"{peaks[False]:.2f} GiB, graphed {peaks[True]:.2f} GiB "
          f"[{smi_line()}]")
    del e, g, rs, r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_run_i(n=121, size=(WIDTH, HEIGHT)):
    """Run I: the fused frame as CUDA graphs (render/graphs.py), one per
    depth, raygen and film, the compacted programs per bucket, one per
    shard's frame, held against the eager frame in six settings (RUN_I)
    at full width: run A (bench.py's), run G's default-preset pass on run
    C's document, run H's three-light reference pass, the lightless
    document's 4-spp fast frame, run F's four shards of the card, and
    run B under compact_depths (its eager side the per-depth programs
    uncaptured)."""
    import tempfile

    t0 = time.perf_counter()
    sky = sky_map()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        docs = {}
        for lights in (("area",), ("area", "directional"), ()):
            docs[lights] = os.path.join(tmp, f"run_i_{len(lights)}.dae")
            with open(docs[lights], "w") as f:
                f.write(run_c_document(n, lights))
        for label, kind, frames in RUN_I:
            results.append(_run_i_setting(label, kind, frames, docs, sky, n))
    print(f"[run I] phase 12 took {time.perf_counter() - t0:.1f} s")
    return results


#: run J (phase 13): run I's settings whose frames are drawn once by the
#: uniform kernel and once by its plain version: (label, how the renderer
#: is made (``_run_i_make``), frames; the last after a small camera move)
RUN_J = RUN_I[:3]
#: the key of phase 13's draws outside a frame
RNG_KEY = (1797259609, 2579123966)


@contextlib.contextmanager
def _plain_draws():
    """A context in which rng.uniform is its plain version, uniform_plain
    (int64 tensor ops on the card): a frame's twin drawn without the
    kernel.  The package has no such switch; only this script swaps."""
    from cuda_raytracer_tpu_torch import rng

    kernel = rng.uniform
    rng.uniform = rng.uniform_plain
    try:
        yield
    finally:
        rng.uniform = kernel


def _draw_shapes(fn):
    """fn()'s result and its rng.uniform calls as (shape, repeat), in
    call order."""
    from cuda_raytracer_tpu_torch import rng

    calls, draw = [], rng.uniform

    def record(key, shape, device, repeat=1):
        calls.append((tuple(int(x) for x in shape), int(repeat)))
        return draw(key, shape, device, repeat)

    rng.uniform = record
    try:
        out = fn()
    finally:
        rng.uniform = draw
    return out, calls


def _rng_bound(shape, repeat):
    """bound_ms of one draw: 4 bytes per output written, RNG_INT_OPS per
    source draw (the repeat form's copies cost no hash)."""
    n_src = math.prod(shape)
    return _bound(4 * n_src * repeat, 0, int_ops=RNG_INT_OPS * n_src)


def measure_rng(label, shape, repeat=1):
    """The uniform kernel against uniform_plain on the card: with RNG_KEY
    as ints and as a KeyTable entry, bit for bit; kernel, plain and
    bound times."""
    import torch

    from cuda_raytracer_tpu_torch import rng

    dev = torch.device(DEVICE)
    table = rng.KeyTable(["k"], dev)
    table.load({"k": RNG_KEY})
    plain = rng.uniform_plain(RNG_KEY, shape, dev, repeat)
    outs = {"int key": rng.uniform_cuda(RNG_KEY, shape, dev, repeat),
            "KeyTable key": rng.uniform_cuda(table["k"], shape, dev, repeat)}
    torch.cuda.synchronize()
    same = {f: torch.equal(o.view(torch.int32), plain.view(torch.int32))
            for f, o in outs.items()}
    err = max(float((o - plain).abs().max()) for o in outs.values())
    lo, hi = float(plain.min()), float(plain.max())
    ms = cuda_time_ms(lambda: rng.uniform_cuda(table["k"], shape, dev,
                                               repeat), 20)
    plain_ms = cuda_time_ms(lambda: rng.uniform_plain(RNG_KEY, shape, dev,
                                                      repeat), 3)
    b = _rng_bound(shape, repeat)
    print(f"[rng] {label}: shape {shape} x{repeat} ({plain.numel():,} "
          f"outputs): bit-equal to uniform_plain {same}, values in "
          f"[{lo:.7f}, {hi:.7f}]; kernel {ms:.4f} ms, plain {plain_ms:.3f} "
          f"ms, bound {b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
          f"{b['bytes_ms']:.5f}, ops {b['ops_ms']:.5f}): "
          f"{b['bound_ms'] / ms:.1%} of the bound [{smi_line()}]")
    check(all(same.values()), f"rng {label}: the kernel's bits differ from "
          f"uniform_plain's ({same})")
    check(tuple(plain.shape) == rng._repeated(shape, repeat)
          and 0.0 <= lo and hi < 1.0, f"rng {label}: shape or range")
    return dict(ms=ms, plain_ms=plain_ms, max_abs_err=err, **b)


def _rng_semantics():
    """No launch for no outputs; a captured draw reads its KeyTable key
    at each replay (a new key, new bits); the repeat form against
    repeat_interleave of the plain draw at a ragged size."""
    import torch

    from cuda_raytracer_tpu_torch import rng

    dev = torch.device(DEVICE)
    before = rng.launches
    empty = [rng.uniform(RNG_KEY, shape, dev) for shape in ((0,), (0, 2))]
    check(rng.launches == before and all(e.numel() == 0 for e in empty),
          "rng: an empty draw launched the kernel")
    table = rng.KeyTable(["k"], dev)
    table.load({"k": RNG_KEY})
    shape = (WIDTH * HEIGHT, 2)
    rng.uniform(table["k"], shape, dev)  # warm outside the capture
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        out = rng.uniform(table["k"], shape, dev)
    same = []
    for key in (RNG_KEY, rng.fold_in(RNG_KEY, 1), rng.fold_in(RNG_KEY, 2)):
        table.load({"k": key})
        g.replay()
        torch.cuda.synchronize()
        want = rng.uniform_plain(key, shape, dev)
        same.append(torch.equal(out.view(torch.int32),
                                want.view(torch.int32)))
    rag = rng.uniform(RNG_KEY, (37, 3), dev, repeat=5)
    rag_ok = torch.equal(rag, torch.repeat_interleave(
        rng.uniform_plain(RNG_KEY, (37, 3), dev), 5, dim=0))
    print(f"[rng] no launch for empty draws; a captured draw replayed under "
          f"three keys loaded into its KeyTable: bit-equal to each key's "
          f"plain draw {same}; (37, 3) x5 equal to repeat_interleave "
          f"{rag_ok}")
    check(all(same), "rng: a graph replay did not read its KeyTable key")
    check(rag_ok, "rng: the repeat form at (37, 3) x5")


def _run_j_setting(label, kind, frames, docs, sky, n):
    """One phase-13 setting, eager and graphed: frames drawn by the kernel
    and frames drawn by uniform_plain, each renderer made and driven
    under its draws; all four bit-equal frame by frame (raw and shown
    image); launches as the schedule gives (no uniform kernel in the
    plain twins); then one frame each in turns (kernel, plain, plain,
    kernel) and a profiled frame each.  Returns the draws of run A's
    first frame (``shapes``) besides the times."""
    import gc

    import numpy as np
    import torch

    runs, rs, launches, shapes = {}, {}, {}, []
    for graphed in (False, True):
        for plain in (False, True):
            with _plain_draws() if plain else contextlib.nullcontext():
                r = _run_i_make(kind, graphed, docs, sky, n)
                reset_launches()
                runs[graphed, plain], calls = _draw_shapes(
                    lambda: _run_i_frames(r, frames))
                launches[graphed, plain] = read_launches()
            if not (graphed or plain):
                shapes = calls
            want = _run_i_want(r, frames)
            if plain:
                want["rng_uniform"] = 0
            check(launches[graphed, plain] == want, f"run J {label} "
                  f"({'graphed' if graphed else 'eager'}, "
                  f"{'plain' if plain else 'kernel'} draws): launches "
                  f"{launches[graphed, plain]} != the schedule's {want}")
            check(all(x["dropped"] == 0 for x in runs[graphed, plain]),
                  f"run J {label}: dropped rays")
            rs[graphed, plain] = r
    ref = runs[False, False]
    bad = {k: [f for f in range(frames)
               if not (np.array_equal(ref[f]["raw"], v[f]["raw"])
                       and np.array_equal(ref[f]["img"], v[f]["img"]))]
           for k, v in runs.items()}
    check(not any(bad.values()), f"run J {label}: frames differ from the "
          f"eager kernel-drawn ones (graphed, plain): {bad}")
    turns, busy = {}, {}
    for graphed in (False, True):
        for plain in (False, True, True, False):
            with _plain_draws() if plain else contextlib.nullcontext():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                rs[graphed, plain].render()
                torch.cuda.synchronize()
            turns.setdefault((graphed, plain), []).append(
                (time.perf_counter() - t0) * 1e3)
        for plain in (False, True):
            with _plain_draws() if plain else contextlib.nullcontext():
                busy[graphed, plain] = _device_busy(
                    rs[graphed, plain].render, min(turns[graphed, plain]))
    desc = "; ".join(
        f"{'graphed' if g else 'eager'} {'plain' if p else 'kernel'} "
        f"draws: {', '.join(f'{t:.2f}' for t in turns[g, p])} ms, "
        f"profiled {busy[g, p][0]:.1f} ms of kernels in {busy[g, p][2]} "
        f"device launches, busy {busy[g, p][1]:.3f}"
        for g in (False, True) for p in (False, True))
    print(f"[run J] {label}: {frames} frames (the last after a camera move) "
          f"bit-equal eager and graphed, kernel and plain draws; dropped 0; "
          f"launches {launches[True, False]} = the schedule, the plain "
          f"twins' without rng_uniform; in turns {desc} [{smi_line()}]")
    res = dict(label=label, turns=turns, busy=busy, shapes=shapes,
               launches=launches[True, False])
    del rs, r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def phase_rng(n=121):
    """Phase 13: the uniform kernel (ops/csrc/rng.cu).  What ptxas says of
    it; no launch for an empty draw, a captured draw reading its KeyTable
    key at each replay; run A (eager and graphed), run G's default pass
    and run H's three-light reference pass (RUN_J) drawn by the kernel
    and by uniform_plain in one process, bit-equal, launches as the
    schedule gives, times in turns; then the kernel against uniform_plain
    at every shape run A's frame draws, at 15,360,001 and under a
    KeyTable key, timed beside its bound, and the frame's draws summed.
    Returns the kernel's JSON row."""
    import tempfile

    from cuda_raytracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for line in _build.ptxas_report("rng"):
        print(f"[rng] ptxas, rng.cu: {line}")
    _rng_semantics()
    sky = sky_map()
    results = []
    with tempfile.TemporaryDirectory() as tmp:
        docs = {}
        # _run_i_make names the lightless document too
        for lights in (("area",), ("area", "directional"), ()):
            docs[lights] = os.path.join(tmp, f"run_j_{len(lights)}.dae")
            with open(docs[lights], "w") as f:
                f.write(run_c_document(n, lights))
        for label, kind, frames in RUN_J:
            results.append(_run_j_setting(label, kind, frames, docs, sky, n))
    run_a = results[0]
    per_frame = run_a["shapes"][:len(run_a["shapes"]) // RUN_J[0][2]]
    lanes = WIDTH * HEIGHT * fast_config().samples_per_frame
    measured = {}
    for shape, repeat in dict.fromkeys(per_frame):
        measured[shape, repeat] = measure_rng("run A's draw", shape, repeat)
    odd = measure_rng("odd length", (lanes + 1,))
    frame_ms = sum(measured[c]["ms"] for c in per_frame)
    frame_bound = sum(_rng_bound(*c)["bound_ms"] for c in per_frame)
    print(f"[rng] run A's frame: {len(per_frame)} draws "
          f"{dict((c, per_frame.count(c)) for c in dict.fromkeys(per_frame))}"
          f", kernel {frame_ms:.4f} ms summed, bound {frame_bound:.5f} ms; "
          f"phase 13 took {time.perf_counter() - t0:.1f} s")
    # the per-lane [N, 2] shape (the reference preset's hemisphere draw,
    # ops/shade.py:618), which the fast frame no longer draws through
    # this kernel since raygen hashes its own
    main = measured.get(((lanes, 2), 1)) or measure_rng(
        "[N, 2] per-lane draw", (lanes, 2))
    err = max([odd["max_abs_err"], main["max_abs_err"]]
              + [m["max_abs_err"] for m in measured.values()])
    # not a pallas_call: it replaces the JAX frame's draws (raygen's now
    # in raygen.cu), the per-lane hemisphere draw first
    return dict(kernel_row("rng_uniform", "rng.cu", "",
                           run_a["launches"]["rng_uniform"], main, err),
                replaces="cuda_raytracer_tpu/ops/shade.py:618")


# ---------------------------------------------------------------------------
# phase 14 (run K): the shading stages' kernels (ops/csrc/shade.cu)
# ---------------------------------------------------------------------------

#: the four shading kernels: name -> the stage function of the JAX
#: package whose XLA fusion it replaces (not a pallas_call)
SHADE_KERNELS = {
    "shade_hit": "cuda_raytracer_tpu/render/bounce.py:71",
    "nee_prep": "cuda_raytracer_tpu/render/bounce.py:86",
    "nee_accum": "cuda_raytracer_tpu/render/bounce.py:93",
    "scatter": "cuda_raytracer_tpu/render/bounce.py:99",
}
#: a kernel against its plain version on the card, per float field: the
#: kernel rounds op by op (-fmad=false); torch's cross, vector_norm and
#: sums may contract a multiply-add or sum in another order
STAGE_RTOL, STAGE_ATOL = 1e-5, 1e-6
#: a lane may disagree only where a quantity that decides a branch
#: (backface, the frame's guide, ok, the light's side and cone, the fold's
#: sign, a diffuse weight's 0, tir, the Fresnel pick, roulette) lies
#: within this of its threshold (STAGE_RTOL on the scale of a unit
#: vector).  One field alone is held to a wider tolerance set from its
#: inputs: scatter's importance on a diffuse lane whose weight
#: 2|dot(d, n)| is ill-conditioned (the dot's rounding bound over the dot
#: above half of STAGE_RTOL), to STAGE_RTOL plus that conditioning
NEAR = 1e-5
#: the relative rounding bound of a three-term dot product, 3u / (1 - 3u)
#: with u = 2^-24
GAMMA_3 = 3 * 2.0 ** -24 / (1 - 3 * 2.0 ** -24)
#: float operations per lane, counted from shade.cu (a sqrt, division,
#: sin, cos, acos or atan2 as one; the shortest branch), for the bound
SHADE_FLOPS = {"shade_hit": 230, "nee_prep": 45, "nee_accum": 5,
               "scatter": 120}
#: the branches the stage inputs of phase 14's frames must reach, by
#: stage, and the BSDF lobes of scatter's lanes (scene/bsdf.py codes:
#: diffuse, mirror, refraction, glass, emission)
SHADE_BRANCHES = {
    "shade_hit": {"emission", "emission + env miss", "no emission"},
    "nee_prep": {"area", "area two-sided", "point", "spot", "directional",
                 "hemisphere", "environment"},
    "nee_accum": {"shadow test", "shadow test + prim_s >= 0"},
    "scatter": {"fold", "fold + roulette", "uniform", "cosine"},
}
SHADE_LOBES = {0, 1, 2, 3, 4}
LIGHT_NAMES = {0: "area", 1: "point", 2: "directional", 3: "hemisphere",
               4: "spot", 5: "environment"}
#: the shading kernels' launch counters (COUNTERS): the four stages' and
#: the fused chain's, by variant
SHADING = (*SHADE_KERNELS, *(f"gap_{g}" for g in GAP_VARIANTS))
#: what the fused chain's calls in phase 14's frames must meet (the parts
#: of ``_gap_branch``): every variant, the emission's branches, the
#: light of every kind drawn and accumulated (recomputed), the two-sided
#: area light, the shadow test's prim_s, scatter's sampling modes
CHAIN_BRANCHES = {
    *GAP_VARIANTS, "emission", "emission + env miss", "no emission",
    "prim_s >= 0", "fold", "fold + roulette", "uniform", "cosine",
    *(f"{what} {k}" for what in ("draws", "accumulates")
      for k in SHADE_BRANCHES["nee_prep"]),
}
#: run K: the frames shaded by the kernels and again by the plain stages
#: (label, how the renderer is made (``_run_i_make``))
RUN_K = (
    ("run A", "run_a"),
    ("run B", "run_b"),
    ("run B, compact_depths", "compact"),
    ("run G default pass", "run_g"),
    ("run H reference, three lights", "run_h"),
)


@contextlib.contextmanager
def _plain_stages():
    """A context in which a depth is shaded stage by stage (not by the
    fused chain) and the four stages are their plain versions (torch ops
    on the card): a frame's twin shaded without the kernels.  The
    package has no such switch; only this script swaps."""
    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    kernel = {k: getattr(SS, k) for k in (*SHADE_KERNELS, "chained")}
    for k in SHADE_KERNELS:
        setattr(SS, k, getattr(SS, f"{k}_plain"))
    SS.chained = lambda x: False
    try:
        yield
    finally:
        for k, fn in kernel.items():
            setattr(SS, k, fn)


def _stage_compare(log, stage, branch, got, want, near, rtol=None):
    """One call of a stage's kernel against its plain version: ``got``
    and ``want`` map output names to tensors ([N] or [N, 3]).  A lane is
    off where a bool or index field differs or a float field is outside
    STAGE_RTOL / STAGE_ATOL; an off lane must be ``near`` a threshold.
    ``rtol`` may map one float field to a per-lane [N] relative tolerance
    that replaces STAGE_RTOL where it is larger (a tolerance set from the
    inputs' conditioning); such lanes are counted, and those that need
    more than STAGE_RTOL.  Adds the call to ``log[stage, branch]``."""
    import torch

    n = next(iter(want.values())).shape[0]
    off = torch.zeros(n, dtype=torch.bool, device=near.device)
    flips, err, rel, wide, used = {}, 0.0, 0.0, 0, 0
    for name, b in want.items():
        a = got[name]
        check(a.shape == b.shape and a.dtype == b.dtype,
              f"{stage} ({branch}): {name} {a.dtype} {tuple(a.shape)} "
              f"against {b.dtype} {tuple(b.shape)}")
        if not b.dtype.is_floating_point:
            lane = a != b
        else:
            close = torch.isclose(a, b, rtol=STAGE_RTOL, atol=STAGE_ATOL,
                                  equal_nan=True)
            if rtol is not None and name in rtol:
                r = rtol[name] if b.dim() == 1 else rtol[name][:, None]
                within = (a - b).abs() <= STAGE_ATOL + r * b.abs()
                strict = close if close.dim() == 1 else close.all(-1)
                close = close | within
                lane_w = rtol[name] > STAGE_RTOL
                wide += int(lane_w.sum())
                used += int((lane_w & ~strict
                             & (close if close.dim() == 1
                                else close.all(-1))).sum())
            lane = ~close if close.dim() == 1 else ~close.all(-1)
        flips[name] = int(lane.sum())
        far = torch.nonzero(lane & ~near).flatten()[:3].tolist()
        for i in far:
            print(f"[shade] {stage} ({branch}): lane {i} of {n}, {name}: "
                  f"kernel {a[i].tolist()}, plain {b[i].tolist()}")
        off |= lane
    for name, b in want.items():
        a = got[name]
        if b.dtype.is_floating_point:
            keep = ~off if b.dim() == 1 else ~off[:, None].expand_as(b)
            fin = keep & torch.isfinite(b) & torch.isfinite(a)
            diff = (a - b).abs()[fin]
            if diff.numel():
                err = max(err, float(diff.max()))
                # relative error where the value is above atol
                big = b.abs()[fin] > STAGE_ATOL
                if bool(big.any()):
                    rel = max(rel, float((diff[big] / b.abs()[fin][big]).max()))
    n_off, n_far = int(off.sum()), int((off & ~near).sum())
    e = log.setdefault((stage, branch), dict(calls=0, lanes=0, off=0, far=0,
                                             near=0, wide=0, used=0,
                                             err=0.0, rel=0.0, flips={}))
    e["calls"] += 1
    e["lanes"] += n
    e["off"] += n_off
    e["far"] += n_far
    e["near"] += int(near.sum())
    e["wide"] += wide
    e["used"] += used
    e["err"], e["rel"] = max(e["err"], err), max(e["rel"], rel)
    for k, v in flips.items():
        e["flips"][k] = e["flips"].get(k, 0) + v
    return torch.nonzero(off & ~near).flatten()[:3].tolist()


def _dot3(a, b):
    return (a * b).sum(-1)


def _near_hit(hit, d):
    """Lanes whose hit record (the plain version's) lies near a branch:
    backface, the frame's guide."""
    ny = hit.n[:, 1]
    return ((_dot3(hit.n, d).abs() <= NEAR) | ((ny - 1e-4).abs() <= NEAR)
            | ((ny + 0.999).abs() <= NEAR))


def _near_nee(scene, hit, li, out):
    """Lanes whose NEE sample toward light ``li`` (nee_prep's plain
    outputs ``out``) lies near a branch: ok's distance and cosine, the
    area light's side, the spot's cone."""
    import torch

    kind = scene.light_kinds[li]
    wi = out[1]
    cos_surf = _dot3(hit.n, wi).abs()
    near = (((out[2] - 1e-2).abs() <= NEAR)
            | ((cos_surf - 1e-2).abs() <= NEAR))
    ldir = scene.light_direction[li]
    if kind == 0:
        near |= _dot3(wi, ldir).abs() <= NEAR
    if kind == 4:
        cone = torch.cos(scene.light_area[li] / 2)
        near |= (_dot3(-wi, ldir) - cone).abs() <= NEAR
    return near


def _near_scatter(scene, hit, imp, keys, u, fold, rr_key, eps, hs, drawn,
                  out_p):
    """Lanes of scatter's call (its plain outputs ``out_p``, its uniforms
    ``drawn`` = (u, u_fresnel, u_rr)) near a branch (tir, the Fresnel
    pick, a diffuse weight's 0, the fold's sign, roulette), and the
    per-lane relative tolerance of importance from the diffuse weight's
    conditioning.  Returns (near, importance's rtol, what a far lane's
    report prints)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import shade as S
    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    uu, u_f, u_rr = drawn
    # the deciding quantities, from the same inputs
    wo, ior = hit.wo_local, scene.bsdf_ior[hit.bsdf]
    cos_o = torch.clamp(wo[:, 2], 1e-6, 1.0)
    eta = torch.where(hit.backface, ior, 1.0 / ior)
    sin2_t = eta * eta * torch.clamp_min(1.0 - cos_o * cos_o, 0.0)
    r0 = ((1.0 - ior) / (1.0 + ior)) ** 2
    fres = r0 + (1.0 - r0) * (1.0 - cos_o) ** 5
    near = ((sin2_t - 1.0).abs() <= NEAR) | ((u_f - fres).abs() <= NEAR)
    # a diffuse lane's weight 2|dot(d, n)| (uniform and fold sampling;
    # cosine sampling's is the albedo): each version rounds the dot
    # three times, so the two differ by at most
    # 2 gamma_3 sum|d_i n_i| (the plain version's d and the hit's n);
    # over |dot| that is the weight's conditioning, which carries
    # into importance (roulette's 1/p with it).  The weight's
    # threshold is 0 (valid needs importance > 0).
    dp = out_p[1]
    dn = _dot3(dp, hit.n).abs()
    diffuse = (scene.bsdf_fn[hit.bsdf] == 0) & (hs != "cosine" or fold)
    near |= diffuse & (dn <= NEAR)
    if fold:
        near |= _dot3(S._spherical_sample(uu), hit.n).abs() <= NEAR
    cond = torch.where(diffuse & (dn > NEAR),
                       2 * GAMMA_3 * (dp * hit.n).abs().sum(-1) / dn, 0.0)
    cond = torch.where(cond > 0.5 * STAGE_RTOL, cond, 0.0)
    p = None
    if u_rr is not None:
        # p from the plain version's importance before the roulette;
        # where the weight is ill-conditioned, p is no closer than
        # its conditioning
        pre = SS.scatter_plain(scene, hit, imp, keys, u, fold, None, eps,
                               hs)[2]
        p = torch.clamp(pre.amax(-1), 0.05, 1.0)
        near |= (u_rr - p).abs() <= NEAR + cond * p

    def report(i):
        return (f"bsdf {int(scene.bsdf_fn[hit.bsdf[i]])}, backface "
                f"{bool(hit.backface[i])}, sin2_t {float(sin2_t[i])}, "
                f"u_f - fres {float(u_f[i] - fres[i])}, dot(d, n) "
                f"{float(_dot3(dp[i], hit.n[i]))}, importance in "
                f"{imp[i].tolist()}"
                + (f", u_rr - p {float(u_rr[i] - p[i])}" if p is not None
                   else ""))

    return near, STAGE_RTOL + cond, report


@contextlib.contextmanager
def _probe_stages(log, kept=None, lobes=None):
    """A context in which the frame is shaded stage by stage on the card
    (``shade_stages.chained`` off) and every call of a shading stage runs
    its kernel and its plain version on the same inputs (the same draws:
    the plain scatter draws from the keys the kernel's draws came from),
    holds them together (``_stage_compare``) and returns the kernel's
    outputs.  ``kept``, a dict, receives each stage's first call
    (scatter: its first with roulette) as (kernel function, its
    arguments, plain function, its arguments); ``lobes``, a set, the
    BSDF codes of scatter's live lanes."""
    import torch

    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    real = {k: getattr(SS, k) for k in (*SHADE_KERNELS, "chained")}
    hit_fields = ("valid", "pt", "n", "dpdu", "dpdv", "wo_local", "bsdf",
                  "t", "backface")

    def keep(name, fk, ak, fp, ap):
        if kept is not None and name not in kept:
            kept[name] = (fk, ak, fp, ap)

    def shade_hit(scene, o, d, t, prim, valid, imp, light, ce, eps, compat):
        args = (scene, o, d, t, prim, valid, imp, light, ce, eps, compat)
        hk, lk = SS.shade_hit_cuda(*args)
        hp, lp = SS.shade_hit_plain(*args)
        branch = ("no emission" if compat else
                  "emission + env miss" if scene.has_env else "emission")
        got = dict(zip(hit_fields, hk), light=lk)
        want = dict(zip(hit_fields, hp), light=lp)
        _stage_compare(log, "shade_hit", branch, got, want, _near_hit(hp, d))
        keep("shade_hit", SS.shade_hit_cuda, args, SS.shade_hit_plain, args)
        return hk, lk

    def nee_prep(scene, hit, imp, li, u, weight, compat_two_sided=False):
        args = (scene, hit, imp, li, u, weight, compat_two_sided)
        ok_k = SS.nee_prep_cuda(*args)
        ok_p = SS.nee_prep_plain(*args)
        kind = scene.light_kinds[li]
        branch = LIGHT_NAMES[kind] + (" two-sided" if compat_two_sided
                                      and kind == 0 else "")
        names = ("o", "wi", "max_t", "li", "ok")
        _stage_compare(log, "nee_prep", branch, dict(zip(names, ok_k)),
                       dict(zip(names, ok_p)), _near_nee(scene, hit, li, ok_p))
        keep("nee_prep", SS.nee_prep_cuda, args, SS.nee_prep_plain, args)
        return ok_k

    def nee_accum(light, t_s, prim_s, max_t, li_imp, ok, eps, compat):
        args = (light, t_s, prim_s, max_t, li_imp, ok, eps, compat)
        lk = SS.nee_accum_cuda(*args)
        lp = SS.nee_accum_plain(*args)
        branch = "shadow test" + (" + prim_s >= 0" if compat else "")
        # the same inputs and one subtraction: no lane may differ
        near = torch.zeros_like(ok)
        _stage_compare(log, "nee_accum", branch, dict(light=lk),
                       dict(light=lp), near)
        keep("nee_accum", SS.nee_accum_cuda, args, SS.nee_accum_plain, args)
        return lk

    def scatter(scene, hit, imp, keys, u, fold, rr_key, eps, hs):
        n, dev = hit.t.shape[0], hit.t.device
        uu, u_f, u_rr = SS.scatter_draws(keys, u, rr_key, n, dev)
        args_k = (scene, hit, imp, uu, u_f, u_rr, fold, eps, hs)
        args_p = (scene, hit, imp, keys, u, fold, rr_key, eps, hs)
        out_k = SS.scatter_drawn(*args_k)
        out_p = SS.scatter_plain(*args_p)
        branch = ("fold" if fold else hs) + (" + roulette" if rr_key
                                             is not None else "")
        near, rtol, report = _near_scatter(scene, hit, imp, keys, u, fold,
                                           rr_key, eps, hs, (uu, u_f, u_rr),
                                           out_p)
        names = ("o", "d", "importance", "valid", "count_emission")
        far = _stage_compare(log, "scatter", branch, dict(zip(names, out_k)),
                             dict(zip(names, out_p)), near,
                             rtol=dict(importance=rtol))
        for i in far:
            print(f"[shade] scatter ({branch}): lane {i}: {report(i)}")
        if lobes is not None:
            fn = scene.bsdf_fn[hit.bsdf][hit.valid]
            lobes.update(int(x) for x in torch.unique(fn).tolist())
        if rr_key is not None:
            keep("scatter", SS.scatter_drawn, args_k, SS.scatter_plain,
                 args_p)
        return out_k

    probes = dict(shade_hit=shade_hit, nee_prep=nee_prep,
                  nee_accum=nee_accum, scatter=scatter,
                  chained=lambda x: False)
    for k, fn in probes.items():
        setattr(SS, k, fn)
    try:
        yield
    finally:
        for k, fn in real.items():
            setattr(SS, k, fn)


def _gap_fields(res):
    """A gap's outputs by name: light, the shadow ray's fields (o only
    where the gap wrote it: the first sample of a depth), the next
    segment's."""
    light, shadow, path = res
    out = dict(light=light)
    if shadow is not None:
        out.update({f"shadow.{k}": v for k, v in shadow._asdict().items()
                    if v is not None})
    if path is not None:
        out.update(zip(("o", "d", "importance", "valid", "count_emission"),
                       path))
    return out


def _gap_branch(scene, kw):
    """A gap call's branch: its variant, then what it met (emission, the
    lights of the samples it accumulates and draws, reference_compat's
    two-sided area light and shadow test, scatter's sampling and
    roulette)."""
    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    opened, accum, sample = kw["opened"], kw["accum"], kw["sample"]
    compat = kw["reference_compat"]
    parts = [SS.gap_variant(opened is not None, accum, sample is not None,
                            kw["store"], kw["scatter"] is not None)]
    if opened is not None:
        parts.append("no emission" if compat else "emission + env miss"
                     if scene.has_env else "emission")
    for what, nee in (("accumulates", accum and accum[0]),
                      ("draws", sample)):
        if nee:
            kind = scene.light_kinds[nee.light]
            parts.append(f"{what} {LIGHT_NAMES[kind]}" + (
                " two-sided" if compat and kind == 0 else ""))
    if accum is not None and compat:
        parts.append("prim_s >= 0")
    if kw["scatter"] is not None:
        _, _, fold, rr_key = kw["scatter"]
        parts.append(("fold" if fold else kw["hemisphere_sampling"])
                     + (" + roulette" if rr_key is not None else ""))
    return "; ".join(parts)


@contextlib.contextmanager
def _probe_chain(log, kept=None, plain_hit=True):
    """A context in which every call of the fused chain (``shade_gap``)
    runs its kernel, the plain stages and the stage kernels chained the
    same way (``shade_stages.gap_by_stages``), all on the same inputs
    and draws; holds the kernel against the plain chain
    (``_stage_compare`` under "gap", a lane off only near a branch of
    any stage the gap runs, from the plain chain's own intermediates)
    and against the stage kernels to the bit (under "gap = stages"); and
    returns the kernel's outputs.  With ``plain_hit`` False the plain
    chain starts from the hit record of shade_hit's kernel (its light
    still the plain version's), as the stage probe hands the plain
    nee_prep and scatter the kernel's record: torch's ops on the card
    round a hit differently within STAGE_RTOL, and a mirror or glass
    lane's direction, built on the hit's frame, carries that to above
    STAGE_ATOL in a component near 0.  ``kept``, a dict, receives each
    variant's first call as (its arguments, its keywords, its keywords
    with scatter's uniforms drawn: shade_gap_drawn's)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    real = SS.shade_gap
    kernels = (SS.shade_hit_cuda, SS.nee_prep_cuda, SS.nee_accum_cuda,
               SS.scatter_cuda)

    def kernel_hit(scene, o, d, t, prim, valid, imp, light, ce, eps,
                   compat):
        hk = SS.shade_hit_cuda(scene, o, d, t, prim, valid, imp, light, ce,
                               eps, True)[0]
        return hk, SS.shade_hit_plain(scene, o, d, t, prim, valid, imp,
                                      light, ce, eps, compat)[1]

    plain = (SS.shade_hit_plain if plain_hit else kernel_hit,
             SS.nee_prep_plain, SS.nee_accum_plain, SS.scatter_plain)

    def gap(scene, o, d, t, prim, imp, light, **kw):
        args = (scene, o, d, t, prim, imp, light)
        got = SS.shade_gap_cuda(*args, **kw)
        want = SS.gap_by_stages(plain, *args, **kw)
        twin = SS.gap_by_stages(kernels, *args, **kw)
        branch = _gap_branch(scene, kw)
        variant = branch.split(";")[0]
        compat, eps = kw["reference_compat"], kw["origin_eps"]
        near = torch.zeros_like(t, dtype=torch.bool)
        rtol = None
        accum, sample, sc = kw["accum"], kw["sample"], kw["scatter"]
        if variant != "close_stored":
            hp = plain[0](scene, o, d, t, prim, None, imp, light, None, eps,
                          True)[0]
            near |= _near_hit(hp, d)
        if accum is not None and accum[1].li is None:
            nee, _, t_s, _ = accum
            out = SS.nee_prep_plain(scene, hp, imp, nee.light, nee.u,
                                    nee.weight, compat)
            near |= _near_nee(scene, hp, nee.light, out)
            # the pass test on a recomputed max_t
            max_t = out[2]
            near |= ((t_s - (max_t - kw["shadow_eps"])).abs()
                     <= NEAR * max_t.abs() + STAGE_ATOL)
        if sample is not None:
            near |= _near_nee(scene, hp, sample.light, (None, *want[1][1:]))
        if sc is not None:
            keys, u, fold, rr_key = sc
            drawn = SS.scatter_draws(keys, u, rr_key, t.shape[0], t.device)
            n_s, rt, _ = _near_scatter(
                scene, hp, imp, keys, u, fold, rr_key, eps,
                kw["hemisphere_sampling"], drawn, want[2])
            near |= n_s
            rtol = dict(importance=rt)
        g, w, tw = _gap_fields(got), _gap_fields(want), _gap_fields(twin)
        _stage_compare(log, "gap", branch, g, w, near, rtol=rtol)
        _stage_compare(log, "gap = stages", branch, g, tw,
                       torch.zeros_like(near))
        for k in tw:
            e = log["gap = stages", branch]
            same = torch.equal(g[k], tw[k]) or (
                g[k].dtype.is_floating_point
                and torch.equal(torch.isnan(g[k]), torch.isnan(tw[k]))
                and torch.equal(torch.nan_to_num(g[k]),
                                torch.nan_to_num(tw[k])))
            e["unequal"] = e.get("unequal", 0) + (not same)
        if kept is not None and variant not in kept:
            kk = dict(kw)
            if sc is not None:
                kk["scatter"] = (*drawn, sc[2])
            kept[variant] = (args, kw, kk)
        return got

    SS.shade_gap = gap
    try:
        yield
    finally:
        SS.shade_gap = real


def refraction_scene():
    """The Cornell box with its mirror and glass spheres and a third,
    refractive sphere, lit by its area light, a point light and a spot
    light aimed at the floor."""
    from cuda_raytracer_tpu_torch.models.cornell import cornell_box_scene
    from cuda_raytracer_tpu_torch.scene import static_scene as st
    from cuda_raytracer_tpu_torch.scene.bsdf import RefractionBSDF

    box = cornell_box_scene(with_spheres=True, sphere_bsdfs="classic")
    objects = list(box.objects) + [st.SphereObject(
        [0.0, 0.9, -0.5], 0.25, RefractionBSDF([0.9, 0.9, 0.9], 0.0, 1.45))]
    lights = list(box.lights) + [
        st.PointLight([2.0, 2.0, 2.0], [0.5, 1.2, 0.4]),
        st.SpotLight([3.0, 3.0, 3.0], [-0.5, 1.4, 0.5], [0.3, -1.0, -0.2],
                     50.0),
    ]
    return st.Scene(objects, lights)


def _shade_branch_settings(docs, sky, n):
    """(label, make) of the eager renderers whose frames phase 14 probes:
    every branch of SHADE_BRANCHES and every lobe between them."""
    from cuda_raytracer_tpu_torch.config import RenderConfig
    from cuda_raytracer_tpu_torch.render.engine import WavefrontRenderer

    size = ["--size", f"{WIDTH}x{HEIGHT}"]
    doc = docs[("area",)]

    def cli(flags):
        def make():
            cfg, mode = _cli_config([doc, *size, *flags], fuse_frame="no")
            r = WavefrontRenderer(cfg, camera_mode=mode, device=DEVICE)
            r.load_scene(doc)
            return r
        return make

    def refraction(**over):
        def make():
            cfg = RenderConfig(width=WIDTH, height=HEIGHT, total_samples=2,
                               samples_per_frame=2, fuse_frame="no", **over)
            r = WavefrontRenderer(cfg, camera_mode="collada", device=DEVICE)
            r.load_static_scene(refraction_scene())
            r.set_viewpoint(*VIEW_A)
            return r
        return make

    return (
        ("run A (fast preset: fold, roulette, area light, emitter)",
         lambda: _run_i_make("run_a", False, docs, sky, n)),
        ("run C's document (fast preset: mirror, glass)",
         cli(["--preset", "fast"])),
        ("refraction sphere, point and spot light (default preset)",
         refraction()),
        ("refraction sphere, NEE at depth 0 only (no sample past it)",
         refraction(nee_schedule=((1, 1.0),))),
        ("run G --hemisphere cosine", cli(["--hemisphere", "cosine"])),
        ("run G --reference-compat (two-sided)",
         cli(["--reference-compat", "--camera-mode", "cutracer"])),
        ("run H reference (directional, environment)",
         lambda: _run_i_make("run_h", False, docs, sky, n)),
        ("lightless document (hemisphere)",
         lambda: _run_i_make("lightless", False, docs, sky, n)),
    )


def _rows_bytes(x, lanes=None):
    """Bytes of tensor x a kernel must read or write: its rows where
    ``lanes`` ([N] bool) is set (all rows for None), a stride-0 axis (the
    camera's expand) counted once."""
    row = x.element_size() * math.prod(
        s for s, st in zip(x.shape[1:], x.stride()[1:]) if st != 0)
    if x.dim() and x.stride(0) == 0:
        return row
    return row * (x.shape[0] if lanes is None else int(lanes.sum()))


def _tensors(obj):
    """The tensors in a nest of tuples (HitRecords included) and values."""
    import torch

    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, (tuple, list)):
        return [t for x in obj for t in _tensors(x)]
    return []


def stage_reads(name, ak, out):
    """(tensor, lanes) of what shading stage ``name``'s call ``ak`` (the
    kernel's arguments), whose outputs are ``out``, must read in this
    call's data: each input on the lanes whose outputs need it (lanes
    None: every lane).  shade_packed counts the rows of the prims hit;
    the per-BSDF and per-light tables (under 1 KB) and the environment
    map's texels are not counted."""
    import torch

    from cuda_raytracer_tpu_torch.render import flatscene as F
    from cuda_raytracer_tpu_torch.scene import bsdf as B

    if name == "nee_accum":
        light, t_s, prim_s, max_t, li, ok, eps, compat = ak
        passes = ok & (t_s > max_t - eps)
        reads = [(light, None), (ok, None), (t_s, ok), (max_t, ok)]
        if compat:
            reads.append((prim_s, passes))
            passes = passes & (prim_s >= 0)
        return reads + [(li, passes)]
    scene = ak[0]
    if name == "shade_hit":
        _, o, d, t, prim, valid, imp, light, ce, eps, compat = ak
        hit = prim >= 0
        reads = [(o, None), (d, None), (prim, None), (t, hit)]
        rows = torch.zeros(scene.shade_packed.shape[0], dtype=torch.bool,
                           device=prim.device)
        rows[prim[hit].long()] = True
        reads.append((scene.shade_packed, rows))
        if compat:
            return reads
        emitter = hit & (scene.bsdf_fn[out[0].bsdf] == B.BSDF_EMISSION)
        # the environment's miss test reads valid; the emission, ce then
        # importance
        miss = torch.zeros_like(hit)
        if scene.has_env:
            reads.append((valid, ~hit))
            miss = ~hit & valid
        return reads + [(light, None), (ce, emitter | miss),
                        (imp, (emitter | miss) & ce)]
    if name == "nee_prep":
        _, hit, imp, li, u, weight, two_sided = ak
        kind = scene.light_kinds[li]
        ok = out[4]
        diffuse = hit.valid & (scene.bsdf_fn[hit.bsdf] == B.BSDF_DIFFUSE)
        reads = [(hit.valid, None), (hit.bsdf, hit.valid), (hit.n, diffuse),
                 (imp, ok)]
        if kind in (F.LIGHT_AREA, F.LIGHT_POINT, F.LIGHT_SPOT):
            reads.append((hit.pt, None))
        if kind in (F.LIGHT_AREA, F.LIGHT_HEMISPHERE, F.LIGHT_ENV):
            reads.append((u, None))
        return reads
    _, hit, imp, u, u_f, u_rr, fold, eps, hs = ak
    fn = scene.bsdf_fn[hit.bsdf]
    diffuse, emit = fn == B.BSDF_DIFFUSE, fn == B.BSDF_EMISSION
    # an emitter's lane takes the glass lobe's direction (the plain
    # version's last choice) with a weight of 0
    glassy = (fn == B.BSDF_GLASS) | emit
    reads = [(hit.bsdf, None), (hit.valid, None), (hit.pt, None),
             (hit.n, None), (hit.dpdu, ~diffuse if fold else None),
             (hit.dpdv, ~diffuse if fold else None), (hit.wo_local, ~diffuse),
             (hit.backface, glassy | (fn == B.BSDF_REFRACTION)),
             (u, diffuse), (u_f, glassy), (imp, ~emit)]
    if u_rr is not None:
        # where the path lives on before the roulette (importance over p
        # is above 0 where importance is)
        lives = hit.valid & ~emit & (out[2].amax(-1) > 0)
        reads.append((u_rr, lives))
    return reads


#: bytes written between timed calls so that no input is still in the
#: card's 50 MB L2 cache: the bytes bound counts each input read from
#: device memory once
L2_FLUSH_BYTES = 256 << 20


def measure_stage(name, kept):
    """A shading kernel against its plain version at run A's shapes (the
    inputs its first call met; scatter's first with roulette): kernel and
    plain ms, each call after a write of L2_FLUSH_BYTES, and the bound
    from the bytes this call must move (each input on the lanes that need
    it, ``stage_reads``, read once; each output written once, nee_prep's
    ``o`` being hit.pt itself) and SHADE_FLOPS."""
    import torch

    fk, ak, fp, ap = kept
    inputs = _tensors(ak)
    res = fk(*ak)
    out = [t for t in _tensors(res) if not any(t is x for x in inputs)]
    reads = stage_reads(name, ak, res)
    nbytes = (sum(_rows_bytes(x, lanes) for x, lanes in reads)
              + sum(_rows_bytes(t) for t in out))
    lanes = out[0].shape[0]
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=out[0].device)
    ms = cuda_time_ms(lambda: fk(*ak), 10, prep=flush.zero_)
    plain_ms = cuda_time_ms(lambda: fp(*ap), 3, prep=flush.zero_)
    b = _bound(nbytes, SHADE_FLOPS[name] * lanes)
    print(f"[shade] {name} kernel at run A's shapes ({lanes:,} lanes, "
          f"{nbytes / lanes:.1f} B a lane needed): {ms:.4f} ms, plain "
          f"{plain_ms:.3f} ms ({plain_ms / ms:.1f}x), bound "
          f"{b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
          f"{b['bytes_ms']:.5f}, ops {b['ops_ms']:.5f}): "
          f"{b['bound_ms'] / ms:.1%} of the bound [{smi_line()}]")
    return dict(ms=ms, plain_ms=plain_ms, lanes=lanes, nbytes=nbytes, **b)


def gap_reads(args, kw, out):
    """(tensor, lanes) of what a fused gap's call must read in this call's
    data (``args``, ``kw``: shade_gap_drawn's, scatter's uniforms drawn;
    ``out`` its outputs), as ``stage_reads`` counts a stage's: each
    input on the lanes whose outputs need it.  The hit record, and a
    sample it accumulates but did not store, are not inputs: the gap
    recomputes them from o, d, t, prim (one shade_packed row per prim
    hit) and the sample's uniforms."""
    import torch

    from cuda_raytracer_tpu_torch.ops import shade_stages as SS
    from cuda_raytracer_tpu_torch.render import flatscene as F
    from cuda_raytracer_tpu_torch.scene import bsdf as B

    scene, o, d, t, prim, imp, light = args
    opened, accum, sample = kw["opened"], kw["accum"], kw["sample"]
    compat, eps = kw["reference_compat"], kw["shadow_eps"]
    sampled = (F.LIGHT_AREA, F.LIGHT_HEMISPHERE, F.LIGHT_ENV)
    reads = []
    if accum is not None and accum[1].li is not None:
        _, sh, t_s, prim_s = accum
        passes = sh.ok & (t_s > sh.max_t - eps)
        reads += [(light, None), (sh.ok, None), (t_s, sh.ok),
                  (sh.max_t, sh.ok)]
        if compat:
            reads.append((prim_s, passes))
            passes = passes & (prim_s >= 0)
        return reads + [(sh.li, passes)]
    hp = SS.shade_hit_plain(scene, o, d, t, prim, None, imp, light, None,
                            kw["origin_eps"], True)[0]
    hit = prim >= 0
    rows = torch.zeros(scene.shade_packed.shape[0], dtype=torch.bool,
                       device=prim.device)
    rows[prim[hit].long()] = True
    reads += [(o, None), (d, None), (prim, None), (t, hit),
              (scene.shade_packed, rows)]
    fn = scene.bsdf_fn[hp.bsdf]
    need_imp = torch.zeros_like(hit)
    if accum is not None or (opened is not None and not compat):
        reads.append((light, None))
    if opened is not None and not compat:
        valid, ce = opened
        emitter = hit & (fn == B.BSDF_EMISSION)
        miss = torch.zeros_like(hit)
        if scene.has_env:
            reads.append((valid, ~hit))
            miss = ~hit & valid
        reads.append((ce, emitter | miss))
        need_imp |= (emitter | miss) & ce
    if accum is not None:
        nee, _, t_s, prim_s = accum
        ok = SS.nee_prep_plain(scene, hp, imp, nee.light, nee.u, nee.weight,
                               compat)[4]
        need_imp |= ok
        reads.append((t_s, ok))
        if scene.light_kinds[nee.light] in sampled:
            reads.append((nee.u, None))
        if compat:
            _, _, max_t, _, _ = SS.nee_prep_plain(
                scene, hp, imp, nee.light, nee.u, nee.weight, compat)
            reads.append((prim_s, ok & (t_s > max_t - eps)))
    if sample is not None:
        need_imp |= out[1].ok
        if scene.light_kinds[sample.light] in sampled:
            reads.append((sample.u, None))
    if kw["scatter"] is not None:
        u, u_f, u_rr, _ = kw["scatter"]
        diffuse, emit = fn == B.BSDF_DIFFUSE, fn == B.BSDF_EMISSION
        glassy = (fn == B.BSDF_GLASS) | emit
        need_imp |= ~emit
        reads += [(u, diffuse), (u_f, glassy)]
        if u_rr is not None:
            lives = hp.valid & ~emit & (out[2][2].amax(-1) > 0)
            reads.append((u_rr, lives))
    return reads + [(imp, need_imp)]


def _gap_flops(variant):
    """Float operations per lane of a gap: its stages' bodies'
    (SHADE_FLOPS; a recomputed hit costs shade_hit's, a recomputed
    sample nee_prep's)."""
    f = SHADE_FLOPS
    if variant == "close_stored":
        return f["nee_accum"]
    n = f["shade_hit"]
    n += (f["nee_prep"] + f["nee_accum"]) * (variant.startswith("step")
                                             or variant == "close_scatter")
    n += f["nee_prep"] * (variant.startswith(("open_nee", "step")))
    return n + f["scatter"] * variant.endswith("scatter")


def measure_gap(variant, kept):
    """A fused gap's kernel at the shapes its first call met (run A's
    where run A has the variant; ``kept``: (arguments, keywords,
    keywords with scatter's uniforms drawn)): kernel ms, the stage
    kernels chained on the same inputs and uniforms (``gap_by_stages``:
    the launches the gap replaces) and the plain chain (its draws
    included), each call after a write of L2_FLUSH_BYTES; the bound
    from the bytes the call must move (``gap_reads`` once, each output
    written once) and the bytes the kernel moves (every lane of each
    input it loads)."""
    import torch

    from cuda_raytracer_tpu_torch.ops import shade_stages as SS

    args, kw, drawn = kept
    res = SS.shade_gap_drawn(*args, **drawn)
    inputs = _tensors((args, drawn))
    out = [x for x in _tensors(res) if not any(x is y for y in inputs)]
    reads = gap_reads(args, drawn, res)
    written = sum(_rows_bytes(x) for x in out)
    need = sum(_rows_bytes(x, lanes) for x, lanes in reads) + written
    moved = sum(_rows_bytes(x) for x, _ in reads) + written
    lanes = args[3].shape[0]
    _, u_f, u_rr, _ = drawn["scatter"] or (None,) * 4

    def scatter_drawn(scene, hit, imp, keys, u, fold, rr_key, eps, hs):
        return SS.scatter_drawn(scene, hit, imp, drawn["scatter"][0], u_f,
                                u_rr, fold, eps, hs)

    kernels = (SS.shade_hit_cuda, SS.nee_prep_cuda, SS.nee_accum_cuda,
               scatter_drawn)
    plain = (SS.shade_hit_plain, SS.nee_prep_plain, SS.nee_accum_plain,
             SS.scatter_plain)
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8,
                        device=args[3].device)
    ms = cuda_time_ms(lambda: SS.shade_gap_drawn(*args, **drawn), 10,
                      prep=flush.zero_)
    stages_ms = cuda_time_ms(lambda: SS.gap_by_stages(kernels, *args, **kw),
                             10, prep=flush.zero_)
    plain_ms = cuda_time_ms(lambda: SS.gap_by_stages(plain, *args, **kw), 3,
                            prep=flush.zero_)
    b = _bound(need, _gap_flops(variant) * lanes)
    print(f"[shade] gap {variant} kernel ({lanes:,} lanes; {need / lanes:.1f}"
          f" B a lane needed, {moved / lanes:.1f} B moved): {ms:.4f} ms "
          f"({moved / ms / 1e9:.3f} TB/s moved), the stage kernels' chain "
          f"{stages_ms:.4f} ms, plain {plain_ms:.3f} ms ({plain_ms / ms:.1f}x)"
          f", bound {b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
          f"{b['bytes_ms']:.5f}, ops {b['ops_ms']:.5f}): "
          f"{b['bound_ms'] / ms:.1%} of the bound [{smi_line()}]")
    return dict(ms=ms, plain_ms=plain_ms, stages_ms=stages_ms, lanes=lanes,
                nbytes=need, moved=moved, **b)


def _run_k_setting(label, kind, frames, docs, sky, n):
    """One run-K setting, graphed: frames shaded by the kernels and frames
    shaded by the plain stages, each renderer made and driven under its
    stages; launches as the schedule gives (no shading kernel in the
    plain twins); the kernel frames within the card-vs-CPU gate of the
    plain ones, frame by frame; then one frame each in turns (kernel,
    plain, plain, kernel) and a profiled frame each."""
    import gc

    import numpy as np
    import torch

    runs, rs, launches = {}, {}, {}
    for plain in (False, True):
        with _plain_stages() if plain else contextlib.nullcontext():
            r = _run_i_make(kind, True, docs, sky, n)
            reset_launches()
            runs[plain] = _run_i_frames(r, frames)
            launches[plain] = read_launches()
        want = _run_i_want(r, frames)
        if plain:
            want.update(dict.fromkeys(SHADING, 0))
        check(launches[plain] == want, f"run K {label} "
              f"({'plain' if plain else 'kernel'} stages): launches "
              f"{launches[plain]} != the schedule's {want}")
        check(all(x["dropped"] == 0 for x in runs[plain]),
              f"run K {label}: dropped rays")
        rs[plain] = r
    gate = []
    for f in range(frames):
        a, b = runs[False][f]["raw"], runs[True][f]["raw"]
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        gate.append((1.0 - float(bad.mean()),
                     float(np.abs(a - b).max()),
                     bool(np.array_equal(a, b))))
        check(float(bad.mean()) <= MAX_BAD, f"run K {label}: frame {f} "
              f"shaded by the kernels differs from the plain stages' in "
              f"{int(bad.sum())} pixels")
    turns, busy = {False: [], True: []}, {}
    for plain in (False, True, True, False):
        with _plain_stages() if plain else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs[plain].render()
            torch.cuda.synchronize()
        turns[plain].append((time.perf_counter() - t0) * 1e3)
    for plain in (False, True):
        with _plain_stages() if plain else contextlib.nullcontext():
            busy[plain] = _device_busy(rs[plain].render, min(turns[plain]))
    per_frame = {k: launches[False][k] // frames for k in SHADING
                 if launches[False][k]}
    print(f"[run K] {label}: {frames} graphed frames (the last after a "
          f"camera move) shaded by the kernels against the plain stages: "
          f"pixels within rtol={PIXEL_RTOL} atol={PIXEL_ATOL} "
          f"{[f'{g[0]:.5f}' for g in gate]}, max |diff| "
          f"{[f'{g[1]:.3g}' for g in gate]}, bit-equal {[g[2] for g in gate]};"
          f" dropped 0; shading launches per frame {per_frame} (the plain "
          f"twins' 0); in turns kernel {turns[False][0]:.2f}, plain "
          f"{turns[True][0]:.2f}, plain {turns[True][1]:.2f}, kernel "
          f"{turns[False][1]:.2f} ms; profiled frame kernel stages "
          f"{busy[False][0]:.1f} ms of kernels in {busy[False][2]} device "
          f"launches, busy {busy[False][1]:.3f}; plain stages "
          f"{busy[True][0]:.1f} ms in {busy[True][2]}, busy "
          f"{busy[True][1]:.3f} [{smi_line()}]")
    res = dict(label=label, turns=turns, busy=busy, gate=gate,
               launches=launches[False])
    del rs, r
    gc.collect()
    torch.cuda.empty_cache()
    return res


def _print_shade_log(log):
    """Phase 14's comparisons, one line per (stage, branch), and the
    check that every lane off lies near a threshold."""
    for (stage, branch), e in sorted(log.items()):
        print(f"[shade] {stage} ({branch}): {e['calls']} call(s), "
              f"{e['lanes']:,} lanes; max abs err {e['err']:.3g}, max "
              f"rel err {e['rel']:.3g} (rtol={STAGE_RTOL}, "
              f"atol={STAGE_ATOL}); lanes off {e['off']} (by field "
              f"{e['flips']}), all near a threshold: {e['far'] == 0} "
              f"({e['near']:,} such lanes); importance held to a "
              f"tolerance from its conditioning on {e['wide']:,} lanes, "
              f"{e['used']} of them beyond rtol={STAGE_RTOL}"
              + (f"; calls not bit-equal {e['unequal']}" if "unequal" in e
                 else ""))
    for (stage, branch), e in log.items():
        check(e["far"] == 0, f"{stage} ({branch}): {e['far']} lanes "
              f"differ from the {'stage kernels' if '=' in stage else 'plain version'}"
              f" away from any threshold")
        check(e.get("unequal", 0) == 0, f"{stage} ({branch}): "
              f"{e.get('unequal')} calls not bit-equal to the stage kernels")


def phase_shade(n=121, frames=2):
    """Phase 14 (run K): the shading kernels (ops/csrc/shade.cu).  What
    ptxas says of them; every call of every stage in eight eager frames
    (_shade_branch_settings: the fast and default presets, mirror, glass
    and refraction, cosine and two-sided, all six light kinds, depths
    with no NEE sample) shaded stage by stage, held against its plain
    version on the same inputs, every branch of SHADE_BRANCHES and every
    lobe reached; then the same frames shaded by the fused chain, every
    gap held against the plain chain and, to the bit, the stage kernels
    chained (_probe_chain), every part of CHAIN_BRANCHES reached; each
    stage kernel timed against its bound and its plain version at run
    A's shapes, each gap variant at its first call's (run A's where it
    has it) against its bound, the stage kernels' chain and the plain
    chain; then RUN_K's frames, graphed, shaded by the fused chain and by
    the plain stages in one process (_run_k_setting).  Returns the JSON
    rows of the four stage kernels and of the eight gap variants."""
    import gc
    import tempfile

    import torch

    from cuda_raytracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for line in _build.ptxas_report("shade"):
        print(f"[shade] ptxas, shade.cu: {line}")
    sky = sky_map()
    log, kept, lobes = {}, {}, set()
    chain_log, chain_kept = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        docs = {}
        for lights in (("area",), ("area", "directional"), ()):
            docs[lights] = os.path.join(tmp, f"run_k_{len(lights)}.dae")
            with open(docs[lights], "w") as f:
                f.write(run_c_document(n, lights))
        settings = _shade_branch_settings(docs, sky, n)
        for chain in (False, True):
            for i, (label, make) in enumerate(settings):
                r = make()
                with (_probe_chain(chain_log, chain_kept, plain_hit=False)
                      if chain else
                      _probe_stages(log, kept if i == 0 else None, lobes)):
                    r.render()
                check(r.dropped == 0, f"phase 14 {label}: dropped rays")
                del r
                gc.collect()
                torch.cuda.empty_cache()
        t_probe = time.perf_counter() - t0
        _print_shade_log(log)
        _print_shade_log(chain_log)
        for stage, want in SHADE_BRANCHES.items():
            got = {b for s, b in log if s == stage}
            check(want <= got, f"phase 14: {stage} never ran "
                  f"{sorted(want - got)}")
        check(SHADE_LOBES <= lobes, f"phase 14: scatter never met lobes "
              f"{sorted(SHADE_LOBES - lobes)}")
        met = {p for _, b in chain_log for p in b.split("; ")}
        check(CHAIN_BRANCHES <= met, f"phase 14: the fused chain never met "
              f"{sorted(CHAIN_BRANCHES - met)}")
        print(f"[shade] every branch reached ({sum(e['calls'] for e in log.values())} "
              f"stage calls, {sum(e['calls'] for (s, _), e in chain_log.items() if s == 'gap')}"
              f" gap calls), scatter's lobes {sorted(lobes)}; probe frames "
              f"{t_probe:.1f} s")
        measured = {k: measure_stage(k, kept[k]) for k in SHADE_KERNELS}
        gaps = {g: measure_gap(g, chain_kept[g]) for g in GAP_VARIANTS}
        kept.clear()
        chain_kept.clear()
        gc.collect()
        torch.cuda.empty_cache()
        results = [_run_k_setting(label, kind, frames, docs, sky, n)
                   for label, kind in RUN_K]
    run_a = results[0]
    want = stage_launches(fast_config(), 1)
    got = {k: run_a["launches"][k] // frames for k in SHADING}
    check(got == want, f"run K: run A's shading launches a frame {got}, "
          f"the fused schedule's {want}")
    print(f"[shade] phase 14 took {time.perf_counter() - t0:.1f} s")
    rows = []
    for k in SHADE_KERNELS:
        err = max(e["err"] for (s, _), e in log.items() if s == k)
        rows.append(dict(kernel_row(k, "shade.cu", "",
                                    run_a["launches"][k], measured[k], err),
                         replaces=SHADE_KERNELS[k]))
    err = max(e["err"] for (s, _), e in chain_log.items() if s == "gap")
    for g in GAP_VARIANTS:
        rows.append(dict(kernel_row(f"gap_{g}", "shade.cu", "",
                                    run_a["launches"][f"gap_{g}"], gaps[g],
                                    err),
                         replaces="the stage kernels it chains",
                         stages_ms=gaps[g]["stages_ms"]))
    return rows


# ---------------------------------------------------------------------------
# phase 15 (run L): the camera rays' and the film's kernels (raygen.cu,
# film.cu)
# ---------------------------------------------------------------------------

#: the kernels at the two ends of a frame: name -> (source, the JAX code
#: whose XLA fusion it replaces; not a pallas_call)
END_KERNELS = {
    "raygen": ("raygen.cu", "cuda_raytracer_tpu/ops/shade.py:139"),
    "film": ("film.cu", "cuda_raytracer_tpu/ops/filters.py:13"),
    "median3x3": ("film.cu", "cuda_raytracer_tpu/ops/filters.py:42"),
}
#: float operations per lane of raygen_kernel's pinhole branch, counted
#: from raygen.cu: the pixel's 2 conversions, x's add and division, y's
#: two adds and division, sx and sy (2 products, a difference each), the
#: three c2w rows (2 products, 2 sums each), the sum of squares (5), its
#: clamp and sqrt, three divisions
RAYGEN_FLOPS = 2 + 2 + 3 + 6 + 12 + 5 + 2 + 3
#: raygen's setting whose divisors are none of them powers of two (W, H,
#: spp): 39 tile columns of 32, a 30-row partial tile row, 5 spp
ODD_RAYGEN = (1248, 702, 5)
#: the median's synthetic image (H, W, seed): run A's size, with NaN (two
#: payloads), +-0, +-inf and runs of equal values (``tie_image``)
TIE_IMAGE = (HEIGHT, WIDTH, 15)
#: run L: the settings whose frames run on the kernels, eager and graphed,
#: and on the plain routes, graphed (label, how the renderer is made,
#: ``_run_i_make``)
RUN_L = (
    ("run A", "run_a"),
    ("run G default pass", "run_g"),
    ("run G --reference-compat --camera-mode cutracer", "cutracer"),
    ("run F, 4 shards of the card", "shards"),
)


@contextlib.contextmanager
def _plain_ends():
    """A context in which raygen and the film are their plain versions
    (torch ops on the card; raygen's draw an rng.uniform launch): a
    frame's twin without the kernels.  The package has no such switch;
    only this script swaps."""
    from cuda_raytracer_tpu_torch.ops import filters as F
    from cuda_raytracer_tpu_torch.ops import shade as S

    kept = [(m, n, getattr(m, n)) for m, n in (
        (S, "generate_camera_rays"), (S, "generate_camera_rays_cutracer"),
        (F, "reconstruct"), (F, "accumulate"), (F, "film"),
        (F, "median_filter_3x3"))]
    for m, n, _ in kept:
        setattr(m, n, getattr(m, f"{n}_plain"))
    try:
        yield
    finally:
        for m, n, fn in kept:
            setattr(m, n, fn)


def _timed_pair(kernel, plain, nbytes, flops=0, int_ops=0, library=None):
    """ms of kernel() (10 calls) and plain() (3) and library() (3, where
    given), each after a write of L2_FLUSH_BYTES, and the bound."""
    import torch

    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    ms = cuda_time_ms(kernel, 10, prep=flush.zero_)
    plain_ms = cuda_time_ms(plain, 3, prep=flush.zero_)
    lib_ms = (None if library is None
              else cuda_time_ms(library, 3, prep=flush.zero_))
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                **_bound(nbytes, flops, int_ops=int_ops))


def _line(b):
    return (f"{b['ms']:.4f} ms, plain {b['plain_ms']:.3f} ms "
            f"({b['plain_ms'] / b['ms']:.1f}x)"
            + ("" if b["library_ms"] is None
               else f", library {b['library_ms']:.4f} ms")
            + f", bound {b['bound_ms']:.5f} ms by {b['bound_by']} (bytes "
            f"{b['bytes_ms']:.5f}, ops {b['ops_ms']:.5f}): "
            f"{b['bound_ms'] / b['ms']:.1%} of the bound")


def measure_raygen(label, cutracer, args, kw, timed=False):
    """raygen's kernel against its plain version on the card, under
    RNG_KEY (a KeyTable key for the kernel, the int key for the plain
    version): d within STAGE_RTOL / STAGE_ATOL on every lane, o the same
    stride-0 expand; kernel, plain and bound times where ``timed``.
    ``args``/``kw``: the function's arguments after the key."""
    import numpy as np
    import torch

    from cuda_raytracer_tpu_torch import rng
    from cuda_raytracer_tpu_torch.ops import shade as S

    dev = torch.device(DEVICE)
    name = "generate_camera_rays" + ("_cutracer" if cutracer else "")
    fk, fp = getattr(S, f"{name}_cuda"), getattr(S, f"{name}_plain")
    # the camera on the card, as the fused frame holds it: no copy from
    # the host inside a timed call
    args = tuple(torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                 device=dev)
                 if isinstance(a, np.ndarray) else a for a in args)
    table = rng.KeyTable(["k"], dev)
    table.load({"k": RNG_KEY})
    o, d = fk(table["k"], *args, device=dev, **kw)
    o2, d2 = fp(RNG_KEY, *args, device=dev, **kw)
    torch.cuda.synchronize()
    n = d.shape[0]
    bad = int((~torch.isclose(d, d2, rtol=STAGE_RTOL, atol=STAGE_ATOL))
              .any(-1).sum())
    err = float((d - d2).abs().max())
    same_o = torch.equal(o, o2) and o.stride(0) == 0
    res = dict(max_abs_err=err, lanes=n)
    desc = ""
    if timed:
        res.update(_timed_pair(
            lambda: fk(table["k"], *args, device=dev, **kw),
            lambda: fp(RNG_KEY, *args, device=dev, **kw), 12 * n,
            RAYGEN_FLOPS * n, 2 * RNG_INT_OPS * n))
        desc = "; kernel " + _line(res)
    print(f"[raygen] {label}: {n:,} lanes, d within rtol={STAGE_RTOL} "
          f"atol={STAGE_ATOL} of the plain version on all but {bad} lanes, "
          f"max abs err {err:.3g}; o the camera's stride-0 expand, equal "
          f"{same_o}{desc} [{smi_line()}]")
    check(bad == 0, f"raygen {label}: {bad} lanes of d differ from the "
          f"plain version")
    check(same_o, f"raygen {label}: o is not the camera's expand")
    return res


def _raygen_cases(rs):
    """measure_raygen on the cameras of run L's renderers: run A's
    (tiles32s, timed), its tiles8 order, run G's raster reference pass,
    the cutracer basis of run C's document, a tiles shard of run F (the
    last slab of 150 rows at row_offset 450 of 600, tiles32s: a partial
    tile row of 22), and run A's camera at ODD_RAYGEN (timed)."""
    out = {}
    a = rs["run A"]
    cfg = a.config
    cam = (a.camera.pos, a.camera.c2w, *a._tan_half())
    out["run A"] = measure_raygen(
        "run A (tiles32s)", False, (WIDTH, HEIGHT, cfg.samples_per_frame,
                                    *cam), dict(pix_order="tiles32s"),
        timed=True)
    measure_raygen("run A's camera, tiles8", False,
                   (WIDTH, HEIGHT, cfg.samples_per_frame, *cam),
                   dict(pix_order="tiles8"))
    g = rs["run G default pass"]
    measure_raygen("run G's reference pass (raster)", False,
                   (WIDTH, HEIGHT, g.config.samples_per_frame,
                    g.camera.pos, g.camera.c2w, *g._tan_half()),
                   dict(pix_order=None), timed=True)
    c = rs["run G --reference-compat --camera-mode cutracer"]
    measure_raygen("cutracer camera of run C's document", True,
                   (WIDTH, HEIGHT, c.config.samples_per_frame,
                    *c._cutracer_arrays()), dict(pix_order=None))
    rows = HEIGHT // 4
    measure_raygen("run F tiles shard (rows 450-599, tiles32s)", False,
                   (WIDTH, rows, cfg.samples_per_frame, *cam),
                   dict(pix_order="tiles32s", row_offset=3 * rows,
                        full_height=HEIGHT))
    w, h, spp = ODD_RAYGEN
    measure_raygen(f"run A's camera at {w}x{h}, {spp} spp (tiles32s: "
                   f"{w // 32} tile columns, a {h % 32}-row partial tile row)",
                   False, (w, h, spp, *cam), dict(pix_order="tiles32s"),
                   timed=True)
    return out


def measure_film(label, r, kept):
    """The film kernel against its plain version on the card, on the
    inputs a frame's film met (``kept``: light, final_img, image_samples;
    the last call with samples already accumulated): one launch of
    reconstruct + accumulate within STAGE_RTOL / STAGE_ATOL (with the
    sample count as a 0-d device tensor and as a float), reconstruct and
    accumulate alone (the sharded renderer's calls), and the median in
    both modes bit-equal to the plain median of the same image; kernel,
    plain, library and bound times of both kernels."""
    import torch

    from cuda_raytracer_tpu_torch.ops import filters as F

    light, final_img, old = kept
    cfg = r.config
    w, h, spp = cfg.width, cfg.height, cfg.samples_per_frame
    inv, major = r._inv_order, cfg.sample_order == "tiles32s"
    old_t = torch.tensor(float(old), dtype=torch.float32, device=DEVICE)
    args = (w, h, spp, inv, major)
    want = F.film_plain(light, final_img, old_t, float(spp), *args)
    errs, bad = [], 0
    for o in (old_t, float(old)):
        got = F.film_cuda(light, final_img, o, float(spp), *args)
        bad += int((~torch.isclose(got, want, rtol=STAGE_RTOL,
                                   atol=STAGE_ATOL)).sum())
        errs.append(float((got - want).abs().max()))
    img_k = F.reconstruct_cuda(light, *args)
    img_p = F.reconstruct_plain(light, *args)
    acc_k = F.accumulate_cuda(final_img, img_p, old_t, float(spp))
    acc_p = F.accumulate_plain(final_img, img_p, old_t, float(spp))
    for k, p in ((img_k, img_p), (acc_k, acc_p)):
        bad += int((~torch.isclose(k, p, rtol=STAGE_RTOL,
                                   atol=STAGE_ATOL)).sum())
        errs.append(float((k - p).abs().max()))
    med_same = {}
    for compat in (False, True):
        mk = F.median_filter_3x3_cuda(want, compat)
        mp = F.median_filter_3x3_plain(want, compat)
        med_same[compat] = torch.equal(mk.view(torch.int32),
                                       mp.view(torch.int32))
    torch.cuda.synchronize()
    view = ((spp, -1, 3), 0) if major else ((-1, spp, 3), 1)
    film_b = _timed_pair(
        lambda: F.film_cuda(light, final_img, old_t, float(spp), *args),
        lambda: F.film_plain(light, final_img, old_t, float(spp), *args),
        _nbytes(light, final_img, want)
        + (0 if inv is None else _nbytes(inv)))
    # no PyTorch call computes the film; torch's mean alone is the
    # reconstruct without inv_order or the accumulate: a partial yardstick
    flush = torch.empty(L2_FLUSH_BYTES, dtype=torch.uint8, device=DEVICE)
    mean_ms = cuda_time_ms(lambda: light.view(*view[0]).mean(view[1]), 3,
                           prep=flush.zero_)
    del flush
    compat = cfg.reference_compat
    med_b = _timed_pair(lambda: F.median_filter_3x3_cuda(want, compat),
                        lambda: F.median_filter_3x3_plain(want, compat),
                        2 * _nbytes(want))
    print(f"[film] {label}: {w}x{h}, {spp} spp "
          f"({'sample' if major else 'pixel'}-major, inv_order "
          f"{inv is not None}), old weight {float(old)}: film (reconstruct "
          f"+ accumulate, the weight on the device and by value), "
          f"reconstruct and accumulate alone within rtol={STAGE_RTOL} "
          f"atol={STAGE_ATOL} of the plain versions on all but {bad} "
          f"values, max abs err {max(errs):.3g}; median bit-equal to the "
          f"plain median (default, compat) {med_same}; film kernel "
          f"{_line(film_b)}; torch mean alone (not the same function: no "
          f"inv_order, no accumulate) {mean_ms:.4f} ms; median "
          f"({'compat' if compat else 'default'}) {_line(med_b)} "
          f"[{smi_line()}]")
    check(bad == 0, f"film {label}: {bad} values differ from the plain "
          f"versions")
    check(all(med_same.values()), f"film {label}: the median kernel's bits "
          f"differ from the plain median's ({med_same})")
    return dict(film=dict(film_b, max_abs_err=max(errs)),
                median3x3=dict(med_b, max_abs_err=0.0))


def tie_image(h, w, seed):
    """An [h, w, 3] float32 image with NaN (two payloads, one of them
    negative), +-0, infinities and runs of equal values."""
    import numpy as np

    g = np.random.default_rng(seed)
    img = g.integers(-3, 4, (h, w, 3)).astype(np.float32) * 0.5
    img[g.random((h, w, 3)) < 0.15] = -0.0
    img[g.random((h, w, 3)) < 0.1] = np.nan
    img[g.random((h, w, 3)) < 0.03] = -np.inf
    img[g.random((h, w, 3)) < 0.03] = np.inf
    bits = img.view(np.uint32)
    nan = np.isnan(img)
    bits[nan & (g.random((h, w, 3)) < 0.5)] = 0xFFC00001
    return img


def _float_order(x):
    """median3x3_kernel's key of each float of ``x`` as int64: -0 as +0,
    every NaN last."""
    import torch

    b = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    b = torch.where(x == 0, torch.zeros_like(b), b)
    key = torch.where(b >= 1 << 31, 0xFFFFFFFF - b, b | (1 << 31))
    return torch.where(torch.isnan(x), torch.full_like(b, 0xFFFFFFFF), key)


def measure_median_ties():
    """The median kernel on TIE_IMAGE in both modes: bit-equal to the
    plain version run on the CPU (torch.sort there keeps equal keys in
    index order, as jnp.sort does), and against the plain version on the
    card, whose torch.sort of 9 keys need not be stable: the values where
    the two differ in bits, which must tie in the sort (the same key: +-0,
    or NaN payloads); times beside the bound and the plain version."""
    import torch

    from cuda_raytracer_tpu_torch.ops import filters as F

    h, w, seed = TIE_IMAGE
    img = torch.as_tensor(tie_image(h, w, seed), device=DEVICE)
    for compat in (False, True):
        mk = F.median_filter_3x3_cuda(img, compat)
        mp = F.median_filter_3x3_plain(img, compat)
        mc = F.median_filter_3x3_plain(img.cpu(), compat)
        torch.cuda.synchronize()
        same_cpu = torch.equal(mk.cpu().view(torch.int32),
                               mc.view(torch.int32))
        n_differ = int((mk.view(torch.int32) != mp.view(torch.int32)).sum())
        ties = bool(torch.equal(_float_order(mk), _float_order(mp)))
        b = _timed_pair(lambda: F.median_filter_3x3_cuda(img, compat),
                        lambda: F.median_filter_3x3_plain(img, compat),
                        2 * _nbytes(img))
        mode = "compat" if compat else "default"
        print(f"[median] {w}x{h} with NaN (two payloads), +-0, +-inf and "
              f"ties, {mode}: bit-equal to the plain version on the CPU "
              f"{same_cpu}; against the plain version on the card "
              f"{n_differ} values differ in bits, all of them ties of the "
              f"sort {ties}; kernel {_line(b)} [{smi_line()}]")
        check(same_cpu, f"median {mode}: the kernel's bits differ from the "
              f"plain version's on the CPU")
        check(ties, f"median {mode}: the kernel and the plain version on "
              f"the card pick values of different keys")


def _run_l_setting(label, kind, frames, docs, sky, n):
    """One run-L setting: frames on the kernels, eager and graphed, and on
    the plain routes (_plain_ends), graphed, each renderer made and driven
    under its routes; launches as the schedule gives (the plain twins: no
    raygen, film or median launch, and raygen's draw through the uniform
    kernel); eager and graphed kernel frames bit-equal, the last after a
    camera move; kernel frames within the card-vs-CPU gate of plain ones;
    then one graphed frame each in turns (kernel, plain, plain, kernel)
    and a profiled frame each.  Returns the renderers, the times and the
    eager renderer's film inputs (the last call with samples already
    accumulated)."""
    import numpy as np
    import torch

    runs, rs, launches, kept = {}, {}, {}, []
    for graphed, plain in ((False, False), (True, False), (True, True)):
        with _plain_ends() if plain else contextlib.nullcontext():
            r = _run_i_make(kind, graphed, docs, sky, n)
            if not (graphed or plain or hasattr(r, "mesh")):
                film = r._film

                def keep(light, with_median, final_img, samples, _f=film):
                    if float(samples) > 0 or not kept:
                        kept[:] = [(light, final_img, samples)]
                    return _f(light, with_median, final_img, samples)

                r._film = keep
            reset_launches()
            runs[graphed, plain] = _run_i_frames(r, frames)
            launches[graphed, plain] = read_launches()
        want = _run_i_want(r, frames)
        if plain:
            want["rng_uniform"] += want["raygen"]
            want.update(dict.fromkeys(END_KERNELS, 0))
        check(launches[graphed, plain] == want, f"run L {label} "
              f"({'graphed' if graphed else 'eager'}, "
              f"{'plain' if plain else 'kernel'} ends): launches "
              f"{launches[graphed, plain]} != the schedule's {want}")
        check(all(x["dropped"] == 0 for x in runs[graphed, plain]),
              f"run L {label}: dropped rays")
        rs[graphed, plain] = r
    eager, graphed = runs[False, False], runs[True, False]
    same = [bool(np.array_equal(a["raw"], b["raw"])
                 and np.array_equal(a["img"], b["img"]))
            for a, b in zip(eager, graphed)]
    check(all(same), f"run L {label}: graphed frames differ from the eager "
          f"ones {same}")
    gate = []
    for f in range(frames):
        a, b = graphed[f]["raw"], runs[True, True][f]["raw"]
        bad = ~np.isclose(a, b, rtol=PIXEL_RTOL, atol=PIXEL_ATOL).all(-1)
        gate.append((1.0 - float(bad.mean()), float(np.abs(a - b).max())))
        check(float(bad.mean()) <= MAX_BAD, f"run L {label}: frame {f} on "
              f"the kernels differs from the plain routes' in "
              f"{int(bad.sum())} pixels")
    turns, busy = {False: [], True: []}, {}
    for plain in (False, True, True, False):
        with _plain_ends() if plain else contextlib.nullcontext():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            rs[True, plain].render()
            torch.cuda.synchronize()
        turns[plain].append((time.perf_counter() - t0) * 1e3)
    for plain in (False, True):
        with _plain_ends() if plain else contextlib.nullcontext():
            busy[plain] = _device_busy(rs[True, plain].render,
                                       min(turns[plain]))
    per_frame = {k: launches[True, False][k] for k in END_KERNELS}
    print(f"[run L] {label}: {frames} frames (the last after a camera "
          f"move), eager and graphed bit-equal {same}; on the kernels "
          f"against the plain routes: pixels within rtol={PIXEL_RTOL} "
          f"atol={PIXEL_ATOL} {[f'{g[0]:.5f}' for g in gate]}, max |diff| "
          f"{[f'{g[1]:.3g}' for g in gate]}; dropped 0; launches of "
          f"{frames} frames {per_frame} (the plain twins' 0, and one more "
          f"uniform launch for each raygen); graphed in turns kernel "
          f"{turns[False][0]:.2f}, plain {turns[True][0]:.2f}, plain "
          f"{turns[True][1]:.2f}, kernel {turns[False][1]:.2f} ms; profiled "
          f"frame kernels {busy[False][0]:.2f} ms of kernels in "
          f"{busy[False][2]} device launches, busy {busy[False][1]:.3f}; "
          f"plain {busy[True][0]:.2f} ms in {busy[True][2]}, busy "
          f"{busy[True][1]:.3f} [{smi_line()}]")
    return dict(r=rs[False, False], launches=launches[True, False],
                turns=turns, busy=busy, kept=kept)


def phase_raygen_film(n=121, frames=3):
    """Phase 15 (run L): the camera rays' and the film's kernels
    (ops/csrc/raygen.cu, film.cu).  What ptxas says of them; RUN_L's
    frames on the kernels, eager and graphed, and on the plain routes
    (_run_l_setting); raygen against its plain version at six settings
    (_raygen_cases), the film and median on the frames' own inputs
    (measure_film) and the median on TIE_IMAGE (measure_median_ties),
    each timed beside its bound.  Returns the three kernels' JSON rows."""
    import gc
    import tempfile

    import torch

    from cuda_raytracer_tpu_torch.ops import _build

    t0 = time.perf_counter()
    for name in ("raygen", "film"):
        for line in _build.ptxas_report(name):
            print(f"[run L] ptxas, {name}.cu: {line}")
    res = {}
    with tempfile.TemporaryDirectory() as tmp:
        docs = {}
        for lights in (("area",), ("area", "directional"), ()):
            docs[lights] = os.path.join(tmp, f"run_l_{len(lights)}.dae")
            with open(docs[lights], "w") as f:
                f.write(run_c_document(n, lights))
        for label, kind in RUN_L:
            res[label] = _run_l_setting(label, kind, frames, docs, None, n)
            gc.collect()
            torch.cuda.empty_cache()
    rs = {k: v["r"] for k, v in res.items()}
    measured = _raygen_cases(rs)
    films = {}
    for label in ("run A", "run G default pass",
                  "run G --reference-compat --camera-mode cutracer"):
        films[label] = measure_film(label, rs[label], res[label]["kept"][0])
    measure_median_ties()
    run_a = res["run A"]
    check(all(run_a["launches"][k] > 0 for k in END_KERNELS),
          f"run L: run A never launched a kernel of its ends "
          f"{run_a['launches']}")
    print(f"[run L] phase 15 took {time.perf_counter() - t0:.1f} s")
    rows = []
    for k, (source, replaces) in END_KERNELS.items():
        m = measured["run A"] if k == "raygen" else films["run A"][k]
        rows.append(dict(kernel_row(k, source, "", run_a["launches"][k], m,
                                    m["max_abs_err"]), replaces=replaces))
    del res, rs
    gc.collect()
    torch.cuda.empty_cache()
    return rows


def main() -> int:
    t_start = time.perf_counter()
    if not os.path.isdir(os.path.join(HERE, "cuda_raytracer_tpu_torch")):
        fail("run from a checkout of the repository (package missing)")
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, HERE)

    phase_setup()
    err = phase_kernel(DEVICE)
    kernels = phase_slice()
    kernels[0]["max_abs_err"] = max(err, kernels[0]["max_abs_err"])
    phase_cpu_vs_cuda()
    phase_run_c()
    phase_run_d()
    part, part_launches, rows_e = phase_run_e()
    phase_run_f()
    row_dyn = phase_dyn_alloc()
    row_w2 = phase_run_g()
    rows_h = phase_run_h()
    phase_run_i()
    row_rng = phase_rng()
    rows_shade = phase_shade()
    rows_ends = phase_raygen_film()
    row_tally = phase_dragon()
    # the payload partition's row: its launches and times on the path that
    # runs it, whole-depth compaction (the shipped preset launches it 0
    # times)
    for k in kernels:
        if k["name"] == "partition":
            k.update(launches=part_launches, ms=part["ms"],
                     plain_ms=part["plain_ms"], bound_ms=part["bound_ms"],
                     bound_by=part["bound_by"],
                     max_abs_err=part["max_abs_err"],
                     library_ms=part["library_ms"])
    kernels += rows_e
    kernels.append(row_dyn)
    kernels.append(row_w2)
    kernels += rows_h
    kernels.append(row_rng)
    kernels += rows_shade
    kernels += rows_ends
    kernels.append(row_tally)
    print(f"[total] {time.perf_counter() - t_start:.1f} s from the start of "
          f"main, imports of torch and the port included")

    print(json.dumps({"kernels": kernels}))
    print(smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
