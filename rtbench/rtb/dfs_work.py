"""The DFS kernel's work and its roofline bound, from the port's tally.

The port's ``dfs_kernel`` (ops/csrc/packet_dfs.cu) adds the work of each
launch into a device tally, which ``utils/timing.counters()`` reads back
as the counts over the frames rendered after the profiled span (a
profiled frame never counts: the tally walks the rays a second time),
with the number of those ``frames``: rays that traverse, node visits,
box tests, triangle and sphere tests, lanes, lanes with a start bound,
launches and the table bytes the launches were given.  The bound is the
least time the H100 could take for that work: the larger of its
operations at the float32 peak and its bytes at the HBM peak."""

from __future__ import annotations

from typing import Dict, Optional

#: NVIDIA H100 SXM data sheet: HBM3 bytes/s, and float32 FLOP/s outside
#: the tensor cores (the kernel's arithmetic is f32, no matrix product)
HBM_BPS = 3.35e12
F32_FLOPS = 67e12
#: float operations the traversal needs, counted from the port's leaf
#: test (ops/intersect.py packed_prim_test, whose triangle and sphere
#: halves the kernel runs apart) and its slab test (adds, products,
#: divisions, sqrt, min/max, compares): per non-empty child box, per
#: triangle test, per sphere test, and per lane the three reciprocals of
#: d (chip_smoke.py BOX_FLOPS, TRI_FLOPS, SPH_FLOPS, RAY_FLOPS)
BOX_FLOPS = 25
TRI_FLOPS = 38
SPH_FLOPS = 37
LANE_FLOPS = 3
#: bytes per lane read once (o and d as float32 [3] each, valid as one
#: bool; a start bound, float32, on the lanes of launches that pass one)
#: and written once (t float32, prim int32), and per launch the dropped
#: count (int64): the kernel's arguments, ops/packet_dfs.py
#: dfs_trace_cuda
LANE_IN_BYTES = 12 + 12 + 1
START_BYTES = 4
LANE_OUT_BYTES = 4 + 4
LAUNCH_BYTES = 8


def counts() -> Optional[Dict[str, int]]:
    """The port's DFS tally over the frames after the profiled span, or
    None where the port keeps none (or counted nothing)."""
    from cuda_raytracer_tpu_torch.utils import timing

    read = getattr(timing, "counters", None)
    if read is None:
        return None
    c = read().get("dfs")
    return c if c and c.get("launches") and c.get("frames") else None


def operations(c: Dict[str, int]) -> int:
    """Float operations of the counted work."""
    return (c["boxes"] * BOX_FLOPS + c["tris"] * TRI_FLOPS
            + c["spheres"] * SPH_FLOPS + c["lanes"] * LANE_FLOPS)


def nbytes(c: Dict[str, int]) -> int:
    """Bytes of the counted launches: each input read once, each output
    written once, the tables read once per launch."""
    return (c["lanes"] * (LANE_IN_BYTES + LANE_OUT_BYTES)
            + c["start_lanes"] * START_BYTES
            + c["launches"] * LAUNCH_BYTES + c["table_bytes"])


def bound_s(c: Dict[str, int]) -> float:
    """The least seconds the card could take for the counted work."""
    return max(operations(c) / F32_FLOPS, nbytes(c) / HBM_BPS)
