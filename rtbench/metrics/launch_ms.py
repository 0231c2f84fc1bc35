"""Host ms per frame in the frame's program calls (graph replays and
their launch counters; ``crt.frame.raygen``, ``crt.frame.depth<i>``,
``crt.frame.partition<d>``, ``crt.frame.film``) and its copies out of
the graphs' pool (``crt.frame.copy_out``)."""

from rtb import ranges


def read(ctx):
    return ranges.host_ms(
        ctx["trace"],
        r"crt\.frame\.(raygen|depth\d+|partition\d+|film|copy_out)")
