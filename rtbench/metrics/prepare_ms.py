"""Host ms per frame from render()'s entry to the frame's first program
(``crt.frame.inputs``): the frame's keys and key table, the camera, the
sample count and the film's input."""

from rtb import ranges


def read(ctx):
    return ranges.host_ms(ctx["trace"], r"crt\.frame\.inputs")
