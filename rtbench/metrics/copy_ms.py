"""Host ms per frame in the image's copies to the host
(``crt.image.copy``: get_image and get_raw_image)."""

from rtb import ranges


def read(ctx):
    return ranges.host_ms(ctx["trace"], r"crt\.image\.copy")
