"""The port's PNG reader (``zlib`` + ``struct``) against the JAX package's
``load_png`` (Pillow's ``convert("RGB")``), layout by layout.

Each case writes one 13x11 image of random samples (numpy, seeded):
with Pillow where Pillow writes the layout, else with this file's own
encoder, which also writes Adam7-interlaced files (Pillow writes none)
and cycles the five scanline filters over the rows.  Held: the two
readers' arrays equal, exactly.
"""

import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from cuda_raytracer_tpu.utils.image import load_png as jax_load_png

from cuda_raytracer_tpu_torch.utils.image import load_png
from torch_threads import _one_torch_thread  # noqa: F401

W, H = 13, 11
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))
PALETTE = np.random.default_rng(1).integers(0, 256, (11, 3), np.uint8)


def _chunk(kind, data):
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _rows(samples, depth, bpp):
    """Filtered scanlines of one (sub)image: filter type y % 5 on row y."""
    out, prev = b"", None
    for y, row in enumerate(samples.reshape(samples.shape[0], -1)):
        if depth == 16:
            line = row.astype(">u2").tobytes()
        elif depth == 8:
            line = row.astype(np.uint8).tobytes()
        else:
            per = 8 // depth
            pad = np.concatenate([row, np.zeros((-len(row)) % per, int)])
            v = np.zeros(len(pad) // per, int)
            for i in range(per):
                v = (v << depth) | pad[i::per]
            line = v.astype(np.uint8).tobytes()
        up = prev if prev is not None else bytes(len(line))
        kind, f = y % 5, bytearray(len(line))
        for i, x in enumerate(line):
            a = line[i - bpp] if i >= bpp else 0
            c = up[i - bpp] if i >= bpp else 0
            pred = (0, a, up[i], (a + up[i]) >> 1, _paeth(a, up[i], c))[kind]
            f[i] = (x - pred) & 0xFF
        out += bytes([kind]) + bytes(f)
        prev = line
    return out


def encode(path, samples, depth, color, interlace=False, plte=None):
    """Write [H, W, ch] integer samples as a PNG of the given layout."""
    h, w, ch = samples.shape
    bpp = max(1, ch * depth // 8)
    if interlace:
        raw = b"".join(
            _rows(samples[y0::dy, x0::dx], depth, bpp)
            for x0, y0, dx, dy in ADAM7 if w > x0 and h > y0)
    else:
        raw = _rows(samples, depth, bpp)
    body = _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, depth, color, 0, 0,
                                       int(interlace)))
    if plte is not None:
        body += _chunk(b"PLTE", plte.tobytes())
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + body
                + _chunk(b"IDAT", zlib.compress(raw))
                + _chunk(b"IEND", b""))


def samples_for(color, depth, seed=0):
    g = np.random.default_rng(seed)
    hi = 1 << depth
    if color == 3:
        hi = min(hi, len(PALETTE) + 2)  # indices past the PLTE too
    elif color == 0 and depth == 16:
        hi = 512  # grey clips at 255: keep both sides of the clip
    return g.integers(0, hi, (H, W, CHANNELS[color]))


def pillow(mode, **save):
    def write(path):
        s = samples_for(3 if mode == "P" else 0, 8)
        if mode == "P":
            idx = s[..., 0] % (1 << save.get("bits", 8))
            im = Image.frombytes("P", (W, H), idx.astype(np.uint8).tobytes())
            im.putpalette(PALETTE.tobytes())
        elif mode == "I;16":
            im = Image.fromarray(samples_for(0, 16)[..., 0].astype(np.uint16))
            assert im.mode == "I;16"
        else:
            n = {"1": 1, "L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
            g = np.random.default_rng(3).integers(0, 256, (H, W, n))
            im = Image.fromarray(g.astype(np.uint8).squeeze(-1) if n == 1
                                 else g.astype(np.uint8))
            if mode == "1":
                im = im.convert("1")
        im.save(path, **save)
    return write


def ours(color, depth, interlace=False):
    def write(path):
        encode(path, samples_for(color, depth), depth, color, interlace,
               PALETTE if color == 3 else None)
    return write


CASES = {
    # written by Pillow
    "grey1": pillow("1"),
    "grey8": pillow("L"),
    "grey16": pillow("I;16"),
    "grey_alpha8": pillow("LA"),
    "rgb8": pillow("RGB"),
    "rgba8": pillow("RGBA"),
    "palette1": pillow("P", bits=1),
    "palette2": pillow("P", bits=2),
    "palette4": pillow("P", bits=4),
    "palette_pillow": pillow("P"),  # Pillow picks 4 bits for 11 colours
    "palette_trns": pillow("P", transparency=bytes([0, 128, 255])),
    # written here: layouts Pillow does not write, all filters per file
    "grey2": ours(0, 2),
    "grey4": ours(0, 4),
    "grey_alpha16": ours(4, 16),
    "rgb16": ours(2, 16),
    "rgba16": ours(6, 16),
    "palette8": ours(3, 8),
    # Adam7
    "adam7_grey1": ours(0, 1, True),
    "adam7_grey16": ours(0, 16, True),
    "adam7_grey_alpha8": ours(4, 8, True),
    "adam7_palette2": ours(3, 2, True),
    "adam7_rgb8": ours(2, 8, True),
    "adam7_rgba16": ours(6, 16, True),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_load_png_matches_jax(case, tmp_path):
    path = str(tmp_path / f"{case}.png")
    CASES[case](path)
    want = jax_load_png(path)
    got = load_png(path)
    assert got.dtype == np.float32 and got.shape == (H, W, 3)
    np.testing.assert_array_equal(got, want)
    assert np.unique(got).size > 1
