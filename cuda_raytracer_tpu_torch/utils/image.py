"""Image I/O and conversion.

PNG save/load on the standard library (``zlib`` + ``struct``; no
Pillow): ``save_png`` writes 8-bit RGB, ``load_png`` reads every PNG
layout as the JAX package's Pillow-based reader does.  Framebuffers are
top-row-first as the JAX package writes them.  The minimal EXR loader
for environment maps is a copy of the JAX package's.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: samples per pixel of each PNG colour type: grey, RGB, palette,
#: grey + alpha, RGBA
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
#: the bit depths the PNG specification allows for each colour type
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
#: Adam7 interlacing: (x0, y0, dx, dy) of each of the seven passes
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def to_uint8(img: np.ndarray) -> np.ndarray:
    """Clamp [H, W, 3] float radiance to 8-bit sRGB-ish output (the
    reference writes raw clamped floats; parity first, tonemap opt-in)."""
    return (np.clip(np.asarray(img), 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + kind + data
            + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))


def save_png(path: str, img: np.ndarray) -> None:
    """Write [H, W, 3] float radiance as an 8-bit RGB, non-interlaced PNG
    (every row with filter type 0)."""
    arr = to_uint8(img)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png takes an [H, W, 3] image, not "
                         f"{arr.shape}")
    h, w, _ = arr.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, -1)],
                          axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(_PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
                + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
                + _chunk(b"IEND", b""))


def _paeth(a: int, b: int, c: int) -> int:
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    if pa <= pb and pa <= pc:
        return a
    return b if pb <= pc else c


def _unfilter(kind: int, line: bytearray, prev: bytes, bpp: int) -> None:
    """Undo one scanline's filter in place (PNG spec section 9.2)."""
    n = len(line)
    if kind == 0:
        return
    if kind == 1:
        for i in range(bpp, n):
            line[i] = (line[i] + line[i - bpp]) & 0xFF
    elif kind == 2:
        for i in range(n):
            line[i] = (line[i] + prev[i]) & 0xFF
    elif kind == 3:
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + ((left + prev[i]) >> 1)) & 0xFF
    elif kind == 4:
        for i in range(n):
            left = line[i - bpp] if i >= bpp else 0
            up_left = prev[i - bpp] if i >= bpp else 0
            line[i] = (line[i] + _paeth(left, prev[i], up_left)) & 0xFF
    else:
        raise ValueError(f"PNG: unknown filter type {kind}")


def _read_pass(raw: bytes, off: int, w: int, h: int, ch: int,
               depth: int):
    """Unfilter one (sub)image of h rows at raw[off:] and unpack its
    samples: ([h, w, ch] int64 array, offset past its rows)."""
    stride = (w * ch * depth + 7) // 8
    bpp = max(1, ch * depth // 8)
    end = off + h * (stride + 1)
    if len(raw) < end:
        raise ValueError(f"image data has {len(raw)} bytes, fewer than "
                         f"the {end} its header needs")
    out = bytearray(h * stride)
    prev = bytes(stride)
    for y in range(h):
        start = off + y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], line, prev, bpp)
        out[y * stride:(y + 1) * stride] = line
        prev = line
    buf = np.frombuffer(bytes(out), np.uint8).reshape(h, stride)
    if depth == 16:
        samples = buf.view(">u2")
    elif depth == 8:
        samples = buf
    else:  # 1, 2 or 4 bits per sample, packed from the high bits
        bits = np.unpackbits(buf, axis=1).reshape(h, -1, depth)
        weights = 1 << np.arange(depth - 1, -1, -1)
        samples = (bits * weights).sum(-1)
    return samples[:, :w * ch].astype(np.int64).reshape(h, w, ch), end


def load_png(path: str) -> np.ndarray:
    """Read a PNG as [H, W, 3] float32 in [0, 1], as the JAX package's
    ``load_png`` does (Pillow's ``convert("RGB")``, divided by 255).

    Every layout the PNG specification allows, interlaced (Adam7) or not:

    * RGB and RGBA, 8 bits: the colour samples (alpha dropped);
    * RGB and RGBA, 16 bits: the high byte of each sample (0x12ff -> 18);
    * grey, 8 bits: the sample in all three channels; 1, 2 and 4 bits:
      scaled to 8 bits (x 255, 85 and 17);
    * grey, 16 bits: the sample clipped at 255 (5000 -> 255), as Pillow
      converts its ``I;16`` mode;
    * grey + alpha: the grey sample (its high byte at 16 bits), alpha
      dropped;
    * palette (1, 2, 4, 8 bits): the PLTE colour; an index past the
      palette gives black.

    A tRNS chunk (transparency) is ignored, as ``convert("RGB")``
    ignores it.  Raises on anything else: a bad signature or CRC, a
    missing IHDR, IDAT or (palette images) PLTE, or a depth the colour
    type does not allow."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off, header, plte, idat = 8, None, None, []
    while off + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, off)
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        off += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            plte = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, comp, filt, interlace = header
    if (color not in _CHANNELS or depth not in _DEPTHS[color] or comp
            or filt or interlace not in (0, 1) or not w or not h):
        raise ValueError(
            f"{path}: not a valid PNG header (colour type {color}, bit "
            f"depth {depth}, compression {comp}, filter {filt}, interlace "
            f"{interlace}, {w}x{h})")
    if color == 3 and plte is None:
        raise ValueError(f"{path}: palette image without a PLTE chunk")
    ch = _CHANNELS[color]
    raw = zlib.decompress(b"".join(idat))
    if interlace:
        samples = np.zeros((h, w, ch), np.int64)
        off = 0
        for x0, y0, dx, dy in _ADAM7:
            pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
            if pw > 0 and ph > 0:
                sub, off = _read_pass(raw, off, pw, ph, ch, depth)
                samples[y0::dy, x0::dx] = sub
    else:
        samples, off = _read_pass(raw, 0, w, h, ch, depth)
    if off != len(raw):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, not "
                         f"{off}")

    if color == 3:
        pal = np.zeros((256, 3), np.uint8)
        n = min(len(plte) // 3, 256)
        pal[:n] = np.frombuffer(plte[:3 * n], np.uint8).reshape(n, 3)
        rgb = pal[samples[..., 0]]
    else:
        if depth == 16:
            v = np.minimum(samples, 255) if color == 0 else samples >> 8
        elif depth < 8:
            v = samples * (255 // ((1 << depth) - 1))
        else:
            v = samples
        rgb = v[..., :3] if color in (2, 6) else np.repeat(v[..., :1], 3, -1)
    return rgb.astype(np.float32) / 255.0


def load_exr(path: str) -> np.ndarray:
    """Minimal scanline EXR loader for environment maps (the reference
    vendors tinyexr; we support uncompressed/ZIP scanline RGB float
    files via a tiny parser).  Raises on unsupported layouts."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"\x76\x2f\x31\x01":
        raise ValueError("not an EXR file")
    # header parse
    off = 8
    attrs = {}
    while True:
        end = data.index(b"\x00", off)
        name = data[off:end].decode()
        if not name:
            off = end + 1
            break
        off = end + 1
        end = data.index(b"\x00", off)
        atype = data[off:end].decode()
        off = end + 1
        (size,) = struct.unpack_from("<i", data, off)
        off += 4
        attrs[name] = (atype, data[off : off + size])
        off += size
    _, box = attrs["dataWindow"]
    x0, y0, x1, y1 = struct.unpack("<iiii", box)
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][1][0]
    _, chan_data = attrs["channels"]
    channels = []
    coff = 0
    while chan_data[coff] != 0:
        cend = chan_data.index(b"\x00", coff)
        cname = chan_data[coff:cend].decode()
        ptype = struct.unpack_from("<i", chan_data, cend + 1)[0]
        channels.append((cname, ptype))
        coff = cend + 1 + 16
    channels_sorted = sorted(c[0] for c in channels)
    nchan = len(channels)
    ptype = channels[0][1]  # 1 = half, 2 = float
    bpp = 2 if ptype == 1 else 4
    dtype = np.float16 if ptype == 1 else np.float32

    # scanline offsets table
    ntables = h if comp == 0 else (h + 15) // 16 if comp == 4 else h
    lines_per_block = 1 if comp == 0 else 16 if comp == 4 else 1
    if comp not in (0, 2, 3, 4):
        raise ValueError(f"unsupported EXR compression {comp}")
    if comp in (2, 3):
        lines_per_block = 1 if comp == 2 else 16
        ntables = (h + lines_per_block - 1) // lines_per_block
    offsets = struct.unpack_from(f"<{ntables}q", data, off)

    img = np.zeros((h, w, nchan), dtype=np.float32)
    for oi, boff in enumerate(offsets):
        (y,) = struct.unpack_from("<i", data, boff)
        (nbytes,) = struct.unpack_from("<i", data, boff + 4)
        raw = data[boff + 8 : boff + 8 + nbytes]
        nlines = min(lines_per_block, h - (y - y0))
        expected = w * nchan * bpp * nlines
        if comp in (2, 3):  # ZIPS/ZIP
            raw = zlib.decompress(raw)
            # EXR zip predictor + interleave
            arr = np.frombuffer(raw, np.uint8).astype(np.int64)
            # delta predictor: r[i] = r[i-1] + raw[i] - 128
            arr = (np.cumsum(arr - 128) + 128) % 256
            arr = arr.astype(np.uint8)
            half = (len(arr) + 1) // 2
            out = np.zeros(len(arr), np.uint8)
            out[0::2] = arr[:half]
            out[1::2] = arr[half:]
            raw = out.tobytes()
        if len(raw) < expected:
            raise ValueError("EXR scanline underrun")
        block = np.frombuffer(raw[:expected], dtype=dtype).astype(np.float32)
        block = block.reshape(nlines, nchan, w)
        for ci, (cname, _) in enumerate(sorted(channels)):
            dst = {"R": 0, "G": 1, "B": 2}.get(cname, ci)
            img[y - y0 : y - y0 + nlines, :, dst] = block[:, ci, :]
    return img[:, :, :3]
