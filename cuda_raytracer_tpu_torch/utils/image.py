"""Image I/O and conversion.

PNG save/load on the standard library (``zlib`` + ``struct``; no
Pillow), framebuffers top-row-first as the JAX package writes them, and
the minimal EXR loader for environment maps (a copy of the JAX
package's).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
#: PNG colour types read: truecolour (RGB) and truecolour with alpha
_CHANNELS = {2: 3, 6: 4}


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


def load_png(path: str) -> np.ndarray:
    """Read an 8-bit RGB or RGBA, non-interlaced PNG as [H, W, 3] float32
    in [0, 1] (alpha dropped); raise on any other layout."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    off, header, idat = 8, None, []
    while off + 8 <= len(data):
        length, kind = struct.unpack_from(">I4s", data, off)
        body = data[off + 8:off + 8 + length]
        (crc,) = struct.unpack_from(">I", data, off + 8 + length)
        if zlib.crc32(kind + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in the {kind!r} chunk")
        off += 12 + length
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None or not idat:
        raise ValueError(f"{path}: no IHDR or IDAT chunk")
    w, h, depth, color, comp, filt, interlace = header
    if depth != 8 or color not in _CHANNELS or comp or filt or interlace:
        raise ValueError(
            f"{path}: only 8-bit RGB/RGBA non-interlaced PNG is read "
            f"(bit depth {depth}, colour type {color}, interlace "
            f"{interlace})")
    bpp = _CHANNELS[color]
    stride = w * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) != h * (stride + 1):
        raise ValueError(f"{path}: image data has {len(raw)} bytes, not "
                         f"{h * (stride + 1)}")
    out = bytearray(h * stride)
    prev = bytes(stride)
    for y in range(h):
        start = y * (stride + 1)
        line = bytearray(raw[start + 1:start + 1 + stride])
        _unfilter(raw[start], line, prev, bpp)
        out[y * stride:(y + 1) * stride] = line
        prev = line
    img = np.frombuffer(bytes(out), np.uint8).reshape(h, w, bpp)[:, :, :3]
    return img.astype(np.float32) / 255.0


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
