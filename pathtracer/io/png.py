"""PNG output and texture image loading, with numpy and zlib only.

Equivalent of the reference's writeImagePNG + clamp (internal/app/tracer/
pathtracer.go:32-59) and scenes.LoadImage (internal/app/scenes/scene.go:30-56).
The writer emits 8-bit RGB; the reader decodes non-interlaced 8-bit
grayscale, gray+alpha, RGB and RGBA images (all five scanline filters).
"""
from __future__ import annotations

import struct
import zlib

import numpy as np

_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# color type -> channels (8-bit depth only)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def clamp_to_u8(img: np.ndarray) -> np.ndarray:
    """Clamp [0,1] floats to bytes like the reference (pathtracer.go:50-59):
    scale by 255 and clip."""
    return np.clip(img * 255.0, 0.0, 255.0).astype(np.uint8)


def _chunk(kind: bytes, data: bytes) -> bytes:
    crc = zlib.crc32(kind + data) & 0xFFFFFFFF
    return struct.pack(">I", len(data)) + kind + data + struct.pack(">I", crc)


def encode_png(rgb: np.ndarray) -> bytes:
    """[H, W, 3] uint8 -> PNG bytes (filter 0 on every scanline)."""
    rgb = np.ascontiguousarray(rgb, dtype=np.uint8)
    h, w, c = rgb.shape
    if c != 3:
        raise ValueError(f"expected [H, W, 3] pixels, got {rgb.shape}")
    raw = np.concatenate(
        [np.zeros((h, 1), np.uint8), rgb.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (_SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))


def write_png(path: str, img: np.ndarray) -> None:
    """img: [H, W, 3] float (linear, unclamped) -> 8-bit PNG."""
    with open(path, "wb") as f:
        f.write(encode_png(clamp_to_u8(img)))


def _unfilter(data: bytes, h: int, w: int, bpp: int) -> np.ndarray:
    stride = w * bpp
    rows = np.frombuffer(data, np.uint8)
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data has the wrong size")
    rows = rows.reshape(h, stride + 1)
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int32)
    for y in range(h):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int32)
        if ftype == 0:
            cur = line
        elif ftype == 2:
            cur = (line + prev) & 0xFF
        elif ftype in (1, 3, 4):
            # left-neighbour filters depend on the decoded bytes to their
            # left, so they run pixel by pixel along the row
            cur = np.zeros(stride, np.int32)
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = prev[x]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prev[x - bpp] if x >= bpp else 0
                    pa, pb, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur[x] = (line[x] + pred) & 0xFF
        else:
            raise ValueError(f"unknown PNG filter type {ftype}")
        out[y] = cur
        prev = cur
    return out


def decode_png(blob: bytes) -> np.ndarray:
    """PNG bytes -> [H, W, C] uint8 (C = 1, 2, 3 or 4 as stored)."""
    if blob[:8] != _SIGNATURE:
        raise ValueError("not a PNG file")
    pos = 8
    idat = []
    hdr = None
    while pos < len(blob):
        n, kind = struct.unpack(">I4s", blob[pos:pos + 8])
        data = blob[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", data)
        elif kind == b"IDAT":
            idat.append(data)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG has no IHDR chunk")
    w, h, depth, ctype, _comp, _filt, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(
            f"unsupported PNG (bit depth {depth}, color type {ctype}, "
            f"interlace {interlace}); 8-bit non-interlaced only")
    c = _CHANNELS[ctype]
    pix = _unfilter(zlib.decompress(b"".join(idat)), h, w, c)
    return pix.reshape(h, w, c)


def load_image(path: str) -> np.ndarray:
    """Decode a PNG to [H, W, 3] float32 in [0,1] (scene.go LoadImage
    converts to NRGBA; we normalize to float and drop alpha)."""
    with open(path, "rb") as f:
        pix = decode_png(f.read())
    if pix.shape[2] in (1, 2):
        pix = np.repeat(pix[..., :1], 3, axis=2)
    return pix[..., :3].astype(np.float32) / 255.0
