"""PNG/RAW writer tests.

The .raw format must stay byte-compatible with the reference
(internal/app/raw/writer.go:11-35): big-endian int32 version major(1),
minor(0), width, height, then float32 RGB triplets.
"""
import os
import struct
import tempfile

import numpy as np
import pytest

from pathtracer.io.png import (clamp_to_u8, decode_png, encode_png,
                               load_image, write_png)
from pathtracer.io.raw import read_raw, write_raw


def test_raw_roundtrip_and_layout():
    img = np.random.default_rng(3).random((5, 7, 3)).astype(np.float32)
    with tempfile.TemporaryDirectory() as d:
        p = os.path.join(d, "x.raw")
        write_raw(p, img)
        with open(p, "rb") as f:
            major, minor, w, h = struct.unpack(">iiii", f.read(16))
            assert (major, minor, w, h) == (1, 0, 7, 5)
            first = struct.unpack(">f", f.read(4))[0]
            assert abs(first - float(img[0, 0, 0])) < 1e-7
        back = read_raw(p)
        np.testing.assert_allclose(back, img, rtol=1e-6)


def test_clamp_matches_reference_semantics():
    """pathtracer.go:50-59: scale by 255, clip to [0, 255]."""
    img = np.array([[[-0.5, 0.0, 0.5], [1.0, 2.0, 0.25]]])
    out = clamp_to_u8(img)
    assert out.tolist() == [[[0, 0, 127], [255, 255, 63]]]


def test_write_png(tmp_path):
    img = np.zeros((4, 6, 3), dtype=np.float32)
    img[..., 0] = 1.0
    p = tmp_path / "x.png"
    write_png(str(p), img)
    with open(p, "rb") as f:
        back = decode_png(f.read())
    assert back.shape == (4, 6, 3)
    assert (back[..., 0] == 255).all() and (back[..., 1] == 0).all()


def test_png_roundtrip_random_image(tmp_path):
    rgb = np.random.default_rng(0).integers(0, 256, (17, 23, 3), np.uint8)
    blob = encode_png(rgb)
    assert blob[:8] == b"\x89PNG\r\n\x1a\n"
    np.testing.assert_array_equal(decode_png(blob), rgb)
    p = tmp_path / "r.png"
    p.write_bytes(blob)
    np.testing.assert_allclose(load_image(str(p)), rgb / 255.0, atol=1e-7)


def _png(rows, w, h, ctype, filters):
    """Hand-built PNG: each scanline with its own filter byte (a second
    encoder, independent of encode_png, so the decoder's unfiltering is
    checked against the PNG specification's definitions)."""
    import zlib

    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = ch
    raw = bytearray()
    prev = np.zeros(w * ch, np.int64)
    for y in range(h):
        cur = rows[y].reshape(-1).astype(np.int64)
        f = filters[y % len(filters)]
        out = np.zeros_like(cur)
        for x in range(cur.size):
            a = cur[x - bpp] if x >= bpp else 0
            b = prev[x]
            c = prev[x - bpp] if x >= bpp else 0
            pred = [0, a, b, (a + b) // 2,
                    a if abs(b - c) <= abs(a - c) and abs(b - c)
                    <= abs(a + b - 2 * c) else
                    (b if abs(a - c) <= abs(a + b - 2 * c) else c)][f]
            out[x] = (cur[x] - pred) % 256
        raw.append(f)
        raw.extend(out.astype(np.uint8).tobytes())
        prev = cur

    def chunk(k, d):
        return (struct.pack(">I", len(d)) + k + d
                + struct.pack(">I", zlib.crc32(k + d) & 0xFFFFFFFF))

    return (b"\x89PNG\r\n\x1a\n"
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(bytes(raw)))
            + chunk(b"IEND", b""))


@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_decodes_all_filters_and_color_types(ctype):
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rows = np.random.default_rng(ctype).integers(0, 256, (10, 7, ch),
                                                 np.uint8)
    blob = _png(rows, 7, 10, ctype, filters=[0, 1, 2, 3, 4])
    np.testing.assert_array_equal(decode_png(blob), rows)


def test_png_rejects_unsupported(tmp_path):
    with pytest.raises(ValueError, match="not a PNG"):
        decode_png(b"GIF89a" + b"\0" * 20)
    blob = bytearray(_png(np.zeros((2, 2, 3), np.uint8), 2, 2, 2, [0]))
    blob[24] = 16                       # IHDR bit depth -> 16
    with pytest.raises(ValueError, match="8-bit"):
        decode_png(bytes(blob))


def test_load_texture_decodes_png_and_warns_on_jpeg(tmp_path, monkeypatch,
                                                   caplog):
    """A PNG asset on the search path is decoded; a JPEG asset is not
    (PNG-only decoder) and falls back to its procedural stand-in with a
    warning naming the file."""
    from pathtracer import assets

    img = np.random.default_rng(0).integers(0, 256, (6, 5, 3), np.uint8)
    (tmp_path / "floor_boards.png").write_bytes(encode_png(img))
    jpg = tmp_path / "seamless-cobblestone-texture.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 16)
    monkeypatch.setenv("PT_ASSETS", str(tmp_path))

    np.testing.assert_allclose(assets.load_texture("floor_boards.png"),
                               img / 255.0, atol=1e-7)
    with caplog.at_level("WARNING", logger="pathtracer"):
        tex = assets.load_texture(jpg.name)
    np.testing.assert_array_equal(tex, assets.cobblestone_texture())
    assert str(jpg) in caplog.text and "only PNG" in caplog.text


def test_canvas():
    """canvas.go:10-63 parity: indexed + mutex writes."""
    from pathtracer.io.canvas import Canvas

    c = Canvas(3, 2)
    c.write_pixel(2, 1, (0.1, 0.2, 0.3))
    c.write_pixel_mutex(0, 0, (1.0, 0.0, 0.0))
    np.testing.assert_allclose(c.pixel_at(2, 1), [0.1, 0.2, 0.3])
    np.testing.assert_allclose(c.pixel_at(0, 0), [1.0, 0.0, 0.0])
    img = np.ones((2, 3, 3), dtype=np.float32)
    c.blit(img)
    assert c.to_image().sum() == 18.0
