"""Procedural texture programs evaluated identically on host and device.

The reference repository ships texture-mapped scenes but is missing the
image assets themselves (SURVEY.md §2.4), so this framework renders them
with deterministic procedural substitutes (assets.py). Every procedural
texture here is a closed-form function of the integer texel coordinate
built on an integer-hash value noise, so the megakernel COMPUTES the same
four bilinear taps the wavefront path gathers from the texel pool, with
pure ALU work and no texture memory traffic.

One implementation serves both paths, parameterized by the array module:
``xp=numpy`` builds the u32 texel pool (scene/pack.py), and ``xp=jnp``
traces the identical arithmetic inside the Pallas kernel
(render/pallas_kernel.py). Bit-level hash equality holds because int32
two's-complement wrap (jnp) and uint32 wrap (numpy) agree, and the
fixed-point coordinates below 2^23 are exact in f32. The only host/device
texel divergences left are transcendental ulps (sin) — bounded by the
±1/255 quantization tests in tests/test_proctex.py.

A texture is described by a hashable descriptor tuple
``(prog_name, (param, ...))`` carried in SceneMeta; PROGRAMS maps the
name to its per-texel function ``fn(xp, ix, iy, h, w, params) -> (r,g,b)``
with rgb floats in [0,1] BEFORE the rgb8 quantization that
``quantize8``/the pool packer applies.

Texture-role parity with the reference kernel: sampling semantics
(normalized coords, REPEAT wrap, bilinear) match tracer.cl:829; the
procedural IMAGES substitute for its missing assets
(texturedplanets.go:124-129).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

# ---------------------------------------------------------------------------
# xp-portable primitives (numpy uint32 <-> jnp int32)
# ---------------------------------------------------------------------------


def _is_np(xp) -> bool:
    return xp is np


def _const_i32(v: int) -> int:
    """A 32-bit constant as the Python int whose int32 two's-complement
    bit pattern equals the uint32 value (jnp int32 literals must fit)."""
    return int(np.int32(np.uint32(v)))


def _mulc(xp, a, v: int):
    """Wrapping 32-bit multiply by constant."""
    if _is_np(xp):
        return (a * np.uint32(v)).astype(np.uint32)
    return a * _const_i32(v)


def _shr(xp, a, k: int):
    """Logical (unsigned) right shift."""
    if _is_np(xp):
        return a >> np.uint32(k)
    import jax

    return jax.lax.shift_right_logical(a, k)


def _xorc(xp, a, v: int):
    """XOR with a 32-bit constant."""
    if _is_np(xp):
        return a ^ np.uint32(v)
    return a ^ _const_i32(v)


def _f32(xp, a):
    if _is_np(xp):
        return a.astype(np.float32)
    import jax.numpy as jnp

    return a.astype(jnp.float32)


def _where(xp, c, a, b):
    return xp.where(c, a, b)


def hash01(xp, ix, iy, seed: int):
    """Uniform [0,1) from integer coords: xorshift-multiply mixer
    (murmur3-finalizer family). ix/iy: u32 (numpy) or i32 (jnp) arrays.
    Returns f32 with 23 random bits — exact in f32, identical across
    numpy and jnp."""
    h = _mulc(xp, ix, 0x27D4EB2D)
    h = h ^ _mulc(xp, iy, 0x165667B1)
    h = _xorc(xp, h, 0x9E3779B9 * (seed + 1) & 0xFFFFFFFF)
    h = h ^ _shr(xp, h, 15)
    h = _mulc(xp, h, 0x85EBCA6B)
    h = h ^ _shr(xp, h, 13)
    h = _mulc(xp, h, 0xC2B2AE35)
    h = h ^ _shr(xp, h, 16)
    return _f32(xp, _shr(xp, h, 9)) * np.float32(1.0 / 8388608.0)


def _floor(xp, a):
    return xp.floor(a)


def _fmod_pos(xp, af, m: int):
    """a mod m for non-negative float-held integers below 2^23 (exact)."""
    mf = np.float32(m)
    return af - mf * _floor(xp, af * np.float32(1.0 / m))


def _i32c(xp, af):
    """Float-held integer -> integer array of the xp-native kind."""
    if _is_np(xp):
        return af.astype(np.uint32)
    import jax.numpy as jnp

    return af.astype(jnp.int32)


def value_noise(xp, fx, fy, cells: int, h: int, w: int, seed: int):
    """Smoothstep-interpolated value noise on a (cells x cells) hash grid,
    evaluated at float texel coords (fx, fy) in [0,w) x [0,h). The grid
    value at integer corner (gx, gy) is hash01(gx, gy, seed). Matches the
    structure of the pre-hash assets._value_noise (bilinear smoothstep
    over a per-seed random grid), with the hash replacing the RNG table
    so the device can evaluate it."""
    ty = fy * np.float32(cells / h)
    tx = fx * np.float32(cells / w)
    y0f = _floor(xp, ty)
    x0f = _floor(xp, tx)
    sy = ty - y0f
    sx = tx - x0f
    sy = sy * sy * (np.float32(3.0) - np.float32(2.0) * sy)
    sx = sx * sx * (np.float32(3.0) - np.float32(2.0) * sx)
    y0 = _i32c(xp, y0f)
    x0 = _i32c(xp, x0f)
    a = hash01(xp, x0, y0, seed)
    b = hash01(xp, x0 + 1, y0, seed)
    c = hash01(xp, x0, y0 + 1, seed)
    d = hash01(xp, x0 + 1, y0 + 1, seed)
    omy = np.float32(1.0) - sy
    omx = np.float32(1.0) - sx
    return a * omy * omx + b * omy * sx + c * sy * omx + d * sy * sx


def quantize8(xp, v):
    """The texel-pool rgb8 quantization (pack._build_texel_pool):
    round-half-even to 8 bits, back to [0,1] f32."""
    x = v * np.float32(255.0)
    if _is_np(xp):
        r = xp.round(x)
    else:
        # half-to-even from floor: the kernel's GPU route has no round
        # primitive. x + 0.5 is exact for |x| < 2^22.
        r = xp.floor(x + np.float32(0.5))
        tie = (r - x) == np.float32(0.5)
        odd = (r - np.float32(2.0) * xp.floor(r * np.float32(0.5))) == 1.0
        r = xp.where(tie & odd, r - np.float32(1.0), r)
    q = xp.clip(r, 0.0, 255.0)
    return _f32(xp, q) * np.float32(1.0 / 255.0)


# ---------------------------------------------------------------------------
# Texture programs. fn(xp, ixf, iyf, h, w, params) -> (r, g, b) in [0,1].
# ixf/iyf arrive as FLOAT-held integer texel coords (exact below 2^23);
# programs convert to integer arrays only for hashing.
# ---------------------------------------------------------------------------


def _checker(xp, ixf, iyf, h, w, params):
    n, c1, c2 = params
    cell = _fmod_pos(xp, _floor(xp, iyf * np.float32(n / h))
                     + _floor(xp, ixf * np.float32(n / w)), 2)
    sel = cell < 0.5
    return tuple(_where(xp, sel, np.float32(a), np.float32(b))
                 for a, b in zip(c1, c2))


def _squares(xp, ixf, iyf, h, w, params):
    """Grout lines over noisy concrete (concrete_squares.png role)."""
    (seed,) = params
    base = np.float32(0.55) + np.float32(0.25) * value_noise(
        xp, ixf, iyf, 16, h, w, seed)
    line = (_fmod_pos(xp, iyf, h // 8) < 3.0) | (_fmod_pos(xp, ixf, w // 8) < 3.0)
    g = _where(xp, line, base * np.float32(0.45), base)
    return g, g, g


def _squares_nm(xp, ixf, iyf, h, w, params):
    """Beveled grout-line normal map (concrete_squares_nm2.png role):
    texel IS the object-space normal after normalization
    (tracer.cl:907-911)."""
    px = _fmod_pos(xp, ixf, w // 8)
    py = _fmod_pos(xp, iyf, h // 8)
    nx = _where(xp, px < 3.0, np.float32(0.1),
                _where(xp, px > np.float32((w // 8) - 4), np.float32(0.5),
                       np.float32(0.3)))
    nz = _where(xp, py < 3.0, np.float32(0.1),
                _where(xp, py > np.float32((h // 8) - 4), np.float32(0.5),
                       np.float32(0.3)))
    ny = xp.full_like(nx, np.float32(0.9))
    return nx, ny, nz


def _cobblestone(xp, ixf, iyf, h, w, params):
    s1, s2 = params
    n1 = value_noise(xp, ixf, iyf, 24, h, w, s1)
    n2 = value_noise(xp, ixf, iyf, 6, h, w, s2)
    g = np.float32(0.35) + np.float32(0.3) * n1 + np.float32(0.2) * n2
    return g, g * np.float32(0.95), g * np.float32(0.85)


def _floorboards(xp, ixf, iyf, h, w, params):
    (seed,) = params
    grain = value_noise(xp, ixf, iyf, 64, h, w, seed)
    plank = _floor(xp, iyf * np.float32(8.0 / h)) * np.float32(1.0 / 8.0)
    g = np.float32(0.45) + np.float32(0.12) * grain + np.float32(0.08) * plank
    line = _fmod_pos(xp, iyf, h // 8) < 2.0
    g = _where(xp, line, g * np.float32(0.5), g)
    return g, g * np.float32(0.72), g * np.float32(0.45)


def _planet(xp, ixf, iyf, h, w, params):
    """2:1 equirectangular planet: continents over ocean + polar caps."""
    (seed,) = params
    n = value_noise(xp, ixf, iyf, 12, h, w, seed) \
        + np.float32(0.5) * value_noise(xp, ixf, iyf, 48, h, w, seed + 1)
    land = n > np.float32(0.75)
    # |linspace(-1,1,h)[iy]| > 0.88
    lat = xp.abs(np.float32(-1.0) + iyf * np.float32(2.0 / (h - 1)))
    polar = lat > np.float32(0.88)
    ocean = (0.05, 0.15, 0.45)
    landc = (0.15, 0.5, 0.2)
    icec = (0.95, 0.95, 0.98)
    out = []
    for k in range(3):
        v = _where(xp, land, np.float32(landc[k]), np.float32(ocean[k]))
        out.append(_where(xp, polar, np.float32(icec[k]), v))
    return tuple(out)


def _jupiter(xp, ixf, iyf, h, w, params):
    (seed,) = params
    yy = iyf * np.float32(1.0 / (h - 1))
    bands = np.float32(0.5) + np.float32(0.25) * xp.sin(yy * np.float32(40.0)) \
        + np.float32(0.1) * value_noise(xp, ixf, iyf, 20, h, w, seed)
    b = xp.clip(bands, np.float32(0.0), np.float32(1.0))
    return b, b * np.float32(0.8), b * np.float32(0.6)


def _sky(xp, ixf, iyf, h, w, params):
    """alps_field_8k.png role: sky gradient + ground band + sun disc."""
    v = iyf * np.float32(1.0 / (h - 1))
    top = (0.35, 0.55, 0.95)
    bot = (0.85, 0.9, 1.0)
    groundc = (0.25, 0.4, 0.18)
    sunc = (1.0, 0.98, 0.9)
    ground = v > np.float32(0.62)
    dy = iyf - np.float32(0.25 * h)
    dx = ixf - np.float32(0.7 * w)
    sun = dy * dy + dx * dx < np.float32((0.03 * h) ** 2)
    out = []
    for k in range(3):
        c = (np.float32(1.0) - v) * np.float32(top[k]) + v * np.float32(bot[k])
        c = _where(xp, ground, np.float32(groundc[k]), c)
        out.append(_where(xp, sun, np.float32(sunc[k]), c))
    return tuple(out)


def _cube_cross(xp, ixf, iyf, h, w, params):
    """shrine_cubemap.jpeg role: 4x3 cross — gradient side faces with
    per-face tints, flat top (sky) and bottom (ground)."""
    (face,) = params
    skyc = (0.4, 0.6, 0.95)
    groundc = (0.3, 0.25, 0.2)
    tints = ((1.0, 0.9, 0.8), (0.9, 1.0, 0.9),
             (0.8, 0.9, 1.0), (1.0, 1.0, 0.85))
    ff = np.float32(face)
    col = _floor(xp, ixf * np.float32(1.0 / face))  # 0..3
    mid = (iyf >= ff) & (iyf < np.float32(2 * face))
    topf = (iyf < ff) & (col == 1.0)
    botf = (iyf >= np.float32(2 * face)) & (col == 1.0)
    # vertical blend within the middle row: linspace(0,1,face)[iy-face]
    vv = (iyf - ff) * np.float32(1.0 / (face - 1))
    out = []
    for k in range(3):
        grad = (np.float32(1.0) - vv) * np.float32(skyc[k]) \
            + vv * np.float32(groundc[k])
        tint = xp.zeros_like(ixf)
        for t in range(4):
            tint = _where(xp, col == np.float32(t),
                          np.float32(tints[t][k]), tint)
        c = _where(xp, mid, grad * tint, xp.zeros_like(ixf))
        c = _where(xp, topf, np.float32(skyc[k]), c)
        c = _where(xp, botf, np.float32(groundc[k]), c)
        out.append(c)
    return tuple(out)


PROGRAMS = {
    "checker": _checker,
    "squares": _squares,
    "squares_nm": _squares_nm,
    "cobblestone": _cobblestone,
    "floorboards": _floorboards,
    "planet": _planet,
    "jupiter": _jupiter,
    "sky": _sky,
    "cube_cross": _cube_cross,
}


def eval_texel(xp, desc: Tuple, ixf, iyf, h: int, w: int):
    """Evaluate a texture program at float-held integer texel coords,
    WITH the pool's rgb8 quantization, so device evaluation matches the
    packed pool texel bit-for-bit (up to transcendental ulps)."""
    name, params = desc
    r, g, b = PROGRAMS[name](xp, ixf, iyf, h, w, params)
    return quantize8(xp, r), quantize8(xp, g), quantize8(xp, b)


def eval_image(desc: Tuple, h: int, w: int) -> np.ndarray:
    """Host-side [h, w, 3] f32 image (pre-quantization floats — the pool
    packer quantizes; callers that need the quantized view use
    eval_texel). Used by assets.py to build every procedural texture."""
    iy, ix = np.mgrid[0:h, 0:w]
    ixf = ix.astype(np.float32)
    iyf = iy.astype(np.float32)
    name, params = desc
    r, g, b = PROGRAMS[name](np, ixf, iyf, h, w, params)
    out = np.stack([np.broadcast_to(r, (h, w)),
                    np.broadcast_to(g, (h, w)),
                    np.broadcast_to(b, (h, w))], axis=-1)
    return np.ascontiguousarray(out.astype(np.float32))


class ProcImage(np.ndarray):
    """[H, W, 3] f32 image that remembers its procedural descriptor, so
    scene/pack.py can hand the megakernel a computable texture instead of
    an opaque texel pool. File-loaded images are plain ndarrays
    (proc is None) and keep the wavefront gather path."""
    proc: "Tuple | None" = None

    @staticmethod
    def wrap(img: np.ndarray, desc: Tuple) -> "ProcImage":
        out = np.asarray(img, dtype=np.float32).view(ProcImage)
        out.proc = desc
        return out

    def __array_finalize__(self, obj):
        if obj is not None and self.ndim != 3:
            # reductions/slices are ordinary arrays conceptually; keep the
            # attribute only on whole-image views
            self.proc = None
        else:
            self.proc = getattr(obj, "proc", None)


def make(desc: Tuple, h: int, w: int) -> ProcImage:
    """Build a descriptor-carrying procedural image."""
    return ProcImage.wrap(eval_image(desc, h, w), desc)
