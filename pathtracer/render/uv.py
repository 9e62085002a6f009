"""UV mapping and texture sampling (SoA forms).

Behavioral equivalents of internal/ocl/tracer.cl:113-213 (cube-cross UV,
spherical map) and the OpenCL sampler CLK_NORMALIZED_COORDS_TRUE |
CLK_ADDRESS_REPEAT | CLK_FILTER_LINEAR (tracer.cl:829) -> bilinear filtering
with wrap addressing. Host-side mirrors live in the reference at
internal/app/shapes/{sphericalmap,cubemap}.go and are covered by the same
unit-test tables (tests/test_uv.py).
"""
from __future__ import annotations

from typing import Optional, Tuple

import jax.numpy as jnp

from .vec3 import Vec3


def spherical_map(p: Vec3) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Unit-sphere point -> (u, v) in [0,1) (tracer.cl:178-213)."""
    theta = jnp.arctan2(p.x, p.z)
    radius = p.norm()
    phi = jnp.arccos(jnp.clip(p.y / radius, -1.0, 1.0))
    raw_u = theta / (2.0 * jnp.pi)
    u = 1.0 - (raw_u + 0.5)
    v = 1.0 - phi / jnp.pi
    return u, v


def _fmod(a: jnp.ndarray, b: float) -> jnp.ndarray:
    """C fmod (truncated, sign of dividend) as used by the kernel's cube UV."""
    return a - b * jnp.trunc(a / b)


def cube_uv(p: Vec3) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Cube-cross UV for a unit-cube local point (tracer.cl:113-175).

    Face layout in the 4x3 cross texture:
        left  u[0,.25]   front u[.25,.5]  right u[.5,.75]  back u[.75,1]
        top   v[2/3,1]   bottom v[0,1/3]  (middle row v[1/3,2/3])
    """
    x, y, z = p.x, p.y, p.z
    coord = p.abs().max_component()

    two_thirds = 0.6666666
    third = 0.333333
    v_mid = two_thirds - (_fmod(y + 1.0, 2.0) / 2.0) * third

    u_right = 0.5 + (_fmod(1.0 - z, 2.0) / 2.0) * 0.25
    u_left = (_fmod(z + 1.0, 2.0) / 2.0) * 0.25
    u_top = 0.25 + (_fmod(x + 1.0, 2.0) / 2.0) * 0.25
    v_top = 1.0 - (_fmod(1.0 - z, 2.0) / 2.0) * third
    u_bottom = u_top
    v_bottom = (_fmod(z + 1.0, 2.0) / 2.0) * third
    u_front = u_top
    u_back = 0.75 + (_fmod(1.0 - x, 2.0) / 2.0) * 0.25

    # selection cascade (first match wins; order matches tracer.cl:158-174)
    sel_right = coord == x
    sel_left = (~sel_right) & (coord == -x)
    sel_top = (~sel_right) & (~sel_left) & (coord == y)
    sel_bottom = (~sel_right) & (~sel_left) & (~sel_top) & (coord == -y)
    sel_front = (~sel_right) & (~sel_left) & (~sel_top) & (~sel_bottom) & (coord == z)

    u = jnp.where(sel_right, u_right,
        jnp.where(sel_left, u_left,
        jnp.where(sel_top, u_top,
        jnp.where(sel_bottom, u_bottom,
        jnp.where(sel_front, u_front, u_back)))))
    v = jnp.where(sel_right | sel_left | sel_front, v_mid,
        jnp.where(sel_top, v_top,
        jnp.where(sel_bottom, v_bottom, v_mid)))
    return u, v


def _bilinear_coords(w, h, layer, n, u, v):
    """OpenCL normalized-coordinate linear filtering with REPEAT wrap:
    texel centers at (i + 0.5) / W (tracer.cl:829 sampler semantics)."""
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0i = jnp.mod(x0.astype(jnp.int32), w)
    x1i = jnp.mod(x0i + 1, w)
    y0i = jnp.mod(y0.astype(jnp.int32), h)
    y1i = jnp.mod(y0i + 1, h)
    li = jnp.clip(layer, 0, n - 1)
    return x0i, x1i, y0i, y1i, tx, ty, li


def sample_texture(atlas: jnp.ndarray, layer: jnp.ndarray, u: jnp.ndarray,
                   v: jnp.ndarray) -> Vec3:
    """Bilinear sample from a channel-leading [3, n, H, W] float atlas.
    layer/u/v: [R]. Returns Vec3. 12 gathers — the differentiable path
    (texture atlases are trainable, diff/grad.py); the render path uses
    sample_texture_pool (u32 texels, one fetch for all kinds)."""
    _, n, h, w = atlas.shape
    x0i, x1i, y0i, y1i, tx, ty, li = _bilinear_coords(w, h, layer, n, u, v)

    def chan(c):
        c00 = atlas[c, li, y0i, x0i]
        c01 = atlas[c, li, y0i, x1i]
        c10 = atlas[c, li, y1i, x0i]
        c11 = atlas[c, li, y1i, x1i]
        top = c00 * (1.0 - tx) + c01 * tx
        bot = c10 * (1.0 - tx) + c11 * tx
        return top * (1.0 - ty) + bot * ty

    return Vec3(chan(0), chan(1), chan(2))


def sample_texture_pool(pool_u32: jnp.ndarray, base: jnp.ndarray,
                        w: jnp.ndarray, h: jnp.ndarray,
                        u: jnp.ndarray, v: jnp.ndarray,
                        pool_quad_u32: Optional[jnp.ndarray] = None
                        ) -> Vec3:
    """Bilinear sample from the FLAT rgb8-u32 texel pool (pack.py
    _build_texel_pool) with per-ray (base, w, h) — one fetch serves every
    sampler kind, so a bounce does 4 pool taps total instead of 4 per
    kind.

    base/w/h arrive as floats (they ride the one-hot attribute fetch;
    exact below 2^24). Same REPEAT + LINEAR semantics as the float
    sampler above."""
    dt = u.dtype
    wi = w.astype(jnp.int32)
    hi = h.astype(jnp.int32)
    bi = base.astype(jnp.int32)
    fx = u * w - 0.5
    fy = v * h - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = (fx - x0).astype(dt)
    ty = (fy - y0).astype(dt)
    x0i = jnp.mod(x0.astype(jnp.int32), wi)
    x1i = jnp.mod(x0i + 1, wi)
    y0i = jnp.mod(y0.astype(jnp.int32), hi)
    y1i = jnp.mod(y0i + 1, hi)

    def unpack(p):
        scale = jnp.asarray(1.0 / 255.0, dt)
        return Vec3(
            (p & 0xFF).astype(dt) * scale,
            ((p >> 8) & 0xFF).astype(dt) * scale,
            ((p >> 16) & 0xFF).astype(dt) * scale,
        )

    if pool_quad_u32 is not None:
        # ONE row gather returns the whole bilinear footprint: quad row i
        # holds [c00, c01, c10, c11] with the texture's REPEAT wrap baked
        # in at pack time (pack._build_texel_pool), so only the anchor
        # index is computed here. The wrap rows ARE the x1/y1 taps, hence
        # bit-identical to the 4-take path (tests/test_uv.py).
        rows = jnp.take(pool_quad_u32, bi + y0i * wi + x0i, axis=0,
                        mode="clip")
        c00 = unpack(rows[:, 0])
        c01 = unpack(rows[:, 1])
        c10 = unpack(rows[:, 2])
        c11 = unpack(rows[:, 3])
    else:
        def tap(yi, xi):
            return jnp.take(pool_u32, bi + yi * wi + xi, mode="clip")

        c00 = unpack(tap(y0i, x0i))
        c01 = unpack(tap(y0i, x1i))
        c10 = unpack(tap(y1i, x0i))
        c11 = unpack(tap(y1i, x1i))
    top = c00 * (1.0 - tx) + c01 * tx
    bot = c10 * (1.0 - tx) + c11 * tx
    return top * (1.0 - ty) + bot * ty
