"""Pallas megakernel for the GPU: the full per-pixel path tracer in one
kernel, compiled through Pallas's Triton route.

GPU re-design of the reference's OpenCL megakernel `trace`
(internal/ocl/tracer.cl:831-1188). Each Pallas program owns one block of
`block` rays (one ray per pixel slot, a power of two) and runs the whole
sample x bounce loop for them with the ray state in registers:

- scene object tables are read as scalars from global memory (they stay
  resident in L1/L2, the analogue of the reference copying objects into
  __local memory, tracer.cl:846-849); the object loop is a static Python
  unroll, so every primitive compiles to exactly its own test
- BVH nodes and triangle rows stay in global memory (L2-resident for the
  benchmark meshes). The block walks the skip-link BVH as one packet
  (_packet_traverse): one node index per block, node and triangle rows
  read as scalars, every ray slab- and triangle-tested against them,
  starting in the front-to-back node copy of the block's majority
  direction octant (scene/bvh.octant_node_orders). A per-ray walk (each
  lane its own node index and gathers, like the wavefront's traverse_bvh)
  measured slower on teapot and compiled 10x slower (PERF.md)
- randomness is a counter-based hash keyed on (seed, global pixel,
  global sample, bounce, draw id), so an image does not depend on the
  block size, the segment schedule or the device mesh
- the bounce loop early-exits per block once every ray has died,
  mirroring the reference's per-work-item break (tracer.cl:1107)

Covers untextured and procedurally textured scenes of plane / sphere /
cylinder / box primitives and BVH triangle meshes, with all roulette
branches (reflect / thin-shell / refract / diffuse), next-event
estimation and the sunflower depth-of-field sampler. Scenes that sample
file-backed images render on the wavefront integrator (integrator.py);
`supports_scene` decides.

Numerics are float32 like the wavefront path; estimator parity is checked
statistically (tests/test_pallas.py, chip_smoke.py): same mean image,
independent noise.
"""
from __future__ import annotations

import functools
import math
import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..config import RenderConfig
from ..scene.pack import SceneArrays, SceneMeta
from ..scene.shapes import BOX, CYLINDER, GROUP, PLANE, SPHERE

# object-table columns (per object row, flattened row-major):
#   0-11  inverse (3x4 row-major)
#   12-23 inverse-transpose (3x4 row-major)
#   24-26 color rgb
#   27-29 emission rgb
#   30    refractive index
#   31    reflectivity
#   32    min_y
#   33    max_y
#   34-36 group bbox min (local space; GROUP objects only)
#   37-39 group bbox max
#   40-42 forward-transform translation (world light origin; NEE,
#         tracer.cl:790)
#   43    light scale = max diagonal of the forward transform
#         (tracer.cl:791)
#   44    forward transform [0,0] (NEE attenuation heuristic,
#         tracer.cl:819)
_OBJ_COLS = 45

# camera vector: 0-11 inverse (3x4 row-major), 12 pixel_size,
# 13 half_width, 14 half_height, 15 aperture, 16 focal_length
_CAM_COLS = 17

# node rows: 0-2 bbmin, 3-5 bbmax, 6 tri_start (exact f32 int),
# 7 is_leaf, 8 exit; padded to 16 floats (64-byte rows)
_NODE_COLS = 16
# triangle rows (dual-basis layout, see _leaf_test):
#   0-2 p1, 3-5 Ng (= e1 x e2, unnormalized), 6-8 U, 9-11 V
#   (U.e1 = 1, U.e2 = 0; V.e1 = 0, V.e2 = 1; both in-plane),
#   12-14 n1, 15-17 d21 (= n2-n1), 18-20 d31 (= n3-n1), 21-23 color
_TRI_COLS = 24

_BIG = 1e30
_INV24 = float(2.0 ** -24)

# rays per Pallas program and warps per program (tuned on the card, see
# PERF.md)
DEFAULT_BLOCK = 128
DEFAULT_WARPS = 4


def textures_procedural(meta: SceneMeta) -> bool:
    """True when every sampled texture (color AND normal maps) carries a
    render/proctex descriptor, so the kernel (and the wavefront's
    computed-texel mode) can evaluate its texels instead of gathering
    them from the texel pool. File-backed images have desc None."""
    if not meta.textured_types and not meta.has_normal_maps:
        return True
    return all(desc is not None
               for (_slot, desc, _w, _h, _sx, _sy)
               in meta.obj_tex + meta.obj_tex_nm)


def supports_scene(meta: SceneMeta) -> bool:
    """Megakernel coverage: the 4 primitives plus BVH triangle meshes,
    with textures/normal maps when they are procedural. Scenes sampling
    file-backed image textures render on the wavefront integrator."""
    prim = all(t in (PLANE, SPHERE, CYLINDER, BOX, GROUP)
               for t in meta.obj_types)
    return prim and textures_procedural(meta)


def scene_tables(scn: SceneArrays, meta: SceneMeta):
    """Flat f32 scene tables for the kernel: (objects [No*_OBJ_COLS],
    nodes [Nn*_NODE_COLS], triangles [Ns*_TRI_COLS]). Built with jnp ops
    so they can be traced inside a jitted step."""
    n = meta.n_objects
    f = lambda a: jnp.asarray(a).astype(jnp.float32)
    tr = f(scn.transform)
    obj = jnp.concatenate([
        f(scn.inverse)[:n, :3, :].reshape(n, 12),
        f(scn.inverse_transpose)[:n, :3, :].reshape(n, 12),
        f(scn.color)[:n], f(scn.emission)[:n],
        f(scn.refractive_index)[:n, None], f(scn.reflectivity)[:n, None],
        f(scn.min_y)[:n, None], f(scn.max_y)[:n, None],
        f(scn.bb_min)[:n], f(scn.bb_max)[:n],
        tr[:n, :3, 3],
        jnp.maximum(jnp.maximum(tr[:n, 0, 0], tr[:n, 1, 1]),
                    tr[:n, 2, 2])[:, None],
        tr[:n, 0, 0][:, None],
    ], axis=1).reshape(-1)
    if not meta.has_groups:
        return (obj, jnp.zeros((_NODE_COLS,), jnp.float32),
                jnp.zeros((_TRI_COLS,), jnp.float32))
    nn = scn.node_bb_min.shape[0]
    nodes = jnp.concatenate([
        f(scn.node_bb_min), f(scn.node_bb_max),
        f(scn.node_tri_start)[:, None],
        f(scn.node_is_leaf)[:, None],
        f(scn.node_exit)[:, None],
        jnp.zeros((nn, _NODE_COLS - 9), jnp.float32),
    ], axis=1).reshape(-1)
    # dual-basis precompute: Ng = e1 x e2 and the in-plane reciprocal
    # basis U = e2 x Ng / |Ng|^2, V = Ng x e1 / |Ng|^2, so the kernel's
    # barycentrics are two affine dot products. Degenerate (padding)
    # slots have Ng = 0 and zeroed U/V (no inf/nan in the table).
    e1 = f(scn.tri_e1)
    e2 = f(scn.tri_e2)
    ng = jnp.cross(e1, e2)
    l2 = (ng * ng).sum(axis=1, keepdims=True)
    safe = jnp.where(l2 > 0.0, l2, 1.0)
    uu = jnp.where(l2 > 0.0, jnp.cross(e2, ng) / safe, 0.0)
    vv = jnp.where(l2 > 0.0, jnp.cross(ng, e1) / safe, 0.0)
    tris = jnp.concatenate([
        f(scn.tri_p1), ng, uu, vv, f(scn.tri_n1),
        f(scn.tri_n2) - f(scn.tri_n1), f(scn.tri_n3) - f(scn.tri_n1),
        f(scn.tri_color),
    ], axis=1).reshape(-1)
    return obj, nodes, tris


def build_camera_vec(cam) -> np.ndarray:
    """[_CAM_COLS] f32 camera vector from the host Camera."""
    out = np.zeros((_CAM_COLS,), dtype=np.float32)
    out[0:12] = np.asarray(cam.inverse, dtype=np.float32)[:3, :].reshape(12)
    out[12] = float(cam.pixel_size)
    out[13] = float(cam.half_width)
    out[14] = float(cam.half_height)
    out[15] = float(cam.aperture)
    out[16] = float(cam.focal_length)
    return out


def pixel_slots(W: int, H: int, block: int, shard_granule: int = 1
                ) -> np.ndarray:
    """Flat pixel index per kernel slot, scanline order, padded to whole
    blocks (times `shard_granule` for even sharding). Padding slots
    repeat the last pixel; callers drop slots >= W*H."""
    n = W * H
    unit = block * shard_granule
    pad = (-n) % unit
    return np.minimum(np.arange(n + pad), n - 1).astype(np.int32)


# --- counter-based RNG ---------------------------------------------------


def _u32(v: int):
    return jnp.uint32(v & 0xFFFFFFFF)


def _mix32(x):
    """murmur3 fmix32 finalizer on uint32."""
    x = x ^ (x >> _u32(16))
    x = x * _u32(0x85EBCA6B)
    x = x ^ (x >> _u32(13))
    x = x * _u32(0xC2B2AE35)
    return x ^ (x >> _u32(16))


def _pixel_key(seed, pix):
    """Per-lane stream key from the seed and the global pixel index."""
    s = _mix32(jnp.full(pix.shape, seed, jnp.int32).astype(jnp.uint32)
               + _u32(0x7F4A7C15))
    return _mix32(pix.astype(jnp.uint32) * _u32(0x9E3779B1) ^ s)


def _sample_key(pkey, n):
    """Key of one global sample index `n` (i32 scalar) of a pixel."""
    return _mix32(pkey + n.astype(jnp.uint32) * _u32(0x85EBCA77))


def _uniform(skey, did: int, b=None):
    """f32 uniforms in [0, 1) for draw id `did` (< 64) of bounce `b` of
    the sample keyed by `skey`."""
    idx = _u32(did)
    if b is not None:
        idx = idx + b.astype(jnp.uint32) * _u32(64)
    x = _mix32(skey + idx * _u32(0x27D4EB2F))
    top24 = (x >> _u32(8)).astype(jnp.int32)
    return top24.astype(jnp.float32) * _INV24


# --- ray/primitive math ----------------------------------------------------


def _mat12_point(m, x, y, z):
    """(12 scalars) 3x4 matrix x point."""
    return (
        m[0] * x + m[1] * y + m[2] * z + m[3],
        m[4] * x + m[5] * y + m[6] * z + m[7],
        m[8] * x + m[9] * y + m[10] * z + m[11],
    )


def _mat12_vec(m, x, y, z):
    return (
        m[0] * x + m[1] * y + m[2] * z,
        m[4] * x + m[5] * y + m[6] * z,
        m[8] * x + m[9] * y + m[10] * z,
    )


def _dot(ax, ay, az, bx, by, bz):
    return ax * bx + ay * by + az * bz


def _normalize(x, y, z):
    inv = jax.lax.rsqrt(x * x + y * y + z * z)
    return x * inv, y * inv, z * inv


def _axis_slab(o, d, mn, mx, eps):
    use = jnp.abs(d) >= eps
    d_safe = jnp.where(use, d, 1.0)
    t1 = jnp.where(use, (mn - o) / d_safe, (mn - o) * _BIG)
    t2 = jnp.where(use, (mx - o) / d_safe, (mx - o) * _BIG)
    return jnp.minimum(t1, t2), jnp.maximum(t1, t2)


def _plane_t(oy, dy, eps):
    ok = jnp.abs(dy) > eps
    t = -oy / jnp.where(ok, dy, 1.0)
    return jnp.where(ok & (t > eps), t, _BIG)


def _sphere_t(ox, oy, oz, dx, dy, dz, eps):
    """Geometric foot-point form (see intersect.py:_sphere_t for why)."""
    a = dx * dx + dy * dy + dz * dz
    t_mid = -(ox * dx + oy * dy + oz * dz) / a
    mx = ox + dx * t_mid
    my = oy + dy * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + my * my + mz * mz
    ok = perp2 < 1.0
    dt = jnp.sqrt(jnp.where(ok, (1.0 - perp2) / a, 0.0))
    t1 = t_mid - dt
    t2 = t_mid + dt
    return jnp.minimum(
        jnp.where(ok & (t1 > eps), t1, _BIG),
        jnp.where(ok & (t2 > eps), t2, _BIG),
    )


def _cylinder_t(ox, oy, oz, dx, dy, dz, min_y, max_y, eps):
    a = dx * dx + dz * dz
    ok_a = jnp.abs(a) >= eps
    a_safe = jnp.where(ok_a, a, 1.0)
    t_mid = -(ox * dx + oz * dz) / a_safe
    mx = ox + dx * t_mid
    mz = oz + dz * t_mid
    perp2 = mx * mx + mz * mz
    ok = ok_a & (perp2 <= 1.0)
    dt = jnp.sqrt(jnp.where(ok, (1.0 - perp2) / a_safe, 0.0))
    t0 = t_mid - dt
    t1 = t_mid + dt
    y0 = oy + t0 * dy
    y1 = oy + t1 * dy
    v0 = ok & (y0 > min_y) & (y0 < max_y) & (t0 > eps)
    v1 = ok & (y1 > min_y) & (y1 < max_y) & (t1 > eps)
    return jnp.minimum(jnp.where(v0, t0, _BIG), jnp.where(v1, t1, _BIG))


def _box_t(ox, oy, oz, dx, dy, dz, eps):
    x1, x2 = _axis_slab(ox, dx, -1.0, 1.0, eps)
    y1, y2 = _axis_slab(oy, dy, -1.0, 1.0, eps)
    z1, z2 = _axis_slab(oz, dz, -1.0, 1.0, eps)
    tmin = jnp.maximum(jnp.maximum(x1, y1), z1)
    tmax = jnp.minimum(jnp.minimum(x2, y2), z2)
    ok = tmin <= tmax
    return jnp.minimum(
        jnp.where(ok & (tmin > eps), tmin, _BIG),
        jnp.where(ok & (tmax > eps), tmax, _BIG),
    )


def _schlick(cx, cy, cz, nx, ny, nz, n1, n2):
    """tracer.cl:485-505 with scalar-or-vector n1/n2."""
    cos = _dot(cx, cy, cz, nx, ny, nz)
    n = n1 / n2
    sin2t = (n * n) * (1.0 - cos * cos)
    tir = (n1 > n2) & (sin2t > 1.0)
    cos_t = jnp.sqrt(jnp.clip(1.0 - sin2t, 0.0, None))
    cos_eff = jnp.where(n1 > n2, cos_t, cos)
    temp = (n1 - n2) / (n1 + n2)
    r0 = temp * temp
    m = 1.0 - cos_eff
    m2 = m * m
    res = r0 + (1.0 - r0) * (m2 * m2 * m)
    return jnp.where(tir, 1.0, res)


def _refract(cx, cy, cz, nx, ny, nz, n1, n2):
    cos_i = _dot(cx, cy, cz, nx, ny, nz)
    ratio = n1 / n2
    sin2t = (ratio * ratio) * (1.0 - cos_i * cos_i)
    cos_t = jnp.sqrt(jnp.clip(1.0 - sin2t, 0.0, None))
    k = ratio * cos_i - cos_t
    ok = sin2t <= 1.0
    return (
        jnp.where(ok, nx * k - cx * ratio, 0.0),
        jnp.where(ok, ny * k - cy * ratio, 0.0),
        jnp.where(ok, nz * k - cz * ratio, 0.0),
    )


def _atan_poly(z):
    """atan(z) for z in [0,1]: odd degree-13 least-squares fit, max err
    7.7e-7 rad."""
    z2 = z * z
    return z * (0.99999659 + z2 * (-0.33319012 + z2 * (0.19823318
        + z2 * (-0.13294270 + z2 * (0.08076473 + z2 * (-0.03461463
        + z2 * 0.00715190))))))


def _atan2(y, x):
    """Four-quadrant atan2 via octant reduction to _atan_poly."""
    ay = jnp.abs(y)
    ax = jnp.abs(x)
    swap = ay > ax
    num = jnp.where(swap, ax, ay)
    den = jnp.where(swap, ay, ax)
    z = num / jnp.maximum(den, jnp.float32(1e-30))
    r = _atan_poly(z)
    r = jnp.where(swap, jnp.float32(math.pi / 2) - r, r)
    r = jnp.where(x < 0.0, jnp.float32(math.pi) - r, r)
    return jnp.where(y < 0.0, -r, r)


def _acos(x):
    """acos(x) = atan2(sqrt(1-x^2), x) for x in [-1, 1]."""
    s = jnp.sqrt(jnp.maximum((1.0 - x) * (1.0 + x), 0.0))
    return _atan2(s, x)


def _spherical_uv(lx, ly, lz):
    """Unit-sphere local point -> texture (u, v), matching
    uv.spherical_map + the integrator's v flip (tracer.cl:178-213)."""
    theta = _atan2(lx, lz)
    radius = jnp.sqrt(lx * lx + ly * ly + lz * lz)
    phi = _acos(jnp.clip(ly / radius, -1.0, 1.0))
    raw_u = theta * jnp.float32(1.0 / (2.0 * math.pi))
    u = 1.0 - (raw_u + 0.5)
    v = phi * jnp.float32(1.0 / math.pi)  # = 1 - (1 - phi/pi)
    return u, v


def _cfmod(a, b):
    """C fmod (truncated, sign of dividend) — cube-cross UV helper."""
    q = a * jnp.float32(1.0 / b)
    return a - b * jnp.where(q < 0.0, jnp.ceil(q), jnp.floor(q))


def _cube_uv(x, y, z):
    """Cube-cross UV for a unit-cube local point, matching uv.cube_uv
    (tracer.cl:113-175)."""
    ax = jnp.abs(x)
    ay = jnp.abs(y)
    az = jnp.abs(z)
    coord = jnp.maximum(jnp.maximum(ax, ay), az)

    third = jnp.float32(0.333333)
    v_mid = jnp.float32(0.6666666) - (_cfmod(y + 1.0, 2.0) * 0.5) * third
    u_right = 0.5 + (_cfmod(1.0 - z, 2.0) * 0.5) * 0.25
    u_left = (_cfmod(z + 1.0, 2.0) * 0.5) * 0.25
    u_top = 0.25 + (_cfmod(x + 1.0, 2.0) * 0.5) * 0.25
    v_top = 1.0 - (_cfmod(1.0 - z, 2.0) * 0.5) * third
    v_bottom = (_cfmod(z + 1.0, 2.0) * 0.5) * third
    u_back = 0.75 + (_cfmod(1.0 - x, 2.0) * 0.5) * 0.25

    sel_right = coord == x
    sel_left = (~sel_right) & (coord == -x)
    sel_top = (~sel_right) & (~sel_left) & (coord == y)
    sel_bottom = (~sel_right) & (~sel_left) & (~sel_top) & (coord == -y)
    sel_front = (~sel_right) & (~sel_left) & (~sel_top) & (~sel_bottom) \
        & (coord == z)

    u = jnp.where(sel_right, u_right,
        jnp.where(sel_left, u_left,
        jnp.where(sel_top, u_top,
        jnp.where(sel_bottom, u_top,
        jnp.where(sel_front, u_top, u_back)))))
    v = jnp.where(sel_top, v_top,
        jnp.where(sel_bottom, v_bottom, v_mid))
    return u, v


def _wrap_tex(a, m):
    """Floor-mod wrap of a float-held integer coordinate to [0, m)."""
    fm = jnp.float32(m)
    return a - fm * jnp.floor(a / fm)


def _sample_proc(desc, w: int, h: int, u, v):
    """Bilinear REPEAT sample of a PROCEDURAL texture: the four texel
    taps are COMPUTED with the proctex program (incl. the pool's rgb8
    quantization) instead of gathered (render/proctex.py). Semantics
    match uv.sample_texture_pool / tracer.cl:829 (normalized coords,
    REPEAT, LINEAR)."""
    from . import proctex

    fx = u * jnp.float32(w) - 0.5
    fy = v * jnp.float32(h) - 0.5
    x0 = jnp.floor(fx)
    y0 = jnp.floor(fy)
    tx = fx - x0
    ty = fy - y0
    x0w = _wrap_tex(x0, w)
    x1w = _wrap_tex(x0 + 1.0, w)
    y0w = _wrap_tex(y0, h)
    y1w = _wrap_tex(y0 + 1.0, h)

    c00 = proctex.eval_texel(jnp, desc, x0w, y0w, h, w)
    c01 = proctex.eval_texel(jnp, desc, x1w, y0w, h, w)
    c10 = proctex.eval_texel(jnp, desc, x0w, y1w, h, w)
    c11 = proctex.eval_texel(jnp, desc, x1w, y1w, h, w)
    out = []
    for k in range(3):
        top = c00[k] * (1.0 - tx) + c01[k] * tx
        bot = c10[k] * (1.0 - tx) + c11[k] * tx
        out.append(top * (1.0 - ty) + bot * ty)
    return out


def _tex_groups(entries, obj_types):
    """Group per-object texture records that share (desc, w, h, sx, sy)
    and primitive type (the type picks the UV mapping), so objects with
    the same program evaluate it once per bounce (e.g. the three
    squares-textured walls of the `textures` scene)."""
    groups = {}
    for (slot, desc, w, h, sx, sy) in entries:
        key = (desc, w, h, sx, sy, obj_types[slot])
        groups.setdefault(key, []).append(slot)
    return [(slots, desc, w, h, sx, sy, tcode)
            for (desc, w, h, sx, sy, tcode), slots in groups.items()]


# --- BVH traversal ---------------------------------------------------------


def _any(mask):
    """Block-wide any() as an i32 max-reduce (Triton has no or-reduce)."""
    return jnp.max(mask.astype(jnp.int32)) > 0


def _inv_safe(d, eps):
    ok = jnp.abs(d) >= eps
    return jnp.where(ok, 1.0 / jnp.where(ok, d, 1.0), _BIG)


def _slab_hit(bmin, bmax, ox, oy, oz, ix, iy, iz, eps, bt):
    """Ray/box slab test with hoisted reciprocals; True where the box is
    entered in front of the ray and closer than bt."""
    ax1 = (bmin[0] - ox) * ix
    ax2 = (bmax[0] - ox) * ix
    ay1 = (bmin[1] - oy) * iy
    ay2 = (bmax[1] - oy) * iy
    az1 = (bmin[2] - oz) * iz
    az2 = (bmax[2] - oz) * iz
    tmin = jnp.maximum(
        jnp.maximum(jnp.minimum(ax1, ax2), jnp.minimum(ay1, ay2)),
        jnp.minimum(az1, az2))
    tmax = jnp.minimum(
        jnp.minimum(jnp.maximum(ax1, ax2), jnp.maximum(ay1, ay2)),
        jnp.maximum(az1, az2))
    return (tmin <= tmax) & (tmax > eps) & (tmin < bt)


def _leaf_test(row, ox, oy, oz, dx, dy, dz, eps):
    """Dual-basis ray/triangle test against one triangle row (12 values:
    P1, Ng, U, V; scalars or per-lane). t = (P1 - o).Ng / d.Ng and
    u = h.U, v = h.V with h = o - P1 + t d: the same hits as
    Möller–Trumbore (tracer.cl:640-674) — |d.Ng| equals its |det|, so the
    eps degeneracy test is unchanged. Returns (t or _BIG, u, v)."""
    pxx = ox - row[0]
    pyy = oy - row[1]
    pzz = oz - row[2]
    den = dx * row[3] + dy * row[4] + dz * row[5]
    num_t = -(pxx * row[3] + pyy * row[4] + pzz * row[5])
    den_ok = jnp.abs(den) >= eps
    t = num_t / jnp.where(den_ok, den, 1.0)
    hx = pxx + t * dx
    hy = pyy + t * dy
    hz = pzz + t * dz
    u = hx * row[6] + hy * row[7] + hz * row[8]
    v = hx * row[9] + hy * row[10] + hz * row[11]
    valid = den_ok & (u >= 0.0) & (v >= 0.0) & (u + v <= 1.0) & (t > eps)
    return jnp.where(valid, t, _BIG), u, v


def _packet_traverse(node_ref, tri_ref, meta: SceneMeta, root: int,
                     end: int, eps, t_max, ox, oy, oz, dx, dy, dz, active,
                     bt0):
    """Packet skip-link BVH walk: ONE node index for the whole block. Each
    step loads one node as scalars, slab-tests every ray against it and
    descends (idx+1) if any ray hits, else skips the subtree (exit link);
    leaves test their triangles (scalar loads) against every ray of the
    block. The walk uses the front-to-back node copy of the block's
    majority direction octant. best-t starts at `bt0` (the closest hit
    among earlier objects) so occluded subtrees prune immediately.

    Returns (t, slot, u, v): the closest triangle hit (t = bt0 and
    slot = -1 where no triangle beat it) with its barycentrics."""
    K = meta.leaf_size
    shape = ox.shape
    ix = _inv_safe(dx, eps)
    iy = _inv_safe(dy, eps)
    iz = _inv_safe(dz, eps)
    if meta.octant_orders:
        act = active.astype(jnp.int32)
        half = jnp.sum(act)
        neg = lambda d: (2 * jnp.sum(act * (d < 0.0).astype(jnp.int32))
                         > half).astype(jnp.int32)
        base = (1 + neg(dx) + 2 * neg(dy) + 4 * neg(dz)) * meta.n_nodes
    else:
        base = jnp.int32(0)
    end_e = base + end
    idx0 = jnp.where(_any(active), base + root, end_e)
    slot0 = jnp.full(shape, -1, jnp.int32)
    zero = jnp.zeros(shape, jnp.float32)

    def cond(st):
        return st[0] < end_e

    def body(st):
        idx, bt, slot, bu, bv = st
        row = idx * _NODE_COLS
        node = [node_ref[row + k] for k in range(9)]
        hit = active & _slab_hit(node[0:3], node[3:6], ox, oy, oz,
                                 ix, iy, iz, eps, bt)
        anyhit = _any(hit)

        def leaf_fn(carry):
            bt, slot, bu, bv = carry
            start = node[6].astype(jnp.int32)
            for s in range(K):
                trow = (start + s) * _TRI_COLS
                tri = [tri_ref[trow + c] for c in range(12)]
                t, u, v = _leaf_test(tri, ox, oy, oz, dx, dy, dz, eps)
                won = hit & (t < bt) & (t < t_max)
                bt = jnp.where(won, t, bt)
                slot = jnp.where(won, start + s, slot)
                bu = jnp.where(won, u, bu)
                bv = jnp.where(won, v, bv)
            return bt, slot, bu, bv

        bt, slot, bu, bv = jax.lax.cond(
            anyhit & (node[7] > 0.5), leaf_fn, lambda c: c,
            (bt, slot, bu, bv))
        nxt = jnp.where(anyhit, idx + 1, node[8].astype(jnp.int32))
        return nxt, bt, slot, bu, bv

    _, bt, slot, bu, bv = jax.lax.while_loop(
        cond, body, (idx0, bt0, slot0, zero, zero))
    return bt, slot, bu, bv


def _tri_payload(tri_ref, meta: SceneMeta, slot, u, v):
    """Smooth normal n1 + u*(n2-n1) + v*(n3-n1) (tracer.cl:669) and color
    of each lane's winning triangle slot (slot < 0: unused values)."""
    row = jnp.maximum(slot, 0) * _TRI_COLS
    g = lambda c: tri_ref[row + c]
    nrm = tuple(g(12 + k) + g(15 + k) * u + g(18 + k) * v for k in range(3))
    if meta.tri_uniform_color is not None:
        col = tuple(jnp.full(u.shape, c, jnp.float32)
                    for c in meta.tri_uniform_color)
    else:
        col = (g(21), g(22), g(23))
    return nrm, col


# --- the kernel --------------------------------------------------------------


def _make_kernel(meta: SceneMeta, cfg: RenderConfig, spp: int,
                 total_samples: int, width: int):
    """Build the block kernel body closed over static scene structure."""
    obj_types = meta.obj_types
    group_bvh = {g: (r, e) for g, r, e in meta.group_bvh}
    eps = cfg.epsilon
    t_max = cfg.t_max
    max_b = cfg.max_bounces
    max_eff = cfg.max_effective_bounces
    golden2 = ((math.sqrt(5.0) + 1.0) / 2.0) ** 2
    sun_n = float(total_samples)
    sun_b = round(2.0 * math.sqrt(sun_n))  # sunflower boundary count
    # static texture programs: one masked in-kernel evaluation per
    # distinct (program, scale, type) per bounce (see _sample_proc;
    # untextured scenes compile none of this)
    tex_groups = _tex_groups(meta.obj_tex, obj_types) \
        if meta.textured_types else []
    nm_groups = _tex_groups(meta.obj_tex_nm, obj_types) \
        if meta.has_normal_maps else []
    track_obj = bool(tex_groups or nm_groups)

    def kernel(seed_ref, cam_ref, obj_ref, node_ref, tri_ref, pix_ref,
               out_r, out_g, out_b):
        def obj(j, k):
            return obj_ref[j * _OBJ_COLS + k]

        pix = pix_ref[...]
        shape = pix.shape
        pkey = _pixel_key(seed_ref[0], pix)
        # global sample base for segmented/sharded launches: the RNG and
        # the sunflower DoF index both use the GLOBAL sample index
        sample_base = seed_ref[1]
        fx = (pix % width).astype(jnp.float32)
        fy = (pix // width).astype(jnp.float32)

        cam = [cam_ref[k] for k in range(12)]
        pixel_size = cam_ref[12]
        half_w = cam_ref[13]
        half_h = cam_ref[14]
        aperture = jnp.full(shape, cam_ref[15], jnp.float32)
        focal = cam_ref[16]
        has_dof = aperture != 0.0
        # camera origin = inverse(0,0,0) = the translation column
        oxw = jnp.full(shape, cam[3], jnp.float32)
        oyw = jnp.full(shape, cam[7], jnp.float32)
        ozw = jnp.full(shape, cam[11], jnp.float32)

        def intersect_group(j, tox, toy, toz, tdx, tdy, tdz, active, bt):
            """Group bbox pretest, then the BVH walk."""
            x1, x2 = _axis_slab(tox, tdx, obj(j, 34), obj(j, 37), eps)
            y1, y2 = _axis_slab(toy, tdy, obj(j, 35), obj(j, 38), eps)
            z1, z2 = _axis_slab(toz, tdz, obj(j, 36), obj(j, 39), eps)
            gtmin = jnp.maximum(jnp.maximum(x1, y1), z1)
            gtmax = jnp.minimum(jnp.minimum(x2, y2), z2)
            pre = active & (gtmin <= gtmax) & (gtmax > eps) & (gtmin < bt)
            root, end = group_bvh[j]
            return _packet_traverse(node_ref, tri_ref, meta, root, end,
                                    eps, t_max, tox, toy, toz, tdx, tdy,
                                    tdz, pre, bt)

        def sample_body(n, acc):
            acc_r, acc_g, acc_b = acc
            gs = n + sample_base              # global sample index
            skey = _sample_key(pkey, gs)
            # --- rayForPixel (tracer.cl:745-779) -----------------------
            jx = _uniform(skey, 0)
            jy = _uniform(skey, 1)
            x_off = pixel_size * (fx + jx)
            y_off = pixel_size * (fy + jy)
            vx = half_w - x_off
            vy = half_h - y_off
            vz = jnp.full(shape, -1.0, jnp.float32)
            pxw, pyw, pzw = _mat12_point(cam, vx, vy, vz)
            dx, dy, dz = _normalize(pxw - oxw, pyw - oyw, pzw - ozw)

            # DoF via sunflower(totalSamples, alpha=2, n)
            # (tracer.cl:762-776)
            nf = jnp.full(shape, gs, jnp.int32).astype(jnp.float32)
            r_sun = jnp.where(
                nf <= (sun_n - sun_b),
                jnp.sqrt(jnp.maximum(nf - 0.5, 0.0))
                / math.sqrt(max(sun_n - (sun_b + 1.0) / 2.0, 1e-9)),
                1.0,
            )
            theta = 2.0 * math.pi * nf / golden2
            sun_x = r_sun * jnp.cos(theta)
            sun_y = r_sun * jnp.sin(theta)
            fpx = oxw + dx * focal
            fpy = oyw + dy * focal
            fpz = ozw + dz * focal
            dox = oxw + sun_y * aperture   # reference swaps x/y
            doy = oyw + sun_x * aperture
            ox = jnp.where(has_dof, dox, oxw)
            oy = jnp.where(has_dof, doy, oyw)
            oz = ozw
            dx = jnp.where(has_dof, fpx - dox, dx)
            dy = jnp.where(has_dof, fpy - doy, dy)
            dz = jnp.where(has_dof, fpz - oz, dz)

            ones = jnp.ones(shape, jnp.float32)
            zeros = jnp.zeros(shape, jnp.float32)
            izeros = jnp.zeros(shape, jnp.int32)

            def bounce_cond(st):
                return (st[0] < max_b) & (jnp.max(st[7]) > 0)

            def bounce_body(st):
                (b, ox, oy, oz, dx, dy, dz, alive_i, inside_i, n_hits, eff,
                 mask_r, mask_g, mask_b, srr, srg, srb) = st
                alive = alive_i > 0
                inside = inside_i > 0

                # ---- intersect: static unroll over objects ------------
                best_t = jnp.full(shape, _BIG, jnp.float32)
                l_ox, l_oy, l_oz = ox, oy, oz
                l_dx, l_dy, l_dz = dx, dy, dz
                col_r = zeros
                col_g = zeros
                col_b = zeros
                emi_r = zeros
                emi_g = zeros
                emi_b = zeros
                refl = zeros
                refr = ones
                invt = [zeros] * 12
                w_type = jnp.full(shape, -1, jnp.int32)
                w_obj = jnp.full(shape, -1, jnp.int32) if track_obj else None
                w_min_y = zeros
                w_max_y = zeros
                is_tri = jnp.zeros(shape, jnp.bool_)
                w_slot = jnp.full(shape, -1, jnp.int32)
                w_u = zeros
                w_v = zeros

                for j, code in enumerate(obj_types):
                    m = [obj(j, k) for k in range(12)]
                    tox, toy, toz = _mat12_point(m, ox, oy, oz)
                    tdx, tdy, tdz = _mat12_vec(m, dx, dy, dz)
                    if code == PLANE:
                        t_j = _plane_t(toy, tdy, eps)
                    elif code == SPHERE:
                        t_j = _sphere_t(tox, toy, toz, tdx, tdy, tdz, eps)
                    elif code == CYLINDER:
                        t_j = _cylinder_t(tox, toy, toz, tdx, tdy, tdz,
                                          obj(j, 32), obj(j, 33), eps)
                    elif code == BOX:
                        t_j = _box_t(tox, toy, toz, tdx, tdy, tdz, eps)
                    else:  # GROUP
                        t_j, g_slot, g_u, g_v = intersect_group(
                            j, tox, toy, toz, tdx, tdy, tdz, alive, best_t)

                    closer = t_j < best_t
                    best_t = jnp.where(closer, t_j, best_t)
                    l_ox = jnp.where(closer, tox, l_ox)
                    l_oy = jnp.where(closer, toy, l_oy)
                    l_oz = jnp.where(closer, toz, l_oz)
                    l_dx = jnp.where(closer, tdx, l_dx)
                    l_dy = jnp.where(closer, tdy, l_dy)
                    l_dz = jnp.where(closer, tdz, l_dz)
                    if code == GROUP:
                        # per-triangle color and normal come from the
                        # winning slot after the loop; emission is 0 for
                        # mesh hits (tracer.cl:672-673, 1071-1073)
                        is_tri = jnp.where(closer, True, is_tri)
                        w_slot = jnp.where(closer, g_slot, w_slot)
                        w_u = jnp.where(closer, g_u, w_u)
                        w_v = jnp.where(closer, g_v, w_v)
                        emi_r = jnp.where(closer, 0.0, emi_r)
                        emi_g = jnp.where(closer, 0.0, emi_g)
                        emi_b = jnp.where(closer, 0.0, emi_b)
                    else:
                        is_tri = jnp.where(closer, False, is_tri)
                        col_r = jnp.where(closer, obj(j, 24), col_r)
                        col_g = jnp.where(closer, obj(j, 25), col_g)
                        col_b = jnp.where(closer, obj(j, 26), col_b)
                        emi_r = jnp.where(closer, obj(j, 27), emi_r)
                        emi_g = jnp.where(closer, obj(j, 28), emi_g)
                        emi_b = jnp.where(closer, obj(j, 29), emi_b)
                    refr = jnp.where(closer, obj(j, 30), refr)
                    refl = jnp.where(closer, obj(j, 31), refl)
                    w_min_y = jnp.where(closer, obj(j, 32), w_min_y)
                    w_max_y = jnp.where(closer, obj(j, 33), w_max_y)
                    invt = [jnp.where(closer, obj(j, 12 + k), invt[k])
                            for k in range(12)]
                    w_type = jnp.where(closer, code, w_type)
                    if track_obj:
                        w_obj = jnp.where(closer, j, w_obj)

                tnx = tny = tnz = zeros
                if meta.has_groups:
                    (tnx, tny, tnz), (tcr, tcg, tcb) = _tri_payload(
                        tri_ref, meta, jnp.where(is_tri, w_slot, -1),
                        w_u, w_v)
                    col_r = jnp.where(is_tri, tcr, col_r)
                    col_g = jnp.where(is_tri, tcg, col_g)
                    col_b = jnp.where(is_tri, tcb, col_b)

                hit_ok = best_t < t_max
                t = jnp.minimum(best_t, t_max)

                # ---- surface normal by type (tracer.cl:903-950) -------
                lx = l_ox + l_dx * t
                ly = l_oy + l_dy * t
                lz = l_oz + l_dz * t
                # cylinder incl. caps
                dist = lx * lx + lz * lz
                top = (dist < 1.0) & (ly >= w_max_y - eps)
                bot = (dist < 1.0) & (ly <= w_min_y + eps)
                cyl_nx = jnp.where(top | bot, zeros, lx)
                cyl_ny = jnp.where(top, ones, jnp.where(bot, -ones, zeros))
                cyl_nz = jnp.where(top | bot, zeros, lz)
                # box: dominant axis
                ax = jnp.abs(lx)
                ay = jnp.abs(ly)
                az = jnp.abs(lz)
                maxc = jnp.maximum(jnp.maximum(ax, ay), az)
                sel_x = maxc == ax
                sel_y = (~sel_x) & (maxc == ay)
                box_nx = jnp.where(sel_x, lx, zeros)
                box_ny = jnp.where(sel_y, ly, zeros)
                box_nz = jnp.where(sel_x | sel_y, zeros, lz)

                is_plane = w_type == PLANE
                is_cyl = w_type == CYLINDER
                is_box = w_type == BOX
                nlx = jnp.where(is_tri, tnx,
                      jnp.where(is_plane, zeros,
                      jnp.where(is_cyl, cyl_nx,
                      jnp.where(is_box, box_nx, lx))))
                nly = jnp.where(is_tri, tny,
                      jnp.where(is_plane, ones,
                      jnp.where(is_cyl, cyl_ny,
                      jnp.where(is_box, box_ny, ly))))
                nlz = jnp.where(is_tri, tnz,
                      jnp.where(is_plane, zeros,
                      jnp.where(is_cyl, cyl_nz,
                      jnp.where(is_box, box_nz, lz))))
                # plane normal maps: the COMPUTED texel is the
                # object-space normal (tracer.cl:907-911; normalized
                # after the invt transform below)
                for (slots, desc, twn, thn, sxn, syn, _t) in nm_groups:
                    msk = functools.reduce(
                        jnp.logical_or, [w_obj == s for s in slots])
                    nm_u = jnp.abs(lx) * sxn
                    nm_v = jnp.abs(lz) * syn
                    nmx, nmy, nmz = _sample_proc(desc, twn, thn, nm_u, nm_v)
                    nlx = jnp.where(msk, nmx, nlx)
                    nly = jnp.where(msk, nmy, nly)
                    nlz = jnp.where(msk, nmz, nlz)
                nx, ny, nz = _mat12_vec(invt, nlx, nly, nlz)
                nx, ny, nz = _normalize(nx, ny, nz)
                # face-forward
                ex, ey, ez = -dx, -dy, -dz
                flip = _dot(ex, ey, ez, nx, ny, nz) < 0.0
                nx = jnp.where(flip, -nx, nx)
                ny = jnp.where(flip, -ny, ny)
                nz = jnp.where(flip, -nz, nz)

                # ---- texture color (tracer.cl:1075-1093): computed, not
                # gathered — one masked program eval per distinct texture
                for (slots, desc, tw, th, sx, sy, tcode) in tex_groups:
                    msk = functools.reduce(
                        jnp.logical_or, [w_obj == s for s in slots])
                    if tcode == PLANE:
                        tu = lx * sx
                        tv = lz * sy
                    elif tcode == SPHERE:
                        tu, tv = _spherical_uv(lx, ly, lz)
                    else:  # BOX (cube-cross)
                        tu, tv = _cube_uv(lx, ly, lz)
                    tcr, tcg, tcb = _sample_proc(desc, tw, th, tu, tv)
                    col_r = jnp.where(msk, tcr, col_r)
                    col_g = jnp.where(msk, tcg, col_g)
                    col_b = jnp.where(msk, tcb, col_b)

                # ---- material roulette (tracer.cl:982-1061) -----------
                u_refl = _uniform(skey, 2, b)
                u_schl = _uniform(skey, 3, b)
                u1 = _uniform(skey, 4, b)
                u2 = _uniform(skey, 5, b)

                wx = ox + dx * t
                wy = oy + dy * t
                wz = oz + dz * t
                over_x = wx + nx * eps
                over_y = wy + ny * eps
                over_z = wz + nz * eps
                under_x = wx - nx * eps
                under_y = wy - ny * eps
                under_z = wz - nz * eps

                do_reflect = (refl != 0.0) & (u_refl < refl)
                thin = (~do_reflect) & (refr == -1.0)
                sch_thin = _schlick(ex, ey, ez, nx, ny, nz,
                                    jnp.float32(1.0), jnp.float32(1.5))
                thin_pass = thin & (sch_thin < u_schl)
                thin_reflect = thin & ~(sch_thin < u_schl)

                solid = (~do_reflect) & (~thin) & (refr != 1.0)
                outside = ~inside
                sch = jnp.where(
                    outside,
                    _schlick(ex, ey, ez, nx, ny, nz, jnp.float32(1.0), refr),
                    _schlick(ex, ey, ez, nx, ny, nz, refr, jnp.float32(1.0)),
                )
                do_refract = solid & (sch < u_schl)
                rf_o = _refract(ex, ey, ez, nx, ny, nz, jnp.float32(1.0),
                                refr)
                rf_i = _refract(ex, ey, ez, nx, ny, nz, refr,
                                jnp.float32(1.0))
                rfx = jnp.where(outside, rf_o[0], rf_i[0])
                rfy = jnp.where(outside, rf_o[1], rf_i[1])
                rfz = jnp.where(outside, rf_o[2], rf_i[2])
                solid_reflect = solid & ~do_refract
                diffuse = (~do_reflect) & (~thin) & (~solid)

                # cosine-weighted hemisphere (tracer.cl:348-366)
                rand1 = 2.0 * math.pi * u1
                rand2s = jnp.sqrt(u2)
                pick = jnp.abs(nx) > 0.1
                axx = jnp.where(pick, zeros, ones)
                axy = jnp.where(pick, ones, zeros)
                # u = axis x n, normalized
                ux = axy * nz
                uy = -(axx * nz)
                uz = axx * ny - axy * nx
                ux, uy, uz = _normalize(ux, uy, uz)
                # v = n x u
                vx2 = ny * uz - nz * uy
                vy2 = nz * ux - nx * uz
                vz2 = nx * uy - ny * ux
                cu = jnp.cos(rand1) * rand2s
                cv = jnp.sin(rand1) * rand2s
                cn = jnp.sqrt(1.0 - u2)
                hx = ux * cu + vx2 * cv + nx * cn
                hy = uy * cu + vy2 * cv + ny * cn
                hz = uz * cu + vz2 * cv + nz * cn

                ddn = 2.0 * _dot(dx, dy, dz, nx, ny, nz)
                rx = dx - nx * ddn
                ry = dy - ny * ddn
                rz = dz - nz * ddn

                any_reflect = do_reflect | thin_reflect | solid_reflect
                ndx = jnp.where(any_reflect, rx,
                      jnp.where(thin_pass, dx,
                      jnp.where(do_refract, rfx, hx)))
                ndy = jnp.where(any_reflect, ry,
                      jnp.where(thin_pass, dy,
                      jnp.where(do_refract, rfy, hy)))
                ndz = jnp.where(any_reflect, rz,
                      jnp.where(thin_pass, dz,
                      jnp.where(do_refract, rfz, hz)))
                cos = jnp.where(diffuse, _dot(hx, hy, hz, nx, ny, nz), 1.0)
                go_under = thin_pass | do_refract
                nox = jnp.where(go_under, under_x, over_x)
                noy = jnp.where(go_under, under_y, over_y)
                noz = jnp.where(go_under, under_z, over_z)

                entering = do_refract & outside
                exiting = do_refract & inside
                new_inside_i = jnp.where(
                    do_refract, outside.astype(jnp.int32), inside_i)
                is_refraction = entering | exiting

                # ---- fold resolve forward (tracer.cl:1116-1176) -------
                rec = alive & hit_ok
                no_refr = rec & ~is_refraction
                is_light = emi_r > 0.0

                srr = srr + jnp.where(no_refr, mask_r * emi_r, 0.0)
                srg = srg + jnp.where(no_refr, mask_g * emi_g, 0.0)
                srb = srb + jnp.where(no_refr, mask_b * emi_b, 0.0)

                # ---- optional next-event estimation (tracer.cl:786-829;
                # the reference ships with the call disabled,
                # tracer.cl:1168) — statically elided unless cfg.nee.
                # One shadow traversal per light per bounce, exactly as
                # biased as the reference (the BSDF light hit is NOT
                # shadow-discounted), using the PRE-update mask and the
                # post-texture color like integrator._next_event_estimation
                if cfg.nee and meta.light_indices:
                    nee_cond = no_refr & ~is_light
                    for li, l in enumerate(meta.light_indices):
                        nu1 = _uniform(skey, 6 + 2 * li, b)
                        nu2 = _uniform(skey, 7 + 2 * li, b)
                        # randomPointOnSphere (tracer.cl:321-336) kept
                        # verbatim incl. its latitude offset
                        lat = _acos(2.0 * nu1 - 1.0) - 2.0 * math.pi
                        lon = 2.0 * math.pi * nu2
                        cl = jnp.cos(lat)
                        scale_by = obj(l, 43)
                        lpx = obj(l, 40) + cl * jnp.cos(lon) * scale_by
                        lpy = obj(l, 41) \
                            + (jnp.sin(lat) - math.pi * 0.25) * scale_by
                        lpz = obj(l, 42) + cl * jnp.sin(lon) * scale_by
                        sdx, sdy, sdz = _normalize(lpx - wx, lpy - wy,
                                                   lpz - wz)
                        sox = wx + sdx * eps
                        soy = wy + sdy * eps
                        soz = wz + sdz * eps
                        ldn = _dot(sdx, sdy, sdz, nx, ny, nz)
                        # nearest shadow hit over the whole scene: the
                        # same static unroll as the main intersect, t and
                        # winning index only
                        s_best = jnp.full(shape, _BIG, jnp.float32)
                        s_idx = jnp.full(shape, -1, jnp.int32)
                        for j, code in enumerate(obj_types):
                            m = [obj(j, k) for k in range(12)]
                            stox, stoy, stoz = _mat12_point(
                                m, sox, soy, soz)
                            stdx, stdy, stdz = _mat12_vec(
                                m, sdx, sdy, sdz)
                            if code == PLANE:
                                t_s = _plane_t(stoy, stdy, eps)
                            elif code == SPHERE:
                                t_s = _sphere_t(stox, stoy, stoz,
                                                stdx, stdy, stdz, eps)
                            elif code == CYLINDER:
                                t_s = _cylinder_t(
                                    stox, stoy, stoz, stdx, stdy, stdz,
                                    obj(j, 32), obj(j, 33), eps)
                            elif code == BOX:
                                t_s = _box_t(stox, stoy, stoz,
                                             stdx, stdy, stdz, eps)
                            else:
                                t_s = intersect_group(
                                    j, stox, stoy, stoz, stdx, stdy, stdz,
                                    nee_cond, s_best)[0]
                            s_closer = t_s < s_best
                            s_best = jnp.where(s_closer, t_s, s_best)
                            s_idx = jnp.where(s_closer, j, s_idx)
                        visible = (nee_cond & (ldn > 0.0) & (s_idx == l)
                                   & (s_best > eps) & (s_best < t_max))
                        sxl = obj(l, 44)
                        atten = 1.0 - s_best / jnp.sqrt(
                            s_best * s_best + sxl * sxl)
                        w_nee = ldn * atten
                        srr = srr + jnp.where(
                            visible, mask_r * col_r * obj(l, 27) * w_nee,
                            0.0)
                        srg = srg + jnp.where(
                            visible, mask_g * col_g * obj(l, 28) * w_nee,
                            0.0)
                        srb = srb + jnp.where(
                            visible, mask_b * col_b * obj(l, 29) * w_nee,
                            0.0)

                direct = no_refr & is_light & (n_hits == 0)
                srr = jnp.where(direct, col_r, srr)
                srg = jnp.where(direct, col_g, srg)
                srb = jnp.where(direct, col_b, srb)
                upd = no_refr & ~is_light
                mask_r = jnp.where(upd, mask_r * col_r * cos, mask_r)
                mask_g = jnp.where(upd, mask_g * col_g * cos, mask_g)
                mask_b = jnp.where(upd, mask_b * col_b * cos, mask_b)

                eff = eff + jnp.where(
                    rec & ~is_refraction & ~any_reflect, 1, 0)
                n_hits = n_hits + rec.astype(jnp.int32)
                alive_i = (
                    alive & hit_ok & ~(rec & is_light) & (eff < max_eff)
                ).astype(jnp.int32)

                ox = jnp.where(rec, nox, ox)
                oy = jnp.where(rec, noy, oy)
                oz = jnp.where(rec, noz, oz)
                dx = jnp.where(rec, ndx, dx)
                dy = jnp.where(rec, ndy, dy)
                dz = jnp.where(rec, ndz, dz)
                inside_i = jnp.where(rec, new_inside_i, inside_i)

                return (b + 1, ox, oy, oz, dx, dy, dz, alive_i, inside_i,
                        n_hits, eff, mask_r, mask_g, mask_b, srr, srg, srb)

            st = (jnp.int32(0), ox, oy, oz, dx, dy, dz,
                  jnp.ones(shape, jnp.int32), izeros, izeros, izeros,
                  ones, ones, ones, zeros, zeros, zeros)
            st = jax.lax.while_loop(bounce_cond, bounce_body, st)
            return (acc_r + st[14], acc_g + st[15], acc_b + st[16])

        zero = jnp.zeros(shape, jnp.float32)
        acc_r, acc_g, acc_b = jax.lax.fori_loop(
            0, spp, sample_body, (zero, zero, zero))
        out_r[...] = acc_r
        out_g[...] = acc_g
        out_b[...] = acc_b

    return kernel


@functools.partial(
    jax.jit,
    static_argnames=("meta", "cfg", "spp", "total_samples", "block",
                     "interpret"),
)
def trace_tiles(
    seed: jnp.ndarray,          # i32 [2]: (seed, global sample base)
    cam_vec: jnp.ndarray,       # [_CAM_COLS] f32
    obj_table: jnp.ndarray,     # flat f32 tables from scene_tables
    node_table: jnp.ndarray,
    tri_table: jnp.ndarray,
    pix: jnp.ndarray,           # i32 [P] flat pixel index per slot
    meta: SceneMeta = None,
    cfg: RenderConfig = None,
    spp: int = 1,
    total_samples: int = 1,
    block: int = DEFAULT_BLOCK,
    interpret: bool = False,
):
    """Run the megakernel over every pixel slot; returns the (r, g, b)
    radiance SUMS of `spp` samples per slot, each [P]. P must be a
    multiple of `block` (pixel_slots pads). interpret=True runs the kernel
    on the CPU and is for tests only."""
    if block & (block - 1) or pix.shape[0] % block:
        raise ValueError(
            f"block={block} must be a power of two dividing "
            f"{pix.shape[0]} slots")
    kernel = _make_kernel(meta, cfg, spp, total_samples, cfg.width)
    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    slots = pl.BlockSpec((block,), lambda i: (i,))
    return pl.pallas_call(
        kernel,
        grid=(pix.shape[0] // block,),
        in_specs=[whole(seed), whole(cam_vec), whole(obj_table),
                  whole(node_table), whole(tri_table), slots],
        out_specs=[slots] * 3,
        out_shape=[jax.ShapeDtypeStruct(pix.shape, jnp.float32)] * 3,
        compiler_params=pltriton.CompilerParams(num_warps=DEFAULT_WARPS,
                                                num_stages=1),
        interpret=interpret,
        name="pathtrace_megakernel",
    )(seed, cam_vec, obj_table, node_table, tri_table, pix)


def render_pallas(scn: SceneArrays, meta: SceneMeta, camera,
                  cfg: RenderConfig, seed: int = None,
                  interpret: bool = False,
                  block: int = DEFAULT_BLOCK) -> np.ndarray:
    """Full-image render via the megakernel. Returns [H, W, 3] float32."""
    if not supports_scene(meta):
        raise ValueError("scene not supported by the megakernel")
    W, H = camera.width, camera.height
    pix = jnp.asarray(pixel_slots(W, H, block))
    obj, nodes, tris = scene_tables(scn, meta)
    r, g, b = trace_tiles(
        jnp.asarray([cfg.seed if seed is None else seed, 0], jnp.int32),
        jnp.asarray(build_camera_vec(camera)), obj, nodes, tris, pix,
        meta=meta, cfg=cfg.replace(width=W, height=H), spp=cfg.samples,
        total_samples=cfg.samples, block=block, interpret=interpret,
    )
    img = np.stack([np.asarray(c)[:W * H] for c in (r, g, b)], axis=-1)
    return img.reshape(H, W, 3) / float(cfg.samples)
