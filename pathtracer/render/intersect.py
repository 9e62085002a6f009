"""Scene intersection: statically-unrolled primitive tests + stackless
skip-link BVH, all in SoA [R]-per-component layout (see vec3.py).

Behavioral equivalent of the reference's findClosestIntersection
(internal/ocl/tracer.cl:537-742):

- rays are transformed into each object's space by the cached inverse
  (tracer.cl:547-548), then tested per type: plane (tracer.cl:478), sphere
  (448), cylinder minus caps (396, caps disabled in the reference too),
  box (378), group/BVH (598-719)
- intersections strictly closer than EPSILON are discarded and anything at
  t >= 1024 counts as a miss (tracer.cl:727-739)

Design decisions:
- the object loop is a STATIC python unroll over meta.obj_types, so each
  object's 4x4 inverse elements become broadcast scalars (no gathers) and
  each object compiles to exactly its own primitive test
- the per-ray BVH walk replaces the reference's explicit int stack[64]
  (tracer.cl:624) with one skip-link index per ray inside a lax.while_loop;
  leaf triangles are tested through a static LEAF_SIZE unroll of [R]
  gathers — no [R, L] buffers, no lane-padding waste
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..scene.pack import SceneArrays, SceneMeta
from ..scene.shapes import BOX, CYLINDER, GROUP, PLANE, SPHERE
from .vec3 import Vec3, mat_apply_point, mat_apply_vector


class Hit(NamedTuple):
    t: jnp.ndarray           # [R] distance; >= t_max means miss
    obj_idx: jnp.ndarray     # [R] i32 object slot (clipped valid; check t)
    local_origin: Vec3       # [R] ray origin in the HIT object's space
    local_dir: Vec3          # [R] ray direction in the hit object's space
    is_tri: jnp.ndarray      # [R] bool: hit a BVH triangle
    tri_slot: jnp.ndarray    # [R] i32 triangle slot (-1 none)
    tri_u: jnp.ndarray       # [R] barycentric u
    tri_v: jnp.ndarray       # [R] barycentric v


def _axis_slab(o, d, mn, mx, eps):
    """One-axis checkAxis (tracer.cl:250-268); scalars are [R] streams."""
    big = 1e30
    use = jnp.abs(d) >= eps
    d_safe = jnp.where(use, d, 1.0)
    t1 = jnp.where(use, (mn - o) / d_safe, (mn - o) * big)
    t2 = jnp.where(use, (mx - o) / d_safe, (mx - o) * big)
    return jnp.minimum(t1, t2), jnp.maximum(t1, t2)


def slab_test(o: Vec3, d: Vec3, bb_min: Vec3, bb_max: Vec3, eps
              ) -> Tuple[jnp.ndarray, jnp.ndarray]:
    """Ray/AABB slab test (tracer.cl:270-280) -> (tmin, tmax)."""
    x1, x2 = _axis_slab(o.x, d.x, bb_min.x, bb_max.x, eps)
    y1, y2 = _axis_slab(o.y, d.y, bb_min.y, bb_max.y, eps)
    z1, z2 = _axis_slab(o.z, d.z, bb_min.z, bb_max.z, eps)
    return (
        jnp.maximum(jnp.maximum(x1, y1), z1),
        jnp.minimum(jnp.minimum(x2, y2), z2),
    )


# ---------------------------------------------------------------------------
# Primitive tests: object-space Vec3 rays -> closest valid t [R] (inf = miss)
# ---------------------------------------------------------------------------

def _plane_t(o: Vec3, d: Vec3, eps):
    ok = jnp.abs(d.y) > eps
    t = -o.y / jnp.where(ok, d.y, 1.0)
    return jnp.where(ok & (t > eps), t, jnp.inf)


def _sphere_t(o: Vec3, d: Vec3, eps):
    """Unit-sphere intersection (tracer.cl:448-476), reformulated for f32:
    the textbook b^2-4ac discriminant cancels catastrophically for strongly
    anisotropic object scales (the reference scene's light is squashed
    100:1); the geometric foot-point form is algebraically identical and
    stable (verified against f64 goldens)."""
    a = d.dot(d)
    t_mid = -o.dot(d) / a
    m = o + d * t_mid
    perp2 = m.dot(m)
    ok = perp2 < 1.0
    dt = jnp.sqrt(jnp.where(ok, (1.0 - perp2) / a, 0.0))
    t1 = t_mid - dt
    t2 = t_mid + dt
    return jnp.minimum(
        jnp.where(ok & (t1 > eps), t1, jnp.inf),
        jnp.where(ok & (t2 > eps), t2, jnp.inf),
    )


def _cylinder_t(o: Vec3, d: Vec3, min_y, max_y, eps):
    """Uncapped truncated cylinder (tracer.cl:396-446; caps disabled in the
    reference kernel too, tracer.cl:437-444)."""
    a = d.x * d.x + d.z * d.z
    ok_a = jnp.abs(a) >= eps
    a_safe = jnp.where(ok_a, a, 1.0)
    t_mid = -(o.x * d.x + o.z * d.z) / a_safe
    mx = o.x + t_mid * d.x
    mz = o.z + t_mid * d.z
    perp2 = mx * mx + mz * mz
    ok = ok_a & (perp2 <= 1.0)
    dt = jnp.sqrt(jnp.where(ok, (1.0 - perp2) / a_safe, 0.0))
    t0 = t_mid - dt
    t1 = t_mid + dt
    y0 = o.y + t0 * d.y
    y1 = o.y + t1 * d.y
    v0 = ok & (y0 > min_y) & (y0 < max_y) & (t0 > eps)
    v1 = ok & (y1 > min_y) & (y1 < max_y) & (t1 > eps)
    return jnp.minimum(
        jnp.where(v0, t0, jnp.inf), jnp.where(v1, t1, jnp.inf)
    )


def _box_t(o: Vec3, d: Vec3, eps):
    one = Vec3.full(o.x.shape, 1.0, 1.0, 1.0, o.x.dtype)
    tmin, tmax = slab_test(o, d, -1.0 * one, one, eps)
    ok = tmin <= tmax
    t_near = jnp.where(ok & (tmin > eps), tmin, jnp.inf)
    t_far = jnp.where(ok & (tmax > eps), tmax, jnp.inf)
    return jnp.minimum(t_near, t_far)


# ---------------------------------------------------------------------------
# BVH traversal
# ---------------------------------------------------------------------------

class _TravState(NamedTuple):
    idx: jnp.ndarray        # [R] current node
    best_t: jnp.ndarray     # [R]
    best_slot: jnp.ndarray  # [R] triangle slot of best hit (-1 none)
    best_u: jnp.ndarray
    best_v: jnp.ndarray


def traverse_bvh(
    scn: SceneArrays,
    o: Vec3,            # object-space origin [R]
    d: Vec3,            # object-space direction [R]
    root: int,
    end: int,
    leaf_size: int,
    eps: float,
    t_max: float,
) -> _TravState:
    """Stackless skip-link walk over nodes [root, end). Replaces the
    reference's per-ray explicit stack (tracer.cl:624-718)."""
    n_nodes = scn.node_bb_min.shape[0]
    R = o.x.shape[0]
    dt = o.x.dtype

    init = _TravState(
        idx=jnp.full((R,), root, dtype=jnp.int32),
        best_t=jnp.full((R,), jnp.inf, dtype=dt),
        best_slot=jnp.full((R,), -1, dtype=jnp.int32),
        best_u=jnp.zeros((R,), dtype=dt),
        best_v=jnp.zeros((R,), dtype=dt),
    )

    def cond(s: _TravState):
        return jnp.any(s.idx < end)

    def body(s: _TravState) -> _TravState:
        active = s.idx < end
        ni = jnp.clip(s.idx, 0, n_nodes - 1)
        bb_min = Vec3(scn.node_bb_min[ni, 0], scn.node_bb_min[ni, 1],
                      scn.node_bb_min[ni, 2])
        bb_max = Vec3(scn.node_bb_max[ni, 0], scn.node_bb_max[ni, 1],
                      scn.node_bb_max[ni, 2])
        tmin, tmax = slab_test(o, d, bb_min, bb_max, eps)
        # (tmax > eps) and (tmin < best_t) are safe prunings the reference
        # lacks: a box entirely behind the ray, or entered beyond the
        # current best hit, cannot host a closer valid intersection.
        hit_box = active & (tmin < tmax) & (tmax > eps) & (tmin < s.best_t)
        is_leaf = scn.node_is_leaf[ni] == 1
        do_tri = hit_box & is_leaf
        start = scn.node_tri_start[ni]

        best_t, best_slot = s.best_t, s.best_slot
        best_u, best_v = s.best_u, s.best_v

        # static unroll over the leaf's LEAF_SIZE slots: [R] gathers only,
        # running-min update — no [R, L] lane-padded buffers
        for l in range(leaf_size):
            slot = start + l
            p1 = Vec3(scn.tri_p1[slot, 0], scn.tri_p1[slot, 1], scn.tri_p1[slot, 2])
            e1 = Vec3(scn.tri_e1[slot, 0], scn.tri_e1[slot, 1], scn.tri_e1[slot, 2])
            e2 = Vec3(scn.tri_e2[slot, 0], scn.tri_e2[slot, 1], scn.tri_e2[slot, 2])

            # Möller–Trumbore (tracer.cl:640-674)
            dc2 = d.cross(e2)
            det = e1.dot(dc2)
            det_ok = jnp.abs(det) >= eps
            f = 1.0 / jnp.where(det_ok, det, 1.0)
            p1o = o - p1
            u = f * p1o.dot(dc2)
            oc1 = p1o.cross(e1)
            v = f * d.dot(oc1)
            t = f * e2.dot(oc1)
            valid = (
                do_tri & det_ok
                & (u >= 0.0) & (u <= 1.0)
                & (v >= 0.0) & (u + v <= 1.0)
                & (t > eps) & (t < t_max)
            )
            better = valid & (t < best_t)
            best_t = jnp.where(better, t, best_t)
            best_slot = jnp.where(better, slot, best_slot)
            best_u = jnp.where(better, u, best_u)
            best_v = jnp.where(better, v, best_v)

        return _TravState(
            idx=jnp.where(active,
                          jnp.where(hit_box, s.idx + 1, scn.node_exit[ni]),
                          s.idx),
            best_t=best_t,
            best_slot=best_slot,
            best_u=best_u,
            best_v=best_v,
        )

    return jax.lax.while_loop(cond, body, init)


# ---------------------------------------------------------------------------
# Full scene intersection
# ---------------------------------------------------------------------------

def intersect_scene(
    scn: SceneArrays,
    meta: SceneMeta,
    origin: Vec3,     # [R] world
    direction: Vec3,  # [R] world
    eps: float,
    t_max: float,
) -> Hit:
    R = origin.x.shape[0]
    dt = origin.x.dtype

    best_t = jnp.full((R,), jnp.inf, dtype=dt)
    best_obj = jnp.full((R,), -1, dtype=jnp.int32)
    best_lo, best_ld = origin, direction
    is_tri = jnp.zeros((R,), dtype=bool)
    tri_slot = jnp.full((R,), -1, dtype=jnp.int32)
    tri_u = jnp.zeros((R,), dtype=dt)
    tri_v = jnp.zeros((R,), dtype=dt)

    group_bvh = dict((g, (r, e)) for g, r, e in meta.group_bvh)

    # STATIC unroll: each object contributes exactly its own test, with its
    # inverse matrix elements as broadcast scalars
    for j, code in enumerate(meta.obj_types):
        if code not in (PLANE, SPHERE, CYLINDER, BOX, GROUP):
            continue
        inv = scn.inverse[j]
        to = mat_apply_point(inv, origin)
        td = mat_apply_vector(inv, direction)

        tri_here = False
        if code == PLANE:
            t_j = _plane_t(to, td, eps)
        elif code == SPHERE:
            t_j = _sphere_t(to, td, eps)
        elif code == CYLINDER:
            t_j = _cylinder_t(to, td, scn.min_y[j], scn.max_y[j], eps)
        elif code == BOX:
            t_j = _box_t(to, td, eps)
        else:  # GROUP
            root, end = group_bvh[j]
            st = traverse_bvh(scn, to, td, root, end, meta.leaf_size,
                              eps, t_max)
            t_j = st.best_t
            tri_here = True

        closer = t_j < best_t
        best_t = jnp.where(closer, t_j, best_t)
        best_obj = jnp.where(closer, j, best_obj)
        best_lo = Vec3.where(closer, to, best_lo)
        best_ld = Vec3.where(closer, td, best_ld)
        if tri_here:
            is_tri = jnp.where(closer, True, is_tri)
            tri_slot = jnp.where(closer, st.best_slot, tri_slot)
            tri_u = jnp.where(closer, st.best_u, tri_u)
            tri_v = jnp.where(closer, st.best_v, tri_v)
        else:
            is_tri = jnp.where(closer, False, is_tri)

    return Hit(
        t=jnp.minimum(best_t, t_max),
        obj_idx=jnp.clip(best_obj, 0, None),
        local_origin=best_lo,
        local_dir=best_ld,
        is_tri=is_tri,
        tri_slot=tri_slot,
        tri_u=tri_u,
        tri_v=tri_v,
    )
