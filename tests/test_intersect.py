"""Intersection tests, numeric cases from the reference's host-side
primitives and 'Ray Tracer Challenge' tables (shapes/intersection*_test.go)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

import pathtracer.geometry as g
from pathtracer.scene.material import Material
from pathtracer.scene.pack import pack_scene
from pathtracer.scene.shapes import Cube, Cylinder, Group, Plane, Sphere, Triangle
from pathtracer.render.intersect import intersect_scene
from pathtracer.render.vec3 import Vec3

EPS = 1e-4
TMAX = 1024.0


def isect(objects, origins, directions):
    arrays, meta = pack_scene(objects)
    f = jax.jit(lambda o, d: intersect_scene(arrays, meta, o, d, EPS, TMAX))
    o = np.atleast_2d(np.asarray(origins, np.float32))
    d = np.atleast_2d(np.asarray(directions, np.float32))
    hit = f(Vec3(*(jnp.asarray(o[:, i]) for i in range(3))),
            Vec3(*(jnp.asarray(d[:, i]) for i in range(3))))
    # reconstruct the smooth triangle normal from (slot, u, v)
    slot = np.clip(np.asarray(hit.tri_slot), 0, None)
    u = np.asarray(hit.tri_u)[:, None]
    v = np.asarray(hit.tri_v)[:, None]
    n1 = np.asarray(arrays.tri_n1)[slot]
    n2 = np.asarray(arrays.tri_n2)[slot]
    n3 = np.asarray(arrays.tri_n3)[slot]
    tn = n2 * u + n3 * v + n1 * (1.0 - u - v)
    return (np.asarray(hit.t), np.asarray(hit.obj_idx),
            np.asarray(hit.is_tri), tn)


def test_sphere_two_points():
    t, oi, _, _ = isect([Sphere()], [0, 0, -5], [0, 0, 1])
    assert np.isclose(t[0], 4.0)  # nearest of (4, 6)


def test_sphere_inside():
    t, oi, _, _ = isect([Sphere()], [0, 0, 0], [0, 0, 1])
    assert np.isclose(t[0], 1.0)  # (-1, 1) -> only positive


def test_sphere_behind():
    t, _, _, _ = isect([Sphere()], [0, 0, 5], [0, 0, 1])
    assert t[0] >= TMAX  # both negative -> miss


def test_sphere_scaled():
    s = Sphere()
    s.set_transform(g.scale(2, 2, 2))
    t, _, _, _ = isect([s], [0, 0, -5], [0, 0, 1])
    assert np.isclose(t[0], 3.0)


def test_sphere_translated_miss():
    s = Sphere()
    s.set_transform(g.translate(5, 0, 0))
    t, _, _, _ = isect([s], [0, 0, -5], [0, 0, 1])
    assert t[0] >= TMAX


def test_plane_hit_from_above():
    t, _, _, _ = isect([Plane()], [0, 1, 0], [0, -1, 0])
    assert np.isclose(t[0], 1.0)


def test_plane_parallel_misses():
    t, _, _, _ = isect([Plane()], [0, 10, 0], [0, 0, 1])
    assert t[0] >= TMAX


@pytest.mark.parametrize(
    "origin,direction,expected",
    [
        ((5, 0.5, 0), (-1, 0, 0), 4.0),   # +x face
        ((-5, 0.5, 0), (1, 0, 0), 4.0),   # -x
        ((0.5, 5, 0), (0, -1, 0), 4.0),   # +y
        ((0.5, 0, 5), (0, 0, -1), 4.0),   # +z
        ((0, 0.5, 0), (0, 0, 1), 1.0),    # inside
    ],
)
def test_cube_table(origin, direction, expected):
    t, _, _, _ = isect([Cube()], origin, direction)
    assert np.isclose(t[0], expected, atol=1e-5)


def test_cube_miss():
    t, _, _, _ = isect([Cube()], [2, 2, 0], [0, 0, 1])
    assert t[0] >= TMAX


def test_cylinder_through():
    c = Cylinder(min_y=-1e9, max_y=1e9)
    t, _, _, _ = isect([c], [0, 0, -5], [0, 0, 1])
    assert np.isclose(t[0], 4.0, atol=1e-4)


def test_cylinder_truncated():
    # book table: cylinder limited to 1 < y < 2
    c = Cylinder(min_y=1.0, max_y=2.0)
    # ray through the middle horizontally at y=1.5 hits
    t, _, _, _ = isect([c], [0, 1.5, -2], [0, 0, 1])
    assert t[0] < TMAX
    # ray at y=3 passes above
    t, _, _, _ = isect([c], [0, 3, -5], [0, 0, 1])
    assert t[0] >= TMAX
    # exactly at the cap boundary: excluded (strict <, cylinder.go semantics)
    t, _, _, _ = isect([c], [0, 2, -5], [0, 0, 1])
    assert t[0] >= TMAX


def test_cylinder_axis_parallel_ray_misses():
    c = Cylinder(min_y=0.0, max_y=1.0)
    t, _, _, _ = isect([c], [0, -5, 0], [0, 1, 0])
    assert t[0] >= TMAX  # caps disabled, parity with tracer.cl:437-444


def test_triangle_group_hit_with_smooth_normal():
    tri = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0),
                   g.vector(0, 1, 0), g.vector(-1, 0, 0), g.vector(1, 0, 0))
    grp = Group()
    grp.add_child(tri)
    grp.bounds()
    t, oi, is_tri, tn = isect([grp], [-0.2, 0.3, -2], [0, 0, 1])
    assert t[0] < TMAX and is_tri[0]
    # smooth normal: n2*u + n3*v + n1*(1-u-v) (tracer.cl:669); book value
    # at u=0.45, v=0.25 -> (-0.5547, 0.83205, 0) direction-ish
    assert abs(tn[0, 2]) < 1e-5
    assert tn[0, 0] < 0  # x<0 side


def test_triangle_miss_edges():
    tri = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0))
    grp = Group()
    grp.add_child(tri)
    grp.bounds()
    for origin in ([1, 1, -2], [-1, 1, -2], [0, -1, -2]):
        t, _, _, _ = isect([grp], origin, [0, 0, 1])
        assert t[0] >= TMAX


def test_group_transform_applies():
    tri = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0))
    grp = Group()
    grp.add_child(tri)
    grp.set_transform(g.translate(10, 0, 0))
    grp.bounds()
    t, _, _, _ = isect([grp], [10, 0.5, -2], [0, 0, 1])
    assert np.isclose(t[0], 2.0, atol=1e-4)
    t, _, _, _ = isect([grp], [0, 0.5, -2], [0, 0, 1])
    assert t[0] >= TMAX


def test_closest_object_wins():
    s1 = Sphere()
    s1.set_transform(g.translate(0, 0, 2))
    s2 = Sphere()
    s2.set_transform(g.translate(0, 0, 6))
    t, oi, _, _ = isect([s2, s1], [0, 0, -5], [0, 0, 1])
    assert oi[0] == 1 and np.isclose(t[0], 6.0)


def test_many_triangles_bvh_vs_bruteforce():
    rng = np.random.default_rng(7)
    tris = []
    for _ in range(64):
        c = rng.uniform(-3, 3, 3)
        tris.append(Triangle(
            np.append(c, 1.0),
            np.append(c + rng.uniform(-0.5, 0.5, 3), 1.0),
            np.append(c + rng.uniform(-0.5, 0.5, 3), 1.0),
        ))
    grp = Group()
    for t_ in tris:
        grp.add_child(t_)
    grp.bounds()
    origins = rng.uniform(-4, 4, (32, 3))
    dirs = rng.normal(size=(32, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    t, _, _, _ = isect([grp], origins, dirs)

    # brute force in f64
    best = np.full(32, np.inf)
    for tr in tris:
        e1, e2, p1 = tr.e1[:3], tr.e2[:3], tr.p1[:3]
        for i in range(32):
            o, d = origins[i], dirs[i]
            dc2 = np.cross(d, e2)
            det = e1 @ dc2
            if abs(det) < EPS:
                continue
            f = 1.0 / det
            p1o = o - p1
            u = f * (p1o @ dc2)
            if u < 0 or u > 1:
                continue
            oc1 = np.cross(p1o, e1)
            v = f * (d @ oc1)
            if v < 0 or u + v > 1:
                continue
            tt = f * (e2 @ oc1)
            if EPS < tt < best[i]:
                best[i] = tt
    hit_mask = best < np.inf
    assert np.array_equal(t < TMAX, hit_mask)
    assert np.allclose(t[hit_mask], best[hit_mask], rtol=1e-4, atol=1e-5)


def test_bvh_matches_brute_force_on_random_soup():
    """Property test: for a random triangle soup, the skip-link BVH
    traversal must return the SAME closest hit as brute-force
    Moller-Trumbore over every triangle, for every ray. Pins the whole
    builder + traversal pipeline (snapped-SAH build, degenerate padding
    slots, best-t pruning), not just tree structure."""
    rng = np.random.default_rng(11)
    N, R = 200, 256
    p1 = rng.uniform(-2, 2, (N, 3))
    p2 = p1 + rng.uniform(-0.6, 0.6, (N, 3))
    p3 = p1 + rng.uniform(-0.6, 0.6, (N, 3))

    tris = [Triangle(np.append(a, 1.0), np.append(b, 1.0),
                     np.append(c, 1.0))
            for a, b, c in zip(p1, p2, p3)]
    g = Group()
    for t in tris:
        g.add_child(t)

    origins = rng.uniform(-3, 3, (R, 3))
    dirs = rng.normal(size=(R, 3))
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)

    t_bvh, _, is_tri, _ = isect([g], origins, dirs)

    # brute force in f32 (same arithmetic precision as the device path)
    e1 = (p2 - p1).astype(np.float32)
    e2 = (p3 - p1).astype(np.float32)
    o32 = origins.astype(np.float32)
    d32 = dirs.astype(np.float32)
    best = np.full(R, TMAX, np.float32)
    for i in range(N):
        dc2 = np.cross(d32, e2[i])
        det = (e1[i] * dc2).sum(axis=1)
        ok = np.abs(det) >= EPS
        f = 1.0 / np.where(ok, det, 1.0)
        pv = o32 - p1[i].astype(np.float32)
        u = f * (pv * dc2).sum(axis=1)
        oc = np.cross(pv, e1[i])
        v = f * (d32 * oc).sum(axis=1)
        t = f * (e2[i] * oc).sum(axis=1)
        good = (ok & (u >= 0) & (u <= 1) & (v >= 0) & (u + v <= 1)
                & (t > EPS) & (t < best))
        best = np.where(good, t.astype(np.float32), best)

    hit_brute = best < TMAX
    np.testing.assert_array_equal(is_tri.astype(bool), hit_brute)
    # identical winning t within f32 arithmetic-order tolerance
    np.testing.assert_allclose(t_bvh[hit_brute], best[hit_brute],
                               rtol=2e-5, atol=2e-5)
