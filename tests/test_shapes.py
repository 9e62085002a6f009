"""Scene-graph shape semantics (reference: internal/app/shapes/)."""
import numpy as np

import pathtracer.geometry as g
from pathtracer.scene.shapes import (
    Cube, Cylinder, Group, Plane, Sphere, Triangle,
    PLANE, SPHERE, CYLINDER, BOX, GROUP,
)
from pathtracer.scene.material import Material


def test_type_codes_match_reference_layout():
    # internal/ocl/scene.go:45-76
    assert Plane().type_code == 0
    assert Sphere().type_code == 1
    assert Cylinder().type_code == 2
    assert Cube().type_code == 3
    assert Group().type_code == 4


def test_sphere_default_identity():
    s = Sphere()
    assert np.allclose(s.transform, np.eye(4))
    assert np.allclose(s.inverse, np.eye(4))


def test_set_transform_right_multiplies():
    # SetTransform accumulates right-multiplied (sphere.go:60-64): calling
    # translate then scale gives T @ S.
    s = Sphere()
    s.set_transform(g.translate(2, 3, 4))
    s.set_transform(g.scale(2, 2, 2))
    expected = g.multiply(g.translate(2, 3, 4), g.scale(2, 2, 2))
    assert np.allclose(s.transform, expected)
    assert np.allclose(s.inverse, np.linalg.inv(expected))
    assert np.allclose(s.inverse_transpose, np.linalg.inv(expected).T)


def test_triangle_precompute():
    # triangle.go:21-41: e1 = p2-p1, e2 = p3-p1, n = normalize(cross(e2, e1))
    t = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0))
    assert np.allclose(t.e1, g.vector(-1, -1, 0))
    assert np.allclose(t.e2, g.vector(1, -1, 0))
    assert np.allclose(t.n, g.vector(0, 0, -1))
    assert np.allclose(t.n1, t.n)
    assert np.allclose(t.n2, t.n)


def test_triangle_with_normals():
    n1, n2, n3 = g.vector(0, 1, 0), g.vector(-1, 0, 0), g.vector(1, 0, 0)
    t = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0),
                 n1, n2, n3)
    assert np.allclose(t.n1, n1)
    assert np.allclose(t.n2, n2)
    assert np.allclose(t.n3, n3)


def test_group_add_child_updates_bbox():
    gr = Group()
    t = Triangle(g.point(0, 1, 0), g.point(-1, 0, 0), g.point(1, 0, 0))
    gr.add_child(t)
    assert t.parent is gr
    assert np.allclose(gr.bounding_box.min[:3], [-1, 0, 0])
    assert np.allclose(gr.bounding_box.max[:3], [1, 1, 0])


def test_group_all_triangles_recursive():
    inner = Group()
    inner.add_child(Triangle(g.point(0, 0, 0), g.point(1, 0, 0), g.point(0, 1, 0)))
    outer = Group()
    outer.add_child(inner)
    outer.add_child(Triangle(g.point(0, 0, 1), g.point(1, 0, 1), g.point(0, 1, 1)))
    assert len(outer.all_triangles()) == 2


def test_material_presets():
    # material.go:38-60
    gl = Material.glass()
    assert gl.refractive_index == 1.52 and gl.reflectivity == 0.05
    mi = Material.mirror()
    assert mi.reflectivity == 1.0
    lb = Material.light_bulb()
    assert lb.emission == (8.0, 8.0, 8.0)
