"""Bounding box tests (reference tables: shapes/boundingbox_test.go)."""
import numpy as np

import pathtracer.geometry as g
from pathtracer.scene.bounds import (
    BoundingBox, bounds_of, parent_space_bounds, transform_bounding_box,
)
from pathtracer.scene.shapes import Cube, Group, Sphere, Triangle


def test_add_points():
    b = BoundingBox.empty()
    b.add_point(g.point(-5, 2, 0))
    b.add_point(g.point(7, 0, -3))
    assert np.allclose(b.min[:3], [-5, 0, -3])
    assert np.allclose(b.max[:3], [7, 2, 0])


def test_merge():
    b1 = BoundingBox.of_floats(-5, -2, 0, 7, 4, 4)
    b2 = BoundingBox.of_floats(8, -7, -2, 14, 2, 8)
    b1.merge_with(b2)
    assert np.allclose(b1.min[:3], [-5, -7, -2])
    assert np.allclose(b1.max[:3], [14, 4, 8])


def test_contains_point():
    b = BoundingBox.of_floats(5, -2, 0, 11, 4, 7)
    assert b.contains_point(g.point(5, -2, 0))
    assert b.contains_point(g.point(11, 4, 7))
    assert b.contains_point(g.point(8, 1, 3))
    assert not b.contains_point(g.point(3, 0, 3))
    assert not b.contains_point(g.point(8, -4, 3))


def test_contains_box():
    b = BoundingBox.of_floats(5, -2, 0, 11, 4, 7)
    assert b.contains_box(BoundingBox.of_floats(5, -2, 0, 11, 4, 7))
    assert b.contains_box(BoundingBox.of_floats(6, -1, 1, 10, 3, 6))
    assert not b.contains_box(BoundingBox.of_floats(4, -3, -1, 10, 3, 6))
    assert not b.contains_box(BoundingBox.of_floats(6, -1, 1, 12, 5, 8))


def test_transform_bbox():
    # boundingbox_test.go: transform unit box by rx(pi/4)·ry(pi/4)
    b = BoundingBox.of_floats(-1, -1, -1, 1, 1, 1)
    m = g.multiply(g.rotate_x(np.pi / 4), g.rotate_y(np.pi / 4))
    out = transform_bounding_box(b, m)
    assert np.allclose(out.min[:3], [-1.41421, -1.70710, -1.70710], atol=1e-4)
    assert np.allclose(out.max[:3], [1.41421, 1.70710, 1.70710], atol=1e-4)


def test_bounds_of_default_unit():
    b = bounds_of(Sphere())
    assert np.allclose(b.min[:3], [-1, -1, -1])
    assert np.allclose(b.max[:3], [1, 1, 1])


def test_bounds_of_triangle():
    t = Triangle(g.point(-3, 7, 2), g.point(6, 2, -4), g.point(2, -1, -1))
    b = bounds_of(t)
    assert np.allclose(b.min[:3], [-3, -1, -4])
    assert np.allclose(b.max[:3], [6, 7, 2])


def test_bounds_of_group_uses_parent_space():
    gr = Group()
    s = Sphere()
    s.set_transform(g.translate(2, 5, -3))
    s.set_transform(g.scale(2, 2, 2))
    c = Cube()  # Cylinder in the book test; unit cube default bounds here
    c.set_transform(g.translate(-4, -1, 4))
    c.set_transform(g.scale(0.5, 1, 0.5))
    gr.add_children(s, c)
    gr.bounds()
    assert np.allclose(gr.bounding_box.min[:3], [-4.5, -2, -5])
    assert np.allclose(gr.bounding_box.max[:3], [4, 7, 4.5])


def test_parent_space_bounds():
    s = Sphere()
    s.set_transform(g.translate(1, -3, 5))
    s.set_transform(g.scale(0.5, 2, 4))
    b = parent_space_bounds(s)
    assert np.allclose(b.min[:3], [0.5, -5, 1])
    assert np.allclose(b.max[:3], [1.5, -1, 9])
