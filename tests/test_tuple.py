"""Tuple math tests, ported from the reference's numeric tables
(internal/app/geom/tuple_test.go, 'Ray Tracer Challenge' examples)."""
import numpy as np
import pytest

import pathtracer.geometry as g


def test_point_has_w1():
    p = g.point(4.3, -4.2, 3.1)
    assert p[3] == 1.0
    assert g.is_point(p) and not g.is_vector(p)


def test_vector_has_w0():
    v = g.vector(4.3, -4.2, 3.1)
    assert v[3] == 0.0
    assert g.is_vector(v) and not g.is_point(v)


def test_add():
    a = np.array([3.0, -2.0, 5.0, 1.0])
    b = np.array([-2.0, 3.0, 1.0, 0.0])
    assert np.allclose(g.add(a, b), [1, 1, 6, 1])


def test_sub_points_gives_vector():
    p1 = g.point(3, 2, 1)
    p2 = g.point(5, 6, 7)
    assert np.allclose(g.sub(p1, p2), [-2, -4, -6, 0])


def test_sub_vector_from_point():
    p = g.point(3, 2, 1)
    v = g.vector(5, 6, 7)
    assert np.allclose(g.sub(p, v), [-2, -4, -6, 1])


def test_negate():
    a = np.array([1.0, -2.0, 3.0, -4.0])
    assert np.allclose(g.negate(a), [-1, 2, -3, 4])


def test_mul_scalar():
    a = np.array([1.0, -2.0, 3.0, -4.0])
    assert np.allclose(g.mul_scalar(a, 3.5), [3.5, -7, 10.5, -14])
    assert np.allclose(g.mul_scalar(a, 0.5), [0.5, -1, 1.5, -2])


def test_div_scalar():
    a = np.array([1.0, -2.0, 3.0, -4.0])
    assert np.allclose(g.div_scalar(a, 2), [0.5, -1, 1.5, -2])


@pytest.mark.parametrize(
    "v,expected",
    [
        (g.vector(1, 0, 0), 1.0),
        (g.vector(0, 1, 0), 1.0),
        (g.vector(0, 0, 1), 1.0),
        (g.vector(1, 2, 3), np.sqrt(14.0)),
        (g.vector(-1, -2, -3), np.sqrt(14.0)),
    ],
)
def test_magnitude(v, expected):
    assert np.isclose(g.magnitude(v), expected)


def test_normalize():
    assert np.allclose(g.normalize(g.vector(4, 0, 0)), [1, 0, 0, 0])
    n = g.normalize(g.vector(1, 2, 3))
    s14 = np.sqrt(14.0)
    assert np.allclose(n, [1 / s14, 2 / s14, 3 / s14, 0])
    assert np.isclose(g.magnitude(n), 1.0)


def test_dot():
    assert g.dot(g.vector(1, 2, 3), g.vector(2, 3, 4)) == 20.0


def test_cross():
    a = g.vector(1, 2, 3)
    b = g.vector(2, 3, 4)
    assert np.allclose(g.cross(a, b), g.vector(-1, 2, -1))
    assert np.allclose(g.cross(b, a), g.vector(1, -2, 1))


def test_hadamard():
    c1 = g.color(1, 0.2, 0.4)
    c2 = g.color(0.9, 1, 0.1)
    assert np.allclose(g.hadamard(c1, c2), g.color(0.9, 0.2, 0.04))


def test_reflect_45deg():
    v = g.vector(1, -1, 0)
    n = g.vector(0, 1, 0)
    assert np.allclose(g.reflect(v, n), g.vector(1, 1, 0))


def test_reflect_slanted():
    v = g.vector(0, -1, 0)
    n = g.vector(np.sqrt(2) / 2, np.sqrt(2) / 2, 0)
    assert np.allclose(g.reflect(v, n), g.vector(1, 0, 0))


def test_batched_ops():
    a = np.stack([g.vector(1, 2, 3), g.vector(2, 3, 4)])
    b = np.stack([g.vector(2, 3, 4), g.vector(1, 2, 3)])
    d = g.dot(a, b)
    assert d.shape == (2,)
    assert np.allclose(d, [20, 20])
    c = g.cross(a, b)
    assert np.allclose(c[0], g.vector(-1, 2, -1))
    assert np.allclose(c[1], g.vector(1, -2, 1))
