"""Transform builder tests, ported from the reference's numeric tables
(internal/app/geom/{translation,scaling,rotation}_test.go and
camera ViewTransform tests)."""
import numpy as np

import pathtracer.geometry as g


def test_translate_point():
    t = g.translate(5, -3, 2)
    p = g.point(-3, 4, 5)
    assert np.allclose(g.multiply_tuple(t, p), g.point(2, 1, 7))


def test_translate_inverse():
    inv = g.inverse(g.translate(5, -3, 2))
    p = g.point(-3, 4, 5)
    assert np.allclose(g.multiply_tuple(inv, p), g.point(-8, 7, 3))


def test_translate_does_not_affect_vectors():
    t = g.translate(5, -3, 2)
    v = g.vector(-3, 4, 5)
    assert np.allclose(g.multiply_tuple(t, v), v)


def test_scale_point():
    s = g.scale(2, 3, 4)
    assert np.allclose(g.multiply_tuple(s, g.point(-4, 6, 8)), g.point(-8, 18, 32))


def test_scale_vector():
    s = g.scale(2, 3, 4)
    assert np.allclose(g.multiply_tuple(s, g.vector(-4, 6, 8)), g.vector(-8, 18, 32))


def test_reflection_is_negative_scale():
    s = g.scale(-1, 1, 1)
    assert np.allclose(g.multiply_tuple(s, g.point(2, 3, 4)), g.point(-2, 3, 4))


def test_rotate_x():
    p = g.point(0, 1, 0)
    half = g.rotate_x(np.pi / 4)
    full = g.rotate_x(np.pi / 2)
    s2 = np.sqrt(2) / 2
    assert np.allclose(g.multiply_tuple(half, p), g.point(0, s2, s2))
    assert np.allclose(g.multiply_tuple(full, p), g.point(0, 0, 1), atol=1e-12)


def test_rotate_y():
    p = g.point(0, 0, 1)
    half = g.rotate_y(np.pi / 4)
    s2 = np.sqrt(2) / 2
    assert np.allclose(g.multiply_tuple(half, p), g.point(s2, 0, s2))


def test_rotate_z():
    p = g.point(0, 1, 0)
    half = g.rotate_z(np.pi / 4)
    s2 = np.sqrt(2) / 2
    assert np.allclose(g.multiply_tuple(half, p), g.point(-s2, s2, 0))


def test_shear():
    p = g.point(2, 3, 4)
    assert np.allclose(
        g.multiply_tuple(g.shear(1, 0, 0, 0, 0, 0), p), g.point(5, 3, 4)
    )
    assert np.allclose(
        g.multiply_tuple(g.shear(0, 1, 0, 0, 0, 0), p), g.point(6, 3, 4)
    )
    assert np.allclose(
        g.multiply_tuple(g.shear(0, 0, 1, 0, 0, 0), p), g.point(2, 5, 4)
    )


def test_chained_transforms_applied_in_sequence():
    # The reference chains SetTransform calls that right-multiply
    # (shapes/sphere.go:60-64): T then S means world = T @ S.
    p = g.point(1, 0, 1)
    a = g.rotate_x(np.pi / 2)
    b = g.scale(5, 5, 5)
    c = g.translate(10, 5, 7)
    t = g.multiply(g.multiply(c, b), a)
    assert np.allclose(g.multiply_tuple(t, p), g.point(15, 0, 7))


def test_view_transform_default():
    vt = g.view_transform(g.point(0, 0, 0), g.point(0, 0, -1), g.vector(0, 1, 0))
    assert np.allclose(vt, g.identity())


def test_view_transform_positive_z():
    vt = g.view_transform(g.point(0, 0, 0), g.point(0, 0, 1), g.vector(0, 1, 0))
    assert np.allclose(vt, g.scale(-1, 1, -1))


def test_view_transform_moves_world():
    vt = g.view_transform(g.point(0, 0, 8), g.point(0, 0, 0), g.vector(0, 1, 0))
    assert np.allclose(vt, g.translate(0, 0, -8))


def test_view_transform_arbitrary():
    vt = g.view_transform(g.point(1, 3, 2), g.point(4, -2, 8), g.vector(1, 1, 0))
    expected = np.array(
        [
            [-0.50709, 0.50709, 0.67612, -2.36643],
            [0.76772, 0.60609, 0.12122, -2.82843],
            [-0.35857, 0.59761, -0.71714, 0.00000],
            [0.00000, 0.00000, 0.00000, 1.00000],
        ]
    )
    assert np.allclose(vt, expected, atol=1e-5)


def test_ray_position():
    r = g.Ray(g.point(2, 3, 4), g.vector(1, 0, 0))
    assert np.allclose(g.ray_position(r, 0), g.point(2, 3, 4))
    assert np.allclose(g.ray_position(r, 1), g.point(3, 3, 4))
    assert np.allclose(g.ray_position(r, -1), g.point(1, 3, 4))
    assert np.allclose(g.ray_position(r, 2.5), g.point(4.5, 3, 4))


def test_transform_ray():
    r = g.Ray(g.point(1, 2, 3), g.vector(0, 1, 0))
    m = g.translate(3, 4, 5)
    r2 = g.transform_ray(m, r)
    assert np.allclose(r2.origin, g.point(4, 6, 8))
    assert np.allclose(r2.direction, g.vector(0, 1, 0))

    m2 = g.scale(2, 3, 4)
    r3 = g.transform_ray(m2, r)
    assert np.allclose(r3.origin, g.point(2, 6, 12))
    assert np.allclose(r3.direction, g.vector(0, 3, 0))
