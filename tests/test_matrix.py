"""Matrix math tests, ported from the reference's numeric tables
(internal/app/geom/matrix_test.go)."""
import numpy as np

import pathtracer.geometry as g
from pathtracer.geometry.matrix import from_flat


def test_multiply():
    a = from_flat([1, 2, 3, 4, 5, 6, 7, 8, 9, 8, 7, 6, 5, 4, 3, 2])
    b = from_flat([-2, 1, 2, 3, 3, 2, 1, -1, 4, 3, 6, 5, 1, 2, 7, 8])
    expected = from_flat(
        [20, 22, 50, 48, 44, 54, 114, 108, 40, 58, 110, 102, 16, 26, 46, 42]
    )
    assert np.allclose(g.multiply(a, b), expected)


def test_multiply_by_tuple():
    a = from_flat([1, 2, 3, 4, 2, 4, 4, 2, 8, 6, 4, 1, 0, 0, 0, 1])
    t = np.array([1.0, 2.0, 3.0, 1.0])
    assert np.allclose(g.multiply_tuple(a, t), [18, 24, 33, 1])


def test_multiply_by_identity():
    a = from_flat([0, 1, 2, 4, 1, 2, 4, 8, 2, 4, 8, 16, 4, 8, 16, 32])
    assert np.allclose(g.multiply(a, g.identity()), a)


def test_transpose():
    a = from_flat([0, 9, 3, 0, 9, 8, 0, 8, 1, 8, 5, 3, 0, 0, 5, 8])
    expected = from_flat([0, 9, 1, 0, 9, 8, 8, 0, 3, 0, 5, 5, 0, 8, 3, 8])
    assert np.allclose(g.transpose(a), expected)
    assert np.allclose(g.transpose(g.identity()), g.identity())


def test_determinant_2x2():
    a = np.array([[1.0, 5.0], [-3.0, 2.0]])
    assert g.determinant(a) == 17.0


def test_submatrix():
    a = np.array([[1.0, 5.0, 0.0], [-3.0, 2.0, 7.0], [0.0, 6.0, -3.0]])
    assert np.allclose(g.submatrix(a, 0, 2), [[-3, 2], [0, 6]])


def test_minor_cofactor():
    a = np.array([[3.0, 5.0, 0.0], [2.0, -1.0, -7.0], [6.0, -1.0, 5.0]])
    assert g.minor(a, 1, 0) == 25.0
    assert g.cofactor(a, 0, 0) == -12.0
    assert g.cofactor(a, 1, 0) == -25.0


def test_determinant_3x3():
    a = np.array([[1.0, 2.0, 6.0], [-5.0, 8.0, -4.0], [2.0, 6.0, 4.0]])
    assert g.cofactor(a, 0, 0) == 56.0
    assert g.cofactor(a, 0, 1) == 12.0
    assert g.cofactor(a, 0, 2) == -46.0
    assert g.determinant(a) == -196.0


def test_determinant_4x4():
    a = from_flat([-2, -8, 3, 5, -3, 1, 7, 3, 1, 2, -9, 6, -6, 7, 7, -9])
    assert g.cofactor(a, 0, 0) == 690.0
    assert g.cofactor(a, 0, 1) == 447.0
    assert g.cofactor(a, 0, 2) == 210.0
    assert g.cofactor(a, 0, 3) == 51.0
    assert g.determinant(a) == -4071.0


def test_inverse():
    a = from_flat([-5, 2, 6, -8, 1, -5, 1, 8, 7, 7, -6, -7, 1, -3, 7, 4])
    b = g.inverse(a)
    assert np.isclose(g.determinant(a), 532.0)
    expected = from_flat(
        [
            0.21805, 0.45113, 0.24060, -0.04511,
            -0.80827, -1.45677, -0.44361, 0.52068,
            -0.07895, -0.22368, -0.05263, 0.19737,
            -0.52256, -0.81391, -0.30075, 0.30639,
        ]
    )
    assert np.allclose(b, expected, atol=1e-5)


def test_inverse_2():
    a = from_flat([8, -5, 9, 2, 7, 5, 6, 1, -6, 0, 9, 6, -3, 0, -9, -4])
    expected = from_flat(
        [
            -0.15385, -0.15385, -0.28205, -0.53846,
            -0.07692, 0.12308, 0.02564, 0.03077,
            0.35897, 0.35897, 0.43590, 0.92308,
            -0.69231, -0.69231, -0.76923, -1.92308,
        ]
    )
    assert np.allclose(g.inverse(a), expected, atol=1e-5)


def test_multiply_product_by_inverse():
    a = from_flat([3, -9, 7, 3, 3, -8, 2, -9, -4, 4, 4, 1, -6, 5, -1, 1])
    b = from_flat([8, 2, 2, 2, 3, -1, 7, 0, 7, 0, 5, 4, 6, -2, 0, 5])
    c = g.multiply(a, b)
    assert np.allclose(g.multiply(c, g.inverse(b)), a)
