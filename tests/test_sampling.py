"""Sampling math tests (schlick tables from the 'Ray Tracer Challenge'
examples the reference implements, tracer.cl:485-505)."""
import numpy as np
import jax
import jax.numpy as jnp

from pathtracer.render.sampling import (
    random_vector_in_hemisphere, refracted_direction, schlick, sunflower,
)
from pathtracer.render.vec3 import Vec3


def _v(p):
    return Vec3(jnp.asarray([p[0]], jnp.float32),
                jnp.asarray([p[1]], jnp.float32),
                jnp.asarray([p[2]], jnp.float32))


def _vec_np(v: Vec3):
    return np.array([float(v.x[0]), float(v.y[0]), float(v.z[0])])


def _sch(eye, normal, n1, n2):
    f = jax.jit(lambda e, n: schlick(e, n, n1, n2))
    return float(f(_v(eye), _v(normal))[0])


def test_schlick_total_internal_reflection():
    # grazing incidence glass->air: cos=0 -> sin2t > 1 -> 1.0
    val = _sch([0, 1, 0], [1, 0, 0], 1.5, 1.0)
    assert val == 1.0


def test_schlick_perpendicular():
    # normal incidence air->glass n=1.5: r0 = ((1-1.5)/(2.5))^2 = 0.04
    val = _sch([0, 1, 0], [0, 1, 0], 1.0, 1.5)
    assert np.isclose(val, 0.04, atol=1e-5)


def test_schlick_small_angle_n2_gt_n1():
    val = _sch([0, 0.6, 0.8], [0, 1, 0], 1.0, 1.52)
    assert 0.04 < val < 1.0


def test_refracted_direction_straight_through():
    d = jax.jit(lambda e, nn: refracted_direction(e, nn, 1.0, 1.0))(
        _v([0, 1, 0]), _v([0, 1, 0]))
    assert np.allclose(_vec_np(d), [0, -1, 0], atol=1e-6)


def test_refracted_direction_snell():
    # 45 degrees air->glass(1.5): sin_t = sin(45)/1.5
    s2 = np.sqrt(2) / 2
    d = jax.jit(lambda e, nn: refracted_direction(e, nn, 1.0, 1.5))(
        _v([0, s2, -s2]), _v([0, 1, 0]))
    dn = _vec_np(d)
    sin_t = np.linalg.norm([dn[0], dn[2]]) / np.linalg.norm(dn)
    assert np.isclose(sin_t, s2 / 1.5, atol=1e-5)
    assert dn[1] < 0  # transmitted into the surface


def test_hemisphere_upper_and_unit():
    rng = np.random.default_rng(0)
    N = 512
    u1 = jnp.asarray(rng.random(N).astype(np.float32))
    u2 = jnp.asarray(rng.random(N).astype(np.float32))
    z = jnp.zeros(N, jnp.float32)
    n = Vec3(z, z, z - 1.0)
    d = jax.jit(random_vector_in_hemisphere)(n, u1, u2)
    dots = -np.asarray(d.z)
    assert (dots >= -1e-6).all()
    norms = np.sqrt(np.asarray(d.x)**2 + np.asarray(d.y)**2 + np.asarray(d.z)**2)
    assert np.allclose(norms, 1.0, atol=1e-5)


def test_sunflower_within_disc():
    idx = jnp.arange(1, 501, dtype=jnp.float32)
    x, y = jax.jit(lambda i: sunflower(500, 2.0, i))(idx)
    r = np.hypot(np.asarray(x), np.asarray(y))
    assert (r <= 1.0 + 1e-5).all()
    # boundary points land on the rim
    assert np.isclose(r[-1], 1.0, atol=1e-5)
