"""UV mapping tests (reference tables: shapes/sphericalmap_test.go,
shapes/cubemap_test.go)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest

from pathtracer.render.uv import cube_uv, sample_texture, spherical_map
from pathtracer.render.vec3 import Vec3


def _v(p):
    return Vec3(jnp.asarray([p[0]], jnp.float32),
                jnp.asarray([p[1]], jnp.float32),
                jnp.asarray([p[2]], jnp.float32))


@pytest.mark.parametrize(
    "p,expected",
    [
        ((0, 0, -1), (0.0, 0.5)),
        ((1, 0, 0), (0.25, 0.5)),
        ((0, 0, 1), (0.5, 0.5)),
        ((-1, 0, 0), (0.75, 0.5)),
        ((0, 1, 0), (0.5, 1.0)),
        ((0, -1, 0), (0.5, 0.0)),
        ((np.sqrt(2) / 2, np.sqrt(2) / 2, 0), (0.25, 0.75)),
    ],
)
def test_spherical_map_table(p, expected):
    u, v = jax.jit(spherical_map)(_v(p))
    assert np.allclose([float(u[0]), float(v[0])], expected, atol=1e-5)


@pytest.mark.parametrize(
    "p,u_range,v_range",
    [
        ((1, 0, 0), (0.5, 0.75), (1/3, 2/3)),    # right
        ((-1, 0, 0), (0.0, 0.25), (1/3, 2/3)),   # left
        ((0, 1, 0), (0.25, 0.5), (2/3, 1.0)),    # top
        ((0, -1, 0), (0.25, 0.5), (0.0, 1/3)),   # bottom
        ((0, 0, 1), (0.25, 0.5), (1/3, 2/3)),    # front
        ((0, 0, -1), (0.75, 1.0), (1/3, 2/3)),   # back
    ],
)
def test_cube_uv_face_regions(p, u_range, v_range):
    u, v = jax.jit(cube_uv)(_v(p))
    assert u_range[0] <= float(u[0]) <= u_range[1], (float(u[0]), float(v[0]))
    assert v_range[0] <= float(v[0]) <= v_range[1], (float(u[0]), float(v[0]))


def test_cube_uv_front_center():
    # front face center: u = 0.25 + 0.5*0.25 = 0.375, v = 2/3 - 0.5/3 = 0.5
    u, v = jax.jit(cube_uv)(_v((0.0, 0.0, 1.0)))
    assert np.allclose([float(u[0]), float(v[0])], [0.375, 0.5], atol=1e-4)


def _atlas(arr_hw3):
    """[n,H,W,3] -> channel-leading [3,n,H,W] jnp atlas."""
    return jnp.asarray(np.moveaxis(arr_hw3, -1, 0))


def _sample(at, u, v):
    f = jax.jit(lambda uu, vv: sample_texture(
        at, jnp.zeros_like(uu, jnp.int32), uu, vv))
    out = f(jnp.asarray([u], jnp.float32), jnp.asarray([v], jnp.float32))
    return np.array([float(out.x[0]), float(out.y[0]), float(out.z[0])])


def test_sample_texture_bilinear_wrap():
    atlas = np.zeros((1, 2, 2, 3), np.float32)
    atlas[0, 0, 0] = [1, 0, 0]
    atlas[0, 0, 1] = [0, 1, 0]
    atlas[0, 1, 0] = [0, 0, 1]
    atlas[0, 1, 1] = [1, 1, 1]
    at = _atlas(atlas)
    # texel centers: (0.25, 0.25) -> exact texel values
    assert np.allclose(_sample(at, 0.25, 0.25), [1, 0, 0], atol=1e-6)
    # midpoint: average of all four
    assert np.allclose(_sample(at, 0.5, 0.5), [0.5, 0.5, 0.5], atol=1e-6)
    # wrap: u=1.25 == u=0.25
    assert np.allclose(_sample(at, 1.25, 0.25), [1, 0, 0], atol=1e-6)


def test_sample_texture_repeat_negative():
    atlas = np.zeros((1, 1, 4, 3), np.float32)
    atlas[0, 0, :, 0] = [0.0, 0.25, 0.5, 0.75]
    at = _atlas(atlas)
    assert np.allclose(
        _sample(at, -0.875, 0.5), _sample(at, 0.125, 0.5), atol=1e-6
    )


def test_sample_texture_pool_matches_float_sampler(monkeypatch):
    """The flat-pool u32 fetch must agree with the float-atlas bilinear
    sampler within rgb8 quantization (1/255 per tap), including REPEAT
    wrap and textures of different native sizes in one pool."""
    import numpy as np

    from pathtracer.render.uv import sample_texture, sample_texture_pool
    from pathtracer.scene.pack import _build_texel_pool

    # the quad pool is only materialized under PT_TEX_FETCH=quad (it is
    # 4x the pool memory and unread otherwise)
    monkeypatch.setenv("PT_TEX_FETCH", "quad")

    rng = np.random.default_rng(7)
    imgs = [rng.random((h, w, 3)) for h, w in ((8, 16), (5, 7))]
    # quantize the float source exactly like the pool does, so the only
    # difference left is the fetch path itself
    imgs = [np.round(im * 255.0) / 255.0 for im in imgs]
    pool, pool_quad, tables = _build_texel_pool({"planar": imgs})

    R = 512
    u = jnp.asarray(rng.uniform(-2, 2, R), jnp.float32)
    v = jnp.asarray(rng.uniform(-2, 2, R), jnp.float32)
    for li, (base, w, h) in enumerate(tables["planar"]):
        atlas = np.zeros((3, 1, h, w), np.float32)
        atlas[:, 0] = np.moveaxis(imgs[li], -1, 0)
        want = sample_texture(jnp.asarray(atlas),
                              jnp.zeros(R, jnp.int32), u, v)
        got = sample_texture_pool(
            jnp.asarray(pool),
            jnp.full(R, float(base), jnp.float32),
            jnp.full(R, float(w), jnp.float32),
            jnp.full(R, float(h), jnp.float32), u, v)
        for a, b in zip((got.x, got.y, got.z), (want.x, want.y, want.z)):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                       atol=1.5 / 255.0)
        # the quad-pool fetch (one row gather, wrap baked in at pack
        # time) must be BIT-identical to the 4-take path
        got_q = sample_texture_pool(
            jnp.asarray(pool),
            jnp.full(R, float(base), jnp.float32),
            jnp.full(R, float(w), jnp.float32),
            jnp.full(R, float(h), jnp.float32), u, v,
            pool_quad_u32=jnp.asarray(pool_quad))
        for a, b in zip((got_q.x, got_q.y, got_q.z),
                        (got.x, got.y, got.z)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
