"""Procedural texture programs: host/device agreement and the megakernel
texture pipeline (computed texels vs the wavefront's gathered ones).

The contract (render/proctex.py): the numpy evaluation that BUILDS the
u32 texel pool and the jnp evaluation the megakernel TRACES must agree
per texel to within one rgb8 quantization step (the only divergence
sources are transcendental ulps and XLA FMA contraction)."""
import jax

import numpy as np
import pytest

jnp = jax.numpy

from pathtracer.config import RenderConfig
from pathtracer.render import proctex
from pathtracer.scenes import get_scene

DESCS = [
    (("checker", (8, (0.9, 0.9, 0.9), (0.2, 0.2, 0.2))), 512, 512),
    (("squares", (7,)), 512, 512),
    (("squares_nm", ()), 512, 512),
    (("cobblestone", (11, 13)), 512, 512),
    (("floorboards", (17,)), 512, 512),
    (("planet", (23,)), 512, 1024),
    (("jupiter", (31,)), 512, 1024),
    (("sky", ()), 1024, 2048),
    (("cube_cross", (256,)), 768, 1024),
]


@pytest.mark.parametrize("desc,h,w", DESCS, ids=[d[0][0] for d in DESCS])
def test_numpy_jnp_texel_agreement(desc, h, w):
    """Same program, numpy vs jnp(jit): every texel within 1/255."""
    rng = np.random.default_rng(3)
    iy = rng.integers(0, h, 4096)
    ix = rng.integers(0, w, 4096)
    ixf = ix.astype(np.float32)
    iyf = iy.astype(np.float32)
    a = np.stack(proctex.eval_texel(np, desc, ixf, iyf, h, w))

    @jax.jit
    def dev(x, y):
        return jnp.stack(proctex.eval_texel(jnp, desc, x, y, h, w))

    b = np.asarray(dev(jnp.asarray(ixf), jnp.asarray(iyf)))
    d = np.abs(a - b)
    assert d.max() <= 1.0 / 255.0 + 1e-6, f"max texel diff {d.max()}"


@pytest.mark.parametrize("desc,h,w", DESCS, ids=[d[0][0] for d in DESCS])
def test_pool_matches_program(desc, h, w):
    """The packed u32 pool texel IS the quantized program value (the
    megakernel computes what the wavefront gathers)."""
    img = proctex.eval_image(desc, h, w)
    q = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint32)
    rng = np.random.default_rng(5)
    iy = rng.integers(0, h, 2048)
    ix = rng.integers(0, w, 2048)
    got = np.stack(proctex.eval_texel(
        np, desc, ix.astype(np.float32), iy.astype(np.float32), h, w))
    want = q[iy, ix].T.astype(np.float32) / 255.0
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_atan2_acos_accuracy():
    """The kernel's polynomial atan2/acos vs numpy, over all
    quadrants."""
    from pathtracer.render.pallas_kernel import _acos, _atan2

    rng = np.random.default_rng(11)
    y = rng.uniform(-3, 3, 20000).astype(np.float32)
    x = rng.uniform(-3, 3, 20000).astype(np.float32)
    got = np.asarray(jax.jit(_atan2)(y, x))
    want = np.arctan2(y, x)
    assert np.abs(got - want).max() < 2e-6

    z = rng.uniform(-1, 1, 20000).astype(np.float32)
    got = np.asarray(jax.jit(_acos)(z))
    want = np.arccos(z)
    assert np.abs(got - want).max() < 1e-4  # d/dz acos blows up at +-1


def test_kernel_uv_matches_wavefront_uv():
    """_spherical_uv/_cube_uv (kernel) vs uv.spherical_map/cube_uv
    (wavefront), including the integrator's v flip."""
    from pathtracer.render.pallas_kernel import _cube_uv, _spherical_uv
    from pathtracer.render.uv import cube_uv, spherical_map
    from pathtracer.render.vec3 import Vec3

    rng = np.random.default_rng(13)
    p = rng.normal(size=(3, 5000)).astype(np.float32)
    n = np.sqrt((p * p).sum(0))
    sp = (p / n).astype(np.float32)  # unit sphere points
    u_k, v_k = jax.jit(_spherical_uv)(*[jnp.asarray(c) for c in sp])
    u_w, v_w = spherical_map(Vec3(*[jnp.asarray(c) for c in sp]))
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_w), atol=2e-6)
    np.testing.assert_allclose(np.asarray(v_k),
                               1.0 - np.asarray(v_w), atol=2e-6)

    # unit-cube surface points: project onto a random face
    q = rng.uniform(-1, 1, size=(3, 5000)).astype(np.float32)
    face = rng.integers(0, 3, 5000)
    sign = rng.choice([-1.0, 1.0], 5000).astype(np.float32)
    for a in range(3):
        q[a, face == a] = sign[face == a]
    u_k, v_k = jax.jit(_cube_uv)(*[jnp.asarray(c) for c in q])
    u_w, v_w = cube_uv(Vec3(*[jnp.asarray(c) for c in q]))
    np.testing.assert_allclose(np.asarray(u_k), np.asarray(u_w), atol=2e-6)
    np.testing.assert_allclose(np.asarray(v_k), np.asarray(v_w), atol=2e-6)


def test_sample_proc_matches_pool_sampler():
    """_sample_proc (computed 4-tap bilinear) vs uv.sample_texture_pool
    (gathered) on the same texture at random UVs incl. out-of-range
    (REPEAT wrap)."""
    from pathtracer.render.pallas_kernel import _sample_proc
    from pathtracer.render.uv import sample_texture_pool

    desc, h, w = ("squares", (7,)), 512, 512
    img = proctex.eval_image(desc, h, w)
    q = np.clip(np.round(img * 255.0), 0, 255).astype(np.uint32)
    pool = (q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)).reshape(-1)

    rng = np.random.default_rng(17)
    u = rng.uniform(-2, 3, 4000).astype(np.float32)
    v = rng.uniform(-2, 3, 4000).astype(np.float32)
    R = u.shape[0]
    got = jax.jit(lambda uu, vv: jnp.stack(_sample_proc(desc, w, h, uu, vv)))(
        jnp.asarray(u), jnp.asarray(v))
    base = jnp.zeros(R, jnp.float32)
    want = sample_texture_pool(jnp.asarray(pool), base,
                               jnp.full(R, float(w)), jnp.full(R, float(h)),
                               jnp.asarray(u), jnp.asarray(v))
    want = jnp.stack([want.x, want.y, want.z])
    d = np.abs(np.asarray(got) - np.asarray(want))
    # bilinear weights may differ by FMA contraction; taps by 1/255
    assert d.max() < 2.5 / 255.0, f"max sample diff {d.max()}"


@pytest.mark.parametrize("scene", ["textures", "envmap", "cubemap"])
def test_wavefront_computed_matches_gathered(scene, monkeypatch):
    """The wavefront integrator's computed-texel path (PT_TEX_MODE
    default) vs its pool-gather path: same RNG, same estimator — images
    agree to the texel quantization level."""
    from pathtracer.render.integrator import render

    cfg = RenderConfig(width=32, height=24, samples=8, samples_per_pass=8,
                       seed=3)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack()
    monkeypatch.setenv("PT_TEX_MODE", "compute")
    a = render(arrays, meta, sc.camera, cfg)
    monkeypatch.setenv("PT_TEX_MODE", "gather")
    b = render(arrays, meta, sc.camera, cfg)
    d = np.abs(a - b)
    assert d.max() <= 1.5 / 255.0, f"max {d.max()}"
    assert d.mean() <= 0.5 / 255.0


@pytest.mark.parametrize("scene,spp,bound", [
    ("textures", 32, 0.04),
    ("envmap", 16, 0.04),
    ("cubemap", 16, 0.04),
])
def test_textured_megakernel_matches_wavefront(scene, spp, bound):
    """End-to-end: the textured megakernel (interpret mode) and the
    wavefront integrator are independent estimators of the same
    integral — means agree at matched spp."""
    from pathtracer.render.integrator import render
    from pathtracer.render.pallas_kernel import (render_pallas,
                                                     supports_scene)

    cfg = RenderConfig(width=32, height=24, samples=spp,
                       samples_per_pass=spp)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack()
    assert supports_scene(meta)
    img_p = render_pallas(arrays, meta, sc.camera, cfg, interpret=True)
    img_w = render(arrays, meta, sc.camera, cfg)
    assert np.isfinite(img_p).all() and img_p.min() >= 0.0
    assert abs(img_p.mean() - img_w.mean()) < bound
    assert np.abs(img_p - img_w).mean() < 0.2
