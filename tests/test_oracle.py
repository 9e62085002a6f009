"""Production integrator vs the independent brute-force f64 oracle.

tests/_oracle.py re-implements the reference kernel's estimator straight
from its equations (bounce records + resolve pass, brute-force
intersection, f64, numpy). Two kinds of checks:

1. DETERMINISTIC subcomputations match exactly (ray generation at fixed
   jitter, closest-hit t and winning object for probe rays) — these have
   no Monte-Carlo noise, so any mismatch is a real estimator divergence.
2. The rendered IMAGES converge to each other at high spp (different RNG
   streams, same integral): per-pixel tolerance scaled to MC noise.
"""
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.scenes import get_scene

from _oracle import OracleScene, _closest_hit, oracle_render


def _pack(scene, w=16, h=12, samples=8):
    cfg = RenderConfig(width=w, height=h, samples=samples,
                       samples_per_pass=samples, dtype="float64")
    sc = get_scene(scene, cfg)
    import jax.numpy as jnp

    arrays, meta = sc.pack(dtype=jnp.float64)
    return cfg, sc, arrays, meta


@pytest.fixture(scope="module", autouse=True)
def _x64():
    import jax

    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


def test_oracle_closest_hit_matches_production():
    """Deterministic: same probe rays -> identical winning object and
    intersection distance (f64, rounding-level tolerance)."""
    from pathtracer.render.intersect import intersect_scene
    from pathtracer.render.vec3 import Vec3
    import jax.numpy as jnp

    cfg, sc, arrays, meta = _pack("default")
    osc = OracleScene(arrays, meta)

    rng = np.random.default_rng(0)
    R = 256
    o = rng.normal(size=(R, 3)) * 0.3 + np.array([0, 0.1, -1.2])
    d = _norm(rng.normal(size=(R, 3)))

    t_o, win_o, *_, hit_o = _closest_hit(osc, o, d, cfg.epsilon,
                                         cfg.t_max)

    ov = Vec3(jnp.asarray(o[:, 0]), jnp.asarray(o[:, 1]),
              jnp.asarray(o[:, 2]))
    dv = Vec3(jnp.asarray(d[:, 0]), jnp.asarray(d[:, 1]),
              jnp.asarray(d[:, 2]))
    hit = intersect_scene(arrays, meta, ov, dv, cfg.epsilon, cfg.t_max)
    t_p = np.asarray(hit.t)
    win_p = np.asarray(hit.obj_idx)

    both_hit = hit_o & (t_p < cfg.t_max)
    assert both_hit.sum() > R // 4
    np.testing.assert_allclose(t_o[both_hit], t_p[both_hit],
                               rtol=1e-9, atol=1e-9)
    # winners match except exact ties (none expected on this scene)
    assert (win_o[both_hit] == win_p[both_hit]).mean() > 0.999
    # miss/hit classification identical
    np.testing.assert_array_equal(hit_o, t_p < cfg.t_max)


def _norm(v):
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_oracle_closest_hit_two_groups():
    """A scene with TWO mesh groups under different transforms: each
    group's triangles must be intersected in its OWN local space (the
    oracle once tested the whole merged pool under every group's
    inverse, which double-tests triangles in the wrong space)."""
    from pathtracer.geometry.transforms import scale, translate
    from pathtracer.render.intersect import intersect_scene
    from pathtracer.render.vec3 import Vec3
    from pathtracer.scene.pack import pack_scene
    from pathtracer.scene.shapes import Group, Triangle
    import jax.numpy as jnp

    def quad(y):
        # unit XZ quad at height y
        p = lambda x, z: np.array([x, y, z, 1.0])
        return [Triangle(p(-1, -1), p(1, -1), p(1, 1)),
                Triangle(p(-1, -1), p(1, 1), p(-1, 1))]

    ga = Group()
    ga.add_children(*quad(0.0))
    ga.set_transform(translate(-1.5, 0.0, 0.0))
    gb = Group()
    gb.add_children(*quad(0.0))
    gb.set_transform(translate(1.5, 0.5, 0.0) @ scale(0.5, 1.0, 0.5))
    arrays, meta = pack_scene([ga, gb], leaf_size=4)
    assert len(meta.group_bvh) == 2
    osc = OracleScene(arrays, meta)

    # downward probes across both quads (and the gap between them)
    rng = np.random.default_rng(3)
    R = 256
    o = np.stack([rng.uniform(-3, 3, R), np.full(R, 2.0),
                  rng.uniform(-2, 2, R)], axis=1)
    d = np.tile([0.0, -1.0, 0.0], (R, 1))

    eps, t_max = 1e-4, 1024.0
    t_o, win_o, *_, hit_o = _closest_hit(osc, o, d, eps, t_max)

    ov = Vec3(*(jnp.asarray(o[:, i]) for i in range(3)))
    dv = Vec3(*(jnp.asarray(d[:, i]) for i in range(3)))
    hit = intersect_scene(arrays, meta, ov, dv, eps, t_max)
    t_p = np.asarray(hit.t)

    np.testing.assert_array_equal(hit_o, t_p < t_max)
    # expected hit fraction = quad areas / probe area = (4+1)/24 ~ 0.21
    assert hit_o.sum() > R // 8
    np.testing.assert_allclose(t_o[hit_o], t_p[hit_o], rtol=1e-6,
                               atol=1e-6)
    assert (win_o[hit_o] == np.asarray(hit.obj_idx)[hit_o]).all()
    assert set(np.unique(win_o[hit_o])) == {0, 1}  # both groups win somewhere


@pytest.mark.parametrize("scene", ["reference", "default", "textures"])
def test_oracle_image_convergence(scene):
    """Independent estimators of the same integral converge: 16x12 at
    high spp, per-pixel agreement within MC noise. `textures` covers the
    whole texture pipeline (UV maps, bilinear REPEAT pool sampling,
    normal maps) against the oracle's own f64 re-derivation."""
    from pathtracer.render.integrator import render

    spp = 1536
    cfg, sc, arrays, meta = _pack(scene, samples=spp)
    img_o = oracle_render(arrays, meta, sc.camera, cfg.width,
                          cfg.height, spp=spp, seed=7)

    cfg_p = cfg.replace(samples_per_pass=64)
    img_p = np.asarray(render(arrays, meta, sc.camera, cfg_p),
                       np.float64)

    assert np.isfinite(img_o).all()
    # global mean parity
    assert abs(img_o.mean() - img_p.mean()) < 0.012, (
        img_o.mean(), img_p.mean())
    # per-pixel: bound by MC standard error (~v/sqrt(spp)); direct-light
    # pixels are exact
    diff = np.abs(img_o - img_p)
    assert diff.mean() < 0.03, diff.mean()
    assert np.quantile(diff, 0.95) < 0.09, np.quantile(diff, 0.95)
