"""End-to-end integrator tests: tiny renders of the reference scenes on the
CPU backend (the 'fake backend' strategy, SURVEY.md section 4)."""
import numpy as np
import jax.numpy as jnp
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render.integrator import render
from pathtracer.scene.pack import pack_scene
from pathtracer.scenes import get_scene, list_scenes


@pytest.fixture(scope="module")
def tiny_cfg():
    return RenderConfig(width=32, height=24, samples=8, samples_per_pass=8)


def test_registry_has_reference_scenes():
    names = list_scenes()
    assert "reference" in names and "default" in names


def test_reference_scene_packs(tiny_cfg):
    sc = get_scene("reference", tiny_cfg)
    arrays, meta = pack_scene(sc.objects)
    assert meta.n_objects == 8
    assert meta.max_objects == 16
    assert meta.group_bvh == ()
    types = np.asarray(arrays.obj_type)
    assert types[0] == 1  # light sphere
    assert (types[1:6] == 0).all()  # five planes
    assert (types[6:8] == 1).all()  # two spheres
    assert (types[8:] == -1).all()  # padding


def test_default_scene_packs_with_group(tiny_cfg):
    sc = get_scene("default", tiny_cfg)
    arrays, meta = pack_scene(sc.objects)
    assert len(meta.group_bvh) == 1
    g, root, end = meta.group_bvh[0]
    assert np.asarray(arrays.obj_type)[g] == 4
    assert end > root


def test_render_reference_tiny(tiny_cfg):
    sc = get_scene("reference", tiny_cfg)
    arrays, meta = pack_scene(sc.objects)
    img = render(arrays, meta, sc.camera, tiny_cfg)
    assert img.shape == (24, 32, 3)
    assert np.isfinite(img).all()
    assert (img >= 0).all()
    # plausible global brightness (f64 golden mean ~0.267 at high spp)
    assert 0.05 < img.mean() < 0.6
    # direct light pixels return the light COLOR (1,1,1), not emission
    # (tracer.cl:1156-1163): pixels fully inside the light disc average to
    # exactly 1.0 in every channel
    ones = np.isclose(img, 1.0, atol=1e-5).all(axis=-1)
    assert ones.any()
    # left wall tinted red, right wall blue
    left = img[8:16, :6].mean(axis=(0, 1))
    right = img[8:16, -6:].mean(axis=(0, 1))
    assert left[0] > left[2]
    assert right[2] > right[0]


def test_render_f32_matches_f64(tiny_cfg):
    """f32 device path vs f64 golden on identical RNG: estimator parity."""
    sc = get_scene("reference", tiny_cfg)
    a32, meta = pack_scene(sc.objects, dtype=jnp.float32)
    a64, _ = pack_scene(sc.objects, dtype=jnp.float64)
    cfg64 = tiny_cfg.replace(dtype="float64")
    img32 = render(a32, meta, sc.camera, tiny_cfg)
    img64 = render(a64, meta, sc.camera, cfg64)
    # same threefry draws in both precisions -> images nearly identical
    # except for the rare sample whose roulette decision flips on an f32
    # rounding boundary
    diff = np.abs(img32 - img64)
    assert diff.mean() < 0.01
    assert (diff > 0.05).mean() < 0.02


def test_render_default_scene_with_bvh(tiny_cfg):
    sc = get_scene("default", tiny_cfg)
    arrays, meta = pack_scene(sc.objects)
    img = render(arrays, meta, sc.camera, tiny_cfg)
    assert np.isfinite(img).all()
    assert 0.01 < img.mean() < 0.6


def test_render_non_divisible_spp_normalization():
    """samples=10 with chunk 8 must render (and normalize by) ceil-rounded
    16 samples, not render 8 and divide by 10 (regression: integrator.py
    used to floor n_chunks and divide by cfg.samples)."""
    cfg10 = RenderConfig(width=16, height=12, samples=10, samples_per_pass=8)
    cfg16 = RenderConfig(width=16, height=12, samples=16, samples_per_pass=8)
    sc = get_scene("reference", cfg10)
    arrays, meta = pack_scene(sc.objects)
    img10 = render(arrays, meta, sc.camera, cfg10)
    img16 = render(arrays, meta, sc.camera, cfg16)
    # with aperture 0 the sample budget only sets chunk count + divisor:
    # both configs run 2 chunks of 8 and divide by 16 -> bitwise equal
    np.testing.assert_array_equal(img10, img16)
