"""Pallas megakernel: correctness in interpret mode on the CPU, and on the
card.

The megakernel (render/pallas_kernel.py) uses a different RNG than the
wavefront integrator (a counter hash vs threefry), so parity is
statistical: same mean image at matched spp, not bitwise (same policy the
reference forces on us for the OpenCL kernel's wall-clock-seeded
sin-hash, tracer.cl:314). Each render-level test runs twice: in
interpret mode here, and (`gpu` case) compiled for the card, where it
runs through chip_smoke.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.render import pallas_kernel as pk
from pathtracer.render.pallas_kernel import render_pallas, supports_scene
from pathtracer.scenes import get_scene

MODES = ["interpret", pytest.param("gpu", marks=pytest.mark.gpu)]


def _size(mode, small, full):
    """Interpret mode runs the kernel on the CPU: keep it tiny there."""
    return small if mode == "interpret" else full


def _render(mode, arrays, meta, camera, cfg, **kw):
    return render_pallas(arrays, meta, camera, cfg,
                         interpret=(mode == "interpret"), **kw)


def test_supports_scene_classification():
    cfg = RenderConfig(width=32, height=24, samples=1)
    checks = {
        "reference": True,          # planes + spheres
        "transparency": True,       # + glass/mirror roulette
        "default": True,            # triangle group (BVH walk)
        "teapot": True,             # BVH mesh
        "textures": True,           # procedural textures: computed in-kernel
        "cubemap": True,            # procedural cube-cross: computed
        "envmap": True,             # procedural sky sphere: computed
    }
    for name, expect in checks.items():
        sc = get_scene(name, cfg)
        _, meta = sc.pack()
        assert supports_scene(meta) == expect, name


def test_supports_scene_file_texture_falls_back():
    """A scene sampling a file-backed image (no proctex descriptor, as a
    loaded PNG) has no texels the kernel can compute: it must stay on
    the wavefront path, which gathers the full-resolution texel pool."""
    cfg = RenderConfig(width=32, height=24, samples=1)
    sc = get_scene("textures", cfg)
    sc.textures[0] = np.asarray(sc.textures[0])
    _, meta = sc.pack()
    assert not supports_scene(meta)
    assert any(d is None for (_s, d, *_r) in meta.obj_tex)


def _reference_parity(mode, w, h, spp, mean_tol, pixel_tol):
    from pathtracer.render.integrator import render

    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=spp)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    img_p = _render(mode, arrays, meta, sc.camera, cfg)
    img_w = render(arrays, meta, sc.camera, cfg)

    assert np.isfinite(img_p).all()
    assert img_p.min() >= 0.0
    # independent-RNG estimates of the same integral: means agree
    assert abs(img_p.mean() - img_w.mean()) < mean_tol
    # and so do per-pixel values up to MC noise
    assert np.abs(img_p - img_w).mean() < pixel_tol


@pytest.mark.gpu
def test_megakernel_matches_wavefront_mean():
    _reference_parity("gpu", 64, 48, 64, 0.03, 0.15)


def test_megakernel_matches_wavefront_mean_cpu_interpret():
    """The CPU twin of the card test above, in interpret mode: runs in
    every suite invocation."""
    _reference_parity("interpret", 32, 24, 32, 0.04, 0.2)


@pytest.mark.parametrize("mode", MODES)
def test_megakernel_textured_matches_wavefront_mean(mode):
    """Textured megakernel (computed texels + polynomial sphere UV +
    normal maps) vs the wavefront integrator: independent estimators of
    the same integral."""
    from pathtracer.render.integrator import render

    w, h, spp = _size(mode, (16, 12, 8), (64, 48, 64))
    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=spp)
    for scene in ("textures", "envmap"):
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack()
        assert supports_scene(meta), scene
        img_p = _render(mode, arrays, meta, sc.camera, cfg)
        img_w = render(arrays, meta, sc.camera, cfg)
        assert np.isfinite(img_p).all() and img_p.min() >= 0.0, scene
        assert abs(img_p.mean() - img_w.mean()) < _size(mode, 0.06, 0.04)
        assert np.abs(img_p - img_w).mean() < _size(mode, 0.3, 0.15)


@pytest.mark.parametrize("mode", MODES)
def test_megakernel_mesh_matches_wavefront_mean(mode):
    """BVH mesh path (packet walk) vs the wavefront integrator."""
    from pathtracer.render.integrator import render

    w, h, spp = _size(mode, (16, 12, 16), (64, 48, 64))
    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=spp)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    img_p = _render(mode, arrays, meta, sc.camera, cfg)
    img_w = render(arrays, meta, sc.camera, cfg)
    assert np.isfinite(img_p).all()
    assert abs(img_p.mean() - img_w.mean()) < _size(mode, 0.06, 0.03)
    assert np.abs(img_p - img_w).mean() < _size(mode, 0.3, 0.15)


@pytest.mark.parametrize("mode", MODES)
def test_megakernel_deterministic_per_seed(mode):
    w, h, spp = _size(mode, (16, 8, 4), (64, 48, 16))
    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=spp)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    a = _render(mode, arrays, meta, sc.camera, cfg, seed=5)
    b = _render(mode, arrays, meta, sc.camera, cfg, seed=5)
    c = _render(mode, arrays, meta, sc.camera, cfg, seed=6)
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)


def _launch(mode, cfg, sc, arrays, meta, spp, base, block=64, seed=7):
    """One trace_tiles launch of `spp` samples starting at global sample
    `base`; returns the [H, W, 3] radiance SUM."""
    W, H = cfg.width, cfg.height
    obj, nodes, tris = pk.scene_tables(arrays, meta)
    pix = jnp.asarray(pk.pixel_slots(W, H, block))
    r, g, b = pk.trace_tiles(
        jnp.asarray([seed, base], jnp.int32),
        jnp.asarray(pk.build_camera_vec(sc.camera)), obj, nodes, tris, pix,
        meta=meta, cfg=cfg, spp=spp, total_samples=cfg.samples,
        block=block, interpret=(mode == "interpret"))
    img = np.stack([np.asarray(c)[:W * H] for c in (r, g, b)], -1)
    return img.reshape(H, W, 3)


@pytest.mark.parametrize("mode", MODES)
def test_dof_sample_base_threads_into_sunflower(mode):
    """Segmented/sharded DoF launches must continue the sunflower lens
    spiral at their global sample offset: with aperture != 0, the same
    seed with a different sample base must sample different lens points
    (regression: every segment used to re-sample indices 0..spp-1)."""
    w, h = _size(mode, (16, 8), (64, 48))
    cfg = RenderConfig(width=w, height=h, samples=8, aperture=0.1,
                       focal_length=1.6)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    r0 = _launch(mode, cfg, sc, arrays, meta, 4, 0)
    r0b = _launch(mode, cfg, sc, arrays, meta, 4, 0)
    r4 = _launch(mode, cfg, sc, arrays, meta, 4, 4)
    np.testing.assert_array_equal(r0, r0b)   # deterministic
    assert not np.array_equal(r0, r4)        # base reaches the lens spiral


@pytest.mark.parametrize("mode", MODES)
def test_dof_segmented_driver_matches_single_launch_mean(mode):
    """A segmented DoF render (2 launches with sample bases 0 and spp/2)
    is the same render as one launch: the kernel keys its RNG and the
    sunflower on the GLOBAL sample index. On the card the segments come
    from the driver (PT_SEG_SPP)."""
    w, h, spp = _size(mode, (16, 8, 8), (64, 48, 64))
    cfg = RenderConfig(width=w, height=h, samples=spp, samples_per_pass=8,
                       aperture=0.08, focal_length=1.6, backend="pallas")
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    single = _launch(mode, cfg, sc, arrays, meta, spp, 0, seed=cfg.seed)
    if mode == "interpret":
        half = spp // 2
        seg = (_launch(mode, cfg, sc, arrays, meta, half, 0, seed=cfg.seed)
               + _launch(mode, cfg, sc, arrays, meta, half, half,
                         seed=cfg.seed))
        np.testing.assert_allclose(seg, single, rtol=1e-5, atol=1e-5)
        return
    import os

    from pathtracer.driver import render_driver

    os.environ["PT_SEG_SPP"] = str(spp // 2)
    try:
        img_seg, stats = render_driver(arrays, meta, sc.camera, cfg)
    finally:
        del os.environ["PT_SEG_SPP"]
    assert stats.backend == "pallas" and stats.segments == 2
    np.testing.assert_allclose(img_seg, single / spp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", MODES)
def test_render_sharded_pallas_mesh_of_one(mode):
    """The driver's sharded megakernel segments (parallel/render_dist.
    make_driver_segments) on a mesh reproduce the one-device launch: the
    RNG is keyed on the global pixel and sample, so only the psum's
    summation order differs. Interpret mode shards over 2x2 virtual CPU
    devices; on the card a 1x1 mesh."""
    from jax.sharding import Mesh

    from pathtracer.parallel.render_dist import make_driver_segments

    w, h, spp = _size(mode, (16, 8, 4), (64, 48, 16))
    shape = (2, 2) if mode == "interpret" else (1, 1)
    devs = jax.devices()[:shape[0] * shape[1]]
    mesh = Mesh(np.array(devs).reshape(shape), ("pixels", "spp"))
    cfg = RenderConfig(width=w, height=h, samples=spp,
                       samples_per_pass=spp // 2)
    sc = get_scene("default", cfg)  # triangle group -> packet walk
    arrays, meta = sc.pack()
    segment, finalize, padded = make_driver_segments(
        arrays, meta, sc.camera, cfg, mesh, True, None,
        interpret=(mode == "interpret"))
    acc = segment(0, 2, None)
    flat = np.stack([np.asarray(c) for c in acc], -1)
    assert flat.shape == (padded, 3)
    img_d = finalize(flat).reshape(h, w, 3)
    img_s = _launch(mode, cfg, sc, arrays, meta, spp, 0, seed=cfg.seed)
    assert np.isfinite(img_d).all() and img_d.min() >= 0.0
    np.testing.assert_allclose(img_d, img_s, rtol=1e-5, atol=1e-5)


def test_image_independent_of_block_size():
    """The RNG is keyed on the global pixel, not on the program id: the
    image does not change with the block size."""
    cfg = RenderConfig(width=16, height=8, samples=4)
    sc = get_scene("default", cfg)
    arrays, meta = sc.pack()
    a = _launch("interpret", cfg, sc, arrays, meta, 4, 0, block=32)
    b = _launch("interpret", cfg, sc, arrays, meta, 4, 0, block=128)
    np.testing.assert_array_equal(a, b)


def test_pixel_slots_padding():
    for (W, H, block, granule) in [(16, 8, 64, 1), (33, 25, 128, 1),
                                   (1280, 960, 128, 2), (17, 3, 64, 4)]:
        pix = pk.pixel_slots(W, H, block, shard_granule=granule)
        assert pix.dtype == np.int32
        assert pix.shape[0] % (block * granule) == 0
        assert pix.shape[0] - W * H < block * granule
        np.testing.assert_array_equal(pix[:W * H], np.arange(W * H))
        assert (pix[W * H:] == W * H - 1).all()


def test_trace_tiles_rejects_bad_block():
    cfg = RenderConfig(width=16, height=8, samples=1)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    obj, nodes, tris = pk.scene_tables(arrays, meta)
    cam = jnp.asarray(pk.build_camera_vec(sc.camera))
    for block, n in ((48, 96), (64, 96)):
        with pytest.raises(ValueError, match="power of two"):
            pk.trace_tiles(jnp.asarray([0, 0], jnp.int32), cam, obj, nodes,
                           tris, jnp.zeros((n,), jnp.int32), meta=meta,
                           cfg=cfg, block=block, interpret=True)


def test_kernel_rng_uniforms():
    """The counter hash gives [0, 1) uniforms, distinct streams per
    pixel, sample, bounce and draw id."""
    pix = jnp.arange(4096, dtype=jnp.int32)
    pkey = pk._pixel_key(jnp.int32(3), pix)
    s0 = pk._sample_key(pkey, jnp.int32(0))
    u = np.asarray(pk._uniform(s0, 2, jnp.int32(0)))
    assert u.min() >= 0.0 and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.02 and abs(u.var() - 1 / 12) < 0.01
    others = [pk._uniform(s0, 3, jnp.int32(0)),
              pk._uniform(s0, 2, jnp.int32(1)),
              pk._uniform(pk._sample_key(pkey, jnp.int32(1)), 2,
                          jnp.int32(0)),
              pk._uniform(pk._sample_key(pk._pixel_key(jnp.int32(4), pix),
                                         jnp.int32(0)), 2, jnp.int32(0))]
    for v in others:
        v = np.asarray(v)
        assert abs(np.corrcoef(u, v)[0, 1]) < 0.05
        assert (u != v).mean() > 0.99


def test_kernel_has_no_dot():
    """The kernel body is elementwise work and gathers: no matrix
    product (which would run in TF32 on the card unless given a
    precision)."""
    cfg = RenderConfig(width=16, height=8, samples=1)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    obj, nodes, tris = pk.scene_tables(arrays, meta)
    jaxpr = jax.make_jaxpr(lambda *a: pk.trace_tiles(
        *a, meta=meta, cfg=cfg, spp=1, total_samples=1, interpret=True))(
        jnp.asarray([0, 0], jnp.int32),
        jnp.asarray(pk.build_camera_vec(sc.camera)), obj, nodes, tris,
        jnp.asarray(pk.pixel_slots(16, 8, pk.DEFAULT_BLOCK)))
    text = str(jaxpr)
    assert "pallas_call" in text
    assert "dot_general" not in text


def test_staged_wavefront_uses_pool_gathers():
    """A scene with file-backed textures renders on the WAVEFRONT path,
    which gathers texels from the full-resolution pool: with the same
    texel data as procedural programs, the megakernel's computed texels
    and the wavefront's gathered ones are estimators of one integral.
    Exercises file-backed NORMAL MAPS too."""
    from pathtracer.render import proctex
    from pathtracer.render.integrator import render

    cfg = RenderConfig(width=16, height=12, samples=16,
                       samples_per_pass=16)
    tex = [proctex.make(("squares", (7,)), 64, 64),
           proctex.make(("cobblestone", (11, 13)), 64, 64),
           proctex.make(("floorboards", (17,)), 64, 64),
           proctex.make(("squares_nm", ()), 64, 64)]
    sph = [proctex.make(("planet", (23,)), 64, 128),
           proctex.make(("jupiter", (31,)), 64, 128)]
    sc_f = get_scene("textures", cfg)
    sc_f.textures = [np.asarray(t).copy() for t in tex]
    sc_f.sphere_textures = [np.asarray(t).copy() for t in sph]
    arr_f, meta_f = sc_f.pack()
    assert not supports_scene(meta_f)
    img_w = render(arr_f, meta_f, sc_f.camera, cfg)

    sc_p = get_scene("textures", cfg)
    sc_p.textures = list(tex)
    sc_p.sphere_textures = list(sph)
    arr_p, meta_p = sc_p.pack()
    img_p = render_pallas(arr_p, meta_p, sc_p.camera, cfg, interpret=True)
    assert np.isfinite(img_w).all()
    assert abs(img_p.mean() - img_w.mean()) < 0.06
    assert np.abs(img_p - img_w).mean() < 0.3


def test_octant_orders_do_not_change_the_image():
    """The packet walk starts in its majority octant's front-to-back
    node copy; visiting order changes, the closest hits do not."""
    cfg = RenderConfig(width=16, height=8, samples=2)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    assert meta.octant_orders
    a = _launch("interpret", cfg, sc, arrays, meta, 2, 0)
    flat = dataclasses.replace(meta, octant_orders=False)
    b = _launch("interpret", cfg, sc, arrays, flat, 2, 0)
    np.testing.assert_allclose(a, b, atol=1e-5)
