"""Next-event estimation (cfg.nee) — the reference's experimental
explicit-light-sampling path (tracer.cl:786-829, shipped disabled)."""
import numpy as np

from pathtracer.config import RenderConfig
from pathtracer.render.integrator import render
from pathtracer.scenes import get_scene


def test_nee_runs_and_brightens_diffuse():
    cfg = RenderConfig(width=24, height=18, samples=16, samples_per_pass=8)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    assert meta.light_indices == (0,)  # the flattened sphere light

    base = render(arrays, meta, sc.camera, cfg)
    nee = render(arrays, meta, sc.camera, cfg.replace(nee=True))
    assert np.isfinite(nee).all()
    # NEE adds direct-light contributions on top of the path estimator
    # (the reference's version double-counts by design — it keeps the
    # emission-on-hit path too)
    assert nee.mean() > base.mean()
    # same scene visibility: wall hit pattern unchanged
    assert (nee > 0).sum() >= (base > 0).sum()


def test_light_indices_static():
    cfg = RenderConfig(width=8, height=8, samples=1)
    for name, n_lights in [("reference", 1), ("transparency_quad_lights", 4),
                           ("transparency_f_light", 3)]:
        sc = get_scene(name, cfg)
        _, meta = sc.pack()
        assert len(meta.light_indices) == n_lights, name


def _mk_render(cfg, sc, arrays, meta, spp):
    """Megakernel interpret-mode image at spp samples -> [H, W, 3]."""
    import jax.numpy as jnp

    from pathtracer.render import pallas_kernel as pk

    W, H = cfg.width, cfg.height
    obj, nodes, tris = pk.scene_tables(arrays, meta)
    r, g, b = pk.trace_tiles(
        jnp.asarray([3, 0], jnp.int32),
        jnp.asarray(pk.build_camera_vec(sc.camera)), obj, nodes, tris,
        jnp.asarray(pk.pixel_slots(W, H, pk.DEFAULT_BLOCK)), meta=meta,
        cfg=cfg, spp=spp, total_samples=spp, interpret=True)
    img = np.stack([np.asarray(c)[:W * H] for c in (r, g, b)], axis=-1)
    return img.reshape(H, W, 3) / float(spp)


def test_megakernel_nee_matches_wavefront_statistically():
    """cfg.nee on the MEGAKERNEL (in-kernel shadow traversal,
    pallas_kernel.py) agrees with the wavefront NEE estimator
    (integrator._next_event_estimation) in expectation — independent
    RNG streams, same biased estimator (tracer.cl:786-829)."""
    cfg = RenderConfig(width=24, height=18, samples=32,
                       samples_per_pass=8)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()

    nee_cfg = cfg.replace(nee=True)
    img_wf = render(arrays, meta, sc.camera, nee_cfg)
    img_mk = _mk_render(nee_cfg, sc, arrays, meta, 32)
    assert np.isfinite(img_mk).all()
    # NEE actually fired in the kernel: brighter than the base estimator
    img_mk_base = _mk_render(cfg, sc, arrays, meta, 32)
    assert img_mk.mean() > img_mk_base.mean() * 1.2
    # statistical agreement with the wavefront NEE (MC noise at 32 spp)
    assert abs(img_mk.mean() - img_wf.mean()) < 0.08 * img_wf.mean()
    assert np.abs(img_mk - img_wf).mean() < 0.25


def test_megakernel_nee_multi_light():
    """All lights statically unrolled: the 4-light scene runs and
    brightens under the megakernel NEE."""
    cfg = RenderConfig(width=16, height=12, samples=8, samples_per_pass=8)
    sc = get_scene("transparency_quad_lights", cfg)
    arrays, meta = sc.pack()
    assert len(meta.light_indices) == 4
    base = _mk_render(cfg, sc, arrays, meta, 8)
    nee = _mk_render(cfg.replace(nee=True), sc, arrays, meta, 8)
    assert np.isfinite(nee).all()
    assert nee.mean() > base.mean()


def test_megakernel_nee_mesh_scene():
    """NEE shadow rays walk the BVH in-kernel (GROUP objects in
    the shadow intersect unroll): the teapot scene runs, stays finite,
    and the mesh still shadows the floor (non-degenerate image)."""
    cfg = RenderConfig(width=16, height=12, samples=4, samples_per_pass=4)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    assert meta.light_indices
    base = _mk_render(cfg, sc, arrays, meta, 4)
    nee = _mk_render(cfg.replace(nee=True), sc, arrays, meta, 4)
    assert np.isfinite(nee).all()
    assert nee.mean() > base.mean()
    assert nee.std() > 0.01
