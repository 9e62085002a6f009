"""Distributed rendering tests on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.parallel import make_mesh, mesh_shape_for, render_sharded
from pathtracer.render.integrator import render
from pathtracer.scene.pack import pack_scene
from pathtracer.scenes import get_scene


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=32, height=24, samples=16, samples_per_pass=8)
    sc = get_scene("reference", cfg)
    arrays, meta = pack_scene(sc.objects)
    return cfg, sc, arrays, meta


def test_mesh_shape():
    assert mesh_shape_for(8) == (4, 2)
    assert mesh_shape_for(1) == (1, 1)
    assert mesh_shape_for(3) == (3, 1)


def test_eight_devices_available():
    assert len(jax.devices()) == 8


def test_render_sharded_runs_and_is_deterministic(setup):
    cfg, sc, arrays, meta = setup
    mesh = make_mesh()
    img1 = render_sharded(arrays, meta, sc.camera, cfg, mesh)
    img2 = render_sharded(arrays, meta, sc.camera, cfg, mesh)
    assert img1.shape == (24, 32, 3)
    assert np.isfinite(img1).all()
    assert np.array_equal(img1, img2)


def test_render_sharded_matches_local_statistically(setup):
    cfg, sc, arrays, meta = setup
    big = cfg.replace(samples=64, samples_per_pass=8)
    mesh = make_mesh()
    img_dist = render_sharded(arrays, meta, sc.camera, big, mesh)
    img_local = render(arrays, meta, sc.camera, big)
    # different RNG streams -> agree in expectation
    assert abs(img_dist.mean() - img_local.mean()) < 0.03
    assert np.abs(img_dist - img_local).mean() < 0.12


def _pallas_segments(setup_cfg, sc, arrays, meta, mesh):
    from pathtracer.parallel.render_dist import make_driver_segments

    return make_driver_segments(arrays, meta, sc.camera, setup_cfg, mesh,
                                True, None, interpret=True)


def test_render_sharded_pallas_matches_local(setup):
    """The distributed MEGAKERNEL (the driver's shard_map segments over
    ('pixels','spp') with the Pallas kernel per shard) on the CPU mesh
    in interpret mode: statistical parity with the local wavefront."""
    cfg, sc, arrays, meta = setup
    big = cfg.replace(samples=16, samples_per_pass=8)
    mesh = make_mesh()                   # (4, 2)
    segment, finalize, padded = _pallas_segments(big, sc, arrays, meta,
                                                 mesh)
    acc = segment(0, 2, None)
    flat = np.stack([np.asarray(c) for c in acc], -1)
    img = finalize(flat).reshape(24, 32, 3) / 16.0
    assert np.isfinite(img).all() and img.min() >= 0.0
    img_local = render(arrays, meta, sc.camera, big)
    assert abs(img.mean() - img_local.mean()) < 0.05
    # independent RNG streams at 16 spp: per-pixel MAD is MC noise
    assert np.abs(img - img_local).mean() < 0.25


def test_render_sharded_pixels_only_mesh(setup):
    cfg, sc, arrays, meta = setup
    mesh = make_mesh(shape=(8, 1))
    img = render_sharded(arrays, meta, sc.camera, cfg, mesh)
    assert np.isfinite(img).all()
    assert 0.05 < img.mean() < 0.6


def test_driver_with_mesh_matches_local_statistically(setup):
    """render_driver(mesh=...) — the unified distributed path — agrees
    with the single-device driver in expectation, and populates stats."""
    from pathtracer.driver import render_driver

    cfg, sc, arrays, meta = setup
    big = cfg.replace(samples=64, samples_per_pass=8)
    mesh = make_mesh()
    img_dist, stats = render_driver(arrays, meta, sc.camera, big,
                                    mesh=mesh)
    img_local, _ = render_driver(arrays, meta, sc.camera, big)
    assert img_dist.shape == (24, 32, 3)
    assert stats.backend == "wavefront@4x2"
    assert stats.samples == 32 * 24 * 64
    assert stats.segments >= 1
    assert abs(img_dist.mean() - img_local.mean()) < 0.03
    assert np.abs(img_dist - img_local).mean() < 0.15
    # the unified driver path IS render_sharded's estimator, bit-exactly
    # (same RNG stream layout) — plus checkpoints/recovery/stats on top
    img_sharded = render_sharded(arrays, meta, sc.camera, big, mesh)
    np.testing.assert_array_equal(img_dist, img_sharded)


def test_driver_with_mesh_checkpoint_resume(tmp_path, setup, monkeypatch):
    """Checkpoint/resume is bit-identical under distribution (VERDICT
    round-1: the distributed path used to forfeit the driver entirely)."""
    from pathtracer.driver import render_driver

    cfg, sc, arrays, meta = setup
    cfg = cfg.replace(samples=32)          # 4 chunks of 8 spp
    mesh = make_mesh()
    ck = str(tmp_path / "ck.npz")

    img_full, _ = render_driver(arrays, meta, sc.camera, cfg, mesh=mesh,
                                checkpoint_path=None, checkpoint_every=2)

    # interrupted run: fault injection exhausts retries at chunk 2, AFTER
    # the first 2-chunk segment checkpointed
    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    monkeypatch.setenv("PT_FAULT_COUNT", "99")
    monkeypatch.setenv("PT_MAX_RETRIES", "0")
    with pytest.raises(Exception):
        render_driver(arrays, meta, sc.camera, cfg, mesh=mesh,
                      checkpoint_path=ck, checkpoint_every=2)
    monkeypatch.delenv("PT_FAULT_INJECT")
    monkeypatch.delenv("PT_FAULT_COUNT")
    monkeypatch.delenv("PT_MAX_RETRIES")

    img_resumed, stats = render_driver(
        arrays, meta, sc.camera, cfg, mesh=mesh,
        checkpoint_path=ck, checkpoint_every=2, resume=True)
    # resume picked up mid-render, not from scratch
    assert stats.samples < 32 * 24 * 32
    np.testing.assert_array_equal(img_full, img_resumed)


def test_driver_with_mesh_recovers_from_fault(setup, monkeypatch):
    from pathtracer.driver import render_driver

    cfg, sc, arrays, meta = setup
    mesh = make_mesh()
    img_ok, _ = render_driver(arrays, meta, sc.camera, cfg, mesh=mesh)
    monkeypatch.setenv("PT_FAULT_INJECT", "1")
    img_rec, stats = render_driver(arrays, meta, sc.camera, cfg,
                                   mesh=mesh)
    assert stats.recoveries == 1
    np.testing.assert_array_equal(img_ok, img_rec)


def test_render_sharded_pallas_rounds_spp_up(setup, monkeypatch):
    """Each 'spp' shard renders its own slice of a segment's global
    samples: a 4-chunk segment over a 2-way 'spp' axis gives every shard
    2 chunks' worth of samples, at sample bases 0 and 2 chunks, and the
    padded pixel slots split evenly over the 'pixels' shards."""
    from pathtracer.render import pallas_kernel as pk

    cfg, sc, arrays, meta = setup
    seen = []
    real = pk.trace_tiles

    def spy(seed, *args, **kw):
        seen.append((kw["spp"], args[-1].shape[0]))
        return real(seed, *args, **kw)

    # make_driver_segments resolves pk.trace_tiles when it traces
    monkeypatch.setattr(pk, "trace_tiles", spy)
    mesh = make_mesh()  # (4, 2): spp axis size 2
    small = cfg.replace(samples=8, samples_per_pass=2)
    segment, finalize, padded = _pallas_segments(small, sc, arrays, meta,
                                                 mesh)
    acc = segment(0, 4, None)
    assert seen and seen[0] == (4, padded // 4)
    assert padded % (4 * pk.DEFAULT_BLOCK) == 0
    flat = np.stack([np.asarray(c) for c in acc], -1)
    assert np.isfinite(flat).all() and flat.shape == (padded, 3)
