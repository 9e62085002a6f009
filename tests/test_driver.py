"""Driver subsystems: checkpoint/resume, failure detection + recovery.

The reference has neither (SURVEY.md §5: every error path is Fatalf,
nothing can resume a render). These tests pin the rebuild's contract:
- a render interrupted after N chunks resumes BIT-IDENTICALLY (the RNG is
  counter-based over global chunk indices, and the host f64 accumulation
  order is per-chunk in both runs)
- an injected segment failure (PT_FAULT_INJECT) is detected and
  re-rendered from the last host flush with an identical result
- a failure with retries exhausted propagates
"""
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.driver import render_driver
from pathtracer.scene.pack import pack_scene
from pathtracer.scenes import get_scene


def _setup():
    cfg = RenderConfig(width=32, height=24, samples=8, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = pack_scene(sc.objects)
    return cfg, sc, arrays, meta


@pytest.fixture()
def small_segments(monkeypatch):
    # one 2-spp chunk per segment so faults/checkpoints land mid-render
    monkeypatch.setenv("PT_SEG_SPP", "2")
    monkeypatch.delenv("PT_FAULT_INJECT", raising=False)


def test_checkpoint_resume_bit_identical(tmp_path, small_segments,
                                         monkeypatch):
    cfg, sc, arrays, meta = _setup()
    # the baseline must also checkpoint per chunk: flushing moves the
    # chunk summation from f32-on-device to f64-on-host, so only runs
    # with the SAME flush boundaries are bit-comparable
    clean, _ = render_driver(arrays, meta, sc.camera, cfg,
                             checkpoint_path=str(tmp_path / "clean.npz"),
                             checkpoint_every=1)

    # interrupt after chunk 2: inject a fault with retries disabled so it
    # propagates, leaving the chunk-2 checkpoint behind
    ck = str(tmp_path / "ck.npz")
    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    monkeypatch.setenv("PT_MAX_RETRIES", "0")
    with pytest.raises(RuntimeError):
        render_driver(arrays, meta, sc.camera, cfg,
                      checkpoint_path=ck, checkpoint_every=1)
    monkeypatch.delenv("PT_FAULT_INJECT")
    monkeypatch.delenv("PT_MAX_RETRIES")

    with np.load(ck, allow_pickle=False) as z:
        assert int(z["chunks_done"]) == 2  # partial state on disk

    resumed, stats = render_driver(arrays, meta, sc.camera, cfg,
                                   checkpoint_path=ck, checkpoint_every=1,
                                   resume=True)
    np.testing.assert_array_equal(resumed, clean)
    assert stats.segments == 2  # only chunks 3 and 4 were re-rendered


def test_fault_recovery_identical_output(small_segments, monkeypatch):
    cfg, sc, arrays, meta = _setup()
    clean, clean_stats = render_driver(arrays, meta, sc.camera, cfg)
    assert clean_stats.recoveries == 0

    monkeypatch.setenv("PT_FAULT_INJECT", "2")
    healed, stats = render_driver(arrays, meta, sc.camera, cfg)
    assert stats.recoveries == 1
    # re-rendered chunks use the same counter-based streams -> identical
    np.testing.assert_array_equal(healed, clean)


def test_retries_exhausted_raises(small_segments, monkeypatch):
    cfg, sc, arrays, meta = _setup()
    # persistent outage: the fault re-fires on every retry of chunk 0
    monkeypatch.setenv("PT_MAX_RETRIES", "2")
    monkeypatch.setenv("PT_FAULT_INJECT", "0")
    monkeypatch.setenv("PT_FAULT_COUNT", "10")
    with pytest.raises(RuntimeError, match="PT_FAULT_INJECT"):
        render_driver(arrays, meta, sc.camera, cfg)


def test_transient_multi_fault_recovers(small_segments, monkeypatch):
    cfg, sc, arrays, meta = _setup()
    clean, _ = render_driver(arrays, meta, sc.camera, cfg)
    # two consecutive failures at chunk 1, then the device comes back
    monkeypatch.setenv("PT_FAULT_INJECT", "1")
    monkeypatch.setenv("PT_FAULT_COUNT", "2")
    healed, stats = render_driver(arrays, meta, sc.camera, cfg)
    assert stats.recoveries == 2
    np.testing.assert_array_equal(healed, clean)


def test_checkpoint_config_mismatch_rejected(tmp_path, small_segments):
    cfg, sc, arrays, meta = _setup()
    ck = str(tmp_path / "ck.npz")
    render_driver(arrays, meta, sc.camera, cfg,
                  checkpoint_path=ck, checkpoint_every=1)
    other = cfg.replace(seed=cfg.seed + 1)
    with pytest.raises(ValueError, match="seed"):
        render_driver(arrays, meta, sc.camera, other,
                      checkpoint_path=ck, checkpoint_every=1, resume=True)


def test_checkpoint_layout_mismatch_rejected(tmp_path):
    """Two pixel layouts can have the SAME slot count, so resuming a
    checkpoint across layouts would silently pixel-permute the image —
    the layout tag must reject it."""
    from pathtracer.driver import _checkpoint_load, _checkpoint_save

    cfg = RenderConfig(width=8, height=6, samples=4, samples_per_pass=2)
    ck = str(tmp_path / "ck.npz")
    _checkpoint_save(ck, np.zeros((48, 3)), 1, cfg, "pallas", 1,
                     "tile8x512:linear")
    with pytest.raises(ValueError, match="layout"):
        _checkpoint_load(ck, cfg, "pallas", 1, "tile8x512:block")
    _, n = _checkpoint_load(ck, cfg, "pallas", 1, "tile8x512:linear")
    assert n == 1


class _FakeGpu:
    platform = "gpu"
    device_kind = "test double"


def test_forced_pallas_on_unsupported_scene_raises(monkeypatch):
    """--backend pallas on a scene with a file-backed texture (which only
    the wavefront path renders) must fail loudly, not silently render
    untextured. The platform check passes with a stand-in GPU device; the
    scene check raises before any device work."""
    import jax

    cfg = RenderConfig(width=16, height=12, samples=2, samples_per_pass=2,
                       backend="pallas")
    sc = get_scene("textures", cfg)
    sc.textures[0] = np.asarray(sc.textures[0])  # as a loaded PNG would be
    arrays, meta = sc.pack()
    monkeypatch.setattr(jax, "devices", lambda *a: [_FakeGpu()])
    with pytest.raises(ValueError, match="file-backed textures"):
        render_driver(arrays, meta, sc.camera, cfg)


def test_backend_pallas_off_gpu_raises():
    """The megakernel is compiled for the GPU only: --backend pallas on
    the CPU is an error, never a silent interpret-mode render."""
    cfg, sc, arrays, meta = _setup()
    with pytest.raises(ValueError, match="needs a GPU"):
        render_driver(arrays, meta, sc.camera, cfg.replace(backend="pallas"))


def test_auto_backend_is_wavefront_off_gpu(monkeypatch):
    """`auto` picks the megakernel only on a GPU; here the render runs
    on the wavefront path."""
    monkeypatch.setenv("PT_SEG_SPP", "8")
    cfg = RenderConfig(width=8, height=6, samples=2, samples_per_pass=2)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    img, stats = render_driver(arrays, meta, sc.camera, cfg)
    assert stats.backend == "wavefront"
    assert img.shape == (6, 8, 3) and np.isfinite(img).all()
