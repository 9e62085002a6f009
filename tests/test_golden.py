"""Golden-image regression at fixed seed/spp.

What the reference lacks entirely (SURVEY.md §4: its only 'golden history'
is an informal archive of experiment PNGs): a deterministic small render of
the benchmark scene, bit-stable across refactors of the integrator. The
golden is regenerated with:

    PT_WRITE_GOLDENS=1 python -m pytest tests/test_golden.py

(pytest, because conftest.py is what pins the CPU platform: the golden
is a CPU render, and a plain script on a GPU host would bake GPU numerics
into it). Any intentional change to the estimator
(sampling order, RNG keying, resolve semantics) must regenerate it.
"""
import os

import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.scenes import get_scene

GOLDEN = os.path.join(os.path.dirname(__file__), "goldens", "reference.npz")
CFG = dict(width=32, height=24, samples=8, samples_per_pass=4, seed=7)


def _render():
    from pathtracer.render.integrator import render

    cfg = RenderConfig(**CFG)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    return render(arrays, meta, sc.camera, cfg)


def test_reference_golden():
    img = _render()
    if os.environ.get("PT_WRITE_GOLDENS") == "1":
        os.makedirs(os.path.dirname(GOLDEN), exist_ok=True)
        np.savez_compressed(GOLDEN, img=img)
        pytest.skip(f"golden regenerated: mean={img.mean():.6f}")
    if not os.path.exists(GOLDEN):
        pytest.fail("no golden stored — regenerate with "
                    "PT_WRITE_GOLDENS=1 python -m pytest tests/test_golden.py")
    with np.load(GOLDEN) as z:
        want = z["img"]
    assert img.shape == want.shape
    # identical platform/dtype renders are deterministic; allow small
    # cross-platform float drift
    np.testing.assert_allclose(img, want, atol=2e-5,
                               err_msg=f"mean {img.mean()} vs {want.mean()}")


TEAPOT_GOLDEN = os.path.join(os.path.dirname(__file__), "goldens",
                             "teapot.npz")


def test_teapot_golden():
    """Mesh golden: locks the OBJ parse -> vertex normals -> snapped-SAH
    BVH -> wavefront integrator chain end-to-end at fixed seed. Uses the
    procedural teapot substitute when assets are absent, which is itself
    deterministic."""
    from pathtracer.render.integrator import render

    cfg = RenderConfig(width=32, height=24, samples=4, samples_per_pass=4,
                       seed=7)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    img = render(arrays, meta, sc.camera, cfg)

    if os.environ.get("PT_WRITE_GOLDENS") == "1":
        os.makedirs(os.path.dirname(TEAPOT_GOLDEN), exist_ok=True)
        np.savez_compressed(TEAPOT_GOLDEN, img=img,
                            n_tris=meta.n_tri_slots)
        pytest.skip(f"teapot golden regenerated: mean={img.mean():.6f}")
    if not os.path.exists(TEAPOT_GOLDEN):
        pytest.fail("no teapot golden — regenerate with PT_WRITE_GOLDENS=1")
    with np.load(TEAPOT_GOLDEN) as z:
        want = z["img"]
        n_tris = int(z["n_tris"])
    assert meta.n_tri_slots == n_tris, (
        "triangle pool changed — asset or BVH build drift")
    np.testing.assert_allclose(img, want, atol=2e-5,
                               err_msg=f"mean {img.mean()} vs {want.mean()}")


@pytest.mark.parametrize("scene", ["textures", "transparency"])
def test_scene_goldens(scene):
    """Pinned small renders for the texture pipeline (procedural asset ->
    pack pool -> UV -> bilinear fetch -> normal maps) and the glass /
    mirror roulette chain (schlick, refraction, total internal
    reflection). Regenerate with PT_WRITE_GOLDENS=1."""
    from pathtracer.render.integrator import render

    golden = os.path.join(os.path.dirname(__file__), "goldens",
                          f"{scene}.npz")
    cfg = RenderConfig(width=32, height=24, samples=4, samples_per_pass=4,
                       seed=11)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack()
    img = render(arrays, meta, sc.camera, cfg)

    if os.environ.get("PT_WRITE_GOLDENS") == "1":
        os.makedirs(os.path.dirname(golden), exist_ok=True)
        np.savez_compressed(golden, img=img)
        pytest.skip(f"{scene} golden regenerated: mean={img.mean():.6f}")
    if not os.path.exists(golden):
        pytest.fail(f"no {scene} golden — regenerate with "
                    "PT_WRITE_GOLDENS=1")
    with np.load(golden) as z:
        want = z["img"]
    assert img.shape == want.shape
    np.testing.assert_allclose(img, want, atol=2e-5,
                               err_msg=f"mean {img.mean()} vs {want.mean()}")
