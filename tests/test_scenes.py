"""Scene registry regression: all 15 reference scenes (cmd/pt/main.go:27-43)
pack with the expected structure (+ the `textures-file` extension scene,
which demonstrates file-backed textures on the wavefront path)."""
import pytest

from pathtracer.config import RenderConfig
from pathtracer.scenes import get_scene, list_scenes

EXPECTED = {
    # name: (n_objects, has_mesh, textured)
    "reference": (8, False, False),
    "default": (11, True, False),
    "teapot": (8, True, False),
    "glass": (13, True, False),
    "gopher": (9, True, False),
    "gopher-window": (15, True, False),
    "christian": (15, True, False),
    "textures": (9, False, True),
    "textures-file": (9, False, True),
    "textures-train": (9, False, True),
    "envmap": (2, False, True),
    "envmap-file": (2, False, True),
    "cubemap": (4, True, True),
    "reflection": (8, False, False),
    "transparency": (9, False, False),
    "transparency_quad_lights": (12, False, False),
    "transparency_f_light": (11, False, False),
    "transparent_teapot": (9, True, False),
}


def test_registry_complete():
    assert sorted(list_scenes()) == sorted(EXPECTED)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_scene_packs(name):
    cfg = RenderConfig(width=8, height=8, samples=1)
    sc = get_scene(name, cfg)
    arrays, meta = sc.pack()
    n_objects, has_mesh, textured = EXPECTED[name]
    assert meta.n_objects == n_objects, name
    assert meta.has_groups == has_mesh, name
    assert bool(meta.textured_types) == textured, name
    if has_mesh:
        assert meta.n_tri_slots >= 3
    assert len(meta.light_indices) >= 1
