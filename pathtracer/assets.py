"""Asset resolution and procedural substitutes.

The reference loads models/textures from an `assets/` directory relative to
the working directory (e.g. teapot.go:80 reads "assets/teapot.obj",
texturedplanets.go:124-129 loads six texture images). Several of the texture
assets and glass.obj are missing from the reference repository itself
(SURVEY.md §2.4), so this module provides:

- a search path for real assets: $PT_ASSETS, ./assets, <repo>/assets
- deterministic procedural substitutes for anything not found, so every
  registered scene renders out of the box
"""
from __future__ import annotations

import logging
import math
import os
from typing import List, Optional

import numpy as np

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def asset_search_paths() -> List[str]:
    paths = []
    env = os.environ.get("PT_ASSETS")
    if env:
        paths.append(env)
    paths.append(os.path.join(os.getcwd(), "assets"))
    paths.append(os.path.join(_REPO_ROOT, "assets"))
    return paths


def find_asset(name: str) -> Optional[str]:
    for d in asset_search_paths():
        p = os.path.join(d, name)
        if os.path.isfile(p):
            return p
    return None


# ---------------------------------------------------------------------------
# Procedural meshes (fallbacks for missing .obj assets)
# ---------------------------------------------------------------------------

def uv_sphere_obj(n_lat: int = 24, n_lon: int = 32, name: str = "Sphere") -> str:
    """A .obj-format UV sphere (v + f lines only, like teapot.obj which has
    no vn records — exercises ComputeVertexNormals)."""
    lines = [f"g {name}"]
    verts = []
    for i in range(n_lat + 1):
        phi = math.pi * i / n_lat
        for j in range(n_lon):
            theta = 2.0 * math.pi * j / n_lon
            verts.append((
                math.sin(phi) * math.cos(theta),
                math.cos(phi),
                math.sin(phi) * math.sin(theta),
            ))
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")

    def vid(i, j):
        return i * n_lon + (j % n_lon) + 1

    for i in range(n_lat):
        for j in range(n_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                lines.append(f"f {a} {b} {c}")
            if i < n_lat - 1:
                lines.append(f"f {a} {c} {d}")
    return "\n".join(lines)


def goblet_obj(n_seg: int = 32, name: str = "Glass") -> str:
    """Procedural stand-in for the missing glass.obj: a lathed goblet
    profile (bowl + stem + foot), two named groups like the reference's
    glass() loader expects (transparent_glass.go:121-134)."""
    # lathe profile: (radius, y) pairs bottom->top
    profile = [
        (0.001, 0.0), (0.9, 0.0), (0.95, 0.05), (0.3, 0.1), (0.15, 0.15),
        (0.12, 1.2), (0.3, 1.4), (0.75, 1.8), (0.95, 2.4), (1.0, 3.0),
    ]
    lines = [f"g {name}Bowl"]
    verts = []
    for r, y in profile:
        for j in range(n_seg):
            t = 2.0 * math.pi * j / n_seg
            verts.append((r * math.cos(t), y, r * math.sin(t)))
    for v in verts:
        lines.append(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}")

    def vid(i, j):
        return i * n_seg + (j % n_seg) + 1

    half = len(profile) // 2
    for i in range(len(profile) - 1):
        if i == half:
            lines.append(f"g {name}Stem")
        for j in range(n_seg):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            lines.append(f"f {a} {b} {c}")
            lines.append(f"f {a} {c} {d}")
    return "\n".join(lines)


def load_obj_source(name: str) -> str:
    """Return .obj text for `name`, real file if found, else a procedural
    substitute (the reference panics on missing assets, teapot.go:80-83;
    we degrade gracefully so all 15 scenes always run)."""
    p = find_asset(name)
    if p is not None:
        with open(p) as f:
            return f.read()
    if name == "glass.obj":
        return goblet_obj()
    return uv_sphere_obj(name=os.path.splitext(name)[0])


# ---------------------------------------------------------------------------
# Procedural textures ([H, W, 3] float32 in [0, 1]).
#
# Every generator is a thin wrapper over render/proctex.py: a hashable
# descriptor + closed-form per-texel program that BOTH the host pool
# packer and the Pallas megakernel evaluate identically (the megakernel
# computes texels instead of gathering them from the pool). The returned
# arrays are ProcImage (ndarray subclass) carrying
# the descriptor; file-loaded images stay plain ndarrays and render on
# the wavefront path.
# ---------------------------------------------------------------------------

def checker_texture(h: int = 512, w: int = 512, n: int = 8,
                    c1=(0.9, 0.9, 0.9), c2=(0.2, 0.2, 0.2)) -> np.ndarray:
    from .render import proctex
    return proctex.make(("checker", (n, tuple(c1), tuple(c2))), h, w)


def squares_texture(h: int = 512, w: int = 512) -> np.ndarray:
    """Stand-in for concrete_squares.png: grout lines over noisy concrete."""
    from .render import proctex
    return proctex.make(("squares", (7,)), h, w)


def squares_normal_map(h: int = 512, w: int = 512) -> np.ndarray:
    """Normal-map stand-in for concrete_squares_nm2.png: beveled edges at
    the grout lines. Texel values must be in [0,1] like any 8-bit image —
    the kernel normalizes the raw texel and uses it as the normal
    (tracer.cl:907-911), so bevels are encoded as small x/z excursions on
    a dominant y component."""
    from .render import proctex
    return proctex.make(("squares_nm", ()), h, w)


def cobblestone_texture(h: int = 512, w: int = 512) -> np.ndarray:
    from .render import proctex
    return proctex.make(("cobblestone", (11, 13)), h, w)


def floorboards_texture(h: int = 512, w: int = 512) -> np.ndarray:
    from .render import proctex
    return proctex.make(("floorboards", (17,)), h, w)


def planet_texture(h: int = 512, w: int = 1024, seed: int = 23) -> np.ndarray:
    """2:1 equirectangular planet: continents over ocean."""
    from .render import proctex
    return proctex.make(("planet", (seed,)), h, w)


def jupiter_texture(h: int = 512, w: int = 1024) -> np.ndarray:
    from .render import proctex
    return proctex.make(("jupiter", (31,)), h, w)


def sky_sphere_texture(h: int = 1024, w: int = 2048) -> np.ndarray:
    """Stand-in for alps_field_8k.png: 2:1 sky gradient + ground + sun."""
    from .render import proctex
    return proctex.make(("sky", ()), h, w)


def cubemap_cross_texture(face: int = 256) -> np.ndarray:
    """Stand-in for shrine_cubemap.jpeg in the 4x3 cross layout the kernel
    samples (tracer.cl:113-147): +X right, -X left, +Y top, -Y bottom,
    +Z front, -Z back."""
    from .render import proctex
    return proctex.make(("cube_cross", (face,)), 3 * face, 4 * face)


def load_texture(name: str) -> np.ndarray:
    """Real image if present in the asset path, procedural otherwise.

    The built-in decoder reads PNG only: a JPEG asset that is present
    (the reference's cobblestone and shrine cubemap) is not decoded; it
    renders as its procedural stand-in, with a warning."""
    p = find_asset(name)
    if p is not None:
        if p.lower().endswith(".png"):
            from .io.png import load_image
            return load_image(p)
        logging.getLogger("pathtracer").warning(
            "%s: only PNG images are decoded; rendering its procedural "
            "stand-in instead", p)
    gen = {
        "concrete_squares.png": squares_texture,
        "concrete_squares_nm2.png": squares_normal_map,
        "seamless-cobblestone-texture.jpg": cobblestone_texture,
        "floor_boards.png": floorboards_texture,
        "planet.png": planet_texture,
        "jupiter2_6k_contrast.png": jupiter_texture,
        "alps_field_8k.png": sky_sphere_texture,
        "shrine_cubemap.jpeg": cubemap_cross_texture,
    }
    if name in gen:
        return gen[name]()
    return checker_texture()
