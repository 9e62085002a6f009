"""Texture scenes: `textures` (planets + normal-mapped walls), `envmap`,
and `reflection`.

Constants ported verbatim from internal/app/scenes/{texturedplanets.go:13,
envmap.go:13, reflections.go:12}. Texture image assets are missing from the
reference repository; assets.load_texture substitutes deterministic
procedural images with the same roles (see SURVEY.md §2.4).
"""
from __future__ import annotations

import math

from ..assets import load_texture
from ..config import RenderConfig
from ..geometry import transforms as gx
from ..render.camera import Camera
from ..scene.material import Material
from ..scene.pack import Scene
from ..scene.shapes import Plane, Sphere
from . import register
from .cornell import cornell_walls, default_camera, _p


@register("textures")
def textured_planets_scene(cfg: RenderConfig) -> Scene:
    """TexturedPlanetsScene (texturedplanets.go:13): textured+normal-mapped
    walls, textured planet spheres, two flattened area lights."""
    left_wall = Plane()
    left_wall.set_transform(gx.translate(-0.6, 0, 0))
    left_wall.set_transform(gx.rotate_x(math.pi))
    left_wall.set_transform(gx.rotate_z(math.pi / 2))
    left_wall.set_transform(gx.rotate_y(math.pi / 2))
    left_wall.set_material(Material.diffuse(0.75, 0.25, 0.25))
    left_wall.material.textured = True
    left_wall.material.texture_id = 0
    left_wall.material.textured_nm = True
    left_wall.material.texture_id_nm = 3

    right_wall = Plane()
    right_wall.set_transform(gx.translate(0.6, 0, 0))
    right_wall.set_transform(gx.rotate_z(math.pi / 2))
    right_wall.set_transform(gx.rotate_y(math.pi / 2))
    right_wall.set_material(Material.diffuse(0.25, 0.25, 0.75))
    right_wall.material.textured = True
    right_wall.material.texture_id = 0
    right_wall.material.textured_nm = True
    right_wall.material.texture_id_nm = 3

    floor = Plane()
    floor.set_transform(gx.translate(0, -0.4, 0))
    fm = Material.diffuse(0.9, 0.8, 0.7)
    fm.textured = True
    fm.texture_id = 1
    fm.texture_scale_x = 0.25
    fm.texture_scale_y = 0.25
    floor.set_material(fm)

    ceil = Plane()
    ceil.set_transform(gx.translate(0, 0.4, 0))
    ceil.set_material(Material.diffuse(0.9, 0.8, 0.7))
    ceil.material.textured = True
    ceil.material.texture_id = 2

    back_wall = Plane()
    back_wall.set_transform(gx.translate(0, 0, 0.4))
    back_wall.set_transform(gx.rotate_x(math.pi / 2))
    back_wall.set_material(Material.diffuse(0.9, 0.8, 0.7))
    back_wall.material.textured = True
    back_wall.material.texture_id = 0
    back_wall.material.textured_nm = True
    back_wall.material.texture_id_nm = 3

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.3, -0.1, -0.25))
    left_sphere.set_transform(gx.scale(0.2, 0.2, 0.2))
    left_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))
    left_sphere.material.textured = True
    left_sphere.material.texture_id = 1

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0.2, 0, -0.3))
    right_sphere.set_transform(gx.rotate_y(math.pi))
    right_sphere.set_transform(gx.scale(0.25, 0.25, 0.25))
    right_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))
    right_sphere.material.textured = True
    right_sphere.material.texture_id = 0

    light = Material.light_bulb()
    light.emission = (10.0, 10.0, 10.0)

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(0, 0.395, -0.9))
    lightsource.set_transform(gx.scale(0.283, 0.01, 0.283))
    lightsource.set_material(light)

    lightsource2 = Sphere()
    lightsource2.set_transform(gx.translate(0, 0, -1.7))
    lightsource2.set_transform(gx.scale(0.283, 0.283, 0.01))
    lightsource2.set_material(light)

    objects = [lightsource, lightsource2, floor, ceil, left_wall,
               right_wall, back_wall, left_sphere, right_sphere]
    return Scene(
        camera=default_camera(cfg),
        objects=objects,
        textures=[
            load_texture("concrete_squares.png"),
            load_texture("seamless-cobblestone-texture.jpg"),
            load_texture("floor_boards.png"),
            load_texture("concrete_squares_nm2.png"),
        ],
        sphere_textures=[
            load_texture("planet.png"),
            load_texture("jupiter2_6k_contrast.png"),
        ],
    )


@register("envmap")
def envmap_scene(cfg: RenderConfig) -> Scene:
    """EnvironmentMap (envmap.go:13): emissive textured sky sphere (scale 5)
    + mirror sphere."""
    cam = Camera(
        cfg.width, cfg.height, math.pi / 3,
        _p(0, 0.1, -1.5), _p(0, 0.15, 0),
        aperture=cfg.aperture, focal_length=cfg.focal_length,
    )

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0, -0.14, -0.30))
    right_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    right_sphere.set_material(Material.mirror())

    sky = Sphere()
    sky.set_transform(gx.scale(5, 5, 5))
    sky.material = Material.default()
    sky.material.textured = True
    sky.material.texture_id = 0
    sky.material.emission = (1.0, 1.0, 1.0)

    objects = [right_sphere, sky]
    return Scene(camera=cam, objects=objects,
                 sphere_textures=[load_texture("alps_field_8k.png")])


@register("reflection")
def reflections_scene(cfg: RenderConfig) -> Scene:
    """ReflectionsScene (reflections.go:12): the reference scene with a
    mirror left sphere."""
    left_wall, right_wall, floor, ceil, back_wall, _front = cornell_walls()

    left_sphere = Sphere()
    left_sphere.set_transform(gx.translate(-0.35, -0.28, -0.15))
    left_sphere.set_transform(gx.scale(0.12, 0.12, 0.12))
    left_sphere.set_material(Material.mirror())

    right_sphere = Sphere()
    right_sphere.set_transform(gx.translate(0, -0.24, -0.30))
    right_sphere.set_transform(gx.scale(0.16, 0.16, 0.16))
    right_sphere.set_material(Material.diffuse(0.9, 0.8, 0.7))

    lightsource = Sphere()
    lightsource.set_transform(gx.translate(0, 0.399, 0))
    lightsource.set_transform(gx.scale(0.283, 0.01, 0.283))
    light = Material.light_bulb()
    light.emission = (9.0, 9.0, 9.0)
    lightsource.set_material(light)

    objects = [lightsource, floor, ceil, left_wall, right_wall, back_wall,
               left_sphere, right_sphere]
    return Scene(camera=default_camera(cfg), objects=objects)


@register("textures-file")
def textured_planets_file_scene(cfg: RenderConfig) -> Scene:
    """`textures` with small FILE-BACKED images (plain arrays, no proctex
    descriptor — exactly what a user-loaded PNG looks like). The
    reference samples arbitrary image2d_array_t textures in its hot loop
    (tracer.cl:829,1077-1093); here file-backed images render on the
    wavefront path, which gathers the full-resolution texel pool.
    Extension scene — not one of the reference's 15
    (cmd/pt/main.go:27-43)."""
    import numpy as np

    from ..render import proctex

    sc = textured_planets_scene(cfg)
    mk = lambda d, h, w: np.asarray(proctex.make(d, h, w)).copy()
    sc.textures = [
        mk(("squares", (7,)), 128, 128),
        mk(("cobblestone", (11, 13)), 256, 96),   # non-square
        mk(("floorboards", (17,)), 128, 128),
        mk(("squares_nm", ()), 128, 128),
    ]
    sc.sphere_textures = [
        mk(("planet", (23,)), 128, 256),
        mk(("jupiter", (31,)), 128, 256),
    ]
    return sc


@register("textures-train")
def textured_planets_train_scene(cfg: RenderConfig) -> Scene:
    """`textures-file` configured for TEXEL TRAINING through the
    wavefront AD path (diff/grad, float texture atlases): normal maps
    off (nm texels redirect rays — non-linear). The planar atlas is the
    trainable parameter set; tools/train_demo.py --tex recovers it.
    Extension scene — not one of the reference's 15."""
    sc = textured_planets_file_scene(cfg)
    for o in sc.objects:
        o.material.textured_nm = False
    return sc


@register("envmap-file")
def envmap_file_scene(cfg: RenderConfig) -> Scene:
    """`envmap` with its 1024x2048 sky as a plain FILE-BACKED image (no
    proctex descriptor): the arbitrary-size image2d_array_t capability
    (tracer.cl:829), rendered on the wavefront path at full resolution.
    Extension scene — not one of the reference's 15
    (cmd/pt/main.go:27-43)."""
    import numpy as np

    sc = envmap_scene(cfg)
    sc.sphere_textures = [np.asarray(t).copy() for t in sc.sphere_textures]
    return sc
