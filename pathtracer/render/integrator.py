"""Wavefront path-tracing integrator (SoA Vec3 layout, see vec3.py).

Behavioral equivalent of the reference megakernel's sample/bounce/resolve
loops (internal/ocl/tracer.cl:867-1187), restructured as whole-batch
array programs for XLA:

- the per-work-item bounce array bounce[16] + backward resolve pass
  (tracer.cl:1116-1176) is folded FORWARD into running (mask, accum) state,
  which is mathematically identical because the resolve is a prefix product
- all material branching (tracer.cl:982-1061) is branchless where-selects
  over the whole ray batch
- the RNG is counter-based threefry keyed on (pass, bounce); the reference's
  wall-clock-seeded sin-hash (tracer.cl:314, cmd/pt/main.go:19) is not
  reproducible by design, so parity is estimator-level, not bitwise

Semantics preserved exactly (all cited):
- max 10 bounces, max 4 "effective" bounces; reflection/refraction bounces
  are free (tracer.cl:884, 1098-1101)
- break on emissive hit; a light hit on the FIRST recorded bounce returns
  the light's color, not emission (tracer.cl:1107, 1156-1163)
- refraction pass-through bounces skip mask/accum updates (tracer.cl:1148)
- thin-shell refractiveIndex == -1 hack (tracer.cl:989-1004)
- reflectivity roulette, schlick-roulette refract/reflect with
  inside-tracking (tracer.cl:982, 1006-1054)
- cos = 1 for non-diffuse bounces (tracer.cl:975)
- per-triangle colors for BVH hits, emission forced to 0 (tracer.cl:672-673,
  1071-1073)
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import RenderConfig
from ..scene.pack import SceneArrays, SceneMeta
from ..scene.shapes import BOX, CYLINDER, PLANE, SPHERE
from .camera import Camera, CameraArrays, rays_for_pixels
from .intersect import intersect_scene
from .sampling import random_vector_in_hemisphere, refracted_direction, schlick
from .uv import (cube_uv, sample_texture, sample_texture_pool,
                 spherical_map)
from .vec3 import Vec3


def _tex_sampler(cfg: RenderConfig, scn: SceneArrays, kind: str):
    """Float-atlas texture fetch for the differentiable path (texel
    gradients flow through sample_texture). The render path fetches from
    the flat u32 pool instead (sample_texture_pool) — one fetch for all
    sampler kinds."""
    atlas = getattr(scn, f"tex_{kind}")
    return lambda li, u, v: sample_texture(atlas, li, u, v)


class PathState(NamedTuple):
    origin: Vec3
    direction: Vec3
    mask: Vec3
    accum: Vec3
    alive: jnp.ndarray     # [R] bool
    inside: jnp.ndarray    # [R] bool
    n_hits: jnp.ndarray    # [R] i32 recorded bounces
    eff: jnp.ndarray       # [R] i32 effective bounces


def _gather_vec(table: jnp.ndarray, idx: jnp.ndarray) -> Vec3:
    """Column gathers from a small [N, 3] table -> Vec3 of [R]."""
    return Vec3(table[idx, 0], table[idx, 1], table[idx, 2])


class ObjAttrs(NamedTuple):
    """Per-ray object attributes for the winning hit, all [R]."""
    color: Vec3
    emission: Vec3
    refractive_index: jnp.ndarray
    reflectivity: jnp.ndarray
    min_y: jnp.ndarray
    max_y: jnp.ndarray
    inv_t: Tuple[jnp.ndarray, ...]   # 12 rows: 3x4 inverse-transpose
    obj_type: jnp.ndarray            # float codes (exact for small ints)
    is_textured: jnp.ndarray
    texture_index: jnp.ndarray       # i32
    texture_scale: Tuple[jnp.ndarray, jnp.ndarray]
    is_textured_nm: jnp.ndarray
    texture_index_nm: jnp.ndarray    # i32
    texture_scale_nm: Tuple[jnp.ndarray, jnp.ndarray]
    # flat-pool fetch coordinates (f32-exact; see pack._build_texel_pool)
    tex_base: jnp.ndarray
    tex_w: jnp.ndarray
    tex_h: jnp.ndarray
    tex_nm_base: jnp.ndarray
    tex_nm_w: jnp.ndarray
    tex_nm_h: jnp.ndarray


def _quad_pool(scn: SceneArrays):
    """Texel-fetch strategy switch (trace-time static): PT_TEX_FETCH=quad
    fetches the whole bilinear footprint with one row gather from the
    precomputed quad pool (pack._build_texel_pool); default is four 1-D
    takes. Both are bit-identical (tests/test_uv.py)."""
    if os.environ.get("PT_TEX_FETCH", "take4") == "quad":
        if scn.tex_pool_quad_u32.shape[0] != scn.tex_pool_u32.shape[0]:
            # scene was packed without the quad pool (PT_TEX_FETCH was
            # take4 at pack time) — fall back rather than fetch zeros
            return None
        return scn.tex_pool_quad_u32
    return None


def _fetch_object_attrs(scn: SceneArrays, oi: jnp.ndarray) -> ObjAttrs:
    """Fetch ALL per-object attributes for each ray with ONE one-hot
    contraction [C, No] @ [No, R] instead of ~30 separate [R]-indexed
    gathers. Whether a plain gather is faster on the GPU is an open
    measurement (ROADMAP Speed #3).
    """
    dt = scn.color.dtype
    no = scn.obj_type.shape[0]

    # [C, No] attribute table (tiny; assembled from the packed scene)
    f = lambda a: a.astype(dt)
    table = jnp.concatenate([
        scn.color.T,                            # 0-2
        scn.emission.T,                         # 3-5
        scn.refractive_index[None, :],          # 6
        scn.reflectivity[None, :],              # 7
        scn.min_y[None, :],                     # 8
        scn.max_y[None, :],                     # 9
        scn.inv_t_affine.T,                     # 10-21
        f(scn.obj_type)[None, :],               # 22
        f(scn.is_textured)[None, :],            # 23
        f(scn.texture_index)[None, :],          # 24
        scn.texture_scale.T,                    # 25-26
        f(scn.is_textured_nm)[None, :],         # 27
        f(scn.texture_index_nm)[None, :],       # 28
        scn.texture_scale_nm.T,                 # 29-30
        f(scn.tex_base)[None, :],               # 31
        f(scn.tex_w)[None, :],                  # 32
        f(scn.tex_h)[None, :],                  # 33
        f(scn.tex_nm_base)[None, :],            # 34
        f(scn.tex_nm_w)[None, :],               # 35
        f(scn.tex_nm_h)[None, :],               # 36
    ], axis=0)

    onehot = (
        jnp.arange(no, dtype=oi.dtype)[:, None] == oi[None, :]
    ).astype(dt)                                 # [No, R]
    attrs = jax.lax.dot_general(
        table, onehot,
        dimension_numbers=(((1,), (0,)), ((), ())),
        preferred_element_type=dt,
        # HIGHEST is load-bearing: the default f32 matmul precision
        # on the GPU is TF32 (10 mantissa bits), which would round
        # inv_t transform entries (geometry!) and tex_base pool
        # offsets (integers > 2048) — they must come back exact. The
        # contraction dim is only n_objects, so the cost is nil.
        precision=jax.lax.Precision.HIGHEST,
    )                                            # [C, R]

    return ObjAttrs(
        color=Vec3(attrs[0], attrs[1], attrs[2]),
        emission=Vec3(attrs[3], attrs[4], attrs[5]),
        refractive_index=attrs[6],
        reflectivity=attrs[7],
        min_y=attrs[8],
        max_y=attrs[9],
        inv_t=tuple(attrs[10 + k] for k in range(12)),
        obj_type=attrs[22],
        is_textured=attrs[23],
        texture_index=attrs[24].astype(jnp.int32),
        texture_scale=(attrs[25], attrs[26]),
        is_textured_nm=attrs[27],
        texture_index_nm=attrs[28].astype(jnp.int32),
        texture_scale_nm=(attrs[29], attrs[30]),
        tex_base=attrs[31],
        tex_w=attrs[32],
        tex_h=attrs[33],
        tex_nm_base=attrs[34],
        tex_nm_w=attrs[35],
        tex_nm_h=attrs[36],
    )


def _mat12_apply_vector(m: Tuple[jnp.ndarray, ...], v: Vec3) -> Vec3:
    """Apply per-ray 3x4 matrices given as 12 [R] row streams."""
    return Vec3(
        m[0] * v.x + m[1] * v.y + m[2] * v.z,
        m[4] * v.x + m[5] * v.y + m[6] * v.z,
        m[8] * v.x + m[9] * v.y + m[10] * v.z,
    )


def _use_computed_tex(meta: SceneMeta, cfg: RenderConfig) -> bool:
    """Compute texels from the procedural programs instead of gathering
    from the texel pool (render/proctex.py), the megakernel's texturing
    strategy. Gathering remains for file-backed images, f64 golden
    renders (programs are f32), the trainable-texture atlases, and
    PT_TEX_MODE=gather A/Bs."""
    from . import pallas_kernel as _pk

    return (_pk.textures_procedural(meta)
            and cfg.dtype == "float32"
            and not cfg.trainable_textures
            and os.environ.get("PT_TEX_MODE", "compute") != "gather")


def _computed_tex_fold(meta: SceneMeta, entries, obj_idx, u, v, out: Vec3
                       ) -> Vec3:
    """Fold per-object-group computed texture samples into `out` at the
    (already type-unified) UV coordinates."""
    import functools

    from . import pallas_kernel as _pk

    for (slots, desc, tw, th, _sx, _sy, _tc) in _pk._tex_groups(
            entries, meta.obj_types):
        msk = functools.reduce(
            jnp.logical_or, [obj_idx == s for s in slots])
        r, g, b = _pk._sample_proc(desc, tw, th, u, v)
        out = Vec3.where(msk, Vec3(r, g, b), out)
    return out


def _surface_normal(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                    at: ObjAttrs, lp: Vec3, tri_normal: Vec3, is_tri,
                    eps, obj_idx=None) -> Vec3:
    """Object-space normal by primitive type (tracer.cl:903-950)."""
    obj_type = at.obj_type
    min_y, max_y = at.min_y, at.max_y
    zero = jnp.zeros_like(lp.x)
    one = jnp.ones_like(zero)

    # PLANE: +Y, or normal-map texture (tracer.cl:906-914). The sampling
    # code is statically elided for scenes without normal maps.
    n_plane = Vec3(zero, one, zero)
    if meta.has_normal_maps:
        has_nm = (at.is_textured_nm == 1) & (obj_type == PLANE)
        nm_sx, nm_sy = at.texture_scale_nm
        nm_u = jnp.abs(lp.x) * nm_sx
        nm_v = jnp.abs(lp.z) * nm_sy
        if _use_computed_tex(meta, cfg) and obj_idx is not None:
            nm_rgb = _computed_tex_fold(
                meta, meta.obj_tex_nm, obj_idx, nm_u, nm_v,
                n_plane).normalized()
        elif not cfg.trainable_textures:
            nm_rgb = sample_texture_pool(
                scn.tex_pool_u32, at.tex_nm_base, at.tex_nm_w,
                at.tex_nm_h, nm_u, nm_v,
                pool_quad_u32=_quad_pool(scn)).normalized()
        else:
            nm_rgb = _tex_sampler(cfg, scn, "planar")(
                at.texture_index_nm, nm_u, nm_v).normalized()
        n_plane = Vec3.where(has_nm, nm_rgb, n_plane)

    # SPHERE: local point minus origin (tracer.cl:915-920) -> lp itself

    # CYLINDER incl. cap normals (tracer.cl:921-932)
    dist = lp.x * lp.x + lp.z * lp.z
    top = (dist < 1.0) & (lp.y >= max_y - eps)
    bottom = (dist < 1.0) & (lp.y <= min_y + eps)
    n_cyl = Vec3.where(
        top, Vec3(zero, one, zero),
        Vec3.where(bottom, Vec3(zero, -one, zero), Vec3(lp.x, zero, lp.z)),
    )

    # CUBE: dominant axis (tracer.cl:933-946)
    a = lp.abs()
    maxc = a.max_component()
    sel_x = maxc == a.x
    sel_y = (~sel_x) & (maxc == a.y)
    n_box = Vec3.where(
        sel_x, Vec3(lp.x, zero, zero),
        Vec3.where(sel_y, Vec3(zero, lp.y, zero), Vec3(zero, zero, lp.z)),
    )

    n = Vec3.where(obj_type == PLANE, n_plane,
        Vec3.where(obj_type == SPHERE, lp,
        Vec3.where(obj_type == CYLINDER, n_cyl,
        Vec3.where(obj_type == BOX, n_box, tri_normal))))
    return Vec3.where(is_tri, tri_normal, n)


def _surface_color(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                   at: ObjAttrs, lp: Vec3, tri_color: Vec3, is_tri,
                   obj_idx=None) -> Vec3:
    """Surface color incl. texture lookups (tracer.cl:1075-1093).

    Texture sampling per primitive type is STATICALLY elided when no object
    of that type is textured (meta.textured_types) — untextured scenes pay
    zero gather cost, unlike the reference's runtime isTextured branch."""
    base = at.color
    obj_type = at.obj_type
    if meta.textured_types:
        # only plane/sphere/box have texture mappings (tracer.cl:1077-1093)
        # — a textured material on any other type keeps its base color
        textured = (at.is_textured == 1) & (
            (obj_type == PLANE) | (obj_type == SPHERE) | (obj_type == BOX))
        sx, sy = at.texture_scale

        if not cfg.trainable_textures:
            # unified UV: select the sampler-kind UV per ray FIRST
            # (cheap VPU selects), then ONE texel evaluation/fetch
            u = lp.x * sx
            v = lp.z * sy
            if SPHERE in meta.textured_types:
                us, vs = spherical_map(lp)
                sel = obj_type == SPHERE
                u = jnp.where(sel, us, u)
                v = jnp.where(sel, 1.0 - vs, v)
            if BOX in meta.textured_types:
                uc, vc = cube_uv(lp)
                sel = obj_type == BOX
                u = jnp.where(sel, uc, u)
                v = jnp.where(sel, vc, v)
            if _use_computed_tex(meta, cfg) and obj_idx is not None:
                # COMPUTE the 4 bilinear taps from the procedural
                # programs — no pool gathers at all on this path
                tex_color = _computed_tex_fold(
                    meta, meta.obj_tex, obj_idx, u, v, base)
            else:
                # flat-pool fetch: texel gathers dominate textured
                # scenes, so one 4-tap fetch for all kinds
                tex_color = sample_texture_pool(
                    scn.tex_pool_u32, at.tex_base, at.tex_w, at.tex_h,
                    u, v, pool_quad_u32=_quad_pool(scn))
        else:
            # differentiable path: per-kind float atlases (texel
            # gradients flow; perf is AD-dominated anyway)
            tex_idx = at.texture_index
            tex_color = base
            if PLANE in meta.textured_types:
                c_plane = _tex_sampler(cfg, scn, "planar")(
                    tex_idx, lp.x * sx, lp.z * sy)
                tex_color = Vec3.where(obj_type == PLANE, c_plane,
                                       tex_color)
            if SPHERE in meta.textured_types:
                us, vs = spherical_map(lp)
                c_sphere = _tex_sampler(cfg, scn, "sphere")(
                    tex_idx, us, 1.0 - vs)
                tex_color = Vec3.where(obj_type == SPHERE, c_sphere,
                                       tex_color)
            if BOX in meta.textured_types:
                uc, vc = cube_uv(lp)
                c_cube = _tex_sampler(cfg, scn, "cube")(tex_idx, uc, vc)
                tex_color = Vec3.where(obj_type == BOX, c_cube, tex_color)

        base = Vec3.where(textured, tex_color, base)
    return Vec3.where(is_tri, tri_color, base)


def _next_event_estimation(scn: SceneArrays, meta: SceneMeta,
                           cfg: RenderConfig, position: Vec3, normal: Vec3,
                           color: Vec3, mask: Vec3, cond: jnp.ndarray,
                           key: jnp.ndarray) -> Vec3:
    """Explicit light sampling (tracer.cl:786-829), statically unrolled
    over the pack-time emissive objects (meta.light_indices)."""
    from .sampling import random_point_on_sphere

    R = position.x.shape[0]
    dt = position.x.dtype
    eps = cfg.epsilon
    out = Vec3.zeros((R,), dt)

    for li, l in enumerate(meta.light_indices):
        u1, u2 = jax.random.uniform(
            jax.random.fold_in(key, li), (2, R), dtype=jnp.float32
        ).astype(dt)
        # light origin from the transform's translation column; scale from
        # the max diagonal element (tracer.cl:790-791)
        tr = scn.transform[l]
        origin = Vec3(
            jnp.broadcast_to(tr[0, 3], (R,)),
            jnp.broadcast_to(tr[1, 3], (R,)),
            jnp.broadcast_to(tr[2, 3], (R,)),
        )
        scale_by = jnp.maximum(jnp.maximum(tr[0, 0], tr[1, 1]), tr[2, 2])
        rpos = random_point_on_sphere(1.0, u1, u2)
        light_pos = origin + rpos * scale_by

        sdir = (light_pos - position).normalized()
        sorigin = position + sdir * eps
        ldn = sdir.dot(normal)

        hit = intersect_scene(scn, meta, sorigin, sdir, eps, cfg.t_max)
        sh_t, sh_idx = hit.t, hit.obj_idx
        visible = (
            cond & (ldn > 0.0) & (sh_idx == l)
            & (sh_t > eps) & (sh_t < cfg.t_max)
        )
        # reference attenuation heuristic (tracer.cl:819)
        atten = 1.0 - sh_t / jnp.sqrt(sh_t * sh_t + tr[0, 0] * tr[0, 0])
        eff = color * Vec3(scn.emission[l, 0], scn.emission[l, 1],
                           scn.emission[l, 2])
        contrib = eff * mask * (ldn * atten)
        out = out + Vec3.where(visible, contrib, Vec3.zeros((R,), dt))
    return out


def bounce_step(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                state: PathState, key: jnp.ndarray) -> PathState:
    eps = cfg.epsilon
    R = state.origin.x.shape[0]
    dt = state.origin.x.dtype

    hit = intersect_scene(scn, meta, state.origin, state.direction,
                          eps, cfg.t_max)
    # triangle smooth normal n2*u + n3*v + n1*(1-u-v) (tracer.cl:669)
    # and per-triangle color, gathered once by winning slot; statically
    # elided for mesh-free scenes
    if meta.has_groups:
        slot = jnp.clip(hit.tri_slot, 0, scn.tri_p1.shape[0] - 1)
        w1 = 1.0 - hit.tri_u - hit.tri_v
        tri_normal = (
            _gather_vec(scn.tri_n2, slot) * hit.tri_u
            + _gather_vec(scn.tri_n3, slot) * hit.tri_v
            + _gather_vec(scn.tri_n1, slot) * w1
        )
        tri_color = _gather_vec(scn.tri_color, slot)
    else:
        tri_normal = Vec3.zeros((R,), dt)
        tri_color = Vec3.zeros((R,), dt)

    hit_ok = hit.t < cfg.t_max

    # ALL per-object attributes in one one-hot fetch
    at = _fetch_object_attrs(scn, hit.obj_idx)

    position = state.origin + state.direction * hit.t
    eye = -state.direction
    # local hit point from the already-transformed per-object ray — no
    # per-ray matrix gather needed
    local_point = hit.local_origin + hit.local_dir * hit.t

    n_local = _surface_normal(
        scn, meta, cfg, at, local_point, tri_normal, hit.is_tri, eps,
        obj_idx=hit.obj_idx,
    )
    normal = _mat12_apply_vector(at.inv_t, n_local).normalized()
    # face-forward (tracer.cl:962-964)
    normal = Vec3.where(eye.dot(normal) < 0.0, -normal, normal)

    over = position + normal * eps
    under = position - normal * eps

    # draw in f32 regardless of compute dtype so f64 golden renders consume
    # bit-identical uniforms (estimator parity across precisions)
    u_refl, u_schl, u1, u2 = jax.random.uniform(
        key, (4, R), dtype=jnp.float32
    ).astype(dt)

    refl = at.reflectivity
    refr = at.refractive_index

    # --- material roulette (tracer.cl:982-1061) -----------------------
    do_reflect = (refl != 0.0) & (u_refl < refl)

    thin = (~do_reflect) & (refr == -1.0)
    sch_thin = schlick(eye, normal, jnp.asarray(1.0, dt), jnp.asarray(1.5, dt))
    thin_pass = thin & (sch_thin < u_schl)
    thin_reflect = thin & ~(sch_thin < u_schl)

    solid = (~do_reflect) & (~thin) & (refr != 1.0)
    outside = ~state.inside
    sch = jnp.where(
        outside,
        schlick(eye, normal, jnp.asarray(1.0, dt), refr),
        schlick(eye, normal, refr, jnp.asarray(1.0, dt)),
    )
    do_refract = solid & (sch < u_schl)
    refract_dir = Vec3.where(
        outside,
        refracted_direction(eye, normal, jnp.asarray(1.0, dt), refr),
        refracted_direction(eye, normal, refr, jnp.asarray(1.0, dt)),
    )
    solid_reflect = solid & ~do_refract

    diffuse = (~do_reflect) & (~thin) & (~solid)
    hemi = random_vector_in_hemisphere(normal, u1, u2)

    reflect_dir = state.direction.reflect(normal)
    any_reflect = do_reflect | thin_reflect | solid_reflect

    new_dir = Vec3.where(any_reflect, reflect_dir,
              Vec3.where(thin_pass, state.direction,
              Vec3.where(do_refract, refract_dir, hemi)))
    cos = jnp.where(diffuse, hemi.dot(normal), jnp.asarray(1.0, dt))
    new_origin = Vec3.where(thin_pass | do_refract, under, over)

    entering = do_refract & outside
    exiting = do_refract & state.inside
    new_inside = jnp.where(do_refract, outside, state.inside)
    is_refraction = entering | exiting

    color = _surface_color(scn, meta, cfg, at, local_point, tri_color,
                           hit.is_tri, obj_idx=hit.obj_idx)
    zero = jnp.zeros_like(color.x)
    emission = Vec3.where(hit.is_tri, Vec3(zero, zero, zero), at.emission)

    # --- fold the resolve pass forward (tracer.cl:1116-1176) ----------
    rec = state.alive & hit_ok
    no_refr = rec & ~is_refraction
    is_light = emission.x > 0.0

    accum = state.accum + Vec3.where(
        no_refr, state.mask * emission, Vec3(zero, zero, zero)
    )

    # optional next-event estimation (tracer.cl:786-829; the reference
    # ships with the call disabled, tracer.cl:1168 — cfg.nee replicates
    # the experimental estimator exactly, including its light-sphere
    # attenuation heuristic)
    if cfg.nee and meta.light_indices:
        nee_cond = no_refr & ~is_light
        accum = accum + _next_event_estimation(
            scn, meta, cfg, position, normal, color, state.mask,
            nee_cond, jax.random.fold_in(key, 3),
        )
    direct = no_refr & is_light & (state.n_hits == 0)
    accum = Vec3.where(direct, color, accum)
    mask = Vec3.where(
        no_refr & ~is_light, state.mask * color * cos, state.mask
    )

    # effective bounces: everything except refraction transits and
    # reflections (tracer.cl:1098-1101) — note a thin-shell pass-through
    # sets neither entering/exiting nor reflecting, so it COUNTS
    eff = state.eff + jnp.where(rec & ~is_refraction & ~any_reflect, 1, 0)
    n_hits = state.n_hits + rec.astype(jnp.int32)
    alive = (
        state.alive & hit_ok & ~(rec & is_light)
        & (eff < cfg.max_effective_bounces)
    )

    return PathState(
        origin=Vec3.where(rec, new_origin, state.origin),
        direction=Vec3.where(rec, new_dir, state.direction),
        mask=mask,
        accum=accum,
        alive=alive,
        inside=jnp.where(rec, new_inside, state.inside),
        n_hits=n_hits,
        eff=eff,
    )


def render_rays(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                origin: Vec3, direction: Vec3, key: jnp.ndarray) -> Vec3:
    """Trace a batch of primary rays to completion; returns accumulated
    radiance as Vec3 of [R] (one sample each)."""
    R = origin.x.shape[0]
    dt = origin.x.dtype
    state = PathState(
        origin=origin,
        direction=direction,
        mask=Vec3.full((R,), 1.0, 1.0, 1.0, dt),
        accum=Vec3.zeros((R,), dt),
        alive=jnp.ones((R,), dtype=bool),
        inside=jnp.zeros((R,), dtype=bool),
        n_hits=jnp.zeros((R,), dtype=jnp.int32),
        eff=jnp.zeros((R,), dtype=jnp.int32),
    )

    # early exit once every ray has terminated (hit a light, missed, or
    # exhausted effective bounces) — the whole-batch analogue of the
    # reference's per-work-item break (tracer.cl:1107). The fixed-trip
    # fori_loop variant computes the identical result (dead rays are
    # masked) and is used for reverse-mode AD (cfg.early_exit=False).
    def _probe(b, s):
        """Per-bounce path-state probe for one ray of the batch — the
        equivalent of the reference's per-pixel printf probes
        (tracer.cl:1015, 1065-1067)."""
        i = cfg.debug_ray
        jax.debug.print(
            "bounce {b} ray {i}: o=({ox:.5f},{oy:.5f},{oz:.5f}) "
            "d=({dx:.5f},{dy:.5f},{dz:.5f}) mask=({mr:.4f},{mg:.4f},"
            "{mb:.4f}) accum=({ar:.4f},{ag:.4f},{ab:.4f}) alive={al}",
            b=b, i=i,
            ox=s.origin.x[i], oy=s.origin.y[i], oz=s.origin.z[i],
            dx=s.direction.x[i], dy=s.direction.y[i], dz=s.direction.z[i],
            mr=s.mask.x[i], mg=s.mask.y[i], mb=s.mask.z[i],
            ar=s.accum.x[i], ag=s.accum.y[i], ab=s.accum.z[i],
            al=s.alive[i],
        )

    if cfg.early_exit:
        def cond(bs):
            b, s = bs
            return (b < cfg.max_bounces) & jnp.any(s.alive)

        def body(bs):
            b, s = bs
            s = bounce_step(scn, meta, cfg, s, jax.random.fold_in(key, b))
            if cfg.debug_ray >= 0:
                _probe(b, s)
            return b + 1, s

        _, state = jax.lax.while_loop(cond, body, (jnp.int32(0), state))
    else:
        # the fixed-trip loop exists for reverse-mode AD; rematerialize
        # each bounce instead of saving its intermediates — without this,
        # the backward pass stores ~30 [R]-sized residuals per bounce to
        # HBM and goes bandwidth-bound (jax.checkpoint = the standard
        # FLOPs-for-memory trade; prevent_cse=False is the loop-body form)
        step = jax.checkpoint(
            lambda s, k: bounce_step(scn, meta, cfg, s, k),
            prevent_cse=False,
        )

        def fbody(b, s):
            s = step(s, jax.random.fold_in(key, b))
            if cfg.debug_ray >= 0:
                _probe(b, s)
            return s

        state = jax.lax.fori_loop(0, cfg.max_bounces, fbody, state)
    return state.accum


def render_pass(scn: SceneArrays, meta: SceneMeta, cfg: RenderConfig,
                cam: CameraArrays, px: jnp.ndarray, py: jnp.ndarray,
                sample0: jnp.ndarray, n_samples: int,
                key: jnp.ndarray) -> Vec3:
    """Render `n_samples` samples for each of P pixels; returns the SUM of
    sample radiances as Vec3 of [P] (caller divides by total spp)."""
    P = px.shape[0]
    S = n_samples
    dt = cam.inverse.dtype

    pxs = jnp.repeat(px, S)
    pys = jnp.repeat(py, S)
    sample_ids = sample0 + jnp.tile(jnp.arange(S, dtype=jnp.int32), P)

    kj = jax.random.fold_in(key, 1)
    jx, jy = jax.random.uniform(kj, (2, P * S), dtype=jnp.float32).astype(dt)
    origin, direction = rays_for_pixels(
        cam, pxs, pys, jx, jy, sample_ids, cfg.samples
    )
    acc = render_rays(scn, meta, cfg, origin, direction,
                      jax.random.fold_in(key, 2))
    return Vec3(
        acc.x.reshape(P, S).sum(axis=1),
        acc.y.reshape(P, S).sum(axis=1),
        acc.z.reshape(P, S).sum(axis=1),
    )


@functools.partial(jax.jit, static_argnums=(1, 2, 6))
def _render_tile_jit(scn, meta, cfg, cam, px, py, n_chunks, key):
    S = cfg.samples_per_pass

    def chunk(c, acc):
        k = jax.random.fold_in(key, c)
        s0 = (c * S).astype(jnp.int32)
        return acc + render_pass(scn, meta, cfg, cam, px, py, s0, S, k)

    init = Vec3.zeros((px.shape[0],), cam.inverse.dtype)
    return jax.lax.fori_loop(0, n_chunks, chunk, init)


def render(scn: SceneArrays, meta: SceneMeta, camera: Camera,
           cfg: RenderConfig, key: Optional[jnp.ndarray] = None) -> np.ndarray:
    """Full-image render on the local device. Returns [H, W, 3] float32.

    Equivalent of the reference's ocl.Trace host loop (ocltracer.go:100-223)
    but with sample-chunk batching inside jit instead of 4-row watchdog
    batches.
    """
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    W, H = camera.width, camera.height
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    cam = camera.pack(dtype)

    spp_chunk = min(cfg.samples_per_pass, cfg.samples)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    # ceil like the driver (driver.py): flooring would both under-render
    # and mis-normalize a non-divisible sample budget (samples=10 with
    # chunk 8 used to render 8 samples yet divide by 10)
    n_chunks = max(1, (cfg.samples + spp_chunk - 1) // spp_chunk)
    total_spp = n_chunks * spp_chunk

    rows = cfg.rows_per_pass or H
    out = np.zeros((H, W, 3), dtype=np.float32)
    for y0 in range(0, H, rows):
        y1 = min(y0 + rows, H)
        ys, xs = np.mgrid[y0:y1, 0:W]
        px = jnp.asarray(xs.ravel(), jnp.int32)
        py = jnp.asarray(ys.ravel(), jnp.int32)
        tile = _render_tile_jit(scn, meta, cfg, cam, px, py, n_chunks,
                                jax.random.fold_in(key, y0))
        stacked = np.stack(
            [np.asarray(tile.x), np.asarray(tile.y), np.asarray(tile.z)],
            axis=-1,
        ).astype(np.float32)
        out[y0:y1] = stacked.reshape(y1 - y0, W, 3)

    return out / float(total_spp)
