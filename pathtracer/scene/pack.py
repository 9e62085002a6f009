"""Flatten the host scene graph into a static struct-of-arrays device scene.

Equivalent of the reference's host->device marshaling
(internal/ocl/scene.go BuildSceneBufferCL/BuildCLGroup and the fixed-layout
CLObject/CLTriangle/CLGroup structs, internal/ocl/ocltracer.go:25-96).
Instead of 1024-byte packed structs we emit padded struct-of-arrays jnp
buffers with fully static shapes, replicated on every chip.
"""
from __future__ import annotations

import dataclasses
import os
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import jax.numpy as jnp

from .bvh import (FlatBVH, build_bvh, build_bvh_arrays, empty_bvh,
                  octant_node_orders)
from .shapes import BOX, PLANE, SPHERE, Cylinder, Group, Shape, Triangle

NONE_TYPE = -1


class SceneArrays(NamedTuple):
    """Device-side scene. All arrays have static (padded) shapes.

    Per-element attribute arrays keep the ELEMENT axis first; per-ray
    code gathers them column-wise from small 2D tables (render/vec3.py
    keeps ray batches as one array per component).

    Objects (reference CLObject fields, ocltracer.go:25-51):
    """
    obj_type: jnp.ndarray          # [No] i32: 0 plane,1 sphere,2 cyl,3 box,4 group,-1 pad
    inverse: jnp.ndarray           # [No,4,4] (used with STATIC object index -> scalars)
    inverse_transpose: jnp.ndarray # [No,4,4]
    transform: jnp.ndarray         # [No,4,4]
    inv_affine: jnp.ndarray        # [No,12] row-major 3x4 of inverse (per-ray gather)
    inv_t_affine: jnp.ndarray      # [No,12] row-major 3x4 of inverse-transpose
    color: jnp.ndarray             # [No,3] (tiny table; column gathers)
    emission: jnp.ndarray          # [No,3]
    refractive_index: jnp.ndarray  # [No]
    reflectivity: jnp.ndarray      # [No]
    min_y: jnp.ndarray             # [No]
    max_y: jnp.ndarray             # [No]
    bb_min: jnp.ndarray            # [No,3] (group-local bounds)
    bb_max: jnp.ndarray            # [No,3]
    bvh_root: jnp.ndarray          # [No] i32 (-1 if not a group)
    bvh_end: jnp.ndarray           # [No] i32
    is_textured: jnp.ndarray       # [No] i32
    texture_index: jnp.ndarray     # [No] i32
    texture_scale: jnp.ndarray     # [No,2]
    is_textured_nm: jnp.ndarray    # [No] i32
    texture_index_nm: jnp.ndarray  # [No] i32
    texture_scale_nm: jnp.ndarray  # [No,2]

    # BVH node pool (reference CLGroup, ocltracer.go:53-64 -> skip links)
    node_bb_min: jnp.ndarray       # [Nn,3] (column gathers)
    node_bb_max: jnp.ndarray       # [Nn,3]
    node_tri_start: jnp.ndarray    # [Nn] i32
    node_is_leaf: jnp.ndarray      # [Nn] i32
    node_exit: jnp.ndarray         # [Nn] i32

    # Triangle pool (reference CLTriangle, ocltracer.go:66-77)
    tri_p1: jnp.ndarray            # [Nt,3] (column gathers)
    tri_e1: jnp.ndarray
    tri_e2: jnp.ndarray
    tri_n1: jnp.ndarray
    tri_n2: jnp.ndarray
    tri_n3: jnp.ndarray
    tri_color: jnp.ndarray         # [Nt,3]

    # Texture atlases, CHANNEL-LEADING [3, n, H, W] so (H, W) take the
    # physical tiles (reference image2d_array_t x3, ocltracer.go:228-254)
    tex_planar: jnp.ndarray
    tex_sphere: jnp.ndarray
    tex_cube: jnp.ndarray
    # Flat u32 texel pool: every texture of every kind concatenated at
    # NATIVE resolution, with per-object (base, w, h) so the integrator
    # does ONE unified 4-tap fetch per bounce instead of one fetch per
    # sampler kind (texel gathers are ~97% of textured-scene time; see
    # integrator.py). base/w/h ride the one-hot attribute fetch
    # as f32 columns — pack_scene asserts the pool stays < 2^24 texels so
    # the bases are f32-exact.
    tex_pool_u32: jnp.ndarray      # [sum(H*W)] u32
    # Quad variant of the pool: row i holds the 4 bilinear taps anchored
    # at texel i — [c00, c01, c10, c11] with that texture's REPEAT wrap
    # baked in — so the sampler can fetch a whole bilinear footprint with
    # ONE row gather instead of four 1-D takes (PT_TEX_FETCH=quad)
    tex_pool_quad_u32: jnp.ndarray  # [sum(H*W), 4] u32
    tex_base: jnp.ndarray          # [No] f32-exact texel offset (color)
    tex_w: jnp.ndarray             # [No]
    tex_h: jnp.ndarray             # [No]
    tex_nm_base: jnp.ndarray       # [No] (normal map; planes only)
    tex_nm_w: jnp.ndarray          # [No]
    tex_nm_h: jnp.ndarray          # [No]


@dataclasses.dataclass(frozen=True)
class SceneMeta:
    """Static (hashable) scene structure; closed over at jit-trace time."""
    n_objects: int                 # real objects (<= padded size)
    max_objects: int
    # static per-object type codes; the intersector unrolls over these so
    # each object compiles to exactly its own primitive test
    obj_types: Tuple[int, ...]
    group_indices: Tuple[int, ...] # which object slots are BVH groups
    # static (obj_slot, bvh_root, bvh_end) per group; jit closes over these
    group_bvh: Tuple[Tuple[int, int, int], ...]
    n_nodes: int
    n_tri_slots: int
    leaf_size: int
    # static texture usage: obj type codes (PLANE/SPHERE/BOX) that actually
    # have textured materials, and whether any plane has a normal map.
    # The integrator elides ALL texture sampling code for types not listed
    # (a zero-cost jit specialization the reference's runtime branching,
    # tracer.cl:1077-1093, cannot do).
    textured_types: Tuple[int, ...] = ()
    has_normal_maps: bool = False
    # object slots that are emissive at pack time (emission.x > 0, the
    # reference's light test, tracer.cl:788) — drives the static NEE unroll
    light_indices: Tuple[int, ...] = ()
    # node arrays hold 9 copies (original + 8 octant front-to-back DFS
    # orders, bvh.octant_node_orders); the megakernel walks the copy of
    # each ray's direction octant
    octant_orders: bool = False
    # when every real triangle in the pool shares one color (common for
    # single-material OBJ models), the megakernel statically elides the
    # per-triangle color fetch and broadcasts this constant instead
    # (render/pallas_kernel._tri_payload); None = per-tri colors
    tri_uniform_color: "Tuple[float, float, float] | None" = None
    # static per-object texture programs for the megakernel: one entry
    # per object that actually SAMPLES a texture (is_textured and type
    # in plane/sphere/box): (slot, proc_desc, w, h, sx, sy). proc_desc
    # is the render/proctex descriptor when the image is procedural, or
    # None for file-backed images — then the megakernel cannot compute
    # texels and the scene stays on the wavefront gather path
    # (pallas_kernel.supports_scene). obj_tex_nm likewise for plane
    # normal maps (tracer.cl:907-911 semantics).
    obj_tex: Tuple = ()
    obj_tex_nm: Tuple = ()

    @property
    def has_groups(self) -> bool:
        return len(self.group_indices) > 0


@dataclasses.dataclass
class Scene:
    """Host scene container (reference: internal/app/scenes/scene.go:16-28)."""
    camera: "object"
    objects: List[Shape]
    textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    sphere_textures: List[np.ndarray] = dataclasses.field(default_factory=list)
    cube_textures: List[np.ndarray] = dataclasses.field(default_factory=list)

    def pack(self, **kw) -> Tuple["SceneArrays", "SceneMeta"]:
        """Flatten to device arrays, threading the three texture atlases
        through (reference prepareTextures x3, ocltracer.go:178-183)."""
        return pack_scene(
            self.objects,
            textures=self.textures,
            sphere_textures=self.sphere_textures,
            cube_textures=self.cube_textures,
            **kw,
        )


def _pack_texture_atlas(images: Sequence[np.ndarray], dtype) -> np.ndarray:
    """Stack images into channel-leading [3, n, H, W], padding to the max
    H/W by nearest resize (the reference requires same-size layers in
    image2d_array_t)."""
    if not images:
        return np.ones((3, 1, 1, 1), dtype=dtype)
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    out = np.zeros((3, len(images), h, w), dtype=dtype)
    for i, im in enumerate(images):
        if im.shape[0] != h or im.shape[1] != w:
            # nearest-neighbor resize to the common size
            yi = (np.arange(h) * im.shape[0] // h).clip(0, im.shape[0] - 1)
            xi = (np.arange(w) * im.shape[1] // w).clip(0, im.shape[1] - 1)
            im = im[yi][:, xi]
        out[:, i] = np.moveaxis(im[..., :3], -1, 0)
    return out


def _build_texel_pool(kind_images):
    """Concatenate every texture of every kind into ONE flat rgb8-u32
    pool at native resolution. Returns (pool [T] u32, {kind: [(base, w,
    h), ...]}). Unlike the per-kind atlases (which must pad layers to a
    common size, image2d_array_t-style), the flat pool needs no padding —
    and it lets the integrator fetch any texture of any kind with a
    single 4-tap bilinear gather."""
    # the quad pool is 4x the texel pool in host+device memory and is
    # only read under PT_TEX_FETCH=quad (integrator._quad_pool), so only
    # build it when that fetch strategy is selected; the integrator falls
    # back to take4 if a scene packed without it is traced with quad set
    want_quad = os.environ.get("PT_TEX_FETCH", "take4") == "quad"
    chunks = []
    quads = []
    tables = {}
    off = 0
    for kind, images in kind_images.items():
        entries = []
        for im in images:
            h, w = im.shape[0], im.shape[1]
            q = np.clip(np.round(im[..., :3] * 255.0), 0,
                        255).astype(np.uint32)
            packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            chunks.append(packed.reshape(-1))
            if want_quad:
                # quad rows: bilinear footprint [c00, c01, c10, c11] with
                # this texture's REPEAT wrap baked in (see SceneArrays)
                c01 = np.roll(packed, -1, axis=1)
                c10 = np.roll(packed, -1, axis=0)
                c11 = np.roll(c10, -1, axis=1)
                quads.append(np.stack([packed, c01, c10, c11],
                                      axis=-1).reshape(-1, 4))
            entries.append((off, w, h))
            off += h * w
        tables[kind] = entries
    pool = np.concatenate(chunks) if chunks else np.zeros(1, np.uint32)
    pool_quad = (np.concatenate(quads)
                 if quads else np.zeros((1, 4), np.uint32))
    assert pool.size < 2 ** 24, (
        f"texel pool has {pool.size} texels; f32-exact base offsets cap "
        "at 2^24 — switch tex_base to an i32 side-table to grow further")
    return pool, pool_quad, tables


def pack_scene(
    objects: Sequence[Shape],
    leaf_size: Optional[int] = None,
    max_objects: Optional[int] = None,
    dtype=jnp.float32,
    textures: Sequence[np.ndarray] = (),
    sphere_textures: Sequence[np.ndarray] = (),
    cube_textures: Sequence[np.ndarray] = (),
) -> Tuple[SceneArrays, SceneMeta]:
    n = len(objects)
    no = max_objects or max(16, n)
    assert n <= no, f"{n} objects > padded capacity {no}"

    if leaf_size is None and os.environ.get("PT_BVH_LEAF"):
        # explicit override for leaf-size A/Bs (bench.py/CLI runs pick
        # it up without a code edit)
        leaf_size = int(os.environ["PT_BVH_LEAF"])
    if leaf_size is None:
        # 8 slots per leaf: the megakernel's packet walk on an H100 ran
        # teapot and gopher ~2x faster at 8 than at the former 32 / 16
        # (PERF.md)
        leaf_size = 8

    np_dtype = np.float64  # build in f64, cast at the end

    obj_type = np.full(no, NONE_TYPE, dtype=np.int32)
    inverse = np.tile(np.eye(4), (no, 1, 1))
    inverse_t = np.tile(np.eye(4), (no, 1, 1))
    transform = np.tile(np.eye(4), (no, 1, 1))
    color = np.zeros((no, 3), dtype=np_dtype)
    emission = np.zeros((no, 3), dtype=np_dtype)
    refr_idx = np.ones(no, dtype=np_dtype)
    refl = np.zeros(no, dtype=np_dtype)
    min_y = np.zeros(no, dtype=np_dtype)
    max_y = np.zeros(no, dtype=np_dtype)
    bb_min = np.zeros((no, 3), dtype=np_dtype)
    bb_max = np.zeros((no, 3), dtype=np_dtype)
    bvh_root = np.full(no, -1, dtype=np.int32)
    bvh_end = np.full(no, -1, dtype=np.int32)
    is_tex = np.zeros(no, dtype=np.int32)
    tex_idx = np.zeros(no, dtype=np.int32)
    tex_scale = np.ones((no, 2), dtype=np_dtype)
    is_tex_nm = np.zeros(no, dtype=np.int32)
    tex_idx_nm = np.zeros(no, dtype=np.int32)
    tex_scale_nm = np.ones((no, 2), dtype=np_dtype)

    pool: FlatBVH = empty_bvh(leaf_size)
    group_indices: List[int] = []
    group_bvh: List[Tuple[int, int, int]] = []

    for i, s in enumerate(objects):
        m = s.material
        obj_type[i] = s.type_code
        inverse[i] = s.inverse
        inverse_t[i] = s.inverse_transpose
        transform[i] = s.transform
        color[i] = np.asarray(m.color)[:3]
        emission[i] = np.asarray(m.emission)[:3]
        refr_idx[i] = m.refractive_index
        refl[i] = m.reflectivity
        if m.textured:
            is_tex[i] = 1
            tex_idx[i] = m.texture_id
            tex_scale[i] = (m.texture_scale_x, m.texture_scale_y)
        if m.textured_nm:
            is_tex_nm[i] = 1
            tex_idx_nm[i] = m.texture_id_nm
            tex_scale_nm[i] = (m.texture_scale_x_nm, m.texture_scale_y_nm)

        if isinstance(s, Cylinder):
            min_y[i] = s.min_y
            max_y[i] = s.max_y
        elif isinstance(s, Group):
            soup = s.soup
            if soup is None and not s.all_triangles():
                # group with no triangles contributes nothing (matches the
                # reference: childCount==0 groups are skipped, tracer.cl:617)
                obj_type[i] = NONE_TYPE
                continue
            s.bounds()
            bb_min[i] = s.bounding_box.min[:3]
            bb_max[i] = s.bounding_box.max[:3]
            if soup is not None:
                # native triangle-soup fast path (no Python objects)
                pool, root, end = build_bvh_arrays(
                    soup.p1, soup.p2, soup.p3, soup.n1, soup.n2, soup.n3,
                    soup.color, leaf_size=leaf_size, into=pool,
                )
            else:
                pool, root, end = build_bvh(
                    s.all_triangles(), leaf_size=leaf_size, into=pool)
            bvh_root[i] = root
            bvh_end[i] = end
            group_indices.append(i)
            group_bvh.append((i, root, end))

    # pad pools to at least one element so gathers are well-defined
    if pool.n_nodes == 0:
        pool, _, _ = build_bvh(
            [Triangle(np.zeros(4), np.zeros(4), np.zeros(4))], leaf_size=leaf_size,
            into=pool,
        )
        dummy = True
    else:
        dummy = False

    # octant-ordered node copies for the megakernel's front-to-back
    # walk (PT_OCTANT=0 disables; copy 0 stays the original order, so
    # the wavefront per-ray walk is bit-unchanged)
    n_pool_nodes = pool.n_nodes
    octant = (not dummy and group_bvh
              and os.environ.get("PT_OCTANT", "1") != "0")
    if octant:
        pool = octant_node_orders(
            pool, [(r, e) for (_, r, e) in group_bvh])

    # convert dtypes in numpy BEFORE jnp.asarray: a jnp-side cast traces
    # + compiles a convert_element_type program per unique shape (~3s of
    # pure overhead for a mesh scene); a matching-dtype numpy array is a
    # straight device_put
    f = lambda a: jnp.asarray(np.asarray(a, dtype=np.dtype(dtype)))
    i32 = lambda a: jnp.asarray(np.asarray(a, dtype=np.int32))

    # flat texel pool + per-object (base, w, h): the object's primitive
    # type selects its sampler kind (plane->planar, sphere->spherical,
    # box->cube-cross; tracer.cl:1077-1093); normal maps are planar-only
    # (tracer.cl:907-911)
    tex_pool, tex_pool_quad, pool_tables = _build_texel_pool({
        "planar": list(textures),
        "sphere": list(sphere_textures),
        "cube": list(cube_textures),
    })
    _kind_of_type = {PLANE: "planar", SPHERE: "sphere", BOX: "cube"}
    pool_base = np.zeros(no, dtype=np_dtype)
    pool_w = np.ones(no, dtype=np_dtype)
    pool_h = np.ones(no, dtype=np_dtype)
    pool_nm_base = np.zeros(no, dtype=np_dtype)
    pool_nm_w = np.ones(no, dtype=np_dtype)
    pool_nm_h = np.ones(no, dtype=np_dtype)
    kind_image_lists = {"planar": list(textures),
                        "sphere": list(sphere_textures),
                        "cube": list(cube_textures)}
    obj_tex: List[Tuple] = []
    obj_tex_nm: List[Tuple] = []
    for i in range(n):
        kind = _kind_of_type.get(int(obj_type[i]))
        entries = pool_tables.get(kind, [])
        if is_tex[i] and tex_idx[i] < len(entries):
            pool_base[i], pool_w[i], pool_h[i] = entries[tex_idx[i]]
        if is_tex_nm[i] and tex_idx_nm[i] < len(pool_tables["planar"]):
            (pool_nm_base[i], pool_nm_w[i],
             pool_nm_h[i]) = pool_tables["planar"][tex_idx_nm[i]]
        # static texture-program records for the megakernel (see SceneMeta)
        if is_tex[i] and kind is not None:
            ims = kind_image_lists[kind]
            im = ims[tex_idx[i]] if tex_idx[i] < len(ims) else None
            desc = getattr(im, "proc", None) if im is not None else None
            obj_tex.append((
                i, desc,
                int(im.shape[1]) if im is not None else 1,
                int(im.shape[0]) if im is not None else 1,
                float(tex_scale[i][0]), float(tex_scale[i][1]),
            ))
        if is_tex_nm[i] and int(obj_type[i]) == PLANE:
            ims = kind_image_lists["planar"]
            im = ims[tex_idx_nm[i]] if tex_idx_nm[i] < len(ims) else None
            desc = getattr(im, "proc", None) if im is not None else None
            obj_tex_nm.append((
                i, desc,
                int(im.shape[1]) if im is not None else 1,
                int(im.shape[0]) if im is not None else 1,
                float(tex_scale_nm[i][0]), float(tex_scale_nm[i][1]),
            ))

    arrays = SceneArrays(
        obj_type=i32(obj_type),
        inverse=f(inverse),
        inverse_transpose=f(inverse_t),
        transform=f(transform),
        inv_affine=f(inverse[:, :3, :].reshape(no, 12)),
        inv_t_affine=f(inverse_t[:, :3, :].reshape(no, 12)),
        color=f(color),
        emission=f(emission),
        refractive_index=f(refr_idx),
        reflectivity=f(refl),
        min_y=f(min_y),
        max_y=f(max_y),
        bb_min=f(bb_min),
        bb_max=f(bb_max),
        bvh_root=i32(bvh_root),
        bvh_end=i32(bvh_end),
        is_textured=i32(is_tex),
        texture_index=i32(tex_idx),
        texture_scale=f(tex_scale),
        is_textured_nm=i32(is_tex_nm),
        texture_index_nm=i32(tex_idx_nm),
        texture_scale_nm=f(tex_scale_nm),
        node_bb_min=f(pool.node_bb_min),
        node_bb_max=f(pool.node_bb_max),
        node_tri_start=i32(pool.node_tri_start),
        node_is_leaf=i32(pool.node_is_leaf),
        node_exit=i32(pool.node_exit),
        tri_p1=f(pool.tri_p1),
        tri_e1=f(pool.tri_e1),
        tri_e2=f(pool.tri_e2),
        tri_n1=f(pool.tri_n1),
        tri_n2=f(pool.tri_n2),
        tri_n3=f(pool.tri_n3),
        tri_color=f(pool.tri_color),
        tex_planar=f(_pack_texture_atlas(textures, np.float32)),
        tex_sphere=f(_pack_texture_atlas(sphere_textures,
                                         np.float32)),
        tex_cube=f(_pack_texture_atlas(cube_textures, np.float32)),
        tex_pool_u32=jnp.asarray(tex_pool),
        tex_pool_quad_u32=jnp.asarray(tex_pool_quad),
        tex_base=f(pool_base),
        tex_w=f(pool_w),
        tex_h=f(pool_h),
        tex_nm_base=f(pool_nm_base),
        tex_nm_w=f(pool_nm_w),
        tex_nm_h=f(pool_nm_h),
    )
    textured_types = sorted(
        {int(obj_type[i]) for i, s in enumerate(objects)
         if s.material.textured and obj_type[i] != NONE_TYPE}
    )
    has_nm = any(s.material.textured_nm for s in objects)
    lights = tuple(
        i for i, s in enumerate(objects)
        if s.material.emission[0] > 0.0 and obj_type[i] != NONE_TYPE
    )
    # static uniform-triangle-color detection: real (non-padding) slots
    # have a nonzero geometric normal; padding slots never hit, so only
    # real slots constrain uniformity
    uni_color = None
    if not dummy and pool.n_tri_slots:
        _ng = np.cross(np.asarray(pool.tri_e1), np.asarray(pool.tri_e2))
        _real = (_ng * _ng).sum(axis=1) > 0.0
        _cols = np.asarray(pool.tri_color, dtype=np.float32)[_real]
        if len(_cols) and bool(np.all(_cols == _cols[0])):
            uni_color = tuple(float(c) for c in _cols[0])
    meta = SceneMeta(
        n_objects=n,
        max_objects=no,
        obj_types=tuple(int(t) for t in obj_type[:n]),
        group_indices=tuple(group_indices),
        group_bvh=tuple(group_bvh),
        n_nodes=int(n_pool_nodes) if not dummy else 0,
        octant_orders=bool(octant),
        n_tri_slots=int(pool.n_tri_slots),
        leaf_size=leaf_size,
        textured_types=tuple(textured_types),
        has_normal_maps=has_nm,
        light_indices=lights,
        tri_uniform_color=uni_color,
        obj_tex=tuple(obj_tex),
        obj_tex_nm=tuple(obj_tex_nm),
    )
    return arrays, meta
