"""Sharded rendering: pixels x spp over the device mesh.

Replaces the reference's single-device NDRange dispatch
(ocltracer.go:197-223) with shard_map over a Mesh: each device renders its
interleaved pixel shard for its slice of the sample budget, sample partials
are psum-reduced over the 'spp' axis, and XLA's output sharding assembles
the image.

Pixels are sharded INTERLEAVED (stride = #shards) rather than in blocks:
divergent path lengths cluster spatially (mesh pixels trace deeper), and
striding decorrelates the load across devices (SURVEY.md section 7
'Hard parts').
"""
from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import RenderConfig
from ..render.camera import Camera
from ..render.integrator import render_pass
from ..render.vec3 import Vec3
from ..scene.pack import SceneArrays, SceneMeta


def _put_sharded(arr, sharding):
    """Distribute a host array over a (possibly multi-process) mesh.

    Single-process: plain device_put. Multi-process (multi-controller
    jax.distributed): every process holds the SAME full host array, so
    each builds its addressable shards via make_array_from_callback — the
    multihost equivalent of the reference's single EnqueueWriteBuffer
    (ocltracer.go:314-340)."""
    if jax.process_count() == 1:
        return jax.device_put(arr, sharding)
    arr = np.asarray(arr)
    return jax.make_array_from_callback(
        arr.shape, sharding, lambda idx: arr[idx])


def _fetch(x) -> np.ndarray:
    """Materialize a global sharded array on every host (the one
    device->host transfer of the pipeline; DCN carries only this)."""
    if jax.process_count() == 1:
        return np.asarray(x)
    from jax.experimental import multihost_utils

    return np.asarray(multihost_utils.process_allgather(x, tiled=True))


def _shard_body(scn, cam, px, py, key, meta: SceneMeta, cfg: RenderConfig,
                n_chunks: int, spp_axis_size: int):
    """Per-device body: render this device's pixel shard for its slice of
    the sample chunks, then psum over the 'spp' axis."""
    S = cfg.samples_per_pass
    spp_rank = jax.lax.axis_index("spp")
    # decorrelate random streams across pixel shards: without this, the
    # ray at local slot r draws identical uniforms on every shard, which
    # correlates the noise of neighboring (strided) pixels
    key = jax.random.fold_in(key, jax.lax.axis_index("pixels"))

    def chunk(c, acc):
        # global chunk id: this device's slice of the chunk sequence
        gc = c * spp_axis_size + spp_rank
        k = jax.random.fold_in(key, gc)
        s0 = (gc * S).astype(jnp.int32)
        return acc + render_pass(scn, meta, cfg, cam, px, py, s0, S, k)

    local_chunks = n_chunks // spp_axis_size
    acc = jax.lax.fori_loop(
        0, local_chunks, chunk,
        Vec3.zeros((px.shape[0],), cam.inverse.dtype),
    )
    return jax.lax.psum(acc, axis_name="spp")


def render_sharded(
    scn: SceneArrays,
    meta: SceneMeta,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    key: Optional[jax.Array] = None,
) -> np.ndarray:
    """Full-image render over the mesh. Returns [H, W, 3] float32."""
    if key is None:
        key = jax.random.PRNGKey(cfg.seed)
    W, H = camera.width, camera.height
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    cam = camera.pack(dtype)

    n_pix_shards = mesh.shape["pixels"]
    spp_axis = mesh.shape["spp"]

    spp_chunk = min(cfg.samples_per_pass, max(1, cfg.samples // spp_axis))
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, cfg.samples // spp_chunk)
    # make the chunk count divisible over the spp axis
    n_chunks = ((n_chunks + spp_axis - 1) // spp_axis) * spp_axis
    total_samples = n_chunks * spp_chunk

    # interleaved pixel sharding: pixel i -> shard i % n_shards
    P_total = W * H
    pad = (-P_total) % (n_pix_shards * 8)
    ids = np.arange(P_total + pad)
    xs = ids % W
    ys = np.minimum(ids // W, H - 1)
    # stride-interleave: reorder so equal slices are strided sets
    perm = ids.reshape(-1, n_pix_shards).T.reshape(-1)

    shard = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    px = _put_sharded(np.asarray(xs[perm], np.int32), shard)
    py = _put_sharded(np.asarray(ys[perm], np.int32), shard)
    if jax.process_count() > 1:
        # commit replicated operands to the global mesh explicitly;
        # host-local arrays cannot feed a multi-controller computation
        scn = jax.tree_util.tree_map(
            lambda a: _put_sharded(a, rep), scn)
        cam = jax.tree_util.tree_map(
            lambda a: _put_sharded(a, rep), cam)
        key = _put_sharded(np.asarray(key), rep)

    body = functools.partial(
        _shard_body, meta=meta, cfg=cfg, n_chunks=n_chunks,
        spp_axis_size=spp_axis,
    )
    fn = jax.jit(
        jax.shard_map(
            body,
            mesh=mesh,
            in_specs=(P(), P(), P("pixels"), P("pixels"), P()),
            out_specs=P("pixels"),
            # the bounce-loop carries start as unvarying constants and
            # become device-varying after the first bounce; the static VMA
            # check rejects that, so it is disabled (collectives here are
            # just the final spp-psum)
            check_vma=False,
        )
    )
    acc = fn(scn, cam, px, py, key)

    flat = np.stack(
        [_fetch(acc.x), _fetch(acc.y), _fetch(acc.z)], axis=-1
    ).astype(np.float32) / float(total_samples)
    # undo interleave, drop padding
    out = np.empty((P_total + pad, 3), dtype=np.float32)
    out[perm] = flat
    return out[:P_total].reshape(H, W, 3)


def make_driver_segments(
    scn: SceneArrays,
    meta: SceneMeta,
    camera: Camera,
    cfg: RenderConfig,
    mesh: Mesh,
    use_pallas: bool,
    key: jax.Array,
    interpret: bool = False,
):
    """Sharded per-segment render functions for `render_driver(mesh=...)`.

    This is what unifies distribution with the driver (the reference has
    ONE driver entry for everything, internal/app/tracer/pathtracer.go:19):
    the driver keeps its chunk loop, checkpointing, failure recovery and
    metrics, and only the per-segment compute is swapped for a shard_map
    over the mesh — megakernel when the scene supports it, wavefront
    otherwise, sample partials psum-reduced over the 'spp' axis.

    Returns (segment, finalize, padded_pixels):
    - segment(c0, n, k) -> Vec3 of globally sharded per-pixel partial sums
      for global chunks [c0, c0+n); n must be a multiple of the 'spp'
      axis size (the driver rounds its schedule accordingly)
    - finalize(accum [padded_pixels, 3]) -> [H*W, 3] in image order

    `interpret` runs the megakernel on the CPU (tests only).
    """
    W, H = camera.width, camera.height
    spp_axis = mesh.shape["spp"]
    n_shards = mesh.shape["pixels"]
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    shard = NamedSharding(mesh, P("pixels"))
    rep = NamedSharding(mesh, P())
    spp_chunk = cfg.samples_per_pass
    n_pix = W * H

    if use_pallas:
        from ..render import pallas_kernel as pk

        pix_np = pk.pixel_slots(W, H, pk.DEFAULT_BLOCK,
                                shard_granule=n_shards)
        pix = _put_sharded(pix_np, shard)
        tables = (pk.build_camera_vec(camera),) + tuple(
            pk.scene_tables(scn, meta))
        if jax.process_count() > 1:
            tables = tuple(_put_sharded(np.asarray(t), rep) for t in tables)
        else:
            tables = tuple(jnp.asarray(t) for t in tables)

        @functools.lru_cache(maxsize=None)
        def fn_for(n):
            # spp per device for this segment length (static for the
            # kernel's in-kernel sample loop)
            local_spp = (n // spp_axis) * spp_chunk

            def body(cam_vec, obj, nodes, tris, pix_s, c0):
                # this spp shard's slice of the segment's global samples;
                # the kernel keys its RNG on (seed, pixel, global sample),
                # so the sharded image equals the one-device image
                base = (c0 * jnp.int32(spp_chunk)
                        + jax.lax.axis_index("spp") * jnp.int32(local_spp))
                seed = jnp.stack([jnp.int32(cfg.seed), base])
                r, g, b = pk.trace_tiles(
                    seed, cam_vec, obj, nodes, tris, pix_s, meta=meta,
                    cfg=cfg, spp=local_spp, total_samples=cfg.samples,
                    interpret=interpret)
                return (jax.lax.psum(r, "spp"), jax.lax.psum(g, "spp"),
                        jax.lax.psum(b, "spp"))

            return jax.jit(jax.shard_map(
                body, mesh=mesh,
                in_specs=(P(), P(), P(), P(), P("pixels"), P()),
                out_specs=(P("pixels"),) * 3,
                check_vma=False,
            ))

        def segment(c0, n, k):
            assert n % spp_axis == 0, (n, spp_axis)
            r, g, b = fn_for(int(n))(*tables, pix, jnp.int32(c0))
            return Vec3(r, g, b)

        def finalize(acc):
            return acc[:n_pix]

        return segment, finalize, pix_np.shape[0]

    # ---- wavefront over the mesh (all scenes) -------------------------
    pad = (-n_pix) % (n_shards * 8)
    ids = np.arange(n_pix + pad)
    xs = ids % W
    ys = np.minimum(ids // W, H - 1)
    # stride-interleave pixels across shards (decorrelates the load from
    # spatially clustered path lengths; see render_sharded)
    perm = ids.reshape(-1, n_shards).T.reshape(-1)
    px = _put_sharded(np.asarray(xs[perm], np.int32), shard)
    py = _put_sharded(np.asarray(ys[perm], np.int32), shard)
    cam = camera.pack(dtype)
    if jax.process_count() > 1:
        scn = jax.tree_util.tree_map(lambda a: _put_sharded(a, rep), scn)
        cam = jax.tree_util.tree_map(lambda a: _put_sharded(a, rep), cam)
        key = _put_sharded(np.asarray(key), rep)

    from ..render.integrator import render_pass

    def body(scn_, cam_, px_, py_, key_, c0, n):
        spp_rank = jax.lax.axis_index("spp")
        key_ = jax.random.fold_in(key_, jax.lax.axis_index("pixels"))

        def chunk(i, acc):
            gc = c0 + i * spp_axis + spp_rank
            k = jax.random.fold_in(key_, gc)
            s0 = (gc * spp_chunk).astype(jnp.int32)
            return acc + render_pass(scn_, meta, cfg, cam_, px_, py_, s0,
                                     spp_chunk, k)

        acc = jax.lax.fori_loop(
            0, n // spp_axis, chunk,
            Vec3.zeros((px_.shape[0],), cam_.inverse.dtype))
        return jax.lax.psum(acc, axis_name="spp")

    fn = jax.jit(jax.shard_map(
        body, mesh=mesh,
        in_specs=(P(), P(), P("pixels"), P("pixels"), P(), P(), P()),
        out_specs=P("pixels"),
        check_vma=False,
    ))

    def segment(c0, n, k):
        assert n % spp_axis == 0, (n, spp_axis)
        return fn(scn, cam, px, py, key, jnp.int32(c0), jnp.int32(n))

    def finalize(acc):
        out = np.empty((n_pix + pad, acc.shape[-1]), dtype=acc.dtype)
        out[perm] = acc
        return out[:n_pix]

    return segment, finalize, n_pix + pad
