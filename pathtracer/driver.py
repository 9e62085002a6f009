"""Render driver: chunked rendering with progress logging, throughput
metrics, checkpoint/resume, failure recovery, and optional profiler traces.

Equivalent of the reference's render driver (internal/app/tracer/
pathtracer.go:19-39, renderer.go:40-75) plus the auxiliary subsystems the
reference lacks (SURVEY.md §5): the reference's only resiliency mechanism is
4-row batching against GPU watchdogs (ocltracer.go:212-223), every error
path is Fatalf, and it cannot resume a render. Here every sample-chunk
segment is checkpointable, a render resumes exactly (the RNG is
counter-based, keyed by global chunk index, so the restarted stream is
identical), and partial sums flush to host periodically, so a failed
segment costs only the chunks since the last flush: the driver re-renders
them in-process (PT_FAULT_INJECT=<chunk> injects such a failure), and a
process that dies resumes from its checkpoint with --resume.
"""
from __future__ import annotations

import dataclasses
import json
import logging
import os
import time
from typing import Optional

import numpy as np

from .config import RenderConfig
from .render.camera import Camera
from .scene.pack import SceneArrays, SceneMeta

log = logging.getLogger("pathtracer")


class DeviceFailure(RuntimeError):
    """Synthetic segment failure raised by PT_FAULT_INJECT (exercises the
    in-process recovery path). Real CUDA errors are not retried: they
    leave the device context unusable, so they propagate and the render
    resumes from its checkpoint in a new process."""


@dataclasses.dataclass
class RenderStats:
    """Throughput metrics (the reference only logs wall time per batch,
    ocltracer.go:222; we also report samples/sec and structured JSON)."""
    wall_s: float = 0.0
    samples: int = 0
    backend: str = ""
    segments: int = 0
    recoveries: int = 0

    @property
    def msamples_per_sec(self) -> float:
        return self.samples / self.wall_s / 1e6 if self.wall_s else 0.0

    def to_json(self, **extra) -> str:
        return json.dumps({
            "wall_s": round(self.wall_s, 3),
            "samples": self.samples,
            "msamples_per_sec": round(self.msamples_per_sec, 3),
            "backend": self.backend,
            "segments": self.segments,
            "recoveries": self.recoveries,
            **extra,
        })


def _checkpoint_save(path: str, accum: np.ndarray, chunks_done: int,
                     cfg: RenderConfig, backend: str,
                     checkpoint_every: int, layout: str) -> None:
    tmp = path + ".tmp.npz"
    np.savez(tmp,
             accum=accum, chunks_done=chunks_done,
             meta=json.dumps({
                 "width": cfg.width, "height": cfg.height,
                 "samples": cfg.samples,
                 "samples_per_pass": cfg.samples_per_pass,
                 "seed": cfg.seed,
                 # the backend (and mesh shape) fix the RNG streams and
                 # the flush interval the f64 summation order, so a
                 # resume must match them for bit-exact continuation
                 "backend": backend,
                 "checkpoint_every": checkpoint_every,
                 # the accum's slot->pixel mapping: two layouts can have
                 # the SAME slot count, so resuming across layouts would
                 # silently pixel-permute the image — reject on mismatch
                 "layout": layout,
             }))
    os.replace(tmp, path)


def _checkpoint_load(path: str, cfg: RenderConfig, backend: str,
                     checkpoint_every: int, layout: str):
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(str(z["meta"]))
        want = {
            "width": cfg.width, "height": cfg.height,
            "samples": cfg.samples,
            "samples_per_pass": cfg.samples_per_pass,
            "seed": cfg.seed,
            "backend": backend,
            "checkpoint_every": checkpoint_every,
            "layout": layout,
        }
        for k, v in want.items():
            if meta.get(k, v) != v:
                raise ValueError(
                    f"checkpoint {path} was written for {k}={meta[k]}, "
                    f"current config has {v}"
                )
        return z["accum"].copy(), int(z["chunks_done"])


def render_driver(
    scn: SceneArrays,
    meta: SceneMeta,
    camera: Camera,
    cfg: RenderConfig,
    checkpoint_path: Optional[str] = None,
    checkpoint_every: int = 0,       # in sample chunks; 0 = only at end
    resume: bool = False,
    profile_dir: Optional[str] = None,
    mesh=None,
) -> tuple[np.ndarray, RenderStats]:
    """Render the full image, returning ([H, W, 3] float32, stats).

    The sample budget runs in chunks of cfg.samples_per_pass; the
    accumulated (unnormalized) radiance sum is checkpointed every
    `checkpoint_every` chunks. Resume picks up at the recorded chunk with a
    bit-identical RNG stream.
    """
    import jax
    import jax.numpy as jnp

    from .render import pallas_kernel as pk
    from .render.integrator import render_pass
    from .render.vec3 import Vec3

    W, H = camera.width, camera.height
    dtype = jnp.float64 if cfg.dtype == "float64" else jnp.float32
    cam = camera.pack(dtype)
    key = jax.random.PRNGKey(cfg.seed)

    spp_chunk = min(cfg.samples_per_pass, cfg.samples)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, (cfg.samples + spp_chunk - 1) // spp_chunk)

    platform = jax.devices()[0].platform
    if cfg.backend == "pallas":
        if platform != "gpu":
            # the megakernel is compiled for the GPU only; interpret mode
            # is for tests, never a silent fallback
            raise ValueError(
                f"--backend pallas needs a GPU (found {platform}); use "
                "--backend auto or wavefront")
        if not pk.supports_scene(meta):
            raise ValueError(
                "--backend pallas: scene samples file-backed textures, "
                "which only the wavefront path renders; use --backend "
                "auto or wavefront")
    use_pallas = (
        cfg.backend == "pallas"
        or (cfg.backend == "auto"
            and cfg.dtype == "float32"
            and platform == "gpu"
            and cfg.debug_ray < 0     # the per-ray probe is wavefront-only
            and pk.supports_scene(meta))
    )
    backend_name = "pallas" if use_pallas else "wavefront"
    # slot->pixel layout identity for checkpoint validation: every path
    # hands the driver scanline-ordered sums (padded for the mesh)
    layout_tag = "linear"
    spp_axis = 1
    finalize = None
    padded_pixels = H * W
    if mesh is not None:
        # distributed render: same driver loop (segments, checkpoints,
        # recovery, metrics), per-segment compute shard_mapped over the
        # mesh. The chunk schedule is rounded to the 'spp' axis so every
        # device renders an equal share of each segment.
        spp_axis = mesh.shape["spp"]
        n_chunks = ((n_chunks + spp_axis - 1) // spp_axis) * spp_axis
        # the mesh shape is part of the RNG stream layout -> must match
        # on resume (enforced via the checkpoint's backend tag)
        backend_name += "@%dx%d" % (mesh.shape["pixels"], spp_axis)
    log.info("backend: %s", backend_name)

    if mesh is not None:
        from .parallel.render_dist import make_driver_segments

        segment, finalize, padded_pixels = make_driver_segments(
            scn, meta, camera, cfg, mesh, use_pallas, key)

    @jax.jit
    def segment_wavefront(c0: jnp.ndarray, n: jnp.ndarray, k, bpx, bpy
                          ) -> Vec3:
        """Sum of render passes for global chunks [c0, c0+n)."""
        def body(i, acc):
            c = c0 + i
            kc = jax.random.fold_in(k, c)
            s0 = (c * spp_chunk).astype(jnp.int32)
            return acc + render_pass(scn, meta, cfg, cam, bpx, bpy, s0,
                                     spp_chunk, kc)
        init = Vec3.zeros((bpx.shape[0],), dtype)
        return jax.lax.while_loop(
            lambda s: s[0] < n,
            lambda s: (s[0] + 1, body(s[0], s[1])),
            (jnp.int32(0), init),
        )[1]

    if mesh is not None:
        pass  # sharded segment built above
    elif use_pallas:
        pix = jnp.asarray(pk.pixel_slots(W, H, pk.DEFAULT_BLOCK))
        cam_vec = jnp.asarray(pk.build_camera_vec(camera))
        obj_table, nodes, tris = pk.scene_tables(scn, meta)

        def segment(c0: int, n: int, k) -> Vec3:
            # the kernel keys its RNG on the global sample index, so the
            # segment only passes its first sample (also the sunflower
            # DoF base)
            seed = jnp.asarray([cfg.seed, int(c0) * spp_chunk], jnp.int32)
            r, g, b = pk.trace_tiles(
                seed, cam_vec, obj_table, nodes, tris, pix,
                meta=meta, cfg=cfg, spp=int(n) * spp_chunk,
                total_samples=cfg.samples)
            return Vec3(r[:H * W], g[:H * W], b[:H * W])
    else:
        block = cfg.rows_per_pass or H
        pad_rows = (-H) % block
        ys2, xs2 = np.mgrid[0:H + pad_rows, 0:W]
        ys2 = np.minimum(ys2, H - 1)
        pxb = jnp.asarray(xs2.ravel(), jnp.int32).reshape(-1, block * W)
        pyb = jnp.asarray(ys2.ravel(), jnp.int32).reshape(-1, block * W)
        n_blocks = pxb.shape[0]

        def segment(c0: int, n: int, k) -> Vec3:
            # per-block key fold: reusing one key across pixel blocks would
            # replicate the random stream block-to-block (visible banding)
            outs = [
                segment_wavefront(jnp.int32(c0), jnp.int32(n),
                                  jax.random.fold_in(k, 1000003 + b),
                                  pxb[b], pyb[b])
                for b in range(n_blocks)
            ]
            cat = lambda f: jnp.concatenate([f(o) for o in outs])[:H * W]
            return Vec3(cat(lambda o: o.x), cat(lambda o: o.y),
                        cat(lambda o: o.z))

    accum = np.zeros((padded_pixels, 3), dtype=np.float64)
    start_chunk = 0
    if resume and checkpoint_path and os.path.exists(checkpoint_path):
        accum, start_chunk = _checkpoint_load(
            checkpoint_path, cfg, backend_name, checkpoint_every,
            layout_tag)
        if accum.shape[0] != padded_pixels:
            raise ValueError(
                f"checkpoint {checkpoint_path} has {accum.shape[0]} pixel "
                f"slots, current layout has {padded_pixels}")
        log.info("resumed from %s at chunk %d/%d",
                 checkpoint_path, start_chunk, n_chunks)

    if checkpoint_every > 0:
        seg_len = checkpoint_every
    else:
        # cap per-device-call work (PT_SEG_SPP to tune): one compiled
        # segment gets reused across the render, and the partial sums stay
        # ON DEVICE between segments (device->host only at flushes,
        # checkpoints and the end). Mesh scenes trace far fewer samples
        # per second, so their cap is smaller to keep a segment (the unit
        # of progress logging and of lost work on a failure) short.
        default_spp = "128" if not meta.has_groups else "8"
        seg_spp = int(os.environ.get("PT_SEG_SPP", default_spp))
        seg_len = max(1, min(n_chunks, max(1, seg_spp // spp_chunk)))
    if spp_axis > 1:
        # whole segments distribute evenly over the 'spp' mesh axis
        seg_len = ((seg_len + spp_axis - 1) // spp_axis) * spp_axis
    stats = RenderStats(backend=backend_name)
    t_total = time.perf_counter()

    def to_np(v: "Vec3") -> np.ndarray:
        if mesh is not None and jax.process_count() > 1:
            from .parallel.render_dist import _fetch

            get = _fetch
        else:
            get = np.asarray
        return np.stack(
            [get(v.x), get(v.y), get(v.z)], axis=-1,
        ).astype(np.float64)

    # failure recovery knobs: device partials flush to host at least every
    # PT_FLUSH_S seconds so a failure can only lose that much work; a
    # failed segment re-renders from the last flushed chunk
    flush_s = float(os.environ.get("PT_FLUSH_S", "60"))
    max_retries = int(os.environ.get("PT_MAX_RETRIES", "3"))
    fault_at = int(os.environ.get("PT_FAULT_INJECT", "-1"))
    # how many times the injected fault fires (a persistent outage is
    # PT_FAULT_COUNT > PT_MAX_RETRIES)
    fault_count = int(os.environ.get("PT_FAULT_COUNT", "1"))

    ctx = (jax.profiler.trace(profile_dir) if profile_dir
           else _null_context())
    with ctx:
        c = start_chunk
        host_base = start_chunk  # chunks reflected in the host accum
        dev_acc = None  # device-resident partial sum since last flush
        failures = 0
        t_flush = time.perf_counter()

        def flush(save_ck: bool):
            nonlocal accum, dev_acc, host_base, t_flush
            if dev_acc is not None:
                accum += to_np(dev_acc)
                dev_acc = None
            host_base = c
            t_flush = time.perf_counter()
            if save_ck and checkpoint_path:
                _checkpoint_save(checkpoint_path, accum, c, cfg,
                                 backend_name, checkpoint_every,
                                 layout_tag)

        while c < n_chunks:
            n = min(seg_len, n_chunks - c)
            t0 = time.perf_counter()
            try:
                if c <= fault_at < c + n and fault_count > 0:
                    fault_count -= 1
                    if fault_count == 0:
                        fault_at = -1
                    raise DeviceFailure(
                        f"PT_FAULT_INJECT at chunk {c}")
                out = segment(c, n, key)
                dev_acc = out if dev_acc is None else Vec3(
                    dev_acc.x + out.x, dev_acc.y + out.y,
                    dev_acc.z + out.z)
                # sync each segment: the segment time is logged, and a
                # device error surfaces at this segment
                dev_acc.x.block_until_ready()
            except DeviceFailure as exc:
                if failures >= max_retries:
                    raise
                failures += 1
                stats.recoveries += 1
                log.warning(
                    "segment failure at chunk %d (%s); re-rendering %d "
                    "chunk(s) from %d (retry %d/%d)",
                    c, exc, c + n - host_base, host_base, failures,
                    max_retries)
                # the partial since the last flush is discarded
                dev_acc = None
                c = host_base
                continue
            failures = 0
            dt = time.perf_counter() - t0
            c += n
            seg_samples = W * H * n * spp_chunk
            stats.samples += seg_samples
            stats.segments += 1
            log.info("%d/%d chunks done in %.2fs (%.2f Msamples/s)",
                     c, n_chunks, dt, seg_samples / dt / 1e6)
            if checkpoint_path and checkpoint_every > 0:
                flush(save_ck=True)
            elif time.perf_counter() - t_flush > flush_s:
                flush(save_ck=False)
        flush(save_ck=checkpoint_path is not None)

    stats.wall_s = time.perf_counter() - t_total
    total_spp = n_chunks * spp_chunk
    if finalize is not None:
        accum = finalize(accum)
    img = (accum / float(total_spp)).astype(np.float32).reshape(H, W, 3)
    return img, stats


class _null_context:
    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False
