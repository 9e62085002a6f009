"""Benchmark: reference Cornell scene (scenes/reference.go:12) at 1280x960.

Metric: camera samples traced per second (Msamples/s), steady-state
(compile excluded). Baseline of record (BASELINE.md): the reference's best
published wall time, RTX 2080 at 45.43 s for 1280x960 x 2048 spp
= 2.516G samples => 55.4 Msamples/s.

BENCH_BACKEND picks the path: pallas (default; the GPU megakernel,
render/pallas_kernel.py), wavefront (the jnp integrator) or diff
(fwd+bwd training step through the wavefront AD path). Extra records
(mesh and textured scenes, the fwd+bwd rate, the end-to-end driver render)
follow unless BENCH_EXTRA=0.

Every device-touching step runs in this one process. Measuring needs a
GPU: on any other platform the script prints the headline with value null
and exits 1. Prints ONE JSON line: {"metric", "value", "unit",
"vs_baseline", "device", "card"[, "extra"]}.
"""
import json
import os
import sys
import time

BASELINE_MSPS = 1280 * 960 * 2048 / 45.43 / 1e6  # 55.39 Msamples/s
# per-scene reference baselines (BASELINE.md): best published wall times
# at 1280x960 x 2048 spp on the RTX 2080
SCENE_BASELINES = {
    "reference": BASELINE_MSPS,
    "teapot": 1280 * 960 * 2048 / (29 * 60 + 20) / 1e6,   # 29m20s -> 1.43
    "gopher": 1280 * 960 * 2048 / (47 * 60) / 1e6,        # 47m    -> 0.89
}


def _best_of(run, reps):
    run(0)  # compile + warm
    best = float("inf")
    for i in range(reps):
        t0 = time.perf_counter()
        run(i + 1)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_pallas(cfg, sc, arrays, meta, spp):
    import jax.numpy as jnp

    from pathtracer.render import pallas_kernel as pk

    W, H = cfg.width, cfg.height
    pix = jnp.asarray(pk.pixel_slots(W, H, pk.DEFAULT_BLOCK))
    cam_vec = jnp.asarray(pk.build_camera_vec(sc.camera))
    obj, nodes, tris = pk.scene_tables(arrays, meta)

    def run(seed):
        r, _, _ = pk.trace_tiles(
            jnp.asarray([seed, 0], jnp.int32), cam_vec, obj, nodes, tris,
            pix, meta=meta, cfg=cfg, spp=spp, total_samples=cfg.samples)
        r.block_until_ready()

    return W * H * spp, _best_of(run, 3)


def bench_diff(cfg, sc, arrays, meta, spp):
    """fwd+bwd (differentiable render + gradient step) throughput through
    the wavefront AD path (diff/grad.train_step) — the north-star
    'fwd+bwd per chip' dimension; the reference has no gradients at all.
    One sample per pixel per step."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer.diff.grad import extract_params, train_step
    from pathtracer.render.vec3 import Vec3

    W, H = cfg.width, cfg.height
    cam = sc.camera.pack()
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)
    params = extract_params(arrays)
    target = Vec3.zeros((px.shape[0],), jnp.float32)
    n = max(1, spp // 8)  # gradient steps at 1 spp each

    step = jax.jit(lambda p, k: train_step(
        p, arrays, meta, cfg, cam, px, py, k, 1, target))

    def run(i):
        p = params
        for j in range(n):
            p, _ = step(p, jax.random.PRNGKey(i * n + j))
        jax.tree.leaves(p)[0].block_until_ready()

    return W * H * n, _best_of(run, 2)


def bench_wavefront(cfg, sc, arrays, meta, spp):
    import jax
    import jax.numpy as jnp
    import numpy as np

    from pathtracer.render.integrator import _render_tile_jit

    W, H = cfg.width, cfg.height
    spp_chunk = min(cfg.samples_per_pass, spp)
    cfg = cfg.replace(samples_per_pass=spp_chunk)
    n_chunks = max(1, spp // spp_chunk)
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)
    cam = sc.camera.pack()

    def run(i):
        out = _render_tile_jit(arrays, meta, cfg, cam, px, py, n_chunks,
                               jax.random.PRNGKey(i))
        out.x.block_until_ready()

    return W * H * n_chunks * spp_chunk, _best_of(run, 2)


BENCHES = {"pallas": bench_pallas, "wavefront": bench_wavefront,
           "diff": bench_diff}


def measure(fn, scene, width, height, spp):
    """Msamples/s of one bench function on one scene."""
    from pathtracer.config import RenderConfig
    from pathtracer.scenes import get_scene

    cfg = RenderConfig(width=width, height=height, samples=2048,
                       samples_per_pass=8)
    sc = get_scene(scene, cfg)
    arrays, meta = sc.pack()
    samples, dt = fn(cfg, sc, arrays, meta, spp)
    return samples / dt / 1e6


def _extra_records(width, height):
    """Secondary cells: mesh and textured forward rates (megakernel where
    the scene supports it), and the fwd+bwd rate."""
    out = {}
    for scene, fn, spp in (("teapot", bench_pallas, 8),
                           ("gopher", bench_pallas, 8),
                           ("textures", bench_pallas, 32),
                           ("cubemap", bench_pallas, 8),
                           ("reference", bench_diff, 32)):
        tag = (f"fwd_bwd_{scene}" if fn is bench_diff
               else f"fwd_{scene}")
        msps = measure(fn, scene, width, height, spp)
        rec = {"Msamples_per_sec": msps}
        if scene in SCENE_BASELINES and fn is bench_pallas:
            rec["vs_baseline"] = msps / SCENE_BASELINES[scene]
        out[tag] = rec
    return out


def _full_render_record(width, height):
    """End-to-end wall clock of the FULL headline render (reference
    scene, width x height x 2048 spp) through the production driver —
    scene build + segmented device render + host download included.
    This is the number the reference's published 45.43 s actually is.
    Two runs: the first pays whatever compile the persistent cache
    doesn't cover, the second is the warm number."""
    from pathtracer.config import RenderConfig
    from pathtracer.driver import render_driver
    from pathtracer.scenes import get_scene

    def one():
        t0 = time.perf_counter()
        cfg = RenderConfig(width=width, height=height, samples=2048,
                           samples_per_pass=8)
        sc = get_scene("reference", cfg)
        arrays, meta = sc.pack()
        img, stats = render_driver(arrays, meta, sc.camera, cfg)
        wall = time.perf_counter() - t0
        assert float(img.mean()) > 0.0
        return wall, stats

    wall_cold, _ = one()
    wall_warm, stats = one()
    total = width * height * 2048
    return {"full_render_1280x960x2048": {
        "wall_s": wall_warm,
        "wall_s_first_run": wall_cold,
        "Msamples_per_sec_e2e": total / wall_warm / 1e6,
        "vs_baseline_wall": 45.43 / wall_warm,
        "device_Msamples_per_sec": stats.msamples_per_sec,
    }}


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from pathtracer.cache import configure_compile_cache
    from pathtracer.device import card_name, device_record
    from pathtracer.scenes import list_scenes

    configure_compile_cache()
    width = int(os.environ.get("BENCH_WIDTH", "1280"))
    height = int(os.environ.get("BENCH_HEIGHT", "960"))
    backend = os.environ.get("BENCH_BACKEND", "pallas")
    spp = int(os.environ.get("BENCH_SPP", "128" if backend == "pallas"
                             else "32"))
    scene = os.environ.get("BENCH_SCENE", "reference")
    tag = "_fwd_bwd" if backend == "diff" else ""
    metric = f"{scene}{tag}_{width}x{height}_Msamples_per_sec"

    def fail(msg, device=None):
        print(json.dumps({"metric": metric, "value": None,
                          "unit": "Msamples/s", "vs_baseline": None,
                          "device": device, "error": msg[:200]}))
        raise SystemExit(1)

    if scene not in list_scenes():
        fail(f"unknown scene {scene!r}")
    if backend not in BENCHES:
        fail(f"unknown BENCH_BACKEND {backend!r}")
    device = device_record()
    if device["platform"] != "gpu":
        fail(f"bench.py measures on a GPU; found {device['platform']}",
             device)
    card = card_name()
    print(f"card: {card}", flush=True)

    msps = measure(BENCHES[backend], scene, width, height, spp)
    rec = {
        "metric": metric,
        "value": msps,
        "unit": "Msamples/s",
        "vs_baseline": msps / SCENE_BASELINES.get(scene, BASELINE_MSPS),
        "device": device,
        "card": card,
    }
    if os.environ.get("BENCH_EXTRA", "1") != "0":
        extra = _extra_records(width, height)
        if scene == "reference" and backend == "pallas":
            extra.update(_full_render_record(width, height))
        rec["extra"] = extra
    print(json.dumps(rec))


if __name__ == "__main__":
    main()
