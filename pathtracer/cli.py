"""Command-line entry point.

Flag-for-flag equivalent of the reference CLI (cmd/pt/main.go:45-112):
--width --height --samples --aperture --focal-length --scene
--device-index --list-devices --list-scenes, with viper-style environment
overrides (PT_WIDTH=1920 etc., cf. viper.AutomaticEnv, cmd/pt/main.go:64),
plus flags for precision, backend, chunking, distribution, checkpointing
and profiling.

Outputs match the reference render driver: `experiment.raw` (float32 RGB
dump, internal/app/raw/writer.go:11-35) and `out-<spp>-<W>x<H>.png`
(internal/app/tracer/pathtracer.go:29-39).
"""
from __future__ import annotations

import argparse
import logging
import os
import sys
import time


def _env(name: str, default, cast):
    v = os.environ.get(f"PT_{name.upper().replace('-', '_')}")
    return cast(v) if v is not None else default


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="pathtracer",
        description="GPU Monte-Carlo path tracer",
    )
    # reference flags (cmd/pt/main.go:48-56)
    p.add_argument("--width", type=int, default=_env("width", 1280, int))
    p.add_argument("--height", type=int, default=_env("height", 960, int))
    p.add_argument("--samples", type=int, default=_env("samples", 1, int))
    p.add_argument("--aperture", type=float,
                   default=_env("aperture", 0.0, float))
    p.add_argument("--focal-length", type=float,
                   default=_env("focal_length", 0.0, float))
    p.add_argument("--scene", type=str,
                   default=_env("scene", "reference", str))
    p.add_argument("--device-index", type=int,
                   default=_env("device_index", 0, int))
    p.add_argument("--list-devices", action="store_true")
    p.add_argument("--list-scenes", action="store_true")
    # device-side flags
    p.add_argument("--dtype", choices=("float32", "float64"),
                   default=_env("dtype", "float32", str))
    p.add_argument("--backend", choices=("auto", "pallas", "wavefront"),
                   default=_env("backend", "auto", str),
                   help="pallas = GPU megakernel (scenes without "
                        "file-backed textures); wavefront = jnp "
                        "integrator (all scenes); auto picks the "
                        "megakernel on a GPU where it can")
    p.add_argument("--samples-per-pass", type=int,
                   default=_env("samples_per_pass", 8, int))
    p.add_argument("--rows-per-pass", type=int,
                   default=_env("rows_per_pass", 0, int))
    p.add_argument("--seed", type=int, default=_env("seed", 0, int))
    p.add_argument("--nee", action="store_true",
                   help="next-event estimation (the reference's "
                        "experimental light sampling, tracer.cl:786)")
    p.add_argument("--debug-ray", type=int, default=-1,
                   help="print per-bounce state for this ray index")
    p.add_argument("--distributed", action="store_true",
                   help="shard pixels x spp over all visible devices")
    p.add_argument("--mesh", type=str, default=None,
                   help="mesh shape as PIXELSxSPP, e.g. 4x2")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="checkpoint file (.npz) for save/resume")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="checkpoint every N sample chunks")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--profile", type=str, default=None,
                   help="write a jax.profiler trace to this directory")
    p.add_argument("--metrics-json", type=str, default=None,
                   help="write render metrics as one JSON line to this file")
    p.add_argument("--output", type=str, default=None,
                   help="PNG path (default out-<spp>-<W>x<H>.png)")
    p.add_argument("--raw-output", type=str, default="experiment.raw")
    p.add_argument("-v", "--verbose", action="store_true")
    return p


def list_devices() -> None:
    """Equivalent of cmd/pt/main.go:98-112."""
    import jax

    for i, d in enumerate(jax.devices()):
        print(f"Index: {i}")
        print(f"Type: {d.platform.upper()}")
        print(f"Name: {getattr(d, 'device_kind', d)}")


def main(argv=None) -> int:
    from .cache import configure_compile_cache

    configure_compile_cache()

    # multi-host: join the jax.distributed cluster BEFORE any backend
    # init (same contract as tests/_multihost_worker.py), via
    # PT_COORDINATOR=host:port, PT_NUM_PROCESSES and PT_PROCESS_ID.
    if os.environ.get("PT_COORDINATOR"):
        from .parallel.multihost import initialize_multihost

        npr = os.environ.get("PT_NUM_PROCESSES")
        pid = os.environ.get("PT_PROCESS_ID")
        initialize_multihost(
            coordinator_address=os.environ["PT_COORDINATOR"],
            num_processes=int(npr) if npr else None,
            process_id=int(pid) if pid else None,
        )

    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname)s %(message)s",
    )
    log = logging.getLogger("pathtracer")

    from .scenes import list_scenes as _scenes

    if args.list_scenes:
        # cmd/pt/main.go:92-96
        print("Available scenes:")
        for name in _scenes():
            print(f"  {name}")
        return 0
    if args.list_devices:
        list_devices()
        return 0

    import jax

    from .config import RenderConfig
    from .driver import render_driver
    from .io.png import write_png
    from .io.raw import write_raw
    from .scenes import get_scene

    # fail fast on an unwritable --output BEFORE burning a render: a
    # directory path (or a non-PNG extension) would otherwise crash in
    # write_png after the full render completed
    if args.output:
        if os.path.isdir(args.output) or args.output.endswith(os.sep):
            print(f"error: --output {args.output!r} is a directory; "
                  "pass a .png file path", file=sys.stderr)
            return 2
        ext = os.path.splitext(args.output)[1].lower()
        if ext != ".png":
            print(f"error: --output {args.output!r} has unsupported "
                  f"extension {ext or '(none)'}; use .png", file=sys.stderr)
            return 2

    cfg = RenderConfig(
        width=args.width, height=args.height, samples=args.samples,
        aperture=args.aperture, focal_length=args.focal_length,
        dtype=args.dtype, samples_per_pass=args.samples_per_pass,
        rows_per_pass=args.rows_per_pass, seed=args.seed,
        backend=args.backend, nee=args.nee, debug_ray=args.debug_ray,
    )

    if args.dtype == "float64":
        # without x64 enabled jax silently downcasts to f32 — the f64
        # golden path (the reference computes in double throughout,
        # tracer.cl) must actually be double
        jax.config.update("jax_enable_x64", True)

    t0 = time.perf_counter()
    try:
        sc = get_scene(args.scene, cfg)
    except KeyError as e:
        print(f"error: {e.args[0]}", file=sys.stderr)
        return 2
    import jax.numpy as jnp

    arrays, meta = sc.pack(
        dtype=jnp.float64 if args.dtype == "float64" else jnp.float32
    )
    log.info("scene %s: %d objects, %d BVH nodes, %d triangle slots",
             args.scene, meta.n_objects, meta.n_nodes, meta.n_tri_slots)

    mesh = None
    if args.distributed or args.mesh:
        from .parallel.mesh import make_mesh, mesh_shape_for

        devices = jax.devices()
        if args.mesh:
            shape = tuple(int(v) for v in args.mesh.split("x"))
        else:
            shape = mesh_shape_for(len(devices))
        mesh = make_mesh(devices[:shape[0] * shape[1]], shape=shape)
        log.info("mesh: %s over %d devices", dict(mesh.shape), mesh.size)
    elif args.device_index:
        jax.config.update(
            "jax_default_device", jax.devices()[args.device_index]
        )
    # one driver entry for everything, like the reference's tracer.Render
    # (pathtracer.go:19): distributed renders keep checkpoints, failure
    # recovery and metrics — only the per-segment compute is sharded
    img, stats = render_driver(
        arrays, meta, sc.camera, cfg,
        checkpoint_path=args.checkpoint,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        profile_dir=args.profile,
        mesh=mesh,
    )

    dt = time.perf_counter() - t0
    log.info("render took %.2fs%s", dt,
             f" ({stats.msamples_per_sec:.2f} Msamples/s)" if stats else "")
    if args.metrics_json and stats:
        with open(args.metrics_json, "w") as f:
            f.write(stats.to_json(
                scene=args.scene, width=cfg.width, height=cfg.height,
                spp=cfg.samples, total_wall_s=round(dt, 3),
            ) + "\n")

    write_raw(args.raw_output, img)
    out = args.output or f"out-{cfg.samples}-{cfg.width}x{cfg.height}.png"
    write_png(out, img)
    log.info("wrote %s and %s", args.raw_output, out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
