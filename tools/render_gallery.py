"""Render a small PNG of every registered scene into docs/renders/.

The counterpart of the reference's images/ archive (its informal golden
history). Megakernel scenes render at higher spp; the scenes with
file-backed textures (wavefront path) use fewer samples to keep the
gallery run short.

    python tools/render_gallery.py [--out docs/renders] [--width 320]
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="docs/renders")
    ap.add_argument("--width", type=int, default=320)
    ap.add_argument("--height", type=int, default=240)
    ap.add_argument("--scenes", nargs="*", default=None)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend")
    args = ap.parse_args()

    if args.cpu:
        import jax

        jax.config.update("jax_platforms", "cpu")

    from pathtracer.config import RenderConfig
    from pathtracer.driver import render_driver
    from pathtracer.io.png import write_png
    from pathtracer.scenes import get_scene, list_scenes

    os.makedirs(args.out, exist_ok=True)
    names = args.scenes or list_scenes()
    for name in names:
        t0 = time.perf_counter()
        cfg = RenderConfig(width=args.width, height=args.height,
                           samples=256, samples_per_pass=8)
        sc = get_scene(name, cfg)
        arrays, meta = sc.pack()
        # file-textured scenes run on the (slower) wavefront path — fewer
        # spp
        from pathtracer.render.pallas_kernel import supports_scene

        if not supports_scene(meta):
            spp = 32 if meta.has_groups else 64
            cfg = cfg.replace(samples=spp)
        img, stats = render_driver(arrays, meta, sc.camera, cfg)
        path = os.path.join(args.out, f"{name}.png")
        write_png(path, img)
        print(f"{name}: {cfg.samples} spp in {time.perf_counter()-t0:.1f}s "
              f"({stats.backend}) -> {path}", flush=True)


if __name__ == "__main__":
    main()
