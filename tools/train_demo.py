"""Inverse-rendering demo: recover scene parameters from a target image by
gradient descent through the differentiable renderer.

The demo perturbs one parameter field, then optimizes it back toward a
target render of the TRUE scene with adam through diff/grad.train_step
(the wavefront AD path; the distributed equivalent is
diff.make_sharded_train_step, tested in tests/test_grad.py). Outputs a
side-by-side PNG (target | perturbed | recovered) plus the loss curve.

Modes:
    python tools/train_demo.py [--steps 200]        # sphere colors of the
                                                    # reference Cornell box
    python tools/train_demo.py --tri --scene teapot # per-triangle colors
    python tools/train_demo.py --tex                # planar texel atlas
                                                    # (textures-train)

Runs on whatever device JAX picks (JAX_PLATFORMS=cpu for the CPU).
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--width", type=int, default=160)
    ap.add_argument("--height", type=int, default=120)
    ap.add_argument("--spp", type=int, default=8)
    ap.add_argument("--lr", type=float, default=0.02)
    ap.add_argument("--out", default=None,
                    help="PNG path (default docs/renders/train_demo"
                         "[_tri|_tex].png)")
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--tri", action="store_true",
                      help="mesh mode: recover per-triangle colors")
    mode.add_argument("--tex", action="store_true",
                      help="texture mode: recover the planar texel atlas")
    ap.add_argument("--scene", default=None,
                    help="scene (default reference / teapot / "
                         "textures-train by mode)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp
    import optax

    from pathtracer.config import RenderConfig
    from pathtracer.diff import extract_params, render_image_diff
    from pathtracer.diff.grad import train_step
    from pathtracer.io.png import write_png
    from pathtracer.render.vec3 import Vec3
    from pathtracer.scene.shapes import SPHERE
    from pathtracer.scenes import get_scene

    field, label, suffix, default_scene = (
        ("tri_color", "tri-color", "_tri", "teapot") if args.tri else
        ("tex_planar", "texel", "_tex", "textures-train") if args.tex else
        ("color", "color", "", "reference"))
    W, H = args.width, args.height
    cfg = RenderConfig(width=W, height=H, samples=args.spp,
                       samples_per_pass=args.spp)
    sc = get_scene(args.scene or default_scene, cfg)
    arrays, meta = sc.pack()
    cam = sc.camera.pack()
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)

    def render(params, key, spp):
        acc = render_image_diff(params, arrays, meta, cfg, cam, px, py,
                                key, spp)
        return np.stack([np.asarray(c) for c in acc], -1).reshape(H, W, 3)

    true_params = extract_params(arrays)
    truth = np.asarray(getattr(true_params, field))
    # which entries are perturbed and trained: the spheres' colors
    # (directly visible, so the inverse problem is well-identified), the
    # real (non-padding) triangles, or every texel
    if args.tri:
        ng = np.cross(np.asarray(arrays.tri_e1), np.asarray(arrays.tri_e2))
        active = np.broadcast_to(((ng * ng).sum(1) > 0)[:, None],
                                 truth.shape)
    elif args.tex:
        active = np.ones(truth.shape, bool)
    else:
        rows = np.asarray([t == SPHERE for t in meta.obj_types]
                          + [False] * (meta.max_objects - meta.n_objects))
        active = np.broadcast_to(rows[:, None], truth.shape)
    rng = np.random.default_rng(3)
    bad = truth.copy()
    bad[active] = np.clip(
        bad[active] + rng.uniform(-0.4, 0.4, int(active.sum())), 0.05, 1.0)
    mask = jnp.asarray(active, jnp.float32)

    key = jax.random.PRNGKey(0)
    # COMMON RANDOM NUMBERS: the target uses the SAME key and spp as every
    # training estimate, so the Monte-Carlo noise cancels in the loss and
    # what remains is pure parameter mismatch
    train_key = jax.random.fold_in(key, 12345)
    target_img = render(true_params, train_key, args.spp)
    target = Vec3(*(jnp.asarray(target_img[..., c].ravel(), jnp.float32)
                    for c in range(3)))
    params = true_params._replace(**{field: jnp.asarray(bad)})
    initial_img = render(params, jax.random.fold_in(key, 998), 64)
    display_target = render(true_params, jax.random.fold_in(key, 999), 64)

    opt = optax.adam(args.lr)
    opt_state = opt.init(params)

    @jax.jit
    def step(params, opt_state):
        params, opt_state, loss = train_step(
            params, arrays, meta, cfg, cam, px, py, train_key, args.spp,
            target, optimizer=opt, opt_state=opt_state)
        # projected descent on the trained entries only: every other
        # parameter stays at truth (otherwise the optimizer games the
        # image loss through emission/texture trade-offs), and the field
        # projects back into the physical [0, 1] box
        val = (jnp.clip(getattr(params, field), 0.0, 1.0) * mask
               + jnp.asarray(truth) * (1.0 - mask))
        return true_params._replace(**{field: val}), opt_state, loss

    t0 = time.time()
    losses = []
    for i in range(args.steps):
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        if i % 25 == 0 or i == args.steps - 1:
            print(f"step {i:4d}  loss {losses[-1]:.6f}", flush=True)
    dt = time.time() - t0

    recovered_img = render(params, jax.random.fold_in(key, 997), 64)
    got = np.asarray(getattr(params, field))
    err0 = float(np.abs(truth - bad)[active].mean())
    err1 = float(np.abs(truth - got)[active].mean())
    print(f"{args.steps} steps in {dt:.1f}s on "
          f"{len(jax.devices())} {jax.devices()[0].platform} device(s); "
          f"loss {losses[0]:.5f} -> {losses[-1]:.5f}; "
          f"{label} MAD {err0:.4f} -> {err1:.4f}")

    out = args.out or f"docs/renders/train_demo{suffix}.png"
    write_png(out, np.concatenate(
        [display_target, initial_img, recovered_img], axis=1))
    print(f"wrote {out} (target | perturbed | recovered)")
    return err0, err1


if __name__ == "__main__":
    main()
