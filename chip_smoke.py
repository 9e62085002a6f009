"""End-to-end check that the path tracer runs correctly on the GPU.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --multi    # four cards: the sharded paths only

Phases (one card), in order; any failure raises and exits non-zero:

1. device     JAX must see a GPU.
2. reference  `reference` at 1280x960x64 spp through cli.main, megakernel
              (the `auto` choice) and wavefront: image means per channel
              within 1% relative, mean |difference| <= 0.15, Cornell wall
              colours, Msamples/s of each path (a second, warm render).
3. teapot     `teapot` (BVH mesh) at 1280x960x64, the same comparison.
4. precision  wavefront f32 renders on the card vs the CPU goldens
              (tests/goldens) within tests/test_golden.py's tolerance.
5. training   Adam steps of diff/grad.train_step at 1280x960: finite,
              falling loss; the parameters move.
6. gpu_tests  the `gpu`-marked tests, run in this process.

Every phase runs even after one fails; the script then exits 1 and
prints no result line.

--multi runs only: the sharded driver render at 1280x960 on a (2, 2)
mesh against the one-card render, and one sharded train step whose
gradient is compared with the one-card gradient.

Every device step runs in this one process; the only child process
(the f64 CPU golden of the gpu tests) is pinned to the CPU. The last line
of standard output is one JSON object: {"ok": true, "device": {...}}.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import traceback

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
W, H = 1280, 960
PHASES = ("device", "reference", "teapot", "precision", "training",
          "gpu_tests")
MULTI_PHASES = ("device", "multi")


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--multi", action="store_true",
                   help="run only the four-card sharded checks")
    p.add_argument("--phases", default=None,
                   help="comma-separated subset of the one-card phases")
    return p.parse_args(argv)


def select_phases(args) -> tuple:
    """The phases a run executes, in order ('device' always first)."""
    if args.multi:
        if args.phases:
            raise SystemExit("--phases does not combine with --multi")
        return MULTI_PHASES
    if not args.phases:
        return PHASES
    want = [p.strip() for p in args.phases.split(",") if p.strip()]
    unknown = sorted(set(want) - set(PHASES))
    if unknown:
        raise SystemExit(f"unknown phase(s): {', '.join(unknown)}")
    return ("device",) + tuple(p for p in PHASES[1:] if p in want)


def log(msg: str) -> None:
    print(msg, flush=True)


def compare(name, a, b, max_mad=0.15, max_rel=0.01):
    """Statistical parity of two independent estimates of one image."""
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.isfinite(a).all() and np.isfinite(b).all(), name
    ma = a.reshape(-1, 3).mean(axis=0)
    mb = b.reshape(-1, 3).mean(axis=0)
    rel = np.abs(ma - mb) / np.maximum(mb, 1e-12)
    mad = float(np.abs(a - b).mean())
    log(f"{name}: channel means {ma.tolist()} vs {mb.tolist()}, "
        f"relative diff {rel.tolist()} (limit {max_rel}), "
        f"mean |diff| {mad} (limit {max_mad})")
    assert (rel <= max_rel).all(), f"{name}: channel means differ"
    assert mad <= max_mad, f"{name}: mean absolute difference too large"


def render_cli(ctx, scene, spp, backend, spp_pass=8):
    """One render through the CLI entry point; returns (image, metrics)."""
    from pathtracer import cli
    from pathtracer.io.raw import read_raw

    base = os.path.join(ctx["out"], f"{scene}-{backend}-{spp}spp")
    rc = cli.main([
        "--scene", scene, "--width", str(W), "--height", str(H),
        "--samples", str(spp), "--samples-per-pass", str(spp_pass),
        "--backend", backend, "--output", base + ".png",
        "--raw-output", base + ".raw", "--metrics-json", base + ".json"])
    assert rc == 0, f"cli.main returned {rc}"
    with open(base + ".json") as f:
        metrics = json.load(f)
    return read_raw(base + ".raw"), metrics


def forward_phase(ctx, scene, spp):
    out = {}
    for tag, backend in (("megakernel", "auto"), ("wavefront", "wavefront")):
        # the first render compiles; the second is timed warm
        _, cold = render_cli(ctx, scene, spp, backend)
        img, warm = render_cli(ctx, scene, spp, backend)
        log(f"{scene} {W}x{H}x{spp} {tag} ({warm['backend']}): "
            f"{warm['msamples_per_sec']} Msamples/s warm, "
            f"{cold['total_wall_s']} s first render incl. compile "
            f"[{ctx['card']}]")
        out[tag] = (img, warm)
    (img_k, m_k), (img_w, _) = out["megakernel"], out["wavefront"]
    assert m_k["backend"] == "pallas", (
        f"--backend auto chose {m_k['backend']} on the GPU")
    compare(f"{scene} megakernel vs wavefront", img_k, img_w)
    return img_k


def phase_device(ctx):
    import jax

    devs = jax.devices()
    log(f"devices: {len(devs)} x {devs[0].device_kind} "
        f"({devs[0].platform})")


def phase_reference(ctx):
    img = forward_phase(ctx, "reference", 64)
    row = img[H // 2]
    left, right = row[5], row[W - 6]
    log(f"reference walls: left rgb {left.tolist()}, right rgb "
        f"{right.tolist()}")
    assert left[0] > left[2], "left wall is not red"
    assert right[2] > right[0], "right wall is not blue"


def phase_teapot(ctx):
    forward_phase(ctx, "teapot", 64)


def phase_precision(ctx):
    from pathtracer.config import RenderConfig
    from pathtracer.render.integrator import render
    from pathtracer.scenes import get_scene

    # tests/test_golden.py's 2e-5, except for `textures`: its computed
    # texels call sin() (the jupiter program), whose last bits differ
    # between the GPU's libdevice and the CPU
    atol = {"textures": 1e-4}
    goldens = {
        "reference": dict(width=32, height=24, samples=8,
                          samples_per_pass=4, seed=7),
        "teapot": dict(width=32, height=24, samples=4, samples_per_pass=4,
                       seed=7),
        "textures": dict(width=32, height=24, samples=4,
                         samples_per_pass=4, seed=11),
        "transparency": dict(width=32, height=24, samples=4,
                             samples_per_pass=4, seed=11),
    }
    for scene, kw in goldens.items():
        cfg = RenderConfig(**kw)
        sc = get_scene(scene, cfg)
        arrays, meta = sc.pack()
        img = render(arrays, meta, sc.camera, cfg)
        with np.load(os.path.join(REPO, "tests", "goldens",
                                  f"{scene}.npz")) as z:
            want = z["img"]
            if "n_tris" in z:
                assert int(z["n_tris"]) == meta.n_tri_slots, (
                    f"{scene}: triangle pool differs from the golden's")
        diff = np.abs(img - want)
        tol = atol.get(scene, 2e-5)
        log(f"precision {scene}: wavefront f32 on the card vs CPU golden, "
            f"max |diff| {float(diff.max())}, mean {float(diff.mean())} "
            f"(limit {tol})")
        np.testing.assert_allclose(img, want, atol=tol)


def phase_training(ctx):
    import jax
    import jax.numpy as jnp
    import optax

    from pathtracer.config import RenderConfig
    from pathtracer.diff.grad import extract_params, train_step
    from pathtracer.render.vec3 import Vec3
    from pathtracer.scenes import get_scene

    cfg = RenderConfig(width=W, height=H, samples=1, samples_per_pass=1)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    cam = sc.camera.pack()
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)
    target = Vec3.zeros((px.shape[0],), jnp.float32)
    opt = optax.adam(0.05)
    params0 = params = extract_params(arrays)
    opt_state = opt.init(params)
    key = jax.random.PRNGKey(0)
    step = jax.jit(lambda p, s: train_step(
        p, arrays, meta, cfg, cam, px, py, key, 1, target,
        optimizer=opt, opt_state=s))
    losses = []
    for i in range(4):
        t0 = time.perf_counter()
        params, opt_state, loss = step(params, opt_state)
        losses.append(float(loss))
        log(f"training step {i}: loss {losses[-1]} "
            f"({time.perf_counter() - t0} s) [{ctx['card']}]")
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0], f"loss did not fall: {losses}"
    moved = max(float(np.abs(np.asarray(a) - np.asarray(b)).max())
                for a, b in zip(jax.tree.leaves(params),
                                jax.tree.leaves(params0)))
    log(f"training: largest parameter change {moved}")
    assert moved > 0.0, "parameters did not move"


def phase_gpu_tests(ctx):
    import pytest

    os.environ["PT_TESTS_GPU"] = "1"
    rc = pytest.main(["-q", "-rP", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(REPO, "tests")])
    log(f"gpu-marked tests: pytest exit code {int(rc)}")
    assert int(rc) == 0, f"gpu-marked tests failed (pytest rc {int(rc)})"


def phase_multi(ctx):
    import jax
    import jax.numpy as jnp

    from pathtracer.config import RenderConfig
    from pathtracer.diff.grad import (extract_params, image_loss,
                                      make_sharded_train_step)
    from pathtracer.driver import render_driver
    from pathtracer.parallel.mesh import make_mesh, mesh_shape_for
    from pathtracer.render.vec3 import Vec3
    from pathtracer.scenes import get_scene

    devs = jax.devices()
    assert len(devs) == 4, f"--multi needs 4 GPUs, found {len(devs)}"
    shape = mesh_shape_for(4)
    assert tuple(shape) == (2, 2), shape
    mesh = make_mesh(devs, shape=shape)

    # sharded forward render through the driver vs one card
    cfg = RenderConfig(width=W, height=H, samples=64, samples_per_pass=8)
    sc = get_scene("reference", cfg)
    arrays, meta = sc.pack()
    t0 = time.perf_counter()
    img_1, st_1 = render_driver(arrays, meta, sc.camera, cfg)
    log(f"one-card render ({st_1.backend}): {st_1.msamples_per_sec} "
        f"Msamples/s, {time.perf_counter() - t0} s wall incl. compile "
        f"[{ctx['card']}]")
    t0 = time.perf_counter()
    img_4, st_4 = render_driver(arrays, meta, sc.camera, cfg, mesh=mesh)
    log(f"sharded render ({st_4.backend}): {st_4.msamples_per_sec} "
        f"Msamples/s, {time.perf_counter() - t0} s wall incl. compile "
        f"[{ctx['card']}]")
    log(f"sharded vs one-card render: max |diff| "
        f"{float(np.abs(img_4 - img_1).max())} (the megakernel keys its RNG "
        f"on global pixel and sample, so only summation order differs)")
    compare("sharded vs one-card render", img_4, img_1)

    # one sharded train step: its gradient vs the one-card gradient
    lr = 0.05
    cam = sc.camera.pack()
    ys, xs = np.mgrid[0:H, 0:W]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)
    target = Vec3.zeros((px.shape[0],), jnp.float32)
    params = extract_params(arrays)
    key = jax.random.PRNGKey(0)
    step = make_sharded_train_step(mesh, meta, cfg, n_samples=1, lr=lr)
    new_params, loss4 = step(params, arrays, cam, px, py, target, key)
    devices_used = {d for leaf in jax.tree.leaves(new_params)
                    for d in leaf.sharding.device_set}
    log(f"sharded train step: loss {float(loss4)}, result on "
        f"{len(devices_used)} devices")
    assert len(devices_used) == 4, devices_used
    g4 = jax.tree.map(lambda p, q: (np.asarray(p) - np.asarray(q)) / lr,
                      params, new_params)
    # the same estimate on one card: the step's loss is the mean over the
    # 'pixels' shards (contiguous halves of the pixel list) and the 'spp'
    # shards of per-shard losses, each with its key folded by its mesh
    # coordinates, so the one-card gradient averages those four terms
    grad = jax.jit(jax.grad(lambda p, k, x, y, t: image_loss(
        p, arrays, meta, cfg, cam, x, y, k, 1, t)))
    half = px.shape[0] // 2
    g1 = None
    for r in range(2):
        sl = slice(r * half, (r + 1) * half)
        for s in range(2):
            k = jax.random.fold_in(jax.random.fold_in(key, r), s)
            g = grad(params, k, px[sl], py[sl],
                     Vec3(target.x[sl], target.y[sl], target.z[sl]))
            g1 = g if g1 is None else jax.tree.map(jnp.add, g1, g)
    g1 = jax.tree.map(lambda g: np.asarray(g) / 4.0, g1)
    for name in ("color", "emission"):
        a = np.asarray(getattr(g4, name)).ravel()
        b = np.asarray(getattr(g1, name)).ravel()
        rel = float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))
        log(f"sharded vs one-card {name} gradient (same estimator, same "
            f"keys): relative L2 difference {rel} (limit 1e-3)")
        assert np.isfinite(a).all() and rel < 1e-3, name


PHASE_FUNCS = {
    "device": phase_device, "reference": phase_reference,
    "teapot": phase_teapot, "precision": phase_precision,
    "training": phase_training, "gpu_tests": phase_gpu_tests,
    "multi": phase_multi,
}


def main(argv=None) -> int:
    args = parse_args(argv)
    phases = select_phases(args)
    sys.path.insert(0, REPO)
    import jax

    from pathtracer.cache import configure_compile_cache
    from pathtracer.device import card_name

    configure_compile_cache()
    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU, JAX found {devs[0].platform}",
              file=sys.stderr)
        return 2
    ctx = {"card": card_name()}
    log(f"card: {ctx['card']}")
    failed = []
    with tempfile.TemporaryDirectory() as out:
        ctx["out"] = out
        for name in phases:
            t0 = time.perf_counter()
            log(f"== phase {name}")
            try:
                PHASE_FUNCS[name](ctx)
            except Exception:  # noqa: BLE001 — reported, and fails the run
                traceback.print_exc()
                log(f"== phase {name} FAILED after "
                    f"{time.perf_counter() - t0} s")
                failed.append(name)
                if name == "device":
                    break
                continue
            log(f"== phase {name} passed in {time.perf_counter() - t0} s")
    if failed:
        log(f"chip_smoke: failed phases: {', '.join(failed)}")
        return 1
    log(f"card: {ctx['card']}")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
