"""Differentiable render + distributed training step.

The north-star dimension the reference lacks entirely (BASELINE.json):
gradients of the rendered image w.r.t. continuous material parameters.

What is differentiable:
- object colors, emission, per-triangle colors, texture atlases — these
  enter the estimator only through the linear mask/accum chain
  (tracer.cl:1148-1175), so reverse-mode AD through the bounce fori_loop
  gives exact pathwise gradients
- the roulette DECISIONS (reflect/refract choices, tracer.cl:982-1061) and
  intersection geometry are discrete; they are detached (their comparisons
  produce booleans, which carry no tangents), i.e. detached-sampling
  pathwise gradients for continuous params only (SURVEY.md section 7.5)

Distribution: gradients are psum-reduced over both mesh axes inside the
sharded step, overlapping with the backward pass under XLA.
"""
from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from ..config import RenderConfig
from ..render.camera import CameraArrays
from ..render.integrator import render_pass
from ..render.vec3 import Vec3
from ..scene.pack import SceneArrays, SceneMeta


class SceneParams(NamedTuple):
    """The trainable subset of SceneArrays."""
    color: jnp.ndarray       # [No,3]
    emission: jnp.ndarray    # [No,3]
    tri_color: jnp.ndarray   # [Nt,3]
    tex_planar: jnp.ndarray  # [3,n,H,W]
    tex_sphere: jnp.ndarray
    tex_cube: jnp.ndarray


def extract_params(scn: SceneArrays) -> SceneParams:
    return SceneParams(
        color=scn.color,
        emission=scn.emission,
        tri_color=scn.tri_color,
        tex_planar=scn.tex_planar,
        tex_sphere=scn.tex_sphere,
        tex_cube=scn.tex_cube,
    )


def apply_params(scn: SceneArrays, p: SceneParams) -> SceneArrays:
    return scn._replace(
        color=p.color,
        emission=p.emission,
        tri_color=p.tri_color,
        tex_planar=p.tex_planar,
        tex_sphere=p.tex_sphere,
        tex_cube=p.tex_cube,
    )


def render_image_diff(
    params: SceneParams,
    scn: SceneArrays,
    meta: SceneMeta,
    cfg: RenderConfig,
    cam: CameraArrays,
    px: jnp.ndarray,
    py: jnp.ndarray,
    key: jax.Array,
    n_samples: int,
) -> Vec3:
    """Differentiable estimate of P pixels at n_samples spp -> Vec3 [P]."""
    scn = apply_params(scn, params)
    # fixed-trip bounce loop: reverse-mode AD cannot cross a dynamic
    # while_loop (config.py early_exit); float texture sampling so texel
    # gradients flow (the u32 texel-pool path is quantized/non-differentiable)
    cfg = cfg.replace(early_exit=False, trainable_textures=True)
    acc = render_pass(scn, meta, cfg, cam, px, py,
                      jnp.int32(0), n_samples, key)
    return acc * (1.0 / float(n_samples))


def image_loss(params, scn, meta, cfg, cam, px, py, key, n_samples,
               target: Vec3) -> jnp.ndarray:
    img = render_image_diff(params, scn, meta, cfg, cam, px, py, key,
                            n_samples)
    d = img - target
    return jnp.mean(d.x * d.x + d.y * d.y + d.z * d.z) / 3.0


def train_step(params, scn, meta, cfg, cam, px, py, key, n_samples,
               target: Vec3, lr=0.05, optimizer=None, opt_state=None):
    """Single-device training step.

    Plain SGD at `lr` returns (new_params, loss). With an optax
    `optimizer` (e.g. optax.adam) and its `opt_state` it returns
    (new_params, new_opt_state, loss)."""
    loss, grads = jax.value_and_grad(image_loss)(
        params, scn, meta, cfg, cam, px, py, key, n_samples, target
    )
    if optimizer is None:
        new_params = jax.tree.map(lambda p, g: p - lr * g, params, grads)
        return new_params, loss
    import optax

    updates, opt_state = optimizer.update(grads, opt_state, params)
    return optax.apply_updates(params, updates), opt_state, loss



def make_sharded_train_step(
    mesh: Mesh,
    meta: SceneMeta,
    cfg: RenderConfig,
    n_samples: int,
    lr: float = 0.05,
    optimizer=None,
):
    """Build the jit-able distributed training step.

    Sharding layout: params + scene + camera replicated, pixels sharded over
    the 'pixels' axis, samples split over the 'spp' axis. Per-device pathwise
    gradients are psum-reduced over BOTH axes — the psum is emitted inside
    the step so XLA can overlap the all-reduce with the backward pass.

    `optimizer` is any optax GradientTransformation; None means plain SGD
    at `lr` with the same (params, ...) -> (new_params, loss) signature as
    before. With an optimizer the returned step takes and returns an
    opt_state: (params, opt_state, ...) -> (new_params, new_opt_state,
    loss); initialize it with `optimizer.init(params)` (replicated — the
    gradients are pmean-reduced before the update, so every device holds
    identical optimizer state).
    """

    def step(params, opt_state, scn, cam, px, py, target, key):
        pix_rank = jax.lax.axis_index("pixels")
        spp_rank = jax.lax.axis_index("spp")
        k = jax.random.fold_in(jax.random.fold_in(key, pix_rank), spp_rank)

        def local_loss(p):
            return image_loss(p, scn, meta, cfg, cam, px, py, k, n_samples,
                              target)

        loss, grads = jax.value_and_grad(local_loss)(params)
        loss = jax.lax.pmean(jax.lax.pmean(loss, "pixels"), "spp")
        grads = jax.tree.map(
            lambda g: jax.lax.pmean(jax.lax.pmean(g, "pixels"), "spp"), grads
        )
        if optimizer is None:
            new_params = jax.tree.map(lambda p, g: p - lr * g, params,
                                      grads)
            return new_params, loss
        import optax

        updates, new_opt_state = optimizer.update(grads, opt_state, params)
        new_params = optax.apply_updates(params, updates)
        return new_params, new_opt_state, loss

    if optimizer is None:
        fn = lambda params, scn, cam, px, py, target, key: step(  # noqa: E731
            params, None, scn, cam, px, py, target, key)
        n_rep_in, n_rep_out = 1, 1    # params in; params out
    else:
        fn = step
        n_rep_in, n_rep_out = 2, 2    # + opt_state in and out
    return jax.jit(
        jax.shard_map(
            fn,
            mesh=mesh,
            # replicated leading args (params [, opt_state] + scn + cam),
            # then sharded pixel/target streams and the replicated key
            in_specs=(P(),) * (n_rep_in + 2) + (
                P("pixels"), P("pixels"), P("pixels"), P()),
            out_specs=(P(),) * n_rep_out + (P(),),
            check_vma=False,  # see render_dist.py: bounce-loop carry VMA
        )
    )
