"""Differentiable-render tests: pathwise gradients vs finite differences,
and the sharded training step."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pathtracer.config import RenderConfig
from pathtracer.diff import (
    apply_params, extract_params, image_loss, make_sharded_train_step,
    render_image_diff, train_step,
)
from pathtracer.render.vec3 import Vec3
from pathtracer.parallel import make_mesh
from pathtracer.scene.pack import pack_scene
from pathtracer.scenes import get_scene


@pytest.fixture(scope="module")
def setup():
    cfg = RenderConfig(width=16, height=12, samples=4, samples_per_pass=4)
    sc = get_scene("reference", cfg)
    arrays, meta = pack_scene(sc.objects)
    cam = sc.camera.pack()
    ys, xs = np.mgrid[0:12, 0:16]
    px = jnp.asarray(xs.ravel(), jnp.int32)
    py = jnp.asarray(ys.ravel(), jnp.int32)
    return cfg, arrays, meta, cam, px, py


def test_grad_exists_and_matches_finite_difference(setup):
    cfg, arrays, meta, cam, px, py = setup
    params = extract_params(arrays)
    key = jax.random.PRNGKey(3)

    target = Vec3.zeros((px.shape[0],))
    loss_fn = jax.jit(lambda p: image_loss(
        p, arrays, meta, cfg, cam, px, py, key, 4, target))
    grads = jax.jit(jax.grad(lambda p: image_loss(
        p, arrays, meta, cfg, cam, px, py, key, 4, target)))(params)

    g_em = np.asarray(grads.emission)
    assert np.isfinite(g_em).all()
    # the light (object 0) emission must have nonzero gradient
    assert np.abs(g_em[0]).max() > 0

    # finite differences on the light's red emission channel; the RNG is
    # frozen by the fixed key, so the estimator is deterministic in params
    eps = 1e-2
    e = np.asarray(params.emission)
    p_plus = params._replace(emission=jnp.asarray(e).at[0, 0].add(eps))
    p_minus = params._replace(emission=jnp.asarray(e).at[0, 0].add(-eps))
    fd = (float(loss_fn(p_plus)) - float(loss_fn(p_minus))) / (2 * eps)
    ad = float(g_em[0, 0])
    assert np.isclose(ad, fd, rtol=5e-2, atol=1e-6), (ad, fd)


def test_grad_color_finite_difference(setup):
    cfg, arrays, meta, cam, px, py = setup
    params = extract_params(arrays)
    key = jax.random.PRNGKey(5)
    target = Vec3.full((px.shape[0],), 0.5, 0.5, 0.5)

    loss_fn = jax.jit(lambda p: image_loss(
        p, arrays, meta, cfg, cam, px, py, key, 4, target))
    grads = jax.jit(jax.grad(lambda p: image_loss(
        p, arrays, meta, cfg, cam, px, py, key, 4, target)))(params)
    # floor (object 1) color gradient
    g = float(np.asarray(grads.color)[1, 0])
    eps = 1e-2
    c = np.asarray(params.color)
    fd = (
        float(loss_fn(params._replace(color=jnp.asarray(c).at[1, 0].add(eps))))
        - float(loss_fn(params._replace(color=jnp.asarray(c).at[1, 0].add(-eps))))
    ) / (2 * eps)
    assert np.isclose(g, fd, rtol=5e-2, atol=1e-6), (g, fd)


def test_train_step_descends(setup):
    cfg, arrays, meta, cam, px, py = setup
    params = extract_params(arrays)
    key = jax.random.PRNGKey(0)
    # target: darker image -> loss should fall as emission shrinks
    target = Vec3.zeros((px.shape[0],))
    step = jax.jit(lambda p, k: train_step(
        p, arrays, meta, cfg, cam, px, py, k, 4, target, lr=0.1))
    p, loss0 = step(params, key)
    for i in range(4):
        p, loss = step(p, jax.random.fold_in(key, i + 10))
    assert float(loss) < float(loss0)


def test_sharded_train_step(setup):
    cfg, arrays, meta, cam, px, py = setup
    mesh = make_mesh()  # (4, 2) on the 8-device CPU mesh
    params = extract_params(arrays)
    step = make_sharded_train_step(mesh, meta, cfg, n_samples=4, lr=0.1)
    P = px.shape[0]
    pad = (-P) % mesh.shape["pixels"]
    pxp = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
    pyp = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
    target = Vec3.zeros((P + pad,))
    new_params, loss = step(
        params, arrays, cam, pxp, pyp, target, jax.random.PRNGKey(0),
    )
    assert np.isfinite(float(loss))
    # params actually moved
    assert not np.allclose(np.asarray(new_params.emission),
                           np.asarray(params.emission))


def test_sharded_train_step_optax(setup):
    """Distributed step with an optax optimizer: opt_state threads through
    and adam actually converges the loss over a few steps."""
    import optax

    cfg, arrays, meta, cam, px, py = setup
    mesh = make_mesh()
    params = extract_params(arrays)
    opt = optax.adam(0.05)
    opt_state = opt.init(params)
    step = make_sharded_train_step(mesh, meta, cfg, n_samples=4,
                                   optimizer=opt)
    P = px.shape[0]
    pad = (-P) % mesh.shape["pixels"]
    pxp = jnp.concatenate([px, jnp.zeros(pad, px.dtype)])
    pyp = jnp.concatenate([py, jnp.zeros(pad, py.dtype)])
    target = Vec3.zeros((P + pad,))

    losses = []
    key = jax.random.PRNGKey(0)
    for i in range(5):
        params, opt_state, loss = step(
            params, opt_state, arrays, cam, pxp, pyp, target,
            jax.random.fold_in(key, i),
        )
        losses.append(float(loss))
    assert all(np.isfinite(losses))
    # adam on a black target must darken the scene monotonically-ish
    assert losses[-1] < losses[0] * 0.9, losses


def test_train_state_checkpoint_roundtrip(setup, tmp_path):
    """Train-state save/restore: params + adam opt_state round-trip
    bit-exactly and training resumes from the restored state."""
    import optax

    from pathtracer.diff.checkpoint import (
        restore_train_state, save_train_state,
    )

    cfg, arrays, meta, cam, px, py = setup
    params = extract_params(arrays)
    opt = optax.adam(0.05)
    opt_state = opt.init(params)

    # advance one step so the state is non-trivial
    target = Vec3.zeros((px.shape[0],))
    loss, grads = jax.value_and_grad(image_loss)(
        params, arrays, meta, cfg, cam, px, py, jax.random.PRNGKey(0), 2,
        target)
    updates, opt_state = opt.update(grads, opt_state, params)
    params = optax.apply_updates(params, updates)

    ckdir = str(tmp_path / "train_ck")
    save_train_state(ckdir, step=7, params=params, opt_state=opt_state)

    fresh_p = extract_params(arrays)
    fresh_o = opt.init(fresh_p)
    step, p2, o2 = restore_train_state(ckdir, fresh_p, fresh_o)
    assert step == 7
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for a, b in zip(jax.tree.leaves(opt_state), jax.tree.leaves(o2)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_npz_train_checkpoint_roundtrip(tmp_path):
    """The .npz train-state checkpoint: an adam state tree round-trips
    bit-exactly (dtypes included), latest-step restore, and only the
    newest max_to_keep steps stay on disk."""
    import optax

    from pathtracer.diff.checkpoint import (
        restore_train_state, save_train_state,
    )

    params = {"a": jnp.arange(6.0).reshape(2, 3),
              "b": jnp.asarray([1, 2], jnp.int32)}
    opt = optax.adam(0.1)
    state = opt.init(params)
    ck = str(tmp_path / "ck")
    for step in (1, 2, 3, 4):
        p = jax.tree.map(lambda x: x * step, params)
        save_train_state(ck, step, p, state, max_to_keep=2)
    assert sorted(os.listdir(ck)) == ["step_00000003.npz",
                                      "step_00000004.npz"]
    step, p2, s2 = restore_train_state(ck, params, opt.init(params))
    assert step == 4
    for x, y in zip(jax.tree.leaves(p2),
                    jax.tree.leaves(jax.tree.map(lambda x: x * 4, params))):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    for x, y in zip(jax.tree.leaves(s2), jax.tree.leaves(state)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    step3, p3, _ = restore_train_state(ck, params, step=3)
    assert step3 == 3
    np.testing.assert_array_equal(np.asarray(p3["a"]),
                                  np.asarray(params["a"]) * 3)


def test_npz_train_checkpoint_rejects_mismatch(tmp_path):
    from pathtracer.diff.checkpoint import (
        restore_train_state, save_train_state,
    )

    ck = str(tmp_path / "ck")
    with pytest.raises(FileNotFoundError):
        restore_train_state(ck, {"a": jnp.zeros(2)})
    save_train_state(ck, 1, {"a": jnp.zeros(2)})
    with pytest.raises(ValueError, match="shape"):
        restore_train_state(ck, {"a": jnp.zeros(3)})
    with pytest.raises(ValueError, match="leaves"):
        restore_train_state(ck, {"a": jnp.zeros(2), "b": jnp.zeros(2)})
