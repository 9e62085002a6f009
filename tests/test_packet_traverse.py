"""Direct interpret-mode validation of the megakernel's BVH walk.

`_packet_traverse` (one node pointer per block) in
render/pallas_kernel.py finds each ray's closest triangle with the
dual-basis test; `_tri_payload` then fetches the winning slot's smooth
normal and color. The walk is PRNG-free, so this file drives it directly in an interpret-mode pallas_call (the kernel's
own Triton route) on the CPU and checks every ray against a brute-force
numpy Möller–Trumbore oracle (reference equations,
internal/ocl/tracer.cl:640-674).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from pathtracer.config import RenderConfig
from pathtracer.render import pallas_kernel as pk
from pathtracer.scenes import get_scene


@functools.lru_cache(maxsize=1)
def _teapot():
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    sc = get_scene("teapot", cfg)
    arrays, meta = sc.pack()
    return cfg, arrays, meta


def _traverse_interpret(meta, cfg, tables, rays, block=128):
    """One interpret-mode pallas_call around the BVH walk + payload
    fetch. Returns (t, slot, nx, ny, nz, cr, cg, cb) per ray."""
    (j, root, end), = meta.group_bvh
    n = rays[0].shape[0]

    def kernel(node_ref, tri_ref, ox, oy, oz, dx, dy, dz, *outs):
        o = (ox[...], oy[...], oz[...])
        d = (dx[...], dy[...], dz[...])
        bt0 = jnp.full(o[0].shape, pk._BIG, jnp.float32)
        act = jnp.ones(o[0].shape, jnp.bool_)
        t, slot, u, v = pk._packet_traverse(
            node_ref, tri_ref, meta, root, end, cfg.epsilon, cfg.t_max,
            *o, *d, act, bt0)
        nrm, col = pk._tri_payload(tri_ref, meta, slot, u, v)
        for ref, val in zip(outs, (t, slot) + nrm + col):
            ref[...] = val

    whole = lambda a: pl.BlockSpec(a.shape, lambda i: (0,))
    ray = pl.BlockSpec((block,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((n,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    _, nodes, tris = tables
    outs = pl.pallas_call(
        kernel,
        grid=(n // block,),
        in_specs=[whole(nodes), whole(tris)] + [ray] * 6,
        out_specs=[ray] * 8,
        out_shape=[f32, i32] + [f32] * 6,
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=1),
        interpret=True,
    )(nodes, tris, *rays)
    return [np.asarray(o) for o in outs]


def _brute_force(arrays, eps, o, d):
    """Closest-hit oracle: Möller–Trumbore over every real triangle."""
    p1 = np.asarray(arrays.tri_p1, np.float32)
    e1 = np.asarray(arrays.tri_e1, np.float32)
    e2 = np.asarray(arrays.tri_e2, np.float32)
    best_t = np.full(o.shape[0], pk._BIG, np.float32)
    best_i = np.full(o.shape[0], -1, np.int64)
    for i in range(p1.shape[0]):
        dxe2 = np.cross(d, e2[i])
        det = dxe2 @ e1[i]
        ok = np.abs(det) >= eps
        f = 1.0 / np.where(ok, det, 1.0)
        p = o - p1[i]
        u = f * (p * dxe2).sum(1)
        q = np.cross(p, e1[i])
        v = f * (q * d).sum(1)
        t = f * (q @ e2[i])
        hit = ok & (u >= 0) & (v >= 0) & (u + v <= 1) & (t > eps) \
            & (t < best_t)
        best_t = np.where(hit, t, best_t)
        best_i = np.where(hit, i, best_i)
    return best_t, best_i


def _rays_toward_mesh(arrays, n, seed=0):
    """Random rays aimed into the mesh bounding box (plus some misses)."""
    rng = np.random.default_rng(seed)
    lo = np.asarray(arrays.node_bb_min).min(axis=0)
    hi = np.asarray(arrays.node_bb_max).max(axis=0)
    center = (lo + hi) / 2
    span = (hi - lo).max()
    o = center + rng.normal(size=(n, 3)) * span * 1.5
    tgt = lo + rng.random((n, 3)) * (hi - lo)
    # last quarter aims away from the box: guaranteed misses
    miss = np.arange(n) >= (3 * n) // 4
    d = np.where(miss[:, None], o - center, tgt - o)
    d = d / np.linalg.norm(d, axis=1, keepdims=True)
    return o.astype(np.float32), d.astype(np.float32)


def _as_rays(o, d):
    return [jnp.asarray(np.ascontiguousarray(x)) for x in
            (o[:, 0], o[:, 1], o[:, 2], d[:, 0], d[:, 1], d[:, 2])]


@pytest.mark.parametrize("block", [64, 256])
def test_packet_traverse_matches_brute_force(block):
    cfg, arrays, meta = _teapot()
    n = 512
    o, d = _rays_toward_mesh(arrays, n, seed=block)
    tables = pk.scene_tables(arrays, meta)
    t, slot, nx, ny, nz, cr, cg, cb = _traverse_interpret(
        meta, cfg, tables, _as_rays(o, d), block)

    bt, bi = _brute_force(arrays, cfg.epsilon, o, d)
    hit = bi >= 0

    # same hit/miss classification and same closest t
    assert np.array_equal(t < pk._BIG, hit)
    assert np.array_equal(slot >= 0, hit)
    np.testing.assert_allclose(t[hit], bt[hit], rtol=2e-4, atol=2e-5)
    assert hit.sum() > n // 4          # the aimed rays actually hit

    # interpolated smooth normals are unit-ish and colors match the pool
    nrm = np.stack([nx, ny, nz], 1)[hit]
    ln = np.linalg.norm(nrm, axis=1)
    assert (np.abs(ln - 1.0) < 0.1).mean() > 0.99
    cols = np.stack([cr, cg, cb], 1)[hit]
    pool_cols = np.asarray(arrays.tri_color, np.float32)[bi[hit]]
    np.testing.assert_allclose(cols, pool_cols, atol=1e-6)


def test_packet_traverse_slot_tracking():
    """The walk reports the winning global triangle slot (the payload
    fetch keys on it): validated against the brute-force oracle's argmin
    index (ties — rays whose two closest triangles are ULP-level equal —
    are accepted when the reported slot's own Möller–Trumbore t equals
    the oracle's best t). Per-slot colors are read (uniform elision
    off)."""
    cfg, arrays, meta = _teapot()
    meta = dataclasses.replace(meta, tri_uniform_color=None)
    o, d = _rays_toward_mesh(arrays, 512, seed=5)
    t, sl, *_ = _traverse_interpret(
        meta, cfg, pk.scene_tables(arrays, meta), _as_rays(o, d))
    sl = sl.astype(np.int64)

    bt, bi = _brute_force(arrays, cfg.epsilon, o, d)
    hit = bi >= 0
    assert np.array_equal(sl >= 0, hit)
    exact = sl[hit] == bi[hit]
    assert exact.mean() > 0.95

    # non-exact slots must still be genuine closest hits (ties): the
    # reported slot's own triangle yields the oracle's best t
    if (~exact).any():
        p1 = np.asarray(arrays.tri_p1, np.float32)
        e1 = np.asarray(arrays.tri_e1, np.float32)
        e2 = np.asarray(arrays.tri_e2, np.float32)
        idx = np.flatnonzero(hit)[~exact]
        for i in idx:
            s = sl[i]
            dxe2 = np.cross(d[i], e2[s])
            det = dxe2 @ e1[s]
            q = np.cross(o[i] - p1[s], e1[s])
            t_s = (q @ e2[s]) / det
            assert abs(t_s - bt[i]) <= 2e-4 * max(abs(bt[i]), 1.0), (
                i, s, bi[i], t_s, bt[i])


def test_uniform_color_detection():
    """teapot is single-material -> static color elision kicks in; the
    mixed-color `default` group scene must keep per-tri colors."""
    _, _, meta = _teapot()
    assert meta.tri_uniform_color is not None
    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    sc = get_scene("default", cfg)
    a2, m2 = sc.pack()
    # the field must be consistent with the REAL (non-padding) pool
    # colors; padding slots are degenerate and never hit, so they don't
    # constrain uniformity
    ng = np.cross(np.asarray(a2.tri_e1), np.asarray(a2.tri_e2))
    cols = np.asarray(a2.tri_color)[(ng * ng).sum(1) > 0]
    uniform = bool((cols == cols[0]).all())
    assert (m2.tri_uniform_color is not None) == uniform
    if uniform:
        assert m2.tri_uniform_color == tuple(float(c) for c in cols[0])


def test_octant_copy_parity():
    """Walking from the blocks' octant node copies must produce the same
    hits as the original order (front-to-back reordering changes visit
    order, not the result), whatever octant the block majority picks."""
    cfg, arrays, meta = _teapot()
    if not meta.octant_orders:
        pytest.skip("no octant copies packed")
    o, d = _rays_toward_mesh(arrays, 256, seed=9)
    tables = pk.scene_tables(arrays, meta)
    plain = dataclasses.replace(meta, octant_orders=False)
    t0 = _traverse_interpret(plain, cfg, tables, _as_rays(o, d))[0]
    for block in (32, 256):
        t = _traverse_interpret(meta, cfg, tables, _as_rays(o, d), block)[0]
        np.testing.assert_allclose(t, t0, rtol=1e-6, atol=1e-7)
