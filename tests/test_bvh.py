"""BVH construction tests: reference-parity divide (shapes/bvh_test.go) and
the flat skip-link builder."""
import numpy as np

import pathtracer.geometry as g
from pathtracer.scene.bounds import BoundingBox, bounds_of
from pathtracer.scene.bvh import (
    build_bvh, divide, partition_children, split_bounds,
)
from pathtracer.scene.shapes import Group, Sphere, Triangle


def test_split_perfect_cube():
    b = BoundingBox.of_floats(-1, -4, -5, 9, 6, 5)  # dx=10 largest
    left, right = split_bounds(b)
    assert np.allclose(left.min[:3], [-1, -4, -5])
    assert np.allclose(left.max[:3], [4, 6, 5])
    assert np.allclose(right.min[:3], [4, -4, -5])
    assert np.allclose(right.max[:3], [9, 6, 5])


def test_split_y_wide():
    b = BoundingBox.of_floats(-1, -2, -3, 3, 7, 3)  # dy=9 largest
    left, right = split_bounds(b)
    assert np.allclose(left.max[:3], [3, 2.5, 3])
    assert np.allclose(right.min[:3], [-1, 2.5, -3])


def test_split_z_wide():
    b = BoundingBox.of_floats(-1, -2, -3, 3, 3, 7)  # dz=10 largest
    left, right = split_bounds(b)
    assert np.allclose(left.max[:3], [3, 3, 2])
    assert np.allclose(right.min[:3], [-1, -2, 2])


def test_partition_children():
    # bvh_test.go: three spheres; two fit halves, one straddles and remains
    s1 = Sphere()
    s1.set_transform(g.translate(-2, 0, 0))
    s2 = Sphere()
    s2.set_transform(g.translate(2, 0, 0))
    s3 = Sphere()
    gr = Group()
    gr.add_children(s1, s2, s3)
    left, right = partition_children(gr)
    assert gr.children == [s3]
    assert left.children == [s1]
    assert right.children == [s2]


def test_divide_below_threshold_recurses_only():
    s1 = Sphere()
    s1.set_transform(g.translate(-2, 0, 0))
    s2 = Sphere()
    s2.set_transform(g.translate(2, 0, 0))
    gr = Group()
    gr.add_children(s1, s2)
    divide(gr, 3)  # threshold > len: no partition at top
    assert gr.children == [s1, s2]


def test_divide_partitions():
    s1 = Sphere()
    s1.set_transform(g.translate(-2, -2, 0))
    s2 = Sphere()
    s2.set_transform(g.translate(-2, 2, 0))
    s3 = Sphere()
    s3.set_transform(g.scale(4, 4, 4))
    gr = Group()
    gr.add_children(s1, s2, s3)
    divide(gr, 1)
    # straddling sphere remains; the others move into subgroups
    assert s3 in gr.children
    subgroups = [c for c in gr.children if isinstance(c, Group)]
    assert len(subgroups) >= 1
    collected = []
    def walk(grp):
        for c in grp.children:
            if isinstance(c, Group):
                walk(c)
            else:
                collected.append(c)
    walk(gr)
    assert set(id(x) for x in collected) == set(id(x) for x in [s1, s2, s3])


def _random_tris(n, seed=0):
    rng = np.random.default_rng(seed)
    tris = []
    for _ in range(n):
        p1 = rng.uniform(-10, 10, 3)
        tris.append(Triangle(
            np.append(p1, 1.0),
            np.append(p1 + rng.uniform(-1, 1, 3), 1.0),
            np.append(p1 + rng.uniform(-1, 1, 3), 1.0),
        ))
    return tris


def test_build_bvh_structure():
    tris = _random_tris(100)
    bvh, root, end = build_bvh(tris, leaf_size=8)
    assert root == 0 and end == bvh.n_nodes
    # skip links: every exit is > own index and <= end
    for i in range(bvh.n_nodes):
        assert bvh.node_exit[i] > i
        assert bvh.node_exit[i] <= end
    # leaves hold every real triangle exactly once
    n_real = 0
    for i in range(bvh.n_nodes):
        if bvh.node_is_leaf[i]:
            s = bvh.node_tri_start[i]
            chunk = bvh.tri_p1[s:s + 8]
            n_real += int(np.sum(np.any(chunk != 0, axis=1)))
    assert n_real == 100
    # parent boxes contain children
    def check(i):
        if bvh.node_is_leaf[i]:
            return i + 1
        j = i + 1
        while j < bvh.node_exit[i]:
            assert np.all(bvh.node_bb_min[i] <= bvh.node_bb_min[j] + 1e-9)
            assert np.all(bvh.node_bb_max[i] >= bvh.node_bb_max[j] - 1e-9)
            j = check(j)
        return j
    check(0)


def test_build_bvh_appends_to_pool():
    t1 = _random_tris(20, seed=1)
    t2 = _random_tris(30, seed=2)
    pool, r1, e1 = build_bvh(t1, leaf_size=8)
    pool, r2, e2 = build_bvh(t2, leaf_size=8, into=pool)
    assert r2 == e1
    assert e2 == pool.n_nodes


def test_build_bvh_snapped_minimum_leaves():
    """The snapped-SAH build must produce the minimum possible tree:
    exactly ceil(N/leaf_size) leaves (every leaf full except at most the
    remainder) and 2*leaves - 1 nodes. This is the property the
    megakernel's packet walk pays for (one while-iteration per visited
    node, fixed-cost leaf unroll)."""
    for n, leaf in ((100, 8), (64, 8), (37, 4), (257, 16)):
        tris = _random_tris(n, seed=n)
        bvh, root, end = build_bvh(tris, leaf_size=leaf)
        n_leaves = int(bvh.node_is_leaf.sum())
        assert n_leaves == -(-n // leaf), (n, leaf, n_leaves)
        assert bvh.n_nodes == 2 * n_leaves - 1
        # slot pool is exactly leaves * leaf_size
        assert bvh.n_tri_slots == n_leaves * leaf


def test_octant_node_orders_equivalent():
    """Each octant copy must be a valid skip-link tree over the same
    leaves, and traversal must find identical nearest hits."""
    import numpy as np

    from pathtracer.scene.bvh import (build_bvh_arrays,
                                          octant_node_orders)

    rng = np.random.default_rng(3)
    n = 200
    p1 = rng.normal(size=(n, 3))
    p2 = p1 + rng.normal(scale=0.2, size=(n, 3))
    p3 = p1 + rng.normal(scale=0.2, size=(n, 3))
    nrm = np.zeros((n, 3))
    col = np.ones((n, 3))
    pool, root, end = build_bvh_arrays(p1, p2, p3, nrm, nrm, nrm, col,
                                       leaf_size=8)
    nn = pool.n_nodes
    pool9 = octant_node_orders(pool, [(root, end)])
    assert pool9.node_bb_min.shape[0] == 9 * nn
    # copy 0 is the original
    np.testing.assert_array_equal(pool9.node_exit[:nn], pool.node_exit)
    np.testing.assert_array_equal(pool9.node_bb_min[:nn],
                                  pool.node_bb_min)

    def walk(o, d, base):
        """Skip-link walk collecting candidate leaf tri_starts in visit
        order; returns the nearest brute-force hit among visited leaves
        (must equal the global brute-force nearest for ANY valid tree)."""
        bmin = pool9.node_bb_min
        bmax = pool9.node_bb_max
        leaf = pool9.node_is_leaf
        ex = pool9.node_exit
        st = pool9.node_tri_start
        idx = base + root
        stop = base + end
        starts = []
        while idx < stop:
            inv = 1.0 / np.where(np.abs(d) > 1e-12, d, 1e-12)
            t1 = (bmin[idx] - o) * inv
            t2 = (bmax[idx] - o) * inv
            tmin = np.minimum(t1, t2).max()
            tmax = np.maximum(t1, t2).min()
            hit = tmin <= tmax and tmax > 1e-4
            if hit and leaf[idx]:
                starts.append(int(st[idx]))
            idx = idx + 1 if hit else int(ex[idx])
        return sorted(starts)

    for trial in range(8):
        o = rng.normal(size=3) * 3
        d = rng.normal(size=3)
        d /= np.linalg.norm(d)
        base_starts = walk(o, d, 0)
        for k in range(1, 9):
            assert walk(o, d, k * nn) == base_starts, (trial, k)


def test_pt_bvh_leaf_env_override(monkeypatch):
    """PT_BVH_LEAF overrides the packed leaf size (hardware leaf-size
    A/Bs drive bench.py/CLI without code edits)."""
    from pathtracer.config import RenderConfig
    from pathtracer.scenes import get_scene

    cfg = RenderConfig(width=16, height=12, samples=1, samples_per_pass=1)
    sc = get_scene("teapot", cfg)
    monkeypatch.setenv("PT_BVH_LEAF", "64")
    _, meta = sc.pack()
    assert meta.leaf_size == 64
    monkeypatch.delenv("PT_BVH_LEAF")
    _, meta2 = sc.pack()
    assert meta2.leaf_size == 8  # default
