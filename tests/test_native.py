"""Native scene-core (native/scenecore.cpp) vs pure-Python parity.

The native OBJ parser / vertex-normal pass / BVH builder must produce
bit-identical arrays to the Python implementations they accelerate
(scene/objfile.py, scene/bvh.py) — same split decisions, same DFS
emission order, same slot padding.
"""
import numpy as np
import pytest

from pathtracer import native
from pathtracer.assets import goblet_obj, uv_sphere_obj
from pathtracer.scene.bvh import build_bvh_arrays, empty_bvh
from pathtracer.scene.objfile import compute_vertex_normals, parse_obj

pytestmark = pytest.mark.skipif(
    not native.available(), reason="native scenecore not built"
)


def _python_soup(text, compute_normals):
    model = parse_obj(text)
    tris = model.all_triangles()
    if compute_normals:
        compute_vertex_normals(tris)
    g = lambda f: np.stack([f(t)[:3] for t in tris])
    return (g(lambda t: t.p1), g(lambda t: t.p2), g(lambda t: t.p3),
            g(lambda t: t.n1), g(lambda t: t.n2), g(lambda t: t.n3),
            g(lambda t: np.asarray(t.material.color)))


@pytest.mark.parametrize("maker,normals", [
    (uv_sphere_obj, True),
    (goblet_obj, True),
    (uv_sphere_obj, False),
])
def test_parse_obj_matches_python(maker, normals):
    text = maker()
    nat = native.parse_obj(text, compute_normals=normals)
    p1, p2, p3, n1, n2, n3, color = _python_soup(text, normals)

    assert nat.n_tris == p1.shape[0]
    np.testing.assert_array_equal(nat.p1, p1)
    np.testing.assert_array_equal(nat.p2, p2)
    np.testing.assert_array_equal(nat.p3, p3)
    np.testing.assert_allclose(nat.n1, n1, atol=1e-12)
    np.testing.assert_allclose(nat.n2, n2, atol=1e-12)
    np.testing.assert_allclose(nat.n3, n3, atol=1e-12)
    np.testing.assert_array_equal(nat.color, color)


def test_parse_real_gopher_if_present():
    from pathtracer.assets import find_asset
    from pathtracer.scene.objfile import parse_mtl

    path = find_asset("gopher.obj")
    if path is None:
        pytest.skip("gopher.obj not in asset path")
    import os
    with open(path) as f:
        text = f.read()
    with open(os.path.join(os.path.dirname(path), "gopher.mtl")) as f:
        mtl = parse_mtl(f.read())

    nat = native.parse_obj(text, mtl=mtl)
    model = parse_obj(text, mtl_dir=os.path.dirname(path))
    tris = model.all_triangles()
    assert nat.n_tris == len(tris)
    color = np.stack([np.asarray(t.material.color)[:3] for t in tris])
    np.testing.assert_allclose(nat.color, color, atol=1e-12)
    # gopher.obj carries vn records — smooth normals must round-trip
    n1 = np.stack([t.n1[:3] for t in tris])
    np.testing.assert_array_equal(nat.n1, n1)


def test_bvh_native_matches_python():
    text = uv_sphere_obj(n_lat=12, n_lon=16)
    nat = native.parse_obj(text, compute_normals=True)

    import os
    os.environ["PT_NATIVE"] = "0"
    try:
        # force the python emit inside build_bvh_arrays
        native._lib_saved = native._lib
        native._lib = None
        native._tried = True
        py_pool, py_root, py_end = build_bvh_arrays(
            nat.p1, nat.p2, nat.p3, nat.n1, nat.n2, nat.n3, nat.color,
            leaf_size=8, into=empty_bvh(8))
    finally:
        native._lib = native._lib_saved
        del os.environ["PT_NATIVE"]

    nat_pool, nat_root, nat_end = build_bvh_arrays(
        nat.p1, nat.p2, nat.p3, nat.n1, nat.n2, nat.n3, nat.color,
        leaf_size=8, into=empty_bvh(8))

    assert (py_root, py_end) == (nat_root, nat_end)
    np.testing.assert_array_equal(py_pool.node_is_leaf, nat_pool.node_is_leaf)
    np.testing.assert_array_equal(py_pool.node_exit, nat_pool.node_exit)
    np.testing.assert_array_equal(py_pool.node_tri_start,
                                  nat_pool.node_tri_start)
    np.testing.assert_allclose(py_pool.node_bb_min, nat_pool.node_bb_min)
    np.testing.assert_allclose(py_pool.node_bb_max, nat_pool.node_bb_max)
    np.testing.assert_array_equal(py_pool.tri_p1, nat_pool.tri_p1)
    np.testing.assert_array_equal(py_pool.tri_e1, nat_pool.tri_e1)
    np.testing.assert_array_equal(py_pool.tri_color, nat_pool.tri_color)


def test_parse_obj_negative_indices_resolve_relative():
    """OBJ-legal negative indices resolve relative to the current vertex
    count (the Python parser gets this for free from list[-k])."""
    text = "\n".join([
        "v 0 0 0",
        "v 1 0 0",
        "v 0 1 0",
        "f -3 -2 -1",
    ])
    nat = native.parse_obj(text)
    assert nat is not None and nat.n_tris == 1
    py = parse_obj(text).all_triangles()
    np.testing.assert_array_equal(nat.p1[0], py[0].p1[:3])
    np.testing.assert_array_equal(nat.p3[0], py[0].p3[:3])


def test_parse_obj_pathological_input_does_not_crash():
    """Out-of-range indices, malformed numbers, and junk must not read out
    of bounds or throw across the ctypes boundary — bad faces/lines are
    dropped and counted as ignored."""
    text = "\n".join([
        "v 0 0 0",
        "v 1 0 0",
        "v 0 1 0",
        "f 1 2 3",          # good
        "f 1 2 99",         # out-of-range vertex
        "f 0 1 2",          # 0 is the placeholder slot (illegal in OBJ)
        "f 1 2 xyz",        # malformed integer
        "v a b c",          # malformed floats
        "f -99 1 2",        # negative out of range
        "f 1//1 2//9 3//1",  # normal index out of range -> face normal
    ])
    nat = native.parse_obj(text)
    assert nat is not None
    # the good face plus the face whose bad normal falls back to face-n
    assert nat.n_tris == 2
    assert nat.ignored_lines >= 5
    np.testing.assert_allclose(nat.n1[1], nat.face_n[1], atol=1e-12)
