"""ctypes bindings for the native scene-core (native/scenecore.cpp).

The native library accelerates the host-side scene pipeline — OBJ parsing,
vertex-normal computation, flat BVH construction — the role the reference
fills with its Go host code + C AVX2 intrinsics (cfiles/, geom/*_amd64.s).
Pure-Python implementations in scene/{objfile,bvh}.py remain the portable
fallback; `available()` gates every call site.

Set PT_NATIVE=0 to force the Python path (used by the parity tests).
"""
from __future__ import annotations

import ctypes as ct
import logging
import os
import subprocess
from typing import List, Optional, Tuple

import numpy as np

log = logging.getLogger("pathtracer")

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_LIB_PATH = os.path.join(_REPO_ROOT, "native", "libscenecore.so")

_lib = None
_tried = False

_f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load() -> Optional[ct.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if os.environ.get("PT_NATIVE") == "0":
        return None
    if not os.path.exists(_LIB_PATH):
        # best-effort build (g++ is in the image); stay silent on failure
        try:
            subprocess.run(
                ["make", "-C", os.path.dirname(_LIB_PATH)],
                capture_output=True, timeout=120, check=True,
            )
        except Exception:
            return None
    try:
        lib = ct.CDLL(_LIB_PATH)
    except OSError:
        return None

    lib.sc_parse_obj.restype = ct.c_void_p
    lib.sc_parse_obj.argtypes = [
        ct.c_char_p, ct.c_char_p, _f64p, _f64p, ct.c_int, ct.c_int]
    lib.sc_obj_counts.argtypes = [ct.c_void_p] + [ct.POINTER(ct.c_int)] * 4
    lib.sc_obj_group_names.argtypes = [ct.c_void_p, ct.c_char_p]
    lib.sc_obj_tris.argtypes = [ct.c_void_p] + [_f64p] * 9 + [_i32p]
    lib.sc_obj_free.argtypes = [ct.c_void_p]

    lib.sc_build_bvh.restype = ct.c_void_p
    lib.sc_build_bvh.argtypes = [_f64p, _f64p, _f64p, ct.c_int, ct.c_int]
    lib.sc_bvh_counts.argtypes = [ct.c_void_p] + [ct.POINTER(ct.c_int)] * 2
    lib.sc_bvh_nodes.argtypes = [ct.c_void_p, _f64p, _f64p, _i32p, _i32p,
                                 _i32p]
    lib.sc_bvh_slots.argtypes = [ct.c_void_p, _i32p]
    lib.sc_bvh_free.argtypes = [ct.c_void_p]

    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


class ObjData:
    """Triangle-soup result of the native OBJ parse (arrays, not objects)."""

    def __init__(self, p1, p2, p3, n1, n2, n3, face_n, color, refr,
                 group_id, group_names, ignored_lines):
        self.p1, self.p2, self.p3 = p1, p2, p3
        self.n1, self.n2, self.n3 = n1, n2, n3
        self.face_n = face_n
        self.color = color
        self.refr = refr
        self.group_id = group_id
        self.group_names: List[str] = group_names
        self.ignored_lines = ignored_lines

    @property
    def n_tris(self) -> int:
        return self.p1.shape[0]


def parse_obj(text: str, mtl: Optional[dict] = None,
              compute_normals: bool = False) -> Optional[ObjData]:
    """Parse .obj text natively. `mtl` maps material name -> Mtl (already
    parsed in Python — it owns file IO); colors are resolved like
    Mtl.to_material (Ka+Kd+Ks summed, objparser.go:181-196)."""
    lib = _load()
    assert lib is not None, "native scenecore unavailable"

    names: List[str] = []
    colors = np.zeros((max(1, len(mtl or {})), 3), dtype=np.float64)
    refrs = np.ones(max(1, len(mtl or {})), dtype=np.float64)
    if mtl:
        for i, (name, m) in enumerate(mtl.items()):
            names.append(name)
            colors[i] = [
                m.ambient[0] + m.diffuse[0] + m.specular[0],
                m.ambient[1] + m.diffuse[1] + m.specular[1],
                m.ambient[2] + m.diffuse[2] + m.specular[2],
            ]
            refrs[i] = m.refractive_index

    h = lib.sc_parse_obj(
        text.encode(), "\n".join(names).encode(), colors, refrs,
        len(names), 1 if compute_normals else 0,
    )
    if not h:
        # the C side returns NULL instead of letting an exception cross
        # the ctypes boundary; callers fall back to the Python parser
        return None
    try:
        n_tris = ct.c_int()
        n_groups = ct.c_int()
        names_len = ct.c_int()
        ignored = ct.c_int()
        lib.sc_obj_counts(h, ct.byref(n_tris), ct.byref(n_groups),
                          ct.byref(names_len), ct.byref(ignored))
        n = n_tris.value
        mk = lambda: np.empty((n, 3), dtype=np.float64)
        p1, p2, p3, n1, n2, n3, fn, col = (mk() for _ in range(8))
        refr = np.empty(n, dtype=np.float64)
        gid = np.empty(n, dtype=np.int32)
        if n:
            lib.sc_obj_tris(h, p1, p2, p3, n1, n2, n3, fn, col, refr, gid)
        buf = ct.create_string_buffer(names_len.value + 1)
        lib.sc_obj_group_names(h, buf)
        group_names = buf.value.decode().split("\n")[:n_groups.value]
        return ObjData(p1, p2, p3, n1, n2, n3, fn, col, refr, gid,
                       group_names, ignored.value)
    finally:
        lib.sc_obj_free(h)


def build_bvh(p1: np.ndarray, p2: np.ndarray, p3: np.ndarray,
              leaf_size: int = 8
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray,
                         np.ndarray, np.ndarray]:
    """Native flat skip-link BVH over triangle positions.

    Returns (bb_min[Nn,3], bb_max[Nn,3], tri_start[Nn], is_leaf[Nn],
    exit[Nn], slots[Ns]) with slots = triangle ids, -1 for leaf padding.
    Exit links and tri_start are local (0-based); the caller rebases.
    """
    lib = _load()
    assert lib is not None, "native scenecore unavailable"
    p1 = np.ascontiguousarray(p1, dtype=np.float64)
    p2 = np.ascontiguousarray(p2, dtype=np.float64)
    p3 = np.ascontiguousarray(p3, dtype=np.float64)
    h = lib.sc_build_bvh(p1, p2, p3, p1.shape[0], leaf_size)
    try:
        n_nodes = ct.c_int()
        n_slots = ct.c_int()
        lib.sc_bvh_counts(h, ct.byref(n_nodes), ct.byref(n_slots))
        nn, ns = n_nodes.value, n_slots.value
        bb_min = np.empty((nn, 3), dtype=np.float64)
        bb_max = np.empty((nn, 3), dtype=np.float64)
        tri_start = np.empty(nn, dtype=np.int32)
        is_leaf = np.empty(nn, dtype=np.int32)
        exit_idx = np.empty(nn, dtype=np.int32)
        slots = np.empty(ns, dtype=np.int32)
        lib.sc_bvh_nodes(h, bb_min, bb_max, tri_start, is_leaf, exit_idx)
        lib.sc_bvh_slots(h, slots)
        return bb_min, bb_max, tri_start, is_leaf, exit_idx, slots
    finally:
        lib.sc_bvh_free(h)
