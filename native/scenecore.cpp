// scenecore: native scene-build pipeline (OBJ parse, vertex normals,
// flat skip-link BVH).
//
// Counterpart of the reference's host-side native layer: where
// the reference accelerates host math with C AVX2 intrinsics compiled to
// PLAN9 asm (cfiles/*.c, Makefile:15-36) and builds its scene buffers in
// Go (internal/ocl/scene.go, internal/app/obj/objparser.go,
// internal/app/shapes/bvh.go), this library does the heavy scene
// construction natively and hands padded arrays straight to the packer.
// Algorithms are semantically identical to the Python implementations in
// pathtracer/scene/{objfile,bvh}.py (which remain as the portable
// fallback and as the parity oracle in tests/test_native.py).
//
// Build: make -C native   (g++ -O3 -shared -fPIC)
// Binding: ctypes (pathtracer/native.py) — no pybind11 dependency.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <memory>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct V3 {
  double x = 0, y = 0, z = 0;
};

static inline V3 sub(const V3 &a, const V3 &b) {
  return {a.x - b.x, a.y - b.y, a.z - b.z};
}
static inline V3 cross(const V3 &a, const V3 &b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z,
          a.x * b.y - a.y * b.x};
}
static inline double norm(const V3 &a) {
  return std::sqrt(a.x * a.x + a.y * a.y + a.z * a.z);
}
static inline V3 normalized(const V3 &a) {
  double m = norm(a);
  if (m <= 0.0) return a;
  return {a.x / m, a.y / m, a.z / m};
}

struct Tri {
  V3 p1, p2, p3;     // positions
  V3 n1, n2, n3;     // vertex normals (face normal if absent)
  V3 face_n;         // normalize(cross(e2, e1)) — reference triangle.go:36
  V3 color{1, 1, 1};
  double refr = 1.0;
  int group_id = 0;
};

struct Obj {
  std::vector<Tri> tris;
  std::vector<std::string> group_names;
  int ignored_lines = 0;
};

// position hash key: raw bit pattern of (x, y, z), matching the Python
// implementation's tobytes() key (objfile.py compute_vertex_normals)
struct PosKey {
  uint64_t a, b, c;
  bool operator==(const PosKey &o) const {
    return a == o.a && b == o.b && c == o.c;
  }
};
struct PosKeyHash {
  size_t operator()(const PosKey &k) const {
    uint64_t h = 1469598103934665603ull;
    for (uint64_t v : {k.a, k.b, k.c}) {
      h ^= v;
      h *= 1099511628211ull;
    }
    return static_cast<size_t>(h);
  }
};
static inline PosKey key_of(const V3 &p) {
  PosKey k;
  std::memcpy(&k.a, &p.x, 8);
  std::memcpy(&k.b, &p.y, 8);
  std::memcpy(&k.c, &p.z, 8);
  return k;
}

// --------------------------------------------------------------------
// OBJ parsing (semantics of objfile.py parse_obj / objparser.go:13-135)
// --------------------------------------------------------------------

struct Cursor {
  const char *p, *end;
};

static bool next_line(Cursor &c, const char *&b, const char *&e) {
  if (c.p >= c.end) return false;
  b = c.p;
  const char *nl = static_cast<const char *>(
      std::memchr(c.p, '\n', static_cast<size_t>(c.end - c.p)));
  e = nl ? nl : c.end;
  c.p = nl ? nl + 1 : c.end;
  return true;
}

static void split_fields(const char *b, const char *e,
                         std::vector<std::string> &out) {
  out.clear();
  const char *p = b;
  while (p < e) {
    while (p < e && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
    const char *s = p;
    while (p < e && *p != ' ' && *p != '\t' && *p != '\r') ++p;
    if (p > s) out.emplace_back(s, p);
  }
}

// Non-throwing numeric parsing: std::stod/stoi throw on malformed input
// and the exception would cross the extern "C"/ctypes boundary
// (std::terminate). Malformed fields make the line an ignored_line
// instead, like any other unrecognized content.
static bool parse_d(const std::string &s, double &out) {
  char *e = nullptr;
  out = std::strtod(s.c_str(), &e);
  return e != s.c_str();
}
static bool parse_l(const std::string &s, long &out) {
  char *e = nullptr;
  out = std::strtol(s.c_str(), &e, 10);
  return e != s.c_str();
}
// OBJ indices are 1-based; negative indices are OBJ-legal and relative
// to the current end of the list (the Python parser gets this for free
// from list[-k]). Returns 0 on out-of-range (callers treat 0 as bad —
// slot 0 is the placeholder, objparser.go:22-23).
static size_t resolve_index(long idx, size_t size) {
  if (idx < 0) idx += static_cast<long>(size);
  if (idx <= 0 || idx >= static_cast<long>(size)) return 0;
  return static_cast<size_t>(idx);
}

Obj *parse_obj_impl(const char *text, const char *mtl_names,
                    const double *mtl_colors, const double *mtl_refr,
                    int n_mtl, int compute_normals) {
  // unique_ptr: if anything below throws (bad_alloc on a pathological
  // asset, substr edge cases), sc_parse_obj's catch-all must not leak
  // the partially built Obj and its vectors
  auto owned = std::make_unique<Obj>();
  Obj *obj = owned.get();
  std::unordered_map<std::string, int> mtl_index;
  {
    const char *p = mtl_names;
    for (int i = 0; i < n_mtl; ++i) {
      const char *nl = std::strchr(p, '\n');
      std::string name = nl ? std::string(p, nl) : std::string(p);
      mtl_index[name] = i;
      if (!nl) break;
      p = nl + 1;
    }
  }

  std::vector<V3> verts(1);     // slot 0 placeholder (objparser.go:22)
  std::vector<V3> normals(1);
  std::unordered_map<std::string, int> group_ids;
  obj->group_names.push_back("DefaultGroup");
  group_ids["DefaultGroup"] = 0;
  int cur_group = 0;
  V3 cur_color{1, 1, 1};
  double cur_refr = 1.0;
  bool have_mtl = false;

  Cursor c{text, text + std::strlen(text)};
  const char *lb, *le;
  std::vector<std::string> f;
  while (next_line(c, lb, le)) {
    split_fields(lb, le, f);
    if (f.empty()) {
      obj->ignored_lines++;
      continue;
    }
    const std::string &tag = f[0];
    if (tag == "v" && f.size() >= 4) {
      V3 v;
      if (parse_d(f[1], v.x) && parse_d(f[2], v.y) && parse_d(f[3], v.z))
        verts.push_back(v);
      else
        obj->ignored_lines++;
    } else if (tag == "vn" && f.size() >= 4) {
      V3 v;
      if (parse_d(f[1], v.x) && parse_d(f[2], v.y) && parse_d(f[3], v.z))
        normals.push_back(v);
      else
        obj->ignored_lines++;
    } else if (tag == "usemtl" && f.size() >= 2) {
      auto it = mtl_index.find(f[1]);
      if (it != mtl_index.end()) {
        cur_color = {mtl_colors[3 * it->second],
                     mtl_colors[3 * it->second + 1],
                     mtl_colors[3 * it->second + 2]};
        cur_refr = mtl_refr[it->second];
        have_mtl = true;
      }
    } else if (tag == "f" && f.size() >= 4) {
      bool has_slash =
          std::memchr(lb, '/', static_cast<size_t>(le - lb)) != nullptr;
      for (size_t i = 2; i + 1 < f.size(); ++i) {
        Tri t;
        size_t vi[3], ni[3] = {0, 0, 0};
        bool ok = true;
        const std::string *fp[3] = {&f[1], &f[i], &f[i + 1]};
        for (int k = 0; k < 3; ++k) {
          const std::string &s = *fp[k];
          size_t s1 = s.find('/');
          long raw;
          if (!parse_l(s.substr(0, s1), raw)) { ok = false; break; }
          vi[k] = resolve_index(raw, verts.size());
          if (vi[k] == 0) { ok = false; break; }
          if (s1 != std::string::npos) {
            size_t s2 = s.find('/', s1 + 1);
            if (s2 != std::string::npos && s2 + 1 < s.size()
                && parse_l(s.substr(s2 + 1), raw))
              ni[k] = resolve_index(raw, normals.size());
          }
        }
        if (!ok) {
          // malformed or out-of-range face corner: drop the whole face
          // (counted once as an ignored line below, per face line)
          obj->ignored_lines++;
          break;
        }
        t.p1 = verts[vi[0]];
        t.p2 = verts[vi[1]];
        t.p3 = verts[vi[2]];
        t.face_n = normalized(cross(sub(t.p3, t.p1), sub(t.p2, t.p1)));
        if (has_slash && ni[0] > 0 && ni[1] > 0 && ni[2] > 0) {
          t.n1 = normals[ni[0]];
          t.n2 = normals[ni[1]];
          t.n3 = normals[ni[2]];
        } else {
          t.n1 = t.n2 = t.n3 = t.face_n;
        }
        // plain-vertex faces keep the default material; v/t/n faces get
        // the current usemtl material (objparser.go:58-71 vs 74-106)
        if (has_slash && have_mtl) {
          t.color = cur_color;
          t.refr = cur_refr;
        }
        t.group_id = cur_group;
        obj->tris.push_back(t);
      }
    } else if ((tag == "g" || tag == "o") && f.size() >= 2) {
      auto it = group_ids.find(f[1]);
      if (it == group_ids.end()) {
        int id = static_cast<int>(obj->group_names.size());
        group_ids[f[1]] = id;
        obj->group_names.push_back(f[1]);
        cur_group = id;
      } else {
        cur_group = it->second;
      }
    } else if (tag == "mtllib") {
      // .mtl resolution happens in Python (it owns file IO); the resolved
      // table arrives via mtl_names/mtl_colors
      continue;
    } else {
      obj->ignored_lines++;
    }
  }

  if (compute_normals) {
    // accumulate face normals per position (objfile.py / objparser.go:137)
    std::unordered_map<PosKey, V3, PosKeyHash> acc;
    acc.reserve(obj->tris.size() * 2);
    for (const Tri &t : obj->tris) {
      for (const V3 *p : {&t.p1, &t.p2, &t.p3}) {
        V3 &a = acc[key_of(*p)];
        a.x += t.face_n.x;
        a.y += t.face_n.y;
        a.z += t.face_n.z;
      }
    }
    for (Tri &t : obj->tris) {
      t.n1 = normalized(acc[key_of(t.p1)]);
      t.n2 = normalized(acc[key_of(t.p2)]);
      t.n3 = normalized(acc[key_of(t.p3)]);
    }
  }
  return owned.release();
}

// --------------------------------------------------------------------
// Flat skip-link BVH (semantics of bvh.py build_bvh)
// --------------------------------------------------------------------

struct BVH {
  std::vector<double> bb_min, bb_max;  // [Nn*3]
  std::vector<int32_t> tri_start, is_leaf, exit_idx;
  std::vector<int32_t> slots;          // [Ns] triangle ids, -1 = padding
  int leaf_size = 8;
};

struct Builder {
  const double *p1, *p2, *p3;
  std::vector<double> bmin, bmax, cent;  // per-tri [n*3]
  BVH *out;
  int leaf_size;

  void build(std::vector<int32_t> &ids) {
    size_t my = out->bb_min.size() / 3;
    double mn[3] = {1e300, 1e300, 1e300};
    double mx[3] = {-1e300, -1e300, -1e300};
    for (int32_t id : ids)
      for (int a = 0; a < 3; ++a) {
        mn[a] = std::min(mn[a], bmin[3 * static_cast<size_t>(id) + a]);
        mx[a] = std::max(mx[a], bmax[3 * static_cast<size_t>(id) + a]);
      }
    out->bb_min.insert(out->bb_min.end(), mn, mn + 3);
    out->bb_max.insert(out->bb_max.end(), mx, mx + 3);
    out->tri_start.push_back(0);
    out->is_leaf.push_back(0);
    out->exit_idx.push_back(0);

    if (static_cast<int>(ids.size()) <= leaf_size) {
      out->is_leaf[my] = 1;
      out->tri_start[my] = static_cast<int32_t>(out->slots.size());
      for (int32_t id : ids) out->slots.push_back(id);
      for (int k = static_cast<int>(ids.size()); k < leaf_size; ++k)
        out->slots.push_back(-1);
      out->exit_idx[my] = static_cast<int32_t>(out->bb_min.size() / 3);
      return;
    }

    // Snapped-SAH split: SAH sweep over the 3 sorted-centroid axes with
    // the cut snapped to a multiple of leaf_size (full leaves => the
    // minimum possible node count, which is what the megakernel's
    // packet walk pays for). Bit-identical to the python emit path
    // (scene/bvh.py _build_tree): stable sorts, same fp operation
    // order, strict-< first-min tie-breaks over axes then cuts.
    double cmin[3] = {1e300, 1e300, 1e300};
    double cmax[3] = {-1e300, -1e300, -1e300};
    for (int32_t id : ids)
      for (int a = 0; a < 3; ++a) {
        double v = cent[3 * static_cast<size_t>(id) + a];
        cmin[a] = std::min(cmin[a], v);
        cmax[a] = std::max(cmax[a], v);
      }
    const size_t n = ids.size();
    const size_t n_leaves = (n + leaf_size - 1) / leaf_size;

    auto area = [](const double *mn, const double *mx) {
      double d0 = mx[0] - mn[0], d1 = mx[1] - mn[1], d2 = mx[2] - mn[2];
      return d0 * d1 + d1 * d2 + d2 * d0;
    };

    double best_cost = std::numeric_limits<double>::infinity();
    std::vector<int32_t> best_order;
    size_t best_cut = 0;
    std::vector<double> lmn(n * 3), lmx(n * 3), rmn(n * 3), rmx(n * 3);
    for (int axis = 0; axis < 3; ++axis) {
      if (cmax[axis] - cmin[axis] <= 0.0) continue;
      std::vector<int32_t> order(ids);
      std::stable_sort(order.begin(), order.end(),
                       [&](int32_t a, int32_t b) {
                         return cent[3 * static_cast<size_t>(a) + axis] <
                                cent[3 * static_cast<size_t>(b) + axis];
                       });
      for (size_t i = 0; i < n; ++i) {
        size_t id = static_cast<size_t>(order[i]);
        for (int a = 0; a < 3; ++a) {
          double mnv = bmin[3 * id + a], mxv = bmax[3 * id + a];
          lmn[3 * i + a] = i ? std::min(lmn[3 * (i - 1) + a], mnv) : mnv;
          lmx[3 * i + a] = i ? std::max(lmx[3 * (i - 1) + a], mxv) : mxv;
        }
      }
      for (size_t i = n; i-- > 0;) {
        size_t id = static_cast<size_t>(order[i]);
        for (int a = 0; a < 3; ++a) {
          double mnv = bmin[3 * id + a], mxv = bmax[3 * id + a];
          rmn[3 * i + a] =
              i + 1 < n ? std::min(rmn[3 * (i + 1) + a], mnv) : mnv;
          rmx[3 * i + a] =
              i + 1 < n ? std::max(rmx[3 * (i + 1) + a], mxv) : mxv;
        }
      }
      double ax_best = std::numeric_limits<double>::infinity();
      size_t ax_cut = 0;
      for (size_t cut = static_cast<size_t>(leaf_size); cut < n;
           cut += static_cast<size_t>(leaf_size)) {
        double cost =
            area(&lmn[3 * (cut - 1)], &lmx[3 * (cut - 1)]) *
                static_cast<double>(cut) +
            area(&rmn[3 * cut], &rmx[3 * cut]) *
                static_cast<double>(n - cut);
        if (cost < ax_best) {
          ax_best = cost;
          ax_cut = cut;
        }
      }
      if (ax_cut && ax_best < best_cost) {
        best_cost = ax_best;
        best_order = order;
        best_cut = ax_cut;
      }
    }
    if (best_order.empty()) {
      // all centroids identical: snapped even split, original order
      best_order = ids;
      best_cut = std::min(static_cast<size_t>(leaf_size) * (n_leaves / 2),
                          n - 1);
    }
    std::vector<int32_t> left(best_order.begin(),
                              best_order.begin() +
                                  static_cast<long>(best_cut));
    std::vector<int32_t> right(best_order.begin() +
                                   static_cast<long>(best_cut),
                               best_order.end());
    build(left);
    build(right);
    out->exit_idx[my] = static_cast<int32_t>(out->bb_min.size() / 3);
  }
};

}  // namespace

extern "C" {

void *sc_parse_obj(const char *text, const char *mtl_names,
                   const double *mtl_colors, const double *mtl_refr,
                   int n_mtl, int compute_normals) {
  // no exception may cross the ctypes boundary (std::terminate);
  // NULL tells the Python side to fall back to its own parser
  try {
    return parse_obj_impl(text, mtl_names, mtl_colors, mtl_refr, n_mtl,
                          compute_normals);
  } catch (...) {
    return nullptr;
  }
}

void sc_obj_counts(void *h, int *n_tris, int *n_groups, int *names_len,
                   int *ignored) {
  auto *o = static_cast<Obj *>(h);
  *n_tris = static_cast<int>(o->tris.size());
  *n_groups = static_cast<int>(o->group_names.size());
  size_t len = 0;
  for (const auto &n : o->group_names) len += n.size() + 1;
  *names_len = static_cast<int>(len);
  *ignored = o->ignored_lines;
}

void sc_obj_group_names(void *h, char *buf) {
  auto *o = static_cast<Obj *>(h);
  char *p = buf;
  for (const auto &n : o->group_names) {
    std::memcpy(p, n.data(), n.size());
    p += n.size();
    *p++ = '\n';
  }
}

void sc_obj_tris(void *h, double *p1, double *p2, double *p3, double *n1,
                 double *n2, double *n3, double *face_n, double *color,
                 double *refr, int32_t *group_id) {
  auto *o = static_cast<Obj *>(h);
  for (size_t i = 0; i < o->tris.size(); ++i) {
    const Tri &t = o->tris[i];
    const V3 *vs[7] = {&t.p1, &t.p2, &t.p3, &t.n1, &t.n2, &t.n3, &t.face_n};
    double *ds[7] = {p1, p2, p3, n1, n2, n3, face_n};
    for (int k = 0; k < 7; ++k) {
      ds[k][3 * i] = vs[k]->x;
      ds[k][3 * i + 1] = vs[k]->y;
      ds[k][3 * i + 2] = vs[k]->z;
    }
    color[3 * i] = t.color.x;
    color[3 * i + 1] = t.color.y;
    color[3 * i + 2] = t.color.z;
    refr[i] = t.refr;
    group_id[i] = t.group_id;
  }
}

void sc_obj_free(void *h) { delete static_cast<Obj *>(h); }

void *sc_build_bvh(const double *p1, const double *p2, const double *p3,
                   int n_tris, int leaf_size) {
  auto *bvh = new BVH();
  bvh->leaf_size = leaf_size;
  Builder b;
  b.p1 = p1;
  b.p2 = p2;
  b.p3 = p3;
  b.out = bvh;
  b.leaf_size = leaf_size;
  size_t n = static_cast<size_t>(n_tris);
  b.bmin.resize(n * 3);
  b.bmax.resize(n * 3);
  b.cent.resize(n * 3);
  for (size_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      double v1 = p1[3 * i + a], v2 = p2[3 * i + a], v3 = p3[3 * i + a];
      b.bmin[3 * i + a] = std::min(v1, std::min(v2, v3));
      b.bmax[3 * i + a] = std::max(v1, std::max(v2, v3));
      b.cent[3 * i + a] = (v1 + v2 + v3) / 3.0;
    }
  std::vector<int32_t> ids(n);
  for (size_t i = 0; i < n; ++i) ids[i] = static_cast<int32_t>(i);
  b.build(ids);
  return bvh;
}

void sc_bvh_counts(void *h, int *n_nodes, int *n_slots) {
  auto *b = static_cast<BVH *>(h);
  *n_nodes = static_cast<int>(b->bb_min.size() / 3);
  *n_slots = static_cast<int>(b->slots.size());
}

void sc_bvh_nodes(void *h, double *bb_min, double *bb_max,
                  int32_t *tri_start, int32_t *is_leaf, int32_t *exit_idx) {
  auto *b = static_cast<BVH *>(h);
  std::memcpy(bb_min, b->bb_min.data(), b->bb_min.size() * 8);
  std::memcpy(bb_max, b->bb_max.data(), b->bb_max.size() * 8);
  std::memcpy(tri_start, b->tri_start.data(), b->tri_start.size() * 4);
  std::memcpy(is_leaf, b->is_leaf.data(), b->is_leaf.size() * 4);
  std::memcpy(exit_idx, b->exit_idx.data(), b->exit_idx.size() * 4);
}

void sc_bvh_slots(void *h, int32_t *slots) {
  auto *b = static_cast<BVH *>(h);
  std::memcpy(slots, b->slots.data(), b->slots.size() * 4);
}

void sc_bvh_free(void *h) { delete static_cast<BVH *>(h); }

}  // extern "C"
