// Native asset-prep kernels: 3-D convex hull (quickhull), quadric
// edge-collapse mesh decimation, binary STL writer.
//
// TPU-native replacement for the host-side geometry dependencies of the
// reference's robot builder: scipy.spatial.ConvexHull
// (smpl_sim/smpllib/smpl_local_robot.py:146-173) and
// vtk.vtkQuadricDecimation (smpl_sim/utils/geom.py:12-36). These run at
// model-build time only (never on the hot path); they are native so the
// framework's mesh pipeline has no scipy/vtk runtime requirement.
//
// C ABI only — bound from Python via ctypes (smplsim_tpu/native/__init__.py).
// All functions return 0 on success, negative error codes otherwise.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <queue>
#include <vector>

namespace {

struct V3 {
  double x, y, z;
};

static inline V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
static inline V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}
static inline double dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
static inline double norm(V3 a) { return std::sqrt(dot(a, a)); }

// ---------------------------------------------------------------------------
// Quickhull
// ---------------------------------------------------------------------------
struct Face {
  int a, b, c;          // vertex indices, CCW seen from outside
  V3 n;                 // unit normal
  double d;             // plane offset: dot(n, p) == d on the plane
  std::vector<int> outside;
  bool alive = true;
};

struct Hull {
  const V3* pts;
  int n;
  double eps;
  std::vector<Face> faces;

  void make_face(int a, int b, int c, V3 inside) {
    Face f;
    f.a = a; f.b = b; f.c = c;
    V3 nrm = cross(sub(pts[b], pts[a]), sub(pts[c], pts[a]));
    double len = norm(nrm);
    if (len < 1e-30) len = 1e-30;
    nrm = {nrm.x / len, nrm.y / len, nrm.z / len};
    double d = dot(nrm, pts[a]);
    // orient outward (away from the interior point)
    if (dot(nrm, inside) - d > 0) {
      std::swap(f.b, f.c);
      nrm = {-nrm.x, -nrm.y, -nrm.z};
      d = -d;
    }
    f.n = nrm;
    f.d = d;
    faces.push_back(std::move(f));
  }

  double dist(const Face& f, int p) const { return dot(f.n, pts[p]) - f.d; }
};

int quickhull(const double* pts_raw, int n, std::vector<int>& out_faces,
              double* volume) {
  if (n < 4) return -1;
  const V3* pts = reinterpret_cast<const V3*>(pts_raw);

  // bounding scale for epsilon
  V3 lo = pts[0], hi = pts[0];
  for (int i = 1; i < n; i++) {
    lo.x = std::min(lo.x, pts[i].x); hi.x = std::max(hi.x, pts[i].x);
    lo.y = std::min(lo.y, pts[i].y); hi.y = std::max(hi.y, pts[i].y);
    lo.z = std::min(lo.z, pts[i].z); hi.z = std::max(hi.z, pts[i].z);
  }
  double scale = std::max({hi.x - lo.x, hi.y - lo.y, hi.z - lo.z, 1e-12});
  double eps = 1e-10 * scale;

  // initial simplex: extreme pair, then farthest from line, then from plane
  int i0 = 0, i1 = 0;
  {
    double best = -1;
    int ex[6];
    double exv[6] = {1e300, -1e300, 1e300, -1e300, 1e300, -1e300};
    for (int i = 0; i < n; i++) {
      const double c[3] = {pts[i].x, pts[i].y, pts[i].z};
      for (int k = 0; k < 3; k++) {
        if (c[k] < exv[2 * k]) { exv[2 * k] = c[k]; ex[2 * k] = i; }
        if (c[k] > exv[2 * k + 1]) { exv[2 * k + 1] = c[k]; ex[2 * k + 1] = i; }
      }
    }
    for (int p = 0; p < 6; p++)
      for (int q = p + 1; q < 6; q++) {
        double d = norm(sub(pts[ex[p]], pts[ex[q]]));
        if (d > best) { best = d; i0 = ex[p]; i1 = ex[q]; }
      }
    if (best < eps) return -2;  // degenerate: all points coincide
  }
  int i2 = -1;
  {
    double best = -1;
    V3 dir = sub(pts[i1], pts[i0]);
    double dlen = dot(dir, dir);
    for (int i = 0; i < n; i++) {
      V3 w = sub(pts[i], pts[i0]);
      double t = dot(w, dir) / dlen;
      V3 proj = {pts[i0].x + t * dir.x, pts[i0].y + t * dir.y,
                 pts[i0].z + t * dir.z};
      double d = norm(sub(pts[i], proj));
      if (d > best) { best = d; i2 = i; }
    }
    if (best < eps) return -3;  // collinear
  }
  int i3 = -1;
  {
    V3 nrm = cross(sub(pts[i1], pts[i0]), sub(pts[i2], pts[i0]));
    double len = norm(nrm);
    nrm = {nrm.x / len, nrm.y / len, nrm.z / len};
    double d0 = dot(nrm, pts[i0]);
    double best = -1;
    for (int i = 0; i < n; i++) {
      double d = std::fabs(dot(nrm, pts[i]) - d0);
      if (d > best) { best = d; i3 = i; }
    }
    if (best < eps) return -4;  // coplanar
  }

  Hull h{pts, n, eps, {}};
  V3 centroid = {
      (pts[i0].x + pts[i1].x + pts[i2].x + pts[i3].x) / 4,
      (pts[i0].y + pts[i1].y + pts[i2].y + pts[i3].y) / 4,
      (pts[i0].z + pts[i1].z + pts[i2].z + pts[i3].z) / 4};
  h.make_face(i0, i1, i2, centroid);
  h.make_face(i0, i1, i3, centroid);
  h.make_face(i0, i2, i3, centroid);
  h.make_face(i1, i2, i3, centroid);

  // assign outside sets
  for (int i = 0; i < n; i++) {
    for (auto& f : h.faces)
      if (h.dist(f, i) > eps) { f.outside.push_back(i); break; }
  }

  // iterate
  for (;;) {
    int fi = -1;
    for (size_t k = 0; k < h.faces.size(); k++)
      if (h.faces[k].alive && !h.faces[k].outside.empty()) { fi = (int)k; break; }
    if (fi < 0) break;

    // farthest point of this face
    Face& f = h.faces[fi];
    int far = f.outside[0];
    double best = h.dist(f, far);
    for (int p : f.outside) {
      double d = h.dist(f, p);
      if (d > best) { best = d; far = p; }
    }

    // find all faces visible from `far`
    std::vector<int> visible;
    for (size_t k = 0; k < h.faces.size(); k++)
      if (h.faces[k].alive && h.dist(h.faces[k], far) > eps)
        visible.push_back((int)k);

    // horizon edges: edges of visible faces shared with non-visible ones.
    // count directed edges of visible faces; an edge whose reverse is absent
    // is on the horizon.
    std::vector<std::pair<int, int>> edges;
    for (int k : visible) {
      const Face& vf = h.faces[k];
      edges.push_back({vf.a, vf.b});
      edges.push_back({vf.b, vf.c});
      edges.push_back({vf.c, vf.a});
    }
    std::vector<std::pair<int, int>> horizon;
    for (auto& e : edges) {
      bool has_rev = false;
      for (auto& e2 : edges)
        if (e2.first == e.second && e2.second == e.first) { has_rev = true; break; }
      if (!has_rev) horizon.push_back(e);
    }

    // collect orphaned outside points, kill visible faces
    std::vector<int> orphans;
    for (int k : visible) {
      for (int p : h.faces[k].outside)
        if (p != far) orphans.push_back(p);
      h.faces[k].alive = false;
      h.faces[k].outside.clear();
    }

    // new faces from horizon to far
    size_t first_new = h.faces.size();
    for (auto& e : horizon) h.make_face(e.first, e.second, far, centroid);

    // redistribute orphans
    for (int p : orphans) {
      for (size_t k = first_new; k < h.faces.size(); k++) {
        if (h.dist(h.faces[k], p) > eps) {
          h.faces[k].outside.push_back(p);
          break;
        }
      }
    }
    if (h.faces.size() > (size_t)(16 * n + 64)) return -5;  // runaway guard
  }

  out_faces.clear();
  double vol = 0;
  for (auto& f : h.faces) {
    if (!f.alive) continue;
    out_faces.push_back(f.a);
    out_faces.push_back(f.b);
    out_faces.push_back(f.c);
    // signed tetra volume vs origin-shifted centroid for stability
    V3 a = sub(pts[f.a], centroid), b = sub(pts[f.b], centroid),
       c = sub(pts[f.c], centroid);
    vol += dot(a, cross(b, c)) / 6.0;
  }
  if (volume) *volume = std::fabs(vol);
  return 0;
}

// ---------------------------------------------------------------------------
// Quadric decimation (Garland–Heckbert '97)
// ---------------------------------------------------------------------------
struct Quadric {
  // symmetric 4x4, stored upper-triangular (10 doubles)
  double q[10] = {0};
  void add_plane(double a, double b, double c, double d) {
    double p[4] = {a, b, c, d};
    int k = 0;
    for (int i = 0; i < 4; i++)
      for (int j = i; j < 4; j++) q[k++] += p[i] * p[j];
  }
  void add(const Quadric& o) {
    for (int i = 0; i < 10; i++) q[i] += o.q[i];
  }
  // optimal collapse position: argmin v^T Q v solves the 3x3 system
  // A p = -b with A = Q[0:3,0:3], b = Q[0:3,3] (GH'97 eq. 1). Returns false
  // when A is (near-)singular — caller falls back to endpoint/midpoint.
  bool optimum(V3* out) const {
    const double a00 = q[0], a01 = q[1], a02 = q[2], b0 = q[3];
    const double a11 = q[4], a12 = q[5], b1 = q[6];
    const double a22 = q[7], b2 = q[8];
    double det = a00 * (a11 * a22 - a12 * a12) - a01 * (a01 * a22 - a12 * a02)
               + a02 * (a01 * a12 - a11 * a02);
    double scale = std::fabs(a00) + std::fabs(a11) + std::fabs(a22);
    if (std::fabs(det) < 1e-10 * scale * scale * scale + 1e-300) return false;
    double inv = 1.0 / det;
    out->x = -inv * (b0 * (a11 * a22 - a12 * a12) - a01 * (b1 * a22 - a12 * b2)
                     + a02 * (b1 * a12 - a11 * b2));
    out->y = -inv * (a00 * (b1 * a22 - a12 * b2) - b0 * (a01 * a22 - a02 * a12)
                     + a02 * (a01 * b2 - b1 * a02));
    out->z = -inv * (a00 * (a11 * b2 - b1 * a12) - a01 * (a01 * b2 - b1 * a02)
                     + b0 * (a01 * a12 - a11 * a02));
    return true;
  }

  double eval(double x, double y, double z) const {
    // v^T Q v with v = (x,y,z,1)
    double v[4] = {x, y, z, 1.0};
    double full[4][4];
    int k = 0;
    for (int i = 0; i < 4; i++)
      for (int j = i; j < 4; j++) {
        full[i][j] = q[k];
        full[j][i] = q[k];
        k++;
      }
    double s = 0;
    for (int i = 0; i < 4; i++)
      for (int j = 0; j < 4; j++) s += v[i] * full[i][j] * v[j];
    return s;
  }
};

int decimate_impl(const double* verts_raw, int nv, const int* faces_raw, int nf,
                  int target_faces, std::vector<double>& out_verts,
                  std::vector<int>& out_faces) {
  std::vector<V3> V(nv);
  std::memcpy(V.data(), verts_raw, sizeof(double) * 3 * nv);
  std::vector<std::array<int, 3>> F;
  F.reserve(nf);
  for (int i = 0; i < nf; i++)
    F.push_back({faces_raw[3 * i], faces_raw[3 * i + 1], faces_raw[3 * i + 2]});

  std::vector<Quadric> Q(nv);
  auto face_quadric = [&](const std::array<int, 3>& f, Quadric& into) {
    V3 nrm = cross(sub(V[f[1]], V[f[0]]), sub(V[f[2]], V[f[0]]));
    double len = norm(nrm);
    if (len < 1e-30) return;
    nrm = {nrm.x / len, nrm.y / len, nrm.z / len};
    double d = -dot(nrm, V[f[0]]);
    into.add_plane(nrm.x, nrm.y, nrm.z, d);
  };
  for (auto& f : F) {
    Quadric fq;
    face_quadric(f, fq);
    for (int v : f) Q[v].add(fq);
  }

  std::vector<int> remap(nv);
  for (int i = 0; i < nv; i++) remap[i] = i;
  auto find = [&](int v) {
    while (remap[v] != v) { remap[v] = remap[remap[v]]; v = remap[v]; }
    return v;
  };

  struct Cand {
    double cost;
    int u, v;
    int vu, vv;  // vertex versions at push time (stale-entry invalidation)
    V3 pos;
    bool operator>(const Cand& o) const { return cost > o.cost; }
  };
  std::priority_queue<Cand, std::vector<Cand>, std::greater<Cand>> heap;
  std::vector<int> version(nv, 0);

  auto push_edge = [&](int u, int v) {
    u = find(u); v = find(v);
    if (u == v) return;
    Quadric sum = Q[u];
    sum.add(Q[v]);
    // optimal position from the quadric; endpoints/midpoint as fallback
    // candidates when the 3x3 system is ill-conditioned (vtk does the same)
    V3 cands[4] = {V[u], V[v],
                   {(V[u].x + V[v].x) / 2, (V[u].y + V[v].y) / 2,
                    (V[u].z + V[v].z) / 2}, {0, 0, 0}};
    int ncand = 3;
    if (sum.optimum(&cands[3])) ncand = 4;
    double best = 1e300;
    V3 bp = cands[2];
    for (int ci = 0; ci < ncand; ci++) {
      const V3& c = cands[ci];
      double e = sum.eval(c.x, c.y, c.z);
      if (e < best) { best = e; bp = c; }
    }
    heap.push({best, u, v, version[u], version[v], bp});
  };

  for (auto& f : F)
    for (int e = 0; e < 3; e++) push_edge(f[e], f[(e + 1) % 3]);

  int live_faces = nf;
  auto face_alive = [&](const std::array<int, 3>& f) {
    int a = find(f[0]), b = find(f[1]), c = find(f[2]);
    return a != b && b != c && a != c;
  };

  while (live_faces > target_faces && !heap.empty()) {
    Cand c = heap.top();
    heap.pop();
    int u = find(c.u), v = find(c.v);
    if (u == v) continue;
    if (u != c.u || v != c.v || version[u] != c.vu || version[v] != c.vv)
      continue;  // stale: endpoint moved or merged since push
    // collapse v into u
    int before = 0, after = 0;
    for (auto& f : F) {
      bool touches = (find(f[0]) == v || find(f[1]) == v || find(f[2]) == v ||
                      find(f[0]) == u || find(f[1]) == u || find(f[2]) == u);
      if (touches && face_alive(f)) before++;
    }
    remap[v] = u;
    V[u] = c.pos;
    Q[u].add(Q[v]);
    version[u]++;
    for (auto& f : F) {
      bool touches = (find(f[0]) == u || find(f[1]) == u || find(f[2]) == u);
      if (touches && face_alive(f)) after++;
    }
    live_faces -= (before - after);
    // re-seed edges around u
    for (auto& f : F) {
      if (!face_alive(f)) continue;
      int a = find(f[0]), b = find(f[1]), cc = find(f[2]);
      if (a == u || b == u || cc == u) {
        push_edge(a, b);
        push_edge(b, cc);
        push_edge(cc, a);
      }
    }
  }

  // compact output
  std::vector<int> newid(nv, -1);
  out_verts.clear();
  out_faces.clear();
  for (auto& f : F) {
    if (!face_alive(f)) continue;
    int idx[3];
    for (int e = 0; e < 3; e++) {
      int v = find(f[e]);
      if (newid[v] < 0) {
        newid[v] = (int)(out_verts.size() / 3);
        out_verts.push_back(V[v].x);
        out_verts.push_back(V[v].y);
        out_verts.push_back(V[v].z);
      }
      idx[e] = newid[v];
    }
    out_faces.push_back(idx[0]);
    out_faces.push_back(idx[1]);
    out_faces.push_back(idx[2]);
  }
  return 0;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

// pts: (n,3) doubles. out_faces: capacity cap_faces*3 ints. Writes the hull
// triangles + volume. Returns 0, or <0 on degenerate input / overflow.
int sm_convex_hull(const double* pts, int n, int* out_faces, int cap_faces,
                   int* n_faces, double* volume) {
  std::vector<int> tri;
  int rc = quickhull(pts, n, tri, volume);
  if (rc != 0) return rc;
  int nf = (int)(tri.size() / 3);
  if (nf > cap_faces) return -10;
  std::memcpy(out_faces, tri.data(), tri.size() * sizeof(int));
  *n_faces = nf;
  return 0;
}

// Decimate to ~target_faces. Output buffers must hold the INPUT sizes
// (decimation never grows the mesh).
int sm_decimate(const double* verts, int nv, const int* faces, int nf,
                int target_faces, double* out_verts, int* out_nv,
                int* out_faces, int* out_nf) {
  std::vector<double> ov;
  std::vector<int> of;
  int rc = decimate_impl(verts, nv, faces, nf, target_faces, ov, of);
  if (rc != 0) return rc;
  if ((int)(ov.size() / 3) > nv || (int)(of.size() / 3) > nf) return -11;
  std::memcpy(out_verts, ov.data(), ov.size() * sizeof(double));
  std::memcpy(out_faces, of.data(), of.size() * sizeof(int));
  *out_nv = (int)(ov.size() / 3);
  *out_nf = (int)(of.size() / 3);
  return 0;
}

// Binary STL (the mesh skeleton writer's asset format,
// skeleton_mesh_local.py via numpy-stl).
int sm_write_stl(const char* path, const double* verts, const int* faces,
                 int nf) {
  FILE* fp = std::fopen(path, "wb");
  if (!fp) return -1;
  char header[80] = {0};
  std::snprintf(header, sizeof(header), "smplsim_tpu binary stl");
  std::fwrite(header, 1, 80, fp);
  uint32_t n = (uint32_t)nf;
  std::fwrite(&n, 4, 1, fp);
  for (int i = 0; i < nf; i++) {
    const V3* a = reinterpret_cast<const V3*>(verts + 3 * faces[3 * i]);
    const V3* b = reinterpret_cast<const V3*>(verts + 3 * faces[3 * i + 1]);
    const V3* c = reinterpret_cast<const V3*>(verts + 3 * faces[3 * i + 2]);
    V3 nrm = cross(sub(*b, *a), sub(*c, *a));
    double len = norm(nrm);
    if (len > 1e-30) nrm = {nrm.x / len, nrm.y / len, nrm.z / len};
    float buf[12] = {(float)nrm.x, (float)nrm.y, (float)nrm.z,
                     (float)a->x,  (float)a->y,  (float)a->z,
                     (float)b->x,  (float)b->y,  (float)b->z,
                     (float)c->x,  (float)c->y,  (float)c->z};
    std::fwrite(buf, 4, 12, fp);
    uint16_t attr = 0;
    std::fwrite(&attr, 2, 1, fp);
  }
  std::fclose(fp);
  return 0;
}

}  // extern "C"
