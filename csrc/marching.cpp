// Marching-squares contour extraction with polyline assembly.
//
// Native replacement for the scikit-image Cython traversal the reference's
// host-side contour-extraction utilities depend on (reference core.py:1470,
// tests/test_breaking.py:65) — skimage is not part of this framework, and the
// extraction/grouping path is inherently serial/host-side (unlike total
// perimeter length, which runs as a data-parallel XLA kernel in
// diagnostics/length.py).
//
// Semantics: corners with value > level are "above"; vertices are linearly
// interpolated on cut edges; ambiguous (saddle) cells follow the
// fully-connected-low rule (above-level corners cut off individually),
// matching the device kernel and skimage's default.  Cells with any NaN corner
// emit no segments.  Output polylines are (r, c) index coordinates like
// skimage's find_contours; orientation/order of polylines is unspecified.
//
// Build: g++ -O3 -shared -fPIC -o libmarching.so marching.cpp
// (driven by xcontour_tpu/host/native.py, loaded via ctypes).

#include <cmath>
#include <cstdint>
#include <cstring>
#include <unordered_map>
#include <vector>

namespace {

struct Pt {
  double r, c;
  bool operator==(const Pt& o) const { return r == o.r && c == o.c; }
};

struct PtHash {
  size_t operator()(const Pt& p) const {
    // bit-exact hashing: adjacent cells compute shared-edge vertices from the
    // same corner values with the same expression, so doubles match exactly
    uint64_t a, b;
    static_assert(sizeof(double) == 8, "");
    std::memcpy(&a, &p.r, 8);
    std::memcpy(&b, &p.c, 8);
    uint64_t h = a * 0x9E3779B97F4A7C15ull ^ (b + 0x7F4A7C15u + (a << 6));
    return static_cast<size_t>(h);
  }
};

inline double frac(double va, double vb, double level) {
  double d = vb - va;
  return d == 0.0 ? 0.0 : (level - va) / d;
}

}  // namespace

extern "C" {

// Returns total number of vertices written, or -1 on capacity overflow.
// verts_out: [verts_cap * 2] doubles, polylines concatenated (r, c) pairs.
// seg_lens_out: [segs_cap] vertex counts per polyline; *n_segs_out set.
long long xc_find_contours(const double* data, long long ny, long long nx,
                           double level, double* verts_out,
                           long long verts_cap, long long* seg_lens_out,
                           long long segs_cap, long long* n_segs_out) {
  // adjacency: each vertex connects to <= 2 neighbours
  std::unordered_map<Pt, std::vector<Pt>, PtHash> adj;
  adj.reserve(static_cast<size_t>(ny) * 4);

  auto add_seg = [&](Pt a, Pt b) {
    if (a == b) return;  // degenerate (vertex at a corner touching the level)
    adj[a].push_back(b);
    adj[b].push_back(a);
  };

  for (long long r = 0; r + 1 < ny; ++r) {
    for (long long c = 0; c + 1 < nx; ++c) {
      double v00 = data[r * nx + c], v01 = data[r * nx + c + 1];
      double v10 = data[(r + 1) * nx + c], v11 = data[(r + 1) * nx + c + 1];
      if (std::isnan(v00) || std::isnan(v01) || std::isnan(v10) ||
          std::isnan(v11))
        continue;
      bool a00 = v00 > level, a01 = v01 > level;
      bool a10 = v10 > level, a11 = v11 > level;
      int n_above = a00 + a01 + a10 + a11;
      if (n_above == 0 || n_above == 4) continue;

      Pt top{(double)r, c + frac(v00, v01, level)};
      Pt bot{(double)r + 1, c + frac(v10, v11, level)};
      Pt lef{r + frac(v00, v10, level), (double)c};
      Pt rig{r + frac(v01, v11, level), (double)c + 1};

      bool iso00 = (a00 != a01) && (a00 != a10) && (a01 == a11);
      bool iso01 = (a01 != a00) && (a01 != a11) && (a00 == a10);
      bool iso10 = (a10 != a00) && (a10 != a11) && (a00 == a01);
      bool iso11 = (a11 != a01) && (a11 != a10) && (a01 == a00);
      if (iso00) add_seg(top, lef);
      else if (iso01) add_seg(top, rig);
      else if (iso10) add_seg(bot, lef);
      else if (iso11) add_seg(bot, rig);
      else if ((a00 == a01) && (a10 == a11)) add_seg(lef, rig);
      else if ((a00 == a10) && (a01 == a11)) add_seg(top, bot);
      else if (a00 && a11) { add_seg(top, lef); add_seg(bot, rig); }
      else { add_seg(top, rig); add_seg(bot, lef); }
    }
  }

  std::unordered_map<Pt, bool, PtHash> used;
  used.reserve(adj.size());
  long long vtotal = 0, stotal = 0;

  auto walk = [&](Pt start) -> bool {
    std::vector<Pt> line;
    line.push_back(start);
    used[start] = true;
    Pt cur = start;
    Pt prev{NAN, NAN};
    for (;;) {
      const auto& nbrs = adj[cur];
      bool advanced = false;
      for (const Pt& nb : nbrs) {
        if (!(std::isnan(prev.r)) && nb == prev) continue;
        if (used.count(nb) && !(nb == start)) continue;
        if (nb == start && line.size() > 2) {
          line.push_back(start);  // close the loop
          advanced = false;
          break;
        }
        if (used.count(nb)) continue;
        prev = cur;
        cur = nb;
        used[cur] = true;
        line.push_back(cur);
        advanced = true;
        break;
      }
      if (!advanced) break;
    }
    if (line.size() < 2) return true;
    if (vtotal + (long long)line.size() > verts_cap || stotal >= segs_cap)
      return false;
    for (const Pt& p : line) {
      verts_out[vtotal * 2] = p.r;
      verts_out[vtotal * 2 + 1] = p.c;
      ++vtotal;
    }
    seg_lens_out[stotal++] = (long long)line.size();
    return true;
  };

  // open chains first (degree-1 endpoints), then closed loops
  for (const auto& kv : adj)
    if (kv.second.size() == 1 && !used.count(kv.first))
      if (!walk(kv.first)) return -1;
  for (const auto& kv : adj)
    if (!used.count(kv.first))
      if (!walk(kv.first)) return -1;

  *n_segs_out = stotal;
  return vtotal;
}

}  // extern "C"
