// Host geometry engine — C++ hot loops for the GIS subsystem (a copy of
// atlite_tpu/native/geometry.cpp).
//
// atlite delegates these operations to GEOS/GDAL (shapely STRtree +
// polygon intersection, its gis.py:104-183; rasterio geometry_mask,
// gis.py:291).  Here they are implemented directly for the two shapes of
// work the framework needs:
//
//   polygon_cell_areas : exact |polygon ∩ cell| for every cell of a regular
//                        grid window (Sutherland–Hodgman clip per cell) —
//                        the indicator-matrix kernel,
//   points_in_rings    : even-odd point-in-polygon for a batch of points —
//                        the rasterization kernel.
//
// Compiled with g++ at first use into build/native/ and loaded via ctypes
// (atlite_tpu_torch/native/__init__.py); pure-numpy fallbacks exist for
// every entry point.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Pt {
  double x, y;
};

// Clip an implicitly-closed ring against one half-plane (axis-aligned).
// axis: 0 = x, 1 = y;  keep_ge: keep points with coord >= bound.
static void clip_halfplane(const std::vector<Pt>& in, std::vector<Pt>& out,
                           int axis, double bound, bool keep_ge) {
  out.clear();
  const size_t n = in.size();
  if (n == 0) return;
  for (size_t i = 0; i < n; ++i) {
    const Pt& cur = in[i];
    const Pt& nxt = in[(i + 1) % n];
    const double c = axis == 0 ? cur.x : cur.y;
    const double d = axis == 0 ? nxt.x : nxt.y;
    const bool cin = keep_ge ? (c >= bound) : (c <= bound);
    const bool nin = keep_ge ? (d >= bound) : (d <= bound);
    if (cin) out.push_back(cur);
    if (cin != nin) {
      const double t = (bound - c) / (d - c);
      out.push_back({cur.x + t * (nxt.x - cur.x), cur.y + t * (nxt.y - cur.y)});
    }
  }
}

static double ring_area_abs(const std::vector<Pt>& ring) {
  const size_t n = ring.size();
  if (n < 3) return 0.0;
  double acc = 0.0;
  for (size_t i = 0; i < n; ++i) {
    const Pt& a = ring[i];
    const Pt& b = ring[(i + 1) % n];
    acc += a.x * b.y - b.x * a.y;
  }
  return std::fabs(0.5 * acc);
}

// |ring ∩ box| via Sutherland–Hodgman (box is convex).
static double ring_box_area(const std::vector<Pt>& ring, double xmin,
                            double ymin, double xmax, double ymax,
                            std::vector<Pt>& buf_a, std::vector<Pt>& buf_b) {
  clip_halfplane(ring, buf_a, 0, xmin, true);
  clip_halfplane(buf_a, buf_b, 0, xmax, false);
  clip_halfplane(buf_b, buf_a, 1, ymin, true);
  clip_halfplane(buf_a, buf_b, 1, ymax, false);
  return ring_area_abs(buf_b);
}

}  // namespace

extern "C" {

// Exact |polygon ∩ cell| for all cells of a regular window.
//
// xs/ys        : ring vertices, all rings concatenated
// ring_sizes   : vertex count per ring (ring 0 = shell, rest = holes)
// n_rings      : number of rings
// x0/y0        : coordinate of the window's first cell's lower-left corner
// dx/dy        : positive cell sizes; nx/ny cell counts
// out          : ny * nx area array (row-major, y slow)
void polygon_cell_areas(const double* xs, const double* ys,
                        const int64_t* ring_sizes, int64_t n_rings, double x0,
                        double dx, int64_t nx, double y0, double dy,
                        int64_t ny, double* out) {
  // parse rings once
  std::vector<std::vector<Pt>> rings(n_rings);
  {
    int64_t off = 0;
    for (int64_t r = 0; r < n_rings; ++r) {
      rings[r].reserve(ring_sizes[r]);
      for (int64_t i = 0; i < ring_sizes[r]; ++i)
        rings[r].push_back({xs[off + i], ys[off + i]});
      off += ring_sizes[r];
    }
  }
  std::vector<Pt> buf_a, buf_b;
  buf_a.reserve(64);
  buf_b.reserve(64);

  for (int64_t r = 0; r < n_rings; ++r) {
    const auto& ring = rings[r];
    if (ring.size() < 3) continue;
    // ring bbox limits the cell loop
    double rxmin = ring[0].x, rxmax = ring[0].x;
    double rymin = ring[0].y, rymax = ring[0].y;
    for (const Pt& p : ring) {
      rxmin = std::min(rxmin, p.x);
      rxmax = std::max(rxmax, p.x);
      rymin = std::min(rymin, p.y);
      rymax = std::max(rymax, p.y);
    }
    int64_t i0 = std::max<int64_t>(0, (int64_t)std::floor((rxmin - x0) / dx));
    int64_t i1 = std::min<int64_t>(nx, (int64_t)std::ceil((rxmax - x0) / dx));
    int64_t j0 = std::max<int64_t>(0, (int64_t)std::floor((rymin - y0) / dy));
    int64_t j1 = std::min<int64_t>(ny, (int64_t)std::ceil((rymax - y0) / dy));
    const double sign = (r == 0) ? 1.0 : -1.0;  // holes subtract
    for (int64_t j = j0; j < j1; ++j) {
      const double ylo = y0 + j * dy;
      for (int64_t i = i0; i < i1; ++i) {
        const double xlo = x0 + i * dx;
        const double a =
            ring_box_area(ring, xlo, ylo, xlo + dx, ylo + dy, buf_a, buf_b);
        if (a != 0.0) out[j * nx + i] += sign * a;
      }
    }
  }
}

// Even-odd point-in-polygon for a batch of points against one polygon
// (shell + holes as consecutive rings; even-odd across all rings).
// Result is XOR-ed into out (callers OR/accumulate across polygons).
void points_in_rings(const double* rxs, const double* rys,
                     const int64_t* ring_sizes, int64_t n_rings,
                     const double* px, const double* py, int64_t n_points,
                     uint8_t* out) {
  int64_t off = 0;
  for (int64_t r = 0; r < n_rings; ++r) {
    const int64_t n = ring_sizes[r];
    if (n == 0) continue;  // empty ring: the bbox init below would read OOB
    // bbox prefilter for this ring
    double rxmin = rxs[off], rxmax = rxs[off];
    double rymin = rys[off], rymax = rys[off];
    for (int64_t i = 1; i < n; ++i) {
      rxmin = std::min(rxmin, rxs[off + i]);
      rxmax = std::max(rxmax, rxs[off + i]);
      rymin = std::min(rymin, rys[off + i]);
      rymax = std::max(rymax, rys[off + i]);
    }
    for (int64_t p = 0; p < n_points; ++p) {
      const double x = px[p], y = py[p];
      if (x < rxmin || x > rxmax || y < rymin || y > rymax) continue;
      int crossings = 0;
      for (int64_t i = 0; i < n; ++i) {
        const double x1 = rxs[off + i], y1 = rys[off + i];
        const double x2 = rxs[off + (i + 1) % n], y2 = rys[off + (i + 1) % n];
        if ((y1 > y) != (y2 > y)) {
          const double xint = x1 + (y - y1) / (y2 - y1) * (x2 - x1);
          if (x < xint) ++crossings;
        }
      }
      if (crossings & 1) out[p] ^= 1;
    }
    off += n;
  }
}

}  // extern "C"
