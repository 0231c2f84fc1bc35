// Native sweep-SAH BVH builder.
//
// Same algorithm and cost model as the Python builder in
// accel/bvh.py (which mirrors the reference's semantics,
// src/bvh.cpp:48-230): three stably-maintained per-axis centroid
// orders, 12 value-spaced candidate planes per axis, split cost
//   5 + (sa1/sa)*n1*2 + (sa2/sa)*n2*2
// against leaf cost 2n, stable partition of all three orders on the
// winning plane.  Tie-breaking matches the Python builder exactly
// (axis-major, plane-ascending, strict improvement), so both backends
// produce identical trees.
//
// Exposed via a plain C ABI for ctypes (no Python headers needed).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Builder {
  const double* pmin;  // [n][3]
  const double* pmax;  // [n][3]
  std::vector<double> cen;  // [n][3] centroids
  int n, max_leaf, bins;
  std::vector<int64_t> orders[3];
  std::vector<int64_t> sorted_order;
  std::vector<uint8_t> mask;

  // flat node output (preorder): bounds [cap][6], info [cap][4]
  double* node_bounds;
  int64_t* node_info;  // start, range, left, right (-1,-1 for leaf)
  int cap;
  int count = 0;
  bool overflow = false;
  // scratch reused across nodes (avoids per-node allocation)
  std::vector<double> pre, suf;
  std::vector<int64_t> tmp;

  static double surface_area(const double lo[3], const double hi[3]) {
    double e0 = hi[0] - lo[0], e1 = hi[1] - lo[1], e2 = hi[2] - lo[2];
    return 2.0 * (e0 * e1 + e1 * e2 + e2 * e0);
  }

  int emit(const double lo[3], const double hi[3], int64_t start,
           int64_t range) {
    if (count >= cap) {
      overflow = true;
      return -1;
    }
    int id = count++;
    std::memcpy(node_bounds + 6 * id, lo, 3 * sizeof(double));
    std::memcpy(node_bounds + 6 * id + 3, hi, 3 * sizeof(double));
    node_info[4 * id + 0] = start;
    node_info[4 * id + 1] = range;
    node_info[4 * id + 2] = -1;
    node_info[4 * id + 3] = -1;
    return id;
  }

  int build(int64_t start, int64_t end, const double bb_min[3],
            const double bb_max[3]) {
    const int64_t nn = end - start;
    int id = emit(bb_min, bb_max, start, nn);
    if (id < 0) return -1;
    if (nn <= max_leaf) {
      for (int64_t i = start; i < end; ++i)
        sorted_order[i] = orders[0][i];
      return id;
    }
    const double total_sa = surface_area(bb_min, bb_max);
    if (total_sa < 1e-15) {
      for (int64_t i = start; i < end; ++i)
        sorted_order[i] = orders[0][i];
      return id;
    }

    const double current_cost = 2.0 * double(nn);
    double best_cost = std::numeric_limits<double>::infinity();
    int best_axis = -1;
    int64_t best_n1 = 0;
    double best_l[6], best_r[6];
    bool have_best = false;

    // per-axis sweep buffers (prefix/suffix bboxes over the subrange)

    for (int axis = 0; axis < 3; ++axis) {
      const int64_t* idx = orders[axis].data() + start;
      const double startval = cen[3 * idx[0] + axis];
      const double endval = cen[3 * idx[nn - 1] + axis];
      if (endval <= startval) continue;

      // prefix sweep
      for (int64_t k = 0; k < nn; ++k) {
        const double* lo = pmin + 3 * idx[k];
        const double* hi = pmax + 3 * idx[k];
        double* o = pre.data() + 6 * k;
        if (k == 0) {
          for (int a = 0; a < 3; ++a) { o[a] = lo[a]; o[3 + a] = hi[a]; }
        } else {
          const double* p = pre.data() + 6 * (k - 1);
          for (int a = 0; a < 3; ++a) {
            o[a] = std::min(p[a], lo[a]);
            o[3 + a] = std::max(p[3 + a], hi[a]);
          }
        }
      }
      // suffix sweep
      for (int64_t k = nn - 1; k >= 0; --k) {
        const double* lo = pmin + 3 * idx[k];
        const double* hi = pmax + 3 * idx[k];
        double* o = suf.data() + 6 * k;
        if (k == nn - 1) {
          for (int a = 0; a < 3; ++a) { o[a] = lo[a]; o[3 + a] = hi[a]; }
        } else {
          const double* s = suf.data() + 6 * (k + 1);
          for (int a = 0; a < 3; ++a) {
            o[a] = std::min(s[a], lo[a]);
            o[3 + a] = std::max(s[3 + a], hi[a]);
          }
        }
      }

      for (int k = 1; k <= bins; ++k) {
        const double divider =
            startval + double(k) * ((endval - startval) / double(bins + 1));
        // count of centroids <= divider (searchsorted side='right')
        int64_t lo_i = 0, hi_i = nn;
        while (lo_i < hi_i) {
          int64_t mid = (lo_i + hi_i) / 2;
          if (cen[3 * idx[mid] + axis] <= divider) lo_i = mid + 1;
          else hi_i = mid;
        }
        const int64_t n1 = lo_i, n2 = nn - n1;
        if (n1 == 0 || n2 == 0) continue;
        const double sa1 = surface_area(pre.data() + 6 * (n1 - 1),
                                        pre.data() + 6 * (n1 - 1) + 3);
        const double sa2 = surface_area(suf.data() + 6 * n1,
                                        suf.data() + 6 * n1 + 3);
        const double cost = 5.0 + (sa1 / total_sa) * double(n1) * 2.0 +
                            (sa2 / total_sa) * double(n2) * 2.0;
        if ((!have_best || cost < best_cost) && cost < current_cost) {
          have_best = true;
          best_cost = cost;
          best_axis = axis;
          best_n1 = n1;
          std::memcpy(best_l, pre.data() + 6 * (n1 - 1), 6 * sizeof(double));
          std::memcpy(best_r, suf.data() + 6 * n1, 6 * sizeof(double));
        }
      }
    }

    if (!have_best) {  // no split beats the leaf cost
      for (int64_t i = start; i < end; ++i)
        sorted_order[i] = orders[0][i];
      return id;
    }

    // stable partition of all three axis orders by left membership
    const int64_t* widx = orders[best_axis].data() + start;
    for (int64_t k = 0; k < best_n1; ++k) mask[widx[k]] = 1;
    for (int a = 0; a < 3; ++a) {
      int64_t* sl = orders[a].data() + start;
      int64_t w = 0;
      for (int64_t k = 0; k < nn; ++k)
        if (mask[sl[k]]) tmp[w++] = sl[k];
      for (int64_t k = 0; k < nn; ++k)
        if (!mask[sl[k]]) tmp[w++] = sl[k];
      std::memcpy(sl, tmp.data(), nn * sizeof(int64_t));
    }
    for (int64_t k = 0; k < best_n1; ++k) mask[widx[k]] = 0;
    // NOTE: widx now points at the partitioned order; the first n1
    // entries are exactly the left set (stable partition keeps them
    // in front), so clearing through it is correct.

    int l = build(start, start + best_n1, best_l, best_l + 3);
    int r = build(start + best_n1, end, best_r, best_r + 3);
    node_info[4 * id + 2] = l;
    node_info[4 * id + 3] = r;
    return id;
  }
};

}  // namespace

extern "C" {

// Returns node count, or -1 on node-capacity overflow.
int bvh_build(const double* prim_min, const double* prim_max, int n,
              int max_leaf, int bins, int64_t* sorted_order,
              double* node_bounds, int64_t* node_info, int cap) {
  if (n <= 0) return 0;
  Builder b;
  b.pmin = prim_min;
  b.pmax = prim_max;
  b.n = n;
  b.max_leaf = max_leaf;
  b.bins = bins;
  b.node_bounds = node_bounds;
  b.node_info = node_info;
  b.cap = cap;
  b.cen.resize(size_t(n) * 3);
  for (int64_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a)
      b.cen[3 * i + a] = 0.5 * (prim_min[3 * i + a] + prim_max[3 * i + a]);

  for (int a = 0; a < 3; ++a) {
    b.orders[a].resize(n);
    for (int64_t i = 0; i < n; ++i) b.orders[a][i] = i;
    const double* c = b.cen.data();
    std::stable_sort(b.orders[a].begin(), b.orders[a].end(),
                     [c, a](int64_t x, int64_t y) {
                       return c[3 * x + a] < c[3 * y + a];
                     });
  }
  b.sorted_order.assign(n, 0);
  b.mask.assign(n, 0);
  b.pre.resize(size_t(n) * 6);
  b.suf.resize(size_t(n) * 6);
  b.tmp.resize(n);

  double root_min[3], root_max[3];
  for (int a = 0; a < 3; ++a) {
    root_min[a] = std::numeric_limits<double>::infinity();
    root_max[a] = -std::numeric_limits<double>::infinity();
  }
  for (int64_t i = 0; i < n; ++i)
    for (int a = 0; a < 3; ++a) {
      root_min[a] = std::min(root_min[a], prim_min[3 * i + a]);
      root_max[a] = std::max(root_max[a], prim_max[3 * i + a]);
    }

  b.build(0, n, root_min, root_max);
  if (b.overflow) return -1;
  std::memcpy(sorted_order, b.sorted_order.data(), n * sizeof(int64_t));
  return b.count;
}

}  // extern "C"
