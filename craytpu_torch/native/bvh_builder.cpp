// Binned-SAH BVH builder — the native fast path behind craytpu/accel/bvh.py.
//
// Same algorithm as the reference builder (accelerators/bvh.c:80-287):
// 32 bins x 3 axes, right-to-left partial-cost sweep then left-to-right
// full-cost sweep with strict less-than selection, leaf cutoff
// primCount < 2 or depth >= 64, approximate-median fallback for leaves
// that would exceed 16 prims, Hoare-style in-place partition, preorder
// node allocation. Float32 math and comparison semantics match the Python
// builder exactly, so both paths produce the identical node array and
// primitive ordering (asserted by tests/test_native_bvh.py).
//
// Compiled on demand by craytpu/native/__init__.py (g++ -O2, no
// -ffast-math: SAH sweeps rely on IEEE inf/NaN comparison behavior).

#include <cfloat>
#include <cstdint>
#include <cstdlib>

namespace {

constexpr int kBinCount = 32;
constexpr int kMaxDepth = 64;
constexpr std::uint32_t kMaxLeafSize = 16;
constexpr float kTraversalCost = 1.5f;

struct BBox {
  float lo[3];
  float hi[3];
};

inline BBox empty_bbox() {
  return {{FLT_MAX, FLT_MAX, FLT_MAX}, {-FLT_MAX, -FLT_MAX, -FLT_MAX}};
}

inline void extend(BBox &a, const BBox &b) {
  for (int k = 0; k < 3; ++k) {
    a.lo[k] = a.lo[k] < b.lo[k] ? a.lo[k] : b.lo[k];
    a.hi[k] = a.hi[k] > b.hi[k] ? a.hi[k] : b.hi[k];
  }
}

inline float half_area(const BBox &b) {
  // empty boxes overflow to +/-inf products, same as the reference
  float ex = b.hi[0] - b.lo[0];
  float ey = b.hi[1] - b.lo[1];
  float ez = b.hi[2] - b.lo[2];
  return ex * (ey + ez) + ey * ez;
}

// floatIndex semantics shared with bvh.py _bin_indices: negative and NaN
// map to bin 0, +inf and anything >= BIN_COUNT to the last bin.
inline std::uint32_t bin_index(float coord, float mn, float mx) {
  float center_to_bin = static_cast<float>(kBinCount) / (mx - mn);
  float fi = (coord - mn) * center_to_bin;
  if (!(fi >= 0.0f)) return 0;  // negative or NaN
  if (fi >= static_cast<float>(kBinCount)) return kBinCount - 1;
  return static_cast<std::uint32_t>(fi);
}

struct Builder {
  const float *bb_lo;    // (n, 3)
  const float *bb_hi;    // (n, 3)
  const float *centers;  // (n, 3)
  float *bounds;         // (2n-1, 6) minx,maxx,miny,maxy,minz,maxz
  std::int32_t *child;
  std::int32_t *count;
  std::int32_t *prim;    // (n,)
  std::int64_t node_count;

  void make_leaf(std::int64_t node, std::uint32_t begin, std::uint32_t cnt) {
    child[node] = static_cast<std::int32_t>(begin);
    count[node] = static_cast<std::int32_t>(cnt);
  }

  std::uint32_t partition(std::int64_t node, int axis, std::uint32_t bin,
                          std::uint32_t begin, std::uint32_t end) {
    const float mn = bounds[node * 6 + axis * 2];
    const float mx = bounds[node * 6 + axis * 2 + 1];
    std::uint32_t i = begin, j = end;
    while (i < j) {
      while (i < j) {
        if (bin_index(centers[prim[i] * 3 + axis], mn, mx) >= bin) break;
        ++i;
      }
      while (i < j) {
        if (bin_index(centers[prim[j - 1] * 3 + axis], mn, mx) < bin) break;
        --j;
      }
      if (i >= j) break;
      std::int32_t tmp = prim[j - 1];
      prim[j - 1] = prim[i];
      prim[i] = tmp;
      --j;
      ++i;
    }
    return i;
  }

  void build(std::int64_t node, std::uint32_t begin, std::uint32_t end,
             int depth) {
    std::uint32_t prim_count = end - begin;
    if (depth >= kMaxDepth || prim_count < 2) {
      make_leaf(node, begin, prim_count);
      return;
    }

    BBox bins[3][kBinCount];
    std::uint32_t bin_cnt[3][kBinCount];
    float bin_cost[kBinCount];
    float min_cost[3] = {FLT_MAX, FLT_MAX, FLT_MAX};
    std::uint32_t min_bin[3] = {1, 1, 1};

    for (int axis = 0; axis < 3; ++axis) {
      const float mn = bounds[node * 6 + axis * 2];
      const float mx = bounds[node * 6 + axis * 2 + 1];
      for (int i = 0; i < kBinCount; ++i) {
        bins[axis][i] = empty_bbox();
        bin_cnt[axis][i] = 0;
      }
      for (std::uint32_t i = begin; i < end; ++i) {
        const std::int32_t p = prim[i];
        const std::uint32_t bi = bin_index(centers[p * 3 + axis], mn, mx);
        BBox pb;
        for (int k = 0; k < 3; ++k) {
          pb.lo[k] = bb_lo[p * 3 + k];
          pb.hi[k] = bb_hi[p * 3 + k];
        }
        extend(bins[axis][bi], pb);
        bin_cnt[axis][bi]++;
      }
      // right-to-left partial cost
      BBox cur = empty_bbox();
      std::uint32_t cur_cnt = 0;
      for (int i = kBinCount; i > 1; --i) {
        cur_cnt += bin_cnt[axis][i - 1];
        extend(cur, bins[axis][i - 1]);
        bin_cost[i - 1] = static_cast<float>(cur_cnt) * half_area(cur);
      }
      // left-to-right full cost, strict less-than
      cur = empty_bbox();
      cur_cnt = 0;
      for (int i = 0; i < kBinCount - 1; ++i) {
        cur_cnt += bin_cnt[axis][i];
        extend(cur, bins[axis][i]);
        float cost = static_cast<float>(cur_cnt) * half_area(cur)
                     + bin_cost[i + 1];
        if (cost < min_cost[axis]) {
          min_bin[axis] = i + 1;
          min_cost[axis] = cost;
        }
      }
    }

    int min_axis = 0;
    if (min_cost[1] < min_cost[0]) min_axis = 1;
    if (min_cost[2] < min_cost[min_axis]) min_axis = 2;

    BBox nb;
    for (int k = 0; k < 3; ++k) {
      nb.lo[k] = bounds[node * 6 + k * 2];
      nb.hi[k] = bounds[node * 6 + k * 2 + 1];
    }
    float leaf_cost = half_area(nb)
                      * (static_cast<float>(prim_count) - kTraversalCost);
    if (min_cost[min_axis] > leaf_cost) {
      if (prim_count > kMaxLeafSize) {
        std::uint32_t accum = 0, best_approx = prim_count;
        for (int i = 0; i < kBinCount - 1; ++i) {
          accum += bin_cnt[min_axis][i];
          std::uint32_t approx = static_cast<std::uint32_t>(
              std::abs(static_cast<int>(prim_count) / 2
                       - static_cast<int>(accum)));
          if (approx < best_approx) {
            best_approx = approx;
            min_bin[min_axis] = i + 1;
          }
        }
      } else {
        make_leaf(node, begin, prim_count);
        return;
      }
    }

    std::uint32_t begin_right =
        partition(node, min_axis, min_bin[min_axis], begin, end);
    if (begin_right > begin) {
      std::int64_t left = node_count;
      std::int64_t right = left + 1;
      node_count += 2;
      BBox lb = empty_bbox(), rb = empty_bbox();
      for (std::uint32_t i = 0; i < min_bin[min_axis]; ++i)
        extend(lb, bins[min_axis][i]);
      for (std::uint32_t i = min_bin[min_axis]; i < kBinCount; ++i)
        extend(rb, bins[min_axis][i]);
      for (int k = 0; k < 3; ++k) {
        bounds[left * 6 + k * 2] = lb.lo[k];
        bounds[left * 6 + k * 2 + 1] = lb.hi[k];
        bounds[right * 6 + k * 2] = rb.lo[k];
        bounds[right * 6 + k * 2 + 1] = rb.hi[k];
      }
      child[node] = static_cast<std::int32_t>(left);
      count[node] = 0;
      build(left, begin, begin_right, depth + 1);
      build(right, begin_right, end, depth + 1);
    } else {
      make_leaf(node, begin, prim_count);
    }
  }
};

}  // namespace

extern "C" std::int64_t craytpu_build_bvh(
    const float *bb_lo, const float *bb_hi, const float *centers,
    std::int32_t n, float *bounds, std::int32_t *child, std::int32_t *count,
    std::int32_t *prim) {
  if (n < 1) return 0;
  Builder b{bb_lo, bb_hi, centers, bounds, child, count, prim, 1};
  for (std::int32_t i = 0; i < n; ++i) prim[i] = i;
  BBox root = empty_bbox();
  for (std::int32_t p = 0; p < n; ++p) {
    BBox pb;
    for (int k = 0; k < 3; ++k) {
      pb.lo[k] = bb_lo[p * 3 + k];
      pb.hi[k] = bb_hi[p * 3 + k];
    }
    extend(root, pb);
  }
  for (int k = 0; k < 3; ++k) {
    bounds[k * 2] = root.lo[k];
    bounds[k * 2 + 1] = root.hi[k];
  }
  b.build(0, 0, static_cast<std::uint32_t>(n), 0);
  return b.node_count;
}
