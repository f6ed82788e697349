// K2: closest hit of each ray over the flattened two-level BVH.
//
// Replaces the JAX package's Pallas search craytpu/ops/flash2.py::_kernel
// (built by build_flash2_fn). That kernel tested whole triangle blocks as
// double-bf16 matmuls because per-lane gathers are slow on a TPU; on this
// card gathers are cheap and a per-thread walk is the natural form. It
// computes what flash2 computes, with exact float32 tests, and returns
// bit for bit what the plain version (ops/traverse.py::traverse_plain)
// returns: same visit order, same tie rules, same roundings.
//
// One thread per ray. The stack (node, instance) lives in local memory,
// KMAX_STACK entries; a push is dropped once the scene's stack_depth
// entries are in use, exactly as in the plain version.
//
// What bounds it on an H100: the dependent node/triangle loads of the
// walk (latency of scattered reads through L1/L2 at 32-128 bytes each),
// and warp divergence between rays that take different paths. The
// arithmetic is ~10x the plain f32 work (emulated fmas, exact div/sqrt)
// but stays below the load latency. This first version does nothing about
// either beyond keeping the ray's traversal-space transform in registers
// until the instance changes; ray sorting for coherence is done by the
// integrator's Morton compaction, and shared-memory node caches or a wide
// BVH are later work.
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int KMAX_STACK = 160;
constexpr int INST_MESH = 0;
constexpr int INST_SPHERE = 1;

struct Scene {
  const float* node_bounds;  // (M, 6)
  const int* node_child;     // (M,)
  const int* node_count;     // (M,)
  const int* prim_idx;       // (Q,)
  const float* tri_packed;   // (P, 12)
  const float* inst_Ainv;    // (I, 12)
  const int* inst_kind;      // (I,)
  const int* inst_obj;       // (I,)
  const float* inst_offset;  // (I,)
  const int* blas_root;      // (num_meshes,)
  const float* sph_radius;   // (S,)
  int tlas_end;
  int n_nodes;
  int stack_depth;
};

// slab test (intersect.node_intersect): plain mul + add, two roundings
__device__ __forceinline__ bool node_hit(const float* b, const float inv[3],
                                         const float ss[3], const bool neg[3],
                                         float max_dist, float& t_entry) {
  float tn[3], tf[3];
  for (int a = 0; a < 3; ++a) {
    float lo = b[2 * a], hi = b[2 * a + 1];
    float near = neg[a] ? hi : lo;
    float far = neg[a] ? lo : hi;
    tn[a] = __fadd_rn(__fmul_rn(near, inv[a]), ss[a]);
    tf[a] = __fadd_rn(__fmul_rn(far, inv[a]), ss[a]);
  }
  // NaN-safe compare order (bvh.c:340-346)
  float t_min = tn[0] > tn[1] ? tn[0] : tn[1];
  float t_max = tf[0] < tf[1] ? tf[0] : tf[1];
  t_min = t_min > tn[2] ? t_min : tn[2];
  t_max = t_max < tf[2] ? t_max : tf[2];
  t_min = t_min > 0.0f ? t_min : 0.0f;
  t_max = t_max < max_dist ? t_max : max_dist;
  t_entry = t_min;
  return t_min <= t_max;
}

__global__ void closest_hit_kernel(const float* __restrict__ o_w,
                                   const float* __restrict__ d_w,
                                   const float* __restrict__ limit, int B,
                                   Scene sc, float* __restrict__ t_out,
                                   int* __restrict__ prim_out,
                                   int* __restrict__ inst_out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  float lim = limit[lane];
  if (!(lim > 0.0f)) {  // dead lane: a miss, at once
    t_out[lane] = detm::FLT_MAX_F;
    prim_out[lane] = -1;
    inst_out[lane] = -1;
    return;
  }
  const float ow[3] = {o_w[3 * lane], o_w[3 * lane + 1], o_w[3 * lane + 2]};
  const float dw[3] = {d_w[3 * lane], d_w[3 * lane + 1], d_w[3 * lane + 2]};

  int st_n[KMAX_STACK];
  int st_i[KMAX_STACK];
  int sp = 0;
  int node = 0, inst = -1;
  float best_t = lim;
  int best_prim = -1, best_inst = -1;

  // traversal-space ray of `inst`, kept until the instance changes
  int ray_inst = -2;
  float o[3], d[3], inv[3], ss[3];
  bool neg[3];

  while (true) {
    if (inst != ray_inst) {
      ray_inst = inst;
      if (inst >= 0) {
        detm::space_ray(sc.inst_Ainv + 12 * inst, sc.inst_offset[inst], ow,
                        dw, o, d);
      } else {
        for (int i = 0; i < 3; ++i) {
          o[i] = ow[i];
          d[i] = dw[i];
        }
      }
      for (int i = 0; i < 3; ++i) {
        inv[i] = detm::exact_div(1.0f, d[i]);
        neg[i] = signbit(d[i]);
        ss[i] = __fmul_rn(-o[i], inv[i]);
      }
    }
    int count = sc.node_count[node];
    int row = sc.node_child[node];
    bool descend = false;
    int next = node;
    if (count > 0 && node >= sc.tlas_end) {
      // BLAS leaf: its triangles in order, strict t < best
      for (int k = 0; k < count; ++k) {
        int pr = sc.prim_idx[row + k];
        float t, u, v;
        if (detm::tri_intersect(sc.tri_packed + 12 * pr, o, d, t, u, v) &&
            t < best_t) {
          best_t = t;
          best_prim = pr;
          best_inst = inst;
        }
      }
    } else if (count > 0) {
      // TLAS leaf: spheres now (t >= 1e-5, t <= best), mesh roots pushed
      for (int k = 0; k < count; ++k) {
        int ii = sc.prim_idx[row + k];
        int kind = sc.inst_kind[ii];
        int obj = sc.inst_obj[ii];
        if (kind == INST_SPHERE) {
          float os[3], ds[3], t0;
          detm::space_ray(sc.inst_Ainv + 12 * ii, sc.inst_offset[ii], ow, dw,
                          os, ds);
          if (detm::sphere_roots(sc.sph_radius[obj], os, ds, t0) &&
              t0 >= 1e-5f && t0 <= best_t) {
            best_t = t0;
            best_prim = -1;
            best_inst = ii;
          }
        } else if (kind == INST_MESH) {
          int root = sc.blas_root[obj];
          if (root >= 0 && sp < sc.stack_depth) {
            st_n[sp] = root;
            st_i[sp] = ii;
            ++sp;
          }
        }
      }
    } else {
      // inner node: slab-test both children, descend near, push far
      int left = min(row, sc.n_nodes - 1);
      int right = min(left + 1, sc.n_nodes - 1);
      float t_l, t_r;
      bool hit_l = node_hit(sc.node_bounds + 6 * left, inv, ss, neg, best_t,
                            t_l);
      bool hit_r = node_hit(sc.node_bounds + 6 * right, inv, ss, neg, best_t,
                            t_r);
      bool both = hit_l && hit_r;
      bool swap = both && (t_l > t_r);
      int near = swap ? right : left;
      int far = swap ? left : right;
      both = both && (sp < sc.stack_depth);  // overflow-safe push
      if (both) {
        st_n[sp] = far;
        st_i[sp] = inst;
        ++sp;
      }
      descend = both || (hit_l != hit_r);
      next = both ? near : (hit_l ? left : right);
    }
    if (descend) {
      node = next;
    } else if (sp > 0) {
      --sp;
      node = st_n[sp];
      inst = st_i[sp];
    } else {
      break;
    }
  }
  t_out[lane] = best_t;
  prim_out[lane] = best_prim;
  inst_out[lane] = best_inst;
}

}  // namespace

extern "C" int craytpu_closest_hit(
    const float* o_w, const float* d_w, const float* limit, int B,
    const float* node_bounds, const int* node_child, const int* node_count,
    const int* prim_idx, const float* tri_packed, const float* inst_Ainv,
    const int* inst_kind, const int* inst_obj, const float* inst_offset,
    const int* blas_root, const float* sph_radius, int tlas_end, int n_nodes,
    int stack_depth, float* t_out, int* prim_out, int* inst_out,
    void* stream) {
  if (stack_depth > KMAX_STACK) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  Scene sc{node_bounds, node_child, node_count, prim_idx, tri_packed,
           inst_Ainv,   inst_kind,  inst_obj,   inst_offset, blas_root,
           sph_radius,  tlas_end,   n_nodes,    stack_depth};
  const int threads = 128;
  const int blocks = (B + threads - 1) / threads;
  closest_hit_kernel<<<blocks, threads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      o_w, d_w, limit, B, sc, t_out, prim_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}
