// K2: closest hit of each ray over the flattened two-level BVH.
//
// Replaces the JAX package's Pallas search craytpu/ops/flash2.py::_kernel
// (built by build_flash2_fn). That kernel tested whole triangle blocks as
// double-bf16 matmuls because per-lane gathers are slow on a TPU; on this
// card gathers are cheap and a per-thread walk is the natural form. It
// computes what flash2 computes, with exact float32 tests, and returns
// bit for bit what the plain version (ops/traverse.py::traverse_plain)
// returns: same visit order, same tie rules, same roundings. Each ray
// visits its nodes in exactly the plain walk's order (near child first,
// far child pushed, a push dropped once stack_depth entries are in use),
// so a wide BVH, speculative or postponed leaf tests and child reordering
// are out: they would change winners.
//
// What bounds it on an H100: the latency of each ray's chain of dependent
// loads and emulated-fma arithmetic, with too few warps resident to hide
// it, and warp divergence between rays that take different paths. The
// bytes (the rays and the scene rows they touch) would take a few
// microseconds. What the design does about it:
//   - the scene is read through KernelLayout tables (ops/traverse.py::
//     build_layout), built once per scene: an inner node's visit is one
//     round of four 16-byte loads of its 64-byte record (both children's
//     bounds and (row, count)), where the Geometry arrays needed 14 scalar
//     loads in two dependent rounds; a leaf's triangles are consecutive
//     48-byte rows in leaf-slot order (three 16-byte loads each, no
//     prim_idx load per test); the winner's slot maps to its triangle id
//     once, at the end;
//   - the stack holds (node, row, count, instance) as one 16-byte entry,
//     so a pop needs no load from the scene. It lives in local memory
//     (KMAX_STACK entries, L1-cached); a top of 8 entries in shared memory
//     measured slower (PERF.md);
//   - "while-while" loop (Aila & Laine, HPG 2009): a lane visits inner
//     nodes until it reaches a leaf, then the warp's lanes that hold a
//     leaf test it together, so inner visits and leaf tests do not
//     alternate between diverged lanes; each ray's own order is unchanged;
//   - at most 72 registers a thread (__launch_bounds__ with 7 blocks of
//     128 an SM: 28 warps), which ptxas meets without spills. Without the
//     cap it takes 89 registers and measured faster at 2^16 rays but
//     slower on the 2^20 primary batches that take most of a frame.
// One thread a ray in 128-thread blocks. Persistent warps that fetch rays
// from a global counter measured slower at 2^20 rays and per frame: the
// hardware already refills each SM block by block, and refills from one
// counter mix distant rays in a warp (PERF.md).
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int KMAX_STACK = 160;
constexpr int INST_MESH = 0;
constexpr int INST_SPHERE = 1;
constexpr int THREADS = 128;
constexpr int MIN_BLOCKS = 7;  // blocks an SM: caps registers at 72

struct Scene {
  const float4* node_rec;    // (M, 4): inner node -> children's bounds and
                             //         (row, count), the last float4 int bits
  const float4* tri_leaf;    // (Q, 3): triangle rows in leaf-slot order
  const int* node_child;     // (M,) root rows
  const int* node_count;     // (M,) root counts
  const int* prim_idx;       // (Q,) TLAS slot -> instance; BLAS -> triangle
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

// slab test (intersect.node_intersect): plain mul + add, two roundings.
// b = minx, maxx, miny, maxy, minz, maxz
__device__ __forceinline__ bool node_hit(const float b[6], const float inv[3],
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

// one walk's state between node visits
struct Walk {
  float ow[3], dw[3];
  int node, row, count, inst, sp;
  float best_t;
  int best_slot, best_inst;
  int ray_inst;  // traversal-space ray of `inst`, kept until it changes
  float o[3], d[3], inv[3], ss[3];
  bool neg[3];
};

__device__ __forceinline__ void start_walk(Walk& w, const Scene& sc,
                                           const float* o_w,
                                           const float* d_w, int ray,
                                           float lim) {
  for (int i = 0; i < 3; ++i) {
    w.ow[i] = o_w[3 * ray + i];
    w.dw[i] = d_w[3 * ray + i];
  }
  w.node = 0;
  w.row = sc.node_child[0];
  w.count = sc.node_count[0];
  w.inst = -1;
  w.sp = 0;
  w.best_t = lim;
  w.best_slot = -1;
  w.best_inst = -1;
  w.ray_inst = -2;
}

// one node of the walk; false once the ray has finished. The order is
// traverse_plain's: BLAS leaf, TLAS leaf or inner node, then descend, pop
// or finish.
__device__ __forceinline__ bool visit(Walk& w, int4* stack, const Scene& sc) {
  if (w.inst != w.ray_inst) {
    w.ray_inst = w.inst;
    if (w.inst >= 0) {
      detm::space_ray(sc.inst_Ainv + 12 * w.inst, sc.inst_offset[w.inst],
                      w.ow, w.dw, w.o, w.d);
    } else {
      for (int i = 0; i < 3; ++i) {
        w.o[i] = w.ow[i];
        w.d[i] = w.dw[i];
      }
    }
    for (int i = 0; i < 3; ++i) {
      w.inv[i] = detm::exact_div(1.0f, w.d[i]);
      w.neg[i] = signbit(w.d[i]);
      w.ss[i] = __fmul_rn(-w.o[i], w.inv[i]);
    }
  }
  bool descend = false;
  int next = 0, next_row = 0, next_count = 0;
  if (w.count > 0 && w.node >= sc.tlas_end) {
    // BLAS leaf: its triangles in order, strict t < best
    for (int k = 0; k < w.count; ++k) {
      const float4* r = sc.tri_leaf + 3 * (w.row + k);
      const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
      const float tri[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                             b.z, b.w, c.x, c.y, c.z, c.w};
      float t, u, v;
      if (detm::tri_intersect(tri, w.o, w.d, t, u, v) && t < w.best_t) {
        w.best_t = t;
        w.best_slot = w.row + k;
        w.best_inst = w.inst;
      }
    }
  } else if (w.count > 0) {
    // TLAS leaf: spheres now (t >= 1e-5, t <= best), mesh roots pushed
    for (int k = 0; k < w.count; ++k) {
      const int ii = sc.prim_idx[w.row + k];
      const int kind = sc.inst_kind[ii];
      const int obj = sc.inst_obj[ii];
      if (kind == INST_SPHERE) {
        float os[3], ds[3], t0;
        detm::space_ray(sc.inst_Ainv + 12 * ii, sc.inst_offset[ii], w.ow,
                        w.dw, os, ds);
        if (detm::sphere_roots(sc.sph_radius[obj], os, ds, t0) &&
            t0 >= 1e-5f && t0 <= w.best_t) {
          w.best_t = t0;
          w.best_slot = -1;
          w.best_inst = ii;
        }
      } else if (kind == INST_MESH) {
        const int root = sc.blas_root[obj];
        if (root >= 0 && w.sp < sc.stack_depth) {
          stack[w.sp++] = make_int4(root, sc.node_child[root],
                                    sc.node_count[root], ii);
        }
      }
    }
  } else {
    // inner node: slab-test both children, descend near, push far
    const float4* r = sc.node_rec + 4 * w.node;
    const float4 a = __ldg(r), b = __ldg(r + 1), c = __ldg(r + 2);
    const int4 rc = __ldg(reinterpret_cast<const int4*>(r) + 3);
    const float bl[6] = {a.x, a.y, a.z, a.w, b.x, b.y};
    const float br[6] = {b.z, b.w, c.x, c.y, c.z, c.w};
    const int left = min(w.row, sc.n_nodes - 1);
    const int right = min(left + 1, sc.n_nodes - 1);
    float t_l, t_r;
    const bool hit_l = node_hit(bl, w.inv, w.ss, w.neg, w.best_t, t_l);
    const bool hit_r = node_hit(br, w.inv, w.ss, w.neg, w.best_t, t_r);
    bool both = hit_l && hit_r;
    const bool swap = both && (t_l > t_r);
    both = both && (w.sp < sc.stack_depth);  // overflow-safe push
    if (both) {
      stack[w.sp++] = swap ? make_int4(left, rc.x, rc.y, w.inst)
                           : make_int4(right, rc.z, rc.w, w.inst);
    }
    descend = both || (hit_l != hit_r);
    // both: the near child; one: the child that was hit
    const bool go_left = both ? !swap : hit_l;
    next = go_left ? left : right;
    next_row = go_left ? rc.x : rc.z;
    next_count = go_left ? rc.y : rc.w;
  }
  if (descend) {
    w.node = next;
    w.row = next_row;
    w.count = next_count;
  } else if (w.sp > 0) {
    const int4 e = stack[--w.sp];
    w.node = e.x;
    w.row = e.y;
    w.count = e.z;
    w.inst = e.w;
  } else {
    return false;
  }
  return true;
}

__device__ __forceinline__ void finish(const Walk& w, const Scene& sc, int ray,
                                       float* t_out, int* prim_out,
                                       int* inst_out) {
  t_out[ray] = w.best_t;
  prim_out[ray] = w.best_slot >= 0 ? sc.prim_idx[w.best_slot] : -1;
  inst_out[ray] = w.best_inst;
}

// a whole walk from where `w` stands, "while-while": inner nodes until a
// leaf, then the leaf; false once the ray has finished
__device__ __forceinline__ bool walk_to_leaf(Walk& w, int4* stack,
                                             const Scene& sc) {
  bool live = true;
  while (live && w.count <= 0) live = visit(w, stack, sc);
  return live && visit(w, stack, sc);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    closest_hit_kernel(const float* __restrict__ o_w,
                       const float* __restrict__ d_w,
                       const float* __restrict__ limit, int B, Scene sc,
                       float* __restrict__ t_out, int* __restrict__ prim_out,
                       int* __restrict__ inst_out) {
  const int ray = blockIdx.x * blockDim.x + threadIdx.x;
  if (ray >= B) return;
  const float lim = limit[ray];
  if (!(lim > 0.0f)) {  // dead lane: a miss, at once
    t_out[ray] = detm::FLT_MAX_F;
    prim_out[ray] = -1;
    inst_out[ray] = -1;
    return;
  }
  Walk w;
  // the walk's stack of (node, row, count, instance), in local memory
  int4 stack[KMAX_STACK];
  start_walk(w, sc, o_w, d_w, ray, lim);
  while (walk_to_leaf(w, stack, sc)) {
  }
  finish(w, sc, ray, t_out, prim_out, inst_out);
}

}  // namespace

extern "C" int craytpu_closest_hit(
    const float* o_w, const float* d_w, const float* limit, int B,
    const float* node_rec, const float* tri_leaf, const int* node_child,
    const int* node_count, const int* prim_idx, const float* inst_Ainv,
    const int* inst_kind, const int* inst_obj, const float* inst_offset,
    const int* blas_root, const float* sph_radius, int tlas_end, int n_nodes,
    int stack_depth, float* t_out, int* prim_out, int* inst_out,
    void* stream) {
  if (stack_depth > KMAX_STACK) return static_cast<int>(cudaErrorInvalidValue);
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + THREADS - 1) / THREADS;
  Scene sc{reinterpret_cast<const float4*>(node_rec),
           reinterpret_cast<const float4*>(tri_leaf),
           node_child, node_count, prim_idx, inst_Ainv, inst_kind, inst_obj,
           inst_offset, blas_root, sph_radius, tlas_end, n_nodes, stack_depth};
  closest_hit_kernel<<<blocks, THREADS, 0, st>>>(o_w, d_w, limit, B, sc, t_out,
                                                 prim_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}
