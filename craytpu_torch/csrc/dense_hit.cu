// K3: closest hit of each ray by a dense search over every triangle of
// every instance, with no BVH (CRAYTPU_TRAVERSAL=dense).
//
// Replaces the JAX package's XLA dense search, craytpu/ops/dense_isect.py
// (_search_mesh, make_dense_traverse_fn): there a lax.scan over
// 256-triangle coefficient blocks, each a (B, 10) @ (10, 4*256) matmul of
// the ray features phi = [d, o, d x o, 1] with a divide, mask and argmin
// epilogue, the running best carried across instances. It is not a Pallas
// kernel; this is the port's kernel for it. It returns bit for bit what
// the plain version (ops/dense_isect.py::dense_hit_plain) returns: each
// bilinear quantity is the explicit sum of its products in phi's feature
// order, two roundings a term (-fmad=false), 1/det correctly rounded,
// the same validity mask, the same tie rules (a strict t < best over the
// triangles in row order, spheres by the walk's quadratic with
// t <= best, instances in index order).
//
// What bounds it on an H100: operations. Every (ray, triangle) pair costs
// 38 f32 operations (5 for det, 11 each for u*det and v*det, 6 for t*det,
// the reciprocal, 3 products, u + v) and 5 compares, none of them fused
// (-fmad=false), and there are rays x triangles of them: 1.4e11 pairs for
// one 2^20-ray batch of stress_highpoly, against 12 MB of rays and an
// 8.4 MB table. The bytes are nothing; the f32 lanes are everything. What
// the design does about it:
//   - one thread a ray, one launch a search, the instance loop inside the
//     kernel (stress_instances has 64 mesh instances; a launch each would
//     multiply the host overhead that bounds every path);
//   - a mesh's 64-byte coefficient rows (build_tri_table) stream through
//     shared memory in tiles of TILE rows, double-buffered with cp.async:
//     every thread of a block reads the same row at the same time (a
//     broadcast: four 16-byte shared loads a pair), and the next tile
//     lands while this one is searched;
//   - the running (t, triangle, instance) stays in registers; a block
//     whose lanes are all dead (a ragged pool) returns at once.
// Not done yet (later work): tensor cores through a split-precision
// product, per-block bounding-box culling, early det/t rejects.
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TILE = 256;  // triangle rows a shared-memory tile
constexpr int ROW = 4;     // float4s a row
constexpr int INST_SPHERE = 1;

__device__ __forceinline__ void cp_async16(float4* smem, const float4* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

// start copying rows [first, first + n) of the table into `buf`, as one
// commit group of this thread
__device__ __forceinline__ void load_tile(float4* buf, const float4* table,
                                          int first, int n) {
  const float4* src = table + static_cast<size_t>(first) * ROW;
  for (int k = threadIdx.x; k < n * ROW; k += THREADS) {
    cp_async16(buf + k, src + k);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// One mesh instance: rows [first, first + rows) of the table against the
// instance-space ray (o, d, w = d x o). Updates (best_t, best_prim);
// true if a triangle of this mesh became the best. Called by every thread
// of the block alike (it synchronises the block).
__device__ __forceinline__ bool search_mesh(float4 (*tiles)[TILE * ROW],
                                            const float4* table, int first,
                                            int rows, const float o[3],
                                            const float d[3],
                                            const float w[3], float& best_t,
                                            int& best_prim) {
  bool found = false;
  const int ntiles = (rows + TILE - 1) / TILE;
  load_tile(tiles[0], table, first, min(rows, TILE));
  for (int k = 0; k < ntiles; ++k) {
    const int next = (k + 1) * TILE;
    // the next tile's copies (an empty group after the last tile keeps
    // the wait below uniform), then wait for this tile's
    load_tile(tiles[(k + 1) & 1], table, first + next,
              k + 1 < ntiles ? min(rows - next, TILE) : 0);
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();
    const float4* tile = tiles[k & 1];
    const int n = min(rows - k * TILE, TILE);
    const int base = first + k * TILE;
    for (int j = 0; j < n; ++j) {
      // [n(3) v0xe2(3) -e2(3) v0xe1(3) -e1(3) n.v0]
      const float4 a = tile[ROW * j], b = tile[ROW * j + 1];
      const float4 c = tile[ROW * j + 2], e = tile[ROW * j + 3];
      const float det = __fadd_rn(
          __fadd_rn(__fmul_rn(d[0], a.x), __fmul_rn(d[1], a.y)),
          __fmul_rn(d[2], a.z));
      float ud = __fadd_rn(__fmul_rn(d[0], a.w), __fmul_rn(d[1], b.x));
      ud = __fadd_rn(ud, __fmul_rn(d[2], b.y));
      ud = __fadd_rn(ud, __fmul_rn(w[0], b.z));
      ud = __fadd_rn(ud, __fmul_rn(w[1], b.w));
      ud = __fadd_rn(ud, __fmul_rn(w[2], c.x));
      float vd = __fadd_rn(__fmul_rn(d[0], c.y), __fmul_rn(d[1], c.z));
      vd = __fadd_rn(vd, __fmul_rn(d[2], c.w));
      vd = __fadd_rn(vd, __fmul_rn(w[0], e.x));
      vd = __fadd_rn(vd, __fmul_rn(w[1], e.y));
      vd = __fadd_rn(vd, __fmul_rn(w[2], e.z));
      float td = __fadd_rn(__fmul_rn(o[0], -a.x), __fmul_rn(o[1], -a.y));
      td = __fadd_rn(td, __fmul_rn(o[2], -a.z));
      td = __fadd_rn(td, e.w);
      const float inv = __frcp_rn(det);  // 1/det, correctly rounded
      const float u = __fmul_rn(ud, inv);
      const float v = __fmul_rn(vd, inv);
      const float t = __fmul_rn(td, inv);
      // NaN fails every compare
      if (u >= 0.0f && v >= 0.0f && __fadd_rn(u, v) <= 1.0f && t >= 0.0f &&
          t < best_t) {
        best_t = t;
        best_prim = base + j;
        found = true;
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  return found;
}

__global__ void __launch_bounds__(THREADS)
    dense_hit_kernel(const float* __restrict__ o_w,
                     const float* __restrict__ d_w,
                     const float* __restrict__ limit, int B,
                     const float4* __restrict__ table,
                     const int4* __restrict__ plan, int n_inst,
                     const float* __restrict__ inst_Ainv,
                     const float* __restrict__ inst_offset,
                     const float* __restrict__ sph_radius,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     int* __restrict__ inst_out) {
  __shared__ __align__(16) float4 tiles[2][TILE * ROW];
  const int ray = blockIdx.x * THREADS + threadIdx.x;
  const bool in = ray < B;
  // a lane past B searches as a dead lane (the block synchronises)
  const float lim = in ? limit[ray] : 0.0f;
  if (!__syncthreads_or(lim > 0.0f)) {  // the whole block is dead
    if (in) {
      t_out[ray] = detm::FLT_MAX_F;
      prim_out[ray] = -1;
      inst_out[ray] = -1;
    }
    return;
  }
  float ow[3], dw[3];
  for (int i = 0; i < 3; ++i) {
    ow[i] = in ? o_w[3 * ray + i] : 0.0f;
    dw[i] = in ? d_w[3 * ray + i] : 0.0f;
  }
  // a dead lane keeps its limit (not > 0): no t >= 0 is below it
  float best_t = lim;
  int best_prim = -1, best_inst = -1;
  for (int i = 0; i < n_inst; ++i) {
    const int4 p = __ldg(plan + i);  // kind, first row, rows, object
    if (p.x != INST_SPHERE && p.z == 0) continue;
    float o[3], d[3];
    detm::space_ray(inst_Ainv + 12 * i, inst_offset[i], ow, dw, o, d);
    if (p.x == INST_SPHERE) {
      float t0;
      if (detm::sphere_roots(sph_radius[p.w], o, d, t0) && t0 >= 1e-5f &&
          t0 <= best_t) {
        best_t = t0;
        best_prim = -1;
        best_inst = i;
      }
    } else {
      float w[3];
      detm::cross(d, o, w);
      if (search_mesh(tiles, table, p.y, p.z, o, d, w, best_t, best_prim)) {
        best_inst = i;
      }
    }
  }
  if (!in) return;
  const bool dead = !(lim > 0.0f);
  t_out[ray] = dead ? detm::FLT_MAX_F : best_t;
  prim_out[ray] = dead ? -1 : best_prim;
  inst_out[ray] = dead ? -1 : best_inst;
}

}  // namespace

extern "C" int craytpu_dense_hit(const float* o_w, const float* d_w,
                                 const float* limit, int B,
                                 const float* table, const int* plan,
                                 int n_inst, const float* inst_Ainv,
                                 const float* inst_offset,
                                 const float* sph_radius, float* t_out,
                                 int* prim_out, int* inst_out, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + THREADS - 1) / THREADS;
  dense_hit_kernel<<<blocks, THREADS, 0, st>>>(
      o_w, d_w, limit, B, reinterpret_cast<const float4*>(table),
      reinterpret_cast<const int4*>(plan), n_inst, inst_Ainv, inst_offset,
      sph_radius, t_out, prim_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}
