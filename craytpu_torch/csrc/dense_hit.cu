// K3: closest hit of each ray by a dense search over the triangles of
// every instance, with no BVH walk (CRAYTPU_TRAVERSAL=dense).
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
// the same validity mask; instances in index order, spheres by the
// walk's quadratic with t <= best.
//
// What bounds it on an H100: operations. A (ray, triangle) pair costs 13
// f32 operations to reject on its t (5 for det, 6 for t*det, the
// reciprocal, t) and 25 more for u*det, v*det, u, v and u + v, none fused
// (-fmad=false); testing every pair is 1.4e11 pairs for one 2^20-ray
// batch of stress_highpoly. So the design tests few pairs:
//   - each mesh's 64-byte coefficient rows are in its BLAS leaf order
//     (DenseLayout.leaf_table, the triangle id of each row beside it in
//     leaf_ids), cut into groups of GROUP = 32 rows and superblocks of
//     SUPER = 8 groups (TILE = 256 rows, one shared-memory tile), each
//     with its mesh-space box, the mesh with its root box, so that a box
//     holds triangles that lie together; within each run of SUPER
//     superblocks the rows are regrouped into superblocks, and within
//     each superblock into groups, by normal or by place
//     (ops/dense_isect.py::leaf_groups), so that the plane test below
//     sees narrow cones;
//   - a ray that cannot use the root box skips the instance (the block
//     skips it when no lane can, __syncthreads_or); each lane votes on
//     each superblock box of a pass of SB_CHUNK superblocks, the votes of
//     a warp go into a bit mask (__any_sync) that the block ors together,
//     and the block streams only the voted superblocks through shared
//     memory, double-buffered with cp.async (rows, ids and group boxes);
//     in a loaded superblock a warp skips a group unless one of its lanes
//     votes for the group's box (__any_sync);
//   - in a group it runs, a pair computes det, t*det and t first and
//     u*det, v*det, u, v only where 0 <= t <= best (each quantity by the
//     same operations in the same order as the plain version's);
//   - one thread a ray, one launch a search, the instance loop inside the
//     kernel; the running (t, triangle, instance) stays in registers; a
//     block whose lanes are all dead returns at once.
//
// Tie contract (the leaf order is not the id order): inside one mesh
// instance a pair wins on t < best, or on t == best when the best is a
// triangle of this same instance with a higher id; across instances a
// mesh needs t < best (the earlier instance keeps an equal hit); a sphere
// wins on t <= best. The plain version scans ids in order with a strict
// <, so both pick the least (t, id) of each instance, and the same
// result.
//
// The cull is conservative for every pair whose ray is at least THETA =
// 2^-5 (1.8 degrees) off its triangle's plane. Let u = 2^-24, the ray
// (o, d) in instance space (rounded, but exactly what the pair test
// uses), O = max|o_i|, A = max|d_i|; for a triangle, V >= max|coordinate|
// of its vertices (the box's), L <= 2V its largest edge component. The
// table's coefficients carry rounding: |n_i err| <= 4uL^2 (compile's n),
// v0 x e2 and v0 x e1 <= 4.01uVL each component (numpy), n.v0 <=
// 30.2uL^2 V against the exact n.v0; w = d x o <= 4.1uAO (exact and fast
// forms). With recursive-summation bounds (gamma_k <= 1.01ku), the
// computed quantities lie within
//     E_det <= 30.2 u A L^2,  E_ud, E_vd <= 49 u A L (V + O),
//     E_td  <= 55 u L^2 (V + O)
// of the exact Möller–Trumbore values of the triangle with the exact
// vertices. For a pair the plain test accepts (u_c, v_c >= 0,
// u_c + v_c <= 1 + 1.01u, 0 <= t_c <= best) with |det| >= rho A L^2:
//     |u* - u_c| <= 2.03u + 49u (V + O) / (rho L) + 30.6u / rho  (so v),
//     |t* - t_c| <= t_c (2.03u + 30.2u / rho) + 55u (V + O) / (rho A),
// and the exact ray point at t*, v0 + u*(v1 - v0) + v*(v2 - v0), lies
// within sqrt(3) L (|du| + |dv|) + 1.75uL <= u (382 / rho + 18) (V + O)
// of the triangle. At rho = RHO = 2^-6 that is
//     box margin   K_BOX = 382 / RHO + 18 = 24,466 u (V + O),
//     t margin     t * K_REL u + K_ABS u (V + O) / A,
//                  K_REL = 2.03 + 30.2 / RHO = 1,935,
//                  K_ABS = 55 / RHO = 3,520
// (about 1.5e-3 (V + O): 6e-3 on stress_highpoly, whose triangles are
// about 0.014 across in mesh space). Each margin is a / rho + b with a, b
// >= 0, so at any rho >= RHO / F (F >= 1) it is at most F times its value
// at RHO.
//
// Which rho a ray has: a ray at angle alpha to the plane of a triangle
// with exact normal n has |det| = |d| |n| sin(alpha) >= A mu L^2
// sin(alpha), mu = |n| / L^2 the triangle's shape (a sliver's mu is
// small). So rho >= THETA mu for every ray at least THETA off the plane.
// Each box carries in its eighth float F = max(1, RHO / (THETA mu_min)),
// mu_min the least mu of its triangles (ops/dense_isect.py::box_factor,
// in float64, rounded up; +inf for a degenerate triangle), and scales
// the margins by it: a box whose inflated slab interval misses [-K_ABS F
// u (V + O) / A, best (1 + K_REL F u) + K_ABS F u (V + O) / A] holds no
// pair the plain test accepts at or below the best with its ray at least
// THETA off the triangle's plane.
//
// The slab test alone does not cover a pair with |det| < rho A L^2,
// rho = RHO / F: the margins grow as 1 / rho, and for a ray in the plane
// det, u*det, v*det and t*det are all rounding errors, so the plain test
// may accept the pair (rarely: all four must fall the right way) with t
// anywhere on the ray. Such a pair has a ray line that lies nearly in
// the triangle's plane, wherever the triangle is, and the plane test
// keeps every box that may hold one:
//
// Let r = v0 - o and M = r x d, the moment of the ray's line about v0
// (exact). Then u*det = d.(r x e2) = -e2.M and v*det = -e1.M exactly,
// and for the part M_p of M in the plane (M_p = M - (M.n^) n^),
// |M_p| |n| = |M_p x n| = |e1 (M.e2) - e2 (M.e1)| <= sqrt(3) L (|u*det| +
// |v*det|). An accepted pair has u, v >= 0 and u + v <= 1 as computed,
// so |ud_c|, |vd_c| <= |det_c| (1 + 3.02u) (the roundings of 1/det, of
// the products and of u + v; an underflow only shrinks them, an overflow
// of 1/det rejects the pair), and with the error bounds above
//     |u*det|, |v*det| <= (|det| + E_det)(1 + 3.02u) + E_ud.
// With |det| < rho A L^2, rho / mu <= THETA (F >= RHO / (THETA mu_min):
// rho = RHO / F <= THETA mu_min), 1 / mu <= 1 / mu_min <= 2F, L <= L_B
// (the box's largest extent) and L <= 2V:
//     |M_p| <= 2 sqrt(3) A ((rho + 30.3u) L + 49u (V + O)) / mu
//           <= A (K_T L_B + C_W F (V + O)),
//     K_T = 2 sqrt(3) THETA = 0.10826,  C_W = 4 sqrt(3) 109.6 u <= 760u.
// So the line's plane through v0 has its normal M / |M| within |M_p| /
// |M| of the triangle's normal n^ (up to sign). Each box carries the cone
// [c, S] of its triangles' unit normals (ops/dense_isect.py::box_cone,
// in float64: S >= max |n^_k - c^| over its triangles, each n^_k's sign
// turned toward c^ = c / |c|, plus its own float64 error and 2^-20,
// rounded up). For the box's centre p = (lo + hi) * 0.5 (as computed;
// every point of the box lies within R = K_R L_B + E_V V of it, K_R =
// 0.8661 > sqrt(3) / 2 with the rounding of L_B, E_V = 2^-21 > 1.75u for
// the centre's roundings) and any vertex v0 of the box, |M(v0) - M(p)|
// = |(v0 - p) x d| <= R |d|; and for a normal n^ within S of c^,
//     |M(v0) x n^| >= |M(p) x c^| - S |M(p)| - R |d|.
// The pair is possible only if that is at most A (K_T L_B + C_W F (V +
// O)). The kernel computes x = p - o, X = max |x_i|, M = x x d and q = M x
// c in round to nearest: x's and M's roundings move M by at most 7u X
// |d| (E_X X |d| below, E_X = 2^-18); q's, by at most 5.2u |M|, which
// the 2^-20 in S covers; |c| differs from 1 by at most 2^-23. The box is
// culled by the plane test only if
//     |q| > (S |M| + T) * SLACK,
//     T = |d| (K_R L_B + E_V V + E_X X) + A (K_T L_B + C_W (V + O) F),
// SLACK = 1 + 2^-16 covering the roundings of the sums, products and
// roots of the test (each a few u relative, every term positive). A box
// is kept if the slab test or the plane test keeps it, so a box that
// holds a pair the plain test accepts at or below the best is kept for
// every ray: with |det| >= rho A L^2 by the slab test, below it by the
// plane test. There is no band of rays the guarantee leaves out.
//
// What it costs: on a displaced mesh the normals of one group spread
// widely, so the plane test keeps many boxes whose slabs the ray misses:
// a ray's line lies nearly in some plane of a box's cone, within its
// reach, far more often than in the plane of one of its triangles
// (scripts/dense_cull_band.py prints S and each test's keep rate).
//
// The slab test (box_keep, and ops/dense_isect.py::slab_keep operation
// for operation) rounds to nearest and encloses instead: the margins are
// passed rounded up with room for their own roundings (MARGIN_BOX =
// 1.01 (K_BOX + 2) u, MARGIN_REL = (K_REL + 4) u, MARGIN_ABS = 1.01
// K_ABS u; the few roundings of (O + V) F and of the products with it
// are within the 1.01, and 1 + MARGIN_REL F rounds to at least 1 +
// (K_REL F + 2.9) u); a slab end (x - o) * (1/d) is within 3.01u of its
// exact value relatively, so the entry (the max over axes) is widened by
// WIDEN = 2^-20 = 16u relatively and FLT_MIN absolutely (subnormal
// products), the exit likewise; fmaxf/fminf drop the NaN of a d_i = 0
// axis whose origin lies on a slab plane (that axis does not bound the
// ray), and a NaN comparison keeps the box. The plane test
// (ops/dense_isect.py::plane_keep) likewise; roots correctly rounded.
// Dead lanes vote for nothing.
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int GROUP = 32;               // rows a group (one warp's vote)
constexpr int SUPER = 8;                // groups a superblock
constexpr int TILE = GROUP * SUPER;     // rows a superblock (one tile)
constexpr int ROW = 4;                  // float4s a row
constexpr int SB_CHUNK = 256;           // superblocks a pass of votes
constexpr int WORDS = SB_CHUNK / 32;
constexpr int INST_SPHERE = 1;
constexpr unsigned FULL = 0xffffffffu;
constexpr float WIDEN_DN = 1.0f - 0x1p-20f;
constexpr float WIDEN_UP = 1.0f + 0x1p-20f;
constexpr float FLT_MIN_F = 0x1p-126f;
constexpr int BOX = 3;                  // float4s a box

// the slab test's margins and the plane test's constants, as
// ops/dense_isect.py passes them (the header derives them)
struct Margins {
  float box, rel, abs;  // MARGIN_BOX, MARGIN_REL, MARGIN_ABS
  float kt, cw, kr, ev, ex, slack;  // K_T, C_W, K_R, E_V, E_X, SLACK
};

// the box test's terms of one instance-space ray
struct CullRay {
  float o[3], d[3], inv[3];
  bool neg[3];
  float O, kA, A, dn;
};

__device__ __forceinline__ float norm3(float a, float b, float c) {
  return __fsqrt_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, a), __fmul_rn(b, b)),
                              __fmul_rn(c, c)));
}

// a x b, each component one difference of two products
__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = __fsub_rn(__fmul_rn(a[1], b[2]), __fmul_rn(a[2], b[1]));
  out[1] = __fsub_rn(__fmul_rn(a[2], b[0]), __fmul_rn(a[0], b[2]));
  out[2] = __fsub_rn(__fmul_rn(a[0], b[1]), __fmul_rn(a[1], b[0]));
}

__device__ __forceinline__ void cull_ray(const float o[3], const float d[3],
                                         const Margins& mg, CullRay& c) {
  float A = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    c.o[a] = o[a];
    c.d[a] = d[a];
    c.inv[a] = __frcp_rn(d[a]);
    c.neg[a] = signbit(d[a]);
    A = a ? fmaxf(A, fabsf(d[a])) : fabsf(d[a]);
  }
  c.O = fmaxf(fmaxf(fabsf(o[0]), fabsf(o[1])), fabsf(o[2]));
  c.kA = __fdiv_rn(mg.abs, A);
  c.A = A;
  c.dn = norm3(d[0], d[1], d[2]);
}

// the plane test of the box [lo.xyz, V] [hi.xyz, F] [cone.xyz, S] (see the
// header); ops/dense_isect.py::plane_keep. sf = (O + V) * F.
__device__ __forceinline__ bool plane_keep(const float4 lo, const float4 hi,
                                           const float4 cone,
                                           const CullRay& c, float sf,
                                           const Margins& mg) {
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  const float cv[3] = {cone.x, cone.y, cone.z};
  float x[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x[a] = __fsub_rn(__fmul_rn(__fadd_rn(l[a], h[a]), 0.5f), c.o[a]);
  }
  const float X = fmaxf(fmaxf(fabsf(x[0]), fabsf(x[1])), fabsf(x[2]));
  float M[3], q[3];
  cross3(x, c.d, M);
  cross3(M, cv, q);
  const float LB = fmaxf(
      fmaxf(__fsub_rn(h[0], l[0]), __fsub_rn(h[1], l[1])),
      __fsub_rn(h[2], l[2]));
  const float reach =
      __fadd_rn(__fmul_rn(mg.kr, LB), __fmul_rn(mg.ev, lo.w));
  const float T = __fadd_rn(
      __fmul_rn(c.dn, __fadd_rn(reach, __fmul_rn(mg.ex, X))),
      __fmul_rn(c.A, __fadd_rn(__fmul_rn(mg.kt, LB), __fmul_rn(mg.cw, sf))));
  const float rhs = __fmul_rn(
      __fadd_rn(__fmul_rn(cone.w, norm3(M[0], M[1], M[2])), T), mg.slack);
  return !(norm3(q[0], q[1], q[2]) > rhs);
}

// the slab test of the box [lo.xyz, V] [hi.xyz, F] at the ray's running
// best (see the header); ops/dense_isect.py::slab_keep. s = (O + V) * F.
__device__ __forceinline__ bool slab_keep(const float4 lo, const float4 hi,
                                          const CullRay& c, float best,
                                          const Margins& mg, float& s) {
  s = __fmul_rn(__fadd_rn(c.O, lo.w), hi.w);
  const float m = __fmul_rn(mg.box, s);
  const float tm = __fmul_rn(c.kA, s);
  const float rel = __fadd_rn(__fmul_rn(mg.rel, hi.w), 1.0f);
  const float l[3] = {lo.x, lo.y, lo.z}, h[3] = {hi.x, hi.y, hi.z};
  float en = 0.0f, ex = 0.0f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float near = c.neg[a] ? __fadd_rn(h[a], m) : __fsub_rn(l[a], m);
    const float far = c.neg[a] ? __fsub_rn(l[a], m) : __fadd_rn(h[a], m);
    const float e = __fmul_rn(__fsub_rn(near, c.o[a]), c.inv[a]);
    const float x = __fmul_rn(__fsub_rn(far, c.o[a]), c.inv[a]);
    en = a ? fmaxf(en, e) : e;
    ex = a ? fminf(ex, x) : x;
  }
  en = __fsub_rn(__fmul_rn(en, en > 0.0f ? WIDEN_DN : WIDEN_UP), FLT_MIN_F);
  ex = __fadd_rn(__fmul_rn(ex, ex > 0.0f ? WIDEN_UP : WIDEN_DN), FLT_MIN_F);
  const float tlim = __fadd_rn(__fmul_rn(best, rel), tm);
  return !((en > ex) || (en > tlim) || (ex < -tm));
}

// whether the ray may use the box [lo.xyz, V] [hi.xyz, F] [cone.xyz, S] at
// its running best: the slab test or the plane test (see the header);
// ops/dense_isect.py::box_keep
__device__ __forceinline__ bool box_keep(const float4 lo, const float4 hi,
                                         const float4 cone,
                                         const CullRay& c, float best,
                                         const Margins& mg) {
  float s;
  return slab_keep(lo, hi, c, best, mg, s) ||
         plane_keep(lo, hi, cone, c, s, mg);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// The shared-memory copy of one superblock: its rows, their triangle ids
// and its groups' boxes.
struct Tile {
  float4 rows[TILE * ROW];
  int ids[TILE];
  float4 boxes[SUPER * BOX];
};

// the mesh's rows, as the kernel reads them
struct Mesh {
  const float4* table;  // leaf_table rows of the mesh
  const int* ids;       // their triangle ids
  const float4* group_box;  // the mesh's group boxes (BOX float4s each)
  int rows;
};

// start copying superblock s of the mesh into `t`, as one commit group of
// this thread
__device__ __forceinline__ void load_super(Tile& t, const Mesh& mesh,
                                           int s) {
  const int r0 = s * TILE;
  const int n = min(mesh.rows - r0, TILE);
  const int groups = (n + GROUP - 1) / GROUP;
  const float4* src = mesh.table + static_cast<size_t>(r0) * ROW;
  for (int k = threadIdx.x; k < n * ROW; k += THREADS) {
    cp_async16(t.rows + k, src + k);
  }
  if (threadIdx.x < n) cp_async4(t.ids + threadIdx.x, mesh.ids + r0 +
                                 threadIdx.x);
  if (threadIdx.x < BOX * groups) {
    cp_async16(t.boxes + threadIdx.x,
               mesh.group_box + static_cast<size_t>(s) * SUPER * BOX +
                   threadIdx.x);
  }
  commit();
}

// the least voted superblock after `after` (relative to the pass), or -1
__device__ __forceinline__ int next_voted(const unsigned* need, int after,
                                          int count) {
  for (int i = after + 1; i < count; i = (i | 31) + 1) {
    const unsigned w = need[i >> 5] >> (i & 31);
    if (w) return i + __ffs(w) - 1;
  }
  return -1;
}

// The pairs of one loaded superblock: each group whose box a lane of the
// warp votes for, row by row. Updates (best_t, best_prim, here).
__device__ __forceinline__ void search_tile(const Tile& t, int n,
                                            const CullRay& c, bool vote,
                                            const float w[3],
                                            const Margins& mg, float& best_t,
                                            int& best_prim, bool& here) {
  const int groups = (n + GROUP - 1) / GROUP;
  for (int g = 0; g < groups; ++g) {
    const bool v =
        vote && box_keep(t.boxes[BOX * g], t.boxes[BOX * g + 1],
                         t.boxes[BOX * g + 2], c, best_t, mg);
    if (!__any_sync(FULL, v)) continue;
    const int j1 = min(g * GROUP + GROUP, n);
    for (int j = g * GROUP; j < j1; ++j) {
      // [n(3) v0xe2(3) -e2(3) v0xe1(3) -e1(3) n.v0]
      const float4 a = t.rows[ROW * j], e = t.rows[ROW * j + 3];
      const float det = __fadd_rn(
          __fadd_rn(__fmul_rn(c.d[0], a.x), __fmul_rn(c.d[1], a.y)),
          __fmul_rn(c.d[2], a.z));
      float td = __fadd_rn(__fmul_rn(c.o[0], -a.x), __fmul_rn(c.o[1], -a.y));
      td = __fadd_rn(td, __fmul_rn(c.o[2], -a.z));
      td = __fadd_rn(td, e.w);
      const float inv = __frcp_rn(det);  // 1/det, correctly rounded
      const float tt = __fmul_rn(td, inv);
      if (!(tt >= 0.0f && tt <= best_t)) continue;  // NaN fails too
      const float4 b = t.rows[ROW * j + 1], cc = t.rows[ROW * j + 2];
      float ud = __fadd_rn(__fmul_rn(c.d[0], a.w), __fmul_rn(c.d[1], b.x));
      ud = __fadd_rn(ud, __fmul_rn(c.d[2], b.y));
      ud = __fadd_rn(ud, __fmul_rn(w[0], b.z));
      ud = __fadd_rn(ud, __fmul_rn(w[1], b.w));
      ud = __fadd_rn(ud, __fmul_rn(w[2], cc.x));
      float vd = __fadd_rn(__fmul_rn(c.d[0], cc.y), __fmul_rn(c.d[1], cc.z));
      vd = __fadd_rn(vd, __fmul_rn(c.d[2], cc.w));
      vd = __fadd_rn(vd, __fmul_rn(w[0], e.x));
      vd = __fadd_rn(vd, __fmul_rn(w[1], e.y));
      vd = __fadd_rn(vd, __fmul_rn(w[2], e.z));
      const float u = __fmul_rn(ud, inv);
      const float vv = __fmul_rn(vd, inv);
      if (u >= 0.0f && vv >= 0.0f && __fadd_rn(u, vv) <= 1.0f) {
        const int id = t.ids[j];
        // t < best, or t == best against a higher id of this instance
        if (tt < best_t || (here && id < best_prim)) {
          best_t = tt;
          best_prim = id;
          here = true;
        }
      }
    }
  }
}

// One mesh instance: the mesh's rows behind its boxes against the
// instance-space ray (o, d). Updates (best_t, best_prim); true if a
// triangle of this instance became the best. Called by every thread of
// the block alike (it synchronises the block).
__device__ __forceinline__ bool search_mesh(
    Tile (&tiles)[2], unsigned* need, const Mesh& mesh,
    const float4* root, const float4* block_box, bool live,
    const float o[3], const float d[3], const Margins& mg, float& best_t,
    int& best_prim) {
  CullRay c;
  cull_ray(o, d, mg, c);
  const bool vote =
      live && box_keep(root[0], root[1], root[2], c, best_t, mg);
  if (!__syncthreads_or(vote)) return false;
  float w[3];
  detm::cross(d, o, w);
  bool here = false;
  const int nsb = (mesh.rows + TILE - 1) / TILE;
  const bool warp_votes = __any_sync(FULL, vote);
  for (int c0 = 0; c0 < nsb; c0 += SB_CHUNK) {
    const int count = min(nsb - c0, SB_CHUNK);
    __syncthreads();  // every thread is done with the last pass's mask
    if (threadIdx.x < WORDS) need[threadIdx.x] = 0u;
    __syncthreads();
    if (warp_votes) {
      unsigned bits = 0u;
      for (int s = 0; s < count; ++s) {
        const float4* b = block_box + BOX * static_cast<size_t>(c0 + s);
        const bool v = vote && box_keep(__ldg(b), __ldg(b + 1), __ldg(b + 2),
                                        c, best_t, mg);
        if (__any_sync(FULL, v)) bits |= 1u << (s & 31);
        if ((s & 31) == 31 || s == count - 1) {
          if ((threadIdx.x & 31) == 0 && bits) atomicOr(need + (s >> 5),
                                                        bits);
          bits = 0u;
        }
      }
    }
    __syncthreads();
    int cur = next_voted(need, -1, count);
    if (cur < 0) continue;
    load_super(tiles[0], mesh, c0 + cur);
    for (int k = 0; cur >= 0; ++k) {
      // the next voted superblock's copies (an empty group after the last
      // keeps the wait below uniform), then wait for this one's
      const int nxt = next_voted(need, cur, count);
      if (nxt >= 0) {
        load_super(tiles[(k + 1) & 1], mesh, c0 + nxt);
      } else {
        commit();
      }
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
      __syncthreads();
      const int n = min(mesh.rows - (c0 + cur) * TILE, TILE);
      search_tile(tiles[k & 1], n, c, vote, w, mg, best_t, best_prim,
                  here);
      __syncthreads();  // this buffer is refilled two superblocks on
      cur = nxt;
    }
  }
  return here;
}

__global__ void __launch_bounds__(THREADS)
    dense_hit_kernel(const float* __restrict__ o_w,
                     const float* __restrict__ d_w,
                     const float* __restrict__ limit, int B,
                     const float4* __restrict__ leaf_table,
                     const int* __restrict__ leaf_ids,
                     const int4* __restrict__ plan, int n_inst,
                     const int2* __restrict__ mesh_index,
                     const float4* __restrict__ root_box,
                     const float4* __restrict__ block_box,
                     const float4* __restrict__ group_box,
                     const float* __restrict__ inst_Ainv,
                     const float* __restrict__ inst_offset,
                     const float* __restrict__ sph_radius, Margins mg,
                     float* __restrict__ t_out, int* __restrict__ prim_out,
                     int* __restrict__ inst_out) {
  __shared__ __align__(16) Tile tiles[2];
  __shared__ unsigned need[WORDS];
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
  const bool live = lim > 0.0f;
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
      const int2 mi = __ldg(mesh_index + p.w);  // first superblock, group
      const Mesh mesh{leaf_table + static_cast<size_t>(p.y) * ROW,
                      leaf_ids + p.y,
                      group_box + BOX * static_cast<size_t>(mi.y), p.z};
      if (search_mesh(tiles, need, mesh, root_box + BOX * p.w,
                      block_box + BOX * static_cast<size_t>(mi.x), live, o, d,
                      mg, best_t, best_prim)) {
        best_inst = i;
      }
    }
  }
  if (!in) return;
  t_out[ray] = live ? best_t : detm::FLT_MAX_F;
  prim_out[ray] = live ? best_prim : -1;
  inst_out[ray] = live ? best_inst : -1;
}

}  // namespace

extern "C" int craytpu_dense_hit(
    const float* o_w, const float* d_w, const float* limit, int B,
    const float* leaf_table, const int* leaf_ids, const int* plan,
    int n_inst, const int* mesh_index, const float* root_box,
    const float* block_box, const float* group_box, const float* inst_Ainv,
    const float* inst_offset, const float* sph_radius, float margin_box,
    float margin_rel, float margin_abs, float k_t, float c_w, float k_r,
    float e_v, float e_x, float slack, float* t_out, int* prim_out,
    int* inst_out, void* stream) {
  if (B <= 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int blocks = (B + THREADS - 1) / THREADS;
  dense_hit_kernel<<<blocks, THREADS, 0, st>>>(
      o_w, d_w, limit, B, reinterpret_cast<const float4*>(leaf_table),
      leaf_ids, reinterpret_cast<const int4*>(plan), n_inst,
      reinterpret_cast<const int2*>(mesh_index),
      reinterpret_cast<const float4*>(root_box),
      reinterpret_cast<const float4*>(block_box),
      reinterpret_cast<const float4*>(group_box), inst_Ainv, inst_offset,
      sph_radius,
      Margins{margin_box, margin_rel, margin_abs, k_t, c_w, k_r, e_v, e_x,
              slack},
      t_out, prim_out, inst_out);
  return static_cast<int>(cudaGetLastError());
}
