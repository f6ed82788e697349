// K1: hit-record resolve — winner ids -> shading-ready hit data.
//
// Replaces the JAX package's Pallas kernel
// craytpu/ops/hitrec_kernel.py::_kernel (built by build_hitrec_kernel).
// That kernel took the winner rows pre-gathered and transposed, and the
// instance rows through an (I, B) one-hot matmul, because narrow per-lane
// gathers were slow on the TPU. Here each warp gathers its lanes' rows:
// tri_wide (P, 32) by prim and inst_wide (I, 28) by inst. It runs the
// formulas of hitrec_kernel.py:53-146 with the plain version's roundings
// (ops/hitrec.py::hitrec_plain), bit for bit:
//   object-space ray (Ainv rows + rayOffset fma), exact Moller-Trumbore
//   (t, u, v), the reference-rounded sphere t, p_obj = det_fma(d, t, o),
//   the sphere normal, the smooth normal and uv in the poly.c fma pattern,
//   the world normal via Ainv^T (normalised for meshes), the world point
//   via A.
// The record is 16 floats per lane, row-major (B, 16):
//   [t, u, v, p_w(3), n_w(3), uv_mesh(2), n_obj_sphere(3), pad(2)].
// The sphere-uv trig stays outside, in torch.
//
// What bounds it on an H100: per lane it reads 7 ray floats and 2 ids and
// writes 16 floats (100 bytes), and gathers a 128-byte tri_wide row and a
// 112-byte inst_wide row; many lanes share a row, so the tables count
// once each. Against that, about 1,850 f32 operations a lane (the
// emulated fmas, exact div and sqrt), which at 2^20 lanes take longer to
// issue than the bytes take to move: once memory access is coalesced the
// kernel is bound by its instructions. What the design does about the
// access: each warp stages its 32 lanes' rows in shared memory with
// 16-byte loads, neighbouring lanes on neighbouring words of a row (8
// loads for the 32 tri_wide rows, 7 for the inst_wide rows, where one
// thread a lane made ~60 scalar loads, each touching 32 sectors), and
// stages its 32 records in shared memory to write them as 4 coalesced
// 16-byte stores per lane (where 16 scalar stores at a 64-byte stride each
// touched 32 sectors). Shared-memory slots are swizzled so that both the
// staging and each lane's reads of its own row are free of bank
// conflicts. Intermediates stay in registers. A lane computes only what
// its record keeps: the triangle test for a triangle winner, the sphere
// roots and sphere normal for a sphere winner (the record's sphere normal
// of a triangle lane is p_obj / 1, i.e. p_obj + 0), which is the same
// record the plain version computes with both.
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int N_OUT = 16;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int TRI_F4 = 8;   // a tri_wide row: 8 float4
constexpr int INST_F4 = 7;  // an inst_wide row: 7 float4
constexpr unsigned FULL = 0xffffffffu;
// blocks of 128 an SM that __launch_bounds__ asks registers for: 5 gives
// 96 registers and no spills; 6 gives 80 with spills, and no cap 112; both
// measured slower (PERF.md)
constexpr int MIN_BLOCKS = 5;

// float4 slot of word-quad c of staged tri row r (XOR swizzle)
__device__ __forceinline__ int tri_slot(int r, int c) {
  return r * TRI_F4 + (c ^ (r & 7));
}

// float4 slot of quad j of staged record r (rotation swizzle)
__device__ __forceinline__ int rec_slot(int r, int j) {
  return r * 4 + ((j + (r >> 1)) & 3);
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
    hitrec_kernel(const float4* __restrict__ tri_wide,
                  const float4* __restrict__ inst_wide,
                  const float* __restrict__ o_w, const float* __restrict__ d_w,
                  const float* __restrict__ t_k, const int* __restrict__ prim,
                  const int* __restrict__ inst, int B, int sphere_uv,
                  float4* __restrict__ out) {
  // per warp: its 32 tri_wide rows (later its 32 records) and inst rows
  __shared__ float4 s_tri[WARPS][32 * TRI_F4];
  __shared__ float4 s_inst[WARPS][32 * INST_F4];
  using namespace detm;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int base = (blockIdx.x * WARPS + warp) * 32;
  if (base >= B) return;  // the whole warp
  const int n = min(32, B - base);
  const bool valid = lane < n;
  const int my = base + lane;
  const int pr_id = valid ? prim[my] : -1;
  const int in_id = valid ? inst[my] : -1;
  const int tri_row = pr_id > 0 ? pr_id : 0;
  const int inst_row = in_id > 0 ? in_id : 0;

  // ---- stage the warp's rows, 16 bytes a lane, rows in order ----
  float4* st = s_tri[warp];
  float4* si = s_inst[warp];
  for (int k = 0; k < TRI_F4; ++k) {  // 4 rows a pass, 8 lanes a row
    const int r = 4 * k + (lane >> 3), c = lane & 7;
    const int id = __shfl_sync(FULL, tri_row, r);
    if (r < n) st[tri_slot(r, c)] = __ldg(tri_wide + TRI_F4 * id + c);
  }
  for (int k = 0; k < INST_F4; ++k) {
    const int g = 32 * k + lane, r = g / INST_F4, c = g % INST_F4;
    const int id = __shfl_sync(FULL, inst_row, r);
    if (r < n) si[g] = __ldg(inst_wide + INST_F4 * id + c);
  }
  __syncwarp();
  float tw[4 * TRI_F4], iw[4 * INST_F4];
  for (int c = 0; c < TRI_F4; ++c) {
    const float4 q = st[tri_slot(lane, c)];
    tw[4 * c] = q.x, tw[4 * c + 1] = q.y, tw[4 * c + 2] = q.z,
    tw[4 * c + 3] = q.w;
  }
  for (int c = 0; c < INST_F4; ++c) {
    const float4 q = si[INST_F4 * lane + c];
    iw[4 * c] = q.x, iw[4 * c + 1] = q.y, iw[4 * c + 2] = q.z,
    iw[4 * c + 3] = q.w;
  }
  __syncwarp();  // every lane holds its rows: st may take the records

  const bool is_hit = in_id >= 0;
  const bool is_sph = pr_id < 0;
  float ow[3] = {0.0f, 0.0f, 0.0f}, dw[3] = {0.0f, 0.0f, 0.0f};
  float tk = 0.0f;
  if (valid) {
    for (int i = 0; i < 3; ++i) {
      ow[i] = o_w[3 * my + i];
      dw[i] = d_w[3 * my + i];
    }
    tk = t_k[my];
  }

  // ---- object-space ray: Ainv rows at 12..23, rayOffset at 24 ----
  float o[3], d[3];
  space_ray(iw + 12, iw[24], ow, dw, o, d);

  // ---- exact winner recompute (a lane computes only the test whose
  // result it keeps) ----
  const bool is_tri = is_hit && !is_sph;
  float t_x = 0.0f, u_x = 0.0f, v_x = 0.0f;
  if (is_tri) tri_intersect(tw, o, d, t_x, u_x, v_x);
  float t_s = 0.0f;
  if (is_sph && is_hit) sphere_roots(iw[26], o, d, t_s);

  float t = is_tri ? t_x : ((is_sph && is_hit) ? t_s : tk);
  const float u = is_tri ? u_x : 0.0f;
  const float v = is_tri ? v_x : 0.0f;
  t = is_hit ? t : FLT_MAX_F;

  float p_obj[3];
  for (int i = 0; i < 3; ++i) p_obj[i] = det_fma(d[i], t, o[i]);

  // ---- sphere normal (vecNormalize of the object-space hit) ----
  float sph_len = 1.0f;
  if (is_sph) {
    sph_len = exact_sqrt(dot3(p_obj[0], p_obj[1], p_obj[2], p_obj[0],
                              p_obj[1], p_obj[2]));
  }
  if (sph_len == 0.0f) sph_len = 1.0f;
  float n_sph[3] = {0.0f, 0.0f, 0.0f};
  if (is_sph) {
    for (int i = 0; i < 3; ++i) n_sph[i] = exact_div(p_obj[i], sph_len);
  } else if (sphere_uv) {
    // sph_len is 1 here: exact_div(x, 1) without the division
    for (int i = 0; i < 3; ++i) n_sph[i] = exact_div_one(p_obj[i]);
  }

  // ---- mesh normal / uv: fma(n0, w, fma(n1, u, n2*v)) ----
  const float w = __fsub_rn(__fsub_rn(1.0f, u), v);
  const int flags = static_cast<int>(tw[28]);
  const bool has_n = (flags & 1) == 1;
  const bool uv_ok = (flags & 2) == 2;
  float n_obj[3];
  for (int i = 0; i < 3; ++i) {
    float sm = fma_raw(tw[12 + i], w,
                       fma_raw(tw[15 + i], u, __fmul_rn(tw[18 + i], v)));
    n_obj[i] = is_sph ? n_sph[i] : (has_n ? sm : tw[9 + i]);
  }
  float uv_m[2];
  for (int i = 0; i < 2; ++i) {
    float m = fma_raw(tw[21 + i], w,
                      fma_raw(tw[23 + i], u, __fmul_rn(tw[25 + i], v)));
    uv_m[i] = uv_ok ? m : -1.0f;
  }

  // ---- world normal: Ainv^T, normalised for meshes ----
  float n_w[3];
  mat33_vec_T(iw + 12, n_obj, n_w);
  if (!is_sph) {
    float n_len = exact_sqrt(dot3(n_w[0], n_w[1], n_w[2], n_w[0], n_w[1],
                                  n_w[2]));
    if (n_len == 0.0f) n_len = 1.0f;
    for (int i = 0; i < 3; ++i) n_w[i] = exact_div(n_w[i], n_len);
  }

  // ---- world point via A (rows 0..11) ----
  float p_w[3];
  mat34_point(iw, p_obj, p_w);

  // ---- stage the warp's records, then 16-byte coalesced stores ----
  const float s0 = sphere_uv ? n_sph[0] : 0.0f;
  const float s1 = sphere_uv ? n_sph[1] : 0.0f;
  const float s2 = sphere_uv ? n_sph[2] : 0.0f;
  st[rec_slot(lane, 0)] = make_float4(t, u, v, p_w[0]);
  st[rec_slot(lane, 1)] = make_float4(p_w[1], p_w[2], n_w[0], n_w[1]);
  st[rec_slot(lane, 2)] = make_float4(n_w[2], uv_m[0], uv_m[1], s0);
  st[rec_slot(lane, 3)] = make_float4(s1, s2, 0.0f, 0.0f);
  __syncwarp();
  float4* o4 = out + static_cast<size_t>(N_OUT / 4) * base;
  for (int k = 0; k < N_OUT / 4; ++k) {
    const int g = 32 * k + lane;  // the warp's g-th output float4
    if ((g >> 2) < n) o4[g] = st[rec_slot(g >> 2, g & 3)];
  }
}

}  // namespace

extern "C" int craytpu_hitrec(const float* tri_wide, const float* inst_wide,
                              const float* o_w, const float* d_w,
                              const float* t_k, const int* prim,
                              const int* inst, int B, int sphere_uv,
                              float* out, void* stream) {
  if (B <= 0) return 0;
  const int blocks = (B + THREADS - 1) / THREADS;
  hitrec_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(tri_wide),
      reinterpret_cast<const float4*>(inst_wide), o_w, d_w, t_k, prim, inst,
      B, sphere_uv, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
