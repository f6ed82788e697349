// K1: hit-record resolve — winner ids -> shading-ready hit data.
//
// Replaces the JAX package's Pallas kernel
// craytpu/ops/hitrec_kernel.py::_kernel (built by build_hitrec_kernel).
// That kernel took the winner rows pre-gathered and transposed, and the
// instance rows through an (I, B) one-hot matmul, because narrow per-lane
// gathers were slow on the TPU. Here each thread gathers its own rows:
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
// What bounds it on an H100: memory. Per lane it reads 7 ray floats and 2
// ids and writes 16 floats (100 bytes), and gathers a 128-byte tri_wide
// row and a 112-byte inst_wide row; many lanes share a row, so the tables
// count once each (a scene's tables fit in L2 or nearly). Against that, a
// couple of thousand f32 operations (the emulated fmas). One thread per
// lane and all intermediates in registers; the scattered row reads are
// what it waits on.
#include <cuda_runtime.h>

#include "detmath.cuh"

namespace {

constexpr int N_OUT = 16;

__global__ void hitrec_kernel(const float* __restrict__ tri_wide,
                              const float* __restrict__ inst_wide,
                              const float* __restrict__ o_w,
                              const float* __restrict__ d_w,
                              const float* __restrict__ t_k,
                              const int* __restrict__ prim,
                              const int* __restrict__ inst, int B,
                              int sphere_uv, float* __restrict__ out) {
  int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= B) return;
  using namespace detm;
  const int pr_id = prim[lane];
  const int in_id = inst[lane];
  const bool is_hit = in_id >= 0;
  const bool is_sph = pr_id < 0;
  const float* iw = inst_wide + 28 * (in_id > 0 ? in_id : 0);
  const float* tw = tri_wide + 32 * (pr_id > 0 ? pr_id : 0);
  const float ow[3] = {o_w[3 * lane], o_w[3 * lane + 1], o_w[3 * lane + 2]};
  const float dw[3] = {d_w[3 * lane], d_w[3 * lane + 1], d_w[3 * lane + 2]};

  // ---- object-space ray: Ainv rows at 12..23, rayOffset at 24 ----
  float o[3], d[3];
  space_ray(iw + 12, iw[24], ow, dw, o, d);

  // ---- exact winner recompute ----
  float t_x, u_x, v_x;
  tri_intersect(tw, o, d, t_x, u_x, v_x);
  float t_s;
  sphere_roots(iw[26], o, d, t_s);

  const bool is_tri = is_hit && !is_sph;
  float t = is_tri ? t_x : ((is_sph && is_hit) ? t_s : t_k[lane]);
  const float u = is_tri ? u_x : 0.0f;
  const float v = is_tri ? v_x : 0.0f;
  t = is_hit ? t : FLT_MAX_F;

  float p_obj[3];
  for (int i = 0; i < 3; ++i) p_obj[i] = det_fma(d[i], t, o[i]);

  // ---- sphere normal (vecNormalize of the object-space hit) ----
  float sph_len =
      is_sph ? exact_sqrt(dot3(p_obj[0], p_obj[1], p_obj[2], p_obj[0],
                               p_obj[1], p_obj[2]))
             : 1.0f;
  if (sph_len == 0.0f) sph_len = 1.0f;
  float n_sph[3];
  for (int i = 0; i < 3; ++i) n_sph[i] = exact_div(p_obj[i], sph_len);

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
  float n_len = exact_sqrt(dot3(n_w[0], n_w[1], n_w[2], n_w[0], n_w[1],
                                n_w[2]));
  if (n_len == 0.0f) n_len = 1.0f;
  if (!is_sph) {
    for (int i = 0; i < 3; ++i) n_w[i] = exact_div(n_w[i], n_len);
  }

  // ---- world point via A (rows 0..11) ----
  float p_w[3];
  mat34_point(iw, p_obj, p_w);

  float* r = out + static_cast<size_t>(N_OUT) * lane;
  r[0] = t;
  r[1] = u;
  r[2] = v;
  for (int i = 0; i < 3; ++i) {
    r[3 + i] = p_w[i];
    r[6 + i] = n_w[i];
    r[11 + i] = sphere_uv ? n_sph[i] : 0.0f;
  }
  r[9] = uv_m[0];
  r[10] = uv_m[1];
  r[14] = 0.0f;
  r[15] = 0.0f;
}

}  // namespace

extern "C" int craytpu_hitrec(const float* tri_wide, const float* inst_wide,
                              const float* o_w, const float* d_w,
                              const float* t_k, const int* prim,
                              const int* inst, int B, int sphere_uv,
                              float* out, void* stream) {
  if (B <= 0) return 0;
  const int threads = 256;
  const int blocks = (B + threads - 1) / threads;
  hitrec_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      tri_wide, inst_wide, o_w, d_w, t_k, prim, inst, B, sphere_uv, out);
  return static_cast<int>(cudaGetLastError());
}
