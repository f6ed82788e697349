// Deterministic float primitives shared by the port's kernels: the CUDA
// twins of craytpu_torch/ops/vecmath.py, op for op.
//
// The reference binary contracts its float chains into fmas at fixed
// sites; the port reproduces each of those as a Dekker exact product plus
// a Knuth 2Sum, written here with __fmul_rn/__fadd_rn/__fsub_rn so that
// nvcc can neither contract nor reorder them. Everything else is built
// with -fmad=false, so a plain a*b + c stays two roundings. Division and
// sqrt are IEEE (-prec-div=true -prec-sqrt=true). There is deliberately
// no __fmaf_rn: the emulated det_fma can double-round in rare cases, and a
// hardware fma would then differ from the plain version by one ulp.
//
// -DCRAYTPU_FASTMATH=1 (cuda_build's fast variant; profiling only, as
// vecmath's CRAYTPU_FASTMATH): exact_div, exact_sqrt, fma_raw and det_fma
// fall to IEEE a / b, sqrtf and a * b + c in two roundings
// (__fadd_rn(__fmul_rn(a, b), c), still no __fmaf_rn), bit-equal to the
// plain versions under the same flag. Not golden-exact.
#pragma once

#include <cuda_runtime.h>

#ifndef CRAYTPU_FASTMATH
#define CRAYTPU_FASTMATH 0
#endif

namespace detm {

constexpr float SPLIT = 4097.0f;  // 2^12 + 1: Dekker split point (f32)
constexpr float FLT_MAX_F = 3.402823466e+38f;

__device__ __forceinline__ bool finite(float x) { return isfinite(x); }

// x == h + l with h, l each <= 12 mantissa bits
__device__ __forceinline__ void split(float x, float& h, float& l) {
  float c = __fmul_rn(SPLIT, x);
  h = __fsub_rn(c, __fsub_rn(c, x));
  l = __fsub_rn(x, h);
}

// p + e == x*y exactly
__device__ __forceinline__ void two_prod(float x, float y, float& p,
                                         float& e) {
  p = __fmul_rn(x, y);
  float hx, lx, hy, ly;
  split(x, hx, lx);
  split(y, hy, ly);
  e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(hx, hy), p),
                                    __fmul_rn(hx, ly)),
                          __fmul_rn(lx, hy)),
                __fmul_rn(ly, lx));
}

// correctly rounded a / b, as vecmath.exact_div
__device__ __forceinline__ float exact_div(float a, float b) {
#if CRAYTPU_FASTMATH
  return __fdiv_rn(a, b);
#else
  float q = __fdiv_rn(a, b);
  float p, e;
  two_prod(q, b, p, e);
  float r = __fsub_rn(__fsub_rn(a, p), e);
  float corr = __fdiv_rn(r, b);
  return finite(corr) ? __fadd_rn(q, corr) : q;
#endif
}

// correctly rounded sqrt(x), as vecmath.exact_sqrt
__device__ __forceinline__ float exact_sqrt(float x) {
#if CRAYTPU_FASTMATH
  return __fsqrt_rn(x);
#else
  float s = __fsqrt_rn(x);
  float p, e;
  two_prod(s, s, p, e);
  float r = __fsub_rn(__fsub_rn(x, p), e);
  float corr = __fdiv_rn(r, __fadd_rn(s, s));
  return finite(corr) ? __fadd_rn(s, corr) : s;
#endif
}

// unguarded emulated fma(a, b, c), as vecmath.fma_raw / _fma_pre.
// Argument order matters: the error terms sum ha*lb before la*hb.
__device__ __forceinline__ float fma_raw(float a, float b, float c) {
#if CRAYTPU_FASTMATH
  return __fadd_rn(__fmul_rn(a, b), c);
#else
  float ha, la, hb, lb;
  split(a, ha, la);
  split(b, hb, lb);
  float p = __fmul_rn(a, b);
  float e = __fadd_rn(__fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ha, hb), p),
                                          __fmul_rn(ha, lb)),
                                __fmul_rn(la, hb)),
                      __fmul_rn(lb, la));
  float s = __fadd_rn(p, c);
  float z = __fsub_rn(s, p);
  float t = __fadd_rn(__fsub_rn(p, __fsub_rn(s, z)), __fsub_rn(c, z));
  return __fadd_rn(s, __fadd_rn(t, e));
#endif
}

// guarded emulated fma, as vecmath.det_fma
__device__ __forceinline__ float det_fma(float a, float b, float c) {
#if CRAYTPU_FASTMATH
  return __fadd_rn(__fmul_rn(a, b), c);
#else
  float p, e;
  two_prod(a, b, p, e);
  float s = __fadd_rn(p, c);
  float z = __fsub_rn(s, p);
  float t = __fadd_rn(__fsub_rn(p, __fsub_rn(s, z)), __fsub_rn(c, z));
  float corr = __fadd_rn(t, e);
  return finite(corr) ? __fadd_rn(s, corr)
                      : __fadd_rn(__fmul_rn(a, b), c);
#endif
}

// exact_div(x, 1.0f) without the division: x + 0 (a -0 turns +0; the
// residual is +0), or x itself under fast math (x / 1 == x)
__device__ __forceinline__ float exact_div_one(float x) {
#if CRAYTPU_FASTMATH
  return x;
#else
  return __fadd_rn(x, 0.0f);
#endif
}

// vecDot as the reference binary rounds it: fma(az,bz, fma(ax,bx, ay*by))
__device__ __forceinline__ float dot3(float ax, float ay, float az,
                                      float bx, float by, float bz) {
  return fma_raw(az, bz, fma_raw(ax, bx, __fmul_rn(ay, by)));
}

// cross(a, b)_i = fma(a_j, b_k, -(a_k * b_j))
__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float r[3]) {
  r[0] = fma_raw(a[1], b[2], -__fmul_rn(a[2], b[1]));
  r[1] = fma_raw(a[2], b[0], -__fmul_rn(a[0], b[2]));
  r[2] = fma_raw(a[0], b[1], -__fmul_rn(a[1], b[0]));
}

// rows of a row-major 3x4 matrix M: transformPoint rounding
// out_i = fma(z, Mi2, fma(x, Mi0, y*Mi1)) + Mi3
__device__ __forceinline__ void mat34_point(const float* M, const float p[3],
                                            float out[3]) {
  for (int i = 0; i < 3; ++i) {
    const float* m = M + 4 * i;
    out[i] = __fadd_rn(
        fma_raw(p[2], m[2], fma_raw(p[0], m[0], __fmul_rn(p[1], m[1]))),
        m[3]);
  }
}

__device__ __forceinline__ void mat33_vec(const float* M, const float v[3],
                                          float out[3]) {
  for (int i = 0; i < 3; ++i) {
    const float* m = M + 4 * i;
    out[i] = fma_raw(v[2], m[2], fma_raw(v[0], m[0], __fmul_rn(v[1], m[1])));
  }
}

// (M^T) v over the 3x3 part: transformVectorWithTranspose rounding
__device__ __forceinline__ void mat33_vec_T(const float* M, const float v[3],
                                            float out[3]) {
  for (int i = 0; i < 3; ++i) {
    out[i] = fma_raw(v[2], M[8 + i],
                     fma_raw(v[0], M[i], __fmul_rn(v[1], M[4 + i])));
  }
}

// object-space ray of an instance (Ainv rows, then the rayOffset fma)
__device__ __forceinline__ void space_ray(const float* Ainv, float off,
                                          const float o_w[3],
                                          const float d_w[3], float o[3],
                                          float d[3]) {
  float ot[3];
  mat34_point(Ainv, o_w, ot);
  mat33_vec(Ainv, d_w, d);
  for (int i = 0; i < 3; ++i) o[i] = fma_raw(d[i], off, ot[i]);
}

// Moller-Trumbore on a packed row v0,e1,e2,n (intersect.tri_intersect);
// returns uv_ok && t >= 0 (the caller applies its own t bound)
__device__ __forceinline__ bool tri_intersect(const float* tri,
                                              const float o[3],
                                              const float d[3], float& t,
                                              float& u, float& v) {
  float c[3], r[3];
  for (int i = 0; i < 3; ++i) c[i] = __fsub_rn(tri[i], o[i]);
  cross(d, c, r);
  float inv_det =
      exact_div(1.0f, dot3(tri[9], tri[10], tri[11], d[0], d[1], d[2]));
  u = __fmul_rn(dot3(r[0], r[1], r[2], tri[6], tri[7], tri[8]), inv_det);
  v = __fmul_rn(dot3(r[0], r[1], r[2], tri[3], tri[4], tri[5]), inv_det);
  bool uv_ok = (u >= 0.0f) && (v >= 0.0f) && (__fadd_rn(u, v) <= 1.0f);
  t = __fmul_rn(dot3(tri[9], tri[10], tri[11], c[0], c[1], c[2]), inv_det);
  return uv_ok && (t >= 0.0f);
}

// sphere quadratic (intersect.sphere_intersect): t0 and whether roots
// exist; the caller applies t0 >= 1e-5 && t0 <= best
__device__ __forceinline__ bool sphere_roots(float radius, const float o[3],
                                             const float d[3], float& t0) {
  float A = dot3(d[0], d[1], d[2], d[0], d[1], d[2]);
  float B = __fmul_rn(2.0f, dot3(d[0], d[1], d[2], o[0], o[1], o[2]));
  float C = fma_raw(-radius, radius, dot3(o[0], o[1], o[2], o[0], o[1], o[2]));
  float disc = fma_raw(B, B, -__fmul_rn(__fmul_rn(4.0f, A), C));
  bool has_roots = disc >= 0.0f;
  float sq = exact_sqrt(disc < 0.0f ? 0.0f : disc);
  t0 = __fdiv_rn(__fadd_rn(-B, sq), 2.0f);
  float t1 = __fdiv_rn(__fsub_rn(-B, sq), 2.0f);
  if ((t0 > t1) && (t1 > 0.0f)) t0 = t1;
  return has_roots;
}

}  // namespace detm

// error text for the Python wrappers
extern "C" const char* craytpu_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
