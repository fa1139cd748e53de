// The standalone sweeps' per-sphere hit distance, shared by
// intersect_fused.cu and bounce_lane.cu: the TPU sweep kernels' two tiers
// (python_ray_tracer_tpu/ops/pallas_intersect.py _block_t_fast, whose
// quadratic is sphere_math.cuh's sphere_t, and _block_t_exact), which the
// lane-layout bounce (ops/pallas_bounce.py _nearest, _shadow) sweeps too.
//
// The exact tier here is _block_t_exact's, which differs from
// sphere_math.cuh's sphere_t_exact: the Dekker splitter is 4097 (f32) or
// 134217729 (f64), and twoProd keeps the general form.  Build with
// --fmad=false (ops/_build.py): an FMA would destroy the error terms.

#pragma once

#include "sphere_math.cuh"

namespace {

template <typename T> __device__ __forceinline__ T split_factor();
template <> __device__ __forceinline__ float split_factor<float>() { return 4097.0f; }
template <> __device__ __forceinline__ double split_factor<double>() { return 134217729.0; }

// Dekker twoProd without FMA: a * b = p + e exactly.
template <typename T> __device__ __forceinline__ void two_prod(T a, T b, T& p, T& e) {
  p = a * b;
  const T ca = a * split_factor<T>();
  const T ah = ca - (ca - a);
  const T al = a - ah;
  const T cb = b * split_factor<T>();
  const T bh = cb - (cb - b);
  const T bl = b - bh;
  e = ((ah * bh - p) + ah * bl + al * bh) + al * bl;
}

// Knuth twoSum: a + b = s + e exactly.
template <typename T> __device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bv = s - a;
  e = (a - (s - bv)) + (b - bv);
}

// _block_t_exact for one sphere g = (cx, cy, cz, r).
template <typename T>
__device__ __forceinline__ T block_t_exact(const V3<T>& o, const V3<T>& d, const T* g, T faraway) {
  T h[3], lo[3];
  two_sum(o.x, -g[0], h[0], lo[0]);
  two_sum(o.y, -g[1], h[1], lo[1]);
  two_sum(o.z, -g[2], h[2], lo[2]);
  const T b = T(2) * ((d.x * h[0] + d.y * h[1] + d.z * h[2]) + (d.x * lo[0] + d.y * lo[1] + d.z * lo[2]));
  T p0, e0, p1, e1, p2, e2, pr, er;
  two_prod(h[0], h[0], p0, e0);
  two_prod(h[1], h[1], p1, e1);
  two_prod(h[2], h[2], p2, e2);
  two_prod(g[3], g[3], pr, er);
  T s1, t1, s2, t2, s3, t3;
  two_sum(p0, p1, s1, t1);
  two_sum(s1, p2, s2, t2);
  two_sum(s2, -pr, s3, t3);
  const T corr = (((t1 + t2 + t3) + (e0 + e1 + e2 - er)) + T(2) * (h[0] * lo[0] + h[1] * lo[1] + h[2] * lo[2]))
                 + (lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2]);
  return roots(b, s3 + corr, faraway);
}

template <typename T>
__device__ __forceinline__ T sweep_t(int k, int s_cheap, const V3<T>& o, const V3<T>& d, const T* s_geom,
                                     T faraway) {
  const T* g = s_geom + 4 * k;
  return k < s_cheap ? sphere_t(o, d, g, faraway) : block_t_exact(o, d, g, faraway);
}

}  // namespace
