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
//
// Below the tiers, the warp-bundle sphere skip that shadow_sweep (both
// modes) and bounce_lane run, and the sweeps built on it: a warp bounds its
// 32 rays once (warp_bundle), one lane a sphere tests 32 cheap-tier spheres
// against that bound under one ballot (reach_ballot), and the warp sweeps
// only the spheres some lane may hit, in ascending order (sweep_cheap).
// ops/intersect_fused.py (warp_bundles, bundle_test) is the plain version,
// term for term.

#pragma once

#include "bundle_math.cuh"

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

// --- The warp-bundle sphere skip ---
//
// The bound and its margin: bundle_math.cuh.
//
// Skipped means a miss at faraway, bitwise.  The nearest sweep needs
// nothing: faraway < tmin never holds.  The shadow minima start from a
// sentinel, so a skipped sphere still folds faraway into t_self (the lane's
// own sphere) or t_others, as vmin would have on the full loop: a minimum
// over numbers does not depend on their order.

// The launchers' rule: the skip is taken from this many cheap-tier spheres
// on, or as the caller forces it (ops/intersect_fused.py SKIP, the codes).
// On the card (benchmarks/sweep_skip_ab.py, glossy and mirror bounces of
// random_spheres_scene(n)) the skip lost 21-30% at 3 cheap spheres, where
// the bundle costs as much as the sweep; at 7 the shadow sweep lost 17%
// (bounce_lane at parity), at 15 the shadow sweep was at parity
// (bounce_lane 1.2x faster), at 47 both 1.3-1.9x faster.
// The nearest sweep gains less a reached sphere (its fold is one compare):
// at 15 and 16 cheap spheres it lost 6-11%, at 31 and 47 it won 12-14%.
constexpr int kSkipMinCheap = 16;
constexpr int kNearestSkipMinCheap = 24;
enum Skip { kSkipAuto = -1, kSkipOff = 0, kSkipOn = 1 };
inline bool takes_skip(int skip, int s_cheap, int min_cheap = kSkipMinCheap) {
  return skip == kSkipAuto ? s_cheap >= min_cheap : skip == kSkipOn;
}

// Bit j: cheap-tier sphere k0 + j (below s_cheap) may be hit by a ray of
// the warp.  Lane j tests sphere k0 + j; one ballot gathers the answers.
template <typename T>
__device__ __forceinline__ unsigned reach_ballot(const Bundle<T>& b, const T* geom, int k0, int s_cheap) {
  const int k = k0 + static_cast<int>(threadIdx.x & 31u);
  return __ballot_sync(kFullWarp, k < s_cheap && bundle_reaches(b, geom + 4 * k));
}

// The bundle a sweep runs under, in the warp's slot of slots (kBundleValues
// a warp of the block): none (every sphere) without the skip or in a warp
// with a lane past n (warp_full false, uniform over the warp).
template <typename T, bool kSkip>
__device__ __forceinline__ Bundle<T> sweep_bundle(bool warp_full, const V3<T>& o, const V3<T>& d, const V3<T>& apex,
                                                  T* slots) {
  if constexpr (kSkip) {
    if (warp_full) return warp_bundle(o, d, apex, slots + kBundleValues * (threadIdx.x / 32u));
  }
  return {slots, false, false};
}

// Cheap-tier sphere k's row (cx, cy, cz, r) in vector loads: the (S, 4)
// table starts 16-byte aligned (shared memory, or a tensor's storage; the
// launchers refuse a table that does not).
template <typename T> struct Row {
  T g[4];
};
__device__ __forceinline__ Row<float> load_row(const float* geom, int k) {
  const float4 q = reinterpret_cast<const float4*>(geom)[k];
  return {{q.x, q.y, q.z, q.w}};
}
__device__ __forceinline__ Row<double> load_row(const double* geom, int k) {
  const double2* q = reinterpret_cast<const double2*>(geom) + 2 * k;
  const double2 a = q[0];
  const double2 b = q[1];
  return {{a.x, a.y, b.x, b.y}};
}

// fold(k, t) of t = sphere_t of every cheap-tier sphere k the warp's rays may
// hit, in ascending order: every one without a usable bundle, else the
// reached ones, skipped(bits, k0) first for each chunk of 32 that leaves
// some out (bit j: sphere k0 + j).
template <typename T, typename Fold, typename Skipped>
__device__ __forceinline__ void sweep_cheap(const Bundle<T>& b, const V3<T>& o, const V3<T>& d, const T* geom,
                                            int s_cheap, T faraway, Fold&& fold, Skipped&& skipped) {
  auto eval = [&](int k) {
    const Row<T> row = load_row(geom, k);
    return sphere_t(o, d, row.g, faraway);
  };
  if (!b.ok) {
#pragma unroll 4
    for (int k = 0; k < s_cheap; ++k) fold(k, eval(k));
    return;
  }
  for (int k0 = 0; k0 < s_cheap; k0 += 32) {
    const unsigned reached = reach_ballot(b, geom, k0, s_cheap);
    const int width = min(32, s_cheap - k0);
    const unsigned chunk = width == 32 ? kFullWarp : (1u << width) - 1u;
    if (const unsigned bits = chunk & ~reached) skipped(bits, k0);
    for (unsigned m = reached; m != 0u; m &= m - 1u) {
      const int k = k0 + __ffs(static_cast<int>(m)) - 1;
      fold(k, eval(k));
    }
  }
}

// The nearest hit over every sphere (strict <, the lowest index wins ties;
// a miss keeps faraway and index 0).
template <typename T>
__device__ __forceinline__ void nearest_min(const Bundle<T>& b, const V3<T>& o, const V3<T>& d, const T* geom,
                                            int s_cheap, int s_total, T faraway, T& tmin, int& idx) {
  tmin = faraway;
  idx = 0;
  auto take = [&](int k, T tk) {
    if (tk < tmin) {
      tmin = tk;
      idx = k;
    }
  };
  sweep_cheap(b, o, d, geom, s_cheap, faraway, take, [](unsigned, int) {});
  for (int k = s_cheap; k < s_total; ++k) take(k, block_t_exact(o, d, geom + 4 * k, faraway));
}

// The hard shadow's two minima along one ray, both from the sentinel big:
// over the spheres other than self, and over self (an index outside
// 0..s_total-1 matches none); a skipped sphere folds faraway.
template <typename T>
__device__ __forceinline__ void shadow_minima(const Bundle<T>& b, const V3<T>& o, const V3<T>& d, const T* geom,
                                              int self, int s_cheap, int s_total, T faraway, T big, T& t_others,
                                              T& t_self) {
  t_others = big;
  t_self = big;
  auto fold = [&](int k, T tk) {
    if (k == self) {
      t_self = vmin(t_self, tk);
    } else {
      t_others = vmin(t_others, tk);
    }
  };
  bool self_skipped = false;
  bool others_skipped = false;
  sweep_cheap(b, o, d, geom, s_cheap, faraway, fold, [&](unsigned bits, int k0) {
    const unsigned own = self >= k0 && self - k0 < 32 ? 1u << (self - k0) : 0u;
    self_skipped = self_skipped || (bits & own) != 0u;
    others_skipped = others_skipped || (bits & ~own) != 0u;
  });
  for (int k = s_cheap; k < s_total; ++k) fold(k, block_t_exact(o, d, geom + 4 * k, faraway));
  if (self_skipped) t_self = vmin(t_self, faraway);
  if (others_skipped) t_others = vmin(t_others, faraway);
}

}  // namespace
