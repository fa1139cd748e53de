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

// --- The warp-bundle sphere skip ---
//
// The bound.  A warp's rays o + t d (t > 0) have their origins in a ball
// (centre c, radius r: the centre of the origins' box, and the farthest
// origin from it) and their directions d/|d| in a cone (axis a, the
// normalised sum of the directions; cos_t, the least cosine between a
// direction and a).  A ray from inside the ball that passes within q of a
// sphere's centre g has a twin from c with the same direction that passes
// within q + r of it; a half-line from c in the cone passes within rho of g,
// |v| = |g - c| > rho, only if the angle between a and v is at most
// theta + alpha, cos theta = cos_t, sin alpha = rho / |v|.  The test
// (bundle_reaches) says "skip" when v2 = |v|^2 and that angle rule out every
// such half-line (outside_cone):
//   |v| > rho  and  a.v < cos_t sqrt(|v|^2 - rho^2) - sin_t rho.
// Shadow rays all aim at the light, so their lines pass near it however
// far apart their origins lie: with an apex p (the light), the warp also
// measures eps, the farthest any lane's line passes from p.  Every point of
// such a line lies within eps of the line through p with the same
// direction, in the cone either way: the same rule with p for c, eps for
// r_ball and |a.v| for a.v rules a sphere out too, and the test skips a
// sphere either rule rules out.  Any apex gives a true bound (eps is
// measured on the rays); NaN (the nearest sweep) gives none.
// The ball and the cones cost ~130 operations a lane, once a sweep; the test
// ~45 operations and 3 roots for one lane (~25 and 1 more with an apex),
// once a (warp, sphere) pair.
//
// The margin: rho covers every pair that sphere_t, as compiled (no FMA),
// calls a hit, in units of the dtype's unit roundoff u (2^-24, 2^-53).
//   * disc > 0 as rounded: b = 2 d.oc and ct = |oc|^2 - r^2 each carry at
//     most ~6u of |d||oc| and |oc|^2 + r^2, so the computed b^2 - 4 ct is
//     within ~13u |oc|^2 + 3u r^2 (over 4) of the true one, and a direction
//     with | |d|^2 - 1 | <= 32u adds |d|^2 - 1 of |oc|^2: a hit has the
//     line from o within sqrt(r^2 (1 + 3u) + 48u |o - g|^2) of g.  rho takes
//     r^2 (1 + 16u) + 256u w^2, w = |v| + r_ball >= |o - g|: 5x the 48u.
//     This is the grazing ray whose discriminant rounds positive.
//   * t > 0: with ct > 0 a hit needs b < 0 as rounded (roots: both roots
//     share ct's sign and b's opposite), so d.(g - o) > -6u |d||oc|: the
//     near point of the half-line is o itself or the line's, within the
//     bound above plus (6u)^2 |oc|^2.  With ct <= 0 as rounded (an origin
//     inside, on, or nudged 1e-4 off its sphere, a root near t = 0) o is
//     within sqrt(r^2 (1 + 2u) + 4u |oc|^2) of g: the same bound holds.
//   * rounding of oc, of v and of rho itself: 64u w more on rho; v2 - rho^2
//     loses 8u (v2 + rho^2) before its root (it cancels at a tangent); both
//     sides of the angle rule keep 64u (|v| + rho) apart; cos_t is lowered
//     by 64u (|d| and |a| off 1, the rounded dot products); r_ball is the
//     rounded farthest distance times 1 + 16u.
//   * the apex's cone: eps is each line's distance from p to its point
//     o + (w.d) d, w = p - o, the farthest plus 16u |w| (the rounding of
//     w, w.d and the difference, ~11u |w|), times 1 + 16u; its rho is
//     eps + the quadratic's term above (still with w = |g - c| + r_ball, a
//     bound on |o - g|) + 64u (w + |g - p|).
// A warp whose bound is unusable sweeps every sphere (ok = false): a lane
// past n, a lane with an origin coordinate past 2^40 in magnitude or not a
// number, a direction with | |d|^2 - 1 | > 32u (not unit, zero, inf or NaN),
// or a cone of half-angle 90 degrees or more; and the test never skips with
// v2 >= 2^100 or any NaN (every comparison then fails).  The exact tier (the
// r = 99999 giants, |oc| ~ 1e5) is always swept: its compensated quadratic
// is exact where this margin would be as wide as the giants.
//
// Skipped means a miss at faraway, bitwise.  The nearest sweep needs
// nothing: faraway < tmin never holds.  The shadow minima start from a
// sentinel, so a skipped sphere still folds faraway into t_self (the lane's
// own sphere) or t_others, as vmin would have on the full loop: a minimum
// over numbers does not depend on their order.

constexpr unsigned kFullWarp = 0xffffffffu;
// The launchers' rule: the skip is taken from this many cheap-tier spheres
// on, or as the caller forces it (ops/intersect_fused.py SKIP, the codes).
// On the card (benchmarks/sweep_skip_ab.py, glossy and mirror bounces of
// random_spheres_scene(n)) the skip lost 21-30% at 3 cheap spheres, where
// the bundle costs as much as the sweep; at 7 the shadow sweep lost 17%
// (bounce_lane at parity), at 15 the shadow sweep was at parity
// (bounce_lane 1.2x faster), at 47 both 1.3-1.9x faster.
constexpr int kSkipMinCheap = 16;
enum Skip { kSkipAuto = -1, kSkipOff = 0, kSkipOn = 1 };
inline bool takes_skip(int skip, int s_cheap) {
  return skip == kSkipAuto ? s_cheap >= kSkipMinCheap : skip == kSkipOn;
}
// An origin coordinate past this, or |g - c|^2 past kBundleMaxV2, sweeps every sphere.
constexpr double kBundleMaxCoord = 1099511627776.0;  // 2^40
constexpr double kBundleMaxV2 = 1267650600228229401496703205376.0;  // 2^100

template <typename T> __device__ __forceinline__ T quiet_nan();
template <> __device__ __forceinline__ float quiet_nan<float>() { return nanf(""); }
template <> __device__ __forceinline__ double quiet_nan<double>() { return nan(""); }

template <typename T> __device__ __forceinline__ T unit_roundoff();
template <> __device__ __forceinline__ float unit_roundoff<float>() { return 5.9604644775390625e-8f; }  // 2^-24
template <> __device__ __forceinline__ double unit_roundoff<double>() { return 1.1102230246251565e-16; }  // 2^-53

// A warp's bound, kept in shared memory (a slot of kBundleValues a warp) so
// that it holds no registers through the sweep: every origin within r of c,
// every direction d/|d| within the cone about a / |a| whose half-angle has
// cosine cos_t and sine sin_t, and every ray's line within eps of the point
// p, as s = (c, r, a, cos_t, sin_t, p, eps).  ok = false: the warp sweeps
// every sphere; apex = false: no apex (eps not a number), its cone untested.
constexpr int kBundleValues = 13;
template <typename T> struct Bundle {
  const volatile T* s;
  bool ok;
  bool apex;
};

// The xor butterflies leave every lane the same value bitwise (a + b = b + a).
template <typename T> __device__ __forceinline__ T warp_min(T x) {
  for (int m = 16; m > 0; m >>= 1) x = vmin(x, __shfl_xor_sync(kFullWarp, x, m));
  return x;
}
template <typename T> __device__ __forceinline__ T warp_max(T x) {
  for (int m = 16; m > 0; m >>= 1) x = vmax(x, __shfl_xor_sync(kFullWarp, x, m));
  return x;
}
template <typename T> __device__ __forceinline__ T warp_sum(T x) {
  for (int m = 16; m > 0; m >>= 1) x = x + __shfl_xor_sync(kFullWarp, x, m);
  return x;
}

// The bound of the warp's 32 rays, written to the warp's slot; every lane
// of the warp calls it, none past n.  apex: a point the rays' lines pass
// near (the light, for shadow rays; any point, or NaN for none: eps is
// measured on the rays, so the bound holds whatever it is).
template <typename T>
__device__ __forceinline__ Bundle<T> warp_bundle(const V3<T>& o, const V3<T>& d, const V3<T>& apex, T* slot) {
  const T u = unit_roundoff<T>();
  const T lim = T(kBundleMaxCoord);
  const bool lane_ok = m_abs(o.x) <= lim && m_abs(o.y) <= lim && m_abs(o.z) <= lim &&
                       m_abs(dot3(d, d) - T(1)) <= T(32) * u;
  if (!__all_sync(kFullWarp, lane_ok)) return {slot, false, false};
  const V3<T> c = {(warp_min(o.x) + warp_max(o.x)) * T(0.5), (warp_min(o.y) + warp_max(o.y)) * T(0.5),
                   (warp_min(o.z) + warp_max(o.z)) * T(0.5)};
  const V3<T> e = {o.x - c.x, o.y - c.y, o.z - c.z};
  const T r = warp_max(m_sqrt(dot3(e, e))) * (T(1) + T(16) * u);
  const V3<T> a = normalize3(V3<T>{warp_sum(d.x), warp_sum(d.y), warp_sum(d.z)});
  const T cos_t = warp_min(dot3(d, a)) - T(64) * u;
  const T sin_t = m_sqrt((T(1) - cos_t) * (T(1) + cos_t));
  // The line's distance from the apex: to its point o + (w.d) d, |w| off in
  // at most ~11u |w| by rounding.
  const V3<T> w = {apex.x - o.x, apex.y - o.y, apex.z - o.z};
  const T wd = dot3(w, d);
  const V3<T> f = {w.x - wd * d.x, w.y - wd * d.y, w.z - wd * d.z};
  const T eps = warp_max(m_sqrt(dot3(f, f)) + T(16) * u * m_sqrt(dot3(w, w))) * (T(1) + T(16) * u);
  if ((threadIdx.x & 31u) == 0u) {
    const T values[kBundleValues] = {c.x, c.y, c.z, r, a.x, a.y, a.z, cos_t, sin_t, apex.x, apex.y, apex.z, eps};
    for (int j = 0; j < kBundleValues; ++j) slot[j] = values[j];
  }
  __syncwarp();
  return {slot, cos_t > T(0), eps == eps};
}

// Whether the sphere lies outside the cone (axis a, cos_t, sin_t; doubled:
// both ways) from a point v away from its centre, widened to rho.
template <typename T>
__device__ __forceinline__ bool outside_cone(const V3<T>& v, T v2, T vl, T rho, const V3<T>& a, T cos_t, T sin_t,
                                             bool doubled) {
  const T u = unit_roundoff<T>();
  const T rho2 = rho * rho;
  const T x = v2 - rho2 - T(8) * u * (v2 + rho2);
  const T av = dot3(a, v);
  const T lhs = (doubled ? m_abs(av) : av) + T(64) * u * (vl + rho);
  const T rhs = cos_t * m_sqrt(x) - sin_t * rho;
  return v2 < T(kBundleMaxV2) && x > T(0) && lhs < rhs;
}

// Whether a ray of the bundle may hit the cheap-tier sphere g = (cx, cy, cz,
// r): not if the cone from the ball rules it out, nor if the double cone
// from the apex does (every line within eps of it; |o - g| <= w still).
template <typename T> __device__ __forceinline__ bool bundle_reaches(const Bundle<T>& b, const T* g) {
  const T u = unit_roundoff<T>();
  const V3<T> c = {b.s[0], b.s[1], b.s[2]};
  const T r_b = b.s[3];
  const V3<T> a = {b.s[4], b.s[5], b.s[6]};
  const T cos_t = b.s[7];
  const T sin_t = b.s[8];
  const V3<T> v = {g[0] - c.x, g[1] - c.y, g[2] - c.z};
  const T v2 = dot3(v, v);
  const T vl = m_sqrt(v2);
  const T w = vl + r_b;
  const T q = m_sqrt(g[3] * g[3] * (T(1) + T(16) * u) + T(256) * u * (w * w));
  bool outside = outside_cone(v, v2, vl, r_b + q + T(64) * u * w, a, cos_t, sin_t, false);
  if (b.apex) {  // uniform over the warp
    const V3<T> vp = {g[0] - b.s[9], g[1] - b.s[10], g[2] - b.s[11]};
    const T vp2 = dot3(vp, vp);
    const T vpl = m_sqrt(vp2);
    outside = outside || outside_cone(vp, vp2, vpl, b.s[12] + q + T(64) * u * (w + vpl), a, cos_t, sin_t, true);
  }
  return !outside;
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
