// The warp bundle: a bound on the 32 rays of a warp (a ball of origins, a
// cone of directions, how near their lines pass a point), and the test of a
// sphere against it, with its rounding margin.  sweep_math.cuh builds the
// standalone sweeps' skip on it (shadow_sweep, both modes, nearest_sweep and
// bounce_lane: a sphere no half-line of the warp can hit); culled_smooth.cu
// builds fwd_cs's (a sphere no line of the warp comes near enough to shade,
// line_reaches below).  ops/intersect_fused.py (warp_bundles, bundle_test,
// line_test) is the plain version, term for term.

#pragma once

#include "sphere_math.cuh"

namespace {

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
constexpr unsigned kFullWarp = 0xffffffffu;
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
template <typename T> __device__ __forceinline__ T warp_sum_all(T x) {
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
  const V3<T> a = normalize3(V3<T>{warp_sum_all(d.x), warp_sum_all(d.y), warp_sum_all(d.z)});
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

// Whether the bundle's bound rules out sphere g = (cx, cy, cz, r): the
// cone from the ball (doubled: the whole line) widened to r_ball + q(w) +
// 64u w, or the double cone from the apex widened to eps + q(w) + 64u (w +
// |g - p|), w = |g - c| + r_ball >= |o - g|; q(w) the distance from the
// centre within which a line counts.
template <typename T, typename Q>
__device__ __forceinline__ bool rules_out(const Bundle<T>& b, const T* g, bool doubled, Q&& q_of) {
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
  const T q = q_of(w);
  bool outside = outside_cone(v, v2, vl, r_b + q + T(64) * u * w, a, cos_t, sin_t, doubled);
  if (b.apex) {  // uniform over the warp
    const V3<T> vp = {g[0] - b.s[9], g[1] - b.s[10], g[2] - b.s[11]};
    const T vp2 = dot3(vp, vp);
    const T vpl = m_sqrt(vp2);
    outside = outside || outside_cone(vp, vp2, vpl, b.s[12] + q + T(64) * u * (w + vpl), a, cos_t, sin_t, true);
  }
  return outside;
}

// Whether a ray of the bundle may hit the cheap-tier sphere g = (cx, cy, cz,
// r): not if the cone from the ball rules it out, nor if the double cone
// from the apex does (every line within eps of it), a hit counting within
// the margin's q of the centre.
template <typename T> __device__ __forceinline__ bool bundle_reaches(const Bundle<T>& b, const T* g) {
  const T u = unit_roundoff<T>();
  return !rules_out(b, g, false, [&](T w) { return m_sqrt(g[3] * g[3] * (T(1) + T(16) * u) + T(256) * u * (w * w)); });
}

// Whether some lane's line (both ways from its origin) may pass within
// r_eff of sphere g = (cx, cy, cz, r)'s centre, r_eff^2 = r^2 + edge: fwd_cs's
// shadow skip, edge = |SigEdge<T>::lo| / (4 sharp_s) (smooth_math.cuh).  Its
// shadow factor reads disc = b^2 - 4 ct, b = 2 L.oc, ct = |oc|^2 - r^2, and
// sig(sharp_s disc) is exactly 0 wherever the rounded sharp_s disc < lo.
// With |L|^2 - 1 within 32u (the bundle's lane test) disc / 4 is
// r^2 - |L|^2 dist^2 + (|L|^2 - 1) |oc|^2, dist the line's distance from
// the centre, and the rounding of oc, b, ct and disc adds at most
// 17u |oc|^2 + 3u r^2, so the rounded disc / 4 is at most
//   r^2 (1 + 3u) - (1 - 32u) dist^2 + 49u |oc|^2,
// and sharp_s disc rounds at most u nearer 0.  Hence dist^2 >
// (r^2 + edge)(1 + 64u) + 256u w^2 (w >= |oc|) makes it < lo: q below is
// that distance, and the rules of bundle_reaches (the rounding of v, rho
// and the angle test) carry it to every line of the warp, both cones
// doubled since disc sees the whole line.
template <typename T> __device__ __forceinline__ bool line_reaches(const Bundle<T>& b, const T* g, T edge) {
  const T u = unit_roundoff<T>();
  return !rules_out(b, g, true,
                    [&](T w) { return m_sqrt((g[3] * g[3] + edge) * (T(1) + T(64) * u) + T(256) * u * (w * w)); });
}

}  // namespace
