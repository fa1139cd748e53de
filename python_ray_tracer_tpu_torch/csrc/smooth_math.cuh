// Device code of the smooth-visibility kernels, shared by
// bounce_smooth_sub.cu and culled_smooth.cu: one smooth bounce (the TPU
// kernels' _FwdSub, python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:227)
// and its handwritten adjoint (_adjoint_bounce, :578).
//
// Atlas mode (kAtlas, :407-429 and :487-488): an image lane's in-kernel
// diffuse texture is zero, the bounce exports its flat texel id and
// dww = dw * w (diffuse weight x path weight), and the caller adds
// texels[flat] * dww outside; the adjoint takes that term's cotangent
// g_dww (:598-603, :676-677, :755).
//
// fwd_bounce and adjoint_bounce are templates over two choices:
//   * where the winner comes from (Winner): a sweep of every sphere, the
//     saved (idx, hit, clear) of a replay, or a known (idx, hit) with the
//     shadow product still computed (the culled smooth kernels);
//   * which spheres the shadow loops visit (a Shadow set): every sphere
//     (AllSpheres), or a tile's candidate list, its full-tier fallback and
//     the exact tier (culled_smooth.cu).  A sphere left out has an
//     occlusion factor of exactly 1 in f32, so the product is the same.
// adjoint_bounce hands its table gradients to a Sink: geom(slot, k, c, x)
// for the shadow spheres, winner(sc, idx, rows) for the winner's material
// row and consts(sc, c, x) for the scene constants.
//
// Numerics that must hold (see ops/_build.py for the flags):
//   * --fmad=false, never fast math: the exact tier's Dekker twoProd and
//     Knuth twoSum error terms must not be contracted into FMAs.  The split
//     factor is 4097 in f32 and 134217729 in f64, as in the smooth kernels'
//     _two_prod (not the hard kernels' 4097 everywhere);
//   * sigmoid is 1 / (1 + exp(-x)), torch's CUDA form: in f32 it is exactly
//     0 for x < -88.72, which the culled route's exactness rests on, and its
//     denormal values are not flushed;
//   * strict t < tmin for the winner (lowest index wins ties), strict
//     disc > dmax for the miss fallback (sentinel -3e38);
//   * Phase C divides by max(fac, 1e-6), as the TPU kernel does.

#pragma once

#include "sphere_math.cuh"

namespace {

constexpr int kWarp = 32;
constexpr double kEpsDen = 1e-6;     // _EPS_DEN
constexpr double kNegBig = -3.0e38;  // max-disc fallback sentinel

__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }

template <typename T> __device__ __forceinline__ T split_factor();
template <> __device__ __forceinline__ float split_factor<float>() { return 4097.0f; }
template <> __device__ __forceinline__ double split_factor<double>() { return 134217729.0; }

template <typename T> __device__ __forceinline__ T sgn(T x) { return T((T(0) < x) - (x < T(0))); }
template <typename T> __device__ __forceinline__ T sig(T x) { return T(1) / (T(1) + m_exp(-x)); }

template <typename T> __device__ __forceinline__ T pow4(T x) {
  const T x2 = x * x;
  return x2 * x2;
}
template <typename T> __device__ __forceinline__ T pow3(T x) { return x * (x * x); }

// (v / |v|, |v|) with the reference's guarded reciprocal.
template <typename T> __device__ __forceinline__ V3<T> norm3(const V3<T>& v, T& mag) {
  mag = m_sqrt(dot3(v, v));
  const T inv = T(1) / (mag == T(0) ? T(1) : mag);
  return {v.x * inv, v.y * inv, v.z * inv};
}

template <typename T> struct Scal {
  T faraway, sharp_e, sharp_s;
  int s_cheap, s_total;
  int tex_h, tex_w;  // the atlas's slot extents (atlas mode)
};

// Root selection and validity (_quad_sol_disc).
template <typename T>
__device__ __forceinline__ void quad_sol_disc(T b, T ct, T faraway, T& sol, T& disc, T& t) {
  disc = b * b - T(4) * ct;
  const bool pos = disc > T(0);
  const T sq = pos ? m_sqrt(disc) : T(0);
  const T qroot = T(-0.5) * (b + (b < T(0) ? -sq : sq));
  const T safe_q = qroot == T(0) ? T(1) : qroot;
  const T other = qroot == T(0) ? T(0) : ct / safe_q;
  const T t0 = vmin(qroot, other);
  const T t1 = vmax(qroot, other);
  sol = (t0 > T(0) && t0 < t1) ? t0 : t1;
  t = (pos && sol > T(0)) ? sol : faraway;
}

template <typename T>
__device__ __forceinline__ void b_cterm_plain(const V3<T>& o, const V3<T>& d, const V3<T>& c, T r, T& b,
                                              T& ct) {
  const V3<T> oc = {o.x - c.x, o.y - c.y, o.z - c.z};
  b = T(2) * dot3(d, oc);
  ct = dot3(oc, oc) - r * r;
}

template <typename T> __device__ __forceinline__ void two_sum(T a, T b, T& s, T& e) {
  s = a + b;
  const T bv = s - a;
  e = (a - (s - bv)) + (b - bv);
}

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

// _compensated_b_cterm: exact tier.
template <typename T>
__device__ __forceinline__ void b_cterm_exact(const V3<T>& o, const V3<T>& d, const V3<T>& c, T r, T& b,
                                              T& ct) {
  T h[3], lo[3];
  for (int i = 0; i < 3; ++i) two_sum(o[i], -c[i], h[i], lo[i]);
  b = T(2) * ((d.x * h[0] + d.y * h[1] + d.z * h[2]) + (d.x * lo[0] + d.y * lo[1] + d.z * lo[2]));
  T p0, e0, p1, e1, p2, e2, pr, er;
  two_prod(h[0], h[0], p0, e0);
  two_prod(h[1], h[1], p1, e1);
  two_prod(h[2], h[2], p2, e2);
  two_prod(r, r, pr, er);
  T s1, t1, s2, t2, s3, t3;
  two_sum(p0, p1, s1, t1);
  two_sum(s1, p2, s2, t2);
  two_sum(s2, -pr, s3, t3);
  const T corr = (((t1 + t2 + t3) + (e0 + e1 + e2 - er)) + T(2) * (h[0] * lo[0] + h[1] * lo[1] + h[2] * lo[2]))
                 + (lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2]);
  ct = s3 + corr;
}

// The (S, 4) geometry table read from global memory through the read-only
// path: a sweep's lanes all read the same sphere, so each load is one
// broadcast.  The kernels take it where the table does not fit in shared
// memory; elsewhere they index a staged copy (const T*).
template <typename T> struct LdgGeom {
  const T* p;
  __device__ __forceinline__ T operator[](int i) const { return __ldg(p + i); }
};

// Sphere k's (sol, disc, t, b, c_term), tier by index.  G indexes the
// geometry table: a pointer, or an LdgGeom.
template <typename T, typename G>
__device__ __forceinline__ void sphere_quad(int k, const Scal<T>& sc, const V3<T>& o, const V3<T>& d,
                                            const G& geom, T& sol, T& disc, T& t, T& b, T& ct) {
  const V3<T> c = {geom[4 * k], geom[4 * k + 1], geom[4 * k + 2]};
  const T r = geom[4 * k + 3];
  if (k < sc.s_cheap) {
    b_cterm_plain(o, d, c, r, b, ct);
  } else {
    b_cterm_exact(o, d, c, r, b, ct);
  }
  quad_sol_disc(b, ct, sc.faraway, sol, disc, t);
}

// Every intermediate of one smooth bounce that the adjoint reads (_FwdSub).
template <typename T> struct Fwd {
  V3<T> o, d;
  T thr, alive;
  int idx;
  bool hit;
  T clear;
  const T* m;  // winner's material row
  T b_w, ct_w, sol_w, disc_w, sig_de, sig_se, cov_w, coverage, t_safe, inv_r;
  V3<T> p, normal, L, V, H, p_n, tex, irid_base, color, refl;
  T l_mag, v_mag, h_mag, u_mag;
  T n_dot_l, dw, relu_ny, dome_up;
  bool is_checker, spec_gate;
  // Atlas mode: an image lane, its flat texel id (0 elsewhere), dw * w there.
  bool is_image;
  int flat;
  T dww;
  T nv_raw, nh_raw, vh_raw, nl_raw, n_dot_v, n_dot_h, v_dot_h, n_dot_l_c;
  T f0, one_m_vdh5, fresnel, alpha, ggx_den, dist;
  T g1l, g1l_root, g1v, g1v_root, geom, spec_den, spec_base, one_m_ndv, glint, spec;
  T view_angle, angle_factor, phase, ip, hue, irid_w;
  T w, refl_coeff, thr_out, ddn;
  // Glossy continuation (kXi): dout = pert ? r_pert : refl.
  V3<T> dout, t1v, t2v, hvec, r_pert;
  T xi1, cos_t, sin_t, cphi, sphi, s_sign, a_b, sc, ss, hw_mag, dhn, r_mag;
  bool pert;
};

// Where a bounce's winner comes from: a sweep of every sphere; the saved
// (idx, hit, clear) of a replay (no sweep at all); or a known (idx, hit),
// the shadow product still computed.  The caller sets f.idx, f.hit (and
// f.clear when saved) before the call.
enum class Winner { kSweep, kSaved, kKnown };

// The shadow set of the unculled kernels: every sphere in index order.
// visit(sc, fn) calls fn(slot, k) for each sphere k; slot is its position
// in the visiting order.
struct AllSpheres {
  template <typename T, typename F> __device__ __forceinline__ void visit(const Scal<T>& sc, F&& fn) const {
    for (int k = 0; k < sc.s_total; ++k) fn(k, k);
  }
};

// One smooth bounce.  kXi: the continuation is glossy, from the uniforms
// (xi1, xi2); otherwise the mirror.  kAtlas: the atlas mode (sc.tex_h x
// sc.tex_w slots).  mat may lie in shared or global memory; geom is anything
// sphere_quad indexes.
template <typename T, bool kXi, Winner kWin, bool kAtlas = false, typename Shadow, typename G>
__device__ __forceinline__ void fwd_bounce(Fwd<T>& f, const V3<T>& o, const V3<T>& d, T thr, T alive,
                                           const G& geom, const T* mat, const T* cst, const Scal<T>& sc,
                                           const Shadow& shadow, T xi1, T xi2) {
  f.o = o;
  f.d = d;
  f.thr = thr;
  f.alive = alive;
  if (kWin == Winner::kSweep) {
    T tmin = sc.faraway;
    int imin = 0;
    T dmax = T(kNegBig);
    int idmax = 0;
    for (int k = 0; k < sc.s_total; ++k) {
      T sol, disc, t, b, ct;
      sphere_quad(k, sc, o, d, geom, sol, disc, t, b, ct);
      if (t < tmin) {  // strict: lowest index wins exact ties
        tmin = t;
        imin = k;
      }
      if (disc > dmax) {
        dmax = disc;
        idmax = k;
      }
    }
    f.hit = tmin != sc.faraway;
    f.idx = f.hit ? imin : idmax;
  }
  const T* m = mat + kMatCols * f.idx;
  f.m = m;
  const V3<T> c_w = {m[CX], m[CY], m[CZ]};
  const T r_w = m[RAD];

  if (f.idx >= sc.s_cheap) {
    b_cterm_exact(o, d, c_w, r_w, f.b_w, f.ct_w);
  } else {
    b_cterm_plain(o, d, c_w, r_w, f.b_w, f.ct_w);
  }
  T t_w;
  quad_sol_disc(f.b_w, f.ct_w, sc.faraway, f.sol_w, f.disc_w, t_w);

  f.sig_de = sig(sc.sharp_e * f.disc_w);
  f.sig_se = sig(sc.sharp_e * f.sol_w);
  f.cov_w = f.sig_de * f.sig_se;
  f.coverage = f.cov_w * alive;

  f.t_safe = f.hit ? f.sol_w : T(1);
  f.p = {o.x + d.x * f.t_safe, o.y + d.y * f.t_safe, o.z + d.z * f.t_safe};
  f.inv_r = T(1) / r_w;
  f.normal = {(f.p.x - c_w.x) * f.inv_r, (f.p.y - c_w.y) * f.inv_r, (f.p.z - c_w.z) * f.inv_r};

  f.L = norm3(V3<T>{cst[3] - f.p.x, cst[4] - f.p.y, cst[5] - f.p.z}, f.l_mag);
  f.V = norm3(V3<T>{cst[0] - f.p.x, cst[1] - f.p.y, cst[2] - f.p.z}, f.v_mag);
  f.p_n = {f.p.x + f.normal.x * T(kNudge), f.p.y + f.normal.y * T(kNudge), f.p.z + f.normal.z * T(kNudge)};

  if (kWin != Winner::kSaved) {
    T clear = T(1);
    shadow.visit(sc, [&](int, int k) {
      T sol, disc, t, b, ct;
      sphere_quad(k, sc, f.p_n, f.L, geom, sol, disc, t, b, ct);
      const T occl = sig(sc.sharp_s * disc) * sig(sc.sharp_s * sol);
      clear = clear * (f.idx == k ? T(1) : T(1) - occl);
    });
    f.clear = clear;
  }

  f.n_dot_l = vmax(dot3(f.normal, f.L), T(0));
  const int cx = mod2(static_cast<int>(m_trunc(f.p.x * T(2))));
  const int cz = mod2(static_cast<int>(m_trunc(f.p.z * T(2))));
  const T checker = cx == cz ? T(1) : T(0);
  f.is_checker = m[KIND] == T(1);
  f.tex = {f.is_checker ? checker : m[DCR], f.is_checker ? checker : m[DCG], f.is_checker ? checker : m[DCB]};
  f.is_image = false;
  if constexpr (kAtlas) {
    f.is_image = m[KIND] == T(2);
    f.flat = f.is_image ? flat_texel(f.normal, m, sc.tex_h, sc.tex_w) : 0;
    if (f.is_image) f.tex = {T(0), T(0), T(0)};
  }
  f.dw = f.n_dot_l * f.clear * m[DG];

  f.relu_ny = vmax(f.normal.y, T(0));
  f.dome_up = f.relu_ny * cst[9];
  const V3<T> dome = {cst[6] * f.dome_up, cst[7] * f.dome_up, cst[8] * f.dome_up};

  f.H = norm3(V3<T>{f.L.x + f.V.x, f.L.y + f.V.y, f.L.z + f.V.z}, f.h_mag);
  f.nv_raw = dot3(f.normal, f.V);
  f.nh_raw = dot3(f.normal, f.H);
  f.vh_raw = dot3(f.V, f.H);
  f.nl_raw = dot3(f.normal, f.L);
  f.n_dot_v = clip01(f.nv_raw);
  f.n_dot_h = clip01(f.nh_raw);
  f.v_dot_h = clip01(f.vh_raw);
  f.n_dot_l_c = clip01(f.nl_raw);
  const T ior = m[IOR];
  f.f0 = pow2((ior - T(1)) / (ior + T(1)));
  f.one_m_vdh5 = pow5(T(1) - f.v_dot_h);
  f.fresnel = f.f0 + (T(1) - f.f0) * f.one_m_vdh5;
  f.alpha = pow2(m[ROUGH]);
  f.ggx_den = pow2(f.n_dot_h) * (pow2(f.alpha) - T(1)) + T(1);
  f.dist = pow2(f.alpha) / (T(kPi) * (pow2(f.ggx_den) + T(kEps)));
  f.g1l_root = m_sqrt(pow2(f.alpha) + (T(1) - pow2(f.alpha)) * pow2(f.n_dot_l_c));
  f.g1l = T(2) * f.n_dot_l_c / (f.n_dot_l_c + f.g1l_root + T(kEps));
  f.g1v_root = m_sqrt(pow2(f.alpha) + (T(1) - pow2(f.alpha)) * pow2(f.n_dot_v));
  f.g1v = T(2) * f.n_dot_v / (f.n_dot_v + f.g1v_root + T(kEps));
  f.geom = f.g1l * f.g1v;
  f.spec_den = T(4) * f.n_dot_v + T(kEps);
  f.spec_base = (f.fresnel * f.dist * f.geom) / f.spec_den;
  f.one_m_ndv = T(1) - f.n_dot_v;
  f.glint = m_pow(f.one_m_ndv, T(kGlintExponent)) * f.n_dot_l_c;
  f.spec_gate = f.n_dot_v > T(0);
  f.spec = f.spec_gate ? f.spec_base + m[SG] * f.glint : T(0);
  const T spec_term = f.spec * m[SG] * f.clear;

  f.view_angle = clip01(f.nv_raw);
  f.angle_factor = m_abs(f.view_angle - T(0.5)) * T(2);
  f.phase = f.angle_factor * T(kPi) * m[TFT] * T(10);
  f.ip = m_sin(f.phase);
  f.hue = (m[TFI] - T(1)) / T(2);
  f.irid_w = m[TFW] * m[IG];
  f.irid_base = {f.ip * f.hue + (T(1) - f.hue) * (T(1) - f.ip), f.ip * (T(1) - f.hue) + f.hue * (T(1) - f.ip),
                 T(0.5) + T(0.5) * f.ip};

  const T amb = T(kAmbient);
  for (int i = 0; i < 3; ++i) {
    f.color[i] = amb + f.tex[i] * f.dw + dome[i] + spec_term + f.irid_base[i] * f.irid_w;
  }

  f.w = thr * f.coverage;
  if constexpr (kAtlas) f.dww = f.is_image ? f.dw * f.w : T(0);
  f.refl_coeff = T(0.5) * m[SG] * f.clear;
  f.thr_out = f.w * f.refl_coeff;

  f.ddn = T(2) * dot3(d, f.normal);
  f.refl = norm3(V3<T>{d.x - f.normal.x * f.ddn, d.y - f.normal.y * f.ddn, d.z - f.normal.z * f.ddn}, f.u_mag);
  if (!kXi) {
    f.dout = f.refl;
    return;
  }

  // Glossy continuation (_FwdSub :497-538, ops/vecmath.ggx_perturb_reflect
  // term for term): reflect about a GGX-sampled microfacet half-vector.
  const V3<T>& n = f.normal;
  f.xi1 = xi1;
  const T t2q = pow2(f.alpha) * xi1 / vmax(T(1) - xi1, T(1e-8));
  f.cos_t = T(1) / m_sqrt(T(1) + t2q);  // a division, never rsqrt
  f.sin_t = m_sqrt(vmax(T(1) - pow2(f.cos_t), T(0)));
  const T phi = T(2.0 * kPi) * xi2;
  f.cphi = m_cos(phi);
  f.sphi = m_sin(phi);
  f.s_sign = n.z >= T(0) ? T(1) : T(-1);
  f.a_b = T(-1) / (f.s_sign + n.z);
  const T b_b = n.x * n.y * f.a_b;
  f.t1v = {T(1) + f.s_sign * n.x * n.x * f.a_b, f.s_sign * b_b, -f.s_sign * n.x};
  f.t2v = {b_b, f.s_sign + n.y * n.y * f.a_b, -n.y};
  f.sc = f.sin_t * f.cphi;
  f.ss = f.sin_t * f.sphi;
  V3<T> hw;
  for (int i = 0; i < 3; ++i) hw[i] = f.t1v[i] * f.sc + f.t2v[i] * f.ss + n[i] * f.cos_t;
  f.hvec = norm3(hw, f.hw_mag);
  f.dhn = T(2) * dot3(d, f.hvec);
  f.r_pert = norm3(V3<T>{d.x - f.hvec.x * f.dhn, d.y - f.hvec.y * f.dhn, d.z - f.hvec.z * f.dhn}, f.r_mag);
  // Below-surface samples keep the mirror; the gate is piecewise constant.
  f.pert = dot3(f.r_pert, n) > T(0);
  f.dout = f.pert ? f.r_pert : f.refl;
}

template <typename T> __device__ __forceinline__ T adj_gate(T raw) {
  return (raw > T(0) && raw < T(1)) ? T(1) : T(0);
}

// (g_b, g_ct) of the as-computed quad_sol_disc (_sol_disc_adjoint).
template <typename T>
__device__ __forceinline__ void sol_disc_adjoint(T b, T ct, T g_sol, T g_disc, T& g_b_out, T& g_ct_out) {
  const T disc = b * b - T(4) * ct;
  const bool pos = disc > T(0);
  const T sq = pos ? m_sqrt(disc) : T(0);
  const T sg = b < T(0) ? T(-1) : T(1);
  const T qroot = T(-0.5) * (b + sg * sq);
  const bool q_zero = qroot == T(0);
  const T safe_q = q_zero ? T(1) : qroot;
  const T other = q_zero ? T(0) : ct / safe_q;
  const T t0 = vmin(qroot, other);
  const T t1 = vmax(qroot, other);
  const T sol = (t0 > T(0) && t0 < t1) ? t0 : t1;
  const bool chose_q = sol == qroot;

  g_b_out = T(2) * b * g_disc;
  g_ct_out = T(-4) * g_disc;
  T g_qroot = chose_q ? g_sol : T(0);
  const T g_other = chose_q ? T(0) : g_sol;
  g_ct_out = g_ct_out + (q_zero ? T(0) : g_other / safe_q);
  g_qroot = g_qroot + (q_zero ? T(0) : -g_other * ct / (safe_q * safe_q));
  g_b_out = g_b_out - T(0.5) * g_qroot;
  const T g_sq = T(-0.5) * sg * g_qroot;
  const T g_disc_sq = pos ? g_sq / (T(2) * vmax(sq, T(kEpsDen))) : T(0);
  g_b_out = g_b_out + T(2) * b * g_disc_sq;
  g_ct_out = g_ct_out - T(4) * g_disc_sq;
}

// The glossy continuation's adjoint (_adjoint_bounce :615-657): splits
// g_dout by the recomputed pert gate into the mirror branch's share (g_refl,
// returned in place) and the microfacet branch, chained back to d (g_d_p),
// the normal (g_n_p) and alpha (the return value).
template <typename T>
__device__ __forceinline__ T ggx_adjoint(const Fwd<T>& f, V3<T>& g_refl, V3<T>& g_d_p, V3<T>& g_n_p) {
  const V3<T>& d = f.d;
  V3<T> g_r;
  for (int i = 0; i < 3; ++i) {
    g_r[i] = f.pert ? g_refl[i] : T(0);
    g_refl[i] = f.pert ? T(0) : g_refl[i];
  }
  // r_pert = ur / |ur|, ur = d - hvec dhn, dhn = 2 d.hvec
  const T rdotp = dot3(f.r_pert, g_r);
  const T inv_rmag = T(1) / vmax(f.r_mag, T(kEpsDen));
  V3<T> g_ur;
  for (int i = 0; i < 3; ++i) g_ur[i] = (g_r[i] - f.r_pert[i] * rdotp) * inv_rmag;
  g_d_p = g_ur;
  const T g_dhn = -dot3(f.hvec, g_ur);
  V3<T> g_h;
  for (int i = 0; i < 3; ++i) g_h[i] = -f.dhn * g_ur[i];
  for (int i = 0; i < 3; ++i) {
    g_d_p[i] = g_d_p[i] + T(2) * f.hvec[i] * g_dhn;
    g_h[i] = g_h[i] + T(2) * d[i] * g_dhn;
  }
  // hvec = hw / |hw|, hw = t1v sc + t2v ss + normal cos_t
  const T hdotp = dot3(f.hvec, g_h);
  const T inv_wmag = T(1) / vmax(f.hw_mag, T(kEpsDen));
  V3<T> g_wv;
  for (int i = 0; i < 3; ++i) g_wv[i] = (g_h[i] - f.hvec[i] * hdotp) * inv_wmag;
  const T g_sc = dot3(f.t1v, g_wv);
  const T g_ss = dot3(f.t2v, g_wv);
  T g_cos = dot3(f.normal, g_wv);
  V3<T> g_t1, g_t2;
  for (int i = 0; i < 3; ++i) {
    g_t1[i] = f.sc * g_wv[i];
    g_t2[i] = f.ss * g_wv[i];
    g_n_p[i] = f.cos_t * g_wv[i];
  }
  // Branchless tangent frame: s piecewise constant, a = -1/(s+nz) with
  // da/dnz = a^2, b = nx ny a.
  const T sgn = f.s_sign, ab = f.a_b;
  const V3<T>& nrm = f.normal;
  const T g_bb = sgn * g_t1.y + g_t2.x;
  const T g_ab = sgn * nrm.x * nrm.x * g_t1.x + nrm.y * nrm.y * g_t2.y + nrm.x * nrm.y * g_bb;
  g_n_p.x = g_n_p.x + T(2) * sgn * nrm.x * ab * g_t1.x - sgn * g_t1.z + nrm.y * ab * g_bb;
  g_n_p.y = g_n_p.y + nrm.x * ab * g_bb + T(2) * nrm.y * ab * g_t2.y - g_t2.z;
  g_n_p.z = g_n_p.z + ab * ab * g_ab;
  // sin_t = sqrt(max(0, 1 - cos^2)), gated at sin_t > 1e-6 (the sample is
  // then the mirror, whose slope the mirror branch carries).
  const T g_sin = f.cphi * g_sc + f.sphi * g_ss;
  const T slope = f.sin_t > T(1e-6) ? -f.cos_t / vmax(f.sin_t, T(1e-6)) : T(0);
  g_cos = g_cos + slope * g_sin;
  // cos_t = (1 + t2q)^(-1/2), t2q = alpha^2 xi1 / max(1 - xi1, 1e-8)
  const T g_t2q = T(-0.5) * pow3(f.cos_t) * g_cos;
  return T(2) * f.alpha * f.xi1 / vmax(T(1) - f.xi1, T(1e-8)) * g_t2q;
}

// One bounce's handwritten adjoint (Phases A-G).  In: the cotangents of the
// bounce's outputs; out (in place): those of its inputs.  g_acc passes
// through (acc is a pure accumulator).  Phase C visits the shadow set of
// the forward; table gradients go to the sink.  kAtlas: g_dww_raw is the
// cotangent of the bounce's dww (kept on image lanes only).
template <typename T, bool kXi, bool kAtlas = false, typename Shadow, typename Sink, typename G>
__device__ __forceinline__ void adjoint_bounce(const Fwd<T>& f, V3<T>& g_o, V3<T>& g_d, T& g_thr, T& g_alive,
                                               const V3<T>& g_acc, const G& geom, const T* cst,
                                               const Scal<T>& sc, const Shadow& shadow, const Sink& sink,
                                               T g_dww_raw = T(0)) {
  const T* m = f.m;
  const V3<T>& o = f.o;
  const V3<T>& d = f.d;
  const T g_thr_o = g_thr;
  const T g_alive_o = g_alive;

  // --- Phase A: top level and shading ---
  const V3<T> g_color = {g_acc.x * f.w, g_acc.y * f.w, g_acc.z * f.w};
  T g_w = g_acc.x * f.color.x + g_acc.y * f.color.y + g_acc.z * f.color.z;
  g_w = g_w + g_thr_o * f.refl_coeff;
  // The external texel term acc += texel * dww, dww = dw * w on image lanes.
  const T g_dww = kAtlas && f.is_image ? g_dww_raw : T(0);
  if (kAtlas) g_w = g_w + g_dww * f.dw;
  const T g_rc = g_thr_o * f.w;
  T g_sg = T(0.5) * f.clear * g_rc;
  T g_clear = T(0.5) * m[SG] * g_rc;
  const T g_coverage = g_alive_o + g_w * f.thr;
  const T g_thr_in = g_w * f.coverage;

  // continuation: dout = refl = u / |u|, or pert ? r_pert : refl (kXi)
  V3<T> g_refl = g_d;
  V3<T> g_d_p = {T(0), T(0), T(0)}, g_n_p = {T(0), T(0), T(0)};
  const T g_A_pert = kXi ? ggx_adjoint(f, g_refl, g_d_p, g_n_p) : T(0);
  const T rdot = dot3(f.refl, g_refl);
  const T inv_umag = T(1) / vmax(f.u_mag, T(kEpsDen));
  V3<T> g_u;
  for (int i = 0; i < 3; ++i) g_u[i] = (g_refl[i] - f.refl[i] * rdot) * inv_umag;
  V3<T> g_d_acc = g_u;
  const T g_ddn = -dot3(f.normal, g_u);
  V3<T> g_n_acc;
  for (int i = 0; i < 3; ++i) g_n_acc[i] = -f.ddn * g_u[i];
  for (int i = 0; i < 3; ++i) {
    g_d_acc[i] = g_d_acc[i] + T(2) * f.normal[i] * g_ddn;
    g_n_acc[i] = g_n_acc[i] + T(2) * d[i] * g_ddn;
  }
  if (kXi) {
    for (int i = 0; i < 3; ++i) {
      g_d_acc[i] = g_d_acc[i] + g_d_p[i];
      g_n_acc[i] = g_n_acc[i] + g_n_p[i];
    }
  }

  V3<T> g_tex;
  for (int i = 0; i < 3; ++i) g_tex[i] = g_color[i] * f.dw;
  T g_dw = g_color.x * f.tex.x + g_color.y * f.tex.y + g_color.z * f.tex.z;
  if (kAtlas) g_dw = g_dw + g_dww * f.w;
  const T g_spec_term = g_color.x + g_color.y + g_color.z;
  const T g_irid_w = g_color.x * f.irid_base.x + g_color.y * f.irid_base.y + g_color.z * f.irid_base.z;
  const T g_ip = f.irid_w * (g_color.x * (T(2) * f.hue - T(1)) + g_color.y * (T(1) - T(2) * f.hue)
                             + g_color.z * T(0.5));
  const T g_hue = f.irid_w * (g_color.x * (T(2) * f.ip - T(1)) + g_color.y * (T(1) - T(2) * f.ip));
  const T g_tfw = g_irid_w * m[IG];
  const T g_ig = g_irid_w * m[TFW];
  const T g_tfi = g_hue * T(0.5);
  const T g_phase = m_cos(f.phase) * g_ip;
  const T g_af = T(kPi) * T(10) * m[TFT] * g_phase;
  const T g_tft = f.angle_factor * T(kPi) * T(10) * g_phase;
  const T g_va = T(2) * sgn(f.view_angle - T(0.5)) * g_af;
  const T gate_nv = adj_gate(f.nv_raw);
  const T g_nv_raw = g_va * gate_nv;
  T g_spec = g_spec_term * m[SG] * f.clear;
  g_sg = g_sg + g_spec_term * f.spec * f.clear;
  g_clear = g_clear + g_spec_term * f.spec * m[SG];
  g_spec = f.spec_gate ? g_spec : T(0);
  const T g_spec_base = g_spec;
  g_sg = g_sg + g_spec * f.glint;
  const T g_glint = g_spec * m[SG];
  const T g_one_m_ndv = g_glint * T(kGlintExponent) * m_pow(f.one_m_ndv, T(kGlintExponent - 1.0)) * f.n_dot_l_c;
  T g_ndv = -g_one_m_ndv;
  T g_nlc = g_glint * m_pow(f.one_m_ndv, T(kGlintExponent));
  const T inv_sden = T(1) / f.spec_den;
  const T g_fres = g_spec_base * f.dist * f.geom * inv_sden;
  const T g_dist = g_spec_base * f.fresnel * f.geom * inv_sden;
  const T g_geom = g_spec_base * f.fresnel * f.dist * inv_sden;
  const T g_sden = -g_spec_base * f.spec_base * inv_sden;
  g_ndv = g_ndv + T(4) * g_sden;
  const T A = f.alpha;
  const T g_g1l = g_geom * f.g1v;
  const T g_g1v = g_geom * f.g1l;

  T gx_l, gA_l, gx_v, gA_v;
  {
    const T x = f.n_dot_l_c, R = f.g1l_root;
    const T Rs = vmax(R, T(kEpsDen));
    const T den = x + R + T(kEps);
    const T Rp = (T(1) - pow2(A)) * x / Rs;
    gx_l = g_g1l * T(2) * (R + T(kEps) - x * Rp) / (den * den);
    const T dRdA = A * (T(1) - x * x) / Rs;
    gA_l = g_g1l * (T(-2) * x / (den * den)) * dRdA;
  }
  {
    const T x = f.n_dot_v, R = f.g1v_root;
    const T Rs = vmax(R, T(kEpsDen));
    const T den = x + R + T(kEps);
    const T Rp = (T(1) - pow2(A)) * x / Rs;
    gx_v = g_g1v * T(2) * (R + T(kEps) - x * Rp) / (den * den);
    const T dRdA = A * (T(1) - x * x) / Rs;
    gA_v = g_g1v * (T(-2) * x / (den * den)) * dRdA;
  }
  g_nlc = g_nlc + gx_l;
  g_ndv = g_ndv + gx_v;
  T g_A = g_A_pert + gA_l + gA_v;
  const T Dq = f.ggx_den;
  const T denD = T(kPi) * (Dq * Dq + T(kEps));
  g_A = g_A + g_dist * T(2) * A / denD;
  const T g_Dq = g_dist * (-(A * A) * T(2) * Dq * T(kPi)) / (denD * denD);
  const T g_ndh = g_Dq * T(2) * f.n_dot_h * (A * A - T(1));
  g_A = g_A + g_Dq * pow2(f.n_dot_h) * T(2) * A;
  const T g_f0 = g_fres * (T(1) - f.one_m_vdh5);
  const T g_vdh = -g_fres * (T(1) - f.f0) * T(5) * pow4(T(1) - f.v_dot_h);
  const T ior = m[IOR];
  const T ratio = (ior - T(1)) / (ior + T(1));
  const T g_ior = g_f0 * T(2) * ratio * (T(2) / pow2(ior + T(1)));
  const T g_rough = T(2) * m[ROUGH] * g_A;
  const T g_ndv_raw = g_ndv * gate_nv + g_nv_raw;
  const T g_ndh_raw = g_ndh * adj_gate(f.nh_raw);
  const T g_vdh_raw = g_vdh * adj_gate(f.vh_raw);
  const T g_nlc_raw = g_nlc * adj_gate(f.nl_raw);
  const V3<T> g_dome_c = {g_color.x * f.dome_up, g_color.y * f.dome_up, g_color.z * f.dome_up};
  const T g_dome_up = g_color.x * cst[6] + g_color.y * cst[7] + g_color.z * cst[8];
  const T g_relu_ny = g_dome_up * cst[9];
  const T g_dome_t = g_dome_up * f.relu_ny;
  g_n_acc.y = g_n_acc.y + g_relu_ny * (f.normal.y > T(0) ? T(1) : T(0));
  const T g_ndl = g_dw * f.clear * m[DG];
  g_clear = g_clear + g_dw * f.n_dot_l * m[DG];
  const T g_dg = g_dw * f.n_dot_l * f.clear;
  const T g_nl_relu = g_ndl * (f.nl_raw > T(0) ? T(1) : T(0));
  // Constant-color lanes only: the checker is piecewise constant, and an
  // image lane's diffuse texture is the external texel's.
  const T is_const = f.is_checker || (kAtlas && f.is_image) ? T(0) : T(1);
  const T g_cov_w = g_coverage * f.alive;
  const T g_alive_in = g_coverage * f.cov_w;
  const T g_disc_w = g_cov_w * f.sig_se * f.sig_de * (T(1) - f.sig_de) * sc.sharp_e;
  T g_sol_w = g_cov_w * f.sig_de * f.sig_se * (T(1) - f.sig_se) * sc.sharp_e;

  V3<T> g_L_acc, g_V_acc, g_H_acc;
  for (int i = 0; i < 3; ++i) {
    g_L_acc[i] = f.normal[i] * (g_nlc_raw + g_nl_relu);
    g_V_acc[i] = f.normal[i] * g_ndv_raw + f.H[i] * g_vdh_raw;
    g_H_acc[i] = f.normal[i] * g_ndh_raw + f.V[i] * g_vdh_raw;
  }
  for (int i = 0; i < 3; ++i) {
    g_n_acc[i] = g_n_acc[i] + f.V[i] * g_ndv_raw + f.H[i] * g_ndh_raw + f.L[i] * (g_nlc_raw + g_nl_relu);
  }

  // --- Phase B: H = (L + V) / |L + V| ---
  const T hdot = dot3(f.H, g_H_acc);
  const T inv_hmag = T(1) / vmax(f.h_mag, T(kEpsDen));
  for (int i = 0; i < 3; ++i) {
    const T g_lv = (g_H_acc[i] - f.H[i] * hdot) * inv_hmag;
    g_L_acc[i] = g_L_acc[i] + g_lv;
    g_V_acc[i] = g_V_acc[i] + g_lv;
  }

  // --- Phase C: shadow-product adjoint, one sphere at a time ---
  V3<T> g_pn_s = {T(0), T(0), T(0)};
  shadow.visit(sc, [&](int slot, int k) {
    T sol, disc, t, b, ct;
    sphere_quad(k, sc, f.p_n, f.L, geom, sol, disc, t, b, ct);
    const T sd = sig(sc.sharp_s * disc);
    const T ss = sig(sc.sharp_s * sol);
    const T occl = sd * ss;
    const bool is_self = f.idx == k;
    const T fac = is_self ? T(1) : T(1) - occl;
    const T g_fac = g_clear * f.clear / vmax(fac, T(kEpsDen));
    const T g_occl = is_self ? T(0) : -g_fac;
    const T g_disc_j = g_occl * ss * sd * (T(1) - sd) * sc.sharp_s;
    const T g_sol_j = g_occl * sd * ss * (T(1) - ss) * sc.sharp_s;
    T g_b, g_ct;
    sol_disc_adjoint(b, ct, g_sol_j, g_disc_j, g_b, g_ct);
    for (int i = 0; i < 3; ++i) {
      const T oc = f.p_n[i] - geom[4 * k + i];
      g_pn_s[i] = g_pn_s[i] + T(2) * f.L[i] * g_b + T(2) * oc * g_ct;
      g_L_acc[i] = g_L_acc[i] + T(2) * oc * g_b;
      sink.geom(slot, k, i, T(-2) * f.L[i] * g_b - T(2) * oc * g_ct);
    }
    sink.geom(slot, k, 3, T(-2) * geom[4 * k + 3] * g_ct);
  });

  // --- Phase D: p_n, L, V unit-vector transposes ---
  V3<T> g_p;
  for (int i = 0; i < 3; ++i) {
    const T g_pn = g_o[i] + g_pn_s[i];
    g_p[i] = g_pn;
    g_n_acc[i] = g_n_acc[i] + T(kNudge) * g_pn;
  }
  const T ldot = dot3(f.L, g_L_acc);
  const T inv_lmag = T(1) / vmax(f.l_mag, T(kEpsDen));
  V3<T> g_light;
  for (int i = 0; i < 3; ++i) {
    g_light[i] = (g_L_acc[i] - f.L[i] * ldot) * inv_lmag;
    g_p[i] = g_p[i] - g_light[i];
  }
  const T vdot = dot3(f.V, g_V_acc);
  const T inv_vmag = T(1) / vmax(f.v_mag, T(kEpsDen));
  V3<T> g_cam;
  for (int i = 0; i < 3; ++i) {
    g_cam[i] = (g_V_acc[i] - f.V[i] * vdot) * inv_vmag;
    g_p[i] = g_p[i] - g_cam[i];
  }

  // --- Phase E: normal, p, winner quadratic ---
  V3<T> g_cw = {T(0), T(0), T(0)};
  T g_rw = -dot3(f.normal, g_n_acc) * f.inv_r;
  for (int i = 0; i < 3; ++i) {
    g_p[i] = g_p[i] + g_n_acc[i] * f.inv_r;
    g_cw[i] = g_cw[i] - g_n_acc[i] * f.inv_r;
  }
  V3<T> g_o_in = g_p;
  const T g_t = dot3(d, g_p);
  for (int i = 0; i < 3; ++i) g_d_acc[i] = g_d_acc[i] + g_p[i] * f.t_safe;
  g_sol_w = g_sol_w + (f.hit ? g_t : T(0));
  T g_bw, g_ctw;
  sol_disc_adjoint(f.b_w, f.ct_w, g_sol_w, g_disc_w, g_bw, g_ctw);
  const V3<T> oc_w = {o.x - m[CX], o.y - m[CY], o.z - m[CZ]};
  for (int i = 0; i < 3; ++i) {
    g_o_in[i] = g_o_in[i] + T(2) * d[i] * g_bw + T(2) * oc_w[i] * g_ctw;
    g_d_acc[i] = g_d_acc[i] + T(2) * oc_w[i] * g_bw;
    g_cw[i] = g_cw[i] - T(2) * d[i] * g_bw - T(2) * oc_w[i] * g_ctw;
  }
  g_rw = g_rw - T(2) * m[RAD] * g_ctw;

  // --- Phase F: per-lane material gradients into the winner's row ---
  const T rows[15] = {g_cw.x, g_cw.y, g_cw.z, g_rw, g_dg,
                      g_tex.x * is_const, g_tex.y * is_const, g_tex.z * is_const, g_sg, g_rough, g_ig, g_ior,
                      g_tfw, g_tft, g_tfi};
  sink.winner(sc, f.idx, rows);

  // --- Phase G: scene constants ---
  for (int i = 0; i < 3; ++i) sink.consts(sc, i, g_cam[i]);
  for (int i = 0; i < 3; ++i) sink.consts(sc, 3 + i, g_light[i]);
  for (int i = 0; i < 3; ++i) sink.consts(sc, 6 + i, g_dome_c[i]);
  sink.consts(sc, 9, g_dome_t);

  g_o = g_o_in;
  g_d = g_d_acc;
  g_thr = g_thr_in;
  g_alive = g_alive_in;
}

}  // namespace
