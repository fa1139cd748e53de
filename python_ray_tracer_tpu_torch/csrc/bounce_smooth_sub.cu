// Smooth-visibility bounce kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces five TPU kernels of python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:
//   _fwd_kernel_sub_deep   (:1329, launched at :1454) -> smooth_fwd_deep
//       the smooth bounce chain; writes acc and the per-depth residuals
//       (entering state, winner, hit, shadow clear) the adjoint replays.
//   _bwd_kernel_sub_deep   (:1370, launched at :1498) -> smooth_bwd_deep
//       replays each bounce from the residuals and runs the adjoint
//       (Phases A-G) in reverse depth order: ray and table gradients.
//   _train_kernel_sub_deep (:1799, launched at :1896) -> train_deep
//       forward chain, the L2 cotangent 2 (clip(acc) - tgt) clip'(acc), and
//       the reverse adjoint in one launch; the per-bounce replay state stays
//       in thread-local memory, nothing but gradients and the SSE leaves.
//   _fwd_kernel_sub        (:544, launched at :1159)  -> smooth_fwd_step
//       one bounce: the state (o, d, thr, alive, acc) in and out, plus the
//       residuals (idx, hit, clear); the depth-1 route and the scan route.
//   _bwd_kernel_sub        (:1040, launched at :1204) -> smooth_bwd_step
//       its adjoint: cotangents of all five outputs in, those of (o, d,
//       thr, alive) and the table gradients out; acc's passes through.
// All five share fwd_bounce() (the TPU kernels' _FwdSub, :227, unrolled
// mode) and adjoint_bounce() (_adjoint_bounce, :578), no atlas.  Each is
// instantiated twice: with the mirror continuation, and with the stochastic
// glossy one (kXi; :497-538 forward, :610-657 adjoint), whose uniforms xi
// come from the wrapper on the JAX package's seed schedule.  The plain
// PyTorch versions are in ops/bounce_smooth_sub.py (fwd_sub_math,
// adjoint_bounce) and evaluate the same expressions in the same order.
//
// What bounds them on this card: per ray and bounce, S winner and S shadow
// quadratics (the exact tier ~4x the plain one), three sigmoids per sphere,
// the BRDF, and in the adjoint the shadow sweep once more with its
// quadratic adjoint; against a few tens of bytes per ray (rays in, acc or
// gradients out, plus 11 residual values per bounce for the fwd/bwd pair).
// That is far above the H100's ~20 FLOP/B f32 ridge: compute- and
// latency-bound, branchy, and with ~150 live values per bounce register
// pressure is the first limit.  The one-bounce pair is the exception by
// count: it moves the whole state per launch (100-120 B per ray) for one
// bounce's work, so its least time is set by the bytes.  The design follows
// from that, not from the TPU layout:
//   * one thread per ray over the (3, N) layout, ragged edge masked; no
//     (8, 128) packing and no padding;
//   * the geometry (S, 4), material (S, 19) and consts (1, 16) tables are
//     staged per block in dynamic shared memory (23 S + 16 values), so a
//     warp's sphere reads are broadcasts;
//   * sphere and depth loops are runtime loops: no TPU compile-size caps;
//   * table gradients without float atomics: each warp sums its lanes'
//     contributions by a shuffle tree and lane 0 adds them into its own
//     column of a (values, warps) partials array; a second kernel sums the
//     columns in a fixed order.  Two launches on the same inputs give
//     bitwise-equal gradients.
//
// Numerics that must hold (see ops/_build.py for the flags):
//   * --fmad=false, never fast math: the exact tier's Dekker twoProd and
//     Knuth twoSum error terms must not be contracted into FMAs.  The split
//     factor is 4097 in f32 and 134217729 in f64, as in the smooth kernels'
//     _two_prod (not the hard kernels' 4097 everywhere);
//   * x**n for integer n is binary exponentiation (JAX integer_pow); 2.5 and
//     1.5 are pow;
//   * sigmoid is 1 / (1 + exp(-x)), torch's CUDA form, so f32 coverage
//     underflows to exactly 0 on the same lanes as the plain version;
//   * strict t < tmin for the winner (lowest index wins ties), strict
//     disc > dmax for the miss fallback (sentinel -3e38);
//   * Phase C divides by max(fac, 1e-6), as the TPU kernel does;
//   * the L2 cotangent's clip gradient splits 0.5 at exact bounds (JAX).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpheres = 256;    // ops/bounce_smooth_sub.py MAX_SMOOTH_SPHERES
constexpr int kMaxTrainDepth = 64;  // ops/bounce_smooth_sub.py MAX_TRAIN_DEPTH
constexpr int kMatCols = 19;        // ops/tables.py MAT_COLS
constexpr int kNConst = 16;         // ops/tables.py N_CONST
constexpr int kThreads = 128;
constexpr int kWarp = 32;
constexpr int kReduceThreads = 256;

enum MatCol { CX, CY, CZ, RAD, DG, DCR, DCG, DCB, SG, ROUGH, IG, IOR, TFW, TFT, TFI, KIND };

constexpr double kPi = 3.141592653589793;
constexpr double kAmbient = 0.004;
constexpr double kEps = 1e-8;         // SHADING_EPS
constexpr double kNudge = 0.0001;
constexpr double kGlint = 2.5;
constexpr double kEpsDen = 1e-6;      // _EPS_DEN
constexpr double kNegBig = -3.0e38;   // max-disc fallback sentinel

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_exp(float x) { return expf(x); }
__device__ __forceinline__ double m_exp(double x) { return exp(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_trunc(float x) { return truncf(x); }
__device__ __forceinline__ double m_trunc(double x) { return trunc(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T split_factor();
template <> __device__ __forceinline__ float split_factor<float>() { return 4097.0f; }
template <> __device__ __forceinline__ double split_factor<double>() { return 134217729.0; }

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a < b ? b : a; }
template <typename T> __device__ __forceinline__ T clip01(T x) { return vmin(vmax(x, T(0)), T(1)); }
template <typename T> __device__ __forceinline__ T sgn(T x) { return T((T(0) < x) - (x < T(0))); }
template <typename T> __device__ __forceinline__ T sig(T x) { return T(1) / (T(1) + m_exp(-x)); }

// JAX integer_pow by binary exponentiation.
template <typename T> __device__ __forceinline__ T pow2(T x) { return x * x; }
template <typename T> __device__ __forceinline__ T pow4(T x) {
  const T x2 = x * x;
  return x2 * x2;
}
template <typename T> __device__ __forceinline__ T pow3(T x) { return x * (x * x); }
template <typename T> __device__ __forceinline__ T pow5(T x) {
  const T x2 = x * x;
  return x * (x2 * x2);
}

__device__ __forceinline__ int mod2(int i) { return ((i % 2) + 2) % 2; }

template <typename T> struct V3 {
  T x, y, z;
  __device__ __forceinline__ T& operator[](int i) { return i == 0 ? x : (i == 1 ? y : z); }
  __device__ __forceinline__ T operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

template <typename T> __device__ __forceinline__ T dot3(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// (v / |v|, |v|) with the reference's guarded reciprocal.
template <typename T> __device__ __forceinline__ V3<T> norm3(const V3<T>& v, T& mag) {
  mag = m_sqrt(dot3(v, v));
  const T inv = T(1) / (mag == T(0) ? T(1) : mag);
  return {v.x * inv, v.y * inv, v.z * inv};
}

template <typename T> struct Scal {
  T faraway, sharp_e, sharp_s;
  int s_cheap, s_total;
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

// Sphere k's (sol, disc, t, b, c_term), tier by index.
template <typename T>
__device__ __forceinline__ void sphere_quad(int k, const Scal<T>& sc, const V3<T>& o, const V3<T>& d,
                                            const T* geom, T& sol, T& disc, T& t, T& b, T& ct) {
  const T* g = geom + 4 * k;
  const V3<T> c = {g[0], g[1], g[2]};
  if (k < sc.s_cheap) {
    b_cterm_plain(o, d, c, g[3], b, ct);
  } else {
    b_cterm_exact(o, d, c, g[3], b, ct);
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
  const T* m;  // winner's material row (shared memory)
  T b_w, ct_w, sol_w, disc_w, sig_de, sig_se, cov_w, coverage, t_safe, inv_r;
  V3<T> p, normal, L, V, H, p_n, tex, irid_base, color, refl;
  T l_mag, v_mag, h_mag, u_mag;
  T n_dot_l, dw, relu_ny, dome_up;
  bool is_checker, spec_gate;
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

// One smooth bounce.  saved = true replays with the given idx/hit/clear
// (no winner or shadow sweep).  kXi: the continuation is glossy, from the
// uniforms (xi1, xi2); otherwise the mirror.
template <typename T, bool kXi>
__device__ __forceinline__ void fwd_bounce(Fwd<T>& f, const V3<T>& o, const V3<T>& d, T thr, T alive,
                                           const T* geom, const T* mat, const T* cst, const Scal<T>& sc,
                                           bool saved, T xi1, T xi2) {
  f.o = o;
  f.d = d;
  f.thr = thr;
  f.alive = alive;
  if (!saved) {
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

  if (!saved) {
    T clear = T(1);
    for (int k = 0; k < sc.s_total; ++k) {
      T sol, disc, t, b, ct;
      sphere_quad(k, sc, f.p_n, f.L, geom, sol, disc, t, b, ct);
      const T occl = sig(sc.sharp_s * disc) * sig(sc.sharp_s * sol);
      clear = clear * (f.idx == k ? T(1) : T(1) - occl);
    }
    f.clear = clear;
  }

  f.n_dot_l = vmax(dot3(f.normal, f.L), T(0));
  const int cx = mod2(static_cast<int>(m_trunc(f.p.x * T(2))));
  const int cz = mod2(static_cast<int>(m_trunc(f.p.z * T(2))));
  const T checker = cx == cz ? T(1) : T(0);
  f.is_checker = m[KIND] == T(1);
  f.tex = {f.is_checker ? checker : m[DCR], f.is_checker ? checker : m[DCG], f.is_checker ? checker : m[DCB]};
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
  f.glint = m_pow(f.one_m_ndv, T(kGlint)) * f.n_dot_l_c;
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

// Warp-level partial sums of the table gradients: every lane of the warp
// calls this with the same value index (uniform control flow); lane 0 adds
// the warp's sum into its own column.  Invalid lanes contribute zero, and a
// warp wholly past the ragged edge has no column and writes nothing.
template <typename T> struct Partials {
  T* parts;  // (n_vals, n_warps)
  int n_warps, warp, lane;
  bool valid;

  __device__ __forceinline__ void add(int v, T x) const {
    T s = valid ? x : T(0);
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && warp < n_warps) parts[static_cast<long long>(v) * n_warps + warp] += s;
  }
};

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

// Value indices of the partials: geom (S, 4), then mat (S, 19), consts 16, SSE.
__device__ __forceinline__ int v_geom(int k, int c) { return 4 * k + c; }
__device__ __forceinline__ int v_mat(int s, int k, int c) { return 4 * s + kMatCols * k + c; }
__device__ __forceinline__ int v_const(int s, int c) { return (4 + kMatCols) * s + c; }
__device__ __forceinline__ int v_sse(int s) { return (4 + kMatCols) * s + kNConst; }

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
// through (acc is a pure accumulator).  Table gradients go to the partials.
template <typename T, bool kXi>
__device__ __forceinline__ void adjoint_bounce(const Fwd<T>& f, V3<T>& g_o, V3<T>& g_d, T& g_thr, T& g_alive,
                                               const V3<T>& g_acc, const T* geom, const T* cst,
                                               const Scal<T>& sc, const Partials<T>& part) {
  const T* m = f.m;
  const V3<T>& o = f.o;
  const V3<T>& d = f.d;
  const T g_thr_o = g_thr;
  const T g_alive_o = g_alive;

  // --- Phase A: top level and shading ---
  const V3<T> g_color = {g_acc.x * f.w, g_acc.y * f.w, g_acc.z * f.w};
  T g_w = g_acc.x * f.color.x + g_acc.y * f.color.y + g_acc.z * f.color.z;
  g_w = g_w + g_thr_o * f.refl_coeff;
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
  const T g_dw = g_color.x * f.tex.x + g_color.y * f.tex.y + g_color.z * f.tex.z;
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
  const T g_one_m_ndv = g_glint * T(kGlint) * m_pow(f.one_m_ndv, T(kGlint - 1.0)) * f.n_dot_l_c;
  T g_ndv = -g_one_m_ndv;
  T g_nlc = g_glint * m_pow(f.one_m_ndv, T(kGlint));
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
  const T is_const = f.is_checker ? T(0) : T(1);
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
  for (int k = 0; k < sc.s_total; ++k) {
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
    const T* g = geom + 4 * k;
    for (int i = 0; i < 3; ++i) {
      const T oc = f.p_n[i] - g[i];
      g_pn_s[i] = g_pn_s[i] + T(2) * f.L[i] * g_b + T(2) * oc * g_ct;
      g_L_acc[i] = g_L_acc[i] + T(2) * oc * g_b;
      part.add(v_geom(k, i), T(-2) * f.L[i] * g_b - T(2) * oc * g_ct);
    }
    part.add(v_geom(k, 3), T(-2) * g[3] * g_ct);
  }

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
  for (int k = 0; k < sc.s_total; ++k) {
    const bool sel = f.idx == k;
    if (!__any_sync(0xffffffffu, part.valid && sel)) continue;  // warp-uniform skip
    for (int c = 0; c < 15; ++c) part.add(v_mat(sc.s_total, k, c), sel ? rows[c] : T(0));
  }

  // --- Phase G: scene constants ---
  for (int i = 0; i < 3; ++i) part.add(v_const(sc.s_total, i), g_cam[i]);
  for (int i = 0; i < 3; ++i) part.add(v_const(sc.s_total, 3 + i), g_light[i]);
  for (int i = 0; i < 3; ++i) part.add(v_const(sc.s_total, 6 + i), g_dome_c[i]);
  part.add(v_const(sc.s_total, 9), g_dome_t);

  g_o = g_o_in;
  g_d = g_d_acc;
  g_thr = g_thr_in;
  g_alive = g_alive_in;
}

// Copy the side tables into dynamic shared memory; every thread of the
// block takes part, so this comes before any thread leaves.
template <typename T>
__device__ __forceinline__ void stage_tables(T* s_geom, T* s_mat, T* s_cst, const T* geom, const T* mat,
                                             const T* cst, int s_total) {
  for (int i = threadIdx.x; i < s_total * 4; i += blockDim.x) s_geom[i] = geom[i];
  for (int i = threadIdx.x; i < s_total * kMatCols; i += blockDim.x) s_mat[i] = mat[i];
  for (int i = threadIdx.x; i < kNConst; i += blockDim.x) s_cst[i] = cst[i];
  __syncthreads();
}

template <typename T> struct Smem {
  T *geom, *mat, *cst;
};

template <typename T> __device__ __forceinline__ Smem<T> smem_tables(int s_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  return {base, base + 4 * s_total, base + (4 + kMatCols) * s_total};
}

// Bounce dep's uniforms from a (2 * depth, N) xi stack (zero when !kXi).
template <typename T, bool kXi>
__device__ __forceinline__ void load_xi(const T* xi, int dep, long long N, long long i, T& xi1, T& xi2) {
  xi1 = kXi ? xi[2 * dep * N + i] : T(0);
  xi2 = kXi ? xi[(2 * dep + 1) * N + i] : T(0);
}

template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ acc,
                    T* __restrict__ osave, T* __restrict__ dsave, T* __restrict__ thrsave,
                    T* __restrict__ alivesave, int* __restrict__ idx_out, T* __restrict__ hit_out,
                    T* __restrict__ clear_out, int n, int depth, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long N = n;
  V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T thr = T(1), alive = T(1);
  V3<T> a = {T(0), T(0), T(0)};
  Fwd<T> f;
  for (int dep = 0; dep < depth; ++dep) {
    if (dep > 0) {
      for (int c = 0; c < 3; ++c) {
        osave[(3 * (dep - 1) + c) * N + i] = ro[c];
        dsave[(3 * (dep - 1) + c) * N + i] = rd[c];
      }
      thrsave[(dep - 1) * N + i] = thr;
      alivesave[(dep - 1) * N + i] = alive;
    }
    T xi1, xi2;
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, false, xi1, xi2);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + f.color[c] * f.w;
    idx_out[dep * N + i] = f.idx;
    hit_out[dep * N + i] = f.hit ? T(1) : T(0);
    clear_out[dep * N + i] = f.clear;
    ro = f.p_n;
    rd = f.dout;
    thr = f.thr_out;
    alive = f.coverage;
  }
  for (int c = 0; c < 3; ++c) acc[c * N + i] = a[c];
}

template <typename T> __device__ __forceinline__ Partials<T> make_partials(T* parts, long long i, int n) {
  Partials<T> p;
  p.parts = parts;
  p.n_warps = (n + kWarp - 1) / kWarp;
  p.warp = static_cast<int>(i / kWarp);
  p.lane = threadIdx.x % kWarp;
  p.valid = i < n;
  return p;
}

// Reverse adjoint chain from the residuals.  Lanes past the ragged edge
// stay (on a copy of the last ray, contributing zero) so every warp
// reduction has all 32 lanes.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ osave,
                    const T* __restrict__ dsave, const T* __restrict__ thrsave,
                    const T* __restrict__ alivesave, const int* __restrict__ idx_in,
                    const T* __restrict__ hit_in, const T* __restrict__ clear_in, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    const T* __restrict__ g_acc_in,
                    T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n, int depth,
                    Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
  const V3<T> g_acc = {g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]};
  V3<T> g_o = {T(0), T(0), T(0)}, g_d = {T(0), T(0), T(0)};
  T g_thr = T(0), g_alive = T(0);
  Fwd<T> f;
  for (int dep = depth - 1; dep >= 0; --dep) {
    V3<T> ro, rd;
    T thr, alive;
    if (dep == 0) {
      ro = {o[i], o[N + i], o[2 * N + i]};
      rd = {d[i], d[N + i], d[2 * N + i]};
      thr = T(1);
      alive = T(1);
    } else {
      for (int c = 0; c < 3; ++c) {
        ro[c] = osave[(3 * (dep - 1) + c) * N + i];
        rd[c] = dsave[(3 * (dep - 1) + c) * N + i];
      }
      thr = thrsave[(dep - 1) * N + i];
      alive = alivesave[(dep - 1) * N + i];
    }
    f.idx = idx_in[dep * N + i];
    f.hit = hit_in[dep * N + i] != T(0);
    f.clear = clear_in[dep * N + i];
    T xi1, xi2;
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, true, xi1, xi2);
    adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, part);
  }
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
  }
}

// Replay state of one bounce, kept in thread-local memory by train_deep.
template <typename T> struct Replay {
  V3<T> o, d;
  T thr, alive, clear;
  int idx;
  bool hit;
};

template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    train_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ tgt,
               const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst,
               const T* __restrict__ xi, T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n, int depth,
               Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
  Replay<T> saved[kMaxTrainDepth];
  V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T thr = T(1), alive = T(1);
  V3<T> a = {T(0), T(0), T(0)};
  Fwd<T> f;
  for (int dep = 0; dep < depth; ++dep) {
    T xi1, xi2;
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, false, xi1, xi2);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + f.color[c] * f.w;
    saved[dep] = {ro, rd, thr, alive, f.clear, f.idx, f.hit};
    ro = f.p_n;
    rd = f.dout;
    thr = f.thr_out;
    alive = f.coverage;
  }

  // In-kernel L2 cotangent: sse = sum (clip(acc) - tgt)^2; the 1/(3N) of
  // the mean and the loss's upstream cotangent are applied by the caller.
  T sse = T(0);
  V3<T> g_acc;
  for (int c = 0; c < 3; ++c) {
    const T e = clip01(a[c]) - tgt[c * N + i];
    sse = sse + e * e;
    const T g_lo = T(0.5) * ((a[c] >= T(0) ? T(1) : T(0)) + (a[c] > T(0) ? T(1) : T(0)));
    const T y = vmax(a[c], T(0));
    const T g_hi = T(0.5) * ((y <= T(1) ? T(1) : T(0)) + (y < T(1) ? T(1) : T(0)));
    g_acc[c] = T(2) * e * (g_lo * g_hi);
  }
  part.add(v_sse(sc.s_total), sse);

  V3<T> g_o = {T(0), T(0), T(0)}, g_d = {T(0), T(0), T(0)};
  T g_thr = T(0), g_alive = T(0);
  for (int dep = depth - 1; dep >= 0; --dep) {
    const Replay<T>& r = saved[dep];
    f.idx = r.idx;
    f.hit = r.hit;
    f.clear = r.clear;
    T xi1, xi2;  // read again: the replay keeps no xi
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi>(f, r.o, r.d, r.thr, r.alive, s.geom, s.mat, s.cst, sc, true, xi1, xi2);
    adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, part);
  }
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
  }
}

// One smooth bounce per launch (_fwd_kernel_sub): the state (o, d, thr,
// alive, acc) in, the next state and the bounce's residuals (idx, hit,
// clear) out.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const T* __restrict__ acc, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ o_out, T* __restrict__ d_out, T* __restrict__ thr_out,
                    T* __restrict__ alive_out, T* __restrict__ acc_out, int* __restrict__ idx_out,
                    T* __restrict__ hit_out, T* __restrict__ clear_out, int n, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  fwd_bounce<T, kXi>(f, ro, rd, thr[i], alive[i], s.geom, s.mat, s.cst, sc, false, xi1, xi2);
  for (int c = 0; c < 3; ++c) {
    acc_out[c * N + i] = acc[c * N + i] + f.color[c] * f.w;
    o_out[c * N + i] = f.p_n[c];
    d_out[c * N + i] = f.dout[c];
  }
  thr_out[i] = f.thr_out;
  alive_out[i] = f.coverage;
  idx_out[i] = f.idx;
  hit_out[i] = f.hit ? T(1) : T(0);
  clear_out[i] = f.clear;
}

// Its adjoint (_bwd_kernel_sub): replays the bounce from its inputs and
// residuals, takes the cotangents of all five outputs and writes those of
// (o, d, thr, alive); acc's passes through and is the caller's.  Lanes past
// the ragged edge stay (on a copy of the last ray, contributing zero) so
// every warp reduction has all 32 lanes.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const int* __restrict__ idx, const T* __restrict__ hit,
                    const T* __restrict__ clear, const T* __restrict__ geom, const T* __restrict__ mat,
                    const T* __restrict__ cst, const T* __restrict__ xi, const T* __restrict__ g_o_in,
                    const T* __restrict__ g_d_in, const T* __restrict__ g_thr_in,
                    const T* __restrict__ g_alive_in, const T* __restrict__ g_acc_in, T* __restrict__ g_o_out,
                    T* __restrict__ g_d_out, T* __restrict__ g_thr_out, T* __restrict__ g_alive_out,
                    T* __restrict__ parts, int n, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  f.idx = idx[i];
  f.hit = hit[i] != T(0);
  f.clear = clear[i];
  fwd_bounce<T, kXi>(f, ro, rd, thr[i], alive[i], s.geom, s.mat, s.cst, sc, true, xi1, xi2);
  V3<T> g_o = {g_o_in[i], g_o_in[N + i], g_o_in[2 * N + i]};
  V3<T> g_d = {g_d_in[i], g_d_in[N + i], g_d_in[2 * N + i]};
  T g_thr = g_thr_in[i], g_alive = g_alive_in[i];
  const V3<T> g_acc = {g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]};
  adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, part);
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
    g_thr_out[i] = g_thr;
    g_alive_out[i] = g_alive;
  }
}

// Second pass: each block sums one value's column of warp partials, in a
// fixed order (strided per thread, then a shared-memory tree).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const T* __restrict__ parts, T* __restrict__ out, int n_warps) {
  __shared__ T s[kReduceThreads];
  const T* row = parts + static_cast<long long>(blockIdx.x) * n_warps;
  T acc = T(0);
  for (int w = threadIdx.x; w < n_warps; w += kReduceThreads) acc += row[w];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

bool bad_args(int n, int s_cheap, int s_total, int depth) {
  return n <= 0 || s_total < 1 || s_total > kMaxSpheres || s_cheap < 0 || s_cheap > s_total || depth < 1;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T> size_t smem_bytes(int s_total) {
  return sizeof(T) * static_cast<size_t>((4 + kMatCols) * s_total + kNConst);
}

int n_vals(int s_total) { return (4 + kMatCols) * s_total + kNConst + 1; }

template <typename T>
int launch_reduce(const T* parts, T* flat, int n, int s_total, cudaStream_t stream) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  reduce_partials<T><<<n_vals(s_total), kReduceThreads, 0, stream>>>(parts, flat, (n + kWarp - 1) / kWarp);
  return static_cast<int>(cudaGetLastError());
}

// Each launcher takes xi as a pointer that may be null: null launches the
// deterministic instantiation of the kernel, non-null the glossy one.
#define PRT_DISPATCH_XI(KERNEL, T, GRID, SMEM, STREAM, ...)                    \
  do {                                                                        \
    if (xi) {                                                                 \
      KERNEL<T, true><<<GRID, kThreads, SMEM, STREAM>>>(__VA_ARGS__);         \
    } else {                                                                  \
      KERNEL<T, false><<<GRID, kThreads, SMEM, STREAM>>>(__VA_ARGS__);        \
    }                                                                         \
  } while (0)

template <typename T>
int launch_fwd(const T* o, const T* d, const T* geom, const T* mat, const T* cst, const T* xi, T* acc, T* osave,
               T* dsave, T* thrsave, T* alivesave, int* idx, T* hit, T* clear, int n, int s_cheap, int s_total,
               int depth, T faraway, T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  PRT_DISPATCH_XI(smooth_fwd_deep, T, blocks_for(n), smem_bytes<T>(s_total), static_cast<cudaStream_t>(stream),
                  o, d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear, n, depth, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave, const T* alivesave,
               const int* idx, const T* hit, const T* clear, const T* geom, const T* mat, const T* cst, const T* xi,
               const T* g_acc, T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, int depth,
               T faraway, T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(smooth_bwd_deep, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, osave, dsave, thrsave,
                  alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc, g_o, g_d, parts, n, depth, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

template <typename T>
int launch_train(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, const T* xi,
                 T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, int depth, T faraway,
                 T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth) || depth > kMaxTrainDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(train_deep, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, tgt, geom, mat, cst, xi, g_o,
                  g_d, parts, n, depth, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

template <typename T>
int launch_fwd_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* geom,
                    const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out,
                    T* acc_out, int* idx, T* hit, T* clear, int n, int s_cheap, int s_total, T faraway, T sharp_e,
                    T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  PRT_DISPATCH_XI(smooth_fwd_step, T, blocks_for(n), smem_bytes<T>(s_total), static_cast<cudaStream_t>(stream),
                  o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out, acc_out, idx, hit,
                  clear, n, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_step(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit,
                    const T* clear, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
                    const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, T* g_o_out, T* g_d_out,
                    T* g_thr_out, T* g_alive_out, T* parts, T* flat, int n, int s_cheap, int s_total, T faraway,
                    T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(smooth_bwd_step, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, thr, alive, idx, hit,
                  clear, geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_o_out, g_d_out, g_thr_out,
                  g_alive_out, parts, n, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

#undef PRT_DISPATCH_XI

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_smooth_sub.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

#define PRT_SMOOTH_ENTRIES(T, SUFFIX)                                                                          \
  int prt_smooth_fwd_deep_##SUFFIX(const T* o, const T* d, const T* geom, const T* mat, const T* cst,           \
                                   const T* xi, T* acc, T* osave, T* dsave, T* thrsave, T* alivesave, int* idx, \
                                   T* hit, T* clear, int n, int s_cheap, int s_total, int depth, T faraway,     \
                                   T sharp_e, T sharp_s, void* stream) {                                       \
    return launch_fwd<T>(o, d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear, n, \
                         s_cheap, s_total, depth, faraway, sharp_e, sharp_s, stream);                          \
  }                                                                                                            \
  int prt_smooth_bwd_deep_##SUFFIX(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave,   \
                                   const T* alivesave, const int* idx, const T* hit, const T* clear,           \
                                   const T* geom, const T* mat, const T* cst, const T* xi, const T* g_acc,     \
                                   T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total,         \
                                   int depth, T faraway, T sharp_e, T sharp_s, void* stream) {                 \
    return launch_bwd<T>(o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc,  \
                         g_o, g_d, parts, flat, n, s_cheap, s_total, depth, faraway, sharp_e, sharp_s, stream);\
  }                                                                                                            \
  int prt_train_deep_##SUFFIX(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, \
                              const T* xi, T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, \
                              int depth, T faraway, T sharp_e, T sharp_s, void* stream) {                      \
    return launch_train<T>(o, d, tgt, geom, mat, cst, xi, g_o, g_d, parts, flat, n, s_cheap, s_total, depth,  \
                           faraway, sharp_e, sharp_s, stream);                                                 \
  }                                                                                                            \
  int prt_smooth_fwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc,         \
                                   const T* geom, const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, \
                                   T* thr_out, T* alive_out, T* acc_out, int* idx, T* hit, T* clear, int n,    \
                                   int s_cheap, int s_total, T faraway, T sharp_e, T sharp_s, void* stream) {  \
    return launch_fwd_step<T>(o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,    \
                              acc_out, idx, hit, clear, n, s_cheap, s_total, faraway, sharp_e, sharp_s,        \
                              stream);                                                                         \
  }                                                                                                            \
  int prt_smooth_bwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* idx,       \
                                   const T* hit, const T* clear, const T* geom, const T* mat, const T* cst,    \
                                   const T* xi, const T* g_o, const T* g_d, const T* g_thr,                    \
                                   const T* g_alive, const T* g_acc, T* g_o_out, T* g_d_out, T* g_thr_out,     \
                                   T* g_alive_out, T* parts, T* flat, int n, int s_cheap, int s_total,         \
                                   T faraway, T sharp_e, T sharp_s, void* stream) {                            \
    return launch_bwd_step<T>(o, d, thr, alive, idx, hit, clear, geom, mat, cst, xi, g_o, g_d, g_thr,         \
                              g_alive, g_acc, g_o_out, g_d_out, g_thr_out, g_alive_out, parts, flat, n,        \
                              s_cheap, s_total, faraway, sharp_e, sharp_s, stream);                            \
  }

PRT_SMOOTH_ENTRIES(float, f32)
PRT_SMOOTH_ENTRIES(double, f64)

#undef PRT_SMOOTH_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
