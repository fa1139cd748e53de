// Device code shared by the kernel sources of this package: the ray-sphere
// quadratic in its two tiers and the reference shading, as the JAX kernels
// compute them (python_ray_tracer_tpu/ops/pallas_bounce_sub.py _roots,
// _sphere_t, _sphere_t_exact; the shading of _bounce_math and
// ops/pallas_culled.py _shade_kernel_culled, ops/shading.py term for term),
// and the staging of the geometry table in shared memory.
//
// Numerics that must hold (see ops/_build.py for the flags):
//   * build with --fmad=false and never with fast math: FMA contraction
//     destroys the Dekker twoProd / Knuth twoSum error terms of the exact
//     tier, which the r = 99999 ground sphere depends on, and the culled
//     kernels' naive root relies on sqrt of a negative giving NaN;
//   * x**2 and x**5 are JAX integer_pow (binary exponentiation), 2.5 is pow;
//   * the checker's integer modulo floors (JAX), C++ % truncates;
//   * normalisation multiplies by a guarded reciprocal, never divides.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMatCols = 19;  // ops/tables.py MAT_COLS
constexpr int kNConst = 16;   // ops/tables.py N_CONST

// Material columns in ops/tables.py order (texture id/extents unused here).
enum MatCol { CX, CY, CZ, RAD, DG, DCR, DCG, DCB, SG, ROUGH, IG, IOR, TFW, TFT, TFI, KIND };

constexpr double kPi = 3.141592653589793;
constexpr double kAmbient = 0.004;
constexpr double kEps = 1e-8;
constexpr double kNudge = 0.0001;
constexpr double kGlintExponent = 2.5;
constexpr double kShadowBig = 3.0e38;

__device__ __forceinline__ float m_sqrt(float x) { return sqrtf(x); }
__device__ __forceinline__ double m_sqrt(double x) { return sqrt(x); }
__device__ __forceinline__ float m_sin(float x) { return sinf(x); }
__device__ __forceinline__ double m_sin(double x) { return sin(x); }
__device__ __forceinline__ float m_cos(float x) { return cosf(x); }
__device__ __forceinline__ double m_cos(double x) { return cos(x); }
__device__ __forceinline__ float m_pow(float x, float y) { return powf(x, y); }
__device__ __forceinline__ double m_pow(double x, double y) { return pow(x, y); }
__device__ __forceinline__ float m_trunc(float x) { return truncf(x); }
__device__ __forceinline__ double m_trunc(double x) { return trunc(x); }
__device__ __forceinline__ float m_abs(float x) { return fabsf(x); }
__device__ __forceinline__ double m_abs(double x) { return fabs(x); }

template <typename T> __device__ __forceinline__ T vmin(T a, T b) { return b < a ? b : a; }
template <typename T> __device__ __forceinline__ T vmax(T a, T b) { return a < b ? b : a; }
template <typename T> __device__ __forceinline__ T clip01(T x) { return vmin(vmax(x, T(0)), T(1)); }

// JAX integer_pow by binary exponentiation: x**2 = x*x, x**5 = x*((x*x)*(x*x)).
template <typename T> __device__ __forceinline__ T pow2(T x) { return x * x; }
template <typename T> __device__ __forceinline__ T pow5(T x) {
  const T x2 = x * x;
  return x * (x2 * x2);
}

// Floor modulo 2 of a truncated coordinate (JAX's %, not C++'s).
__device__ __forceinline__ int mod2(int i) { return ((i % 2) + 2) % 2; }

template <typename T> struct V3 {
  T x, y, z;
};

template <typename T> __device__ __forceinline__ T dot3(const V3<T>& a, const V3<T>& b) {
  return a.x * b.x + a.y * b.y + a.z * b.z;
}

// Reference normalisation: multiply by a guarded reciprocal, never divide.
template <typename T> __device__ __forceinline__ V3<T> normalize3(const V3<T>& v) {
  const T mag = m_sqrt(dot3(v, v));
  const T inv = T(1) / (mag == T(0) ? T(1) : mag);
  return {v.x * inv, v.y * inv, v.z * inv};
}

// Strict disc > 0 & t > 0, stable q-form root pairing, faraway on a miss.
template <typename T> __device__ __forceinline__ T roots(T b, T ct, T faraway) {
  const T disc = b * b - T(4) * ct;
  const bool pos = disc > T(0);
  const T sq = pos ? m_sqrt(disc) : T(0);
  const T qroot = T(-0.5) * (b + (b < T(0) ? -sq : sq));
  const T safe_q = qroot == T(0) ? T(1) : qroot;
  const T other = qroot == T(0) ? T(0) : ct / safe_q;
  const T t0 = vmin(qroot, other);
  const T t1 = vmax(qroot, other);
  const T sol = (t0 > T(0) && t0 < t1) ? t0 : t1;
  return (pos && sol > T(0)) ? sol : faraway;
}

// Cheap tier (_sphere_t): plain well-conditioned quadratic; g = (cx, cy, cz, r).
template <typename T>
__device__ __forceinline__ T sphere_t(const V3<T>& o, const V3<T>& d, const T* g, T faraway) {
  const T ocx = o.x - g[0];
  const T ocy = o.y - g[1];
  const T ocz = o.z - g[2];
  const T r = g[3];
  const T b = T(2) * (d.x * ocx + d.y * ocy + d.z * ocz);
  const T ct = ocx * ocx + ocy * ocy + ocz * ocz - r * r;
  return roots(b, ct, faraway);
}

// Exact tier (_sphere_t_exact): compensated |o - c|^2 - r^2.  The Dekker
// splitter is 4097 in every dtype, as in the TPU kernel.
template <typename T>
__device__ __forceinline__ T sphere_t_exact(const V3<T>& o, const V3<T>& d, const T* g, T faraway) {
  const T oc[3] = {o.x, o.y, o.z};
  T h[3], lo[3], p[3], e[3];
  for (int i = 0; i < 3; ++i) {
    const T oi = oc[i];
    const T ci = g[i];
    const T s = oi - ci;
    const T bv = s - oi;
    h[i] = s;
    lo[i] = (oi - (s - bv)) + (-ci - bv);
  }
  const T b = T(2) * ((d.x * h[0] + d.y * h[1] + d.z * h[2]) + (d.x * lo[0] + d.y * lo[1] + d.z * lo[2]));
  for (int i = 0; i < 3; ++i) {  // Dekker twoProd of h[i] with itself
    const T a = h[i];
    p[i] = a * a;
    const T c = a * T(4097);
    const T hi = c - (c - a);
    const T low = a - hi;
    e[i] = ((hi * hi - p[i]) + T(2) * hi * low) + low * low;
  }
  const T r = g[3];
  const T r2 = r * r;
  const T rc = r * T(4097);
  const T rhi = rc - (rc - r);
  const T rlo = r - rhi;
  const T er = ((rhi * rhi - r2) + T(2) * rhi * rlo) + rlo * rlo;

  // Knuth twoSum chain over p0 + p1 + p2 - r^2.
  const T s1 = p[0] + p[1];
  const T bv1 = s1 - p[0];
  const T t1 = (p[0] - (s1 - bv1)) + (p[1] - bv1);
  const T s2 = s1 + p[2];
  const T bv2 = s2 - s1;
  const T t2 = (s1 - (s2 - bv2)) + (p[2] - bv2);
  const T s3 = s2 + (-r2);
  const T bv3 = s3 - s2;
  const T t3 = (s2 - (s3 - bv3)) + ((-r2) - bv3);
  const T corr = (((t1 + t2 + t3) + (e[0] + e[1] + e[2] - er))
                  + T(2) * (h[0] * lo[0] + h[1] * lo[1] + h[2] * lo[2]))
                 + (lo[0] * lo[0] + lo[1] * lo[1] + lo[2] * lo[2]);
  return roots(b, s3 + corr, faraway);
}

template <typename T>
__device__ __forceinline__ T sphere_t_tiered(int k, int s_cheap, const V3<T>& o, const V3<T>& d,
                                             const T* geom, T faraway) {
  const T* g = geom + 4 * k;
  return k < s_cheap ? sphere_t(o, d, g, faraway) : sphere_t_exact(o, d, g, faraway);
}

// The local color of one hit (ops/shading.py shade, term for term): the
// reference shader's ambient + diffuse x texture + dome + GGX specular and
// glint + thin-film iridescence.  p the hit point, normal its unit normal,
// L and V the unit directions to the light and to the ORIGINAL camera,
// m the winner's material row (kMatCols values), cst the consts row.
template <typename T>
__device__ __forceinline__ V3<T> shade_color(const V3<T>& p, const V3<T>& normal, const V3<T>& L,
                                             const V3<T>& V, T in_light, const T* m, const T* cst) {
  const T n_dot_l = vmax(dot3(normal, L), T(0));
  const int cx_i = mod2(static_cast<int>(m_trunc(p.x * T(2))));
  const int cz_i = mod2(static_cast<int>(m_trunc(p.z * T(2))));
  const T checker = cx_i == cz_i ? T(1) : T(0);
  const bool is_checker = m[KIND] == T(1);
  const V3<T> tex = {is_checker ? checker : m[DCR], is_checker ? checker : m[DCG],
                     is_checker ? checker : m[DCB]};
  const T diffuse_w = n_dot_l * in_light * m[DG];

  const T dome_up = vmax(normal.y, T(0)) * cst[9];
  const V3<T> dome = {cst[6] * dome_up, cst[7] * dome_up, cst[8] * dome_up};

  const V3<T> H = normalize3(V3<T>{L.x + V.x, L.y + V.y, L.z + V.z});
  const T n_dot_v = clip01(dot3(normal, V));
  const T n_dot_h = clip01(dot3(normal, H));
  const T v_dot_h = clip01(dot3(V, H));
  const T n_dot_l_c = clip01(dot3(normal, L));
  const T ior = m[IOR];
  const T f0 = pow2((ior - T(1)) / (ior + T(1)));
  const T fresnel = f0 + (T(1) - f0) * pow5(T(1) - v_dot_h);
  const T alpha = pow2(m[ROUGH]);
  const T alpha2 = pow2(alpha);
  const T denom = pow2(n_dot_h) * (alpha2 - T(1)) + T(1);
  const T dist = alpha2 / (T(kPi) * (pow2(denom) + T(kEps)));
  const T g_l = T(2) * n_dot_l_c / (n_dot_l_c + m_sqrt(alpha2 + (T(1) - alpha2) * pow2(n_dot_l_c)) + T(kEps));
  const T g_v = T(2) * n_dot_v / (n_dot_v + m_sqrt(alpha2 + (T(1) - alpha2) * pow2(n_dot_v)) + T(kEps));
  const T geom_term = g_l * g_v;
  const T spec_base = (fresnel * dist * geom_term) / (T(4) * n_dot_v + T(kEps));
  const T glint = m_pow(T(1) - n_dot_v, T(kGlintExponent)) * n_dot_l_c;
  const T spec = n_dot_v <= T(0) ? T(0) : spec_base + m[SG] * glint;
  const T spec_term = spec * m[SG] * in_light;

  const T view_angle = clip01(dot3(normal, V));
  const T angle_factor = m_abs(view_angle - T(0.5)) * T(2);
  const T phase = angle_factor * T(kPi) * m[TFT] * T(10);
  const T ip = m_sin(phase);
  const T hue = (m[TFI] - T(1)) / T(2);
  const T irid_w = m[TFW] * m[IG];
  const V3<T> irid = {(ip * hue + (T(1) - hue) * (T(1) - ip)) * irid_w,
                      (ip * (T(1) - hue) + hue * (T(1) - ip)) * irid_w,
                      (T(0.5) + T(0.5) * ip) * irid_w};

  const T amb = T(kAmbient);
  return {amb + tex.x * diffuse_w + dome.x + spec_term + irid.x,
          amb + tex.y * diffuse_w + dome.y + spec_term + irid.y,
          amb + tex.z * diffuse_w + dome.z + spec_term + irid.z};
}

// Stage the (S, 4) geometry table in dynamic shared memory; every thread
// of the block takes part, so this comes before any thread leaves for the
// ragged edge.
template <typename T> __device__ __forceinline__ T* stage_geom(const T* geom, int s_total) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* s_geom = reinterpret_cast<T*>(smem);
  for (int i = threadIdx.x; i < 4 * s_total; i += blockDim.x) s_geom[i] = geom[i];
  __syncthreads();
  return s_geom;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory where needed.
template <typename K> int allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes));
}

}  // namespace
