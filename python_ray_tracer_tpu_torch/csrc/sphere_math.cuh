// Device code shared by the kernel sources of this package: the ray-sphere
// quadratic in its two tiers and the reference shading, as the JAX kernels
// compute them (python_ray_tracer_tpu/ops/pallas_bounce_sub.py _roots,
// _sphere_t, _sphere_t_exact; the shading of _bounce_math and
// ops/pallas_culled.py _shade_kernel_culled, ops/shading.py term for term),
// the polynomial equirectangular UV of image textures (ops/pallas_bounce.py
// _atan2_poly, _asin_poly; the flat texel id of pallas_bounce_sub.py:277-302)
// and the staging of the geometry table in shared memory.
//
// Numerics that must hold (see ops/_build.py for the flags):
//   * build with --fmad=false and never with fast math: FMA contraction
//     destroys the Dekker twoProd / Knuth twoSum error terms of the exact
//     tier, which the r = 99999 ground sphere depends on, and the culled
//     kernels' naive root relies on sqrt of a negative giving NaN;
//   * x**2 and x**5 are JAX integer_pow (binary exponentiation), 2.5 is pow;
//   * the checker's integer modulo floors (JAX), C++ % truncates;
//   * normalisation multiplies by a guarded reciprocal, never divides;
//   * the UV polynomial's coefficients round from double to the dtype, as
//     JAX's Python constants do, and the UV divides by 2 pi and pi.

#pragma once

#include <cuda_runtime.h>

// PRT_ATAN_C: generated by ops/_build.py from ops/texture.py ATAN_C.
#include "texture_coeffs.cuh"

namespace {

constexpr int kMatCols = 19;  // ops/tables.py MAT_COLS
constexpr int kNConst = 16;   // ops/tables.py N_CONST

// Material columns in ops/tables.py order; TID, TEXH, TEXW: the texture id
// and the texture's native extents (image lanes of an atlas scene).
enum MatCol { CX, CY, CZ, RAD, DG, DCR, DCG, DCB, SG, ROUGH, IG, IOR, TFW, TFT, TFI, KIND, TID, TEXH, TEXW };

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
__device__ __forceinline__ float m_floor(float x) { return floorf(x); }
__device__ __forceinline__ double m_floor(double x) { return floor(x); }

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
  __device__ __forceinline__ T& operator[](int i) { return i == 0 ? x : (i == 1 ? y : z); }
  __device__ __forceinline__ T operator[](int i) const { return i == 0 ? x : (i == 1 ? y : z); }
};

// Ray i of a (3, n) array: its three rows are n apart.
template <typename T> __device__ __forceinline__ V3<T> load3(const T* a, long long n, long long i) {
  return {a[i], a[n + i], a[2 * n + i]};
}

template <typename T> __device__ __forceinline__ void store3(T* a, long long n, long long i, const V3<T>& v) {
  a[i] = v.x;
  a[n + i] = v.y;
  a[2 * n + i] = v.z;
}

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

// Horner's rule over the coefficients, lowest order first, each rounded to T:
// ((c10 x2 + c9) x2 + ...) x2 + c0.
template <typename T> __device__ __forceinline__ T horner(T, double c) { return T(c); }
template <typename T, typename... R> __device__ __forceinline__ T horner(T x2, double c, R... rest) {
  return horner<T>(x2, rest...) * x2 + T(c);
}

// atan(x) for x in [0, 1] via the polynomial (_atan_unit).
template <typename T> __device__ __forceinline__ T atan_unit(T x) { return x * horner<T>(x * x, PRT_ATAN_C); }

// Full-quadrant atan2 from the [0, 1] polynomial, octant reduction (_atan2_poly).
template <typename T> __device__ __forceinline__ T atan2_poly(T y, T x) {
  const T ax = m_abs(x);
  const T ay = m_abs(y);
  const bool swap = ay > ax;
  const T num = swap ? ax : ay;
  const T den = vmax(swap ? ay : ax, T(1e-30));
  T a = atan_unit(num / den);
  a = swap ? T(kPi / 2) - a : a;
  a = x < T(0) ? T(kPi) - a : a;
  return y < T(0) ? -a : a;
}

// asin(y) = atan2(y, sqrt(1 - y^2)), y clipped to [-1, 1] (_asin_poly).
template <typename T> __device__ __forceinline__ T asin_poly(T y) {
  y = vmin(vmax(y, T(-1)), T(1));
  return atan2_poly(y, m_sqrt(vmax(T(1) - y * y, T(0))));
}

// Flat id of the nearest texel of an image lane: equirectangular UV of the
// unit normal over the texture's native extents (m[TEXH], m[TEXW]), in an
// atlas of tex_h x tex_w slots: tid * (tex_h * tex_w) + tj * tex_w + ti.
template <typename T>
__device__ __forceinline__ int flat_texel(const V3<T>& normal, const T* m, int tex_h, int tex_w) {
  T u = T(0.5) + atan2_poly(normal.z, normal.x) / T(2.0 * kPi);
  T v = T(0.5) - asin_poly(normal.y) / T(kPi);
  u = u - m_floor(u);
  v = v - m_floor(v);
  const T th = m[TEXH];
  const T tw = m[TEXW];
  const int ti = min(max(static_cast<int>(u * (tw - T(1))), 0), static_cast<int>(tw - T(1)));
  const int tj = min(max(static_cast<int>(v * (th - T(1))), 0), static_cast<int>(th - T(1)));
  return static_cast<int>(m[TID]) * (tex_h * tex_w) + tj * tex_w + ti;
}

// What the atlas mode of a hard kernel exports besides the color: the flat
// texel id (0 off image lanes), whether the lane is an image lane, and the
// diffuse weight n.l * in_light * diffuse_gain.
template <typename T> struct TexHit {
  int flat;
  bool is_image;
  T diffuse_w;
};

// The local color of one hit (ops/shading.py shade, term for term): the
// reference shader's ambient + diffuse x texture + dome + GGX specular and
// glint + thin-film iridescence.  p the hit point, normal its unit normal,
// L and V the unit directions to the light and to the ORIGINAL camera,
// m the winner's material row (kMatCols values), cst the consts row.
// kAtlas: image lanes get their texel id in th (atlas slots tex_h x tex_w)
// and a zero diffuse texture here, the caller composing the texel outside.
// kTexelsInside (with kAtlas): their diffuse texture is instead the texel
// itself, read from the (T * tex_h * tex_w, 3) table texels, inside the sum
// (the lane-layout bounce, bounce_lane.cu); texels is unread otherwise.
template <typename T, bool kAtlas, bool kTexelsInside>
__device__ __forceinline__ V3<T> shade_color_tex(const V3<T>& p, const V3<T>& normal, const V3<T>& L,
                                                 const V3<T>& V, T in_light, const T* m, const T* cst, int tex_h,
                                                 int tex_w, TexHit<T>& th, const T* texels) {
  static_assert(kAtlas || !kTexelsInside, "the in-kernel texel read is a mode of the atlas");
  const T n_dot_l = vmax(dot3(normal, L), T(0));
  const int cx_i = mod2(static_cast<int>(m_trunc(p.x * T(2))));
  const int cz_i = mod2(static_cast<int>(m_trunc(p.z * T(2))));
  const T checker = cx_i == cz_i ? T(1) : T(0);
  const bool is_checker = m[KIND] == T(1);
  V3<T> tex = {is_checker ? checker : m[DCR], is_checker ? checker : m[DCG], is_checker ? checker : m[DCB]};
  if constexpr (kAtlas) {
    th.is_image = m[KIND] == T(2);
    th.flat = th.is_image ? flat_texel(normal, m, tex_h, tex_w) : 0;
    if (th.is_image) {
      if constexpr (kTexelsInside) {
        const T* tx = texels + 3 * static_cast<long long>(th.flat);
        tex = {tx[0], tx[1], tx[2]};
      } else {
        tex = {T(0), T(0), T(0)};
      }
    }
  }
  const T diffuse_w = n_dot_l * in_light * m[DG];
  th.diffuse_w = diffuse_w;

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

template <typename T>
__device__ __forceinline__ V3<T> shade_color(const V3<T>& p, const V3<T>& normal, const V3<T>& L,
                                             const V3<T>& V, T in_light, const T* m, const T* cst) {
  TexHit<T> unused;
  return shade_color_tex<T, false, false>(p, normal, L, V, in_light, m, cst, 0, 0, unused, nullptr);
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
