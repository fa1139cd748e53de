// Hard-visibility bounce kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces two TPU kernels of python_ray_tracer_tpu/ops/pallas_bounce_sub.py:
//   _trace_kernel_sub_deep (:416, launched at :569) -> trace_deep
//       the whole bounce chain in one launch; ray state stays in registers
//       and only acc leaves the kernel.
//   _bounce_kernel_sub     (:382, launched at :604) -> bounce_step
//       one bounce per launch; state goes in and out.
// Both run bounce(): the TPU kernel body _bounce_math (:179-379) with
// parts="full", no texture atlas and no stochastic xi.  The plain PyTorch
// versions sit in ops/bounce_sub.py (bounce_math).
//
// What bounds it on this card: a ray reads 24 B (origin + direction, f32)
// and writes 12 B (acc), against S * 2 * depth quadratic solves (nearest and
// shadow sweeps) plus the BRDF per bounce.  At S = 3 and depth 3 that is
// ~1-2 kFLOP per 36 B, far above the H100's ~20 FLOP/B ridge for f32
// outside the tensor cores: the kernel is compute- and latency-bound, and
// branchy.  The design follows from that and not from the TPU layout:
//   * one thread per ray over the (3, N) layout ray_directions_t gives,
//     ragged edge masked; no (8, 128) packing, no padding to 1024 rays;
//   * the geometry (S, 4), material (S, 19) and consts (1, 16) tables, at
//     most ~6 KB in f32 for S <= 64, are staged once per block in shared
//     memory, where every lane of a warp reads the same sphere row in the
//     sweeps (a broadcast);
//   * sphere and depth loops are runtime loops: the TPU's compile-size caps
//     (MAX_FUSE_DEPTH_HARD, _MAX_FUSE_SPHERE_EVALS) have no counterpart.
//
// Numerics that must hold (see ops/_build.py for the flags):
//   * build with --fmad=false and never with fast math: FMA contraction
//     destroys the Dekker twoProd / Knuth twoSum error terms of the exact
//     tier, which the r = 99999 ground sphere depends on.  The splitter is
//     4097 in every dtype, as in the TPU kernel;
//   * x**2 and x**5 are JAX integer_pow (binary exponentiation), 2.5 is pow;
//   * the checker's integer modulo floors (JAX), C++ % truncates;
//   * strict t_k < tmin (lowest index wins ties), idx = 0 on a miss, dead
//     lanes use t = 1, the hard shadow is t_self <= t_others with sentinel
//     3e38, to_camera points at the ORIGINAL camera every bounce, and the
//     mirror direction is normalised.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSpheres = 64;  // ops/bounce_sub.py MAX_SUB_SPHERES
constexpr int kMatCols = 19;     // ops/tables.py MAT_COLS
constexpr int kNConst = 16;      // ops/tables.py N_CONST
constexpr int kThreads = 128;

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

// Cheap tier (_sphere_t, :72): plain well-conditioned quadratic.
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

// Exact tier (_sphere_t_exact, :95): compensated |o - c|^2 - r^2.
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

// One hard bounce (_bounce_math, parts="full"): updates o, d, thr, alive in
// place and returns the color it adds to acc.
template <typename T>
__device__ __forceinline__ V3<T> bounce(V3<T>& o, V3<T>& d, T& thr, T& alive, const T* geom,
                                        const T* mat, const T* cst, int s_cheap, int s_total,
                                        T faraway) {
  // Nearest-hit sweep: strict <, so the lowest index wins ties.
  T tmin = faraway;
  int idx = 0;
  for (int k = 0; k < s_total; ++k) {
    const T tk = sphere_t_tiered(k, s_cheap, o, d, geom, faraway);
    if (k == 0 || tk < tmin) {
      tmin = tk;
      idx = k;
    }
  }
  const bool is_hit = tmin != faraway;
  const T hit = is_hit ? T(1) : T(0);
  if (!is_hit) idx = 0;
  const T coverage = hit * alive;
  const T t_safe = is_hit ? tmin : T(1);
  const T* m = mat + kMatCols * idx;

  const V3<T> p = {o.x + d.x * t_safe, o.y + d.y * t_safe, o.z + d.z * t_safe};
  const T inv_r = T(1) / m[RAD];
  const V3<T> normal = {(p.x - m[CX]) * inv_r, (p.y - m[CY]) * inv_r, (p.z - m[CZ]) * inv_r};
  const V3<T> to_light = normalize3(V3<T>{cst[3] - p.x, cst[4] - p.y, cst[5] - p.z});
  const V3<T> to_cam = normalize3(V3<T>{cst[0] - p.x, cst[1] - p.y, cst[2] - p.z});
  const V3<T> p_n = {p.x + normal.x * T(kNudge), p.y + normal.y * T(kNudge), p.z + normal.z * T(kNudge)};

  // Hard shadow: lit iff the own sphere is nearest along the light ray.
  T t_others = T(kShadowBig);
  T t_self = T(kShadowBig);
  for (int k = 0; k < s_total; ++k) {
    const T tk = sphere_t_tiered(k, s_cheap, p_n, to_light, geom, faraway);
    if (k == idx) {
      t_self = vmin(t_self, tk);
    } else {
      t_others = vmin(t_others, tk);
    }
  }
  const T in_light = t_self <= t_others ? T(1) : T(0);

  // Shading, ops/shading.py term for term.
  const T n_dot_l = vmax(dot3(normal, to_light), T(0));
  const int cx_i = mod2(static_cast<int>(m_trunc(p.x * T(2))));
  const int cz_i = mod2(static_cast<int>(m_trunc(p.z * T(2))));
  const T checker = cx_i == cz_i ? T(1) : T(0);
  const bool is_checker = m[KIND] == T(1);
  const V3<T> tex = {is_checker ? checker : m[DCR], is_checker ? checker : m[DCG],
                     is_checker ? checker : m[DCB]};
  const T diffuse_w = n_dot_l * in_light * m[DG];

  const T dome_up = vmax(normal.y, T(0)) * cst[9];
  const V3<T> dome = {cst[6] * dome_up, cst[7] * dome_up, cst[8] * dome_up};

  const V3<T>& L = to_light;
  const V3<T>& V = to_cam;
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

  const T view_angle = clip01(dot3(normal, to_cam));
  const T angle_factor = m_abs(view_angle - T(0.5)) * T(2);
  const T phase = angle_factor * T(kPi) * m[TFT] * T(10);
  const T ip = m_sin(phase);
  const T hue = (m[TFI] - T(1)) / T(2);
  const T irid_w = m[TFW] * m[IG];
  const V3<T> irid = {(ip * hue + (T(1) - hue) * (T(1) - ip)) * irid_w,
                      (ip * (T(1) - hue) + hue * (T(1) - ip)) * irid_w,
                      (T(0.5) + T(0.5) * ip) * irid_w};

  const T amb = T(kAmbient);
  const V3<T> color = {amb + tex.x * diffuse_w + dome.x + spec_term + irid.x,
                       amb + tex.y * diffuse_w + dome.y + spec_term + irid.y,
                       amb + tex.z * diffuse_w + dome.z + spec_term + irid.z};

  const T w = thr * coverage;
  const T refl_coeff = T(0.5) * m[SG] * in_light;
  thr = w * refl_coeff;
  alive = alive * hit;

  // Mirror continuation, normalised.
  const T ddn = T(2) * dot3(d, normal);
  d = normalize3(V3<T>{d.x - normal.x * ddn, d.y - normal.y * ddn, d.z - normal.z * ddn});
  o = p_n;
  return {color.x * w, color.y * w, color.z * w};
}

// Copy the side tables into shared memory; every thread of the block takes
// part, so this comes before any thread leaves for the ragged edge.
template <typename T>
__device__ __forceinline__ void stage_tables(T* s_geom, T* s_mat, T* s_cst, const T* geom,
                                             const T* mat, const T* cst, int s_total) {
  for (int i = threadIdx.x; i < s_total * 4; i += blockDim.x) s_geom[i] = geom[i];
  for (int i = threadIdx.x; i < s_total * kMatCols; i += blockDim.x) s_mat[i] = mat[i];
  for (int i = threadIdx.x; i < kNConst; i += blockDim.x) s_cst[i] = cst[i];
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    trace_deep(const T* __restrict__ o, const T* __restrict__ d, T* __restrict__ acc, int n,
               const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst,
               int s_cheap, int s_total, int depth, T faraway) {
  __shared__ T s_geom[kMaxSpheres * 4];
  __shared__ T s_mat[kMaxSpheres * kMatCols];
  __shared__ T s_cst[kNConst];
  stage_tables(s_geom, s_mat, s_cst, geom, mat, cst, s_total);

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long stride = n;
  V3<T> ro = {o[i], o[stride + i], o[2 * stride + i]};
  V3<T> rd = {d[i], d[stride + i], d[2 * stride + i]};
  T thr = T(1);
  T alive = T(1);
  V3<T> a = {T(0), T(0), T(0)};
  for (int dep = 0; dep < depth; ++dep) {
    const V3<T> add = bounce(ro, rd, thr, alive, s_geom, s_mat, s_cst, s_cheap, s_total, faraway);
    a = {a.x + add.x, a.y + add.y, a.z + add.z};
  }
  acc[i] = a.x;
  acc[stride + i] = a.y;
  acc[2 * stride + i] = a.z;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bounce_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                const T* __restrict__ alive, const T* __restrict__ acc, T* __restrict__ o_out,
                T* __restrict__ d_out, T* __restrict__ thr_out, T* __restrict__ alive_out,
                T* __restrict__ acc_out, int n, const T* __restrict__ geom,
                const T* __restrict__ mat, const T* __restrict__ cst, int s_cheap, int s_total,
                T faraway) {
  __shared__ T s_geom[kMaxSpheres * 4];
  __shared__ T s_mat[kMaxSpheres * kMatCols];
  __shared__ T s_cst[kNConst];
  stage_tables(s_geom, s_mat, s_cst, geom, mat, cst, s_total);

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long stride = n;
  V3<T> ro = {o[i], o[stride + i], o[2 * stride + i]};
  V3<T> rd = {d[i], d[stride + i], d[2 * stride + i]};
  T t = thr[i];
  T al = alive[i];
  const V3<T> add = bounce(ro, rd, t, al, s_geom, s_mat, s_cst, s_cheap, s_total, faraway);
  o_out[i] = ro.x;
  o_out[stride + i] = ro.y;
  o_out[2 * stride + i] = ro.z;
  d_out[i] = rd.x;
  d_out[stride + i] = rd.y;
  d_out[2 * stride + i] = rd.z;
  thr_out[i] = t;
  alive_out[i] = al;
  acc_out[i] = acc[i] + add.x;
  acc_out[stride + i] = acc[stride + i] + add.y;
  acc_out[2 * stride + i] = acc[2 * stride + i] + add.z;
}

bool bad_args(int n, int s_cheap, int s_total) {
  return n <= 0 || s_total < 1 || s_total > kMaxSpheres || s_cheap < 0 || s_cheap > s_total;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_trace_deep(const T* o, const T* d, T* acc, const T* geom, const T* mat, const T* cst,
                      int n, int s_cheap, int s_total, int depth, T faraway, void* stream) {
  if (bad_args(n, s_cheap, s_total) || depth < 1) return static_cast<int>(cudaErrorInvalidValue);
  trace_deep<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, acc, n, geom, mat, cst, s_cheap, s_total, depth, faraway);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bounce_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc,
                       T* o_out, T* d_out, T* thr_out, T* alive_out, T* acc_out, const T* geom,
                       const T* mat, const T* cst, int n, int s_cheap, int s_total, T faraway,
                       void* stream) {
  if (bad_args(n, s_cheap, s_total)) return static_cast<int>(cudaErrorInvalidValue);
  bounce_step<T><<<blocks_for(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out, n, geom, mat, cst,
      s_cheap, s_total, faraway);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_sub.py _SIGNATURES).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

int prt_trace_deep_f32(const float* o, const float* d, float* acc, const float* geom,
                       const float* mat, const float* cst, int n, int s_cheap, int s_total,
                       int depth, float faraway, void* stream) {
  return launch_trace_deep<float>(o, d, acc, geom, mat, cst, n, s_cheap, s_total, depth, faraway, stream);
}

int prt_trace_deep_f64(const double* o, const double* d, double* acc, const double* geom,
                       const double* mat, const double* cst, int n, int s_cheap, int s_total,
                       int depth, double faraway, void* stream) {
  return launch_trace_deep<double>(o, d, acc, geom, mat, cst, n, s_cheap, s_total, depth, faraway, stream);
}

int prt_bounce_step_f32(const float* o, const float* d, const float* thr, const float* alive,
                        const float* acc, float* o_out, float* d_out, float* thr_out,
                        float* alive_out, float* acc_out, const float* geom, const float* mat,
                        const float* cst, int n, int s_cheap, int s_total, float faraway,
                        void* stream) {
  return launch_bounce_step<float>(o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out,
                                   geom, mat, cst, n, s_cheap, s_total, faraway, stream);
}

int prt_bounce_step_f64(const double* o, const double* d, const double* thr, const double* alive,
                        const double* acc, double* o_out, double* d_out, double* thr_out,
                        double* alive_out, double* acc_out, const double* geom, const double* mat,
                        const double* cst, int n, int s_cheap, int s_total, double faraway,
                        void* stream) {
  return launch_bounce_step<double>(o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out,
                                    acc_out, geom, mat, cst, n, s_cheap, s_total, faraway, stream);
}

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
