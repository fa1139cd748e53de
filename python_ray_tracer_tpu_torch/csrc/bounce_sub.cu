// Hard-visibility bounce kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces two TPU kernels of python_ray_tracer_tpu/ops/pallas_bounce_sub.py:
//   _trace_kernel_sub_deep (:416, launched at :569) -> trace_deep
//       the whole bounce chain in one launch; ray state stays in registers
//       and only acc leaves the kernel.
//   _bounce_kernel_sub     (:382, launched at :604) -> bounce_step
//       one bounce per launch; state goes in and out.
// Both run bounce(): the TPU kernel body _bounce_math (:179-379) with
// parts="full", deterministic or with the stochastic glossy continuation
// (:353-376): given xi, the kernel reflects about a GGX-sampled microfacet
// instead of the normal.  xi comes from the wrapper (ops/rng.py, the JAX
// package's seed schedule), (2 * depth, N) for trace_deep and (2, N) for
// bounce_step.  The atlas mode (kAtlas, :277-302) writes each bounce's flat
// texel id and dww = diffuse weight x path weight of its image lanes,
// (depth, N) for trace_deep and (N,) for bounce_step, and zeroes their
// in-kernel diffuse texture; the wrapper composes the texels after the
// launch (ops/texture.py compose_texels).  Each kernel is instantiated for
// every (kXi, kAtlas), so the deterministic no-atlas build is unchanged.
// The plain PyTorch versions sit in ops/bounce_sub.py (bounce_math).
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
// Numerics (the tiers, integer_pow, floor modulo, no FMA) are those of
// sphere_math.cuh; besides, strict t_k < tmin (lowest index wins ties),
// idx = 0 on a miss, dead lanes use t = 1, the hard shadow is t_self <=
// t_others with sentinel 3e38, to_camera points at the ORIGINAL camera
// every bounce, and the mirror direction is normalised.

#include "sphere_math.cuh"

namespace {

constexpr int kMaxSpheres = 64;  // ops/bounce_sub.py MAX_SUB_SPHERES
constexpr int kThreads = 128;

// Glossy continuation (:353-376, ops/vecmath.ggx_perturb_reflect term for
// term): reflect d about a GGX-sampled half-vector around the unit normal n;
// a sample that leaves below the surface keeps the mirror direction refl.
template <typename T>
__device__ __forceinline__ V3<T> ggx_continuation(const V3<T>& d, const V3<T>& n, const V3<T>& refl, T rough,
                                                  T xi1, T xi2) {
  const T alpha_s = pow2(rough);
  const T tan2 = pow2(alpha_s) * xi1 / vmax(T(1) - xi1, T(1e-8));
  const T cos_t = T(1) / m_sqrt(T(1) + tan2);  // a division, never rsqrt
  const T sin_t = m_sqrt(vmax(T(1) - pow2(cos_t), T(0)));
  const T phi = T(2.0 * kPi) * xi2;
  const T s_sign = n.z >= T(0) ? T(1) : T(-1);
  const T a_b = T(-1) / (s_sign + n.z);
  const T b_b = n.x * n.y * a_b;
  const V3<T> t1 = {T(1) + s_sign * n.x * n.x * a_b, s_sign * b_b, -s_sign * n.x};
  const V3<T> t2 = {b_b, s_sign + n.y * n.y * a_b, -n.y};
  const T sc = sin_t * m_cos(phi);
  const T ss = sin_t * m_sin(phi);
  const V3<T> h = normalize3(V3<T>{t1.x * sc + t2.x * ss + n.x * cos_t, t1.y * sc + t2.y * ss + n.y * cos_t,
                                   t1.z * sc + t2.z * ss + n.z * cos_t});
  const T dhn = T(2) * dot3(d, h);
  const V3<T> r = normalize3(V3<T>{d.x - h.x * dhn, d.y - h.y * dhn, d.z - h.z * dhn});
  return dot3(r, n) > T(0) ? r : refl;
}

// One hard bounce (_bounce_math, parts="full"): updates o, d, thr, alive in
// place and returns the color it adds to acc.  kXi: glossy continuation
// from (xi1, xi2).  kAtlas: flat and dww get the lane's texel id and weight
// (atlas slots tex_h x tex_w).
template <typename T, bool kXi, bool kAtlas>
__device__ __forceinline__ V3<T> bounce(V3<T>& o, V3<T>& d, T& thr, T& alive, const T* geom,
                                        const T* mat, const T* cst, int s_cheap, int s_total,
                                        T faraway, T xi1, T xi2, int tex_h, int tex_w, int& flat, T& dww) {
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

  TexHit<T> th;
  const V3<T> color =
      shade_color_tex<T, kAtlas, false>(p, normal, to_light, to_cam, in_light, m, cst, tex_h, tex_w, th, nullptr);
  if constexpr (kAtlas) {
    flat = th.flat;
    dww = th.is_image ? th.diffuse_w * thr * coverage : T(0);
  }

  const T w = thr * coverage;
  const T refl_coeff = T(0.5) * m[SG] * in_light;
  thr = w * refl_coeff;
  alive = alive * hit;

  // Mirror continuation, normalised; glossy with xi.
  const T ddn = T(2) * dot3(d, normal);
  const V3<T> refl = normalize3(V3<T>{d.x - normal.x * ddn, d.y - normal.y * ddn, d.z - normal.z * ddn});
  d = kXi ? ggx_continuation(d, normal, refl, m[ROUGH], xi1, xi2) : refl;
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

template <typename T, bool kXi, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    trace_deep(const T* __restrict__ o, const T* __restrict__ d, T* __restrict__ acc, int n,
               const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst,
               const T* __restrict__ xi, int* __restrict__ flat_out, T* __restrict__ dww_out, int s_cheap,
               int s_total, int depth, T faraway, int tex_h, int tex_w) {
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
    const T xi1 = kXi ? xi[2 * dep * stride + i] : T(0);
    const T xi2 = kXi ? xi[(2 * dep + 1) * stride + i] : T(0);
    int flat;
    T dww;
    const V3<T> add = bounce<T, kXi, kAtlas>(ro, rd, thr, alive, s_geom, s_mat, s_cst, s_cheap, s_total, faraway,
                                             xi1, xi2, tex_h, tex_w, flat, dww);
    a = {a.x + add.x, a.y + add.y, a.z + add.z};
    if constexpr (kAtlas) {
      flat_out[dep * stride + i] = flat;
      dww_out[dep * stride + i] = dww;
    }
  }
  acc[i] = a.x;
  acc[stride + i] = a.y;
  acc[2 * stride + i] = a.z;
}

template <typename T, bool kXi, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    bounce_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                const T* __restrict__ alive, const T* __restrict__ acc, T* __restrict__ o_out,
                T* __restrict__ d_out, T* __restrict__ thr_out, T* __restrict__ alive_out,
                T* __restrict__ acc_out, int n, const T* __restrict__ geom,
                const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                int* __restrict__ flat_out, T* __restrict__ dww_out, int s_cheap, int s_total, T faraway,
                int tex_h, int tex_w) {
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
  const T xi1 = kXi ? xi[i] : T(0);
  const T xi2 = kXi ? xi[stride + i] : T(0);
  int flat;
  T dww;
  const V3<T> add = bounce<T, kXi, kAtlas>(ro, rd, t, al, s_geom, s_mat, s_cst, s_cheap, s_total, faraway, xi1, xi2,
                                           tex_h, tex_w, flat, dww);
  if constexpr (kAtlas) {
    flat_out[i] = flat;
    dww_out[i] = dww;
  }
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

// xi == nullptr launches the deterministic instantiation, flat_out ==
// nullptr the one without an atlas.
#define PRT_DISPATCH(KERNEL, T, ...)                                                  \
  if (xi && flat_out) {                                                               \
    KERNEL<T, true, true><<<blocks_for(n), kThreads, 0, st>>>(__VA_ARGS__);           \
  } else if (xi) {                                                                    \
    KERNEL<T, true, false><<<blocks_for(n), kThreads, 0, st>>>(__VA_ARGS__);          \
  } else if (flat_out) {                                                              \
    KERNEL<T, false, true><<<blocks_for(n), kThreads, 0, st>>>(__VA_ARGS__);          \
  } else {                                                                            \
    KERNEL<T, false, false><<<blocks_for(n), kThreads, 0, st>>>(__VA_ARGS__);         \
  }

template <typename T>
int launch_trace_deep(const T* o, const T* d, T* acc, const T* geom, const T* mat, const T* cst,
                      const T* xi, int* flat_out, T* dww_out, int n, int s_cheap, int s_total, int depth,
                      T faraway, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total) || depth < 1 || (flat_out && (!dww_out || tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH(trace_deep, T, o, d, acc, n, geom, mat, cst, xi, flat_out, dww_out, s_cheap, s_total, depth, faraway,
               tex_h, tex_w);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bounce_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc,
                       T* o_out, T* d_out, T* thr_out, T* alive_out, T* acc_out, const T* geom,
                       const T* mat, const T* cst, const T* xi, int* flat_out, T* dww_out, int n, int s_cheap,
                       int s_total, T faraway, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total) || (flat_out && (!dww_out || tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH(bounce_step, T, o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out, n, geom, mat, cst,
               xi, flat_out, dww_out, s_cheap, s_total, faraway, tex_h, tex_w);
  return static_cast<int>(cudaGetLastError());
}

#undef PRT_DISPATCH

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_sub.py _SIGNATURES).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

#define PRT_HARD_ENTRIES(T, SUFFIX)                                                                            \
  int prt_trace_deep_##SUFFIX(const T* o, const T* d, T* acc, const T* geom, const T* mat, const T* cst,         \
                              const T* xi, int* flat, T* dww, int n, int s_cheap, int s_total, int depth,       \
                              T faraway, int tex_h, int tex_w, void* stream) {                                  \
    return launch_trace_deep<T>(o, d, acc, geom, mat, cst, xi, flat, dww, n, s_cheap, s_total, depth, faraway,  \
                                tex_h, tex_w, stream);                                                          \
  }                                                                                                            \
  int prt_bounce_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc, T* o_out,    \
                               T* d_out, T* thr_out, T* alive_out, T* acc_out, const T* geom, const T* mat,     \
                               const T* cst, const T* xi, int* flat, T* dww, int n, int s_cheap, int s_total,  \
                               T faraway, int tex_h, int tex_w, void* stream) {                                \
    return launch_bounce_step<T>(o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out, geom, mat,  \
                                 cst, xi, flat, dww, n, s_cheap, s_total, faraway, tex_h, tex_w, stream);      \
  }

PRT_HARD_ENTRIES(float, f32)
PRT_HARD_ENTRIES(double, f64)

#undef PRT_HARD_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
