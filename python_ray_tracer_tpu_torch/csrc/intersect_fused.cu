// Standalone sweep kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces the two TPU kernels of python_ray_tracer_tpu/ops/pallas_intersect.py
// that render.trace calls once each per bounce where a bounce cannot fuse
// (on the single-shard hard path: a stochastic glossy scene above 64
// spheres), with the shading in between done by plain PyTorch:
//   _nearest_kernel (:181, launched at :266) -> nearest_sweep
//       nearest hit (t, idx) over every sphere: the cheap tier with
//       _block_t_fast's quadratic, the exact tier with _block_t_exact's
//       compensated one; strict < (lowest index wins), idx = 0 on a miss.
//   _shadow_kernel  (:384, launched at :444) -> shadow_sweep
//       hard mode: lit iff t_self <= min over the other spheres, with the
//       sentinel big = 3e38 (f32) or 1e300 (f64);
//       parts mode (shadow_parts_pallas, :491), on one sphere shard of the
//       sphere-sharded path: the pair (min t over the others, t of self)
//       itself, self a LOCAL index that never matches when out of range;
//       the caller takes each one's minimum over the shards and compares.
// The plain PyTorch versions sit in ops/intersect_fused.py.
//
// Design: one thread per ray over the (N, 3) rows render.trace carries
// (its public layout, as the JAX functions take it); one sequential
// ascending loop over the (S, 4) geometry table staged in shared memory,
// every lane of a warp reading the same row (a broadcast).  The TPU's
// sphere blocks, padding rows and in-block min reductions are gone: a
// sequential strict-< sweep picks the same winner as the blocked one.
//
// What bounds it on this card: ~35 operations per ray and cheap sphere
// (~120 per exact one) against 28 B in and 8 B out per ray (16 B in parts
// mode).  Sweeping every pair, the instruction throughput of the pair
// arithmetic bounds it at any S past a handful (89-92% of its bound at the
// op-mix ceiling), so the shadow sweep (both modes) sweeps fewer pairs.
// Once a launch, its warp bounds its 32 shadow rays by a ball of origins
// and a cone of directions, and by how near their lines pass the light (an
// argument only this bound reads); one lane a sphere tests 32 cheap-tier
// spheres against that bound under one ballot; the warp sweeps the reached
// ones in ascending order and folds faraway for the rest (sweep_math.cuh:
// the bound, its margin, the fold).  Every output stays bitwise the full
// sweep's.  What bounds it then is the reached pairs, the exact tier
// (always swept) and the test, one a (warp, sphere) pair; where a warp's
// rays scatter (glossy bounces past the first) nearly every pair is reached
// and the skip gains nothing.  kSkip compiles the skip in; the launcher
// takes it from kSkipMinCheap cheap spheres on (skip = -1) or as the caller
// forces it (0 off, 1 on: the card check and the A/B time both sides).
// nearest_sweep is unchanged.
//
// Numerics: sphere_math.cuh, and sweep_math.cuh for the two tiers of the
// sweep (_block_t_exact's exact tier, not sphere_math.cuh's sphere_t_exact).

#include "sweep_math.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T> __device__ __forceinline__ T shadow_big();
template <> __device__ __forceinline__ float shadow_big<float>() { return 3.0e38f; }
template <> __device__ __forceinline__ double shadow_big<double>() { return 1.0e300; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    nearest_sweep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                  T* __restrict__ t_out, int* __restrict__ idx_out, int n, int s_cheap, int s_total, T faraway) {
  const T* s_geom = stage_geom(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3<T> ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3<T> rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  T tmin = faraway;
  int imin = 0;
  for (int k = 0; k < s_total; ++k) {
    const T tk = sweep_t(k, s_cheap, ro, rd, s_geom, faraway);
    if (tk < tmin) {
      tmin = tk;
      imin = k;
    }
  }
  t_out[i] = tmin;
  idx_out[i] = tmin == faraway ? 0 : imin;
}

// kParts: write (t_others, t_self) to out and out2; else lit to out.
// kSkip: sweep only the cheap-tier spheres the warp's bundle reaches.
template <typename T, bool kParts, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    shadow_sweep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                 const int* __restrict__ self_idx, T* __restrict__ out, T* __restrict__ out2, int n, int s_cheap,
                 int s_total, T faraway, const T* __restrict__ light) {
  __shared__ T s_bundles[kBundleValues * kThreads / 32];
  const T* s_geom = stage_geom(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && __all_sync(kFullWarp, i < n);
  if (i >= n) return;
  const V3<T> ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3<T> rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const int self = self_idx[i];
  T t_others, t_self;
  const V3<T> apex = light ? V3<T>{light[0], light[1], light[2]}
                           : V3<T>{quiet_nan<T>(), quiet_nan<T>(), quiet_nan<T>()};
  shadow_minima(sweep_bundle<T, kSkip>(warp_full, ro, rd, apex, s_bundles), ro, rd, s_geom, self, s_cheap, s_total,
                faraway,
                shadow_big<T>(), t_others, t_self);
  if (kParts) {
    out[i] = t_others;
    out2[i] = t_self;
  } else {
    out[i] = t_self <= t_others ? T(1) : T(0);
  }
}

bool bad_args(int n, int s_cheap, int s_total) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_nearest(const T* o, const T* d, const T* geom, T* t, int* idx, int n, int s_cheap, int s_total,
                   T faraway, void* stream) {
  if (bad_args(n, s_cheap, s_total)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  if (const int err = allow_smem(nearest_sweep<T>, smem)) return err;
  nearest_sweep<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, geom, t, idx, n, s_cheap, s_total, faraway);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool kParts, bool kSkip>
int launch_shadow_as(const T* o, const T* d, const T* geom, const int* self_idx, T* out, T* out2, int n,
                     int s_cheap, int s_total, T faraway, const T* light, cudaStream_t stream) {
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  if (const int err = allow_smem(shadow_sweep<T, kParts, kSkip>, smem)) return err;
  shadow_sweep<T, kParts, kSkip><<<blocks_for(n), kThreads, smem, stream>>>(o, d, geom, self_idx, out, out2, n,
                                                                            s_cheap, s_total, faraway, light);
  return static_cast<int>(cudaGetLastError());
}

// light: the point (3 values) the shadow rays aim at, which only the skip's
// bound reads (nullptr: none); any point gives the same output.
template <typename T, bool kParts>
int launch_shadow(const T* o, const T* d, const T* geom, const int* self_idx, T* out, T* out2, int n, int s_cheap,
                  int s_total, T faraway, const T* light, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total) || skip < kSkipAuto || skip > kSkipOn) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return takes_skip(skip, s_cheap)
             ? launch_shadow_as<T, kParts, true>(o, d, geom, self_idx, out, out2, n, s_cheap, s_total, faraway, light,
                                                 st)
             : launch_shadow_as<T, kParts, false>(o, d, geom, self_idx, out, out2, n, s_cheap, s_total, faraway, light,
                                                  st);
}

// Resident blocks per SM of the shadow_sweep instantiation (mode, skip) at
// s_total spheres' shared memory; 0 where it cannot have that much.
template <typename T, bool kParts, bool kSkip> int shadow_blocks_as(int s_total) {
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  int blocks = 0;
  if (allow_smem(shadow_sweep<T, kParts, kSkip>, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, shadow_sweep<T, kParts, kSkip>, kThreads, smem) !=
          cudaSuccess) {
    cudaGetLastError();
    return 0;
  }
  return blocks;
}

template <typename T> int shadow_blocks_per_sm(int parts, int skip, int s_total) {
  if (parts) return skip ? shadow_blocks_as<T, true, true>(s_total) : shadow_blocks_as<T, true, false>(s_total);
  return skip ? shadow_blocks_as<T, false, true>(s_total) : shadow_blocks_as<T, false, false>(s_total);
}

}  // namespace

// Plain C entries, bound with ctypes (ops/intersect_fused.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch; skip is
// a Skip.  prt_shadow_blocks_per_sm_* reports a shadow_sweep
// instantiation's resident blocks per SM.
extern "C" {

int prt_nearest_sweep_f32(const float* o, const float* d, const float* geom, float* t, int* idx, int n,
                          int s_cheap, int s_total, float faraway, void* stream) {
  return launch_nearest<float>(o, d, geom, t, idx, n, s_cheap, s_total, faraway, stream);
}

int prt_nearest_sweep_f64(const double* o, const double* d, const double* geom, double* t, int* idx, int n,
                          int s_cheap, int s_total, double faraway, void* stream) {
  return launch_nearest<double>(o, d, geom, t, idx, n, s_cheap, s_total, faraway, stream);
}

#define PRT_SHADOW_ENTRIES(T, SUFFIX)                                                                              \
  int prt_shadow_sweep_##SUFFIX(const T* o, const T* d, const T* geom, const int* self_idx, T* lit, int n,        \
                                int s_cheap, int s_total, T faraway, const T* light, int skip, void* stream) {   \
    return launch_shadow<T, false>(o, d, geom, self_idx, lit, nullptr, n, s_cheap, s_total, faraway, light, skip, \
                                   stream);                                                                      \
  }                                                                                                              \
  int prt_shadow_parts_##SUFFIX(const T* o, const T* d, const T* geom, const int* self_idx, T* t_others,         \
                                T* t_self, int n, int s_cheap, int s_total, T faraway, const T* light, int skip, \
                                void* stream) {                                                                  \
    return launch_shadow<T, true>(o, d, geom, self_idx, t_others, t_self, n, s_cheap, s_total, faraway, light,   \
                                  skip, stream);                                                                 \
  }

PRT_SHADOW_ENTRIES(float, f32)
PRT_SHADOW_ENTRIES(double, f64)

#undef PRT_SHADOW_ENTRIES

int prt_shadow_blocks_per_sm_f32(int parts, int skip, int s_total) {
  return shadow_blocks_per_sm<float>(parts, skip, s_total);
}
int prt_shadow_blocks_per_sm_f64(int parts, int skip, int s_total) {
  return shadow_blocks_per_sm<double>(parts, skip, s_total);
}

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
