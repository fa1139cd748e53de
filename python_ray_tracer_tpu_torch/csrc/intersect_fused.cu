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
//   _shadow_kernel  (:384, launched at :444) -> shadow_sweep (hard mode)
//       lit iff t_self <= min over the other spheres, with the sentinel big
//       = 3e38 (f32) or 1e300 (f64).  The parts mode of the sphere-sharded
//       path is not ported.
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
// (~120 per exact one) against 28 B in and 8 B out per ray: bound by
// operations at any S past a handful.
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    shadow_sweep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                 const int* __restrict__ self_idx, T* __restrict__ lit, int n, int s_cheap, int s_total,
                 T faraway) {
  const T* s_geom = stage_geom(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3<T> ro = {o[3 * i], o[3 * i + 1], o[3 * i + 2]};
  const V3<T> rd = {d[3 * i], d[3 * i + 1], d[3 * i + 2]};
  const int self = self_idx[i];
  T t_others = shadow_big<T>();
  T t_self = shadow_big<T>();
  for (int k = 0; k < s_total; ++k) {
    const T tk = sweep_t(k, s_cheap, ro, rd, s_geom, faraway);
    if (k == self) {
      t_self = vmin(t_self, tk);
    } else {
      t_others = vmin(t_others, tk);
    }
  }
  lit[i] = t_self <= t_others ? T(1) : T(0);
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

template <typename T>
int launch_shadow(const T* o, const T* d, const T* geom, const int* self_idx, T* lit, int n, int s_cheap,
                  int s_total, T faraway, void* stream) {
  if (bad_args(n, s_cheap, s_total)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  if (const int err = allow_smem(shadow_sweep<T>, smem)) return err;
  shadow_sweep<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, geom, self_idx, lit, n, s_cheap, s_total, faraway);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, bound with ctypes (ops/intersect_fused.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

int prt_nearest_sweep_f32(const float* o, const float* d, const float* geom, float* t, int* idx, int n,
                          int s_cheap, int s_total, float faraway, void* stream) {
  return launch_nearest<float>(o, d, geom, t, idx, n, s_cheap, s_total, faraway, stream);
}

int prt_nearest_sweep_f64(const double* o, const double* d, const double* geom, double* t, int* idx, int n,
                          int s_cheap, int s_total, double faraway, void* stream) {
  return launch_nearest<double>(o, d, geom, t, idx, n, s_cheap, s_total, faraway, stream);
}

int prt_shadow_sweep_f32(const float* o, const float* d, const float* geom, const int* self_idx, float* lit,
                         int n, int s_cheap, int s_total, float faraway, void* stream) {
  return launch_shadow<float>(o, d, geom, self_idx, lit, n, s_cheap, s_total, faraway, stream);
}

int prt_shadow_sweep_f64(const double* o, const double* d, const double* geom, const int* self_idx, double* lit,
                         int n, int s_cheap, int s_total, double faraway, void* stream) {
  return launch_shadow<double>(o, d, geom, self_idx, lit, n, s_cheap, s_total, faraway, stream);
}

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
