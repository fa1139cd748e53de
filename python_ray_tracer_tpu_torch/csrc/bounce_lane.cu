// Lane-layout hard bounce for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel of python_ray_tracer_tpu/ops/pallas_bounce.py:
//   _bounce_kernel (:160, launched by trace_fused at :430) -> bounce_lane
//       one whole hard bounce per ray: the nearest hit over every sphere
//       (cheap tier, then exact tier, :117-134), the hard shadow
//       t_self <= t_others with the 3e38 sentinel (:137-157), the winner's
//       material, the full shading stack (:218-305) and the mirror
//       continuation (:313-314); state (3, N) and (N,) in and out.
//       With an atlas (kAtlas) an image lane's nearest texel (the
//       polynomial equirectangular UV of :227-241) is read from the texel
//       table inside the kernel and enters the colour sum as its diffuse
//       texture, before the sum is weighted (:260, :305).
// The JAX renderer takes it for the hard scenes its other kernels leave:
// 65-95 spheres, or more with over 8 in the exact tier, mirror bounces,
// atlases of at most MAX_FUSED_TEXELS texels.  One launch is one bounce, as
// trace_fused scans its pallas_call; a frame takes max_depth launches.
// The plain PyTorch version sits in ops/bounce_lane.py (bounce_lane_plain).
//
// What bounds it on this card: a ray reads 44 B and writes 44 B (f32: o, d,
// acc, thr, alive), against two sweeps of S quadratics (~35 operations a
// cheap sphere, ~120 an exact one) and the BRDF.  At 80 spheres that is
// ~6 kFLOP per 88 B, far above the H100's ~20 FLOP/B ridge for f32 outside
// the tensor cores: the kernel is bound by operations.  The design follows
// from that and not from the TPU layout:
//   * one thread per ray; no (1, B) lane tiles, no sphere blocks, no
//     padding rows: a sequential strict-< sweep picks the blocked sweep's
//     winner (the lowest index among equal distances), whatever the
//     TPU's block_spheres;
//   * no one-hot MXU gathers: the winner's material row and the texel are
//     read straight from global memory (one row per lane, through L1);
//   * every lane of a warp reads the same geometry row at once (a
//     broadcast), from shared memory where the (S, 4) table is staged, else
//     from global memory through L1 (kStaged); the consts row is staged.
//     Staging is taken while it keeps as many blocks resident on an SM as
//     global reads do (registers bound those): on the card it was 3-11%
//     faster at 80 and 1032 spheres, and 30% slower at 4088 f32 spheres,
//     where 64 KB a block left 3 blocks an SM against 10 (PERF.md).
//
// Numerics: sphere_math.cuh and sweep_math.cuh (the sweeps' two tiers,
// _block_t_exact's exact tier); no FMA (ops/_build.py).  The material and
// texel reads are exact in f64 too, where the JAX kernel's one-hot products
// accumulate in float32 and so round them.

#include "sweep_math.cuh"

namespace {

constexpr int kThreads = 128;
// Hopper's opt-in shared memory a block (ops/_build.py MAX_SHARED_BYTES).
constexpr long long kMaxSharedBytes = 232448;
// Where the kernel reads the geometry: kAuto by the residency rule above,
// or forced, which the card check uses to time both sides.
enum Geometry { kAuto = -1, kGlobal = 0, kShared = 1 };

template <typename T, bool kAtlas, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    bounce_lane(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                const T* __restrict__ alive, const T* __restrict__ acc, T* __restrict__ o_out,
                T* __restrict__ d_out, T* __restrict__ thr_out, T* __restrict__ alive_out,
                T* __restrict__ acc_out, int n, const T* __restrict__ geom, const T* __restrict__ mat,
                const T* __restrict__ cst, const T* __restrict__ texels, int s_cheap, int s_total, T faraway,
                int tex_h, int tex_w) {
  // Stage the consts row (and the geometry, kStaged); every thread of the
  // block takes part, before any leaves for the ragged edge.
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int n_geom = kStaged ? 4 * s_total : 0;
  for (int j = threadIdx.x; j < n_geom; j += blockDim.x) s[j] = geom[j];
  for (int j = threadIdx.x; j < kNConst; j += blockDim.x) s[n_geom + j] = cst[j];
  __syncthreads();
  const T* g = kStaged ? s : geom;
  const T* c = s + n_geom;

  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3<T> ro = load3(o, n, i);
  const V3<T> rd = load3(d, n, i);

  // Nearest hit (_nearest): strict <, so the lowest index wins ties; a miss
  // keeps faraway and gets index 0.
  T tmin = faraway;
  int idx = 0;
  for (int k = 0; k < s_total; ++k) {
    const T tk = sweep_t(k, s_cheap, ro, rd, g, faraway);
    if (tk < tmin) {
      tmin = tk;
      idx = k;
    }
  }
  const bool is_hit = tmin != faraway;
  const T hit = is_hit ? T(1) : T(0);
  const T coverage = hit * alive[i];
  const T t_safe = is_hit ? tmin : T(1);
  const T* m = mat + static_cast<long long>(kMatCols) * idx;

  const V3<T> p = {ro.x + rd.x * t_safe, ro.y + rd.y * t_safe, ro.z + rd.z * t_safe};
  const T inv_r = T(1) / m[RAD];
  const V3<T> normal = {(p.x - m[CX]) * inv_r, (p.y - m[CY]) * inv_r, (p.z - m[CZ]) * inv_r};
  const V3<T> to_light = normalize3(V3<T>{c[3] - p.x, c[4] - p.y, c[5] - p.z});
  const V3<T> to_cam = normalize3(V3<T>{c[0] - p.x, c[1] - p.y, c[2] - p.z});
  const V3<T> p_n = {p.x + normal.x * T(kNudge), p.y + normal.y * T(kNudge), p.z + normal.z * T(kNudge)};

  // Hard shadow (_shadow): lit iff the own sphere is nearest along the
  // light ray, both minima starting from the sentinel.
  T t_others = T(kShadowBig);
  T t_self = T(kShadowBig);
  for (int k = 0; k < s_total; ++k) {
    const T tk = sweep_t(k, s_cheap, p_n, to_light, g, faraway);
    if (k == idx) {
      t_self = vmin(t_self, tk);
    } else {
      t_others = vmin(t_others, tk);
    }
  }
  const T in_light = t_self <= t_others ? T(1) : T(0);

  TexHit<T> th;
  const V3<T> color =
      shade_color_tex<T, kAtlas, kAtlas>(p, normal, to_light, to_cam, in_light, m, c, tex_h, tex_w, th, texels);

  const T w = thr[i] * coverage;
  const T refl_coeff = T(0.5) * m[SG] * in_light;
  const T ddn = T(2) * dot3(rd, normal);
  const V3<T> refl = normalize3(V3<T>{rd.x - normal.x * ddn, rd.y - normal.y * ddn, rd.z - normal.z * ddn});

  store3(o_out, n, i, p_n);
  store3(d_out, n, i, refl);
  thr_out[i] = w * refl_coeff;
  alive_out[i] = alive[i] * hit;
  store3(acc_out, n, i, V3<T>{acc[i] + color.x * w, acc[n + i] + color.y * w, acc[2 * n + i] + color.z * w});
}

bool bad_args(int n, int s_cheap, int s_total, const void* texels, int tex_h, int tex_w) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total || (texels && (tex_h < 1 || tex_w < 1));
}

template <typename T, bool kAtlas, bool kStaged>
int launch_one(int s_total, cudaStream_t stream, const T* o, const T* d, const T* thr, const T* alive, const T* acc,
               T* o_out, T* d_out, T* thr_out, T* alive_out, T* acc_out, int n, const T* geom, const T* mat,
               const T* cst, const T* texels, int s_cheap, T faraway, int tex_h, int tex_w) {
  const int smem = static_cast<int>(sizeof(T)) * ((kStaged ? 4 * s_total : 0) + kNConst);
  auto kernel = bounce_lane<T, kAtlas, kStaged>;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<(n + kThreads - 1) / kThreads, kThreads, smem, stream>>>(o, d, thr, alive, acc, o_out, d_out, thr_out,
                                                                    alive_out, acc_out, n, geom, mat, cst, texels,
                                                                    s_cheap, s_total, faraway, tex_h, tex_w);
  return static_cast<int>(cudaGetLastError());
}

// Blocks of kernel resident on an SM with smem bytes of dynamic shared
// memory; 0 where it cannot have that much.
template <typename K> int resident_blocks(K kernel, int smem) {
  int blocks = 0;
  if (allow_smem(kernel, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem) != cudaSuccess) {
    cudaGetLastError();  // a refused size is not an error of the launch: it is read from global memory
    return 0;
  }
  return blocks;
}

template <typename T, bool kAtlas> bool staged(int geometry, int s_total) {
  if (geometry != kAuto) return geometry == kShared;
  const long long bytes = static_cast<long long>(sizeof(T)) * (4LL * s_total + kNConst);
  return bytes <= kMaxSharedBytes &&
         resident_blocks(bounce_lane<T, kAtlas, true>, static_cast<int>(bytes)) >=
             resident_blocks(bounce_lane<T, kAtlas, false>, static_cast<int>(sizeof(T)) * kNConst);
}

// texels == nullptr launches the instantiation without an atlas; geometry
// (a Geometry) picks staged or global reads.
template <typename T>
int launch_bounce_lane(const T* o, const T* d, const T* thr, const T* alive, const T* acc, T* o_out, T* d_out,
                       T* thr_out, T* alive_out, T* acc_out, const T* geom, const T* mat, const T* cst,
                       const T* texels, int n, int s_cheap, int s_total, T faraway, int tex_h, int tex_w,
                       int geometry, void* stream) {
  if (bad_args(n, s_cheap, s_total, texels, tex_h, tex_w) || geometry < kAuto || geometry > kShared) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_LANE_ARGS \
  s_total, st, o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out, n, geom, mat, cst, texels, s_cheap, \
      faraway, tex_h, tex_w
  if (texels) {
    return staged<T, true>(geometry, s_total) ? launch_one<T, true, true>(PRT_LANE_ARGS)
                                              : launch_one<T, true, false>(PRT_LANE_ARGS);
  }
  return staged<T, false>(geometry, s_total) ? launch_one<T, false, true>(PRT_LANE_ARGS)
                                             : launch_one<T, false, false>(PRT_LANE_ARGS);
#undef PRT_LANE_ARGS
}

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_lane.py _SIGNATURES).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

#define PRT_LANE_ENTRY(T, SUFFIX)                                                                                 \
  int prt_bounce_lane_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc, T* o_out,     \
                               T* d_out, T* thr_out, T* alive_out, T* acc_out, const T* geom, const T* mat,     \
                               const T* cst, const T* texels, int n, int s_cheap, int s_total, T faraway,      \
                               int tex_h, int tex_w, int geometry, void* stream) {                             \
    return launch_bounce_lane<T>(o, d, thr, alive, acc, o_out, d_out, thr_out, alive_out, acc_out, geom, mat,  \
                                 cst, texels, n, s_cheap, s_total, faraway, tex_h, tex_w, geometry, stream);   \
  }

PRT_LANE_ENTRY(float, f32)
PRT_LANE_ENTRY(double, f64)

#undef PRT_LANE_ENTRY

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
