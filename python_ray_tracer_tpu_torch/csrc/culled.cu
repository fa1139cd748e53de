// Culled big-scene hard kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces the two TPU kernels of python_ray_tracer_tpu/ops/pallas_culled.py
// that trace_fused_culled launches once each per bounce:
//   _near_kernel_culled  (:609, launched at :991)  -> near_culled
//       the nearest hit over a tile's candidate list (or the full table),
//       naive roots for the selection, the winner's t recomputed once with
//       the exact forms; writes t, idx, the hit point and the normal.
//   _shade_kernel_culled (:691, launched at :1010) -> shade_culled
//       the candidate shadow sweep, the shading (the winner's material row
//       gathered by index) and the mirror continuation.  Its atlas mode
//       (kAtlas, :830-852) also writes each image lane's flat texel id and
//       dww = diffuse weight x path weight and zeroes its in-kernel diffuse
//       texture; the glue composes the texels after the launch, in the
//       bounce's ray order (ops/texture.py compose_texels).
// The plain PyTorch versions sit in ops/culled.py (near_culled_plain,
// shade_culled_plain); so does the glue that builds the candidate lists.
//
// Layout and design: one thread per ray over the flat (3, N) ray order; a
// tile is tile_rays consecutive rays (4096 on the main path), so the CTAs
// of a tile all read the same candidate row, and every lane of a warp loops
// the same count: the loop bound does not diverge, the SIMT form of the
// reason the JAX package chose candidate lists over a BVH.  The (S, 4)
// geometry table is staged in shared memory (16 KB f32 / 32 KB f64 at 1024
// spheres; dynamic, above 48 KB with the opt-in attribute); candidate ids
// are read from global memory, the same address across the warp (one
// broadcast transaction); the (S, 19) material table is read from global
// memory by winner index.  The winner's geometry is not carried: a miss or
// a win leaves it at s_geom + 4 * idx.
//
// What bounds it on this card: per ray and candidate ~30 operations (the
// naive root, a compare, selects), against 24-56 B of state in and out per
// ray; with hundreds of candidates per tile the kernels are bound by
// operations (and by the divergence of the selects), not by bytes.
//
// Numerics: sphere_math.cuh; the naive root relies on sqrt of a negative
// giving NaN (no fast math).  Strict sol < tmin over ascending ids (lowest
// index wins ties); the shadow sweep's miss is faraway (not big), so
// all-miss lanes tie and stay lit, with sentinel 3e38 in both dtypes.

#include "sphere_math.cuh"

namespace {

constexpr int kThreads = 256;

// _sphere_sol_fast: un-doubled b = d.(o - c), roots -b -/+ sqrt(b^2 - c2);
// valid iff sol > 0 (false for the NaN of a negative discriminant).
template <typename T>
__device__ __forceinline__ bool sol_fast(const V3<T>& o, const V3<T>& d, const T* g, T& sol) {
  const T ocx = o.x - g[0];
  const T ocy = o.y - g[1];
  const T ocz = o.z - g[2];
  const T b = d.x * ocx + d.y * ocy + d.z * ocz;
  const T c2 = ocx * ocx + ocy * ocy + ocz * ocz - g[3] * g[3];
  const T sq = m_sqrt(b * b - c2);
  const T t0 = -b - sq;
  sol = t0 > T(0) ? t0 : sq - b;
  return sol > T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    near_culled(const T* __restrict__ o, const T* __restrict__ d, const int* __restrict__ cand,
                const int* __restrict__ cnt_cand, const int* __restrict__ cnt_full, const T* __restrict__ geom,
                T* __restrict__ t_out, int* __restrict__ idx_out, T* __restrict__ p_out, T* __restrict__ n_out,
                int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway) {
  const T* s_geom = stage_geom(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3<T> ro = load3(o, n, i);
  const V3<T> rd = load3(d, n, i);
  const int tile = static_cast<int>(i / tile_rays);
  const int nc = min(max(cnt_cand[tile], 0), cand_stride);
  const int nf = min(max(cnt_full[tile], 0), s_cheap);
  const int* row = cand + static_cast<long long>(tile) * cand_stride;

  T tmin = faraway;
  int imin = 0;
  for (int j = 0; j < nc; ++j) {
    const int sid = __ldg(row + j);
    T sol;
    if (sol_fast(ro, rd, s_geom + 4 * sid, sol) && sol < tmin) {
      tmin = sol;
      imin = sid;
    }
  }
  for (int k = 0; k < nf; ++k) {
    T sol;
    if (sol_fast(ro, rd, s_geom + 4 * k, sol) && sol < tmin) {
      tmin = sol;
      imin = k;
    }
  }
  for (int k = s_cheap; k < s_total; ++k) {  // exact tier: always swept
    const T tk = sphere_t_exact(ro, rd, s_geom + 4 * k, faraway);
    if (tk < tmin) {
      tmin = tk;
      imin = k;
    }
  }
  // The winner's t once more with the exact forms (q-form, or compensated
  // in the exact tier): grazing-incidence cancellation of the naive root
  // never reaches the hit point or the reported distance.
  const T* cw = s_geom + 4 * imin;
  const T t_win = imin >= s_cheap ? sphere_t_exact(ro, rd, cw, faraway) : sphere_t(ro, rd, cw, faraway);
  const T t = tmin != faraway ? t_win : faraway;
  const bool hit = t != faraway;
  const T t_safe = hit ? t : T(1);
  t_out[i] = t;
  idx_out[i] = hit ? imin : 0;
  const V3<T> p = {ro.x + rd.x * t_safe, ro.y + rd.y * t_safe, ro.z + rd.z * t_safe};
  store3(p_out, n, i, p);
  // A divide, not a reciprocal multiply, as the TPU kernel.
  store3(n_out, n, i, V3<T>{(p.x - cw[0]) / cw[3], (p.y - cw[1]) / cw[3], (p.z - cw[2]) / cw[3]});
}

template <typename T>
__device__ __forceinline__ void shadow_take(int sid, int idx, T tk, T& t_others, T& t_self) {
  if (sid == idx) {
    t_self = vmin(t_self, tk);
  } else {
    t_others = vmin(t_others, tk);
  }
}

template <typename T, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    shade_culled(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                 const T* __restrict__ alive, const T* __restrict__ acc, const T* __restrict__ t_in,
                 const int* __restrict__ idx_in, const T* __restrict__ pn_in, const T* __restrict__ n_in,
                 const T* __restrict__ tl_in, const T* __restrict__ mat, const int* __restrict__ cand,
                 const int* __restrict__ cnt_cand, const int* __restrict__ cnt_full, const T* __restrict__ geom,
                 const T* __restrict__ cst, T* __restrict__ o_out, T* __restrict__ d_out, T* __restrict__ thr_out,
                 T* __restrict__ alive_out, T* __restrict__ acc_out, int* __restrict__ flat_out,
                 T* __restrict__ dww_out, int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway,
                 int tex_h, int tex_w) {
  const T* s_geom = stage_geom(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const V3<T> ro = load3(o, n, i);
  const V3<T> rd = load3(d, n, i);
  const V3<T> p_n = load3(pn_in, n, i);
  const V3<T> normal = load3(n_in, n, i);
  const V3<T> to_light = load3(tl_in, n, i);
  const T t = t_in[i];
  const int idx = idx_in[i];
  const int tile = static_cast<int>(i / tile_rays);
  const int nc = min(max(cnt_cand[tile], 0), cand_stride);
  const int nf = min(max(cnt_full[tile], 0), s_cheap);
  const int* row = cand + static_cast<long long>(tile) * cand_stride;

  const bool is_hit = t != faraway;
  const T hit = is_hit ? T(1) : T(0);
  const T coverage = hit * alive[i];
  const T t_safe = is_hit ? t : T(1);
  const T* m = mat + static_cast<long long>(kMatCols) * idx;
  const V3<T> p = {ro.x + rd.x * t_safe, ro.y + rd.y * t_safe, ro.z + rd.z * t_safe};
  const V3<T> to_cam = normalize3(V3<T>{cst[0] - p.x, cst[1] - p.y, cst[2] - p.z});

  // Culled hard shadow: lit iff the own sphere is nearest along the light ray.
  T t_others = T(kShadowBig);
  T t_self = T(kShadowBig);
  for (int j = 0; j < nc; ++j) {
    const int sid = __ldg(row + j);
    T sol;
    const bool valid = sol_fast(p_n, to_light, s_geom + 4 * sid, sol);
    shadow_take(sid, idx, valid ? sol : faraway, t_others, t_self);
  }
  for (int k = 0; k < nf; ++k) {
    T sol;
    const bool valid = sol_fast(p_n, to_light, s_geom + 4 * k, sol);
    shadow_take(k, idx, valid ? sol : faraway, t_others, t_self);
  }
  for (int k = s_cheap; k < s_total; ++k) {
    shadow_take(k, idx, sphere_t_exact(p_n, to_light, s_geom + 4 * k, faraway), t_others, t_self);
  }
  const T in_light = t_self <= t_others ? T(1) : T(0);

  TexHit<T> th;
  const V3<T> color =
      shade_color_tex<T, kAtlas, false>(p, normal, to_light, to_cam, in_light, m, cst, tex_h, tex_w, th, nullptr);
  if constexpr (kAtlas) {
    flat_out[i] = th.flat;
    dww_out[i] = th.is_image ? th.diffuse_w * thr[i] * coverage : T(0);
  }
  const T w = thr[i] * coverage;
  thr_out[i] = w * (T(0.5) * m[SG] * in_light);
  alive_out[i] = alive[i] * hit;
  const T ddn = T(2) * dot3(rd, normal);
  store3(d_out, n, i, normalize3(V3<T>{rd.x - normal.x * ddn, rd.y - normal.y * ddn, rd.z - normal.z * ddn}));
  store3(o_out, n, i, p_n);
  store3(acc_out, n, i,
         V3<T>{acc[i] + color.x * w, acc[n + i] + color.y * w, acc[2 * static_cast<long long>(n) + i] + color.z * w});
}

template <typename T> int geom_smem(int s_total) { return 4 * s_total * static_cast<int>(sizeof(T)); }

bool bad_args(int n, int s_cheap, int s_total, int tile_rays, int cand_stride) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total || tile_rays < 1 || cand_stride < 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T>
int launch_near(const T* o, const T* d, const int* cand, const int* cnt_cand, const int* cnt_full, const T* geom,
                T* t, int* idx, T* p, T* nrm, int n, int s_cheap, int s_total, int tile_rays, int cand_stride,
                T faraway, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride)) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = geom_smem<T>(s_total);
  if (const int err = allow_smem(near_culled<T>, smem)) return err;
  near_culled<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, cand, cnt_cand, cnt_full, geom, t, idx, p, nrm, n, s_cheap, s_total, tile_rays, cand_stride, faraway);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_shade(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* t, const int* idx,
                 const T* p_n, const T* nrm, const T* tl, const T* mat, const int* cand, const int* cnt_cand,
                 const int* cnt_full, const T* geom, const T* cst, T* o_out, T* d_out, T* thr_out, T* alive_out,
                 T* acc_out, int* flat_out, T* dww_out, int n, int s_cheap, int s_total, int tile_rays,
                 int cand_stride, T faraway, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) || (flat_out && (!dww_out || tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = geom_smem<T>(s_total);
  const auto kernel = flat_out ? shade_culled<T, true> : shade_culled<T, false>;
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, acc, t, idx, p_n, nrm, tl, mat, cand, cnt_cand, cnt_full, geom, cst, o_out, d_out,
      thr_out, alive_out, acc_out, flat_out, dww_out, n, s_cheap, s_total, tile_rays, cand_stride, faraway, tex_h,
      tex_w);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entries, bound with ctypes (ops/culled.py _SIGNATURES).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

#define PRT_NEAR_ENTRY(SUFFIX, T)                                                                            \
  int prt_near_culled_##SUFFIX(const T* o, const T* d, const int* cand, const int* cnt_cand,                 \
                               const int* cnt_full, const T* geom, T* t, int* idx, T* p, T* nrm, int n,       \
                               int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway,           \
                               void* stream) {                                                               \
    return launch_near<T>(o, d, cand, cnt_cand, cnt_full, geom, t, idx, p, nrm, n, s_cheap, s_total,         \
                          tile_rays, cand_stride, faraway, stream);                                          \
  }

#define PRT_SHADE_ENTRY(SUFFIX, T)                                                                           \
  int prt_shade_culled_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc,          \
                                const T* t, const int* idx, const T* p_n, const T* nrm, const T* tl,          \
                                const T* mat, const int* cand, const int* cnt_cand, const int* cnt_full,      \
                                const T* geom, const T* cst, T* o_out, T* d_out, T* thr_out, T* alive_out,    \
                                T* acc_out, int* flat, T* dww, int n, int s_cheap, int s_total, int tile_rays, \
                                int cand_stride, T faraway, int tex_h, int tex_w, void* stream) {            \
    return launch_shade<T>(o, d, thr, alive, acc, t, idx, p_n, nrm, tl, mat, cand, cnt_cand, cnt_full, geom, \
                           cst, o_out, d_out, thr_out, alive_out, acc_out, flat, dww, n, s_cheap, s_total,   \
                           tile_rays, cand_stride, faraway, tex_h, tex_w, stream);                           \
  }

PRT_NEAR_ENTRY(f32, float)
PRT_NEAR_ENTRY(f64, double)
PRT_SHADE_ENTRY(f32, float)
PRT_SHADE_ENTRY(f64, double)

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
