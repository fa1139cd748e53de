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
// Layout: one thread per ray over the flat (3, N) ray order; a tile is
// tile_rays consecutive rays (4096 on the main path), so the CTAs of a tile
// all read the same candidate row, and every lane of a warp loops the same
// count: the loop bound does not diverge, the SIMT form of the reason the
// JAX package chose candidate lists over a BVH.  The (S, 4) geometry table
// is staged in shared memory (16 KB f32 / 32 KB f64 at 1024 spheres;
// dynamic, above 48 KB with the opt-in attribute); candidate ids are read
// from global memory, the same address across the warp (one broadcast
// transaction); the (S, 19) material table is read from global memory by
// winner index.  The winner's geometry is not carried: a miss or a win
// leaves it at s_geom + 4 * idx.
//
// shade_culled's shadow sweep with the skip (kSkip, the launcher's rule
// unless the caller passes 0): a tile's list holds every sphere some shadow
// ray of its 4096 may meet, but a warp is 32 neighbouring rays, and most of
// the listed spheres lie far from all of them.  Each warp bounds its 32
// shadow rays (p_n, to_light) once (bundle_math.cuh warp_bundle: a ball of
// origins, a cone of directions, and the light as the apex every shadow
// line passes near), then tests the listed cheap-tier spheres 32 at a time,
// one lane a sphere, under one ballot (bundle_reaches), and runs sol_fast
// only for the kept ids, in the list's order.  A sphere left out is a miss
// on every lane: it folds faraway, which the lane's two minima take at the
// end (t_self where the sphere is the lane's own, else t_others), as
// shadow_minima does in sweep_math.cuh; a minimum over numbers does not
// depend on their order, so in_light and every output stay bitwise the
// skip-off build's.  Whether the bound keeps a sphere depends on the sphere
// alone, so a lane whose own sphere the bound keeps skipped none of its
// copies, and only the other lanes look their own sphere up in the row.  A
// warp whose bound is unusable sweeps every listed sphere.  The exact tier
// is always swept.
//
// Why bundle_reaches' margin covers sol_fast (argued in bundle_math.cuh for
// sphere_t): sol_fast reads the same quadratic with b un-doubled, b = d.oc
// and c2 = |oc|^2 - r^2, and calls a hit where sol > 0 with b^2 - c2 >= 0 as
// rounded (a negative one gives NaN).  The exact scalings by 2 and 4 change
// no rounding, so b^2 - c2 >= 0 as rounded needs the line within
// sqrt(r^2 (1 + 3u) + 48u |o - g|^2) of g, as sphere_t's disc > 0 does (the
// bound admits equality).  sol > 0 needs t0 = -b - sq > 0, so b < 0 as
// rounded (the half-line's near point ahead of o, sphere_t's case), or
// sq - b > 0: with b < 0 the same, with b >= 0 only where the rounded
// b^2 - c2 reaches b^2, so c2 <= ~3u |oc|^2 and the origin itself lies
// within r sqrt(1 + 10u) of g (a shadow origin a nudge off its sphere from
// a light behind it).  Both lie inside the margin's q: a skipped sphere is
// a miss on every lane.  tests/test_torch_culled_skip.py holds fans of
// shadow lines tangent to r from far origins, which without the margin the
// f32 bound gets wrong.
//
// What bounds it on this card: per ray and listed candidate ~30 operations
// (the naive root, a compare, selects), against 24-56 B of state in and out
// per ray; with hundreds of candidates per tile the kernels are bound by
// operations (and by the divergence of the selects), not by bytes.  With
// the skip shade_culled pays one test a (warp, listed sphere) pair (~78
// operations for one lane, 32 spheres a ballot) and the root only on the
// pairs the bound keeps: on config 4's mirror frame it keeps 5 / 16 / 31 /
// 60% of the listed (warp, slot) pairs, bounce by bounce, and runs 1.6 /
// 1.8 / 1.6 / 1.0x the skip-off build (an H100).  The skip builds take 64
// registers in f32 (46 without; 4 CTAs of 256 an SM at 1024 spheres against
// 5) and 102 in f64 (76; 2 against 3), no spills (ptxas -v): in f64 the lost
// CTA makes the skip lose at 480x270, which only the checks run.
//
// Numerics: sphere_math.cuh; the naive root relies on sqrt of a negative
// giving NaN (no fast math).  Strict sol < tmin over ascending ids (lowest
// index wins ties); the shadow sweep's miss is faraway (not big), so
// all-miss lanes tie and stay lit, with sentinel 3e38 in both dtypes.

#include "bundle_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarp = 32;

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

// shade_culled's shadow minima over a tile's list with the skip: the
// candidates row[0..nc), then the full-tier fallback 0..nf-1, each chunk of
// 32 tested against the warp's bound b (one lane a sphere, one ballot),
// sol_fast only for the kept ids in the list's order.  A skipped sphere is a
// miss on every lane and folds faraway at the end: into t_self where it is
// the lane's own sphere idx, into t_others otherwise.  Whether a sphere is
// kept depends on the sphere alone, so every listed copy of idx is skipped
// exactly where the lane's own test of it fails; only those lanes count
// their copies, by a scan of the row.  Every lane of the warp calls it, b
// usable.  The exact tier is the caller's.
template <typename T>
__device__ __forceinline__ void list_minima_skip(const Bundle<T>& b, const V3<T>& p_n, const V3<T>& to_light, int idx,
                                                 const int* row, int nc, int nf, const T* s_geom, int s_cheap,
                                                 T faraway, T& t_others, T& t_self) {
  const int lane = static_cast<int>(threadIdx.x & 31u);
  const bool own_kept = idx < 0 || idx >= s_cheap || bundle_reaches(b, s_geom + 4 * idx);
  int skipped = 0;  // the warp's skipped slots (uniform over it)
  auto eval = [&](int sid) {
    T sol;
    const bool valid = sol_fast(p_n, to_light, s_geom + 4 * sid, sol);
    shadow_take(sid, idx, valid ? sol : faraway, t_others, t_self);
  };
  auto chunk_bits = [](int left) { return left >= kWarp ? kFullWarp : (1u << left) - 1u; };
  for (int j0 = 0; j0 < nc; j0 += kWarp) {  // the candidates, lane j reading j0 + j
    const int j = j0 + lane;
    const int k = j < nc ? __ldg(row + j) : 0;
    const unsigned reached = __ballot_sync(kFullWarp, j < nc && (k >= s_cheap || bundle_reaches(b, s_geom + 4 * k)));
    skipped += __popc(chunk_bits(nc - j0) & ~reached);
    for (unsigned m = reached; m != 0u; m &= m - 1u) eval(__shfl_sync(kFullWarp, k, __ffs(static_cast<int>(m)) - 1));
  }
  for (int k0 = 0; k0 < nf; k0 += kWarp) {  // the full-tier fallback
    const int k = k0 + lane;
    const unsigned reached = __ballot_sync(kFullWarp, k < nf && bundle_reaches(b, s_geom + 4 * k));
    skipped += __popc(chunk_bits(nf - k0) & ~reached);
    for (unsigned m = reached; m != 0u; m &= m - 1u) eval(k0 + __ffs(static_cast<int>(m)) - 1);
  }
  int own = 0;  // the skipped copies of the lane's own sphere
  if (!own_kept) {
    for (int j = 0; j < nc; ++j) own += __ldg(row + j) == idx ? 1 : 0;
    own += idx < nf ? 1 : 0;
  }
  if (own > 0) t_self = vmin(t_self, faraway);
  if (skipped > own) t_others = vmin(t_others, faraway);
}

// kSkip: the shadow sweep leaves out the listed spheres no shadow ray of the
// warp can hit (list_minima_skip).
template <typename T, bool kAtlas, bool kSkip>
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
  const bool warp_full = kSkip && tile_rays % kWarp == 0 && __all_sync(kFullWarp, i < n);
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
  bool swept = false;
  if constexpr (kSkip) {
    __shared__ T s_bundles[kBundleValues * (kThreads / kWarp)];
    T* slot = s_bundles + kBundleValues * (threadIdx.x / kWarp);
    const V3<T> light = {cst[3], cst[4], cst[5]};
    const Bundle<T> b = warp_full ? warp_bundle(p_n, to_light, light, slot) : Bundle<T>{slot, false, false};
    if (b.ok) {  // uniform over the warp
      list_minima_skip(b, p_n, to_light, idx, row, nc, nf, s_geom, s_cheap, faraway, t_others, t_self);
      swept = true;
    }
  }
  if (!swept) {
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

// shade_culled's instantiation for the atlas mode and the skip.
template <typename T> auto shade_kernel(bool atlas, bool skip) {
  return skip ? (atlas ? shade_culled<T, true, true> : shade_culled<T, false, true>)
              : (atlas ? shade_culled<T, true, false> : shade_culled<T, false, false>);
}

// shade_culled's skip code, as the sweeps' (sweep_math.cuh Skip): -1 the
// launcher's rule, 0 off, 1 on.  The rule takes the skip on every launch:
// the culled route's tables hold at least 96 spheres.
inline bool shade_takes_skip(int skip) { return skip != 0; }

template <typename T>
int launch_shade(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* t, const int* idx,
                 const T* p_n, const T* nrm, const T* tl, const T* mat, const int* cand, const int* cnt_cand,
                 const int* cnt_full, const T* geom, const T* cst, T* o_out, T* d_out, T* thr_out, T* alive_out,
                 T* acc_out, int* flat_out, T* dww_out, int n, int s_cheap, int s_total, int tile_rays,
                 int cand_stride, T faraway, int tex_h, int tex_w, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) || (flat_out && (!dww_out || tex_h < 1 || tex_w < 1)) ||
      skip < -1 || skip > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = geom_smem<T>(s_total);
  const auto kernel = shade_kernel<T>(flat_out != nullptr, shade_takes_skip(skip));
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, acc, t, idx, p_n, nrm, tl, mat, cand, cnt_cand, cnt_full, geom, cst, o_out, d_out,
      thr_out, alive_out, acc_out, flat_out, dww_out, n, s_cheap, s_total, tile_rays, cand_stride, faraway, tex_h,
      tex_w);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of shade_culled's instantiation (atlas, skip) at
// its launch's dynamic shared bytes for s_total spheres, or a negative CUDA
// error.
template <typename T> int shade_blocks_per_sm(int atlas, int skip, int s_total) {
  const int smem = geom_smem<T>(s_total);
  const auto kernel = shade_kernel<T>(atlas != 0, skip != 0);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

}  // namespace

// Plain C entries, bound with ctypes (ops/culled.py _SIGNATURES).  Each
// launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
// prt_shade_culled_blocks_per_sm_* reports an instantiation's resident
// blocks per SM.
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
                                int cand_stride, T faraway, int tex_h, int tex_w, int skip, void* stream) {  \
    return launch_shade<T>(o, d, thr, alive, acc, t, idx, p_n, nrm, tl, mat, cand, cnt_cand, cnt_full, geom, \
                           cst, o_out, d_out, thr_out, alive_out, acc_out, flat, dww, n, s_cheap, s_total,   \
                           tile_rays, cand_stride, faraway, tex_h, tex_w, skip, stream);                     \
  }                                                                                                          \
  int prt_shade_culled_blocks_per_sm_##SUFFIX(int atlas, int skip, int s_total) {                            \
    return shade_blocks_per_sm<T>(atlas, skip, s_total);                                                     \
  }

PRT_NEAR_ENTRY(f32, float)
PRT_NEAR_ENTRY(f64, double)
PRT_SHADE_ENTRY(f32, float)
PRT_SHADE_ENTRY(f64, double)

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
