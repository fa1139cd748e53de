// Per-shard smooth-visibility sweeps for Hopper (sm_90a), CUDA C++.
//
// Replaces the three TPU kernels of
// python_ray_tracer_tpu/ops/pallas_smooth_parts.py that the sphere-sharded
// smooth path runs on every bounce, each over one shard of the sphere table
// (LOCAL indices; the caller's collectives finish the reductions across the
// sphere shards):
//   _smooth_nearest_kernel (:107, launched at :190) -> smooth_nearest_parts
//       the strict-hit winner (t, idx) with its raw (sol, disc), and the
//       max-discriminant fallback (dmax, fidx, sol_f): strict t < tmin (the
//       lowest index wins an exact tie), strict disc > dmax (the first
//       maximum wins), sentinel -3e38; a miss keeps idx = 0 and
//       sol_w = disc_w = 0 (:150-170).
//   _clear_fwd_kernel (:313, launched at :436) -> clear_fwd
//       the product over the shard's spheres other than the lane's own of
//       1 - sig(k disc) sig(k sol), kept as one running product in row
//       order (the TPU multiplies within a block of rows first, :332-335).
//   _clear_bwd_kernel (:345, launched at :492) -> clear_bwd
//       its adjoint, the shard swept again: lane gradients g_o, g_d and the
//       per-sphere (centre, radius) gradients, with the Phase-C divisor
//       max(fac, 1e-6) (:382) and the branch adjoint taken at the plain
//       tier's (b, c_term) for every row, as the TPU kernel takes it.
// The plain PyTorch versions sit in ops/smooth_parts.py.
// smooth_nearest_parts (kSkip, by the launch rule from kNearestSkipMinCheap
// cheap spheres) walks the cheap tier as smooth_fwd_step's winner sweep
// does (smooth_math.cuh winner_skip_cheap), leaving out the spheres that can
// win neither strict compare; its seven outputs stay bitwise the full loop's.
//
// Design: one thread per ray over the (N, 3) rows render.trace carries;
// one ascending loop over the shard's (S, 4) geometry table, every lane of a
// warp reading the same row (a broadcast), from shared memory where staging
// keeps as many blocks resident on an SM as global reads do (the residency
// rule of bounce_lane.cu), else from global memory.  The TPU sums its
// per-sphere gradient rows into one output across its sequential grid
// (:367-369, :405); Hopper's blocks run in no order, so clear_bwd reduces
// each sphere's four values within its block (warp shuffles, then the
// warps in a fixed order through shared memory, a chunk of spheres at a
// time) into one partial row per block, and reduce_parts sums the blocks'
// rows in a fixed order: no float atomics, two launches agree bit for bit.
// A warp passes a sphere that reaches none of its rays (the ray's own, or
// a shadow sigmoid of exactly 0): no second sigmoid, no branch adjoint, no
// warp sums there, its slot +0; about 0.1% of warp-sphere pairs reach.
// clear_fwd (kSkip, by the launch rule from kClearSkipMinCheap cheap
// spheres) leaves its factors of exactly 1 out of the product the same way,
// and more cheaply: each warp bounds its 32 shadow lines (a ball of
// origins, a cone of directions, the light as apex) and tests 32 cheap
// spheres a ballot against r_eff (bundle_math.cuh line_reaches), so a
// sphere no line comes near costs no quadratic at all; a pair the bound
// keeps takes its quadratic and the zero test, and the sigmoids only where
// that test fails (smooth_math.cuh shadow_skip_product, shared with
// smooth_fwd_step).  clear stays bitwise the full loop's.
//
// What bounds them on this card: per ray and sphere ~30 operations
// (smooth_nearest_parts), ~45 with two sigmoids (clear_fwd without its
// skip) and ~110 with the branch adjoint (clear_bwd), against 24-56 B a ray
// in and out (f32): bound by operations at any shard size past a handful of
// spheres; with the skips, by the pairs they keep and their tests.
//
// Numerics: smooth_math.cuh (its tiers, quad_sol_disc, sol_disc_adjoint,
// sig); no FMA (ops/_build.py).

#include "smooth_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / kWarp;
// Spheres whose block sums clear_bwd gathers in shared memory at once:
// kChunk * 4 values, one for each thread of the block to finish.
constexpr int kChunk = kThreads / 4;
constexpr int kReduceThreads = 256;
constexpr long long kMaxSharedBytes = 232448;  // ops/_build.py MAX_SHARED_BYTES

template <typename T> __device__ __forceinline__ V3<T> row3(const T* a, long long i) {
  return {a[3 * i], a[3 * i + 1], a[3 * i + 2]};
}

// Sphere k's (sol, disc, t) in its tier, and its plain-tier (b, c_term).
template <typename T>
__device__ __forceinline__ void sphere_parts(int k, int s_cheap, const V3<T>& o, const V3<T>& d, const T* g,
                                             T faraway, T& sol, T& disc, T& t, T& b_plain, T& ct_plain,
                                             V3<T>& oc) {
  const V3<T> c = {g[4 * k], g[4 * k + 1], g[4 * k + 2]};
  const T r = g[4 * k + 3];
  b_cterm_plain(o, d, c, r, b_plain, ct_plain);
  oc = {o.x - c.x, o.y - c.y, o.z - c.z};
  T b = b_plain, ct = ct_plain;
  if (k >= s_cheap) b_cterm_exact(o, d, c, r, b, ct);
  quad_sol_disc(b, ct, faraway, sol, disc, t);
}

// The geometry rows a block reads: staged into shared memory (kStaged) by
// every thread of the block, before any thread leaves; else global memory.
template <typename T, bool kStaged> __device__ __forceinline__ const T* block_geom(const T* geom, int s_total) {
  if (!kStaged) return geom;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  for (int j = threadIdx.x; j < 4 * s_total; j += blockDim.x) s[j] = geom[j];
  __syncthreads();
  return s;
}

// kSkip: the cheap tier walked as smooth_fwd_step's winner sweep walks it
// (smooth_math.cuh winner_skip_cheap): a warp whose 32 rays have a usable
// bound (no apex) visits only the spheres winner_reaches keeps against its
// least running dmax, read before each chunk of 32, in index order; a
// sphere left out can win neither strict compare, so every output is
// bitwise the full loop's.  The exact tier is always visited.
template <typename T, bool kStaged, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    smooth_nearest_parts(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                         T* __restrict__ t_out, int* __restrict__ idx_out, T* __restrict__ solw_out,
                         T* __restrict__ discw_out, T* __restrict__ dmax_out, int* __restrict__ fidx_out,
                         T* __restrict__ solf_out, int n, int s_cheap, int s_total, T faraway) {
  const T* g = block_geom<T, kStaged>(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && __all_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const V3<T> ro = row3(o, i);
  const V3<T> rd = row3(d, i);
  T tmin = faraway, solw = T(0), discw = T(0);
  T dmax = T(kNegBig), solf = T(0);
  int imin = 0, fidx = 0;
  // Sphere k's two strict compares, in index order.
  auto take = [&](int k) {
    T sol, disc, t, b, ct;
    V3<T> oc;
    sphere_parts(k, s_cheap, ro, rd, g, faraway, sol, disc, t, b, ct, oc);
    if (t < tmin) {
      tmin = t;
      imin = k;
      solw = sol;
      discw = disc;
    }
    if (disc > dmax) {
      dmax = disc;
      fidx = k;
      solf = sol;
    }
  };
  int k0 = 0;
  if constexpr (kSkip) {
    __shared__ T s_bundles[kBundleValues * kWarps];
    k0 = winner_skip_cheap(ro, rd, g, s_cheap, s_bundles + kBundleValues * (threadIdx.x / kWarp), warp_full, dmax,
                           take);
  }
  for (int k = k0; k < s_total; ++k) take(k);
  t_out[i] = tmin;
  idx_out[i] = tmin == faraway ? 0 : imin;
  solw_out[i] = solw;
  discw_out[i] = discw;
  dmax_out[i] = dmax;
  fidx_out[i] = fidx;
  solf_out[i] = solf;
}

// kSkip: the product leaves out the factors of exactly 1
// (smooth_math.cuh shadow_skip_product): per lane a pair whose sig(k disc)
// is exactly 0, and per warp the cheap-tier spheres no shadow line comes
// within r_eff of (the warp's bundle, with light as its apex where given).
// The factors left are multiplied in row order: clear is bitwise the full
// loop's.  light: the point the shadow rays aim at (3 values), read by the
// bundle only (nullptr: none; any point gives the same output).
template <typename T, bool kStaged, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    clear_fwd(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
              const int* __restrict__ self_idx, T* __restrict__ clear_out, int n, int s_cheap, int s_total,
              T faraway, T sharpness, const T* __restrict__ light) {
  const T* g = block_geom<T, kStaged>(geom, s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && __all_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const V3<T> ro = row3(o, i);
  const V3<T> rd = row3(d, i);
  const int self = self_idx[i];
  T clear = T(1);
  if constexpr (kSkip) {
    __shared__ T s_bundles[kBundleValues * kWarps];
    const Scal<T> sc = {faraway, T(0), sharpness, s_cheap, s_total, 0, 0};
    const V3<T> apex = light ? V3<T>{light[0], light[1], light[2]}
                             : V3<T>{quiet_nan<T>(), quiet_nan<T>(), quiet_nan<T>()};
    clear = shadow_skip_product(ro, rd, self, g, sc, apex, s_bundles + kBundleValues * (threadIdx.x / kWarp),
                                warp_full);
  } else {
    for (int k = 0; k < s_total; ++k) {
      T sol, disc, t, b, ct;
      V3<T> oc;
      sphere_parts(k, s_cheap, ro, rd, g, faraway, sol, disc, t, b, ct, oc);
      const T occl = sig(sharpness * disc) * sig(sharpness * sol);
      clear = clear * (k == self ? T(1) : T(1) - occl);
    }
  }
  clear_out[i] = clear;
}

// parts: (4 * s_total, n_blocks), the block sums of each sphere's
// (g_cx, g_cy, g_cz, g_r), value-major.
template <typename T, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    clear_bwd(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
              const int* __restrict__ self_idx, const T* __restrict__ clear, const T* __restrict__ g_clear,
              T* __restrict__ go_out, T* __restrict__ gd_out, T* __restrict__ parts, int n, int s_cheap,
              int s_total, T faraway, T sharpness) {
  const T* g = block_geom<T, kStaged>(geom, s_total);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // After the staged geometry: the warps' sums of one chunk of spheres.
  T* red = reinterpret_cast<T*>(smem_raw) + (kStaged ? 4 * s_total : 0);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool valid = i < n;
  // Every thread runs the sweep (the block's reductions need all of them);
  // past the ragged edge a lane reads ray 0 and adds zeros.
  const long long li = valid ? i : 0;
  const V3<T> ro = row3(o, li);
  const V3<T> rd = row3(d, li);
  const int self = self_idx[li];
  const T gc = valid ? g_clear[li] * clear[li] : T(0);
  V3<T> go = {T(0), T(0), T(0)}, gd = {T(0), T(0), T(0)};
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int n_blocks = gridDim.x;
  for (int k0 = 0; k0 < s_total; k0 += kChunk) {
    const int k1 = min(k0 + kChunk, s_total);
    for (int k = k0; k < k1; ++k) {
      // A sphere that reaches no valid lane of the warp (the lane's own, or
      // a shadow sigmoid sig(k disc) of exactly 0, disc in the sphere's
      // tier): every term it has there is exactly +-0, so the warp passes
      // it and its slot reads +0.
      const V3<T> c = {g[4 * k], g[4 * k + 1], g[4 * k + 2]};
      T bt, ctt;
      if (k < s_cheap) {
        b_cterm_plain(ro, rd, c, g[4 * k + 3], bt, ctt);
      } else {
        b_cterm_exact(ro, rd, c, g[4 * k + 3], bt, ctt);
      }
      const bool reached = valid && k != self && !sig_is_zero(sharpness * (bt * bt - T(4) * ctt));
      if (!__any_sync(0xffffffffu, reached)) {
        if (lane == 0) {
          for (int v = 0; v < 4; ++v) red[(warp * kChunk + (k - k0)) * 4 + v] = T(0);
        }
        continue;
      }
      T sol, disc, t, b, ct;
      V3<T> oc;
      sphere_parts(k, s_cheap, ro, rd, g, faraway, sol, disc, t, b, ct, oc);
      const T sd = sig(sharpness * disc);
      const T ss = sig(sharpness * sol);
      const T occl = sd * ss;
      const bool is_self = k == self;
      const T fac = is_self ? T(1) : T(1) - occl;
      const T g_fac = gc / vmax(fac, T(kEpsDen));
      const T g_occl = is_self ? T(0) : -g_fac;
      const T g_disc = g_occl * ss * sd * (T(1) - sd) * sharpness;
      const T g_sol = g_occl * sd * ss * (T(1) - ss) * sharpness;
      T g_b, g_ct;
      sol_disc_adjoint(b, ct, g_sol, g_disc, g_b, g_ct);
      T row[4];
      for (int c = 0; c < 3; ++c) {
        const T go_c = T(2) * rd[c] * g_b + T(2) * oc[c] * g_ct;
        go[c] = go[c] + go_c;
        gd[c] = gd[c] + T(2) * oc[c] * g_b;
        row[c] = -go_c;
      }
      row[3] = T(-2) * g[4 * k + 3] * g_ct;
      for (int c = 0; c < 4; ++c) {
        const T s = warp_sum(row[c]);
        if (lane == 0) red[(warp * kChunk + (k - k0)) * 4 + c] = s;
      }
    }
    __syncthreads();
    const int e = threadIdx.x;  // (k - k0) * 4 + c
    if (e < (k1 - k0) * 4) {
      T s = T(0);
      for (int w = 0; w < kWarps; ++w) s += red[w * kChunk * 4 + e];
      parts[static_cast<long long>(4 * k0 + e) * n_blocks + blockIdx.x] = s;
    }
    __syncthreads();
  }
  if (valid) {
    for (int c = 0; c < 3; ++c) {
      go_out[3 * i + c] = go[c];
      gd_out[3 * i + c] = gd[c];
    }
  }
}

// out[v] = the sum of parts[v, :] (n_cols values), one block per value, in a
// fixed order (strided per thread, then a shared-memory tree).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_parts(const T* __restrict__ parts, T* __restrict__ out, int n_cols) {
  __shared__ T s[kReduceThreads];
  const T* row = parts + static_cast<long long>(blockIdx.x) * n_cols;
  T acc = T(0);
  for (int w = threadIdx.x; w < n_cols; w += kReduceThreads) acc += row[w];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

bool bad_args(int n, int s_cheap, int s_total) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

// Opt a kernel in to more than 48 KB of dynamic shared memory where needed.
template <typename K> int opt_in(K kernel, long long bytes) {
  if (bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  return allow_smem(kernel, static_cast<int>(bytes));
}

// Blocks of kernel resident on an SM with smem bytes of dynamic shared
// memory; 0 where it cannot have that much.
template <typename K> int resident_blocks(K kernel, long long smem) {
  int blocks = 0;
  if (opt_in(kernel, smem) != 0 ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, static_cast<int>(smem)) !=
          cudaSuccess) {
    cudaGetLastError();  // a refused size is not an error of the launch: it reads global memory
    return 0;
  }
  return blocks;
}

// Stage the geometry (extra: the other dynamic shared memory a block uses)
// while that keeps as many blocks resident as global reads do.
template <typename KS, typename KG> bool staged(KS k_staged, KG k_global, int s_total, int elem, long long extra) {
  const long long bytes = static_cast<long long>(elem) * 4 * s_total + extra;
  return bytes <= kMaxSharedBytes && resident_blocks(k_staged, bytes) >= resident_blocks(k_global, extra);
}

template <typename T, typename K, typename... Args>
int launch_one(K kernel, long long smem, cudaStream_t stream, int n, Args... args) {
  if (const int err = opt_in(kernel, smem)) return err;
  kernel<<<blocks_for(n), kThreads, static_cast<int>(smem), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

// smooth_nearest_parts' skip: the launcher takes it from
// kNearestSkipMinCheap cheap-tier spheres on (skip = -1), or as the caller
// forces it (0 off, 1 on: the card check and the A/B time both sides;
// ops/smooth_parts.py NEAREST_SKIP_MIN_CHEAP), as clear_fwd's.
constexpr int kNearestSkipMinCheap = 16;

template <typename T, bool kSkip>
int launch_nearest_as(const T* o, const T* d, const T* geom, T* t, int* idx, T* solw, T* discw, T* dmax, int* fidx,
                      T* solf, int n, int s_cheap, int s_total, T faraway, cudaStream_t st) {
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  if (staged(smooth_nearest_parts<T, true, kSkip>, smooth_nearest_parts<T, false, kSkip>, s_total, sizeof(T), 0)) {
    return launch_one<T>(smooth_nearest_parts<T, true, kSkip>, geom_bytes, st, n, o, d, geom, t, idx, solw, discw,
                         dmax, fidx, solf, n, s_cheap, s_total, faraway);
  }
  return launch_one<T>(smooth_nearest_parts<T, false, kSkip>, 0, st, n, o, d, geom, t, idx, solw, discw, dmax, fidx,
                       solf, n, s_cheap, s_total, faraway);
}

template <typename T>
int launch_nearest(const T* o, const T* d, const T* geom, T* t, int* idx, T* solw, T* discw, T* dmax, int* fidx,
                   T* solf, int n, int s_cheap, int s_total, T faraway, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total) || skip < -1 || skip > 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (skip < 0 ? s_cheap >= kNearestSkipMinCheap : skip == 1)
             ? launch_nearest_as<T, true>(o, d, geom, t, idx, solw, discw, dmax, fidx, solf, n, s_cheap, s_total,
                                          faraway, st)
             : launch_nearest_as<T, false>(o, d, geom, t, idx, solw, discw, dmax, fidx, solf, n, s_cheap, s_total,
                                           faraway, st);
}

// Resident blocks per SM of the smooth_nearest_parts instantiation (skip) a
// launch for s_total spheres takes (staged or global geometry).
template <typename T, bool kSkip> int nearest_blocks_per_sm(int s_total) {
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  return staged(smooth_nearest_parts<T, true, kSkip>, smooth_nearest_parts<T, false, kSkip>, s_total, sizeof(T), 0)
             ? resident_blocks(smooth_nearest_parts<T, true, kSkip>, geom_bytes)
             : resident_blocks(smooth_nearest_parts<T, false, kSkip>, 0);
}

// clear_fwd's skip: the launcher takes it from kClearSkipMinCheap cheap-tier
// spheres on (skip = -1), or as the caller forces it (0 off, 1 on: the card
// check and the A/B time both sides; ops/smooth_parts.py
// CLEAR_SKIP_MIN_CHEAP).
constexpr int kClearSkipMinCheap = 16;

template <typename T, bool kSkip>
int launch_clear_fwd_as(const T* o, const T* d, const T* geom, const int* self_idx, T* clear, int n, int s_cheap,
                        int s_total, T faraway, T sharpness, const T* light, cudaStream_t st) {
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  if (staged(clear_fwd<T, true, kSkip>, clear_fwd<T, false, kSkip>, s_total, sizeof(T), 0)) {
    return launch_one<T>(clear_fwd<T, true, kSkip>, geom_bytes, st, n, o, d, geom, self_idx, clear, n, s_cheap,
                         s_total, faraway, sharpness, light);
  }
  return launch_one<T>(clear_fwd<T, false, kSkip>, 0, st, n, o, d, geom, self_idx, clear, n, s_cheap, s_total,
                       faraway, sharpness, light);
}

template <typename T>
int launch_clear_fwd(const T* o, const T* d, const T* geom, const int* self_idx, T* clear, int n, int s_cheap,
                     int s_total, T faraway, T sharpness, const T* light, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total) || skip < -1 || skip > 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (skip < 0 ? s_cheap >= kClearSkipMinCheap : skip == 1)
             ? launch_clear_fwd_as<T, true>(o, d, geom, self_idx, clear, n, s_cheap, s_total, faraway, sharpness,
                                            light, st)
             : launch_clear_fwd_as<T, false>(o, d, geom, self_idx, clear, n, s_cheap, s_total, faraway, sharpness,
                                             light, st);
}

// Resident blocks per SM of the clear_fwd instantiation (skip) a launch for
// s_total spheres takes (staged or global geometry), at its shared bytes.
template <typename T, bool kSkip> int clear_fwd_blocks_per_sm(int s_total) {
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  return staged(clear_fwd<T, true, kSkip>, clear_fwd<T, false, kSkip>, s_total, sizeof(T), 0)
             ? resident_blocks(clear_fwd<T, true, kSkip>, geom_bytes)
             : resident_blocks(clear_fwd<T, false, kSkip>, 0);
}

// parts: scratch of (4 * s_total) x blocks_for(n) values; g_geom: (s_total, 4).
template <typename T>
int launch_clear_bwd(const T* o, const T* d, const T* geom, const int* self_idx, const T* clear, const T* g_clear,
                     T* go, T* gd, T* parts, T* g_geom, int n, int s_cheap, int s_total, T faraway, T sharpness,
                     void* stream) {
  if (bad_args(n, s_cheap, s_total)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const long long red_bytes = static_cast<long long>(sizeof(T)) * kWarps * kChunk * 4;
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  int err;
  if (staged(clear_bwd<T, true>, clear_bwd<T, false>, s_total, sizeof(T), red_bytes)) {
    err = launch_one<T>(clear_bwd<T, true>, geom_bytes + red_bytes, st, n, o, d, geom, self_idx, clear, g_clear, go,
                        gd, parts, n, s_cheap, s_total, faraway, sharpness);
  } else {
    err = launch_one<T>(clear_bwd<T, false>, red_bytes, st, n, o, d, geom, self_idx, clear, g_clear, go, gd, parts,
                        n, s_cheap, s_total, faraway, sharpness);
  }
  if (err != 0) return err;
  reduce_parts<T><<<4 * s_total, kReduceThreads, 0, st>>>(parts, g_geom, blocks_for(n));
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of the clear_bwd instantiation a launch for
// s_total spheres takes (staged or global geometry), at its shared bytes.
template <typename T> int clear_bwd_blocks_per_sm(int s_total) {
  const long long red_bytes = static_cast<long long>(sizeof(T)) * kWarps * kChunk * 4;
  const long long geom_bytes = static_cast<long long>(sizeof(T)) * 4 * s_total;
  return staged(clear_bwd<T, true>, clear_bwd<T, false>, s_total, sizeof(T), red_bytes)
             ? resident_blocks(clear_bwd<T, true>, geom_bytes + red_bytes)
             : resident_blocks(clear_bwd<T, false>, red_bytes);
}

}  // namespace

// Plain C entries, bound with ctypes (ops/smooth_parts.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch;
// prt_clear_bwd_blocks_per_sm_*, prt_clear_fwd_blocks_per_sm_* and
// prt_nearest_parts_blocks_per_sm_* report the kernels' resident blocks per
// SM.
extern "C" {

#define PRT_PARTS_ENTRIES(T, SUFFIX)                                                                               \
  int prt_smooth_nearest_parts_##SUFFIX(const T* o, const T* d, const T* geom, T* t, int* idx, T* solw, T* discw,  \
                                        T* dmax, int* fidx, T* solf, int n, int s_cheap, int s_total, T faraway,  \
                                        int skip, void* stream) {                                                \
    return launch_nearest<T>(o, d, geom, t, idx, solw, discw, dmax, fidx, solf, n, s_cheap, s_total, faraway,     \
                             skip, stream);                                                                      \
  }                                                                                                              \
  int prt_clear_fwd_##SUFFIX(const T* o, const T* d, const T* geom, const int* self_idx, T* clear, int n,          \
                             int s_cheap, int s_total, T faraway, T sharpness, const T* light, int skip,          \
                             void* stream) {                                                                     \
    return launch_clear_fwd<T>(o, d, geom, self_idx, clear, n, s_cheap, s_total, faraway, sharpness, light, skip, \
                               stream);                                                                          \
  }                                                                                                              \
  int prt_clear_bwd_##SUFFIX(const T* o, const T* d, const T* geom, const int* self_idx, const T* clear,           \
                             const T* g_clear, T* go, T* gd, T* parts, T* g_geom, int n, int s_cheap, int s_total, \
                             T faraway, T sharpness, void* stream) {                                              \
    return launch_clear_bwd<T>(o, d, geom, self_idx, clear, g_clear, go, gd, parts, g_geom, n, s_cheap, s_total,  \
                               faraway, sharpness, stream);                                                      \
  }

PRT_PARTS_ENTRIES(float, f32)
PRT_PARTS_ENTRIES(double, f64)

int prt_clear_bwd_blocks_per_sm_f32(int s_total) { return clear_bwd_blocks_per_sm<float>(s_total); }
int prt_clear_bwd_blocks_per_sm_f64(int s_total) { return clear_bwd_blocks_per_sm<double>(s_total); }
int prt_nearest_parts_blocks_per_sm_f32(int skip, int s_total) {
  return skip ? nearest_blocks_per_sm<float, true>(s_total) : nearest_blocks_per_sm<float, false>(s_total);
}
int prt_nearest_parts_blocks_per_sm_f64(int skip, int s_total) {
  return skip ? nearest_blocks_per_sm<double, true>(s_total) : nearest_blocks_per_sm<double, false>(s_total);
}
int prt_clear_fwd_blocks_per_sm_f32(int skip, int s_total) {
  return skip ? clear_fwd_blocks_per_sm<float, true>(s_total) : clear_fwd_blocks_per_sm<float, false>(s_total);
}
int prt_clear_fwd_blocks_per_sm_f64(int skip, int s_total) {
  return skip ? clear_fwd_blocks_per_sm<double, true>(s_total) : clear_fwd_blocks_per_sm<double, false>(s_total);
}

#undef PRT_PARTS_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
