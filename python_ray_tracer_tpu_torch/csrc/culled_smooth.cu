// Culled smooth-visibility kernels for Hopper (sm_90a), CUDA C++: the
// differentiable route of big scenes at big frames (BASELINE config 4's
// training step).
//
// Replaces the three TPU kernels of python_ray_tracer_tpu/ops/pallas_culled_smooth.py
// that trace_culled_smooth launches once each per bounce:
//   _near_kernel_cs (:154, launched at :357) -> near_cs
//       the smooth winner selectors over a tile's nearest list (strict
//       t < tmin, strict disc > dmax from -3e38, the exact tier always
//       swept), the winner's tier-matched quadratic, the hit point, the
//       normal and the shadow-relevance mask sval.  Forward only.
//   _fwd_kernel_cs  (:252, launched at :405) -> fwd_cs
//       one smooth bounce with the winner known (idx, hit) and the shadow
//       product over the tile's shadow list, less the factors of exactly 1;
//       the mirror or GGX continuation.
//   _bwd_kernel_cs  (:284, launched at :442) -> bwd_cs
//       its adjoint, Phase C over the same shadow list; ray gradients and
//       the table gradients (one deterministic second pass, reduce_cs).
// All three evaluate fwd_bounce/adjoint_bounce of smooth_math.cuh, the
// bounce of the unculled smooth kernels.  fwd_cs and bwd_cs have an atlas
// mode (kAtlas): fwd_cs also writes each image lane's flat texel id and dww,
// bwd_cs takes their cotangent g_dww; the glue composes the texels right
// after fwd_cs, in the bounce's ray order (ops/texture.py compose_texels).
// The plain PyTorch versions are in ops/culled_smooth.py (near_cs_plain,
// fwd_cs_plain, bwd_cs_plain); so is the glue that builds the lists
// (ops/culled.py candidate_lists).
//
// Exactness (pallas_culled_smooth.py:12-25): a sphere outside a tile's list
// has sig(sharp * x) == 0 in f32 on every lane of the tile (expf overflows,
// 1 / (1 + inf) == 0), so its shadow factor is exactly 1 and its gradient
// exactly 0.  That holds with IEEE expf only: never fast math, and the
// denormal sigmoids of x in about (-103, -87.3) are kept (no -ftz).  In f64
// a culled sphere's factor is 1 - ~1e-39, so the f64 route equals the
// culled plain version and JAX's culled route, not the unculled one.
//
// Layout: one thread per ray over the flat (3, N) order for near_cs and
// fwd_cs; a tile is tile_rays consecutive rays (4096 on the main path, 16
// CTAs of 256), so every lane of a warp loops the same list.  Only the
// geometry table (S, 4) and the consts row sit in shared memory (64 KB f32,
// 128 KB f64 at 4096 spheres, opted in above 48 KB); the winner's material
// row is read from global memory by index.
//
// bwd_cs: kBwdCtasPerTile CTAs of kBwdThreads threads share a tile (8 CTAs
// of 128 on the main path: 1,016 CTAs at 960x540, 4,056 at 1920x1080), each
// thread taking its rays in rounds of kBwdBatch.  Phase C, ~94% of the time
// of the one-CTA-a-tile kernel it replaces on an H100
// (benchmarks/bwd_cs_split.py),
// runs slot-outer over the tile's shadow list with the round's rays in
// registers: a sphere's four gradients are summed over a thread's rays, over
// its warp by one shuffle sum, over the CTA's warps in order in shared
// memory, and written to the CTA's own row every kChunk slots; a warp skips a
// sphere whose terms are exactly zero on all its lanes.  Phase F adds each
// distinct winner of a warp once (__match_any_sync; the peers summed in lane
// order), the warps in turn; Phase G sums in registers.  Each CTA owns one
// row: (S, 4) by shadow slot, (S, 15) by nearest slot, 16 constants, so the
// rows take (n_tiles * 8) * (19 S + 16) values, 316 MB in f32 at config 4 as
// before.  reduce_cs then sums each sphere's slots over every row in a fixed
// order (a tile's candidate ids are ascending: binary search).  No float
// atomics: two launches on the same inputs give bitwise-equal gradients.
//
// fwd_cs's shadow product (kSkip, SkipList): a pair whose factor is exactly 1
// is left out.  On config 4's lists sig(sharp_s disc) is exactly 0 on 98.6-
// 99.8% of the listed (ray, sphere) pairs (benchmarks/sweep_skip_ab.py), so
// each lane first computes the pair's quadratic and tests that (no exp, no
// division where it holds), and each warp bounds its 32 shadow lines (a ball
// of origins, a cone of directions, the light as apex) and skips the listed
// cheap-tier spheres no line comes within r_eff of (bundle_math.cuh
// line_reaches, with its rounding margin).  The order of the remaining
// factors is the list's, so clear is bitwise the full product's.  The
// launcher takes the skip unless the caller passes 0 (the card check and
// the A/B time both sides); smooth_fwd_step and the other kernels that
// share fwd_bounce compile as before (its kSkip is false there).
//
// near_cs's winner sweep (kSkip, winner_skip_list): the same warp bound,
// here of the bounce's rays with no apex, and the rule of smooth_fwd_step's
// sweep (smooth_math.cuh winner_reaches): a listed cheap-tier sphere that no
// half-line of the warp can hit (its t is faraway, which never wins) and
// whose disc cannot exceed m, the least of the warp's running dmax read at
// the start of each chunk of 32 list slots, changes no lane's (tmin, imin,
// dmax, idmax) under the strict compares, so the warp visits only the
// others, in the list's order, and (idx, hit, p, normal, sval) stay bitwise
// the skip-off build's.  While some lane's dmax is still the sentinel -3e38
// nothing is left out, so the list's first chunk is visited whole before
// the bound is built, and a list of at most 32 slots (the primary bounce's,
// ~7 a warp at config 4) runs as the skip-off build.  The candidates and the
// full-tier fallback are walked in chunks of their own, lane j reading slot
// j0 + j; the exact tier is always swept.  A warp whose lanes do not all run
// in one tile (tile_rays not a multiple of 32, the frame's last warp) visits
// every listed sphere and runs no warp collective.
//
// What bounds them on this card: per ray and listed sphere ~40 operations
// (a quadratic, two compares) in near_cs, ~120 in bwd_cs's Phase C, and in
// fwd_cs the pairs its skip keeps (the quadratic, and the whole pair only
// where a lane's sigmoid is not 0), plus the BRDF and its adjoint per ray,
// against 60-150 B of state per ray: bound by operations once a list holds
// more than a few spheres.  With its skip near_cs pays one test a (warp,
// listed sphere) pair (~96 operations for one lane, 32 spheres a ballot)
// and the quadratic only on the pairs the rule keeps: on config 4's smooth
// step it keeps 96 / 49 / 60% of the listed (warp, slot) pairs, bounce by
// bounce, and runs 1.0 / 1.4 / 1.3x the skip-off build (an H100).  Its skip
// builds take 48 registers in f32 (39 without; 5 CTAs of 256 an SM at 1024
// spheres against 6) and 80 in f64 (56; 3 against 4), no spills (ptxas -v).

#include "bundle_math.cuh"
#include "smooth_math.cuh"

namespace {

constexpr int kThreads = 256;  // near_cs and fwd_cs: one thread a ray
constexpr int kMatGrads = 15;  // material columns CX..TFI that take gradients
constexpr int kReduceThreads = 256;

// The spheres a tile visits: its candidate ids (ascending), then its
// full-tier fallback 0..nf-1, then the exact tier.  visit() calls
// fn(slot, k) in that order.
struct TileList {
  const int* row;
  int nc, nf;

  template <typename T, typename F> __device__ __forceinline__ void visit(const Scal<T>& sc, F&& fn) const {
    int slot = 0;
    for (int j = 0; j < nc; ++j) fn(slot++, __ldg(row + j));
    for (int k = 0; k < nf; ++k) fn(slot++, k);
    for (int k = sc.s_cheap; k < sc.s_total; ++k) fn(slot++, k);
  }
};

// Tile t's list, its counts clamped to the row and the cheap tier.
__device__ __forceinline__ TileList tile_list(const int* cand, const int* cnt, const int* cnt_full, int tile,
                                              int stride, int s_cheap) {
  return {cand + static_cast<long long>(tile) * stride, min(max(cnt[tile], 0), stride),
          min(max(cnt_full[tile], 0), s_cheap)};
}

// fwd_cs's shadow set with the skip: the tile's list in TileList's order,
// less the pairs whose factor is exactly 1 (smooth_math.cuh shadow_fold, per
// lane).  Where the warp's lanes all run (warp_full), the warp also bounds
// its 32 shadow lines (a ball of origins, a cone of directions, the light as
// apex; bundle_math.cuh) and tests each listed cheap-tier sphere once, one
// lane a sphere, 32 under a ballot: a sphere no line comes within r_eff of
// (r_eff^2 = r^2 + |SigEdge lo| / (4 sharp_s), line_reaches) has sig(sharp_s
// disc) exactly 0 on every lane, and the warp visits only the others, in
// the list's order.  The exact tier is always visited.
template <typename T> struct SkipList {
  TileList list;
  T* slot;         // the warp's bundle slot (kBundleValues values)
  bool warp_full;  // every lane of the warp runs, in one tile

  __device__ __forceinline__ T product(const V3<T>& p_n, const V3<T>& L, int idx, const T* geom, const T* cst,
                                       const Scal<T>& sc) const {
    const bool finite = sc.sharp_s - sc.sharp_s == T(0);
    T clear = T(1);
    auto fold = [&](int k) {
      if (k < sc.s_cheap) {
        shadow_fold<false>(k, p_n, L, idx, geom, sc, finite, clear);
      } else {
        shadow_fold<true>(k, p_n, L, idx, geom, sc, finite, clear);
      }
    };
    if (!warp_full) {
      list.visit(sc, [&](int, int k) { fold(k); });
      return clear;
    }
    const V3<T> light = {cst[3], cst[4], cst[5]};
    const Bundle<T> b = finite && sc.sharp_s > T(0) ? warp_bundle(p_n, L, light, slot) : Bundle<T>{slot, false, false};
    const T edge = T(-SigEdge<T>::lo) / (T(4) * sc.sharp_s);
    const int lane = static_cast<int>(threadIdx.x & 31u);
    for (int j0 = 0; j0 < list.nc; j0 += kWarp) {  // the candidates, lane j reading j0 + j
      const int j = j0 + lane;
      const int k = j < list.nc ? __ldg(list.row + j) : 0;
      const unsigned reached = __ballot_sync(
          kFullWarp, j < list.nc && (!b.ok || k >= sc.s_cheap || line_reaches(b, geom + 4 * k, edge)));
      for (unsigned m = reached; m != 0u; m &= m - 1u) fold(__shfl_sync(kFullWarp, k, __ffs(static_cast<int>(m)) - 1));
    }
    for (int k0 = 0; k0 < list.nf; k0 += kWarp) {  // the full-tier fallback
      const int k = k0 + lane;
      const unsigned reached = __ballot_sync(kFullWarp, k < list.nf && (!b.ok || line_reaches(b, geom + 4 * k, edge)));
      for (unsigned m = reached; m != 0u; m &= m - 1u) fold(k0 + __ffs(static_cast<int>(m)) - 1);
    }
    for (int k = sc.s_cheap; k < sc.s_total; ++k) fold(k);
    return clear;
  }
};

// near_cs's winner sweep over a tile's list with the skip: after the list's
// first chunk the warp bounds its rays (no apex; slot its bundle) and walks
// the rest of the candidates, then of the full-tier fallback, in chunks of
// 32 slots (one lane a slot, under a ballot), calling take(k) for the
// spheres winner_reaches keeps against the warp's least running dmax (which
// take updates), in the list's order; a sphere left out is a miss whose disc
// is at most every lane's dmax.  A candidate id outside the cheap tier is
// always kept.  The exact tier is always visited.  A warp that is not
// warp_full (some lane does not run, or its lanes span two tiles, whose
// lists differ) visits every listed sphere and runs no warp collective; a
// warp without a usable bound keeps every listed sphere.
template <typename T, typename F>
__device__ __forceinline__ void winner_skip_list(const V3<T>& o, const V3<T>& d, const TileList& list, const T* geom,
                                                 const Scal<T>& sc, T* slot, bool warp_full, const T& dmax, F&& take) {
  if (!warp_full) {
    list.visit(sc, [&](int, int k) { take(k); });
    return;
  }
  // The list's first chunk is visited whole, with no bound: every lane's dmax
  // is still the sentinel there, and winner_reaches keeps every sphere.
  int j0 = min(list.nc, kWarp);
  int k0 = list.nc > 0 ? 0 : min(list.nf, kWarp);
  for (int j = 0; j < j0; ++j) take(__ldg(list.row + j));
  for (int k = 0; k < k0; ++k) take(k);
  if (j0 < list.nc || k0 < list.nf) {  // uniform over the warp: one tile
    const V3<T> no_apex = {quiet_nan<T>(), quiet_nan<T>(), quiet_nan<T>()};
    const Bundle<T> b = warp_bundle(o, d, no_apex, slot);
    const int lane = static_cast<int>(threadIdx.x & 31u);
    for (; j0 < list.nc; j0 += kWarp) {  // the candidates, lane j reading j0 + j
      const int j = j0 + lane;
      const int k = j < list.nc ? __ldg(list.row + j) : 0;
      const T m = warp_min(dmax);
      const unsigned reached = __ballot_sync(
          kFullWarp, j < list.nc && (!b.ok || k >= sc.s_cheap || winner_reaches(b, geom + 4 * k, m)));
      for (unsigned mm = reached; mm != 0u; mm &= mm - 1u) take(__shfl_sync(kFullWarp, k, __ffs(static_cast<int>(mm)) - 1));
    }
    for (; k0 < list.nf; k0 += kWarp) {  // the full-tier fallback
      const int k = k0 + lane;
      const T m = warp_min(dmax);
      const unsigned reached = __ballot_sync(kFullWarp, k < list.nf && (!b.ok || winner_reaches(b, geom + 4 * k, m)));
      for (unsigned mm = reached; mm != 0u; mm &= mm - 1u) take(k0 + __ffs(static_cast<int>(mm)) - 1);
    }
  }
  for (int k = sc.s_cheap; k < sc.s_total; ++k) take(k);
}

// Stage the geometry table and the consts row in dynamic shared memory;
// every thread of the block takes part, before any leaves.
template <typename T> __device__ __forceinline__ T* stage_geom_consts(const T* geom, const T* cst, int s_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  for (int i = threadIdx.x; i < 4 * s_total; i += blockDim.x) s[i] = geom[i];
  for (int i = threadIdx.x; i < kNConst; i += blockDim.x) s[4 * s_total + i] = cst[i];
  __syncthreads();
  return s;
}

// kSkip: the winner sweep leaves out the listed spheres that cannot change
// any lane's winner (winner_skip_list).
template <typename T, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    near_cs(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
            const T* __restrict__ alive, const int* __restrict__ cand, const int* __restrict__ cnt,
            const int* __restrict__ cnt_full, const T* __restrict__ geom, int* __restrict__ idx_out,
            T* __restrict__ hit_out, T* __restrict__ p_out, T* __restrict__ n_out, T* __restrict__ sval_out, int n,
            int tile_rays, int cand_stride, Scal<T> sc) {
  const T* s_geom = stage_geom(geom, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && tile_rays % kWarp == 0 && __all_sync(kFullWarp, i < n);
  if (i >= n) return;
  const V3<T> ro = load3(o, n, i);
  const V3<T> rd = load3(d, n, i);
  const TileList list = tile_list(cand, cnt, cnt_full, static_cast<int>(i / tile_rays), cand_stride, sc.s_cheap);

  // The unculled sweep's winner selectors over the list: a true hit is
  // always listed (the inflated radius), and a sphere off the both-nappes
  // list has sig(sharp_e disc) == 0 on every lane, so the max-disc fallback
  // can differ only where the lane's coverage is exactly zero either way.
  T tmin = sc.faraway;
  int imin = 0;
  T dmax = T(kNegBig);
  int idmax = 0;
  auto take = [&](int k) {
    T sol, disc, t, b, ct;
    sphere_quad(k, sc, ro, rd, s_geom, sol, disc, t, b, ct);
    if (t < tmin) {  // strict: lowest index wins exact ties
      tmin = t;
      imin = k;
    }
    if (disc > dmax) {  // strict: lowest index on disc ties
      dmax = disc;
      idmax = k;
    }
  };
  if constexpr (kSkip) {
    __shared__ T s_bundles[kBundleValues * (kThreads / kWarp)];
    winner_skip_list(ro, rd, list, s_geom, sc, s_bundles + kBundleValues * (threadIdx.x / kWarp), warp_full, dmax,
                     take);
  } else {
    list.visit(sc, [&](int, int k) { take(k); });
  }
  const bool hit = tmin != sc.faraway;
  const int idx = hit ? imin : idmax;

  // The winner's tier-matched quadratic: the values fwd_cs recomputes; here
  // they feed the hit point, the normal and the exact zero-coverage gate.
  const T* g = s_geom + 4 * idx;
  const V3<T> c_w = {g[0], g[1], g[2]};
  const T r_w = g[3];
  T b_w, ct_w;
  if (idx >= sc.s_cheap) {
    b_cterm_exact(ro, rd, c_w, r_w, b_w, ct_w);
  } else {
    b_cterm_plain(ro, rd, c_w, r_w, b_w, ct_w);
  }
  T sol_w, disc_w, t_w;
  quad_sol_disc(b_w, ct_w, sc.faraway, sol_w, disc_w, t_w);
  const T cov_w = sig(sc.sharp_e * disc_w) * sig(sc.sharp_e * sol_w);
  const T t_safe = hit ? sol_w : T(1);
  const T inv_r = T(1) / r_w;
  const V3<T> p = {ro.x + rd.x * t_safe, ro.y + rd.y * t_safe, ro.z + rd.z * t_safe};
  idx_out[i] = idx;
  hit_out[i] = hit ? T(1) : T(0);
  store3(p_out, n, i, p);
  store3(n_out, n, i, V3<T>{(p.x - c_w.x) * inv_r, (p.y - c_w.y) * inv_r, (p.z - c_w.z) * inv_r});
  // Lanes with exactly zero coverage or throughput contribute nothing,
  // forward or backward: leaving them out of the shadow bounds is exact.
  sval_out[i] = (cov_w > T(0) && thr[i] > T(0) && alive[i] > T(0)) ? T(1) : T(0);
}

// kSkip: the shadow product leaves out the factors of exactly 1 (SkipList).
template <typename T, bool kXi, bool kAtlas, bool kSkip>
__global__ void __launch_bounds__(kThreads)
    fwd_cs(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr, const T* __restrict__ alive,
           const T* __restrict__ acc, const int* __restrict__ idx, const T* __restrict__ hit,
           const int* __restrict__ cand, const int* __restrict__ cnt, const int* __restrict__ cnt_full,
           const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
           T* __restrict__ o_out, T* __restrict__ d_out, T* __restrict__ thr_out, T* __restrict__ alive_out,
           T* __restrict__ acc_out, T* __restrict__ clear_out, int* __restrict__ flat_out, T* __restrict__ dww_out,
           int n, int tile_rays, int cand_stride, Scal<T> sc) {
  const T* s_geom = stage_geom_consts(geom, cst, sc.s_total);
  const T* s_cst = s_geom + 4 * sc.s_total;
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && tile_rays % kWarp == 0 && __all_sync(kFullWarp, i < n);
  if (i >= n) return;
  const long long N = n;
  const TileList list = tile_list(cand, cnt, cnt_full, static_cast<int>(i / tile_rays), cand_stride, sc.s_cheap);
  Fwd<T> f;
  f.idx = idx[i];
  f.hit = hit[i] != T(0);
  const T xi1 = kXi ? xi[i] : T(0);
  const T xi2 = kXi ? xi[N + i] : T(0);
  if constexpr (kSkip) {
    __shared__ T s_bundles[kBundleValues * kThreads / kWarp];
    const SkipList<T> shadow = {list, s_bundles + kBundleValues * (threadIdx.x / kWarp), warp_full};
    fwd_bounce<T, kXi, Winner::kKnown, kAtlas, true>(f, load3(o, N, i), load3(d, N, i), thr[i], alive[i], s_geom, mat,
                                                     s_cst, sc, shadow, xi1, xi2);
  } else {
    fwd_bounce<T, kXi, Winner::kKnown, kAtlas>(f, load3(o, N, i), load3(d, N, i), thr[i], alive[i], s_geom, mat,
                                               s_cst, sc, list, xi1, xi2);
  }
  if constexpr (kAtlas) {
    flat_out[i] = f.flat;
    dww_out[i] = f.dww;
  }
  store3(acc_out, N, i, V3<T>{acc[i] + f.color.x * f.w, acc[N + i] + f.color.y * f.w, acc[2 * N + i] + f.color.z * f.w});
  store3(o_out, N, i, f.p_n);
  store3(d_out, N, i, f.dout);
  thr_out[i] = f.thr_out;
  alive_out[i] = f.coverage;
  clear_out[i] = f.clear;
}

// bwd_cs's layout (ops/culled_smooth.py mirrors these): kBwdCtasPerTile
// CTAs of kBwdThreads threads share a tile (its lists); CTA c of tile t
// takes rays t * tile_rays + c * tile_rays / kBwdCtasPerTile onwards, thread
// x of it rays x, x + kBwdThreads, ..., in rounds of kBwdBatch.
constexpr int kBwdThreads = 128;
constexpr int kBwdWarps = kBwdThreads / kWarp;
constexpr int kBwdCtasPerTile = 8;
constexpr int kBwdBatch = 4;
// Resident CTAs an SM that bwd_cs's launch bounds ask for: ptxas then caps
// its registers at 128 (236 uncapped in f32, 2 CTAs an SM), spilling ~0.8 KB
// a thread of the passes around Phase C; the faster trade on an H100
// (benchmarks/bwd_cs_split.py, variants nocap, min3 and min5).
constexpr int kBwdMinBlocks = 4;
constexpr int kChunk = kBwdThreads / 4;  // shadow slots a flush writes: one value a thread
// A round's Phase C state in shared memory, kBwdBatch x kBwdThreads of
// each: p_n (then Phase C's g_pn_s), L, g_clear * clear, g_L (Phase B's,
// then Phase C's), and the winner as an int after them.
enum BwdState { kPnX, kPnY, kPnZ, kLx, kLy, kLz, kGcc, kGLx, kGLy, kGLz, kBwdStateVals };
// Scratch shared by Phase C's flush (two buffers of kChunk slots x warps x
// 4), Phase F's exchange (kMatGrads x kWarp a warp) and Phase G's sums.
constexpr int kBwdScratch = kBwdWarps * kMatGrads * kWarp;
static_assert(2 * kChunk * kBwdWarps * 4 <= kBwdScratch && kBwdWarps * kAdjConsts <= kBwdScratch, "scratch");
static_assert(kMatGrads == kAdjMat, "Phase F's row");

template <typename T> int bwd_smem(int s_total) {
  return (4 * s_total + kNConst + kBwdStateVals * kBwdBatch * kBwdThreads + kBwdScratch) * static_cast<int>(sizeof(T))
         + kBwdBatch * kBwdThreads * static_cast<int>(sizeof(int));
}

// Slot of sphere k among a tile's candidates (ascending ids), or -1.
__device__ __forceinline__ int find_slot(const TileList& list, int k) {
  int lo = 0, hi = list.nc;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (__ldg(list.row + mid) < k) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo < list.nc && __ldg(list.row + lo) == k ? lo : -1;
}

// Where sphere k lies in a tile's visiting order: its candidate slot, else
// its full-tier slot, else its exact-tier slot; -1 if the list lacks it.
__device__ __forceinline__ int list_slot(const TileList& list, int k, int s_cheap) {
  if (k >= s_cheap) return list.nc + list.nf + (k - s_cheap);
  const int j = find_slot(list, k);
  return j >= 0 ? j : (k < list.nf ? list.nc + k : -1);
}

// Recompute ray i's bounce from its saved winner and shadow product and
// run Phases A-B of its adjoint.
template <typename T, bool kXi, bool kAtlas>
__device__ __forceinline__ AdjShade<T> bwd_shade(Fwd<T>& f, long long i, long long N, const T* o, const T* d,
                                                 const T* thr, const T* alive, const int* idx, const T* hit,
                                                 const T* clear, const T* s_geom, const T* mat, const T* s_cst,
                                                 const T* xi, const T* g_d_in, const T* g_thr_in, const T* g_alive_in,
                                                 const T* g_acc_in, const T* g_dww_in, const Scal<T>& sc,
                                                 const TileList& shadow) {
  f.idx = idx[i];
  f.hit = hit[i] != T(0);
  f.clear = clear[i];
  const T xi1 = kXi ? xi[i] : T(0);
  const T xi2 = kXi ? xi[N + i] : T(0);
  fwd_bounce<T, kXi, Winner::kSaved, kAtlas>(f, load3(o, N, i), load3(d, N, i), thr[i], alive[i], s_geom, mat, s_cst,
                                             sc, shadow, xi1, xi2);
  return adjoint_shade<T, kXi, kAtlas>(f, load3(g_d_in, N, i), g_thr_in[i], g_alive_in[i], load3(g_acc_in, N, i),
                                       s_cst, sc, kAtlas ? g_dww_in[i] : T(0));
}

// The adjoint of one culled bounce.  Per round of kBwdBatch rays a thread:
//   pass 1  recompute each ray's bounce and Phases A-B; keep what Phase C
//           reads in shared memory;
//   Phase C slot-outer over the tile's shadow list, the round's rays in
//           registers: each sphere's four gradients are summed over a
//           thread's rays, then over its warp (one shuffle sum a value),
//           then over the CTA's warps in order in shared memory, and every
//           kChunk slots written to the CTA's row;
//   pass 2  recompute each ray's bounce and Phases A-B again (bitwise the
//           same), take Phase C's sums and run Phases D-G.  Phase F: the
//           lanes of a warp that share a winner add their rows at their
//           lowest lane in lane order, which adds the sum into the winner's
//           slot (binary search) of the CTA's row, the warps in turn.
//           Phase G sums in registers over the thread's rays.
// The rows: one per CTA (pg (S, 4) by shadow slot, written whole over the
// list; pm (S, kMatGrads) by nearest slot, zeroed by the wrapper; pc
// (kNConst,), written whole).
template <typename T, bool kXi, bool kAtlas>
__global__ void __launch_bounds__(kBwdThreads, kBwdMinBlocks)
    bwd_cs(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr, const T* __restrict__ alive,
           const int* __restrict__ idx, const T* __restrict__ hit, const T* __restrict__ clear,
           const int* __restrict__ cand_b, const int* __restrict__ cnt_b, const int* __restrict__ cnt_bf,
           const int* __restrict__ cand_a, const int* __restrict__ cnt_a, const int* __restrict__ cnt_af,
           const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
           const T* __restrict__ g_o_in, const T* __restrict__ g_d_in, const T* __restrict__ g_thr_in,
           const T* __restrict__ g_alive_in, const T* __restrict__ g_acc_in, const T* __restrict__ g_dww_in,
           T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ g_thr_out, T* __restrict__ g_alive_out,
           T* __restrict__ pg, T* __restrict__ pm, T* __restrict__ pc, int n, int tile_rays, int cand_stride,
           Scal<T> sc) {
  T* const s_geom = stage_geom_consts(geom, cst, sc.s_total);
  const T* s_cst = s_geom + 4 * sc.s_total;
  T* state = s_geom + 4 * sc.s_total + kNConst;
  T* scratch = state + kBwdStateVals * kBwdBatch * kBwdThreads;
  int* s_idx = reinterpret_cast<int*>(scratch + kBwdScratch);
  const int x = threadIdx.x, lane = x % kWarp, warp = x / kWarp;
  const int tile = blockIdx.x / kBwdCtasPerTile;
  const long long N = n;
  const long long S = sc.s_total;
  T* row_g = pg + blockIdx.x * S * 4;
  T* row_m = pm + blockIdx.x * S * kMatGrads;
  T* row_c = pc + static_cast<long long>(blockIdx.x) * kNConst;
  const TileList near = tile_list(cand_a, cnt_a, cnt_af, tile, cand_stride, sc.s_cheap);
  const TileList shadow = tile_list(cand_b, cnt_b, cnt_bf, tile, cand_stride, sc.s_cheap);
  const int n_slots = shadow.nc + shadow.nf + (sc.s_total - sc.s_cheap);
  const int per_thread = tile_rays / (kBwdCtasPerTile * kBwdThreads);
  const long long first = static_cast<long long>(tile) * tile_rays
                          + static_cast<long long>(blockIdx.x % kBwdCtasPerTile) * (tile_rays / kBwdCtasPerTile) + x;
  auto st = [&](int v, int j) -> T& { return state[(v * kBwdBatch + j) * kBwdThreads + x]; };
  T g_consts[kAdjConsts];
  for (int c = 0; c < kAdjConsts; ++c) g_consts[c] = T(0);

  for (int r0 = 0; r0 < per_thread; r0 += kBwdBatch) {
    const int live = min(kBwdBatch, per_thread - r0);  // uniform over the CTA

    // Pass 1: what Phase C reads.
#pragma unroll 1
    for (int j = 0; j < live; ++j) {
      const long long i = first + static_cast<long long>(r0 + j) * kBwdThreads;
      Fwd<T> f;
      const AdjShade<T> a = bwd_shade<T, kXi, kAtlas>(f, i, N, o, d, thr, alive, idx, hit, clear, s_geom, mat, s_cst,
                                                      xi, g_d_in, g_thr_in, g_alive_in, g_acc_in, g_dww_in, sc, shadow);
      for (int c = 0; c < 3; ++c) {
        st(kPnX + c, j) = f.p_n[c];
        st(kLx + c, j) = f.L[c];
        st(kGLx + c, j) = a.g_L[c];
      }
      st(kGcc, j) = a.g_clear * f.clear;
      s_idx[j * kBwdThreads + x] = f.idx;
    }

    // Phase C, slot-outer over the round's rays.
    V3<T> pn[kBwdBatch], L[kBwdBatch], gpn[kBwdBatch], gL[kBwdBatch];
    T gcc[kBwdBatch];
    int wid[kBwdBatch];
#pragma unroll
    for (int j = 0; j < kBwdBatch; ++j) {
      if (j >= live) continue;
      for (int c = 0; c < 3; ++c) {
        pn[j][c] = st(kPnX + c, j);
        L[j][c] = st(kLx + c, j);
        gL[j][c] = st(kGLx + c, j);
        gpn[j][c] = T(0);
      }
      gcc[j] = st(kGcc, j);
      wid[j] = s_idx[j * kBwdThreads + x];
    }
    int buf = 0;
    shadow.visit(sc, [&](int slot, int k) {
      T part[4] = {T(0), T(0), T(0), T(0)};
      bool reached = false;  // uniform over the warp
#pragma unroll
      for (int j = 0; j < kBwdBatch; ++j) {
        if (j >= live) continue;
        // A warp whose lanes the sphere does not reach skips it: its terms
        // there are all exactly +-0, which leave every sum as it is.
        if (!__any_sync(0xffffffffu, shadow_reaches(k, pn[j], L[j], wid[j], s_geom, sc))) continue;
        reached = true;
        T gk[4];
        shadow_adjoint(k, pn[j], L[j], wid[j], gcc[j], s_geom, sc, gpn[j], gL[j], gk);
        for (int c = 0; c < 4; ++c) part[c] += gk[c];
      }
      T* red = scratch + buf * (kChunk * kBwdWarps * 4);
      for (int c = 0; c < 4; ++c) {
        const T s = reached ? warp_sum(part[c]) : T(0);
        if (lane == 0) red[((slot % kChunk) * kBwdWarps + warp) * 4 + c] = s;
      }
      if (slot % kChunk == kChunk - 1 || slot == n_slots - 1) {
        __syncthreads();
        const int base = slot - slot % kChunk;
        const int e = x / 4, c = x % 4;
        if (base + e <= slot) {
          T v = red[(e * kBwdWarps) * 4 + c];
          for (int w = 1; w < kBwdWarps; ++w) v += red[(e * kBwdWarps + w) * 4 + c];
          T& out = row_g[4 * static_cast<long long>(base) + x];
          out = r0 == 0 ? v : out + v;
        }
        buf ^= 1;
      }
    });
#pragma unroll
    for (int j = 0; j < kBwdBatch; ++j) {
      if (j >= live) continue;
      for (int c = 0; c < 3; ++c) {
        st(kPnX + c, j) = gpn[j][c];
        st(kGLx + c, j) = gL[j][c];
      }
    }
    __syncthreads();  // the last flush's reads of the scratch before Phase F's writes

    // Pass 2: Phases D-G.
#pragma unroll 1
    for (int j = 0; j < live; ++j) {
      const long long i = first + static_cast<long long>(r0 + j) * kBwdThreads;
      Fwd<T> f;
      AdjShade<T> a = bwd_shade<T, kXi, kAtlas>(f, i, N, o, d, thr, alive, idx, hit, clear, s_geom, mat, s_cst, xi,
                                                g_d_in, g_thr_in, g_alive_in, g_acc_in, g_dww_in, sc, shadow);
      V3<T> g_pn_s;
      for (int c = 0; c < 3; ++c) {
        g_pn_s[c] = st(kPnX + c, j);
        a.g_L[c] = st(kGLx + c, j);
      }
      V3<T> g_o = load3(g_o_in, N, i);
      V3<T> g_d = load3(g_d_in, N, i);
      T rows[kAdjMat], consts[kAdjConsts];
      adjoint_geometry(f, a, g_pn_s, g_o, g_d, rows, consts);
      store3(g_o_out, N, i, g_o);
      store3(g_d_out, N, i, g_d);
      g_thr_out[i] = a.g_thr_in;
      g_alive_out[i] = a.g_alive_in;
      for (int c = 0; c < kAdjConsts; ++c) g_consts[c] += consts[c];

      // Phase F: each distinct winner of the warp once.
      const unsigned peers = __match_any_sync(0xffffffffu, f.idx);
      const bool leader = __ffs(peers) - 1 == lane;
      T* ex = scratch + warp * (kMatGrads * kWarp);
      for (int c = 0; c < kMatGrads; ++c) ex[c * kWarp + lane] = rows[c];
      __syncwarp();
      T sum[kMatGrads];
      int slot = -1;
      if (leader) {
        for (int c = 0; c < kMatGrads; ++c) sum[c] = T(0);
        for (unsigned m = peers; m != 0; m &= m - 1) {
          const int p = __ffs(m) - 1;
          for (int c = 0; c < kMatGrads; ++c) sum[c] += ex[c * kWarp + p];
        }
        slot = list_slot(near, f.idx, sc.s_cheap);
      }
      for (int w = 0; w < kBwdWarps; ++w) {  // the warps in turn: one writer a slot
        if (w == warp && slot >= 0) {
          T* r = row_m + static_cast<long long>(kMatGrads) * slot;
          for (int c = 0; c < kMatGrads; ++c) r[c] += sum[c];
        }
        __syncthreads();
      }
    }
  }

  // Phase G: the CTA's sums of the scene constants, warps in order.
  for (int c = 0; c < kAdjConsts; ++c) {
    const T s = warp_sum(g_consts[c]);
    if (lane == 0) scratch[warp * kAdjConsts + c] = s;
  }
  __syncthreads();
  if (x < kNConst) {
    T v = T(0);
    if (x < kAdjConsts) {
      v = scratch[x];
      for (int w = 1; w < kBwdWarps; ++w) v += scratch[w * kAdjConsts + x];
    }
    row_c[x] = v;
  }
}

// Second pass, a fixed order: block k < S sums sphere k's geometry slots of
// every CTA's row, block S + k its material slots, block 2S the
// constants; each thread strides over the rows, then a shared-memory tree.
// out: geom (S, 4), then mat (S, 19) (columns past TFI zero), then consts 16.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_cs(const T* __restrict__ pg, const T* __restrict__ pm, const T* __restrict__ pc,
              const int* __restrict__ cand_b, const int* __restrict__ cnt_b, const int* __restrict__ cnt_bf,
              const int* __restrict__ cand_a, const int* __restrict__ cnt_a, const int* __restrict__ cnt_af,
              T* __restrict__ out, int n_tiles, int cand_stride, int s_cheap, int s_total) {
  __shared__ T red[kMatGrads + 1][kReduceThreads];
  const int b = blockIdx.x;
  const long long S = s_total;
  int n_vals, k = 0;
  const T* base;
  long long row_stride;
  const int *cand, *cnt, *cnt_full;
  if (b < s_total) {
    k = b, n_vals = 4, base = pg, row_stride = S * 4, cand = cand_b, cnt = cnt_b, cnt_full = cnt_bf;
  } else if (b < 2 * s_total) {
    k = b - s_total, n_vals = kMatGrads, base = pm, row_stride = S * kMatGrads, cand = cand_a, cnt = cnt_a,
    cnt_full = cnt_af;
  } else {
    n_vals = kNConst, base = pc, row_stride = kNConst, cand = nullptr, cnt = nullptr, cnt_full = nullptr;
  }
  T acc[kMatGrads + 1];
  for (int c = 0; c < kMatGrads + 1; ++c) acc[c] = T(0);
  const int n_rows = n_tiles * kBwdCtasPerTile;
  for (int r = threadIdx.x; r < n_rows; r += kReduceThreads) {
    const T* rowp = base + r * row_stride;
    if (!cand) {
      for (int c = 0; c < kNConst; ++c) acc[c] += rowp[c];
      continue;
    }
    const TileList list = tile_list(cand, cnt, cnt_full, r / kBwdCtasPerTile, cand_stride, s_cheap);
    int slots[2] = {-1, -1};  // where k sits: a candidate or a full-tier slot, or the exact tier
    if (k >= s_cheap) {
      slots[0] = list.nc + list.nf + (k - s_cheap);
    } else {
      slots[0] = find_slot(list, k);
      if (k < list.nf) slots[1] = list.nc + k;
    }
    for (int s = 0; s < 2; ++s) {
      if (slots[s] < 0) continue;
      for (int c = 0; c < n_vals; ++c) acc[c] += rowp[static_cast<long long>(slots[s]) * n_vals + c];
    }
  }
  for (int c = 0; c < n_vals; ++c) red[c][threadIdx.x] = acc[c];
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) {
      for (int c = 0; c < n_vals; ++c) red[c][threadIdx.x] += red[c][threadIdx.x + stride];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (b < s_total) {
    for (int c = 0; c < 4; ++c) out[4 * k + c] = red[c][0];
  } else if (b < 2 * s_total) {
    T* row = out + 4 * S + static_cast<long long>(kMatCols) * k;
    for (int c = 0; c < kMatCols; ++c) row[c] = c < kMatGrads ? red[c][0] : T(0);
  } else {
    for (int c = 0; c < kNConst; ++c) out[(4 + kMatCols) * S + c] = red[c][0];
  }
}

bool bad_args(int n, int s_cheap, int s_total, int tile_rays, int cand_stride) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total || tile_rays < 1 || cand_stride < 0;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T> int geom_consts_smem(int s_total) {
  return (4 * s_total + kNConst) * static_cast<int>(sizeof(T));
}

// fwd_cs's and near_cs's skip code, as the sweeps' (sweep_math.cuh Skip): -1
// the launcher's rule, 0 off, 1 on.  The rule takes the skip on every launch:
// the culled route's tables hold at least 96 spheres.
inline bool fwd_takes_skip(int skip) { return skip != 0; }

template <typename T> auto near_kernel(bool skip) { return skip ? near_cs<T, true> : near_cs<T, false>; }

template <typename T>
int launch_near(const T* o, const T* d, const T* thr, const T* alive, const int* cand, const int* cnt,
                const int* cnt_full, const T* geom, int* idx, T* hit, T* p, T* nrm, T* sval, int n, int s_cheap,
                int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) || skip < -1 || skip > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, T(0), s_cheap, s_total};
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  const auto kernel = near_kernel<T>(fwd_takes_skip(skip));
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, cand, cnt, cnt_full, geom, idx, hit, p, nrm, sval, n, tile_rays, cand_stride, sc);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of near_cs's instantiation (skip) at its launch's
// dynamic shared bytes for s_total spheres, or a negative CUDA error.
template <typename T> int near_blocks_per_sm(int skip, int s_total) {
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  const auto kernel = near_kernel<T>(skip != 0);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// KERNEL's instantiation for glossy (kXi) and ATLAS.
#define PRT_CS_KERNEL(KERNEL, GLOSSY, ATLAS)                                                          \
  ((GLOSSY) ? ((ATLAS) ? KERNEL<T, true, true> : KERNEL<T, true, false>)                             \
            : ((ATLAS) ? KERNEL<T, false, true> : KERNEL<T, false, false>))

// Launch KERNEL's instantiation for the xi pointer (null: the mirror) and
// ATLAS (null: no atlas).
#define PRT_CS_LAUNCH(KERNEL, ATLAS, GRID, THREADS, ...)                                             \
  [&]() {                                                                                            \
    const auto kernel = PRT_CS_KERNEL(KERNEL, xi, ATLAS);                                            \
    if (const int err = allow_smem(kernel, smem)) return err;                                        \
    kernel<<<GRID, THREADS, smem, st>>>(__VA_ARGS__);                                                \
    return static_cast<int>(cudaGetLastError());                                                     \
  }()

// fwd_cs's instantiation for glossy (kXi), atlas and skip.
template <typename T> auto fwd_kernel(bool glossy, bool atlas, bool skip) {
  if (skip) {
    return glossy ? (atlas ? fwd_cs<T, true, true, true> : fwd_cs<T, true, false, true>)
                  : (atlas ? fwd_cs<T, false, true, true> : fwd_cs<T, false, false, true>);
  }
  return glossy ? (atlas ? fwd_cs<T, true, true, false> : fwd_cs<T, true, false, false>)
                : (atlas ? fwd_cs<T, false, true, false> : fwd_cs<T, false, false, false>);
}

template <typename T>
int launch_fwd(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const int* idx, const T* hit,
               const int* cand, const int* cnt, const int* cnt_full, const T* geom, const T* mat, const T* cst,
               const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out, T* acc_out, T* clear_out, int* flat_out,
               T* dww_out, int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e,
               T sharp_s, int tex_h, int tex_w, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) ||
      (flat_out && (!dww_out || tex_h < 1 || tex_w < 1)) || skip < -1 || skip > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const int smem = geom_consts_smem<T>(s_total);
  const auto kernel = fwd_kernel<T>(xi != nullptr, flat_out != nullptr, fwd_takes_skip(skip));
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,
      acc_out, clear_out, flat_out, dww_out, n, tile_rays, cand_stride, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit, const T* clear,
               const int* cand_b, const int* cnt_b, const int* cnt_bf, const int* cand_a, const int* cnt_a,
               const int* cnt_af, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
               const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out,
               T* g_d_out, T* g_thr_out, T* g_alive_out, T* pg, T* pm, T* pc, T* flat, int n, int s_cheap,
               int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w,
               void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) || n % tile_rays ||
      tile_rays % (kBwdCtasPerTile * kBwdThreads) || (g_dww && (tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const int smem = bwd_smem<T>(s_total);
  const int n_tiles = n / tile_rays;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = PRT_CS_LAUNCH(bwd_cs, g_dww, n_tiles * kBwdCtasPerTile, kBwdThreads, o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf,
                                cand_a, cnt_a, cnt_af, geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_dww,
                                g_o_out, g_d_out, g_thr_out, g_alive_out, pg, pm, pc, n, tile_rays, cand_stride, sc);
  if (err) return err;
  reduce_cs<T><<<2 * s_total + 1, kReduceThreads, 0, st>>>(pg, pm, pc, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af,
                                                            flat, n_tiles, cand_stride, s_cheap, s_total);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM of bwd_cs's instantiation at its launch's dynamic
// shared bytes for s_total spheres, or a negative CUDA error.
template <typename T> int bwd_blocks_per_sm(int glossy, int atlas, int s_total) {
  const int smem = bwd_smem<T>(s_total);
  const auto kernel = PRT_CS_KERNEL(bwd_cs, glossy, atlas);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kBwdThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Resident blocks per SM of fwd_cs's instantiation (glossy, atlas, skip)
// at its launch's dynamic shared bytes for s_total spheres, or a negative
// CUDA error.
template <typename T> int fwd_blocks_per_sm(int glossy, int atlas, int skip, int s_total) {
  const int smem = geom_consts_smem<T>(s_total);
  const auto kernel = fwd_kernel<T>(glossy, atlas, skip);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

#undef PRT_CS_LAUNCH
#undef PRT_CS_KERNEL

}  // namespace

// Plain C entries, bound with ctypes (ops/culled_smooth.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.  xi may
// be null: the mirror instantiation; non-null launches the glossy one.
// prt_bwd_cs_blocks_per_sm_*, prt_fwd_cs_blocks_per_sm_* and
// prt_near_cs_blocks_per_sm_* report an instantiation's resident blocks per
// SM.
extern "C" {

#define PRT_CS_ENTRIES(T, SUFFIX)                                                                              \
  int prt_near_cs_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* cand,              \
                           const int* cnt, const int* cnt_full, const T* geom, int* idx, T* hit, T* p, T* nrm,  \
                           T* sval, int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway, \
                           T sharp_e, int skip, void* stream) {                                                \
    return launch_near<T>(o, d, thr, alive, cand, cnt, cnt_full, geom, idx, hit, p, nrm, sval, n, s_cheap,     \
                          s_total, tile_rays, cand_stride, faraway, sharp_e, skip, stream);                    \
  }                                                                                                            \
  int prt_near_cs_blocks_per_sm_##SUFFIX(int skip, int s_total) {                                              \
    return near_blocks_per_sm<T>(skip, s_total);                                                              \
  }                                                                                                            \
  int prt_fwd_cs_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const int* idx,  \
                          const T* hit, const int* cand, const int* cnt, const int* cnt_full, const T* geom,    \
                          const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out,              \
                          T* alive_out, T* acc_out, T* clear_out, int* tflat, T* dww, int n, int s_cheap,       \
                          int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, T sharp_s,         \
                          int tex_h, int tex_w, int skip, void* stream) {                                       \
    return launch_fwd<T>(o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat, cst, xi, o_out,      \
                         d_out, thr_out, alive_out, acc_out, clear_out, tflat, dww, n, s_cheap, s_total,        \
                         tile_rays, cand_stride, faraway, sharp_e, sharp_s, tex_h, tex_w, skip, stream);       \
  }                                                                                                            \
  int prt_bwd_cs_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit,   \
                          const T* clear, const int* cand_b, const int* cnt_b, const int* cnt_bf,               \
                          const int* cand_a, const int* cnt_a, const int* cnt_af, const T* geom, const T* mat,  \
                          const T* cst, const T* xi, const T* g_o, const T* g_d, const T* g_thr,                \
                          const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out, T* g_d_out,             \
                          T* g_thr_out, T* g_alive_out, T* pg, T* pm, T* pc, T* flat, int n, int s_cheap,       \
                          int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, T sharp_s,         \
                          int tex_h, int tex_w, void* stream) {                                                 \
    return launch_bwd<T>(o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af,      \
                         geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_dww, g_o_out, g_d_out,          \
                         g_thr_out, g_alive_out, pg, pm, pc, flat, n, s_cheap, s_total, tile_rays, cand_stride, \
                         faraway, sharp_e, sharp_s, tex_h, tex_w, stream);                                     \
  }                                                                                                            \
  int prt_bwd_cs_blocks_per_sm_##SUFFIX(int glossy, int atlas, int s_total) {                                  \
    return bwd_blocks_per_sm<T>(glossy, atlas, s_total);                                                      \
  }                                                                                                            \
  int prt_fwd_cs_blocks_per_sm_##SUFFIX(int glossy, int atlas, int skip, int s_total) {                        \
    return fwd_blocks_per_sm<T>(glossy, atlas, skip, s_total);                                                \
  }

PRT_CS_ENTRIES(float, f32)
PRT_CS_ENTRIES(double, f64)

#undef PRT_CS_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
