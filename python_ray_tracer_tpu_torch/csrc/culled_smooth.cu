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
//       product over the tile's shadow list; the mirror or GGX continuation.
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
// bwd_cs: one CTA per tile, each thread taking tile_rays / 256 rays in turn,
// so a tile's table gradients stay in the tile's own rows.  Each warp owns
// (S, 4) rows keyed by shadow-list slot, (S, 15) keyed by nearest-list slot
// (the winner lies in the tile's nearest list, its full-tier fallback or
// the exact tier, so Phase F loops that list, not the table) and 16
// constants; its lane 0 adds the warp's shuffle sum into them.  reduce_cs
// then sums each sphere's slots over every tile and warp in a fixed order
// (a tile's candidate ids are ascending: binary search).  No float atomics:
// two launches on the same inputs give bitwise-equal gradients.  The rows
// take (n_tiles * 8) * (19 S + 16) values: 316 MB in f32 at config 4.
//
// What bounds them on this card: per ray and listed sphere ~40 operations
// (a quadratic, two sigmoids) in near_cs and fwd_cs, ~120 in bwd_cs's
// Phase C, plus the BRDF and its adjoint per ray, against 60-150 B of state
// per ray: bound by operations once a list holds more than a few spheres.

#include "smooth_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarpsPerBlock = kThreads / kWarp;
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

template <typename T>
__global__ void __launch_bounds__(kThreads)
    near_cs(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
            const T* __restrict__ alive, const int* __restrict__ cand, const int* __restrict__ cnt,
            const int* __restrict__ cnt_full, const T* __restrict__ geom, int* __restrict__ idx_out,
            T* __restrict__ hit_out, T* __restrict__ p_out, T* __restrict__ n_out, T* __restrict__ sval_out, int n,
            int tile_rays, int cand_stride, Scal<T> sc) {
  const T* s_geom = stage_geom(geom, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
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
  list.visit(sc, [&](int, int k) {
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
  });
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

template <typename T, bool kXi, bool kAtlas>
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
  if (i >= n) return;
  const long long N = n;
  const TileList list = tile_list(cand, cnt, cnt_full, static_cast<int>(i / tile_rays), cand_stride, sc.s_cheap);
  Fwd<T> f;
  f.idx = idx[i];
  f.hit = hit[i] != T(0);
  const T xi1 = kXi ? xi[i] : T(0);
  const T xi2 = kXi ? xi[N + i] : T(0);
  fwd_bounce<T, kXi, Winner::kKnown, kAtlas>(f, load3(o, N, i), load3(d, N, i), thr[i], alive[i], s_geom, mat,
                                             s_cst, sc, list, xi1, xi2);
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

// adjoint_bounce's sink in bwd_cs: this warp's rows of its tile.  Every
// lane of the warp calls with the same slot (the tile's list is uniform
// across it); lane 0 adds the warp's sum, so no two threads write a row.
template <typename T> struct TileSink {
  T* pg;          // (S, 4): the shadow list's slots
  T* pm;          // (S, kMatGrads): the nearest list's slots
  T* pc;          // (kNConst,)
  TileList near;  // the tile's nearest list: where a lane's winner lies
  int lane;

  static __device__ __forceinline__ T warp_sum(T x) {
    for (int off = kWarp / 2; off > 0; off >>= 1) x += __shfl_down_sync(0xffffffffu, x, off);
    return x;
  }
  __device__ __forceinline__ void geom(int slot, int, int c, T x) const {
    const T s = warp_sum(x);
    if (lane == 0) pg[4 * slot + c] += s;
  }
  __device__ __forceinline__ void winner(const Scal<T>& sc, int idx, const T (&rows)[kMatGrads]) const {
    near.visit(sc, [&](int slot, int k) {
      const bool sel = idx == k;
      if (!__any_sync(0xffffffffu, sel)) return;  // warp-uniform skip
      for (int c = 0; c < kMatGrads; ++c) {
        const T s = warp_sum(sel ? rows[c] : T(0));
        if (lane == 0) pm[kMatGrads * slot + c] += s;
      }
    });
  }
  __device__ __forceinline__ void consts(const Scal<T>&, int c, T x) const {
    const T s = warp_sum(x);
    if (lane == 0) pc[c] += s;
  }
};

// One CTA per tile; thread t takes rays tile * tile_rays + r * 256 + t.
// The rows (pg, pm, pc) come zeroed.
template <typename T, bool kXi, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
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
  const T* s_geom = stage_geom_consts(geom, cst, sc.s_total);
  const T* s_cst = s_geom + 4 * sc.s_total;
  const int tile = blockIdx.x;
  const long long N = n;
  const int row = tile * kWarpsPerBlock + threadIdx.x / kWarp;
  const long long S = sc.s_total;
  TileSink<T> sink;
  sink.pg = pg + row * S * 4;
  sink.pm = pm + row * S * kMatGrads;
  sink.pc = pc + static_cast<long long>(row) * kNConst;
  sink.near = tile_list(cand_a, cnt_a, cnt_af, tile, cand_stride, sc.s_cheap);
  sink.lane = threadIdx.x % kWarp;
  const TileList shadow = tile_list(cand_b, cnt_b, cnt_bf, tile, cand_stride, sc.s_cheap);
  for (int r = threadIdx.x; r < tile_rays; r += kThreads) {
    const long long i = static_cast<long long>(tile) * tile_rays + r;
    Fwd<T> f;
    f.idx = idx[i];
    f.hit = hit[i] != T(0);
    f.clear = clear[i];
    const T xi1 = kXi ? xi[i] : T(0);
    const T xi2 = kXi ? xi[N + i] : T(0);
    fwd_bounce<T, kXi, Winner::kSaved, kAtlas>(f, load3(o, N, i), load3(d, N, i), thr[i], alive[i], s_geom, mat,
                                               s_cst, sc, shadow, xi1, xi2);
    V3<T> g_o = load3(g_o_in, N, i);
    V3<T> g_d = load3(g_d_in, N, i);
    T g_thr = g_thr_in[i], g_alive = g_alive_in[i];
    const T g_dww = kAtlas ? g_dww_in[i] : T(0);
    adjoint_bounce<T, kXi, kAtlas>(f, g_o, g_d, g_thr, g_alive, load3(g_acc_in, N, i), s_geom, s_cst, sc, shadow, sink,
                                   g_dww);
    store3(g_o_out, N, i, g_o);
    store3(g_d_out, N, i, g_d);
    g_thr_out[i] = g_thr;
    g_alive_out[i] = g_alive;
  }
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

// Second pass, a fixed order: block k < S sums sphere k's geometry slots of
// every (tile, warp) row, block S + k its material slots, block 2S the
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
  const int n_rows = n_tiles * kWarpsPerBlock;
  for (int r = threadIdx.x; r < n_rows; r += kReduceThreads) {
    const T* rowp = base + r * row_stride;
    if (!cand) {
      for (int c = 0; c < kNConst; ++c) acc[c] += rowp[c];
      continue;
    }
    const TileList list = tile_list(cand, cnt, cnt_full, r / kWarpsPerBlock, cand_stride, s_cheap);
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

template <typename T>
int launch_near(const T* o, const T* d, const T* thr, const T* alive, const int* cand, const int* cnt,
                const int* cnt_full, const T* geom, int* idx, T* hit, T* p, T* nrm, T* sval, int n, int s_cheap,
                int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, T(0), s_cheap, s_total};
  const int smem = 4 * s_total * static_cast<int>(sizeof(T));
  if (const int err = allow_smem(near_cs<T>, smem)) return err;
  near_cs<T><<<blocks_for(n), kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      o, d, thr, alive, cand, cnt, cnt_full, geom, idx, hit, p, nrm, sval, n, tile_rays, cand_stride, sc);
  return static_cast<int>(cudaGetLastError());
}

// Launch KERNEL's instantiation for the xi pointer (null: the mirror) and
// ATLAS (null: no atlas).
#define PRT_CS_LAUNCH(KERNEL, ATLAS, GRID, ...)                                                      \
  [&]() {                                                                                            \
    const auto kernel = xi ? (ATLAS ? KERNEL<T, true, true> : KERNEL<T, true, false>)                \
                           : (ATLAS ? KERNEL<T, false, true> : KERNEL<T, false, false>);             \
    if (const int err = allow_smem(kernel, smem)) return err;                                        \
    kernel<<<GRID, kThreads, smem, st>>>(__VA_ARGS__);                                               \
    return static_cast<int>(cudaGetLastError());                                                     \
  }()

template <typename T>
int launch_fwd(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const int* idx, const T* hit,
               const int* cand, const int* cnt, const int* cnt_full, const T* geom, const T* mat, const T* cst,
               const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out, T* acc_out, T* clear_out, int* flat_out,
               T* dww_out, int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e,
               T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) ||
      (flat_out && (!dww_out || tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const int smem = geom_consts_smem<T>(s_total);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return PRT_CS_LAUNCH(fwd_cs, flat_out, blocks_for(n), o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom,
                       mat, cst, xi, o_out, d_out, thr_out, alive_out, acc_out, clear_out, flat_out, dww_out, n,
                       tile_rays, cand_stride, sc);
}

template <typename T>
int launch_bwd(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit, const T* clear,
               const int* cand_b, const int* cnt_b, const int* cnt_bf, const int* cand_a, const int* cnt_a,
               const int* cnt_af, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
               const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out,
               T* g_d_out, T* g_thr_out, T* g_alive_out, T* pg, T* pm, T* pc, T* flat, int n, int s_cheap,
               int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w,
               void* stream) {
  if (bad_args(n, s_cheap, s_total, tile_rays, cand_stride) || n % tile_rays || tile_rays % kThreads ||
      (g_dww && (tex_h < 1 || tex_w < 1))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const int smem = geom_consts_smem<T>(s_total);
  const int n_tiles = n / tile_rays;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = PRT_CS_LAUNCH(bwd_cs, g_dww, n_tiles, o, d, thr, alive, idx, hit, clear, cand_b, cnt_b, cnt_bf,
                                cand_a, cnt_a, cnt_af, geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_dww,
                                g_o_out, g_d_out, g_thr_out, g_alive_out, pg, pm, pc, n, tile_rays, cand_stride, sc);
  if (err) return err;
  reduce_cs<T><<<2 * s_total + 1, kReduceThreads, 0, st>>>(pg, pm, pc, cand_b, cnt_b, cnt_bf, cand_a, cnt_a, cnt_af,
                                                            flat, n_tiles, cand_stride, s_cheap, s_total);
  return static_cast<int>(cudaGetLastError());
}

#undef PRT_CS_LAUNCH

}  // namespace

// Plain C entries, bound with ctypes (ops/culled_smooth.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.  xi may
// be null: the mirror instantiation; non-null launches the glossy one.
extern "C" {

#define PRT_CS_ENTRIES(T, SUFFIX)                                                                              \
  int prt_near_cs_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* cand,              \
                           const int* cnt, const int* cnt_full, const T* geom, int* idx, T* hit, T* p, T* nrm,  \
                           T* sval, int n, int s_cheap, int s_total, int tile_rays, int cand_stride, T faraway, \
                           T sharp_e, void* stream) {                                                          \
    return launch_near<T>(o, d, thr, alive, cand, cnt, cnt_full, geom, idx, hit, p, nrm, sval, n, s_cheap,     \
                          s_total, tile_rays, cand_stride, faraway, sharp_e, stream);                          \
  }                                                                                                            \
  int prt_fwd_cs_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const int* idx,  \
                          const T* hit, const int* cand, const int* cnt, const int* cnt_full, const T* geom,    \
                          const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out,              \
                          T* alive_out, T* acc_out, T* clear_out, int* tflat, T* dww, int n, int s_cheap,       \
                          int s_total, int tile_rays, int cand_stride, T faraway, T sharp_e, T sharp_s,         \
                          int tex_h, int tex_w, void* stream) {                                                 \
    return launch_fwd<T>(o, d, thr, alive, acc, idx, hit, cand, cnt, cnt_full, geom, mat, cst, xi, o_out,      \
                         d_out, thr_out, alive_out, acc_out, clear_out, tflat, dww, n, s_cheap, s_total,        \
                         tile_rays, cand_stride, faraway, sharp_e, sharp_s, tex_h, tex_w, stream);             \
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
  }

PRT_CS_ENTRIES(float, f32)
PRT_CS_ENTRIES(double, f64)

#undef PRT_CS_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
