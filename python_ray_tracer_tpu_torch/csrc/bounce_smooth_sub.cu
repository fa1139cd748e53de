// Smooth-visibility bounce kernels for Hopper (sm_90a), CUDA C++.
//
// Replaces five TPU kernels of python_ray_tracer_tpu/ops/pallas_bounce_smooth_sub.py:
//   _fwd_kernel_sub_deep   (:1329, launched at :1454) -> smooth_fwd_deep
//       the smooth bounce chain; writes acc and the per-depth residuals
//       (entering state, winner, hit, shadow clear) the adjoint replays.
//   _bwd_kernel_sub_deep   (:1370, launched at :1498) -> smooth_bwd_deep
//       replays each bounce from the residuals and runs the adjoint
//       (Phases A-G) in reverse depth order: ray and table gradients.
//   _train_kernel_sub_deep (:1799, launched at :1896) -> train_deep
//       forward chain, the L2 cotangent 2 (clip(acc) - tgt) clip'(acc), and
//       the reverse adjoint in one launch; the per-bounce replay state stays
//       in thread-local memory, nothing but gradients and the SSE leaves.
//   _fwd_kernel_sub        (:544, launched at :1159)  -> smooth_fwd_step
//       one bounce: the state (o, d, thr, alive, acc) in and out, plus the
//       residuals (idx, hit, clear); the depth-1 route and the scan route.
//   _bwd_kernel_sub        (:1040, launched at :1204) -> smooth_bwd_step
//       its adjoint: cotangents of all five outputs in, those of (o, d,
//       thr, alive) and the table gradients out; acc's passes through.
// The TPU kernels take 1-4096 spheres (past 256 in their blocked mode);
// above 4096 the JAX package runs the lane pair of
// python_ray_tracer_tpu/ops/pallas_bounce_smooth.py, _fwd_kernel (:346,
// launched at :773) and _bwd_kernel (:420, launched at :801), once per
// bounce: the same bounce up to float order, which smooth_fwd_step and
// smooth_bwd_step take over there.  None of the five has a sphere cap.
// All five share fwd_bounce() (the TPU kernels' _FwdSub, :227, unrolled
// mode) and adjoint_bounce() (_adjoint_bounce, :578) from smooth_math.cuh,
// with the winner swept or saved and every sphere in the shadow loops; the
// warp partials below are their sink.  Each is instantiated with the mirror
// continuation and with the stochastic glossy one (kXi; :497-538 forward,
// :610-657 adjoint), whose uniforms xi come from the wrapper on the JAX
// package's seed schedule.  All but train_deep (which the JAX package keeps
// off atlas scenes) also have an atlas mode (kAtlas): the forward kernels
// write each bounce's flat texel ids and dww weights, (depth, N) or (N,),
// the backward ones take their cotangent g_dww, and the wrapper composes
// the texels between the launches (ops/texture.py compose_texels).  The
// plain PyTorch versions are in ops/bounce_smooth_sub.py (fwd_sub_math,
// adjoint_bounce) and evaluate the same expressions in the same order.
//
// What bounds them on this card: per ray and bounce, S winner and S shadow
// quadratics (the exact tier ~4x the plain one), three sigmoids per sphere,
// the BRDF, and in the adjoint the shadow sweep once more with its
// quadratic adjoint; against a few tens of bytes per ray (rays in, acc or
// gradients out, plus 11 residual values per bounce for the fwd/bwd pair).
// That is far above the H100's ~20 FLOP/B f32 ridge: compute- and
// latency-bound, branchy, and with ~150 live values per bounce register
// pressure is the first limit.  The one-bounce pair is the exception by
// count at small tables: it moves the whole state per launch (100-120 B per
// ray) for one bounce's work, so its least time is set by the bytes.  The
// design follows from that, not from the TPU layout (neither the sublane
// packing nor the blocked mode's one-hot scatters and piecewise gathers,
// which fit Mosaic's VMEM and SMEM):
//   * one thread per ray over the (3, N) layout, ragged edge masked; no
//     (8, 128) packing and no padding;
//   * any table size.  The consts row sits in dynamic shared memory, and
//     so does the geometry (S, 4) while it takes at most kStageMaxBytes
//     (4096 spheres in f32, 2048 in f64; opted in above 48 KB); a warp's
//     sphere reads are then shared-memory broadcasts.  Larger geometry is
//     read from global memory through the read-only path (LdgGeom), every
//     lane of a warp on the same sphere, so each load is one broadcast from
//     L1.  Each kernel is built both ways (kStaged) and the launcher picks
//     by size, but smooth_bwd_step, which stages its geometry a chunk at a
//     time.  The winner's material row (19 values) is read from global
//     memory by index;
//   * sphere and depth loops are runtime loops: no TPU compile-size caps;
//   * table gradients without float atomics, in memory bounded in N.  In
//     smooth_bwd_deep and train_deep each warp owns one column of a
//     (values, cols) partials array (cols given by the caller, at most
//     ceil(N / 32); the wrapper's PARTIAL_COLS caps it), and walks the
//     ray-warps col, col + cols, ... in that order; for each, the warp sums
//     its lanes' contributions by a shuffle tree and lane 0 adds the sum
//     into its column; the partials take (23 S + 17) * cols values.
//     smooth_bwd_step skips the shadow spheres that reach none of a warp's
//     rays and sums the rest over its CTA in shared memory into one row a
//     CTA, (19 S + 16) values (see the kernel).  A second kernel sums the
//     columns or rows in a fixed order: two launches on the same inputs
//     give bitwise-equal gradients;
//   * smooth_fwd_step (kSkip, by the launch rule from kStepSkipMinCheap
//     cheap spheres) leaves out of its winner sweep and its shadow product
//     the cheap-tier spheres a warp's bounds show cannot change them
//     (smooth_math.cuh SkipAll): at 8192 spheres the two full sweeps took
//     96% of its time (benchmarks/smooth_fwd_split.py), and a warp's bounds
//     rule out most of their pairs; what is left is held by the warps whose
//     rays scatter too wide for a bound (PERF.md).  Its outputs stay
//     bitwise the full sweeps'.
//
// Numerics: smooth_math.cuh (no FMA contraction, the smooth split factor,
// the sigmoid's form, the tie rules); x**n for integer n is binary
// exponentiation (JAX integer_pow), 2.5 and 1.5 are pow; the L2 cotangent's
// clip gradient splits 0.5 at exact bounds (JAX).

#include <type_traits>

#include "smooth_math.cuh"

namespace {

constexpr int kMaxTrainDepth = 64;  // ops/bounce_smooth_sub.py MAX_TRAIN_DEPTH
constexpr int kThreads = 128;
constexpr int kWarpsPerBlock = kThreads / kWarp;
constexpr int kReduceThreads = 256;
// Geometry staged in shared memory up to this many bytes.  On an H100
// staging 64 KB (4096 f32 spheres) beat global reads by 2-15%; staging
// 128 KB left one block an SM and ran the kernels 1.3-2.7x slower than
// global reads (PERF.md, Findings).  64 KB leaves room for three
// blocks an SM, the gradient kernels' register limit in f32.
constexpr int kStageMaxBytes = 65536;

// Groups of 32 rays (ray-warps) of n rays.
__host__ __device__ __forceinline__ int ray_warps(int n) { return (n + kWarp - 1) / kWarp; }

// Warp-level partial sums of the table gradients: every lane of the warp
// calls this with the same value index (uniform control flow); lane 0 adds
// the warp's sum into the warp's own column.  Invalid lanes contribute zero.
template <typename T> struct Partials {
  T* parts;  // (n_vals, n_cols)
  int n_cols, col, lane;
  bool valid;

  __device__ __forceinline__ void add(int v, T x) const {
    T s = valid ? x : T(0);
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) parts[static_cast<long long>(v) * n_cols + col] += s;
  }

  // adjoint_bounce's sink (smooth_math.cuh): a shadow sphere's geometry
  // gradient, the winner's material row (one pass over every sphere a lane
  // of the warp won), a scene constant.
  __device__ __forceinline__ void geom(int, int k, int c, T x) const { add(v_geom(k, c), x); }
  __device__ __forceinline__ void winner(const Scal<T>& sc, int idx, const T (&rows)[15]) const {
    for (int k = 0; k < sc.s_total; ++k) {
      const bool sel = idx == k;
      if (!__any_sync(0xffffffffu, valid && sel)) continue;  // warp-uniform skip
      for (int c = 0; c < 15; ++c) add(v_mat(sc.s_total, k, c), sel ? rows[c] : T(0));
    }
  }
  __device__ __forceinline__ void consts(const Scal<T>& sc, int c, T x) const { add(v_const(sc.s_total, c), x); }

  // Value indices of the partials: geom (S, 4), then mat (S, 19), consts 16, SSE.
  static __device__ __forceinline__ int v_geom(int k, int c) { return 4 * k + c; }
  static __device__ __forceinline__ int v_mat(int s, int k, int c) { return 4 * s + kMatCols * k + c; }
  static __device__ __forceinline__ int v_const(int s, int c) { return (4 + kMatCols) * s + c; }
};

__device__ __forceinline__ int v_sse(int s) { return (4 + kMatCols) * s + kNConst; }

// The geometry as the kernels index it: staged in shared memory, or read
// from global memory (LdgGeom).
template <typename T, bool kStaged> using GeomOf = std::conditional_t<kStaged, const T*, LdgGeom<T>>;

template <typename T, bool kStaged> struct Tables {
  GeomOf<T, kStaged> geom;
  const T* cst;  // shared
};

// Copy the geometry (when staged) and the consts row into dynamic shared
// memory; every thread of the block takes part, so this comes before any
// thread leaves.
template <typename T, bool kStaged>
__device__ __forceinline__ Tables<T, kStaged> stage_tables(const T* geom, const T* cst, int s_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* s = reinterpret_cast<T*>(smem_raw);
  const int n_geom = kStaged ? 4 * s_total : 0;
  for (int i = threadIdx.x; i < n_geom; i += blockDim.x) s[i] = geom[i];
  for (int i = threadIdx.x; i < kNConst; i += blockDim.x) s[n_geom + i] = cst[i];
  __syncthreads();
  if constexpr (kStaged) {
    return {s, s + n_geom};
  } else {
    return {LdgGeom<T>{geom}, s};
  }
}

// The ray-warps of a gradient kernel's warp, in order: col, col + n_cols,
// ... (col is the warp's column of the partials).  fn(part, i) runs once per
// ray-warp with every lane: i is the lane's ray, or for lanes past the
// ragged edge a copy of the last ray (part.valid false: they contribute
// zero, and every warp reduction has all 32 lanes).
template <typename T, typename F>
__device__ __forceinline__ void for_ray_warps(T* parts, int n, int n_cols, F&& fn) {
  Partials<T> part;
  part.parts = parts;
  part.n_cols = n_cols;
  const int thread = blockIdx.x * blockDim.x + threadIdx.x;
  part.col = thread / kWarp;
  part.lane = thread % kWarp;
  const int n_ray_warps = ray_warps(n);
  if (part.col >= part.n_cols) return;  // the last block's spare warps
  for (int rw = part.col; rw < n_ray_warps; rw += part.n_cols) {  // warp-uniform
    const long long gi = static_cast<long long>(rw) * kWarp + part.lane;
    part.valid = gi < n;
    fn(part, part.valid ? gi : static_cast<long long>(n) - 1);
  }
}

// Bounce dep's uniforms from a (2 * depth, N) xi stack (zero when !kXi).
template <typename T, bool kXi>
__device__ __forceinline__ void load_xi(const T* xi, int dep, long long N, long long i, T& xi1, T& xi2) {
  xi1 = kXi ? xi[2 * dep * N + i] : T(0);
  xi2 = kXi ? xi[(2 * dep + 1) * N + i] : T(0);
}

template <typename T, bool kXi, bool kStaged, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ acc,
                    T* __restrict__ osave, T* __restrict__ dsave, T* __restrict__ thrsave,
                    T* __restrict__ alivesave, int* __restrict__ idx_out, T* __restrict__ hit_out,
                    T* __restrict__ clear_out, int* __restrict__ flat_out, T* __restrict__ dww_out, int n, int depth,
                    Scal<T> sc) {
  const Tables<T, kStaged> tb = stage_tables<T, kStaged>(geom, cst, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long N = n;
  V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T thr = T(1), alive = T(1);
  V3<T> a = {T(0), T(0), T(0)};
  Fwd<T> f;
  for (int dep = 0; dep < depth; ++dep) {
    if (dep > 0) {
      for (int c = 0; c < 3; ++c) {
        osave[(3 * (dep - 1) + c) * N + i] = ro[c];
        dsave[(3 * (dep - 1) + c) * N + i] = rd[c];
      }
      thrsave[(dep - 1) * N + i] = thr;
      alivesave[(dep - 1) * N + i] = alive;
    }
    T xi1, xi2;
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi, Winner::kSweep, kAtlas>(f, ro, rd, thr, alive, tb.geom, mat, tb.cst, sc, AllSpheres{}, xi1,
                                               xi2);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + f.color[c] * f.w;
    if constexpr (kAtlas) {
      flat_out[dep * N + i] = f.flat;
      dww_out[dep * N + i] = f.dww;
    }
    idx_out[dep * N + i] = f.idx;
    hit_out[dep * N + i] = f.hit ? T(1) : T(0);
    clear_out[dep * N + i] = f.clear;
    ro = f.p_n;
    rd = f.dout;
    thr = f.thr_out;
    alive = f.coverage;
  }
  for (int c = 0; c < 3; ++c) acc[c * N + i] = a[c];
}

// Reverse adjoint chain from the residuals, one ray-warp after another
// (for_ray_warps).
template <typename T, bool kXi, bool kStaged, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ osave,
                    const T* __restrict__ dsave, const T* __restrict__ thrsave,
                    const T* __restrict__ alivesave, const int* __restrict__ idx_in,
                    const T* __restrict__ hit_in, const T* __restrict__ clear_in, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    const T* __restrict__ g_acc_in, const T* __restrict__ g_dww_in,
                    T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n, int n_cols,
                    int depth, Scal<T> sc) {
  const Tables<T, kStaged> tb = stage_tables<T, kStaged>(geom, cst, sc.s_total);
  const long long N = n;
  for_ray_warps(parts, n, n_cols, [&](const Partials<T>& part, long long i) {
    const V3<T> g_acc = {g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]};
    V3<T> g_o = {T(0), T(0), T(0)}, g_d = {T(0), T(0), T(0)};
    T g_thr = T(0), g_alive = T(0);
    Fwd<T> f;
    for (int dep = depth - 1; dep >= 0; --dep) {
      V3<T> ro, rd;
      T thr, alive;
      if (dep == 0) {
        ro = {o[i], o[N + i], o[2 * N + i]};
        rd = {d[i], d[N + i], d[2 * N + i]};
        thr = T(1);
        alive = T(1);
      } else {
        for (int c = 0; c < 3; ++c) {
          ro[c] = osave[(3 * (dep - 1) + c) * N + i];
          rd[c] = dsave[(3 * (dep - 1) + c) * N + i];
        }
        thr = thrsave[(dep - 1) * N + i];
        alive = alivesave[(dep - 1) * N + i];
      }
      f.idx = idx_in[dep * N + i];
      f.hit = hit_in[dep * N + i] != T(0);
      f.clear = clear_in[dep * N + i];
      T xi1, xi2;
      load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
      fwd_bounce<T, kXi, Winner::kSaved, kAtlas>(f, ro, rd, thr, alive, tb.geom, mat, tb.cst, sc, AllSpheres{}, xi1,
                                                 xi2);
      const T g_dww = kAtlas ? g_dww_in[dep * N + i] : T(0);
      adjoint_bounce<T, kXi, kAtlas>(f, g_o, g_d, g_thr, g_alive, g_acc, tb.geom, tb.cst, sc, AllSpheres{}, part,
                                     g_dww);
    }
    if (part.valid) {
      for (int c = 0; c < 3; ++c) {
        g_o_out[c * N + i] = g_o[c];
        g_d_out[c * N + i] = g_d[c];
      }
    }
  });
}

// Replay state of one bounce, kept in thread-local memory by train_deep.
template <typename T> struct Replay {
  V3<T> o, d;
  T thr, alive, clear;
  int idx;
  bool hit;
};

template <typename T, bool kXi, bool kStaged>
__global__ void __launch_bounds__(kThreads)
    train_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ tgt,
               const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst,
               const T* __restrict__ xi, T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n,
               int n_cols, int depth, Scal<T> sc) {
  const Tables<T, kStaged> tb = stage_tables<T, kStaged>(geom, cst, sc.s_total);
  const long long N = n;
  for_ray_warps(parts, n, n_cols, [&](const Partials<T>& part, long long i) {
    Replay<T> saved[kMaxTrainDepth];
    V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
    V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
    T thr = T(1), alive = T(1);
    V3<T> a = {T(0), T(0), T(0)};
    Fwd<T> f;
    for (int dep = 0; dep < depth; ++dep) {
      T xi1, xi2;
      load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
      fwd_bounce<T, kXi, Winner::kSweep>(f, ro, rd, thr, alive, tb.geom, mat, tb.cst, sc, AllSpheres{}, xi1, xi2);
      for (int c = 0; c < 3; ++c) a[c] = a[c] + f.color[c] * f.w;
      saved[dep] = {ro, rd, thr, alive, f.clear, f.idx, f.hit};
      ro = f.p_n;
      rd = f.dout;
      thr = f.thr_out;
      alive = f.coverage;
    }

    // In-kernel L2 cotangent: sse = sum (clip(acc) - tgt)^2; the 1/(3N) of
    // the mean and the loss's upstream cotangent are applied by the caller.
    T sse = T(0);
    V3<T> g_acc;
    for (int c = 0; c < 3; ++c) {
      const T e = clip01(a[c]) - tgt[c * N + i];
      sse = sse + e * e;
      const T g_lo = T(0.5) * ((a[c] >= T(0) ? T(1) : T(0)) + (a[c] > T(0) ? T(1) : T(0)));
      const T y = vmax(a[c], T(0));
      const T g_hi = T(0.5) * ((y <= T(1) ? T(1) : T(0)) + (y < T(1) ? T(1) : T(0)));
      g_acc[c] = T(2) * e * (g_lo * g_hi);
    }
    part.add(v_sse(sc.s_total), sse);

    V3<T> g_o = {T(0), T(0), T(0)}, g_d = {T(0), T(0), T(0)};
    T g_thr = T(0), g_alive = T(0);
    for (int dep = depth - 1; dep >= 0; --dep) {
      const Replay<T>& r = saved[dep];
      f.idx = r.idx;
      f.hit = r.hit;
      f.clear = r.clear;
      T xi1, xi2;  // read again: the replay keeps no xi
      load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
      fwd_bounce<T, kXi, Winner::kSaved>(f, r.o, r.d, r.thr, r.alive, tb.geom, mat, tb.cst, sc, AllSpheres{}, xi1,
                                         xi2);
      adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, tb.geom, tb.cst, sc, AllSpheres{}, part);
    }
    if (part.valid) {
      for (int c = 0; c < 3; ++c) {
        g_o_out[c * N + i] = g_o[c];
        g_d_out[c * N + i] = g_d[c];
      }
    }
  });
}

// One smooth bounce per launch (_fwd_kernel_sub; above 4096 spheres the
// lane kernel _fwd_kernel of pallas_bounce_smooth.py): the state (o, d,
// thr, alive, acc) in, the next state and the bounce's residuals (idx, hit,
// clear) out.  kSkip: the winner sweep and the shadow product over SkipAll
// (smooth_math.cuh), which leave out the cheap-tier spheres that cannot
// change them; each warp's two bundles sit in the dynamic shared memory
// after the consts row (kStepBundleValues).  Every output stays bitwise the
// kernel's without the skip.
template <typename T, bool kXi, bool kStaged, bool kAtlas, bool kSkip = false>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const T* __restrict__ acc, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ o_out, T* __restrict__ d_out, T* __restrict__ thr_out,
                    T* __restrict__ alive_out, T* __restrict__ acc_out, int* __restrict__ idx_out,
                    T* __restrict__ hit_out, T* __restrict__ clear_out, int* __restrict__ flat_out,
                    T* __restrict__ dww_out, int n, Scal<T> sc) {
  const Tables<T, kStaged> tb = stage_tables<T, kStaged>(geom, cst, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool warp_full = kSkip && __all_sync(0xffffffffu, i < n);
  if (i >= n) return;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  if constexpr (kSkip) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* const slots = reinterpret_cast<T*>(smem_raw) + (kStaged ? 4 * sc.s_total : 0) + kNConst;
    const SkipAll<T> sets = {slots + 2 * kBundleValues * (threadIdx.x / kWarp), warp_full};
    fwd_bounce<T, kXi, Winner::kSweep, kAtlas, true>(f, ro, rd, thr[i], alive[i], tb.geom, mat, tb.cst, sc, sets, xi1,
                                                     xi2);
  } else {
    fwd_bounce<T, kXi, Winner::kSweep, kAtlas>(f, ro, rd, thr[i], alive[i], tb.geom, mat, tb.cst, sc, AllSpheres{},
                                               xi1, xi2);
  }
  if constexpr (kAtlas) {
    flat_out[i] = f.flat;
    dww_out[i] = f.dww;
  }
  for (int c = 0; c < 3; ++c) {
    acc_out[c * N + i] = acc[c * N + i] + f.color[c] * f.w;
    o_out[c * N + i] = f.p_n[c];
    d_out[c * N + i] = f.dout[c];
  }
  thr_out[i] = f.thr_out;
  alive_out[i] = f.coverage;
  idx_out[i] = f.idx;
  hit_out[i] = f.hit ? T(1) : T(0);
  clear_out[i] = f.clear;
}

// Its adjoint (_bwd_kernel_sub; above 4096 spheres _bwd_kernel): replays
// the bounce from its inputs and residuals, takes the cotangents of all
// five outputs and writes those of (o, d, thr, alive); acc's passes through
// and is the caller's.
//
// Layout (ops/bounce_smooth_sub.py mirrors these constants): a CTA takes
// kStepRayWarps ray-warps a round, each over kStepSplit warps that split
// its spheres; rows CTAs (at most kStepMaxRows) walk the ray-warps in
// rounds, CTA b taking ray-warps (r * rows + b) * kStepRayWarps + 0..3 in
// round r.  Each CTA owns one row of table gradients: geometry (S, 4) and
// constants 16 written whole, material (S, 15) added into (the wrapper
// zeroes it); reduce_rows sums the rows in a fixed order.  No float
// atomics, no read-modify-write of device memory in the sphere loop.
//   Phase C  a warp visits its slice of the spheres, chunks of kStepChunk
//            at a time, and passes a sphere that reaches no valid lane
//            (shadow_reaches: the winner, or a shadow sigmoid of exactly
//            0): its terms are all exactly +-0 there.  The test is the
//            loop's cost (~99.9% of warp-sphere pairs end there), so a
//            chunk's geometry is staged in shared memory by the CTA, the
//            next one read while this one runs (one value a thread,
//            coalesced), each tier is its own loop, the exact tier's
//            quadratic never predicated into the cheap tier's, and
//            kStepTests spheres are tested at once, independent chains
//            without a branch under one vote (the sigmoid itself runs only
//            where a lane sits on its zero edge).  A reached sphere's
//            four gradients are summed over the warp (one shuffle sum a
//            value) into a shared slot; at the end of each chunk the CTA
//            sums each sphere's slots over its ray-warps in order and
//            writes the row (added to it in later rounds; the same
//            thread each time).  Each ray's g_pn_s and g_L keep the
//            sphere order of the one-warp-a-ray-warp kernel; split over
//            kStepSplit warps, the slices' sums are added in slice order.
//   Phase F  each distinct winner of a warp once (__match_any_sync; the
//            peers summed in lane order), the ray-warps' warps in turn.
//   Phase G  sums in registers over a thread's rounds, then the warp and
//            the CTA's warps in order.
constexpr int kStepRayWarps = 4;
constexpr int kStepSplit = 1;
constexpr int kStepThreads = kStepRayWarps * kStepSplit * kWarp;
constexpr int kStepChunk = kWarp;
constexpr int kStepTests = 4;  // spheres tested at once in Phase C
constexpr int kStepMaxRows = 4096;
constexpr int kStepMat = kAdjMat;  // material columns CX..TFI that take gradients
// Shared scratch, reused phase by phase: Phase C's two buffers of
// (kStepSplit, kStepChunk, kStepRayWarps, 4) slots, the slices' Phase C
// sums (kStepRayWarps, kStepSplit, 6, kWarp), Phase F's exchange
// (kStepRayWarps, kStepMat, kWarp), Phase G's (warps, kAdjConsts).
constexpr int kStepRed = kStepSplit * kStepChunk * kStepRayWarps * 4;
constexpr int kStepScratch = cmax(cmax(2 * kStepRed, kStepRayWarps * kStepSplit * 6 * kWarp),
                                  cmax(kStepRayWarps * kStepMat * kWarp, kStepRayWarps * kStepSplit * kAdjConsts));
static_assert(kStepSplit * kStepChunk * 4 == kStepThreads, "a flush takes one value a thread");

// Phase C's view of the geometry: one group's chunks staged in shared
// memory, sphere k at p[4 (k - base) + c] (base: the warp's chunk's first).
template <typename T> struct ChunkGeom {
  const T* p;
  int base;
  __device__ __forceinline__ T operator[](int i) const { return p[i - 4 * base]; }
};

// Value x of group g's geometry chunks (thread x stages it): sphere
// (g kStepSplit + x / (4 kStepChunk)) kStepChunk + (x / 4) % kStepChunk,
// column x % 4; zero past the table.
template <typename T> __device__ __forceinline__ T chunk_value(const T* geom, int g, int groups, int s_total, int x) {
  const int k = (g * kStepSplit + x / (4 * kStepChunk)) * kStepChunk + (x / 4) % kStepChunk;
  return g < groups && k < s_total ? __ldg(geom + 4 * k + x % 4) : T(0);
}

template <typename T, bool kXi, bool kAtlas>
__global__ void __launch_bounds__(kStepThreads)
    smooth_bwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const int* __restrict__ idx, const T* __restrict__ hit,
                    const T* __restrict__ clear, const T* __restrict__ geom, const T* __restrict__ mat,
                    const T* __restrict__ cst, const T* __restrict__ xi, const T* __restrict__ g_o_in,
                    const T* __restrict__ g_d_in, const T* __restrict__ g_thr_in,
                    const T* __restrict__ g_alive_in, const T* __restrict__ g_acc_in,
                    const T* __restrict__ g_dww_in, T* __restrict__ g_o_out,
                    T* __restrict__ g_d_out, T* __restrict__ g_thr_out, T* __restrict__ g_alive_out,
                    T* __restrict__ pg, T* __restrict__ pm, T* __restrict__ pc, int n, int rows, Scal<T> sc) {
  // Only the consts row is staged whole: Phase C, the one reader of the
  // geometry, takes it a group of chunks at a time (chunks below).
  const Tables<T, false> tb = stage_tables<T, false>(geom, cst, sc.s_total);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const scratch = reinterpret_cast<T*>(smem_raw) + kNConst;
  T* const chunks = scratch + kStepScratch;  // two buffers of kStepThreads values
  const int x = threadIdx.x, lane = x % kWarp, warp = x / kWarp;
  const int rws = warp / kStepSplit, slice = warp % kStepSplit;  // ray-warp slot, sphere slice
  const long long N = n;
  const int S = sc.s_total;
  T* const row_g = pg + static_cast<long long>(blockIdx.x) * S * 4;
  T* const row_m = pm + static_cast<long long>(blockIdx.x) * S * kStepMat;
  T* const row_c = pc + static_cast<long long>(blockIdx.x) * kNConst;
  const int n_ray_warps = ray_warps(n);
  const int rounds = (n_ray_warps + rows * kStepRayWarps - 1) / (rows * kStepRayWarps);
  const int groups = ((S + kStepChunk - 1) / kStepChunk + kStepSplit - 1) / kStepSplit;
  T g_consts[kAdjConsts];
  for (int c = 0; c < kAdjConsts; ++c) g_consts[c] = T(0);

  for (int r = 0; r < rounds; ++r) {  // uniform over the CTA
    // Phase C's slots start at zero (the flushes keep them so; the phases
    // after Phase C reuse the scratch).
    for (int v = x; v < 2 * kStepRed; v += kStepThreads) scratch[v] = T(0);
    chunks[x] = chunk_value(geom, 0, groups, S, x);
    __syncthreads();
    const long long rw = (static_cast<long long>(r) * rows + blockIdx.x) * kStepRayWarps + rws;
    const long long gi = rw * kWarp + lane;
    const bool valid = gi < n;
    const long long i = valid ? gi : N - 1;  // past the edge: a copy of the last ray, adding zero
    const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
    const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
    T xi1, xi2;
    load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
    Fwd<T> f;
    f.idx = idx[i];
    f.hit = hit[i] != T(0);
    f.clear = clear[i];
    fwd_bounce<T, kXi, Winner::kSaved, kAtlas>(f, ro, rd, thr[i], alive[i], tb.geom, mat, tb.cst, sc, AllSpheres{},
                                               xi1, xi2);
    AdjShade<T> a = adjoint_shade<T, kXi, kAtlas>(f, V3<T>{g_d_in[i], g_d_in[N + i], g_d_in[2 * N + i]},
                                                  g_thr_in[i], g_alive_in[i],
                                                  V3<T>{g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]}, tb.cst,
                                                  sc, kAtlas ? g_dww_in[i] : T(0));

    // --- Phase C over this warp's slice, chunk by chunk ---
    const T g_cc = a.g_clear * f.clear;
    V3<T> g_pn_s = {T(0), T(0), T(0)};
    V3<T> g_L = slice == 0 ? a.g_L : V3<T>{T(0), T(0), T(0)};
    int buf = 0;
    for (int g = 0; g < groups; ++g) {
      const int k0 = (g * kStepSplit + slice) * kStepChunk;
      const int k1 = min(k0 + kStepChunk, S);
      const T next = chunk_value(geom, g + 1, groups, S, x);  // the next group's, read while this one runs
      const ChunkGeom<T> cg{chunks + buf * kStepThreads + slice * kStepChunk * 4, k0};
      T* red = scratch + buf * kStepRed;
      // The spheres [ka, kb) of one tier (kExact, known when compiled),
      // kStepTests at a time under one vote; a sphere that reaches no valid
      // lane of the warp is passed (its terms are all exactly +-0, which
      // leave every sum as it is), the others take Phase C in sphere order.
      // The test is shadow_reaches' without a branch where the answer is
      // sure: below the sigmoid's zero edge (SigEdge lo) the sphere is
      // passed, above it (hi) it reaches; only where a lane sits on the edge
      // (or at a NaN) does the sigmoid decide, under a vote of the warp.
      auto spheres = [&](auto exact, int ka, int kb) {
        for (int k = ka; k < kb; k += kStepTests) {
          T xs[kStepTests];
          unsigned reach = 0;  // bit j: sphere k + j reaches the lane
          bool edge = false;
#pragma unroll
          for (int j = 0; j < kStepTests; ++j) {
            const int kk = min(k + j, kb - 1);
            xs[j] = shadow_arg<decltype(exact)::value>(kk, f.p_n, f.L, cg, sc);
            const bool maybe = valid & (k + j < kb) & (f.idx != kk) & !(xs[j] < SigEdge<T>::lo);
            edge |= maybe & !(xs[j] > SigEdge<T>::hi);
            reach |= static_cast<unsigned>(maybe) << j;
          }
          if (__any_sync(0xffffffffu, edge)) {
#pragma unroll
            for (int j = 0; j < kStepTests; ++j) {
              if ((reach >> j & 1u) && !(xs[j] > SigEdge<T>::hi) && sig(xs[j]) == T(0)) reach &= ~(1u << j);
            }
          }
          if (!__any_sync(0xffffffffu, reach != 0)) continue;
          for (int j = 0; j < kStepTests && k + j < kb; ++j) {
            if (!__any_sync(0xffffffffu, reach >> j & 1u)) continue;
            T gk[4];
            shadow_adjoint(k + j, f.p_n, f.L, f.idx, g_cc, cg, sc, g_pn_s, g_L, gk);
            for (int c = 0; c < 4; ++c) {
              const T s = warp_sum(valid ? gk[c] : T(0));
              if (lane == 0) red[((slice * kStepChunk + (k + j - k0)) * kStepRayWarps + rws) * 4 + c] = s;
            }
          }
        }
      };
      spheres(std::false_type{}, k0, min(k1, sc.s_cheap));
      spheres(std::true_type{}, max(k0, sc.s_cheap), k1);
      chunks[(buf ^ 1) * kStepThreads + x] = next;  // the buffer the previous group read
      __syncthreads();
      // Thread x finishes value x % 4 of slot (x / 4) % kStepChunk of the
      // group's chunk x / (4 kStepChunk), and clears the slots it read.
      const int sl = x / (4 * kStepChunk), e = (x / 4) % kStepChunk, c = x % 4;
      const int k = (g * kStepSplit + sl) * kStepChunk + e;
      if (k < S) {
        T* slots = red + ((sl * kStepChunk + e) * kStepRayWarps) * 4 + c;
        T v = slots[0];
        slots[0] = T(0);
        for (int w = 1; w < kStepRayWarps; ++w) {
          v += slots[4 * w];
          slots[4 * w] = T(0);
        }
        T& out = row_g[4 * static_cast<long long>(k) + c];
        out = r == 0 ? v : out + v;
      }
      buf ^= 1;
    }
    __syncthreads();  // the last flush's reads of the scratch before its next use
    if (kStepSplit > 1) {  // the slices' sums, added in slice order
      T* mine = scratch + (rws * kStepSplit + slice) * 6 * kWarp + lane;
      for (int c = 0; c < 3; ++c) {
        mine[c * kWarp] = g_pn_s[c];
        mine[(3 + c) * kWarp] = g_L[c];
      }
      __syncthreads();
      if (slice == 0) {
        for (int s = 1; s < kStepSplit; ++s) {
          const T* other = scratch + (rws * kStepSplit + s) * 6 * kWarp + lane;
          for (int c = 0; c < 3; ++c) {
            g_pn_s[c] = g_pn_s[c] + other[c * kWarp];
            g_L[c] = g_L[c] + other[(3 + c) * kWarp];
          }
        }
      }
      __syncthreads();
    }

    // --- Phases D-G on the slice-0 warps ---
    T rows_f[kAdjMat];
    int key = -1;  // the lane's winner, -1 where it adds nothing
    if (slice == 0) {
      a.g_L = g_L;
      V3<T> g_o = {g_o_in[i], g_o_in[N + i], g_o_in[2 * N + i]};
      V3<T> g_d = {g_d_in[i], g_d_in[N + i], g_d_in[2 * N + i]};
      T consts[kAdjConsts];
      adjoint_geometry(f, a, g_pn_s, g_o, g_d, rows_f, consts);
      if (valid) {
        for (int c = 0; c < 3; ++c) {
          g_o_out[c * N + i] = g_o[c];
          g_d_out[c * N + i] = g_d[c];
        }
        g_thr_out[i] = a.g_thr_in;
        g_alive_out[i] = a.g_alive_in;
        for (int c = 0; c < kAdjConsts; ++c) g_consts[c] += consts[c];
        key = f.idx;
      }
    }
    // Phase F: each distinct winner of a warp once, at its lowest lane.
    T sum[kStepMat];
    bool leader = false;
    if (slice == 0) {
      const unsigned peers = __match_any_sync(0xffffffffu, key);
      leader = key >= 0 && __ffs(peers) - 1 == lane;
      T* ex = scratch + rws * (kStepMat * kWarp);
      for (int c = 0; c < kStepMat; ++c) ex[c * kWarp + lane] = rows_f[c];
      __syncwarp();
      if (leader) {
        for (int c = 0; c < kStepMat; ++c) sum[c] = T(0);
        for (unsigned m = peers; m != 0; m &= m - 1) {
          const int p = __ffs(m) - 1;
          for (int c = 0; c < kStepMat; ++c) sum[c] += ex[c * kWarp + p];
        }
      }
    }
    for (int t = 0; t < kStepRayWarps; ++t) {  // the ray-warps in turn: one writer a slot
      if (t == rws && leader) {
        T* rm = row_m + static_cast<long long>(kStepMat) * key;
        for (int c = 0; c < kStepMat; ++c) rm[c] += sum[c];
      }
      __syncthreads();
    }
  }

  // Phase G: the CTA's sums of the scene constants, warps in order (the
  // slice-0 warps hold them; the others add zeros).
  for (int c = 0; c < kAdjConsts; ++c) {
    const T s = warp_sum(g_consts[c]);
    if (lane == 0) scratch[warp * kAdjConsts + c] = s;
  }
  __syncthreads();
  if (x < kNConst) {
    T v = T(0);
    if (x < kAdjConsts) {
      v = scratch[x];
      for (int w = 1; w < kStepRayWarps * kStepSplit; ++w) v += scratch[w * kAdjConsts + x];
    }
    row_c[x] = v;
  }
}

// smooth_bwd_step's second pass, a fixed order: block k < S sums sphere k's
// geometry values over the rows, block S + k its material values, block 2S
// the constants; each thread strides over the rows, then a shared-memory
// tree.  out: geom (S, 4), mat (S, 19) (columns past TFI zero), consts 16.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_rows(const T* __restrict__ pg, const T* __restrict__ pm, const T* __restrict__ pc, T* __restrict__ out,
                int rows, int s_total) {
  __shared__ T red[kNConst][kReduceThreads];
  const int b = blockIdx.x;
  const long long S = s_total;
  int n_vals;
  const T* base;
  long long stride;
  if (b < s_total) {
    n_vals = 4, base = pg + 4 * static_cast<long long>(b), stride = 4 * S;
  } else if (b < 2 * s_total) {
    n_vals = kStepMat, base = pm + static_cast<long long>(kStepMat) * (b - s_total), stride = kStepMat * S;
  } else {
    n_vals = kNConst, base = pc, stride = kNConst;
  }
  T acc[kNConst];
  for (int c = 0; c < kNConst; ++c) acc[c] = T(0);
  for (int r = threadIdx.x; r < rows; r += kReduceThreads) {
    for (int c = 0; c < n_vals; ++c) acc[c] += base[r * stride + c];
  }
  for (int c = 0; c < n_vals; ++c) red[c][threadIdx.x] = acc[c];
  __syncthreads();
  for (int st = kReduceThreads / 2; st > 0; st >>= 1) {
    if (threadIdx.x < st) {
      for (int c = 0; c < n_vals; ++c) red[c][threadIdx.x] += red[c][threadIdx.x + st];
    }
    __syncthreads();
  }
  if (threadIdx.x != 0) return;
  if (b < s_total) {
    for (int c = 0; c < 4; ++c) out[4 * b + c] = red[c][0];
  } else if (b < 2 * s_total) {
    T* row = out + 4 * S + static_cast<long long>(kMatCols) * (b - s_total);
    for (int c = 0; c < kMatCols; ++c) row[c] = c < kStepMat ? red[c][0] : T(0);
  } else {
    for (int c = 0; c < kNConst; ++c) out[(4 + kMatCols) * S + c] = red[c][0];
  }
}

// Second pass: each block sums one value's row of column partials, in a
// fixed order (strided per thread, then a shared-memory tree).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const T* __restrict__ parts, T* __restrict__ out, int n_cols) {
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

bool bad_args(int n, int s_cheap, int s_total, int depth) {
  return n <= 0 || s_total < 1 || s_cheap < 0 || s_cheap > s_total || depth < 1;
}

// A gradient kernel's partials take 1 to ceil(n / 32) columns.
bool bad_cols(int n, int n_cols) { return n_cols < 1 || n_cols > ray_warps(n); }

// Is the geometry table staged in shared memory (else read from global)?
template <typename T> bool staged(int s_total) {
  return sizeof(T) * 4 * static_cast<size_t>(s_total) <= static_cast<size_t>(kStageMaxBytes);
}

template <typename T> int smem_bytes(bool is_staged, int s_total) {
  return static_cast<int>(sizeof(T)) * ((is_staged ? 4 * s_total : 0) + kNConst);
}

int n_vals(int s_total) { return (4 + kMatCols) * s_total + kNConst + 1; }

// Blocks of a launch: one thread per ray, or (gradient kernels) one warp per
// column of the partials.
int ray_blocks(int n) { return (n + kThreads - 1) / kThreads; }
int col_blocks(int n_cols) { return (n_cols + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <typename T, bool kStaged, typename... P, typename... A>
int launch_one(void (*kernel)(P...), int blocks, int s_total, cudaStream_t stream, A... args) {
  const int smem = smem_bytes<T>(kStaged, s_total);
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_reduce(int err, const T* parts, T* flat, int n_cols, int s_total, cudaStream_t stream) {
  if (err != 0) return err;
  reduce_partials<T><<<n_vals(s_total), kReduceThreads, 0, stream>>>(parts, flat, n_cols);
  return static_cast<int>(cudaGetLastError());
}

// Launch KERNEL's instantiation for the xi pointer (null: the deterministic
// kernel, else the glossy one) and the table size (staged geometry up to
// kStageMaxBytes); evaluates to the launch's CUDA error.
#define PRT_DISPATCH(KERNEL, T, BLOCKS, S_TOTAL, STREAM, ...)                                        \
  (xi ? (staged<T>(S_TOTAL)                                                                    \
             ? launch_one<T, true>(KERNEL<T, true, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)     \
             : launch_one<T, false>(KERNEL<T, true, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__))  \
      : (staged<T>(S_TOTAL)                                                                    \
             ? launch_one<T, true>(KERNEL<T, false, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)    \
             : launch_one<T, false>(KERNEL<T, false, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)))

// The same for a kernel with an atlas mode: ATLAS (the flat-id pointer, or
// the g_dww one) non-null launches that instantiation.
#define PRT_DISPATCH_ATLAS(KERNEL, T, ATLAS, BLOCKS, S_TOTAL, STREAM, ...)                                    \
  (xi ? (staged<T>(S_TOTAL)                                                                                \
             ? (ATLAS ? launch_one<T, true>(KERNEL<T, true, true, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)    \
                      : launch_one<T, true>(KERNEL<T, true, true, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__))   \
             : (ATLAS ? launch_one<T, false>(KERNEL<T, true, false, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)  \
                      : launch_one<T, false>(KERNEL<T, true, false, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)))\
      : (staged<T>(S_TOTAL)                                                                                \
             ? (ATLAS ? launch_one<T, true>(KERNEL<T, false, true, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__)   \
                      : launch_one<T, true>(KERNEL<T, false, true, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__))  \
             : (ATLAS ? launch_one<T, false>(KERNEL<T, false, false, true>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__) \
                      : launch_one<T, false>(KERNEL<T, false, false, false>, BLOCKS, S_TOTAL, STREAM, __VA_ARGS__))))

// An atlas-mode launch needs both its pointers and the slot extents.
bool bad_atlas(const void* a, const void* b, int tex_h, int tex_w) {
  return a && (!b || tex_h < 1 || tex_w < 1);
}

template <typename T>
int launch_fwd(const T* o, const T* d, const T* geom, const T* mat, const T* cst, const T* xi, T* acc, T* osave,
               T* dsave, T* thrsave, T* alivesave, int* idx, T* hit, T* clear, int* flat, T* dww, int n, int s_cheap,
               int s_total, int depth, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth) || bad_atlas(flat, dww, tex_h, tex_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  return PRT_DISPATCH_ATLAS(smooth_fwd_deep, T, flat, ray_blocks(n), s_total, static_cast<cudaStream_t>(stream), o,
                            d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear, flat, dww,
                            n, depth, sc);
}

template <typename T>
int launch_bwd(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave, const T* alivesave,
               const int* idx, const T* hit, const T* clear, const T* geom, const T* mat, const T* cst, const T* xi,
               const T* g_acc, const T* g_dww, T* g_o, T* g_d, T* parts, T* flat, int n, int n_cols, int s_cheap,
               int s_total, int depth, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth) || bad_cols(n, n_cols) || bad_atlas(g_dww, g_dww, tex_h, tex_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = PRT_DISPATCH_ATLAS(smooth_bwd_deep, T, g_dww, col_blocks(n_cols), s_total, st, o, d, osave, dsave,
                                     thrsave, alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc, g_dww, g_o, g_d,
                                     parts, n, n_cols, depth, sc);
  return launch_reduce(err, parts, flat, n_cols, s_total, st);
}

template <typename T>
int launch_train(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, const T* xi,
                 T* g_o, T* g_d, T* parts, T* flat, int n, int n_cols, int s_cheap, int s_total, int depth,
                 T faraway, T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth) || bad_cols(n, n_cols) || depth > kMaxTrainDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = PRT_DISPATCH(train_deep, T, col_blocks(n_cols), s_total, st, o, d, tgt, geom, mat, cst, xi, g_o,
                               g_d, parts, n, n_cols, depth, sc);
  return launch_reduce(err, parts, flat, n_cols, s_total, st);
}

// smooth_fwd_step's skip: the launcher takes it from kStepSkipMinCheap
// cheap-tier spheres on (skip = -1), or as the caller forces it (0 off, 1
// on: the card check and the A/B time both sides; ops/bounce_smooth_sub.py
// STEP_SKIP_MIN_CHEAP).  Below it the bundles and the tests cost more than
// the pairs they leave out (benchmarks/sweep_skip_ab.py).
constexpr int kStepSkipMinCheap = 16;
// The skip's dynamic shared memory after the consts row: two bundles a warp.
constexpr int kStepBundleValues = 2 * kBundleValues * kWarpsPerBlock;

template <typename T, bool kXi, bool kStaged, bool kAtlas, typename... A>
int launch_step_skip(int blocks, int s_total, cudaStream_t stream, A... args) {
  const auto kernel = smooth_fwd_step<T, kXi, kStaged, kAtlas, true>;
  const int smem = smem_bytes<T>(kStaged, s_total) + kStepBundleValues * static_cast<int>(sizeof(T));
  if (const int err = allow_smem(kernel, smem)) return err;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_fwd_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* geom,
                    const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out,
                    T* acc_out, int* idx, T* hit, T* clear, int* flat, T* dww, int n, int s_cheap, int s_total,
                    T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, int skip, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1) || bad_atlas(flat, dww, tex_h, tex_w) || skip < -1 || skip > 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (skip < 0 ? s_cheap >= kStepSkipMinCheap : skip == 1) {
#define PRT_STEP_SKIP(XI, ATLAS)                                                                                   \
  (staged<T>(s_total) ? launch_step_skip<T, XI, true, ATLAS>(ray_blocks(n), s_total, st, o, d, thr, alive, acc,    \
                                                            geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,  \
                                                            acc_out, idx, hit, clear, flat, dww, n, sc)            \
                      : launch_step_skip<T, XI, false, ATLAS>(ray_blocks(n), s_total, st, o, d, thr, alive, acc,   \
                                                             geom, mat, cst, xi, o_out, d_out, thr_out, alive_out, \
                                                             acc_out, idx, hit, clear, flat, dww, n, sc))
    const int err = xi ? (flat ? PRT_STEP_SKIP(true, true) : PRT_STEP_SKIP(true, false))
                       : (flat ? PRT_STEP_SKIP(false, true) : PRT_STEP_SKIP(false, false));
#undef PRT_STEP_SKIP
    return err;
  }
  return PRT_DISPATCH_ATLAS(smooth_fwd_step, T, flat, ray_blocks(n), s_total, st, o, d, thr, alive, acc, geom, mat,
                            cst, xi, o_out, d_out, thr_out, alive_out, acc_out, idx, hit, clear, flat, dww, n, sc);
}

// smooth_bwd_step's dynamic shared memory: the consts row, its scratch and
// the two geometry buffers.
template <typename T> int step_smem_bytes() {
  return static_cast<int>(sizeof(T)) * (kNConst + kStepScratch + 2 * kStepThreads);
}

// smooth_bwd_step's rows (CTAs): 1 to ceil(ray-warps / kStepRayWarps), at
// most kStepMaxRows.
bool bad_rows(int n, int rows) {
  return rows < 1 || rows > kStepMaxRows || rows > (ray_warps(n) + kStepRayWarps - 1) / kStepRayWarps;
}

template <typename T, bool kXi, bool kAtlas, typename... A> int launch_step(int rows, cudaStream_t stream, A... args) {
  smooth_bwd_step<T, kXi, kAtlas><<<rows, kStepThreads, step_smem_bytes<T>(), stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_step(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit,
                    const T* clear, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
                    const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out,
                    T* g_d_out, T* g_thr_out, T* g_alive_out, T* pg, T* pm, T* pc, T* flat, int n, int rows,
                    int s_cheap, int s_total, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1) || bad_rows(n, rows) || bad_atlas(g_dww, g_dww, tex_h, tex_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PRT_STEP(XI, ATLAS)                                                                                     \
  launch_step<T, XI, ATLAS>(rows, st, o, d, thr, alive, idx, hit, clear, geom, mat, cst, xi, g_o, g_d, \
                            g_thr, g_alive, g_acc, g_dww, g_o_out, g_d_out, g_thr_out, g_alive_out, pg, pm, pc, n, \
                            rows, sc)
  const int err = xi ? (g_dww ? PRT_STEP(true, true) : PRT_STEP(true, false))
                     : (g_dww ? PRT_STEP(false, true) : PRT_STEP(false, false));
#undef PRT_STEP
  if (err != 0) return err;
  reduce_rows<T><<<2 * s_total + 1, kReduceThreads, 0, st>>>(pg, pm, pc, flat, rows, s_total);
  return static_cast<int>(cudaGetLastError());
}

#undef PRT_DISPATCH
#undef PRT_DISPATCH_ATLAS

// Resident blocks per SM of a kernel's instantiation for a table size, or a
// negative CUDA error.
template <typename T, bool kStaged, typename... P>
int blocks_per_sm(void (*kernel)(P...), int s_total, int extra = 0) {
  const int smem = smem_bytes<T>(kStaged, s_total) + extra;
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T, typename... P> int step_blocks_per_sm(void (*kernel)(P...)) {
  const int smem = step_smem_bytes<T>();
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kStepThreads, smem);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

template <typename T, bool kXi> int occupancy_xi(int which, int s_total) {
  const bool is_staged = staged<T>(s_total);
#define PRT_OCC(KERNEL) \
  (is_staged ? blocks_per_sm<T, true>(KERNEL<T, kXi, true>, s_total) : blocks_per_sm<T, false>(KERNEL<T, kXi, false>, s_total))
#define PRT_OCC4(KERNEL) \
  (is_staged ? blocks_per_sm<T, true>(KERNEL<T, kXi, true, false>, s_total) \
             : blocks_per_sm<T, false>(KERNEL<T, kXi, false, false>, s_total))
  switch (which) {
    case 0: return PRT_OCC4(smooth_fwd_deep);
    case 1: return PRT_OCC4(smooth_bwd_deep);
    case 2: return PRT_OCC(train_deep);
    case 3: return PRT_OCC4(smooth_fwd_step);
    case 4:
      return step_blocks_per_sm<T>(smooth_bwd_step<T, kXi, false>);
    case 5: {  // smooth_fwd_step with its skip
      const int extra = kStepBundleValues * static_cast<int>(sizeof(T));
      return is_staged ? blocks_per_sm<T, true>(smooth_fwd_step<T, kXi, true, false, true>, s_total, extra)
                       : blocks_per_sm<T, false>(smooth_fwd_step<T, kXi, false, false, true>, s_total, extra);
    }
    default: return -static_cast<int>(cudaErrorInvalidValue);
  }
#undef PRT_OCC
#undef PRT_OCC4
}

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_smooth_sub.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch;
// prt_smooth_blocks_per_sm_* reports a kernel's resident blocks per SM
// (which: 0-4 in the order above, 5 smooth_fwd_step with its skip) for a
// table size, and
// prt_smooth_shared_bytes_* the shared memory a block of any of them takes.
extern "C" {

#define PRT_SMOOTH_ENTRIES(T, SUFFIX)                                                                          \
  int prt_smooth_fwd_deep_##SUFFIX(const T* o, const T* d, const T* geom, const T* mat, const T* cst,           \
                                   const T* xi, T* acc, T* osave, T* dsave, T* thrsave, T* alivesave, int* idx, \
                                   T* hit, T* clear, int* tflat, T* dww, int n, int s_cheap, int s_total,       \
                                   int depth, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w,           \
                                   void* stream) {                                                             \
    return launch_fwd<T>(o, d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear,    \
                         tflat, dww, n, s_cheap, s_total, depth, faraway, sharp_e, sharp_s, tex_h, tex_w,      \
                         stream);                                                                              \
  }                                                                                                            \
  int prt_smooth_bwd_deep_##SUFFIX(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave,   \
                                   const T* alivesave, const int* idx, const T* hit, const T* clear,           \
                                   const T* geom, const T* mat, const T* cst, const T* xi, const T* g_acc,     \
                                   const T* g_dww, T* g_o, T* g_d, T* parts, T* flat, int n, int n_cols,       \
                                   int s_cheap, int s_total, int depth, T faraway, T sharp_e, T sharp_s,       \
                                   int tex_h, int tex_w, void* stream) {                                       \
    return launch_bwd<T>(o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc,  \
                         g_dww, g_o, g_d, parts, flat, n, n_cols, s_cheap, s_total, depth, faraway, sharp_e,   \
                         sharp_s, tex_h, tex_w, stream);                                                       \
  }                                                                                                            \
  int prt_train_deep_##SUFFIX(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, \
                              const T* xi, T* g_o, T* g_d, T* parts, T* flat, int n, int n_cols, int s_cheap,  \
                              int s_total, int depth, T faraway, T sharp_e, T sharp_s, void* stream) {         \
    return launch_train<T>(o, d, tgt, geom, mat, cst, xi, g_o, g_d, parts, flat, n, n_cols, s_cheap, s_total,  \
                           depth, faraway, sharp_e, sharp_s, stream);                                          \
  }                                                                                                            \
  int prt_smooth_fwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc,         \
                                   const T* geom, const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, \
                                   T* thr_out, T* alive_out, T* acc_out, int* idx, T* hit, T* clear,          \
                                   int* tflat, T* dww, int n, int s_cheap, int s_total, T faraway, T sharp_e,  \
                                   T sharp_s, int tex_h, int tex_w, int skip, void* stream) {                  \
    return launch_fwd_step<T>(o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,    \
                              acc_out, idx, hit, clear, tflat, dww, n, s_cheap, s_total, faraway, sharp_e,     \
                              sharp_s, tex_h, tex_w, skip, stream);                                            \
  }                                                                                                            \
  int prt_smooth_bwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* idx,       \
                                   const T* hit, const T* clear, const T* geom, const T* mat, const T* cst,    \
                                   const T* xi, const T* g_o, const T* g_d, const T* g_thr,                    \
                                   const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out, T* g_d_out,   \
                                   T* g_thr_out, T* g_alive_out, T* pg, T* pm, T* pc, T* flat, int n,          \
                                   int rows, int s_cheap, int s_total, T faraway, T sharp_e, T sharp_s,        \
                                   int tex_h, int tex_w, void* stream) {                                       \
    return launch_bwd_step<T>(o, d, thr, alive, idx, hit, clear, geom, mat, cst, xi, g_o, g_d, g_thr,         \
                              g_alive, g_acc, g_dww, g_o_out, g_d_out, g_thr_out, g_alive_out, pg, pm, pc,     \
                              flat, n, rows, s_cheap, s_total, faraway, sharp_e, sharp_s, tex_h, tex_w,        \
                              stream);                                                                         \
  }                                                                                                            \
  int prt_smooth_blocks_per_sm_##SUFFIX(int which, int glossy, int s_total) {                                  \
    return glossy ? occupancy_xi<T, true>(which, s_total) : occupancy_xi<T, false>(which, s_total);           \
  }                                                                                                            \
  int prt_smooth_shared_bytes_##SUFFIX(int s_total) { return smem_bytes<T>(staged<T>(s_total), s_total); }

PRT_SMOOTH_ENTRIES(float, f32)
PRT_SMOOTH_ENTRIES(double, f64)

#undef PRT_SMOOTH_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
