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
//     by size.  The winner's material row (19 values) is read from global
//     memory by index;
//   * sphere and depth loops are runtime loops: no TPU compile-size caps;
//   * table gradients without float atomics, in memory bounded in N: each
//     warp of a gradient kernel owns one column of a (values, cols)
//     partials array (cols given by the caller, at most ceil(N / 32); the
//     wrapper's PARTIAL_COLS caps it), and walks the
//     ray-warps col, col + cols, ... in that order; for each, the warp sums
//     its lanes' contributions by a shuffle tree and lane 0 adds the sum
//     into its column.  A second kernel sums the columns in a fixed order.
//     Two launches on the same inputs give bitwise-equal gradients, and the
//     partials take (23 S + 17) * cols values whatever the frame.
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
// clear) out.
template <typename T, bool kXi, bool kStaged, bool kAtlas>
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
  if (i >= n) return;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  fwd_bounce<T, kXi, Winner::kSweep, kAtlas>(f, ro, rd, thr[i], alive[i], tb.geom, mat, tb.cst, sc, AllSpheres{}, xi1,
                                             xi2);
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
// and is the caller's.  One ray-warp after another (for_ray_warps).
template <typename T, bool kXi, bool kStaged, bool kAtlas>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const int* __restrict__ idx, const T* __restrict__ hit,
                    const T* __restrict__ clear, const T* __restrict__ geom, const T* __restrict__ mat,
                    const T* __restrict__ cst, const T* __restrict__ xi, const T* __restrict__ g_o_in,
                    const T* __restrict__ g_d_in, const T* __restrict__ g_thr_in,
                    const T* __restrict__ g_alive_in, const T* __restrict__ g_acc_in,
                    const T* __restrict__ g_dww_in, T* __restrict__ g_o_out,
                    T* __restrict__ g_d_out, T* __restrict__ g_thr_out, T* __restrict__ g_alive_out,
                    T* __restrict__ parts, int n, int n_cols, Scal<T> sc) {
  const Tables<T, kStaged> tb = stage_tables<T, kStaged>(geom, cst, sc.s_total);
  const long long N = n;
  for_ray_warps(parts, n, n_cols, [&](const Partials<T>& part, long long i) {
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
    V3<T> g_o = {g_o_in[i], g_o_in[N + i], g_o_in[2 * N + i]};
    V3<T> g_d = {g_d_in[i], g_d_in[N + i], g_d_in[2 * N + i]};
    T g_thr = g_thr_in[i], g_alive = g_alive_in[i];
    const V3<T> g_acc = {g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]};
    const T g_dww = kAtlas ? g_dww_in[i] : T(0);
    adjoint_bounce<T, kXi, kAtlas>(f, g_o, g_d, g_thr, g_alive, g_acc, tb.geom, tb.cst, sc, AllSpheres{}, part, g_dww);
    if (part.valid) {
      for (int c = 0; c < 3; ++c) {
        g_o_out[c * N + i] = g_o[c];
        g_d_out[c * N + i] = g_d[c];
      }
      g_thr_out[i] = g_thr;
      g_alive_out[i] = g_alive;
    }
  });
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

template <typename T>
int launch_fwd_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* geom,
                    const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out,
                    T* acc_out, int* idx, T* hit, T* clear, int* flat, T* dww, int n, int s_cheap, int s_total,
                    T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1) || bad_atlas(flat, dww, tex_h, tex_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  return PRT_DISPATCH_ATLAS(smooth_fwd_step, T, flat, ray_blocks(n), s_total, static_cast<cudaStream_t>(stream), o,
                            d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out, acc_out, idx,
                            hit, clear, flat, dww, n, sc);
}

template <typename T>
int launch_bwd_step(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit,
                    const T* clear, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
                    const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out,
                    T* g_d_out, T* g_thr_out, T* g_alive_out, T* parts, T* flat, int n, int n_cols, int s_cheap,
                    int s_total, T faraway, T sharp_e, T sharp_s, int tex_h, int tex_w, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1) || bad_cols(n, n_cols) || bad_atlas(g_dww, g_dww, tex_h, tex_w)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total, tex_h, tex_w};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = PRT_DISPATCH_ATLAS(smooth_bwd_step, T, g_dww, col_blocks(n_cols), s_total, st, o, d, thr, alive,
                                     idx, hit, clear, geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_dww,
                                     g_o_out, g_d_out, g_thr_out, g_alive_out, parts, n, n_cols, sc);
  return launch_reduce(err, parts, flat, n_cols, s_total, st);
}

#undef PRT_DISPATCH
#undef PRT_DISPATCH_ATLAS

// Resident blocks per SM of a kernel's instantiation for a table size, or a
// negative CUDA error.
template <typename T, bool kStaged, typename... P> int blocks_per_sm(void (*kernel)(P...), int s_total) {
  const int smem = smem_bytes<T>(kStaged, s_total);
  if (const int err = allow_smem(kernel, smem)) return -err;
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel, kThreads, smem);
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
    case 4: return PRT_OCC4(smooth_bwd_step);
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
// (which: 0-4 in the order above) for a table size, and
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
                                   T sharp_s, int tex_h, int tex_w, void* stream) {                            \
    return launch_fwd_step<T>(o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,    \
                              acc_out, idx, hit, clear, tflat, dww, n, s_cheap, s_total, faraway, sharp_e,     \
                              sharp_s, tex_h, tex_w, stream);                                                  \
  }                                                                                                            \
  int prt_smooth_bwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* idx,       \
                                   const T* hit, const T* clear, const T* geom, const T* mat, const T* cst,    \
                                   const T* xi, const T* g_o, const T* g_d, const T* g_thr,                    \
                                   const T* g_alive, const T* g_acc, const T* g_dww, T* g_o_out, T* g_d_out,   \
                                   T* g_thr_out, T* g_alive_out, T* parts, T* flat, int n, int n_cols,         \
                                   int s_cheap, int s_total, T faraway, T sharp_e, T sharp_s, int tex_h,       \
                                   int tex_w, void* stream) {                                                  \
    return launch_bwd_step<T>(o, d, thr, alive, idx, hit, clear, geom, mat, cst, xi, g_o, g_d, g_thr,         \
                              g_alive, g_acc, g_dww, g_o_out, g_d_out, g_thr_out, g_alive_out, parts, flat, n, \
                              n_cols, s_cheap, s_total, faraway, sharp_e, sharp_s, tex_h, tex_w, stream);      \
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
