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
// All five share fwd_bounce() (the TPU kernels' _FwdSub, :227, unrolled
// mode) and adjoint_bounce() (_adjoint_bounce, :578), no atlas, from
// smooth_math.cuh, with the winner swept or saved and every sphere in the
// shadow loops; the warp partials below are their sink.  Each is
// instantiated twice: with the mirror continuation, and with the stochastic
// glossy one (kXi; :497-538 forward, :610-657 adjoint), whose uniforms xi
// come from the wrapper on the JAX package's seed schedule.  The plain
// PyTorch versions are in ops/bounce_smooth_sub.py (fwd_sub_math,
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
// count: it moves the whole state per launch (100-120 B per ray) for one
// bounce's work, so its least time is set by the bytes.  The design follows
// from that, not from the TPU layout:
//   * one thread per ray over the (3, N) layout, ragged edge masked; no
//     (8, 128) packing and no padding;
//   * the geometry (S, 4), material (S, 19) and consts (1, 16) tables are
//     staged per block in dynamic shared memory (23 S + 16 values), so a
//     warp's sphere reads are broadcasts;
//   * sphere and depth loops are runtime loops: no TPU compile-size caps;
//   * table gradients without float atomics: each warp sums its lanes'
//     contributions by a shuffle tree and lane 0 adds them into its own
//     column of a (values, warps) partials array; a second kernel sums the
//     columns in a fixed order.  Two launches on the same inputs give
//     bitwise-equal gradients.
//
// Numerics: smooth_math.cuh (no FMA contraction, the smooth split factor,
// the sigmoid's form, the tie rules); x**n for integer n is binary
// exponentiation (JAX integer_pow), 2.5 and 1.5 are pow; the L2 cotangent's
// clip gradient splits 0.5 at exact bounds (JAX).

#include "smooth_math.cuh"

namespace {

constexpr int kMaxSpheres = 256;    // ops/bounce_smooth_sub.py MAX_SMOOTH_SPHERES
constexpr int kMaxTrainDepth = 64;  // ops/bounce_smooth_sub.py MAX_TRAIN_DEPTH
constexpr int kThreads = 128;
constexpr int kReduceThreads = 256;

// Warp-level partial sums of the table gradients: every lane of the warp
// calls this with the same value index (uniform control flow); lane 0 adds
// the warp's sum into its own column.  Invalid lanes contribute zero, and a
// warp wholly past the ragged edge has no column and writes nothing.
template <typename T> struct Partials {
  T* parts;  // (n_vals, n_warps)
  int n_warps, warp, lane;
  bool valid;

  __device__ __forceinline__ void add(int v, T x) const {
    T s = valid ? x : T(0);
    for (int off = kWarp / 2; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0 && warp < n_warps) parts[static_cast<long long>(v) * n_warps + warp] += s;
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

// Copy the side tables into dynamic shared memory; every thread of the
// block takes part, so this comes before any thread leaves.
template <typename T>
__device__ __forceinline__ void stage_tables(T* s_geom, T* s_mat, T* s_cst, const T* geom, const T* mat,
                                             const T* cst, int s_total) {
  for (int i = threadIdx.x; i < s_total * 4; i += blockDim.x) s_geom[i] = geom[i];
  for (int i = threadIdx.x; i < s_total * kMatCols; i += blockDim.x) s_mat[i] = mat[i];
  for (int i = threadIdx.x; i < kNConst; i += blockDim.x) s_cst[i] = cst[i];
  __syncthreads();
}

template <typename T> struct Smem {
  T *geom, *mat, *cst;
};

template <typename T> __device__ __forceinline__ Smem<T> smem_tables(int s_total) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* base = reinterpret_cast<T*>(smem_raw);
  return {base, base + 4 * s_total, base + (4 + kMatCols) * s_total};
}

// Bounce dep's uniforms from a (2 * depth, N) xi stack (zero when !kXi).
template <typename T, bool kXi>
__device__ __forceinline__ void load_xi(const T* xi, int dep, long long N, long long i, T& xi1, T& xi2) {
  xi1 = kXi ? xi[2 * dep * N + i] : T(0);
  xi2 = kXi ? xi[(2 * dep + 1) * N + i] : T(0);
}

template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ acc,
                    T* __restrict__ osave, T* __restrict__ dsave, T* __restrict__ thrsave,
                    T* __restrict__ alivesave, int* __restrict__ idx_out, T* __restrict__ hit_out,
                    T* __restrict__ clear_out, int n, int depth, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
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
    fwd_bounce<T, kXi, Winner::kSweep>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
    for (int c = 0; c < 3; ++c) a[c] = a[c] + f.color[c] * f.w;
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

template <typename T> __device__ __forceinline__ Partials<T> make_partials(T* parts, long long i, int n) {
  Partials<T> p;
  p.parts = parts;
  p.n_warps = (n + kWarp - 1) / kWarp;
  p.warp = static_cast<int>(i / kWarp);
  p.lane = threadIdx.x % kWarp;
  p.valid = i < n;
  return p;
}

// Reverse adjoint chain from the residuals.  Lanes past the ragged edge
// stay (on a copy of the last ray, contributing zero) so every warp
// reduction has all 32 lanes.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ osave,
                    const T* __restrict__ dsave, const T* __restrict__ thrsave,
                    const T* __restrict__ alivesave, const int* __restrict__ idx_in,
                    const T* __restrict__ hit_in, const T* __restrict__ clear_in, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    const T* __restrict__ g_acc_in,
                    T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n, int depth,
                    Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
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
    fwd_bounce<T, kXi, Winner::kSaved>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
    adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, AllSpheres{}, part);
  }
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
  }
}

// Replay state of one bounce, kept in thread-local memory by train_deep.
template <typename T> struct Replay {
  V3<T> o, d;
  T thr, alive, clear;
  int idx;
  bool hit;
};

template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    train_deep(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ tgt,
               const T* __restrict__ geom, const T* __restrict__ mat, const T* __restrict__ cst,
               const T* __restrict__ xi, T* __restrict__ g_o_out, T* __restrict__ g_d_out, T* __restrict__ parts, int n, int depth,
               Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
  Replay<T> saved[kMaxTrainDepth];
  V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T thr = T(1), alive = T(1);
  V3<T> a = {T(0), T(0), T(0)};
  Fwd<T> f;
  for (int dep = 0; dep < depth; ++dep) {
    T xi1, xi2;
    load_xi<T, kXi>(xi, dep, N, i, xi1, xi2);
    fwd_bounce<T, kXi, Winner::kSweep>(f, ro, rd, thr, alive, s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
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
    fwd_bounce<T, kXi, Winner::kSaved>(f, r.o, r.d, r.thr, r.alive, s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
    adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, AllSpheres{}, part);
  }
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
  }
}

// One smooth bounce per launch (_fwd_kernel_sub): the state (o, d, thr,
// alive, acc) in, the next state and the bounce's residuals (idx, hit,
// clear) out.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_fwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const T* __restrict__ acc, const T* __restrict__ geom,
                    const T* __restrict__ mat, const T* __restrict__ cst, const T* __restrict__ xi,
                    T* __restrict__ o_out, T* __restrict__ d_out, T* __restrict__ thr_out,
                    T* __restrict__ alive_out, T* __restrict__ acc_out, int* __restrict__ idx_out,
                    T* __restrict__ hit_out, T* __restrict__ clear_out, int n, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  fwd_bounce<T, kXi, Winner::kSweep>(f, ro, rd, thr[i], alive[i], s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
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

// Its adjoint (_bwd_kernel_sub): replays the bounce from its inputs and
// residuals, takes the cotangents of all five outputs and writes those of
// (o, d, thr, alive); acc's passes through and is the caller's.  Lanes past
// the ragged edge stay (on a copy of the last ray, contributing zero) so
// every warp reduction has all 32 lanes.
template <typename T, bool kXi>
__global__ void __launch_bounds__(kThreads)
    smooth_bwd_step(const T* __restrict__ o, const T* __restrict__ d, const T* __restrict__ thr,
                    const T* __restrict__ alive, const int* __restrict__ idx, const T* __restrict__ hit,
                    const T* __restrict__ clear, const T* __restrict__ geom, const T* __restrict__ mat,
                    const T* __restrict__ cst, const T* __restrict__ xi, const T* __restrict__ g_o_in,
                    const T* __restrict__ g_d_in, const T* __restrict__ g_thr_in,
                    const T* __restrict__ g_alive_in, const T* __restrict__ g_acc_in, T* __restrict__ g_o_out,
                    T* __restrict__ g_d_out, T* __restrict__ g_thr_out, T* __restrict__ g_alive_out,
                    T* __restrict__ parts, int n, Scal<T> sc) {
  const Smem<T> s = smem_tables<T>(sc.s_total);
  stage_tables(s.geom, s.mat, s.cst, geom, mat, cst, sc.s_total);
  const long long gi = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const Partials<T> part = make_partials(parts, gi, n);
  const long long i = part.valid ? gi : n - 1;
  const long long N = n;
  const V3<T> ro = {o[i], o[N + i], o[2 * N + i]};
  const V3<T> rd = {d[i], d[N + i], d[2 * N + i]};
  T xi1, xi2;
  load_xi<T, kXi>(xi, 0, N, i, xi1, xi2);
  Fwd<T> f;
  f.idx = idx[i];
  f.hit = hit[i] != T(0);
  f.clear = clear[i];
  fwd_bounce<T, kXi, Winner::kSaved>(f, ro, rd, thr[i], alive[i], s.geom, s.mat, s.cst, sc, AllSpheres{}, xi1, xi2);
  V3<T> g_o = {g_o_in[i], g_o_in[N + i], g_o_in[2 * N + i]};
  V3<T> g_d = {g_d_in[i], g_d_in[N + i], g_d_in[2 * N + i]};
  T g_thr = g_thr_in[i], g_alive = g_alive_in[i];
  const V3<T> g_acc = {g_acc_in[i], g_acc_in[N + i], g_acc_in[2 * N + i]};
  adjoint_bounce<T, kXi>(f, g_o, g_d, g_thr, g_alive, g_acc, s.geom, s.cst, sc, AllSpheres{}, part);
  if (part.valid) {
    for (int c = 0; c < 3; ++c) {
      g_o_out[c * N + i] = g_o[c];
      g_d_out[c * N + i] = g_d[c];
    }
    g_thr_out[i] = g_thr;
    g_alive_out[i] = g_alive;
  }
}

// Second pass: each block sums one value's column of warp partials, in a
// fixed order (strided per thread, then a shared-memory tree).
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
    reduce_partials(const T* __restrict__ parts, T* __restrict__ out, int n_warps) {
  __shared__ T s[kReduceThreads];
  const T* row = parts + static_cast<long long>(blockIdx.x) * n_warps;
  T acc = T(0);
  for (int w = threadIdx.x; w < n_warps; w += kReduceThreads) acc += row[w];
  s[threadIdx.x] = acc;
  __syncthreads();
  for (int stride = kReduceThreads / 2; stride > 0; stride >>= 1) {
    if (threadIdx.x < stride) s[threadIdx.x] += s[threadIdx.x + stride];
    __syncthreads();
  }
  if (threadIdx.x == 0) out[blockIdx.x] = s[0];
}

bool bad_args(int n, int s_cheap, int s_total, int depth) {
  return n <= 0 || s_total < 1 || s_total > kMaxSpheres || s_cheap < 0 || s_cheap > s_total || depth < 1;
}

int blocks_for(int n) { return (n + kThreads - 1) / kThreads; }

template <typename T> size_t smem_bytes(int s_total) {
  return sizeof(T) * static_cast<size_t>((4 + kMatCols) * s_total + kNConst);
}

int n_vals(int s_total) { return (4 + kMatCols) * s_total + kNConst + 1; }

template <typename T>
int launch_reduce(const T* parts, T* flat, int n, int s_total, cudaStream_t stream) {
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0) return err;
  reduce_partials<T><<<n_vals(s_total), kReduceThreads, 0, stream>>>(parts, flat, (n + kWarp - 1) / kWarp);
  return static_cast<int>(cudaGetLastError());
}

// Each launcher takes xi as a pointer that may be null: null launches the
// deterministic instantiation of the kernel, non-null the glossy one.
#define PRT_DISPATCH_XI(KERNEL, T, GRID, SMEM, STREAM, ...)                    \
  do {                                                                        \
    if (xi) {                                                                 \
      KERNEL<T, true><<<GRID, kThreads, SMEM, STREAM>>>(__VA_ARGS__);         \
    } else {                                                                  \
      KERNEL<T, false><<<GRID, kThreads, SMEM, STREAM>>>(__VA_ARGS__);        \
    }                                                                         \
  } while (0)

template <typename T>
int launch_fwd(const T* o, const T* d, const T* geom, const T* mat, const T* cst, const T* xi, T* acc, T* osave,
               T* dsave, T* thrsave, T* alivesave, int* idx, T* hit, T* clear, int n, int s_cheap, int s_total,
               int depth, T faraway, T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  PRT_DISPATCH_XI(smooth_fwd_deep, T, blocks_for(n), smem_bytes<T>(s_total), static_cast<cudaStream_t>(stream),
                  o, d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear, n, depth, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave, const T* alivesave,
               const int* idx, const T* hit, const T* clear, const T* geom, const T* mat, const T* cst, const T* xi,
               const T* g_acc, T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, int depth,
               T faraway, T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(smooth_bwd_deep, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, osave, dsave, thrsave,
                  alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc, g_o, g_d, parts, n, depth, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

template <typename T>
int launch_train(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, const T* xi,
                 T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, int depth, T faraway,
                 T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, depth) || depth > kMaxTrainDepth) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(train_deep, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, tgt, geom, mat, cst, xi, g_o,
                  g_d, parts, n, depth, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

template <typename T>
int launch_fwd_step(const T* o, const T* d, const T* thr, const T* alive, const T* acc, const T* geom,
                    const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, T* thr_out, T* alive_out,
                    T* acc_out, int* idx, T* hit, T* clear, int n, int s_cheap, int s_total, T faraway, T sharp_e,
                    T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  PRT_DISPATCH_XI(smooth_fwd_step, T, blocks_for(n), smem_bytes<T>(s_total), static_cast<cudaStream_t>(stream),
                  o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out, acc_out, idx, hit,
                  clear, n, sc);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_bwd_step(const T* o, const T* d, const T* thr, const T* alive, const int* idx, const T* hit,
                    const T* clear, const T* geom, const T* mat, const T* cst, const T* xi, const T* g_o,
                    const T* g_d, const T* g_thr, const T* g_alive, const T* g_acc, T* g_o_out, T* g_d_out,
                    T* g_thr_out, T* g_alive_out, T* parts, T* flat, int n, int s_cheap, int s_total, T faraway,
                    T sharp_e, T sharp_s, void* stream) {
  if (bad_args(n, s_cheap, s_total, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const Scal<T> sc = {faraway, sharp_e, sharp_s, s_cheap, s_total};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  PRT_DISPATCH_XI(smooth_bwd_step, T, blocks_for(n), smem_bytes<T>(s_total), st, o, d, thr, alive, idx, hit,
                  clear, geom, mat, cst, xi, g_o, g_d, g_thr, g_alive, g_acc, g_o_out, g_d_out, g_thr_out,
                  g_alive_out, parts, n, sc);
  return launch_reduce(parts, flat, n, s_total, st);
}

#undef PRT_DISPATCH_XI

}  // namespace

// Plain C entries, bound with ctypes (ops/bounce_smooth_sub.py _SIGNATURES).
// Each launches on the given stream, does not synchronise, and returns
// cudaGetLastError() so the caller can raise on a refused launch.
extern "C" {

#define PRT_SMOOTH_ENTRIES(T, SUFFIX)                                                                          \
  int prt_smooth_fwd_deep_##SUFFIX(const T* o, const T* d, const T* geom, const T* mat, const T* cst,           \
                                   const T* xi, T* acc, T* osave, T* dsave, T* thrsave, T* alivesave, int* idx, \
                                   T* hit, T* clear, int n, int s_cheap, int s_total, int depth, T faraway,     \
                                   T sharp_e, T sharp_s, void* stream) {                                       \
    return launch_fwd<T>(o, d, geom, mat, cst, xi, acc, osave, dsave, thrsave, alivesave, idx, hit, clear, n, \
                         s_cheap, s_total, depth, faraway, sharp_e, sharp_s, stream);                          \
  }                                                                                                            \
  int prt_smooth_bwd_deep_##SUFFIX(const T* o, const T* d, const T* osave, const T* dsave, const T* thrsave,   \
                                   const T* alivesave, const int* idx, const T* hit, const T* clear,           \
                                   const T* geom, const T* mat, const T* cst, const T* xi, const T* g_acc,     \
                                   T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total,         \
                                   int depth, T faraway, T sharp_e, T sharp_s, void* stream) {                 \
    return launch_bwd<T>(o, d, osave, dsave, thrsave, alivesave, idx, hit, clear, geom, mat, cst, xi, g_acc,  \
                         g_o, g_d, parts, flat, n, s_cheap, s_total, depth, faraway, sharp_e, sharp_s, stream);\
  }                                                                                                            \
  int prt_train_deep_##SUFFIX(const T* o, const T* d, const T* tgt, const T* geom, const T* mat, const T* cst, \
                              const T* xi, T* g_o, T* g_d, T* parts, T* flat, int n, int s_cheap, int s_total, \
                              int depth, T faraway, T sharp_e, T sharp_s, void* stream) {                      \
    return launch_train<T>(o, d, tgt, geom, mat, cst, xi, g_o, g_d, parts, flat, n, s_cheap, s_total, depth,  \
                           faraway, sharp_e, sharp_s, stream);                                                 \
  }                                                                                                            \
  int prt_smooth_fwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const T* acc,         \
                                   const T* geom, const T* mat, const T* cst, const T* xi, T* o_out, T* d_out, \
                                   T* thr_out, T* alive_out, T* acc_out, int* idx, T* hit, T* clear, int n,    \
                                   int s_cheap, int s_total, T faraway, T sharp_e, T sharp_s, void* stream) {  \
    return launch_fwd_step<T>(o, d, thr, alive, acc, geom, mat, cst, xi, o_out, d_out, thr_out, alive_out,    \
                              acc_out, idx, hit, clear, n, s_cheap, s_total, faraway, sharp_e, sharp_s,        \
                              stream);                                                                         \
  }                                                                                                            \
  int prt_smooth_bwd_step_##SUFFIX(const T* o, const T* d, const T* thr, const T* alive, const int* idx,       \
                                   const T* hit, const T* clear, const T* geom, const T* mat, const T* cst,    \
                                   const T* xi, const T* g_o, const T* g_d, const T* g_thr,                    \
                                   const T* g_alive, const T* g_acc, T* g_o_out, T* g_d_out, T* g_thr_out,     \
                                   T* g_alive_out, T* parts, T* flat, int n, int s_cheap, int s_total,         \
                                   T faraway, T sharp_e, T sharp_s, void* stream) {                            \
    return launch_bwd_step<T>(o, d, thr, alive, idx, hit, clear, geom, mat, cst, xi, g_o, g_d, g_thr,         \
                              g_alive, g_acc, g_o_out, g_d_out, g_thr_out, g_alive_out, parts, flat, n,        \
                              s_cheap, s_total, faraway, sharp_e, sharp_s, stream);                            \
  }

PRT_SMOOTH_ENTRIES(float, f32)
PRT_SMOOTH_ENTRIES(double, f64)

#undef PRT_SMOOTH_ENTRIES

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
