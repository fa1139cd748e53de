// Material-gather probe for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernels of benchmarks/gather_probe.py, all launched
// through _call (:40-41): stage 1's five take_along_axis probes (:60, :74,
// :87, :102, :118) and stage 2's in-kernel material-row take at config-4
// scale (S = 1024 spheres, 2,097,152 rays, 12 channels): the piecewise
// gather `kern` (:187) and the direct gather `kern_d` (:228), beside XLA's
// take (:176).  Every kernel here computes
//     out[c, l] = table[c, abs(idx[l]) % S]
// for a (C, S) f32 table (JAX's mat_t) and n int32 indices, out (C, n); the
// abs % S is JAX's and stays.  Three strategies, one kernel each:
//   gather_global   each thread reads its C values from global memory with
//                   __ldg (through L1), as shade_culled reads the winner's
//                   material row today (csrc/culled.cu);
//   gather_shared   each block stages the whole table in dynamic shared
//                   memory (12 x 1024 f32 is 49,152 B, opted in like the
//                   other kernels' staging) and walks its share of the lanes:
//                   the counterpart of JAX's direct kern_d, one gather from
//                   a resident table;
//   gather_shuffle  the register gather: for each 32-entry piece of the
//                   table that a lane of the warp wants, lane k of the warp
//                   holds entry 32 p + k of each channel and every lane takes
//                   __shfl_sync(piece, idx % 32), keeping it where
//                   idx / 32 == p: the counterpart of JAX's piecewise kern (a
//                   128-lane piece broadcast, take_along_axis, a select on
//                   hi).
// The plain PyTorch version (advanced indexing) sits in
// benchmarks/gather_probe.py (gather_plain).
//
// What bounds them on this card: bytes.  A lane reads a 4-byte index and
// writes C 4-byte values, and the table is read once: 109 MB at stage 2,
// ~0.033 ms at 3.35 TB/s.  The table's reads are what the three strategies
// trade: L1 lines (global), a staging pass a block (shared), or some
// 0.6-0.9 C * S / 32 shuffles and piece loads a lane (shuffle, which issues
// that many times the work of the others and is here to be measured, not
// to win).

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSharedThreads = 512;
constexpr int kWarp = 32;
constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kChanGroup = 12;  // channels gather_shuffle loads a piece for at once
// Indices a thread of gather_shuffle takes: 2 is the fastest of 1, 2 and 4
// on an H100 (benchmarks/gather_lanes.py).  A second index a thread makes
// a warp want more of the table's pieces (27.6 of 32 for 64 indices, 20.6
// for 32), so more shuffles a value, but halves the loads a value.
constexpr int kShuffleLanes = 2;
constexpr long long kMaxSharedBytes = 232448;  // ops/_build.py MAX_SHARED_BYTES

// jnp.abs(i) % s: the absolute value wraps at INT_MIN as int32 does, and the
// remainder takes the divisor's sign (floor modulo), as jnp's and torch's do.
// Worked in unsigned arithmetic: built from a signed abs and %, the kernel
// gave 2^31 % s for INT_MIN on an H100.  abs(INT_MIN) is INT_MIN, whose
// floor remainder is s - 2^31 % s (or 0).
__device__ __forceinline__ int wrap(int i, int s) {
  const unsigned a = i < 0 ? 0u - static_cast<unsigned>(i) : static_cast<unsigned>(i);
  const unsigned m = a % static_cast<unsigned>(s);
  return a == 0x80000000u && m != 0 ? s - static_cast<int>(m) : static_cast<int>(m);
}

__global__ void __launch_bounds__(kThreads) gather_global(const float* __restrict__ table, const int* __restrict__ idx,
                                                          float* __restrict__ out, int chans, int s, int n) {
  const long long lane = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (lane >= n) return;
  const int j = wrap(__ldg(idx + lane), s);
  for (int c = 0; c < chans; ++c) {
    out[c * static_cast<long long>(n) + lane] = __ldg(table + c * static_cast<long long>(s) + j);
  }
}

__global__ void __launch_bounds__(kSharedThreads) gather_shared(const float* __restrict__ table,
                                                                const int* __restrict__ idx, float* __restrict__ out,
                                                                int chans, int s, int n) {
  extern __shared__ float staged[];
  const int entries = chans * s;
  for (int e = threadIdx.x; e < entries; e += kSharedThreads) staged[e] = table[e];
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * kSharedThreads;
  for (long long lane = static_cast<long long>(blockIdx.x) * kSharedThreads + threadIdx.x; lane < n; lane += stride) {
    const int j = wrap(__ldg(idx + lane), s);
    for (int c = 0; c < chans; ++c) out[c * static_cast<long long>(n) + lane] = staged[c * s + j];
  }
}

// The register gather, piece-outer: a warp visits only the 32-entry pieces
// of the table that one of its lanes wants (the OR of each lane's bits over
// the warp, a word of 32 pieces at a time), loads each such piece once for
// a group of up to kChanGroup channels (entry 32 p + k of each channel in
// lane k), and every lane takes __shfl_sync(piece, idx % 32) of each,
// keeping it where idx / 32 == p.  A thread takes kShuffleLanes indices
// (lanes base + k + 32 m), so one loaded piece serves that many shuffles.
// A warp does (pieces wanted) x channels x kShuffleLanes shuffles: for
// uniform indices 0.64 x S / 32 a value at one index a thread (32 draw 20.6
// of 32 pieces), 0.86 x S / 32 at two (64 draw 27.6), the floor of this
// strategy.
__global__ void __launch_bounds__(kThreads) gather_shuffle(const float* __restrict__ table, const int* __restrict__ idx,
                                                           float* __restrict__ out, int chans, int s, int n) {
  const int k = threadIdx.x % kWarp;
  const long long base = (static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x - k) * kShuffleLanes + k;
  // Every lane of the warp takes part in each vote and shuffle, past the end too.
  bool live[kShuffleLanes];
  int hi[kShuffleLanes], lo[kShuffleLanes];
#pragma unroll
  for (int m = 0; m < kShuffleLanes; ++m) {
    const long long lane = base + m * kWarp;
    live[m] = lane < n;
    const int j = live[m] ? wrap(__ldg(idx + lane), s) : 0;
    hi[m] = j / kWarp;
    lo[m] = j % kWarp;
  }
  const int pieces = (s + kWarp - 1) / kWarp;
  for (int c0 = 0; c0 < chans; c0 += kChanGroup) {
    const int group = min(kChanGroup, chans - c0);
    float acc[kChanGroup][kShuffleLanes] = {};
    for (int w = 0; w * kWarp < pieces; ++w) {
      unsigned bits = 0;
#pragma unroll
      for (int m = 0; m < kShuffleLanes; ++m) bits |= live[m] && hi[m] / kWarp == w ? 1u << (hi[m] % kWarp) : 0u;
      unsigned wanted = __reduce_or_sync(kFullMask, bits);
      while (wanted != 0) {  // warp-uniform
        const int p = w * kWarp + __ffs(wanted) - 1;
        wanted &= wanted - 1;
        const int e = p * kWarp + k;
        float held[kChanGroup];
#pragma unroll
        for (int c = 0; c < kChanGroup; ++c) {
          held[c] = c < group && e < s ? __ldg(table + (c0 + c) * static_cast<long long>(s) + e) : 0.0f;
        }
#pragma unroll
        for (int c = 0; c < kChanGroup; ++c) {
#pragma unroll
          for (int m = 0; m < kShuffleLanes; ++m) {
            const float got = __shfl_sync(kFullMask, held[c], lo[m]);
            if (hi[m] == p) acc[c][m] = got;
          }
        }
      }
    }
#pragma unroll
    for (int m = 0; m < kShuffleLanes; ++m) {
      if (!live[m]) continue;
#pragma unroll
      for (int c = 0; c < kChanGroup; ++c) {
        if (c < group) out[(c0 + c) * static_cast<long long>(n) + base + m * kWarp] = acc[c][m];
      }
    }
  }
}

int blocks_for(int n, int threads) { return (n + threads - 1) / threads; }

// gather_shared's grid: as many blocks as stay resident on the card at once
// (each walks lanes with a grid stride), so the table is staged once a block
// and not once per 512 lanes; never more blocks than lanes need.
int shared_grid(int n, int smem) {
  int device = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, gather_shared, kSharedThreads, smem) != cudaSuccess) {
    return -1;
  }
  const int grid = sms * (per_sm > 0 ? per_sm : 1);
  const int needed = blocks_for(n, kSharedThreads);
  return grid < needed ? grid : needed;
}

bool bad_args(int chans, int s, int n) { return chans < 1 || s < 1 || n < 1; }

}  // namespace

// Plain C entries, bound with ctypes (benchmarks/gather_probe.py
// _SIGNATURE).  Each launches on the given stream, does not synchronise,
// and returns cudaGetLastError() so the caller can raise on a refused
// launch.  The grid and occupancy entries answer for gather_shuffle.
extern "C" {

int prt_gather_shuffle_grid(int n) { return blocks_for(n, kThreads * kShuffleLanes); }

int prt_gather_global_f32(const float* table, const int* idx, float* out, int chans, int s, int n, void* stream) {
  if (bad_args(chans, s, n)) return static_cast<int>(cudaErrorInvalidValue);
  gather_global<<<blocks_for(n, kThreads), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, idx, out, chans,
                                                                                             s, n);
  return static_cast<int>(cudaGetLastError());
}

int prt_gather_shared_f32(const float* table, const int* idx, float* out, int chans, int s, int n, void* stream) {
  const long long bytes = static_cast<long long>(sizeof(float)) * chans * s;
  if (bad_args(chans, s, n) || bytes > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = static_cast<int>(bytes);
  if (const cudaError_t err = cudaFuncSetAttribute(gather_shared, cudaFuncAttributeMaxDynamicSharedMemorySize, smem)) {
    return static_cast<int>(err);
  }
  const int grid = shared_grid(n, smem);
  if (grid < 1) {
    const cudaError_t err = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : cudaErrorInvalidConfiguration);
  }
  gather_shared<<<grid, kSharedThreads, smem, static_cast<cudaStream_t>(stream)>>>(table, idx, out, chans, s, n);
  return static_cast<int>(cudaGetLastError());
}

int prt_gather_shuffle_f32(const float* table, const int* idx, float* out, int chans, int s, int n, void* stream) {
  if (bad_args(chans, s, n)) return static_cast<int>(cudaErrorInvalidValue);
  gather_shuffle<<<prt_gather_shuffle_grid(n), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(table, idx, out, chans,
                                                                                                 s, n);
  return static_cast<int>(cudaGetLastError());
}

// gather_shuffle's resident blocks per SM (it takes no dynamic shared
// memory), or a negative CUDA error; and its CTAs for n indices.
int prt_gather_shuffle_blocks_per_sm() {
  int blocks = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, gather_shuffle, kThreads, 0);
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

const char* prt_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

}  // extern "C"
