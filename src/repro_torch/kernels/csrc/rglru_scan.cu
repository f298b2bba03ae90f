// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan.py. Same function: h_t = a_t h_{t-1} + b_t
// over (B, L, W) with h_0 = 0, the state in fp32, a and b each fp32 or bf16,
// the output in b's dtype. Unlike the Pallas kernel it takes any L (the
// reference's XLA path does too).
//
// Bound on an H100. The function reads a and b once and writes h once: at
// recurrentgemma-9b prefill (1, 4096, 4096) in fp32 that is 201.33 MB,
// 0.0601 ms at 3.35 TB/s, against one FMA per 12 bytes, so the bound is the
// bytes. This kernel moves exactly those bytes: a and b are read once, into
// registers, and h is written once. A design that wrote per-chunk carries
// and read a and b a second time to apply them would move 335 MB, a floor
// of 0.10 ms.
//
// Design. One block per (batch, 32 consecutive channels): a warp's lanes are
// 32 neighbouring channels, so each step's load and store is one 128-byte
// line (64 bytes in bf16). At W = 4096, B = 1 that is 128 blocks, one per
// SM; blocks never wait on each other. Inside the block the time axis is
// split over NW warps, each a run of T consecutive steps, one tile = NW * T
// steps. For each tile every thread
//   1. has all T steps of its channel's a and b in registers (loaded while
//      the previous tile was scanned, see below);
//   2. runs its run's recurrence from 0, h = a h + b, and the product of a;
//   3. writes that aggregate to shared memory; one __syncthreads;
//   4. folds the aggregates of the warps before it, from the block's carry,
//      into its carry-in, and all NW into the next tile's carry (each warp
//      does the whole fold itself, so no second barrier: the aggregates are
//      double-buffered by tile parity);
//   5. re-runs its T steps from the carry-in out of the same registers, in
//      the sequential order (h = a h + b in fp32), and stores h.
// The re-run costs T more FMAs and no bytes. The tile loop is unrolled by
// two over two register buffers, so the next tile's 2T loads per thread are
// in flight while this tile is scanned: a tile of 256 steps keeps 64 KB of
// loads in flight on each SM (32 KB in bf16) through the barrier and the
// fold, where a load-then-scan loop would leave the memory idle.
//
// Why the fold runs in fp64. With long memory (a near 1) a rounding error in
// a carry is never forgotten, and the fold adds roundings at the scale of
// the whole state to every later step. At a = 1, (1, 4133, 4096), the fold
// in fp32 put the kernel at 0.945 of the 2e-5 (1 + |h|) tolerance from the
// plain log-depth scan (0.623 from an fp64 loop); in fp64 (the aggregates,
// the fold and the block's carry; one conversion each way per run) at 0.741
// (0.540). The state that steps through time, h = a h + b, stays fp32 as in
// the TPU kernel; only each run's carry-in is summed more exactly. That
// costs 0.0015 ms of 0.074 in fp32 and 0.004 of 0.054 in bf16 (below): a
// margin against a tolerance that fp32 cannot otherwise keep is worth it.
//
// Measured alternatives (scripts/kernel_variants.py, one H100 80GB HBM3 at
// 700 W, device ms at (1, 4096, 4096) fp32 / bf16, medians of five rounds in
// one call): this schedule, NW = 16, T = 16, 0.0743 / 0.0540; the fold in
// fp32 0.0728 / 0.0498; without the next tile's loads in flight 0.0811 /
// 0.0641; that load-then-scan loop at T = 32, 0.1710 / 0.0681 (400 B of
// spills at 128 registers); NW = 8, T = 32, 0.0755 / 0.0549; NW = 32,
// T = 8, 0.0913 / 0.0856 (spills at 64 registers); loads that ask L2 for
// 256 bytes 0.0742 / 0.0536 and streaming cache hints 0.0786 / 0.0543, no
// gain; neither barrier nor fold (wrong outputs) 0.0755 / 0.0411. An
// elementwise torch.add(a, b), which moves the same bytes, takes 0.0688 /
// 0.0361 ms against this kernel's 0.0756 / 0.0556 (CUDA events,
// chip_smoke.py): in fp32 the scan runs at 91 % of its rate, bound by the
// memory traffic (dropping the barrier and the fold does not speed it up),
// and in bf16 the per-tile barrier and fold, not the bytes, set the time.
// ptxas: 114 / 120 / 120 / 128 registers for (a, b) in fp32/fp32,
// fp32/bf16, bf16/fp32, bf16/bf16, no spills.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int NW = 16;         // warps per block, each a run of T steps
constexpr int T = 16;          // steps per warp run
constexpr int TILE = NW * T;   // steps per tile
constexpr int THREADS = NW * 32;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T_> __device__ __forceinline__ T_ from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Issue the T loads of a and b of the run that starts at step t0; steps past
// L and lanes past W read nothing and hold 0.
template <typename TA, typename TB>
__device__ __forceinline__ void load_run(TA (&av)[T], TB (&bv)[T], const TA* __restrict__ a,
                                         const TB* __restrict__ b, int t0, int L, int W,
                                         bool live) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const bool ok = live && t0 + u < L;
    const size_t off = (size_t)(t0 + u) * W;
    av[u] = ok ? a[off] : from_f32<TA>(0.f);
    bv[u] = ok ? b[off] : from_f32<TB>(0.f);
  }
}

// One tile: the run's aggregate, the fold over the warps (fp64), the re-run.
template <int PARITY, typename TA, typename TB>
__device__ __forceinline__ void scan_run(const TA (&av)[T], const TB (&bv)[T],
                                         TB* __restrict__ out, int t0, int L, int W, bool live,
                                         double& carry, double2 (&agg)[2][NW][32], int warp,
                                         int lane) {
  float p = 1.f, h = 0.f;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const float x = to_f32(av[u]);
    p *= x;
    h = fmaf(x, h, to_f32(bv[u]));
  }
  agg[PARITY][warp][lane] = make_double2(p, h);
  __syncthreads();
  // (pp, hp): the runs before warp j composed from the identity
  double pp = 1.0, hp = 0.0, cin = 0.0;
#pragma unroll
  for (int j = 0; j < NW; ++j) {
    if (j == warp) cin = fma(pp, carry, hp);
    const double2 g = agg[PARITY][j][lane];
    hp = fma(g.x, hp, g.y);
    pp *= g.x;
  }
  carry = fma(pp, carry, hp);
  h = (float)cin;
#pragma unroll
  for (int u = 0; u < T; ++u) {
    h = fmaf(to_f32(av[u]), h, to_f32(bv[u]));
    if (live && t0 + u < L) out[(size_t)(t0 + u) * W] = from_f32<TB>(h);
  }
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS, 1)
rglru_fwd(const TA* __restrict__ a, const TB* __restrict__ b, TB* __restrict__ out, int L,
          int W) {
  __shared__ double2 agg[2][NW][32];  // (product of a, h from 0) per warp run
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int w = blockIdx.x * 32 + lane;
  const bool live = w < W;
  const size_t base = (size_t)blockIdx.y * L * W + (live ? w : 0);
  a += base;
  b += base;
  out += base;
  const int ntiles = (L + TILE - 1) / TILE;
  const int t_run = warp * T;  // this warp's first step within a tile
  double carry = 0.0;
  TA a0[T], a1[T];
  TB b0[T], b1[T];
  load_run(a0, b0, a, b, t_run, L, W, live);
  for (int k = 0; k < ntiles; k += 2) {
    const int t0 = k * TILE + t_run;
    if (k + 1 < ntiles) load_run(a1, b1, a, b, t0 + TILE, L, W, live);
    scan_run<0>(a0, b0, out, t0, L, W, live, carry, agg, warp, lane);
    if (k + 1 == ntiles) break;
    if (k + 2 < ntiles) load_run(a0, b0, a, b, t0 + 2 * TILE, L, W, live);
    scan_run<1>(a1, b1, out, t0 + TILE, L, W, live, carry, agg, warp, lane);
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* out, int B, int L, int W,
                   cudaStream_t stream) {
  const dim3 grid((W + 31) / 32, B);
  rglru_fwd<TA, TB><<<grid, THREADS, 0, stream>>>(static_cast<const TA*>(a),
                                                  static_cast<const TB*>(b),
                                                  static_cast<TB*>(out), L, W);
  return cudaGetLastError();
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16; the output takes b's. Returns the
// CUDA error of the launch (0 on success); it does not synchronise.
extern "C" int rglru_scan_fwd(const void* a, int a_dtype, const void* b, int b_dtype, void* out,
                              int B, int L, int W, int device, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || W < 1) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (a_dtype == 0 && b_dtype == 0) return (int)launch<float, float>(a, b, out, B, L, W, st);
  if (a_dtype == 0 && b_dtype == 1)
    return (int)launch<float, __nv_bfloat16>(a, b, out, B, L, W, st);
  if (a_dtype == 1 && b_dtype == 0)
    return (int)launch<__nv_bfloat16, float>(a, b, out, B, L, W, st);
  if (a_dtype == 1 && b_dtype == 1)
    return (int)launch<__nv_bfloat16, __nv_bfloat16>(a, b, out, B, L, W, st);
  return (int)cudaErrorInvalidValue;
}
