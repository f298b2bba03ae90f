// RG-LRU diagonal linear recurrence for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_rglru_kernel` / `rglru_scan` in
// src/repro/kernels/rglru_scan.py. Same function: h_t = a_t h_{t-1} + b_t
// over (B, L, W) with h_0 = 0, the state in fp32, a and b each fp32 or bf16,
// the output in b's dtype. Unlike the Pallas kernel it takes any L (the
// reference's XLA path does too); it does not chunk.
//
// Design. One thread per channel (b, w), neighbouring threads on
// neighbouring w, so that each step's loads and stores are coalesced; the
// state stays in a register for the whole sequence, taking the place of the
// TPU's VMEM-resident state and sequential chunk axis. Each thread loads U
// steps of a and b ahead (2U loads in flight) before it runs them, so that
// a load's latency is paid once per U steps instead of once per step. Blocks
// are one warp, so that the channels spread over as many SMs as there are
// warps (at W = 4096, B = 1: 128 warps on 132 SMs). U = 64 is the fastest
// of 16, 32 and 64 with the fp32 a and b that the model hands the kernel.
//
// Bound on an H100. The function reads a and b once and writes h once: at
// recurrentgemma-9b prefill (1, 4096, 4096) in fp32 that is 201 MB, 0.060 ms
// at 3.35 TB/s, with one FMA per 12 bytes, so the bound is the bytes. A
// thread per channel gives about one warp per SM, each running a 4096-step
// dependent loop: far too little memory parallelism to approach the byte
// rate. The way there is a chunked two-pass scan (per-chunk products and
// partial sums in parallel over chunks, then a short scan of the chunk
// carries), which puts many warps on every SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;  // one warp per block
constexpr int U = 64;        // steps loaded ahead (see the note above)

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TA, typename TB>
__global__ void __launch_bounds__(THREADS)
rglru_fwd(const TA* __restrict__ a, const TB* __restrict__ b, TB* __restrict__ out, int L,
          int W) {
  const int w = blockIdx.x * THREADS + threadIdx.x;
  if (w >= W) return;
  const size_t base = (size_t)blockIdx.y * L * W + w;
  a += base;
  b += base;
  out += base;
  float h = 0.f;
  for (int t0 = 0; t0 < L; t0 += U) {
    const int n = min(U, L - t0);
    float av[U], bv[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        av[u] = to_f32(a[(size_t)u * W]);
        bv[u] = to_f32(b[(size_t)u * W]);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (u < n) {
        h = av[u] * h + bv[u];
        out[(size_t)u * W] = from_f32<TB>(h);
      }
    }
    a += (size_t)U * W;
    b += (size_t)U * W;
    out += (size_t)U * W;
  }
}

template <typename TA, typename TB>
cudaError_t launch(const void* a, const void* b, void* out, int B, int L, int W,
                   cudaStream_t stream) {
  const dim3 grid((W + THREADS - 1) / THREADS, B);
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
