// Chunked Mamba-2 SSD scan (state-space duality) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_ssd_kernel` / `ssd_scan` in
// src/repro/kernels/ssd_scan.py. Same function: for x (B, L, H, P), dt
// (B, L, H), a (H,) and B, C (B, L, G, N), with head h reading group
// h * G / H, the sequence is cut into chunks of Q steps and, per chunk,
//   lcum_i = sum_{t <= i} dt_t a                         (inclusive cumsum)
//   y_i    = sum_{j <= i} (C_i . B_j) exp(lcum_i - lcum_j) dt_j x_j
//            + exp(lcum_i) C_i h^T                       (carried state)
//   h     <- exp(lcum_Q) h + sum_j exp(lcum_Q - lcum_j) dt_j x_j B_j^T
// with h (P, N) starting at 0. All arithmetic is fp32 on the CUDA cores;
// each operand is read in its own dtype (fp32 or bf16), y is written in x's
// dtype and the final state in fp32.
//
// Design. The Pallas grid is (B, H, chunks) with the chunk axis sequential
// and the state in VMEM scratch. Here one thread block owns (b, h, a slice
// of PS = 32 state rows p) and walks the chunks in a loop, the state slice
// staying in shared memory throughout. Slicing P is free for y's columns and
// the state's rows, which are separable in p; only C B^T is shared between
// slices, and each slice recomputes it. At mamba2-130m prefill (B = 2,
// H = 24, P = 64) that gives 96 blocks instead of 48 on the 132 SMs.
// A chunk does not fit on chip at once (at Q = 256, N = 128 the Q x Q gate
// alone is 256 KB in fp32), so it is tiled into 64-row query tiles and
// 64-row key tiles: per query tile, C rows stay in shared memory while the
// key tiles at or below the diagonal stream B and x dt through it; S = C B^T
// is formed in registers (4 x 4 per thread), masked and decayed into a
// shared G tile, and G (x dt) accumulates in registers. The exponential
// exp(lcum_i - lcum_j) is computed only for j <= i: above the diagonal it
// would overflow to inf, and inf * 0 is NaN. After all query tiles have read
// the old state, one more pass over the key tiles updates it. The cumsum is
// one warp's scan. Shared memory at N = 128: C, B tiles 33 KB each, x tile
// 9 KB, G tile 17 KB, state slice 17 KB, lcum and dt 2 KB: 113 KB, two
// blocks per SM.
//
// Bound on an H100. At mamba2-130m prefill (B = 2, L = 2048, H = 24, P = 64,
// N = 128, Q = 256, bf16 x/B/C) the work the function needs is about
// 8.1 GFLOP (the causal triangle of C B^T and of G x per chunk, the state
// term and the state update) against about 29 MB of inputs and outputs:
// ~8 us at the bf16 tensor-core rate and ~9 us at 3.35 TB/s, so the bound is
// the bytes. This first kernel is far from either: the products run in fp32
// on the CUDA cores (67 TFLOP/s peak for the whole card), limited by
// shared-memory loads (8 vector loads per 64 FMAs in C B^T), loads are
// synchronous with nothing in flight behind the products, C B^T is recomputed
// per P slice, and B and x are read again by every query tile (from L2).
// The way to the bound is tensor cores for C B^T and G x (bf16 operands,
// fp32 accumulate, where the tolerance allows it), a cp.async/TMA pipeline,
// and chunks spread over more blocks with a second pass for the state.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;  // 16 x 16: ty owns rows, tx owns columns
constexpr int TI = 64;        // query rows per tile
constexpr int TJ = 64;        // key rows per tile
constexpr int PS = 32;        // state rows p per block
constexpr int MAX_N = 128;    // state width held in registers by the update
constexpr int PAD = 4;        // row padding (floats): conflict-free float4 rows

// An input pointer with its dtype (0 = float32, 1 = bfloat16).
struct In {
  const void* p;
  int bf16;
};

__device__ __forceinline__ float ld(In t, size_t i) {
  return t.bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(t.p)[i])
                : static_cast<const float*>(t.p)[i];
}

__global__ void __launch_bounds__(THREADS)
ssd_fwd(In x, In dt, In a, In bm, In cm, void* __restrict__ y, int y_bf16,
        float* __restrict__ h_out, int L, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const int ldn = N + PAD;
  float* cs = reinterpret_cast<float*>(smem4);  // [TI][ldn]  C rows of the query tile
  float* bs = cs + TI * ldn;                    // [TJ][ldn]  B rows of the key tile
  float* hs = bs + TJ * ldn;                    // [PS][ldn]  state slice h[p][n]
  float* gs = hs + PS * ldn;                    // [TI][TJ + PAD] masked, decayed gate
  float* xs = gs + TI * (TJ + PAD);             // [TJ][PS + PAD] x (times a weight)
  float* lc = xs + TJ * (PS + PAD);             // [Q] inclusive cumsum of dt a
  float* dts = lc + Q;                          // [Q] dt of the chunk

  const int h = blockIdx.x, b = blockIdx.y, p0 = blockIdx.z * PS;
  const int g = h * G / H;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float ah = ld(a, h);
  const int ps = min(PS, P - p0);  // state rows of this slice
  const int ntiles = (Q + TI - 1) / TI;

  for (int e = tid; e < PS * ldn; e += THREADS) hs[e] = 0.f;

  for (int l0 = 0; l0 < L; l0 += Q) {
    const size_t row0 = (size_t)b * L + l0;  // (b, l0) as a row of (B * L)
    for (int t = tid; t < Q; t += THREADS) dts[t] = ld(dt, (row0 + t) * H + h);
    __syncthreads();
    if (tid < 32) {  // inclusive cumsum of dt a: serial per lane, then a warp scan
      const int seg = (Q + 31) / 32;
      const int t0 = min(tid * seg, Q), t1 = min(t0 + seg, Q);
      float run = 0.f;
      for (int t = t0; t < t1; ++t) run += dts[t] * ah;
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += up;
      }
      float acc = incl - run;
      for (int t = t0; t < t1; ++t) {
        acc += dts[t] * ah;
        lc[t] = acc;
      }
    }
    __syncthreads();

    // ---- outputs: one query tile at a time, against the old state ----
    for (int it = 0; it < ntiles; ++it) {
      const int i0 = it * TI;
      for (int e = tid; e < TI * N; e += THREADS) {
        const int r = e / N, n = e % N;
        cs[r * ldn + n] = (i0 + r < Q) ? ld(cm, ((row0 + i0 + r) * G + g) * N + n) : 0.f;
      }
      float acc[4][2] = {};  // y[i0 + ty*4 + i][p0 + tx + 16*jj]
      for (int jt = 0; jt <= it; ++jt) {
        const int j0 = jt * TJ;
        for (int e = tid; e < TJ * N; e += THREADS) {
          const int r = e / N, n = e % N;
          bs[r * ldn + n] = (j0 + r < Q) ? ld(bm, ((row0 + j0 + r) * G + g) * N + n) : 0.f;
        }
        for (int e = tid; e < TJ * PS; e += THREADS) {
          const int r = e / PS, p = e % PS;
          xs[r * (PS + PAD) + p] =
              (j0 + r < Q && p < ps) ? ld(x, ((row0 + j0 + r) * H + h) * P + p0 + p) * dts[j0 + r]
                                     : 0.f;
        }
        __syncthreads();
        // S = C B^T for rows ty*4 + i, keys tx + 16*jj
        float s[4][4] = {};
        for (int n = 0; n < N; n += 4) {
          float4 cv[4], bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            cv[i] = *reinterpret_cast<const float4*>(cs + (ty * 4 + i) * ldn + n);
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            bv[jj] = *reinterpret_cast<const float4*>(bs + (tx + 16 * jj) * ldn + n);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int jj = 0; jj < 4; ++jj)
            {
              s[i][jj] += cv[i].x * bv[jj].x;
              s[i][jj] += cv[i].y * bv[jj].y;
              s[i][jj] += cv[i].z * bv[jj].z;
              s[i][jj] += cv[i].w * bv[jj].w;
            }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qi = i0 + ty * 4 + i;
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const int kj = j0 + tx + 16 * jj;
            // the decay only where it is needed: above the diagonal it overflows
            const float gate = (kj <= qi && qi < Q) ? s[i][jj] * expf(lc[qi] - lc[kj]) : 0.f;
            gs[(ty * 4 + i) * (TJ + PAD) + tx + 16 * jj] = gate;
          }
        }
        __syncthreads();
        // y += G (x dt)
        for (int j = 0; j < TJ; j += 4) {
          float4 gv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i)
            gv[i] = *reinterpret_cast<const float4*>(gs + (ty * 4 + i) * (TJ + PAD) + j);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const float* xc = xs + j * (PS + PAD) + tx + 16 * jj;
            const float x0 = xc[0], x1 = xc[PS + PAD], x2 = xc[2 * (PS + PAD)],
                        x3 = xc[3 * (PS + PAD)];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              acc[i][jj] += gv[i].x * x0;
              acc[i][jj] += gv[i].y * x1;
              acc[i][jj] += gv[i].z * x2;
              acc[i][jj] += gv[i].w * x3;
            }
          }
        }
        __syncthreads();  // before the next key tile overwrites bs, xs, gs
      }
      // carried state: y += exp(lcum_i) C_i h^T
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = ty * 4 + i;
        const float decay = (i0 + r < Q) ? expf(lc[i0 + r]) : 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const float* hr = hs + (tx + 16 * jj) * ldn;
          float dot = 0.f;
          for (int n = 0; n < N; n += 4) {
            const float4 c4 = *reinterpret_cast<const float4*>(cs + r * ldn + n);
            const float4 h4 = *reinterpret_cast<const float4*>(hr + n);
            dot += c4.x * h4.x;
            dot += c4.y * h4.y;
            dot += c4.z * h4.z;
            dot += c4.w * h4.w;
          }
          acc[i][jj] += decay * dot;
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qi = i0 + ty * 4 + i;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int p = tx + 16 * jj;
          if (qi < Q && p < ps) {
            const size_t off = ((row0 + qi) * H + h) * P + p0 + p;
            if (y_bf16)
              static_cast<__nv_bfloat16*>(y)[off] = __float2bfloat16(acc[i][jj]);
            else
              static_cast<float*>(y)[off] = acc[i][jj];
          }
        }
      }
      __syncthreads();  // before the next query tile overwrites cs
    }

    // ---- state update: h <- exp(ltot) h + sum_j exp(ltot - lcum_j) dt_j x_j B_j^T ----
    const float ltot = lc[Q - 1];
    const float keep = expf(ltot);
    float hacc[2][MAX_N / 16];  // h[ty*2 + i][tx + 16*m]
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int m = 0; m < MAX_N / 16; ++m) {
        const int n = tx + 16 * m;
        hacc[i][m] = (n < N) ? hs[(ty * 2 + i) * ldn + n] * keep : 0.f;
      }
    for (int jt = 0; jt < ntiles; ++jt) {
      const int j0 = jt * TJ;
      for (int e = tid; e < TJ * N; e += THREADS) {
        const int r = e / N, n = e % N;
        bs[r * ldn + n] = (j0 + r < Q) ? ld(bm, ((row0 + j0 + r) * G + g) * N + n) : 0.f;
      }
      for (int e = tid; e < TJ * PS; e += THREADS) {
        const int r = e / PS, p = e % PS;
        const int t = j0 + r;
        xs[r * (PS + PAD) + p] =
            (t < Q && p < ps)
                ? ld(x, ((row0 + t) * H + h) * P + p0 + p) * expf(ltot - lc[t]) * dts[t]
                : 0.f;
      }
      __syncthreads();
      for (int j = 0; j < TJ; ++j) {
        const float2 xw = *reinterpret_cast<const float2*>(xs + j * (PS + PAD) + ty * 2);
#pragma unroll
        for (int m = 0; m < MAX_N / 16; ++m) {
          const int n = tx + 16 * m;
          const float bv = (n < N) ? bs[j * ldn + n] : 0.f;
          hacc[0][m] += xw.x * bv;
          hacc[1][m] += xw.y * bv;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int m = 0; m < MAX_N / 16; ++m) {
        const int n = tx + 16 * m;
        if (n < N) hs[(ty * 2 + i) * ldn + n] = hacc[i][m];
      }
    __syncthreads();
  }

  for (int e = tid; e < ps * N; e += THREADS) {
    const int p = e / N, n = e % N;
    h_out[(((size_t)b * H + h) * P + p0 + p) * N + n] = hs[p * ldn + n];
  }
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16; y takes x's. Returns the CUDA
// error of the launch (0 on success); it does not synchronise.
extern "C" int ssd_scan_fwd(const void* x, int x_dtype, const void* dt, int dt_dtype,
                            const void* a, int a_dtype, const void* bm, int b_dtype,
                            const void* cm, int c_dtype, void* y, float* h_out, int B, int L,
                            int H, int P, int G, int N, int Q, int device, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 4 || N > MAX_N ||
      N % 4 != 0 || Q < 1 || L % Q != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(float) * ((size_t)(TI + TJ + PS) * (N + PAD) + (size_t)TI * (TJ + PAD) +
                       (size_t)TJ * (PS + PAD) + 2 * (size_t)Q);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(ssd_fwd, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(H, B, (P + PS - 1) / PS);
  ssd_fwd<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      In{x, x_dtype}, In{dt, dt_dtype}, In{a, a_dtype}, In{bm, b_dtype}, In{cm, c_dtype}, y,
      x_dtype, h_out, L, H, P, G, N, Q);
  return (int)cudaGetLastError();
}
