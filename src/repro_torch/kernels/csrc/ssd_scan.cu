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
// with h (P, N) starting at 0. y is written in x's dtype and the final state
// in fp32.
//
// Two variants, chosen by the wrapper before the launch from what the inputs
// are: the model's bf16 x/B/C with fp32 dt/a (and P, N multiples of 16, a
// chunk of at most 256) run the chunk-parallel tensor-core passes at the end
// of this file; everything else, fp32 in particular (held at 2e-4, which no
// bf16 or TF32 product meets), runs `ssd_fwd`, all fp32 on the CUDA cores,
// each operand read in its own dtype.
//
// Design of `ssd_fwd`. The Pallas grid is (B, H, chunks) with the chunk axis sequential
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
// the bytes. `ssd_fwd` is far from either: the products run in fp32 on the
// CUDA cores (67 TFLOP/s peak for the whole card), limited by shared-memory
// loads (8 vector loads per 64 FMAs in C B^T), loads are synchronous with
// nothing in flight behind the products, C B^T is recomputed per P slice,
// and the 96 blocks walk the chunks in order. The tensor-core variant spreads
// (b, h, chunk) over 384 blocks and moves the products to mma.sync; what it
// adds on the way is the chunk states' fp32 round trip through L2 (12.6 MB
// written and read twice at that shape).

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

// ---------------------------------------------------------------------------
// bf16 x/B/C with fp32 dt/a: chunk-parallel passes on the tensor cores
// ---------------------------------------------------------------------------
//
// The chunks no longer wait for each other's products. Three launches:
//  1. `ssd_chunk_state`, one block of 8 warps per (b, h, chunk): the chunk's
//     own state S_c = (x o w)^T B with w_j = exp(lcum_Q - lcum_j) dt_j, a
//     (P x Q)(Q x N) product on the tensor cores (x w rounded to bf16, B bf16,
//     fp32 accumulate), and the chunk's total log-decay lcum_Q.
//  2. `ssd_state_pass`, one thread per (b, h, p, n): h_c = exp(lcum_Q,c)
//     h_{c-1} + S_c in fp32, walking the chunks in order; the state entering
//     each chunk overwrites S_c in place, and the last one is the final state.
//  3. `ssd_chunk_scan`, one block per (b, h, chunk), 8 warps of two 16-row
//     query slabs each (slabs w and 15 - w, so that the triangle's work is
//     even). First the carried state's term exp(lcum_i) C h_in^T, with h_in
//     split into bf16 hi + lo parts so that the fp32 state loses nothing a
//     bf16 product would (two products with the same C fragments); it needs
//     only C and h_in, and runs while B and x are still landing. Then, per
//     tile of 64 keys up to the diagonal, C B^T on the tensor cores for the
//     tile's 16-key blocks (up to 8 accumulators in flight), decayed and
//     scaled by dt in registers (the mask, and the exponential's guard, only
//     on the diagonal block), rounded to bf16 as the A operand of G x. y is
//     stored in bf16.
// Products are mma.sync m16n8k16 fed by ldmatrix (with .trans where the
// operand is stored the other way round); whole chunks of C, B and x are
// loaded with cp.async (mma.sync, not wgmma: the products are small, 5 GFLOP
// at mamba2-130m's prefill, and the bound is the bytes). C B^T is recomputed
// per head: at mamba2-130m's single group that is 24 times the minimum, about
// 3 GFLOP of tensor-core work, traded against sharing it across heads
// through L2 or registers.

constexpr int TC_MAXP = 64;    // head width held in the accumulators
constexpr int TC_MAXN = 128;   // state width held in the C fragments
constexpr int TC_MAXQ = 256;   // 16 query slabs of 16 rows
constexpr int TC_PADE = 8;     // bf16 row padding: 16 bytes, conflict-free ldmatrix
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {  // until at most N groups are in flight
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}


__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// dt of the chunk into dts[0, Q) and the inclusive cumsum of dt a into
// lc[0, Q); rows [Q, Qp) get dt 0 and the last cumsum, so that padded rows
// and keys stay finite and contribute nothing. Ends with __syncthreads.
__device__ void chunk_cumsum(const float* __restrict__ dt, size_t row0, int H, int h, float ah,
                             int Q, int Qp, float* lc, float* dts) {
  for (int t = threadIdx.x; t < Qp; t += blockDim.x)
    dts[t] = t < Q ? dt[(row0 + t) * H + h] : 0.f;
  __syncthreads();
  if (threadIdx.x < 32) {  // serial per lane, then a warp scan
    const int lane = threadIdx.x, seg = (Q + 31) / 32;
    const int t0 = min(lane * seg, Q), t1 = min(t0 + seg, Q);
    float run = 0.f;
    for (int t = t0; t < t1; ++t) run += dts[t] * ah;
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += up;
    }
    float acc = incl - run;
    for (int t = t0; t < t1; ++t) {
      acc += dts[t] * ah;
      lc[t] = acc;
    }
  }
  __syncthreads();
  for (int t = Q + threadIdx.x; t < Qp; t += blockDim.x) lc[t] = lc[Q - 1];
  __syncthreads();
}

// `rows` rows of `width` bf16 (a multiple of 8) from global rows `stride`
// elements apart into shared rows of width + TC_PADE, by 16-byte cp.async;
// rows [rows, rows_p) are zeroed.
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                          size_t stride, int rows, int rows_p, int width) {
  const int vec = width / 8, ld = width + TC_PADE;
  for (int e = threadIdx.x; e < rows_p * vec; e += blockDim.x) {
    const int r = e / vec, c = (e - r * vec) * 8;
    if (r < rows)
      cp_async16(dst + r * ld + c, src + r * stride + c);
    else
      *reinterpret_cast<uint4*>(dst + r * ld + c) = make_uint4(0, 0, 0, 0);
  }
}

__global__ void __launch_bounds__(256)
ssd_chunk_state(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
                float* __restrict__ states, float* __restrict__ ltot, int L, int H, int P, int G,
                int N, int Q) {
  extern __shared__ float4 smem4[];
  const int Qp = (Q + 15) / 16 * 16, nc = L / Q;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, g = h * G / H;
  const int ldx = P + TC_PADE, ldb = N + TC_PADE;
  __nv_bfloat16* xw = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Qp][ldx] x w
  __nv_bfloat16* bs = xw + Qp * ldx;                             // [Qp][ldb] B
  float* lc = reinterpret_cast<float*>(bs + Qp * ldb);            // [Qp]
  float* dts = lc + Qp;                                           // [Qp]
  const size_t row0 = (size_t)b * L + (size_t)c * Q;

  load_rows(bs, bm + (row0 * G + g) * N, (size_t)G * N, Q, Qp, N);
  load_rows(xw, x + row0 * H * P + (size_t)h * P, (size_t)H * P, Q, Qp, P);
  chunk_cumsum(dt, row0, H, h, a[h], Q, Qp, lc, dts);
  // w_j = exp(lcum_Q - lcum_j) dt_j, in place of dt
  const float last = lc[Q - 1];
  for (int t = threadIdx.x; t < Q; t += blockDim.x) dts[t] *= expf(last - lc[t]);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  // x -> x w in place, 8 columns at a time
  for (int e = threadIdx.x; e < Q * (P / 8); e += blockDim.x) {
    const int t = e / (P / 8), p = (e - t * (P / 8)) * 8;
    const float w = dts[t];
    uint4* xv = reinterpret_cast<uint4*>(xw + t * ldx + p);
    uint4 raw = *xv;
    uint32_t* r = reinterpret_cast<uint32_t*>(&raw);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(r + i));
      r[i] = pack_bf16(f.x * w, f.y * w);
    }
    *xv = raw;
  }
  __syncthreads();

  // warp w: state rows [16 (w % 4), + 16), state columns [64 (w / 4), + 64)
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int p0 = 16 * (warp % 4), n0 = 64 * (warp / 4);
  if (p0 < P && n0 < N) {
    float acc[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][e] = 0.f;
    const int mi = lane / 8, r8 = lane % 8;
    for (int j0 = 0; j0 < Qp; j0 += 16) {
      uint32_t af[4];  // A[p][j] = (x w)[j][p]: stored transposed
      ldsm_x4_t(af, xw + (j0 + (mi / 2) * 8 + r8) * ldx + p0 + (mi % 2) * 8);
#pragma unroll
      for (int n2 = 0; n2 < 4; ++n2) {
        if (n0 + 16 * n2 < N) {
          uint32_t bf[4];  // B[j][n], k = j: stored k-major, read transposed
          ldsm_x4_t(bf, bs + (j0 + (mi % 2) * 8 + r8) * ldb + n0 + 16 * n2 + (mi / 2) * 8);
          mma_16816(acc[2 * n2], af, bf[0], bf[1]);
          mma_16816(acc[2 * n2 + 1], af, bf[2], bf[3]);
        }
      }
    }
    const int gq = lane / 4, tq = lane % 4;
    float* out = states + (((size_t)b * H + h) * nc + c) * P * N;
#pragma unroll
    for (int nb = 0; nb < 8; ++nb) {
      if (n0 + 8 * nb < N) {
        const int n = n0 + 8 * nb + 2 * tq;
        *reinterpret_cast<float2*>(out + (p0 + gq) * N + n) = make_float2(acc[nb][0], acc[nb][1]);
        *reinterpret_cast<float2*>(out + (p0 + gq + 8) * N + n) =
            make_float2(acc[nb][2], acc[nb][3]);
      }
    }
  }
  if (threadIdx.x == 0) ltot[((size_t)b * H + h) * nc + c] = last;
}

__global__ void __launch_bounds__(256)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ ltot,
               float* __restrict__ h_out, int H, int PN, int nc) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= PN) return;
  const size_t bh = (size_t)blockIdx.z * H + blockIdx.y;
  float* s = states + bh * nc * PN + e;
  float hc = 0.f;
  for (int c0 = 0; c0 < nc; c0 += 8) {  // 8 chunks' loads in flight at once
    float own[8], keep[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < nc) {
        own[i] = s[(size_t)(c0 + i) * PN];
        keep[i] = expf(ltot[bh * nc + c0 + i]);
      }
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (c0 + i < nc) {
        s[(size_t)(c0 + i) * PN] = hc;  // the state entering chunk c0 + i
        hc = keep[i] * hc + own[i];
      }
  }
  h_out[bh * PN + e] = hc;
}

// P, N: head and state widths, multiples of 16 up to 64 and 128. They are
// compile-time values: the guards and addresses of the unrolled products
// then cost nothing, which takes a third off this kernel's time.
template <int P, int N>
__global__ void __launch_bounds__(256)
ssd_chunk_scan(const __nv_bfloat16* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ a, const __nv_bfloat16* __restrict__ bm,
               const __nv_bfloat16* __restrict__ cm, const float* __restrict__ states,
               __nv_bfloat16* __restrict__ y, int L, int H, int G, int Q) {
  extern __shared__ float4 smem4[];
  const int Qp = (Q + 15) / 16 * 16, nc = L / Q;
  const int h = blockIdx.x, c = blockIdx.y, b = blockIdx.z, g = h * G / H;
  const int ldn = N + TC_PADE, ldx = P + TC_PADE;
  __nv_bfloat16* cs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [Qp][ldn] C
  __nv_bfloat16* bs = cs + Qp * ldn;                             // [Qp][ldn] B
  __nv_bfloat16* xs = bs + Qp * ldn;                             // [Qp][ldx] x
  __nv_bfloat16* hh = xs + Qp * ldx;                             // [P][ldn] h_in, bf16 hi
  __nv_bfloat16* hl = hh + P * ldn;                              // [P][ldn] h_in - hi
  float* lc = reinterpret_cast<float*>(hl + P * ldn);            // [Qp]
  float* dts = lc + Qp;                                          // [Qp]
  const size_t row0 = (size_t)b * L + (size_t)c * Q;

  load_rows(cs, cm + (row0 * G + g) * N, (size_t)G * N, Q, Qp, N);
  cp_async_commit();  // C: the carried state's term needs only C and h_in
  load_rows(bs, bm + (row0 * G + g) * N, (size_t)G * N, Q, Qp, N);
  load_rows(xs, x + row0 * H * P + (size_t)h * P, (size_t)H * P, Q, Qp, P);
  cp_async_commit();  // B and x, for the intra-chunk term
  // h_in (fp32) -> bf16 hi and lo parts; all of a thread's loads in flight at once
  const float* hin = states + (((size_t)b * H + h) * nc + c) * P * N;
  constexpr int HV = (P * N / 4 + 255) / 256;  // float4 per thread
  float4 hv[HV];
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int e = threadIdx.x + 256 * i;
    if (e < P * N / 4) hv[i] = *reinterpret_cast<const float4*>(hin + 4 * e);
  }
#pragma unroll
  for (int i = 0; i < HV; ++i) {
    const int e = threadIdx.x + 256 * i;
    if (e >= P * N / 4) continue;
    const int p = e / (N / 4), n = (e - p * (N / 4)) * 4;
    const float4 v = hv[i];
    const __nv_bfloat162 hi01 = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 hi23 = __floats2bfloat162_rn(v.z, v.w);
    const float2 f01 = __bfloat1622float2(hi01), f23 = __bfloat1622float2(hi23);
    *reinterpret_cast<uint2*>(hh + p * ldn + n) =
        make_uint2(*reinterpret_cast<const uint32_t*>(&hi01),
                   *reinterpret_cast<const uint32_t*>(&hi23));
    *reinterpret_cast<uint2*>(hl + p * ldn + n) =
        make_uint2(pack_bf16(v.x - f01.x, v.y - f01.y), pack_bf16(v.z - f23.x, v.w - f23.y));
  }
  chunk_cumsum(dt, row0, H, h, a[h], Q, Qp, lc, dts);
  cp_async_wait<1>();  // C has landed; B and x may still be in flight
  __syncthreads();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int mi = lane / 8, r8 = lane % 8, gq = lane / 4, tq = lane % 4;
  const int nslab = Qp / 16;
  // each warp owns slabs w and 15 - w, 16 query rows each
  float acc[2][P / 8][4];
  uint32_t cf[N / 16][4];  // a slab's C as the A operand, all of N
  auto load_cf = [&](int i0) {
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk)
      ldsm_x4(cf[kk], cs + (i0 + (mi % 2) * 8 + r8) * ldn + 16 * kk + (mi / 2) * 8);
  };

  // carried state, C and h_in only (B and x may still be landing):
  // y_i = exp(lcum_i) (C h_in^T)_i, with h_in = hi + lo
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int i = 0; i < P / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[half][i][e] = 0.f;
    const int slab = half == 0 ? warp : 15 - warp;
    if (slab >= nslab) continue;
    const int i0 = 16 * slab;
    load_cf(i0);
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
      for (int p2 = 0; p2 < P / 16; ++p2) {
        const int off = (16 * p2 + (mi / 2) * 8 + r8) * ldn + 16 * kk + (mi % 2) * 8;
        uint32_t bf[4];
        ldsm_x4(bf, hh + off);
        mma_16816(acc[half][2 * p2], cf[kk], bf[0], bf[1]);
        mma_16816(acc[half][2 * p2 + 1], cf[kk], bf[2], bf[3]);
        ldsm_x4(bf, hl + off);
        mma_16816(acc[half][2 * p2], cf[kk], bf[0], bf[1]);
        mma_16816(acc[half][2 * p2 + 1], cf[kk], bf[2], bf[3]);
      }
    }
    const float da = expf(lc[i0 + gq]), db = expf(lc[i0 + gq + 8]);
#pragma unroll
    for (int i = 0; i < P / 8; ++i) {
      acc[half][i][0] *= da;
      acc[half][i][1] *= da;
      acc[half][i][2] *= db;
      acc[half][i][3] *= db;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // intra-chunk, per tile of 64 keys up to the diagonal: G = (C B^T) o decay
  // o dt over the tile's 16-key blocks at or below the diagonal, then G x.
  // The blocks' products are independent, so that up to 8 accumulators are
  // in flight.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int slab = half == 0 ? warp : 15 - warp;
    if (slab >= nslab) continue;
    const int i0 = 16 * slab;
    const int ia = i0 + gq, ib = ia + 8;  // this thread's two rows
    const float lca = lc[ia], lcb = lc[ib];
    load_cf(i0);
    for (int j0 = 0; j0 <= i0; j0 += 64) {
      const int nkb = min(4, (i0 - j0) / 16 + 1);  // 16-key blocks of this tile in use
      float sc[8][4];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[i][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
#pragma unroll
        for (int kb = 0; kb < 4; ++kb) {
          if (kb >= nkb) continue;
          uint32_t bf[4];  // B[j][n] as the B operand of C B^T (k = n): k-major
          ldsm_x4(bf, bs + (j0 + 16 * kb + (mi / 2) * 8 + r8) * ldn + 16 * kk + (mi % 2) * 8);
          mma_16816(sc[2 * kb], cf[kk], bf[0], bf[1]);
          mma_16816(sc[2 * kb + 1], cf[kk], bf[2], bf[3]);
        }
      }
#pragma unroll
      for (int kb = 0; kb < 4; ++kb) {
        if (kb >= nkb) continue;
        uint32_t ga[4];
        const bool diagonal = j0 + 16 * kb == i0;  // the only block that needs the mask
#pragma unroll
        for (int nb = 0; nb < 2; ++nb)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = e < 2 ? ia : ib, j = j0 + 16 * kb + 8 * nb + 2 * tq + (e & 1);
            float& v = sc[2 * kb + nb][e];
            // the decay only where it is needed: above the diagonal it overflows
            const float w = exp2f(((e < 2 ? lca : lcb) - lc[j]) * kLog2e) * dts[j];
            v = (!diagonal || j <= i) ? v * w : 0.f;
          }
        ga[0] = pack_bf16(sc[2 * kb][0], sc[2 * kb][1]);
        ga[1] = pack_bf16(sc[2 * kb][2], sc[2 * kb][3]);
        ga[2] = pack_bf16(sc[2 * kb + 1][0], sc[2 * kb + 1][1]);
        ga[3] = pack_bf16(sc[2 * kb + 1][2], sc[2 * kb + 1][3]);
#pragma unroll
        for (int p2 = 0; p2 < P / 16; ++p2) {
          uint32_t xf[4];  // x[j][p] as the B operand of G x (k = j): stored transposed
          ldsm_x4_t(xf, xs + (j0 + 16 * kb + (mi % 2) * 8 + r8) * ldx + 16 * p2 + (mi / 2) * 8);
          mma_16816(acc[half][2 * p2], ga, xf[0], xf[1]);
          mma_16816(acc[half][2 * p2 + 1], ga, xf[2], xf[3]);
        }
      }
    }

#pragma unroll
    for (int pb = 0; pb < P / 8; ++pb) {
      const int p = 8 * pb + 2 * tq;
      if (ia < Q)
        *reinterpret_cast<uint32_t*>(y + ((row0 + ia) * H + h) * P + p) =
            pack_bf16(acc[half][pb][0], acc[half][pb][1]);
      if (ib < Q)
        *reinterpret_cast<uint32_t*>(y + ((row0 + ib) * H + h) * P + p) =
            pack_bf16(acc[half][pb][2], acc[half][pb][3]);
    }
  }
}

size_t tc_state_smem(int P, int N, int Q) {
  const size_t Qp = (Q + 15) / 16 * 16;
  return 2 * Qp * (P + TC_PADE) + 2 * Qp * (N + TC_PADE) + 8 * Qp;
}

size_t tc_scan_smem(int P, int N, int Q) {
  const size_t Qp = (Q + 15) / 16 * 16;
  return 2 * (2 * Qp * (N + TC_PADE) + Qp * (P + TC_PADE) + 2 * (size_t)P * (N + TC_PADE)) +
         8 * Qp;
}

template <int P, int N>
cudaError_t launch_scan(dim3 grid, size_t smem, cudaStream_t stream, const __nv_bfloat16* x,
                        const float* dt, const float* a, const __nv_bfloat16* bm,
                        const __nv_bfloat16* cm, const float* states, __nv_bfloat16* y, int L,
                        int H, int G, int Q) {
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_scan<P, N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  ssd_chunk_scan<P, N><<<grid, 256, smem, stream>>>(x, dt, a, bm, cm, states, y, L, H, G, Q);
  return cudaGetLastError();
}

template <int P, typename... Args>
cudaError_t launch_scan_n(int N, Args... args) {
  switch (N) {
    case 16: return launch_scan<P, 16>(args...);
    case 32: return launch_scan<P, 32>(args...);
    case 48: return launch_scan<P, 48>(args...);
    case 64: return launch_scan<P, 64>(args...);
    case 80: return launch_scan<P, 80>(args...);
    case 96: return launch_scan<P, 96>(args...);
    case 112: return launch_scan<P, 112>(args...);
    case 128: return launch_scan<P, 128>(args...);
    default: return cudaErrorInvalidValue;
  }
}

template <typename... Args>
cudaError_t launch_scan_p(int P, int N, Args... args) {
  switch (P) {
    case 16: return launch_scan_n<16>(N, args...);
    case 32: return launch_scan_n<32>(N, args...);
    case 48: return launch_scan_n<48>(N, args...);
    case 64: return launch_scan_n<64>(N, args...);
    default: return cudaErrorInvalidValue;
  }
}

cudaError_t launch_tc(const void* x, const float* dt, const float* a, const void* bm,
                      const void* cm, void* y, float* h_out, float* states, float* ltot, int B,
                      int L, int H, int P, int G, int N, int Q, cudaStream_t stream) {
  if (P % 16 != 0 || P > TC_MAXP || N % 16 != 0 || N > TC_MAXN || Q > TC_MAXQ)
    return cudaErrorInvalidValue;
  const size_t smem1 = tc_state_smem(P, N, Q), smem3 = tc_scan_smem(P, N, Q);
  if (smem3 > 232448) return cudaErrorInvalidValue;
  const int nc = L / Q;
  const auto* xb = static_cast<const __nv_bfloat16*>(x);
  const auto* bb = static_cast<const __nv_bfloat16*>(bm);
  const auto* cb = static_cast<const __nv_bfloat16*>(cm);
  cudaError_t err = cudaFuncSetAttribute(ssd_chunk_state,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem1);
  if (err != cudaSuccess) return err;
  const dim3 grid(H, nc, B);
  ssd_chunk_state<<<grid, 256, smem1, stream>>>(xb, dt, a, bb, states, ltot, L, H, P, G, N, Q);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  ssd_state_pass<<<dim3((P * N + 255) / 256, H, B), 256, 0, stream>>>(states, ltot, h_out, H,
                                                                       P * N, nc);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  return launch_scan_p(P, N, grid, smem3, stream, xb, dt, a, bb, cb, states,
                       static_cast<__nv_bfloat16*>(y), L, H, G, Q);
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16; y takes x's. variant: 0 = the
// sequential-chunk CUDA-core kernel `ssd_fwd`, 1 = the chunk-parallel
// tensor-core passes (bf16 x/B/C, fp32 dt/a, P and N multiples of 16 up to 64
// and 128, Q up to 256), as the wrapper's routing chose it; `states`
// (B, H, L/Q, P, N) and `ltot` (B, H, L/Q) are its fp32 scratch, unused by
// variant 0. Returns the CUDA error of the last launch (0 on success); it
// does not synchronise.
extern "C" int ssd_scan_fwd(const void* x, int x_dtype, const void* dt, int dt_dtype,
                            const void* a, int a_dtype, const void* bm, int b_dtype,
                            const void* cm, int c_dtype, void* y, float* h_out, float* states,
                            float* ltot, int variant, int B, int L, int H, int P, int G, int N,
                            int Q, int device, void* stream) {
  if (B < 1 || B > 65535 || L < 1 || H < 1 || P < 1 || G < 1 || H % G != 0 || N < 4 || N > MAX_N ||
      N % 4 != 0 || Q < 1 || L % Q != 0 || L / Q > 65535)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {  // bf16 x/B/C, fp32 dt/a: the chunk-parallel passes
    if (x_dtype != 1 || b_dtype != 1 || c_dtype != 1 || dt_dtype != 0 || a_dtype != 0)
      return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaSetDevice(device);
    if (err != cudaSuccess) return (int)err;
    return (int)launch_tc(x, static_cast<const float*>(dt), static_cast<const float*>(a), bm, cm,
                          y, h_out, states, ltot, B, L, H, P, G, N, Q,
                          static_cast<cudaStream_t>(stream));
  }
  if (variant != 0) return (int)cudaErrorInvalidValue;
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
