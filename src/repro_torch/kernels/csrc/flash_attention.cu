// Blockwise online-softmax (flash) self-attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: causal, sliding-window
// (key k visible to query q when k > q - window) or non-causal masks, GQA
// (q head h reads kv head h * Hkv / Hq), a key-padding mask for a sequence
// length that is not a multiple of the tile, an optional scale, and a value
// width Dv that may differ from the query/key width D (both up to 256).
// Running max, sum and accumulator are fp32; the output is in q's dtype.
// Inputs are fp32 or bf16, contiguous (B, H, S, D).
//
// Design. One thread block per (q tile of 64 rows, q head, batch). A loop
// inside the block walks the kv tiles, taking the place of the TPU's
// sequential kv grid axis; the running statistics stay in registers, and
// each query row's max, sum and rescale are reduced by lane shuffles. Two
// variants, chosen at the launch from what the inputs are:
//  - bf16 with D % 16 == 0, Dv % 8 == 0 and 16-byte aligned tensors (every
//    dense config, the main path): `flash_fwd_tc`, 4 warps of 16 rows each
//    on the tensor cores through mma.sync m16n8k16 (bf16 in, fp32
//    accumulate). Q, K and V^T tiles sit in shared memory as bf16; P stays
//    in registers, rounded to bf16 for P V as in FlashAttention-2.
//  - fp32 (and any other bf16 shape): `flash_fwd`, 256 threads on the fp32
//    CUDA cores, each owning 4 rows for both products. Tiles are staged as
//    fp32 (Q and K transposed, so a thread reads its 4 rows and 4 keys with
//    one 16-byte load each); P goes through shared memory to feed P V.
//    Plain FMA keeps fp32 inputs at full precision: no TF32 anywhere.
//
// Masking. Tiles that are fully masked (above the causal diagonal, or wholly
// before the sliding window) are never visited. Inside a visited tile a row
// may still see no visible key (the window's first tile); its update is
// guarded (p = 0, alpha = 1), so the result does not depend on the order of
// the kv tiles, unlike the TPU kernel, which relies on a later
// alpha = exp(-1e30 - m) to wipe out a fully masked block that came first.
//
// Bound on an H100. At qwen2.5-3b prefill (B = 1, Hq = 16, Hkv = 2,
// S = 2048, D = 128, bf16, causal) the work is about 4 * B * Hq * S^2 * D / 2
// = 17 GFLOP against 18.9 MB of inputs and outputs: far above the card's
// ~295 FLOP/byte ridge, so the kernel is bound by arithmetic, and its bound
// is the bf16 tensor-core rate (989 TFLOP/s). What this simple design leaves
// on the table: mma.sync reaches only part of that rate (wgmma, which reads
// its operands from shared memory asynchronously, is the way to the full
// rate); tile loads are synchronous, with no cp.async or TMA pipeline
// overlapping the next tile's copy with the current products; V is
// transposed through 2-byte shared-memory stores instead of ldmatrix.trans;
// and the fp32 variant runs on the CUDA cores (67 TFLOP/s peak), limited
// further by its shared-memory reads (2 vector loads per 16 FMAs) and by one
// 120 KB block per SM.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;           // query rows per block
constexpr int BK = 64;           // keys per kv tile
constexpr int THREADS = 256;     // 16 x 16: ty owns rows ty*4.., tx keys tx*4..
constexpr int PAD = 4;           // keeps 16-byte alignment of every row
constexpr int LDQ = BQ + PAD;    // stride (floats) of one d-row of the Q^T tile
constexpr int LDK = BK + PAD;    // stride of one d-row of the K^T tile
constexpr int LDP = BQ + PAD;    // stride of one key-row of the P^T tile

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype does
}

// NV = number of 64-wide column groups of the value width (Dv <= 64 * NV).
template <typename T, int NV>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
          T* __restrict__ o, int Hq, int Hkv, int S, int D, int Dv, float scale,
          int causal, int window) {
  extern __shared__ float4 smem4[];
  constexpr int LDV = NV * 64;
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LDQ]  Q tile, transposed
  float* kt = qt + D * LDQ;                     // [D][LDK]  K tile, transposed
  float* vs = kt + D * LDK;                     // [BK][LDV] V tile
  float* pt = vs + BK * LDV;                    // [BK][LDP] P tile, transposed

  const int nq = (S + BQ - 1) / BQ;
  const int qtile = nq - 1 - blockIdx.x;  // longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * Hkv / Hq;
  const int q0 = qtile * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qp = q + (size_t)(b * Hq + h) * S * D;
  const T* kp = k + (size_t)(b * Hkv + hk) * S * D;
  const T* vp = v + (size_t)(b * Hkv + hk) * S * Dv;
  T* op = o + (size_t)(b * Hq + h) * S * Dv;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qt[d * LDQ + r] = (q0 + r < S) ? to_f32(qp[(size_t)(q0 + r) * D + d]) : 0.f;
  }

  float acc[4][NV][4];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0.f;
  }

  // kv tiles that hold at least one key visible to some row of this q tile
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - r * D;
      kt[d * LDK + r] = (k0 + r < S) ? to_f32(kp[(size_t)(k0 + r) * D + d]) : 0.f;
    }
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV, c = i - r * LDV;
      vs[i] = (k0 + r < S && c < Dv) ? to_f32(vp[(size_t)(k0 + r) * Dv + c]) : 0.f;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float4 a = *reinterpret_cast<const float4*>(qt + d * LDQ + ty * 4);
      const float4 bk = *reinterpret_cast<const float4*>(kt + d * LDK + tx * 4);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {bk.x, bk.y, bk.z, bk.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx * 4 + j;
        const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                        (window <= 0 || kpos > qpos - window);
        s[i][j] = ok ? s[i][j] * scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      if (m_new == -INFINITY) {  // no visible key for this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
      } else {
        alpha = expf(m[i] - m_new);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = expf(s[i][j] - m_new);
          rs += s[i][j];
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) acc[i][j][c] *= alpha;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt + (tx * 4 + j) * LDP + ty * 4) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    for (int c = 0; c < BK; ++c) {
      const float4 p4 = *reinterpret_cast<const float4*>(pt + c * LDP + ty * 4);
      const float pv[4] = {p4.x, p4.y, p4.z, p4.w};
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + c * LDV + 64 * j + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          acc[i][j][0] = fmaf(pv[i], v4.x, acc[i][j][0]);
          acc[i][j][1] = fmaf(pv[i], v4.y, acc[i][j][1]);
          acc[i][j][2] = fmaf(pv[i], v4.z, acc[i][j][2]);
          acc[i][j][3] = fmaf(pv[i], v4.w, acc[i][j][3]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= S) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
#pragma unroll
    for (int j = 0; j < NV; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = 64 * j + tx * 4 + c;
        if (col < Dv) op[(size_t)row * Dv + col] = from_f32<T>(acc[i][j][c] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16, fp32 accumulate
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps, 16 query rows each
constexpr int TC_BQ = 64;
constexpr int TC_BK = 64;
constexpr int TC_PAD = 8;        // bf16 elements: rows stay 16-byte aligned and
                                 // fragment loads hit 32 distinct banks
constexpr int TC_LDV = TC_BK + TC_PAD;

__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Fragment layout (PTX ISA, mma.m16n8k16): lane = 4 * g + t. A holds rows
// g and g + 8, columns 2t, 2t+1 and 2t+8, 2t+9; B holds column g, rows 2t,
// 2t+1 and 2t+8, 2t+9; C holds rows g and g + 8, columns 2t, 2t+1. The S
// accumulator of two adjacent 8-key tiles is therefore the A operand of P V
// for their 16 keys, and P never leaves registers.
//
// NG = number of 64-wide column groups of the value width (Dv <= 64 * NG).
// Needs D % 16 == 0, Dv % 8 == 0 and 16-byte aligned tensors.
template <int NG>
__global__ void __launch_bounds__(TC_THREADS)
flash_fwd_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
             const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o, int Hq,
             int Hkv, int S, int D, int Dv, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];
  const int ldq = D + TC_PAD;
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem4);  // [BQ][ldq]
  __nv_bfloat16* ks = qs + TC_BQ * ldq;                          // [BK][ldq]
  __nv_bfloat16* vt = ks + TC_BK * ldq;                          // [Dv][LDV], V^T

  const int nq = (S + TC_BQ - 1) / TC_BQ;
  const int qtile = nq - 1 - blockIdx.x;  // longest causal rows start first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h * Hkv / Hq;
  const int q0 = qtile * TC_BQ;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row0 = (tid >> 5) * 16;  // this warp's first row in the tile

  const __nv_bfloat16* qp = q + (size_t)(b * Hq + h) * S * D;
  const __nv_bfloat16* kp = k + (size_t)(b * Hkv + hk) * S * D;
  const __nv_bfloat16* vp = v + (size_t)(b * Hkv + hk) * S * Dv;
  __nv_bfloat16* op = o + (size_t)(b * Hq + h) * S * Dv;
  const uint4 zero = make_uint4(0, 0, 0, 0);

  const int dvec = D / 8;  // 16-byte vectors per q/k row
  for (int i = tid; i < TC_BQ * dvec; i += TC_THREADS) {
    const int r = i / dvec, c = (i - r * dvec) * 8;
    *reinterpret_cast<uint4*>(qs + r * ldq + c) =
        (q0 + r < S) ? *reinterpret_cast<const uint4*>(qp + (size_t)(q0 + r) * D + c) : zero;
  }

  float acc[NG * 8][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g, g + 8
#pragma unroll
  for (int n = 0; n < NG * 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[n][c] = 0.f;

  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + TC_BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / TC_BK) * TC_BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += TC_BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < TC_BK * dvec; i += TC_THREADS) {
      const int r = i / dvec, c = (i - r * dvec) * 8;
      *reinterpret_cast<uint4*>(ks + r * ldq + c) =
          (k0 + r < S) ? *reinterpret_cast<const uint4*>(kp + (size_t)(k0 + r) * D + c) : zero;
    }
    // V transposed; consecutive threads take consecutive keys, so that the
    // 2-byte stores of a warp land in 16 distinct banks
    for (int i = tid; i < TC_BK * (Dv / 8); i += TC_THREADS) {
      const int r = i % TC_BK, c = (i / TC_BK) * 8;
      uint4 raw = (k0 + r < S) ? *reinterpret_cast<const uint4*>(vp + (size_t)(k0 + r) * Dv + c)
                               : zero;
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) vt[(c + j) * TC_LDV + r] = e[j];
    }
    __syncthreads();

    float s[8][4];  // 8 tiles of 8 keys
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
    for (int kk = 0; kk < D; kk += 16) {
      const __nv_bfloat16* qa = qs + (row0 + g) * ldq + kk + 2 * t;
      const uint32_t a[4] = {ld32(qa), ld32(qa + 8 * ldq), ld32(qa + 8), ld32(qa + 8 * ldq + 8)};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kb = ks + (8 * j + g) * ldq + kk + 2 * t;
        mma_16816(s[j], a, ld32(kb), ld32(kb + 8));
      }
    }

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int qpos = q0 + row0 + g + 8 * r;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int kpos = k0 + 8 * j + 2 * t + c;
          const bool ok = kpos < S && (!causal || kpos <= qpos) &&
                          (window <= 0 || kpos > qpos - window);
          s[j][2 * r + c] = ok ? s[j][2 * r + c] * scale : -INFINITY;
          mx = fmaxf(mx, s[j][2 * r + c]);
        }
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      float alpha = 1.f, rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float p = (m_new == -INFINITY) ? 0.f : expf(s[j][2 * r + c] - m_new);
          s[j][2 * r + c] = p;
          rs += p;
        }
      if (m_new != -INFINITY) alpha = expf(m[r] - m_new);
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      l[r] = l[r] * alpha + rs;
      m[r] = m_new;
#pragma unroll
      for (int n = 0; n < NG * 8; ++n) {
        acc[n][2 * r] *= alpha;
        acc[n][2 * r + 1] *= alpha;
      }
    }

#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 16 keys per step
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int n = 0; n < NG * 8; ++n) {
        if (8 * n < Dv) {  // uniform across the warp
          const __nv_bfloat16* vb = vt + (8 * n + g) * TC_LDV + 16 * kk + 2 * t;
          mma_16816(acc[n], a, ld32(vb), ld32(vb + 8));
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + row0 + g + 8 * r;
    if (row >= S) continue;
    const float inv = l[r] > 0.f ? 1.f / l[r] : 0.f;
#pragma unroll
    for (int n = 0; n < NG * 8; ++n) {
      const int col = 8 * n + 2 * t;
      if (col < Dv)
        *reinterpret_cast<uint32_t*>(op + (size_t)row * Dv + col) =
            pack_bf16(acc[n][2 * r] * inv, acc[n][2 * r + 1] * inv);
    }
  }
}

template <int NG>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                      int Hkv, int S, int D, int Dv, float scale, int causal, int window,
                      cudaStream_t stream) {
  const size_t smem = sizeof(__nv_bfloat16) *
                      ((size_t)(TC_BQ + TC_BK) * (D + TC_PAD) + (size_t)Dv * TC_LDV);
  auto kern = flash_fwd_tc<NG>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + TC_BQ - 1) / TC_BQ, Hq, B);
  kern<<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o), Hq, Hkv, S, D, Dv,
      scale, causal, window);
  return cudaGetLastError();
}

cudaError_t launch_tc_dv(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                         int Hkv, int S, int D, int Dv, float scale, int causal, int window,
                         cudaStream_t st) {
  switch ((Dv + 63) / 64) {
    case 1: return launch_tc<1>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 2: return launch_tc<2>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 3: return launch_tc<3>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 4: return launch_tc<4>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                   int Hkv, int S, int D, int Dv, float scale, int causal, int window,
                   cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * LDQ + (size_t)D * LDK +
                                       (size_t)BK * NV * 64 + (size_t)BK * LDP);
  auto kern = flash_fwd<T, NV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((S + BQ - 1) / BQ, Hq, B);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), Hq,
                                        Hkv, S, D, Dv, scale, causal, window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* o, int B, int Hq,
                      int Hkv, int S, int D, int Dv, float scale, int causal, int window,
                      cudaStream_t st) {
  switch ((Dv + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 2: return launch<T, 2>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 3: return launch<T, 3>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 4: return launch<T, 4>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns the CUDA error of the launch
// (0 on success); it does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Hq, int Hkv, int S, int D, int Dv,
                                   float scale, int causal, int window, int device,
                                   void* stream) {
  if (B < 1 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || D < 1 || D > 256 ||
      Dv < 1 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t addr_bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                              reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (dtype == 0)
    err = launch_dv<float>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
  else if (dtype == 1 && D % 16 == 0 && Dv % 8 == 0 && addr_bits % 16 == 0)
    err = launch_tc_dv(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
  else if (dtype == 1)
    err = launch_dv<__nv_bfloat16>(q, k, v, o, B, Hq, Hkv, S, D, Dv, scale, causal, window,
                                   st);
  else
    err = cudaErrorInvalidValue;
  return (int)err;
}
