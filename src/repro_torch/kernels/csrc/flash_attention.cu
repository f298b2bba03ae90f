// Blockwise online-softmax (flash) self-attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel `_flash_kernel` / `flash_attention` in
// src/repro/kernels/flash_attention.py. Same function: causal, sliding-window
// (key k visible to query q when k > q - window) or non-causal masks, GQA
// (q head h reads kv head h * Hkv / Hq), a key-padding mask for a sequence
// length that is not a multiple of the tile, an optional scale, and a value
// width Dv that may differ from the query/key width D (both up to 256).
// Running max, sum and accumulator are fp32; the output is in q's dtype.
// q, k, v and o are (B, H, S, D) views given by their element strides, the
// innermost stride 1 (the model hands in transposed (B, S, H, D) views, and
// the wrapper allocates o as (B, S, H, Dv)).
//
// Two variants, chosen by the wrapper before the launch from what the inputs
// are (`variant`):
//  1. bf16 with D and Dv multiples of 64 up to 256, 16-byte aligned bases and
//     strides (every config: 64, 128, 192/128, 256): `flash_fwd_wgmma`, a
//     warp-specialised kernel. One block per (128 query rows, q head, batch,
//     part of V's columns): a producer warp issues TMA loads of the Q tile
//     once, then of 64-key K and V tiles into a ring of 2 stages in shared
//     memory (128-byte swizzle, one tensor map per operand built from its
//     strides, full and empty mbarriers per stage and per operand); two
//     consumer warpgroups of 64 query rows each compute S = Q K^T with wgmma
//     m64n64k16 (Q and K K-major from shared memory), keep the online
//     softmax in the accumulator's registers, round P to bf16 in registers as
//     wgmma's A operand, and compute O += P V with V read as an MN-major B
//     operand (the transpose bit: V is never transposed by hand). Each
//     warpgroup issues S_j and P_{j-1} V_{j-1} together and computes the
//     softmax of S_j while the P V product runs; a K stage is released once
//     its S is waited on, a V stage once its P V is.
//     Registers set the shapes: ptxas gives a thread of this block at most
//     168 registers (it counts the producer warp as a third warpgroup), and
//     setmaxnreg did not change that (the same spills with it, and a hang
//     with a producer warpgroup of one warp), so the block does without it.
//     S (32), P in flight (16) and O (64 at 128 columns) fit; a V wider than
//     128 columns is split over blocks of 128 (or 64) columns, each
//     recomputing S. Shared memory: Q 64 KB + 2 x (K 32 KB + V 16 KB) =
//     160 KB at D = 256.
//  0. everything else (fp32, other bf16 widths, storage TMA cannot address):
//     `flash_fwd`, 256 threads on the fp32 CUDA cores, each owning 4 rows for
//     both products. Tiles are staged as fp32 (Q and K transposed, so a
//     thread reads its 4 rows and 4 keys with one 16-byte load each); P goes
//     through shared memory to feed P V. Plain FMA keeps fp32 inputs at full
//     precision: no TF32 anywhere.
//
// Masking. Tiles that are fully masked (above the causal diagonal, or wholly
// before the sliding window) are never visited, and the wgmma variant skips
// a tile that is fully masked for one of its warpgroups; only tiles on the
// diagonal, on the window's edge or past S apply the mask arithmetic. Inside
// a visited tile a row may still see no visible key (the window's first
// tile); its update is guarded (p = 0, and nothing is rescaled that is not
// 0), so the result does not depend on the order of the kv tiles, unlike the
// TPU kernel, which relies on
// a later alpha = exp(-1e30 - m) to wipe out a fully masked block that came
// first. The longest causal rows start first (the q tile is the slowest grid
// axis, walked from the end).
//
// Bound on an H100. At qwen2.5-3b prefill (B = 1, Hq = 16, Hkv = 2,
// S = 2048, D = 128, bf16, causal) the work is about 4 * B * Hq * S^2 * D / 2
// = 17 GFLOP against 18.9 MB of inputs and outputs: far above the card's
// ~295 FLOP/byte ridge, so the kernel is bound by arithmetic, and its bound
// is the bf16 tensor-core rate (989 TFLOP/s). What this design still leaves:
// 64-key tiles (the register budget) make S = Q K^T read Q from shared memory
// once per 64 keys; the two warpgroups are not scheduled against each other
// (no ping-pong); the output is stored from registers rather than through
// TMA; and the fp32 variant runs on the CUDA cores (67 TFLOP/s peak).
//
// The tensor maps are encoded on the host by the driver's
// cuTensorMapEncodeTiled, reached through the runtime's
// cudaGetDriverEntryPoint: the library links no -lcuda.

#include <cuda.h>
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

// Element strides of a (B, H, S, *) view, the innermost stride being 1.
struct Strides {
  long long b, h, s;
};

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
          T* __restrict__ o, Strides sq, Strides sk, Strides sv, Strides so, int Hq, int Hkv,
          int S, int D, int Dv, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];
  constexpr int LDV = NV * 64;
  float* qt = reinterpret_cast<float*>(smem4);  // [D][LDQ]  Q tile, transposed
  float* kt = qt + D * LDQ;                     // [D][LDK]  K tile, transposed
  float* vs = kt + D * LDK;                     // [BK][LDV] V tile
  float* pt = vs + BK * LDV;                    // [BK][LDP] P tile, transposed

  const int nq = (S + BQ - 1) / BQ;
  const int qtile = nq - 1 - blockIdx.z;  // longest causal rows start first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h * Hkv / Hq;
  const int q0 = qtile * BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  const T* qp = q + b * sq.b + h * sq.h;
  const T* kp = k + b * sk.b + hk * sk.h;
  const T* vp = v + b * sv.b + hk * sv.h;
  T* op = o + b * so.b + h * so.h;

  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - r * D;
    qt[d * LDQ + r] = (q0 + r < S) ? to_f32(qp[(q0 + r) * sq.s + d]) : 0.f;
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
      kt[d * LDK + r] = (k0 + r < S) ? to_f32(kp[(k0 + r) * sk.s + d]) : 0.f;
    }
    for (int i = tid; i < BK * LDV; i += THREADS) {
      const int r = i / LDV, c = i - r * LDV;
      vs[i] = (k0 + r < S && c < Dv) ? to_f32(vp[(k0 + r) * sv.s + c]) : 0.f;
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
        if (col < Dv) op[row * so.s + col] = from_f32<T>(acc[i][j][c] * inv);
      }
  }
}

// ---------------------------------------------------------------------------
// bf16 on the tensor cores: TMA + wgmma, warp-specialised
// ---------------------------------------------------------------------------

constexpr int WG_BQ = 128;        // query rows per block: two consumer warpgroups of 64
constexpr int WG_THREADS = 288;   // warpgroups 0, 1 consume; warp 8 produces
constexpr int STAGES = 2;         // K/V ring depth
constexpr int WG_BK = 64;         // keys per tile
constexpr int PANEL_BYTES = 128;  // one swizzled row: 64 bf16 columns

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Wait until the phase of parity `parity` has completed. A wait of more than
// about ten seconds (a lost arrival) traps, so that the launch fails with an
// error instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  const long long t0 = clock64();
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (clock64() - t0 > 20000000000LL) __trap();
  }
}

// One box of a 4-d tensor map (coordinates innermost first) into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor for a 128-byte-swizzled operand whose
// swizzle atoms (8 rows of 128 bytes) are 1024 bytes apart. K-major operands
// (Q, K) ignore the leading offset; the MN-major V, read 64 columns (one atom
// wide) per instruction, steps by the stride offset from one 8-key group to
// the next. Both offsets are therefore 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (static_cast<uint64_t>(1024 >> 4) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Pins accumulator registers in place around an asynchronous wgmma: the
// compiler may then neither move their definitions into the span where
// wgmma owns them (which would make ptxas serialise every wgmma) nor read
// them before the wait that retires it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {  // until at most N groups are in flight
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// two floats -> one register of two bf16, the lower column in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]^T: A and B K-major in shared memory
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] B[16 x 64]: A in registers, B MN-major in shared memory
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// 2^x by the special-function unit (ex2.approx.ftz: 2 ulp, and P is
// rounded to bf16 after it); exp2f adds range handling the softmax does not
// need (scripts/kernel_variants.py times both).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Online softmax of one S tile, in place: s (raw Q K^T) becomes P (fp32), m
// (the running max in log2 units of the scaled scores) and l (this thread's
// share of the row sums) are updated, and alpha gets each row's rescale of
// the running output. Rows row[0] and row[1], keys k0 + 8j + 2t + {0, 1}; the
// mask is applied only when `masked`. A row with no visible key yet is
// guarded: its max stays -inf, it is exponentiated against 0, so p = 0 and
// alpha = 0 on an output and a sum that are still 0, and the result does not
// depend on the order of the tiles.
__device__ __forceinline__ void softmax_tile(float (&s)[WG_BK / 2], const int (&row)[2], int k0,
                                             int tq4, bool masked, int S, int causal,
                                             int window, float scale_log2, float (&m)[2],
                                             float (&l)[2], float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < WG_BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * r + c];
        if (masked) {
          const int kpos = k0 + 8 * j + 2 * tq4 + c;
          const bool ok = kpos < S && (!causal || kpos <= row[r]) &&
                          (window <= 0 || kpos > row[r] - window);
          x = ok ? x : -INFINITY;
        }
        mx = fmaxf(mx, x);
      }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m[r], mx * scale_log2);
    const float m_use = m_new == -INFINITY ? 0.f : m_new;
    float rs = 0.f;
#pragma unroll
    for (int j = 0; j < WG_BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[4 * j + 2 * r + c];
        x = ex2(fmaf(x, scale_log2, -m_use));
        rs += x;
      }
    alpha[r] = ex2(m[r] - m_use);
    l[r] = l[r] * alpha[r] + rs;
    m[r] = m_new;
  }
}

// Accumulator layout of wgmma m64nN (fp32): warp w of the warpgroup holds
// rows 16w + g and 16w + g + 8 (lane = 4g + t); register 4j + c holds column
// 8j + 2t + (c & 1) of row g + 8 * (c >> 1). The A operand from registers
// has the layout of mma.m16n8k16's A per warp, so the S accumulator of two
// adjacent 8-key column blocks is P's A operand for those 16 keys.
//
// Each consumer warpgroup overlaps its softmax with the tensor cores: in
// step j it issues S_j = Q K_j^T and O += P_{j-1} V_{j-1}, waits for S_j
// alone, releases K_j, computes the softmax of S_j while the P V product
// runs, then waits for it, releases V_{j-1}, rescales O and packs P_j. K and
// V stages have their own empty barriers, so that K_{j+2} loads as soon as
// S_j is done and V_{j+1} as soon as P_{j-1} V_{j-1} is.
//
// D = query/key width (a multiple of 64, up to 256); DV = the value columns
// this block computes (64 or 128: `parts` blocks share a wider V, each
// recomputing S, so that S, P in flight and O fit the 168 registers a
// consumer thread gets: ptxas allots a block of two consumer warpgroups and a
// producer warp as three warpgroups). Every loop over the widths is unrolled
// at compile time: a loop kept at run time copies the accumulators at its
// back edge, inside the span where wgmma owns them, and ptxas then
// serialises every wgmma.
template <int D, int DV>
__global__ void __launch_bounds__(WG_THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                const __grid_constant__ CUtensorMap tv, __nv_bfloat16* __restrict__ o,
                Strides so, int Hq, int Hkv, int S, int parts, float scale_log2, int causal,
                int window) {
  constexpr int NP = DV / 64;  // 64-column panels of V and of the output
  extern __shared__ uint8_t smem_raw[];
  // swizzle atoms must start on a 1024-byte boundary
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  constexpr int q_bytes = WG_BQ * D * 2, k_bytes = WG_BK * D * 2, v_bytes = WG_BK * DV * 2;
  uint8_t* qs = smem;                          // D/64 panels of [128 rows][128 B]
  uint8_t* ks = qs + q_bytes;                  // STAGES x D/64 panels of [WG_BK][128 B]
  uint8_t* vs = ks + STAGES * k_bytes;         // STAGES x NP panels of [WG_BK][128 B]
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + STAGES * v_bytes);
  const uint32_t q_full = smem_u32(bars);
  auto full_k = [&](int t) { return smem_u32(bars + 1 + t % STAGES); };
  auto full_v = [&](int t) { return smem_u32(bars + 1 + STAGES + t % STAGES); };
  auto empty_k = [&](int t) { return smem_u32(bars + 1 + 2 * STAGES + t % STAGES); };
  auto empty_v = [&](int t) { return smem_u32(bars + 1 + 3 * STAGES + t % STAGES); };
  auto parity = [](int t) { return (t / STAGES) & 1; };  // of tile t's use of its stage

  const int nq = (S + WG_BQ - 1) / WG_BQ;
  const int qz = static_cast<int>(blockIdx.z) / parts;
  const int q0 = (nq - 1 - qz) * WG_BQ;  // longest rows first
  const int col0 = (static_cast<int>(blockIdx.z) - qz * parts) * DV;  // this block's V columns
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h * Hkv / Hq;

  // kv tiles that hold at least one key visible to some row of this q tile:
  // tile t covers keys [k_lo + t WG_BK, k_lo + (t + 1) WG_BK)
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + WG_BQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  k_lo = (k_lo / WG_BK) * WG_BK;
  const int ntiles = (k_hi - k_lo + WG_BK - 1) / WG_BK;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int st = 0; st < STAGES; ++st) {
      mbar_init(full_k(st), 1);
      mbar_init(full_v(st), 1);
      mbar_init(empty_k(st), 2 * 128);  // every consumer thread releases the stage
      mbar_init(empty_v(st), 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 2 * 128) {
    // ---- producer warp: one thread issues every TMA load ----
    if (threadIdx.x == 2 * 128) {
      mbar_expect_tx(q_full, q_bytes);
      for (int p = 0; p < D / 64; ++p)
        tma_load_4d(smem_u32(qs + p * WG_BQ * PANEL_BYTES), &tq, q_full, 64 * p, q0, h, b);
      for (int t = 0; t < ntiles; ++t) {
        const int k0 = k_lo + t * WG_BK, st = t % STAGES;
        mbar_wait(empty_k(t), parity(t) ^ 1);  // the first pass finds every stage free
        mbar_expect_tx(full_k(t), k_bytes);
        for (int p = 0; p < D / 64; ++p)
          tma_load_4d(smem_u32(ks + st * k_bytes + p * WG_BK * PANEL_BYTES), &tk, full_k(t),
                      64 * p, k0, hk, b);
        mbar_wait(empty_v(t), parity(t) ^ 1);
        mbar_expect_tx(full_v(t), v_bytes);
        for (int p = 0; p < NP; ++p)
          tma_load_4d(smem_u32(vs + st * v_bytes + p * WG_BK * PANEL_BYTES), &tv, full_v(t),
                      col0 + 64 * p, k0, hk, b);
      }
    }
  } else {
    // ---- two consumer warpgroups, 64 query rows each ----
    const int wg = threadIdx.x / 128, t128 = threadIdx.x % 128;
    const int lane = t128 % 32, g = lane / 4, tq4 = lane % 4;
    const int r0 = q0 + 64 * wg;                  // this warpgroup's first row
    const int row[2] = {r0 + (t128 / 32) * 16 + g, r0 + (t128 / 32) * 16 + g + 8};

    // this warpgroup's tiles [t0, t1): the others are wholly masked for its
    // rows (a prefix before the window, a suffix past the diagonal); it
    // still waits for them and releases them
    int t0 = ntiles, t1 = 0;
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = k_lo + t * WG_BK;
      const bool skip =
          (causal && k0 > r0 + 63) || (window > 0 && k0 + WG_BK - 1 <= r0 - window);
      if (!skip) {
        t0 = min(t0, t);
        t1 = t + 1;
      }
    }
    t1 = max(t1, t0);
    auto pass_over = [&](int t) {
      mbar_wait(full_k(t), parity(t));
      mbar_arrive(empty_k(t));
      mbar_wait(full_v(t), parity(t));
      mbar_arrive(empty_v(t));
    };
    auto masked = [&](int k0) {  // does the tile need the mask for these rows?
      return (causal && k0 + WG_BK - 1 > r0) || (window > 0 && k0 <= r0 + 63 - window) ||
             (k0 + WG_BK > S);
    };
    const uint32_t q_base = smem_u32(qs) + 64 * wg * PANEL_BYTES;
    auto issue_s = [&](float (&s)[WG_BK / 2], int t) {  // S = Q K_t^T, committed
      const uint32_t k_base = smem_u32(ks + (t % STAGES) * k_bytes);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t off = (kk & 3) * 32;  // 16 columns = 32 bytes inside a panel
        wgmma_ss_n64(s, sw128_desc(q_base + (kk >> 2) * WG_BQ * PANEL_BYTES + off),
                     sw128_desc(k_base + (kk >> 2) * WG_BK * PANEL_BYTES + off), kk > 0);
      }
      wgmma_commit();
      fence_regs(s);
    };

    float acc[NP][32];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[p][i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};
    float l[2] = {0.f, 0.f};  // this thread's share of the row sums, reduced at the end
    float alpha[2];
    uint32_t pa[WG_BK / 16][4];  // P in bf16, wgmma's A operand for 16 keys each
    auto pack_p = [&](const float (&s)[WG_BK / 2]) {
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk) {
        pa[kk][0] = pack_bf16(s[8 * kk + 0], s[8 * kk + 1]);
        pa[kk][1] = pack_bf16(s[8 * kk + 2], s[8 * kk + 3]);
        pa[kk][2] = pack_bf16(s[8 * kk + 4], s[8 * kk + 5]);
        pa[kk][3] = pack_bf16(s[8 * kk + 6], s[8 * kk + 7]);
      }
    };
    auto issue_pv = [&](int t) {  // O += P V_t, committed
      const uint32_t v_base = smem_u32(vs + (t % STAGES) * v_bytes);
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < WG_BK / 16; ++kk)
#pragma unroll
        for (int p = 0; p < NP; ++p)  // 16 keys = two 8-row atoms = 2048 bytes
          wgmma_rs_n64(acc[p], pa[kk],
                       sw128_desc(v_base + p * WG_BK * PANEL_BYTES + kk * 16 * PANEL_BYTES));
      wgmma_commit();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
    };
    auto retire_pv = [&]() {  // wait for every wgmma of this warpgroup
      wgmma_wait<0>();
#pragma unroll
      for (int p = 0; p < NP; ++p) fence_regs(acc[p]);
      fence_regs(pa);  // P may be rewritten only now
    };

    mbar_wait(q_full, 0);
    for (int t = 0; t < t0; ++t) pass_over(t);
    if (t0 < t1) {
      float s[WG_BK / 2];
      mbar_wait(full_k(t0), parity(t0));
      issue_s(s, t0);
      wgmma_wait<0>();
      fence_regs(s);
      mbar_arrive(empty_k(t0));
      softmax_tile(s, row, k_lo + t0 * WG_BK, tq4, masked(k_lo + t0 * WG_BK), S, causal, window,
                       scale_log2, m, l, alpha);
      pack_p(s);
      for (int t = t0 + 1; t < t1; ++t) {
        mbar_wait(full_k(t), parity(t));
        issue_s(s, t);
        mbar_wait(full_v(t - 1), parity(t - 1));
        issue_pv(t - 1);
        wgmma_wait<1>();  // S_t is done; P_{t-1} V_{t-1} may still run
        fence_regs(s);
        mbar_arrive(empty_k(t));
        softmax_tile(s, row, k_lo + t * WG_BK, tq4, masked(k_lo + t * WG_BK), S, causal, window,
                         scale_log2, m, l, alpha);
        retire_pv();
        mbar_arrive(empty_v(t - 1));
#pragma unroll
        for (int p = 0; p < NP; ++p)
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[p][4 * j] *= alpha[0];
            acc[p][4 * j + 1] *= alpha[0];
            acc[p][4 * j + 2] *= alpha[1];
            acc[p][4 * j + 3] *= alpha[1];
          }
        pack_p(s);
      }
      mbar_wait(full_v(t1 - 1), parity(t1 - 1));
      issue_pv(t1 - 1);
      retire_pv();
      mbar_arrive(empty_v(t1 - 1));
    }
    for (int t = t1; t < ntiles; ++t) pass_over(t);

#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[r];
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      if (row[r] >= S) continue;  // rows past S were zero-filled by TMA
      const float inv = sum > 0.f ? 1.f / sum : 0.f;
      __nv_bfloat16* orow = o + b * so.b + h * so.h + row[r] * so.s + col0;
#pragma unroll
      for (int p = 0; p < NP; ++p)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          *reinterpret_cast<uint32_t*>(orow + 64 * p + 8 * j + 2 * tq4) =
              pack_bf16(acc[p][4 * j + 2 * r] * inv, acc[p][4 * j + 2 * r + 1] * inv);
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, through the runtime (no -lcuda).
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A tensor map over the (B, H, S, width) bf16 view at `base` with element
// strides `st`, read in boxes of 64 columns x `rows` rows, 128-byte swizzled.
// Rows past S read as zeros.
bool make_map(CUtensorMap* map, const void* base, Strides st, int B, int H, int S, int width,
              int rows) {
  EncodeTiledFn encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)width, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)st.s * 2, (cuuint64_t)st.h * 2,
                                 (cuuint64_t)st.b * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D, int DV>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v, void* o, const Strides* st,
                         int B, int Hq, int Hkv, int S, int Dv, float scale, int causal,
                         int window, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map(&tq, q, st[0], B, Hq, S, D, WG_BQ) || !make_map(&tk, k, st[1], B, Hkv, S, D, WG_BK) ||
      !make_map(&tv, v, st[2], B, Hkv, S, Dv, WG_BK))
    return cudaErrorInvalidValue;
  const size_t smem = 1024 /* alignment slack */ + (size_t)WG_BQ * D * 2 +
                      (size_t)STAGES * WG_BK * (D + DV) * 2 + (1 + 4 * STAGES) * sizeof(uint64_t);
  auto kern = flash_fwd_wgmma<D, DV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int parts = Dv / DV;
  const dim3 grid(Hq, B, (S + WG_BQ - 1) / WG_BQ * parts);
  kern<<<grid, WG_THREADS, smem, stream>>>(tq, tk, tv, static_cast<__nv_bfloat16*>(o), st[3],
                                          Hq, Hkv, S, parts, scale * 1.4426950408889634f,
                                          causal, window);
  return cudaGetLastError();
}

// Value columns per block: all of Dv up to 128, else parts of 128 (or 64).
template <int D>
cudaError_t launch_wgmma_d(const void* q, const void* k, const void* v, void* o,
                           const Strides* s, int B, int Hq, int Hkv, int S, int Dv, float scale,
                           int causal, int window, cudaStream_t st) {
  if (Dv == 64)
    return launch_wgmma<D, 64>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
  if (Dv % 128 == 0)
    return launch_wgmma<D, 128>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
  return launch_wgmma<D, 64>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
}

cudaError_t launch_wgmma_dv(const void* q, const void* k, const void* v, void* o,
                            const Strides* s, int B, int Hq, int Hkv, int S, int D, int Dv,
                            float scale, int causal, int window, cudaStream_t st) {
  switch (D) {
    case 64: return launch_wgmma_d<64>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
    case 128: return launch_wgmma_d<128>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
    case 192: return launch_wgmma_d<192>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
    case 256: return launch_wgmma_d<256>(q, k, v, o, s, B, Hq, Hkv, S, Dv, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

template <typename T, int NV>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides* st,
                   int B, int Hq, int Hkv, int S, int D, int Dv, float scale, int causal,
                   int window, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((size_t)D * LDQ + (size_t)D * LDK +
                                       (size_t)BK * NV * 64 + (size_t)BK * LDP);
  auto kern = flash_fwd<T, NV>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hq, B, (S + BQ - 1) / BQ);
  kern<<<grid, THREADS, smem, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                        static_cast<const T*>(v), static_cast<T*>(o), st[0],
                                        st[1], st[2], st[3], Hq, Hkv, S, D, Dv, scale, causal,
                                        window);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_dv(const void* q, const void* k, const void* v, void* o, const Strides* s,
                      int B, int Hq, int Hkv, int S, int D, int Dv, float scale, int causal,
                      int window, cudaStream_t st) {
  switch ((Dv + 63) / 64) {
    case 1: return launch<T, 1>(q, k, v, o, s, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 2: return launch<T, 2>(q, k, v, o, s, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 3: return launch<T, 3>(q, k, v, o, s, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    case 4: return launch<T, 4>(q, k, v, o, s, B, Hq, Hkv, S, D, Dv, scale, causal, window, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. variant: 0 = CUDA cores (`flash_fwd`),
// 1 = TMA + wgmma (`flash_fwd_wgmma`), as the wrapper's routing chose it.
// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn;
// every innermost stride is 1. Returns the CUDA error of the launch (0 on
// success); it does not synchronise.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   const long long* strides, int dtype, int variant, int B,
                                   int Hq, int Hkv, int S, int D, int Dv, float scale,
                                   int causal, int window, int device, void* stream) {
  if (B < 1 || B > 65535 || Hq < 1 || Hkv < 1 || Hq % Hkv != 0 || S < 1 || D < 1 || D > 256 ||
      Dv < 1 || Dv > 256)
    return (int)cudaErrorInvalidValue;
  Strides st[4];
  for (int i = 0; i < 4; ++i) st[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t stream_ = static_cast<cudaStream_t>(stream);
  if (variant == 1) {
    // TMA: 16-byte aligned base and strides; wgmma tiles: widths of 64 columns
    uintptr_t bits = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                     reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
    for (int i = 0; i < 3; ++i) bits |= (uintptr_t)(st[i].b | st[i].h | st[i].s) * 2;
    if (dtype != 1 || D % 64 != 0 || Dv % 64 != 0 || bits % 16 != 0)
      return (int)cudaErrorInvalidValue;
    err = launch_wgmma_dv(q, k, v, o, st, B, Hq, Hkv, S, D, Dv, scale, causal, window, stream_);
  } else if (variant == 0 && dtype == 0) {
    err = launch_dv<float>(q, k, v, o, st, B, Hq, Hkv, S, D, Dv, scale, causal, window, stream_);
  } else if (variant == 0 && dtype == 1) {
    err = launch_dv<__nv_bfloat16>(q, k, v, o, st, B, Hq, Hkv, S, D, Dv, scale, causal, window,
                                   stream_);
  } else {
    err = cudaErrorInvalidValue;
  }
  return (int)err;
}
