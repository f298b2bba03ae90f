// Fused elementwise passes of the dense block for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA, which
// fuses them on its own. Run eagerly in PyTorch, each chain between two
// GEMMs (or a GEMM and flash attention) was several passes over device
// memory, most of them writing fp32 intermediates. Each kernel here is one
// pass: it reads its inputs once, keeps every intermediate in fp32
// registers, and writes its outputs once.
//
//   add_rms_norm   s = x + r (rounded to the activation dtype, as the plain
//                  add rounds it), h = s * rsqrt(mean(s^2) + eps) * scale;
//                  without r (rms_norm) h of x alone, and no s is written.
//   qkv_bias_rope  q, k, v projections (+ their biases), the first d_rot
//                  dims of q and k rotated in the half-split convention
//                  (x1 cos - x2 sin, x2 cos + x1 sin); the rest pass
//                  through. Angles fp32(position * freq), freq the plain
//                  path's own fp32 table, evaluated with full-precision
//                  sincosf once per token and shared by every head.
//   swiglu         h = up * silu(gate), silu rounded to the activation
//                  dtype before the product, as the plain path rounds it.
//
// Bound on an H100. Every pass does a few flops per element against 4 to 6
// bytes of bf16 traffic: far below the ridge (~295 flops a byte), so each
// is bound by its bytes at 3.35 TB/s. For qwen2.5-3b (d 2048, q 2048, k and
// v 256 each, ffn 11008) per token and layer: the two norms read and write
// 16 KB (+8 KB for the residual read and written by the fused add), the
// bias + RoPE pass 10 KB, SwiGLU 66 KB.
//
// Design. Every load and store is 16 bytes a thread where the shapes,
// strides and pointers allow (VEC = 8 bf16 or 4 fp32 values), one value
// otherwise; neighbouring threads take neighbouring addresses. The
// arithmetic mirrors the plain PyTorch chain operation by operation, each
// rounded as PyTorch rounds it (no contraction into FMAs: the explicit
// __f*_rn intrinsics), so the outputs match it bit for bit but where a
// reduction's order differs (the mean of squares) or a libm call's last
// bit does.
//   add_rms_norm: one block per row; a thread holds up to NORM_MAX_VECS
//     vectors of the row in registers, so s is read from registers, not
//     from memory, for the norm; a warp-shuffle and shared-memory sum.
//   qkv_bias_rope: one block per token; the token's cos and sin (d_rot / 2
//     each) go to shared memory, then the block's threads walk the token's
//     units: a rotated unit is VEC values of x1 with the VEC values of x2
//     that pair with them, a plain unit VEC values passed through. It reads
//     any (B, S, H, D) view with unit innermost stride and writes a
//     contiguous (B, S, H, D) tensor.
//   swiglu: a grid-stride loop over the (rows, n) output in vectors, each
//     operand with its own row stride.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NORM_MAX_VECS = 4;  // vectors of a row a thread holds in registers
constexpr int ROPE_THREADS = 128;
constexpr int SWIGLU_THREADS = 256;

template <typename T>
struct Cvt;
template <>
struct Cvt<float> {
  static __device__ __forceinline__ float f(float x) { return x; }
  static __device__ __forceinline__ float t(float x) { return x; }
};
template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float f(__nv_bfloat16 x) { return __bfloat162float(x); }
  static __device__ __forceinline__ __nv_bfloat16 t(float x) { return __float2bfloat16_rn(x); }
};

// x rounded to T and back: what storing a T and reading it again gives
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return Cvt<T>::f(Cvt<T>::t(x));
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ void load(const T* p, float (&out)[VEC]) {
  const Pack<T, VEC> pk = *reinterpret_cast<const Pack<T, VEC>*>(p);
#pragma unroll
  for (int e = 0; e < VEC; ++e) out[e] = Cvt<T>::f(pk.v[e]);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const float (&in)[VEC]) {
  Pack<T, VEC> pk;
#pragma unroll
  for (int e = 0; e < VEC; ++e) pk.v[e] = Cvt<T>::t(in[e]);
  *reinterpret_cast<Pack<T, VEC>*>(p) = pk;
}

// VEC fp32 values of the norm's scale, in 16-byte loads where VEC allows
template <int VEC>
__device__ __forceinline__ void load_scale(const float* p, float (&out)[VEC]) {
  if constexpr (VEC % 4 == 0) {
#pragma unroll
    for (int e = 0; e < VEC; e += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + e);
      out[e] = v.x;
      out[e + 1] = v.y;
      out[e + 2] = v.z;
      out[e + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) out[e] = p[e];
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// add_rms_norm / rms_norm
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void add_rms_norm_kernel(const T* __restrict__ x, int64_t sx, const T* __restrict__ r,
                                    int64_t sr, const float* __restrict__ scale,
                                    T* __restrict__ s_out, T* __restrict__ h_out, int d,
                                    float eps, float inv_d) {
  const int64_t row = blockIdx.x;
  const int nvec = d / VEC;
  const T* xr = x + row * sx;
  float vals[NORM_MAX_VECS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NORM_MAX_VECS; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      load<T, VEC>(xr + v * VEC, vals[i]);
      if (r != nullptr) {
        float rv[VEC];
        load<T, VEC>(r + row * sr + v * VEC, rv);
#pragma unroll
        for (int e = 0; e < VEC; ++e) vals[i][e] = round_to<T>(__fadd_rn(vals[i][e], rv[e]));
        store<T, VEC>(s_out + row * d + v * VEC, vals[i]);
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) ss = __fadd_rn(ss, __fmul_rn(vals[i][e], vals[i][e]));
    }
  }
  __shared__ float part[32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  ss = warp_sum(ss);
  if (lane == 0) part[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    float t = lane < (int)(blockDim.x >> 5) ? part[lane] : 0.f;
    t = warp_sum(t);
    if (lane == 0) part[0] = t;
  }
  __syncthreads();
  const float rs = rsqrtf(__fadd_rn(__fmul_rn(part[0], inv_d), eps));
#pragma unroll
  for (int i = 0; i < NORM_MAX_VECS; ++i) {
    const int v = threadIdx.x + i * blockDim.x;
    if (v < nvec) {
      float sc[VEC], o[VEC];
      load_scale<VEC>(scale + v * VEC, sc);
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = __fmul_rn(__fmul_rn(vals[i][e], rs), sc[e]);
      store<T, VEC>(h_out + row * d + v * VEC, o);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_norm(const void* x, int64_t sx, const void* r, int64_t sr, const void* scale,
                        void* s_out, void* h_out, int64_t rows, int d, float eps, int threads,
                        cudaStream_t st) {
  add_rms_norm_kernel<T, VEC><<<(unsigned)rows, threads, 0, st>>>(
      static_cast<const T*>(x), sx, static_cast<const T*>(r), sr,
      static_cast<const float*>(scale), static_cast<T*>(s_out), static_cast<T*>(h_out), d, eps,
      1.0f / (float)d);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// qkv_bias_rope
// ---------------------------------------------------------------------------

// One input of the pass: slots 0 and 1 (q, k) are rotated, slot 2 (v) is not.
struct Slot {
  const void* x;
  int64_t sb, ss, sh;  // strides in elements; the innermost is 1
  const void* bias;    // (heads * D,) or null
  void* out;           // contiguous (B, S, heads, D)
  int heads;           // 0: the slot is empty
};

struct RopeArgs {
  Slot slot[3];
  int64_t S;
  int D, d_rot;
  const void* pos;  // positions, int64 or int32, read at b * pos_sb + s * pos_ss
  int64_t pos_sb, pos_ss;
  int pos64;
  const float* freqs;  // (d_rot / 2,)
};

template <typename T, int VEC>
__device__ __forceinline__ void add_bias(float (&v)[VEC], const T* bias) {
  if (bias == nullptr) return;
  float b[VEC];
  load<T, VEC>(bias, b);
#pragma unroll
  for (int e = 0; e < VEC; ++e) v[e] = round_to<T>(__fadd_rn(v[e], b[e]));
}

template <typename T, int VEC>
__global__ void qkv_bias_rope_kernel(RopeArgs a) {
  extern __shared__ float cs[];  // cos [0, half), sin [half, 2 half)
  const int64_t tok = blockIdx.x;
  const int64_t b = tok / a.S, s = tok - b * a.S;
  const int half = a.d_rot / 2;
  if (half > 0) {
    const int64_t p = b * a.pos_sb + s * a.pos_ss;
    const float pos = a.pos64 ? (float)static_cast<const int64_t*>(a.pos)[p]
                              : (float)static_cast<const int32_t*>(a.pos)[p];
    for (int i = threadIdx.x; i < half; i += blockDim.x) {
      float sn, c;
      sincosf(__fmul_rn(pos, a.freqs[i]), &sn, &c);
      cs[i] = c;
      cs[half + i] = sn;
    }
  }
  __syncthreads();
  const int rot_units = half / VEC;                     // of a rotated head
  const int units_r = rot_units + (a.D - a.d_rot) / VEC;  // per head of q and k
  const int units_v = a.D / VEC;                          // per head of v
  const int n0 = a.slot[0].heads * units_r, n1 = a.slot[1].heads * units_r;
  const int total = n0 + n1 + a.slot[2].heads * units_v;
  for (int u = threadIdx.x; u < total; u += blockDim.x) {
    const int t = u < n0 ? 0 : (u < n0 + n1 ? 1 : 2);
    // constant indices only: a dynamic index into the parameter space
    // would copy the arguments to local memory
    Slot sl = a.slot[0];
    if (t == 1) sl = a.slot[1];
    if (t == 2) sl = a.slot[2];
    const int w = u - (t == 0 ? 0 : (t == 1 ? n0 : n0 + n1));
    const int per = t == 2 ? units_v : units_r;
    const int h = w / per, j = w - h * per;
    const T* in = static_cast<const T*>(sl.x) + b * sl.sb + s * sl.ss + h * sl.sh;
    T* out = static_cast<T*>(sl.out) + ((tok * sl.heads) + h) * a.D;
    const T* bias = sl.bias ? static_cast<const T*>(sl.bias) + (int64_t)h * a.D : nullptr;
    if (t < 2 && j < rot_units) {
      const int c0 = j * VEC;
      float x1[VEC], x2[VEC], o1[VEC], o2[VEC];
      load<T, VEC>(in + c0, x1);
      load<T, VEC>(in + half + c0, x2);
      add_bias<T, VEC>(x1, bias ? bias + c0 : nullptr);
      add_bias<T, VEC>(x2, bias ? bias + half + c0 : nullptr);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float c = cs[c0 + e], sn = cs[half + c0 + e];
        o1[e] = __fsub_rn(__fmul_rn(x1[e], c), __fmul_rn(x2[e], sn));
        o2[e] = __fadd_rn(__fmul_rn(x2[e], c), __fmul_rn(x1[e], sn));
      }
      store<T, VEC>(out + c0, o1);
      store<T, VEC>(out + half + c0, o2);
    } else {
      const int c0 = t < 2 ? a.d_rot + (j - rot_units) * VEC : j * VEC;
      float v[VEC];
      load<T, VEC>(in + c0, v);
      add_bias<T, VEC>(v, bias ? bias + c0 : nullptr);
      store<T, VEC>(out + c0, v);
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_rope(const RopeArgs& a, int64_t tokens, cudaStream_t st) {
  const size_t smem = sizeof(float) * (size_t)a.d_rot;
  qkv_bias_rope_kernel<T, VEC><<<(unsigned)tokens, ROPE_THREADS, smem, st>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// swiglu
// ---------------------------------------------------------------------------

template <typename T, int VEC>
__global__ void swiglu_kernel(const T* __restrict__ gate, int64_t sg, const T* __restrict__ up,
                              int64_t su, T* __restrict__ out, int64_t rows, int nvec_row) {
  const int64_t total = rows * nvec_row;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; i < total; i += step) {
    const int64_t row = i / nvec_row;
    const int64_t c = (i - row * nvec_row) * VEC;
    float g[VEC], u[VEC], o[VEC];
    load<T, VEC>(gate + row * sg + c, g);
    load<T, VEC>(up + row * su + c, u);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      const float act = round_to<T>(__fdiv_rn(g[e], __fadd_rn(1.0f, expf(-g[e]))));
      o[e] = __fmul_rn(u[e], act);
    }
    store<T, VEC>(out + i * VEC, o);
  }
}

template <typename T, int VEC>
cudaError_t launch_swiglu(const void* gate, int64_t sg, const void* up, int64_t su, void* out,
                          int64_t rows, int n, cudaStream_t st) {
  const int nvec_row = n / VEC;
  const int64_t total = rows * nvec_row;
  int64_t blocks = (total + SWIGLU_THREADS - 1) / SWIGLU_THREADS;
  if (blocks > (1 << 20)) blocks = 1 << 20;
  swiglu_kernel<T, VEC><<<(unsigned)blocks, SWIGLU_THREADS, 0, st>>>(
      static_cast<const T*>(gate), sg, static_cast<const T*>(up), su, static_cast<T*>(out), rows,
      nvec_row);
  return cudaGetLastError();
}

}  // namespace

// Dtype codes: 0 = float32, 1 = bfloat16. `vec` is 1, or the 16-byte width
// (4 fp32, 8 bf16) where the wrapper found every shape, stride and pointer a
// multiple of it. Each function returns the CUDA error of its launch (0 on
// success) and does not synchronise.

extern "C" int add_rms_norm_fwd(const void* x, long long sx, const void* r, long long sr,
                                const void* scale, void* s_out, void* h_out, long long rows,
                                int d, float eps, int dtype, int vec, int threads, int device,
                                void* stream) {
  if (rows < 1 || rows > 0x7fffffffLL || d < 1 || threads < 32 || threads > 1024 ||
      threads % 32 || (d / vec + threads - 1) / threads > NORM_MAX_VECS || d % vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && vec == 8)
    return (int)launch_norm<__nv_bfloat16, 8>(x, sx, r, sr, scale, s_out, h_out, rows, d, eps,
                                              threads, st);
  if (dtype == 1 && vec == 1)
    return (int)launch_norm<__nv_bfloat16, 1>(x, sx, r, sr, scale, s_out, h_out, rows, d, eps,
                                              threads, st);
  if (dtype == 0 && vec == 4)
    return (int)launch_norm<float, 4>(x, sx, r, sr, scale, s_out, h_out, rows, d, eps, threads,
                                      st);
  if (dtype == 0 && vec == 1)
    return (int)launch_norm<float, 1>(x, sx, r, sr, scale, s_out, h_out, rows, d, eps, threads,
                                      st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int qkv_bias_rope_fwd(
    const void* q, long long qsb, long long qss, long long qsh, const void* bq, void* oq, int hq,
    const void* k, long long ksb, long long kss, long long ksh, const void* bk, void* ok, int hk,
    const void* v, long long vsb, long long vss, long long vsh, const void* bv, void* ov, int hv,
    long long B, long long S, int D, int d_rot, const void* pos, long long pos_sb,
    long long pos_ss, int pos64, const void* freqs, int dtype, int vec, int device,
    void* stream) {
  if (B < 1 || S < 1 || B * S > 0x7fffffffLL || D < 1 || d_rot < 0 || d_rot > D || d_rot % 2 ||
      D % vec || (d_rot / 2) % vec)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  RopeArgs a;
  a.slot[0] = Slot{q, qsb, qss, qsh, bq, oq, hq};
  a.slot[1] = Slot{k, ksb, kss, ksh, bk, ok, hk};
  a.slot[2] = Slot{v, vsb, vss, vsh, bv, ov, hv};
  a.S = S;
  a.D = D;
  a.d_rot = d_rot;
  a.pos = pos;
  a.pos_sb = pos_sb;
  a.pos_ss = pos_ss;
  a.pos64 = pos64;
  a.freqs = static_cast<const float*>(freqs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t tokens = B * S;
  if (dtype == 1 && vec == 8) return (int)launch_rope<__nv_bfloat16, 8>(a, tokens, st);
  if (dtype == 1 && vec == 1) return (int)launch_rope<__nv_bfloat16, 1>(a, tokens, st);
  if (dtype == 0 && vec == 4) return (int)launch_rope<float, 4>(a, tokens, st);
  if (dtype == 0 && vec == 1) return (int)launch_rope<float, 1>(a, tokens, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" int swiglu_fwd(const void* gate, long long sg, const void* up, long long su, void* out,
                          long long rows, int n, int dtype, int vec, int device, void* stream) {
  if (rows < 1 || n < 1 || n % vec) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 1 && vec == 8)
    return (int)launch_swiglu<__nv_bfloat16, 8>(gate, sg, up, su, out, rows, n, st);
  if (dtype == 1 && vec == 1)
    return (int)launch_swiglu<__nv_bfloat16, 1>(gate, sg, up, su, out, rows, n, st);
  if (dtype == 0 && vec == 4)
    return (int)launch_swiglu<float, 4>(gate, sg, up, su, out, rows, n, st);
  if (dtype == 0 && vec == 1)
    return (int)launch_swiglu<float, 1>(gate, sg, up, su, out, rows, n, st);
  return (int)cudaErrorInvalidValue;
}
