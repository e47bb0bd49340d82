// Grouped-query softmax attention with an online softmax (flash attention):
//   out[b, s, h*hd + d] = sum_t softmax_t(scale * q[b,s,h,:] . k[b,t,h/G,:]) v[b,t,h/G,d]
// with G = H / Hkv query heads for each KV head.  q (B, S, H, hd), k and v
// (B, T, Hkv, hd), all contiguous and of one type (float32 or bfloat16);
// out (B, S, H*hd) float32.  Causal attention keeps row >= col, both
// counted from 0 (top-left aligned, also when S != T).
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attn/kernel.py
// (flash_attention).  The Pallas version transposed q, k and v to
// head-major (B*H, S, hd) arrays and padded S and T to its tiles before
// the call; this kernel reads the (B, S, H, hd) projections in place,
// computes its own offsets and masks the ragged edges of S and T itself.
//
// Bound on the H100: 4 B H S T hd flops (two products of 2 S T hd a
// head), about half of that when causal, and q, k and v read once and
// the output written once.  At the serving path's prefill shapes (S = 32
// to 4096, hd = 128, bf16) the flops bound it against the tensor cores'
// 989 TFLOP/s; at S = 32 the bytes do.  This kernel does its products
// with float32 FMAs outside the tensor cores (67 TFLOP/s), so it cannot
// come near that bound: a wgmma/TMA design is later work.
//
// Design: one block of 16 x 16 threads for each (b*H + h, 64-row query
// tile).  The query tile is staged in shared memory once, in float32.
// The block then walks the 64-row K/V tiles of its KV head (no copy of K
// or V per query head): it stages them in float32, computes the 64 x 64
// scores (each thread 4 rows x 4 columns, strided by 16, so that a
// half-warp shares a row and reads 16 banks), masks them, and updates the
// running max and sum of each row with shuffles over the 16 threads of
// the row.  The probabilities stay float32 in shared memory for the
// P @ V product, whose 64 x hd accumulator lives in registers (4 rows x
// hd/16 columns a thread).  A tile whose first key lies after the
// block's last query is dead under the causal mask; the loop stops
// there, since every later tile is dead too.  NEG_INF is finite (-1e30,
// as in the Pallas kernel), so exp(m_prev - m_new) is never inf - inf,
// and the denominator is clamped at 1e-30.  Shared memory is dynamic
// (115 KB at hd = 128, above the 48 KB static limit), which leaves room
// for one block an SM at hd = 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int BQ = 64;  // query rows a block
constexpr int BK = 64;  // key rows a tile
constexpr int TX = 16;  // threads along keys (scores) and head dim (output)
constexpr int TY = 16;  // threads along query rows
constexpr int NT = TX * TY;
constexpr int RQ = BQ / TY;  // query rows a thread: ty + i * TY
constexpr int RK = BK / TX;  // key columns a thread: tx + j * TX

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
struct Layout {
  static constexpr int QS = HD + 1;  // padded row strides (floats)
  static constexpr int KS = HD + 1;
  static constexpr int VS = HD;
  static constexpr int PS = BK + 1;
  static constexpr int DJ = (HD + TX - 1) / TX;  // output columns a thread
  static constexpr size_t bytes = sizeof(float) * (BQ * QS + BK * KS + BK * VS + BQ * PS);
};

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, float* __restrict__ out, int S,
                      int Tn, int H, int Hkv, float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + BQ * L::QS;
  float* Vs = Ks + BK * L::KS;
  float* Ps = Vs + BK * L::VS;

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int b = blockIdx.x / H;
  const int h = blockIdx.x % H;
  const int kvh = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const size_t q_step = (size_t)H * HD;  // elements between sequence positions
  const size_t kv_step = (size_t)Hkv * HD;
  const T* qb = q + (size_t)b * S * q_step + (size_t)h * HD;
  const T* kb = k + (size_t)b * Tn * kv_step + (size_t)kvh * HD;
  const T* vb = v + (size_t)b * Tn * kv_step + (size_t)kvh * HD;

  for (int idx = tid; idx < BQ * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int s = q0 + r;
    Qs[r * L::QS + d] = s < S ? to_f32(qb[(size_t)s * q_step + d]) : 0.f;
  }

  float m[RQ], l[RQ], acc[RQ][L::DJ];
#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) acc[i][j] = 0.f;
  }

  const int q_last = min(q0 + BQ, S) - 1;
  for (int k0 = 0; k0 < Tn; k0 += BK) {
    if (causal && k0 > q_last) break;  // dead tile, and so is every later one
    __syncthreads();  // the last tile's readers are done with Ks, Vs and Ps
    for (int idx = tid; idx < BK * HD; idx += NT) {
      const int r = idx / HD, d = idx % HD;
      const int t = k0 + r;
      const bool live = t < Tn;
      Ks[r * L::KS + d] = live ? to_f32(kb[(size_t)t * kv_step + d]) : 0.f;
      Vs[r * L::VS + d] = live ? to_f32(vb[(size_t)t * kv_step + d]) : 0.f;
    }
    __syncthreads();

    float s[RQ][RK];
#pragma unroll
    for (int i = 0; i < RQ; ++i) {
#pragma unroll
      for (int j = 0; j < RK; ++j) s[i][j] = 0.f;
    }
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[RQ], kv[RK];
#pragma unroll
      for (int i = 0; i < RQ; ++i) qv[i] = Qs[(ty + i * TY) * L::QS + d];
#pragma unroll
      for (int j = 0; j < RK; ++j) kv[j] = Ks[(tx + j * TX) * L::KS + d];
#pragma unroll
      for (int i = 0; i < RQ; ++i) {
#pragma unroll
        for (int j = 0; j < RK; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RQ; ++i) {
      const int row = q0 + ty + i * TY;
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const int col = k0 + tx + j * TX;
        float x = s[i][j] * scale;
        if (col >= Tn || (causal && col > row)) x = NEG_INF;
        s[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, TX));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < RK; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + i * TY) * L::PS + tx + j * TX] = p;
        sum += p;
      }
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off, TX);
      l[i] = alpha * l[i] + sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < L::DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float pv[RQ];
#pragma unroll
      for (int i = 0; i < RQ; ++i) pv[i] = Ps[(ty + i * TY) * L::PS + c];
#pragma unroll
      for (int j = 0; j < L::DJ; ++j) {
        const int d = tx + j * TX;
        if (d < HD) {
          const float vv = Vs[c * L::VS + d];
#pragma unroll
          for (int i = 0; i < RQ; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RQ; ++i) {
    const int row = q0 + ty + i * TY;
    if (row >= S) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    float* o = out + ((size_t)b * S + row) * q_step + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) {
      const int d = tx + j * TX;
      if (d < HD) o[d] = acc[i][j] / denom;
    }
  }
}

// Raise the kernel's dynamic shared memory limit once per device, at its
// first launch there, so that a launch captured into a CUDA graph later
// makes no attribute call.
template <typename T, int HD>
cudaError_t allow_smem(int bytes) {
  static std::atomic<bool> done[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 64 && done[dev].load()) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_attn_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && dev < 64) done[dev].store(true);
  return err;
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, float* out, int B,
                   int S, int Tn, int H, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  auto kernel = flash_attn_kernel<T, HD>;
  const int bytes = (int)Layout<HD>::bytes;
  cudaError_t err = allow_smem<T, HD>(bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * H, (S + BQ - 1) / BQ, 1);
  kernel<<<grid, NT, bytes, stream>>>(static_cast<const T*>(q), static_cast<const T*>(k),
                                      static_cast<const T*>(v), out, S, Tn, H, Hkv, scale,
                                      causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, float* out,
                      int B, int S, int Tn, int H, int Hkv, float scale, int causal,
                      cudaStream_t stream) {
  switch (hd) {
    case 8: return launch<T, 8>(q, k, v, out, B, S, Tn, H, Hkv, scale, causal, stream);
    case 16: return launch<T, 16>(q, k, v, out, B, S, Tn, H, Hkv, scale, causal, stream);
    case 32: return launch<T, 32>(q, k, v, out, B, S, Tn, H, Hkv, scale, causal, stream);
    case 64: return launch<T, 64>(q, k, v, out, B, S, Tn, H, Hkv, scale, causal, stream);
    case 128: return launch<T, 128>(q, k, v, out, B, S, Tn, H, Hkv, scale, causal, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike).
extern "C" int repro_flash_attn(const void* q, const void* k, const void* v, float* out,
                                int B, int S, int T, int H, int Hkv, int hd, float scale,
                                int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0) return 0;
  if (T <= 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, out, B, S, T, H, Hkv, scale, causal, st);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, out, B, S, T, H, Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
