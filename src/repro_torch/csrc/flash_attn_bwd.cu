// The gradient of grouped-query softmax attention with float32 FMAs: the
// backward of flash_attn.cu, for every input the tensor-core backward
// (flash_attn_bwd_sm90.cu) does not take: float32 q, k and v, and bfloat16
// with hd 8, 16 or 32.  Given q (B, S, H, hd), k and v (B, T, Hkv, hd), the
// forward's output o and its gradient do (both (B, S, H*hd) float32) and its
// row log-sum-exp lse (B, H, S), it writes dq (B, S, H, hd), dk and dv
// (B, T, Hkv, hd), all float32.  With P = exp(scale q.k - lse) under the
// forward's mask (causal keeps row >= col, top-left aligned) and
// D = rowsum(dO * O):
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D),  dQ = dS K scale,  dK = dS^T Q scale
// with each GQA group's G = H / Hkv query heads summed into its KV head.
//
// Replaces no TPU kernel: the Pallas flash_attention
// (src/repro/kernels/flash_attn/kernel.py) has no custom_vjp; the reference
// trains through XLA's autodiff of chunked attention.  This kernel exists so
// that no route of FlashAttention.backward runs PyTorch ops on the card.
// Training reaches it with the reduced configs: Qwen1.5-0.5B's smoke config
// (launch.train --smoke) is bf16 at hd 16.
//
// Bound on the H100: five products of 2 hd flops for each (row, col) pair
// the mask keeps, a head; in float32 outside the tensor cores (67 TFLOP/s)
// this kernel cannot come near the bf16 bound.
//
// Design, three launches, no atomics (two calls on one input give the same
// bits), the layout of flash_attn.cu's blocks of 16 x 16 threads:
// * D = rowsum(dO * O): one warp a (b, s, h) row, a fixed shuffle order.
// * dK, dV: one block for each (b * Hkv + kv head, 64-key tile), which stages
//   its K and V tiles in float32 once and walks the G query heads of its
//   group and their query tiles that see its keys (from the tile holding its
//   first key under the causal mask), staging each Q and dO tile, lse and D.
//   Each thread computes 4 key rows x 4 query columns of S^T and dP^T, then
//   P^T and dS^T go to shared memory and each thread accumulates 4 key rows x
//   hd/16 columns of dV += P^T dO and dK += dS^T Q in registers.
// * dQ: one block for each (b * H + h, 64-row query tile), which stages Q and
//   dO once and walks the key tiles it sees: S and dP again, dS through
//   shared memory, dQ += dS K in registers.
// Rows >= S and keys >= T are zero-filled when staged and masked in P;
// their gradients are not stored.  Shared memory is dynamic (165 KB for the
// dK/dV block at hd = 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "smem.cuh"

namespace {

constexpr int BQ = 64;  // query rows a tile
constexpr int BK = 64;  // key rows a tile
constexpr int TX = 16;
constexpr int TY = 16;
constexpr int NT = TX * TY;
constexpr int R = 4;  // rows (and columns) of a 64 x 64 tile a thread: ty + i * TY, tx + j * TX

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <int HD>
struct Layout {
  static constexpr int RS = HD + 1;  // padded row stride of a 64 x hd tile (floats)
  static constexpr int PS = 64 + 1;  // of a 64 x 64 tile
  static constexpr int DJ = (HD + TX - 1) / TX;  // hd columns a thread
  static constexpr int TILE = 64 * RS;
  // dK/dV: K, V, Q, dO, P^T, dS^T, lse, D; dQ: Q, dO, K, V, dS
  static constexpr size_t kv_bytes = sizeof(float) * (4 * TILE + 2 * 64 * PS + 2 * 64);
  static constexpr size_t q_bytes = sizeof(float) * (4 * TILE + 64 * PS);
};

// Stage rows [r0, r0 + 64) of head `head` of a (.., n_rows, heads, HD) tensor
// in float32, zeros past n_rows.
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n_rows,
                                      int heads, int head) {
  for (int idx = threadIdx.x; idx < 64 * HD; idx += NT) {
    const int r = idx / HD, d = idx % HD;
    const int row = r0 + r;
    dst[r * Layout<HD>::RS + d] =
        row < n_rows ? to_f32(src[((size_t)row * heads + head) * HD + d]) : 0.f;
  }
}

__global__ void __launch_bounds__(128)
    bwd_rowdot_kernel(const float* __restrict__ o, const float* __restrict__ dout,
                      float* __restrict__ D, int rows, int S, int H, int hd) {
  const int row = blockIdx.x * 4 + threadIdx.x / 32;  // (b * S + s) * H + h
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  const size_t base = (size_t)row * hd;
  float sum = 0.f;
  for (int i = lane; i < hd; i += 32) sum = fmaf(dout[base + i], o[base + i], sum);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
  if (lane == 0) {
    const int h = row % H, s = (row / H) % S, b = row / (H * S);
    D[((size_t)b * H + h) * S + s] = sum;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ D, float* __restrict__ dk, float* __restrict__ dv,
                    int S, int Tn, int H, int Hkv, float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + L::TILE;
  float* Qs = Vs + L::TILE;
  float* dOs = Qs + L::TILE;
  float* Ps = dOs + L::TILE;  // P^T: [key][query]
  float* dSs = Ps + 64 * L::PS;
  float* lse_s = dSs + 64 * L::PS;
  float* d_s = lse_s + 64;

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x / Hkv, kvh = blockIdx.x % Hkv, G = H / Hkv;
  const int k0 = blockIdx.y * BK;
  const int n_q = (S + BQ - 1) / BQ;
  const int q_first = causal ? k0 / BQ : 0;

  stage<T, HD>(Ks, k + (size_t)b * Tn * Hkv * HD, k0, Tn, Hkv, kvh);
  stage<T, HD>(Vs, v + (size_t)b * Tn * Hkv * HD, k0, Tn, Hkv, kvh);

  float dk_acc[R][L::DJ], dv_acc[R][L::DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) dk_acc[i][j] = dv_acc[i][j] = 0.f;
  }

  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    for (int qt = q_first; qt < n_q; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();  // the last tile's readers are done
      stage<T, HD>(Qs, q + (size_t)b * S * H * HD, q0, S, H, h);
      stage<float, HD>(dOs, dout + (size_t)b * S * H * HD, q0, S, H, h);
      if (tid < 64) {
        const int qr = q0 + tid;
        const size_t at = ((size_t)b * H + h) * S + qr;
        lse_s[tid] = qr < S ? lse[at] : 0.f;
        d_s[tid] = qr < S ? D[at] : 0.f;
      }
      __syncthreads();

      float s[R][R], dp[R][R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
      }
#pragma unroll 4
      for (int d = 0; d < HD; ++d) {
        float kv[R], vv[R], qv[R], ov[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          kv[i] = Ks[(ty + i * TY) * L::RS + d];
          vv[i] = Vs[(ty + i * TY) * L::RS + d];
          qv[i] = Qs[(tx + i * TX) * L::RS + d];
          ov[i] = dOs[(tx + i * TX) * L::RS + d];
        }
#pragma unroll
        for (int i = 0; i < R; ++i) {
#pragma unroll
          for (int j = 0; j < R; ++j) {
            s[i][j] = fmaf(kv[i], qv[j], s[i][j]);
            dp[i][j] = fmaf(vv[i], ov[j], dp[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int kr = ty + i * TY, key = k0 + kr;
#pragma unroll
        for (int j = 0; j < R; ++j) {
          const int qc = tx + j * TX, qr = q0 + qc;
          float p = expf(s[i][j] * scale - lse_s[qc]);
          if (qr >= S || key >= Tn || (causal && qr < key)) p = 0.f;
          Ps[kr * L::PS + qc] = p;
          dSs[kr * L::PS + qc] = p * (dp[i][j] - d_s[qc]);
        }
      }
      __syncthreads();

#pragma unroll 4
      for (int c = 0; c < BQ; ++c) {
        float pv[R], sv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) {
          pv[i] = Ps[(ty + i * TY) * L::PS + c];
          sv[i] = dSs[(ty + i * TY) * L::PS + c];
        }
#pragma unroll
        for (int j = 0; j < L::DJ; ++j) {
          const int d = tx + j * TX;
          if (d < HD) {
            const float o_ = dOs[c * L::RS + d], q_ = Qs[c * L::RS + d];
#pragma unroll
            for (int i = 0; i < R; ++i) {
              dv_acc[i][j] = fmaf(pv[i], o_, dv_acc[i][j]);
              dk_acc[i][j] = fmaf(sv[i], q_, dk_acc[i][j]);
            }
          }
        }
      }
    }
  }

  const size_t stride = (size_t)Hkv * HD;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int key = k0 + ty + i * TY;
    if (key >= Tn) continue;
    const size_t at = ((size_t)b * Tn + key) * stride + (size_t)kvh * HD;
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) {
      const int d = tx + j * TX;
      if (d < HD) {
        dk[at + d] = dk_acc[i][j] * scale;
        dv[at + d] = dv_acc[i][j];
      }
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
    bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ dout, const float* __restrict__ lse,
                  const float* __restrict__ D, float* __restrict__ dq, int S, int Tn, int H,
                  int Hkv, float scale, int causal) {
  using L = Layout<HD>;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* dOs = Qs + L::TILE;
  float* Ks = dOs + L::TILE;
  float* Vs = Ks + L::TILE;
  float* dSs = Vs + L::TILE;  // [query][key]

  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / (H / Hkv);
  const int q0 = blockIdx.y * BQ;
  const int q_last = min(q0 + BQ, S) - 1;

  stage<T, HD>(Qs, q + (size_t)b * S * H * HD, q0, S, H, h);
  stage<float, HD>(dOs, dout + (size_t)b * S * H * HD, q0, S, H, h);
  float l_row[R], d_row[R];
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty + i * TY;
    const size_t at = ((size_t)b * H + h) * S + qr;
    l_row[i] = qr < S ? lse[at] : 0.f;
    d_row[i] = qr < S ? D[at] : 0.f;
  }

  float dq_acc[R][L::DJ];
#pragma unroll
  for (int i = 0; i < R; ++i) {
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) dq_acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Tn; k0 += BK) {
    if (causal && k0 > q_last) break;  // dead tile, and so is every later one
    __syncthreads();  // the last tile's readers are done
    stage<T, HD>(Ks, k + (size_t)b * Tn * Hkv * HD, k0, Tn, Hkv, kvh);
    stage<T, HD>(Vs, v + (size_t)b * Tn * Hkv * HD, k0, Tn, Hkv, kvh);
    __syncthreads();

    float s[R][R], dp[R][R];
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < R; ++j) s[i][j] = dp[i][j] = 0.f;
    }
#pragma unroll 4
    for (int d = 0; d < HD; ++d) {
      float qv[R], ov[R], kv[R], vv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        qv[i] = Qs[(ty + i * TY) * L::RS + d];
        ov[i] = dOs[(ty + i * TY) * L::RS + d];
        kv[i] = Ks[(tx + i * TX) * L::RS + d];
        vv[i] = Vs[(tx + i * TX) * L::RS + d];
      }
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int j = 0; j < R; ++j) {
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
          dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
      const int qr = q0 + ty + i * TY;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int kc = tx + j * TX, key = k0 + kc;
        float p = expf(s[i][j] * scale - l_row[i]);
        if (qr >= S || key >= Tn || (causal && key > qr)) p = 0.f;
        dSs[(ty + i * TY) * L::PS + kc] = p * (dp[i][j] - d_row[i]);
      }
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < BK; ++c) {
      float sv[R];
#pragma unroll
      for (int i = 0; i < R; ++i) sv[i] = dSs[(ty + i * TY) * L::PS + c];
#pragma unroll
      for (int j = 0; j < L::DJ; ++j) {
        const int d = tx + j * TX;
        if (d < HD) {
          const float k_ = Ks[c * L::RS + d];
#pragma unroll
          for (int i = 0; i < R; ++i) dq_acc[i][j] = fmaf(sv[i], k_, dq_acc[i][j]);
        }
      }
    }
  }

  const size_t stride = (size_t)H * HD;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int qr = q0 + ty + i * TY;
    if (qr >= S) continue;
    float* dst = dq + ((size_t)b * S + qr) * stride + (size_t)h * HD;
#pragma unroll
    for (int j = 0; j < L::DJ; ++j) {
      const int d = tx + j * TX;
      if (d < HD) dst[d] = dq_acc[i][j] * scale;
    }
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const float* o,
                   const float* dout, const float* lse, float* D, float* dq, float* dk,
                   float* dv, int B, int S, int Tn, int H, int Hkv, float scale, int causal,
                   cudaStream_t stream) {
  static std::atomic<bool> kv_done[64], q_done[64];
  using L = Layout<HD>;
  cudaError_t err = repro::allow_smem(bwd_dkdv_kernel<T, HD>, (int)L::kv_bytes, kv_done);
  if (err != cudaSuccess) return err;
  err = repro::allow_smem(bwd_dq_kernel<T, HD>, (int)L::q_bytes, q_done);
  if (err != cudaSuccess) return err;
  const int rows = B * S * H;
  bwd_rowdot_kernel<<<(rows + 3) / 4, 128, 0, stream>>>(o, dout, D, rows, S, H, HD);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  bwd_dkdv_kernel<T, HD><<<dim3(B * Hkv, (Tn + BK - 1) / BK), NT, L::kv_bytes, stream>>>(
      qt, kt, vt, dout, lse, D, dk, dv, S, Tn, H, Hkv, scale, causal);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dq_kernel<T, HD><<<dim3(B * H, (S + BQ - 1) / BQ), NT, L::q_bytes, stream>>>(
      qt, kt, vt, dout, lse, D, dq, S, Tn, H, Hkv, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_hd(int hd, const void* q, const void* k, const void* v, const float* o,
                      const float* dout, const float* lse, float* D, float* dq, float* dk,
                      float* dv, int B, int S, int Tn, int H, int Hkv, float scale, int causal,
                      cudaStream_t st) {
  switch (hd) {
#define REPRO_HD(N)                                                                            \
  case N:                                                                                      \
    return launch<T, N>(q, k, v, o, dout, lse, D, dq, dk, dv, B, S, Tn, H, Hkv, scale, causal, \
                        st);
    REPRO_HD(8)
    REPRO_HD(16)
    REPRO_HD(32)
    REPRO_HD(64)
    REPRO_HD(128)
#undef REPRO_HD
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (q, k and v alike); o, do (B, S, H*hd),
// lse (B, H, S) float32; scratch D (B, H, S) float32; outputs dq (B, S, H, hd),
// dk and dv (B, T, Hkv, hd) float32.
extern "C" int repro_flash_attn_bwd(const void* q, const void* k, const void* v, const float* o,
                                    const float* dout, const float* lse, float* D, float* dq,
                                    float* dk, float* dv, int B, int S, int T, int H, int Hkv,
                                    int hd, float scale, int causal, int dtype, void* stream) {
  if (B == 0 || S == 0 || H == 0 || T == 0) return 0;
  if (T < 0 || Hkv <= 0 || H % Hkv != 0 || (S + BQ - 1) / BQ > 65535 || (T + BK - 1) / BK > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return (int)launch_hd<float>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T, H, Hkv, scale,
                                 causal, st);
  if (dtype == 1)
    return (int)launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, D, dq, dk, dv, B, S, T, H,
                                         Hkv, scale, causal, st);
  return (int)cudaErrorInvalidValue;
}
