// Shared-memory tiled float32 product of the ngram_sim kernel.
//
// One block computes a BM x BN tile of A(M, K) @ op(B), where op(B) is
// B(K, N) or, with B_TRANS, the transpose of B(N, K).  All three are
// row-major and contiguous.  Each thread owns TM x TN outputs at rows
// ty + i * (BM / TM) and columns tx + j * (BN / TN), so neighbouring
// threads store neighbouring columns.  Every output is summed in
// ascending k with fmaf in true float32 (no TF32, no tensor cores): one
// fixed summation order, so a launch is bit-reproducible.  The ragged
// edge is zero-filled in shared memory, and fmaf(0, 0, acc) == acc.
#pragma once

#include <cuda_runtime.h>

namespace repro {

template <int BM, int BN, int BK, int TM, int TN, bool B_TRANS>
__device__ __forceinline__ void tile_product(const float* __restrict__ A,
                                             const float* __restrict__ B,
                                             int M, int N, int K, int m0,
                                             int n0, float (&acc)[TM][TN]) {
  constexpr int TX = BN / TN;  // threads along N
  constexpr int TY = BM / TM;  // threads along M
  constexpr int NT = TX * TY;
  __shared__ float As[BM][BK + 1];
  __shared__ float Bs[BK][BN + 1];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;

#pragma unroll
  for (int i = 0; i < TM; ++i) {
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = tid; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const int gm = m0 + r, gk = k0 + c;
      As[r][c] = (gm < M && gk < K) ? A[(size_t)gm * K + gk] : 0.f;
    }
    for (int idx = tid; idx < BK * BN; idx += NT) {
      if (B_TRANS) {
        // consecutive threads walk k, which is contiguous in B(N, K)
        const int c = idx / BK, r = idx % BK;
        const int gn = n0 + c, gk = k0 + r;
        Bs[r][c] = (gn < N && gk < K) ? B[(size_t)gn * K + gk] : 0.f;
      } else {
        const int r = idx / BN, c = idx % BN;
        const int gk = k0 + r, gn = n0 + c;
        Bs[r][c] = (gk < K && gn < N) ? B[(size_t)gk * N + gn] : 0.f;
      }
    }
    __syncthreads();

#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[ty + i * TY][kk];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i) {
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
    }
    __syncthreads();
  }
}

}  // namespace repro
