// Thresholded n-gram cosine similarity: out[m, n] = s if s >= threshold else 0,
// s = sum_f A[m, f] B[n, f].
//
// Replaces the Pallas TPU kernel src/repro/kernels/ngram_sim/kernel.py
// (sim_above, and sim_matrix, which is its threshold = -2 case).
//
// Bound on the H100: the canopy probe is M = 1 against N <= 1024 rows of
// F = 128, so it reads B once (512 KB) for 2 N F flops: bound by bytes,
// and in practice by launch latency.  The all-pairs form (M, N ~ 10^3)
// is a small float32 GEMM, bound by operations.
//
// Design: the shared-memory tiled product of tiled.cuh with B read
// transposed (consecutive threads walk F, which is contiguous in B), and
// the threshold applied in the epilogue so that sub-threshold entries
// are zero before they leave the block.  A skinny 8 x 32 tile for
// M <= 8 (the canopy probe spreads over N / 32 blocks); 64 x 64 with
// 4 x 4 outputs a thread otherwise.

#include "tiled.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    ngram_sim_kernel(const float* __restrict__ A, const float* __restrict__ B,
                     float* __restrict__ out, int M, int N, int F,
                     float threshold) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  repro::tile_product<BM, BN, BK, TM, TN, true>(A, B, M, N, F, m0, n0, acc);

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + j * TX;
      if (m < M && n < N) {
        const float s = acc[i][j];
        out[(size_t)m * N + n] = s >= threshold ? s : 0.f;
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
int launch(const float* A, const float* B, float* out, int M, int N, int F,
           float threshold, cudaStream_t stream) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM, 1);
  ngram_sim_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(A, B, out, M, N, F,
                                                   threshold);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_ngram_sim(const float* A, const float* B, float* out,
                               int M, int N, int F, float threshold,
                               void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 8) return launch<8, 32, 32, 1, 1>(A, B, out, M, N, F, threshold, st);
  return launch<64, 64, 16, 4, 4>(A, B, out, M, N, F, threshold, st);
}
