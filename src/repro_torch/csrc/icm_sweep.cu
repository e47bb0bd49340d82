// ICM conditional-delta sweep: out[b, s, p] = u[b, p] + sum_q X[b, s, q] C[b, q, p].
//
// Replaces the Pallas TPU kernel src/repro/kernels/icm_sweep/kernel.py
// (sweep_matrix, and sweep / sweep_batch, which are its S = 1 cases).
//
// Bound on the H100: at the main path's shapes (P <= 496) the S = 1
// sweep of the MLN closure reads C once (about 1 MB) and does 2 P^2
// flops, so it is bound by bytes, and at B = 1 by launch latency.  The
// S = P sweep of the entailment matrix does 2 P^3 flops on 2 MB, so it
// is bound by float32 operations (no TF32: decisions are taken against
// TIE_EPS = 1e-5, and TF32 would round w_co and the unaries).
//
// Design: a shared-memory tiled product (tiled.cuh) with the unary added
// in the epilogue, so the (S, P) product never goes to device memory
// before the bias.  Two tile shapes: a skinny 8 x 32 tile for S <= 8, so
// that the mat-vec still spreads over P / 32 blocks per neighborhood, and
// a 64 x 64 tile with 4 x 4 outputs a thread for the S = P sweep.

#include "tiled.cuh"

namespace {

template <int BM, int BN, int BK, int TM, int TN>
__global__ void __launch_bounds__((BM / TM) * (BN / TN))
    icm_sweep_kernel(const float* __restrict__ u, const float* __restrict__ C,
                     const float* __restrict__ X, float* __restrict__ out,
                     int S, int P) {
  constexpr int TX = BN / TN;
  constexpr int TY = BM / TM;
  const int b = blockIdx.z;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  float acc[TM][TN];
  repro::tile_product<BM, BN, BK, TM, TN, false>(
      X + (size_t)b * S * P, C + (size_t)b * P * P, S, P, P, m0, n0, acc);

  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int s = m0 + ty + i * TY;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int p = n0 + tx + j * TX;
      if (s < S && p < P) {
        out[((size_t)b * S + s) * P + p] = u[(size_t)b * P + p] + acc[i][j];
      }
    }
  }
}

template <int BM, int BN, int BK, int TM, int TN>
int launch(const float* u, const float* C, const float* X, float* out, int B,
           int S, int P, cudaStream_t stream) {
  const dim3 grid((P + BN - 1) / BN, (S + BM - 1) / BM, B);
  icm_sweep_kernel<BM, BN, BK, TM, TN>
      <<<grid, (BM / TM) * (BN / TN), 0, stream>>>(u, C, X, out, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_icm_sweep(const float* u, const float* C, const float* X,
                               float* out, int B, int S, int P, void* stream) {
  if (B == 0 || S == 0 || P == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 8) return launch<8, 32, 32, 1, 1>(u, C, X, out, B, S, P, st);
  return launch<64, 64, 16, 4, 4>(u, C, X, out, B, S, P, st);
}
