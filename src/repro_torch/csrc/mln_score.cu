// Supermodular set score: out[b, s] = x . u[b] + 1/2 x C[b] x^T, x = X[b, s, :].
//
// Replaces the Pallas TPU kernel src/repro/kernels/mln_score/kernel.py
// (score_sets).
//
// Bound on the H100: every (b, s-tile) reads its neighborhood's C[b]
// (P^2 floats, about 1 MB at P = 496) for 2 TS P^2 flops.  At the main
// path's S = 1 that is one read of C per flop pair: bound by bytes.
//
// Design: one block per (s-tile, b).  Each thread owns columns p (strided
// by the block size), so a warp reads a row segment of C[b] coalesced,
// and computes y[t] = sum_q x_t[q] C[q, p] for the TS rows of its tile in
// ascending q.  It folds x_t[p] (u[p] + y[t] / 2) into a per-thread
// partial; a fixed-order tree reduction in shared memory then sums the
// partials.  No atomics, so a launch is bit-reproducible.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileS = 4;

__global__ void __launch_bounds__(kThreads)
    mln_score_kernel(const float* __restrict__ u, const float* __restrict__ C,
                     const float* __restrict__ X, float* __restrict__ out,
                     int S, int P) {
  __shared__ float red[kTileS][kThreads];
  const int b = blockIdx.y;
  const int s0 = blockIdx.x * kTileS;
  const int ns = min(kTileS, S - s0);
  const float* Cb = C + (size_t)b * P * P;
  const float* Xs = X + ((size_t)b * S + s0) * P;
  const float* ub = u + (size_t)b * P;
  const int tid = threadIdx.x;

  float part[kTileS];
#pragma unroll
  for (int t = 0; t < kTileS; ++t) part[t] = 0.f;

  for (int p = tid; p < P; p += kThreads) {
    float y[kTileS];
#pragma unroll
    for (int t = 0; t < kTileS; ++t) y[t] = 0.f;
    for (int q = 0; q < P; ++q) {
      const float c = Cb[(size_t)q * P + p];
#pragma unroll
      for (int t = 0; t < kTileS; ++t) {
        if (t < ns) y[t] = fmaf(Xs[(size_t)t * P + q], c, y[t]);
      }
    }
    const float up = ub[p];
#pragma unroll
    for (int t = 0; t < kTileS; ++t) {
      if (t < ns) part[t] = fmaf(Xs[(size_t)t * P + p], fmaf(0.5f, y[t], up), part[t]);
    }
  }

#pragma unroll
  for (int t = 0; t < kTileS; ++t) red[t][tid] = part[t];
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
#pragma unroll
      for (int t = 0; t < kTileS; ++t) red[t][tid] += red[t][tid + stride];
    }
    __syncthreads();
  }
  if (tid < ns) out[(size_t)b * S + s0 + tid] = red[tid][0];
}

}  // namespace

extern "C" int repro_mln_score(const float* u, const float* C, const float* X,
                               float* out, int B, int S, int P, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((S + kTileS - 1) / kTileS, B, 1);
  mln_score_kernel<<<grid, kThreads, 0, st>>>(u, C, X, out, S, P);
  return (int)cudaGetLastError();
}
