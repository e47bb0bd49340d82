// Supermodular set score: out[b, s] = x . u[b] + 1/2 x C[b] x^T, x = X[b, s, :].
// u (B, P), C (B, P, P), X (B, S, P) float32, contiguous; out (B, S).
//
// Replaces the Pallas TPU kernel src/repro/kernels/mln_score/kernel.py:81
// (score_sets), which tiled X @ C densely over every (q, p) on the MXU.
//
// Bound on the H100, two ways, both by bytes (each C value read feeds 2
// flops).  A kernel that reads all of C[b] moves 4 (B P + B P^2 + B S P +
// B S) bytes: 189 MB at B = 192, P = 496, S = 1, 0.057 ms at the H100
// SXM's published 3.35 TB/s (700 W) -- the dense bound.  But q adds
// x_q sum_p C[q, p] x_p, which is zero when x_q is zero, so a kernel needs
// only the rows of C[b] at the present q: 4 (B P + B S P + B S +
// P sum_{b,s} nnz(x_{b,s})) bytes at S = 1 -- the present-rows bound.  On
// the main path x is a match set: the MMP fixpoint lists 34.9 of a k = 32
// neighborhood's 496 pairs on average (174 at most), 14 MB in all, 13
// times fewer bytes than the dense bound.
//
// Design: one block of 512 threads per (b, s) row; at the path's S = 1
// that is B = 192 blocks, all resident at once (2 blocks an SM), so there
// is no second wave.  The block
//   1. stages x in shared memory with 16-byte loads (4-byte loads when
//      P % 4 != 0 or a pointer is not 16-byte aligned) and sums its
//      linear term x . u on the way;
//   2. lists the present q (x_q != 0) in ascending order in shared memory:
//      warp 0 turns 32 tests at a time into list entries with
//      __ballot_sync and __popc;
//   3. reads only the listed rows: warp w takes listed rows w, w + 16, ...,
//      kRows of them at once so that kRows 16-byte loads a lane are in
//      flight, and each lane folds x_q (C[q, p..p+3] . x[p..p+3]) into its
//      partial for its columns p, with x_p from shared memory.
// Skipping x_q == 0 (and -0.0) changes no value when C is finite: the
// skipped term is exactly zero.  The partials are summed in a fixed order
// (warp shuffles, then the warps' sums in warp order by one warp), with no
// atomics, so a launch is bit-reproducible.  A row with no present q
// writes its linear term alone.  S > 1 takes one block per (b, s) too;
// its repeated reads of C[b] (984 KB at P = 496) hit L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;  // listed rows a warp reads at once

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

template <bool VEC>
__global__ void __launch_bounds__(kThreads, 2)
    mln_score_kernel(const float* __restrict__ u, const float* __restrict__ C,
                     const float* __restrict__ X, float* __restrict__ out, int S, int P) {
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);                // (P rounded up to 4) floats
  int* list = reinterpret_cast<int*>(xs + ((P + 3) & ~3));    // P ints
  __shared__ float partial[kWarps];
  __shared__ int n_listed;

  const int row = blockIdx.x;  // b * S + s
  const int b = row / S;
  const float* x = X + (size_t)row * P;
  const float* ub = u + (size_t)b * P;
  const float* Cb = C + (size_t)b * P * P;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;

  // 1. stage x; linear term
  float acc = 0.f;
  if (VEC) {
    const int P4 = P / 4;
    for (int f = tid; f < P4; f += kThreads) {
      const float4 xv = __ldg(reinterpret_cast<const float4*>(x) + f);
      const float4 uv = __ldg(reinterpret_cast<const float4*>(ub) + f);
      smem4[f] = xv;
      acc = fmaf(xv.x, uv.x, acc);
      acc = fmaf(xv.y, uv.y, acc);
      acc = fmaf(xv.z, uv.z, acc);
      acc = fmaf(xv.w, uv.w, acc);
    }
  } else {
    for (int p = tid; p < P; p += kThreads) {
      const float xv = __ldg(x + p);
      xs[p] = xv;
      acc = fmaf(xv, __ldg(ub + p), acc);
    }
  }
  __syncthreads();

  // 2. list the present q, ascending
  if (warp == 0) {
    const unsigned below = (1u << lane) - 1;
    int count = 0;
    for (int q0 = 0; q0 < P; q0 += 32) {
      const int q = q0 + lane;
      const bool present = q < P && xs[q] != 0.f;
      const unsigned bits = __ballot_sync(0xffffffffu, present);
      if (present) list[count + __popc(bits & below)] = q;
      count += __popc(bits);
    }
    if (lane == 0) n_listed = count;
  }
  __syncthreads();

  // 3. the listed rows of C[b]
  const int n = n_listed;
  float quad = 0.f;
  for (int i0 = warp; i0 < n; i0 += kWarps * kRows) {
    const float* crow[kRows];
    float a[kRows];
    bool live[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r * kWarps;
      live[r] = i < n;
      const int q = live[r] ? list[i] : 0;
      crow[r] = Cb + (size_t)q * P;
      a[r] = live[r] ? xs[q] : 0.f;
    }
    if (VEC) {
      const int P4 = P / 4;
#pragma unroll 2
      for (int f = lane; f < P4; f += 32) {
        float4 c[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          c[r] = live[r] ? __ldg(reinterpret_cast<const float4*>(crow[r]) + f)
                         : make_float4(0.f, 0.f, 0.f, 0.f);
        }
        const float4 xp = smem4[f];
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          float d = c[r].x * xp.x;
          d = fmaf(c[r].y, xp.y, d);
          d = fmaf(c[r].z, xp.z, d);
          d = fmaf(c[r].w, xp.w, d);
          quad = fmaf(a[r], d, quad);
        }
      }
    } else {
#pragma unroll 4
      for (int p = lane; p < P; p += 32) {
        float c[kRows];
#pragma unroll
        for (int r = 0; r < kRows; ++r) c[r] = live[r] ? __ldg(crow[r] + p) : 0.f;
        const float xp = xs[p];
#pragma unroll
        for (int r = 0; r < kRows; ++r) quad = fmaf(a[r], c[r] * xp, quad);
      }
    }
  }

  // fixed-order reduction of the block's partials
  acc = warp_sum(fmaf(0.5f, quad, acc));
  if (lane == 0) partial[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    const float v = warp_sum(lane < kWarps ? partial[lane] : 0.f);
    if (lane == 0) out[row] = v;
  }
}

template <bool VEC>
int launch(const float* u, const float* C, const float* X, float* out, int B, int S, int P,
           cudaStream_t st) {
  const size_t smem = sizeof(float) * ((P + 3) & ~3) + sizeof(int) * (size_t)P;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        mln_score_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  mln_score_kernel<VEC><<<(unsigned)B * S, kThreads, smem, st>>>(u, C, X, out, S, P);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int repro_mln_score(const float* u, const float* C, const float* X,
                               float* out, int B, int S, int P, void* stream) {
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool aligned = ((uintptr_t)u | (uintptr_t)C | (uintptr_t)X) % 16 == 0;
  if (P % 4 == 0 && aligned) return launch<true>(u, C, X, out, B, S, P, st);
  return launch<false>(u, C, X, out, B, S, P, st);
}
