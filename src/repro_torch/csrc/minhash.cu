// MinHash signatures: out[n, h] = min { A(h, d) : X[n, d] > 0 } over d,
// EMPTY = 2^30 where row n has no present shingle.  X (N, D) float32
// presence, out (N, H) int32.  The int32 hash table is read as
// A(h, d) = A[h * stride_h + d * stride_d]: the (H, D) table itself
// (stride_h = D, stride_d = 1), or its (D, H) transposed copy
// (stride_h = 1, stride_d = H), in which a shingle d is one row.
//
// Replaces the Pallas TPU kernel src/repro/kernels/minhash/kernel.py
// (minhash).  The Pallas version fed X and A transposed, (D, N) and
// (D, H), so that N and H sat on the TPU's 128 lanes, and took the
// masked min densely over every d.
//
// Bound on the H100: the streaming ingest calls it with N = 59-68 rows
// against H = 128 hash functions over D = 512 shingle slots (and with
// N = 1,842 when the whole corpus is one batch).  It reads 4 (N D + H D)
// bytes and writes 4 N H: 426 KB at N = 64, 0.13 us at 3.35 TB/s.  A row
// holds about 9 of its 512 shingles, so the min the data needs is N H 9
// int32 operations, well below that.  Both bounds are far below the time
// of a launch: what bounds the kernel is latency, the number of dependent
// trips to memory a row takes, and a dense min over every d would spend
// about 98% of its compares on absent shingles.
//
// Design: compact, then gather.  One warp a row, one row a block (64
// blocks at N = 64).  The warp issues every load of a 512-wide slice of
// its row of X at once (16 bytes a lane when D % 4 == 0 and X is 16-byte
// aligned, else 4), turns the lanes' X > 0 tests into a list of the
// present d in shared memory with __ballot_sync and __popc, and then
// takes each lane's mins, for hashes h = lane + 32 j, over the listed d
// only, with the loads of 8 listed d in flight at once.  From the
// transposed copy each of those warp loads reads 128 contiguous bytes;
// from the (H, D) table each lane's load lands in a sector of its own.
// The result is exact: an integer min in any order is the same min.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t EMPTY = 1 << 30;
constexpr int CHUNK = 512;  // d listed at once
constexpr int HW = 4;       // hashes a lane holds: h0 + lane + 32 j, j < HW
constexpr int BATCH = 8;    // listed d whose loads are in flight together

// List the present d of x[d0 .. d0 + CHUNK - 1] (d < D) in list; returns
// how many.  Every lane of the warp takes part and gets the count.
template <bool VEC>
__device__ __forceinline__ int compact(const float* __restrict__ x, int D, int d0,
                                       int* list, int lane) {
  const unsigned below = (1u << lane) - 1;
  int count = 0;
  auto add = [&](float v, int d) {
    const bool present = v > 0.f;
    const unsigned bits = __ballot_sync(0xffffffffu, present);
    if (present) list[count + __popc(bits & below)] = d;
    count += __popc(bits);
  };
  if (VEC) {
    constexpr int STEPS = CHUNK / 128;
    float4 v[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int d = d0 + 128 * s + 4 * lane;
      v[s] = d < D ? __ldg(reinterpret_cast<const float4*>(x + d)) : make_float4(0, 0, 0, 0);
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int d = d0 + 128 * s + 4 * lane;
      add(v[s].x, d);
      add(v[s].y, d + 1);
      add(v[s].z, d + 2);
      add(v[s].w, d + 3);
    }
  } else {
    constexpr int STEPS = CHUNK / 32;
    float v[STEPS];
#pragma unroll
    for (int s = 0; s < STEPS; ++s) {
      const int d = d0 + 32 * s + lane;
      v[s] = d < D ? __ldg(x + d) : 0.f;
    }
#pragma unroll
    for (int s = 0; s < STEPS; ++s) add(v[s], d0 + 32 * s + lane);
  }
  return count;
}

template <bool VEC>
__global__ void __launch_bounds__(32)
    minhash_kernel(const float* __restrict__ X, const int32_t* __restrict__ A,
                   int32_t* __restrict__ out, int H, int D, int stride_h, int stride_d) {
  __shared__ int list[CHUNK];
  const int lane = threadIdx.x;
  const int n = blockIdx.x;
  const float* x = X + (size_t)n * D;

  for (int h0 = 0; h0 < H; h0 += 32 * HW) {
    int32_t acc[HW];
#pragma unroll
    for (int j = 0; j < HW; ++j) acc[j] = EMPTY;
    for (int d0 = 0; d0 < D; d0 += CHUNK) {
      __syncwarp();  // every lane is done with the last list
      const int count = compact<VEC>(x, D, d0, list, lane);
      __syncwarp();  // the list is written
      for (int k0 = 0; k0 < count; k0 += BATCH) {
        int32_t v[BATCH][HW];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
          const int k = k0 + u;
          const int d = k < count ? list[k] : 0;
#pragma unroll
          for (int j = 0; j < HW; ++j) {
            const int h = h0 + lane + 32 * j;
            v[u][j] = k < count && h < H
                          ? __ldg(A + (size_t)h * stride_h + (size_t)d * stride_d)
                          : EMPTY;
          }
        }
#pragma unroll
        for (int u = 0; u < BATCH; ++u) {
#pragma unroll
          for (int j = 0; j < HW; ++j) acc[j] = min(acc[j], v[u][j]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < HW; ++j) {
      const int h = h0 + lane + 32 * j;
      if (h < H) out[(size_t)n * H + h] = acc[j];
    }
  }
}

}  // namespace

extern "C" int repro_minhash(const float* X, const int32_t* A, int32_t* out, int N,
                             int H, int D, int stride_h, int stride_d, void* stream) {
  if (N == 0 || H == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D % 4 == 0 && (uintptr_t)X % 16 == 0) {
    minhash_kernel<true><<<N, 32, 0, st>>>(X, A, out, H, D, stride_h, stride_d);
  } else {
    minhash_kernel<false><<<N, 32, 0, st>>>(X, A, out, H, D, stride_h, stride_d);
  }
  return (int)cudaGetLastError();
}
