// MinHash signatures: out[n, h] = min { A[h, d] : X[n, d] > 0 } over d,
// EMPTY = 2^30 where row n has no present shingle.  X (N, D) float32
// presence, A (H, D) int32 hash table, out (N, H) int32.
//
// Replaces the Pallas TPU kernel src/repro/kernels/minhash/kernel.py
// (minhash).  The Pallas version fed X and A transposed, (D, N) and
// (D, H), so that N and H sat on the TPU's 128 lanes; that layout has no
// purpose here and is not carried over.
//
// Bound on the H100: the streaming ingest calls it with N = 59-68 rows
// against H = 128 hash functions over D = 512 shingle slots.  It reads
// 4 (N D + H D) bytes and writes 4 N H: 426 KB at N = 64, 0.13 us at
// 3.35 TB/s.  Done densely, the masked min is N H D = 4.2 M int32 min
// operations (a compare and a select each, no tensor cores apply to a
// min-plus product), about 0.25 us at 132 SMs x 64 INT32 lanes x
// 1.98 GHz, so this dense kernel is bound by operations.  The work the
// data needs is smaller: a row holds about 9 of its 512 shingles, so
// the min runs over N H 9 values and bytes bound it.
//
// Design: one block of 32 x 8 threads per 32 x 32 output tile.  X's 32
// rows and A's 32 rows are staged in shared memory one 32-wide slice of
// d at a time (coalesced loads, a padded A tile so that the 32 lanes of
// a warp read 32 banks); X is kept as a 0/1 flag.  A warp shares one
// row n, so its branch on the flag never diverges, and each thread keeps
// the running min of its 4 outputs (n, h) in registers over all of d.
// The result is exact: an integer min in any order is the same min.
//
// Later design, not this one: compact each row's present indices once
// (about 9 of 512), then take the min over those columns of A only,
// about 50x less work at the path's density.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int32_t EMPTY = 1 << 30;
constexpr int TILE = 32;   // outputs a block covers along n and along h
constexpr int ROWS = 8;    // threads along n; each keeps TILE / ROWS rows
constexpr int BD = 32;     // slice of d staged per step

__global__ void __launch_bounds__(TILE * ROWS)
    minhash_kernel(const float* __restrict__ X, const int32_t* __restrict__ A,
                   int32_t* __restrict__ out, int N, int H, int D) {
  __shared__ uint8_t xs[TILE][BD];
  __shared__ int32_t as[TILE][BD + 1];

  const int tx = threadIdx.x;  // h within the tile, and d when loading
  const int ty = threadIdx.y;  // n within the tile (strided by ROWS)
  const int n0 = blockIdx.y * TILE;
  const int h0 = blockIdx.x * TILE;

  int32_t acc[TILE / ROWS];
#pragma unroll
  for (int i = 0; i < TILE / ROWS; ++i) acc[i] = EMPTY;

  for (int d0 = 0; d0 < D; d0 += BD) {
    const int d = d0 + tx;
#pragma unroll
    for (int i = 0; i < TILE / ROWS; ++i) {
      const int r = ty + i * ROWS;
      const int n = n0 + r;
      const int h = h0 + r;
      xs[r][tx] = (n < N && d < D) ? (X[(size_t)n * D + d] > 0.f) : 0;
      as[r][tx] = (h < H && d < D) ? A[(size_t)h * D + d] : EMPTY;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < TILE / ROWS; ++i) {
      const int r = ty + i * ROWS;
#pragma unroll 8
      for (int k = 0; k < BD; ++k) {
        if (xs[r][k]) acc[i] = min(acc[i], as[tx][k]);
      }
    }
    __syncthreads();
  }

  const int h = h0 + tx;
#pragma unroll
  for (int i = 0; i < TILE / ROWS; ++i) {
    const int n = n0 + ty + i * ROWS;
    if (n < N && h < H) out[(size_t)n * H + h] = acc[i];
  }
}

}  // namespace

extern "C" int repro_minhash(const float* X, const int32_t* A, int32_t* out,
                             int N, int H, int D, void* stream) {
  if (N == 0 || H == 0) return 0;
  const dim3 grid((H + TILE - 1) / TILE, (N + TILE - 1) / TILE, 1);
  const dim3 block(TILE, ROWS, 1);
  minhash_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      X, A, out, N, H, D);
  return (int)cudaGetLastError();
}
