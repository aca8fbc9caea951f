// Fused ML-GGD output-layer gradient for Hopper (sm_90a).
//
// Replaces the TPU kernel tpu_se/ops/ggd_kernel.py:ggd_output_grad_pallas
// (body _ggd_kernel), itself the fusion of the reference's 8-kernel chain
// (BP_GPU.cu:408-423).  For one bunch (out, targ) [M, D] and a shape
// factor beta:
//
//   e       = out - targ
//   alpha_d = (beta * (sum_m |e_md|^beta / M))^(1/beta)
//   scale_d = alpha_d == 0 ? 0 : beta / alpha_d^beta
//   dedx    = (e == 0 ? 0 : sign(e) |e|^(beta-1)) * scale_d / M
//
// All fp32.  The e == 0 guard comes before powf: for beta < 1 the exponent
// beta-1 is negative and powf(0, beta-1) would be inf.  beta-1 and 1/beta
// arrive from the host already rounded to fp32 (as JAX's weak-typed
// scalars round), never recomputed here.  No fast-math: powf is the IEEE
// one.
//
// What bounds it on this card: it reads out and targ twice (2 * M * D * 4
// bytes each pass) and writes dedx once (M * D * 4 bytes), ~0.4 MB in all
// at the parity bunch M = 128 and ~12.6 MB at M = 4096, D = 257: memory
// bound, and at M = 128 (a few microseconds of traffic) bound by the two
// launches.  The TPU kernel is one ungridded block over the whole bunch;
// here blocks run in parallel with nothing carried between them, so the
// column reduction needs a second pass.  The design:
//
//   1. ggd_partial_kernel: grid = column strips of 32 (one column per
//      lane, so a warp reads 128 contiguous bytes of a row) x row tiles of
//      kTileM rows.  Each thread sums |e|^beta over its rows of the tile in
//      row order; the 8 per-thread sums of a column then meet in a fixed
//      shared-memory tree, and the tile's sum goes to partial[tile, col].
//   2. ggd_grad_kernel: same grid.  Each block reduces partial[:, its
//      columns] over all tiles the same way (strided per-thread sums, then
//      the tree), forms alpha and scale, and writes dedx for its row tile;
//      blocks of row tile 0 also write alpha.
//
// No atomics anywhere and every sum runs in a fixed order, so a rerun on
// the same input is bitwise identical (bit-exact resume depends on it), and
// every block of a column computes the same alpha bit for bit.  Ragged
// edges in D (257 = 8 * 32 + 1) and in M are masked.

#include <cuda_runtime.h>

namespace {

constexpr int kCols = 32;                 // columns per block: one per lane
constexpr int kRowThreads = 8;            // warps per block
constexpr int kThreads = kCols * kRowThreads;
constexpr int kTileM = 128;               // rows per block

__device__ __forceinline__ float abs_pow(float e, float beta) {
  return e == 0.0f ? 0.0f : powf(fabsf(e), beta);
}

__global__ void __launch_bounds__(kThreads)
ggd_partial_kernel(const float* __restrict__ out,
                   const float* __restrict__ targ,
                   float* __restrict__ partial, int M, int D, float beta) {
  __shared__ float sums[kRowThreads][kCols];
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const int row0 = blockIdx.y * kTileM;
  const int row_end = min(row0 + kTileM, M);

  float acc = 0.0f;
  if (col < D) {
    for (int r = row0 + ty; r < row_end; r += kRowThreads) {
      const size_t i = (size_t)r * D + col;
      acc += abs_pow(out[i] - targ[i], beta);
    }
  }
  sums[ty][lane] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kRowThreads / 2; half > 0; half /= 2) {
    if (ty < half) sums[ty][lane] += sums[ty + half][lane];
    __syncthreads();
  }
  if (ty == 0 && col < D) partial[(size_t)blockIdx.y * D + col] = sums[0][lane];
}

__global__ void __launch_bounds__(kThreads)
ggd_grad_kernel(const float* __restrict__ out, const float* __restrict__ targ,
                const float* __restrict__ partial, float* __restrict__ dedx,
                float* __restrict__ alpha, int M, int D, int n_tiles,
                float beta, float beta_m1, float inv_beta) {
  __shared__ float sums[kRowThreads][kCols];
  const int lane = threadIdx.x;
  const int ty = threadIdx.y;
  const int col = blockIdx.x * kCols + lane;
  const float m = static_cast<float>(M);

  // The column's total over all row tiles, in the same fixed order in
  // every block: strided per-thread sums, then the shared-memory tree.
  float acc = 0.0f;
  if (col < D) {
    for (int t = ty; t < n_tiles; t += kRowThreads)
      acc += partial[(size_t)t * D + col];
  }
  sums[ty][lane] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kRowThreads / 2; half > 0; half /= 2) {
    if (ty < half) sums[ty][lane] += sums[ty + half][lane];
    __syncthreads();
  }
  if (col >= D) return;

  const float a = powf(beta * (sums[0][lane] / m), inv_beta);
  const float scale = a == 0.0f ? 0.0f : beta / powf(a, beta);
  if (blockIdx.y == 0 && ty == 0) alpha[col] = a;
  const int row0 = blockIdx.y * kTileM;
  const int row_end = min(row0 + kTileM, M);
  for (int r = row0 + ty; r < row_end; r += kRowThreads) {
    const size_t i = (size_t)r * D + col;
    const float e = out[i] - targ[i];
    const float sgn_pow =
        e == 0.0f ? 0.0f : copysignf(powf(fabsf(e), beta_m1), e);
    dedx[i] = sgn_pow * scale / m;
  }
}

}  // namespace

// out, targ, dedx [M, D]; alpha [D]; partial [ceil(M / 128), D]; all f32,
// contiguous, on the device of `stream`; M >= 1, D >= 1.  beta_m1 and
// inv_beta are beta - 1 and 1 / beta rounded to fp32 on the host.  Returns
// cudaGetLastError() after the two launches: 0 on success.
extern "C" int ggd_output_grad(const float* out, const float* targ,
                               float* dedx, float* alpha, float* partial,
                               int M, int D, float beta, float beta_m1,
                               float inv_beta, void* stream) {
  const int n_tiles = (M + kTileM - 1) / kTileM;
  const dim3 grid((D + kCols - 1) / kCols, n_tiles);
  const dim3 block(kCols, kRowThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  ggd_partial_kernel<<<grid, block, 0, s>>>(out, targ, partial, M, D, beta);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ggd_grad_kernel<<<grid, block, 0, s>>>(out, targ, partial, dedx, alpha, M,
                                         D, n_tiles, beta, beta_m1, inv_beta);
  return static_cast<int>(cudaGetLastError());
}
