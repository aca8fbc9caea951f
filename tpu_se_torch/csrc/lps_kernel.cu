// Fused LPS front end for Hopper (sm_90a): frames -> log-power spectrum, on
// the fp64 tensor cores.
//
// Replaces the TPU kernel tpu_se/ops/lps_kernel.py:lps_pallas (body
// _lps_kernel): one product of the frames with the windowed-DFT basis
// (Hamming window folded in), then re^2 + im^2 and the floored natural log
// (power < e^-50 -> -50), all in one pass.  Only the [T, K] result is
// written; the [T, 2K] spectrum never reaches device memory.
//
//   frames [T, L] f32 row-major, basis [L, 2K] f32 row-major (columns
//   0..K-1 are Re, K..2K-1 are Im), out [T, K] f32; L a multiple of
//   kStageL = 32 (512 and 256 in use), K = L/2 + 1 (257, 129) or any K.
//
// Precision: the log amplifies the relative error of a bin whose power is
// far below its frame's (for random frames, 1 bin in 10^6 sits 60 dB
// down).  Any fp32 summation order -- sequential, blocked, a BLAS product,
// or TF32/bf16 tensor cores, which round the operands too -- misses the
// exact log power by ~1e-3 at T = 4096, the whole tolerance the port is
// held to.  So the sums run in fp64 (inputs are exact in fp64) and only re
// and im are rounded to fp32, after which the epilogue is the reference's
// fp32 math.  The fp64 tensor cores (DMMA, mma.sync .f64) are the only
// tensor-core route that keeps that rule; wgmma has no fp64 form.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): each frame costs
// 2 * L * 2K ~ 0.53 MFLOP (L = 512) against ~3 KB of device memory, ~170
// FLOP per byte, so the kernel is bound by the fp64 mma rate, not by
// memory.  An mma-only loop reaches 66.1 TFLOP/s with m16n8k8 (m16n8k4
// and m16n8k16 the same, m8n8k4 33.0); the kernel reaches 37.0 TFLOP/s at
// T = 4096 and 43.5 at T = 16384, device time (an earlier fp64-FMA
// version on the CUDA cores: 12.8, against their ~34 TFLOP/s peak).  The
// fp32 -> fp64 conversions are not what holds it below the mma peak:
// replacing either operand's conversion with a bit move gains <= 3 %.
// At a decode batch's T (248-992) the time is one block's pass over L
// plus the launch.
//
// Design:
// - mma.sync.m16n8k8.row.col.f64 (the fastest or tied at every T in a
//   sweep of the four fp64 shapes and ~20 tiles): A = frames (16 frames x
//   8 samples), B = basis (8 samples x 8 columns).  Thread (g = lane/4,
//   q = lane%4) holds A rows g, g+8 at k slots q, q+4, B column g at k
//   slots q, q+4, and C rows g, g+8 at columns 2q, 2q+1.  The kernel maps
//   k slot q to sample 2q and slot q+4 to sample 2q+1, for A and B alike
//   -- a permutation of the sum's terms within each k block -- so each
//   thread's two A values of a row are adjacent: one 8-byte shared load.
// - Operands stay fp32 in shared memory (half the bytes of fp64) and are
//   widened in registers (cvt.f64.f32, exact) as each fragment is loaded.
//   Row pads keep the fragment loads free of bank conflicts.
// - A ring of shared-memory stages of 32 samples filled by cp.async:
//   16-byte copies of the frames (rows are 16-byte aligned); 4-byte copies
//   of the basis (its rows are 2K = 514 floats and the Im half starts at
//   an odd column, so no wider copy is aligned).  The next stage's copies
//   are in flight while the current stage's mmas run.  Ragged T and K are
//   zero filled by the copies (src-size 0) and masked at the store.  TMA
//   was not taken: a tensor map needs 16-byte strides, which the basis
//   rows do not have, and cp.async already hides the L2 latency.
// - Each warp holds fp64 accumulators for the Re columns k0..k0+7 and the
//   Im columns K+k0..K+k0+7 of the same bins, so the mma's C layout puts
//   Re and Im of one (frame, bin) in one thread: rounding to fp32,
//   r*r + m*m (unfused, as the reference), the exact compare with the
//   e^-50 floor and logf all happen in registers.
// - A 1-D grid of (frame tile, bin tile) blocks, bin tile fastest, so the
//   blocks that share a frame tile run together and re-read it from L2.
//   No split of L across blocks: reruns are bitwise equal.  A block is 4
//   warps of 16 frames; two tiles, picked by T in lps_forward:
//     T <= 2560: 8 bins per block, 3 stages, 38,400 B shared memory,
//       96 registers, 0 spills; T = 248 gives 132 blocks, T = 992 528.
//     T >  2560: 16 bins per block (half the frame re-reads), 2 stages,
//       29,696 B, 3 blocks per SM asked: 128 registers, 0 spills.
//   The two cross at T ~ 2560 (39.9 and 40.6 us there).

#include <cuda_runtime.h>

namespace {

// d += a * b, mma.sync.m16n8k8 in fp64 (A row-major, B column-major).
__device__ __forceinline__ void dmma_16x8x8(double (&d)[4],
                                            const double (&a)[4],
                                            const double (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(b[0]), "d"(b[1]));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Copies 16 bytes, or zero-fills them when src_bytes == 0.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kRows = 16 * kWarps;   // frames per block, 16 per warp
constexpr int kStageL = 32;          // samples per stage, 4 mma k blocks
// A row stride: the 8-byte loads of a half warp (4 rows x 8 floats) hit
// 32 distinct banks when the stride is 8 or 24 mod 32; rows stay 16-byte
// aligned for the copies.
constexpr int kAStride = kStageL + 8;

// kBinTiles 8-bin tiles per block (each a Re and an Im mma n-tile, all in
// every warp), kStages stages, kMinBlocks resident blocks per SM asked of
// the register allocator.
template <int kBinTiles_, int kStages_, int kMinBlocks_>
struct LpsTile {
  static constexpr int kBinTiles = kBinTiles_, kStages = kStages_,
                       kMinBlocks = kMinBlocks_;
  static constexpr int kBins = 8 * kBinTiles;
  static constexpr int kCols = 2 * kBins;   // Re block, then Im block
  // B row stride: a warp's B loads read 4 rows 2 apart, 8 columns each,
  // which hit 32 distinct banks when 2 * stride is 8 or 24 mod 32.
  static constexpr int kBStride = kCols + (4 - kCols % 16 + 16) % 16;
  static constexpr int kStageFloats = kRows * kAStride + kStageL * kBStride;
  static constexpr int kSmemBytes = kStages * kStageFloats * 4;
  static_assert((2 * kBStride) % 32 == 8 || (2 * kBStride) % 32 == 24,
                "B fragment loads conflict-free");
  static_assert(kSmemBytes <= 48 * 1024, "needs no opt-in shared memory");
};

template <class C>
__device__ __forceinline__ void load_stage(float* stage, const float* frames,
                                           const float* basis, int T, int L,
                                           int K, int t0, int k0, int l0) {
  float* xs = stage;                          // [kRows][kAStride]
  float* bs = stage + kRows * kAStride;       // [kStageL][kBStride]
  constexpr int kChunks = kRows * (kStageL / 4);
  static_assert(kChunks % kThreads == 0, "whole rounds of frame copies");
#pragma unroll
  for (int j = 0; j < kChunks / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / (kStageL / 4), c = i % (kStageL / 4);
    const int t = t0 + r;
    const float* src =
        frames + static_cast<size_t>(t < T ? t : T - 1) * L + l0 + 4 * c;
    cp_async16(xs + r * kAStride + 4 * c, src, t < T ? 16 : 0);
  }
  constexpr int kElems = kStageL * C::kCols;
  static_assert(kElems % kThreads == 0, "whole rounds of basis copies");
#pragma unroll
  for (int j = 0; j < kElems / kThreads; ++j) {
    const int i = threadIdx.x + j * kThreads;
    const int r = i / C::kCols, c = i % C::kCols;
    const int bin = k0 + (c < C::kBins ? c : c - C::kBins);
    const bool ok = bin < K;
    const int col = c < C::kBins ? bin : K + bin;
    const float* src =
        basis + static_cast<size_t>(l0 + r) * 2 * K + (ok ? col : 0);
    cp_async4(bs + r * C::kBStride + c, src, ok ? 4 : 0);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads, C::kMinBlocks)
lps_kernel(const float* __restrict__ frames, const float* __restrict__ basis,
           float* __restrict__ out, int T, int L, int K, int bin_tiles,
           float log_floor, float power_floor) {
  extern __shared__ __align__(16) float smem[];

  const int k0 = (blockIdx.x % bin_tiles) * C::kBins;
  const int t0 = (blockIdx.x / bin_tiles) * kRows;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int g = lane / 4, q = lane % 4;
  const int n_stages = L / kStageL;

  // acc[ni]: n-tiles 0..kBinTiles-1 are Re, the rest Im, of the same bins.
  double acc[2 * C::kBinTiles][4] = {};

#pragma unroll
  for (int s = 0; s < C::kStages - 1; ++s) {
    if (s < n_stages)
      load_stage<C>(smem + s * C::kStageFloats, frames, basis, T, L, K, t0,
                    k0, s * kStageL);
    cp_async_commit();
  }

  for (int s = 0; s < n_stages; ++s) {
    cp_async_wait<C::kStages - 2>();
    __syncthreads();   // stage s landed; stage s-1 is free to refill
    const int next = s + C::kStages - 1;
    if (next < n_stages)
      load_stage<C>(smem + (next % C::kStages) * C::kStageFloats, frames,
                    basis, T, L, K, t0, k0, next * kStageL);
    cp_async_commit();

    const float* xs = smem + (s % C::kStages) * C::kStageFloats +
                      (16 * warp + g) * kAStride + 2 * q;
    const float* bs = smem + (s % C::kStages) * C::kStageFloats +
                      kRows * kAStride + 2 * q * C::kBStride + g;
#pragma unroll
    for (int kk = 0; kk < kStageL; kk += 8) {
      // Rows g and g+8 at samples kk+2q (slot q) and kk+2q+1 (slot q+4).
      const float2 lo = *reinterpret_cast<const float2*>(xs + kk);
      const float2 hi =
          *reinterpret_cast<const float2*>(xs + 8 * kAStride + kk);
      const double a[4] = {lo.x, hi.x, lo.y, hi.y};
#pragma unroll
      for (int ni = 0; ni < 2 * C::kBinTiles; ++ni) {
        const int col = ni < C::kBinTiles
                            ? ni * 8
                            : C::kBins + (ni - C::kBinTiles) * 8;
        const double b[2] = {bs[kk * C::kBStride + col],
                             bs[(kk + 1) * C::kBStride + col]};
        dmma_16x8x8(acc[ni], a, b);
      }
    }
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int t = t0 + 16 * warp + g + 8 * h;
    if (t >= T) continue;
#pragma unroll
    for (int ni = 0; ni < C::kBinTiles; ++ni) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int bin = k0 + ni * 8 + 2 * q + j;
        if (bin >= K) continue;
        const float r = static_cast<float>(acc[ni][2 * h + j]);
        const float m = static_cast<float>(acc[C::kBinTiles + ni][2 * h + j]);
        const float power = __fadd_rn(__fmul_rn(r, r), __fmul_rn(m, m));
        out[static_cast<size_t>(t) * K + bin] =
            power < power_floor ? log_floor : logf(power);
      }
    }
  }
}

// Blocks of lps_kernel<C> for T frames and K bins.
template <class C>
long long grid_blocks(int T, int K) {
  return (static_cast<long long>(T) + kRows - 1) / kRows *
         ((K + C::kBins - 1) / C::kBins);
}

// Launches lps_kernel<C> on `stream`; returns the CUDA error code (0 on
// success).
template <class C>
int launch(const float* frames, const float* basis, float* out, int T, int L,
           int K, float log_floor, float power_floor, cudaStream_t stream) {
  const long long blocks = grid_blocks<C>(T, K);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  lps_kernel<C><<<static_cast<unsigned>(blocks), kThreads, C::kSmemBytes,
                  stream>>>(frames, basis, out, T, L, K,
                            (K + C::kBins - 1) / C::kBins, log_floor,
                            power_floor);
  return static_cast<int>(cudaGetLastError());
}

// The two tiles lps_forward picks from by T: 8 bins per block up to
// kSmallTileMaxT frames (528 blocks at T = 992), 16 bins above it (half
// the frame re-reads from L2, 2 stages, 3 blocks per SM).
using SmallTile = LpsTile<1, 3, 1>;
using LargeTile = LpsTile<2, 2, 3>;
constexpr int kSmallTileMaxT = 2560;

}  // namespace

// Blocks lps_forward launches for T frames and K bins (the tile rule that
// tpu_se_torch/ops/lps_kernel.py:grid_blocks mirrors).
extern "C" long long lps_grid_blocks(int T, int K) {
  return T <= kSmallTileMaxT ? grid_blocks<SmallTile>(T, K)
                             : grid_blocks<LargeTile>(T, K);
}

// frames [T, L], basis [L, 2K], out [T, K], all f32, contiguous, frames
// 16-byte aligned, on the device of `stream`; T >= 1 (the caller skips
// empty inputs), L a multiple of 32.  Returns cudaGetLastError() after
// the launch: 0 on success.
extern "C" int lps_forward(const float* frames, const float* basis, float* out,
                           int T, int L, int K, float log_floor,
                           float power_floor, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (T <= kSmallTileMaxT)
    return launch<SmallTile>(frames, basis, out, T, L, K, log_floor,
                             power_floor, s);
  return launch<LargeTile>(frames, basis, out, T, L, K, log_floor,
                           power_floor, s);
}
