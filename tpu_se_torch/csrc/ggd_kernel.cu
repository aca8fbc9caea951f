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
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): the function must move
// 3 * M * D * 4 bytes (out and targ read once, dedx written once): 0.4 MB
// at the parity bunch M = 128, D = 257 (0.12 us at 3.35 TB/s) and 12.6 MB
// at M = 4096 (3.8 us).  The arithmetic is a few operations per element,
// far below that, except that beta != 1 costs two powf per element, which
// at M = 4096 is more than the traffic.  At M = 128 neither bound is in
// reach: an empty kernel launched in this form takes ~1.8 us, and the
// kernel's own chain of latencies (one round trip to memory, the block
// tree, the cluster barrier, the remote reads, the store) ~2 us more.
//
// The TPU kernel is one ungridded block over the whole bunch.  Here the
// column sums have to cross blocks; a thread-block cluster does that
// inside one launch:
//
// - The grid is column strips x kCluster.  One cluster of 8 blocks owns a
//   strip; its blocks split the rows.  A thread stands at one column (a
//   warp reads 128 contiguous bytes of a row, or 64 of two rows: rows are
//   D = 257 floats, so nothing wider than 4 bytes is aligned) and walks
//   its rows a batch at a time, all loads of a batch issued before the
//   first is used.
// - A block reads its rows of out and targ once, keeps e in shared memory
//   (up to kTileBytes, so that two blocks fit one SM), sums |e|^beta per
//   thread in row order, then over its row threads in a fixed tree, and
//   publishes the strip's column sums in its own shared memory.
// - After cluster.sync() the first row thread of every block reads all 8
//   blocks' sums over distributed shared memory in rank order, so every
//   block forms the same alpha bit for bit, with no atomics and no trip
//   through device memory; rank 0 writes alpha.  The block then arrives at
//   the cluster's closing barrier at once (relaxed: it only says "I have
//   read yours") and waits on it at its end, so no block's shared memory
//   goes away while a neighbour reads it, and nobody waits for stores.
// - dedx is written from the e kept on chip.  Past kTileBytes of e per
//   block (M > 12288 at 16 columns) the block reads out and targ again.
// - beta == 1 (the default) takes no powf: |e| for the sum, alpha = the
//   mean term, and +-(scale / M) for the gradient, which is what
//   powf(x, 1) = x and powf(x, 0) = 1 give; the results are bitwise those
//   of the general path (checked on the card through
//   ggd_output_grad_general).
// - The plan (make_plan) depends on (M, D) alone: 256 threads, clusters of
//   8, strips of 32 columns up to M = 1024 (9 strips, 72 blocks at
//   D = 257) and of 16 above (17 strips, 136 blocks: more SMs pull on the
//   memory).  In the sweep (bench/sweep_ggd.py; 32/16/8 columns, 256-1024
//   threads, clusters of 4-16) every plan took 3.7-5.2 us at M = 128; at
//   M = 4096 16 x 256 took 8.1 us against 9.1 for 32 x 256; blocks of 1024
//   threads, or clusters of 16, do not fit the card in one wave (one block
//   per SM, 136 or 144 blocks on 132 SMs) and lose what they gain.  Only
//   above M = 8192 do 1024-thread blocks win (45.5 against 62.3 us at
//   M = 16384); no caller has such bunches, so they are not a third plan.
//   A thread's batch is 4 rows at 32 columns and 16 at 16, from the same
//   sweep: the empty slots of a batch cost instructions where a thread
//   has 2 rows (M = 128: 3.2-3.3 us against 3.8 with batches of 8), and
//   more loads in flight pay where it has hundreds (M = 8192: 14.3
//   against 17.6).
//
// Every sum runs in a fixed order, so a rerun on the same input is bitwise
// identical (bit-exact resume depends on it).  Ragged edges in D and in M
// are masked; a block with no rows, or a strip with one live column, still
// takes part in every barrier.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// The launch plan, from (M, D) alone.  bench/sweep_ggd.py builds variants
// with the GGD_FORCE_* macros to time other plans.
constexpr int kCluster = 8;               // blocks per cluster: portable max
constexpr int kThreads = 256;
constexpr int kWideMaxM = 1024;           // 32-column strips up to here
#ifdef GGD_FORCE_TILE_KB
constexpr int kTileBytes = GGD_FORCE_TILE_KB * 1024;
#else
constexpr int kTileBytes = 96 * 1024;     // most of e a block keeps on chip
#endif

struct Plan {
  int cols;            // columns per strip: one cluster per strip
  int threads;         // threads per block
  int cluster;         // blocks per cluster, splitting the rows
  int rows_per_block;  // ceil(M / cluster)
  int keep;            // 1: e stays in shared memory; 0: read again
};

Plan make_plan(int M, int D) {
  (void)D;
  Plan p;
#ifdef GGD_FORCE_COLS
  p.cols = GGD_FORCE_COLS;
  p.threads = GGD_FORCE_THREADS;
  p.cluster = GGD_FORCE_CLUSTER;
#else
  p.cols = M <= kWideMaxM ? 32 : 16;
  p.threads = kThreads;
  p.cluster = kCluster;
#endif
  p.rows_per_block = static_cast<int>(
      (static_cast<long long>(M) + p.cluster - 1) / p.cluster);
  const long long tile =
      static_cast<long long>(p.rows_per_block) * p.cols * sizeof(float);
  p.keep = tile <= kTileBytes ? 1 : 0;
  return p;
}

#ifdef GGD_PROBE
// Built only by bench/sweep_ggd.py --probe: thread 0 of every block notes
// in g_probe[block][16] the SM's clock at each step k of the kernel (slot
// k) and, at its first and last step, the global timer in ns (slot 8 + k).
__device__ unsigned long long* g_probe;
__device__ __forceinline__ void probe(int k) {
  if (threadIdx.x == 0) {
    unsigned long long* row =
        g_probe + (blockIdx.y * gridDim.x + blockIdx.x) * 16;
    row[k] = clock64();
    if (k == 0 || k == 6) {
      unsigned long long t;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
      row[8 + k] = t;
    }
  }
}
#define GGD_PROBE_AT(k) probe(k)
#else
#define GGD_PROBE_AT(k)
#endif

// The two halves of a cluster barrier (cluster.sync() is both at once).
// The arrival is relaxed: it says "I have read your shared memory", and
// publishes nothing of its own.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

__device__ __forceinline__ float abs_pow(float e, float beta) {
  return e == 0.0f ? 0.0f : powf(fabsf(e), beta);
}

// One cluster per strip of kCols columns; cluster rank k owns rows
// [k * rows_per_block, (k + 1) * rows_per_block).  Thread (ty, tx) walks
// rows ty, ty + kRowThreads, ... of its block's rows in column tx, kBatch
// rows at a time: the loads of a batch are all issued before the first is
// used.
template <int kCols, int kBlock, bool kBetaOne, bool kKeep>
__global__ void __launch_bounds__(kBlock, kBlock > 512 ? 1 : 2)
ggd_kernel(const float* __restrict__ out, const float* __restrict__ targ,
           float* __restrict__ dedx, float* __restrict__ alpha, int M, int D,
           int rows_per_block, float beta, float beta_m1, float inv_beta) {
  constexpr int kRowThreads = kBlock / kCols;
  // Rows a thread loads at a time: few where a thread has few rows (the
  // empty slots of a batch cost instructions), many where it has many.
#ifdef GGD_FORCE_BATCH
  constexpr int kBatch = GGD_FORCE_BATCH;
#else
  constexpr int kBatch = kCols == 32 ? 4 : 16;
#endif
  extern __shared__ float e_tile[];       // [rows_per_block][kCols], if kKeep
  __shared__ float sums[kRowThreads][kCols];
  __shared__ float block_sum[kCols];      // read by the whole cluster
  __shared__ float col_scale[kCols];

  GGD_PROBE_AT(0);
  cg::cluster_group cluster = cg::this_cluster();
  const int tx = threadIdx.x % kCols;
  const int ty = threadIdx.x / kCols;
  const int col = blockIdx.x * kCols + tx;
  const bool live = col < D;
  const unsigned rank = cluster.block_rank();
  const long long row0 = static_cast<long long>(rank) * rows_per_block;
  const long long row_end =
      row0 + rows_per_block < M ? row0 + rows_per_block : M;
  const float m = static_cast<float>(M);

  // 1. e once from device memory; this thread's sum of |e|^beta, in row
  //    order (beta == 1: |e|, which is what powf(|e|, 1) gives).
  float acc = 0.0f;
  if (live) {
    for (long long r = row0 + ty; r < row_end; r += kBatch * kRowThreads) {
      float o[kBatch], t[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long rk = r + k * kRowThreads;
        o[k] = t[k] = 0.0f;
        if (rk < row_end) {
          const size_t i = static_cast<size_t>(rk) * D + col;
          o[k] = out[i];
          t[k] = targ[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long rk = r + k * kRowThreads;
        if (rk < row_end) {
          const float e = o[k] - t[k];
          if (kKeep) e_tile[(rk - row0) * kCols + tx] = e;
          acc += kBetaOne ? fabsf(e) : abs_pow(e, beta);
        }
      }
    }
  }
  GGD_PROBE_AT(1);

  // 2. The block's column sums: a fixed tree over the row threads.
  sums[ty][tx] = acc;
  __syncthreads();
#pragma unroll
  for (int half = kRowThreads / 2; half > 0; half /= 2) {
    if (ty < half) sums[ty][tx] += sums[ty + half][tx];
    __syncthreads();
  }
  if (ty == 0) block_sum[tx] = sums[0][tx];
  GGD_PROBE_AT(2);

  // 3. Every block's first row thread adds the cluster's sums in rank
  //    order, over distributed shared memory: the same alpha in every
  //    block, bit for bit.  Once they are read, the block tells the cluster
  //    so (the wait is at the kernel's end).
  cluster.sync();
  GGD_PROBE_AT(3);
  if (ty == 0) {
    float total = 0.0f;
    const unsigned n_ranks = cluster.num_blocks();
    for (unsigned k = 0; k < n_ranks; ++k)
      total += *cluster.map_shared_rank(&block_sum[tx], k);
    const float mean_term = beta * (total / m);
    const float a = kBetaOne ? mean_term : powf(mean_term, inv_beta);
    float scale = 0.0f;
    if (a != 0.0f) scale = beta / (kBetaOne ? a : powf(a, beta));
    col_scale[tx] = scale;
    if (rank == 0 && live) alpha[col] = a;
  }
  __syncthreads();
  cluster_arrive();
  const float scale = col_scale[tx];
  // beta == 1: sign(e) |e|^0 = +-1, and (+-1 * scale) / m = +-(scale / m).
  const float unit = scale / m;
  GGD_PROBE_AT(4);

  // 4. The gradient from the e kept on chip (or read again).
  if (live) {
    for (long long r = row0 + ty; r < row_end; r += kBatch * kRowThreads) {
      float e[kBatch];
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long rk = r + k * kRowThreads;
        e[k] = 0.0f;
        if (rk < row_end) {
          const size_t i = static_cast<size_t>(rk) * D + col;
          e[k] = kKeep ? e_tile[(rk - row0) * kCols + tx] : out[i] - targ[i];
        }
      }
#pragma unroll
      for (int k = 0; k < kBatch; ++k) {
        const long long rk = r + k * kRowThreads;
        if (rk < row_end) {
          float g = 0.0f;
          if (e[k] != 0.0f)
            g = kBetaOne ? copysignf(unit, e[k])
                         : copysignf(powf(fabsf(e[k]), beta_m1), e[k]) *
                               scale / m;
          dedx[static_cast<size_t>(rk) * D + col] = g;
        }
      }
    }
  }
  GGD_PROBE_AT(5);

  // 5. No block leaves while a neighbour may still read its block_sum.
  cluster_wait();
  GGD_PROBE_AT(6);
}

// Same grid, cluster and block as the plan's kernel, no work: the floor of
// a launch of this form.
__global__ void ggd_floor_kernel() {
  cg::this_cluster().sync();
}

struct Args {
  const float* out;
  const float* targ;
  float* dedx;
  float* alpha;
  int M, D;
  float beta, beta_m1, inv_beta;
  cudaStream_t stream;
};

template <typename Kernel, typename... Params>
cudaError_t launch_clustered(Kernel kernel, const Plan& p, int D,
                             size_t shared_bytes, cudaStream_t stream,
                             Params... params) {
  if (p.cluster > 8) {  // only a sweep's variant: past the portable size
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3((D + p.cols - 1) / p.cols, p.cluster, 1);
  config.blockDim = dim3(p.threads, 1, 1);
  config.dynamicSmemBytes = shared_bytes;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(&config, kernel, params...);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int kCols, int kBlock, bool kBetaOne, bool kKeep>
cudaError_t launch(const Plan& p, const Args& a) {
  auto kernel = ggd_kernel<kCols, kBlock, kBetaOne, kKeep>;
  size_t shared_bytes = 0;
  if (kKeep) {
    shared_bytes =
        static_cast<size_t>(p.rows_per_block) * kCols * sizeof(float);
    if (shared_bytes > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(shared_bytes));
      if (err != cudaSuccess) return err;
    }
  }
  return launch_clustered(kernel, p, a.D, shared_bytes, a.stream, a.out,
                          a.targ, a.dedx, a.alpha, a.M, a.D, p.rows_per_block,
                          a.beta, a.beta_m1, a.inv_beta);
}

template <int kCols, int kBlock, bool kBetaOne>
cudaError_t launch_keep(const Plan& p, const Args& a) {
  return p.keep ? launch<kCols, kBlock, kBetaOne, true>(p, a)
                : launch<kCols, kBlock, kBetaOne, false>(p, a);
}

template <bool kBetaOne>
cudaError_t launch_shape(const Plan& p, const Args& a) {
#ifdef GGD_FORCE_COLS
  return launch_keep<GGD_FORCE_COLS, GGD_FORCE_THREADS, kBetaOne>(p, a);
#else
  return p.cols == 32 ? launch_keep<32, kThreads, kBetaOne>(p, a)
                      : launch_keep<16, kThreads, kBetaOne>(p, a);
#endif
}

int run(const Args& a, bool shortcut) {
  const Plan p = make_plan(a.M, a.D);
  const cudaError_t err = shortcut && a.beta == 1.0f
                              ? launch_shape<true>(p, a)
                              : launch_shape<false>(p, a);
  return static_cast<int>(err);
}

}  // namespace

#ifdef GGD_PROBE
extern "C" int ggd_set_probe(unsigned long long* buffer) {
  return static_cast<int>(cudaMemcpyToSymbol(g_probe, &buffer, sizeof(buffer)));
}
#endif

// The launcher's plan for an [M, D] bunch -> plan[0..4] = columns per
// strip, threads per block, blocks per cluster, rows per block, and whether
// e stays in shared memory (1) or is read again (0).
extern "C" void ggd_plan(int M, int D, int* plan) {
  const Plan p = make_plan(M, D);
  plan[0] = p.cols;
  plan[1] = p.threads;
  plan[2] = p.cluster;
  plan[3] = p.rows_per_block;
  plan[4] = p.keep;
}

// out, targ, dedx [M, D]; alpha [D]; all f32, contiguous, on the device of
// `stream`; M >= 1, D >= 1.  beta_m1 and inv_beta are beta - 1 and 1 / beta
// rounded to fp32 on the host.  One launch; returns its CUDA error code: 0
// on success.
extern "C" int ggd_output_grad(const float* out, const float* targ,
                               float* dedx, float* alpha, int M, int D,
                               float beta, float beta_m1, float inv_beta,
                               void* stream) {
  return run({out, targ, dedx, alpha, M, D, beta, beta_m1, inv_beta,
              static_cast<cudaStream_t>(stream)}, true);
}

// The same through powf at every beta, beta == 1 too: what the beta == 1
// shortcut is held to, bit for bit, on the card.
extern "C" int ggd_output_grad_general(const float* out, const float* targ,
                                       float* dedx, float* alpha, int M, int D,
                                       float beta, float beta_m1,
                                       float inv_beta, void* stream) {
  return run({out, targ, dedx, alpha, M, D, beta, beta_m1, inv_beta,
              static_cast<cudaStream_t>(stream)}, false);
}

// An empty kernel launched as ggd_output_grad launches its kernel for an
// [M, D] bunch (grid, cluster, block): the least such a launch can take.
extern "C" int ggd_launch_floor(int M, int D, void* stream) {
  const Plan p = make_plan(M, D);
  return static_cast<int>(launch_clustered(
      ggd_floor_kernel, p, D, 0, static_cast<cudaStream_t>(stream)));
}
