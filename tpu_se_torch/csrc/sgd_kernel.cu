// Fused momentum-SGD update for Hopper (sm_90a).
//
// Replaces no Pallas kernel.  In the reference the update
// (tpu_se/train/optim.py:23-37, the reference's kernUpdatedelta,
// DevFunc.cu:490-507) is one XLA fusion inside the jitted lax.scan of
// tpu_se/train/step.py; the port's plain form
// (ops/sgd_kernel.py:sgd_update_plain) is 7 eager kernels per weight
// tensor and 5 per bias.  For every element of every tensor of the list,
// in the plain form's order and with its roundings:
//
//   s = g * inv_n          PyTorch's CUDA g / n by a host scalar multiplies
//                          by the float32 reciprocal, rounded on the host
//   s = s + wc * p         only where the plain form has a decay (weights);
//                          biases skip it: no 0 * p (-0 + 0 is +0, 0 * inf
//                          is NaN)
//   v = m * v - lr * s
//   p = p + v
//
// lr, m and wc are the float32 roundings of the caller's values, as
// PyTorch rounds a scalar operand of a float32 tensor.  Every operation is
// a round-to-nearest intrinsic (__fmul_rn, __fadd_rn, __fsub_rn), which
// nvcc never contracts into an FMA: under the build's default --fmad=true
// m * v - lr * s would otherwise become one FMA and change bits.  So the
// kernel equals the eager operations on the card bit for bit.
//
// What bounds it (NVIDIA H100 80GB HBM3, 700 W): bytes.  p, v and g are
// read once and p and v written once, 20 bytes per element: 252 MB for the
// full-width model's 12,605,697 parameters, 75.3 us at 3.35 TB/s.  Five
// float operations per element are far below that.
//
// Design:
// - One launch for the whole list.  The tensors travel as a table of up to
//   kMaxTensors entries passed by value as the kernel's argument
//   (multi_tensor_apply's pattern), so a captured CUDA graph holds the
//   table with the launch; a longer list takes one launch per full table.
// - The grid fills the card once (occupancy x SMs), or fewer blocks when
//   the largest tensor needs fewer.  Every block walks every tensor of the
//   table in a grid-stride loop: 16-byte accesses where p, v and g of a
//   tensor are all 16-byte aligned (views into one flat all-reduce buffer
//   need not be), 4-byte accesses otherwise and for a tensor's last
//   n % 4 elements.
// - The rate is read on the device when a pointer is given (a captured
//   graph's 0-dim buffer), so one graph replays every epoch's rate.

#include <cuda_runtime.h>

#include <cstdint>

// One tensor of the list; mirrored by ops/sgd_kernel.py:_Entry.  Outside
// the unnamed namespace: the C entry points take it, and a function whose
// signature names an internal type is not exported.
struct SgdEntry {
  float* p;          // parameter, updated in place
  float* v;          // velocity, updated in place
  const float* g;    // bunch-summed gradient
  int n;             // elements of each of the three
  int has_wc;        // 1: add wc * p to the step (the plain `if wc:`)
  float wc;          // the weight cost, rounded to float32
};

namespace {

constexpr int kMaxTensors = 32;   // as ops/sgd_kernel.py:MAX_TENSORS
constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

struct SgdTable {
  SgdEntry e[kMaxTensors];
  int count;
};

__device__ __forceinline__ void update(float& p, float& v, float g,
                                       float inv_n, bool has_wc, float wc,
                                       float lr, float m) {
  float s = __fmul_rn(g, inv_n);
  if (has_wc) s = __fadd_rn(s, __fmul_rn(wc, p));
  v = __fsub_rn(__fmul_rn(m, v), __fmul_rn(lr, s));
  p = __fadd_rn(p, v);
}

__global__ void __launch_bounds__(kThreads)
sgd_momentum_update_kernel(const SgdTable table, const float* lr_ptr,
                           float lr, float m, float inv_n) {
  if (lr_ptr != nullptr) lr = *lr_ptr;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const long long first =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  for (int t = 0; t < table.count; ++t) {
    const SgdEntry e = table.e[t];
    const bool has_wc = e.has_wc != 0;
    long long done = 0;
    const uintptr_t bits = reinterpret_cast<uintptr_t>(e.p) |
                           reinterpret_cast<uintptr_t>(e.v) |
                           reinterpret_cast<uintptr_t>(e.g);
    if ((bits & 15) == 0) {
      float4* p4 = reinterpret_cast<float4*>(e.p);
      float4* v4 = reinterpret_cast<float4*>(e.v);
      const float4* g4 = reinterpret_cast<const float4*>(e.g);
      const long long n4 = e.n / 4;
      for (long long i = first; i < n4; i += stride) {
        float4 p = p4[i];
        float4 v = v4[i];
        const float4 g = g4[i];
        update(p.x, v.x, g.x, inv_n, has_wc, e.wc, lr, m);
        update(p.y, v.y, g.y, inv_n, has_wc, e.wc, lr, m);
        update(p.z, v.z, g.z, inv_n, has_wc, e.wc, lr, m);
        update(p.w, v.w, g.w, inv_n, has_wc, e.wc, lr, m);
        p4[i] = p;
        v4[i] = v;
      }
      done = n4 * 4;
    }
    for (long long i = done + first; i < e.n; i += stride) {
      float p = e.p[i];
      float v = e.v[i];
      update(p, v, e.g[i], inv_n, has_wc, e.wc, lr, m);
      e.p[i] = p;
      e.v[i] = v;
    }
  }
}

// Launched as the update is, doing nothing: the least a launch costs.
__global__ void __launch_bounds__(kThreads)
sgd_floor_kernel(const SgdTable table, const float* lr_ptr, float lr,
                 float m, float inv_n) {}

// Blocks that fill the current device once, cached per device.
cudaError_t full_grid(int* blocks) {
  static int cached[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && cached[dev] > 0) {
    *blocks = cached[dev];
    return cudaSuccess;
  }
  int sms = 0, per_sm = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, sgd_momentum_update_kernel, kThreads, 0);
  if (err != cudaSuccess) return err;
  *blocks = sms * (per_sm > 0 ? per_sm : 1);
  if (dev < kMaxDevices) cached[dev] = *blocks;
  return cudaSuccess;
}

// The grid for a table whose largest tensor has max_n elements.
cudaError_t grid_for(long long max_n, int* blocks) {
  int full = 0;
  const cudaError_t err = full_grid(&full);
  if (err != cudaSuccess) return err;
  const long long need = (max_n / 4 + kThreads - 1) / kThreads;
  *blocks = static_cast<int>(need < 1 ? 1 : need < full ? need : full);
  return cudaSuccess;
}

}  // namespace

// entries[count]: float32, contiguous, on the device of `stream`, each
// n < 2^31.  lr_ptr: a float32 on the device, read by the kernel, or null
// to take lr.  lr, momentum and the weight costs are rounded to float32;
// inv_n is 1 / n rounded to float32 on the host.  One launch per
// kMaxTensors entries; returns the first CUDA error code, 0 on success.
extern "C" int sgd_momentum_update(const SgdEntry* entries, int count,
                                   const float* lr_ptr, float lr,
                                   float momentum, float inv_n,
                                   void* stream) {
  for (int start = 0; start < count; start += kMaxTensors) {
    SgdTable table;
    table.count = count - start < kMaxTensors ? count - start : kMaxTensors;
    long long max_n = 0;
    for (int i = 0; i < table.count; ++i) {
      table.e[i] = entries[start + i];
      if (table.e[i].n > max_n) max_n = table.e[i].n;
    }
    int blocks = 0;
    cudaError_t err = grid_for(max_n, &blocks);
    if (err != cudaSuccess) return static_cast<int>(err);
    sgd_momentum_update_kernel<<<blocks, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
        table, lr_ptr, lr, momentum, inv_n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  return 0;
}

// An empty kernel launched as sgd_momentum_update launches one table whose
// largest tensor has max_n elements (grid, block, argument size): the
// least such a launch can take.
extern "C" int sgd_launch_floor(long long max_n, void* stream) {
  SgdTable table = {};
  int blocks = 0;
  cudaError_t err = grid_for(max_n, &blocks);
  if (err != cudaSuccess) return static_cast<int>(err);
  sgd_floor_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      table, nullptr, 0.0f, 0.0f, 0.0f);
  return static_cast<int>(cudaGetLastError());
}

// The grid the update takes for a table whose largest tensor has max_n
// elements (-1 on a CUDA error).
extern "C" int sgd_grid_blocks(long long max_n) {
  int blocks = 0;
  return grid_for(max_n, &blocks) == cudaSuccess ? blocks : -1;
}
