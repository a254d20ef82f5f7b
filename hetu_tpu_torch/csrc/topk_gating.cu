// Fused top-k expert gate for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_topk_kernel` of
// hetu_tpu/ops/pallas_kernels/embedding.py (driven by `_topk_gating_impl`,
// op `topk_gating`).  Same function: for each token's logits [E], k passes
// of "take the maximum, then the lowest index that attains it, then mask
// that index with -inf" give the k values (f32) and their indices (int32),
// ties resolved to the lowest index as `lax.top_k` does; then the softmax
// over the k values in f32 (exp(v - max) / sum), written in the logits'
// type.  The gate's gradient is plain PyTorch in the wrapper's
// autograd.Function, as the reference's is plain XLA.
//
// What bounds it on an H100.  The MoE step's gate reads logits [16384, 8]
// f32 (524 KB) and writes [16384, 2] gates and indices (262 KB): under a
// microsecond of HBM time, so the launch itself and the k dependent warp
// reductions are what it costs.
//
// What the design does about it.  One warp per token, 8 tokens to a
// 256-thread block; each lane holds the logits of experts lane, lane + 32,
// ... in registers (E <= 256), so the logits are read once and the k
// passes are register compares plus five shuffles each: a lane's best
// (value, index), then a butterfly reduction that keeps the larger value
// and, among equal values, the lower index.  The owner lane masks the
// winner.  The k values wait in shared memory for the softmax, which every
// lane sums in the same order and whose outputs the lanes write in
// parallel.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libtopk_gating.so topk_gating.cu
// The extern "C" launcher below is bound with ctypes by
// hetu_tpu_torch/ops/cuda_kernels/embedding.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS_PER_BLOCK = 8;               // one warp per token
constexpr int THREADS = WARP * ROWS_PER_BLOCK;  // 256
constexpr int PER_LANE = 8;                     // experts a lane holds
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
topk_gating_kernel(const T* __restrict__ logits, T* __restrict__ gates,
                   int* __restrict__ idx, int t, int e, int k) {
  extern __shared__ float s_vals[];  // [ROWS_PER_BLOCK][k]
  const int warp = threadIdx.x / WARP, lane = threadIdx.x % WARP;
  const int row = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= t) return;
  float* vals = s_vals + warp * k;

  float x[PER_LANE];
  const T* src = logits + static_cast<size_t>(row) * e;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int col = j * WARP + lane;
    x[j] = col < e ? to_float(src[col]) : -INFINITY;
  }

  for (int p = 0; p < k; ++p) {
    // this lane's best (value, lowest index); columns ascend, so ">" keeps
    // the first of equal values
    float best = -INFINITY;
    int best_i = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int col = j * WARP + lane;
      if (col < e && (x[j] > best || (x[j] == best && col < best_i))) {
        best = x[j];
        best_i = col;
      }
    }
#pragma unroll
    for (int off = WARP / 2; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, best_i, off);
      if (ob > best || (ob == best && oi < best_i)) {
        best = ob;
        best_i = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (j * WARP + lane == best_i) x[j] = -INFINITY;
    if (lane == 0) {
      vals[p] = best;
      idx[static_cast<size_t>(row) * k + p] = best_i;
    }
  }
  __syncwarp();

  float m = vals[0];
  for (int p = 1; p < k; ++p) m = fmaxf(m, vals[p]);
  float sum = 0.0f;
  for (int p = 0; p < k; ++p) sum += expf(vals[p] - m);
  for (int p = lane; p < k; p += WARP)
    gates[static_cast<size_t>(row) * k + p] =
        from_float<T>(expf(vals[p] - m) / sum);
}

template <typename T>
cudaError_t launch(const void* logits, void* gates, int* idx, int t, int e,
                   int k, cudaStream_t stream) {
  const int blocks = (t + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  const size_t smem = sizeof(float) * ROWS_PER_BLOCK * k;
  topk_gating_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(logits), static_cast<T*>(gates), idx, t, e, k);
  return cudaGetLastError();
}

}  // namespace

// logits [t, e] of dtype 0 = f32 or 1 = bf16 -> gates [t, k] (same dtype),
// idx [t, k] int32; needs 1 <= k <= e <= 256.  Returns a cudaError_t.
extern "C" int hetu_topk_gating(const void* logits, void* gates, int* idx,
                                int t, int e, int k, int dtype, int device,
                                void* stream) {
  if (k < 1 || k > e || e > WARP * PER_LANE) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(logits, gates, idx, t, e, k, s);
  else
    err = launch<__nv_bfloat16>(logits, gates, idx, t, e, k, s);
  return (int)err;
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
