// Fused top-k expert gate for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_topk_kernel` of
// hetu_tpu/ops/pallas_kernels/embedding.py (driven by `_topk_gating_impl`,
// op `topk_gating`).  Same function: for each token's logits [E], k passes
// of "take the maximum, then the lowest index that attains it, then mask
// that index with -inf" give the k values (f32) and their indices (int32),
// ties resolved to the lowest index as `lax.top_k` does (a row of -inf
// picks index 0, and a masked index can be picked again once every value
// left is -inf, as in the reference); then the softmax over the k values in
// f32 (exp(v - max) / sum), written in the logits' type.  Any E >= k.  The
// gate's gradient is plain PyTorch in the wrapper's autograd.Function, as
// the reference's is plain XLA.
//
// What bounds it on an H100.  The MoE step's gate reads logits [16384, 8]
// f32 (524 KB) and writes [16384, 2] gates and indices (262 KB): a quarter
// of a microsecond of HBM time, so the launch, one round trip to memory and
// the k dependent passes are what it costs.
//
// What the design does about it.  The threads a token gets follow E, so
// that no lane sits idle and no pass waits on a long chain of shuffles:
// * E <= 32: one thread per token, 128 tokens to a block (the MoE step's
//   [16384, 8] is 128 blocks, one wave).  The thread reads its row in
//   16-byte vectors where the row allows it, runs the k passes over
//   registers (strict ">" in ascending column order keeps the lowest index
//   of equal values), takes the softmax in registers and writes gates and
//   indices in vector stores.  Every array index is a compile-time
//   constant (loops unrolled over the register count 8, 16 or 32, guarded
//   by E and k), so nothing spills to local memory.
// * 32 < E <= 1024: G lanes per token, G the smallest power of two with
//   32 G >= E; each lane holds a contiguous slice of at most 32 logits in
//   registers.  A pass takes the lane's best (value, index), then log2 G
//   `__shfl_xor_sync` steps of width G that keep the larger value and,
//   among equal values, the lower index; the owner lane masks the winner.
//   The k values wait in shared memory for the softmax, whose outputs the
//   group's lanes write in parallel.
// * E > 1024: one warp per token keeps the row in f32 in shared memory
//   (or, when E does not fit there, in a scratch row in device memory that
//   the wrapper allocates) and walks it each pass, lane c reading columns
//   c, c + 32, ... so the walk is conflict-free.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libtopk_gating.so topk_gating.cu
// The extern "C" launchers below are bound with ctypes by
// hetu_tpu_torch/ops/cuda_kernels/embedding.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int SMALL_THREADS = 128;  // one thread per token (E <= 32)
constexpr int GROUP_THREADS = 256;  // G lanes per token (32 < E <= 1024)
constexpr int PER_LANE = 32;        // logits a lane holds in registers
constexpr int MAX_GROUP_E = WARP * PER_LANE;  // 1024

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

// VEC elements of type T, moved as one aligned load or store.
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T x[VEC];
};

// (v, i) ranks before (bv, bi): the larger value, then the lower index.
__device__ __forceinline__ bool before(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// x[j] = src[j] as f32 for j < count, -inf for count <= j < N; in 16-byte
// vectors when count and the address allow it.
template <typename T, int N>
__device__ __forceinline__ void load_logits(const T* src, int count,
                                            float (&x)[N]) {
  constexpr int V = 16 / sizeof(T);
  if (N % V == 0 && count % V == 0 &&
      reinterpret_cast<uintptr_t>(src) % 16 == 0) {
#pragma unroll
    for (int q = 0; q < N / V; ++q) {
      if (q * V < count) {
        const Pack<T, V> p = reinterpret_cast<const Pack<T, V>*>(src)[q];
#pragma unroll
        for (int e = 0; e < V; ++e) x[q * V + e] = to_float(p.x[e]);
      } else {
#pragma unroll
        for (int e = 0; e < V; ++e) x[q * V + e] = -INFINITY;
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < N; ++j) x[j] = j < count ? to_float(src[j]) : -INFINITY;
  }
}

// dst[p] = v[p] for p < k (k <= N), in packs of W bytes.
template <int W, typename T, int N>
__device__ __forceinline__ void store_packs(T* dst, const T (&v)[N], int k) {
  constexpr int V = W / sizeof(T);
  using P = Pack<T, V>;
#pragma unroll
  for (int q = 0; q < N / V; ++q) {
    if (q * V < k) {
      P p;
#pragma unroll
      for (int e = 0; e < V; ++e) p.x[e] = v[q * V + e];
      reinterpret_cast<P*>(dst)[q] = p;
    }
  }
}

// dst[p] = v[p] for p < k, in the widest stores (16, 8 or 4 bytes) that k
// and the address allow.
template <typename T, int N>
__device__ __forceinline__ void store_row(T* dst, const T (&v)[N], int k) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(dst);
  const int bytes = k * static_cast<int>(sizeof(T));
  if (bytes % 16 == 0 && a % 16 == 0) {
    store_packs<16>(dst, v, k);
  } else if (bytes % 8 == 0 && a % 8 == 0) {
    store_packs<8>(dst, v, k);
  } else if (bytes % 4 == 0 && a % 4 == 0) {
    store_packs<4>(dst, v, k);
  } else {
#pragma unroll
    for (int p = 0; p < N; ++p)
      if (p < k) dst[p] = v[p];
  }
}

// E <= N <= 32: one thread per token, everything in registers.
template <typename T, int N>
__global__ void __launch_bounds__(SMALL_THREADS)
topk_small_kernel(const T* __restrict__ logits, T* __restrict__ gates,
                  int* __restrict__ idx, int t, int e, int k) {
  const int row = blockIdx.x * SMALL_THREADS + threadIdx.x;
  if (row >= t) return;  // a thread is a token: no shuffles to keep whole
  float x[N];
  load_logits<T, N>(logits + static_cast<size_t>(row) * e, e, x);
  float val[N];
  int pick[N];
#pragma unroll
  for (int p = 0; p < N; ++p) {
    if (p < k) {
      // columns ascend and ">" is strict: the lowest index of equal values
      // (the columns past E hold -inf and never win)
      float best = x[0];
      int bi = 0;
#pragma unroll
      for (int j = 1; j < N; ++j)
        if (x[j] > best) {
          best = x[j];
          bi = j;
        }
#pragma unroll
      for (int j = 0; j < N; ++j)
        if (j == bi) x[j] = -INFINITY;
      val[p] = best;
      pick[p] = bi;
    }
  }
  // the softmax over the k values in f32; they descend, so val[0] is the
  // maximum
  float sum = 0.0f;
#pragma unroll
  for (int p = 0; p < N; ++p)
    if (p < k) sum += expf(val[p] - val[0]);
  T g[N];
#pragma unroll
  for (int p = 0; p < N; ++p)
    if (p < k) g[p] = from_float<T>(expf(val[p] - val[0]) / sum);
  store_row<T, N>(gates + static_cast<size_t>(row) * k, g, k);
  store_row<int, N>(idx + static_cast<size_t>(row) * k, pick, k);
}

// 32 < E <= 32 G: G lanes per token, lane g holding columns
// [g * per, g * per + per) (per <= 32) in registers.
template <typename T, int G>
__global__ void __launch_bounds__(GROUP_THREADS)
topk_group_kernel(const T* __restrict__ logits, T* __restrict__ gates,
                  int* __restrict__ idx, int t, int e, int k, int per) {
  extern __shared__ float s_vals[];  // [GROUP_THREADS / G][k]
  const int g = threadIdx.x % G;
  const int slot = threadIdx.x / G;
  const int row = blockIdx.x * (GROUP_THREADS / G) + slot;
  // a group past the last token still runs every shuffle, with no columns
  const bool live = row < t;
  const int start = g * per;
  const int count = live ? min(per, e - start) : 0;
  float x[PER_LANE];
  load_logits<T, PER_LANE>(
      logits + static_cast<size_t>(live ? row : 0) * e + start, count, x);
  float* vals = s_vals + slot * k;
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (j < count && before(x[j], start + j, best, bi)) {
        best = x[j];
        bi = start + j;
      }
#pragma unroll
    for (int off = G / 2; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(FULL, best, off, G);
      const int oi = __shfl_xor_sync(FULL, bi, off, G);
      if (before(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j)
      if (start + j == bi) x[j] = -INFINITY;
    if (g == 0 && live) {
      vals[p] = best;
      idx[static_cast<size_t>(row) * k + p] = bi;
    }
  }
  __syncwarp();  // a group lies within one warp
  if (!live) return;
  const float m = vals[0];
  float sum = 0.0f;
  for (int p = 0; p < k; ++p) sum += expf(vals[p] - m);
  for (int p = g; p < k; p += G)
    gates[static_cast<size_t>(row) * k + p] =
        from_float<T>(expf(vals[p] - m) / sum);
}

// E > 1024: one warp per token walks the row, in shared memory, or in
// `work` (a [t, e + k] f32 scratch) when that is not null.
template <typename T>
__global__ void __launch_bounds__(WARP)
topk_wide_kernel(const T* __restrict__ logits, T* __restrict__ gates,
                 int* __restrict__ idx, int t, int e, int k,
                 float* __restrict__ work) {
  extern __shared__ float s_row[];  // [e] logits, then [k] values
  const int row = blockIdx.x;
  const int lane = threadIdx.x;
  float* x = work ? work + static_cast<size_t>(row) * (e + k) : s_row;
  float* vals = x + e;
  const T* src = logits + static_cast<size_t>(row) * e;
  for (int c = lane; c < e; c += WARP) x[c] = to_float(src[c]);
  __syncwarp();
  for (int p = 0; p < k; ++p) {
    float best = -INFINITY;
    int bi = INT_MAX;
    for (int c = lane; c < e; c += WARP)
      if (before(x[c], c, best, bi)) {
        best = x[c];
        bi = c;
      }
#pragma unroll
    for (int off = WARP / 2; off > 0; off /= 2) {
      const float ob = __shfl_xor_sync(FULL, best, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (before(ob, oi, best, bi)) {
        best = ob;
        bi = oi;
      }
    }
    if (lane == 0) {
      vals[p] = best;
      x[bi] = -INFINITY;
      idx[static_cast<size_t>(row) * k + p] = bi;
    }
    __syncwarp();
  }
  const float m = vals[0];
  float sum = 0.0f;
  for (int p = 0; p < k; ++p) sum += expf(vals[p] - m);
  for (int p = lane; p < k; p += WARP)
    gates[static_cast<size_t>(row) * k + p] =
        from_float<T>(expf(vals[p] - m) / sum);
}

// Shared memory a wide block needs, or 0 when the row must live in the
// wrapper's scratch (more than the device lets one block have).
int wide_smem_bytes(int e, int k, int device) {
  int optin = 0;
  if (cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             device) != cudaSuccess)
    return 0;
  const size_t bytes = sizeof(float) * (static_cast<size_t>(e) + k);
  return bytes <= static_cast<size_t>(optin) ? static_cast<int>(bytes) : 0;
}

template <typename T, int G>
cudaError_t launch_group(const T* logits, T* gates, int* idx, int t, int e,
                         int k, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  // a slice a multiple of the 16-byte vector, so that the lanes' loads
  // stay aligned where the row is
  const int per = ((e + G - 1) / G + V - 1) / V * V;
  constexpr int tokens = GROUP_THREADS / G;
  const int blocks = (t + tokens - 1) / tokens;
  const size_t smem = sizeof(float) * tokens * k;  // <= 32 KB: k <= 32 G
  topk_group_kernel<T, G><<<blocks, GROUP_THREADS, smem, stream>>>(
      logits, gates, idx, t, e, k, per);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* logits_v, void* gates_v, int* idx,
                   float* work, int t, int e, int k, int device,
                   cudaStream_t stream) {
  const T* logits = static_cast<const T*>(logits_v);
  T* gates = static_cast<T*>(gates_v);
  if (e <= WARP) {
    const int blocks = (t + SMALL_THREADS - 1) / SMALL_THREADS;
    if (e <= 8)
      topk_small_kernel<T, 8><<<blocks, SMALL_THREADS, 0, stream>>>(
          logits, gates, idx, t, e, k);
    else if (e <= 16)
      topk_small_kernel<T, 16><<<blocks, SMALL_THREADS, 0, stream>>>(
          logits, gates, idx, t, e, k);
    else
      topk_small_kernel<T, 32><<<blocks, SMALL_THREADS, 0, stream>>>(
          logits, gates, idx, t, e, k);
    return cudaGetLastError();
  }
  if (e <= MAX_GROUP_E) {
    if (e <= 2 * PER_LANE)
      return launch_group<T, 2>(logits, gates, idx, t, e, k, stream);
    if (e <= 4 * PER_LANE)
      return launch_group<T, 4>(logits, gates, idx, t, e, k, stream);
    if (e <= 8 * PER_LANE)
      return launch_group<T, 8>(logits, gates, idx, t, e, k, stream);
    if (e <= 16 * PER_LANE)
      return launch_group<T, 16>(logits, gates, idx, t, e, k, stream);
    return launch_group<T, 32>(logits, gates, idx, t, e, k, stream);
  }
  int smem = 0;
  if (work == nullptr) {
    smem = wide_smem_bytes(e, k, device);
    if (smem == 0) return cudaErrorInvalidValue;  // needs the scratch
    if (smem > 48 * 1024) {
      const cudaError_t err = cudaFuncSetAttribute(
          topk_wide_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          smem);
      if (err != cudaSuccess) return err;
    }
  }
  topk_wide_kernel<T><<<t, WARP, smem, stream>>>(logits, gates, idx, t, e, k,
                                                 work);
  return cudaGetLastError();
}

}  // namespace

// The f32 scratch, in elements per token, that a launch on these shapes
// needs from the wrapper: e + k when the row fits no block's shared memory
// (E > 1024 only), else 0.
extern "C" long long hetu_topk_gating_work(int e, int k, int device) {
  if (e <= MAX_GROUP_E) return 0;
  return wide_smem_bytes(e, k, device) ? 0
                                       : static_cast<long long>(e) + k;
}

// logits [t, e] of dtype 0 = f32 or 1 = bf16 -> gates [t, k] (same dtype),
// idx [t, k] int32; needs 1 <= k <= e.  `work`: null, or the [t, e + k] f32
// scratch that hetu_topk_gating_work asks for.  Returns a cudaError_t.
extern "C" int hetu_topk_gating(const void* logits, void* gates, int* idx,
                                float* work, int t, int e, int k, int dtype,
                                int device, void* stream) {
  if (k < 1 || k > e) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = launch<float>(logits, gates, idx, work, t, e, k, device, s);
  else
    err = launch<__nv_bfloat16>(logits, gates, idx, work, t, e, k, device, s);
  return (int)err;
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
