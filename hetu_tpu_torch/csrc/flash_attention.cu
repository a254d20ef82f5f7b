// Flash attention forward pass for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel `_flash_fwd_kernel` in
// hetu_tpu/ops/pallas_kernels/flash_attention.py (driven by `_flash_fwd`,
// launched by its `pl.pallas_call`).  Same function: causal or full attention
// with the online softmax over key tiles, O in the input type and an f32
// log-sum-exp (LSE) per query row for the backward pass; the causal mask is
// bottom-right aligned (query i sees keys <= i + S_k - S_q); causal tiles that
// no query of the tile can see are skipped; a query row that sees no key gives
// O = 0 (LSE = -1e30 + log(1e-20)), exactly as the TPU kernel's
// l = max(l, 1e-20) epilogue does.  Scores accumulate in f32 and the scale is
// applied to the f32 scores; the probabilities are rounded to the value type
// before the P.V product, as the TPU kernel's `p.astype(v.dtype)` does.
//
// What bounds it on an H100.  The serving slice's largest prefill is B=1,
// H=12, S=512, D=64, bf16, causal: about 0.40 GFLOP (0.41 us at the 989
// TFLOP/s bf16 tensor-core peak) against 3.1 MB of q, k, v and O plus 24.6 KB
// of LSE (0.95 us at 3.35 TB/s).  So the work is bound by memory, at about
// 1 us, and at this size the launch latency (a few us) dominates both.
//
// What the design does about it.  One thread block per (batch*head, 64-row
// query tile): the q tile is read once into shared memory, 64-row K and V
// tiles stream through shared memory, and the [64, 64] score tile never
// leaves the block, so device memory sees each input read once per query
// tile and each output written once -- the bytes term above, times the number
// of query tiles for K and V (8 at S=512, still L2-resident).  The online
// softmax state (m, l and the output accumulator) stays in f32 registers.
// Four threads share one query row: each owns 16 of the 64 score columns and
// a quarter of the output columns (interleaved, so shared-memory reads are
// conflict-free), and the quad reduces row max and row sum with warp
// shuffles.  Products are scalar f32 FMAs on CUDA cores: simple and exact in
// f32.  At these sizes the kernel is latency-bound, not compute-bound;
// tensor cores (mma.sync / wgmma) and TMA staging are for a later change.
// Ragged tails are masked (rows >= S_q are not written, keys >= S_k get
// p = 0), so any S works, not only the power-of-two blocks the TPU kernel
// needs.  Head dims up to 128 are zero-padded to 32, 64 or 128 in shared
// memory (zero columns add nothing to q.k).
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// The extern "C" launcher below is bound with ctypes by
// hetu_tpu_torch/ops/cuda_kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK_Q = 64;                // query rows per thread block
constexpr int BLOCK_K = 64;                // key rows per shared-memory tile
constexpr int QUAD = 4;                    // threads per query row
constexpr int THREADS = BLOCK_Q * QUAD;    // 256
constexpr int COLS = BLOCK_K / QUAD;       // score columns per thread
constexpr int LDP = BLOCK_K + 1;           // padded row stride of the P tile
constexpr float NEG_INF = -1e30f;          // the TPU kernel's mask value

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// round-trip through T: the probabilities enter P.V in the value type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int DP>
constexpr size_t smem_bytes() {
  // sQ and sK [64][DP + 1], sV [64][DP], sP [64][65], all f32
  return sizeof(float) * (2 * BLOCK_Q * (DP + 1) + BLOCK_K * DP +
                          BLOCK_Q * LDP);
}

// grid: (batch*heads, ceil(S_q / 64)); block: 256 threads.
// q [bh, s_q, d], k and v [bh, s_k, d], o [bh, s_q, d] (all contiguous),
// lse [bh, s_q] f32.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ o,
                 float* __restrict__ lse, int s_q, int s_k, int d,
                 float scale, int causal) {
  constexpr int LD = DP + 1;  // odd stride: rows fall in distinct banks
  constexpr int OUT = DP / QUAD;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BLOCK_Q][LD]
  float* sK = sQ + BLOCK_Q * LD;     // [BLOCK_K][LD]
  float* sV = sK + BLOCK_K * LD;     // [BLOCK_K][DP]
  float* sP = sV + BLOCK_K * DP;     // [BLOCK_Q][LDP]

  const long bh = blockIdx.x;
  const int q0 = blockIdx.y * BLOCK_Q;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;   // query row within the tile
  const int j = tid % QUAD;     // lane within the row's quad
  const long q_base = bh * s_q * d;
  const long k_base = bh * s_k * d;
  const int offset = s_k - s_q;  // bottom-right causal alignment

  for (int e = tid; e < BLOCK_Q * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int gr = q0 + r;
    sQ[r * LD + c] =
        (gr < s_q && c < d) ? to_float(q[q_base + (long)gr * d + c]) : 0.f;
  }

  // key tiles this query tile needs: all, or (causal) those that start at
  // or before the last key the tile's last real row may see
  int n_tiles = (s_k + BLOCK_K - 1) / BLOCK_K;
  if (causal) {
    const int last_key = min(q0 + BLOCK_Q, s_q) - 1 + offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BLOCK_K + 1);
  }
  const int q_pos = q0 + row + offset;  // last key this row may see

  float m = NEG_INF, l = 0.f;
  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK_K;
    __syncthreads();  // sQ stored; the previous tile's sK/sV/sP reads done
    for (int e = tid; e < BLOCK_K * DP; e += THREADS) {
      const int r = e / DP, c = e % DP;
      const int gr = k0 + r;
      const bool in = gr < s_k && c < d;
      const long idx = k_base + (long)gr * d + c;
      sK[r * LD + c] = in ? to_float(k[idx]) : 0.f;
      sV[r * DP + c] = in ? to_float(v[idx]) : 0.f;
    }
    __syncthreads();

    // scores for this thread's columns j, j+4, ..., j+60
    float s[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = 0.f;
    for (int c = 0; c < DP; ++c) {
      const float qv = sQ[row * LD + c];
#pragma unroll
      for (int i = 0; i < COLS; ++i) s[i] += qv * sK[(j + QUAD * i) * LD + c];
    }
    float tile_max = NEG_INF;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kp = k0 + j + QUAD * i;
      const bool keep = kp < s_k && (!causal || kp <= q_pos);
      s[i] = keep ? s[i] * scale : NEG_INF;
      tile_max = fmaxf(tile_max, s[i]);
    }
    const float m_new = fmaxf(m, quad_max(tile_max));
    const float corr = expf(m - m_new);
    float row_sum = 0.f;
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      // masked and ragged keys contribute exactly 0, also when the whole
      // row is masked so far (m_new == NEG_INF)
      const float p = s[i] <= 0.5f * NEG_INF ? 0.f : expf(s[i] - m_new);
      row_sum += p;
      sP[row * LDP + j + QUAD * i] = round_to<T>(p);
    }
    l = l * corr + quad_sum(row_sum);
    m = m_new;
    __syncwarp();  // the quad's P row is complete (a quad is one warp's)

#pragma unroll
    for (int i = 0; i < OUT; ++i) acc[i] *= corr;
    for (int c = 0; c < BLOCK_K; ++c) {
      const float p = sP[row * LDP + c];
#pragma unroll
      for (int i = 0; i < OUT; ++i) acc[i] += p * sV[c * DP + j + QUAD * i];
    }
  }

  const int gr = q0 + row;
  if (gr < s_q) {
    const float l_safe = fmaxf(l, 1e-20f);
    T* o_row = o + q_base + (long)gr * d;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int c = j + QUAD * i;
      if (c < d) o_row[c] = from_float<T>(acc[i] / l_safe);
    }
    if (j == 0) lse[bh * s_q + gr] = m + logf(l_safe);
  }
}

template <typename T, int DP>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int bh, int s_q, int s_k, int d, float scale,
                   int causal, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(bh, (s_q + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<T, DP><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      s_q, s_k, d, scale, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o,
                       void* lse, int bh, int s_q, int s_k, int d,
                       float scale, int causal, cudaStream_t stream) {
  if (d <= 32)
    return launch<T, 32>(q, k, v, o, lse, bh, s_q, s_k, d, scale, causal,
                         stream);
  if (d <= 64)
    return launch<T, 64>(q, k, v, o, lse, bh, s_q, s_k, d, scale, causal,
                         stream);
  return launch<T, 128>(q, k, v, o, lse, bh, s_q, s_k, d, scale, causal,
                        stream);
}

}  // namespace

// Launches the forward pass on `stream` (no synchronisation, no allocation:
// the caller owns o and lse).  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t: nonzero when the arguments are refused or the launch failed.
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        int bh, int s_q, int s_k, int d,
                                        float scale, int causal, int dtype,
                                        int device, void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1) || (s_q + BLOCK_Q - 1) / BLOCK_Q > 65535)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is
  // separate from PyTorch's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_d<float>(q, k, v, o, lse, bh, s_q, s_k, d, scale, causal,
                            s);
  else
    err = dispatch_d<__nv_bfloat16>(q, k, v, o, lse, bh, s_q, s_k, d, scale,
                                    causal, s);
  return (int)err;
}

// The runtime's name for an error code returned above.
extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
