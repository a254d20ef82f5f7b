// Flash attention backward pass for NVIDIA Hopper (sm_90a): the dK/dV
// kernel and the dQ kernel.
//
// Replaces the TPU kernels `_flash_bwd_dkdv_kernel` and `_flash_bwd_dq_kernel`
// in hetu_tpu/ops/pallas_kernels/flash_attention.py (driven by `_flash_bwd`,
// launched by its two `pl.pallas_call`s).  Same function, point by point:
//
//   p  = exp(q.k * scale - lse)    recomputed from the forward's f32 LSE
//   dV = sum over queries of  round_T(p) * dO
//   dP = dO.v
//   dS = round_T(p * (dP - delta) * scale),   delta = rowsum(dO * O) in f32
//   dK = sum over queries of  dS * q,   dQ = sum over keys of  dS * k
//
// where round_T rounds to the input type (bf16 or f32), as the TPU kernels'
// `p.astype(do.dtype)` and `ds.astype(q.dtype)` do; the dot products and all
// sums are f32, and each output is cast to the input type once, at the end.
// The causal mask is bottom-right aligned (query i sees keys <= i + S_k -
// S_q) and a masked pair has p = 0, so a query row that sees no key (S_q >
// S_k) gets dQ = 0 and adds nothing to dK or dV, as the TPU kernel's
// `scores <= NEG_INF / 2` guard does.
//
// What bounds it on an H100.  The training step's shape is B=16, H=12,
// S=1024, D=64, bf16, causal: 100.8 M visible (query, key) pairs.  dK/dV does
// 8*D operations a pair (the q.k, dO.v, p^T.dO and dS^T.q products), 51.6
// GFLOP, 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak; it reads q, k, v,
// dO (25.2 MB each) and the LSE and delta (0.8 MB each), and writes dK and dV,
// 152.6 MB in all, 0.046 ms at 3.35 TB/s.  dQ does 6*D a pair (38.7 GFLOP,
// 0.039 ms) over 127.4 MB (0.038 ms).  Both are bound by operations, barely.
//
// What the design does about it.  The TPU kernels carry their accumulators in
// VMEM across a sequential grid axis; Hopper runs blocks in no order, so that
// loop moves inside the block:
//   * dK/dV: one block per (batch*head, 64-row key tile); K and V stay in
//     shared memory while the block walks the query tiles that can see the
//     key tile (all, or from the causal diagonal on), and dK and dV stay in
//     f32 registers;
//   * dQ: one block per (batch*head, 64-row query tile); q, dO, the row's LSE
//     and delta stay resident while the block walks the key tiles up to the
//     causal limit, and dQ stays in f32 registers.  Blocks are issued
//     heaviest first (the last query tiles see the most keys).
// So no [S_q, S_k] tensor reaches device memory.  Four threads share one row
// of the resident tile (a key row for dK/dV, a query row for dQ): each forms
// 16 of the 64 scores of that row against the streamed tile and owns a
// quarter of the output columns, interleaved so that shared-memory reads are
// conflict-free (odd row strides), exactly as the forward kernel is laid
// out.  The products are scalar f32 FMAs on CUDA cores, which reach a small
// share of the bound above; tensor cores (mma.sync, then wgmma and TMA) are
// for a later change.  Ragged tails are masked: rows >= S_q and keys >= S_k
// load as zeros, get p = 0 and are not written, so any S works.  Head dims up
// to 128 are zero-padded to 32, 64 or 128 in shared memory.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libflash_attention_bwd.so
//              flash_attention_bwd.cu
// The extern "C" launchers below are bound with ctypes by
// hetu_tpu_torch/ops/cuda_kernels/flash_attention.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;                // rows of a query or key tile
constexpr int QUAD = 4;                  // threads per resident row
constexpr int THREADS = BLOCK * QUAD;    // 256
constexpr int COLS = BLOCK / QUAD;       // streamed rows per thread
constexpr int LDP = BLOCK + 1;           // padded row stride of P and dS

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

// round-trip through T: p and dS enter their products in the input type
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// rows [r0, r0 + 64) of a [rows, d] matrix into a [64][DP + 1] f32 tile,
// zeros past the last row and past column d
template <typename T, int DP>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int rows, int d) {
  constexpr int LD = DP + 1;
  for (int e = threadIdx.x; e < BLOCK * DP; e += THREADS) {
    const int r = e / DP, c = e % DP;
    const int gr = r0 + r;
    dst[r * LD + c] =
        (gr < rows && c < d) ? to_float(src[(long)gr * d + c]) : 0.f;
  }
}

template <int DP>
constexpr size_t dkdv_smem_bytes() {
  // sK, sV, sQ, sdO [64][DP + 1], sP, sdS [64][65], sLse, sDelta [64]
  return sizeof(float) *
         (4 * BLOCK * (DP + 1) + 2 * BLOCK * LDP + 2 * BLOCK);
}

template <int DP>
constexpr size_t dq_smem_bytes() {
  // sQ, sdO, sK, sV [64][DP + 1], sdS [64][65]
  return sizeof(float) * (4 * BLOCK * (DP + 1) + BLOCK * LDP);
}

// grid: (batch*heads, ceil(S_k / 64)); block: 256 threads.
// q, dout [bh, s_q, d]; k, v, dk, dv [bh, s_k, d] (all contiguous);
// lse, delta [bh, s_q] f32.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta, T* __restrict__ dk,
                      T* __restrict__ dv, int s_q, int s_k, int d,
                      float scale, int causal) {
  constexpr int LD = DP + 1;  // odd stride: rows fall in distinct banks
  constexpr int OUT = DP / QUAD;
  extern __shared__ float smem[];
  float* sK = smem;                  // [BLOCK][LD]
  float* sV = sK + BLOCK * LD;       // [BLOCK][LD]
  float* sQ = sV + BLOCK * LD;       // [BLOCK][LD]
  float* sdO = sQ + BLOCK * LD;      // [BLOCK][LD]
  float* sP = sdO + BLOCK * LD;      // [key][query], rounded to T
  float* sdS = sP + BLOCK * LDP;     // [key][query], rounded to T
  float* sLse = sdS + BLOCK * LDP;   // [BLOCK]
  float* sDelta = sLse + BLOCK;      // [BLOCK]

  const long bh = blockIdx.x;
  const int k0 = blockIdx.y * BLOCK;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;   // key row within the tile
  const int j = tid % QUAD;     // lane within the row's quad
  const long q_base = bh * s_q * d;
  const long k_base = bh * s_k * d;
  const int offset = s_k - s_q;  // bottom-right causal alignment
  const int kp = k0 + row;       // this thread's key position

  load_tile<T, DP>(sK, k + k_base, k0, s_k, d);
  load_tile<T, DP>(sV, v + k_base, k0, s_k, d);

  // query tiles that can see this key tile: all, or (causal) those from the
  // tile holding the first query that sees key k0 (q + offset >= k0) on
  const int n_q_tiles = (s_q + BLOCK - 1) / BLOCK;
  int first = 0;
  if (causal) {
    const int q_min = k0 - offset;
    first = q_min <= 0 ? 0 : q_min / BLOCK;
  }

  float acc_k[OUT], acc_v[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc_k[i] = acc_v[i] = 0.f;

  for (int t = first; t < n_q_tiles; ++t) {
    const int q0 = t * BLOCK;
    __syncthreads();  // the previous tile's reads of sQ, sdO, sP, sdS done
    load_tile<T, DP>(sQ, q + q_base, q0, s_q, d);
    load_tile<T, DP>(sdO, dout + q_base, q0, s_q, d);
    if (tid < BLOCK) {
      const int gq = q0 + tid;
      sLse[tid] = gq < s_q ? lse[bh * s_q + gq] : 0.f;
      sDelta[tid] = gq < s_q ? delta[bh * s_q + gq] : 0.f;
    }
    __syncthreads();

    // q.k and dO.v of this thread's key row against queries j, j+4, ...
    float s[COLS], dp[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < DP; ++c) {
      const float kc = sK[row * LD + c];
      const float vc = sV[row * LD + c];
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int r = (j + QUAD * i) * LD + c;
        s[i] += sQ[r] * kc;
        dp[i] += sdO[r] * vc;
      }
    }
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int qr = j + QUAD * i;
      const int qp = q0 + qr;
      const bool keep = qp < s_q && kp < s_k && (!causal || kp <= qp + offset);
      const float p = keep ? expf(s[i] * scale - sLse[qr]) : 0.f;
      sP[row * LDP + qr] = round_to<T>(p);
      sdS[row * LDP + qr] = round_to<T>(p * (dp[i] - sDelta[qr]) * scale);
    }
    __syncwarp();  // the quad's P and dS rows are complete (one warp's)

    // dV += P^T dO and dK += dS^T q over the tile's queries
    for (int qr = 0; qr < BLOCK; ++qr) {
      const float p = sP[row * LDP + qr];
      const float ds = sdS[row * LDP + qr];
#pragma unroll
      for (int i = 0; i < OUT; ++i) {
        const int c = qr * LD + j + QUAD * i;
        acc_v[i] += p * sdO[c];
        acc_k[i] += ds * sQ[c];
      }
    }
  }

  if (kp < s_k) {
    T* dk_row = dk + k_base + (long)kp * d;
    T* dv_row = dv + k_base + (long)kp * d;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int c = j + QUAD * i;
      if (c < d) {
        dk_row[c] = from_float<T>(acc_k[i]);
        dv_row[c] = from_float<T>(acc_v[i]);
      }
    }
  }
}

// grid: (batch*heads, ceil(S_q / 64)); block: 256 threads.  Query tiles are
// taken from the last one down, so the blocks that walk the most key tiles
// (causal) start first.
template <typename T, int DP>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq,
                    int s_q, int s_k, int d, float scale, int causal) {
  constexpr int LD = DP + 1;
  constexpr int OUT = DP / QUAD;
  extern __shared__ float smem[];
  float* sQ = smem;                  // [BLOCK][LD]
  float* sdO = sQ + BLOCK * LD;      // [BLOCK][LD]
  float* sK = sdO + BLOCK * LD;      // [BLOCK][LD]
  float* sV = sK + BLOCK * LD;       // [BLOCK][LD]
  float* sdS = sV + BLOCK * LD;      // [query][key], rounded to T

  const long bh = blockIdx.x;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * BLOCK;
  const int tid = threadIdx.x;
  const int row = tid / QUAD;   // query row within the tile
  const int j = tid % QUAD;
  const long q_base = bh * s_q * d;
  const long k_base = bh * s_k * d;
  const int offset = s_k - s_q;
  const int qp = q0 + row;      // this thread's query position

  load_tile<T, DP>(sQ, q + q_base, q0, s_q, d);
  load_tile<T, DP>(sdO, dout + q_base, q0, s_q, d);
  const float row_lse = qp < s_q ? lse[bh * s_q + qp] : 0.f;
  const float row_delta = qp < s_q ? delta[bh * s_q + qp] : 0.f;

  // key tiles this query tile needs: all, or (causal) those that start at
  // or before the last key the tile's last real row may see
  int n_tiles = (s_k + BLOCK - 1) / BLOCK;
  if (causal) {
    const int last_key = min(q0 + BLOCK, s_q) - 1 + offset;
    n_tiles = last_key < 0 ? 0 : min(n_tiles, last_key / BLOCK + 1);
  }

  float acc[OUT];
#pragma unroll
  for (int i = 0; i < OUT; ++i) acc[i] = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BLOCK;
    __syncthreads();  // sQ, sdO stored; the previous tile's reads done
    load_tile<T, DP>(sK, k + k_base, k0, s_k, d);
    load_tile<T, DP>(sV, v + k_base, k0, s_k, d);
    __syncthreads();

    // q.k and dO.v of this thread's query row against keys j, j+4, ...
    float s[COLS], dp[COLS];
#pragma unroll
    for (int i = 0; i < COLS; ++i) s[i] = dp[i] = 0.f;
    for (int c = 0; c < DP; ++c) {
      const float qc = sQ[row * LD + c];
      const float oc = sdO[row * LD + c];
#pragma unroll
      for (int i = 0; i < COLS; ++i) {
        const int r = (j + QUAD * i) * LD + c;
        s[i] += qc * sK[r];
        dp[i] += oc * sV[r];
      }
    }
#pragma unroll
    for (int i = 0; i < COLS; ++i) {
      const int kr = j + QUAD * i;
      const int kp = k0 + kr;
      const bool keep = qp < s_q && kp < s_k && (!causal || kp <= qp + offset);
      const float p = keep ? expf(s[i] * scale - row_lse) : 0.f;
      sdS[row * LDP + kr] = round_to<T>(p * (dp[i] - row_delta) * scale);
    }
    __syncwarp();  // the quad's dS row is complete

    // dQ += dS k over the tile's keys
    for (int kr = 0; kr < BLOCK; ++kr) {
      const float ds = sdS[row * LDP + kr];
#pragma unroll
      for (int i = 0; i < OUT; ++i) acc[i] += ds * sK[kr * LD + j + QUAD * i];
    }
  }

  if (qp < s_q) {
    T* dq_row = dq + q_base + (long)qp * d;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int c = j + QUAD * i;
      if (c < d) dq_row[c] = from_float<T>(acc[i]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  int bh, s_q, s_k, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <typename T, int DP>
cudaError_t launch_dkdv(const Args& a) {
  constexpr size_t smem = dkdv_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkdv_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s_k + BLOCK - 1) / BLOCK);
  flash_bwd_dkdv_kernel<T, DP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dk), static_cast<T*>(a.dv), a.s_q, a.s_k, a.d,
      a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, int DP>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, DP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s_q + BLOCK - 1) / BLOCK);
  flash_bwd_dq_kernel<T, DP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.s_q, a.s_k, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// which: 0 = dK/dV, 1 = dQ
template <typename T>
cudaError_t dispatch_d(const Args& a, int which) {
  if (a.d <= 32) return which ? launch_dq<T, 32>(a) : launch_dkdv<T, 32>(a);
  if (a.d <= 64) return which ? launch_dq<T, 64>(a) : launch_dkdv<T, 64>(a);
  return which ? launch_dq<T, 128>(a) : launch_dkdv<T, 128>(a);
}

int run(const Args& a, int which, int dtype, int device) {
  if (a.bh <= 0 || a.s_q <= 0 || a.s_k <= 0 || a.d <= 0 || a.d > 128 ||
      (dtype != 0 && dtype != 1) || (a.s_q + BLOCK - 1) / BLOCK > 65535 ||
      (a.s_k + BLOCK - 1) / BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is
  // separate from PyTorch's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = dtype == 0 ? dispatch_d<float>(a, which)
                   : dispatch_d<__nv_bfloat16>(a, which);
  return (int)err;
}

}  // namespace

// Launches the dK/dV kernel on `stream` (no synchronisation, no allocation:
// the caller owns dk and dv).  dtype: 0 = float32, 1 = bfloat16.  Returns a
// cudaError_t: nonzero when the arguments are refused or the launch failed.
extern "C" int hetu_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int bh, int s_q,
    int s_k, int d, float scale, int causal, int dtype, int device,
    void* stream) {
  const Args a{q,   k,   v,   dout, lse, delta, nullptr, dk,    dv,
               bh,  s_q, s_k, d,    scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, 0, dtype, device);
}

// Launches the dQ kernel on `stream`; as above, the caller owns dq.
extern "C" int hetu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int bh, int s_q, int s_k,
    int d, float scale, int causal, int dtype, int device, void* stream) {
  const Args a{q,   k,   v,   dout, lse,   delta,  dq, nullptr, nullptr,
               bh,  s_q, s_k, d,    scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, 1, dtype, device);
}

// The runtime's name for an error code returned above.
extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
