// Flash attention backward pass for NVIDIA Hopper (sm_90a): the dK/dV
// kernel and the dQ kernel, on tensor cores for bf16 and on CUDA cores for
// f32.
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
// `scores <= NEG_INF / 2` guard does.  Ragged S is masked, not refused.
//
// What bounds it on an H100.  The training step's shape is B=16, H=12,
// S=1024, D=64, bf16, causal: 100.8 M visible (query, key) pairs.  dK/dV does
// 8*D operations a pair (the q.k, dO.v, p^T.dO and dS^T.q products), 51.6
// GFLOP, 0.052 ms at the 989 TFLOP/s bf16 tensor-core peak; it reads q, k, v,
// dO (25.2 MB each) and the LSE and delta (0.8 MB each), and writes dK and dV,
// 152.6 MB in all, 0.046 ms at 3.35 TB/s.  dQ does 6*D a pair (38.7 GFLOP,
// 0.039 ms) over 127.4 MB (0.038 ms).  Both are bound by operations, so
// only the tensor cores come near the bound (CUDA cores peak at 67 TFLOP/s
// in f32).
//
// bf16: tensor cores (flash_bwd_dkdv_wgmma, flash_bwd_dq_wgmma).  One
// warpgroup a CTA; every product is a wgmma (m64nNk16, bf16 in, f32 sums):
//   * dK/dV: a CTA owns 64 keys.  K and V are loaded once by TMA.  The Q
//     and dO tiles of the query tiles that can see those keys (64 rows; 32
//     at D = 128, to keep four accumulators in registers) stream through a
//     ring of TC_STAGES stages; one thread issues the TMA loads TC_STAGES-1
//     tiles ahead and mbarriers count their bytes in.  Per query tile:
//     S^T = K.Q^T and dP^T = V.dO^T as wgmma chains over D, both operands
//     K-major in shared memory; then, in registers, P^T = exp(S^T scale -
//     lse) with the LSE per column, masked only on tiles that cross the
//     diagonal or a ragged edge, and dS^T = P^T (dP^T - delta) scale; both
//     rounded to bf16 and repacked from the accumulator layout into A
//     fragments (hopper.cuh), so neither passes through shared memory;
//     then dV += P^T.dO and dK += dS^T.Q with A from registers and B read
//     MN-major (transposed) from the tiles already there.  Chosen by
//     measurement on an H100 at the training shape: two warpgroups sharing
//     one Q/dO stream over 128 keys (214 registers a thread, one CTA an SM)
//     and 32-row query tiles (more, shorter iterations) were both slower.
//   * dQ: a CTA owns 64 queries; Q, dO, their LSE and delta stay resident
//     while the K and V tiles up to the causal limit stream through the
//     ring; S = Q.K^T, dP = dO.V^T, dS in registers, dQ += dS.K (B
//     MN-major).  Query tiles are issued heaviest first.
//   * Tiles are bf16 in the 128-byte swizzle, loaded through 4-D tensor maps
//     over [B, H, S, D] with the inputs' own strides (the attention layer's
//     transposed views are read in place, no copy): rows past S and columns
//     past D arrive as zeros, and a tile never reads the next head's rows.
//     The position mask still zeroes p there and outputs are written with
//     bounds checks.  D up to 64 fills one 64-column block (D = 32 is
//     zero-filled), D up to 128 two; D and the strides must be multiples of
//     8 (TMA), and the wrapper copies other inputs once.
//   * No atomics: each output row is written once by one CTA, so two
//     launches give the same bits.
//
// f32: the scalar kernels (flash_bwd_dkdv_kernel, flash_bwd_dq_kernel).  A
// tensor-core product of f32 inputs runs in TF32 (10 mantissa bits), which
// breaks the reference's f32 semantics and the f32 gate of chip_smoke.py
// (TOL_D); the training and serving paths run bf16.  Each scalar block
// keeps its key (or query) tile resident and walks the streamed tiles with
// four threads a row, tiles widened to f32 in shared memory with odd
// strides, p and dS through shared memory.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libflash_attention_bwd.so
//              flash_attention_bwd.cu
// (rebuilt by hetu_tpu_torch/ops/cuda_kernels/build.py when this file or a
// header beside it changes).  The extern "C" launchers below are bound with
// ctypes by hetu_tpu_torch/ops/cuda_kernels/flash_attention.py.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 64;                // rows of a query or key tile
constexpr int QUAD = 4;                  // threads per resident row
constexpr int THREADS = BLOCK * QUAD;    // 256
constexpr int COLS = BLOCK / QUAD;       // streamed rows per thread
constexpr int LDP = BLOCK + 1;           // padded row stride of P and dS

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// ------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;
constexpr int TC_THREADS = 128;  // one warpgroup
constexpr int TC_ROWS = 64;      // rows a CTA owns (keys, or queries)
constexpr int TC_STAGES = 3;     // ring depth of the streamed tiles

// streamed-tile rows: 64, or 32 at D = 128 (keeps dK, dV, S^T and dP^T in
// registers without spilling)
template <int DP>
constexpr int tc_stream_rows() { return DP == 128 ? 32 : 64; }

// shared memory of either kernel: two resident tiles of 64 rows, a ring of
// TC_STAGES stages of two streamed tiles, then the mbarriers (the resident
// tiles' and one per stage), after 1024 bytes of alignment slack
template <int DP>
struct TcSmem {
  static constexpr int BS = tc_stream_rows<DP>();
  static constexpr int RES = TC_ROWS * DP * 2;   // one resident tile
  static constexpr int STR = BS * DP * 2;        // one streamed tile
  static constexpr int RING = 2 * RES;
  static constexpr int BARS = RING + TC_STAGES * 2 * STR;
  static constexpr int BYTES = BARS + 8 * (1 + TC_STAGES) + 1024;
};

// the streamed tile `tile` (rows r0 = tile * BS) of two tensors into ring
// stage `stage`; one thread issues it
template <int DP>
__device__ __forceinline__ void load_stream(uint32_t base, const CUtensorMap* a,
                                            const CUtensorMap* b, int stage,
                                            int r0, int hh, int bb) {
  using L = TcSmem<DP>;
  const uint32_t bar = base + L::BARS + 8 * (1 + stage);
  const uint32_t dst = base + L::RING + stage * 2 * L::STR;
  hopper::mbar_expect_tx(bar, 2 * L::STR);
#pragma unroll
  for (int blk = 0; blk < DP / 64; ++blk) {
    hopper::tma_load_4d(dst + blk * L::BS * 128, a, bar, 64 * blk, r0, hh,
                        bb);
    hopper::tma_load_4d(dst + L::STR + blk * L::BS * 128, b, bar, 64 * blk,
                        r0, hh, bb);
  }
}

// the two resident tiles (rows r0 .. r0 + 63) of two tensors
template <int DP>
__device__ __forceinline__ void load_resident(uint32_t base,
                                              const CUtensorMap* a,
                                              const CUtensorMap* b, int r0,
                                              int hh, int bb) {
  using L = TcSmem<DP>;
  const uint32_t bar = base + L::BARS;
  hopper::mbar_expect_tx(bar, 2 * L::RES);
#pragma unroll
  for (int blk = 0; blk < DP / 64; ++blk) {
    hopper::tma_load_4d(base + blk * TC_ROWS * 128, a, bar, 64 * blk, r0, hh,
                        bb);
    hopper::tma_load_4d(base + L::RES + blk * TC_ROWS * 128, b, bar,
                        64 * blk, r0, hh, bb);
  }
}

// barrier set-up and the first loads, by thread 0
template <int DP>
__device__ __forceinline__ void tc_prologue(uint32_t base, int n_tiles,
                                            const CUtensorMap* res_a,
                                            const CUtensorMap* res_b,
                                            int res_r0,
                                            const CUtensorMap* str_a,
                                            const CUtensorMap* str_b,
                                            int str_first, int hh, int bb) {
  using L = TcSmem<DP>;
  if (threadIdx.x == 0) {
    for (int i = 0; i <= TC_STAGES; ++i)
      hopper::mbar_init(base + L::BARS + 8 * i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n_tiles > 0) {
    load_resident<DP>(base, res_a, res_b, res_r0, hh, bb);
    for (int i = 0; i < TC_STAGES - 1 && i < n_tiles; ++i)
      load_stream<DP>(base, str_a, str_b, i, (str_first + i) * L::BS, hh,
                      bb);
  }
}

// grid: (batch*heads, ceil(S_k / 64)); block: one warpgroup.  The CTA owns
// keys k0 .. k0 + 63 and walks the query tiles that can see them.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, int heads, int s_q, int s_k,
                     int d, float scale, int causal) {
  using L = TcSmem<DP>;
  constexpr int BQ = L::BS;
  const uint32_t base = hopper::aligned_smem_base();
  const uint32_t sK = base, sV = base + L::RES;
  const int bh = blockIdx.x, hh = bh % heads, bb = bh / heads;
  const int k0 = blockIdx.y * TC_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int offset = s_k - s_q;  // bottom-right causal alignment

  // query tiles that can see this key tile: all, or (causal) from the tile
  // holding the first query that sees key k0 (q + offset >= k0) on
  int first = 0;
  if (causal) {
    const int q_min = k0 - offset;
    first = q_min <= 0 ? 0 : q_min / BQ;
  }
  const int n = (s_q + BQ - 1) / BQ - first;
  tc_prologue<DP>(base, n, &tm_k, &tm_v, k0, &tm_q, &tm_do, first, hh, bb);

  float acc_k[DP / 2], acc_v[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  if (n > 0) hopper::mbar_wait(base + L::BARS, 0);

  for (int i = 0; i < n; ++i) {
    // refill the stage that iteration i - 1 read (all threads are past it)
    if (threadIdx.x == 0 && i + TC_STAGES - 1 < n)
      load_stream<DP>(base, &tm_q, &tm_do, (i + TC_STAGES - 1) % TC_STAGES,
                      (first + i + TC_STAGES - 1) * BQ, hh, bb);
    const int stage = i % TC_STAGES;
    const uint32_t sQ = base + L::RING + stage * 2 * L::STR;
    const uint32_t sdO = sQ + L::STR;
    const int q0 = (first + i) * BQ;

    // LSE and delta of this thread's query columns 8j + 2 t4 + e
    float c_lse[BQ / 4], c_delta[BQ / 4];
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qp = q0 + 8 * j + 2 * t4 + e;
        const bool in = qp < s_q;
        c_lse[2 * j + e] = in ? __ldg(lse + (long)bh * s_q + qp) : 0.f;
        c_delta[2 * j + e] = in ? __ldg(delta + (long)bh * s_q + qp) : 0.f;
      }

    hopper::mbar_wait(base + L::BARS + 8 * (1 + stage), (i / TC_STAGES) & 1);

    // S^T = K.Q^T and dP^T = V.dO^T: [64 keys, BQ queries], f32
    float s[BQ / 2], dp[BQ / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      hopper::wgmma_ss<BQ>(s, hopper::desc_k(sK, TC_ROWS, kd),
                           hopper::desc_k(sQ, BQ, kd), kd > 0);
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      hopper::wgmma_ss<BQ>(dp, hopper::desc_k(sV, TC_ROWS, kd),
                           hopper::desc_k(sdO, BQ, kd), kd > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(s);
    hopper::fence_operand(dp);

    // P^T and dS^T in registers; the mask only where a pair can be hidden
    const bool masked = q0 + BQ > s_q || k0 + TC_ROWS > s_k ||
                        (causal && k0 + TC_ROWS - 1 > q0 + offset);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          const int kp = k0 + 16 * warp + g + 8 * h;
          const int qp = q0 + 8 * j + 2 * t4 + e;
          const bool keep = !masked || (qp < s_q && kp < s_k &&
                                        (!causal || kp <= qp + offset));
          const float p = keep ? expf(s[idx] * scale - c_lse[2 * j + e]) : 0.f;
          s[idx] = p;
          dp[idx] = p * (dp[idx] - c_delta[2 * j + e]) * scale;
        }
    // rounded to bf16 and repacked as the A operand: P^T and dS^T never
    // leave the registers
    uint32_t pa[BQ / 16][4], da[BQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        pa[kk][r] =
            hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);
        da[kk][r] =
            hopper::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);
      }

    // dV += P^T.dO and dK += dS^T.Q, B read MN-major from the same tiles
    hopper::fence_operand(acc_v);
    hopper::fence_operand(acc_k);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs_tb<DP>(acc_v, pa[kk], hopper::desc_mn(sdO, BQ, kk), 1);
#pragma unroll
    for (int kk = 0; kk < BQ / 16; ++kk)
      hopper::wgmma_rs_tb<DP>(acc_k, da[kk], hopper::desc_mn(sQ, BQ, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc_v);
    hopper::fence_operand(acc_k);
    __syncthreads();  // this stage is free for the next load
  }

  // each key row once, cast once; bounds-checked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int kp = k0 + 16 * warp + g + 8 * h;
    if (kp >= s_k) continue;
    const long row = ((long)bh * s_k + kp) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c >= d) continue;
      *reinterpret_cast<uint32_t*>(dk + row + c) =
          hopper::pack_bf16(acc_k[4 * j + 2 * h], acc_k[4 * j + 2 * h + 1]);
      *reinterpret_cast<uint32_t*>(dv + row + c) =
          hopper::pack_bf16(acc_v[4 * j + 2 * h], acc_v[4 * j + 2 * h + 1]);
    }
  }
}

// grid: (batch*heads, ceil(S_q / 64)); block: one warpgroup.  The CTA owns
// queries q0 .. q0 + 63, taken from the last tile down (heaviest first
// under the causal mask), and walks the key tiles they can see.
template <int DP>
__global__ void __launch_bounds__(TC_THREADS)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tm_q,
                   const __grid_constant__ CUtensorMap tm_k,
                   const __grid_constant__ CUtensorMap tm_v,
                   const __grid_constant__ CUtensorMap tm_do,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq,
                   int heads, int s_q, int s_k, int d, float scale,
                   int causal) {
  using L = TcSmem<DP>;
  constexpr int BK = L::BS;
  const uint32_t base = hopper::aligned_smem_base();
  const uint32_t sQ = base, sdO = base + L::RES;
  const int bh = blockIdx.x, hh = bh % heads, bb = bh / heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * TC_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int offset = s_k - s_q;

  // key tiles this query tile needs: all, or (causal) those that start at
  // or before the last key the tile's last real row may see
  int n = (s_k + BK - 1) / BK;
  if (causal) {
    const int last_key = min(q0 + TC_ROWS, s_q) - 1 + offset;
    n = last_key < 0 ? 0 : min(n, last_key / BK + 1);
  }
  tc_prologue<DP>(base, n, &tm_q, &tm_do, q0, &tm_k, &tm_v, 0, hh, bb);

  // LSE and delta of this thread's two query rows
  float r_lse[2], r_delta[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + 16 * warp + g + 8 * h;
    r_lse[h] = qp < s_q ? __ldg(lse + (long)bh * s_q + qp) : 0.f;
    r_delta[h] = qp < s_q ? __ldg(delta + (long)bh * s_q + qp) : 0.f;
  }
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if (n > 0) hopper::mbar_wait(base + L::BARS, 0);

  for (int i = 0; i < n; ++i) {
    if (threadIdx.x == 0 && i + TC_STAGES - 1 < n)
      load_stream<DP>(base, &tm_k, &tm_v, (i + TC_STAGES - 1) % TC_STAGES,
                      (i + TC_STAGES - 1) * BK, hh, bb);
    const int stage = i % TC_STAGES;
    const uint32_t sK = base + L::RING + stage * 2 * L::STR;
    const uint32_t sV = sK + L::STR;
    const int k0 = i * BK;
    hopper::mbar_wait(base + L::BARS + 8 * (1 + stage), (i / TC_STAGES) & 1);

    // S = Q.K^T and dP = dO.V^T: [64 queries, BK keys], f32
    float s[BK / 2], dp[BK / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      hopper::wgmma_ss<BK>(s, hopper::desc_k(sQ, TC_ROWS, kd),
                           hopper::desc_k(sK, BK, kd), kd > 0);
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      hopper::wgmma_ss<BK>(dp, hopper::desc_k(sdO, TC_ROWS, kd),
                           hopper::desc_k(sV, BK, kd), kd > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(s);
    hopper::fence_operand(dp);

    const bool masked = k0 + BK > s_k || q0 + TC_ROWS > s_q ||
                        (causal && k0 + BK - 1 > q0 + offset);
    uint32_t da[BK / 16][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          const int qp = q0 + 16 * warp + g + 8 * h;
          const int kp = k0 + 8 * j + 2 * t4 + e;
          const bool keep = !masked || (qp < s_q && kp < s_k &&
                                        (!causal || kp <= qp + offset));
          const float p = keep ? expf(s[idx] * scale - r_lse[h]) : 0.f;
          dp[idx] = p * (dp[idx] - r_delta[h]) * scale;
        }
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        da[kk][r] =
            hopper::pack_bf16(dp[8 * kk + 2 * r], dp[8 * kk + 2 * r + 1]);

    // dQ += dS.K, B read MN-major from the key tile
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      hopper::wgmma_rs_tb<DP>(acc, da[kk], hopper::desc_mn(sK, BK, kk), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    __syncthreads();  // this stage is free for the next load
  }

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int qp = q0 + 16 * warp + g + 8 * h;
    if (qp >= s_q) continue;
    const long row = ((long)bh * s_q + qp) * d;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c < d)
        *reinterpret_cast<uint32_t*>(dq + row + c) =
            hopper::pack_bf16(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;
  // heads, then the batch, head and row strides (in elements) of q, k, v
  // and dout, each with unit inner stride
  const long long* layout;
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

// the four tensor maps of a bf16 launch: q and dO boxes of `q_rows` rows,
// k and v boxes of `k_rows`
cudaError_t tc_maps(const Args& a, int q_rows, int k_rows, CUtensorMap* m) {
  const int heads = static_cast<int>(a.layout[0]), batch = a.bh / heads;
  const void* ptr[4] = {a.q, a.k, a.v, a.dout};
  const int rows[4] = {a.s_q, a.s_k, a.s_k, a.s_q};
  const int box[4] = {q_rows, k_rows, k_rows, q_rows};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t err = hopper::encode_bf16_map(
        &m[i], ptr[i], batch, heads, rows[i], a.d, a.layout + 1 + 3 * i,
        box[i]);
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}

template <int DP>
cudaError_t launch_dkdv_tc(const Args& a) {
  CUtensorMap m[4];
  cudaError_t err = tc_maps(a, tc_stream_rows<DP>(), TC_ROWS, m);
  if (err != cudaSuccess) return err;
  constexpr int smem = TcSmem<DP>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s_k + TC_ROWS - 1) / TC_ROWS);
  flash_bwd_dkdv_wgmma<DP><<<grid, TC_THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), static_cast<int>(a.layout[0]), a.s_q, a.s_k,
      a.d, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t launch_dq_tc(const Args& a) {
  CUtensorMap m[4];
  cudaError_t err = tc_maps(a, TC_ROWS, tc_stream_rows<DP>(), m);
  if (err != cudaSuccess) return err;
  constexpr int smem = TcSmem<DP>::BYTES;
  err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s_q + TC_ROWS - 1) / TC_ROWS);
  flash_bwd_dq_wgmma<DP><<<grid, TC_THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], m[3], static_cast<const float*>(a.lse),
      static_cast<const float*>(a.delta), static_cast<bf16*>(a.dq),
      static_cast<int>(a.layout[0]), a.s_q, a.s_k, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// which: 0 = dK/dV, 1 = dQ.  f32: the scalar kernels, which read
// contiguous [B*H, S, D] inputs; bf16: tensor cores, any strides TMA takes
// (D a multiple of 8: the wrapper pads other head dims).
cudaError_t dispatch_f32(const Args& a, int which) {
  const long long h = a.layout[0];
  for (int i = 0; i < 4; ++i) {
    const long long rows = (i == 1 || i == 2) ? a.s_k : a.s_q;
    const long long* st = a.layout + 1 + 3 * i;
    if (st[2] != a.d || st[1] != rows * a.d || st[0] != h * rows * a.d)
      return cudaErrorInvalidValue;
  }
  if (a.d <= 32)
    return which ? launch_dq<float, 32>(a) : launch_dkdv<float, 32>(a);
  if (a.d <= 64)
    return which ? launch_dq<float, 64>(a) : launch_dkdv<float, 64>(a);
  return which ? launch_dq<float, 128>(a) : launch_dkdv<float, 128>(a);
}

cudaError_t dispatch_bf16(const Args& a, int which) {
  if (a.d % 8 != 0) return cudaErrorInvalidValue;
  if (a.d <= 64) return which ? launch_dq_tc<64>(a) : launch_dkdv_tc<64>(a);
  return which ? launch_dq_tc<128>(a) : launch_dkdv_tc<128>(a);
}

int run(const Args& a, int which, int dtype, int device) {
  if (a.bh <= 0 || a.s_q <= 0 || a.s_k <= 0 || a.d <= 0 || a.d > 128 ||
      (dtype != 0 && dtype != 1) || a.layout == nullptr ||
      a.layout[0] <= 0 || a.bh % a.layout[0] != 0 ||
      (a.s_q + BLOCK - 1) / BLOCK > 65535 ||
      (a.s_k + BLOCK - 1) / BLOCK > 65535)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is
  // separate from PyTorch's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = dtype == 0 ? dispatch_f32(a, which) : dispatch_bf16(a, which);
  return (int)err;
}

}  // namespace

// Launches the dK/dV kernel on `stream` (no synchronisation, no allocation:
// the caller owns dk and dv, contiguous [B*H, S_k, D]).  q, k, v, dout are
// [B, H, S, D] with unit inner stride, laid out as `layout` says (host
// memory: heads, then the batch, head and row strides in elements of q, k,
// v and dout); f32 takes them contiguous only.  dtype: 0 = float32, 1 =
// bfloat16.  Returns a cudaError_t: nonzero when the arguments are refused
// or the launch failed.
extern "C" int hetu_flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv,
    const long long* layout, int bh, int s_q, int s_k, int d, float scale,
    int causal, int dtype, int device, void* stream) {
  const Args a{q,      k,  v,   dout, lse, delta, nullptr, dk,    dv,
               layout, bh, s_q, s_k,  d,   scale, causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, 0, dtype, device);
}

// Launches the dQ kernel on `stream`; as above, the caller owns dq
// (contiguous [B*H, S_q, D]).
extern "C" int hetu_flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, const long long* layout,
    int bh, int s_q, int s_k, int d, float scale, int causal, int dtype,
    int device, void* stream) {
  const Args a{q,      k,  v,   dout, lse,   delta,  dq, nullptr, nullptr,
               layout, bh, s_q, s_k,  d,     scale,  causal,
               static_cast<cudaStream_t>(stream)};
  return run(a, 1, dtype, device);
}

// The runtime's name for an error code returned above.
extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
