// Flash attention forward pass for NVIDIA Hopper (sm_90a), on tensor cores
// for bf16 and on CUDA cores for f32.
//
// Replaces the TPU kernel `_flash_fwd_kernel` in
// hetu_tpu/ops/pallas_kernels/flash_attention.py (driven by `_flash_fwd`,
// launched by its `pl.pallas_call`).  Same function, point by point:
//
//   s  = (q.k summed in f32) * scale, in f32
//   m  = running row max of s;  p = exp(s - m);  l = sum of the f32 p
//   O  = sum over keys of round_T(p) * v, rescaled by exp(m_old - m_new)
//        as the max grows, divided by max(l, 1e-20) once at the end
//   LSE = m + log(max(l, 1e-20))
//
// where round_T rounds to the input type, as the TPU kernel's
// `p.astype(v.dtype)` does; l sums the unrounded p.  The causal mask is
// bottom-right aligned (query i sees keys <= i + S_k - S_q); a masked score
// is -1e30 and gives p = 0 exactly, so a query row that sees no key (S_q >
// S_k) gets O = 0 and LSE = -1e30 + log(1e-20), as the TPU kernel's
// epilogue does.  O comes out in the input type, the LSE in f32 [B*H, S_q].
// Ragged S_q and S_k are masked, not refused.
//
// What bounds it on an H100.  The training step's shape is B=16, H=12,
// S=1024, D=64, bf16, causal: 100.8 M visible (query, key) pairs at 4*D
// operations a pair (q.k and p.v), 25.8 GFLOP, 0.026 ms at the 989 TFLOP/s
// bf16 tensor-core peak; it reads q, k, v and writes O (25.2 MB each) and the
// LSE (0.8 MB), 101.4 MB, 0.030 ms at 3.35 TB/s.  So it is bound by bytes,
// but barely: operations are 86 % of it, and CUDA cores (67 TFLOP/s in f32)
// would take 0.39 ms for the products alone.  Only the tensor cores come
// near the bound, and then the exponentials (one a pair, 16 a cycle an SM)
// cost about as much as each product.
//
// bf16: tensor cores (flash_fwd_wgmma).  A CTA is one warpgroup (128
// threads) that owns 64 queries of one (batch, head); query tiles are
// issued heaviest first under the causal mask.  Several CTAs share an SM,
// so one CTA's exponentials overlap another's products.
//   * Q is loaded once by TMA.  The K and V tiles (64 keys each) up to the
//     causal limit of the CTA's last row stream through a ring of
//     FWD_STAGES stages; one thread issues the loads FWD_STAGES - 1 tiles
//     ahead and mbarriers count their bytes in.
//   * S = Q.K^T is a wgmma chain over D (m64n64k16, both operands K-major
//     in shared memory).  Then, in registers: the scale, the mask (only on
//     tiles that cross the diagonal or a ragged edge), the row max over the
//     quad of threads that shares a row (xor-shuffles 1 and 2), the rescale
//     of the O accumulator, p = exp(s - m), a per-thread share of l (summed
//     over the quad once, at the end), and p rounded to bf16 and repacked
//     from the accumulator layout into A fragments (hopper.cuh).
//   * O += P.V with A from registers and V read MN-major (transposed) from
//     the tile already there: P never touches shared memory.  Every
//     register rescale of the accumulator happens between one chain's wait
//     and the next chain's fence, so ptxas keeps the wgmmas asynchronous.
//   * Tiles are bf16 in the 128-byte swizzle, loaded through 4-D tensor maps
//     over [B, H, S, D] with the inputs' own strides (the attention layer's
//     transposed views are read in place, no copy): rows past S and columns
//     past D arrive as zeros, and a tile never reads the next head's rows.
//     D up to 64 fills one 64-column block (D = 32 is zero-filled), D up to
//     128 two; D and the strides must be multiples of 8 (TMA), and the
//     wrapper copies other inputs once.  O is written once, bounds-checked,
//     with its own strides; no atomics, so two launches give the same bits.
//   * Chosen by measurement on an H100 (PERF.md, section 6): two warpgroups on
//     128 queries sharing each K/V tile (FlashAttention-3's consumer layout,
//     half the K/V traffic a query) were as fast at the training shape and
//     slower at the serving shapes, which have few query tiles.
//
// f32: the scalar kernel (flash_fwd_kernel).  A tensor-core product of f32
// inputs runs in TF32 (10 mantissa bits), which breaks the reference's f32
// semantics and the f32 gate of chip_smoke.py; the training and serving
// paths run bf16.  256 threads, four a query row, K and V widened to f32 in
// shared memory with odd strides, P through shared memory, f32 FMAs.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libflash_attention.so flash_attention.cu
// (rebuilt by hetu_tpu_torch/ops/cuda_kernels/build.py when this file or a
// header beside it changes).  The extern "C" launcher below is bound with
// ctypes by hetu_tpu_torch/ops/cuda_kernels/flash_attention.py.

#include "hopper.cuh"

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1e30f;  // the TPU kernel's mask value

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ------------------------------------------------------ f32: CUDA cores

constexpr int BLOCK_Q = 64;                // query rows per thread block
constexpr int BLOCK_K = 64;                // key rows per shared-memory tile
constexpr int QUAD = 4;                    // threads per query row
constexpr int THREADS = BLOCK_Q * QUAD;    // 256
constexpr int COLS = BLOCK_K / QUAD;       // score columns per thread
constexpr int LDP = BLOCK_K + 1;           // padded row stride of the P tile

template <int DP>
constexpr size_t smem_bytes() {
  // sQ and sK [64][DP + 1], sV [64][DP], sP [64][65], all f32
  return sizeof(float) * (2 * BLOCK_Q * (DP + 1) + BLOCK_K * DP +
                          BLOCK_Q * LDP);
}

// grid: (batch*heads, ceil(S_q / 64)); block: 256 threads.
// q [bh, s_q, d], k and v [bh, s_k, d], o [bh, s_q, d] (all contiguous),
// lse [bh, s_q] f32.
template <int DP>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
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
    sQ[r * LD + c] = (gr < s_q && c < d) ? q[q_base + (long)gr * d + c] : 0.f;
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
      sK[r * LD + c] = in ? k[idx] : 0.f;
      sV[r * DP + c] = in ? v[idx] : 0.f;
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
      sP[row * LDP + j + QUAD * i] = p;
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
    float* o_row = o + q_base + (long)gr * d;
#pragma unroll
    for (int i = 0; i < OUT; ++i) {
      const int c = j + QUAD * i;
      if (c < d) o_row[c] = acc[i] / l_safe;
    }
    if (j == 0) lse[bh * s_q + gr] = m + logf(l_safe);
  }
}

// ------------------------------------------------- bf16: tensor cores

using bf16 = __nv_bfloat16;
constexpr int FWD_ROWS = 64;     // queries a CTA owns; keys a tile
constexpr int FWD_THREADS = 128; // one warpgroup
constexpr int FWD_STAGES = 2;    // ring depth of the K/V tiles
constexpr float LOG2E = 1.4426950408889634f;

// shared memory: the resident query tile, a ring of FWD_STAGES stages of a
// K and a V tile, then the mbarriers (Q's and one per stage), after 1024
// bytes of alignment slack
template <int DP>
struct FwdSmem {
  static constexpr int TILE = FWD_ROWS * DP * 2;  // one 64-row bf16 tile
  static constexpr int RING = TILE;
  static constexpr int BARS = RING + FWD_STAGES * 2 * TILE;
  static constexpr int BYTES = BARS + 8 * (1 + FWD_STAGES) + 1024;
};

// key tile `tile` of K and V into ring stage `stage`; one thread issues it
template <int DP>
__device__ __forceinline__ void load_kv(uint32_t base, const CUtensorMap* k,
                                        const CUtensorMap* v, int stage,
                                        int tile, int hh, int bb) {
  using L = FwdSmem<DP>;
  const uint32_t bar = base + L::BARS + 8 * (1 + stage);
  const uint32_t dst = base + L::RING + stage * 2 * L::TILE;
  hopper::mbar_expect_tx(bar, 2 * L::TILE);
#pragma unroll
  for (int blk = 0; blk < DP / 64; ++blk) {
    hopper::tma_load_4d(dst + blk * FWD_ROWS * 128, k, bar, 64 * blk,
                        tile * FWD_ROWS, hh, bb);
    hopper::tma_load_4d(dst + L::TILE + blk * FWD_ROWS * 128, v, bar,
                        64 * blk, tile * FWD_ROWS, hh, bb);
  }
}

// grid: (batch*heads, ceil(S_q / 64)); block: one warpgroup.  The CTA owns
// queries q0 .. q0 + 63, taken from the last tile down (heaviest first
// under the causal mask), and walks the key tiles they can see.
template <int DP>
__global__ void __launch_bounds__(FWD_THREADS)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tm_q,
                const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v,
                bf16* __restrict__ o, long long o_sb, long long o_sh,
                long long o_sr, float* __restrict__ lse, int heads, int s_q,
                int s_k, int d, float scale, int causal) {
  using L = FwdSmem<DP>;
  const uint32_t base = hopper::aligned_smem_base();
  const uint32_t sQ = base;
  const int bh = blockIdx.x, hh = bh % heads, bb = bh / heads;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FWD_ROWS;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int offset = s_k - s_q;  // bottom-right causal alignment

  // key tiles this query tile needs: all, or (causal) those that start at
  // or before the last key the tile's last real row may see
  int n = (s_k + FWD_ROWS - 1) / FWD_ROWS;
  if (causal) {
    const int last_key = min(q0 + FWD_ROWS, s_q) - 1 + offset;
    n = last_key < 0 ? 0 : min(n, last_key / FWD_ROWS + 1);
  }

  if (threadIdx.x == 0) {
    for (int i = 0; i <= FWD_STAGES; ++i)
      hopper::mbar_init(base + L::BARS + 8 * i, 1);
    hopper::fence_barrier_init();
  }
  __syncthreads();
  if (threadIdx.x == 0 && n > 0) {
    hopper::mbar_expect_tx(base + L::BARS, L::TILE);
#pragma unroll
    for (int blk = 0; blk < DP / 64; ++blk)
      hopper::tma_load_4d(sQ + blk * FWD_ROWS * 128, &tm_q, base + L::BARS,
                          64 * blk, q0, hh, bb);
    for (int i = 0; i < FWD_STAGES - 1 && i < n; ++i)
      load_kv<DP>(base, &tm_k, &tm_v, i, i, hh, bb);
  }

  // online-softmax state of this thread's two rows (16 warp + g + 8 h):
  // the running max and this thread's share of the row sum (its 16 of the
  // 64 columns a tile; the quad's four shares are summed at the end)
  float m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  if (n > 0) hopper::mbar_wait(base + L::BARS, 0);

  for (int i = 0; i < n; ++i) {
    // refill the stage that iteration i - 1 read (all threads are past it)
    if (threadIdx.x == 0 && i + FWD_STAGES - 1 < n)
      load_kv<DP>(base, &tm_k, &tm_v, (i + FWD_STAGES - 1) % FWD_STAGES,
                  i + FWD_STAGES - 1, hh, bb);
    const int stage = i % FWD_STAGES;
    const uint32_t sK = base + L::RING + stage * 2 * L::TILE;
    const uint32_t sV = sK + L::TILE;
    const int k0 = i * FWD_ROWS;
    hopper::mbar_wait(base + L::BARS + 8 * (1 + stage), (i / FWD_STAGES) & 1);

    // S = Q.K^T: [64 queries, 64 keys], f32
    float s[32];
    hopper::wgmma_fence();
#pragma unroll
    for (int kd = 0; kd < DP / 16; ++kd)
      hopper::wgmma_ss<64>(s, hopper::desc_k(sQ, FWD_ROWS, kd),
                           hopper::desc_k(sK, FWD_ROWS, kd), kd > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(s);

    // scale, mask (only where a pair can be hidden) and the row max
    const bool masked = k0 + FWD_ROWS > s_k ||
                        (causal && k0 + FWD_ROWS - 1 > q0 + offset);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          float x = s[idx] * scale;
          if (masked) {
            const int qp = q0 + 16 * warp + g + 8 * h;
            const int kp = k0 + 8 * j + 2 * t4 + e;
            if (kp >= s_k || (causal && kp > qp + offset)) x = NEG_INF;
          }
          s[idx] = x;
          mx[h] = fmaxf(mx[h], x);
        }
    float corr[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      mx[h] = quad_max(mx[h]);
      corr[h] = exp2f((m[h] - mx[h]) * LOG2E);
      m[h] = mx[h];
      l[h] *= corr[h];
    }

    // p = exp(s - m) in f32 into l; a masked score gives exactly 0, also
    // on a row that has seen no key yet (m == NEG_INF)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int idx = 4 * j + 2 * h + e;
          float p = exp2f((s[idx] - m[h]) * LOG2E);
          if (masked && s[idx] <= 0.5f * NEG_INF) p = 0.f;
          l[h] += p;
          s[idx] = p;
        }
    // rounded to bf16 and repacked as the A operand of P.V
    uint32_t pa[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r)
        pa[kk][r] = hopper::pack_bf16(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]);

    // O = O * corr + P.V, B read MN-major from the V tile
    hopper::fence_operand(acc);
#pragma unroll
    for (int j = 0; j < DP / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        acc[4 * j + 2 * h] *= corr[h];
        acc[4 * j + 2 * h + 1] *= corr[h];
      }
    hopper::fence_operand(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      hopper::wgmma_rs_tb<DP>(acc, pa[kk], hopper::desc_mn(sV, FWD_ROWS, kk),
                              1);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_operand(acc);
    __syncthreads();  // this stage is free for the next load
  }

  // O / l in bf16 and the LSE, each row once; bounds-checked
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float l_safe = fmaxf(quad_sum(l[h]), 1e-20f);
    const int qp = q0 + 16 * warp + g + 8 * h;
    if (qp >= s_q) continue;
    bf16* row = o + bb * o_sb + hh * o_sh + qp * o_sr;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int c = 8 * j + 2 * t4;
      if (c < d)
        *reinterpret_cast<uint32_t*>(row + c) = hopper::pack_bf16(
            acc[4 * j + 2 * h] / l_safe, acc[4 * j + 2 * h + 1] / l_safe);
    }
    if (t4 == 0) lse[(long)bh * s_q + qp] = m[h] + logf(l_safe);
  }
}

struct Args {
  const void *q, *k, *v;
  void *o, *lse;
  // heads, then the batch, head and row strides (in elements) of q, k, v
  // and o, each with unit inner stride
  const long long* layout;
  int bh, s_q, s_k, d;
  float scale;
  int causal;
  cudaStream_t stream;
};

template <int DP>
cudaError_t launch_f32(const Args& a) {
  constexpr size_t smem = smem_bytes<DP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.bh, (a.s_q + BLOCK_Q - 1) / BLOCK_Q);
  flash_fwd_kernel<DP><<<grid, THREADS, smem, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<float*>(a.o),
      static_cast<float*>(a.lse), a.s_q, a.s_k, a.d, a.scale, a.causal);
  return cudaGetLastError();
}

// the scalar kernel reads contiguous [B*H, S, D] tensors only
cudaError_t dispatch_f32(const Args& a) {
  const long long h = a.layout[0];
  for (int i = 0; i < 4; ++i) {
    const long long rows = (i == 1 || i == 2) ? a.s_k : a.s_q;
    const long long* st = a.layout + 1 + 3 * i;
    if (st[2] != a.d || st[1] != rows * a.d || st[0] != h * rows * a.d)
      return cudaErrorInvalidValue;
  }
  if (a.d <= 32) return launch_f32<32>(a);
  if (a.d <= 64) return launch_f32<64>(a);
  return launch_f32<128>(a);
}

template <int DP>
cudaError_t launch_bf16(const Args& a) {
  const int heads = static_cast<int>(a.layout[0]), batch = a.bh / heads;
  CUtensorMap m[3];
  const void* ptr[3] = {a.q, a.k, a.v};
  const int rows[3] = {a.s_q, a.s_k, a.s_k};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t err = hopper::encode_bf16_map(
        &m[i], ptr[i], batch, heads, rows[i], a.d, a.layout + 1 + 3 * i,
        FWD_ROWS);
    if (err != cudaSuccess) return err;
  }
  constexpr int smem = FwdSmem<DP>::BYTES;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_wgmma<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const long long* os = a.layout + 10;
  const dim3 grid(a.bh, (a.s_q + FWD_ROWS - 1) / FWD_ROWS);
  flash_fwd_wgmma<DP><<<grid, FWD_THREADS, smem, a.stream>>>(
      m[0], m[1], m[2], static_cast<bf16*>(a.o), os[0], os[1], os[2],
      static_cast<float*>(a.lse), heads, a.s_q, a.s_k, a.d, a.scale,
      a.causal);
  return cudaGetLastError();
}

// bf16: any strides TMA takes (D a multiple of 8: the wrapper pads other
// head dims); O's strides multiples of 2 elements (4-byte stores)
cudaError_t dispatch_bf16(const Args& a) {
  const long long* os = a.layout + 10;
  if (a.d % 8 != 0 || os[0] % 2 || os[1] % 2 || os[2] % 2 ||
      (reinterpret_cast<uintptr_t>(a.o) & 3) != 0)
    return cudaErrorInvalidValue;
  return a.d <= 64 ? launch_bf16<64>(a) : launch_bf16<128>(a);
}

}  // namespace

// Launches the forward pass on `stream` (no synchronisation, no allocation:
// the caller owns o and lse).  q, k, v and o are [B, H, S, D] with unit
// inner stride, laid out as `layout` says (host memory: heads, then the
// batch, head and row strides in elements of q, k, v and o); f32 takes
// them contiguous only.  lse is contiguous f32 [B*H, S_q].  dtype: 0 =
// float32, 1 = bfloat16.  Returns a cudaError_t: nonzero when the
// arguments are refused or the launch failed.
extern "C" int hetu_flash_attention_fwd(const void* q, const void* k,
                                        const void* v, void* o, void* lse,
                                        const long long* layout, int bh,
                                        int s_q, int s_k, int d, float scale,
                                        int causal, int dtype, int device,
                                        void* stream) {
  if (bh <= 0 || s_q <= 0 || s_k <= 0 || d <= 0 || d > 128 ||
      (dtype != 0 && dtype != 1) || layout == nullptr || layout[0] <= 0 ||
      bh % layout[0] != 0 || (s_q + BLOCK_Q - 1) / BLOCK_Q > 65535)
    return (int)cudaErrorInvalidValue;
  // this library links its own CUDA runtime, whose current device is
  // separate from PyTorch's: select the tensors' device explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args a{q,  k,   v,   o, lse,   layout, bh,
               s_q, s_k, d,  scale, causal,
               static_cast<cudaStream_t>(stream)};
  err = dtype == 0 ? dispatch_f32(a) : dispatch_bf16(a);
  return (int)err;
}

// The bf16 kernel's CTA as built: out[0] warpgroups, out[1] the queries
// it owns, out[2] the depth of its K/V ring.
extern "C" void hetu_flash_attention_fwd_design(int* out) {
  out[0] = FWD_THREADS / 128;
  out[1] = FWD_ROWS;
  out[2] = FWD_STAGES;
}

// The runtime's name for an error code returned above.
extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
