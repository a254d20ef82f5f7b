// Row gather and its scatter-add gradient for NVIDIA Hopper (sm_90a).
//
// Replaces two TPU kernels of hetu_tpu/ops/pallas_kernels/embedding.py:
//
// * `_gather_kernel` (op `embedding_gather`): out[i] = table[ids[i]], and a
//   zero row where ids[i] < 0 or ids[i] >= V.  The TPU kernel streams one
//   row per grid step by scalar-prefetch DMA from a clamped id and masks the
//   invalid rows afterwards; here the bounds check and the zero fill are one
//   pass.
// * `_scatter_kernel` (op `embedding_scatter_add`): the gather's gradient,
//   out[r] = sum of grads[i] over the i with ids[i] == r, zeros where no id
//   hits r, invalid ids dropped.  The kernel writes every destination row
//   exactly once: the sum of its source rows, taken in f32 in ascending
//   order of position i and rounded once to the output type, or zeros.  No
//   atomics touch the gradient rows, so the result is deterministic: the
//   same bits on every run, whatever the duplicates.  A row finds its
//   sources in one of two ways (one kernel template, two source modes):
//   - sorted (CSR): `perm`, the stable sort order of the ids, and
//     `offsets`, row r's segment perm[offsets[r]:offsets[r+1]], both made
//     by PyTorch in the wrapper, as the reference sorts its ids first;
//   - inverse (fixed stride m): `inverse` [num_rows, m], row r's positions
//     padded with -1.  The MoE routing builds both directions of its map
//     anyway (a token's k slots, a slot's one route), so its gradients
//     need no sort at all.
//
// What bounds them on an H100.  Both are row copies with no arithmetic to
// speak of: bytes over the 3.35 TB/s of HBM3.  The MoE training step's
// largest calls move 50-150 MB each (tens of microseconds): the combine
// gather reads 32768 rows of 2 KB and writes as many; the combine gradient
// reads 32768 f32 rows and writes 40960.
//
// What the design does about it.  One warp per output row, 8 rows to a
// 256-thread block, so thousands of rows are in flight across the 132 SMs
// (each SM holds 64 warps).  A row moves in 16-byte vectors, neighbouring
// lanes on neighbouring addresses, when its byte length and the base
// pointers allow it (every row of a D = 512 bf16 or f32 table), else in the
// widest of 8, 4 or 2 bytes that does: the same code serves any D.  The
// gather copies bytes and never converts, so its result is bitwise the
// table's.  The scatter's lanes each own a slice of the columns.  In the
// sorted mode they walk the segment's rows in sorted order, reading the
// gradient rows through the permutation (a dependent chain: offsets, then
// perm[j], then the row).  In the inverse mode every lane loads the row's m
// positions once (one broadcast load each), orders them ascending in
// registers (an odd-even transposition network; padding sorts last), so
// the sum runs in the sorted mode's order, and then starts the 16-byte
// loads of up to 8 source rows, and of up to four column slices, before
// the first add: at least 4 loads in flight a lane with no dependent index
// load between them.  With m = 1 (the combine's gradient) that is a
// permuted copy with zero fill.  A row with no source stores zeros: the
// zero fill costs no extra pass.
//
// Build:  nvcc -gencode arch=compute_90a,code=sm_90a -O3 -shared
//              -Xcompiler -fPIC -o libembedding.so embedding.cu
// The extern "C" launchers below are bound with ctypes by
// hetu_tpu_torch/ops/cuda_kernels/embedding.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <climits>
#include <stdint.h>

namespace {

constexpr int WARP = 32;
constexpr int ROWS_PER_BLOCK = 8;              // one warp per row
constexpr int THREADS = WARP * ROWS_PER_BLOCK;  // 256

// ------------------------------------------------------------------ gather

// Copies rows of `width` vectors of type Vec (16, 8, 4 or 2 bytes).
template <typename Vec>
__global__ void __launch_bounds__(THREADS)
gather_kernel(const Vec* __restrict__ table, const int* __restrict__ ids,
              Vec* __restrict__ out, int n, int v, int width) {
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (row >= n) return;
  const int id = ids[row];
  Vec* dst = out + static_cast<size_t>(row) * width;
  if (id < 0 || id >= v) {
    const Vec zero{};
    for (int c = lane; c < width; c += WARP) dst[c] = zero;
    return;
  }
  const Vec* src = table + static_cast<size_t>(id) * width;
  for (int c = lane; c < width; c += WARP) dst[c] = __ldg(src + c);
}

template <typename Vec>
cudaError_t launch_gather(const void* table, const int* ids, void* out,
                          int n, int v, int row_bytes, cudaStream_t stream) {
  const int blocks = (n + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  gather_kernel<Vec><<<blocks, THREADS, 0, stream>>>(
      static_cast<const Vec*>(table), ids, static_cast<Vec*>(out), n, v,
      row_bytes / static_cast<int>(sizeof(Vec)));
  return cudaGetLastError();
}

// The widest vector (16, 8, 4 or 2 bytes) that divides the row length and
// both base addresses, so every row of the table and of the output starts
// on its boundary.
int vector_bytes(int row_bytes, const void* a, const void* b) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(a) |
                         reinterpret_cast<uintptr_t>(b);
  for (int w = 16; w > 2; w /= 2)
    if (row_bytes % w == 0 && addr % w == 0) return w;
  return 2;
}

// ------------------------------------------------------------- scatter-add

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

// out[r] (r < num_rows, D = width * VEC elements of type T) = the f32 sum,
// in ascending order of position, of row r's source rows of grads, rounded
// once to T; zeros for a row with no source.  MAXM = 0: the sorted mode,
// sources grads[perm[j]] for j in [offsets[r], offsets[r+1]).  MAXM > 0:
// the inverse mode, sources grads[inverse[r * m + q]] for q < m <= MAXM,
// entries outside [0, n_src) skipped.
template <typename T, int VEC, int MAXM>
__global__ void __launch_bounds__(THREADS)
scatter_add_kernel(const T* __restrict__ grads, const int* __restrict__ index,
                   const int* __restrict__ offsets, T* __restrict__ out,
                   int num_rows, int width, int m, int n_src) {
  using P = Pack<T, VEC>;
  const int row = blockIdx.x * ROWS_PER_BLOCK + threadIdx.x / WARP;
  const int lane = threadIdx.x % WARP;
  if (row >= num_rows) return;
  const P* src = reinterpret_cast<const P*>(grads);
  P* dst = reinterpret_cast<P*>(out) + static_cast<size_t>(row) * width;
  if constexpr (MAXM == 0) {
    const int begin = offsets[row], end = offsets[row + 1];
    for (int c = lane; c < width; c += WARP) {
      float acc[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[e] = 0.0f;
      for (int j = begin; j < end; ++j) {
        const P g = src[static_cast<size_t>(index[j]) * width + c];
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[e] += to_float(g.x[e]);
      }
      P o;
#pragma unroll
      for (int e = 0; e < VEC; ++e) o.x[e] = from_float<T>(acc[e]);
      dst[c] = o;
    }
  } else {
    // the row's positions, ascending, padding (INT_MAX) last
    int pos[MAXM];
#pragma unroll
    for (int q = 0; q < MAXM; ++q) {
      const int i = q < m ? index[static_cast<size_t>(row) * m + q] : -1;
      pos[q] = (i >= 0 && i < n_src) ? i : INT_MAX;
    }
#pragma unroll
    for (int round = 0; round < MAXM; ++round) {
#pragma unroll
      for (int q = round & 1; q + 1 < MAXM; q += 2) {
        const int lo = min(pos[q], pos[q + 1]);
        pos[q + 1] = max(pos[q], pos[q + 1]);
        pos[q] = lo;
      }
    }
    // U column slices of up to 8 source rows loaded together: at least
    // four 16-byte loads in flight a lane, and registers bounded for any m
    constexpr int U = MAXM >= 4 ? 1 : 4 / MAXM;
    constexpr int B = MAXM < 8 ? MAXM : 8;
    for (int c0 = lane; c0 < width; c0 += WARP * U) {
      float acc[U][VEC];
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[u][e] = 0.0f;
#pragma unroll
      for (int q0 = 0; q0 < MAXM; q0 += B) {
        P g[U][B];
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int c = c0 + u * WARP;
#pragma unroll
          for (int q = 0; q < B; ++q)
            if (c < width && pos[q0 + q] != INT_MAX)
              g[u][q] = src[static_cast<size_t>(pos[q0 + q]) * width + c];
        }
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int q = 0; q < B; ++q)
            if (c0 + u * WARP < width && pos[q0 + q] != INT_MAX) {
#pragma unroll
              for (int e = 0; e < VEC; ++e)
                acc[u][e] += to_float(g[u][q].x[e]);
            }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int c = c0 + u * WARP;
        if (c < width) {
          P o;
#pragma unroll
          for (int e = 0; e < VEC; ++e) o.x[e] = from_float<T>(acc[u][e]);
          dst[c] = o;
        }
      }
    }
  }
}

template <typename T, int VEC, int MAXM>
cudaError_t launch_scatter(const void* grads, const int* index,
                           const int* offsets, void* out, int num_rows, int d,
                           int m, int n_src, cudaStream_t stream) {
  const int blocks = (num_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  scatter_add_kernel<T, VEC, MAXM><<<blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(grads), index, offsets, static_cast<T*>(out),
      num_rows, d / VEC, m, n_src);
  return cudaGetLastError();
}

// The inverse mode's instance for m: the smallest MAXM in 1, 2, 4, ..., 32
// that holds it.
template <typename T, int VEC>
cudaError_t launch_inverse(const void* grads, const int* inverse, void* out,
                           int num_rows, int d, int m, int n_src,
                           cudaStream_t stream) {
#define HETU_INVERSE(M)                                                     \
  if (m <= M)                                                              \
    return launch_scatter<T, VEC, M>(grads, inverse, nullptr, out,         \
                                     num_rows, d, m, n_src, stream);
  HETU_INVERSE(1) HETU_INVERSE(2) HETU_INVERSE(4) HETU_INVERSE(8)
  HETU_INVERSE(16) HETU_INVERSE(32)
#undef HETU_INVERSE
  return cudaErrorInvalidValue;
}

// 16-byte packs where D and both base addresses allow, else one element;
// `inverse` null: the sorted mode on perm/offsets.
template <typename T>
cudaError_t dispatch_scatter(const void* grads, const int* perm,
                             const int* offsets, const int* inverse,
                             void* out, int num_rows, int d, int m, int n_src,
                             cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  if (vector_bytes(d * static_cast<int>(sizeof(T)), grads, out) == 16) {
    if (inverse)
      return launch_inverse<T, VEC>(grads, inverse, out, num_rows, d, m,
                                    n_src, stream);
    return launch_scatter<T, VEC, 0>(grads, perm, offsets, out, num_rows, d,
                                     0, 0, stream);
  }
  if (inverse)
    return launch_inverse<T, 1>(grads, inverse, out, num_rows, d, m, n_src,
                                stream);
  return launch_scatter<T, 1, 0>(grads, perm, offsets, out, num_rows, d, 0, 0,
                                 stream);
}

}  // namespace

// table [v, row_bytes] (any element type), ids [n] int32 -> out [n,
// row_bytes]; ids outside [0, v) give zero rows.  Returns a cudaError_t.
extern "C" int hetu_embedding_gather(const void* table, const int* ids,
                                     void* out, int n, int v, int row_bytes,
                                     int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vector_bytes(row_bytes, table, out)) {
    case 16: err = launch_gather<uint4>(table, ids, out, n, v, row_bytes, s);
      break;
    case 8: err = launch_gather<uint2>(table, ids, out, n, v, row_bytes, s);
      break;
    case 4: err = launch_gather<unsigned>(table, ids, out, n, v, row_bytes, s);
      break;
    default:
      err = launch_gather<unsigned short>(table, ids, out, n, v, row_bytes, s);
  }
  return (int)err;
}

// The sorted mode.  grads [*, d] of dtype 0 = f32 or 1 = bf16, perm [*]
// int32 (the stable sort order of the ids), offsets [num_rows + 1] int32
// (row r's segment of the sorted order) -> out [num_rows, d].  Returns a
// cudaError_t.
extern "C" int hetu_embedding_scatter_add(const void* grads, const int* perm,
                                          const int* offsets, void* out,
                                          int num_rows, int d, int dtype,
                                          int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_scatter<float>(grads, perm, offsets, nullptr, out,
                                  num_rows, d, 0, 0, s);
  else
    err = dispatch_scatter<__nv_bfloat16>(grads, perm, offsets, nullptr, out,
                                          num_rows, d, 0, 0, s);
  return (int)err;
}

// The inverse mode.  grads [n_src, d] of dtype 0 = f32 or 1 = bf16,
// inverse [num_rows, m] int32 (row r's positions in grads, -1 padding;
// m <= 32) -> out [num_rows, d].  Returns a cudaError_t.
extern "C" int hetu_embedding_scatter_add_inverse(
    const void* grads, const int* inverse, void* out, int num_rows, int m,
    int n_src, int d, int dtype, int device, void* stream) {
  if (m < 0 || m > 32) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    err = dispatch_scatter<float>(grads, nullptr, nullptr, inverse, out,
                                  num_rows, d, m, n_src, s);
  else
    err = dispatch_scatter<__nv_bfloat16>(grads, nullptr, nullptr, inverse,
                                          out, num_rows, d, m, n_src, s);
  return (int)err;
}

extern "C" const char* hetu_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
