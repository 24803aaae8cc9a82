// Block-sparse SpMM for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; pointers from tensor.data_ptr(), stream from
// torch.cuda.current_stream()).
//
// Replaces the three Pallas TPU kernels of the JAX package's ops/spmm.py:
//   spmm_csr_fwd  <- _spmm_kernel (forward) and _spmm_kernel_vx_fwd
//   spmm_csc_t    <- _spmm_kernel (transpose) and _spmm_kernel_vx_t
// The TPU needed two families (x streamed from HBM, or resident in VMEM) and
// 1024-entry metadata chunks for its DMA engine; here every block reads its
// own indices and x rows straight from device memory (L2 keeps the hot x
// rows), so one kernel per direction covers all three.
//
// Storage (shared by both directions, no transposed copy):
//   blocks      [n_blocks, br, bc] f32, CSR tile order
//   block_cols  [n_blocks]  column tile of each stored tile (CSR order)
//   row_ptr     [n_row_tiles + 1]
//   col_ptr     [n_col_tiles + 1]  CSC over the same tiles
//   block_ids   [n_blocks]  CSC entry -> index into blocks
//   block_rows  [n_blocks]  row tile of each CSC entry
//   seg_tile, seg_start [n_seg], col_seg_ptr [n_col_tiles + 1]: each CSC
//     range cut into segments of at most seg_len entries (at least one
//     segment per column tile, so empty column tiles are written too)
//
// Bound: bytes. The graphs this serves fill their tiles sparsely (about 11
// nonzeros in an 8 x 128 tile on a power-law user x item graph), so the
// least time is the stored tiles + the x rows they touch + the output over
// HBM bandwidth; the products themselves are 2 * nnz * D flops. Both kernels
// therefore read each tile row once, coalesced, and spend arithmetic only
// on nonzero entries: a warp ballot over 32 tile entries finds them, and
// only their x rows are read. A zero tile entry contributes nothing, so the
// result equals the dense tile product for finite x.
//
// spmm_csr_fwd: one block per (row tile, 64-column slice of D); warp w owns
//   tile rows w, w + 8, ... and walks the row tile's CSR range, prefetching
//   the next tile's row while it works on the current one. No shared memory
//   and no block barrier.
// spmm_csc_t: one block per (CSC segment, 64-column slice); thread j owns
//   output row j of the column tile and keeps its 64 sums in registers. On
//   power-law graphs a hot column tile spans every row tile (13,603 at the
//   Amazon-Book size), so one block per column tile would serialise a fifth
//   of the work; segments spread it over many blocks. A column tile with one
//   segment writes y directly; longer ones write per-segment partials that
//   spmm_csc_t_reduce sums in segment order, so the result is deterministic.
//
// Offsets into blocks, x, y and the partials are 64-bit: at the 8 GiB format
// guard n_blocks * br * bc reaches 2^31.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kFwdWarps = 8;
constexpr int kFwdThreads = kFwdWarps * kWarp;
constexpr int kDSlice = 64;                  // output columns per block
constexpr int kMaxTile = 128;                // br, bc <= 128
constexpr int kChunks = kMaxTile / kWarp;    // tile-row chunks of 32 entries
constexpr int kTThreads = kMaxTile;          // one thread per output row
constexpr int kRowGroup = 8;                 // tile rows loaded together
constexpr int kReduceThreads = 256;
constexpr int kReduceSpan = 1024;            // outputs per reduce block
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void load_tile_row(const float* __restrict__ row,
                                              int bc, int lane,
                                              float (&a)[kChunks]) {
#pragma unroll
  for (int q = 0; q < kChunks; ++q) {
    const int j = q * kWarp + lane;
    a[q] = j < bc ? __ldg(row + j) : 0.f;
  }
}

// y[rt*br + r, d0 + c] = sum_k sum_j tile_k[r, j] * x[cb_k*bc + j, d0 + c]
__global__ void __launch_bounds__(kFwdThreads)
spmm_csr_fwd_kernel(const float* __restrict__ blocks,
                    const int* __restrict__ block_cols,
                    const int* __restrict__ row_ptr,
                    const float* __restrict__ x, float* __restrict__ y,
                    int br, int bc, int d, long long n_x) {
  const int rt = blockIdx.x;
  const int d0 = blockIdx.y * kDSlice;
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
  const int c0 = d0 + lane;
  const int c1 = d0 + kWarp + lane;
  const bool ok0 = c0 < d;
  const bool ok1 = c1 < d;
  const long long tile_elems = (long long)br * bc;
  const int start = row_ptr[rt];
  const int stop = row_ptr[rt + 1];

  for (int r = warp; r < br; r += kFwdWarps) {
    float acc0 = 0.f, acc1 = 0.f;
    float a[kChunks] = {}, an[kChunks] = {};
    if (start < stop)
      load_tile_row(blocks + start * tile_elems + (long long)r * bc, bc,
                    lane, a);
    for (int k = start; k < stop; ++k) {
      if (k + 1 < stop)   // prefetch the next tile's row
        load_tile_row(blocks + (k + 1) * tile_elems + (long long)r * bc, bc,
                      lane, an);
      const long long xr0 = (long long)block_cols[k] * bc;
#pragma unroll
      for (int q = 0; q < kChunks; ++q) {
        unsigned mask = __ballot_sync(kFull, a[q] != 0.f);
        while (mask) {
          const int b = __ffs(mask) - 1;
          mask &= mask - 1;
          const float av = __shfl_sync(kFull, a[q], b);
          const long long xr = xr0 + q * kWarp + b;
          // x may hold fewer rows than the padded tile grid
          if (xr < n_x) {
            const float* xrow = x + xr * d;
            if (ok0) acc0 = fmaf(av, __ldg(xrow + c0), acc0);
            if (ok1) acc1 = fmaf(av, __ldg(xrow + c1), acc1);
          }
        }
      }
#pragma unroll
      for (int q = 0; q < kChunks; ++q) a[q] = an[q];
    }
    float* yrow = y + ((long long)rt * br + r) * d;
    if (ok0) yrow[c0] = acc0;
    if (ok1) yrow[c1] = acc1;
  }
}

// acc[c] += a * x[xr, d0 + c] for the block's slice of D
template <bool kVec>
__device__ __forceinline__ void axpy_row(const float* __restrict__ xrow,
                                         float a, int n_valid,
                                         float (&acc)[kDSlice]) {
  if (kVec) {   // d % 4 == 0: 16-byte loads, all lanes read the same row
    const float4* x4 = reinterpret_cast<const float4*>(xrow);
#pragma unroll
    for (int c = 0; c < kDSlice; c += 4) {
      if (c < n_valid) {
        const float4 v = __ldg(x4 + c / 4);
        acc[c] = fmaf(a, v.x, acc[c]);
        acc[c + 1] = fmaf(a, v.y, acc[c + 1]);
        acc[c + 2] = fmaf(a, v.z, acc[c + 2]);
        acc[c + 3] = fmaf(a, v.w, acc[c + 3]);
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kDSlice; ++c)
      if (c < n_valid) acc[c] = fmaf(a, __ldg(xrow + c), acc[c]);
  }
}

// y[ct*bc + j, d0 + c] = sum_k sum_i tile_k[i, j] * x[rt_k*br + i, d0 + c]
// over one segment of column tile ct's CSC range (tile_k =
// blocks[block_ids[k]]).
template <bool kVec>
__global__ void __launch_bounds__(kTThreads)
spmm_csc_t_kernel(const float* __restrict__ blocks,
                  const int* __restrict__ block_ids,
                  const int* __restrict__ block_rows,
                  const int* __restrict__ col_ptr,
                  const int* __restrict__ seg_tile,
                  const int* __restrict__ seg_start,
                  const int* __restrict__ col_seg_ptr,
                  const float* __restrict__ x, float* __restrict__ y,
                  float* __restrict__ part, int br, int bc, int d,
                  long long n_x, int seg_len) {
  __shared__ float out_s[kDSlice][kTThreads];
  const int s = blockIdx.x;
  const int d0 = blockIdx.y * kDSlice;
  const int j = threadIdx.x;
  const int n_valid = min(kDSlice, d - d0);
  const int ct = seg_tile[s];
  const int k0 = seg_start[s];
  const int k1 = min(k0 + seg_len, col_ptr[ct + 1]);
  const long long tile_elems = (long long)br * bc;
  float acc[kDSlice];
#pragma unroll
  for (int c = 0; c < kDSlice; ++c) acc[c] = 0.f;

  for (int k = k0; k < k1; ++k) {
    const float* tile = blocks + (long long)block_ids[k] * tile_elems + j;
    const long long xr0 = (long long)block_rows[k] * br;
    for (int i0 = 0; i0 < br; i0 += kRowGroup) {
      float a[kRowGroup];
#pragma unroll
      for (int u = 0; u < kRowGroup; ++u)
        a[u] = (j < bc && i0 + u < br) ? __ldg(tile + (long long)(i0 + u) * bc)
                                       : 0.f;
#pragma unroll
      for (int u = 0; u < kRowGroup; ++u) {
        const long long xr = xr0 + i0 + u;
        if (a[u] != 0.f && xr < n_x)
          axpy_row<kVec>(x + xr * d + d0, a[u], n_valid, acc);
      }
    }
  }

  // stage through shared memory so the [bc, 64] slice is written coalesced
#pragma unroll
  for (int c = 0; c < kDSlice; ++c) out_s[c][j] = acc[c];
  __syncthreads();
  const bool single = col_seg_ptr[ct + 1] - col_seg_ptr[ct] == 1;
  float* out = single ? y + (long long)ct * bc * d
                      : part + (long long)s * bc * d;
  for (int e = threadIdx.x; e < bc * kDSlice; e += kTThreads) {
    const int row = e / kDSlice;
    const int c = e % kDSlice;
    if (c < n_valid) out[(long long)row * d + d0 + c] = out_s[c][row];
  }
}

// y[ct] = sum of its segments' partials, in segment order
__global__ void __launch_bounds__(kReduceThreads)
spmm_csc_t_reduce_kernel(const int* __restrict__ col_seg_ptr,
                         const float* __restrict__ part,
                         float* __restrict__ y, int bc, int d) {
  const int ct = blockIdx.x;
  const int s0 = col_seg_ptr[ct];
  const int s1 = col_seg_ptr[ct + 1];
  if (s1 - s0 < 2) return;
  const long long n = (long long)bc * d;
  const long long e0 = (long long)blockIdx.y * kReduceSpan;
  const long long e1 = min(n, e0 + kReduceSpan);
  for (long long e = e0 + threadIdx.x; e < e1; e += kReduceThreads) {
    float acc = 0.f;
    for (int s = s0; s < s1; ++s) acc += part[(long long)s * n + e];
    y[(long long)ct * n + e] = acc;
  }
}

int check_shape(int br, int bc, int d) {
  if (br <= 0 || bc <= 0 || br > kMaxTile || bc > kMaxTile || d <= 0)
    return (int)cudaErrorInvalidValue;
  return 0;
}

}  // namespace

extern "C" {

// Every entry point returns a cudaError_t value (0 on success), checked
// right after each launch: a refused launch never runs, and a later
// synchronize would not report it. Launches go on the caller's stream
// (PyTorch's current stream) on the caller's current device.

int gdmcf_spmm_csr_fwd(const float* blocks, const int* block_cols,
                       const int* row_ptr, const float* x, float* y,
                       int n_row_tiles, int br, int bc, int d, long long n_x,
                       void* stream) {
  int err = check_shape(br, bc, d);
  if (err) return err;
  if (n_row_tiles <= 0) return 0;
  dim3 grid(n_row_tiles, (d + kDSlice - 1) / kDSlice);
  spmm_csr_fwd_kernel<<<grid, kFwdThreads, 0, (cudaStream_t)stream>>>(
      blocks, block_cols, row_ptr, x, y, br, bc, d, n_x);
  return (int)cudaGetLastError();
}

// part: [n_seg, bc, d] f32 scratch, read only when n_seg > n_col_tiles
int gdmcf_spmm_csc_t(const float* blocks, const int* block_ids,
                     const int* block_rows, const int* col_ptr,
                     const int* seg_tile, const int* seg_start,
                     const int* col_seg_ptr, const float* x, float* y,
                     float* part, int n_col_tiles, int n_seg, int seg_len,
                     int br, int bc, int d, long long n_x, void* stream) {
  int err = check_shape(br, bc, d);
  if (err) return err;
  if (n_seg <= 0) return 0;
  if (seg_len <= 0 || n_seg < n_col_tiles ||
      (n_seg > n_col_tiles && part == nullptr))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  dim3 grid(n_seg, (d + kDSlice - 1) / kDSlice);
  // 16-byte x loads need d % 4 == 0 and a 16-byte aligned x
  if (d % 4 == 0 && (reinterpret_cast<std::uintptr_t>(x) & 15) == 0)
    spmm_csc_t_kernel<true><<<grid, kTThreads, 0, st>>>(
        blocks, block_ids, block_rows, col_ptr, seg_tile, seg_start,
        col_seg_ptr, x, y, part, br, bc, d, n_x, seg_len);
  else
    spmm_csc_t_kernel<false><<<grid, kTThreads, 0, st>>>(
        blocks, block_ids, block_rows, col_ptr, seg_tile, seg_start,
        col_seg_ptr, x, y, part, br, bc, d, n_x, seg_len);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || n_seg == n_col_tiles) return (int)e;
  const long long n = (long long)bc * d;
  dim3 rgrid(n_col_tiles, (unsigned)((n + kReduceSpan - 1) / kReduceSpan));
  spmm_csc_t_reduce_kernel<<<rgrid, kReduceThreads, 0, st>>>(
      col_seg_ptr, part, y, bc, d);
  return (int)cudaGetLastError();
}

const char* gdmcf_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
