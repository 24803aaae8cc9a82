// Row-gather SpMM for Hopper (sm_90a), bound to Python through a plain C
// interface (ctypes; pointers from tensor.data_ptr(), stream from
// torch.cuda.current_stream()).
//
// One kernel, spmm_rows, for both directions of the LightGCN products. It
// replaces the Pallas TPU kernels of the JAX package's ops/spmm.py,
//   _spmm_kernel (K2, forward and transpose), _spmm_kernel_vx_fwd (K3) and
//   _spmm_kernel_vx_t (K4),
// and the COO remainder pass of its hybrid_spmm (a gather and a scatter-add).
// The TPU streams dense 8 x 128 tiles to its matrix unit and wants a
// 128-lane scatter, so the JAX package splits a graph into tiles and a COO
// remainder; on a power-law user x item graph the tiles are about 1% full.
// Here the operand holds only the nonzeros, tiles and remainder alike, and
// one launch computes the whole product.
//
// Operand (one per direction, built on the host by ops/spmm.py; the
// transpose direction is the CSR of A^T, so both are the same gather):
//   cols, vals    [nnz]        x row and value of each nonzero, in the
//                              schedule's order: each segment a range
//   seg_ptr       [n_seg + 1]  segment s is [seg_ptr[s], seg_ptr[s + 1]),
//   seg_row       [n_seg]      at most seg_len nonzeros of row seg_row[s];
//                              every row has at least one (so an empty row
//                              is written as zeros)
//   seg_part      [n_seg]      partial slot of a segment of a row of several
//                              segments, -1 for a row of one
//   row_part_ptr  [n_out + 1]  the partial slots of each row: [row_part_ptr
//                              [r], row_part_ptr[r + 1]), none for a row of
//                              one segment
//
//   y[r, :] = sum_k vals[k] * x[cols[k], :] over row r's segments.
//
// Bound: gathers. At D = 64 a nonzero costs 2 * 64 flops against a 256-byte
// x row, so the tensor cores have nothing to do; the least time is the
// nonzeros (8 bytes each, value and column), the segment arrays, x and y
// once over HBM, but every nonzero reads a whole x row: 20M nonzeros gather
// 5 GB a launch. Where x fits in the 50 MB L2 (the Amazon-Book tables, 24
// to 28 MB; the item table of a 1M x 200k graph, whose gathers fall 90% in
// its 31 MB of popular rows) the gathers come from L2 after the first
// touch. Where they spread wider (that graph's 256 MB user table, 90% of
// the gathers over 206 MB of it) most would come from HBM at the rate of
// random 256-byte reads, so the host schedules the operand in slabs
// (ops/spmm.py decides from the operand and the card's L2): x's rows are
// cut into slabs of a fixed share of the L2, each row longer than a
// segment is cut at the slab boundaries of its columns, and the pieces run
// slab-major, so the warps in flight gather from one slab and x is read
// from HBM about once a launch. Its price is one partial (d floats written
// and read back) for each piece of a cut row; a row of one segment is not
// cut (pieces of a few nonzeros would cost a warp each), and these rows
// run whole after the last slab. What the kernel does about the rest:
//   - one warp per segment, eight warps per block, no shared memory and no
//     block barrier; its segment's bounds, row and partial slot are four
//     independent loads, so the first gathers wait on two load latencies;
//   - the warp reads its segment's cols and vals 32 at a time, coalesced,
//     and hands each nonzero out with shuffles;
//   - a half-warp gathers one 64-wide x row as 16 float4 loads, so a warp
//     takes two nonzeros at a time, and kUnroll = 2 pairs are loaded before
//     any is used. Most rows are short (20 nonzeros on average, 6 in the
//     tiles alone), so what hides the latency is warps, not unrolling: the
//     kernel is held to 40 registers so that 48 warps fit on an SM;
//   - D > 64 is walked in 64-wide slices; D % 4 != 0 or an unaligned x
//     takes a scalar path (a lane per column, kUnroll nonzeros in flight);
//   - a hot row (a popular item has 273,554 nonzeros in the 1M x 200k
//     graph's A^T) is spread over many warps by its segments. A row of one
//     segment writes y directly; a longer row's segments write partials,
//     and the warp that finishes last (an integer counter per row) sums
//     them in slot order, which the host gives in slab order. No float
//     atomics: two launches on the same inputs give bitwise equal output.
//     Slabbed, every cut row's last piece runs in the last slab, so these
//     sums come at the end of the slabs, beside the short rows' work.
// Columns at or past n_x read as zero (x may be shorter than the grid).
// Offsets into x, y and the partials are 64-bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kWarp = 32;
constexpr int kWarps = 8;                // warps (segments) per block
constexpr int kThreads = kWarps * kWarp;
constexpr int kMinBlocks = 6;            // resident blocks per SM: <= 40
                                         // registers, 48 warps
constexpr int kDSlice = 64;              // output columns per pass
constexpr int kUnroll = 2;               // gathers in flight per lane
constexpr unsigned kFull = 0xffffffffu;

// Lane l takes nonzero base + l of [base, stop): its x row, or -1 (value
// 0) past the end or for an x row at or past n_x.
__device__ __forceinline__ int load_chunk(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          int base, int stop, long long n_x,
                                          int lane, float& val) {
  int col = -1;
  val = 0.f;
  if (lane < stop - base) {
    col = __ldg(cols + base + lane);
    val = __ldg(vals + base + lane);
    if (col >= n_x) {
      col = -1;
      val = 0.f;
    }
  }
  return col;
}

// out[c] = sum over [k0, k1) of vals[k] * x[cols[k], c] for c in
// [d0, d0 + 64), 16-byte loads (d % 4 == 0): half-warp h takes nonzeros
// h, h + 2, ... of each chunk of 32, lane q of a half-warp columns
// d0 + 4q .. d0 + 4q + 3, and the two halves add up at the end.
__device__ __forceinline__ void slice_vec(const int* __restrict__ cols,
                                          const float* __restrict__ vals,
                                          int k0, int k1,
                                          const float* __restrict__ x,
                                          long long n_x, int d, int d0,
                                          int lane, float* out) {
  const int half = lane >> 4;
  const int c = d0 + 4 * (lane & 15);
  const bool ok = c < d;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int base = k0; base < k1; base += kWarp) {
    float val;
    const int col = load_chunk(cols, vals, base, k1, n_x, lane, val);
    const int n = min(kWarp, k1 - base);
    for (int j0 = 0; j0 < n; j0 += 2 * kUnroll) {
      float a[kUnroll];
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int j = j0 + 2 * u + half;   // <= 31: j0 <= 32 - 2 * kUnroll
        const int cj = __shfl_sync(kFull, col, j);
        a[u] = __shfl_sync(kFull, val, j);
        v[u] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (ok && cj >= 0)
          v[u] = __ldg(reinterpret_cast<const float4*>(
              x + (long long)cj * d + c));
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc.x = fmaf(a[u], v[u].x, acc.x);
        acc.y = fmaf(a[u], v[u].y, acc.y);
        acc.z = fmaf(a[u], v[u].z, acc.z);
        acc.w = fmaf(a[u], v[u].w, acc.w);
      }
    }
  }
  acc.x += __shfl_xor_sync(kFull, acc.x, 16);
  acc.y += __shfl_xor_sync(kFull, acc.y, 16);
  acc.z += __shfl_xor_sync(kFull, acc.z, 16);
  acc.w += __shfl_xor_sync(kFull, acc.w, 16);
  if (half == 0 && ok) *reinterpret_cast<float4*>(out + c) = acc;
}

// The same sum with 4-byte loads: lane l owns columns d0 + l and
// d0 + 32 + l, and the warp takes one nonzero at a time.
__device__ __forceinline__ void slice_scalar(const int* __restrict__ cols,
                                             const float* __restrict__ vals,
                                             int k0, int k1,
                                             const float* __restrict__ x,
                                             long long n_x, int d, int d0,
                                             int lane, float* out) {
  const int c0 = d0 + lane;
  const int c1 = d0 + kWarp + lane;
  const bool ok0 = c0 < d;
  const bool ok1 = c1 < d;
  float acc0 = 0.f, acc1 = 0.f;
  for (int base = k0; base < k1; base += kWarp) {
    float val;
    const int col = load_chunk(cols, vals, base, k1, n_x, lane, val);
    const int n = min(kWarp, k1 - base);
    for (int j0 = 0; j0 < n; j0 += kUnroll) {
      float a[kUnroll], v0[kUnroll], v1[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int cj = __shfl_sync(kFull, col, j0 + u);   // j0 + u <= 31
        a[u] = __shfl_sync(kFull, val, j0 + u);
        v0[u] = v1[u] = 0.f;
        if (cj >= 0) {
          const float* xrow = x + (long long)cj * d;
          if (ok0) v0[u] = __ldg(xrow + c0);
          if (ok1) v1[u] = __ldg(xrow + c1);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        acc0 = fmaf(a[u], v0[u], acc0);
        acc1 = fmaf(a[u], v1[u], acc1);
      }
    }
  }
  if (ok0) out[c0] = acc0;
  if (ok1) out[c1] = acc1;
}

// One warp per segment.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
spmm_rows_kernel(const int* __restrict__ cols,
                 const float* __restrict__ vals,
                 const int* __restrict__ seg_ptr,
                 const int* __restrict__ seg_row,
                 const int* __restrict__ seg_part,
                 const int* __restrict__ row_part_ptr,
                 const float* __restrict__ x, float* y, float* part,
                 int* count, int n_seg, int d, long long n_x) {
  const int s = blockIdx.x * kWarps + threadIdx.x / kWarp;
  if (s >= n_seg) return;
  const int lane = threadIdx.x % kWarp;
  const int k0 = seg_ptr[s];
  const int k1 = seg_ptr[s + 1];
  const int row = seg_row[s];
  const int slot = seg_part[s];
  float* out = slot < 0 ? y + (long long)row * d
                        : part + (long long)slot * d;
  for (int d0 = 0; d0 < d; d0 += kDSlice) {
    if (kVec)
      slice_vec(cols, vals, k0, k1, x, n_x, d, d0, lane, out);
    else
      slice_scalar(cols, vals, k0, k1, x, n_x, d, d0, lane, out);
  }
  if (slot < 0) return;

  // the row's last segment to finish sums its partials, in slot order
  const int p0 = row_part_ptr[row];
  const int n_part = row_part_ptr[row + 1] - p0;
  __threadfence();
  __syncwarp();
  int done = 0;
  if (lane == 0) done = atomicAdd(count + p0, 1);
  done = __shfl_sync(kFull, done, 0);
  if (done != n_part - 1) return;
  __threadfence();
  float* yrow = y + (long long)row * d;
  for (int c = lane; c < d; c += kWarp) {
    float acc = 0.f;
    for (int p = 0; p < n_part; ++p)
      acc += __ldcg(part + (long long)(p0 + p) * d + c);
    yrow[c] = acc;
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<std::uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" {

// Returns a cudaError_t value (0 on success), checked right after the
// launch: a refused launch never runs, and a later synchronize would not
// report it. The launch goes on the caller's stream (PyTorch's current
// stream) on the caller's current device.
//
// part: [n_part, d] f32 scratch, count: [n_part] int32 zeros; both only
// when some row has several segments (n_part > 0).
int gdmcf_spmm_rows(const int* cols, const float* vals, const int* seg_ptr,
                    const int* seg_row, const int* seg_part,
                    const int* row_part_ptr, const float* x, float* y,
                    float* part, int* count, int n_seg, int n_part, int d,
                    long long n_x, void* stream) {
  if (n_seg < 0 || n_part < 0 || d <= 0 || n_x < 0 ||
      (n_part > 0 && (part == nullptr || count == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (n_seg == 0) return 0;
  const cudaStream_t st = (cudaStream_t)stream;
  // 16-byte loads and stores need d % 4 == 0 and 16-byte aligned rows
  const bool vec = d % 4 == 0 && aligned16(x) && aligned16(y) &&
                   (part == nullptr || aligned16(part));
  const unsigned grid = (unsigned)(((long long)n_seg + kWarps - 1) / kWarps);
  if (vec)
    spmm_rows_kernel<true><<<grid, kThreads, 0, st>>>(
        cols, vals, seg_ptr, seg_row, seg_part, row_part_ptr, x, y, part,
        count, n_seg, d, n_x);
  else
    spmm_rows_kernel<false><<<grid, kThreads, 0, st>>>(
        cols, vals, seg_ptr, seg_row, seg_part, row_part_ptr, x, y, part,
        count, n_seg, d, n_x);
  return (int)cudaGetLastError();
}

const char* gdmcf_spmm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
