// Row-ordered sparse product y = A x over a batch of lanes, float64 or
// float32 (one template, two C entries), for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves the COO product of
// phy_engine_tpu/ops/sparse.py (coo_matvec, bicgstab) to XLA, which fuses
// the gather, the multiply and the segment sum.  The port's plain twin is
// phy_engine_tpu_torch/ops/sparse.py::COOLayout over RowPlan: a gather of
// x at every entry's column, the (B, nnz) products written out, then per
// degree bucket a padded gather, its adds and a scatter, about 27 device
// operations and a few GB of traffic a product at (64, 100001).  This
// kernel is the same sum in one pass.
//
// The function.  The host lays the pattern out in rows (sparse.py::
// COOLayout.__init__): rowptr (n + 1) int32, cols (nnz) int32 in row order
// (the stable sort RowPlan makes, so a row keeps its entries' COO order;
// entries of the ground row are dropped; a column equal to n is the ground
// dummy and reads as 0.0), and the values gathered into that order once a
// solve (COOLayout.bind).  For every lane b and row r:
//   y[b][r] = sum over k in [rowptr[r], rowptr[r+1]) of vals[b][k] * x'[b][cols[k]]
// with x'[b][n] = 0.0, each product rounded and then added strictly left
// to right: __dmul_rn / __dadd_rn (__fmul_rn / __fadd_rn in float32), so
// no FMA is contracted and the card rounds as the plain twin does.  On rows up to eight entries wide that is
// RowPlan's order, so the two agree bit for bit; wider rows differ from
// torch's sum by rounding.  No atomics: a repeat run is bit-identical.
// vals and x take a lane stride each (0: one row shared by every lane).
//
// What bounds it on an H100: bytes.  At the mesh cell's (64, 100001) with
// 540,001 entries a pass reads the values once (276.5 MB), x once (51.2
// MB) and writes y once (51.2 MB): ~380 MB, 0.113 ms at 3.35 TB/s; the
// int32 pattern (2.6 MB) stays in the 50 MB L2.  Two operations a stored
// entry, so never near the FP64 rate.
//
// Design.  Rows up to row_max entries (sparse.py::ROW_THREAD_MAX, 32:
// every row of a mesh or a ladder): coo_rows, one thread per (lane, row),
// neighbouring threads on neighbouring rows of one lane, so the warp's
// value and column loads fall in a few neighbouring lines that L1 keeps
// across its iterations.  The grid is ordered lane by lane (block i holds
// lane i / row_blocks), so the blocks in flight read x of two or three
// lanes (800 KB each), which stay in L2 while their gathers hit them.
// Wider rows (a rail node with thousands of entries) would stall a warp
// behind one thread: coo_wide gives each (lane, wide row) a block, each
// thread summing its strided entries left to right, then a fixed tree (a
// warp butterfly, then the eight warp sums in order) — deterministic, and
// launched only when the layout has such rows (coo_rows skips them).
// Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.142 ms at (64,
// 100001), 80 % of the bytes bound, against 2.32 ms for the plain twin.

#include <cuda_runtime.h>

namespace {

constexpr int kRowThreads = 256;
constexpr int kWideThreads = 256;

// Rounded product and sum, never contracted into an FMA.
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(kRowThreads)
coo_rows(const int* __restrict__ rowptr, const int* __restrict__ cols,
         const T* __restrict__ vals, long long vstride,
         const T* __restrict__ x, long long xstride,
         T* __restrict__ y, int n, int row_blocks, int row_max) {
  const int lane = blockIdx.x / row_blocks;
  const int r = (blockIdx.x - lane * row_blocks) * kRowThreads + threadIdx.x;
  if (r >= n) return;
  const int s = __ldg(rowptr + r);
  const int e = __ldg(rowptr + r + 1);
  if (e - s > row_max) return;                 // coo_wide writes this row
  const T* v = vals + lane * vstride;
  const T* xl = x + lane * xstride;
  T acc = T(0);
  for (int k = s; k < e; ++k) {
    const int c = __ldg(cols + k);
    const T p = mul_rn(__ldg(v + k), c < n ? __ldg(xl + c) : T(0));
    acc = k == s ? p : add_rn(acc, p);
  }
  y[lane * static_cast<long long>(n) + r] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kWideThreads)
coo_wide(const int* __restrict__ rowptr, const int* __restrict__ cols,
         const int* __restrict__ wide, int n_wide,
         const T* __restrict__ vals, long long vstride,
         const T* __restrict__ x, long long xstride,
         T* __restrict__ y, int n) {
  __shared__ T part[kWideThreads / 32];
  const int lane = blockIdx.x / n_wide;
  const int r = __ldg(wide + (blockIdx.x - lane * n_wide));
  const int s = __ldg(rowptr + r);
  const int e = __ldg(rowptr + r + 1);
  const T* v = vals + lane * vstride;
  const T* xl = x + lane * xstride;
  T acc = T(0);
  for (int k = s + threadIdx.x; k < e; k += kWideThreads) {
    const int c = __ldg(cols + k);
    acc = add_rn(acc, mul_rn(__ldg(v + k), c < n ? __ldg(xl + c) : T(0)));
  }
  for (int o = 16; o > 0; o >>= 1)
    acc = add_rn(acc, __shfl_xor_sync(0xffffffffu, acc, o));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    T t = part[0];
    for (int w = 1; w < kWideThreads / 32; ++w) t = add_rn(t, part[w]);
    y[lane * static_cast<long long>(n) + r] = t;
  }
}

template <typename T>
int spmm(const int* rowptr, const int* cols, const int* wide, const T* vals,
         long long vstride, const T* x, long long xstride, T* y, int B,
         int n, int row_max, int n_wide, void* stream) {
  if (B < 1 || n < 1 || row_max < 0 || n_wide < 0)
    return cudaErrorInvalidValue;
  const long long row_blocks = (n + kRowThreads - 1) / kRowThreads;
  if (row_blocks * B > 0x7fffffffLL || static_cast<long long>(n_wide) * B >
      0x7fffffffLL)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  coo_rows<T><<<static_cast<unsigned>(row_blocks * B), kRowThreads, 0, st>>>(
      rowptr, cols, vals, vstride, x, xstride, y, n,
      static_cast<int>(row_blocks), row_max);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_wide == 0) return static_cast<int>(err);
  coo_wide<T><<<static_cast<unsigned>(n_wide * B), kWideThreads, 0, st>>>(
      rowptr, cols, wide, n_wide, vals, vstride, x, xstride, y, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, n) = A x for B lanes.  vstride / xstride: elements between lanes
// of vals / x (0 where one row serves every lane).  wide: the n_wide rows
// wider than row_max (null when n_wide is 0).  Launches coo_rows, then
// coo_wide if n_wide > 0, on `stream`; returns cudaGetLastError().
extern "C" int pe_coo_spmm64(const int* rowptr, const int* cols,
                             const int* wide, const double* vals,
                             long long vstride, const double* x,
                             long long xstride, double* y, int B, int n,
                             int row_max, int n_wide, void* stream) {
  return spmm<double>(rowptr, cols, wide, vals, vstride, x, xstride, y, B,
                      n, row_max, n_wide, stream);
}

// The same in float32 (a Circuit built with dtype float32).
extern "C" int pe_coo_spmm32(const int* rowptr, const int* cols,
                             const int* wide, const float* vals,
                             long long vstride, const float* x,
                             long long xstride, float* y, int B, int n,
                             int row_max, int n_wide, void* stream) {
  return spmm<float>(rowptr, cols, wide, vals, vstride, x, xstride, y, B, n,
                     row_max, n_wide, stream);
}
