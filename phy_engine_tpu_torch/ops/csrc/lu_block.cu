// Batched blocked right-looking Gauss-Jordan inverse in float32 for Hopper
// (sm_90a).
//
// Replaces the TPU Pallas kernel of the JAX package:
//   pe_lu_block_inverse32 <- phy_engine_tpu/ops/lu_block.py:148
//                            (_lu_block_pallas, core _lu_block_core)
//
// Algorithm (the reference's).  W = [A | I] is processed one nb = 32
// diagonal block at a time.  Block step kb (k0 = 32 kb):
//   * the diagonal block D = W[k0:k0+32, k0:k0+32] is inverted by one-hot
//     Gauss-Jordan on the 32 x 64 tile [D | I] whose pivot search stays
//     within the block's rows: at step j the pivot row r is the unpivoted
//     row with the largest |T[r][j]| (a tie goes to the smaller row), every
//     other row takes T[a][q] -= (T[a][j] / T[r][j]) * T[r][q], and
//     krow[r] = j, pivd[r] = 1 + (T[r][j] - 1) (float32, as the reference
//     accumulates it); then Dinv[krow[r]] = T[r][32:] / pivd[r];
//   * G = C Dinv for the rows outside the block (C = W[:, k0:k0+32]) and
//     the block rows become Dinv Wb (Wb = W[k0:k0+32, :]), so that
//     W -= G Wb eliminates the block's columns from every other row and
//     normalises the block rows.  This is the reference's composed
//     G = (C rmask - S) Dinv + S, W -= G Wb with the block rows written
//     as 0 - (-Dinv) Wb: the same products, summed in another order.
// A singular diagonal block (its pivot column all zero among the unpivoted
// rows) turns the lane non-finite; a NaN lane stays NaN.  Nothing traps.
//
// In place.  After block step kb the left half of W is the identity in
// columns < k0 + 32 and the right half still the identity in columns
// >= n + k0 + 32, and neither is read again.  So the live region is n
// columns wide, [k0 + 32, n + k0 + 32), and one n x n buffer X holds it
// with logical column c at physical column c mod n (the classic in-place
// Gauss-Jordan inversion): step kb overwrites physical columns k0..k0+31,
// its pivot columns, with the right half's new columns n+k0..n+k0+31,
// whose entries before the step are those of the identity.  After the
// last step X is A^-1 itself.  The update does 2 n^3 flops per lane in
// all, half of the reference's 4 n^3 (the Pallas CostEstimate).
//
// Design.  Two launches per block step, 2 n / 32 per call, all on the
// caller's stream:
//   (a) lu_diag_kernel, B x ceil(n / 128) blocks of 128 threads.  In each
//       block one warp inverts the lane's diagonal block (a tile row in
//       each thread's registers, warp-shuffle argmax and pivot-row
//       broadcast, no barrier inside the chain; every block of a lane
//       computes the same Dinv bit for bit) while the other three copy
//       the block's 128 columns of Wb into a (32, n) scratch; then each
//       thread writes one row of G.
//       The copy is what makes the in-place update safe: step (b) rewrites
//       the block rows, which every other tile reads.
//   (b) lu_update_kernel, B x ceil(n/64)^2 blocks of 256 threads, one 64 x
//       64 tile of X each: the G and Wb tiles in shared memory, 4 x 4
//       outputs per thread, X_tile = base - G_tile Wb_tile with FP32 FMAs
//       on the CUDA cores in a fixed order (k = 0..31; no atomics, so a
//       repeat run is bit-identical).  At step 0 it reads A, so the input
//       is never copied separately.
//
// What bounds it on an H100.  The function's least work is 2 n^3 flops
// per lane (8.6 GFLOP at B = 256, n = 256: 0.128 ms at the 67 TFLOP/s
// FP32 peak).  Each block step streams the lane's n x n live region in and
// out once (8 n^2 bytes; at B = 256, n = 256 that is 134 MB per step, 1.1
// GB per call, ~0.32 ms at 3.35 TB/s, since 67 MB of X exceeds the 50 MB
// L2), at 8 flops per byte: the rank-32 update sits near the ridge
// between bytes and FP32 operations.  The serial 32-step pivot chain of
// (a) adds its latency to every block step.  wgmma / TMA and a wider
// rank per pass (several block steps fused while the panel stays on chip)
// are the work of a later change.
//
// Launch: the entry point launches on the given stream, does not
// synchronise, allocates nothing (X, G and Wb come from the caller), and
// returns the first launch error.

#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>

namespace {

constexpr int kNb = 32;            // diagonal block = pivot scope
constexpr int kDiagThreads = 128;
constexpr int kDiagRows = kDiagThreads;  // rows of G (columns of Wb) a block
constexpr int kTile = 64;          // update tile: kTile x kTile outputs
constexpr int kUpdThreads = 256;   // 16 x 16 threads, 4 x 4 outputs each
constexpr int kUpdBlocksPerSm = 4; // caps registers at 64 a thread
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ bool better(float va, int ia, float vb, int ib) {
  return va > vb || (va == vb && ia < ib);
}

// src: the matrices at the start of this step (A at step 0, X after);
// G: (B, n, 32) scratch; Wb: (B, 32, n) scratch.  Block (lane, g) owns
// rows r0 .. r0+127 of G and physical columns r0 .. r0+127 of Wb.
__global__ void __launch_bounds__(kDiagThreads)
lu_diag_kernel(const float* __restrict__ src, float* __restrict__ G,
               float* __restrict__ Wb, int n, int k0) {
  __shared__ float D[kNb][kNb + 1];
  __shared__ __align__(16) float Dinv[kNb][kNb];
  __shared__ float C[kDiagRows][kNb + 1];   // C rows, then G rows

  const int groups = (n + kDiagRows - 1) / kDiagRows;
  const size_t lane = blockIdx.x / groups;
  const int r0 = (blockIdx.x % groups) * kDiagRows;
  const int rows = min(kDiagRows, n - r0);
  const int tid = threadIdx.x;
  const float* S = src + lane * n * n;

  for (int e = tid; e < kNb * kNb; e += kDiagThreads) {
    const int a = e / kNb, c = e % kNb;
    D[a][c] = S[static_cast<size_t>(k0 + a) * n + k0 + c];
  }
  __syncthreads();

  if (tid < 32) {
    // the serial pivot chain on the 32 x 64 tile [D | I]: thread a holds
    // row a in registers (every index into it is static: the step j only
    // selects and predicates) and the pivot row is broadcast by shuffles,
    // so the chain has no barrier and no memory round trip.  A NaN key
    // ranks above everything so a NaN lane stays NaN.
    const int a = tid;
    float row[2 * kNb];
#pragma unroll
    for (int q = 0; q < kNb; ++q) {
      row[q] = D[a][q];
      row[kNb + q] = (a == q) ? 1.f : 0.f;
    }
    int krow = -1;
    float pivd = 1.f;
#pragma unroll 1
    for (int j = 0; j < kNb; ++j) {
      float c = row[0];
#pragma unroll
      for (int q = 1; q < kNb; ++q) c = (q == j) ? row[q] : c;
      float bv = krow < 0 ? (c != c ? INFINITY : fabsf(c)) : -3e38f;
      int bi = a;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, off);
        const int oi = __shfl_xor_sync(kFull, bi, off);
        if (better(ov, oi, bv, bi)) {
          bv = ov;
          bi = oi;
        }
      }
      const int r = bi;
      const float p = __shfl_sync(kFull, c, r);
      const float f = __fmul_rn(c / p, (a == r) ? 0.f : 1.f);
#pragma unroll
      for (int q = 1; q < 2 * kNb; ++q) {
        if (q > j) {
          const float pq = __shfl_sync(kFull, row[q], r);
          row[q] = __fsub_rn(row[q], __fmul_rn(f, pq));
        }
      }
      if (a == r) {
        krow = j;
        pivd = 1.f + (p - 1.f);
      }
    }
#pragma unroll
    for (int q = 0; q < kNb; ++q) Dinv[krow][q] = row[kNb + q] / pivd;
  } else {
    // meanwhile the other warps load the C rows and copy Wb's columns;
    // the pivot columns of Wb hold the right half's new identity columns
    const int t = tid - 32, nt = kDiagThreads - 32;
    for (int e = t; e < rows * kNb; e += nt) {
      const int a = e / kNb, c = e % kNb;
      C[a][c] = S[static_cast<size_t>(r0 + a) * n + k0 + c];
    }
    float* Wl = Wb + lane * kNb * n;
    for (int e = t; e < kNb * rows; e += nt) {
      const int k = e / rows, p = r0 + e % rows;
      Wl[static_cast<size_t>(k) * n + p] =
          (p >= k0 && p < k0 + kNb) ? (p - k0 == k ? 1.f : 0.f)
                                    : S[static_cast<size_t>(k0 + k) * n + p];
    }
  }
  __syncthreads();

  // G: thread a computes row r0 + a — C Dinv outside the block, -Dinv
  // inside — over its own C row, which it then overwrites with G
  if (tid < rows) {
    const int i = r0 + tid;
    float g[kNb];
    if (i >= k0 && i < k0 + kNb) {
#pragma unroll
      for (int q = 0; q < kNb; ++q) g[q] = -Dinv[i - k0][q];
    } else {
#pragma unroll
      for (int q = 0; q < kNb; ++q) g[q] = 0.f;
#pragma unroll
      for (int c = 0; c < kNb; ++c) {
        const float x = C[tid][c];
        const float4* d4 = reinterpret_cast<const float4*>(Dinv[c]);
#pragma unroll
        for (int q = 0; q < kNb / 4; ++q) {
          const float4 d = d4[q];
          g[4 * q] = fmaf(x, d.x, g[4 * q]);
          g[4 * q + 1] = fmaf(x, d.y, g[4 * q + 1]);
          g[4 * q + 2] = fmaf(x, d.z, g[4 * q + 2]);
          g[4 * q + 3] = fmaf(x, d.w, g[4 * q + 3]);
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kNb; ++q) C[tid][q] = g[q];
  }
  __syncthreads();
  float* Gl = G + (lane * n + r0) * kNb;
  for (int e = tid; e < rows * kNb; e += kDiagThreads)
    Gl[e] = C[e / kNb][e % kNb];
}

// dst = base - G Wb over one 64 x 64 tile; base is src outside the block
// rows and the pivot columns, 0 inside them.  src == dst after step 0.
__global__ void __launch_bounds__(kUpdThreads, kUpdBlocksPerSm)
lu_update_kernel(const float* src, float* dst, const float* __restrict__ G,
                 const float* __restrict__ Wb, int n, int k0) {
  __shared__ float Gs[kTile][kNb + 1];
  __shared__ __align__(16) float Ws[kNb][kTile];

  const int tiles = (n + kTile - 1) / kTile;
  int bid = blockIdx.x;
  const int tn = bid % tiles;
  bid /= tiles;
  const int tm = bid % tiles;
  const size_t lane = bid / tiles;
  const int i0 = tm * kTile, p0 = tn * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* Gl = G + lane * n * kNb;
  const float* Wl = Wb + lane * kNb * n;

  for (int e = tid; e < kTile * kNb; e += kUpdThreads) {
    const int r = e / kNb, q = e % kNb;
    Gs[r][q] = (i0 + r < n) ? Gl[static_cast<size_t>(i0 + r) * kNb + q] : 0.f;
  }
  for (int e = tid; e < kNb * kTile; e += kUpdThreads) {
    const int k = e / kTile, c = e % kTile;
    Ws[k][c] = (p0 + c < n) ? Wl[static_cast<size_t>(k) * n + p0 + c] : 0.f;
  }
  // the base values are loaded before the product, so their latency
  // overlaps the FMAs.  n and k0 are multiples of 32, p of 4: the four
  // columns of a thread are all inside or all outside the matrix and the
  // pivot columns.
  const int p = p0 + tx * 4;
  const bool pin = p < n;
  const bool pcol = p >= k0 && p < k0 + kNb;
  const float* Sl = src + lane * n * n;
  float4 base[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    const bool brow = i >= k0 && i < k0 + kNb;
    base[r] = (pin && i < n && !brow && !pcol)
                  ? *reinterpret_cast<const float4*>(
                        Sl + static_cast<size_t>(i) * n + p)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();

  float acc[4][4] = {};
#pragma unroll 8
  for (int k = 0; k < kNb; ++k) {
    const float4 w = *reinterpret_cast<const float4*>(&Ws[k][tx * 4]);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float g = Gs[ty + 16 * r][k];
      acc[r][0] = fmaf(g, w.x, acc[r][0]);
      acc[r][1] = fmaf(g, w.y, acc[r][1]);
      acc[r][2] = fmaf(g, w.z, acc[r][2]);
      acc[r][3] = fmaf(g, w.w, acc[r][3]);
    }
  }

  if (!pin) return;
  float* Dl = dst + lane * n * n;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= n) continue;
    const float4 out = make_float4(base[r].x - acc[r][0], base[r].y - acc[r][1],
                                   base[r].z - acc[r][2], base[r].w - acc[r][3]);
    *reinterpret_cast<float4*>(Dl + static_cast<size_t>(i) * n + p) = out;
  }
}

}  // namespace

extern "C" int pe_lu_block_inverse32(const float* A, float* X, float* G,
                                     float* Wb, int B, int n, void* stream) {
  if (B < 1 || n < kNb || n % kNb) return cudaErrorInvalidValue;
  const long long groups = (n + kDiagRows - 1) / kDiagRows;
  const long long tiles = (n + kTile - 1) / kTile;
  if (B * groups > INT_MAX || B * tiles * tiles > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int k0 = 0; k0 < n; k0 += kNb) {
    const float* src = k0 == 0 ? A : X;
    lu_diag_kernel<<<static_cast<int>(B * groups), kDiagThreads, 0, s>>>(
        src, G, Wb, n, k0);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return e;
    lu_update_kernel<<<static_cast<int>(B * tiles * tiles), kUpdThreads, 0,
                       s>>>(src, X, G, Wb, n, k0);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
