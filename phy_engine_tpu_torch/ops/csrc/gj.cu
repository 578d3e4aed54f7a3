// Batched one-hot-pivot Gauss-Jordan in float32 for Hopper (sm_90a):
// right-looking 32-wide micro-panels on chip plus a rank-32 tiled update.
//
// Replaces the two TPU Pallas kernels of the JAX package:
//   pe_gj_solve32   <- phy_engine_tpu/ops/gj.py::_gj_pallas      (A x = b;
//                      core _gj_core_T)
//   pe_gj_inverse32 <- phy_engine_tpu/ops/gj.py::_gj_inv_pallas  (A^-1;
//                      core _gj_core_T_multi)
//
// The function (the reference's): no row swaps.  At step k the pivot row
// r is the unpivoted row, among all n rows, with the largest |W[r][k]| (a
// tie goes to the smallest row index; a NaN ranks above everything); every
// other row takes W[i][:] -= (W[i][k] / W[r][k]) * W[r][:]; krow[r] = k
// and pivd[r] = 1 + (W[r][k] - 1) in float32, as the reference accumulates
// it.  At the end x[krow[r]] = W[r][rhs] / pivd[r].  A singular or NaN
// lane turns non-finite and never traps.
//
// Dataflow: the JAX kernel's micro-panels (MB = 32, gj.py:189-272, with
// panel_factor's rule, gj.py:45-87).  Steps k0 .. k0+31 together act on
// the columns outside the panel as M = I - G O^T, where O holds the one-hot
// selectors of the panel's pivot rows and G is what the panel's 32 columns
// become when each eliminated slot keeps its factor column.  So per panel
// k0 = 0, 32, ... two launches on the caller's stream:
//   (a) gj_panel_kernel, one 256-thread block per lane.  The lane's n x 32
//       panel sits in registers, up to four rows a thread (n <= 1024), and
//       the 32 pivot steps run there with one barrier a step: each warp
//       finds its candidate by two warp reductions (redux) over integer
//       keys and its winning thread publishes its row to shared memory
//       (double buffered, so no second barrier); after the barrier every
//       warp reduces the eight candidates the same way, reads the winner's
//       row and applies the rank-1 step to its registers.  The block
//       writes G, krow, pivd and rowof (step -> row), and copies the pivot
//       rows of the live region as they were before the panel, R = O^T T,
//       to scratch.  The copy is what makes the in-place update safe: (b)
//       rewrites the pivot rows while other tiles still read them.
//       For n > 1024 one block's registers cannot hold the panel, so the
//       launch is a thread-block cluster of cs = ceil(n / 1024) blocks a
//       lane (at most 8, the portable cluster size: n <= 8192), each
//       owning a contiguous range of rows in its registers.  A step then
//       takes one cluster barrier instead of the block barrier: every
//       block publishes its warps' candidates in its own shared memory,
//       and every warp reads all cs x 8 of them through distributed
//       shared memory and picks the winner by the same rule, so every
//       block takes the single-block path's decision.
//   (b) gj_update_kernel, B x (n / 64) x (live columns / 64) blocks of 256
//       threads, one 64 x 64 tile each: T_tile = base - G_tile R_tile with
//       FP32 FMAs on the CUDA cores, k = 0..31 in order.
// In place (the inverse).  Identity column c becomes live at the step
// that pivots row c, exactly when that step's A column dies, so one n x n
// buffer W holds the live region: physical column k holds A column k
// before its panel and identity column rowof[k] after it.  In the panel's
// own columns the update's base is e_rowof[k] and R holds the identity,
// so they are stored as e_rowof[k] - G[:, k - k0].  Identity column j
// ends at physical column krow[j], so the last update places its tiles by
// the pivot map, X[krow[r]][j] = W[r][krow[j]] / pivd[r], instead of
// storing W.  The updates do 2 n^3 flops per lane, the function's least
// work.  The solve keeps A's live columns (> k0 + 31) in W and b in Wb,
// and updates only those, about n^3 flops; its last update places
// x[krow[r]] = Wb[r] / pivd[r].
//
// What bounds it on an H100.  The function's least work is 2 n^3 flops
// per lane for the inverse (8.6 GFLOP at B = 256, n = 256: 0.128 ms at
// the 67 TFLOP/s FP32 peak).  Each update launch streams the live region
// in and out once (8 n^2 bytes per lane for the inverse, 134 MB at B =
// 256, n = 256, beyond the 50 MB L2: ~40 us at 3.35 TB/s) at 8 flops a
// byte, near the ridge between bytes and FP32 operations; the serial
// 32-step chain of each panel launch adds its latency (one block barrier,
// four warp reductions and two dependent shared-memory reads a step) n /
// 32 times: at (256, 256) the eight panel launches take about a third of
// the inverse's time and half of the solve's.
//
// Why no wgmma: on float32 operands the tensor cores compute in TF32
// (about three decimal digits), and the port's factor path requires
// full-float32 products, as the reference's Precision.HIGHEST does.  So
// the update runs on the CUDA cores and its bound is the FP32 rate.
//
// Rounding.  The factors are IEEE quotients col / pivot, as in the
// reference, but the rank-1 steps round once (FMA) where the reference
// rounds the product and then the difference, and the update sums the
// panel's 32 rank-1 terms in another order than the sequential steps: the
// result is not bit-identical to the plain torch version; it agrees to
// gj_cases.TOL.  Nothing is atomic and every sum runs in a fixed order: a
// repeat run is bit-identical.
//
// Launch: the entry points launch on the given stream, do not
// synchronise, allocate nothing (all scratch comes from the caller), and
// return the first launch error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kMb = 32;             // micro-panel width
constexpr int kPanelThreads = 256;
constexpr int kPanelWarps = kPanelThreads / 32;
constexpr int kMaxRpt = 4;          // panel rows a thread at most
constexpr int kBlockRows = kMaxRpt * kPanelThreads;  // one block's rows
constexpr int kMaxCluster = 8;      // the portable cluster size
constexpr int kMaxN = kMaxCluster * kBlockRows;
constexpr int kTile = 64;           // update tile: kTile x kTile outputs
constexpr int kUpdThreads = 256;    // 16 x 16 threads, 4 x 4 outputs each
constexpr int kUpdBlocksPerSm = 4;  // caps registers at 64 a thread
constexpr unsigned kFull = 0xffffffffu;

// The pivot search's order as one unsigned key, larger wins: a row past
// n 0, a pivoted row 1, an unpivoted row the bits of |col| plus 2 (a NaN
// as +inf, so it ranks above every number).  For |col| >= 0 the bits order
// as the floats do.  A tie goes to the smaller row index.
__device__ __forceinline__ unsigned pivot_key(float c, int i, int n, int kr) {
  if (i >= n) return 0u;
  if (kr >= 0) return 1u;
  return (c != c ? 0x7f800000u : __float_as_uint(fabsf(c))) + 2u;
}

// The best (key, index) over the lanes of a warp by two warp reductions;
// every lane ends with the pair.
__device__ __forceinline__ void warp_argmax(unsigned& key, int& bi) {
  const unsigned wk = __reduce_max_sync(kFull, key);
  bi = static_cast<int>(
      __reduce_min_sync(kFull, key == wk ? static_cast<unsigned>(bi) : ~0u));
  key = wk;
}

// This thread's best candidate for the pivot column row[s][0] (its rows i0
// + 256 s rise with s, so the first of equal keys has the smaller index;
// rows at or past lim are not the block's), then its warp's.
template <int RPT>
__device__ __forceinline__ void warp_best(const float (&row)[RPT][kMb],
                                          const int (&kr)[RPT], int i0,
                                          int lim, unsigned& key, int& bi) {
  key = pivot_key(row[0][0], i0, lim, kr[0]);
  bi = i0;
#pragma unroll
  for (int s = 1; s < RPT; ++s) {
    const int i = i0 + s * kPanelThreads;
    const unsigned k = pivot_key(row[s][0], i, lim, kr[s]);
    if (k > key) {
      key = k;
      bi = i;
    }
  }
  warp_argmax(key, bi);
}

// The warp's winner publishes its row as it stands before the step, lane
// 0 the warp's candidate.
template <int RPT>
__device__ __forceinline__ void publish(const float (&row)[RPT][kMb], int i0,
                                        int ln, unsigned key, int bi,
                                        float* slot_row, unsigned* slot_key,
                                        int* slot_i) {
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    if (i0 + s * kPanelThreads == bi) {
      float4* d4 = reinterpret_cast<float4*>(slot_row);
#pragma unroll
      for (int q = 0; q < kMb / 4; ++q)
        d4[q] = make_float4(row[s][4 * q], row[s][4 * q + 1],
                            row[s][4 * q + 2], row[s][4 * q + 3]);
    }
  }
  if (ln == 0) {
    *slot_key = key;
    *slot_i = bi;
  }
}

// src: the lanes before this panel (A at k0 = 0, W after), row stride n;
// bsrc: the solve's right-hand side before this panel (b, then Wb), null
// for the inverse.  G: (B, n, 32); R: (B, 32, rld), filled in the update's
// columns c0 .. n-1, and n for the solve; krow, pivd, rowof: (B, n), set
// from scratch at k0 = 0.
//
// kCluster false (n <= 1024): one block per lane, grid B; thread t owns
// rows t + 256 s, s < RPT.  kCluster true (n > 1024): a cluster of cs
// blocks per lane, grid B cs; block c owns rows [c rb, min(n, (c + 1) rb))
// and its thread t rows c rb + t + 256 s.  Each step every block publishes
// its warps' candidates in its own shared memory, one cluster barrier, and
// every warp of every block reduces all cs x 8 candidates (distributed
// shared memory) by the same rule — largest key, a tie to the smaller row
// — so every block takes the single-block path's decision, then reads the
// winner's row from the block that owns it.
template <int RPT, bool kCluster>
__global__ void __launch_bounds__(kPanelThreads)
gj_panel_kernel(const float* __restrict__ src, const float* __restrict__ bsrc,
                float* __restrict__ G, float* __restrict__ R,
                int* __restrict__ krow, float* __restrict__ pivd,
                int* __restrict__ rowof, int n, int k0, int c0, int rld,
                int cs, int rb) {
  __shared__ __align__(16) float cand_row[2][kPanelWarps][kMb];
  __shared__ unsigned cand_key[2][kPanelWarps];
  __shared__ int cand_i[2][kPanelWarps];
  __shared__ int piv[kMb];

  const int rank = kCluster ? static_cast<int>(blockIdx.x % cs) : 0;
  const size_t lane = kCluster ? blockIdx.x / cs : blockIdx.x;
  const int r_lo = rank * rb, lim = kCluster ? min(n, r_lo + rb) : n;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const int i0 = r_lo + tid;
  const float* S = src + lane * n * n;

  float row[RPT][kMb];
  int kr[RPT];
  float pd[RPT];
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = i0 + s * kPanelThreads;
    if (i < lim) {
      const float4* a4 =
          reinterpret_cast<const float4*>(S + static_cast<size_t>(i) * n + k0);
#pragma unroll
      for (int q = 0; q < kMb / 4; ++q) {
        const float4 v = a4[q];
        row[s][4 * q] = v.x;
        row[s][4 * q + 1] = v.y;
        row[s][4 * q + 2] = v.z;
        row[s][4 * q + 3] = v.w;
      }
      kr[s] = k0 == 0 ? -1 : krow[lane * n + i];
      pd[s] = k0 == 0 ? 1.f : pivd[lane * n + i];
    } else {
#pragma unroll
      for (int q = 0; q < kMb; ++q) row[s][q] = 0.f;
      kr[s] = 0;
      pd[s] = 1.f;
    }
  }

  // the serial chain, one barrier a step.  The registers rotate: at step
  // j, row[s][q] holds panel column (j + q) mod 32, so the pivot column is
  // always row[s][0] and every index is static without unrolling the
  // chain (an unrolled chain is ~10k instructions that run once each,
  // fetched from L2).  After 32 steps row[s][q] is column q again.  Each
  // step ends with the next step's warp candidates, double buffered.
  unsigned key;
  int bi;
  warp_best<RPT>(row, kr, i0, lim, key, bi);
  publish<RPT>(row, i0, ln, key, bi, cand_row[0][warp], cand_key[0] + warp,
               cand_i[0] + warp);
#pragma unroll 1
  for (int j = 0; j < kMb; ++j) {
    const int buf = j & 1;
    const float4* p4;
    int r;
    if constexpr (kCluster) {
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      // lane l takes the candidates l and l + 32 (cs x 8 <= 64), then the
      // warp reduces; the winner's row comes from the block that owns it
      unsigned bk = 0u;
      r = INT_MAX;
      for (int c = ln; c < cs * kPanelWarps; c += 32) {
        const int b = c / kPanelWarps, w = c % kPanelWarps;
        const unsigned k = *cl.map_shared_rank(&cand_key[buf][w], b);
        const int i = *cl.map_shared_rank(&cand_i[buf][w], b);
        if (k > bk || (k == bk && i < r)) {
          bk = k;
          r = i;
        }
      }
      warp_argmax(bk, r);
      const int owner = r / rb;
      p4 = reinterpret_cast<const float4*>(cl.map_shared_rank(
          cand_row[buf][((r - owner * rb) % kPanelThreads) >> 5], owner));
    } else {
      __syncthreads();
      // every warp reduces the warps' candidates and reads the winner's row
      unsigned bk = cand_key[buf][ln % kPanelWarps];
      r = cand_i[buf][ln % kPanelWarps];
      warp_argmax(bk, r);
      p4 = reinterpret_cast<const float4*>(
          cand_row[buf][(r % kPanelThreads) >> 5]);
    }
    float prow[kMb];
#pragma unroll
    for (int q = 0; q < kMb / 4; ++q) {
      const float4 x = p4[q];
      prow[4 * q] = x.x;
      prow[4 * q + 1] = x.y;
      prow[4 * q + 2] = x.z;
      prow[4 * q + 3] = x.w;
    }
    const float p = prow[0];

    // the rank-1 step on the panel, rotating by one; column j's slot keeps
    // the factor column, so the earlier slots accumulate G
#pragma unroll
    for (int s = 0; s < RPT; ++s) {
      const int i = i0 + s * kPanelThreads;
      const float f = __fmul_rn(row[s][0] / p, i == r ? 0.f : 1.f);
#pragma unroll
      for (int q = 1; q < kMb; ++q)
        row[s][q - 1] = fmaf(-f, prow[q], row[s][q]);
      row[s][kMb - 1] = f;
      if (i == r) {
        kr[s] = k0 + j;
        pd[s] = 1.f + (p - 1.f);
      }
    }
    if (tid == 0) piv[j] = r;
    if (j + 1 < kMb) {
      warp_best<RPT>(row, kr, i0, lim, key, bi);
      publish<RPT>(row, i0, ln, key, bi, cand_row[buf ^ 1][warp],
                   cand_key[buf ^ 1] + warp, cand_i[buf ^ 1] + warp);
    }
  }
  // the last step's remote reads end before any block of the cluster exits
  if constexpr (kCluster)
    cg::this_cluster().sync();
  else
    __syncthreads();

  float* Gl = G + lane * n * kMb;
#pragma unroll
  for (int s = 0; s < RPT; ++s) {
    const int i = i0 + s * kPanelThreads;
    if (i >= lim) continue;
    float4* g4 = reinterpret_cast<float4*>(Gl + static_cast<size_t>(i) * kMb);
#pragma unroll
    for (int q = 0; q < kMb / 4; ++q)
      g4[q] = make_float4(row[s][4 * q], row[s][4 * q + 1], row[s][4 * q + 2],
                          row[s][4 * q + 3]);
    krow[lane * n + i] = kr[s];
    pivd[lane * n + i] = pd[s];
  }
  if (rank == 0 && tid < kMb) rowof[lane * n + k0 + tid] = piv[tid];

  // R: the pivot rows before the panel, over the update's columns; the
  // inverse's panel columns hold the identity, the solve's column n is b.
  // Warp w copies rows w, w + 8, w + 16 and w + 24, four columns a lane
  // (c0, n and rld are multiples of 4), all four rows' loads in flight
  // before their stores; the blocks of a cluster take every cs-th run of
  // 128 columns.
  float* Rl = R + lane * kMb * rld;
  for (int p = c0 + 4 * ln + 128 * rank; p < n; p += 128 * cs) {
    float4 v[kMb / kPanelWarps];
#pragma unroll
    for (int a = 0; a < kMb / kPanelWarps; ++a) {
      const int q = warp + kPanelWarps * a;
      v[a] = p >= k0 && p < k0 + kMb
                 ? make_float4(p - k0 == q ? 1.f : 0.f,
                               p + 1 - k0 == q ? 1.f : 0.f,
                               p + 2 - k0 == q ? 1.f : 0.f,
                               p + 3 - k0 == q ? 1.f : 0.f)
                 : *reinterpret_cast<const float4*>(
                       S + static_cast<size_t>(piv[q]) * n + p);
    }
#pragma unroll
    for (int a = 0; a < kMb / kPanelWarps; ++a) {
      const int q = warp + kPanelWarps * a;
      *reinterpret_cast<float4*>(Rl + static_cast<size_t>(q) * rld + p) = v[a];
    }
  }
  if (bsrc != nullptr && rank == 0 && tid < kMb)
    Rl[static_cast<size_t>(tid) * rld + n] = bsrc[lane * n + piv[tid]];
}

// dst = base - G R over one 64 x 64 tile of the columns c0 .. cend-1.
// base: src, except in the inverse's panel columns (e_rowof, the identity
// columns that become live) and the solve's column n (bsrc; written to
// bdst).  src == dst and bsrc == bdst after the first panel.  X (the
// last panel only, else null): the tile is placed by the pivot map instead,
// X[krow[i]][rowof[p]] = (base - G R)[i][p] / pivd[i] for the inverse,
// x[krow[i]] = (base - G R)[i][n] / pivd[i] for the solve.
template <bool kInverse>
__global__ void __launch_bounds__(kUpdThreads, kUpdBlocksPerSm)
gj_update_kernel(const float* src, float* dst, const float* bsrc, float* bdst,
                 const float* __restrict__ G, const float* __restrict__ R,
                 const int* __restrict__ rowof, const int* __restrict__ krow,
                 const float* __restrict__ pivd, float* __restrict__ X,
                 int n, int k0, int c0, int cend, int rld) {
  __shared__ float Gs[kTile][kMb + 1];
  __shared__ __align__(16) float Rs[kMb][kTile];
  __shared__ int piv[kMb];

  const int row_tiles = n / kTile;
  const int col_tiles = (cend - c0 + kTile - 1) / kTile;
  int bid = blockIdx.x;
  const int tn = bid % col_tiles;
  bid /= col_tiles;
  const int tm = bid % row_tiles;
  const size_t lane = bid / row_tiles;
  const int i0 = tm * kTile, p0 = c0 + tn * kTile;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* Gl = G + lane * n * kMb;
  const float* Rl = R + lane * kMb * rld;

  for (int e = tid; e < kTile * kMb; e += kUpdThreads) {
    const int a = e / kMb, q = e % kMb;
    Gs[a][q] = Gl[static_cast<size_t>(i0 + a) * kMb + q];
  }
  for (int e = tid; e < kMb * kTile; e += kUpdThreads) {
    const int q = e / kTile, c = e % kTile;
    Rs[q][c] = p0 + c < cend ? Rl[static_cast<size_t>(q) * rld + p0 + c] : 0.f;
  }
  if (kInverse && tid < kMb) piv[tid] = rowof[lane * n + k0 + tid];

  // the base values are loaded before the product, so their latency
  // overlaps the FMAs.  n, k0 and c0 are multiples of 32 and p of 4: the
  // four columns of a thread are all inside or all outside the matrix and
  // the panel.
  const int p = p0 + tx * 4;
  const bool pa = p < n;                          // four W columns
  const bool pb = !kInverse && p == n;            // the solve's b column
  const bool pcol = kInverse && p >= k0 && p < k0 + kMb;
  const float* Sl = src + lane * n * n;
  float4 base[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (pa && !pcol)
      base[a] = *reinterpret_cast<const float4*>(
          Sl + static_cast<size_t>(i) * n + p);
    else if (pb)
      base[a] = make_float4(bsrc[lane * n + i], 0.f, 0.f, 0.f);
    else
      base[a] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  __syncthreads();
  if (pcol) {
    const int c = p - k0;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int i = i0 + ty + 16 * a;
      base[a] = make_float4(
          i == piv[c] ? 1.f : 0.f, i == piv[c + 1] ? 1.f : 0.f,
          i == piv[c + 2] ? 1.f : 0.f, i == piv[c + 3] ? 1.f : 0.f);
    }
  }

  float acc[4][4] = {};
#pragma unroll 8
  for (int q = 0; q < kMb; ++q) {
    const float4 w = *reinterpret_cast<const float4*>(&Rs[q][tx * 4]);
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const float g = Gs[ty + 16 * a][q];
      acc[a][0] = fmaf(g, w.x, acc[a][0]);
      acc[a][1] = fmaf(g, w.y, acc[a][1]);
      acc[a][2] = fmaf(g, w.z, acc[a][2]);
      acc[a][3] = fmaf(g, w.w, acc[a][3]);
    }
  }

  if (X != nullptr) {
    if (kInverse) {
      int j[4];
#pragma unroll
      for (int c = 0; c < 4; ++c) j[c] = rowof[lane * n + p + c];
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const int i = i0 + ty + 16 * a;
        const float d = pivd[lane * n + i];
        float* Xr = X + (lane * n + krow[lane * n + i]) * n;
        Xr[j[0]] = (base[a].x - acc[a][0]) / d;
        Xr[j[1]] = (base[a].y - acc[a][1]) / d;
        Xr[j[2]] = (base[a].z - acc[a][2]) / d;
        Xr[j[3]] = (base[a].w - acc[a][3]) / d;
      }
    } else if (pb) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const size_t e = lane * n + i0 + ty + 16 * a;
        X[lane * n + krow[e]] = (base[a].x - acc[a][0]) / pivd[e];
      }
    }
    return;
  }
  float* Dl = dst + lane * n * n;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int i = i0 + ty + 16 * a;
    if (pa) {
      *reinterpret_cast<float4*>(Dl + static_cast<size_t>(i) * n + p) =
          make_float4(base[a].x - acc[a][0], base[a].y - acc[a][1],
                      base[a].z - acc[a][2], base[a].w - acc[a][3]);
    } else if (pb) {
      bdst[lane * n + i] = base[a].x - acc[a][0];
    }
  }
}

// the panel kernel for 1 .. 4 rows a thread, one block a lane; in a
// cluster a block holds more than 512 rows, so 3 or 4 a thread
using PanelKernel = void (*)(const float*, const float*, float*, float*, int*,
                             float*, int*, int, int, int, int, int, int);
const PanelKernel kPanelKernels[kMaxRpt] = {
    gj_panel_kernel<1, false>, gj_panel_kernel<2, false>,
    gj_panel_kernel<3, false>, gj_panel_kernel<4, false>};
const PanelKernel kClusterKernels[2] = {gj_panel_kernel<3, true>,
                                        gj_panel_kernel<4, true>};

// One panel launch: n <= 1024 one block a lane (the rows strided over its
// threads); above that a cluster of cs = ceil(n / 1024) blocks a lane,
// each owning rb = ceil(n / cs) rows rounded up to a multiple of 256 (the
// last block fewer).
cudaError_t launch_panel(const float* src, const float* bsrc, float* G,
                         float* R, int* krow, float* pivd, int* rowof, int B,
                         int n, int k0, int c0, int rld, cudaStream_t s) {
  if (n <= kBlockRows) {
    const int rpt = (n + kPanelThreads - 1) / kPanelThreads;
    kPanelKernels[rpt - 1]<<<B, kPanelThreads, 0, s>>>(
        src, bsrc, G, R, krow, pivd, rowof, n, k0, c0, rld, 1, n);
    return cudaGetLastError();
  }
  const int cs = (n + kBlockRows - 1) / kBlockRows;
  const int rb =
      ((n + cs - 1) / cs + kPanelThreads - 1) / kPanelThreads * kPanelThreads;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cs);
  cfg.blockDim = dim3(kPanelThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kClusterKernels[rb / kPanelThreads - 3], src, bsrc, G, R, krow,
      pivd, rowof, n, k0, c0, rld, cs, rb);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// A: (B, n, n); b: (B, n) or null (the inverse).  Scratch from the
// caller: W (B, n, n); Wb (B, n), the solve only; G (B, n, 32); R (B, 32,
// n) for the inverse, (B, 32, n + 4) for the solve (b in column n, rows
// 16-byte aligned); krow, rowof (B, n) int32; pivd (B, n).  out: X (B, n,
// n) or x (B, n).  Every offset into them is a size_t: B n n passes 2^31
// at n = 8192, B >= 32.
template <bool kInverse>
cudaError_t run(const float* A, const float* b, float* W, float* Wb, float* G,
                float* R, int* krow, float* pivd, int* rowof, float* out,
                int B, int n, cudaStream_t s) {
  if (B < 1 || n < kTile || n % kTile || n > kMaxN)
    return cudaErrorInvalidValue;
  const int cend = kInverse ? n : n + 1;
  const int rld = kInverse ? n : n + 4;
  const long long row_tiles = n / kTile;
  const long long max_col_tiles =
      (cend - (kInverse ? 0 : kMb) + kTile - 1) / kTile;
  if (static_cast<long long>(B) * row_tiles * max_col_tiles > INT_MAX ||
      static_cast<long long>(B) * kMaxCluster > INT_MAX)
    return cudaErrorInvalidValue;
  for (int k0 = 0; k0 < n; k0 += kMb) {
    const float* src = k0 == 0 ? A : W;
    const float* bsrc = kInverse ? nullptr : (k0 == 0 ? b : Wb);
    const int c0 = kInverse ? 0 : k0 + kMb;
    cudaError_t e = launch_panel(src, bsrc, G, R, krow, pivd, rowof, B, n, k0,
                                 c0, rld, s);
    if (e != cudaSuccess) return e;
    const long long col_tiles = (cend - c0 + kTile - 1) / kTile;
    gj_update_kernel<kInverse>
        <<<static_cast<int>(B * row_tiles * col_tiles), kUpdThreads, 0, s>>>(
            src, W, bsrc, Wb, G, R, rowof, krow, pivd,
            k0 + kMb == n ? out : nullptr, n, k0, c0, cend, rld);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

}  // namespace

extern "C" int pe_gj_solve32(const float* A, const float* b, float* W,
                             float* Wb, float* G, float* R, int* krow,
                             float* pivd, int* rowof, float* x, int B, int n,
                             void* stream) {
  return static_cast<int>(run<false>(A, b, W, Wb, G, R, krow, pivd, rowof, x,
                                     B, n, static_cast<cudaStream_t>(stream)));
}

extern "C" int pe_gj_inverse32(const float* A, float* W, float* G, float* R,
                               int* krow, float* pivd, int* rowof, float* X,
                               int B, int n, void* stream) {
  return static_cast<int>(run<true>(A, nullptr, W, nullptr, G, R, krow, pivd,
                                    rowof, X, B, n,
                                    static_cast<cudaStream_t>(stream)));
}

extern "C" const char* pe_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
