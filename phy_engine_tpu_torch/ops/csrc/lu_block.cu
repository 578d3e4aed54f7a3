// Batched blocked right-looking Gauss-Jordan inverse in float32 for Hopper
// (sm_90a): 128-wide super-panels on chip plus one rank-128 update each.
//
// Replaces the TPU Pallas kernel of the JAX package:
//   pe_lu_block_inverse32 <- phy_engine_tpu/ops/lu_block.py:148
//                            (_lu_block_pallas, core _lu_block_core)
//
// Algorithm (the reference's).  W = [A | I] is processed one nb = 32
// diagonal block at a time.  Block step k0 = 0, 32, ...:
//   * the diagonal block D = W[k0:k0+32, k0:k0+32] is inverted by one-hot
//     Gauss-Jordan on the 32 x 64 tile [D | I] whose pivot search stays
//     within the block's rows: at step j the pivot row r is the unpivoted
//     row with the largest |T[r][j]| (a tie goes to the smaller row, a NaN
//     ranks above everything), every other row takes T[a][q] -= (T[a][j] /
//     T[r][j]) * T[r][q], and krow[r] = j, pivd[r] = 1 + (T[r][j] - 1)
//     (float32, as the reference accumulates it); then Dinv[krow[r]] =
//     T[r][32:] / pivd[r];
//   * G = C Dinv for the rows outside the block (C = W[:, k0:k0+32]) and
//     -Dinv on the block rows, and W <- base - G Wb (Wb = W[k0:k0+32, :],
//     base 0 on the block rows): other rows are eliminated, the block rows
//     normalised.  This is the reference's composed G = (C rmask - S) Dinv
//     + S, W -= G Wb: the same products, summed in another order.
// A singular diagonal block (its pivot column all zero among the unpivoted
// rows) turns the lane non-finite; a NaN lane stays NaN.  Nothing traps.
//
// In place.  After block step k0 the left half of W is the identity in
// columns < k0 + 32 and the right half still the identity in columns >=
// n + k0 + 32, and neither is read again.  So one n x n buffer X holds
// the live region, logical column c at physical column c mod n: step k0
// overwrites physical columns k0..k0+31, its pivot columns, with the right
// half's new columns n+k0..n+k0+31, whose entries before the step are
// those of the identity.  After the last step X is A^-1 itself.
//
// Super-panels.  The pivot search never leaves the diagonal block, so the
// block steps of a super-panel of w = 128 columns (four steps; the last
// super-panel 32, 64 or 96 wide when n % 128 != 0) compose without any
// search outside it: each step is T_i = I + V_i E_i^T with E_i selecting
// its 32 rows, and the four compose to T = I + (U - E) E^T, E selecting
// the super-panel's w rows s0..s0+w-1.  U = T E is what the four steps
// make of the n x w column panel when its pivot columns take the identity
// columns' contents (the in-place map above).  So with R = X[s0:s0+w, :]
// before the super-panel (E^T X = R), X <- T X is X + U R on the rows
// outside the super-panel and U R on its own rows: no E is subtracted
// from U, which would cost the panel's small entries their low bits.
// Per super-panel two launches on the caller's stream:
//   (a) lu_panel_kernel: the lane's n x w column panel on chip, in dynamic
//       shared memory (loaded by cp.async), its rows split over a
//       thread-block cluster when one block cannot hold them: cs =
//       min(8, ceil(n / 256)) blocks, one to n = 256, two at 512, four at
//       1024, eight at 2048; past that w drops to 64 and then 32 until
//       n = 6144, and beyond 6144 the panel (and G) lie in a global
//       scratch, w = 128 again, so any n % 32 == 0 runs, as the reference
//       does.  Per block step one warp of the block that
//       owns the 32 diagonal rows runs the serial pivot chain (integer-key
//       warp reductions for the argmax; the pivot row through shared
//       memory as float4 reads; the rows rotate in registers so every
//       index is static) and publishes Dinv, and its other warps publish
//       the block rows Wb; both double buffered.  One barrier (a cluster
//       barrier when split, after which the other blocks copy Dinv and Wb
//       through distributed shared memory), then every block writes G
//       transposed to shared memory and applies the rank-32 step to its
//       own rows in 8 x 8 register tiles.  Lookahead: the block that owns
//       the next step's diagonal rows updates them first, and one warp
//       runs the next chain while the others update the rest, so only the
//       first chain of a super-panel is exposed.  At the end it writes the
//       panel into X's super-panel columns and U^T to scratch.
//   (b) lu_update_kernel: X[:, c] <- base + U R[:, c] over the columns
//       outside the super-panel (base X, 0 on its rows), 128 x 128 tiles
//       of 256 threads with 8 x 8 outputs each, FP32 FMAs on the CUDA
//       cores, the U^T and R tiles through a three-chunk cp.async ring in
//       chunks of 16 and the tile of X brought in behind them, k summed in
//       order from 0 (no atomics, so a repeat run is bit-identical).
// R is a copy, which makes the in-place update safe (it rewrites rows s0
// .. s0+w-1 while other tiles still read them), made without a pass of
// its own: super-panel 0 reads A's rows (A is never copied), and each
// super-panel's launches write the next one's rows to a second buffer as
// they store them (the panel its columns, the update the rest).
//
// What bounds it on an H100.  The function's least work is 2 n^3 flops
// per lane (8.6 GFLOP at B = 256, n = 256: 0.128 ms at the 67 TFLOP/s FP32
// peak); no wgmma, since on float32 operands the tensor cores compute in
// TF32 and the factor path requires full float32 products.  A 32-wide
// step streamed the n x n live region through HBM at 8 flops a byte, half
// the FP32 ridge (~20): n / 32 passes, 1.07 GB at (256, 256).  An update
// of rank w = 128 does 32 flops a byte, above the ridge, in n / 128
// passes; the panels sit in shared memory.  What is left is latency: a
// lane's panel is one block (or one cluster), and its diagonal chains, 32
// dependent pivot steps each, are serial; chip_smoke.py phase 2 splits
// the time between the panel and update launches.
//
// Launch: the entry point launches on the given stream, does not
// synchronise, allocates nothing (X, the U^T / R scratch and, past n =
// 6144, the panel scratch come from the caller), and returns the first
// launch error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <climits>
#include <cmath>
#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int kNb = 32;              // diagonal block = pivot scope
constexpr int kW = 128;              // super-panel width; the scratch's rows
constexpr int kPanelThreads = 256;
constexpr int kBlockRows = 256;      // panel rows a block, where it can
constexpr int kMaxCluster = 8;       // the portable cluster size
constexpr int kTile = 128;           // update tile: kTile x kTile outputs
constexpr int kKc = 16;              // update k chunk
constexpr int kStages = 3;           // update chunks in flight
constexpr int kUpdThreads = 256;     // 16 x 16 threads, 8 x 8 outputs each
constexpr unsigned kFull = 0xffffffffu;

// The panel kernel's working set, in floats: the panel P (rb rows of w +
// 4, padded so a warp's float4 row reads hit every bank once) and a step's
// G transposed (32 x rb), together big(); then small(): the published Wb
// and Dinv (two buffers each; in a cluster the blocks that do not own a
// step copy the owner's into their own), the chain's staging tile and
// pivots.  On chip all of it lies in dynamic shared memory, P first; where
// P and G do not fit, they lie in a global scratch of big() floats a block
// and only small() is shared.
struct Layout {
  int w, rb;
  __host__ __device__ int ld() const { return w + 4; }
  __host__ __device__ size_t gt() const {
    return static_cast<size_t>(rb) * ld();
  }
  __host__ __device__ size_t big() const {
    return gt() + static_cast<size_t>(kNb) * rb;
  }
  __host__ __device__ size_t wpub() const { return 0; }
  __host__ __device__ size_t dpub() const { return wpub() + 2 * kNb * w; }
  __host__ __device__ size_t stage() const { return dpub() + 2 * kNb * kNb; }
  __host__ __device__ size_t pds() const { return stage() + kNb * (kNb + 1); }
  __host__ __device__ size_t small() const { return pds() + kNb; }
  __host__ __device__ size_t bytes(bool onchip) const {
    return 4 * (small() + (onchip ? big() : 0));
  }
};

// The pivot search's order as one unsigned key, larger wins: a pivoted row
// 1, an unpivoted row the bits of |c| plus 2 (a NaN as +inf).  For |c| >= 0
// the bits order as the floats do.
__device__ __forceinline__ unsigned pivot_key(float c, int kr) {
  if (kr >= 0) return 1u;
  return (c != c ? 0x7f800000u : __float_as_uint(fabsf(c))) + 2u;
}

// The best (key, index) over the lanes of a warp, a tie to the smaller
// index; every lane ends with the pair.
__device__ __forceinline__ void warp_argmax(unsigned& key, int& bi) {
  const unsigned wk = __reduce_max_sync(kFull, key);
  bi = static_cast<int>(
      __reduce_min_sync(kFull, key == wk ? static_cast<unsigned>(bi) : ~0u));
  key = wk;
}

// 16 bytes global -> shared, asynchronous; zero-filled when !valid.
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(valid ? 16 : 0));
}

// One warp inverts the 32 x 32 diagonal block D (lane a's row at Drow, a
// float4-aligned row of P) and writes Dinv (row major, 32 x 32) to Dv.
// In place on 32 slots a row: slot j holds D's column j until step j and
// the right half's column rowof[j] after it (e_r - f there at the step).
// The registers rotate, so at step j t[q] holds slot (j + q) mod 32 and
// the pivot column is always t[0].  The pivot row goes through the
// staging tile (one lane's float4 stores, every lane's float4 reads); the
// rank-1 step rounds once (FMA) where the reference's W - f * pivrow rounds
// twice, as gj.cu's panel does.
__device__ void diag_chain(const float* Drow, int a, float* pds, float* stage,
                           float* Dv) {
  float t[kNb];
#pragma unroll
  for (int m = 0; m < kNb / 4; ++m) {
    const float4 v = reinterpret_cast<const float4*>(Drow)[m];
    t[4 * m] = v.x;
    t[4 * m + 1] = v.y;
    t[4 * m + 2] = v.z;
    t[4 * m + 3] = v.w;
  }
  int kr = -1;
  float pd = 1.f;
#pragma unroll 2
  for (int j = 0; j < kNb; ++j) {
    unsigned key = pivot_key(t[0], kr);
    int r = a;
    warp_argmax(key, r);
    if (a == r) {
#pragma unroll
      for (int m = 0; m < kNb / 4; ++m)
        reinterpret_cast<float4*>(stage)[m] =
            make_float4(t[4 * m], t[4 * m + 1], t[4 * m + 2], t[4 * m + 3]);
    }
    __syncwarp();
    float pr[kNb];
#pragma unroll
    for (int m = 0; m < kNb / 4; ++m) {
      const float4 v = reinterpret_cast<const float4*>(stage)[m];
      pr[4 * m] = v.x;
      pr[4 * m + 1] = v.y;
      pr[4 * m + 2] = v.z;
      pr[4 * m + 3] = v.w;
    }
    __syncwarp();
    const float p = pr[0];
    const float f = __fmul_rn(t[0] / p, a == r ? 0.f : 1.f);
#pragma unroll
    for (int q = 1; q < kNb; ++q)
      t[q - 1] = fmaf(-f, pr[q], t[q]);
    t[kNb - 1] = __fsub_rn(a == r ? 1.f : 0.f, f);
    if (a == r) {
      kr = j;
      pd = 1.f + (p - 1.f);
    }
  }
  // Dinv[k][c] = T[rowof[k]][slot krow[c]] / pivd[rowof[k]]; lane a takes
  // column c = a, whose slot is its own krow.  The staging tile's last
  // column holds rowof, pds the pivots by row.
#pragma unroll
  for (int q = 0; q < kNb; ++q) stage[a * (kNb + 1) + q] = t[q];
  stage[kr * (kNb + 1) + kNb] = __int_as_float(a);
  pds[a] = pd;
  __syncwarp();
#pragma unroll 8
  for (int k = 0; k < kNb; ++k) {
    const int rk = __float_as_int(stage[k * (kNb + 1) + kNb]);
    Dv[k * kNb + a] = stage[rk * (kNb + 1) + kr] / pds[rk];
  }
}

// The block rows of a step, Wb (32 x w, row major): the 32 panel rows at
// rows (stride ld) as they stand before the step, the step's own columns
// [q0, q0 + 32) holding the right half's new identity columns.  Threads
// t0, t0 + nt, ... of the caller share the copy.
__device__ __forceinline__ void copy_block_rows(const float* rows, int ld,
                                                int w, int q0, float* Wb,
                                                int t0, int nt) {
  const int w4 = w / 4;
  for (int e = t0; e < kNb * w4; e += nt) {
    const int k = e / w4, q = 4 * (e % w4);
    *reinterpret_cast<float4*>(Wb + k * w + q) =
        q >= q0 && q < q0 + kNb
            ? make_float4(q - q0 == k ? 1.f : 0.f, q + 1 - q0 == k ? 1.f : 0.f,
                          q + 2 - q0 == k ? 1.f : 0.f,
                          q + 3 - q0 == k ? 1.f : 0.f)
            : *reinterpret_cast<const float4*>(rows + k * ld + q);
  }
}

// G for a step, transposed: Gt[k][l] (row stride gld) for the block's rows
// l = t0, t0 + nt, ... < nr, one row a thread: g = C Dinv (C = the row's
// columns [q0, q0 + 32)), -Dinv[d] on the step's own rows (d = l - d0).
__device__ __forceinline__ void g_rows(const float* P, int ld, int nr, int q0,
                                       int d0, const float* Dc, float* Gt,
                                       int gld, int t0, int nt) {
  for (int l = t0; l < nr; l += nt) {
    const int d = l - d0;
    float g[kNb];
    if (d >= 0 && d < kNb) {
#pragma unroll
      for (int m = 0; m < kNb / 4; ++m) {
        const float4 v = reinterpret_cast<const float4*>(Dc + d * kNb)[m];
        g[4 * m] = -v.x;
        g[4 * m + 1] = -v.y;
        g[4 * m + 2] = -v.z;
        g[4 * m + 3] = -v.w;
      }
    } else {
      float c[kNb];
#pragma unroll
      for (int m = 0; m < kNb / 4; ++m) {
        const float4 v = reinterpret_cast<const float4*>(P + l * ld + q0)[m];
        c[4 * m] = v.x;
        c[4 * m + 1] = v.y;
        c[4 * m + 2] = v.z;
        c[4 * m + 3] = v.w;
      }
#pragma unroll
      for (int q = 0; q < kNb; ++q) g[q] = 0.f;
#pragma unroll
      for (int k = 0; k < kNb; ++k) {
#pragma unroll
        for (int m = 0; m < kNb / 4; ++m) {
          const float4 v = reinterpret_cast<const float4*>(Dc + k * kNb)[m];
          g[4 * m] = fmaf(c[k], v.x, g[4 * m]);
          g[4 * m + 1] = fmaf(c[k], v.y, g[4 * m + 1]);
          g[4 * m + 2] = fmaf(c[k], v.z, g[4 * m + 2]);
          g[4 * m + 3] = fmaf(c[k], v.w, g[4 * m + 3]);
        }
      }
    }
#pragma unroll
    for (int k = 0; k < kNb; ++k) Gt[k * gld + l] = g[k];
  }
}

// The step on panel rows: P <- base - G Wb over tiles of TR rows x 8
// columns, TR x 8 outputs a thread, k = 0..31 in order.  The tiles cover
// ngroups groups of TR rows from row lo, skipping the 32 rows from skip
// (-1: none); base is 0 on the step's own rows (l - d0 in [0, 32)) and
// columns [q0, q0 + 32).  Threads t0, t0 + nt, ... share the tiles.
template <int TR>
__device__ __forceinline__ void update_tiles(float* P, int ld, int w,
                                             const float* Gt, int gld,
                                             const float* Wc, int q0, int d0,
                                             int lo, int ngroups, int skip,
                                             int t0, int nt) {
  const int cgs = w / 8;
  for (int t = t0; t < ngroups * cgs; t += nt) {
    const int cg = t % cgs, c0 = 8 * cg;
    int r0 = lo + TR * (t / cgs);
    if (skip >= 0 && r0 >= skip) r0 += kNb;
    float acc[TR][8];
#pragma unroll
    for (int r = 0; r < TR; ++r)
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
#pragma unroll 8
    for (int k = 0; k < kNb; ++k) {
      float a[TR];
#pragma unroll
      for (int r = 0; r < TR; r += 2) {
        const float2 v = *reinterpret_cast<const float2*>(Gt + k * gld + r0 + r);
        a[r] = v.x;
        a[r + 1] = v.y;
      }
      const float4 b0 = *reinterpret_cast<const float4*>(Wc + k * w + c0);
      const float4 b1 = *reinterpret_cast<const float4*>(Wc + k * w + c0 + 4);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < TR; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
#pragma unroll
    for (int r = 0; r < TR; ++r) {
      const int l = r0 + r;
      const bool zrow = l - d0 >= 0 && l - d0 < kNb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = c0 + 4 * h;
        float4* pp = reinterpret_cast<float4*>(P + l * ld + c);
        const float4 base = zrow || (c >= q0 && c < q0 + kNb)
                                ? make_float4(0.f, 0.f, 0.f, 0.f)
                                : *pp;
        *pp = make_float4(base.x - acc[r][4 * h], base.y - acc[r][4 * h + 1],
                          base.z - acc[r][4 * h + 2],
                          base.w - acc[r][4 * h + 3]);
      }
    }
  }
}

// src: the lanes before this super-panel (A at s0 = 0, X after), row
// stride n.  X: the output; the panel's final columns go to X[:, s0:s0+w].
// Ut: (B, 128, n), row q of U^T = panel^T.  Rn: (B, 128, n), rows
// s0 + w .. s0 + w + w1 - 1 of the result (the next super-panel's R), of
// which this launch writes the super-panel's columns and the update the
// others; w1 = 0 for the last super-panel.  One block (kCluster false,
// grid B, rb = n) or a cluster of cs blocks (grid B cs) a lane; block c
// owns rows [c rb, min(n, (c + 1) rb)), rb % 32 == 0 so each diagonal
// block lies in one block.  kGlobal: the block's P and G lie in Pg (big()
// floats a block, in grid order), else in shared memory.
template <bool kCluster, bool kGlobal>
__global__ void __launch_bounds__(kPanelThreads, 1)
lu_panel_kernel(const float* __restrict__ src, float* __restrict__ X,
                float* __restrict__ Ut, float* __restrict__ Rn,
                float* __restrict__ Pg, int n, int s0, int w, int w1, int cs,
                int rb) {
  extern __shared__ __align__(16) float sm[];
  const Layout L{w, rb};
  const int ld = L.ld(), w4 = w / 4;
  float* P = kGlobal ? Pg + blockIdx.x * L.big() : sm;
  float* Gt = P + L.gt();
  float* sh = kGlobal ? sm : sm + L.big();

  const int rank = kCluster ? static_cast<int>(blockIdx.x % cs) : 0;
  const size_t lane = kCluster ? blockIdx.x / cs : blockIdx.x;
  const int r_lo = rank * rb, nr = min(n, r_lo + rb) - r_lo;
  const int tid = threadIdx.x, warp = tid >> 5, ln = tid & 31;
  const float* S = src + lane * n * n;
  float* Xl = X + lane * n * n;
  float* Ul = Ut + lane * kW * n;

  // the block's rows of the column panel, every copy in flight at once
  // (a warp a row, w / 4 <= 32 lanes)
  for (int l = warp; l < nr; l += kPanelThreads / 32) {
    if (ln >= w4) continue;
    const float* from = S + static_cast<size_t>(r_lo + l) * n + s0 + 4 * ln;
    if constexpr (kGlobal)
      *reinterpret_cast<float4*>(P + l * ld + 4 * ln) =
          *reinterpret_cast<const float4*>(from);
    else
      cp_async16(P + l * ld + 4 * ln, from, true);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  // step 0's diagonal chain and block rows; each later step's come from
  // the step before it (the lookahead below)
  const int nsteps = w / kNb;
  if (rank == s0 / rb) {
    const int lk = s0 - rank * rb;
    if (warp == 0)
      diag_chain(P + (lk + ln) * ld, ln, sh + L.pds(), sh + L.stage(),
                 sh + L.dpub());
    else
      copy_block_rows(P + lk * ld, ld, w, 0, sh + L.wpub(), tid - 32,
                      kPanelThreads - 32);
  }
#pragma unroll 1
  for (int i = 0; i < nsteps; ++i) {
    const int buf = i & 1, q0 = kNb * i, k0 = s0 + q0, d0 = k0 - r_lo;
    const int owner = k0 / rb;
    float* Wb = sh + L.wpub() + buf * kNb * w;
    float* Dv = sh + L.dpub() + buf * kNb * kNb;
    if constexpr (kCluster) {
      // the owner's Dinv and Wb into this block's own buffers of the step
      // (no other block reads them at this step)
      cg::cluster_group cl = cg::this_cluster();
      cl.sync();
      if (rank != owner) {
        const float4* Wr =
            reinterpret_cast<const float4*>(cl.map_shared_rank(Wb, owner));
        const float4* Dr =
            reinterpret_cast<const float4*>(cl.map_shared_rank(Dv, owner));
        for (int e = tid; e < kNb * w4; e += kPanelThreads)
          reinterpret_cast<float4*>(Wb)[e] = Wr[e];
        for (int e = tid; e < kNb * kNb / 4; e += kPanelThreads)
          reinterpret_cast<float4*>(Dv)[e] = Dr[e];
      }
    }
    __syncthreads();
    g_rows(P, ld, nr, q0, d0, Dv, Gt, rb, tid, kPanelThreads);
    __syncthreads();

    // Lookahead: the block that owns the next step's diagonal rows updates
    // them first; then warp 0 runs the next chain while the other warps
    // publish the next Wb and update the rest.
    const int k1 = k0 + kNb, lk1 = k1 - r_lo;
    const bool ahead = i + 1 < nsteps && k1 / rb == rank;
    if (ahead) {
      update_tiles<2>(P, ld, w, Gt, rb, Wb, q0, d0, lk1, kNb / 2, -1, tid,
                      kPanelThreads);
      __syncthreads();
      if (warp == 0) {
        diag_chain(P + (lk1 + ln) * ld + q0 + kNb, ln, sh + L.pds(),
                   sh + L.stage(), sh + L.dpub() + (buf ^ 1) * kNb * kNb);
      } else {
        copy_block_rows(P + lk1 * ld, ld, w, q0 + kNb,
                        sh + L.wpub() + (buf ^ 1) * kNb * w, tid - 32,
                        kPanelThreads - 32);
        update_tiles<8>(P, ld, w, Gt, rb, Wb, q0, d0, 0, (nr - kNb) / 8, lk1,
                        tid - 32, kPanelThreads - 32);
      }
    } else {
      update_tiles<8>(P, ld, w, Gt, rb, Wb, q0, d0, 0, nr / 8, -1, tid,
                      kPanelThreads);
    }
  }
  __syncthreads();

  // the panel into X's super-panel columns and the next R's rows, and
  // U^T
  const int s1 = s0 + w;
  float* Rl = Rn + lane * kW * n;
  for (int l = warp; l < nr; l += kPanelThreads / 32) {
    const int r = r_lo + l, q = 4 * ln;
    if (ln >= w4) continue;
    const float4 v = *reinterpret_cast<const float4*>(P + l * ld + q);
    *reinterpret_cast<float4*>(Xl + static_cast<size_t>(r) * n + s0 + q) = v;
    if (r >= s1 && r < s1 + w1)
      *reinterpret_cast<float4*>(Rl + static_cast<size_t>(r - s1) * n + s0 +
                                 q) = v;
  }
  for (int q = warp; q < w; q += kPanelThreads / 32)
    for (int l = ln; l < nr; l += 32)
      Ul[static_cast<size_t>(q) * n + r_lo + l] = P[l * ld + q];
  // the last step's remote reads end before any block of the cluster exits
  if constexpr (kCluster) cg::this_cluster().sync();
}

// X = base + U R over one 128 x 128 tile, outside the super-panel's
// columns [s0, s0 + w); base is src, 0 on the super-panel's rows.  src ==
// X after super-panel 0.  R: rows s0 .. s0
// + w - 1 before the super-panel, row stride n, lane stride r_lane (A
// itself at s0 = 0, else the buffer the last launches filled).  Rows s0 +
// w .. s0 + w + w1 - 1 of the result also go to Rn, the next super-
// panel's R.  The tile of src is brought to shared memory by cp.async
// behind the product.  Thread (tx, ty) owns rows ty*4 + {0..3} and 64 +
// ty*4 + {0..3}, columns likewise in tx.
__global__ void __launch_bounds__(kUpdThreads, 2)
lu_update_kernel(const float* src, float* X, const float* __restrict__ Ut,
                 const float* __restrict__ R, size_t r_lane,
                 float* __restrict__ Rn, int n, int s0, int w, int w1) {
  extern __shared__ __align__(16) float usm[];
  float(*Us)[kKc][kTile] = reinterpret_cast<float(*)[kKc][kTile]>(usm);
  float(*Rs)[kKc][kTile] =
      reinterpret_cast<float(*)[kKc][kTile]>(usm + kStages * kKc * kTile);
  float(*Xs)[kTile] =
      reinterpret_cast<float(*)[kTile]>(usm + 2 * kStages * kKc * kTile);

  const int tiles = (n + kTile - 1) / kTile;
  int bid = blockIdx.x;
  const int tn = bid % tiles;
  bid /= tiles;
  const int tm = bid % tiles;
  const size_t lane = bid / tiles;
  const int i0 = tm * kTile, p0 = tn * kTile;
  if (p0 >= s0 && p0 + kTile <= s0 + w) return;  // the panel's own columns
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const float* Ul = Ut + lane * kW * n;
  const float* Rl = R + lane * r_lane;
  const float* Sl = src + lane * n * n;

  auto load = [&](int kc, int buf) {
    for (int e = tid; e < kKc * kTile / 4; e += kUpdThreads) {
      const int k = e / (kTile / 4), c = 4 * (e % (kTile / 4));
      const size_t row = static_cast<size_t>(kc + k) * n;
      cp_async16(&Us[buf][k][c], Ul + row + min(i0 + c, n - 4), i0 + c < n);
      cp_async16(&Rs[buf][k][c], Rl + row + min(p0 + c, n - 4), p0 + c < n);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };

  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;
  load(0, 0);
  // the base tile, one group after the first chunk's
  for (int e = tid; e < kTile * kTile / 4; e += kUpdThreads) {
    const int a = e / (kTile / 4), c = 4 * (e % (kTile / 4));
    const int i = i0 + a, p = p0 + c;
    const bool ok = i < n && p < n && (p < s0 || p >= s0 + w) &&
                    (i < s0 || i >= s0 + w);
    cp_async16(&Xs[a][c], Sl + (ok ? static_cast<size_t>(i) * n + p : 0), ok);
  }
  asm volatile("cp.async.commit_group;\n" ::);
  const int nk = w / kKc;
  if (nk > 1) load(kKc, 1);
#pragma unroll 1
  for (int t = 0; t < nk; ++t) {
    // chunk t has landed when at most the groups issued after it (the
    // base tile at t = 0, chunk t + 1) are pending
    const int after = (t == 0) + (t + 1 < nk);
    if (after == 2)
      asm volatile("cp.async.wait_group 2;\n" ::: "memory");
    else if (after == 1)
      asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    else
      asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (t + 2 < nk) load((t + 2) * kKc, (t + 2) % kStages);
    const int buf = t % kStages;
#pragma unroll
    for (int k = 0; k < kKc; ++k) {
      const float4 a0 = *reinterpret_cast<const float4*>(&Us[buf][k][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&Us[buf][k][64 + ty * 4]);
      const float4 b0 = *reinterpret_cast<const float4*>(&Rs[buf][k][tx * 4]);
      const float4 b1 =
          *reinterpret_cast<const float4*>(&Rs[buf][k][64 + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int r = 0; r < 8; ++r)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
    }
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int s1 = s0 + w;
  float* Xl = X + lane * n * n;
  float* Rnl = Rn == nullptr ? nullptr : Rn + lane * kW * n;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = 64 * h + 4 * tx, p = p0 + c;
    if (p >= n || (p >= s0 && p < s1)) continue;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int a = 64 * (r / 4) + ty * 4 + r % 4, i = i0 + a;
      if (i >= n) continue;
      const float4 b = *reinterpret_cast<const float4*>(&Xs[a][c]);
      const float4 v =
          make_float4(b.x + acc[r][4 * h], b.y + acc[r][4 * h + 1],
                      b.z + acc[r][4 * h + 2], b.w + acc[r][4 * h + 3]);
      *reinterpret_cast<float4*>(Xl + static_cast<size_t>(i) * n + p) = v;
      if (i >= s1 && i < s1 + w1)
        *reinterpret_cast<float4*>(Rnl + static_cast<size_t>(i - s1) * n + p) =
            v;
    }
  }
}

// The super-panel width, the panel's row split and where it lies: cs =
// min(8, ceil(n / 256)) blocks of rb = ceil(n / cs) rows rounded up to a
// multiple of 32, and the widest w of 128, 64, 32 whose panel fits the
// device's shared memory; at 227 KB a block, w = 128 to n = 2048, 64 to
// 3840, 32 to 6144.  Past that the panel and G go to global scratch (they
// stay in L2 at small B) with w = 128, for any n.
struct Plan {
  int w, cs, rb;
  bool onchip;
};

Plan make_plan(int n, int smem_limit) {
  const int c = min(kMaxCluster, max(1, (n + kBlockRows - 1) / kBlockRows));
  const int r = ((n + c - 1) / c + kNb - 1) / kNb * kNb;
  for (int ww = kW; ww >= kNb; ww /= 2)
    if (Layout{ww, r}.bytes(true) <= static_cast<size_t>(smem_limit))
      return {ww, c, r, true};
  return {kW, c, r, false};
}

cudaError_t device_plan(int n, Plan* plan) {
  int dev = 0, limit = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  e = cudaDeviceGetAttribute(&limit, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev);
  if (e != cudaSuccess) return e;
  *plan = make_plan(n, limit);
  return cudaSuccess;
}

}  // namespace

// The floats of global panel scratch pe_lu_block_inverse32 needs for (B,
// n): 0 where the panel fits on chip; negative on a CUDA error.
extern "C" long long pe_lu_block_panel_floats(int B, int n) {
  Plan pl;
  const cudaError_t e = device_plan(n, &pl);
  if (e != cudaSuccess) return -static_cast<long long>(e);
  return pl.onchip ? 0
                   : static_cast<long long>(B) * pl.cs *
                         static_cast<long long>(Layout{pl.w, pl.rb}.big());
}

// A: (B, n, n); X: (B, n, n) out; Ut: (B, 128, n) and R: (2, B, 128, n)
// scratch (R ping-pongs between super-panels); Pg: the global panel
// scratch of pe_lu_block_panel_floats(B, n) floats (unused when that is 0).
extern "C" int pe_lu_block_inverse32(const float* A, float* X, float* Ut,
                                     float* R, float* Pg, int B, int n,
                                     void* stream) {
  if (B < 1 || n < kNb || n % kNb) return cudaErrorInvalidValue;
  Plan pl;
  cudaError_t e = device_plan(n, &pl);
  if (e != cudaSuccess) return e;
  const int w = pl.w, cs = pl.cs, rb = pl.rb;
  if (!pl.onchip && Pg == nullptr) return cudaErrorInvalidValue;
  const long long tiles = (n + kTile - 1) / kTile;
  if (B * tiles * tiles > INT_MAX || static_cast<long long>(B) * cs > INT_MAX)
    return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the panel launches: one kernel for the call, a cluster of cs blocks a
  // lane where cs > 1
  const auto panel = !pl.onchip ? lu_panel_kernel<true, true>
                     : cs > 1   ? lu_panel_kernel<true, false>
                                : lu_panel_kernel<false, false>;
  e = cudaFuncSetAttribute(panel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Layout{w, rb}.bytes(pl.onchip)));
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * cs);
  cfg.blockDim = dim3(kPanelThreads);
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = cs > 1 ? 1 : 0;
  const int upd_smem = 4 * (2 * kStages * kKc * kTile + kTile * kTile);
  e = cudaFuncSetAttribute(lu_update_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           upd_smem);
  if (e != cudaSuccess) return e;
  const size_t rbuf = static_cast<size_t>(B) * kW * n;
  for (int s0 = 0, sp = 0; s0 < n; s0 += w, ++sp) {
    const int ws = min(w, n - s0), s1 = s0 + ws;
    const int w1 = s1 < n ? min(w, n - s1) : 0;
    const float* src = s0 == 0 ? A : X;
    float* Rn = w1 > 0 ? R + ((sp + 1) & 1) * rbuf : nullptr;
    cfg.dynamicSmemBytes = Layout{ws, rb}.bytes(pl.onchip);
    e = cudaLaunchKernelEx(&cfg, panel, src, X, Ut, Rn, Pg, n, s0, ws, w1, cs,
                           rb);
    if (e != cudaSuccess) return e;
    if (ws == n) continue;  // one super-panel: no column outside it
    // R: A's rows at s0 = 0, else the buffer the last launches filled
    const float* Rc = s0 == 0 ? A + static_cast<size_t>(s0) * n
                              : R + (sp & 1) * rbuf;
    const size_t r_lane = s0 == 0 ? static_cast<size_t>(n) * n
                                  : static_cast<size_t>(kW) * n;
    lu_update_kernel<<<static_cast<int>(B * tiles * tiles), kUpdThreads,
                       upd_smem, s>>>(src, X, Ut, Rc, r_lane, Rn, n, s0, ws,
                                      w1);
    e = cudaGetLastError();
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}
