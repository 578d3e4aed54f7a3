// Partitioned tridiagonal solve x = T^-1 b in float64, for Hopper
// (sm_90a): Thomas within chunks, the chunks' separators solved as a
// smaller tridiagonal system of the same kind, recursively, then the
// chunks re-solved with their separators known.  Two forms, each its own
// instantiation (kLane): one T shared by every lane (the bordered
// ladder), and one T a lane (bt coefficient lanes; the sparse route's
// chain preconditioner, whose band has its own values in every lane).
//
// Replaces no TPU kernel: the JAX package solves the bordered ladder by
// parallel cyclic reduction in XLA (phy_engine_tpu/ops/tridiag.py::
// tridiag_solve, border_solve).  The port's plain twin is
// phy_engine_tpu_torch/ops/tridiag.py::part_factor_plain /
// part_solve_plain, the same levels and the same operations in the same
// order; ops/tridiag.py::PartitionFactor launches this kernel for CUDA
// tensors.  PCR at N = 10^6 runs 20 rounds of shifts and multiply-adds,
// some 14 passes over (B, N) a round; this is two passes over b and one
// over x, whatever N.
//
// The function.  A level is a tridiagonal system of n rows (sub a, diagonal
// d, super c; a[0] and c[n-1] are ignored) cut into C = ceil(n / kM)
// chunks of kM rows, rows past n being identity rows with a zero right
// side.  In chunk k, rows kM .. kM+kM-2 are its interior and row s_k =
// kM+kM-1 its separator.  Eliminating every interior leaves a tridiagonal
// system in the C separators (the Schur complement, an M-matrix again
// where T is one), which is the next level; a level of at most 64 rows
// (tridiag.py's PART_DIRECT, the host's choice) is solved by Thomas over
// all its rows, one thread a lane.
//   interior: y = T_k^-1 r_k (r_k the interior's right side), Thomas with
//     pivots p_j = d_j - w_j c_{j-1}, ip_j = 1 / p_j, w_j = a_j ip_{j-1},
//     t_j = c_j ip_j:  z_j = r_j - w_j z_{j-1},  y_j = z_j ip_j - t_j y_{j+1}
//   spikes:   gl = T_k^-1 (a_{kM} e_0),  gr = T_k^-1 (c_{s_k - 1} e_last)
//   next level, row k: a' = -a_{s_k} gl_k[last],
//     d' = d_{s_k} - a_{s_k} gr_k[last] - c_{s_k} gl_{k+1}[0],
//     c' = -c_{s_k} gr_{k+1}[0],
//     rhs' = P_k - Q_{k+1}, P_k = b_{s_k} - a_{s_k} y_k[last],
//     Q_k = c_{s_{k-1}} y_k[0]  (so a chunk writes only its own P and Q)
//   back: x on chunk k's interior = T_k^-1 (r_k - a_{kM} x_{s_{k-1}} e_0
//     - c_{s_k - 1} x_{s_k} e_last), and x at s_k from the level below.
// Every product, quotient and difference is rounded on its own (__dmul_rn,
// __ddiv_rn, __dsub_rn: no FMA), in the twin's order, so the kernel and the
// twin agree bit for bit; no atomics, so a repeat run is bit-identical.
// Thomas on a diagonally dominant M-matrix is componentwise stable, which
// a ladder Laplacian (condition ~N^2) needs.
//
// What bounds it on an H100: bytes.  At the ladder cell's (16, 10^6) a
// solve reads b (128 MB) in the first sweep and again in the last, and
// writes x (128 MB); the coefficients (three (kM-1, C) float64 arrays, 23
// MB at N = 10^6) are shared by the lanes.  The lower levels (31,250 and
// 977 rows a lane) stay in L2.  Least bytes: b read once, x written once,
// every level's factor once: 283 MB, 0.084 ms at 3.35 TB/s; this design
// moves ~410 MB.  Measured on an H100 80GB HBM3 at 700 W (PERF.md): 0.238
// ms a (16, 10^6) solve, 2.8x that bound, against 17.3 ms for one PCR
// solve; the factor 0.146 ms.
//
// The per-lane form (the *_lanes64 entries): T is (bt, n), a level's w,
// ip, t (bt, 31, C), edge (bt, 10, C), the last level's (bt, n); the
// right side is (R, n), R a multiple of bt, row r taking coefficient lane
// r mod bt (so a factor's k border columns solve as one (k bt, n) call),
// its rows ld apart at the top level (a band sliced from wider rows needs
// no copy).  Nothing is shared between lanes, so a unit stages its own
// coefficients, by cp.async straight into shared memory (93 copies a
// thread in flight, no registers), read coalesced: (lane, row-in-chunk,
// chunk) puts a group's 32 chunks side by side.  At the chain cell's (64,
// 10^5) a solve reads b twice, the top level's coefficients twice (149
// MB each) and writes x: ~460 MB.
//
// Design.  One warp a block, a thread a chunk: a block takes a contiguous
// run of units (a unit is one lane of a group of kP = 32 chunks, 1,024
// rows; units run group by group, lane by lane), and the grid holds as many
// blocks as fit on the card at once (seven one-warp blocks an SM by shared
// memory), so every block gets the same work to one unit.  A block stages
// its group's coefficients in shared memory once for all the lanes of its
// run, so L2 serves them about once a group, not once a lane; for each
// unit it stages the right side's 1,024 rows (32 loads in flight a thread),
// a row of kM + 1 doubles a chunk so the threads' column reads do not
// conflict, and each thread runs its chunk's interior in registers (kM - 1
// = 31 rows, unrolled).  part_sweep<false> (reduce) writes P and Q;
// part_sweep<true> (expand) writes x through the tile, coalesced.  A solve
// at N = 10^6 is three reduces (10^6 -> 31,250 -> 977 -> 31 rows), one
// direct and three expands; the factor two launches a level and one direct.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace {

constexpr int kM = 32;            // rows a chunk: kI interior, 1 separator
constexpr int kI = kM - 1;
constexpr int kP = 32;            // chunks a block: one warp, a thread each
static_assert(kP == kM, "the tile's loads take row it of chunk it");
constexpr int kPad = kM + 1;      // a chunk's row in the shared tile
constexpr int kFactorThreads = 128;
constexpr int kDirectThreads = 128;

// edge rows, each (C,): the couplings of chunk k and its spikes' tips
enum Edge { kA0, kCl, kAs, kCq, kDs, kCs, kGlF, kGlL, kGrF, kGrL, kEdges };

__device__ __forceinline__ double mul(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ double sub(double a, double b) {
  return __dsub_rn(a, b);
}
__device__ __forceinline__ double quo(double a, double b) {
  return __ddiv_rn(a, b);
}

// y = T_k^-1 r in place over the kI interior rows of a chunk; w(j), ip(j)
// and t(j) give the chunk's coefficients of interior row j.
template <typename W, typename IP, typename Tt>
__device__ __forceinline__ void interior(double (&r)[kI], W w, IP ip,
                                         Tt t) {
#pragma unroll
  for (int j = 1; j < kI; ++j) r[j] = sub(r[j], mul(w(j), r[j - 1]));
  r[kI - 1] = mul(r[kI - 1], ip(kI - 1));
#pragma unroll
  for (int j = kI - 2; j >= 0; --j)
    r[j] = sub(mul(r[j], ip(j)), mul(t(j), r[j + 1]));
}

// The level's right side at row i of a lane: p[i] - q[i + 1] (q null at the
// top level, and read only below n).
__device__ __forceinline__ double rhs(const double* __restrict__ p,
                                      const double* __restrict__ q,
                                      long long off, long long i, int n) {
  double v = __ldg(p + off + i);
  if (q != nullptr && i + 1 < n) v = sub(v, __ldg(q + off + i + 1));
  return v;
}

// A unit's right side in two steps, so that the next unit's loads are in
// flight while the block solves this one.  load_p: this thread's rows of
// the group (row, row + kP, ...; kP == kM, so its row it of chunk it), p's
// values, zeros past n, every load issued before any is used.  to_tile:
// subtract q[+1] (0.0 past n - 1, which leaves p as it is) and store them
// in the tile.
__device__ __forceinline__ void load_p(double (&v)[kM],
                                       const double* __restrict__ p,
                                       long long off, long long row, int n) {
#pragma unroll
  for (int it = 0; it < kM; ++it) {
    const long long i = row + it * kP;
    v[it] = i < n ? __ldg(p + off + i) : 0.0;
  }
}

__device__ __forceinline__ void to_tile(double* tile, double (&v)[kM],
                                        const double* __restrict__ q,
                                        long long off, long long row, int n) {
  if (q != nullptr) {
#pragma unroll
    for (int it = 0; it < kM; ++it) {
      const long long i = row + it * kP;
      v[it] = sub(v[it], i + 1 < n ? __ldg(q + off + i + 1) : 0.0);
    }
  }
#pragma unroll
  for (int it = 0; it < kM; ++it) tile[it * kPad + threadIdx.x] = v[it];
}

// A block's sweep over its run of units.  A unit is one lane of one group
// of kP chunks; units run group by group, lane by lane within a group, and
// a block takes a contiguous run of them (so the grid is balanced to one
// unit), staging a group's coefficients in shared memory once for all the
// lanes of its run (kLane: once a unit, from the unit's coefficient lane,
// by cp.async).  For each unit it stages the right side's kP kM rows in
// the tile (coalesced), then each thread solves its chunk's interior in
// registers.  Reduce writes the next level's P and Q; expand writes x
// through the tile, coalesced.  kLane: p's rows lie ld apart (q's, P's,
// Q's and x's are dense); bt coefficient lanes.
template <bool kExpand, bool kLane>
__global__ void __launch_bounds__(kP)
part_sweep(const double* __restrict__ p, const double* __restrict__ q, int n,
           int C, int B, long long units, const double* __restrict__ w,
           const double* __restrict__ ip, const double* __restrict__ t,
           const double* __restrict__ edge, const double* __restrict__ xs_in,
           double* __restrict__ out0, double* __restrict__ out1, int bt,
           long long ld) {
  __shared__ double coef[3][kI][kP];
  __shared__ double tile[kP * kPad];
  const int tid = threadIdx.x;
  const long long u0 = blockIdx.x * units / gridDim.x;
  const long long u1 = (blockIdx.x + 1) * units / gridDim.x;
  const long long cc = C;
  double* col = tile + tid * kPad;
  int staged = -1;
  long long staged_lane = -1;
  // unit u's lane offset and first row of this thread
  auto at = [&](long long u, long long* off, long long* row) {
    const long long g = u / B;
    if constexpr (kLane) {
      *off = (u - g * B) * ld;
    } else {
      *off = (u - g * B) * n;
    }
    *row = g * kP * kM + tid;
  };
  double v[kM];
  long long off, row;
  if (u0 < u1) {
    at(u0, &off, &row);
    load_p(v, p, off, row, n);
  }
  for (long long u = u0; u < u1; ++u) {
    const int g = static_cast<int>(u / B);
    const int lane = static_cast<int>(u - static_cast<long long>(g) * B);
    const int k = g * kP + tid;
    const int cl = kLane ? lane % bt : 0;    // the unit's coefficient lane
    const double* eg = edge + static_cast<long long>(cl) * kEdges * cc;
    __syncthreads();                 // the last unit is done with both
    if constexpr (kLane) {
      // a thread reads back only its own column: no barrier needed
      const long long key = static_cast<long long>(g) * bt + cl;
      if (key != staged_lane && k < C) {
        const long long c0 = static_cast<long long>(cl) * kI * cc + k;
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          __pipeline_memcpy_async(&coef[0][j][tid], w + c0 + j * cc, 8);
          __pipeline_memcpy_async(&coef[1][j][tid], ip + c0 + j * cc, 8);
          __pipeline_memcpy_async(&coef[2][j][tid], t + c0 + j * cc, 8);
        }
        __pipeline_commit();
      }
      staged_lane = key;
    } else {
      if (g != staged && k < C) {
#pragma unroll
        for (int j = 0; j < kI; ++j) {
          coef[0][j][tid] = __ldg(w + j * cc + k);
          coef[1][j][tid] = __ldg(ip + j * cc + k);
          coef[2][j][tid] = __ldg(t + j * cc + k);
        }
      }
      staged = g;
    }
    const long long row0 = static_cast<long long>(g) * kP * kM;
    to_tile(tile, v, q, off, row, n);
    __syncthreads();
    if (u + 1 < u1) {
      at(u + 1, &off, &row);
      load_p(v, p, off, row, n);
    }
    const long long loff = static_cast<long long>(lane) * C;
    if constexpr (kLane) __pipeline_wait_prior(0);
    if (k < C) {
      double r[kI];
#pragma unroll
      for (int j = 0; j < kI; ++j) r[j] = col[j];
      auto W = [&](int j) { return coef[0][j][tid]; };
      auto IP = [&](int j) { return coef[1][j][tid]; };
      auto Tt = [&](int j) { return coef[2][j][tid]; };
      if (!kExpand) {
        interior(r, W, IP, Tt);
        // out0 = P, out1 = Q of the next level
        out0[loff + k] = sub(col[kM - 1], mul(__ldg(eg + kAs * cc + k),
                                              r[kI - 1]));
        out1[loff + k] = mul(__ldg(eg + kCq * cc + k), r[0]);
      } else {
        const double xs = __ldg(xs_in + loff + k);
        const double xp = k > 0 ? __ldg(xs_in + loff + k - 1) : 0.0;
        r[0] = sub(r[0], mul(__ldg(eg + kA0 * cc + k), xp));
        r[kI - 1] = sub(r[kI - 1], mul(__ldg(eg + kCl * cc + k), xs));
        interior(r, W, IP, Tt);
#pragma unroll
        for (int j = 0; j < kI; ++j) col[j] = r[j];
        col[kM - 1] = xs;
      }
    }
    if (kExpand) {
      __syncthreads();
      const long long xoff = static_cast<long long>(lane) * n;
#pragma unroll
      for (int it = 0; it < kM; ++it) {
        const long long i = row0 + tid + it * kP;
        if (i < n) out0[xoff + i] = tile[it * kPad + tid];
      }
    }
  }
}

// The grid of a sweep: as many blocks as fit on the card at once (the
// shared memory carved out to the most), at most one a unit.  Returns 0
// and sets *blocks, or a CUDA error.
template <bool kExpand, bool kLane>
int sweep_blocks(long long units, long long* blocks) {
  static int per_device[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (per_device[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(part_sweep<kExpand, kLane>,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, part_sweep<kExpand, kLane>, kP, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    per_device[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *blocks = units < per_device[dev] ? units : per_device[dev];
  return cudaSuccess;
}

template <bool kExpand, bool kLane>
int sweep(const double* p, const double* q, int n, int B, const double* w,
          const double* ip, const double* t, const double* edge,
          const double* xs, double* out0, double* out1, int bt, long long ld,
          void* stream) {
  if (n < 1 || B < 1) return cudaErrorInvalidValue;
  if (kLane && (bt < 1 || B % bt != 0 || ld < n))
    return cudaErrorInvalidValue;
  const int C = (n + kM - 1) / kM;
  const long long units = static_cast<long long>((C + kP - 1) / kP) * B;
  long long blocks = 0;
  const int err = sweep_blocks<kExpand, kLane>(units, &blocks);
  if (err != cudaSuccess) return err;
  part_sweep<kExpand, kLane><<<static_cast<unsigned>(blocks), kP, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      p, q, n, C, B, units, w, ip, t, edge, xs, out0, out1, bt, ld);
  return static_cast<int>(cudaGetLastError());
}

// One thread a lane: Thomas over the whole (small) level, z kept in x.
// kLane: coefficients (bt, n), row r's from lane r mod bt; p's rows ld
// apart.
template <bool kLane>
__global__ void __launch_bounds__(kDirectThreads)
part_direct(const double* __restrict__ p, const double* __restrict__ q,
            int n, int B, const double* __restrict__ w,
            const double* __restrict__ ip, const double* __restrict__ t,
            double* __restrict__ x, int bt, long long ld) {
  const int lane = blockIdx.x * kDirectThreads + threadIdx.x;
  if (lane >= B) return;
  const long long xo = static_cast<long long>(lane) * n;
  const long long off = kLane ? lane * ld : xo;
  if constexpr (kLane) {
    const long long c0 = static_cast<long long>(lane % bt) * n;
    w += c0;
    ip += c0;
    t += c0;
  }
  double z = rhs(p, q, off, 0, n);
  x[xo] = z;
  for (int i = 1; i < n; ++i) {
    z = sub(rhs(p, q, off, i, n), mul(__ldg(w + i), z));
    x[xo + i] = z;
  }
  double y = mul(z, __ldg(ip + n - 1));
  x[xo + n - 1] = y;
  for (int i = n - 2; i >= 0; --i) {
    y = sub(mul(x[xo + i], __ldg(ip + i)), mul(__ldg(t + i), y));
    x[xo + i] = y;
  }
}

// The level's diagonals with the ignored corners and the identity rows
// past n.
struct Diags {
  const double* a;
  const double* d;
  const double* c;
  int n;
  __device__ double A(long long i) const {
    return i <= 0 || i >= n ? 0.0 : a[i];
  }
  __device__ double D(long long i) const { return i >= n ? 1.0 : d[i]; }
  __device__ double Cs(long long i) const {
    return i < 0 || i >= n - 1 ? 0.0 : c[i];
  }
};

// One thread a chunk: the interior's Thomas factor, its couplings and its
// two spikes' tips.  kLane: one thread a (lane, chunk) of bt lanes, T's
// diagonals (bt, n), the outputs (bt, 31, C) and (bt, 10, C).
template <bool kLane>
__global__ void __launch_bounds__(kFactorThreads)
part_factor_chunks(Diags T, int C, double* __restrict__ w,
                   double* __restrict__ ip, double* __restrict__ t,
                   double* __restrict__ edge, int bt) {
  int k = blockIdx.x * kFactorThreads + threadIdx.x;
  const long long cc = C;
  if constexpr (kLane) {
    if (k >= bt * C) return;
    const int lane = k / C;
    k -= lane * C;
    const long long d0 = static_cast<long long>(lane) * T.n;
    T.a += d0;
    T.d += d0;
    T.c += d0;
    w += lane * kI * cc;
    ip += lane * kI * cc;
    t += lane * kI * cc;
    edge += lane * kEdges * cc;
  } else {
    if (k >= C) return;
  }
  const long long r0 = static_cast<long long>(k) * kM;
  // the coefficients stay in registers for the spikes: what this kernel
  // writes it may not read back through the read-only path
  double wl[kI], ipl[kI], tl[kI];
  wl[0] = 0.0;
  ipl[0] = quo(1.0, T.D(r0));
  tl[0] = mul(T.Cs(r0), ipl[0]);
#pragma unroll
  for (int j = 1; j < kI; ++j) {
    wl[j] = mul(T.A(r0 + j), ipl[j - 1]);
    ipl[j] = quo(1.0, sub(T.D(r0 + j), mul(wl[j], T.Cs(r0 + j - 1))));
    tl[j] = mul(T.Cs(r0 + j), ipl[j]);
  }
#pragma unroll
  for (int j = 0; j < kI; ++j) {
    w[j * cc + k] = wl[j];
    ip[j * cc + k] = ipl[j];
    t[j * cc + k] = tl[j];
  }
  const double a0 = T.A(r0);
  const double cl = T.Cs(r0 + kI - 1);
  double gl[kI], gr[kI];
#pragma unroll
  for (int j = 0; j < kI; ++j) gl[j] = gr[j] = 0.0;
  gl[0] = a0;
  gr[kI - 1] = cl;
  auto W = [&](int j) { return wl[j]; };
  auto IP = [&](int j) { return ipl[j]; };
  auto Tt = [&](int j) { return tl[j]; };
  interior(gl, W, IP, Tt);
  interior(gr, W, IP, Tt);
  edge[kA0 * cc + k] = a0;
  edge[kCl * cc + k] = cl;
  edge[kAs * cc + k] = T.A(r0 + kM - 1);
  edge[kCq * cc + k] = T.Cs(r0 - 1);
  edge[kDs * cc + k] = T.D(r0 + kM - 1);
  edge[kCs * cc + k] = T.Cs(r0 + kM - 1);
  edge[kGlF * cc + k] = gl[0];
  edge[kGlL * cc + k] = gl[kI - 1];
  edge[kGrF * cc + k] = gr[0];
  edge[kGrL * cc + k] = gr[kI - 1];
}

// One thread a separator: the next level's row.  kLane: a (lane,
// separator) of bt lanes, the next level's diagonals (bt, C).
template <bool kLane>
__global__ void __launch_bounds__(kFactorThreads)
part_factor_reduce(const double* __restrict__ edge, int C,
                   double* __restrict__ a2, double* __restrict__ d2,
                   double* __restrict__ c2, int bt) {
  int k = blockIdx.x * kFactorThreads + threadIdx.x;
  const long long cc = C;
  if constexpr (kLane) {
    if (k >= bt * C) return;
    const int lane = k / C;
    k -= lane * C;
    edge += lane * kEdges * cc;
    a2 += lane * cc;
    d2 += lane * cc;
    c2 += lane * cc;
  } else {
    if (k >= C) return;
  }
  const double as = edge[kAs * cc + k];
  const double cs = edge[kCs * cc + k];
  const double glf = k + 1 < C ? edge[kGlF * cc + k + 1] : 0.0;
  const double grf = k + 1 < C ? edge[kGrF * cc + k + 1] : 0.0;
  a2[k] = -mul(as, edge[kGlL * cc + k]);
  d2[k] = sub(sub(edge[kDs * cc + k], mul(as, edge[kGrL * cc + k])),
              mul(cs, glf));
  c2[k] = -mul(cs, grf);
}

// One thread: Thomas's factor of the whole (small) last level.  kLane:
// one thread a lane of bt, T's diagonals and w, ip, t (bt, n).
template <bool kLane>
__global__ void part_direct_factor(Diags T, double* __restrict__ w,
                                   double* __restrict__ ip,
                                   double* __restrict__ t, int bt) {
  if constexpr (kLane) {
    const int lane = blockIdx.x * blockDim.x + threadIdx.x;
    if (lane >= bt) return;
    const long long d0 = static_cast<long long>(lane) * T.n;
    T.a += d0;
    T.d += d0;
    T.c += d0;
    w += d0;
    ip += d0;
    t += d0;
  } else {
    if (threadIdx.x != 0 || blockIdx.x != 0) return;
  }
  double ipv = quo(1.0, T.D(0));
  w[0] = 0.0;
  ip[0] = ipv;
  t[0] = mul(T.Cs(0), ipv);
  for (int i = 1; i < T.n; ++i) {
    const double wi = mul(T.A(i), ipv);
    ipv = quo(1.0, sub(T.D(i), mul(wi, T.Cs(i - 1))));
    w[i] = wi;
    ip[i] = ipv;
    t[i] = mul(T.Cs(i), ipv);
  }
}

int chunks(int n) { return (n + kM - 1) / kM; }

template <bool kLane>
int factor(const double* a, const double* d, const double* c, int n, int bt,
           double* w, double* ip, double* t, double* edge, double* a2,
           double* d2, double* c2, void* stream) {
  if (n < 1 || bt < 1) return cudaErrorInvalidValue;
  const int C = chunks(n);
  const long long rows = kLane ? static_cast<long long>(bt) * C : C;
  const unsigned blocks = (rows + kFactorThreads - 1) / kFactorThreads;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  part_factor_chunks<kLane><<<blocks, kFactorThreads, 0, st>>>(
      Diags{a, d, c, n}, C, w, ip, t, edge, bt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  part_factor_reduce<kLane><<<blocks, kFactorThreads, 0, st>>>(
      edge, C, a2, d2, c2, bt);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLane>
int direct_factor(const double* a, const double* d, const double* c, int n,
                  int bt, double* w, double* ip, double* t, void* stream) {
  if (n < 1 || bt < 1) return cudaErrorInvalidValue;
  const unsigned blocks = kLane ? (bt + kDirectThreads - 1) / kDirectThreads
                                : 1;
  part_direct_factor<kLane><<<blocks, kLane ? kDirectThreads : 32, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      Diags{a, d, c, n}, w, ip, t, bt);
  return static_cast<int>(cudaGetLastError());
}

template <bool kLane>
int direct(const double* p, const double* q, int n, int B, int bt,
           long long ld, const double* w, const double* ip, const double* t,
           double* x, void* stream) {
  if (n < 1 || B < 1) return cudaErrorInvalidValue;
  if (kLane && (bt < 1 || B % bt != 0 || ld < n))
    return cudaErrorInvalidValue;
  const unsigned blocks = (B + kDirectThreads - 1) / kDirectThreads;
  part_direct<kLane><<<blocks, kDirectThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      p, q, n, B, w, ip, t, x, bt, ld);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The factor of one level of n > 0 rows (C = ceil(n / 32) chunks): w, ip,
// t (31, C) and edge (10, C), then the next level's diagonals a2, d2, c2
// (C,).  Two launches on `stream`; returns cudaGetLastError().
extern "C" int pe_tridiag_part_factor64(const double* a, const double* d,
                                        const double* c, int n, double* w,
                                        double* ip, double* t, double* edge,
                                        double* a2, double* d2, double* c2,
                                        void* stream) {
  return factor<false>(a, d, c, n, 1, w, ip, t, edge, a2, d2, c2, stream);
}

// Thomas's factor of the last level (n rows): w, ip, t (n,).  One launch.
extern "C" int pe_tridiag_part_direct_factor64(const double* a,
                                               const double* d,
                                               const double* c, int n,
                                               double* w, double* ip,
                                               double* t, void* stream) {
  return direct_factor<false>(a, d, c, n, 1, w, ip, t, stream);
}

// One level's first sweep for B lanes: right side p - q[+1] (B, n) (q null
// at the top level), writing the next level's P and Q (B, C).  One launch.
extern "C" int pe_tridiag_part_reduce64(const double* p, const double* q,
                                        int n, int B, const double* w,
                                        const double* ip, const double* t,
                                        const double* edge, double* p2,
                                        double* q2, void* stream) {
  return sweep<false, false>(p, q, n, B, w, ip, t, edge, nullptr, p2, q2, 1,
                             n, stream);
}

// One level's last sweep: the same right side and the separators' values
// xs (B, C) from the level below, writing x (B, n).  One launch.
extern "C" int pe_tridiag_part_expand64(const double* p, const double* q,
                                        int n, int B, const double* w,
                                        const double* ip, const double* t,
                                        const double* edge, const double* xs,
                                        double* x, void* stream) {
  return sweep<true, false>(p, q, n, B, w, ip, t, edge, xs, x, nullptr, 1, n,
                            stream);
}

// The last level solved by Thomas, one thread a lane: right side p - q[+1]
// (B, n), x (B, n).  One launch.
extern "C" int pe_tridiag_part_direct64(const double* p, const double* q,
                                        int n, int B, const double* w,
                                        const double* ip, const double* t,
                                        double* x, void* stream) {
  return direct<false>(p, q, n, B, 1, n, w, ip, t, x, stream);
}

// The per-lane form of each entry above: bt coefficient lanes, T's
// diagonals (bt, n), every factor array with a leading bt; B right sides,
// a multiple of bt, row r solved with lane r mod bt's coefficients; ld
// the distance between p's rows (n below the top level, where q is not
// null).

extern "C" int pe_tridiag_part_factor_lanes64(
    const double* a, const double* d, const double* c, int n, int bt,
    double* w, double* ip, double* t, double* edge, double* a2, double* d2,
    double* c2, void* stream) {
  return factor<true>(a, d, c, n, bt, w, ip, t, edge, a2, d2, c2, stream);
}

extern "C" int pe_tridiag_part_direct_factor_lanes64(
    const double* a, const double* d, const double* c, int n, int bt,
    double* w, double* ip, double* t, void* stream) {
  return direct_factor<true>(a, d, c, n, bt, w, ip, t, stream);
}

extern "C" int pe_tridiag_part_reduce_lanes64(
    const double* p, const double* q, int n, int B, int bt, long long ld,
    const double* w, const double* ip, const double* t, const double* edge,
    double* p2, double* q2, void* stream) {
  return sweep<false, true>(p, q, n, B, w, ip, t, edge, nullptr, p2, q2, bt,
                            ld, stream);
}

extern "C" int pe_tridiag_part_expand_lanes64(
    const double* p, const double* q, int n, int B, int bt, long long ld,
    const double* w, const double* ip, const double* t, const double* edge,
    const double* xs, double* x, void* stream) {
  return sweep<true, true>(p, q, n, B, w, ip, t, edge, xs, x, nullptr, bt,
                           ld, stream);
}

extern "C" int pe_tridiag_part_direct_lanes64(
    const double* p, const double* q, int n, int B, int bt, long long ld,
    const double* w, const double* ip, const double* t, double* x,
    void* stream) {
  return direct<true>(p, q, n, B, bt, ld, w, ip, t, x, stream);
}
