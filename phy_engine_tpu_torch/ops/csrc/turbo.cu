// Whole-tick digital engine ("turbo") for Hopper (sm_90a).
//
// Replaces the TPU kernel phy_engine_tpu/digital/turbo.py::run_pallas
// (the Pallas call over a grid of T ticks whose (Khi, 512) f32 slab of
// u16 plane halves persists in VMEM).  It computes the same function bit
// for bit: T ticks of B independent instances of a levelled, chunked gate
// graph in 4-state V/U planes, 32 stimulus lanes per 32-bit word.  The
// chunk tables are the plan's own (phy_engine_tpu_torch/digital/turbo.py::
// TurboPlan, identical to the JAX package's): 16 int32 rows per 128-gate
// chunk for the combinational passes, 12 rows per chunk for flip-flops.
//
// Design: one thread block of 128 threads per instance, looping over the
// T ticks inside the block (the TPU's sequential grid becomes that loop).
// Thread i owns slot i of every chunk.  The TPU gathers and scatters with
// one-hot MXU contractions because it has no fast gather; here a gather is
// a plain indexed load from the planes.
//
// State placement (template flag GLOBAL):
//   * shared (GLOBAL = false): V and U as uint32 (K,) arrays in dynamic
//     shared memory, plus the flip-flop segment buffer.  The RV32 core has
//     K = 24,448 slots: 195.6 KB of planes + 10 KB of buffer, inside the
//     227 KB a block may use (the wrapper raises the limit with
//     cudaFuncSetAttribute);
//   * global (GLOBAL = true): the same words in a per-instance scratch in
//     device memory that the wrapper allocates, for designs whose state
//     exceeds shared memory.  Same code; __syncthreads() orders the
//     block's global accesses as it does its shared ones.
//
// Semantics that are easy to get wrong:
//   1. Within a chunk every gate gathers before any gate stores
//      (barrier between gather and store), and a chunk's stores land
//      before the next chunk gathers (barrier after the store).  Chunks run
//      in table order: a sub-level may span several chunks, and the cone,
//      flip-flop and full passes are sequential.
//   2. A flip-flop segment reads a frozen pre-segment snapshot
//      (turbo.py ff_chunk gathers from state_pre): a DFF's d may be another
//      DFF's q of the same segment.  Every FF of the segment computes its
//      new q and last-clock words into the segment buffer (4 words per FF
//      slot) before any is stored.
//   3. Padding slots have valid = 0 and point at the trash slot; they
//      store 0 there, so trash reads 0 after every chunk (the JAX scatter's
//      clear-then-add gives 0 too).
//   4. Forced inputs are stored once per tick, before the cone pass, 128
//      at a time, from (B, T, nf_pad) planes; padding entries store 0 to
//      trash.
//   5. History: all K slots per tick (watch == NULL, run_pallas's output)
//      or only the watched slots (B, T, W), after the full settle.
//
// What bounds it: per instance and tick, the larger of (a) the table
// traffic, 16 int32 rows per gate slot of every chunk (RV32: 914 chunks x
// 128 x 64 B = 7.5 MB, from L2: the tables, 7.5 MB in all, stay resident
// in the 50 MB L2), and (b) the chain of dependent chunks (RV32: 914),
// each costing an L2 round trip for its rows, two shared-memory gathers
// and two block barriers.  With one block per instance, B instances fill
// at most B SMs; the design keeps every plane access on chip (shared
// placement) so the chain's length, not device memory, sets the time.
// Compacting the tables, several chunks per block in flight and cp.async
// prefetch of the next chunk's rows are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 128;

// combinational chunk table rows (turbo.py _R_*)
enum { R_AHI, R_ALO, R_BHI, R_BLO, R_OHI, R_OLO,
       R_INVA, R_INVB, R_INVO, R_VALID, R_CORE0 };
// flip-flop table rows (turbo.py _F_*)
enum { F_DHI, F_DLO, F_CHI, F_CLO, F_RHI, F_RLO, F_QHI, F_QLO,
       F_LHI, F_LLO, F_VALID, F_RSTEN };

struct Args {
  const int* state0;     // (B, 2, K)   V then U planes
  const int* fv;         // (B, T, nf_pad)
  const int* fu;
  const int* f_hi;       // (nf_pad,)  forced slots as hi/lo halves
  const int* f_lo;
  const int* cone;       // (16, cone_w)
  const int* full;       // (16, full_w)
  const int* ff;         // (12, ff_w)
  const int* ff_ranges;  // (n_seg, 2)  chunk range of each FF segment
  const int* watch;      // (width,) or NULL: record all K slots
  int* hv;               // (B, T, width)
  int* hu;
  int* scratch;          // (B, words) for the global placement
  int T, K, nf_pad, cone_w, n_cone, full_w, n_full, ff_w, n_seg,
      max_seg_chunks, width;
};

__device__ __forceinline__ uint32_t ld(const int* tab, int w, int r,
                                       int col) {
  return static_cast<uint32_t>(__ldg(tab + static_cast<size_t>(r) * w + col));
}

__device__ __forceinline__ int slot(const int* tab, int w, int rhi, int rlo,
                                    int col) {
  return __ldg(tab + static_cast<size_t>(rhi) * w + col) * CHUNK +
         __ldg(tab + static_cast<size_t>(rlo) * w + col);
}

// one combinational pass: n chunks of the table, in order
__device__ __forceinline__ void comb_pass(uint32_t* V, uint32_t* U,
                                          const int* tab, int w, int n) {
  const int tid = threadIdx.x;
  for (int li = 0; li < n; ++li) {
    const int col = li * CHUNK + tid;
    const int ia = slot(tab, w, R_AHI, R_ALO, col);
    const int ib = slot(tab, w, R_BHI, R_BLO, col);
    const int io = slot(tab, w, R_OHI, R_OLO, col);
    const uint32_t inv_a = ld(tab, w, R_INVA, col);
    const uint32_t inv_b = ld(tab, w, R_INVB, col);
    const uint32_t inv_o = ld(tab, w, R_INVO, col);
    const uint32_t valid = ld(tab, w, R_VALID, col);
    uint32_t va = V[ia], ua = U[ia], vb = V[ib], ub = U[ib];

    // Kleene cores (turbo.py _chunk_logic)
    va = (va & ~inv_a) | (~va & ~ua & inv_a);
    vb = (vb & ~inv_b) | (~vb & ~ub & inv_b);
    const uint32_t h_a = va & ~ua, l_a = ~va & ~ua;
    const uint32_t h_b = vb & ~ub, l_b = ~vb & ~ub;
    const uint32_t and_v = h_a & h_b;
    const uint32_t and_u = ~(and_v | l_a | l_b);
    const uint32_t or_v = h_a | h_b;
    const uint32_t or_u = ~(or_v | (l_a & l_b));
    const uint32_t known = ~ua & ~ub;
    const uint32_t xor_v = (va ^ vb) & known;
    const uint32_t xor_u = ~known;
    const uint32_t ceq_v = ~(va ^ vb) & ~(ua ^ ub);
    const uint32_t ceq_u = 0u;
    // TRI: a = data, b = enable
    const uint32_t tri_v = (h_b & h_a) | l_b;
    const uint32_t tri_u = (h_b & ua) | l_b | ub;
    // RESOLVE2
    const uint32_t az = ua & va, bz = ub & vb;
    const uint32_t eq = ~(va ^ vb) & ~(ua ^ ub);
    const uint32_t sel_b = az;
    const uint32_t sel_a = ~az & bz;
    const uint32_t sel_e = ~az & ~bz & eq;
    const uint32_t conflict = ~az & ~bz & ~eq;
    const uint32_t res_v = (sel_b & vb) | (sel_a & va) | (sel_e & va);
    const uint32_t res_u = (sel_b & ub) | (sel_a & ua) | (sel_e & ua) |
                           conflict;
    const uint32_t unk_v = ua, unk_u = 0u;

    uint32_t v = and_v, u = and_u;
    const uint32_t cv[6] = {or_v, xor_v, ceq_v, tri_v, res_v, unk_v};
    const uint32_t cu[6] = {or_u, xor_u, ceq_u, tri_u, res_u, unk_u};
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      const uint32_t m = ld(tab, w, R_CORE0 + c, col);
      v = (v & ~m) | (cv[c] & m);
      u = (u & ~m) | (cu[c] & m);
    }
    v = (v & ~inv_o) | (~v & ~u & inv_o);

    __syncthreads();                 // every gather of the chunk is done
    V[io] = v & valid;
    U[io] = u & valid;
    __syncthreads();                 // the chunk's stores are visible
  }
}

// one flip-flop segment: chunks [c0, c1) of the FF table
__device__ __forceinline__ void ff_segment(uint32_t* V, uint32_t* U,
                                           uint32_t* buf, const int* ff,
                                           int w, int c0, int c1) {
  const int tid = threadIdx.x;
  // compute every new q / last clock from the pre-segment planes
  for (int li = c0; li < c1; ++li) {
    const int col = li * CHUNK + tid;
    const int id = slot(ff, w, F_DHI, F_DLO, col);
    const int ic = slot(ff, w, F_CHI, F_CLO, col);
    const int ir = slot(ff, w, F_RHI, F_RLO, col);
    const int iq = slot(ff, w, F_QHI, F_QLO, col);
    const int il = slot(ff, w, F_LHI, F_LLO, col);
    const uint32_t du = U[id], dv = V[id] & ~du;
    const uint32_t cu = U[ic], cv = V[ic] & ~cu;
    const uint32_t au = U[ir], av = V[ir] & ~au;
    uint32_t qv = V[iq], qu = U[iq];
    const uint32_t lcv = V[il], lcu = U[il];
    const uint32_t rise = (~lcv & ~lcu) & (cv & ~cu);
    const uint32_t known = ~cu;
    const uint32_t lcv2 = (lcv & ~known) | (cv & known);
    const uint32_t lcu2 = lcu & ~known;
    qv = (qv & ~rise) | (dv & rise);
    qu = (qu & ~rise) | (du & rise);
    // async reset-low overlay, gated per FF by rst_en
    const uint32_t ren = ld(ff, w, F_RSTEN, col);
    const uint32_t a_l = ~av & ~au & ren;
    const uint32_t a_x = au & ren;
    qv = qv & ~a_l & ~a_x;
    qu = (qu & ~a_l) | a_x;
    const uint32_t valid = ld(ff, w, F_VALID, col);
    uint32_t* b = buf + static_cast<size_t>(li - c0) * 4 * CHUNK;
    b[tid] = qv & valid;
    b[CHUNK + tid] = qu & valid;
    b[2 * CHUNK + tid] = lcv2 & valid;
    b[3 * CHUNK + tid] = lcu2 & valid;
  }
  __syncthreads();                   // the segment read its snapshot
  for (int li = c0; li < c1; ++li) {
    const int col = li * CHUNK + tid;
    const int iq = slot(ff, w, F_QHI, F_QLO, col);
    const int il = slot(ff, w, F_LHI, F_LLO, col);
    const uint32_t* b = buf + static_cast<size_t>(li - c0) * 4 * CHUNK;
    V[iq] = b[tid];
    U[iq] = b[CHUNK + tid];
    V[il] = b[2 * CHUNK + tid];
    U[il] = b[3 * CHUNK + tid];
  }
  __syncthreads();
}

template <bool GLOBAL>
__global__ void __launch_bounds__(CHUNK) turbo_kernel(Args a) {
  extern __shared__ uint32_t smem[];
  const int tid = threadIdx.x;
  const int inst = blockIdx.x;
  const size_t K = static_cast<size_t>(a.K);
  uint32_t* V;
  if (GLOBAL) {
    const size_t words = 2 * K + static_cast<size_t>(a.max_seg_chunks) * 4 * CHUNK;
    V = reinterpret_cast<uint32_t*>(a.scratch) + inst * words;
  } else {
    V = smem;
  }
  uint32_t* U = V + K;
  uint32_t* buf = U + K;

  const uint32_t* s0 = reinterpret_cast<const uint32_t*>(a.state0) + inst * 2 * K;
  for (size_t i = tid; i < K; i += CHUNK) {
    V[i] = s0[i];
    U[i] = s0[K + i];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // 1. forced INPUT words, 128 slots at a time
    const size_t frow = (static_cast<size_t>(inst) * a.T + t) * a.nf_pad;
    for (int c0 = 0; c0 < a.nf_pad; c0 += CHUNK) {
      const int j = c0 + tid;
      const int idx = __ldg(a.f_hi + j) * CHUNK + __ldg(a.f_lo + j);
      V[idx] = static_cast<uint32_t>(__ldg(a.fv + frow + j));
      U[idx] = static_cast<uint32_t>(__ldg(a.fu + frow + j));
      __syncthreads();
    }
    // 2. settle the forced inputs' cone
    comb_pass(V, U, a.cone, a.cone_w, a.n_cone);
    // 3. flip-flops, one frozen snapshot per segment
    for (int s = 0; s < a.n_seg; ++s)
      ff_segment(V, U, buf, a.ff, a.ff_w, __ldg(a.ff_ranges + 2 * s),
                 __ldg(a.ff_ranges + 2 * s + 1));
    // 4. full combinational settle
    comb_pass(V, U, a.full, a.full_w, a.n_full);
    // 5. history
    const size_t hrow = (static_cast<size_t>(inst) * a.T + t) * a.width;
    for (int i = tid; i < a.width; i += CHUNK) {
      const int s = a.watch ? __ldg(a.watch + i) : i;
      a.hv[hrow + i] = static_cast<int>(V[s]);
      a.hu[hrow + i] = static_cast<int>(U[s]);
    }
    __syncthreads();                 // history read before the next stores
  }
}

}  // namespace

extern "C" {

// The largest dynamic shared memory a block of this device may opt in to
// (bytes), or minus the CUDA error.
int pe_turbo_smem_limit() {
  int dev = 0, v = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  e = cudaDeviceGetAttribute(&v, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return -static_cast<int>(e);
  return v;
}

int pe_turbo_run(const void* state0, const void* fv, const void* fu,
                 const void* f_hi, const void* f_lo, const void* cone,
                 const void* full, const void* ff, const void* ff_ranges,
                 const void* watch, void* hv, void* hu, void* scratch,
                 int B, int T, int K, int nf_pad, int cone_w, int n_cone,
                 int full_w, int n_full, int ff_w, int n_seg,
                 int max_seg_chunks, int width, int global_state,
                 void* stream) {
  Args a;
  a.state0 = static_cast<const int*>(state0);
  a.fv = static_cast<const int*>(fv);
  a.fu = static_cast<const int*>(fu);
  a.f_hi = static_cast<const int*>(f_hi);
  a.f_lo = static_cast<const int*>(f_lo);
  a.cone = static_cast<const int*>(cone);
  a.full = static_cast<const int*>(full);
  a.ff = static_cast<const int*>(ff);
  a.ff_ranges = static_cast<const int*>(ff_ranges);
  a.watch = static_cast<const int*>(watch);
  a.hv = static_cast<int*>(hv);
  a.hu = static_cast<int*>(hu);
  a.scratch = static_cast<int*>(scratch);
  a.T = T; a.K = K; a.nf_pad = nf_pad;
  a.cone_w = cone_w; a.n_cone = n_cone;
  a.full_w = full_w; a.n_full = n_full;
  a.ff_w = ff_w; a.n_seg = n_seg; a.max_seg_chunks = max_seg_chunks;
  a.width = width;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (global_state) {
    turbo_kernel<true><<<B, CHUNK, 0, s>>>(a);
  } else {
    const size_t bytes =
        (2 * static_cast<size_t>(K) +
         static_cast<size_t>(max_seg_chunks) * 4 * CHUNK) * sizeof(uint32_t);
    cudaError_t e = cudaFuncSetAttribute(
        turbo_kernel<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes));
    if (e != cudaSuccess) return static_cast<int>(e);
    turbo_kernel<false><<<B, CHUNK, bytes, s>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
