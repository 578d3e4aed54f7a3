// Whole-tick digital engine ("turbo") for Hopper (sm_90a).
//
// Replaces the TPU kernel phy_engine_tpu/digital/turbo.py::run_pallas
// (the Pallas call over a grid of T ticks whose (Khi, 512) f32 slab of
// u16 plane halves persists in VMEM).  It computes the same function bit
// for bit: T ticks of B independent instances of a levelled, chunked gate
// graph in 4-state V/U planes, 32 stimulus lanes per 32-bit word.
//
// It runs from the gate-level schedule that the host derives from the
// plan's chunk tables (phy_engine_tpu_torch/digital/turbo.py::
// level_schedule), not from the tables themselves:
//   * per combinational pass (the forced inputs' cone, the full settle),
//     one 16-byte record {a, b, o, op} per gate, sorted by level;
//     op = inv_a | inv_b << 1 | inv_o << 2 | core << 3.  The kernel reads
//     them as level_rows lays them out for its block: a level in
//     ceil(w / THREADS) rows of one record per thread, padding records
//     marked OP_PAD, the level's last row marked OP_SYNC;
//   * per flip-flop segment, one record {d, c, r, q, lc, rst_en} per FF;
//   * the forced slots, and where a pass or segment stores 0 to the trash
//     slot (its padding slots do, in the chunk tables).
// A gate's level exceeds that of every gate it must follow under the
// chunk semantics (read after write, write after write, write after
// read), so no gate of a level reads a slot that another gate of the
// level writes, and the levels in order, each gate storing right after
// it computes, give the chunk order's result.
//
// Design: one block of THREADS = 256 threads per instance (chosen by
// measurement on RV32: 128, 512 and 1024 were slower), the T ticks a loop
// inside the block (the TPU's sequential grid becomes that loop).  Per row, thread t
// runs the record of column t: gathers of a and b from the planes, the
// gate's Kleene core, the store; after a level's last row, one
// __syncthreads().  The records stream through a 16 KB ring in shared
// memory by cp.async, four rows ahead, each thread copying and reading
// only its own column; the next row's record is read and decoded before
// the barrier.  No copy is issued past a pass's last row, so none is in
// flight when the pass ends and the next pass refills the ring.  A flip-flop segment computes every new q and last clock
// from the pre-segment planes into a buffer (one uint4 per FF), barrier,
// stores, barrier.
//
// State placement (template flag GLOBAL):
//   * shared (GLOBAL = false): V and U as uint32 (K,) arrays in dynamic
//     shared memory, then the FF buffer and the ring.  The RV32 core has
//     K = 24,448 slots: 195.6 KB of planes + 10 KB of buffer + 16 KB of
//     ring, inside the 227 KB a block may use.  The ring counts against
//     that limit: a design whose planes and buffer take more than 211 KB
//     (227 KB less the ring) takes the global placement;
//   * global (GLOBAL = true): planes and buffer in a per-instance scratch
//     in device memory that the wrapper allocates, for designs whose state
//     exceeds shared memory.  Same code; __syncthreads() orders the
//     block's global accesses as it does its shared ones.
//
// Semantics that are easy to get wrong:
//   1. Valid gates never read or write the trash slot (the schedule
//      checks it), so a pass's zero store there may go anywhere in it;
//      thread 0 makes it before the pass's first level.
//   2. Forced inputs are stored once per tick, before the cone pass, from
//      (B, T, nf_pad) planes; padding entries store 0 to the trash slot.
//   3. History: all K slots per tick (watch == NULL, run_pallas's output)
//      or only the watched slots (B, T, W), after the full settle.
//
// What bounds it: the chain of dependent levels on the one SM of an
// instance, not bytes or logic.  RV32 per tick: 124 cone + 195 full
// levels.  Measured on an H100 80GB HBM3 at 700 W (chip_smoke.py phase
// 6, the schedule with its gates or its levels taken out): a level whose
// rows hold no gate costs ~96 ns (the loop, the ring's wait and read, the
// barrier), the tick's ~37,000 gates ~95 ns a level more; the tick's
// fixed part (forced inputs, flip-flops, the full history) ~5.3 us.  The
// logic is spread over the SM's four partitions, whose integer pipes take
// a warp's logic instruction in two cycles: so a warp whose records are
// all padding skips the gate, and AND, OR and XOR, nearly every gate of a
// synthesized design, run without a branch.  B instances fill up to B
// SMs.  Not done here: several SMs per instance (thread-block clusters
// sharing the planes) and warp-only execution of narrow levels, which
// would take the barrier off most levels.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;           // a block (one per instance), and
                                       // the rows' width: turbo.py THREADS
constexpr int FF_REC = 6;              // {d, c, r, q, lc, rst_en}
constexpr int STAGES = 4;              // prefetch ring: rows in flight
constexpr uint32_t OP_SYNC = 1u << 6;  // the barrier follows this row
constexpr uint32_t OP_PAD = 1u << 7;   // a padding record: no gate

struct Args {
  const int* state0;     // (B, 2, K)   V then U planes
  const int* fv;         // (B, T, nf_pad)
  const int* fu;
  const int* f_slot;     // (nf_pad,)  forced slots (padding: trash)
  const int4* cone;      // (cone_rows, THREADS)  turbo.py level_rows
  const int4* full;      // (full_rows, THREADS)
  const int* ff_rec;     // (F, 6)
  const int* ff_seg;     // (n_seg, 3)  {first, end, zero}
  const int* watch;      // (width,) or NULL: record all K slots
  int* hv;               // (B, T, width)
  int* hu;
  int* scratch;          // (B, words) for the global placement
  int T, K, words, nf_pad, cone_rows, full_rows, n_seg, width, trash, zero;
};

// one gate record decoded
struct Gate {
  int a, b, o;
  uint32_t inv_a, inv_b, inv_o, core;
  bool is_or, is_xor, sync, pad;
};

__device__ __forceinline__ Gate decode(int4 r) {
  Gate g;
  const uint32_t op = static_cast<uint32_t>(r.w);
  g.a = r.x;
  g.b = r.y;
  g.o = r.z;
  g.inv_a = 0u - (op & 1u);
  g.inv_b = 0u - ((op >> 1) & 1u);
  g.inv_o = 0u - ((op >> 2) & 1u);
  g.core = (op >> 3) & 7u;
  g.is_or = g.core == 1u;
  g.is_xor = g.core == 2u;
  g.sync = (op & OP_SYNC) != 0;
  g.pad = (op & OP_PAD) != 0;
  return g;
}

// one gate: gather, its Kleene core (turbo.py _chunk_logic computes all
// seven and selects one), store.  AND, OR and XOR (all but a few gates of
// a synthesized design) are computed without a branch; the other four
// cores only in a warp that has such a gate (the schedule sorts a level's
// gates by core, so few warps do).
__device__ __forceinline__ void gate(uint32_t* V, uint32_t* U, const Gate& g) {
  uint32_t va = V[g.a], ua = U[g.a], vb = V[g.b], ub = U[g.b];
  va = (va & ~g.inv_a) | (~va & ~ua & g.inv_a);
  vb = (vb & ~g.inv_b) | (~vb & ~ub & g.inv_b);
  const uint32_t h_a = va & ~ua, l_a = ~va & ~ua;
  const uint32_t h_b = vb & ~ub, l_b = ~vb & ~ub;
  const uint32_t and_v = h_a & h_b, or_v = h_a | h_b;
  const uint32_t known = ~ua & ~ub;
  uint32_t v = g.is_or ? or_v : and_v;
  uint32_t u = g.is_or ? ~(or_v | (l_a & l_b)) : ~(and_v | l_a | l_b);
  v = g.is_xor ? (va ^ vb) & known : v;
  u = g.is_xor ? ~known : u;
  if (g.core > 2u) {
    switch (g.core) {
      case 3:                        // CASE_EQ
        v = ~(va ^ vb) & ~(ua ^ ub);
        u = 0u;
        break;
      case 4:                        // TRI: a = data, b = enable
        v = (h_b & h_a) | l_b;
        u = (h_b & ua) | l_b | ub;
        break;
      case 5: {                      // RESOLVE2
        const uint32_t az = ua & va, bz = ub & vb;
        const uint32_t eq = ~(va ^ vb) & ~(ua ^ ub);
        const uint32_t sel_b = az;
        const uint32_t sel_a = ~az & bz;
        const uint32_t sel_e = ~az & ~bz & eq;
        const uint32_t conflict = ~az & ~bz & ~eq;
        v = (sel_b & vb) | (sel_a & va) | (sel_e & va);
        u = (sel_b & ub) | (sel_a & ua) | (sel_e & ua) | conflict;
        break;
      }
      default:                       // IS_UNKNOWN
        v = ua;
        u = 0u;
        break;
    }
  }
  v = (v & ~g.inv_o) | (~v & ~u & g.inv_o);
  V[g.o] = v;
  U[g.o] = u;
}

// 16-byte asynchronous copy from device to shared memory (cp.async)
__device__ __forceinline__ void cp_async16(int4* dst, const int4* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// one combinational pass: R rows of THREADS gate records (turbo.py
// level_rows), thread t running column t; the block barrier after each
// row marked OP_SYNC, the last row of a level.  Row r travels into ring
// slot r % STAGES while the rows before it run; each thread copies and
// reads only its own column, so no barrier guards the ring.  The next
// row's record is read and decoded before the barrier.  A padding record
// runs no gate: a warp whose records are all padding skips the logic, so
// the SM's integer pipes (16 lanes a partition) serve only real gates.
// One commit group per row, empty from row R on (R is the block's own, so
// the branch does not diverge): the pass ends with no copy in flight,
// and none can land on a slot the next pass has refilled.
__device__ __forceinline__ void comb_pass(uint32_t* V, uint32_t* U,
                                          int4* ring,
                                          const int4* __restrict__ rows,
                                          int R, bool zero, int trash) {
  const int tid = threadIdx.x;
  if (zero && tid == 0) {
    V[trash] = 0u;
    U[trash] = 0u;
  }
  if (R == 0) {
    __syncthreads();
    return;
  }
#pragma unroll
  for (int r = 0; r < STAGES; ++r) {
    if (r < R) cp_async16(ring + r * THREADS + tid, rows + r * THREADS + tid);
    cp_async_commit();
  }
  cp_async_wait<STAGES - 1>();
  Gate g = decode(ring[tid]);
  for (int r = 0; r < R; ++r) {
    if (!g.pad) gate(V, U, g);
    const int nxt = r + STAGES;
    if (nxt < R)
      cp_async16(ring + (r % STAGES) * THREADS + tid,
                 rows + static_cast<size_t>(nxt) * THREADS + tid);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();     // this thread's record of row r + 1
    const Gate next = decode(ring[((r + 1) % STAGES) * THREADS + tid]);
    if (g.sync) __syncthreads();     // the level's stores are visible
    g = next;
  }
}

// one flip-flop segment: records [first, end), every gather from the
// pre-segment planes before any store
__device__ __forceinline__ void ff_segment(uint32_t* V, uint32_t* U,
                                           uint4* buf,
                                           const int* __restrict__ ff,
                                           int first, int end, bool zero,
                                           int trash) {
  const int tid = threadIdx.x;
  for (int i = first + tid; i < end; i += THREADS) {
    const int* r = ff + static_cast<size_t>(i) * FF_REC;
    const int id = __ldg(r), ic = __ldg(r + 1), ir = __ldg(r + 2);
    const int iq = __ldg(r + 3), il = __ldg(r + 4);
    const uint32_t ren = static_cast<uint32_t>(__ldg(r + 5));
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
    const uint32_t a_l = ~av & ~au & ren;
    const uint32_t a_x = au & ren;
    qv = qv & ~a_l & ~a_x;
    qu = (qu & ~a_l) | a_x;
    buf[i - first] = make_uint4(qv, qu, lcv2, lcu2);
  }
  __syncthreads();                   // the segment read its snapshot
  for (int i = first + tid; i < end; i += THREADS) {
    const int* r = ff + static_cast<size_t>(i) * FF_REC;
    const int iq = __ldg(r + 3), il = __ldg(r + 4);
    const uint4 b = buf[i - first];
    V[iq] = b.x;
    U[iq] = b.y;
    V[il] = b.z;
    U[il] = b.w;
  }
  if (zero && tid == 0) {
    V[trash] = 0u;
    U[trash] = 0u;
  }
  __syncthreads();
}

template <bool GLOBAL>
__global__ void __launch_bounds__(THREADS) turbo_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int inst = blockIdx.x;
  const size_t K = static_cast<size_t>(a.K);
  // shared memory: [planes and FF buffer (shared placement)] [ring]
  uint32_t* V = GLOBAL ? reinterpret_cast<uint32_t*>(a.scratch) +
                             static_cast<size_t>(inst) * a.words
                       : smem;
  uint32_t* U = V + K;
  uint4* buf = reinterpret_cast<uint4*>(U + K);
  int4* ring = reinterpret_cast<int4*>(smem + (GLOBAL ? 0 : a.words));

  const uint32_t* s0 = reinterpret_cast<const uint32_t*>(a.state0) + inst * 2 * K;
  for (size_t i = tid; i < K; i += THREADS) {
    V[i] = s0[i];
    U[i] = s0[K + i];
  }
  __syncthreads();

  for (int t = 0; t < a.T; ++t) {
    // 1. forced INPUT words
    const size_t frow = (static_cast<size_t>(inst) * a.T + t) * a.nf_pad;
    for (int j = tid; j < a.nf_pad; j += THREADS) {
      const int s = __ldg(a.f_slot + j);
      V[s] = static_cast<uint32_t>(__ldg(a.fv + frow + j));
      U[s] = static_cast<uint32_t>(__ldg(a.fu + frow + j));
    }
    __syncthreads();
    // 2. settle the forced inputs' cone
    comb_pass(V, U, ring, a.cone, a.cone_rows, a.zero & 1, a.trash);
    // 3. flip-flops, one frozen snapshot per segment
    for (int s = 0; s < a.n_seg; ++s)
      ff_segment(V, U, buf, a.ff_rec, __ldg(a.ff_seg + 3 * s),
                     __ldg(a.ff_seg + 3 * s + 1),
                     __ldg(a.ff_seg + 3 * s + 2) != 0, a.trash);
    // 4. full combinational settle
    comb_pass(V, U, ring, a.full, a.full_rows, a.zero & 2, a.trash);
    // 5. history
    const size_t hrow = (static_cast<size_t>(inst) * a.T + t) * a.width;
    for (int i = tid; i < a.width; i += THREADS) {
      const int s = a.watch ? __ldg(a.watch + i) : i;
      a.hv[hrow + i] = static_cast<int>(V[s]);
      a.hu[hrow + i] = static_cast<int>(U[s]);
    }
    __syncthreads();                 // history read before the next stores
  }
}

template <bool GLOBAL>
cudaError_t launch(const Args& a, int B, int bytes, cudaStream_t s) {
  cudaError_t e = cudaFuncSetAttribute(
      turbo_kernel<GLOBAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (e != cudaSuccess) return e;
  turbo_kernel<GLOBAL><<<B, THREADS, bytes, s>>>(a);
  return cudaGetLastError();
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

// Dynamic shared memory of a launch (bytes): the instance's state words in
// the shared placement, the record ring in both.
long long pe_turbo_shared_bytes(int words, int global_state) {
  return (global_state ? 0LL : 4LL * words) +
         static_cast<long long>(STAGES * THREADS * sizeof(int4));
}

int pe_turbo_run(const void* state0, const void* fv, const void* fu,
                 const void* f_slot, const void* cone, const void* full,
                 const void* ff_rec, const void* ff_seg, const void* watch,
                 void* hv, void* hu, void* scratch, int B, int T, int K,
                 int words, int nf_pad, int cone_rows,
                 int full_rows, int n_seg, int width, int trash, int zero,
                 int global_state, void* stream) {
  if (B < 1 || T < 1) return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.state0 = static_cast<const int*>(state0);
  a.fv = static_cast<const int*>(fv);
  a.fu = static_cast<const int*>(fu);
  a.f_slot = static_cast<const int*>(f_slot);
  a.cone = static_cast<const int4*>(cone);
  a.full = static_cast<const int4*>(full);
  a.ff_rec = static_cast<const int*>(ff_rec);
  a.ff_seg = static_cast<const int*>(ff_seg);
  a.watch = static_cast<const int*>(watch);
  a.hv = static_cast<int*>(hv);
  a.hu = static_cast<int*>(hu);
  a.scratch = static_cast<int*>(scratch);
  a.T = T; a.K = K; a.words = words; a.nf_pad = nf_pad;
  a.cone_rows = cone_rows; a.full_rows = full_rows; a.n_seg = n_seg;
  a.width = width; a.trash = trash; a.zero = zero;
  const int bytes = static_cast<int>(pe_turbo_shared_bytes(words, global_state));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(global_state ? launch<true>(a, B, bytes, s)
                                       : launch<false>(a, B, bytes, s));
}

}  // extern "C"
