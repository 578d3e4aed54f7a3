// Host-native levelled digital sweep engine.
//
// Role parity: the reference's digital runtime is a single-threaded
// C++ event-driven worklist (circuits/circuit.h:307-337 digital_clk,
// model/models/digital/*.h update_digital_clk).  This build replaces
// the worklist with pre-levelled full sweeps (digital/ir.py) and runs
// them three ways: the levelled tick (digital/engine.py, torch ops),
// the whole-tick CUDA kernel (digital/turbo.py, ops/csrc/turbo.cu,
// lane/instance-batched throughput), and THIS engine — a native
// bit-packed host interpreter for latency-bound single-trace clocking,
// where per-launch latency dominates and a tight host loop is the
// speed-of-light (the port's copy of phy_engine_tpu/native/
// pe_digital.cpp; digital/native_run.py drives it).  All backends
// consume the same lowered tables and are bit-exact under the
// two-plane Kleene encoding (digital/logic.py: 32 stimulus lanes per
// word, V/U planes).
//
// State layout: one uint64 per signal, V plane in the low 32 bits and
// U plane in the high 32 — a gate touches 2 random cache words instead
// of 4.
//
// Gate encoding (matches digital/turbo.py _GEN2_ENC):
//   op = core | inva<<3 | invb<<4 | invo<<5
//   cores: 0=AND 1=OR 2=XOR 3=CASE_EQ 4=TRI 5=RESOLVE2 6=IS_UNKNOWN
//
// Gate tables arrive pre-grouped into RUNS (native_run.py _flat_gates):
// a run is a maximal same-opcode stretch within ONE independent
// sub-level, so every gate in a run reads only signals written by
// earlier runs.  That independence is what lets the AVX-512 path below
// evaluate 8 gates at a time with vpgatherqq/vpscatterqq — the decode
// and the inversion masks hoist out per run, and the two-plane Kleene
// cores are straight 32-bit boolean algebra in the low half of each
// 64-bit lane.  Without AVX-512 the same run structure still helps:
// one opcode dispatch per run instead of per gate.
//
// Tick order (identical to digital/engine.py + turbo.py): forced
// INPUT planes -> input-cone settle -> FF segments (frozen reads) ->
// full settle.  The first tick of a run settles the WIDE cone (every
// INPUT's cone — covers constants and fresh X state); later ticks
// settle only the caller-computed NARROW cone (gates on paths from
// inputs that actually vary within the schedule to FF d/c/r pins) —
// bit-exact because unchanged inputs' cones already hold their
// fixpoint from the previous full settle.
//
// Flip-flops (DFF / DFF_ARSTN, d_ff.h:59-66 semantics): rows
// (d, c, r, q, lc) with rst_en selecting the async-reset overlay;
// segments read a frozen pre-segment snapshot (gather-then-write),
// reproducing the engine's simultaneous-within-segment rule.

#include <cstdint>
#include <cstring>

#if defined(__AVX512F__)
#include <immintrin.h>
#define PE_DIG_AVX512 1
#endif

namespace {

inline uint64_t gate_eval(int32_t op, uint64_t a, uint64_t b) {
    uint32_t va = (uint32_t)a, ua = (uint32_t)(a >> 32);
    uint32_t vb = (uint32_t)b, ub = (uint32_t)(b >> 32);
    const uint32_t inva = (op & 8) ? ~0u : 0u;
    const uint32_t invb = (op & 16) ? ~0u : 0u;
    const uint32_t invo = (op & 32) ? ~0u : 0u;
    va = (va & ~inva) | (~va & ~ua & inva);
    vb = (vb & ~invb) | (~vb & ~ub & invb);
    const uint32_t h_a = va & ~ua, l_a = ~va & ~ua;
    const uint32_t h_b = vb & ~ub, l_b = ~vb & ~ub;
    uint32_t v, u;
    switch (op & 7) {
        case 0:  // AND
            v = h_a & h_b;
            u = ~(v | l_a | l_b);
            break;
        case 1:  // OR
            v = h_a | h_b;
            u = ~(v | (l_a & l_b));
            break;
        case 2: {  // XOR
            const uint32_t known = ~ua & ~ub;
            v = (va ^ vb) & known;
            u = ~known;
            break;
        }
        case 3:  // CASE_EQ
            v = ~(va ^ vb) & ~(ua ^ ub);
            u = 0;
            break;
        case 4: {  // TRI: a=data, b=en (logic.op_tri_state)
            const uint32_t eh = h_b, el = l_b;
            v = (eh & h_a) | el;
            u = (eh & ua) | el | ub;
            break;
        }
        case 5: {  // RESOLVE2 (logic.op_resolve2)
            const uint32_t az = ua & va;
            const uint32_t bz = ub & vb;
            const uint32_t eq = ~(va ^ vb) & ~(ua ^ ub);
            const uint32_t sel_b = az;
            const uint32_t sel_a = ~az & bz;
            const uint32_t sel_e = ~az & ~bz & eq;
            const uint32_t conflict = ~az & ~bz & ~eq;
            v = (sel_b & vb) | (sel_a & va) | (sel_e & va);
            u = (sel_b & ub) | (sel_a & ua) | (sel_e & ua) | conflict;
            break;
        }
        default:  // IS_UNKNOWN
            v = ua;
            u = 0;
            break;
    }
    v = (v & ~invo) | (~v & ~u & invo);
    return (uint64_t)v | ((uint64_t)u << 32);
}

#ifdef PE_DIG_AVX512

// 8 gates per iteration.  All 32-bit plane values live in the LOW half
// of each 64-bit lane (high half zero); NOT32 keeps them that way.
inline __m512i not32(__m512i x, __m512i low) {
    return _mm512_xor_si512(x, low);
}

static void run_vec(int32_t op, const int32_t* a, const int32_t* b,
                    const int32_t* o, int32_t i0, int32_t i1,
                    uint64_t* st) {
    const __m512i LOW = _mm512_set1_epi64(0xFFFFFFFFll);
    const __m512i ZERO = _mm512_setzero_si512();
    const int core = op & 7;
    const bool inva = (op & 8) != 0;
    const bool invb = (op & 16) != 0;
    const bool invo = (op & 32) != 0;
    int32_t i = i0;
    for (; i + 8 <= i1; i += 8) {
        const __m256i ia = _mm256_loadu_si256((const __m256i*)(a + i));
        const __m256i ib = _mm256_loadu_si256((const __m256i*)(b + i));
        const __m512i A = _mm512_i32gather_epi64(ia, (const long long*)st, 8);
        const __m512i B = _mm512_i32gather_epi64(ib, (const long long*)st, 8);
        __m512i va = _mm512_and_si512(A, LOW);
        __m512i ua = _mm512_srli_epi64(A, 32);
        __m512i vb = _mm512_and_si512(B, LOW);
        __m512i ub = _mm512_srli_epi64(B, 32);
        if (inva) va = _mm512_andnot_si512(ua, not32(va, LOW));
        if (invb) vb = _mm512_andnot_si512(ub, not32(vb, LOW));
        __m512i v, u;
        switch (core) {
            case 0: {  // AND
                const __m512i h_a = _mm512_andnot_si512(ua, va);
                const __m512i l_a = _mm512_andnot_si512(ua, not32(va, LOW));
                const __m512i h_b = _mm512_andnot_si512(ub, vb);
                const __m512i l_b = _mm512_andnot_si512(ub, not32(vb, LOW));
                v = _mm512_and_si512(h_a, h_b);
                u = not32(_mm512_or_si512(v, _mm512_or_si512(l_a, l_b)),
                          LOW);
                break;
            }
            case 1: {  // OR
                const __m512i h_a = _mm512_andnot_si512(ua, va);
                const __m512i l_a = _mm512_andnot_si512(ua, not32(va, LOW));
                const __m512i h_b = _mm512_andnot_si512(ub, vb);
                const __m512i l_b = _mm512_andnot_si512(ub, not32(vb, LOW));
                v = _mm512_or_si512(h_a, h_b);
                u = not32(_mm512_or_si512(v, _mm512_and_si512(l_a, l_b)),
                          LOW);
                break;
            }
            case 2: {  // XOR
                const __m512i known =
                    _mm512_andnot_si512(_mm512_or_si512(ua, ub), LOW);
                v = _mm512_and_si512(_mm512_xor_si512(va, vb), known);
                u = not32(known, LOW);
                break;
            }
            case 3: {  // CASE_EQ
                v = _mm512_and_si512(
                    not32(_mm512_xor_si512(va, vb), LOW),
                    not32(_mm512_xor_si512(ua, ub), LOW));
                u = ZERO;
                break;
            }
            case 4: {  // TRI
                const __m512i eh = _mm512_andnot_si512(ub, vb);
                const __m512i el = _mm512_andnot_si512(ub, not32(vb, LOW));
                const __m512i h_a = _mm512_andnot_si512(ua, va);
                v = _mm512_or_si512(_mm512_and_si512(eh, h_a), el);
                u = _mm512_or_si512(
                    _mm512_or_si512(_mm512_and_si512(eh, ua), el), ub);
                break;
            }
            case 5: {  // RESOLVE2
                const __m512i az = _mm512_and_si512(ua, va);
                const __m512i bz = _mm512_and_si512(ub, vb);
                const __m512i eq = _mm512_and_si512(
                    not32(_mm512_xor_si512(va, vb), LOW),
                    not32(_mm512_xor_si512(ua, ub), LOW));
                const __m512i naz = not32(az, LOW);
                const __m512i sel_a = _mm512_and_si512(naz, bz);
                const __m512i rest = _mm512_andnot_si512(bz, naz);
                const __m512i sel_e = _mm512_and_si512(rest, eq);
                const __m512i conflict = _mm512_andnot_si512(eq, rest);
                const __m512i va_keep = _mm512_or_si512(sel_a, sel_e);
                v = _mm512_or_si512(_mm512_and_si512(az, vb),
                                    _mm512_and_si512(va_keep, va));
                u = _mm512_or_si512(
                    _mm512_or_si512(_mm512_and_si512(az, ub),
                                    _mm512_and_si512(va_keep, ua)),
                    conflict);
                break;
            }
            default:  // IS_UNKNOWN
                v = ua;
                u = ZERO;
                break;
        }
        if (invo) v = _mm512_andnot_si512(u, not32(v, LOW));
        const __m512i R = _mm512_or_si512(v, _mm512_slli_epi64(u, 32));
        const __m256i io = _mm256_loadu_si256((const __m256i*)(o + i));
        _mm512_i32scatter_epi64((long long*)st, io, R, 8);
    }
    for (; i < i1; ++i) {
        st[o[i]] = gate_eval(op, st[a[i]], st[b[i]]);
    }
}

#endif  // PE_DIG_AVX512

template <int32_t OP>
static void run_op(const int32_t* a, const int32_t* b, const int32_t* o,
                   int32_t i0, int32_t i1, uint64_t* st) {
    for (int32_t i = i0; i < i1; ++i) {
        st[o[i]] = gate_eval(OP, st[a[i]], st[b[i]]);
    }
}

inline void sweep(const int32_t* op, const int32_t* a, const int32_t* b,
                  const int32_t* o, const int32_t* runs, int32_t n_runs,
                  uint64_t* st) {
    // every run is same-op AND intra-sub-level (gates independent);
    // dispatch once per run
    for (int32_t r = 0; r < n_runs; ++r) {
        const int32_t i = runs[r], j = runs[r + 1];
        const int32_t cur = op[i];
#ifdef PE_DIG_AVX512
        if (j - i >= 8) {
            run_vec(cur, a, b, o, i, j, st);
            continue;
        }
#endif
        switch (cur) {
            case 0:  run_op<0>(a, b, o, i, j, st); break;   // AND
            case 1:  run_op<1>(a, b, o, i, j, st); break;   // OR
            case 2:  run_op<2>(a, b, o, i, j, st); break;   // XOR
            case 8 | 0:  run_op<8 | 0>(a, b, o, i, j, st); break;
            case 16 | 0: run_op<16 | 0>(a, b, o, i, j, st); break;
            case 32 | 0: run_op<32 | 0>(a, b, o, i, j, st); break; // NAND/NOT
            case 32 | 1: run_op<32 | 1>(a, b, o, i, j, st); break; // NOR
            case 32 | 2: run_op<32 | 2>(a, b, o, i, j, st); break; // XNOR
            case 8 | 1:  run_op<8 | 1>(a, b, o, i, j, st); break;  // IMP
            case 16 | 1: run_op<16 | 1>(a, b, o, i, j, st); break;
            default:
                for (int32_t k = i; k < j; ++k) {
                    st[o[k]] = gate_eval(cur, st[a[k]], st[b[k]]);
                }
        }
    }
}

// Comb-feedback (gate-level latch) segments, evaluated with the
// levels engine's exact semantics: per segment, all gates read the
// PRE-segment state (Jacobi gather-then-write); segments apply
// sequentially; the whole pass (levels sweep + cyclic segments)
// repeats until the state stops changing or fix_budget passes ran —
// mirroring engine.py's lax.while_loop over comb_pass.
inline void jacobi_segments(const int32_t* cy_op, const int32_t* cy_a,
                            const int32_t* cy_b, const int32_t* cy_o,
                            const int32_t* cy_seg, int32_t n_cy_seg,
                            uint64_t* st, uint64_t* tmp) {
    for (int32_t s = 0; s < n_cy_seg; ++s) {
        const int32_t i0 = cy_seg[s], i1 = cy_seg[s + 1];
        for (int32_t i = i0; i < i1; ++i) {
            tmp[i - i0] = gate_eval(cy_op[i], st[cy_a[i]], st[cy_b[i]]);
        }
        for (int32_t i = i0; i < i1; ++i) {
            st[cy_o[i]] = tmp[i - i0];
        }
    }
}

}  // namespace

extern "C" {

// Run T ticks.  st (size K, v|u<<32 packed) is updated in place;
// HV/HU (T x S, uint32) record the post-tick planes of the first S
// signals.  The wide cone runs on tick 0 only; the narrow cone on
// ticks 1..T-1.  Each gate table comes with a runs array
// ([n_runs + 1] boundaries; see header comment) produced by
// native_run.py.  FF segment i covers rows [seg[i], seg[i+1]);
// scratch holds 6 * max_seg_len uint64.  Cyclic (gate-latch)
// segments: cy_* flat tables with cy_seg boundaries; fix_budget > 0
// bounds the settle-to-fixpoint passes (0 = pure feed-forward, single
// sweep); snap is a K-word buffer for change detection and cy_tmp
// holds max-cyclic-segment words for the Jacobi gather.
void pe_digital_run(
    int32_t K, int32_t S, int32_t T, uint64_t* st,
    const int32_t* wc_op, const int32_t* wc_a, const int32_t* wc_b,
    const int32_t* wc_o, const int32_t* wc_runs, int32_t n_wc_runs,
    const int32_t* nc_op, const int32_t* nc_a, const int32_t* nc_b,
    const int32_t* nc_o, const int32_t* nc_runs, int32_t n_nc_runs,
    const int32_t* full_op, const int32_t* full_a, const int32_t* full_b,
    const int32_t* full_o, const int32_t* full_runs, int32_t n_full_runs,
    const int32_t* cy_op, const int32_t* cy_a, const int32_t* cy_b,
    const int32_t* cy_o, const int32_t* cy_seg, int32_t n_cy_seg,
    int32_t fix_budget,
    const int32_t* ff_d, const int32_t* ff_c, const int32_t* ff_r,
    const int32_t* ff_q, const int32_t* ff_lc, const int32_t* ff_ren,
    const int32_t* seg, int32_t n_seg,
    const int32_t* fsig, int32_t nf, const uint32_t* FV, const uint32_t* FU,
    uint32_t* HV, uint32_t* HU, uint64_t* scratch,
    uint64_t* snap, uint64_t* cy_tmp) {
    for (int32_t t = 0; t < T; ++t) {
        // 1. forced INPUT planes for this tick
        const uint32_t* fv = FV + (size_t)t * nf;
        const uint32_t* fu = FU + (size_t)t * nf;
        for (int32_t i = 0; i < nf; ++i) {
            st[fsig[i]] = (uint64_t)fv[i] | ((uint64_t)fu[i] << 32);
        }
        // 2. pre-sequential settle of the input cone (with feedback
        // present the cone IS the full program, and the cyclic
        // segments run once — engine.py's pre_fused single comb_pass)
        if (t == 0) {
            sweep(wc_op, wc_a, wc_b, wc_o, wc_runs, n_wc_runs, st);
        } else {
            sweep(nc_op, nc_a, nc_b, nc_o, nc_runs, n_nc_runs, st);
        }
        if (n_cy_seg) {
            jacobi_segments(cy_op, cy_a, cy_b, cy_o, cy_seg, n_cy_seg,
                            st, cy_tmp);
        }
        // 3. flip-flops: per segment, snapshot reads then write
        for (int32_t s = 0; s < n_seg; ++s) {
            const int32_t i0 = seg[s], i1 = seg[s + 1];
            const int32_t n = i1 - i0;
            uint64_t* dd = scratch;
            uint64_t* cc = dd + n;
            uint64_t* qq = cc + n;
            uint64_t* ll = qq + n;
            uint64_t* rr = ll + n;
            for (int32_t k = 0; k < n; ++k) {
                const int32_t i = i0 + k;
                dd[k] = st[ff_d[i]];
                cc[k] = st[ff_c[i]];
                qq[k] = st[ff_q[i]];
                ll[k] = st[ff_lc[i]];
                if (ff_ren[i]) rr[k] = st[ff_r[i]];
            }
            for (int32_t k = 0; k < n; ++k) {
                const int32_t i = i0 + k;
                const uint32_t du = (uint32_t)(dd[k] >> 32);
                const uint32_t dv = (uint32_t)dd[k] & ~du;
                const uint32_t cu = (uint32_t)(cc[k] >> 32);
                const uint32_t cv = (uint32_t)cc[k] & ~cu;
                uint32_t qv = (uint32_t)qq[k];
                uint32_t qu = (uint32_t)(qq[k] >> 32);
                const uint32_t lv = (uint32_t)ll[k];
                const uint32_t lu = (uint32_t)(ll[k] >> 32);
                const uint32_t rise = (~lv & ~lu) & (cv & ~cu);
                const uint32_t known = ~cu;
                const uint32_t lv2 = (lv & ~known) | (cv & known);
                const uint32_t lu2 = lu & ~known;
                qv = (qv & ~rise) | (dv & rise);
                qu = (qu & ~rise) | (du & rise);
                if (ff_ren[i]) {
                    const uint32_t au = (uint32_t)(rr[k] >> 32);
                    const uint32_t av = (uint32_t)rr[k] & ~au;
                    const uint32_t a_l = ~av & ~au;
                    qv = qv & ~a_l & ~au;
                    qu = (qu & ~a_l) | au;
                }
                st[ff_q[i]] = (uint64_t)qv | ((uint64_t)qu << 32);
                st[ff_lc[i]] = (uint64_t)lv2 | ((uint64_t)lu2 << 32);
            }
        }
        // 4. full combinational settle; with feedback, repeat the
        // whole pass until nothing changes or the budget is spent
        sweep(full_op, full_a, full_b, full_o, full_runs, n_full_runs, st);
        if (n_cy_seg) {
            jacobi_segments(cy_op, cy_a, cy_b, cy_o, cy_seg, n_cy_seg,
                            st, cy_tmp);
            for (int32_t it = 1; it < fix_budget; ++it) {
                std::memcpy(snap, st, (size_t)K * sizeof(uint64_t));
                sweep(full_op, full_a, full_b, full_o, full_runs,
                      n_full_runs, st);
                jacobi_segments(cy_op, cy_a, cy_b, cy_o, cy_seg,
                                n_cy_seg, st, cy_tmp);
                if (std::memcmp(snap, st,
                                (size_t)K * sizeof(uint64_t)) == 0) {
                    break;
                }
            }
        }
        // 5. record history planes
        uint32_t* hv = HV + (size_t)t * S;
        uint32_t* hu = HU + (size_t)t * S;
        for (int32_t i = 0; i < S; ++i) {
            hv[i] = (uint32_t)st[i];
            hu[i] = (uint32_t)(st[i] >> 32);
        }
    }
}

}  // extern "C"
