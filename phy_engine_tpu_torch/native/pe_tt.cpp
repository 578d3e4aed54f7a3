// Host-native truth-table batching backend.
//
// The reference accelerates its synthesis inner loops with u64-packed
// truth-table cone evaluation on CUDA (src/pe_synth_cuda_u64_cones.cu:
// 26-190: 64 patterns per word, leaf patterns 0xAAAA…/0xCCCC…, gate
// cones evaluated breadth-first).  This port keeps the same packing
// and runs the synthesis passes' batching on the host, here (the port's
// copy of phy_engine_tpu/native/pe_tt.cpp, built by g++ into
// build/phy_engine_tpu_torch/ by native/__init__.py).
//
// Layout: a gate graph in topological order, ops over 64-bit pattern
// words.  `words` is an (n_nodes, n_words) row-major matrix whose leaf
// rows are pre-filled by the caller; gate rows are computed in place.
//
// Ops: 0 = LEAF (skip), 1 = NOT, 2 = AND, 3 = OR, 4 = XOR,
//      5 = CONST0 (fill zeros), 6 = CONST1 (fill ones).

#include <cstdint>
#include <cstring>
#if defined(_OPENMP)
#include <omp.h>
#endif

namespace {

// one word-column slice of the whole graph: columns are independent,
// so slices parallelize perfectly (the reference's CUDA grid maps
// cones x words the same way, pe_synth_cuda_u64_cones.cu:47-113)
void eval_slice(const int32_t* op, const int32_t* f0, const int32_t* f1,
                int32_t n_nodes, uint64_t* words, int32_t n_words,
                int32_t w0, int32_t w1) {
    for (int32_t i = 0; i < n_nodes; ++i) {
        uint64_t* out = words + (size_t)i * n_words;
        switch (op[i]) {
            case 0: break;
            case 1: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                for (int32_t w = w0; w < w1; ++w) out[w] = ~a[w];
                break;
            }
            case 2: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = w0; w < w1; ++w) out[w] = a[w] & b[w];
                break;
            }
            case 3: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = w0; w < w1; ++w) out[w] = a[w] | b[w];
                break;
            }
            case 4: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = w0; w < w1; ++w) out[w] = a[w] ^ b[w];
                break;
            }
            case 5:
                memset(out + w0, 0, (size_t)(w1 - w0) * 8);
                break;
            case 6:
                memset(out + w0, 0xFF, (size_t)(w1 - w0) * 8);
                break;
        }
    }
}

}  // namespace

extern "C" {

void pe_tt_eval_graph(const int32_t* op, const int32_t* f0,
                      const int32_t* f1, int32_t n_nodes,
                      uint64_t* words, int32_t n_words) {
#if defined(_OPENMP)
    // wide truth tables: split the word columns across threads
    if ((int64_t)n_nodes * n_words > (1 << 16) && n_words >= 8) {
        int nt = omp_get_max_threads();
        if (nt > n_words) nt = n_words;
#pragma omp parallel num_threads(nt)
        {
            int t = omp_get_thread_num();
            int per = (n_words + nt - 1) / nt;
            int w0 = t * per;
            int w1 = w0 + per > n_words ? n_words : w0 + per;
            if (w0 < w1) {
                eval_slice(op, f0, f1, n_nodes, words, n_words, w0,
                           w1);
            }
        }
        return;
    }
#endif
    eval_slice(op, f0, f1, n_nodes, words, n_words, 0, n_words);
}

void pe_tt_eval_graph_serial(const int32_t* op, const int32_t* f0,
                             const int32_t* f1, int32_t n_nodes,
                             uint64_t* words, int32_t n_words) {
    for (int32_t i = 0; i < n_nodes; ++i) {
        uint64_t* out = words + (size_t)i * n_words;
        switch (op[i]) {
            case 0: break;  // leaf: pre-filled
            case 1: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                for (int32_t w = 0; w < n_words; ++w) out[w] = ~a[w];
                break;
            }
            case 2: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = 0; w < n_words; ++w) out[w] = a[w] & b[w];
                break;
            }
            case 3: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = 0; w < n_words; ++w) out[w] = a[w] | b[w];
                break;
            }
            case 4: {
                const uint64_t* a = words + (size_t)f0[i] * n_words;
                const uint64_t* b = words + (size_t)f1[i] * n_words;
                for (int32_t w = 0; w < n_words; ++w) out[w] = a[w] ^ b[w];
                break;
            }
            case 5:
                std::memset(out, 0, (size_t)n_words * 8);
                break;
            case 6:
                std::memset(out, 0xFF, (size_t)n_words * 8);
                break;
        }
    }
}

// Compare two node rows for equality / complement over npat patterns.
// Returns 1 if equal (neg == 0) or complementary (neg == 1).
int32_t pe_tt_rows_equal(const uint64_t* a, const uint64_t* b,
                         int32_t n_words, int64_t npat, int32_t neg) {
    for (int32_t w = 0; w < n_words; ++w) {
        uint64_t bv = neg ? ~b[w] : b[w];
        uint64_t diff = a[w] ^ bv;
        if (w == n_words - 1 && (npat & 63)) {
            diff &= (1ULL << (npat & 63)) - 1ULL;
        }
        if (diff) return 0;
    }
    return 1;
}

// Batched random-pattern simulation signatures for equivalence
// candidate grouping: same graph arrays, returns 64-bit signature per
// node (n_words == 1 specialization of eval_graph).
void pe_tt_signatures(const int32_t* op, const int32_t* f0,
                      const int32_t* f1, int32_t n_nodes,
                      uint64_t* words, int32_t n_words) {
    pe_tt_eval_graph(op, f0, f1, n_nodes, words, n_words);
}

}  // extern "C"
