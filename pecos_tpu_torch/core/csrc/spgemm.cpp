// Parallel sparse product Z = Y^T . X for PIFA label embeddings.
//
// The port's copy of pecos_tpu/core/spgemm.cpp, with its C API and its
// arithmetic kept as they are, so both packages give Z bit for bit: row l of
// Z is the Y-weighted sum of the X rows of label l's instances, taken in Y's
// CSC order and each X row's order, accumulated in float32 into a
// generation-stamped dense scratch (scratch[col] += yv * x), and emitted in
// sorted column order with exact zeros kept.  Its threads are std::threads
// (parallel.h) in place of OpenMP.
//
// Labels are Zipf-sized (on a Zipf label set, the first 16 of 8,192 labels
// hold a third of the work), so they are cut into runs of consecutive labels
// of about equal work, the X nonzeros they read, kChunksPerThread runs a
// thread, and threads take runs from a shared counter.  Each run's rows go
// to their own part and spgemm_fill copies the parts in label order: the
// split over threads changes no bit.  Each thread holds a D-wide float and
// stamp scratch (8 bytes a column), so the thread count is capped to keep
// them within kScratchBytes.
//
// Shapes: Y csc (N x L) — column l lists label l's instances;
//         X csr (N x D) — row i lists instance i's features;
//         Z csr (L x D).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>
#include <vector>

#include "parallel.h"

namespace {

constexpr int64_t kChunksPerThread = 64;
constexpr int64_t kScratchBytes = int64_t(1) << 30;

struct Part {
    std::vector<int32_t> indices;
    std::vector<float> data;
};

struct SpgemmResult {
    std::vector<int64_t> indptr;  // L + 1
    std::vector<Part> parts;      // one per run of labels, in label order
};

}  // namespace

extern "C" {

// Z = Y^T . X; NULL when memory runs out.  threads <= 0: the host's threads.
void* spgemm_atb(int64_t N, int64_t L, int64_t D,
                 const int64_t* y_indptr, const int32_t* y_indices, const float* y_data,
                 const int64_t* x_indptr, const int32_t* x_indices, const float* x_data,
                 int threads) {
    (void)N;
    SpgemmResult* r = new (std::nothrow) SpgemmResult();
    if (r == nullptr) return nullptr;
    std::atomic<int64_t> next{0};
    std::atomic<bool> failed{false};
    try {
        r->indptr.assign(L + 1, 0);
        int64_t by_memory = std::max<int64_t>(1, kScratchBytes / std::max<int64_t>(1, 8 * D));
        int n_threads = (int)std::max<int64_t>(1, std::min<int64_t>({host_threads(threads), L, by_memory}));
        // runs [bounds[c], bounds[c + 1]) of about `target` work each
        std::vector<int64_t> work(L, 1);
        int64_t total = 0;
        for (int64_t l = 0; l < L; ++l) {
            for (int64_t p = y_indptr[l]; p < y_indptr[l + 1]; ++p)
                work[l] += x_indptr[y_indices[p] + 1] - x_indptr[y_indices[p]];
            total += work[l];
        }
        int64_t target = std::max<int64_t>(1, total / (n_threads * kChunksPerThread)), acc = 0;
        std::vector<int64_t> bounds{0};
        for (int64_t l = 0; l < L; ++l) {
            acc += work[l];
            if (acc >= target || l + 1 == L) {
                bounds.push_back(l + 1);
                acc = 0;
            }
        }
        int64_t n_chunks = (int64_t)bounds.size() - 1;
        r->parts.resize(n_chunks);
        parallel_for(n_threads, n_threads, [&](int64_t) {
            try {
                std::vector<float> scratch(D, 0.0f);
                std::vector<uint32_t> stamp(D, 0);
                std::vector<int32_t> touched;
                uint32_t gen = 0;
                for (int64_t c = next++; c < n_chunks && !failed; c = next++) {
                    Part& out = r->parts[c];
                    for (int64_t l = bounds[c]; l < bounds[c + 1]; ++l) {
                        ++gen;
                        touched.clear();
                        for (int64_t p = y_indptr[l]; p < y_indptr[l + 1]; ++p) {
                            int64_t i = y_indices[p];
                            float yv = y_data[p];
                            for (int64_t q = x_indptr[i]; q < x_indptr[i + 1]; ++q) {
                                int32_t col = x_indices[q];
                                if (stamp[col] != gen) {
                                    stamp[col] = gen;
                                    scratch[col] = 0.0f;
                                    touched.push_back(col);
                                }
                                scratch[col] += yv * x_data[q];
                            }
                        }
                        // emit the row in sorted column order (canonical CSR)
                        std::sort(touched.begin(), touched.end());
                        for (int32_t col : touched) {
                            out.indices.push_back(col);
                            out.data.push_back(scratch[col]);
                        }
                        r->indptr[l + 1] = (int64_t)touched.size();
                    }
                }
            } catch (const std::bad_alloc&) {
                failed = true;
            }
        }, 1);
    } catch (const std::bad_alloc&) {
        failed = true;
    }
    if (failed) {
        delete r;
        return nullptr;
    }
    for (int64_t l = 0; l < L; ++l) r->indptr[l + 1] += r->indptr[l];
    return r;
}

int64_t spgemm_nnz(void* handle) { return ((SpgemmResult*)handle)->indptr.back(); }

void spgemm_fill(void* handle, int64_t* indptr, int32_t* indices, float* data) {
    SpgemmResult* r = (SpgemmResult*)handle;
    std::memcpy(indptr, r->indptr.data(), r->indptr.size() * sizeof(int64_t));
    int64_t at = 0;
    for (const Part& p : r->parts) {
        if (p.indices.empty()) continue;
        std::memcpy(indices + at, p.indices.data(), p.indices.size() * sizeof(int32_t));
        std::memcpy(data + at, p.data.data(), p.data.size() * sizeof(float));
        at += (int64_t)p.indices.size();
    }
}

void spgemm_free(void* handle) { delete (SpgemmResult*)handle; }

}  // extern "C"
