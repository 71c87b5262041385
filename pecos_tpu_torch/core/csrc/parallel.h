// Host threads for the core's loops, on std::thread in place of OpenMP: a
// g++ may ship without libgomp (its -fopenmp then fails to link), and the
// core must build wherever PyTorch runs.
#pragma once

#include <algorithm>
#include <cstdint>
#include <thread>
#include <vector>

// `requested` threads when > 0, else the machine's hardware threads.
inline int host_threads(int requested) {
    if (requested > 0) return requested;
    return std::max(1, (int)std::thread::hardware_concurrency());
}

// f(i) for every i in [0, n), as `#pragma omp parallel for schedule(static)`
// runs it: contiguous chunks, one a thread, the caller taking the first.
// Batches below `min_per_thread` items a thread run on fewer threads.
template <class F>
void parallel_for(int64_t n, int threads, F&& f, int64_t min_per_thread = 4096) {
    int64_t t_max = std::max<int64_t>(1, n / std::max<int64_t>(1, min_per_thread));
    int n_threads = (int)std::min<int64_t>(host_threads(threads), t_max);
    int64_t per = n_threads > 0 ? (n + n_threads - 1) / n_threads : n;
    auto chunk = [&](int t) {
        int64_t end = std::min(n, (t + 1) * per);
        for (int64_t i = t * per; i < end; ++i) f(i);
    };
    std::vector<std::thread> pool;
    for (int t = 1; t < n_threads; ++t) pool.emplace_back(chunk, t);
    chunk(0);
    for (auto& th : pool) th.join();
}
