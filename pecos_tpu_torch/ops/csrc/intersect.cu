// K1: sparse-query x sparse-weight id-intersection scores, CUDA C++ for sm_90a.
//
// Replaces the Pallas TPU kernel pecos_tpu/ops/intersect.py:intersect_scores_pallas
// and computes the contract of pecos_tpu/xmc/inference.py:_intersect_scores:
//
//   out[n,k] = sum_p wv[n,k,p] * g[n,k,p]
//            + bias_val * sum_p wv[n,k,p] * [wi[n,k,p] == bias_id]     (has_bias)
//   g[n,k,p] = sum_q qv[n,q] * [qi[n,q] == wi[n,k,p]]
//
// Inputs: qids/qvals (N, Qn) int32/float32, the query's padded nonzeros (pad
// id D+1, value 0); w_packed (N, K, 2P) int32, each candidate's weight slots
// as [ids | float bits] (pad slots id 0, value 0).  Output (N, K) float32.
//
// g adds EVERY matching query slot (no early exit), so duplicate or pad ids
// give the same sum as the reference.  CSR ids are unique per row, so g is a
// sum of disjoint singletons and is exact; only the order of the final P-sum
// differs from the reference (here: p ascending, possibly FMA-contracted).
//
// What bounds it on the card: integer compare throughput, not memory.  At the
// predict path's shape (N=1024, K=160, P=64, Qn=256) one call makes
// N*K*P*Qn = 2.7e9 compare-select-adds (~3 instructions each) over ~86 MB of
// input, the gathered weight block being most of it: ~90 instructions per
// byte, while an H100 SXM executes about 5 INT32 / 10 FP32 lane-instructions per
// byte of its 3.35 TB/s HBM (132 SMs x 64 INT32 / 128 FP32 lanes x 1.98 GHz).
// The floor is ~0.25 ms per call at that shape, set by the integer compares.
// The design keeps the inner loop free of global memory: each block
// stages its query row in shared memory once (in chunks of kChunk when Qn is
// larger), every lane of the warp reads the same shared address (a broadcast),
// and each thread holds kSlots weight slots of its candidate in registers, so
// one query nonzero costs two shared loads plus kSlots (compare, select, add).
// Cutting the Qn factor itself (a sorted merge or a hash of the query row) and
// reading parent_packed rows in place of the gathered block are later work.
//
// The kernel allocates nothing and does not synchronise; the C entry point
// returns cudaGetLastError() for the caller to check.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 32;  // candidates per block: one warp
constexpr int kChunk = 512;   // query nonzeros staged in shared memory at a time
constexpr int kSlots = 8;     // weight slots held in registers per pass over the query

__global__ void __launch_bounds__(kThreads)
intersect_scores_kernel(const int* __restrict__ qids, const float* __restrict__ qvals,
                        const int* __restrict__ w_packed, float* __restrict__ out, int K,
                        int P, int Qn, int has_bias, int bias_id, float bias_val) {
  __shared__ int s_id[kChunk];
  __shared__ float s_val[kChunk];

  const int n = blockIdx.x;
  const int k = blockIdx.y * kThreads + threadIdx.x;
  const bool active = k < K;
  const int* qi_row = qids + static_cast<size_t>(n) * Qn;
  const float* qv_row = qvals + static_cast<size_t>(n) * Qn;
  const int* w_row = w_packed + (static_cast<size_t>(n) * K + (active ? k : 0)) * 2 * P;
  const int n_chunks = (Qn + kChunk - 1) / kChunk;

  float score = 0.f;
  float bias_sum = 0.f;
  for (int p0 = 0; p0 < P; p0 += kSlots) {
    int wid[kSlots];
    float wv[kSlots];
    float g[kSlots];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const bool ok = active && p0 + j < P;
      wid[j] = ok ? w_row[p0 + j] : 0;
      wv[j] = ok ? __int_as_float(w_row[P + p0 + j]) : 0.f;
      g[j] = 0.f;
    }
    for (int c = 0; c < n_chunks; ++c) {
      const int q0 = c * kChunk;
      const int qn = min(kChunk, Qn - q0);
      // one chunk stays staged across all passes; several are restaged per pass
      if (n_chunks > 1 || p0 == 0) {
        __syncthreads();
        for (int t = threadIdx.x; t < qn; t += kThreads) {
          s_id[t] = qi_row[q0 + t];
          s_val[t] = qv_row[q0 + t];
        }
        __syncthreads();
      }
#pragma unroll 4
      for (int q = 0; q < qn; ++q) {
        const int id = s_id[q];
        const float v = s_val[q];
#pragma unroll
        for (int j = 0; j < kSlots; ++j) g[j] += (id == wid[j]) ? v : 0.f;
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      if (p0 + j < P) {
        score += g[j] * wv[j];
        if (has_bias && wid[j] == bias_id) bias_sum += wv[j];
      }
    }
  }
  if (active) {
    out[static_cast<size_t>(n) * K + k] = has_bias ? score + bias_val * bias_sum : score;
  }
}

}  // namespace

extern "C" int pecos_intersect_scores(const void* qids, const void* qvals, const void* w_packed,
                                      void* out, int N, int K, int P, int Qn, int has_bias,
                                      int bias_id, float bias_val, void* stream) {
  if (N == 0 || K == 0) return 0;
  const dim3 grid(N, (K + kThreads - 1) / kThreads);
  intersect_scores_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qids), static_cast<const float*>(qvals),
      static_cast<const int*>(w_packed), static_cast<float*>(out), K, P, Qn, has_bias, bias_id,
      bias_val);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pecos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
