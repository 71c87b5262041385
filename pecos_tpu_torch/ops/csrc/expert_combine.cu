// The expert layer's combine: each token's routed experts' rows, weighted by
// their gates and summed in float32, plus the shared experts' row, bfloat16
// out.  CUDA C++ for sm_90a.
//
// It replaces no TPU kernel: the JAX package has no expert layer.  It was
// added for the sparse-expert encoders of XR-Transformer (moe.py), in place
// of five passes over device memory: the float32 copy of the pairs, a
// batched gemv, where(keep), the cast to bfloat16 and the add of the shared
// experts' output.  For token t with k experts:
//
//   out[t] = bf16(float(bf16(keep[t] ? sum_j gates[t, j] * float(pairs[t k + j]) : 0)) + float(shared[t]))
//
// the sum over j in order, one fused multiply-add a term, in float32: the
// roundings of the passes it replaces, the gemv's order of summation aside.
// A token whose keep is False reads none of its pair rows (the grouped GEMM
// wrote none of them).  Deterministic: each output element is one thread's.
//
// Inputs: pairs (T k, H) bf16, the pairs in token order; gates (T, k)
// float32; keep (T,) bool; shared (T, H) bf16; out (T, H) bf16.  H must be a
// multiple of 8 and every row 16-byte aligned (the wrapper checks).
//
// What bounds it on the card: bytes.  It does k multiply-adds for every 2 k
// + 4 bytes it moves, far below the 295 operations a byte where the tensor
// cores would be the limit; at the expert layer's shapes (T 32,768, k 6, H
// 2,048) it reads ~0.94 GB and writes 0.13 GB a layer: ~0.32 ms at 3.35
// TB/s.  So each thread owns 8 consecutive columns of one token and moves
// them in 16-byte loads and stores, a warp 512 contiguous bytes of a row.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kVec = 8;  // bf16 columns a thread: one 16-byte load

__global__ void __launch_bounds__(kThreads)
expert_combine_kernel(const __nv_bfloat16* __restrict__ pairs, const float* __restrict__ gates,
                      const bool* __restrict__ keep, const __nv_bfloat16* __restrict__ shared,
                      __nv_bfloat16* __restrict__ out, int64_t T, int k, int H) {
  const int per_token = H / kVec;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= T * per_token) return;
  const int64_t t = i / per_token;
  const int64_t col = (i % per_token) * kVec;
  float acc[kVec];
#pragma unroll
  for (int q = 0; q < kVec; ++q) acc[q] = 0.f;
  if (keep[t]) {
    for (int j = 0; j < k; ++j) {
      const float g = gates[t * k + j];
      const uint4 raw = *reinterpret_cast<const uint4*>(pairs + (t * k + j) * H + col);
      const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
      for (int q = 0; q < kVec / 2; ++q) {
        const float2 v = __bfloat1622float2(p[q]);
        acc[2 * q] = fmaf(g, v.x, acc[2 * q]);
        acc[2 * q + 1] = fmaf(g, v.y, acc[2 * q + 1]);
      }
    }
  }
  const uint4 raw = *reinterpret_cast<const uint4*>(shared + t * H + col);
  const __nv_bfloat162* s = reinterpret_cast<const __nv_bfloat162*>(&raw);
  uint4 res;
  __nv_bfloat162* o = reinterpret_cast<__nv_bfloat162*>(&res);
#pragma unroll
  for (int q = 0; q < kVec / 2; ++q) {
    const float2 v = __bfloat1622float2(s[q]);
    const float r0 = __bfloat162float(__float2bfloat16_rn(acc[2 * q]));
    const float r1 = __bfloat162float(__float2bfloat16_rn(acc[2 * q + 1]));
    o[q] = __floats2bfloat162_rn(r0 + v.x, r1 + v.y);
  }
  *reinterpret_cast<uint4*>(out + t * H + col) = res;
}

}  // namespace

// out (T, H) = the gate-weighted sum of each kept token's k pair rows, plus its shared row
extern "C" int pecos_expert_combine(const void* pairs, const void* gates, const void* keep, const void* shared,
                                    void* out, int64_t T, int k, int H, void* stream) {
  if (T == 0) return 0;
  const int64_t threads = T * (H / kVec);
  const int64_t blocks = (threads + kThreads - 1) / kThreads;
  expert_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(pairs), static_cast<const float*>(gates), static_cast<const bool*>(keep),
      static_cast<const __nv_bfloat16*>(shared), static_cast<__nv_bfloat16*>(out), T, k, H);
  return static_cast<int>(cudaGetLastError());
}
