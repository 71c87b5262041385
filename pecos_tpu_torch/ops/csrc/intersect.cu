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
// ids with value 0); a table (R, 2P) int32 of weight rows packed as
// [ids | float bits] (pad slots value 0); and a row index rows (N, K) int64
// naming the table row of candidate (n, k).  A row outside [0, R), -1 in
// particular, scores 0, as an all-zero row does.  A null index reads row
// n*K + k: the (N, K, 2P) gathered block as one table.  Output (N, K) float32.
//
// What bounds it on the card: the bytes of the weight rows.  The function is
// a gather and a product: N*K*P multiply-adds (21 MFLOP at the predict path's
// N=1024, K=160, P=64, Qn=256: 0.3 us at 67 TFLOP/s) over N*K*2P*4 bytes of
// rows (84 MB there: 25 us at 3.35 TB/s).  Two designs follow.
// 1. A hash of the query row, not all-pairs compares.  Each block stages its
//    query's nonzeros into an open-addressing table in shared memory: a
//    power of two >= 8x the staged entries (few probes past the first), key
//    and value side by side so one 8-byte load reads both, key -1 empty,
//    multiplicative hash, linear probing.  A weight slot then costs about one
//    probe instead of Qn compares.  Entries whose value is 0 are not
//    inserted: a missing key also gives g = 0, so this is exact, and the pad
//    runs (D+1, 1<<30) do not pile onto one slot.  Weight slots whose value
//    is 0 (pads) are not probed: they add g * 0 = 0 (for finite query
//    values).  A repeated id adds into its slot (atomicCAS, then atomicAdd),
//    so g is the same sum as the reference's, in another order.  A query
//    longer than one table (the wrapper's chunk) is taken in chunks: the
//    table is rebuilt for each, and the rows are probed again for each chunk
//    that staged an entry, the partial scores added into out by the lane
//    that owns the candidate.  A thread that stages an entry sets a flag in
//    shared memory, read after the barrier that follows the inserts; a chunk
//    past the first that staged none (pads alone) reads no row, since its
//    pass would add exact zeros (for finite weights: only the sign of a zero
//    score may differ).  The first chunk always runs and writes out with the
//    bias term.  The flag and the block's count of passes live in shared
//    memory, not in registers, which the probe loop needs (32 a thread);
//    launches whose queries fit one chunk pay for them too, 1-4% on an H100.
//    So a query padded to many chunks costs one pass over its rows for each
//    chunk that holds a nonzero, wherever in the row its nonzeros sit.
// 2. Rows read by id.  The kernel takes the row index and reads the table in
//    place, so no (N, K, 2P) block is written by a gather and read again.
//    Each block copies its candidates' row offsets into shared memory while
//    it builds the hash table.  A group of `lanes` lanes (32 at P >= 64,
//    fewer at small P) takes one candidate: lane l reads slots 2l, 2l+1 of
//    the ids and of the values as 8-byte loads (coalesced), probes,
//    multiplies, and the group reduces with __shfl_xor_sync.  Each group
//    loads two candidates' rows before probing either, and the kernel keeps
//    to 32 registers, so 8 blocks (64 warps) share an SM and many rows are
//    in flight.  The blocks of one query split its K candidates, so a batch
//    of one still spreads over tens of SMs.
// Only the order of the final P-sum (and of duplicate ids' sum) differs from
// the reference; the bias sum is kept apart, as there.
//
// The launch plan (table slots, chunk, lanes, candidates a block, grid,
// shared bytes) comes from the wrapper's _launch_plan.  The kernel allocates
// nothing and does not synchronise; the C entry point returns
// cudaGetLastError() for the caller.  Where `passes` is not null (an int64
// on the card), a block that probed chunks past its first adds their number
// to it, once, by thread 0; the wrapper counts the rest on the host (every
// block's first pass, and the ceil(Qn / chunk) chunks each block had).  So
// only blocks of queries longer than one chunk add, and a launch of one
// chunk adds nothing: a few thousand blocks adding to one address would
// queue on it.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;  // threads a block; must equal the wrapper's _THREADS
constexpr int kMinBlocks = 8;  // blocks an SM must hold: the register budget (32 a thread)
constexpr int kSlots = 2;      // weight slots a lane reads per candidate per pass
constexpr int kCands = 2;      // candidates a group loads before probing; the wrapper's _CANDS
constexpr int kEmpty = -1;     // key of an empty hash slot

__device__ __forceinline__ unsigned slot_of(int id, int shift) {
  return (static_cast<unsigned>(id) * 2654435761u) >> shift;
}

// g for one weight id: the staged query value of that id, or 0
__device__ __forceinline__ float probe(const int2* s_kv, int id, int shift, unsigned mask) {
  unsigned h = slot_of(id, shift);
  while (true) {
    const int2 e = s_kv[h];
    if (e.x == id) return __int_as_float(e.y);
    if (e.x == kEmpty) return 0.f;
    h = (h + 1) & mask;
  }
}

// slots p, p+1 of a row (p even): one 8-byte load each of ids and values
// when P is even, else two 4-byte loads; slots past P read as empty
__device__ __forceinline__ void load_pair(const int* row, int p, int P, int* id, float* val) {
  if (row == nullptr || p >= P) {
    id[0] = id[1] = kEmpty;
    val[0] = val[1] = 0.f;
  } else if ((P & 1) == 0) {
    const int2 i = __ldg(reinterpret_cast<const int2*>(row + p));
    const int2 v = __ldg(reinterpret_cast<const int2*>(row + P + p));
    id[0] = i.x;
    id[1] = i.y;
    val[0] = __int_as_float(v.x);
    val[1] = __int_as_float(v.y);
  } else {
    const bool two = p + 1 < P;
    id[0] = __ldg(row + p);
    val[0] = __int_as_float(__ldg(row + P + p));
    id[1] = two ? __ldg(row + p + 1) : kEmpty;
    val[1] = two ? __int_as_float(__ldg(row + P + p + 1)) : 0.f;
  }
}

__device__ __forceinline__ float group_sum(float v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
intersect_scores_kernel(const int* __restrict__ qids, const float* __restrict__ qvals,
                        const int* __restrict__ table, int64_t R, const int64_t* __restrict__ rows,
                        float* __restrict__ out, unsigned long long* __restrict__ passes, int K,
                        int P, int Qn, int chunk, int log2_slots, int lanes, int per_block,
                        int blocks_per_row, int has_bias, int bias_id, float bias_val) {
  // shared: the hash table (key, value bits), then the block's row offsets
  extern __shared__ int2 s_kv[];
  const int n_slots = 1 << log2_slots;
  int64_t* s_off = reinterpret_cast<int64_t*>(s_kv + n_slots);
  const unsigned mask = n_slots - 1;
  const int shift = 32 - log2_slots;

  const int n = blockIdx.x / blocks_per_row;
  const int k_begin = (blockIdx.x % blocks_per_row) * per_block;
  const int count = min(per_block, K - k_begin);
  const int lane = threadIdx.x & (lanes - 1);
  const int group = threadIdx.x / lanes;
  const int n_groups = kThreads / lanes;
  const int* qi_row = qids + static_cast<size_t>(n) * Qn;
  const float* qv_row = qvals + static_cast<size_t>(n) * Qn;
  float* out_row = out + static_cast<size_t>(n) * K + k_begin;
  const int64_t row_len = 2 * static_cast<int64_t>(P);

  for (int c = threadIdx.x; c < count; c += kThreads) {
    const int64_t flat = static_cast<int64_t>(n) * K + k_begin + c;
    const int64_t r = rows != nullptr ? rows[flat] : flat;
    s_off[c] = (r < 0 || r >= R) ? -1 : r * row_len;
  }

  __shared__ int s_staged;  // whether any thread staged an entry of this chunk
  __shared__ int s_probed;  // chunks whose rows this block probed (thread 0's count)
  if (threadIdx.x == 0) s_probed = 0;
  for (int q0 = 0; q0 < max(Qn, 1); q0 += chunk) {
    const int qn = min(chunk, Qn - q0);
    __syncthreads();  // the previous chunk's probes are done
    if (threadIdx.x == 0) s_staged = 0;
    for (int t = threadIdx.x; t < n_slots; t += kThreads) s_kv[t] = make_int2(kEmpty, 0);
    __syncthreads();
    bool staged = false;
    for (int t = threadIdx.x; t < qn; t += kThreads) {
      const float v = qv_row[q0 + t];
      if (v == 0.f) continue;
      staged = true;
      const int id = qi_row[q0 + t];
      unsigned h = slot_of(id, shift);
      while (true) {
        int* key = &s_kv[h].x;
        const int prev = atomicCAS(key, kEmpty, id);
        if (prev == kEmpty || prev == id) {
          atomicAdd(reinterpret_cast<float*>(&s_kv[h].y), v);
          break;
        }
        h = (h + 1) & mask;
      }
    }
    // a chunk of pads alone adds exact zeros: skip its pass, bar the first,
    // which writes out (every thread reads the same flag after the barrier)
    if (staged) s_staged = 1;
    __syncthreads();
    if (s_staged == 0 && q0 > 0) continue;
    if (threadIdx.x == 0) ++s_probed;

    // every group runs the same trip count, so the shuffles see whole warps
    for (int c0 = 0; c0 < count; c0 += kCands * n_groups) {
      const int* row[kCands];
      float score[kCands], bias_sum[kCands];
#pragma unroll
      for (int u = 0; u < kCands; ++u) {
        const int c = c0 + u * n_groups + group;
        const int64_t off = c < count ? s_off[c] : -1;
        row[u] = off >= 0 ? table + off : nullptr;
        score[u] = bias_sum[u] = 0.f;
      }
      for (int p0 = 0; p0 < P; p0 += kSlots * lanes) {
        int id[kCands][kSlots];
        float val[kCands][kSlots];
#pragma unroll
        for (int u = 0; u < kCands; ++u) load_pair(row[u], p0 + kSlots * lane, P, id[u], val[u]);
#pragma unroll
        for (int u = 0; u < kCands; ++u) {
#pragma unroll
          for (int j = 0; j < kSlots; ++j) {
            if (val[u][j] != 0.f) {  // a zero weight (pad, or a slot not loaded) adds nothing
              score[u] += probe(s_kv, id[u][j], shift, mask) * val[u][j];
              bias_sum[u] += (id[u][j] == bias_id) ? val[u][j] : 0.f;
            }
          }
        }
      }
#pragma unroll
      for (int u = 0; u < kCands; ++u) {
        const int c = c0 + u * n_groups + group;
        const float s = group_sum(score[u], lanes);
        const float b = has_bias ? group_sum(bias_sum[u], lanes) : 0.f;
        if (lane == 0 && c < count) {
          // the bias term once, with the first chunk; later chunks add into out
          if (q0 == 0) {
            out_row[c] = has_bias ? s + bias_val * b : s;
          } else {
            out_row[c] += s;
          }
        }
      }
    }
  }
  if (passes != nullptr && threadIdx.x == 0 && s_probed > 1) {
    atomicAdd(passes, static_cast<unsigned long long>(s_probed - 1));
  }
}

}  // namespace

extern "C" int pecos_intersect_scores(const void* qids, const void* qvals, const void* table,
                                      int64_t R, const void* rows, void* out, void* passes, int K,
                                      int P, int Qn, int chunk, int log2_slots, int lanes,
                                      int per_block, int blocks_per_row, int grid,
                                      int shared_bytes, int has_bias, int bias_id, float bias_val,
                                      void* stream) {
  if (grid == 0) return 0;
  // shared_bytes stays within the 48 KB a launch may take without
  // cudaFuncSetAttribute (the wrapper caps the table at 32 KB and the
  // offsets at 4 KB)
  intersect_scores_kernel<<<grid, kThreads, shared_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(qids), static_cast<const float*>(qvals),
      static_cast<const int*>(table), R, static_cast<const int64_t*>(rows),
      static_cast<float*>(out), static_cast<unsigned long long*>(passes), K, P, Qn, chunk,
      log2_slots, lanes, per_block, blocks_per_row, has_bias, bias_id, bias_val);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* pecos_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
