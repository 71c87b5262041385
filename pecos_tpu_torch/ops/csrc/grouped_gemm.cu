// Grouped GEMM: out[r] = A[r] @ B[e(r)]^T for the rows r of each group e, bfloat16
// in, float32 accumulation, bfloat16 out.  CUDA C++ for sm_90a (WGMMA, TMA).
//
// It replaces no TPU kernel: the JAX package has no expert layer.  It was
// added for the sparse-expert encoders of XR-Transformer (moe.py): every
// expert of a layer multiplies the tokens routed to it by its own weights,
// and one launch covers all experts.
//
// Inputs: A (M, K) row-major, its rows grouped by expert (group e is rows
// offsets[e] .. offsets[e+1]-1); B (E, N, K) row-major, expert e's weights
// (an nn.Linear's (out, in) layout, so both operands are K-major); offsets
// (E+1,) int64 on the card, ascending, offsets[0] = 0, offsets[E] <= M.
// Rows at and past offsets[E] are not computed or written: the expert layer
// sorts the pairs of padding tokens there, so they cost nothing.
// N must be a multiple of 128 and K of 64 (the wrapper checks).
//
// One template, three epilogues chosen at compile time; every instance is
// named grouped_gemm_kernel<...> in a trace:
// - kStore: out (M, N), row r of the product in row r.
// - kSwiglu, the expert layer's gate and up projections: B is (E, 2I, K),
//   expert e's gate rows first, then its up rows.  A block computes 64 gate
//   columns n0.. and the same 64 up columns I + n0.. (two 64-row TMA boxes,
//   one 128-column accumulator), so in wgmma's accumulator layout a thread
//   holds gate column c in acc[4j..4j+3] and up column c in acc[4(j+8)..],
//   and the epilogue is register-local.  It stores act (M, I) =
//   bf16(bf16(silu(bf16(gate))) * bf16(up)), SiLU in float32 with expf: the
//   roundings of PyTorch's F.silu(h[:, :I]) * h[:, I:] on the bf16 h, bit
//   for bit, without h (M x 2I) ever reaching device memory.
// - kScatter, the expert layer's down projection: row r is stored in row
//   dest[r] of out (the pair's token slot, t k + j), so the pairs come back
//   in token order without an index_put over device memory.
// A is read by TMA from a gathered copy of the pairs' token rows: a
// producer that gathered them itself (16-byte cp.async by token id, placed
// by the 128-byte swizzle rule) made the gate-up launch 2.4 ms slower at the
// expert layer's shapes, where the gather it saves takes 0.54 ms.
//
// What bounds it on the card: operations.  At the expert layer's shapes
// (~180K rows a layer over 64 experts, N 2,816 or 2,048, K 2,048 or 1,408)
// a launch does 2 M N K ~ 2 TFLOP over ~1 GB of operands: ~2.1 ms at 989
// TFLOP/s against ~0.3 ms at 3.35 TB/s (less in kSwiglu, which writes half
// the columns).  So the design keeps the tensor cores fed:
// - Tiles of 128 rows x 128 columns, 64 deep.  Each block owns one tile of
//   one group.  The grid is (N / 128) x (ceil(M / 128) + E): an upper bound
//   on the tiles of any split of M rows into E groups, read without waiting
//   for the card.  Each block finds its group by walking the offsets (65
//   loads, from L2); blocks past the last tile exit at once.  The column
//   tile varies fastest, so the blocks of a wave share their A tile and
//   one expert's B in L2.
// - Warp specialisation: one producer warpgroup, whose first thread starts
//   TMA loads of A and B tiles into a ring of 5 stages (128-byte swizzle,
//   completion on an mbarrier per stage), and two consumer warpgroups, each
//   computing 64 rows of the tile with wgmma.m64n128k16 from shared memory
//   into 64 float32 registers a thread.  A consumer releases a stage (a
//   second mbarrier) once its wgmmas on it have completed.
// - A tile's rows past its group's end belong to the next group (or lie
//   past M, where TMA fills zeros): they are computed and not stored.
// The kernel allocates nothing and does not synchronise; the C entry points
// return cudaGetLastError(), or a negative code where the tensor maps could
// not be made.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>

#include <cstdint>

namespace {

constexpr int kBM = 128;                  // rows of a tile: two consumer warpgroups of 64
constexpr int kBN = 128;                  // columns of a tile: wgmma's n
constexpr int kBK = 64;                   // depth of a stage: one 128-byte swizzle row of bf16
constexpr int kStages = 5;                // stages of the ring
constexpr int kConsumers = 2;             // consumer warpgroups
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileA = kBM * kBK * 2;     // bytes of a stage's A tile
constexpr int kTileB = kBN * kBK * 2;     // bytes of a stage's B tile
constexpr int kStageBytes = kTileA + kTileB;
constexpr int kSharedBytes = 1024 + kStages * kStageBytes + 2 * kStages * 8;

enum Epilogue { kStore, kSwiglu, kScatter };

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// one 2-D TMA load of a (rows x 64) box at (col, row) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::
          "r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(smem_addr(bar))
      : "memory");
}

// a wgmma operand descriptor: K-major rows of 128 bytes, 128-byte swizzle,
// 8-row groups 1,024 bytes apart
__device__ __forceinline__ uint64_t smem_desc(const void* p) {
  const uint64_t addr = smem_addr(p);
  uint64_t desc = (addr & 0x3FFFF) >> 4;
  desc |= uint64_t(16 >> 4) << 16;
  desc |= uint64_t(1024 >> 4) << 32;
  desc |= uint64_t(1) << 62;
  return desc;
}

// d (64 x 128 fp32, this thread's 64 values) += A (64 x 16, K-major) * B (128 x 16, K-major)^T
__device__ __forceinline__ void wgmma_m64n128k16(float* d, uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63},"
      " %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// the group and first row of tile `tile` of the split by `offsets`; false
// past the last tile
__device__ __forceinline__ bool find_tile(const int64_t* __restrict__ offsets, int E, int tile, int* group,
                                          int64_t* row0, int* rows) {
  int seen = 0;
  int64_t a = offsets[0];
  for (int g = 0; g < E; ++g) {
    const int64_t b = offsets[g + 1];
    const int t = static_cast<int>((b - a + kBM - 1) / kBM);
    if (tile < seen + t) {
      *group = g;
      *row0 = a + static_cast<int64_t>(tile - seen) * kBM;
      *rows = static_cast<int>(b - *row0 < kBM ? b - *row0 : kBM);
      return true;
    }
    seen += t;
    a = b;
  }
  return false;
}

// PyTorch's F.silu(g) * u on bfloat16 g and u: each op in float32, rounded to bfloat16
__device__ __forceinline__ float silu_mul(float gate, float up) {
  const float g = __bfloat162float(__float2bfloat16_rn(gate));
  const float u = __bfloat162float(__float2bfloat16_rn(up));
  const float s = __bfloat162float(__float2bfloat16_rn(g / (1.0f + expf(-g))));
  return s * u;
}

// dest is null outside kScatter.  N is B's rows an expert (2I in kSwiglu);
// ldo the row stride of out (I in kSwiglu, else N).
template <int kEpilogue>
__global__ void __launch_bounds__(kThreads, 1)
grouped_gemm_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_b,
                    const int64_t* __restrict__ offsets, int E, int N, int K, const int64_t* __restrict__ dest,
                    __nv_bfloat16* __restrict__ out, int ldo) {
  int group, rows;
  int64_t row0;
  if (!find_tile(offsets, E, blockIdx.y, &group, &row0, &rows)) return;
  // first output column of the block; in kSwiglu also its first gate row (up: + N/2)
  const int n0 = blockIdx.x * (kEpilogue == kSwiglu ? kBN / 2 : kBN);

  extern __shared__ unsigned char smem_raw[];
  const uint32_t pad = (1024u - (smem_addr(smem_raw) & 1023u)) & 1023u;
  unsigned char* tiles = smem_raw + pad;
  uint64_t* full = reinterpret_cast<uint64_t*>(tiles + kStages * kStageBytes);
  uint64_t* empty = full + kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int k_tiles = K / kBK;
  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    if (threadIdx.x == 0) {  // the producer
      const int b_row = group * N + n0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const int s = kt % kStages;
        if (kt >= kStages) mbar_wait(&empty[s], ((kt / kStages) - 1) & 1);
        unsigned char* stage = tiles + s * kStageBytes;
        mbar_expect_tx(&full[s], kStageBytes);
        tma_load(stage, &map_a, &full[s], kt * kBK, static_cast<int>(row0));
        if (kEpilogue == kSwiglu) {
          tma_load(stage + kTileA, &map_b, &full[s], kt * kBK, b_row);
          tma_load(stage + kTileA + kTileB / 2, &map_b, &full[s], kt * kBK, b_row + N / 2);
        } else {
          tma_load(stage + kTileA, &map_b, &full[s], kt * kBK, b_row);
        }
      }
    }
    return;
  }

  const int c = wg - 1;  // this consumer's 64 rows of the tile
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int kt = 0; kt < k_tiles; ++kt) {
    const int s = kt % kStages;
    mbar_wait(&full[s], (kt / kStages) & 1);
    const unsigned char* a_tile = tiles + s * kStageBytes + c * 64 * kBK * 2;
    const unsigned char* b_tile = tiles + s * kStageBytes + kTileA;
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      wgmma_m64n128k16(acc, smem_desc(a_tile + kk * 32), smem_desc(b_tile + kk * 32));
    }
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    if (threadIdx.x % 128 == 0) mbar_arrive(&empty[s]);
  }

  // wgmma's accumulator layout: warp w of the warpgroup holds rows 16w..16w+15;
  // lane l holds rows l/4 and l/4 + 8 of those, columns 8j + 2(l%4) and the next
  const int t = threadIdx.x % 128;
  const int r = c * 64 + (t / 32) * 16 + (t % 32) / 4;
  const int col = n0 + 2 * (t % 4);
  int64_t out_r = row0 + r, out_r8 = row0 + r + 8;
  if (kEpilogue == kScatter) {
    out_r = r < rows ? dest[out_r] : 0;
    out_r8 = r + 8 < rows ? dest[out_r8] : 0;
  }
  __nv_bfloat16* o0 = out + out_r * static_cast<int64_t>(ldo) + col;
  __nv_bfloat16* o8 = out + out_r8 * static_cast<int64_t>(ldo) + col;
  if (kEpilogue == kSwiglu) {
#pragma unroll
    for (int j = 0; j < kBN / 16; ++j) {
      const float* g = acc + 4 * j;
      const float* u = acc + 4 * (j + kBN / 16);
      if (r < rows)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) =
            __floats2bfloat162_rn(silu_mul(g[0], u[0]), silu_mul(g[1], u[1]));
      if (r + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(o8 + 8 * j) =
            __floats2bfloat162_rn(silu_mul(g[2], u[2]), silu_mul(g[3], u[3]));
    }
  } else {
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      if (r < rows)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * j) = __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r + 8 < rows)
        *reinterpret_cast<__nv_bfloat162*>(o8 + 8 * j) = __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the libcuda.so.1 the process has loaded, so
// the library links against the CUDA runtime alone
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    if (lib != nullptr) fn = reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// a (rows, cols) row-major bf16 matrix read in (box_rows x 64) boxes, 128-byte swizzle
int make_map(CUtensorMap* map, const void* base, int64_t rows, int64_t cols, int box_rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return -1;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(cols) * 2};
  const cuuint32_t box[2] = {kBK, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                          elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : -1000 - static_cast<int>(res);
}

// one launch of a mode over the M rows of a
template <int kEpilogue>
int launch(const void* a, const void* b, const void* offsets, const int64_t* dest, void* out, int64_t M, int E, int N,
           int K, void* stream) {
  if (M == 0) return 0;
  CUtensorMap map_a, map_b;
  int err = make_map(&map_a, a, M, K, kBM);
  if (err == 0) err = make_map(&map_b, b, static_cast<int64_t>(E) * N, K, kEpilogue == kSwiglu ? kBN / 2 : kBN);
  if (err != 0) return err;
  // above 48 KB of shared memory a launch needs the attribute, set on the current device
  const cudaError_t e = cudaFuncSetAttribute(grouped_gemm_kernel<kEpilogue>,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, kSharedBytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int ldo = kEpilogue == kSwiglu ? N / 2 : N;
  const dim3 grid(ldo / (kEpilogue == kSwiglu ? kBN / 2 : kBN), static_cast<unsigned>((M + kBM - 1) / kBM + E));
  grouped_gemm_kernel<kEpilogue><<<grid, kThreads, kSharedBytes, static_cast<cudaStream_t>(stream)>>>(
      map_a, map_b, static_cast<const int64_t*>(offsets), E, N, K, dest, static_cast<__nv_bfloat16*>(out), ldo);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (M, N) = the rows of each group of a (M, K) times that group's b (E, N, K)^T
extern "C" int pecos_grouped_gemm(const void* a, const void* b, const void* offsets, void* out, int64_t M, int E,
                                  int N, int K, void* stream) {
  return launch<kStore>(a, b, offsets, nullptr, out, M, E, N, K, stream);
}

// act (M, N/2) = SiLU(gate) * up of each group's rows of a (M, K) times its b (E, N, K)^T,
// gate rows :N/2, up rows N/2:
extern "C" int pecos_grouped_gemm_swiglu(const void* a, const void* b, const void* offsets, void* out, int64_t M,
                                         int E, int N, int K, void* stream) {
  return launch<kSwiglu>(a, b, offsets, nullptr, out, M, E, N, K, stream);
}

// out[dest[r]] = row r of each group of a (M, K) times its b (E, N, K)^T, for r < offsets[E]
extern "C" int pecos_grouped_gemm_scatter(const void* a, const void* b, const void* offsets, const void* dest,
                                          void* out, int64_t M, int E, int N, int K, void* stream) {
  return launch<kScatter>(a, b, offsets, static_cast<const int64_t*>(dest), out, M, E, N, K, stream);
}
