// A GEMM core for Hopper (sm_90a): bf16 operands, f32 accumulation, TMA
// loads into a ring of shared-memory stages guarded by mbarriers, wgmma on
// the tensor cores, and a caller's epilogue.
//
//     C[m, n] = sum_k A[m, k] B[k, n]      (0 <= m < M, 0 <= n < N, k < K)
//
// Each operand is a row-major bf16 matrix in device memory, read in one of
// two majors:
//   A, kTransA = 0 (K-major):  stored [M][K];    kTransA = 1 (MN-major): [K][M]
//   B, kTransB = 0 (K-major):  stored [N][K];    kTransB = 1 (MN-major): [K][N]
// so C = A B^T with both K-major (a linear layer's input gradient) and
// C = A^T B with both MN-major (a weight gradient over rows).  Every row
// stride must be a multiple of 16 bytes (TMA), so the stored row length is
// a multiple of 8.
//
// Design.  A CTA owns a kBM x kBN = 128 x 128 tile of C (and, split over K,
// one of `splits` slices of the reduction).  Its 160 threads are one
// consumer warpgroup (warps 0-3) and one producer warp (warp 4).  Lane 0 of
// the producer walks the k steps of 64, and for each waits for a free stage
// (its `empty` barrier), arms the stage's `full` barrier with the stage's
// byte count and starts the TMA loads of the A and B tiles into it (128-byte
// swizzle; a K-major tile is one 64 x 128 box, an MN-major tile two 64 x 64
// boxes side by side).  The consumer warpgroup waits on `full`, runs
// 4 k16 steps x 2 halves of m64n128k16 wgmma with both operands read from
// shared memory through matrix descriptors (the transpose bits select the
// MN-major reads), keeps one group in flight and frees the previous stage
// once its group has retired.  Rows, columns and k past the matrix load as
// zeros (TMA's out-of-bounds fill), and the epilogue is called only inside
// the matrix.  Three stages of 32 KB and 160 threads let two CTAs share an
// SM, so one CTA's epilogue overlaps the other's main loop.
//
// The epilogue.  After the main loop the consumer warpgroup writes its
// 2 x 64 f32 accumulators a thread into the free stages as a 128 x 128 f32
// tile, then calls epi.vec8(split, row, col, v) for 8 consecutive elements
// v[0..7] = C[row, col..col+7] (col a multiple of 8, N a multiple of 8), 16
// neighbouring threads on one row, so that the functor's own loads and
// stores are 16 bytes wide and coalesced.  The functor fuses its elementwise
// work into the store; nothing is summed across CTAs here (a split-K caller
// writes one partial per split and sums them in a fixed order itself).
#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

constexpr int kBM = 128, kBN = 128, kBK = 64, kStages = 3;
constexpr int kConsumers = 128;                // one warpgroup
constexpr int kThreads = kConsumers + 32;      // + one producer warp
constexpr int kTileBytes = 128 * kBK * 2;      // one 128 x 64 bf16 tile
constexpr int kStageBytes = 2 * kTileBytes;    // A and B
constexpr int kSmemBytes = kStages * kStageBytes + 1024 + 2 * kStages * 8;
static_assert(kBM * (kBN + 4) * 4 <= kStages * kStageBytes,
              "the epilogue's f32 tile fits the stages");
constexpr int kTargetCtas = 264;               // two CTAs on each of 132 SMs

// ---- PTX wrappers ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

// Spins until the phase of parity `parity` has completed.  A wait of more
// than ~2^34 cycles (seconds) means a broken pipeline: trap, do not hang.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  long long start = 0;
  do {
    if (start == 0) {
      start = clock64();
    } else if (clock64() - start > (1ll << 34)) {
      __trap();
    }
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// Whether the phase of parity `parity` has completed, without waiting.
__device__ __forceinline__ bool mbar_test(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int inner, int outer) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(inner), "r"(outer)
      : "memory");
}

// A wgmma matrix descriptor for a 128-byte-swizzled tile in shared memory:
// start address, leading and stride byte offsets (16-byte units), layout 1.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// a barrier of the consumer warpgroup alone (the producer warp is elsewhere)
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1), "n"(kTransA), "n"(kTransB));
}

// The forms with A from registers, for a kernel that folds one product's
// output into the next (csrc/cand_score_fwd.cu): A is a 64 x 16 bf16
// fragment, four 32-bit registers a thread, laid out as the accumulator of
// an m64nNk16 product (a thread's accumulator registers 8 s .. 8 s + 7,
// rounded and packed in pairs, are the A fragment of k16 step s).
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, %70;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
}

template <int kTransB>
__device__ __forceinline__ void wgmma_m64n64k16_rs(float (&d)[32], const uint32_t* a,
                                                    uint64_t desc_b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, %38;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1), "n"(kTransB));
}

// a barrier of `count` threads on hardware barrier `id` (1-15)
__device__ __forceinline__ void named_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// orders this thread's generic-proxy shared-memory writes before later
// async-proxy reads of them (wgmma's operand reads)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---- the tile layouts in shared memory ----
//
// K-major tile (128 rows of 64 k, one TMA box): row r at r * 128 bytes, each
// 8-row group a 1024-byte swizzle atom.  A k16 step starts 32 bytes further
// along the row; the second m64 half starts 64 rows (8192 bytes) on.  The
// descriptor's stride byte offset is the 1024 bytes between 8-row groups.
//
// MN-major tile (64 k rows of 128, two 64-wide TMA boxes of 8 KB): k row kr
// of box b at b * 8192 + kr * 128.  A k16 step starts 16 rows (2048 bytes)
// on; the leading byte offset is the 8192 bytes between the two 64-wide
// boxes, the stride byte offset the 1024 bytes between 8-k-row groups.
template <int kTrans>
__device__ __forceinline__ uint64_t operand_desc(uint32_t tile, int half, int kk) {
  if (kTrans == 0) return smem_desc(tile + half * 8192 + kk * 32, 16, 1024);
  return smem_desc(tile + half * 8192 + kk * 2048, 8192, 1024);
}

// The loads of one operand tile: (row or column) offset mn0, k offset k0.
template <int kTrans>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map,
                                          uint32_t bar, int mn0, int k0) {
  if (kTrans == 0) {
    tma_load_2d(dst, map, bar, k0, mn0);
  } else {
    tma_load_2d(dst, map, bar, mn0, k0);
    tma_load_2d(dst + 8192, map, bar, mn0 + 64, k0);
  }
}

template <int kTransA, int kTransB, class Epi>
__global__ void __launch_bounds__(kThreads, 2)
    gemm_kernel(const __grid_constant__ CUtensorMap map_a,
                const __grid_constant__ CUtensorMap map_b, int M, int N, int K,
                int k_per_split, Epi epi) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzle atoms need 1024-byte alignment
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  const uint32_t bars = base + kStages * kStageBytes;  // full[s], then empty[s]
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int split = blockIdx.z;
  const int k_begin = split * k_per_split;
  const int k_end = min(K, k_begin + k_per_split);
  const int steps = k_end > k_begin ? (k_end - k_begin + kBK - 1) / kBK : 0;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- producer warp: lane 0 keeps the ring full ----
    if (tid == kConsumers) {
      for (int it = 0; it < steps; ++it) {
        const int s = it % kStages;
        mbar_wait(empty(s), ((it / kStages) & 1) ^ 1);
        const uint32_t a_tile = base + s * kStageBytes;
        const uint32_t b_tile = a_tile + kTileBytes;
        mbar_expect_tx(full(s), kStageBytes);
        const int k0 = k_begin + it * kBK;
        load_tile<kTransA>(a_tile, &map_a, full(s), m0, k0);
        load_tile<kTransB>(b_tile, &map_b, full(s), n0, k0);
      }
    }
  } else {
    // ---- consumer warpgroup ----
    float acc[2][64];
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[h][i] = 0.f;
    for (int it = 0; it < steps; ++it) {
      const int s = it % kStages;
      mbar_wait(full(s), (it / kStages) & 1);
      const uint32_t a_tile = base + s * kStageBytes;
      const uint32_t b_tile = a_tile + kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        const uint64_t db = operand_desc<kTransB>(b_tile, 0, kk);
#pragma unroll
        for (int h = 0; h < 2; ++h)
          wgmma_m64n128k16<kTransA, kTransB>(acc[h], operand_desc<kTransA>(a_tile, h, kk),
                                             db);
      }
      wgmma_commit();
      if (it > 0) {
        wgmma_wait<1>();  // the previous step's group has read its stage
        if (tid == 0) mbar_arrive(empty((it - 1) % kStages));
      }
    }
    wgmma_wait<0>();

    // ---- epilogue: accumulator element i of half h of thread tid lies at
    // row 64 h + 16 warp + lane / 4 + 8 ((i / 2) % 2), column 8 (i / 4) +
    // 2 (lane % 4) + i % 2; staged as an f32 tile with rows of kLd floats ----
    constexpr int kLd = kBN + 4;
    float* tile = reinterpret_cast<float*>(smem_raw + (base - raw));
    const int warp = tid / 32, lane = tid % 32;
    consumer_sync();  // no wgmma of the warpgroup reads the stages any more
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          *reinterpret_cast<float2*>(
              tile + (64 * h + 16 * warp + lane / 4 + 8 * e) * kLd + 8 * j +
              2 * (lane % 4)) =
              make_float2(acc[h][4 * j + 2 * e], acc[h][4 * j + 2 * e + 1]);
    consumer_sync();
#pragma unroll 4
    for (int v = tid; v < kBM * kBN / 8; v += kConsumers) {
      const int r = v / (kBN / 8), c = (v % (kBN / 8)) * 8;
      const int row = m0 + r, col = n0 + c;
      if (row < M && col < N) {
        const float4 lo = *reinterpret_cast<const float4*>(tile + r * kLd + c);
        const float4 hi = *reinterpret_cast<const float4*>(tile + r * kLd + c + 4);
        const float vals[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
        epi.vec8(split, row, col, vals);
      }
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, a CUDA driver API function, found at run time
// (the library links the CUDA runtime only).
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The map of a row-major bf16 matrix [outer][inner] read in boxes of
// box_inner x box_outer with 128-byte swizzle (box_inner = 64: 128 bytes).
inline bool make_map(CUtensorMap* map, const void* ptr, uint64_t inner, uint64_t outer,
                     uint32_t box_inner, uint32_t box_outer) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr || inner % 8 != 0 || reinterpret_cast<uintptr_t>(ptr) % 16 != 0)
    return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {inner * 2};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
            strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The k steps each of `splits` slices of the reduction covers, in elements
// (a multiple of kBK).
inline int k_per_split(int K, int splits) {
  const int steps = (K + kBK - 1) / kBK;
  return (steps + splits - 1) / splits * kBK;
}

// How many slices of a K-long reduction fill the card with CTAs of an
// M x N output: about kTargetCtas CTAs, each over at least 8 k steps.
inline int splits_for(int M, int N, long long K) {
  const long long tiles = (long long)((M + kBM - 1) / kBM) * ((N + kBN - 1) / kBN);
  long long s = kTargetCtas / tiles;
  const long long most = (K + 8 * kBK - 1) / (8 * kBK);
  s = s < most ? s : most;
  return (int)(s > 1 ? s : 1);
}

// Launches C = A op B (see the top of the file) on `stream`, the reduction
// over K cut into `splits` slices (blockIdx.z); returns the launch's error.
template <int kTransA, int kTransB, class Epi>
cudaError_t gemm(const void* a, const void* b, int M, int N, int K, int splits, Epi epi,
                 cudaStream_t stream) {
  if (M <= 0 || N <= 0 || K <= 0 || splits <= 0 || N % 8 != 0)
    return cudaErrorInvalidValue;
  CUtensorMap map_a, map_b;
  const bool ok_a = kTransA == 0 ? make_map(&map_a, a, K, M, kBK, kBM)
                                 : make_map(&map_a, a, M, K, 64, kBK);
  const bool ok_b = kTransB == 0 ? make_map(&map_b, b, K, N, kBK, kBN)
                                 : make_map(&map_b, b, N, K, 64, kBK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  auto kernel = gemm_kernel<kTransA, kTransB, Epi>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBN - 1) / kBN, (M + kBM - 1) / kBM, splits);
  kernel<<<grid, kThreads, kSmemBytes, stream>>>(map_a, map_b, M, N, K,
                                                 k_per_split(K, splits), epi);
  return cudaGetLastError();
}

// ---- epilogues ----

// C as bf16, row-major with leading dimension ld (a multiple of 8).
struct StoreBf16 {
  __nv_bfloat16* c;
  int ld;
  __device__ __forceinline__ void vec8(int, int row, int col, const float (&v)[8]) const {
    uint4 packed;
    __nv_bfloat162* out = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) out[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
    *reinterpret_cast<uint4*>(c + (size_t)row * ld + col) = packed;
  }
};

// One f32 partial of C per split: part[split][row][col], each [M][N].
struct StorePartial {
  float* part;
  int n;
  size_t split_stride;
  __device__ __forceinline__ void vec8(int split, int row, int col,
                                       const float (&v)[8]) const {
    float4* out = reinterpret_cast<float4*>(part + split * split_stride + (size_t)row * n + col);
    out[0] = make_float4(v[0], v[1], v[2], v[3]);
    out[1] = make_float4(v[4], v[5], v[6], v[7]);
  }
  __device__ __forceinline__ void one(int split, int row, int col, float v) const {
    part[split * split_stride + (size_t)row * n + col] = v;
  }
};

}  // namespace sm90
