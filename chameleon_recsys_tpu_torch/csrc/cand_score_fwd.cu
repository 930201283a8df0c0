// Fused candidate scorer forward for Hopper (sm_90a).
//
// Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/cand_scorer.py::
// _fwd_kernel (the stash_nc=False forward launched by _fwd_impl).  For each
// candidate row r of i_rows [N, C] (N = BT * K; row r belongs to the
// (session, step) pair bt = r / K):
//     pre  = leaky(f32(i[r]) + f32(u[bt]))          -> rounded to the dtype
//     nc   = tanh(pre @ car_W (f32 acc) + car_b)    -> rounded
//     x    = nc * pred[bt]                          -> rounded
//     x    = leaky(x @ W1 + b1) -> rounded; the same for W2 and W3
//     s[r] = sum_m f32(x[m]) * f32(w4[m])           -> scores [N] f32
// u carries the folded PreCAR constant; the w4 bias stays with the caller.
// All operands are bfloat16, or all float32.  These are the Pallas kernel's
// roundings (cand_scorer.py::_fwd_compute).
//
// Training (the stash variant, replacing _fwd_stash_kernel): with a non-null
// `nc` pointer the kernel also stores the rounded CAR output nc [N, C] in the
// input dtype, which it holds anyway while it forms prod; the backward
// (cand_score_bwd.cu) reads it instead of recomputing the CAR product.
//
// What bounds it: at the G1 eval shape (N = 4864 * 50, C = 1024, M = 128,
// 64, 32) the work is 0.58 TFLOP against 0.5 GB of i_rows, about 1,150
// operations per byte, so the tensor cores bound it, not device memory.
// But each block reads all of car_W and W1 (2.25 MB) for its 64 rows, and
// on an H100 delivering those tiles into shared memory, not the tensor
// cores, sets the pace of the design (PERF.md, the forward's findings).
//
// bf16: wgmma + TMA (cand_score_fwd_tc).  A block owns 64 candidate rows
// (one wgmma M): two consumer warpgroups and one producer thread.  The
// producer loads the block's i_rows by TMA, in 64-column k-blocks, into the
// 128-byte-swizzled K-major layout a wgmma descriptor reads; the consumers
// turn each k-block into pre = [d] leaky(i + u) in place as it lands.
// Warpgroup w takes the 128-column tiles t = w, w + 2, ... of the CAR
// output, and has its own ring of 16 KB stages (3; 2 above C = 1024; 1
// above C = 1280) guarded by full/empty mbarriers, so that no consumer waits on a barrier
// more than one phase ahead of it; the producer fills whichever ring has a
// free stage: per tile the k-blocks of car_W[:, tile] (two 64 x 64 boxes a
// stage), then the tile's 128 rows of W1 (two stages of 64).  Per tile the
// warpgroup runs the CAR product pre @ car_W[:, tile] on wgmma from shared
// memory (m64n128k16, B MN-major), freeing each stage as soon as its group
// has run.  Then per 64-column half, in registers: + car_b, tanh, rounding,
// prod = [d] nc * pred[bt], packed straight into the A fragments of x1 +=
// prod @ W1[half, :] (wgmma m64n128k16 with A from registers), and with a
// non-null nc the stash, staged through the W1 stage the fold has read for
// 16-byte stores.  While one warpgroup runs that elementwise work, the
// other's CAR product keeps the tensor cores busy.  Neither nc (but for the
// stash) nor prod reaches device memory.  At the end warpgroup 1 hands its
// x1 partial to warpgroup 0 through the drained rings (summed in that fixed
// order: no atomics, two launches give the same bits), which runs the other
// two layers on wgmma with A from registers (m64n64 products, or m64n128
// where M2 or M3 passes 64; W2 and W3 arrive by TMA behind the exchange in
// the rings where they have 3 stages, else over the dead pre) and sums
// x3 * w4 across each row's quad.  Rows past N and columns past C load as
// zeros (TMA's out-of-bounds fill) and are not written.  C and every
// matching width must be multiples of 8 (16-byte TMA rows; the wrapper pads
// others), M1, M2 and M3 <= 128, and the block's pre must fit shared memory
// beside the rings (C <= 1536).
//
// float32 (cand_score_fwd_tf32): the same function on the tensor cores in
// split TF32 (sm90_gemm.cuh: every product as lo hi + hi lo + hi hi of
// TF32 halves, f32-like accuracy at a third of the TF32 rate, 165 TFLOP/s;
// the CUDA cores' f32 peak is 67).  What shapes it: 64 rows of f32 pre at
// C 1024 take 256 KB, more than a block's shared memory, so pre is not
// kept: each consumer thread forms its A fragments, pre = leaky(i + u) split
// into hi and lo, in registers straight from i_rows and u (L2-resident
// between passes), one 32-column k block ahead, for every 64-column tile of
// the CAR output it passes over.  TF32 wgmma reads B only K-major from
// shared memory, and car_W and W1 come MN-major, so a first launch writes
// their split halves transposed (split_weight_kernel: 8 MB at C 1024),
// their k order permuted so that a thread's fragments are 8 consecutive
// columns of a row of pre (two 16-byte loads) and a CAR accumulator's
// column pairs are, as they stand, the A fragments of the fold into the
// first matching layer.  A block (one consumer warpgroup and a producer
// warp, two blocks an SM) owns 64 rows and a run of the C / 64 tiles; the
// producer streams each tile's car_W k blocks, then its W1 rows, hi and lo
// boxes by TMA into a 4-stage ring of 16 KB; per k block the warpgroup runs
// 4 k8 steps x 3 m64n64k8 products with A from registers.  The tensor cores
// round each sum toward zero, so each k block sums into a fresh
// accumulator that is added to the tile's in f32 (a C-long chain drifts nc
// by ~1e-5; this keeps it within ~6e-7 of the exactly rounded nc).  Then in
// registers: + car_b, tanh, the stash, prod = nc * pred, split into the A
// fragments of x1 += prod @ W1[tile, :] (per 64-column half of W1 a fresh
// sum, added to x1 in shared memory, each thread's own 64 values).  The
// block writes its x1 as one of the row block's partials (the runs are cut
// so that the blocks fill >= 90% of the card's waves: B's 275 row blocks x
// 16 tiles run as 8 runs of 2), and a last launch (cand_score_fwd_tail)
// sums them in run order (no atomics: two launches give the same bits),
// then runs the other two layers on the CUDA cores, 16 rows a block.  Any C
// (no pre is kept); the tail's rows in shared memory bound M1 + M2 + M3.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90_gemm.cuh"

namespace {

constexpr int kMaxM1 = 128;    // widest first matching layer
constexpr int kSmemLimit = 232448;  // 227 KB a block may use on sm_90

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v > 0.f ? v : alpha * v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

struct Params {
  const void *i_rows, *u, *pred, *car_w, *car_b, *w1, *b1, *w2, *b2, *w3,
      *b3, *w4;
  float* out;
  void* nc;  // [n_rows, c] in the input dtype, or null
  long long n_rows;
  int k, c, m1, m2, m3;
  float alpha;
};

// ---------------------------------------------------------------------------
// 1. bf16: wgmma + TMA
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 64;      // candidate rows of a block: one wgmma M
constexpr int kDepth = 64;     // depth of a k-block of pre, and of a ring stage
constexpr int kTileN = 128;    // CAR output columns of a tile
constexpr int kMaxStages = 3;  // ring stages of each warpgroup, where they fit
constexpr int kMaxM23 = 128;   // the last two layers: m64n64, or m64n128, products
constexpr int kMaxKBlocks = 24;             // C <= 1536: the widest pre that fits
constexpr int kBoxBytes = 64 * 64 * 2;      // one 64 x 64 bf16 TMA box
constexpr int kStageBytes = 2 * kBoxBytes;  // 64 k-rows of 128 columns
constexpr int kTailBytes = 4 * kBoxBytes;   // the x1 exchange, or W2 or W3 (k <= 128, n <= 128)
constexpr int kBarBytes = 8 * (4 * kMaxStages + 1 + kMaxKBlocks);
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + the producer's warp

// Byte offsets from the block's 1024-aligned base: pre (k_blocks boxes of
// 64 rows x 64 columns), the two warpgroups' rings (`stages` stages of 16 KB
// each: 3, or as many as fit; at the end the x1 exchange at their start),
// the barriers (each ring's full and empty, W2/W3 loaded, each k-block of
// i_rows loaded).  W2 and W3 (32 KB each) go behind the exchange where the
// rings have 3 stages (96 KB), else (C > 1024) over pre, which is dead by
// then.  `bytes` is the launch's dynamic shared memory, with 1 KB of
// alignment slack.
struct TcLayout {
  int k_blocks, tiles, stages;
  uint32_t off_ring, off_tail, off_bar, bytes;
  __host__ __device__ explicit TcLayout(int c) {
    k_blocks = (c + kDepth - 1) / kDepth;
    tiles = (c + kTileN - 1) / kTileN;
    for (stages = kMaxStages;; --stages) {
      off_ring = k_blocks * kBoxBytes;
      off_bar = off_ring + 2 * stages * kStageBytes;
      bytes = 1024 + off_bar + kBarBytes;
      if (bytes <= (uint32_t)kSmemLimit || stages == 1) break;
    }
    off_tail = stages == kMaxStages ? off_ring + kTailBytes : 0;
  }
};

struct TcParams {
  const __nv_bfloat16 *u, *pred, *car_b, *b1, *b2, *b3, *w4;
  float* out;
  __nv_bfloat16* nc;
  int n_rows, k, c, m1, m2, m3;
  float alpha;
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}

// two consecutive bf16 at p (4-byte aligned) as packed bits, or 0
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p, bool ok) {
  return ok ? *reinterpret_cast<const uint32_t*>(p) : 0u;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// The descriptors of this file's tiles (sm90_gemm.cuh's layouts): a K-major
// 64 x 64 box (pre), k16 step kk; an MN-major tile of 64-wide boxes 8 KB
// apart (car_W, W1, W2, W3: k row kr of a box at kr * 128 bytes), k16 step kk.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int kk) {
  return sm90::smem_desc(tile + kk * 32, 16, 1024);
}
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int kk) {
  return sm90::smem_desc(tile + kk * 2048, 8192, 1024);
}
// W2 or W3 in the tail: such tiles for k-rows 0-63 and 64-127, a stage apart
__device__ __forceinline__ uint64_t tail_desc(uint32_t tile, int kk) {
  return mnmajor_desc(tile + (kk >> 2) * kStageBytes, kk & 3);
}

// x = [d] leaky(acc + b) of an m64nN accumulator, zero past column m, packed
// in pairs as the A fragments of the next product (pair 2 j + e is row
// r_a + 8 e, columns 8 j + q2, + 1; pairs 4 s .. 4 s + 3 are k16 step s)
template <int N>
__device__ __forceinline__ void leaky_pack(const float* acc, const __nv_bfloat16* b, int m,
                                           float alpha, int q2, uint32_t* x) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    const int col = 8 * j + q2;
    const float2 bias = unpack_bf16(load_pair(b + col, col < m));
#pragma unroll
    for (int e = 0; e < 2; ++e)
      x[2 * j + e] = col < m ? pack_bf16(leaky(acc[4 * j + 2 * e] + bias.x, alpha),
                                         leaky(acc[4 * j + 2 * e + 1] + bias.y, alpha))
                             : 0u;
  }
}

// acc = a @ W, an m64nN product of depth m (<= 128) with A from registers
// and W a tail tile
template <int N>
__device__ __forceinline__ void tail_product(float* acc, const uint32_t* a, int m,
                                             uint32_t w) {
#pragma unroll
  for (int i = 0; i < N / 2; ++i) acc[i] = 0.f;
  sm90::wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    if (16 * s >= m) break;
    if constexpr (N == 128)
      sm90::wgmma_m64n128k16_rs<1>(*reinterpret_cast<float(*)[64]>(acc), a + 4 * s,
                                   tail_desc(w, s));
    else
      sm90::wgmma_m64n64k16_rs<1>(*reinterpret_cast<float(*)[32]>(acc), a + 4 * s,
                                  tail_desc(w, s));
  }
  sm90::wgmma_commit();
  sm90::wgmma_wait<0>();
}

// kStash: the training forward, which also stores nc
template <bool kStash>
__global__ void __launch_bounds__(kThreads, 1)
    cand_score_fwd_tc(const __grid_constant__ CUtensorMap map_i,
                      const __grid_constant__ CUtensorMap map_car,
                      const __grid_constant__ CUtensorMap map_w1,
                      const __grid_constant__ CUtensorMap map_w2,
                      const __grid_constant__ CUtensorMap map_w3, const TcParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const TcLayout L(p.c);
  const int S = L.stages;
  // barriers: full and empty of stage s of warpgroup w's ring (index
  // w * S + s), W2 and W3 loaded, k-block kb of i_rows loaded
  const uint32_t bars = base + L.off_bar;
  auto full = [&](int j) { return bars + 8 * j; };
  auto empty = [&](int j) { return bars + 8 * (2 * kMaxStages + j); };
  const uint32_t tail_full = bars + 8 * (4 * kMaxStages);
  auto pre_full = [&](int kb) { return tail_full + 8 * (1 + kb); };
  auto stage_of = [&](int w, int e) {
    return base + L.off_ring + (w * S + e % S) * kStageBytes;
  };

  const int C = p.c, K = p.k, N = p.n_rows;
  const int row0 = blockIdx.x * kRows;
  const int kb_n = L.k_blocks;
  // a warpgroup's ring entries per tile: its car_W stages, then the tile's
  // 128 rows of W1 in two stages of 64
  const int per_tile = kb_n + 2;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int j = 0; j < 2 * S; ++j) {
      sm90::mbar_init(full(j), 1);
      sm90::mbar_init(empty(j), 1);
    }
    for (int kb = 0; kb < kb_n; ++kb) sm90::mbar_init(pre_full(kb), 1);
    sm90::mbar_init(tail_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // the tail's biases, into L1 ahead of their use
    prefetch_l1(p.b1);
    prefetch_l1(p.b1 + 64);
    prefetch_l1(p.b2);
    prefetch_l1(p.b3);
    prefetch_l1(p.w4);
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer: one thread issues every TMA load, into each
    // warpgroup's own ring (so that no consumer waits on a barrier more than
    // one phase ahead of it), whichever has a free stage ----
    if (tid != kConsumers) return;
    for (int kb = 0; kb < kb_n; ++kb) {
      sm90::mbar_expect_tx(pre_full(kb), kBoxBytes);
      sm90::tma_load_2d(base + kb * kBoxBytes, &map_i, pre_full(kb), kb * kDepth, row0);
    }
    const int w1_boxes = p.m1 > 64 ? 2 : 1;
    auto issue = [&](int w, int e) {
      const int j = e % per_tile, n0 = (w + 2 * (e / per_tile)) * kTileN;
      const uint32_t stage = stage_of(w, e), bar = full(w * S + e % S);
      if (j < kb_n) {  // car_W[k-block j, tile]: two 64-column boxes
        const int boxes = n0 + 64 < C ? 2 : 1;
        sm90::mbar_expect_tx(bar, boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b)
          sm90::tma_load_2d(stage + b * kBoxBytes, &map_car, bar, n0 + 64 * b, j * kDepth);
      } else {  // W1[64 rows of the tile, :]
        const int row = n0 + 64 * (j - kb_n);
        const int boxes = row < C ? w1_boxes : 0;
        sm90::mbar_expect_tx(bar, boxes * kBoxBytes);
        for (int b = 0; b < boxes; ++b)
          sm90::tma_load_2d(stage + b * kBoxBytes, &map_w1, bar, 64 * b, row);
      }
    };
    int next[2] = {0, 0};
    const int total[2] = {(L.tiles + 1) / 2 * per_tile, L.tiles / 2 * per_tile};
    long long idle = 0;
    while (next[0] < total[0] || next[1] < total[1]) {
      bool issued = false;
      for (int w = 0; w < 2; ++w) {
        const int e = next[w];
        if (e < total[w] && sm90::mbar_test(empty(w * S + e % S), ((e / S) & 1) ^ 1)) {
          issue(w, e);
          ++next[w];
          issued = true;
        }
      }
      if (issued) {
        idle = 0;
      } else if (idle == 0) {
        idle = clock64();
      } else if (clock64() - idle > (1ll << 34)) {
        __trap();  // no stage freed for seconds: a broken pipeline
      }
    }
    // W2 and W3 into the tail, once every stage of both rings is free (and
    // so every read of pre done): 64-row k-blocks a stage apart, each one
    // or two 64-column boxes
    for (int w = 0; w < 2; ++w)
      for (int e = total[w]; e < total[w] + S; ++e)
        sm90::mbar_wait(empty(w * S + e % S), ((e / S) & 1) ^ 1);
    const int w2_kb = w1_boxes, w2_cb = p.m2 > 64 ? 2 : 1;
    const int w3_kb = w2_cb, w3_cb = p.m3 > 64 ? 2 : 1;
    sm90::mbar_expect_tx(tail_full, (w2_kb * w2_cb + w3_kb * w3_cb) * kBoxBytes);
    const uint32_t tail = base + L.off_tail;
    for (int kb = 0; kb < w2_kb; ++kb)
      for (int b = 0; b < w2_cb; ++b)
        sm90::tma_load_2d(tail + kb * kStageBytes + b * kBoxBytes, &map_w2, tail_full,
                          64 * b, 64 * kb);
    for (int kb = 0; kb < w3_kb; ++kb)
      for (int b = 0; b < w3_cb; ++b)
        sm90::tma_load_2d(tail + kTailBytes + kb * kStageBytes + b * kBoxBytes, &map_w3,
                          tail_full, 64 * b, 64 * kb);
    return;
  }

  // ---- the consumers ----
  const int wg = tid / 128, t_in = tid % 128;
  const int warp = t_in / 32, lane = tid % 32;
  // accumulator element i of this thread: row r_a + 8 ((i / 2) % 2), column
  // 8 (i / 4) + q2 + i % 2 of its tile
  const int r_a = 16 * warp + lane / 4, q2 = 2 * (lane % 4);
  const int row_a = row0 + r_a, row_b = row_a + 8;
  const bool in_a = row_a < N, in_b = row_b < N;
  const __nv_bfloat16* pred_a = p.pred + (size_t)(in_a ? row_a / K : 0) * C;
  const __nv_bfloat16* pred_b = p.pred + (size_t)(in_b ? row_b / K : 0) * C;

  // pre = [d] leaky(i + u), in place over the TMA-loaded i_rows, k-block by
  // k-block as they land (chunk pc of row r of a box holds columns
  // 8 (pc ^ (r % 8)) .. + 7: the 128-byte swizzle).  First each thread
  // brings one 128-byte line of the block's u rows into L1 (rows 0, 4, .. 60
  // of the block: every u row the block reads where K >= 4), so that the
  // loop's u loads do not wait on L2 one by one.
  {
    const int row = row0 + 4 * (tid / 16);
    if (row < N && (tid % 16) * 64 < C)
      prefetch_l1(p.u + (size_t)(row / K) * C + (tid % 16) * 64);
  }
#pragma unroll 2
  for (int v = tid; v < kb_n * 512; v += kConsumers) {
    const int kb = v >> 9, r = (v >> 3) & 63, pc = v & 7;
    if ((v & 511) < kConsumers) sm90::mbar_wait(pre_full(kb), 0);  // its first chunk
    const int col = kb * kDepth + ((pc ^ (r & 7)) << 3);
    const int row = row0 + r;
    uint4* at = reinterpret_cast<uint4*>(smem + kb * kBoxBytes + r * 128 + pc * 16);
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < N && col < C) {
      const uint4 iv = *at;
      const uint4 uv = *reinterpret_cast<const uint4*>(p.u + (size_t)(row / K) * C + col);
      const uint32_t* ip = reinterpret_cast<const uint32_t*>(&iv);
      const uint32_t* up = reinterpret_cast<const uint32_t*>(&uv);
      uint32_t* out = reinterpret_cast<uint32_t*>(&packed);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 a = unpack_bf16(ip[e]), b = unpack_bf16(up[e]);
        out[e] = pack_bf16(leaky(a.x + b.x, p.alpha), leaky(a.y + b.y, p.alpha));
      }
    }
    *at = packed;
  }
  sm90::fence_proxy_async();
  sm90::named_sync(1, kConsumers);

  float x1[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) x1[i] = 0.f;
  int ri = 0;  // this warpgroup's ring entry

  for (int t = wg; t < L.tiles; t += 2) {
    const int n0 = t * kTileN;
    prefetch_l1(p.car_b + n0);
    prefetch_l1(p.car_b + n0 + 64);
    prefetch_l1(pred_a + n0);
    prefetch_l1(pred_a + n0 + 64);
    prefetch_l1(pred_b + n0);
    prefetch_l1(pred_b + n0 + 64);

    // acc = pre @ car_W[:, tile]
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;
    for (int kb = 0; kb < kb_n; ++kb, ++ri) {
      sm90::mbar_wait(full(wg * S + ri % S), (ri / S) & 1);
      const uint32_t b_tile = stage_of(wg, ri), a_tile = base + kb * kBoxBytes;
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        sm90::wgmma_m64n128k16<0, 1>(acc, kmajor_desc(a_tile, kk), mnmajor_desc(b_tile, kk));
      sm90::wgmma_commit();
      // free the stage at once: one stage more in flight is worth more than
      // overlapping this warpgroup's groups (the other warpgroup's fill the gap)
      sm90::wgmma_wait<0>();
      if (t_in == 0) sm90::mbar_arrive(empty(wg * S + ri % S));
    }

    // per 64-column half h: nc = [d] tanh(acc + car_b), prod = [d] nc * pred
    // packed into the A fragments of x1 += prod @ W1[half, :] (pair 2 j + e
    // is row r_a + 8 e, columns 8 j + q2, + 1 of the half; pairs 4 s .. 4 s +
    // 3 are k16 step s); the half's W1 rows are the tile's next ring entry,
    // which then stages nc for 16-byte stores
#pragma unroll
    for (int h = 0; h < 2; ++h, ++ri) {
      const uint32_t w1_stage = stage_of(wg, ri);
      sm90::mbar_wait(full(wg * S + ri % S), (ri / S) & 1);
      const int h0 = n0 + 64 * h;
      if (h0 < C) {
        uint32_t frag[16], nc2[16];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int col = h0 + 8 * j + q2;
          const bool ok = col < C;  // C is a multiple of 8: both of the pair
          const float2 bias = unpack_bf16(load_pair(p.car_b + col, ok));
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float* a = acc + 32 * h + 4 * j + 2 * e;
            nc2[2 * j + e] = pack_bf16(tanhf(a[0] + bias.x), tanhf(a[1] + bias.y));
            const float2 n = unpack_bf16(nc2[2 * j + e]);
            const float2 pr = unpack_bf16(load_pair((e ? pred_b : pred_a) + col,
                                                    ok && (e ? in_b : in_a)));
            frag[2 * j + e] = ok ? pack_bf16(n.x * pr.x, n.y * pr.y) : 0u;
          }
        }
        sm90::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          sm90::wgmma_m64n128k16_rs<1>(x1, frag + 4 * s, mnmajor_desc(w1_stage, s));
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        if (kStash) {  // the stash, through the stage the fold has read
          unsigned char* stage = smem + (w1_stage - base);
#pragma unroll
          for (int j = 0; j < 8; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int r = r_a + 8 * e;
              *reinterpret_cast<uint32_t*>(stage + r * 128 + ((j ^ (r & 7)) << 4) + 2 * q2) =
                  nc2[2 * j + e];
            }
          sm90::named_sync(2 + wg, 128);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int v = t_in + 128 * i, r = v >> 3, c8 = v & 7;
            const int row = row0 + r, col = h0 + 8 * c8;
            if (row < N && col < C)
              *reinterpret_cast<uint4*>(p.nc + (size_t)row * C + col) =
                  *reinterpret_cast<const uint4*>(stage + r * 128 + ((c8 ^ (r & 7)) << 4));
          }
          sm90::fence_proxy_async();  // before TMA writes the stage again
          sm90::named_sync(2 + wg, 128);
        }
      }
      if (t_in == 0) sm90::mbar_arrive(empty(wg * S + ri % S));
    }
  }

  // ---- the tail: x1 = warpgroup 0's partial + warpgroup 1's (through the
  // drained rings), then the other two layers in warpgroup 0 ----
  float* xchg = reinterpret_cast<float*>(smem + L.off_ring);  // no wgmma reads it now
  sm90::named_sync(1, kConsumers);
  if (wg == 1) {
#pragma unroll
    for (int i = 0; i < 64; ++i) xchg[i * 128 + t_in] = x1[i];
  }
  sm90::named_sync(1, kConsumers);
  if (wg == 1) return;
#pragma unroll
  for (int i = 0; i < 64; ++i) x1[i] += xchg[i * 128 + t_in];

  const float alpha = p.alpha;
  const uint32_t tail = base + L.off_tail;  // W2, then W3
  uint32_t xa[32], xb[32];  // x1, x2 = [d] leaky(x + b), zero past M1, M2
  leaky_pack<128>(x1, p.b1, p.m1, alpha, q2, xa);
  sm90::mbar_wait(tail_full, 0);
  // the last two layers on m64n64 products, or m64n128 past 64 units
  const bool wide = p.m2 > 64 || p.m3 > 64;
  float x2[64], x3[64];
  if (wide) {
    tail_product<128>(x2, xa, p.m1, tail);
    leaky_pack<128>(x2, p.b2, p.m2, alpha, q2, xb);
    tail_product<128>(x3, xb, p.m2, tail + kTailBytes);
  } else {
    tail_product<64>(x2, xa, p.m1, tail);
    leaky_pack<64>(x2, p.b2, p.m2, alpha, q2, xb);
    tail_product<64>(x3, xb, p.m2, tail + kTailBytes);
  }

  // s = sum_m [d] leaky(x3 + b3) * w4: this thread's columns, then its quad's
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    if (j == 8 && !wide) break;
    const int col = 8 * j + q2;
    const bool ok = col < p.m3;
    const float2 b = unpack_bf16(load_pair(p.b3 + col, ok));
    const float2 w = unpack_bf16(load_pair(p.w4 + col, ok));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      sum[e] += round_bf16(leaky(x3[4 * j + 2 * e] + b.x, alpha)) * w.x;
      sum[e] += round_bf16(leaky(x3[4 * j + 2 * e + 1] + b.y, alpha)) * w.y;
    }
  }
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 1);
    sum[e] += __shfl_xor_sync(0xffffffffu, sum[e], 2);
  }
  if (lane % 4 == 0) {
    if (in_a) p.out[row_a] = sum[0];
    if (in_b) p.out[row_b] = sum[1];
  }
}

// C and the matching widths the kernel takes (see the top of the file).
bool takes(int c, int m1, int m2, int m3) {
  return c > 0 && c % 8 == 0 && m1 > 0 && m1 % 8 == 0 && m1 <= kMaxM1 && m2 > 0 &&
         m2 % 8 == 0 && m2 <= kMaxM23 && m3 > 0 && m3 % 8 == 0 && m3 <= kMaxM23 &&
         TcLayout(c).bytes <= (uint32_t)kSmemLimit && TcLayout(c).k_blocks <= kMaxKBlocks;
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (!takes(p.c, p.m1, p.m2, p.m3) || p.n_rows > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  const int n = (int)p.n_rows;
  CUtensorMap map_i, map_car, map_w1, map_w2, map_w3;
  if (!sm90::make_map(&map_i, p.i_rows, p.c, n, 64, 64) ||
      !sm90::make_map(&map_car, p.car_w, p.c, p.c, 64, 64) ||
      !sm90::make_map(&map_w1, p.w1, p.m1, p.c, 64, 64) ||
      !sm90::make_map(&map_w2, p.w2, p.m2, p.m1, 64, 64) ||
      !sm90::make_map(&map_w3, p.w3, p.m3, p.m2, 64, 64))
    return cudaErrorInvalidValue;
  using B = const __nv_bfloat16*;
  const TcParams tp{static_cast<B>(p.u), static_cast<B>(p.pred), static_cast<B>(p.car_b),
                    static_cast<B>(p.b1), static_cast<B>(p.b2), static_cast<B>(p.b3),
                    static_cast<B>(p.w4), p.out, static_cast<__nv_bfloat16*>(p.nc),
                    n, p.k, p.c, p.m1, p.m2, p.m3, p.alpha};
  const TcLayout layout(p.c);
  auto kernel = p.nc != nullptr ? cand_score_fwd_tc<true> : cand_score_fwd_tc<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)layout.bytes);
  if (err != cudaSuccess) return err;
  kernel<<<(unsigned)((p.n_rows + kRows - 1) / kRows), kThreads, layout.bytes, stream>>>(
      map_i, map_car, map_w1, map_w2, map_w3, tp);
  return cudaGetLastError();
}

}  // namespace tc

// ---------------------------------------------------------------------------
// 2. float32: split TF32 on wgmma
// ---------------------------------------------------------------------------

namespace f32 {

constexpr int kRows = 64;                   // candidate rows of a block: one wgmma M
constexpr int kTileN = 64;                  // CAR output columns of a tile
constexpr int kDepth = 32;                  // k of a ring entry: one 128-byte row of f32
constexpr int kStages = 4;                  // ring stages
constexpr int kBoxBytes = 64 * kDepth * 4;  // one 64 x 32 f32 TMA box: 8 KB
constexpr int kStageBytes = 2 * kBoxBytes;  // its hi and lo halves
constexpr int kConsumers = 128;             // one warpgroup
constexpr int kThreads = kConsumers + 32;   // + the producer's warp
constexpr int kX1Bytes = 128 * 64 * 4;      // x1: 64 f32 a consumer thread
constexpr int kMainSmemBytes = 1024 + kStages * kStageBytes + kX1Bytes + 2 * kStages * 8;
constexpr int kSlots = 264;                 // blocks the card holds: two on each of 132 SMs
constexpr int kMaxParts = 16;
constexpr int kTailRows = 16;
constexpr int kTailThreads = 256;

// The matching tail's dynamic shared memory: kTailRows rows of x1, x2, x3.
__host__ __device__ constexpr long long tail_bytes(int m1, int m2, int m3) {
  return 4LL * kTailRows * ((long long)m1 + m2 + m3);
}

// The launches' grid and scratch at these shapes.  The CAR output's T tiles
// of a row block are cut into `parts` runs of `tiles_per_part` tiles, one
// block each, each writing its partial x1 [64 rows][M1] (f32, ld_m) for the
// tail to sum in part order: the fewest parts whose blocks fill at least 90%
// of the waves of kSlots blocks (else the fullest, up to kMaxParts).  Then the
// split-TF32 halves of car_W^T [C][ld_k] and W1^T [M1][ld_w], k permuted
// within each 32 (car_W) or 8 (W1) as the A fragments are (see the kernel).
struct Plan {
  int row_blocks, tiles, tiles_per_part, parts, ld_k, ld_w, ld_m;
  size_t off_car[2], off_w1[2], off_part, bytes;
  Plan(long long n_rows, int c, int m1) {
    row_blocks = (int)((n_rows + kRows - 1) / kRows);
    tiles = (c + kTileN - 1) / kTileN;
    double best = -1.0;
    for (int want = 1; want <= tiles && want <= kMaxParts; ++want) {
      const int per = (tiles + want - 1) / want, parts_ = (tiles + per - 1) / per;
      const long long blocks = (long long)row_blocks * parts_;
      const long long waves = (blocks + kSlots - 1) / kSlots;
      const double fill = (double)row_blocks * tiles / ((double)waves * kSlots * per);
      if (fill > best + 1e-9) {
        best = fill;
        tiles_per_part = per;
        parts = parts_;
      }
      if (best >= 0.9) break;
    }
    ld_k = round_up(c, 32);
    ld_w = round_up(c, 64);
    ld_m = round_up(m1, 4);
    size_t at = 0;
    auto take = [&](size_t b) {
      const size_t here = at;
      at += align128(b);
      return here;
    };
    for (int h = 0; h < 2; ++h) {
      off_car[h] = take((size_t)c * ld_k * 4);
      off_w1[h] = take((size_t)m1 * ld_w * 4);
    }
    off_part = take((size_t)parts * n_rows * ld_m * 4);
    bytes = at;
  }
};

// Which of the 32 rows of a k block the kernel's position i reads: car_W
// (mode 0), permuted so that lane q's A fragments of the four k8 steps are
// columns 8 q .. 8 q + 7 of a row of pre (two 16-byte loads); W1 (mode 1),
// within each 8 as a CAR accumulator's columns pair up into A fragments.
__device__ __forceinline__ int source_row(int i, int mode) {
  if (mode == 0) {
    const int s = i / 8, q = i % 8;
    return q < 4 ? 8 * q + 2 * s : 8 * (q - 4) + 2 * s + 1;
  }
  const int q = i % 8;
  return (i & ~7) + (q < 4 ? 2 * q : 2 * (q - 4) + 1);
}

// hi and lo [cols][ld] with element (n, p) = w[32 (p / 32) + source_row(p %
// 32)][n] of w [rows][cols] (zero past the rows): the weight transposed to
// K-major and split.  A 32 x 32 tile a block, through shared memory; grid
// (ld / 32, ceil(cols / 32)).
__global__ void __launch_bounds__(256)
    split_weight_kernel(const float* __restrict__ w, float* __restrict__ hi,
                        float* __restrict__ lo, int rows, int cols, int ld, int mode) {
  __shared__ float t[32][33];
  const int p0 = blockIdx.x * 32, n0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += 8) {
    const int r = p0 + i, n = n0 + tx;
    t[i][tx] = r < rows && n < cols ? w[(size_t)r * cols + n] : 0.f;
  }
  __syncthreads();
  const int from = source_row(tx, mode);
  for (int i = ty; i < 32; i += 8) {
    const int n = n0 + i;
    if (n >= cols) continue;
    uint32_t h, l;
    sm90::split_tf32(t[from][i], h, l);
    const size_t at = (size_t)n * ld + p0 + tx;
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

struct MainParams {
  const float *i_rows, *u, *pred, *car_b;
  float* nc;    // [n_rows, c], or null
  float* part;  // [parts][n_rows][ld_m]
  int n_rows, k, c, m1, ld_m, tiles, tiles_per_part, parts;
  float alpha;
};

// 8 consecutive f32 from p (columns col .. col + 7 of a row of c), zero past c
__device__ __forceinline__ void load8(const float* p, int col, int c, bool vec, float* out) {
  if (vec && col + 8 <= c) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    out[0] = a.x, out[1] = a.y, out[2] = a.z, out[3] = a.w;
    out[4] = b.x, out[5] = b.y, out[6] = b.z, out[7] = b.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) out[e] = col + e < c ? p[e] : 0.f;
  }
}

// The CAR product and the first matching layer of a block's 64 rows over its
// run of CAR output tiles, on wgmma in split TF32 (see the top of the file).
template <bool kStash>
__global__ void __launch_bounds__(kThreads, 2)
    cand_score_fwd_tf32(const __grid_constant__ CUtensorMap map_car_hi,
                        const __grid_constant__ CUtensorMap map_car_lo,
                        const __grid_constant__ CUtensorMap map_w1_hi,
                        const __grid_constant__ CUtensorMap map_w1_lo, const MainParams p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  // the ring, x1 (thread t's element i at [i][t]: each thread reads back
  // only what it wrote), the barriers
  float* x1 = reinterpret_cast<float*>(smem_raw + (base - raw) + kStages * kStageBytes);
  const uint32_t bars = base + kStages * kStageBytes + kX1Bytes;
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };
  auto stage_of = [&](int e) { return base + (e % kStages) * kStageBytes; };

  const int C = p.c, K = p.k, N = p.n_rows;
  const int part = blockIdx.x % p.parts;
  const int row0 = (blockIdx.x / p.parts) * kRows;
  const int t0 = part * p.tiles_per_part;
  const int t1 = min(p.tiles, t0 + p.tiles_per_part);
  const int kb_n = (C + kDepth - 1) / kDepth;
  const int w1_n = p.m1 > 64 ? 2 : 1;  // 64-column halves of W1
  // a tile's ring entries: its kb_n k blocks of car_W, then per 64-column
  // half of W1 (w1_n of them) the tile's rows of it in two k halves of 32
  const int per_tile = kb_n + 2 * w1_n;
  const int tid = threadIdx.x;

  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(full(s), 1);
      sm90::mbar_init(empty(s), 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // ---- the producer: one thread keeps the ring full ----
    if (tid != kConsumers) return;
    const int total = (t1 - t0) * per_tile;
    for (int e = 0; e < total; ++e) {
      const int s = e % kStages;
      sm90::mbar_wait(empty(s), ((e / kStages) & 1) ^ 1);
      const int t = t0 + e / per_tile, j = e % per_tile;
      const uint32_t stage = stage_of(e);
      sm90::mbar_expect_tx(full(s), kStageBytes);
      if (j < kb_n) {
        sm90::tma_load_2d(stage, &map_car_hi, full(s), j * kDepth, t * kTileN);
        sm90::tma_load_2d(stage + kBoxBytes, &map_car_lo, full(s), j * kDepth, t * kTileN);
      } else {
        const int nh = (j - kb_n) / 2, kh = (j - kb_n) % 2;
        const int k0 = t * kTileN + kh * kDepth;
        sm90::tma_load_2d(stage, &map_w1_hi, full(s), k0, nh * 64);
        sm90::tma_load_2d(stage + kBoxBytes, &map_w1_lo, full(s), k0, nh * 64);
      }
    }
    return;
  }

  // ---- the consumer warpgroup ----
  const int warp = tid / 32, lane = tid % 32, q = lane % 4;
  // accumulator element i of this thread: row r_a + 8 ((i / 2) % 2), column
  // 8 (i / 4) + 2 q + i % 2 of its tile
  const int r_a = 16 * warp + lane / 4;
  const int row[2] = {row0 + r_a, row0 + r_a + 8};
  const bool in[2] = {row[0] < N, row[1] < N};
  const float* i_row[2];
  const float* u_row[2];
  const float* pred_row[2];
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int r = in[e] ? row[e] : 0;
    i_row[e] = p.i_rows + (size_t)r * C;
    u_row[e] = p.u + (size_t)(r / K) * C;
    pred_row[e] = p.pred + (size_t)(r / K) * C;
  }
  const bool vec = C % 4 == 0;
  // raw i and u of this thread's rows at columns 8 q .. 8 q + 7 of a k block,
  // loaded one k block ahead of their use
  float ri[2][8], ru[2][8];
  auto load_raw = [&](int kb) {
    const int col = kb * kDepth + 8 * q;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      load8(i_row[e] + col, col, in[e] ? C : 0, vec, ri[e]);
      load8(u_row[e] + col, col, in[e] ? C : 0, vec, ru[e]);
    }
  };
#pragma unroll 8
  for (int i = 0; i < 64; ++i) x1[i * kConsumers + tid] = 0.f;
  uint32_t fhi[16], flo[16];  // A fragments: k8 step s at 4 s .. 4 s + 3
  auto release = [&](int e) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sm90::keep(fhi[i]);
      sm90::keep(flo[i]);
    }
    if (tid == 0) sm90::mbar_arrive(empty(e % kStages));
  };
  int e = 0;  // ring entry
  if (t0 < t1) load_raw(0);

  for (int t = t0; t < t1; ++t) {
    // acc = pre @ car_W[:, tile], pre = leaky(i + u) formed k block by k
    // block from the raw loads (A fragment slots: rows a, b at column 2 s,
    // then at 2 s + 1, of this thread's eight); each k block's 12 products
    // sum into a fresh blk, added to acc in f32 (the tensor cores round
    // toward zero: a C-long chain would drift nc by ~1e-5)
    float acc[32], blk[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = blk[i] = 0.f;
    for (int kb = 0; kb < kb_n; ++kb, ++e) {
#pragma unroll
      for (int s = 0; s < 4; ++s)
#pragma unroll
        for (int slot = 0; slot < 4; ++slot) {
          const int r = slot % 2, c = 2 * s + slot / 2;
          sm90::split_tf32(leaky(ri[r][c] + ru[r][c], p.alpha), fhi[4 * s + slot],
                           flo[4 * s + slot]);
        }
      if (kb + 1 < kb_n)
        load_raw(kb + 1);
      else if (t + 1 < t1)
        load_raw(0);
      sm90::mbar_wait(full(e % kStages), (e / kStages) & 1);
      const uint32_t stage = stage_of(e);
      sm90::wgmma_fence();
#pragma unroll
      for (int s = 0; s < 4; ++s)
        sm90::mma3_m64n64k8_rs(blk, fhi + 4 * s, flo + 4 * s,
                               sm90::smem_desc(stage + 32 * s, 16, 1024),
                               sm90::smem_desc(stage + kBoxBytes + 32 * s, 16, 1024), s);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      release(e);
#pragma unroll
      for (int i = 0; i < 32; ++i) acc[i] += blk[i];
    }

    // nc = tanh(acc + car_b), the stash, prod = nc * pred (zero past N and C)
    const int n0 = t * kTileN;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = n0 + 8 * j + 2 * q;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const bool ok0 = in[h] && col < C, ok1 = in[h] && col + 1 < C;
        float* a = acc + 4 * j + 2 * h;
        const float nc0 = ok0 ? tanhf(a[0] + p.car_b[col]) : 0.f;
        const float nc1 = ok1 ? tanhf(a[1] + p.car_b[col + 1]) : 0.f;
        if (kStash) {  // predicated stores: no branch near the wgmma registers
          float* out = p.nc + (size_t)row[h] * C + col;
          if (ok0) out[0] = nc0;
          if (ok1) out[1] = nc1;
        }
        a[0] = ok0 ? nc0 * pred_row[h][col] : 0.f;
        a[1] = ok1 ? nc1 * pred_row[h][col + 1] : 0.f;
      }
    }

    // x1 += prod @ W1[tile rows, :], per 64-column half of W1 a fresh sum
    // (blk) over the tile's 64 k in two halves of 32, added to x1 in f32; k8
    // step s of half kh is the accumulator's column group j = 4 kh + s, its
    // pairs (2 q, 2 q + 1) the fragment's slots (q, q + 4), as W1^T's k
    // order is permuted
#pragma unroll
    for (int nh = 0; nh < 2; ++nh) {
      if (nh >= w1_n) break;
#pragma unroll
      for (int kh = 0; kh < 2; ++kh, ++e) {
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const float* a = acc + 4 * (4 * kh + s);
          const float v[4] = {a[0], a[2], a[1], a[3]};
#pragma unroll
          for (int slot = 0; slot < 4; ++slot)
            sm90::split_tf32(v[slot], fhi[4 * s + slot], flo[4 * s + slot]);
        }
        sm90::mbar_wait(full(e % kStages), (e / kStages) & 1);
        const uint32_t stage = stage_of(e);
        sm90::wgmma_fence();
#pragma unroll
        for (int s = 0; s < 4; ++s)
          sm90::mma3_m64n64k8_rs(blk, fhi + 4 * s, flo + 4 * s,
                                 sm90::smem_desc(stage + 32 * s, 16, 1024),
                                 sm90::smem_desc(stage + kBoxBytes + 32 * s, 16, 1024),
                                 kh + s);
        sm90::wgmma_commit();
        sm90::wgmma_wait<0>();
        release(e);
      }
#pragma unroll
      for (int i = 0; i < 32; ++i) x1[(32 * nh + i) * kConsumers + tid] += blk[i];
    }
  }

  // ---- this block's partial x1 (element i of this thread: column half
  // i / 32, element i % 32 of its accumulator) ----
  float* out = p.part + (size_t)part * N * p.ld_m;
#pragma unroll 4
  for (int i = 0; i < 32 * w1_n; ++i) {
    const int h = (i / 2) % 2, col = 64 * (i / 32) + 8 * ((i % 32) / 4) + 2 * q + i % 2;
    if (in[h] && col < p.m1) out[(size_t)row[h] * p.ld_m + col] = x1[i * kConsumers + tid];
  }
}

struct TailParams {
  const float *part, *b1, *w2, *b2, *w3, *b3, *w4;
  float* out;
  int n_rows, m1, m2, m3, ld_m, parts;
  float alpha;
};

// The matching tail of kTailRows rows a block, on the CUDA cores: x1 = the
// partials summed in part order, leaky(x1 + b1), the other two layers, and
// s = sum_m x3 w4.
__global__ void __launch_bounds__(kTailThreads) cand_score_fwd_tail(const TailParams p) {
  extern __shared__ __align__(16) float tail_smem[];
  const int M1 = p.m1, M2 = p.m2, M3 = p.m3, N = p.n_rows;
  const int row0 = blockIdx.x * kTailRows;
  const float alpha = p.alpha;
  float* x1 = tail_smem;
  float* x2 = x1 + kTailRows * M1;
  float* x3 = x2 + kTailRows * M2;
  for (int v = threadIdx.x; v < kTailRows * M1; v += kTailThreads) {
    const int r = v / M1, m = v % M1, row = row0 + r;
    float s = 0.f;
    if (row < N)
      for (int q = 0; q < p.parts; ++q)
        s += p.part[((size_t)q * N + row) * p.ld_m + m];
    x1[v] = leaky(s + p.b1[m], alpha);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < kTailRows * M2; v += kTailThreads) {
    const int r = v / M2, m = v % M2;
    const float* x_row = x1 + r * M1;
    float acc = 0.f;
    for (int j = 0; j < M1; ++j) acc = fmaf(x_row[j], p.w2[j * M2 + m], acc);
    x2[v] = leaky(acc + p.b2[m], alpha);
  }
  __syncthreads();
  for (int v = threadIdx.x; v < kTailRows * M3; v += kTailThreads) {
    const int r = v / M3, m = v % M3;
    const float* x_row = x2 + r * M2;
    float acc = 0.f;
    for (int j = 0; j < M2; ++j) acc = fmaf(x_row[j], p.w3[j * M3 + m], acc);
    x3[v] = leaky(acc + p.b3[m], alpha) * p.w4[m];
  }
  __syncthreads();
  for (int r = threadIdx.x; r < kTailRows; r += kTailThreads) {
    if (row0 + r >= N) continue;
    float s = 0.f;
    for (int m = 0; m < M3; ++m) s += x3[r * M3 + m];
    p.out[row0 + r] = s;
  }
}

bool takes(int c, int m1, int m2, int m3) {
  return c > 0 && m1 > 0 && m1 <= kMaxM1 && m2 > 0 && m3 > 0 &&
         tail_bytes(m1, m2, m3) <= kSmemLimit;
}

// The largest dynamic shared memory of the launches: the main kernel's ring,
// or the tail's rows.
long long smem_bytes(int m1, int m2, int m3) {
  const long long tail = tail_bytes(m1, m2, m3);
  return tail > kMainSmemBytes ? tail : kMainSmemBytes;
}

cudaError_t launch(const Params& p, void* scratch, cudaStream_t stream) {
  if (!takes(p.c, p.m1, p.m2, p.m3) || p.n_rows > 0x7fffffffLL || scratch == nullptr)
    return cudaErrorInvalidValue;
  const int n = (int)p.n_rows, C = p.c, M1 = p.m1;
  const Plan plan(n, C, M1);
  unsigned char* buf = static_cast<unsigned char*>(scratch);
  auto at = [&](size_t off) { return reinterpret_cast<float*>(buf + off); };
  // the weights' split-TF32 halves, K-major and permuted
  split_weight_kernel<<<dim3(plan.ld_k / 32, (C + 31) / 32), 256, 0, stream>>>(
      static_cast<const float*>(p.car_w), at(plan.off_car[0]), at(plan.off_car[1]), C, C,
      plan.ld_k, 0);
  split_weight_kernel<<<dim3(plan.ld_w / 32, (M1 + 31) / 32), 256, 0, stream>>>(
      static_cast<const float*>(p.w1), at(plan.off_w1[0]), at(plan.off_w1[1]), C, M1,
      plan.ld_w, 1);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  CUtensorMap maps[4];
  if (!sm90::make_map_f32(&maps[0], at(plan.off_car[0]), plan.ld_k, C, plan.ld_k, 64) ||
      !sm90::make_map_f32(&maps[1], at(plan.off_car[1]), plan.ld_k, C, plan.ld_k, 64) ||
      !sm90::make_map_f32(&maps[2], at(plan.off_w1[0]), plan.ld_w, M1, plan.ld_w, 64) ||
      !sm90::make_map_f32(&maps[3], at(plan.off_w1[1]), plan.ld_w, M1, plan.ld_w, 64))
    return cudaErrorInvalidValue;
  using F = const float*;
  const MainParams mp{static_cast<F>(p.i_rows), static_cast<F>(p.u), static_cast<F>(p.pred),
                      static_cast<F>(p.car_b), static_cast<float*>(p.nc), at(plan.off_part),
                      n, p.k, C, M1, plan.ld_m, plan.tiles, plan.tiles_per_part, plan.parts,
                      p.alpha};
  auto kernel = p.nc != nullptr ? cand_score_fwd_tf32<true> : cand_score_fwd_tf32<false>;
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  kMainSmemBytes)) != cudaSuccess)
    return err;
  kernel<<<(unsigned)((long long)plan.row_blocks * plan.parts), kThreads, kMainSmemBytes,
           stream>>>(maps[0], maps[1], maps[2], maps[3], mp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const TailParams tp{at(plan.off_part), static_cast<F>(p.b1), static_cast<F>(p.w2),
                      static_cast<F>(p.b2), static_cast<F>(p.w3), static_cast<F>(p.b3),
                      static_cast<F>(p.w4), p.out, n, M1, p.m2, p.m3, plan.ld_m,
                      plan.parts, p.alpha};
  const int tail = (int)tail_bytes(M1, p.m2, p.m3);
  if ((err = cudaFuncSetAttribute(cand_score_fwd_tail,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, tail)) !=
      cudaSuccess)
    return err;
  cand_score_fwd_tail<<<(unsigned)((n + kTailRows - 1) / kTailRows), kTailThreads, tail,
                        stream>>>(tp);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

// Dynamic shared memory of a launch at these widths (dtype codes as below),
// or -1 for widths the kernel does not take.
extern "C" long long cand_score_fwd_smem_bytes(int c, int m1, int m2, int m3, int dtype) {
  if (dtype == 0) return f32::takes(c, m1, m2, m3) ? f32::smem_bytes(m1, m2, m3) : -1;
  if (dtype == 1) return tc::takes(c, m1, m2, m3) ? (long long)tc::TcLayout(c).bytes : -1;
  return -1;
}

// Bytes of scratch `cand_score_fwd` needs at these shapes (dtype codes as
// below; bfloat16 needs none), or -1 for shapes it does not take.
extern "C" long long cand_score_fwd_scratch_bytes(long long n_rows, int c, int m1, int m2,
                                                  int m3, int dtype) {
  if (n_rows <= 0 || n_rows > 0x7fffffffLL) return -1;
  if (dtype == 0)
    return f32::takes(c, m1, m2, m3) ? (long long)f32::Plan(n_rows, c, m1).bytes : -1;
  if (dtype == 1) return tc::takes(c, m1, m2, m3) ? 0 : -1;
  return -1;
}

// dtype codes: 0 = float32, 1 = bfloat16 (every operand has it; the scores
// are float32).  Shapes: i_rows [n_rows, c] with n_rows = BT * k; u and pred
// [BT, c]; car_w [c, c]; car_b [c]; w1 [c, m1] (m1 <= 128); b1 [m1];
// w2 [m1, m2]; b2 [m2]; w3 [m2, m3]; b3 [m3]; w4 [m3]; out [n_rows];
// nc null, or [n_rows, c] in the operands' dtype (the training stash).  In
// bfloat16 c and every m are multiples of 8, c <= 1536 and m2, m3 <= 128.
// `scratch` holds cand_score_fwd_scratch_bytes(...) bytes, 128-byte aligned
// (null where that is 0).  Every pointer is 16-byte aligned and every array
// contiguous.  Returns the cudaError_t of the launches (0 on success); the
// kernels run on `stream` and are not waited for.
extern "C" int cand_score_fwd(const void* i_rows, const void* u,
                              const void* pred, const void* car_w,
                              const void* car_b, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* w3, const void* b3, const void* w4,
                              void* out, void* nc, long long n_rows, int k,
                              int c,
                              int m1, int m2, int m3, int dtype, float alpha,
                              void* scratch, void* stream) {
  if (n_rows <= 0 || k <= 0 || n_rows % k != 0) return cudaErrorInvalidValue;
  const Params p{i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4,
                 static_cast<float*>(out), nc, n_rows, k, c, m1, m2, m3,
                 alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return f32::launch(p, scratch, s);
  if (dtype == 1) return tc::launch(p, s);
  return cudaErrorInvalidValue;
}
