// Fused candidate scorer backward for Hopper (sm_90a).
//
// Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/cand_scorer.py::
// _bwd_kernel_stash (the stash-nc body of _bwd_body, launched by _bwd_vjp).
// Given the forward's operands, the stashed CAR output nc [N, C] and the
// score cotangent g [N] (f32), per candidate row r (bt = r / K) it forms, with
// Pallas's roundings to the input dtype d (marked [d]):
//     pre = [d] leaky(i + u);   prod = [d] nc * pred
//     a1 = prod W1 + b1, x1 = [d] leaky(a1); a2, x2; a3, x3 likewise
//     da3 = [d] g w4 leaky'(a3);  da2 = [d] (da3 W3^T) leaky'(a2)
//     da1 = [d] (da2 W2^T) leaky'(a1);  dprod = [d] da1 W1^T
//     dnc = [d] dprod * pred;  dp_rep = [d] dprod * nc
//     dncp_c = [d] dnc * [d](1 - [d] nc^2)      (tanh' from the rounded nc)
//     di = [d] (dncp_c car_W^T) leaky'(i + u)
// and the sums over rows: du, dp = per-(session, step) sums of di and dp_rep
// over its K rows; dcar_w = pre^T dncp_c, dW1 = prod^T da1, dW2 = x1^T da2,
// dW3 = x2^T da3; the bias grads are column sums of dncp_c, da1, da2, da3,
// and dw4 = sum_r x3 g.  All sums are in f32, then rounded once to d.
//
// What bounds it: at the compacted G1 train shape (N = 2688 * 50 rows,
// C 1024, M 128/64/32) the products come to 2 N (2 C^2 + 3 C M1 + 3 M1 M2 +
// 3 M2 M3), about 0.68 TFLOP, against about 0.8 GB of operands and outputs:
// the tensor cores bound it.  Of that, dpre = dncp_c car_W^T and
// dcar_w = pre^T dncp_c are 0.28 TFLOP each, plain GEMMs.
//
// What the design does about it.  The Pallas kernel adds every weight
// gradient into one output block across its sequential grid; blocks on a GPU
// run in parallel and in no order, and dcar_w [C, C] f32 (4 MB) fits no
// block.  So the work is split into launches, none with float atomics, each
// summing in a fixed order (two launches on the same inputs give the same
// bits), in this order:
//   1. the narrow row kernel: a block owns kRows candidate rows and walks C
//      in 64-column chunks twice, each chunk's W1 rows, nc and pred arriving
//      by cp.async into a ring of stages while the previous chunk is used.
//      First a1 = prod W1 (prod = [d] nc * pred formed in the stage), then
//      the small matching tail and its backward on the CUDA cores, then
//      dprod = da1 W1^T per chunk and from it dp_rep and dncp_c.  It writes
//      dp_rep, dncp_c, x1..x3 and da1..da3.
//   2. dp, the segment sum of dp_rep (its scratch is then free);
//   3. dW1 = prod^T da1 on the GEMM core (sm90_gemm.cuh: TMA, mbarrier
//      ring, wgmma), prod = [d] nc * pred first written into dp_rep's slot,
//      both operands MN-major (f32: split and transposed), the rows split
//      into f32 partials summed in split order; the last read of nc;
//   4. dpre on the core, A = dncp_c K-major, B = car_W read as B^T
//      K-major; its epilogue reads
//      i_rows and u and writes di = [d] dpre leaky'(i + u) and
//      pre = [d] leaky(i + u) into dp_rep's slot;
//   5. du, the segment sum of di;
//   6. dcar_w = pre^T dncp_c on the core, as dW1;
//   7. dW2, dW3 (narrow split-N transposed products on WMMA) and the column
//      sums (bias grads, dw4).
// The float32 path has the same launches with its products on the tensor
// cores in split TF32 (sm90_gemm.cuh, three TF32 products a product, f32
// accuracy), but for a1: the row kernel's f32 branch (kRows = 32) forms a1
// on the CUDA cores, register-tiled, each sum a chain of fmaf in k order as
// the f32 twin's product sums, so that leaky'(a1), a step, takes the
// twin's branch (any other order of summation moves a1 by ~1e-7 and flips
// it for an a1 that close to 0, and with it a row of di); dprod runs
// on WMMA m16n16k8, each k8 step summed fresh and added in f32 (the tensor
// cores round toward zero); the C-wide products on the split-TF32 core
// (gemm_tf32).  TF32
// wgmma reads both operands K-major, and dW1 and dcar_w are products over
// rows (both operands MN-major), so small passes write each operand's hi
// and lo halves K-major into scratch first (split_transpose_kernel: prod^T
// from nc and pred, da1^T, pre^T from i_rows and u, dncp_c^T;
// split_rows_kernel: dncp_c and car_W as they stand).  Those passes are
// memory-bound (~0.09 ms each at the quality example B's shapes) where the
// products are bound by the tensor cores.
//
// The recompute variant K1b' (replacing _bwd_kernel, _bwd_body with
// nc_ref=None, run when _STASH_NC is off) is not in this file: the caller
// first runs the stash forward (cand_score_fwd.cu) with its nc output set to
// di, then this backward with nc = di.  di is nc's home until launch 4
// writes it, and nothing reads nc after prod in launch 3, so K1b' is K1b on the
// forward's own nc, bit for bit, in K1b's memory.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "sm90_gemm.cuh"

namespace {

using namespace nvcuda;

// float32 on WMMA: split TF32 fragments (m16n16k8), three products a k step
using TfAcc = wmma::fragment<wmma::accumulator, 16, 16, 8, float>;
using TfA = wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>;
using TfBc = wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::col_major>;

// acc += a b in f32 accuracy: a_hi and b_hi hold the loaded f32 fragments;
// each is split (hi = rna_tf32(x), lo = rna_tf32(x - hi)) and the three
// products run small ones first (sm90_gemm.cuh, "split TF32") into a fresh
// fragment, added to acc on the CUDA cores: the tensor cores round their
// sums toward zero, and a long chain of them drifts (~1e-5 of the sum)
template <class A, class B>
__device__ __forceinline__ void mma3(TfAcc& acc, A& a_hi, A& a_lo, B& b_hi, B& b_lo) {
#pragma unroll
  for (int i = 0; i < a_hi.num_elements; ++i) {
    const float x = a_hi.x[i], h = wmma::__float_to_tf32(x);
    a_hi.x[i] = h;
    a_lo.x[i] = wmma::__float_to_tf32(x - h);
  }
#pragma unroll
  for (int i = 0; i < b_hi.num_elements; ++i) {
    const float x = b_hi.x[i], h = wmma::__float_to_tf32(x);
    b_hi.x[i] = h;
    b_lo.x[i] = wmma::__float_to_tf32(x - h);
  }
  TfAcc step;
  wmma::fill_fragment(step, 0.f);
  wmma::mma_sync(step, a_lo, b_hi, step);
  wmma::mma_sync(step, a_hi, b_lo, step);
  wmma::mma_sync(step, a_hi, b_hi, step);
#pragma unroll
  for (int i = 0; i < acc.num_elements; ++i) acc.x[i] += step.x[i];
}

constexpr int kThreads = 256;  // 8 warps
constexpr int kRowThreads = 512;  // 16 warps: the row kernel, one block an SM
constexpr int kCh = 64;        // C columns (and W1 rows) per row-kernel step
constexpr int kMaxM1 = 128;    // widest first matching layer
constexpr int kTn = 64;        // output tile edge of the transposed products
constexpr int kTnDepth = 64;   // rows per step of the transposed products
constexpr int kSumCols = 32;   // columns per block of the column sums
constexpr int kSmemLimit = 232448;  // 227 KB a block may use on sm_90
constexpr int kTargetBlocks = 264;  // two blocks per SM of an H100

template <typename Scalar>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kRows = 64;
  static constexpr int kPad = 8;  // 16 bytes of row padding against bank conflicts
  static constexpr int kStages = 3;
};
template <>
struct Traits<float> {
  static constexpr int kRows = 32;
  static constexpr int kPad = 4;
  static constexpr int kStages = 2;
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Scalar>
__device__ __forceinline__ Scalar from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename Scalar>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<Scalar>(v));
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v > 0.f ? v : alpha * v;
}

__device__ __forceinline__ float dleaky(float v, float alpha) {
  return v > 0.f ? 1.f : alpha;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

// kVec elements starting at p as f32; elements at or past `valid` read as 0.
template <typename Scalar>
__device__ __forceinline__ void load_f32(const Scalar* p, int valid,
                                         bool vec_ok,
                                         float (&out)[16 / sizeof(Scalar)]) {
  constexpr int kVec = 16 / sizeof(Scalar);
  if (vec_ok && valid >= kVec) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const Scalar* v = reinterpret_cast<const Scalar*>(&raw);
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = to_f32(v[e]);
  } else {
#pragma unroll
    for (int e = 0; e < kVec; ++e) out[e] = e < valid ? to_f32(p[e]) : 0.f;
  }
}

// ---- cp.async ----

__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            bool valid) {
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// A thread's share of copying a tile of `rows` rows of `vecs_per_row`
// 16-byte vectors, the same for every chunk: slot q is tile row row[q]
// (-1: none), from column col[q].  Worked out once, so that a chunk's copy
// costs no division.
template <int kSlots>
struct CopySlots {
  int row[kSlots], col[kSlots];
  __device__ __forceinline__ CopySlots(int rows, int vecs_per_row, int vec) {
#pragma unroll
    for (int q = 0; q < kSlots; ++q) {
      const int v = threadIdx.x + q * kRowThreads;
      row[q] = v < rows * vecs_per_row ? v / vecs_per_row : -1;
      col[q] = (v % vecs_per_row) * vec;
    }
  }
};

// Starts copying a tile into shared memory (leading dimension ld): tile row
// r is global row row_of(r) (or zeros where that is -1) of the row-major
// [*, n_cols] matrix g, from column c0; columns past n_cols read as 0.
// Where a row of g is not 16-byte aligned (n_cols not a multiple of the
// vector), the copy is synchronous.
template <typename Scalar, int kSlots, typename RowOf>
__device__ __forceinline__ void async_tile(const CopySlots<kSlots>& slots, Scalar* s,
                                           int ld, const Scalar* g, int n_cols,
                                           int c0, bool vec_ok, RowOf row_of) {
  constexpr int kVec = 16 / sizeof(Scalar);
#pragma unroll
  for (int q = 0; q < kSlots; ++q) {
    const int r = slots.row[q];
    if (r < 0) continue;
    const int c = slots.col[q];
    const long long gr = row_of(r);
    const int gc = c0 + c;
    Scalar* dst = s + r * ld + c;
    if (vec_ok) {
      const bool in = gr >= 0 && gc < n_cols;
      cp_async_16(dst, in ? g + gr * n_cols + gc : g, in);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        dst[e] = gr >= 0 && gc + e < n_cols ? g[gr * n_cols + gc + e]
                                            : from_f32<Scalar>(0.f);
    }
  }
}

// ---------------------------------------------------------------------------
// 1. the narrow row kernel
// ---------------------------------------------------------------------------

// Shared-memory layout of one row block (byte offsets), shared by the host,
// which sizes the launch, and the kernel: a ring of kStages stages, each a
// W1 tile [kCh][m1_pad] and the block's nc and pred chunks [kRows][kCh]
// (during the tail the last stage holds W2 and W3, rows padded to an odd
// number of words so that a warp reading down a column hits 32 banks); the
// tail's buffers (the dprod chunk's f32 stage aliases them); da1; the pred
// row of each of the block's rows.
template <typename Scalar>
struct RowLayout {
  static constexpr int R = Traits<Scalar>::kRows;
  static constexpr int P = Traits<Scalar>::kPad;
  static constexpr int S = Traits<Scalar>::kStages;
  int m1_pad, ld_w1, ld_ch, ld_a1, ld_x1, ld_da1, ld_stage, ld_w2, ld_w3;
  size_t stage_bytes, off_nc, off_pred, off_w3, off_a1, off_x1, off_a2, off_x2,
      off_da2, off_a3, off_x3, off_da3, off_da1, off_bt, bytes;

  __host__ __device__ RowLayout(int m1, int m2, int m3) {
    constexpr size_t e = sizeof(Scalar);
    m1_pad = round_up(m1, 16);
    ld_w1 = m1_pad + P;
    ld_ch = kCh + P;
    ld_a1 = m1_pad + 4;
    ld_x1 = m1_pad + P;
    ld_da1 = m1_pad + P;
    ld_stage = kCh + 4;
    ld_w2 = m2 + (e == 2 ? 2 : 1);
    ld_w3 = m3 + (e == 2 ? 2 : 1);
    off_nc = align128((size_t)kCh * ld_w1 * e);
    off_pred = off_nc + align128((size_t)R * ld_ch * e);
    stage_bytes = off_pred + align128((size_t)R * ld_ch * e);
    off_w3 = align128((size_t)m1 * ld_w2 * e);
    const size_t tail_w = off_w3 + align128((size_t)m2 * ld_w3 * e);
    stage_bytes = stage_bytes > tail_w ? stage_bytes : tail_w;
    size_t at = S * stage_bytes;
    off_a1 = take(at, (size_t)R * ld_a1 * 4);
    off_x1 = take(at, (size_t)R * ld_x1 * e);
    off_a2 = take(at, (size_t)R * m2 * 4);
    off_x2 = take(at, (size_t)R * m2 * e);
    off_da2 = take(at, (size_t)R * m2 * e);
    off_a3 = take(at, (size_t)R * m3 * 4);
    off_x3 = take(at, (size_t)R * m3 * e);
    off_da3 = take(at, (size_t)R * m3 * e);
    const size_t stage_end = off_a1 + align128((size_t)R * ld_stage * 4);
    at = at > stage_end ? at : stage_end;
    off_da1 = take(at, (size_t)R * ld_da1 * e);
    off_bt = take(at, (size_t)R * sizeof(int));
    bytes = at;
  }

  // the offset `at` before b more bytes (128-byte aligned) are taken
  __host__ __device__ static size_t take(size_t& at, size_t b) {
    const size_t here = at;
    at += align128(b);
    return here;
  }
};

struct RowParams {
  const void *pred, *w1, *b1, *w2, *b2, *w3, *b3, *w4, *nc;
  const float* g;
  void *dp_rep, *dncp_c, *x1, *x2, *x3, *da1, *da2, *da3;
  long long n_rows;
  int k, c, m1, m2, m3;
  float alpha;
};

template <typename Scalar>
__global__ void __launch_bounds__(kRowThreads, 1)
    cand_score_bwd_rows_kernel(const RowParams p) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int S = Traits<Scalar>::kStages;
  constexpr int kVec = 16 / sizeof(Scalar);
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const RowLayout<Scalar> L(p.m1, p.m2, p.m3);
  const int C = p.c, M1 = p.m1, M2 = p.m2, M3 = p.m3, K = p.k;
  const float alpha = p.alpha;
  const long long row0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid / 32;

  const Scalar* pred = static_cast<const Scalar*>(p.pred);
  const Scalar* w1 = static_cast<const Scalar*>(p.w1);
  const Scalar* b1 = static_cast<const Scalar*>(p.b1);
  const Scalar* w2 = static_cast<const Scalar*>(p.w2);
  const Scalar* b2 = static_cast<const Scalar*>(p.b2);
  const Scalar* w3 = static_cast<const Scalar*>(p.w3);
  const Scalar* b3 = static_cast<const Scalar*>(p.b3);
  const Scalar* w4 = static_cast<const Scalar*>(p.w4);
  const Scalar* nc = static_cast<const Scalar*>(p.nc);

  extern __shared__ __align__(128) unsigned char smem[];
  auto w1_tile = [&](int s) {
    return reinterpret_cast<Scalar*>(smem + s * L.stage_bytes);
  };
  auto nc_tile = [&](int s) {
    return reinterpret_cast<Scalar*>(smem + s * L.stage_bytes + L.off_nc);
  };
  auto pred_tile = [&](int s) {
    return reinterpret_cast<Scalar*>(smem + s * L.stage_bytes + L.off_pred);
  };
  float* a1 = reinterpret_cast<float*>(smem + L.off_a1);
  Scalar* x1 = reinterpret_cast<Scalar*>(smem + L.off_x1);
  float* a2 = reinterpret_cast<float*>(smem + L.off_a2);
  Scalar* x2 = reinterpret_cast<Scalar*>(smem + L.off_x2);
  Scalar* da2 = reinterpret_cast<Scalar*>(smem + L.off_da2);
  float* a3 = reinterpret_cast<float*>(smem + L.off_a3);
  Scalar* x3 = reinterpret_cast<Scalar*>(smem + L.off_x3);
  Scalar* da3 = reinterpret_cast<Scalar*>(smem + L.off_da3);
  Scalar* da1 = reinterpret_cast<Scalar*>(smem + L.off_da1);
  float* stage = a1;  // the dprod chunk, once the tail is done

  const bool c_vec = C % kVec == 0;
  const bool m1_vec = M1 % kVec == 0;
  const int m1_tiles = L.m1_pad / 16;
  const int n_ch = (C + kCh - 1) / kCh;
  // the block's rows belong to (session, step) rows bt0 .. bt0 + n_bt - 1 of
  // pred; row r reads pred row bt_of[r] of a stage
  const long long row_end = row0 + R < p.n_rows ? row0 + R : p.n_rows;
  const long long bt0 = row0 / K;
  const int n_bt = (int)((row_end - 1) / K - bt0 + 1);
  int* bt_of = reinterpret_cast<int*>(smem + L.off_bt);
  for (int r = tid; r < R; r += kRowThreads)
    bt_of[r] = row0 + r < p.n_rows ? (int)((row0 + r) / K - bt0) : 0;
  __syncthreads();

  // chunk i (C columns i * kCh ...) into stage i % S; one commit group each
  constexpr int kW1Slots = (kCh * (kMaxM1 / kVec) + kRowThreads - 1) / kRowThreads;
  constexpr int kChSlots = (R * (kCh / kVec) + kRowThreads - 1) / kRowThreads;
  const CopySlots<kW1Slots> w1_slots(kCh, L.m1_pad / kVec, kVec);
  const CopySlots<kChSlots> nc_slots(R, kCh / kVec, kVec);
  const CopySlots<kChSlots> pred_slots(n_bt, kCh / kVec, kVec);
  auto load_chunk = [&](int i) {
    if (i < n_ch) {
      const int s = i % S, c0 = i * kCh;
      async_tile<Scalar>(w1_slots, w1_tile(s), L.ld_w1, w1, M1, 0, m1_vec,
                         [&](int r) -> long long {
                           return c0 + r < C ? c0 + r : -1;
                         });
      async_tile<Scalar>(nc_slots, nc_tile(s), L.ld_ch, nc, C, c0, c_vec,
                         [&](int r) -> long long {
                           return row0 + r < p.n_rows ? row0 + r : -1;
                         });
      async_tile<Scalar>(pred_slots, pred_tile(s), L.ld_ch, pred, C, c0, c_vec,
                         [&](int r) -> long long { return bt0 + r; });
    }
    cp_async_commit();
  };

  // ---- a1 = prod @ W1 (bias below), prod = [d] nc * pred per chunk ----
  {
    // bf16: warp w owns tiles (w % 4, 2 * (w / 4) + {0, 1}) of 16 x 16.
    // f32: on the CUDA cores, thread t the rows 4 (t / 64) + {0..3} and the
    // columns 2 (t % 64) + {0, 1} (a warp's loads: one 16-byte broadcast a
    // row for 4 k, one 256-byte row of W1 a k), each sum a chain of fmaf in
    // k order, the order of the f32 twin's product, so that a1 carries its
    // bits and leaky'(a1) takes its branch (a split-TF32 a1, ~1e-7 off,
    // flips it where a1 lies that close to 0, and with it a row of di)
    Frag acc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[j], 0.f);
    float acc_c[4][2] = {};
    const int rp = 4 * (tid / 64), cq = 2 * (tid % 64);
    for (int i = 0; i < S - 1; ++i) load_chunk(i);
    for (int i = 0; i < n_ch; ++i) {
      cp_async_wait<S - 2>();  // chunk i has landed (this thread's copies)
      __syncthreads();         // everyone's; the stage refilled next is free
      load_chunk(i + S - 1);
      const int s = i % S;
      Scalar* prod = nc_tile(s);
      const Scalar* pv = pred_tile(s);
      for (int v = tid; v < R * kCh / kVec; v += kRowThreads) {
        const int r = v / (kCh / kVec), c = (v % (kCh / kVec)) * kVec;
        const int off = r * L.ld_ch + c;
        uint4 n4 = *reinterpret_cast<const uint4*>(prod + off);
        const uint4 p4 = *reinterpret_cast<const uint4*>(pv + bt_of[r] * L.ld_ch + c);
        Scalar* ns = reinterpret_cast<Scalar*>(&n4);
        const Scalar* ps = reinterpret_cast<const Scalar*>(&p4);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          ns[e] = from_f32<Scalar>(to_f32(ns[e]) * to_f32(ps[e]));
        *reinterpret_cast<uint4*>(prod + off) = n4;
      }
      __syncthreads();
      const Scalar* wt = w1_tile(s);
      if constexpr (kTensor) {
        const int rt = warp % 4, ct = 2 * (warp / 4);
#pragma unroll
        for (int kk = 0; kk < kCh; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::load_matrix_sync(a, prod + 16 * rt * L.ld_ch + kk, L.ld_ch);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            if (ct + j < m1_tiles) {
              wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                             wmma::row_major>
                  b;
              wmma::load_matrix_sync(b, wt + kk * L.ld_w1 + 16 * (ct + j),
                                     L.ld_w1);
              wmma::mma_sync(acc[j], a, b, acc[j]);
            }
          }
        }
      } else if (cq < L.m1_pad) {
        const Scalar* a_rows = prod + rp * L.ld_ch;
#pragma unroll 2
        for (int kk = 0; kk < kCh; kk += 4) {
          float4 a4[4];
#pragma unroll
          for (int r = 0; r < 4; ++r)
            a4[r] = *reinterpret_cast<const float4*>(a_rows + r * L.ld_ch + kk);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 b = *reinterpret_cast<const float2*>(wt + (kk + e) * L.ld_w1 + cq);
#pragma unroll
            for (int r = 0; r < 4; ++r) {
              const float a = reinterpret_cast<const float*>(&a4[r])[e];
              acc_c[r][0] = fmaf(a, b.x, acc_c[r][0]);
              acc_c[r][1] = fmaf(a, b.y, acc_c[r][1]);
            }
          }
        }
      }
    }
    if constexpr (kTensor) {
      const int rt = warp % 4, ct = 2 * (warp / 4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (ct + j < m1_tiles)
          wmma::store_matrix_sync(a1 + 16 * rt * L.ld_a1 + 16 * (ct + j),
                                  acc[j], L.ld_a1, wmma::mem_row_major);
    } else if (cq < L.m1_pad) {
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float2*>(a1 + (rp + r) * L.ld_a1 + cq) =
            make_float2(acc_c[r][0], acc_c[r][1]);
    }
  }
  __syncthreads();  // a1 is complete; every stage of the ring is consumed
  // the dprod pass walks the same chunks: its first stages load during the
  // tail, while the last stage holds W2 and W3 (its chunk loads at the first
  // dprod step, after the tail)
  for (int i = 0; i < S - 1; ++i) load_chunk(i);
  Scalar* w2s = w1_tile(S - 1);
  Scalar* w3s = reinterpret_cast<Scalar*>(smem + (S - 1) * L.stage_bytes + L.off_w3);
  for (int v = tid; v < M1 * M2; v += kRowThreads)
    w2s[(v / M2) * L.ld_w2 + v % M2] = w2[v];
  for (int v = tid; v < M2 * M3; v += kRowThreads)
    w3s[(v / M3) * L.ld_w3 + v % M3] = w3[v];

  // ---- the matching tail and its backward, CUDA cores, f32 ----
  for (int v = tid; v < R * M1; v += kRowThreads) {
    const int r = v / M1, m = v % M1;
    const float a = a1[r * L.ld_a1 + m] + to_f32(b1[m]);
    a1[r * L.ld_a1 + m] = a;
    x1[r * L.ld_x1 + m] = from_f32<Scalar>(leaky(a, alpha));
  }
  __syncthreads();
  // the tail's products: a thread owns one column m of kQ rows r0 + q RQ, so
  // each weight it reads serves kQ independent sums (each in k order)
  constexpr int kQ = 4, RQ = R / kQ;
  for (int v = tid; v < RQ * M2; v += kRowThreads) {
    const int r0 = v / M2, m = v % M2;
    float s[kQ] = {};
    for (int j = 0; j < M1; ++j) {
      const float w = to_f32(w2s[j * L.ld_w2 + m]);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        s[q] = fmaf(to_f32(x1[(r0 + q * RQ) * L.ld_x1 + j]), w, s[q]);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int at = (r0 + q * RQ) * M2 + m;
      const float a = s[q] + to_f32(b2[m]);
      a2[at] = a;
      x2[at] = from_f32<Scalar>(leaky(a, alpha));
    }
  }
  __syncthreads();
  for (int v = tid; v < RQ * M3; v += kRowThreads) {
    const int r0 = v / M3, m = v % M3;
    float s[kQ] = {};
    for (int j = 0; j < M2; ++j) {
      const float w = to_f32(w3s[j * L.ld_w3 + m]);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        s[q] = fmaf(to_f32(x2[(r0 + q * RQ) * M2 + j]), w, s[q]);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = r0 + q * RQ, at = r * M3 + m;
      const float a = s[q] + to_f32(b3[m]);
      a3[at] = a;
      x3[at] = from_f32<Scalar>(leaky(a, alpha));
      const long long row = row0 + r;
      const float ds = row < p.n_rows ? p.g[row] : 0.f;
      da3[at] = from_f32<Scalar>(ds * to_f32(w4[m]) * dleaky(a, alpha));
    }
  }
  __syncthreads();
  for (int v = tid; v < RQ * M2; v += kRowThreads) {
    const int r0 = v / M2, m = v % M2;
    float s[kQ] = {};
    for (int j = 0; j < M3; ++j) {
      const float w = to_f32(w3s[m * L.ld_w3 + j]);
#pragma unroll
      for (int q = 0; q < kQ; ++q)
        s[q] = fmaf(to_f32(da3[(r0 + q * RQ) * M3 + j]), w, s[q]);
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int at = (r0 + q * RQ) * M2 + m;
      da2[at] = from_f32<Scalar>(s[q] * dleaky(a2[at], alpha));
    }
  }
  __syncthreads();
  for (int v = tid; v < RQ * L.m1_pad; v += kRowThreads) {
    const int r0 = v / L.m1_pad, m = v % L.m1_pad;
    float s[kQ] = {};
    if (m < M1) {
      for (int j = 0; j < M2; ++j) {
        const float w = to_f32(w2s[m * L.ld_w2 + j]);
#pragma unroll
        for (int q = 0; q < kQ; ++q)
          s[q] = fmaf(to_f32(da2[(r0 + q * RQ) * M2 + j]), w, s[q]);
      }
    }
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int r = r0 + q * RQ;
      const float value = m < M1 ? s[q] * dleaky(a1[r * L.ld_a1 + m], alpha) : 0.f;
      da1[r * L.ld_da1 + m] = from_f32<Scalar>(value);
    }
  }
  __syncthreads();
  {  // the tail's activations and cotangents, for the weight-grad launches
    Scalar* gx1 = static_cast<Scalar*>(p.x1);
    Scalar* gda1 = static_cast<Scalar*>(p.da1);
    Scalar* gx2 = static_cast<Scalar*>(p.x2);
    Scalar* gda2 = static_cast<Scalar*>(p.da2);
    Scalar* gx3 = static_cast<Scalar*>(p.x3);
    Scalar* gda3 = static_cast<Scalar*>(p.da3);
    for (int v = tid; v < R * M1; v += kRowThreads) {
      const int r = v / M1, m = v % M1;
      const long long row = row0 + r;
      if (row < p.n_rows) {
        gx1[row * M1 + m] = x1[r * L.ld_x1 + m];
        gda1[row * M1 + m] = da1[r * L.ld_da1 + m];
      }
    }
    for (int v = tid; v < R * M2; v += kRowThreads) {
      const long long row = row0 + v / M2;
      if (row < p.n_rows) {
        gx2[row * M2 + v % M2] = x2[v];
        gda2[row * M2 + v % M2] = da2[v];
      }
    }
    for (int v = tid; v < R * M3; v += kRowThreads) {
      const long long row = row0 + v / M3;
      if (row < p.n_rows) {
        gx3[row * M3 + v % M3] = x3[v];
        gda3[row * M3 + v % M3] = da3[v];
      }
    }
  }

  // ---- dprod = [d] da1 @ W1^T per chunk; dp_rep and dncp_c ----
  Scalar* dp_rep = static_cast<Scalar*>(p.dp_rep);
  Scalar* dncp_g = static_cast<Scalar*>(p.dncp_c);
  for (int i = 0; i < n_ch; ++i) {
    cp_async_wait<S - 2>();
    __syncthreads();  // chunk i is in; the last chunk's stage reads are done
    load_chunk(i + S - 1);
    const int s = i % S, c0 = i * kCh;
    // W1 rows c0..c0+63, all M1 columns: as a [M1 x 64] operand it is
    // column-major with leading dimension ld_w1
    const Scalar* wt = w1_tile(s);
    if constexpr (kTensor) {
      // warp w owns the 16 x 16 tile (w % 4, w / 4)
      const int rt = warp % 4, ct = warp / 4;
      Frag acc;
      wmma::fill_fragment(acc, 0.f);
      for (int kk = 0; kk < L.m1_pad; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            b;
        wmma::load_matrix_sync(a, da1 + 16 * rt * L.ld_da1 + kk, L.ld_da1);
        wmma::load_matrix_sync(b, wt + 16 * ct * L.ld_w1 + kk, L.ld_w1);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(stage + 16 * rt * L.ld_stage + 16 * ct, acc,
                              L.ld_stage, wmma::mem_row_major);
    } else if (warp < 8) {
      // f32: warps 0-7 own the 16 x 16 tiles (w % 2, w / 2), split TF32
      const int rt = warp % 2, ct = warp / 2;
      TfAcc acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 2
      for (int kk = 0; kk < L.m1_pad; kk += 8) {
        TfA a_hi, a_lo;
        TfBc b_hi, b_lo;
        wmma::load_matrix_sync(a_hi, da1 + 16 * rt * L.ld_da1 + kk, L.ld_da1);
        wmma::load_matrix_sync(b_hi, wt + 16 * ct * L.ld_w1 + kk, L.ld_w1);
        mma3(acc, a_hi, a_lo, b_hi, b_lo);
      }
      wmma::store_matrix_sync(stage + 16 * rt * L.ld_stage + 16 * ct, acc, L.ld_stage,
                              wmma::mem_row_major);
    }
    __syncthreads();
    const Scalar* nct = nc_tile(s);
    const Scalar* pt = pred_tile(s);
    for (int v = tid; v < R * kCh / kVec; v += kRowThreads) {
      const int r = v / (kCh / kVec), j = (v % (kCh / kVec)) * kVec;
      const long long row = row0 + r;
      const int col = c0 + j;
      if (row >= p.n_rows || col >= C) continue;
      float sv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; e += 4) {
        const float4 f = *reinterpret_cast<const float4*>(stage + r * L.ld_stage + j + e);
        sv[e] = f.x, sv[e + 1] = f.y, sv[e + 2] = f.z, sv[e + 3] = f.w;
      }
      const uint4 n4 = *reinterpret_cast<const uint4*>(nct + r * L.ld_ch + j);
      const uint4 p4 = *reinterpret_cast<const uint4*>(pt + bt_of[r] * L.ld_ch + j);
      const Scalar* ns = reinterpret_cast<const Scalar*>(&n4);
      const Scalar* ps = reinterpret_cast<const Scalar*>(&p4);
      uint4 out_dp, out_dn;
      Scalar* dps = reinterpret_cast<Scalar*>(&out_dp);
      Scalar* dns = reinterpret_cast<Scalar*>(&out_dn);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        const float dprod = round_to<Scalar>(sv[e]);
        const float ncv = to_f32(ns[e]);
        const float pv = to_f32(ps[e]);
        const float dnc = round_to<Scalar>(dprod * pv);
        dps[e] = from_f32<Scalar>(dprod * ncv);
        const float tanh_d = round_to<Scalar>(1.f - round_to<Scalar>(ncv * ncv));
        dns[e] = from_f32<Scalar>(dnc * tanh_d);
      }
      const long long at = row * C + col;
      if (c_vec) {
        *reinterpret_cast<uint4*>(dp_rep + at) = out_dp;
        *reinterpret_cast<uint4*>(dncp_g + at) = out_dn;
      } else {
        for (int e = 0; e < kVec && col + e < C; ++e) {
          dp_rep[at + e] = dps[e];
          dncp_g[at + e] = dns[e];
        }
      }
    }
  }
  cp_async_wait<0>();  // leave no copy in flight (the tail's are empty groups)
}

// ---------------------------------------------------------------------------
// 2. segment sums over the K rows of a (session, step)
// ---------------------------------------------------------------------------

// out[bt, c] = [d] sum_k x[bt * K + k, c], summed in f32 in row order.
template <typename Scalar>
__global__ void segment_sum_kernel(const Scalar* __restrict__ x,
                                   Scalar* __restrict__ out, long long bt_total,
                                   int k, int c) {
  const long long total = bt_total * c;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const long long bt = e / c;
    const int col = (int)(e % c);
    const Scalar* p = x + bt * k * c + col;
    float s = 0.f;
    for (int r = 0; r < k; ++r) s += to_f32(p[(long long)r * c]);
    out[e] = from_f32<Scalar>(s);
  }
}

// prod[r, c] = [d] nc[r, c] * pred[r / k, c], dW1's A operand: a block a
// row at a time, 16-byte vectors where the row allows them.
template <typename Scalar>
__global__ void prod_kernel(const Scalar* __restrict__ nc,
                            const Scalar* __restrict__ pred,
                            Scalar* __restrict__ prod, long long n_rows, int k,
                            int c) {
  constexpr int kVec = 16 / sizeof(Scalar);
  for (long long row = blockIdx.x; row < n_rows; row += gridDim.x) {
    const Scalar* nc_row = nc + row * c;
    const Scalar* pred_row = pred + (row / k) * c;
    Scalar* out = prod + row * c;
    if (c % kVec == 0) {
      for (int j = threadIdx.x * kVec; j < c; j += blockDim.x * kVec) {
        const uint4 n4 = *reinterpret_cast<const uint4*>(nc_row + j);
        const uint4 p4 = *reinterpret_cast<const uint4*>(pred_row + j);
        const Scalar* ns = reinterpret_cast<const Scalar*>(&n4);
        const Scalar* ps = reinterpret_cast<const Scalar*>(&p4);
        uint4 o4;
        Scalar* os = reinterpret_cast<Scalar*>(&o4);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          os[e] = from_f32<Scalar>(to_f32(ns[e]) * to_f32(ps[e]));
        *reinterpret_cast<uint4*>(out + j) = o4;
      }
    } else {
      for (int j = threadIdx.x; j < c; j += blockDim.x)
        out[j] = from_f32<Scalar>(to_f32(nc_row[j]) * to_f32(pred_row[j]));
    }
  }
}

// ---------------------------------------------------------------------------
// 3. the narrow transposed products over all rows (dW2, dW3):
//    part[s] = A[rows of s]^T B[rows of s]
// ---------------------------------------------------------------------------

struct TnParams {
  const void* a;  // A [n, I]
  const void* b;  // B [n, J]
  float* part;    // [S, I_pad, J_pad]
  long long n, rows_per_split;
  int I, J, I_pad, J_pad;
};

// grid (J_pad / kTn, I_pad / kTn, S)
template <typename Scalar>
__global__ void __launch_bounds__(kThreads)
    tn_product_kernel(const TnParams p) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int P = Traits<Scalar>::kPad;
  constexpr int kVec = 16 / sizeof(Scalar);
  constexpr int ld = kTn + P;
  __shared__ __align__(128) Scalar a_tile[kTnDepth * ld];  // [n][i]
  __shared__ __align__(128) Scalar b_tile[kTnDepth * ld];  // [n][j]
  const int i0 = blockIdx.y * kTn, j0 = blockIdx.x * kTn;
  const long long n_begin = (long long)blockIdx.z * p.rows_per_split;
  const long long n_end =
      n_begin + p.rows_per_split < p.n ? n_begin + p.rows_per_split : p.n;
  const int tid = threadIdx.x, warp = tid / 32;
  const Scalar* a = static_cast<const Scalar*>(p.a);
  const Scalar* b = static_cast<const Scalar*>(p.b);
  const bool a_vec = p.I % kVec == 0, b_vec = p.J % kVec == 0;

  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  Frag acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  constexpr int kPer = kTn * kTn / kThreads;
  float acc_c[kTensor ? 1 : kPer];
  if constexpr (!kTensor) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) acc_c[q] = 0.f;
  }

  for (long long n0 = n_begin; n0 < n_end; n0 += kTnDepth) {
    constexpr int kVecsPerRow = kTn / kVec;
    for (int v = tid; v < kTnDepth * kVecsPerRow; v += kThreads) {
      const int r = v / kVecsPerRow, col = (v % kVecsPerRow) * kVec;
      const long long n = n0 + r;
      float av[kVec], bv[kVec];
#pragma unroll
      for (int e = 0; e < kVec; ++e) av[e] = bv[e] = 0.f;
      if (n < n_end) {
        const int gi = i0 + col, gj = j0 + col;
        if (gi < p.I) load_f32(a + n * p.I + gi, p.I - gi, a_vec, av);
        if (gj < p.J) load_f32(b + n * p.J + gj, p.J - gj, b_vec, bv);
      }
      uint4 pa, pb;
      Scalar* sa = reinterpret_cast<Scalar*>(&pa);
      Scalar* sb = reinterpret_cast<Scalar*>(&pb);
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        sa[e] = from_f32<Scalar>(av[e]);
        sb[e] = from_f32<Scalar>(bv[e]);
      }
      *reinterpret_cast<uint4*>(a_tile + r * ld + col) = pa;
      *reinterpret_cast<uint4*>(b_tile + r * ld + col) = pb;
    }
    __syncthreads();
    if constexpr (kTensor) {
      // warp w owns output tiles (w % 4, 2 * (w / 4) + {0, 1}) of 16 x 16
      const int it = warp % 4, jt = 2 * (warp / 4);
#pragma unroll
      for (int kk = 0; kk < kTnDepth; kk += 16) {
        // A^T: element (i, n) lies at a_tile[n * ld + i], column-major
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fa;
        wmma::load_matrix_sync(fa, a_tile + kk * ld + 16 * it, ld);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              fb;
          wmma::load_matrix_sync(fb, b_tile + kk * ld + 16 * (jt + j), ld);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPer; ++q) {
        const int v = tid + q * kThreads;
        const int i = v / kTn, j = v % kTn;
        float s = acc_c[q];
#pragma unroll 8
        for (int r = 0; r < kTnDepth; ++r)
          s = fmaf(to_f32(a_tile[r * ld + i]), to_f32(b_tile[r * ld + j]), s);
        acc_c[q] = s;
      }
    }
    __syncthreads();
  }
  float* out = p.part + (size_t)blockIdx.z * p.I_pad * p.J_pad;
  if constexpr (kTensor) {
    const int it = warp % 4, jt = 2 * (warp / 4);
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(
          out + (size_t)(i0 + 16 * it) * p.J_pad + j0 + 16 * (jt + j), acc[j],
          p.J_pad, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
      const int v = tid + q * kThreads;
      out[(size_t)(i0 + v / kTn) * p.J_pad + j0 + v % kTn] = acc_c[q];
    }
  }
}

// ---------------------------------------------------------------------------
// 4. the float32 path's C-wide products: their operands, split for the
//    TF32 core (sm90_gemm.cuh, gemm_tf32), and dpre's epilogue
// ---------------------------------------------------------------------------

__device__ __forceinline__ void store_split(float* hi, float* lo, size_t at, float v) {
  uint32_t h, l;
  sm90::split_tf32(v, h, l);
  hi[at] = __uint_as_float(h);
  lo[at] = __uint_as_float(l);
}

// hi and lo [rows][ld] of x [rows][cols], K-major as they stand (columns
// cols .. ld - 1 zero)
__global__ void split_rows_kernel(const float* __restrict__ x, float* __restrict__ hi,
                                  float* __restrict__ lo, long long rows, int cols, int ld) {
  const long long total = rows * ld;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    const long long r = e / ld;
    const int p = (int)(e % ld);
    store_split(hi, lo, (size_t)e, p < cols ? x[r * cols + p] : 0.f);
  }
}

// The element sources of the transposed operands: x itself, prod = [d] nc *
// pred, and pre = [d] leaky(i + u), at (row r, column c).
struct PlainSrc {
  const float* x;
  int cols;
  __device__ __forceinline__ float operator()(long long r, int c) const {
    return x[r * cols + c];
  }
};
struct ProdSrc {
  const float *nc, *pred;
  int cols, k;
  __device__ __forceinline__ float operator()(long long r, int c) const {
    return nc[r * cols + c] * pred[(r / k) * cols + c];
  }
};
struct PreSrc {
  const float *i_rows, *u;
  int cols, k;
  float alpha;
  __device__ __forceinline__ float operator()(long long r, int c) const {
    return leaky(i_rows[r * cols + c] + u[(r / k) * cols + c], alpha);
  }
};

// hi and lo [cols][ld] with element (c, r) = src(r, c), zero for rows <= r
// < ld: the K-major halves of an operand whose rows are the reduction (dW1,
// dcar_w).  A 32 x 32 tile a block, through shared memory, so that the
// reads run along c and the writes along r; grid (ld / 32, ceil(cols / 32)).
template <class Src>
__global__ void __launch_bounds__(kThreads)
    split_transpose_kernel(Src src, float* __restrict__ hi, float* __restrict__ lo,
                           long long rows, int cols, long long ld) {
  __shared__ float t[32][33];
  const long long r0 = (long long)blockIdx.x * 32;
  const int c0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int i = ty; i < 32; i += kThreads / 32) {
    const long long r = r0 + i;
    const int c = c0 + tx;
    t[i][tx] = r < rows && c < cols ? src(r, c) : 0.f;
  }
  __syncthreads();
  for (int i = ty; i < 32; i += kThreads / 32) {
    const int c = c0 + i;
    if (c < cols) store_split(hi, lo, (size_t)c * ld + r0 + tx, t[tx][i]);
  }
}

// dpre's epilogue: di = [d] dpre leaky'(i + u) and pre = [d] leaky(i + u)
// at (row, col), u's row being row / k.
template <typename Scalar>
struct DpreEpilogue {
  const Scalar* i_rows;
  const Scalar* u;
  Scalar* di;
  Scalar* pre;
  int c, k;
  float alpha;

  // the f32 core's call: one element (pre null: the f32 path forms pre^T
  // for dcar_w from i_rows and u itself)
  __device__ __forceinline__ void one(int, int row, int col, float v) const {
    const size_t at = (size_t)row * c + col;
    const float a0 = to_f32(i_rows[at]) + to_f32(u[(size_t)(row / k) * c + col]);
    di[at] = from_f32<Scalar>(v * dleaky(a0, alpha));
    if (pre != nullptr) pre[at] = from_f32<Scalar>(leaky(a0, alpha));
  }

  // the f32 core's call where C is a multiple of 4: 4 consecutive columns,
  // 16-byte loads and stores (float32 only)
  __device__ __forceinline__ void vec4(int, int row, int col, const float (&v)[4]) const {
    const size_t at = (size_t)row * c + col;
    const float4 i4 = *reinterpret_cast<const float4*>(i_rows + at);
    const float4 u4 = *reinterpret_cast<const float4*>(u + (size_t)(row / k) * c + col);
    *reinterpret_cast<float4*>(di + at) =
        make_float4(v[0] * dleaky(i4.x + u4.x, alpha), v[1] * dleaky(i4.y + u4.y, alpha),
                    v[2] * dleaky(i4.z + u4.z, alpha), v[3] * dleaky(i4.w + u4.w, alpha));
  }

  // the core's call (bf16): 8 consecutive columns, 16-byte loads and stores
  __device__ __forceinline__ void vec8(int, int row, int col,
                                       const float (&v)[8]) const {
    const size_t at = (size_t)row * c + col;
    const uint4 i4 = *reinterpret_cast<const uint4*>(i_rows + at);
    const uint4 u4 = *reinterpret_cast<const uint4*>(u + (size_t)(row / k) * c + col);
    const Scalar* iv = reinterpret_cast<const Scalar*>(&i4);
    const Scalar* uv = reinterpret_cast<const Scalar*>(&u4);
    uint4 d4, p4;
    Scalar* dv = reinterpret_cast<Scalar*>(&d4);
    Scalar* pv = reinterpret_cast<Scalar*>(&p4);
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const float a0 = to_f32(iv[e]) + to_f32(uv[e]);
      dv[e] = from_f32<Scalar>(v[e] * dleaky(a0, alpha));
      pv[e] = from_f32<Scalar>(leaky(a0, alpha));
    }
    *reinterpret_cast<uint4*>(di + at) = d4;
    *reinterpret_cast<uint4*>(pre + at) = p4;
  }
};

// ---------------------------------------------------------------------------
// 5. column sums: part[s, j] = sum over the rows of s of x[n, j] (* w[n])
// ---------------------------------------------------------------------------

// grid (ceil(J / kSumCols), S); 8 lanes of kSumCols columns each
template <typename Scalar>
__global__ void column_sum_kernel(const Scalar* __restrict__ x,
                                  const float* __restrict__ weight,
                                  float* __restrict__ part, long long n,
                                  long long rows_per_split, int J) {
  __shared__ float red[kThreads / kSumCols][kSumCols];
  const int col = blockIdx.x * kSumCols + threadIdx.x % kSumCols;
  const int lane = threadIdx.x / kSumCols;
  const long long begin = (long long)blockIdx.y * rows_per_split;
  const long long end = begin + rows_per_split < n ? begin + rows_per_split : n;
  float s = 0.f;
  if (col < J) {
    for (long long r = begin + lane; r < end; r += kThreads / kSumCols) {
      const float v = to_f32(x[r * J + col]);
      s += weight != nullptr ? v * weight[r] : v;
    }
  }
  red[lane][threadIdx.x % kSumCols] = s;
  __syncthreads();
  if (lane == 0 && col < J) {
    float total = 0.f;
    for (int l = 0; l < kThreads / kSumCols; ++l) total += red[l][threadIdx.x];
    part[(size_t)blockIdx.y * J + col] = total;
  }
}

// out[i, j] = [d] sum_s part[s, i, j] in split order (i < I, j < J; the
// partials have leading dimension ld and stride s_stride).
template <typename Scalar>
__global__ void reduce_partials_kernel(const float* __restrict__ part, int S,
                                       long long s_stride, int I, int J,
                                       int ld, Scalar* __restrict__ out) {
  const long long total = (long long)I * J;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const size_t at = (size_t)(e / J) * ld + e % J;
    float s = 0.f;
    for (int q = 0; q < S; ++q) s += part[q * s_stride + at];
    out[e] = from_f32<Scalar>(s);
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

long long div_up(long long a, long long b) { return (a + b - 1) / b; }

int grid_for(long long elements) {
  const long long blocks = div_up(elements, kThreads);
  return (int)(blocks < 4096 ? (blocks > 0 ? blocks : 1) : 4096);
}

// One narrow transposed product's shape and its split over the rows.
struct TnPlan {
  int I, J, I_pad, J_pad, S;
  long long rows_per_split;
  TnPlan(int i, int j, long long n) : I(i), J(j) {
    I_pad = round_up(i, kTn);
    J_pad = round_up(j, kTn);
    const long long tiles = (long long)(I_pad / kTn) * (J_pad / kTn);
    long long s = div_up(kTargetBlocks, tiles);
    const long long max_s = div_up(n, 4 * kTnDepth);
    s = s < max_s ? s : max_s;
    s = s > 0 ? s : 1;
    rows_per_split = div_up(div_up(n, s), kTnDepth) * kTnDepth;
    S = (int)div_up(n, rows_per_split);
  }
  size_t floats() const { return (size_t)S * I_pad * J_pad; }
};

struct SumPlan {
  int J, S;
  long long rows_per_split;
  SumPlan(int j, long long n) : J(j) {
    const long long groups = div_up(j, kSumCols);
    long long s = div_up(kTargetBlocks, groups);
    const long long max_s = div_up(n, 1024);
    s = s < max_s ? s : max_s;
    s = s > 0 ? s : 1;
    rows_per_split = div_up(n, s);
    S = (int)div_up(n, rows_per_split);
  }
  size_t floats() const { return (size_t)S * J; }
};

// The splits of an [i, j] weight gradient's reduction over the n rows, by
// the rule of the core that runs it (bf16 or split TF32).
int row_splits(int i, int j, long long n, bool bf16) {
  return bf16 ? sm90::splits_for(i, j, n) : sm90::tf32_splits_for(i, j, n);
}

// The scratch the launches need, carved from one buffer the caller
// allocates: the row kernel's outputs in the operands' dtype (dp_rep's slot
// later holds prod, then pre, in bf16), then the f32 partials of every sum;
// in f32 then the split-TF32 halves (hi, lo) of the C-wide products'
// operands, each K-major: t1 prod^T, later pre^T ([C][ld_n]); t2 dncp_c
// ([n][ld_c]), later dncp_c^T; car_W ([C][ld_c]); da1^T ([M1][ld_n]).
struct Plan {
  long long n, ld_n;
  int c, m1, m2, m3, elem, s_car_w, s_w1, ld_c;
  TnPlan w2, w3;
  SumPlan s_car, s_1, s_2, s_3, s_4;
  size_t off_dp_rep, off_dncp, off_x1, off_da1, off_x2, off_da2, off_x3,
      off_da3, off_part_car, off_part_w1, off_part_w2, off_part_w3,
      off_sum_car, off_sum_1, off_sum_2, off_sum_3, off_sum_4, off_t1[2], off_t2[2],
      off_car[2], off_da1t[2], bytes;

  Plan(long long n_rows, int c_, int m1_, int m2_, int m3_, int elem_)
      : n(n_rows), ld_n(div_up(n_rows, 32) * 32), c(c_), m1(m1_), m2(m2_), m3(m3_),
        elem(elem_), s_car_w(row_splits(c_, c_, n_rows, elem_ == 2)),
        s_w1(row_splits(c_, m1_, n_rows, elem_ == 2)), ld_c(round_up(c_, 4)),
        w2(m1_, m2_, n_rows), w3(m2_, m3_, n_rows), s_car(c_, n_rows),
        s_1(m1_, n_rows), s_2(m2_, n_rows), s_3(m3_, n_rows), s_4(m3_, n_rows) {
    size_t at = 0;
    auto take = [&](size_t b) {
      const size_t here = at;
      at += align128(b);
      return here;
    };
    off_dp_rep = take((size_t)n * c * elem);
    off_dncp = take((size_t)n * c * elem);
    off_x1 = take((size_t)n * m1 * elem);
    off_da1 = take((size_t)n * m1 * elem);
    off_x2 = take((size_t)n * m2 * elem);
    off_da2 = take((size_t)n * m2 * elem);
    off_x3 = take((size_t)n * m3 * elem);
    off_da3 = take((size_t)n * m3 * elem);
    off_part_car = take((size_t)s_car_w * c * c * 4);
    off_part_w1 = take((size_t)s_w1 * c * m1 * 4);
    off_part_w2 = take(w2.floats() * 4);
    off_part_w3 = take(w3.floats() * 4);
    off_sum_car = take(s_car.floats() * 4);
    off_sum_1 = take(s_1.floats() * 4);
    off_sum_2 = take(s_2.floats() * 4);
    off_sum_3 = take(s_3.floats() * 4);
    off_sum_4 = take(s_4.floats() * 4);
    const bool f32 = elem == 4;
    const size_t t1 = (size_t)c * ld_n * 4;
    const size_t t2 = t1 > (size_t)n * ld_c * 4 ? t1 : (size_t)n * ld_c * 4;
    for (int h = 0; h < 2; ++h) {
      off_t1[h] = take(f32 ? t1 : 0);
      off_t2[h] = take(f32 ? t2 : 0);
      off_car[h] = take(f32 ? (size_t)c * ld_c * 4 : 0);
      off_da1t[h] = take(f32 ? (size_t)m1 * ld_n * 4 : 0);
    }
    bytes = at;
  }
};

template <typename Scalar>
cudaError_t tn_product(const Plan& plan, const TnPlan& tp, const void* a,
                       const void* b, float* part, Scalar* out,
                       cudaStream_t stream) {
  TnParams p{a, b, part, plan.n, tp.rows_per_split, tp.I, tp.J, tp.I_pad,
             tp.J_pad};
  const dim3 grid(tp.J_pad / kTn, tp.I_pad / kTn, tp.S);
  tn_product_kernel<Scalar><<<grid, kThreads, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<Scalar><<<grid_for((long long)tp.I * tp.J), kThreads,
                                   0, stream>>>(
      part, tp.S, (long long)tp.I_pad * tp.J_pad, tp.I, tp.J, tp.J_pad, out);
  return cudaGetLastError();
}

template <typename Scalar>
cudaError_t column_sum(const Plan& plan, const SumPlan& sp, const void* x,
                       const float* weight, float* part, Scalar* out,
                       cudaStream_t stream) {
  const dim3 grid((unsigned)div_up(sp.J, kSumCols), sp.S);
  column_sum_kernel<Scalar><<<grid, kThreads, 0, stream>>>(
      static_cast<const Scalar*>(x), weight, part, plan.n, sp.rows_per_split,
      sp.J);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<Scalar><<<grid_for(sp.J), kThreads, 0, stream>>>(
      part, sp.S, sp.J, 1, sp.J, sp.J, out);
  return cudaGetLastError();
}

// The split-TF32 halves of the operand src(r, c) (rows x cols) transposed:
// hi and lo [cols][ld] at off[0], off[1] of the scratch.
template <class Src>
cudaError_t split_transpose(Src src, unsigned char* scratch, const size_t (&off)[2],
                            long long rows, int cols, long long ld, cudaStream_t stream) {
  const dim3 grid((unsigned)(ld / 32), (unsigned)div_up(cols, 32));
  split_transpose_kernel<Src><<<grid, kThreads, 0, stream>>>(
      src, reinterpret_cast<float*>(scratch + off[0]),
      reinterpret_cast<float*>(scratch + off[1]), rows, cols, ld);
  return cudaGetLastError();
}

// The split-TF32 halves of x [rows][cols] as it stands: [rows][ld].
cudaError_t split_rows(const void* x, unsigned char* scratch, const size_t (&off)[2],
                       long long rows, int cols, int ld, cudaStream_t stream) {
  split_rows_kernel<<<grid_for(rows * ld), kThreads, 0, stream>>>(
      static_cast<const float*>(x), reinterpret_cast<float*>(scratch + off[0]),
      reinterpret_cast<float*>(scratch + off[1]), rows, cols, ld);
  return cudaGetLastError();
}

// C = A B on the split-TF32 core, A and B^T the halves at a[0..1], b[0..1].
template <class Epi>
cudaError_t tf32_gemm(unsigned char* scratch, const size_t (&a)[2], long long lda,
                      const size_t (&b)[2], long long ldb, int M, int N, int K, int splits,
                      Epi epi, cudaStream_t stream) {
  auto at = [&](size_t off) { return reinterpret_cast<const float*>(scratch + off); };
  return sm90::gemm_tf32(at(a[0]), at(a[1]), (int)lda, at(b[0]), at(b[1]), (int)ldb, M, N,
                         K, splits, epi, stream);
}

struct Inputs {
  const void *i_rows, *u, *car_w;
};

struct Outputs {
  void *di, *du, *dp, *dcar_w, *dcar_b, *dw1, *db1, *dw2, *db2, *dw3, *db3,
      *dw4;
};

template <typename Scalar>
cudaError_t launch_typed(const Inputs& in, const RowParams& rp_in,
                         const Outputs& o, unsigned char* scratch,
                         cudaStream_t stream) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  const RowLayout<Scalar> layout(rp_in.m1, rp_in.m2, rp_in.m3);
  if (layout.bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const Plan plan(rp_in.n_rows, rp_in.c, rp_in.m1, rp_in.m2, rp_in.m3,
                  sizeof(Scalar));
  RowParams rp = rp_in;
  rp.dp_rep = scratch + plan.off_dp_rep;
  rp.dncp_c = scratch + plan.off_dncp;
  rp.x1 = scratch + plan.off_x1;
  rp.da1 = scratch + plan.off_da1;
  rp.x2 = scratch + plan.off_x2;
  rp.da2 = scratch + plan.off_da2;
  rp.x3 = scratch + plan.off_x3;
  rp.da3 = scratch + plan.off_da3;
  const int C = rp.c;
  const long long n = rp.n_rows;
  auto part = [&](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  cudaError_t err;

  // 1. the narrow row kernel
  if ((err = cudaFuncSetAttribute(cand_score_bwd_rows_kernel<Scalar>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)layout.bytes)) != cudaSuccess)
    return err;
  constexpr int R = Traits<Scalar>::kRows;
  cand_score_bwd_rows_kernel<Scalar>
      <<<(unsigned)div_up(n, R), kRowThreads, layout.bytes, stream>>>(rp);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 2. dp; dp_rep's slot is free afterwards
  const long long bt = n / rp.k;
  segment_sum_kernel<Scalar><<<grid_for(bt * C), kThreads, 0, stream>>>(
      static_cast<const Scalar*>(rp.dp_rep), static_cast<Scalar*>(o.dp), bt,
      rp.k, C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 3. dW1 = prod^T da1 (the last read of nc, which may live in di), the
  // product split over rows: bf16 with prod into dp_rep's slot, f32 with
  // prod^T and da1^T split for the TF32 core
  float* w1_part = part(plan.off_part_w1);
  const int M1 = rp.m1;
  const sm90::StorePartial w1_epi{w1_part, M1, (size_t)C * M1};
  if constexpr (kTensor) {
    const long long prod_blocks = n < 132 * 16 ? n : 132 * 16;
    prod_kernel<Scalar><<<(unsigned)prod_blocks, 128, 0, stream>>>(
        static_cast<const Scalar*>(rp.nc), static_cast<const Scalar*>(rp.pred),
        static_cast<Scalar*>(rp.dp_rep), n, rp.k, C);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    err = sm90::gemm<1, 1>(rp.dp_rep, rp.da1, C, M1, (int)n, plan.s_w1, w1_epi, stream);
  } else {
    const ProdSrc prod{static_cast<const float*>(rp.nc), static_cast<const float*>(rp.pred),
                       C, rp.k};
    const PlainSrc da1{static_cast<const float*>(rp.da1), M1};
    if ((err = split_transpose(prod, scratch, plan.off_t1, n, C, plan.ld_n, stream)) !=
            cudaSuccess ||
        (err = split_transpose(da1, scratch, plan.off_da1t, n, M1, plan.ld_n, stream)) !=
            cudaSuccess)
      return err;
    err = tf32_gemm(scratch, plan.off_t1, plan.ld_n, plan.off_da1t, plan.ld_n, C, M1, (int)n,
                    plan.s_w1, w1_epi, stream);
  }
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<Scalar><<<grid_for((long long)C * M1), kThreads, 0,
                                   stream>>>(w1_part, plan.s_w1, (long long)C * M1,
                                             C, M1, M1, static_cast<Scalar*>(o.dw1));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 4. dpre = dncp_c car_W^T, writing di (and in bf16 pre, into dp_rep's slot)
  Scalar* pre = static_cast<Scalar*>(rp.dp_rep);
  const DpreEpilogue<Scalar> dpre_epi{static_cast<const Scalar*>(in.i_rows),
                                      static_cast<const Scalar*>(in.u),
                                      static_cast<Scalar*>(o.di), kTensor ? pre : nullptr,
                                      C, rp.k, rp.alpha};
  if constexpr (kTensor) {
    err = sm90::gemm<0, 0>(rp.dncp_c, in.car_w, (int)n, C, C, 1, dpre_epi, stream);
  } else {
    if ((err = split_rows(rp.dncp_c, scratch, plan.off_t2, n, C, plan.ld_c, stream)) !=
            cudaSuccess ||
        (err = split_rows(in.car_w, scratch, plan.off_car, C, C, plan.ld_c, stream)) !=
            cudaSuccess)
      return err;
    err = tf32_gemm(scratch, plan.off_t2, plan.ld_c, plan.off_car, plan.ld_c, (int)n, C, C, 1,
                    dpre_epi, stream);
  }
  if (err != cudaSuccess) return err;

  // 5. du
  segment_sum_kernel<Scalar><<<grid_for(bt * C), kThreads, 0, stream>>>(
      static_cast<const Scalar*>(o.di), static_cast<Scalar*>(o.du), bt, rp.k,
      C);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 6. dcar_w = pre^T dncp_c: S partials, summed in split order (f32: pre^T
  // formed from i_rows and u, and dncp_c^T, each split for the TF32 core)
  float* car_part = part(plan.off_part_car);
  const sm90::StorePartial car_epi{car_part, C, (size_t)C * C};
  if constexpr (kTensor) {
    err = sm90::gemm<1, 1>(pre, rp.dncp_c, C, C, (int)n, plan.s_car_w, car_epi, stream);
  } else {
    const PreSrc pre_src{static_cast<const float*>(in.i_rows),
                         static_cast<const float*>(in.u), C, rp.k, rp.alpha};
    const PlainSrc dncp{static_cast<const float*>(rp.dncp_c), C};
    if ((err = split_transpose(pre_src, scratch, plan.off_t1, n, C, plan.ld_n, stream)) !=
            cudaSuccess ||
        (err = split_transpose(dncp, scratch, plan.off_t2, n, C, plan.ld_n, stream)) !=
            cudaSuccess)
      return err;
    err = tf32_gemm(scratch, plan.off_t1, plan.ld_n, plan.off_t2, plan.ld_n, C, C, (int)n,
                    plan.s_car_w, car_epi, stream);
  }
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<Scalar><<<grid_for((long long)C * C), kThreads, 0,
                                   stream>>>(car_part, plan.s_car_w,
                                             (long long)C * C, C, C, C,
                                             static_cast<Scalar*>(o.dcar_w));
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  // 7. dW2, dW3 and the column sums
  if ((err = tn_product<Scalar>(plan, plan.w2, rp.x1, rp.da2,
                                part(plan.off_part_w2),
                                static_cast<Scalar*>(o.dw2), stream)) != cudaSuccess)
    return err;
  if ((err = tn_product<Scalar>(plan, plan.w3, rp.x2, rp.da3,
                                part(plan.off_part_w3),
                                static_cast<Scalar*>(o.dw3), stream)) != cudaSuccess)
    return err;
  if ((err = column_sum<Scalar>(plan, plan.s_car, rp.dncp_c, nullptr,
                                part(plan.off_sum_car),
                                static_cast<Scalar*>(o.dcar_b), stream)) !=
      cudaSuccess)
    return err;
  if ((err = column_sum<Scalar>(plan, plan.s_1, rp.da1, nullptr,
                                part(plan.off_sum_1),
                                static_cast<Scalar*>(o.db1), stream)) !=
      cudaSuccess)
    return err;
  if ((err = column_sum<Scalar>(plan, plan.s_2, rp.da2, nullptr,
                                part(plan.off_sum_2),
                                static_cast<Scalar*>(o.db2), stream)) !=
      cudaSuccess)
    return err;
  if ((err = column_sum<Scalar>(plan, plan.s_3, rp.da3, nullptr,
                                part(plan.off_sum_3),
                                static_cast<Scalar*>(o.db3), stream)) !=
      cudaSuccess)
    return err;
  return column_sum<Scalar>(plan, plan.s_4, rp.x3, rp.g, part(plan.off_sum_4),
                            static_cast<Scalar*>(o.dw4), stream);
}

// bf16 needs C and M1 to be multiples of 8: the core's TMA maps need
// 16-byte row strides (the caller pads them).
bool shapes_ok(long long n_rows, int k, int c, int m1, int m2, int m3,
               int dtype) {
  return n_rows > 0 && k > 0 && n_rows % k == 0 && c > 0 && m1 > 0 &&
         m1 <= kMaxM1 && m2 > 0 && m3 > 0 && n_rows <= 0x7fffffffLL &&
         (dtype == 0 || (dtype == 1 && c % 8 == 0 && m1 % 8 == 0));
}

}  // namespace

// Bytes of scratch `cand_score_bwd` needs for these shapes (dtype codes as
// below), or -1 for shapes it does not take.
extern "C" long long cand_score_bwd_scratch_bytes(long long n_rows, int k,
                                                  int c, int m1, int m2,
                                                  int m3, int dtype) {
  if (!shapes_ok(n_rows, k, c, m1, m2, m3, dtype)) return -1;
  return (long long)Plan(n_rows, c, m1, m2, m3, dtype == 0 ? 4 : 2).bytes;
}

// Dynamic shared memory of the row kernel at these widths (its RowLayout;
// the launch refuses more than kSmemLimit), or -1 for widths or a dtype
// code it does not take.
extern "C" long long cand_score_bwd_rows_smem_bytes(int m1, int m2, int m3, int dtype) {
  if (m1 <= 0 || m1 > kMaxM1 || m2 <= 0 || m3 <= 0) return -1;
  if (dtype == 0) return (long long)RowLayout<float>(m1, m2, m3).bytes;
  if (dtype == 1) return (long long)RowLayout<__nv_bfloat16>(m1, m2, m3).bytes;
  return -1;
}

// dtype codes: 0 = float32, 1 = bfloat16 (every operand and every gradient
// has it; g is float32; in bfloat16 c and m1 are multiples of 8).  Operands as for
// cand_score_fwd, plus nc [n_rows, c] (the forward's CAR output; it may be
// the di buffer itself, which K1b' fills with the stash forward first) and
// g [n_rows].  Outputs: di [n_rows, c], du and dp [n_rows / k, c], dcar_w
// [c, c], dcar_b [c], dw1 [c, m1], db1 [m1], dw2 [m1, m2], db2 [m2], dw3
// [m2, m3], db3 [m3], dw4 [m3].  `scratch` holds
// cand_score_bwd_scratch_bytes(...) bytes, 128-byte aligned.  Every pointer
// is 16-byte aligned and every array contiguous.  Returns the cudaError_t of
// the launches (0 on success); the kernels run on `stream` and are not
// waited for.
extern "C" int cand_score_bwd(
    const void* i_rows, const void* u, const void* pred, const void* car_w,
    const void* car_b, const void* w1, const void* b1, const void* w2,
    const void* b2, const void* w3, const void* b3, const void* w4,
    const void* nc, const void* g, void* di, void* du, void* dp, void* dcar_w,
    void* dcar_b, void* dw1, void* db1, void* dw2, void* db2, void* dw3,
    void* db3, void* dw4, void* scratch, long long n_rows, int k, int c,
    int m1, int m2, int m3, int dtype, float alpha, void* stream) {
  (void)car_b;  // its gradient needs only dncp_c
  if (!shapes_ok(n_rows, k, c, m1, m2, m3, dtype) || nc == nullptr)
    return cudaErrorInvalidValue;
  const Inputs in{i_rows, u, car_w};
  const RowParams rp{pred,    w1,      b1,      w2,      b2,      w3,
                     b3,      w4,      nc,      static_cast<const float*>(g),
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, nullptr, n_rows,  k,       c,       m1,
                     m2,      m3,      alpha};
  const Outputs o{di, du, dp, dcar_w, dcar_b, dw1, db1, dw2, db2, dw3, db3,
                  dw4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* buffer = static_cast<unsigned char*>(scratch);
  if (dtype == 0) return launch_typed<float>(in, rp, o, buffer, s);
  return launch_typed<__nv_bfloat16>(in, rp, o, buffer, s);
}

// The GEMM core alone, for its tests: c [m, n] bf16 = A op B with A [m, k]
// (trans_a 0) or [k, m] (trans_a 1) and B [n, k] (trans_b 0) or [k, n]
// (trans_b 1), all bf16, row-major, rows 16-byte aligned (n, and k or m, a
// multiple of 8).  Returns the launch's cudaError_t.
extern "C" int sm90_gemm_bf16(const void* a, const void* b, void* c, int m,
                              int n, int k, int trans_a, int trans_b,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::StoreBf16 epi{static_cast<__nv_bfloat16*>(c), n};
  if (!trans_a && !trans_b) return sm90::gemm<0, 0>(a, b, m, n, k, 1, epi, s);
  if (!trans_a && trans_b) return sm90::gemm<0, 1>(a, b, m, n, k, 1, epi, s);
  if (trans_a && !trans_b) return sm90::gemm<1, 0>(a, b, m, n, k, 1, epi, s);
  return sm90::gemm<1, 1>(a, b, m, n, k, 1, epi, s);
}
