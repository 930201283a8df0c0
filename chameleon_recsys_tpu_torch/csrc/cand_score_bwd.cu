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
// the tensor cores bound it.
//
// What the design does about it.  The Pallas kernel adds every weight
// gradient into one output block across its sequential grid; blocks on a GPU
// run in parallel and in no order, and dcar_w [C, C] f32 (4 MB) fits no
// block.  So the work is split into launches, none with float atomics, each
// summing in a fixed order (the result does not depend on scheduling):
//   1. the row kernel: a block owns kRows candidate rows.  It forms prod in
//      shared memory, a1 on the tensor cores (WMMA, bf16 in, f32 accumulate),
//      the small matching tail and its backward on the CUDA cores, then dprod
//      in 64-column chunks (dprod = da1 W1^T), writing dncp_c into shared
//      memory over prod, and last dpre = dncp_c car_W^T in 128-column chunks
//      and di.  It writes di, dp_rep, dncp_c, x1..x3 and da1..da3.
//   2. segment sums: du and dp, one thread per (session, step, column).
//   3. the transposed products A^T B over all N rows (dcar_w, dW1, dW2,
//      dW3): a block owns a 64 x 64 tile of the output and one of S slices of
//      the rows (split-N), A tiles built on the fly where A is pre or prod;
//      then a fixed-order sum over the S partials.
//   4. column sums (the bias grads and dw4), split over rows the same way.
// car_W (2 MB in bf16) and W1 are re-read from L2 by every row block, as in
// the forward kernel.  The float32 path has the same structure on the CUDA
// cores in full f32 (no TF32), with kRows = 16.
//
// The recompute variant (a null `nc`) replaces the TPU kernel
// chameleon_recsys_tpu/ops/pallas/cand_scorer.py::_bwd_kernel (_bwd_body
// with nc_ref=None, run when _STASH_NC is off).  It reads no [N, C] stash and
// adds 2 N C^2 operations (the CAR product once more).  The design keeps the
// row kernel's shared memory as it is: the row block first stages pre over
// its prod buffer and forms nc = [d] tanh(pre car_W + car_b) in 128-column
// chunks on the tensor cores, exactly as the forward forms it (the same WMMA
// tiles in the same k order, + car_b, tanhf, one rounding), and writes it
// into its own rows of di, which is nc's home until di is written.  The
// rest of the row kernel then reads nc from there as K1b reads the stash.
// dW1 needs prod = nc * pred over all rows after the row kernel, so the row
// kernel stops before dpre; dW1's transposed product runs; a second launch
// of the row kernel reloads dncp_c and forms dpre and di over nc.  No buffer
// beyond K1b's scratch is allocated, and given the forward's nc the
// gradients are K1b's bit for bit (every sum in the same order).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 64;     // dprod columns per step
constexpr int kCarChunk = 128;  // dpre columns per step: 8 MMAs per warp and tile
constexpr int kDepth = 64;     // depth of one staged weight tile
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
  static constexpr int kRows = 32;
  static constexpr int kPad = 8;  // 16 bytes of row padding against bank conflicts
};
template <>
struct Traits<float> {
  static constexpr int kRows = 16;
  static constexpr int kPad = 4;
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

// Copies a [kTileRows x cols] tile of the row-major global matrix
// [n_rows, n_cols] at (r0, c0) into shared memory with leading dimension ld;
// what lies outside the matrix reads as 0.  `cols` is a multiple of 16 bytes'
// worth of elements and at most kMaxCols.
template <typename Scalar, int kTileRows, int kMaxCols>
__device__ __forceinline__ void stage_tile(Scalar* s, int ld, const Scalar* g,
                                           int n_rows, int n_cols, int r0,
                                           int c0, int cols, bool vec_ok) {
  constexpr int kVec = 16 / sizeof(Scalar);
  const int vecs_per_row = cols / kVec;
  for (int v = threadIdx.x; v < kTileRows * vecs_per_row; v += kThreads) {
    const int r = v / vecs_per_row;
    const int c = (v % vecs_per_row) * kVec;
    const int gr = r0 + r, gc = c0 + c;
    uint4 value = make_uint4(0, 0, 0, 0);
    if (gr < n_rows && gc < n_cols) {
      const Scalar* src = g + (size_t)gr * n_cols + gc;
      if (vec_ok) {
        value = *reinterpret_cast<const uint4*>(src);
      } else {
        Scalar* dst = reinterpret_cast<Scalar*>(&value);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          dst[e] = gc + e < n_cols ? src[e] : from_f32<Scalar>(0.f);
      }
    }
    *reinterpret_cast<uint4*>(s + r * ld + c) = value;
  }
}

// ---------------------------------------------------------------------------
// 1. the row kernel
// ---------------------------------------------------------------------------

// Shared-memory layout of one row block (byte offsets), shared by the host,
// which sizes the launch, and the kernel.
template <typename Scalar>
struct RowLayout {
  static constexpr int R = Traits<Scalar>::kRows;
  static constexpr int P = Traits<Scalar>::kPad;
  int c_pad, m1_pad, ld_buf, ld_w1, ld_car, ld_nc, ld_stage, ld_a1, ld_da1;
  // c_pad is a multiple of kChunk; the dpre and nc loops run over c_pad
  // rounded up to kCarChunk, their last chunk's tail columns masked
  size_t off_w, off_stage, off_a1, off_x1, off_small, off_da1, bytes;

  __host__ __device__ RowLayout(int c, int m1, int m2, int m3) {
    c_pad = round_up(c, kChunk);
    m1_pad = round_up(m1, 16);
    ld_buf = c_pad + P;
    ld_w1 = m1_pad + P;
    ld_car = kDepth + P;
    ld_nc = kCarChunk + P;
    ld_stage = kCarChunk + 4;
    ld_a1 = m1_pad + 4;
    ld_da1 = m1_pad + P;
    const size_t w1_tile = (size_t)kDepth * ld_w1 * sizeof(Scalar);
    const size_t car_tile = (size_t)kCarChunk * ld_car * sizeof(Scalar);
    const size_t nc_tile = (size_t)kDepth * ld_nc * sizeof(Scalar);
    size_t w_tile = w1_tile > car_tile ? w1_tile : car_tile;
    w_tile = w_tile > nc_tile ? w_tile : nc_tile;
    off_w = align128((size_t)R * ld_buf * sizeof(Scalar));
    off_stage = off_w + align128(w_tile);
    off_a1 = off_stage + align128((size_t)R * ld_stage * sizeof(float));
    off_x1 = off_a1 + align128((size_t)R * ld_a1 * sizeof(float));
    off_small = off_x1 + align128((size_t)R * ld_a1 * sizeof(float));
    // a2, x2, da2 [R][m2]; a3, x3, da3 [R][m3]
    off_da1 = off_small + align128((size_t)R * 3 * (m2 + m3) * sizeof(float));
    bytes = off_da1 + align128((size_t)R * ld_da1 * sizeof(Scalar));
  }
};

// What one launch of the row kernel does: all of it from the stash (K1b);
// the front of the recompute variant (nc into di, then everything up to
// dncp_c); or its back (dpre and di from the dncp_c the front wrote).
enum RowMode { kRowAll = 0, kRowFront = 1, kRowDpre = 2 };

struct RowParams {
  const void *i_rows, *u, *pred, *car_w, *car_b, *w1, *b1, *w2, *b2, *w3,
      *b3, *w4, *nc;
  const float* g;
  void *di, *dp_rep, *dncp_c, *x1, *x2, *x3, *da1, *da2, *da3;
  long long n_rows;
  int k, c, m1, m2, m3;
  float alpha;
  int mode;  // a RowMode; with kRowFront, nc points at di
};

// The recompute variant's nc for the block's rows, written to their rows of
// p.di: pre = [d] leaky(i + u) staged in the prod buffer, then
// nc = [d] tanh(pre @ car_W + car_b) in kCarChunk-column chunks, formed as
// cand_score_fwd.cu forms it (16 x 16 WMMA tiles, or f32 fmaf chains, over
// k in increasing order from 0; + car_b; tanhf; one rounding).
template <typename Scalar>
__device__ __forceinline__ void recompute_nc(const RowParams& p,
                                             const RowLayout<Scalar>& L,
                                             unsigned char* smem) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int kVec = 16 / sizeof(Scalar);
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const int C = p.c, K = p.k;
  const float alpha = p.alpha;
  const long long row0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid / 32;
  const bool c_vec = C % kVec == 0;
  const Scalar* i_rows = static_cast<const Scalar*>(p.i_rows);
  const Scalar* u = static_cast<const Scalar*>(p.u);
  const Scalar* car_w = static_cast<const Scalar*>(p.car_w);
  const Scalar* car_b = static_cast<const Scalar*>(p.car_b);
  Scalar* nc = static_cast<Scalar*>(p.di);
  Scalar* buf = reinterpret_cast<Scalar*>(smem);
  Scalar* wt = reinterpret_cast<Scalar*>(smem + L.off_w);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage);

  {
    const int vecs_per_row = L.c_pad / kVec;
    for (int v = tid; v < R * vecs_per_row; v += kThreads) {
      const int r = v / vecs_per_row;
      const int col = (v % vecs_per_row) * kVec;
      const long long row = row0 + r;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (row < p.n_rows && col < C) {
        float iv[kVec], uv[kVec];
        load_f32(i_rows + row * C + col, C - col, c_vec, iv);
        load_f32(u + (row / K) * C + col, C - col, c_vec, uv);
        Scalar* out = reinterpret_cast<Scalar*>(&packed);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          out[e] = from_f32<Scalar>(leaky(iv[e] + uv[e], alpha));
      }
      *reinterpret_cast<uint4*>(buf + r * L.ld_buf + col) = packed;
    }
  }
  for (int j0 = 0; j0 < L.c_pad; j0 += kCarChunk) {
    // tensor path: warp w owns tiles (w % 2, 2 * (w / 2) + {0, 1}) of the
    // [32 x 128] chunk
    Frag acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    constexpr int kPer = R * kCarChunk / kThreads;
    float acc_c[kTensor ? 1 : kPer];
    if constexpr (!kTensor) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc_c[i] = 0.f;
    }
    for (int k0 = 0; k0 < L.c_pad; k0 += kDepth) {
      __syncthreads();  // pre complete / the previous tile and stage consumed
      // car_W rows k0..k0+63, columns j0..j0+127: a row-major [64 x 128]
      // operand with leading dimension ld_nc
      stage_tile<Scalar, kDepth, kCarChunk>(wt, L.ld_nc, car_w, C, C, k0, j0,
                                            kCarChunk, c_vec);
      __syncthreads();
      if constexpr (kTensor) {
        const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::load_matrix_sync(a, buf + 16 * rt * L.ld_buf + k0 + kk,
                                 L.ld_buf);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(b, wt + kk * L.ld_nc + 16 * (ct + j),
                                   L.ld_nc);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int v = tid + i * kThreads;
          const Scalar* a_row = buf + (v / kCarChunk) * L.ld_buf + k0;
          const Scalar* b_col = wt + v % kCarChunk;
          float s = acc_c[i];
#pragma unroll 8
          for (int kk = 0; kk < kDepth; ++kk)
            s = fmaf(to_f32(a_row[kk]), to_f32(b_col[kk * L.ld_nc]), s);
          acc_c[i] = s;
        }
      }
    }
    if constexpr (kTensor) {
      const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + 16 * rt * L.ld_stage + 16 * (ct + j),
                                acc[j], L.ld_stage, wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        stage[(v / kCarChunk) * L.ld_stage + v % kCarChunk] = acc_c[i];
      }
    }
    __syncthreads();
    for (int v = tid; v < R * kCarChunk; v += kThreads) {
      const int r = v / kCarChunk, j = v % kCarChunk;
      const long long row = row0 + r;
      const int col = j0 + j;
      if (row < p.n_rows && col < C)
        nc[row * C + col] = from_f32<Scalar>(
            tanhf(stage[r * L.ld_stage + j] + to_f32(car_b[col])));
    }
  }
  __syncthreads();  // the block's nc rows are written; pre is no longer read
}

// dpre = dncp_c @ car_W^T in column chunks, with dncp_c in the block's
// shared buffer, and di = [d] dpre leaky'(i + u) for the block's rows.
template <typename Scalar>
__device__ __forceinline__ void dpre_and_di(const RowParams& p,
                                            const RowLayout<Scalar>& L,
                                            unsigned char* smem) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int kVec = 16 / sizeof(Scalar);
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const int C = p.c, K = p.k;
  const float alpha = p.alpha;
  const long long row0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x, warp = tid / 32;
  const bool c_vec = C % kVec == 0;
  const Scalar* i_rows = static_cast<const Scalar*>(p.i_rows);
  const Scalar* u = static_cast<const Scalar*>(p.u);
  const Scalar* car_w = static_cast<const Scalar*>(p.car_w);
  Scalar* di = static_cast<Scalar*>(p.di);
  const Scalar* buf = reinterpret_cast<const Scalar*>(smem);
  Scalar* wt = reinterpret_cast<Scalar*>(smem + L.off_w);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage);

  for (int j0 = 0; j0 < L.c_pad; j0 += kCarChunk) {
    // tensor path: warp w owns tiles (w % 2, 2 * (w / 2) + {0, 1}) of the
    // [32 x 128] chunk
    Frag acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    constexpr int kPer = R * kCarChunk / kThreads;
    float acc_c[kTensor ? 1 : kPer];
    if constexpr (!kTensor) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc_c[i] = 0.f;
    }
    for (int k0 = 0; k0 < L.c_pad; k0 += kDepth) {
      __syncthreads();  // dncp_c complete / the previous tile is consumed
      // car_W rows j0..j0+127, columns k0..k0+63: as a [64 (k) x 128 (j)]
      // operand it is column-major with leading dimension ld_car
      stage_tile<Scalar, kCarChunk, kDepth>(wt, L.ld_car, car_w, C, C, j0, k0,
                                            kDepth, c_vec);
      __syncthreads();
      if constexpr (kTensor) {
        const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::load_matrix_sync(a, buf + 16 * rt * L.ld_buf + k0 + kk,
                                 L.ld_buf);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::col_major>
                b;
            wmma::load_matrix_sync(b, wt + 16 * (ct + j) * L.ld_car + kk,
                                   L.ld_car);
            wmma::mma_sync(acc[j], a, b, acc[j]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int v = tid + i * kThreads;
          const Scalar* a_row = buf + (v / kCarChunk) * L.ld_buf + k0;
          const Scalar* b_row = wt + (v % kCarChunk) * L.ld_car;
          float s = acc_c[i];
#pragma unroll 8
          for (int kk = 0; kk < kDepth; ++kk)
            s = fmaf(to_f32(a_row[kk]), to_f32(b_row[kk]), s);
          acc_c[i] = s;
        }
      }
    }
    __syncthreads();  // every read of the stage of the last chunk is done
    if constexpr (kTensor) {
      const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + 16 * rt * L.ld_stage + 16 * (ct + j),
                                acc[j], L.ld_stage, wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        stage[(v / kCarChunk) * L.ld_stage + v % kCarChunk] = acc_c[i];
      }
    }
    __syncthreads();
    for (int v = tid; v < R * kCarChunk; v += kThreads) {
      const int r = v / kCarChunk, j = v % kCarChunk;
      const long long row = row0 + r;
      const int col = j0 + j;
      if (row < p.n_rows && col < C) {
        const float a0 = to_f32(i_rows[row * C + col]) +
                         to_f32(u[(row / K) * C + col]);
        di[row * C + col] = from_f32<Scalar>(stage[r * L.ld_stage + j] *
                                             dleaky(a0, alpha));
      }
    }
  }
}

template <typename Scalar>
__global__ void __launch_bounds__(kThreads, 1)
    cand_score_bwd_rows_kernel(const RowParams p) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int kVec = 16 / sizeof(Scalar);
  using Frag = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;
  const RowLayout<Scalar> L(p.c, p.m1, p.m2, p.m3);
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
  Scalar* dp_rep = static_cast<Scalar*>(p.dp_rep);
  Scalar* dncp_g = static_cast<Scalar*>(p.dncp_c);

  extern __shared__ __align__(128) unsigned char smem[];
  Scalar* buf = reinterpret_cast<Scalar*>(smem);  // prod, then dncp_c
  Scalar* wt = reinterpret_cast<Scalar*>(smem + L.off_w);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage);
  float* a1 = reinterpret_cast<float*>(smem + L.off_a1);
  float* x1 = reinterpret_cast<float*>(smem + L.off_x1);
  float* a2 = reinterpret_cast<float*>(smem + L.off_small);
  float* x2 = a2 + R * M2;
  float* da2 = x2 + R * M2;
  float* a3 = da2 + R * M2;
  float* x3 = a3 + R * M3;
  float* da3 = x3 + R * M3;
  Scalar* da1 = reinterpret_cast<Scalar*>(smem + L.off_da1);

  const bool c_vec = C % kVec == 0;
  const bool m1_vec = M1 % kVec == 0;
  const int m1_tiles = L.m1_pad / 16;

  if (p.mode == kRowFront) recompute_nc<Scalar>(p, L, smem);

  // ---- prod = [d] nc * pred for the block's rows ----
  {
    const int vecs_per_row = L.c_pad / kVec;
    for (int v = tid; v < R * vecs_per_row; v += kThreads) {
      const int r = v / vecs_per_row;
      const int col = (v % vecs_per_row) * kVec;
      const long long row = row0 + r;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (row < p.n_rows && col < C) {
        float nv[kVec], pv[kVec];
        load_f32(nc + row * C + col, C - col, c_vec, nv);
        load_f32(pred + (row / K) * C + col, C - col, c_vec, pv);
        Scalar* out = reinterpret_cast<Scalar*>(&packed);
#pragma unroll
        for (int e = 0; e < kVec; ++e) out[e] = from_f32<Scalar>(nv[e] * pv[e]);
      }
      *reinterpret_cast<uint4*>(buf + r * L.ld_buf + col) = packed;
    }
  }

  // ---- a1 = prod @ W1 (bias below) ----
  {
    // tensor path: warp w owns tiles (w % 2, 2 * (w / 2) + {0, 1}) of 16 x 16
    Frag acc[2];
    wmma::fill_fragment(acc[0], 0.f);
    wmma::fill_fragment(acc[1], 0.f);
    constexpr int kPer = (R * kMaxM1 + kThreads - 1) / kThreads;
    float acc_c[kTensor ? 1 : kPer];
    if constexpr (!kTensor) {
#pragma unroll
      for (int i = 0; i < kPer; ++i) acc_c[i] = 0.f;
    }
    for (int k0 = 0; k0 < L.c_pad; k0 += kDepth) {
      __syncthreads();  // prod is complete / the previous tile is consumed
      stage_tile<Scalar, kDepth, kMaxM1>(wt, L.ld_w1, w1, C, M1, k0, 0,
                                         L.m1_pad, m1_vec);
      __syncthreads();
      if constexpr (kTensor) {
        const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::load_matrix_sync(a, buf + 16 * rt * L.ld_buf + k0 + kk,
                                 L.ld_buf);
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
      } else {
#pragma unroll
        for (int i = 0; i < kPer; ++i) {
          const int v = tid + i * kThreads;
          if (v < R * L.m1_pad) {
            const Scalar* a_row = buf + (v / L.m1_pad) * L.ld_buf + k0;
            const Scalar* b_col = wt + v % L.m1_pad;
            float s = acc_c[i];
#pragma unroll 8
            for (int kk = 0; kk < kDepth; ++kk)
              s = fmaf(to_f32(a_row[kk]), to_f32(b_col[kk * L.ld_w1]), s);
            acc_c[i] = s;
          }
        }
      }
    }
    if constexpr (kTensor) {
      const int rt = warp % 2, ct = 2 * (warp / 2);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        if (ct + j < m1_tiles)
          wmma::store_matrix_sync(a1 + 16 * rt * L.ld_a1 + 16 * (ct + j),
                                  acc[j], L.ld_a1, wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        const int v = tid + i * kThreads;
        if (v < R * L.m1_pad) a1[(v / L.m1_pad) * L.ld_a1 + v % L.m1_pad] = acc_c[i];
      }
    }
  }
  __syncthreads();

  // ---- the matching tail and its backward, CUDA cores, f32 ----
  for (int v = tid; v < R * M1; v += kThreads) {
    const int r = v / M1, m = v % M1;
    const float a = a1[r * L.ld_a1 + m] + to_f32(b1[m]);
    a1[r * L.ld_a1 + m] = a;
    x1[r * L.ld_a1 + m] = round_to<Scalar>(leaky(a, alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * M2; v += kThreads) {
    const int r = v / M2, m = v % M2;
    float s = 0.f;
    for (int j = 0; j < M1; ++j)
      s = fmaf(x1[r * L.ld_a1 + j], to_f32(w2[j * M2 + m]), s);
    const float a = s + to_f32(b2[m]);
    a2[v] = a;
    x2[v] = round_to<Scalar>(leaky(a, alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * M3; v += kThreads) {
    const int r = v / M3, m = v % M3;
    float s = 0.f;
    for (int j = 0; j < M2; ++j) s = fmaf(x2[r * M2 + j], to_f32(w3[j * M3 + m]), s);
    const float a = s + to_f32(b3[m]);
    a3[v] = a;
    x3[v] = round_to<Scalar>(leaky(a, alpha));
    const long long row = row0 + r;
    const float ds = row < p.n_rows ? p.g[row] : 0.f;
    da3[v] = round_to<Scalar>(ds * to_f32(w4[m]) * dleaky(a, alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * M2; v += kThreads) {
    const int r = v / M2, m = v % M2;
    float s = 0.f;
    for (int j = 0; j < M3; ++j) s = fmaf(da3[r * M3 + j], to_f32(w3[m * M3 + j]), s);
    da2[v] = round_to<Scalar>(s * dleaky(a2[v], alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * L.m1_pad; v += kThreads) {
    const int r = v / L.m1_pad, m = v % L.m1_pad;
    float value = 0.f;
    if (m < M1) {
      float s = 0.f;
      for (int j = 0; j < M2; ++j) s = fmaf(da2[r * M2 + j], to_f32(w2[m * M2 + j]), s);
      value = s * dleaky(a1[r * L.ld_a1 + m], alpha);
    }
    da1[r * L.ld_da1 + m] = from_f32<Scalar>(value);
  }
  __syncthreads();
  {  // the tail's activations and cotangents, for the weight-grad launches
    Scalar* gx1 = static_cast<Scalar*>(p.x1);
    Scalar* gda1 = static_cast<Scalar*>(p.da1);
    Scalar* gx2 = static_cast<Scalar*>(p.x2);
    Scalar* gda2 = static_cast<Scalar*>(p.da2);
    Scalar* gx3 = static_cast<Scalar*>(p.x3);
    Scalar* gda3 = static_cast<Scalar*>(p.da3);
    for (int v = tid; v < R * M1; v += kThreads) {
      const int r = v / M1, m = v % M1;
      const long long row = row0 + r;
      if (row < p.n_rows) {
        gx1[row * M1 + m] = from_f32<Scalar>(x1[r * L.ld_a1 + m]);
        gda1[row * M1 + m] = da1[r * L.ld_da1 + m];
      }
    }
    for (int v = tid; v < R * M2; v += kThreads) {
      const long long row = row0 + v / M2;
      if (row < p.n_rows) {
        gx2[row * M2 + v % M2] = from_f32<Scalar>(x2[v]);
        gda2[row * M2 + v % M2] = from_f32<Scalar>(da2[v]);
      }
    }
    for (int v = tid; v < R * M3; v += kThreads) {
      const long long row = row0 + v / M3;
      if (row < p.n_rows) {
        gx3[row * M3 + v % M3] = from_f32<Scalar>(x3[v]);
        gda3[row * M3 + v % M3] = from_f32<Scalar>(da3[v]);
      }
    }
  }

  // ---- dprod = [d] da1 @ W1^T in column chunks; dncp_c over prod ----
  for (int c0 = 0; c0 < L.c_pad; c0 += kChunk) {
    __syncthreads();  // the previous chunk's stage and tile are consumed
    // W1 rows c0..c0+63, all M1 columns: as a [M1 x 64] operand it is
    // column-major with leading dimension ld_w1
    stage_tile<Scalar, kChunk, kMaxM1>(wt, L.ld_w1, w1, C, M1, c0, 0, L.m1_pad,
                                       m1_vec);
    __syncthreads();
    if constexpr (kTensor) {
      // warp w owns the 16 x 16 tile (w % 2, w / 2) of the [32 x 64] chunk
      const int rt = warp % 2, ct = warp / 2;
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
    } else {
      for (int v = tid; v < R * kChunk; v += kThreads) {
        const int r = v / kChunk, j = v % kChunk;
        const Scalar* a_row = da1 + r * L.ld_da1;
        const Scalar* b_row = wt + j * L.ld_w1;
        float s = 0.f;
        for (int kk = 0; kk < L.m1_pad; ++kk)
          s = fmaf(to_f32(a_row[kk]), to_f32(b_row[kk]), s);
        stage[r * L.ld_stage + j] = s;
      }
    }
    __syncthreads();
    for (int v = tid; v < R * kChunk; v += kThreads) {
      const int r = v / kChunk, j = v % kChunk;
      const long long row = row0 + r;
      const int col = c0 + j;
      float value = 0.f;
      if (row < p.n_rows && col < C) {
        const float dprod = round_to<Scalar>(stage[r * L.ld_stage + j]);
        const float ncv = to_f32(nc[row * C + col]);
        const float pv = to_f32(pred[(row / K) * C + col]);
        const float dnc = round_to<Scalar>(dprod * pv);
        dp_rep[row * C + col] = from_f32<Scalar>(dprod * ncv);
        const float tanh_d = round_to<Scalar>(1.f - round_to<Scalar>(ncv * ncv));
        value = round_to<Scalar>(dnc * tanh_d);
        dncp_g[row * C + col] = from_f32<Scalar>(value);
      }
      buf[r * L.ld_buf + col] = from_f32<Scalar>(value);
    }
  }

  // the recompute variant's front stops here: dW1 reads nc (in di) first
  if (p.mode == kRowFront) return;
  dpre_and_di<Scalar>(p, L, smem);
}

// The back of the recompute variant: the block's rows of dncp_c, written by
// the front launch, back into shared memory, then dpre and di.
template <typename Scalar>
__global__ void __launch_bounds__(kThreads, 1)
    cand_score_bwd_dpre_kernel(const RowParams p) {
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int kVec = 16 / sizeof(Scalar);
  const RowLayout<Scalar> L(p.c, p.m1, p.m2, p.m3);
  const int C = p.c;
  const long long row0 = (long long)blockIdx.x * R;
  const Scalar* dncp_g = static_cast<const Scalar*>(p.dncp_c);
  extern __shared__ __align__(128) unsigned char smem[];
  Scalar* buf = reinterpret_cast<Scalar*>(smem);
  const bool c_vec = C % kVec == 0;
  const int vecs_per_row = L.c_pad / kVec;
  for (int v = threadIdx.x; v < R * vecs_per_row; v += kThreads) {
    const int r = v / vecs_per_row;
    const int col = (v % vecs_per_row) * kVec;
    const long long row = row0 + r;
    uint4 packed = make_uint4(0, 0, 0, 0);
    if (row < p.n_rows && col < C) {
      float x[kVec];
      load_f32(dncp_g + row * C + col, C - col, c_vec, x);
      Scalar* out = reinterpret_cast<Scalar*>(&packed);
#pragma unroll
      for (int e = 0; e < kVec; ++e) out[e] = from_f32<Scalar>(x[e]);
    }
    *reinterpret_cast<uint4*>(buf + r * L.ld_buf + col) = packed;
  }
  dpre_and_di<Scalar>(p, L, smem);
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

// ---------------------------------------------------------------------------
// 3. transposed products over all rows: part[s] = A[rows of s]^T B[rows of s]
// ---------------------------------------------------------------------------

enum AMode { kPlain = 0, kPre = 1, kProd = 2 };

struct TnParams {
  const void* a;   // kPlain: A [n, I]; kPre: i_rows; kProd: nc
  const void* a2;  // kPre: u [n / k, I]; kProd: pred [n / k, I]
  const void* b;   // B [n, J]
  float* part;     // [S, I_pad, J_pad]
  long long n, rows_per_split;
  int k, I, J, I_pad, J_pad, mode;
  float alpha;
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
  const Scalar* a2 = static_cast<const Scalar*>(p.a2);
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
        if (gi < p.I) {
          load_f32(a + n * p.I + gi, p.I - gi, a_vec, av);
          if (p.mode != kPlain) {
            float xv[kVec];
            load_f32(a2 + (n / p.k) * p.I + gi, p.I - gi, a_vec, xv);
#pragma unroll
            for (int e = 0; e < kVec; ++e)
              av[e] = p.mode == kPre ? leaky(av[e] + xv[e], p.alpha)
                                     : av[e] * xv[e];
          }
        }
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
// 4. column sums: part[s, j] = sum over the rows of s of x[n, j] (* w[n])
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

// One transposed product's shape and its split over the rows.
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

// The scratch the launches need, carved from one buffer the caller
// allocates: the row kernel's outputs in the operands' dtype, then the f32
// partials of every sum.
struct Plan {
  long long n;
  int c, m1, m2, m3, elem;
  TnPlan car, w1, w2, w3;
  SumPlan s_car, s_1, s_2, s_3, s_4;
  size_t off_dp_rep, off_dncp, off_x1, off_da1, off_x2, off_da2, off_x3,
      off_da3, off_part_car, off_part_w1, off_part_w2, off_part_w3,
      off_sum_car, off_sum_1, off_sum_2, off_sum_3, off_sum_4, bytes;

  Plan(long long n_rows, int c_, int m1_, int m2_, int m3_, int elem_)
      : n(n_rows), c(c_), m1(m1_), m2(m2_), m3(m3_), elem(elem_),
        car(c_, c_, n_rows), w1(c_, m1_, n_rows), w2(m1_, m2_, n_rows),
        w3(m2_, m3_, n_rows), s_car(c_, n_rows), s_1(m1_, n_rows),
        s_2(m2_, n_rows), s_3(m3_, n_rows), s_4(m3_, n_rows) {
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
    off_part_car = take(car.floats() * 4);
    off_part_w1 = take(w1.floats() * 4);
    off_part_w2 = take(w2.floats() * 4);
    off_part_w3 = take(w3.floats() * 4);
    off_sum_car = take(s_car.floats() * 4);
    off_sum_1 = take(s_1.floats() * 4);
    off_sum_2 = take(s_2.floats() * 4);
    off_sum_3 = take(s_3.floats() * 4);
    off_sum_4 = take(s_4.floats() * 4);
    bytes = at;
  }
};

template <typename Scalar>
cudaError_t tn_product(const Plan& plan, const TnPlan& tp, int mode,
                       const void* a, const void* a2, const void* b,
                       float* part, Scalar* out, int k, float alpha,
                       cudaStream_t stream) {
  TnParams p{a, a2, b, part, plan.n, tp.rows_per_split, k, tp.I, tp.J,
             tp.I_pad, tp.J_pad, mode, alpha};
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

struct Outputs {
  void *di, *du, *dp, *dcar_w, *dcar_b, *dw1, *db1, *dw2, *db2, *dw3, *db3,
      *dw4;
};

template <typename Scalar>
cudaError_t launch_typed(const RowParams& rp_in, const Outputs& o,
                         unsigned char* scratch, cudaStream_t stream) {
  const RowLayout<Scalar> layout(rp_in.c, rp_in.m1, rp_in.m2, rp_in.m3);
  if (layout.bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  const Plan plan(rp_in.n_rows, rp_in.c, rp_in.m1, rp_in.m2, rp_in.m3,
                  sizeof(Scalar));
  RowParams rp = rp_in;
  rp.di = o.di;
  rp.dp_rep = scratch + plan.off_dp_rep;
  rp.dncp_c = scratch + plan.off_dncp;
  rp.x1 = scratch + plan.off_x1;
  rp.da1 = scratch + plan.off_da1;
  rp.x2 = scratch + plan.off_x2;
  rp.da2 = scratch + plan.off_da2;
  rp.x3 = scratch + plan.off_x3;
  rp.da3 = scratch + plan.off_da3;

  cudaError_t err = cudaFuncSetAttribute(
      cand_score_bwd_rows_kernel<Scalar>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)layout.bytes);
  if (err != cudaSuccess) return err;
  constexpr int R = Traits<Scalar>::kRows;
  const unsigned row_blocks = (unsigned)div_up(rp.n_rows, R);
  auto part = [&](size_t off) { return reinterpret_cast<float*>(scratch + off); };
  const bool recompute = rp.nc == nullptr;
  if (recompute) {
    // nc lives in di from the front launch until the dpre launch writes di
    rp.nc = o.di;
    rp.mode = kRowFront;
    cand_score_bwd_rows_kernel<Scalar>
        <<<row_blocks, kThreads, layout.bytes, stream>>>(rp);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
    if ((err = tn_product<Scalar>(plan, plan.w1, kProd, rp.nc, rp.pred,
                                  rp.da1, part(plan.off_part_w1),
                                  static_cast<Scalar*>(o.dw1), rp.k, rp.alpha,
                                  stream)) != cudaSuccess)
      return err;
    err = cudaFuncSetAttribute(cand_score_bwd_dpre_kernel<Scalar>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)layout.bytes);
    if (err != cudaSuccess) return err;
    rp.mode = kRowDpre;
    cand_score_bwd_dpre_kernel<Scalar>
        <<<row_blocks, kThreads, layout.bytes, stream>>>(rp);
  } else {
    rp.mode = kRowAll;
    cand_score_bwd_rows_kernel<Scalar>
        <<<row_blocks, kThreads, layout.bytes, stream>>>(rp);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  const long long bt = rp.n_rows / rp.k;
  segment_sum_kernel<Scalar><<<grid_for(bt * rp.c), kThreads, 0, stream>>>(
      static_cast<const Scalar*>(o.di), static_cast<Scalar*>(o.du), bt, rp.k,
      rp.c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  segment_sum_kernel<Scalar><<<grid_for(bt * rp.c), kThreads, 0, stream>>>(
      static_cast<const Scalar*>(rp.dp_rep), static_cast<Scalar*>(o.dp), bt,
      rp.k, rp.c);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;

  if ((err = tn_product<Scalar>(plan, plan.car, kPre, rp.i_rows, rp.u,
                                rp.dncp_c, part(plan.off_part_car),
                                static_cast<Scalar*>(o.dcar_w), rp.k, rp.alpha,
                                stream)) != cudaSuccess)
    return err;
  if (!recompute &&
      (err = tn_product<Scalar>(plan, plan.w1, kProd, rp.nc, rp.pred, rp.da1,
                                part(plan.off_part_w1),
                                static_cast<Scalar*>(o.dw1), rp.k, rp.alpha,
                                stream)) != cudaSuccess)
    return err;
  if ((err = tn_product<Scalar>(plan, plan.w2, kPlain, rp.x1, nullptr, rp.da2,
                                part(plan.off_part_w2),
                                static_cast<Scalar*>(o.dw2), rp.k, rp.alpha,
                                stream)) != cudaSuccess)
    return err;
  if ((err = tn_product<Scalar>(plan, plan.w3, kPlain, rp.x2, nullptr, rp.da3,
                                part(plan.off_part_w3),
                                static_cast<Scalar*>(o.dw3), rp.k, rp.alpha,
                                stream)) != cudaSuccess)
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

bool shapes_ok(long long n_rows, int k, int c, int m1, int m2, int m3) {
  return n_rows > 0 && k > 0 && n_rows % k == 0 && c > 0 && m1 > 0 &&
         m1 <= kMaxM1 && m2 > 0 && m3 > 0 && div_up(n_rows, 16) <= 0x7fffffffLL;
}

}  // namespace

// Bytes of scratch `cand_score_bwd` needs for these shapes (dtype codes as
// below), or -1 for shapes it does not take.
extern "C" long long cand_score_bwd_scratch_bytes(long long n_rows, int k,
                                                  int c, int m1, int m2,
                                                  int m3, int dtype) {
  if (!shapes_ok(n_rows, k, c, m1, m2, m3) || (dtype != 0 && dtype != 1))
    return -1;
  return (long long)Plan(n_rows, c, m1, m2, m3, dtype == 0 ? 4 : 2).bytes;
}

// dtype codes: 0 = float32, 1 = bfloat16 (every operand and every gradient
// has it; g is float32).  Operands as for cand_score_fwd, plus nc [n_rows, c]
// (the forward's stash), or null for the recompute variant, and g [n_rows].  Outputs: di [n_rows, c], du and dp
// [n_rows / k, c], dcar_w [c, c], dcar_b [c], dw1 [c, m1], db1 [m1],
// dw2 [m1, m2], db2 [m2], dw3 [m2, m3], db3 [m3], dw4 [m3].  `scratch` holds
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
  if (!shapes_ok(n_rows, k, c, m1, m2, m3)) return cudaErrorInvalidValue;
  const RowParams rp{i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3,
                     w4, nc, static_cast<const float*>(g), nullptr, nullptr,
                     nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                     nullptr, n_rows, k, c, m1, m2, m3, alpha, kRowAll};
  const Outputs o{di, du, dp, dcar_w, dcar_b, dw1, db1, dw2, db2, dw3, db3,
                  dw4};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* buffer = static_cast<unsigned char*>(scratch);
  if (dtype == 0) return launch_typed<float>(rp, o, buffer, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(rp, o, buffer, s);
  return cudaErrorInvalidValue;
}
