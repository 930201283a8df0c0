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
// What bounds it: at the G1 eval shape (N = 4864 * 50, C = 1024, M = 128,
// 64, 32) the work is 0.58 TFLOP against 0.5 GB of i_rows, about 1,150
// operations per byte, so the tensor cores bound it, not device memory.
//
// What the design does about it: one block owns kRows candidate rows.  It
// builds their PreCAR activations `pre` [kRows, C] once in shared memory,
// then walks the CAR output in column chunks of kChunk.  For each chunk it
// multiplies pre by car_W[:, chunk] on the tensor cores (WMMA, bf16 in, f32
// accumulate), applies bias + tanh and the pred product in shared memory, and
// accumulates that chunk's share of the first matching layer,
// x1 += prod @ W1[chunk, :], in registers.  So neither nc nor prod reaches
// device memory, and the first matching layer costs no extra pass.  car_W
// and W1 tiles are prefetched into registers one step ahead of their use.
// The small tail (bias/leaky of layer 1, layers 2 and 3, the w4 dot) runs on
// the CUDA cores in f32 from shared memory.  Each block re-reads car_W
// (2 MB in bf16) from L2, so with kRows = 64 L2 traffic, not the tensor
// cores, is the first limit of this design.
//
// float32 inputs take the same structure on the CUDA cores in full f32 (no
// TF32), with kRows = 16 so that pre still fits shared memory.
//
// Training (the stash variant, replacing _fwd_stash_kernel): with a non-null
// `nc` pointer the kernel also stores each chunk of the rounded CAR output nc
// [N, C] in the input dtype, which it holds anyway while it forms prod; the
// backward kernel (cand_score_bwd.cu) reads it instead of recomputing the CAR
// product.  A null pointer leaves the eval kernel exactly as it was.
//
// Rows, C and the matching widths need no alignment: tiles past an edge load
// as zeros and rows past N are not written.  16-byte vector loads are used
// where the row length allows them.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

namespace {

using namespace nvcuda;

constexpr int kThreads = 256;  // 8 warps
constexpr int kChunk = 64;     // CAR output columns per step
constexpr int kDepth = 64;     // depth of one car_W tile
constexpr int kMaxM1 = 128;    // widest first matching layer
constexpr int kSmemLimit = 232448;  // 227 KB a block may use on sm_90

template <typename Scalar>
struct Traits;
template <>
struct Traits<__nv_bfloat16> {
  static constexpr int kRows = 64;
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

// The value the dtype holds for v, back in f32 (the Pallas kernel's
// `.astype(d)` between layers).
template <typename Scalar>
__device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<Scalar>(v));
}

__device__ __forceinline__ float leaky(float v, float alpha) {
  return v > 0.f ? v : alpha * v;
}

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}

__host__ __device__ constexpr size_t align128(size_t v) {
  return (v + 127) / 128 * 128;
}

// Shared-memory layout of one block (byte offsets), shared by the host, which
// sizes the launch, and the kernel.  The epilogue's f32 buffers alias the
// region of `pre`, which is dead by then.
template <typename Scalar>
struct Layout {
  static constexpr int R = Traits<Scalar>::kRows;
  static constexpr int P = Traits<Scalar>::kPad;
  int c_pad, m1_pad;
  int ld_pre, ld_w, ld_stage, ld_prod, ld_w1, ld_x1;
  size_t off_w, off_stage, off_prod, off_w1, bytes;

  __host__ __device__ Layout(int c, int m1, int m2, int m3) {
    c_pad = round_up(c, kChunk);
    m1_pad = round_up(m1, 16);
    ld_pre = c_pad + P;
    ld_w = kChunk + P;
    ld_stage = kChunk + 4;
    ld_prod = kChunk + P;
    ld_w1 = m1_pad + P;
    ld_x1 = m1_pad + 4;
    const size_t pre = (size_t)R * ld_pre * sizeof(Scalar);
    const size_t epilogue =
        (size_t)R * (ld_x1 + m2 + m3) * sizeof(float);
    off_w = align128(pre > epilogue ? pre : epilogue);
    off_stage = off_w + align128((size_t)kDepth * ld_w * sizeof(Scalar));
    off_prod = off_stage + align128((size_t)R * ld_stage * sizeof(float));
    off_w1 = off_prod + align128((size_t)R * ld_prod * sizeof(Scalar));
    bytes = off_w1 + align128((size_t)kChunk * ld_w1 * sizeof(Scalar));
  }
};

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

// A [rows x cols] tile of a row-major global matrix [n_rows, n_cols], from
// (r0, c0), staged through registers so that the loads of the next tile are
// in flight while the current one is used.  `cols` is a multiple of 16 bytes'
// worth of elements and at most kMaxCols; outside the matrix reads as 0.
template <typename Scalar, int kTileRows, int kMaxCols>
struct TileLoader {
  static constexpr int kVec = 16 / sizeof(Scalar);
  static constexpr int kPer =
      (kTileRows * kMaxCols / kVec + kThreads - 1) / kThreads;
  uint4 regs[kPer];

  __device__ __forceinline__ void load(const Scalar* g, int n_rows,
                                       int n_cols, int r0, int c0, int cols,
                                       bool vec_ok) {
    const int vecs_per_row = cols / kVec;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      uint4 value = make_uint4(0, 0, 0, 0);
      if (v < kTileRows * vecs_per_row) {
        const int gr = r0 + v / vecs_per_row;
        const int gc = c0 + (v % vecs_per_row) * kVec;
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
      }
      regs[i] = value;
    }
  }

  __device__ __forceinline__ void store(Scalar* s, int ld, int cols) const {
    const int vecs_per_row = cols / kVec;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int v = threadIdx.x + i * kThreads;
      if (v < kTileRows * vecs_per_row) {
        *reinterpret_cast<uint4*>(s + (v / vecs_per_row) * ld +
                                  (v % vecs_per_row) * kVec) = regs[i];
      }
    }
  }
};

struct Params {
  const void *i_rows, *u, *pred, *car_w, *car_b, *w1, *b1, *w2, *b2, *w3,
      *b3, *w4;
  float* out;
  void* nc;  // [n_rows, c] in the input dtype, or null
  long long n_rows;
  int k, c, m1, m2, m3;
  float alpha;
};

template <typename Scalar>
__global__ void __launch_bounds__(kThreads, 1)
    cand_score_fwd_kernel(const Params p) {
  constexpr bool kTensor = std::is_same<Scalar, __nv_bfloat16>::value;
  constexpr int R = Traits<Scalar>::kRows;
  constexpr int kVec = 16 / sizeof(Scalar);
  const Layout<Scalar> L(p.c, p.m1, p.m2, p.m3);
  const int C = p.c, M1 = p.m1, M2 = p.m2, M3 = p.m3;
  const float alpha = p.alpha;
  const long long row0 = (long long)blockIdx.x * R;
  const int tid = threadIdx.x;

  const Scalar* i_rows = static_cast<const Scalar*>(p.i_rows);
  const Scalar* u = static_cast<const Scalar*>(p.u);
  const Scalar* pred = static_cast<const Scalar*>(p.pred);
  const Scalar* car_w = static_cast<const Scalar*>(p.car_w);
  const Scalar* car_b = static_cast<const Scalar*>(p.car_b);
  const Scalar* w1 = static_cast<const Scalar*>(p.w1);
  const Scalar* b1 = static_cast<const Scalar*>(p.b1);
  const Scalar* w2 = static_cast<const Scalar*>(p.w2);
  const Scalar* b2 = static_cast<const Scalar*>(p.b2);
  const Scalar* w3 = static_cast<const Scalar*>(p.w3);
  const Scalar* b3 = static_cast<const Scalar*>(p.b3);
  const Scalar* w4 = static_cast<const Scalar*>(p.w4);
  Scalar* nc_out = static_cast<Scalar*>(p.nc);

  extern __shared__ __align__(128) unsigned char smem[];
  Scalar* pre = reinterpret_cast<Scalar*>(smem);
  Scalar* w_tile = reinterpret_cast<Scalar*>(smem + L.off_w);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage);
  Scalar* prod = reinterpret_cast<Scalar*>(smem + L.off_prod);
  Scalar* w1_tile = reinterpret_cast<Scalar*>(smem + L.off_w1);
  float* x1 = reinterpret_cast<float*>(smem);  // epilogue, aliases pre
  float* x2 = x1 + R * L.ld_x1;
  float* x3 = x2 + R * M2;

  const bool c_vec = C % kVec == 0;
  const bool m1_vec = M1 % kVec == 0;

  // ---- pre = leaky(i + u), rounded, for the block's rows ----
  {
    const int vecs_per_row = L.c_pad / kVec;
    for (int v = tid; v < R * vecs_per_row; v += kThreads) {
      const int r = v / vecs_per_row;
      const int col = (v % vecs_per_row) * kVec;
      const long long row = row0 + r;
      uint4 packed = make_uint4(0, 0, 0, 0);
      if (row < p.n_rows && col < C) {
        const long long bt = row / p.k;
        float iv[kVec], uv[kVec];
        load_f32(i_rows + row * C + col, C - col, c_vec, iv);
        load_f32(u + bt * C + col, C - col, c_vec, uv);
        Scalar* out = reinterpret_cast<Scalar*>(&packed);
#pragma unroll
        for (int e = 0; e < kVec; ++e)
          out[e] = from_f32<Scalar>(leaky(iv[e] + uv[e], alpha));
      }
      *reinterpret_cast<uint4*>(pre + r * L.ld_pre + col) = packed;
    }
  }

  // ---- CAR in column chunks, each folded into the first matching layer ----
  const int warp = tid / 32;
  const int n_depth = L.c_pad / kDepth;
  const int m1_tiles = L.m1_pad / 16;
  TileLoader<Scalar, kDepth, kChunk> w_loader;
  TileLoader<Scalar, kChunk, kMaxM1> w1_loader;

  // tensor path: warp w owns CAR tiles (w % 4, 2 * (w / 4) + {0, 1}) and
  // layer-1 tiles (w % 4, 4 * (w / 4) + {0..3}) of 16 x 16
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> x1_frag[4];
  // CUDA-core path: thread owns elements tid + i * kThreads
  constexpr int kCarPer = R * kChunk / kThreads;
  constexpr int kX1Per = (R * kMaxM1 + kThreads - 1) / kThreads;
  float x1_acc[kTensor ? 1 : kX1Per];
  if constexpr (kTensor) {
#pragma unroll
    for (int j = 0; j < 4; ++j) wmma::fill_fragment(x1_frag[j], 0.f);
  } else {
#pragma unroll
    for (int i = 0; i < kX1Per; ++i) x1_acc[i] = 0.f;
  }

  for (int n0 = 0; n0 < L.c_pad; n0 += kChunk) {
    w1_loader.load(w1, C, M1, n0, 0, L.m1_pad, m1_vec);
    w_loader.load(car_w, C, C, 0, n0, kChunk, c_vec);

    wmma::fragment<wmma::accumulator, 16, 16, 16, float> car_frag[2];
    float car_acc[kTensor ? 1 : kCarPer];
    if constexpr (kTensor) {
      wmma::fill_fragment(car_frag[0], 0.f);
      wmma::fill_fragment(car_frag[1], 0.f);
    } else {
#pragma unroll
      for (int i = 0; i < kCarPer; ++i) car_acc[i] = 0.f;
    }

    for (int kt = 0; kt < n_depth; ++kt) {
      __syncthreads();  // the previous tile (or chunk) is consumed
      w_loader.store(w_tile, L.ld_w, kChunk);
      __syncthreads();
      if (kt + 1 < n_depth)
        w_loader.load(car_w, C, C, (kt + 1) * kDepth, n0, kChunk, c_vec);
      const Scalar* a_base = pre + kt * kDepth;
      if constexpr (kTensor) {
        const int rt = warp % 4, ct = 2 * (warp / 4);
#pragma unroll
        for (int kk = 0; kk < kDepth; kk += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                         wmma::row_major>
              a;
          wmma::load_matrix_sync(a, a_base + 16 * rt * L.ld_pre + kk,
                                 L.ld_pre);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(b, w_tile + kk * L.ld_w + 16 * (ct + j),
                                   L.ld_w);
            wmma::mma_sync(car_frag[j], a, b, car_frag[j]);
          }
        }
      } else {
#pragma unroll
        for (int i = 0; i < kCarPer; ++i) {
          const int v = tid + i * kThreads;
          const Scalar* a_row = a_base + (v / kChunk) * L.ld_pre;
          const Scalar* b_col = w_tile + v % kChunk;
          float acc = car_acc[i];
#pragma unroll 8
          for (int kk = 0; kk < kDepth; ++kk)
            acc = fmaf(to_f32(a_row[kk]), to_f32(b_col[kk * L.ld_w]), acc);
          car_acc[i] = acc;
        }
      }
    }

    // stage the CAR pre-activation; the layer-1 tile of this chunk goes to
    // shared memory (the previous chunk's users of it passed the barriers
    // of the depth loop)
    if constexpr (kTensor) {
      const int rt = warp % 4, ct = 2 * (warp / 4);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(stage + 16 * rt * L.ld_stage + 16 * (ct + j),
                                car_frag[j], L.ld_stage, wmma::mem_row_major);
    } else {
#pragma unroll
      for (int i = 0; i < kCarPer; ++i) {
        const int v = tid + i * kThreads;
        stage[(v / kChunk) * L.ld_stage + v % kChunk] = car_acc[i];
      }
    }
    w1_loader.store(w1_tile, L.ld_w1, L.m1_pad);
    __syncthreads();

    // prod = round(round(tanh(acc + car_b)) * pred); zero past the edges
    for (int v = tid; v < R * kChunk; v += kThreads) {
      const int r = v / kChunk, j = v % kChunk;
      const long long row = row0 + r;
      const int col = n0 + j;
      float value = 0.f;
      if (row < p.n_rows && col < C) {
        const float nc = round_to<Scalar>(
            tanhf(stage[r * L.ld_stage + j] + to_f32(car_b[col])));
        if (nc_out != nullptr) nc_out[row * C + col] = from_f32<Scalar>(nc);
        value = nc * to_f32(pred[(row / p.k) * C + col]);
      }
      prod[r * L.ld_prod + j] = from_f32<Scalar>(value);
    }
    __syncthreads();

    // x1 += prod @ W1[chunk, :]
    if constexpr (kTensor) {
      const int rt = warp % 4, ct = 4 * (warp / 4);
#pragma unroll
      for (int kk = 0; kk < kChunk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            a;
        wmma::load_matrix_sync(a, prod + 16 * rt * L.ld_prod + kk, L.ld_prod);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (ct + j < m1_tiles) {
            wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                           wmma::row_major>
                b;
            wmma::load_matrix_sync(b, w1_tile + kk * L.ld_w1 + 16 * (ct + j),
                                   L.ld_w1);
            wmma::mma_sync(x1_frag[j], a, b, x1_frag[j]);
          }
        }
      }
    } else {
#pragma unroll
      for (int i = 0; i < kX1Per; ++i) {
        const int v = tid + i * kThreads;
        if (v < R * L.m1_pad) {
          const Scalar* a_row = prod + (v / L.m1_pad) * L.ld_prod;
          const Scalar* b_col = w1_tile + v % L.m1_pad;
          float acc = x1_acc[i];
#pragma unroll 8
          for (int kk = 0; kk < kChunk; ++kk)
            acc = fmaf(to_f32(a_row[kk]), to_f32(b_col[kk * L.ld_w1]), acc);
          x1_acc[i] = acc;
        }
      }
    }
  }
  __syncthreads();  // every read of pre, prod and the W1 tile is done

  // ---- epilogue on the CUDA cores, f32 in shared memory ----
  if constexpr (kTensor) {
    const int rt = warp % 4, ct = 4 * (warp / 4);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (ct + j < m1_tiles)
        wmma::store_matrix_sync(x1 + 16 * rt * L.ld_x1 + 16 * (ct + j),
                                x1_frag[j], L.ld_x1, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < kX1Per; ++i) {
      const int v = tid + i * kThreads;
      if (v < R * L.m1_pad) x1[(v / L.m1_pad) * L.ld_x1 + v % L.m1_pad] = x1_acc[i];
    }
  }
  __syncthreads();
  for (int v = tid; v < R * M1; v += kThreads) {
    float* x = x1 + (v / M1) * L.ld_x1 + v % M1;
    *x = round_to<Scalar>(leaky(*x + to_f32(b1[v % M1]), alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * M2; v += kThreads) {
    const int r = v / M2, m = v % M2;
    const float* x_row = x1 + r * L.ld_x1;
    float acc = 0.f;
    for (int j = 0; j < M1; ++j) acc = fmaf(x_row[j], to_f32(w2[j * M2 + m]), acc);
    x2[v] = round_to<Scalar>(leaky(acc + to_f32(b2[m]), alpha));
  }
  __syncthreads();
  for (int v = tid; v < R * M3; v += kThreads) {
    const int r = v / M3, m = v % M3;
    const float* x_row = x2 + r * M2;
    float acc = 0.f;
    for (int j = 0; j < M2; ++j) acc = fmaf(x_row[j], to_f32(w3[j * M3 + m]), acc);
    x3[v] = round_to<Scalar>(leaky(acc + to_f32(b3[m]), alpha)) * to_f32(w4[m]);
  }
  __syncthreads();
  for (int r = tid; r < R; r += kThreads) {
    const long long row = row0 + r;
    if (row < p.n_rows) {
      float s = 0.f;
      for (int m = 0; m < M3; ++m) s += x3[r * M3 + m];
      p.out[row] = s;
    }
  }
}

template <typename Scalar>
cudaError_t launch_typed(const Params& p, cudaStream_t stream) {
  const Layout<Scalar> layout(p.c, p.m1, p.m2, p.m3);
  if (layout.bytes > (size_t)kSmemLimit) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      cand_score_fwd_kernel<Scalar>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)layout.bytes);
  if (err != cudaSuccess) return err;
  constexpr int R = Traits<Scalar>::kRows;
  const long long blocks = (p.n_rows + R - 1) / R;
  cand_score_fwd_kernel<Scalar>
      <<<(unsigned)blocks, kThreads, layout.bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (every operand has it; the scores
// are float32).  Shapes: i_rows [n_rows, c] with n_rows = BT * k; u and pred
// [BT, c]; car_w [c, c]; car_b [c]; w1 [c, m1] (m1 <= 128); b1 [m1];
// w2 [m1, m2]; b2 [m2]; w3 [m2, m3]; b3 [m3]; w4 [m3]; out [n_rows];
// nc null, or [n_rows, c] in the operands' dtype (the training stash).
// Every pointer is 16-byte aligned and every array contiguous.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs on `stream` and
// is not waited for.
extern "C" int cand_score_fwd(const void* i_rows, const void* u,
                              const void* pred, const void* car_w,
                              const void* car_b, const void* w1,
                              const void* b1, const void* w2, const void* b2,
                              const void* w3, const void* b3, const void* w4,
                              void* out, void* nc, long long n_rows, int k,
                              int c,
                              int m1, int m2, int m3, int dtype, float alpha,
                              void* stream) {
  if (n_rows <= 0 || k <= 0 || n_rows % k != 0 || c <= 0 || m1 <= 0 ||
      m1 > kMaxM1 || m2 <= 0 || m3 <= 0)
    return cudaErrorInvalidValue;
  if ((n_rows + 15) / 16 > 0x7fffffffLL) return cudaErrorInvalidValue;
  const Params p{i_rows, u, pred, car_w, car_b, w1, b1, w2, b2, w3, b3, w4,
                 static_cast<float*>(out), nc, n_rows, k, c, m1, m2, m3,
                 alpha};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_typed<float>(p, s);
  if (dtype == 1) return launch_typed<__nv_bfloat16>(p, s);
  return cudaErrorInvalidValue;
}
