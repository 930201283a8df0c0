// UGRNN forward scan for Hopper (sm_90a), zero initial state.
//
// Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::
// _fwd_kernel (launched by _fwd_impl).  Per step t and batch row b:
//     a   = x_proj[b, t] + h[b] . W_hh            (a = [a_g | a_c], 2U wide)
//     g   = sigmoid(a_g + forget_bias)
//     c   = tanh(a_c)
//     h'  = mask[b, t] ? g * h + (1 - g) * c : h  (copy-through when masked)
//     out[b, t] = h'
// x_proj and W_hh are read in their dtype (bf16 or f32, the same for both)
// and widened to f32; h and all gate math stay f32 for the whole sequence;
// the output is written in that dtype.  These are the Pallas kernel's
// numerics.  In training a non-null `hs32` also receives every state in f32
// [B, T, U]: the residual from which the backward kernel (ugrnn_bwd.cu)
// recomputes the gates, as the Pallas VJP keeps its f32 padded output.
//
// What bounds it: the recurrence is 19 dependent steps (G1 sessions), each a
// [rows, U] x [U, 2U] product that needs the previous step's h.  At serving
// batches the work is a few hundred MFLOP, microseconds at the card's f32
// rate, so the kernel is bound by the latency of the serial chain, not by
// bytes or operations.
//
// What the design does about it: one block owns a tile of kRows batch rows
// for the whole sequence, so h never leaves the SM.  h lives in shared memory
// as f32, double-buffered, which needs one __syncthreads() per step.  Thread j
// computes both a_g[:, j] and a_c[:, j], so the gate math is local to the
// thread.  W_hh (255 x 510 at G1: 260 KB in bf16) does not fit a block's
// 227 KB of shared memory; it is read from global memory with coalesced
// loads and stays resident in L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// Batch rows per block.  A larger tile shares each W_hh load among more rows
// but lengthens the block's chain and leaves SMs idle at small batches; of
// 1, 2, 4 and 8, two ran fastest on an H100 at the G1 serving shapes.
constexpr int kRows = 2;

// x: [B, T, 2U], w: [U, 2U], mask: [B, T] (1 byte each), out: [B, T, U].
// Block: one thread per hidden unit (blockDim.x >= U), kRows batch rows.
// Dynamic shared memory: 2 * kRows * U floats (h, double-buffered).
template <typename Scalar>
__global__ void ugrnn_fwd_kernel(const Scalar* __restrict__ x,
                                 const Scalar* __restrict__ w,
                                 const uint8_t* __restrict__ mask,
                                 Scalar* __restrict__ out,
                                 float* __restrict__ hs32, int B, int T,
                                 int U, float forget_bias) {
  extern __shared__ float h_smem[];
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int two_u = 2 * U;

  for (int i = threadIdx.x; i < 2 * kRows * U; i += blockDim.x) h_smem[i] = 0.f;
  __syncthreads();

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* h = h_smem + cur * kRows * U;
    float* h_next = h_smem + (cur ^ 1) * kRows * U;
    if (j < U) {
      float acc_g[kRows], acc_c[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        acc_g[r] = 0.f;
        acc_c[r] = 0.f;
      }
      const Scalar* w_col = w + j;
#pragma unroll 4
      for (int k = 0; k < U; ++k) {
        const float wg = to_f32(w_col[(size_t)k * two_u]);
        const float wc = to_f32(w_col[(size_t)k * two_u + U]);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float hk = h[r * U + k];  // same address across the warp
          acc_g[r] = fmaf(hk, wg, acc_g[r]);
          acc_c[r] = fmaf(hk, wc, acc_c[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        if (b >= B) break;
        const size_t bt = (size_t)b * T + t;
        const float h_prev = h[r * U + j];
        float h_new = h_prev;
        if (mask[bt]) {
          const float a_g = to_f32(x[bt * two_u + j]) + acc_g[r];
          const float a_c = to_f32(x[bt * two_u + U + j]) + acc_c[r];
          const float g = 1.f / (1.f + expf(-(a_g + forget_bias)));
          const float c = tanhf(a_c);
          h_new = g * h_prev + (1.f - g) * c;
        }
        h_next[r * U + j] = h_new;
        out[bt * U + j] = from_f32<Scalar>(h_new);
        if (hs32 != nullptr) hs32[bt * U + j] = h_new;
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

template <typename Scalar>
cudaError_t launch_typed(const void* x, const void* w, const void* mask,
                         void* out, float* hs32, int B, int T, int U,
                         float forget_bias, cudaStream_t stream) {
  const int threads = ((U + 31) / 32) * 32;
  const int blocks = (B + kRows - 1) / kRows;
  const size_t smem = 2u * kRows * U * sizeof(float);  // <= 16 KB at U <= 1024
  ugrnn_fwd_kernel<Scalar><<<blocks, threads, smem, stream>>>(
      static_cast<const Scalar*>(x), static_cast<const Scalar*>(w),
      static_cast<const uint8_t*>(mask), static_cast<Scalar*>(out), hs32, B, T,
      U, forget_bias);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x_proj, W_hh and the output share
// it); hs32 is null or a float32 [B, T, U] copy of the states.  Returns the
// cudaError_t of the launch (0 on success); the kernel runs
// on `stream` and is not waited for.
extern "C" int ugrnn_fwd(const void* x_proj, const void* w_hh,
                         const void* mask, void* out, void* hs32, int B,
                         int T, int U, int dtype, float forget_bias,
                         void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || U > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_typed<float>(x_proj, w_hh, mask, out,
                               static_cast<float*>(hs32), B, T, U,
                               forget_bias, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x_proj, w_hh, mask, out,
                                       static_cast<float*>(hs32), B, T, U,
                                       forget_bias, s);
  return cudaErrorInvalidValue;
}
