// UGRNN backward (BPTT) for Hopper (sm_90a), zero initial state.
//
// Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::
// _bwd_kernel (launched by _bwd_vjp).  Given the forward's f32 states hs
// [B, T, U] and the output cotangent g_out [B, T, U], per batch row and step
// t = T-1 .. 0, with h_prev = hs[t-1] (0 at t = 0):
//     a      = x_proj[t] + h_prev . W_hh            (the gates, recomputed)
//     g, c   = sigmoid(a_g + forget_bias), tanh(a_c)
//     dh     = dh_carry + g_out[t];   m = mask[t];   dh_m = m * dh
//     da_g   = dh_m (h_prev - c) g (1 - g);   da_c = dh_m (1 - g)(1 - c^2)
//     dx_proj[t] = [da_g | da_c]
//     dh_carry = dh_m g + da . W_hh^T + dh (1 - m)  (a padded step copies dh)
// and dW_hh = sum over (b, t) of h_prev^T . da.  Everything runs in f32, as
// in the Pallas kernel; dx_proj is written in x_proj's dtype and dW_hh in
// W_hh's.
//
// What bounds it: like the forward, a chain of T dependent steps (19 at G1),
// each two [rows, U] x [U, 2U]-sized products (the gate recompute and the
// carry).  At the G1 train batch (256 rows, U 255) that is about 2.5 GFLOP of
// f32 arithmetic for the chain and 1.3 GFLOP for dW_hh: microseconds at the
// card's rate, so the serial chain's latency bounds it, not bytes or
// operations.
//
// What the design does about it.  Launch 1 (the chain): as in the forward,
// one block owns kRows batch rows for the whole sequence, one thread per
// hidden unit, so dh_carry stays in registers; h_prev and da pass through
// shared memory with two barriers a step.  W_hh (and its transpose, which the
// wrapper lays out so that the carry's loads are coalesced) are read from L2.
// The Pallas kernel accumulates dW_hh across batch tiles in one output block,
// which needs its sequential grid.  Here launch 1 writes da in f32 and launch
// 2 forms dW_hh = sum h_prev^T . da over all B*T rows: one block per 32 x 32
// tile of dW_hh, a fixed-order loop over the rows, so the result does not
// depend on scheduling.

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

constexpr int kRows = 2;   // batch rows per block of the chain
constexpr int kTile = 32;  // dW_hh tile edge

// x: [B, T, 2U], w: [U, 2U], w_t: [2U, U] (w transposed), mask: [B, T],
// hs: [B, T, U] f32, g_out: [B, T, U]; da: [B, T, 2U] f32; dx: [B, T, 2U]
// in Scalar, or the same memory as da when Scalar is float.
// Block: one thread per hidden unit.  Dynamic shared memory:
// kRows * 3U floats (h_prev [kRows][U], da [kRows][2U]).
template <typename Scalar>
__global__ void ugrnn_bwd_chain_kernel(
    const Scalar* __restrict__ x, const Scalar* __restrict__ w,
    const Scalar* __restrict__ w_t, const uint8_t* __restrict__ mask,
    const float* __restrict__ hs, const Scalar* __restrict__ g_out,
    float* da, Scalar* dx, int B, int T, int U, float forget_bias) {
  extern __shared__ float smem[];
  float* h_prev = smem;           // [kRows][U]
  float* da_s = smem + kRows * U;  // [kRows][2U]
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int two_u = 2 * U;
  const bool write_dx = static_cast<void*>(dx) != static_cast<void*>(da);

  float dh_carry[kRows], dh_keep[kRows], dh_m_keep[kRows], g_keep[kRows],
      m_keep[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh_carry[r] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    if (j < U) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        h_prev[r * U + j] =
            (b < B && t > 0) ? hs[((size_t)b * T + t - 1) * U + j] : 0.f;
      }
    }
    __syncthreads();  // h_prev complete; the last step's reads of da_s done

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
          const float hk = h_prev[r * U + k];
          acc_g[r] = fmaf(hk, wg, acc_g[r]);
          acc_c[r] = fmaf(hk, wc, acc_c[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        float da_g = 0.f, da_c = 0.f;
        dh_keep[r] = dh_m_keep[r] = g_keep[r] = m_keep[r] = 0.f;
        if (b < B) {
          const size_t bt = (size_t)b * T + t;
          const float a_g = to_f32(x[bt * two_u + j]) + acc_g[r];
          const float a_c = to_f32(x[bt * two_u + U + j]) + acc_c[r];
          const float g = 1.f / (1.f + expf(-(a_g + forget_bias)));
          const float c = tanhf(a_c);
          const float dh = dh_carry[r] + to_f32(g_out[bt * U + j]);
          const float m = mask[bt] ? 1.f : 0.f;
          const float dh_m = dh * m;
          const float dg = dh_m * (h_prev[r * U + j] - c);
          const float dc = dh_m * (1.f - g);
          da_g = dg * g * (1.f - g);
          da_c = dc * (1.f - c * c);
          da[bt * two_u + j] = da_g;
          da[bt * two_u + U + j] = da_c;
          if (write_dx) {
            dx[bt * two_u + j] = from_f32<Scalar>(da_g);
            dx[bt * two_u + U + j] = from_f32<Scalar>(da_c);
          }
          dh_keep[r] = dh;
          dh_m_keep[r] = dh_m;
          g_keep[r] = g;
          m_keep[r] = m;
        }
        da_s[r * two_u + j] = da_g;
        da_s[r * two_u + U + j] = da_c;
      }
    }
    __syncthreads();  // da_s complete; every read of h_prev done

    if (j < U) {
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
      const Scalar* wt_col = w_t + j;
#pragma unroll 4
      for (int n = 0; n < two_u; ++n) {
        const float wv = to_f32(wt_col[(size_t)n * U]);
#pragma unroll
        for (int r = 0; r < kRows; ++r)
          acc[r] = fmaf(da_s[r * two_u + n], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dh_carry[r] = dh_m_keep[r] * g_keep[r] + acc[r] +
                      dh_keep[r] * (1.f - m_keep[r]);
    }
  }
}

// dw[k, n] = sum over rows (b, t) of h_prev(b, t)[k] * da(b, t)[n], with
// h_prev(b, t) = hs[b, t - 1] (0 at t = 0).  One block per kTile x kTile
// tile of dw; the rows are summed in a fixed order.
template <typename Scalar>
__global__ void ugrnn_bwd_dw_kernel(const float* __restrict__ hs,
                                    const float* __restrict__ da,
                                    Scalar* __restrict__ dw, int B, int T,
                                    int U) {
  __shared__ float h_tile[kTile][kTile + 1];
  __shared__ float d_tile[kTile][kTile + 1];
  const int two_u = 2 * U;
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int tx = threadIdx.x % kTile, ty = threadIdx.x / kTile;  // ty < 8
  const long long rows = (long long)B * T;
  float acc[kTile / 8];
#pragma unroll
  for (int q = 0; q < kTile / 8; ++q) acc[q] = 0.f;

  for (long long r0 = 0; r0 < rows; r0 += kTile) {
#pragma unroll
    for (int q = 0; q < kTile / 8; ++q) {
      const int rr = ty + 8 * q;
      const long long row = r0 + rr;
      float hv = 0.f, dv = 0.f;
      if (row < rows) {
        const int t = (int)(row % T);
        if (t > 0 && k0 + tx < U) hv = hs[(row - 1) * U + k0 + tx];
        if (n0 + tx < two_u) dv = da[row * two_u + n0 + tx];
      }
      h_tile[rr][tx] = hv;
      d_tile[rr][tx] = dv;
    }
    __syncthreads();
#pragma unroll 8
    for (int rr = 0; rr < kTile; ++rr) {
      const float dv = d_tile[rr][tx];
#pragma unroll
      for (int q = 0; q < kTile / 8; ++q)
        acc[q] = fmaf(h_tile[rr][ty + 8 * q], dv, acc[q]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int q = 0; q < kTile / 8; ++q) {
    const int k = k0 + ty + 8 * q, n = n0 + tx;
    if (k < U && n < two_u) dw[(size_t)k * two_u + n] = from_f32<Scalar>(acc[q]);
  }
}

template <typename Scalar>
cudaError_t launch_typed(const void* x, const void* w, const void* w_t,
                         const void* mask, const float* hs, const void* g_out,
                         float* da, void* dx, void* dw, int B, int T, int U,
                         float forget_bias, cudaStream_t stream) {
  const int threads = ((U + 31) / 32) * 32;
  const int blocks = (B + kRows - 1) / kRows;
  const size_t smem = 3u * kRows * U * sizeof(float);  // <= 24 KB at U <= 1024
  ugrnn_bwd_chain_kernel<Scalar><<<blocks, threads, smem, stream>>>(
      static_cast<const Scalar*>(x), static_cast<const Scalar*>(w),
      static_cast<const Scalar*>(w_t), static_cast<const uint8_t*>(mask), hs,
      static_cast<const Scalar*>(g_out), da, static_cast<Scalar*>(dx), B, T,
      U, forget_bias);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid((2 * U + kTile - 1) / kTile, (U + kTile - 1) / kTile);
  ugrnn_bwd_dw_kernel<Scalar><<<grid, 256, 0, stream>>>(
      hs, da, static_cast<Scalar*>(dw), B, T, U);
  return cudaGetLastError();
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x_proj, W_hh, its transpose w_t,
// g_out, dx and dw share it).  hs and da are float32; da [B, T, 2U] is
// scratch the caller allocates, and with float32 dx may be the same memory.
// Returns the cudaError_t of the launches (0 on success); the kernels run on
// `stream` and are not waited for.
extern "C" int ugrnn_bwd(const void* x_proj, const void* w_hh, const void* w_t,
                         const void* mask, const void* hs, const void* g_out,
                         void* da, void* dx, void* dw, int B, int T, int U,
                         int dtype, float forget_bias, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || U > 1024) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hs);
  float* d = static_cast<float*>(da);
  if (dtype == 0)
    return launch_typed<float>(x_proj, w_hh, w_t, mask, h, g_out, d, dx, dw, B,
                               T, U, forget_bias, s);
  if (dtype == 1)
    return launch_typed<__nv_bfloat16>(x_proj, w_hh, w_t, mask, h, g_out, d,
                                       dx, dw, B, T, U, forget_bias, s);
  return cudaErrorInvalidValue;
}
