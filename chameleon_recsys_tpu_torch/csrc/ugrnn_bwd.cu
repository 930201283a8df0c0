// UGRNN backward (BPTT) for Hopper (sm_90a), zero initial state.
//
// Replaces the TPU kernel chameleon_recsys_tpu/ops/pallas/ugrnn_pallas.py::
// _bwd_kernel (launched by _bwd_vjp).  Given the forward's f32 states hs
// [B, T, U], its f32 pre-activations acts [B, T, 2U] (the stash the forward
// kernel writes in training: acts = x_proj + h_prev . W_hh, the values the
// Pallas kernel recomputes) and the output cotangent g_out [B, T, U], per
// batch row and step t = T-1 .. 0, with h_prev = hs[t-1] (0 at t = 0):
//     g, c   = sigmoid(acts_g + forget_bias), tanh(acts_c)
//     dh     = dh_carry + g_out[t];   m = mask[t];   dh_m = m * dh
//     da_g   = dh_m (h_prev - c) g (1 - g);   da_c = dh_m (1 - g)(1 - c^2)
//     dx_proj[t] = [da_g | da_c]
//     dh_carry = dh_m g + da . W_hh^T + dh (1 - m)  (a padded step copies dh)
// and dW_hh = sum over (b, t) of h_prev^T . da.  Everything runs in f32, as
// in the Pallas kernel; dx_proj is written in x_proj's dtype and dW_hh in
// W_hh's.
//
// What bounds it: the chain of T dependent steps (19 at G1), each one
// [rows, 2U] x [2U, U] product (the carry), plus dW_hh, a [U, B T] x
// [B T, 2U] product of depth 4,864 at G1 (1.27 GFLOP of f32, ~19 us at the
// card's f32 rate).  The chain is latency-bound; dW_hh, done apart, is bound
// by its operations.
//
// What the design does about it.  The gate recompute (h_prev . W_hh, the
// other W-sized product of a step) does not depend on the carried dh, so it
// leaves the chain: the backward reads the forward's stash.  Launch 1, the
// chain (resident, for every U whose layout fits a cluster of at most 8
// CTAs; ugrnn_common.cuh): as in the forward, a cluster of n CTAs owns R
// batch rows and CTA q owns a slice of the hidden units, here with the W_hh
// ROWS of its units resident in shared memory as (W[j, k], W[j, U + k])
// pairs.  A step computes da of the own units from local values (stash,
// state, cotangent, mask, the carried dh in registers), writes that slice
// of da into every CTA's da buffer over distributed shared memory, runs one
// cluster barrier, and forms its units' carry from the full da.  da is
// double-buffered (one barrier a step), and the next step's inputs are
// fetched during the carry product.  Wider U takes the streaming chain: one
// block per 2 rows, W_hh^T read from L2, one __syncthreads a step.  Launch
// 2, dW_hh over all B T rows at once: 64 x 64 output tiles times a split of
// the rows that fills the card, f32 FMA (the Pallas kernel forms dW from f32
// hs and da), each split writing f32 partials; launch 3 sums the partials
// in split order into W_hh's dtype.  No float atomics: two launches give the
// same bits.

#include <map>
#include <mutex>
#include <tuple>

#include "ugrnn_common.cuh"

namespace {

namespace cg = cooperative_groups;
using ugrnn::from_f32;
using ugrnn::Layout;
using ugrnn::to_f32;

template <typename Scalar, int R>
__global__ void __launch_bounds__(ugrnn::kMaxThreads)
    ugrnn_bwd_resident_kernel(const Scalar* __restrict__ w,
                              const uint8_t* __restrict__ mask,
                              const float* __restrict__ hs,
                              const Scalar* __restrict__ g_out,
                              const float* __restrict__ acts, float* da,
                              Scalar* dx, int B, int T, int U,
                              float forget_bias, Layout L) {
  using P = ugrnn::PairOf<Scalar>;
  using Pair = typename P::type;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int uq = L.uq, ws = L.ws, kc = L.kc, kpad = L.kpad;
  const int ksplit = L.ksplit;
  Pair* wsm = reinterpret_cast<Pair*>(smem);  // [kpad][ws]
  // [2 buffers][da_g, da_c][R][kpad]
  float* dbuf = reinterpret_cast<float*>(smem + (size_t)kpad * ws * sizeof(Pair));
  float* red = dbuf + 4 * R * kpad;  // [ksplit][R][uq]
  const int q = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / L.n) * R;
  const int u0 = q * uq;
  const int own = min(uq, U - u0);
  const int ks = threadIdx.x / uq, u = threadIdx.x % uq;
  const int j = u0 + u;
  const bool unit = u < own;
  const int two_u = 2 * U;
  const int nthreads = blockDim.x;
  const bool write_dx = static_cast<void*>(dx) != static_cast<void*>(da);

  // the rows of the own units as (W[j, k], W[j, U + k]) pairs: zero every
  // slot (the depths past U and the units past `own` stay 0), then run uu
  // of gate g is W[u0 + uu, gate U ...), landing in pair column uu.  Loads
  // run along a row (coalesced); the odd stride ws keeps the transposing
  // stores free of bank conflicts.
  uint4* zero = reinterpret_cast<uint4*>(smem);
  const int words16 = (int)((size_t)kpad * ws * sizeof(Pair) / 16);
  for (int i = threadIdx.x; i < words16; i += nthreads) zero[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 4 * R * kpad; i += nthreads) dbuf[i] = 0.f;
  __syncthreads();
  ugrnn::load_pairs(
      w, own, U, [&](int uu, int gate) { return (u0 + uu) * two_u + gate * U; },
      [&](int uu, int k) { return k * ws + uu; }, wsm);
  cluster.sync();  // every CTA's buffers are zero before any remote write

  // the inputs of this thread's gate rows r = ks + i ksplit (i <
  // kGateRows), fetched a step ahead
  constexpr int kG = ugrnn::kGateRows;
  auto fetch = [&](int t, float* go_, float* ag_, float* ac_, float* hp_,
                   bool* mk_) {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int r = ks + i * ksplit, b = row0 + r;
      const bool mine = unit && r < R && b < B && t >= 0;
      const size_t bt = (size_t)b * T + t;
      go_[i] = mine ? to_f32(g_out[bt * U + j]) : 0.f;
      ag_[i] = mine ? acts[bt * two_u + j] : 0.f;
      ac_[i] = mine ? acts[bt * two_u + U + j] : 0.f;
      hp_[i] = mine && t > 0 ? hs[(bt - 1) * U + j] : 0.f;
      mk_[i] = mine && mask[bt];
    }
  };
  float go[kG], ag[kG], ac[kG], hp[kG];
  bool mk[kG];
  fetch(T - 1, go, ag, ac, hp, mk);

  float dh_carry[kG];
#pragma unroll
  for (int i = 0; i < kG; ++i) dh_carry[i] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    float* d_g = dbuf + (t & 1) * 2 * R * kpad;
    float* d_c = d_g + R * kpad;
    float dh_k[kG], dhg_k[kG], m_k[kG];
#pragma unroll
    for (int i = 0; i < kG; ++i) dh_k[i] = dhg_k[i] = m_k[i] = 0.f;
    if (unit) {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int r = ks + i * ksplit, b = row0 + r;
        if (r >= R || b >= B) continue;
        const size_t bt = (size_t)b * T + t;
        const float g = 1.f / (1.f + expf(-(ag[i] + forget_bias)));
        const float c = tanhf(ac[i]);
        const float dh = dh_carry[i] + go[i];
        const float m = mk[i] ? 1.f : 0.f;
        const float dh_m = dh * m;
        const float dg = dh_m * (hp[i] - c);
        const float dc = dh_m * (1.f - g);
        const float da_g = dg * g * (1.f - g);
        const float da_c = dc * (1.f - c * c);
        da[bt * two_u + j] = da_g;
        da[bt * two_u + U + j] = da_c;
        if (write_dx) {
          dx[bt * two_u + j] = from_f32<Scalar>(da_g);
          dx[bt * two_u + U + j] = from_f32<Scalar>(da_c);
        }
        for (int d = 0; d < L.n; ++d) {
          cluster.map_shared_rank(d_g, d)[r * kpad + j] = da_g;
          cluster.map_shared_rank(d_c, d)[r * kpad + j] = da_c;
        }
        dh_k[i] = dh;
        dhg_k[i] = dh_m * g;
        m_k[i] = m;
      }
    }
    cluster.sync();  // da complete in every CTA

    fetch(t - 1, go, ag, ac, hp, mk);  // in flight during the carry product
    // two sums a row (the g and the c half of da), for two dependence chains
    float acc_g[R], acc_c[R];
#pragma unroll
    for (int r = 0; r < R; ++r) acc_g[r] = acc_c[r] = 0.f;
    if (unit) {
      const int k0 = ks * kc;
      const Pair* wp = wsm + (size_t)k0 * ws + u;
#pragma unroll 2
      for (int kk = 0; kk < kc; kk += 4, wp += 4 * ws) {
        const float2 w0 = P::widen(wp[0]), w1 = P::widen(wp[ws]);
        const float2 w2 = P::widen(wp[2 * ws]), w3 = P::widen(wp[3 * ws]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 vg =
              *reinterpret_cast<const float4*>(d_g + r * kpad + k0 + kk);
          const float4 vc =
              *reinterpret_cast<const float4*>(d_c + r * kpad + k0 + kk);
          acc_g[r] = fmaf(vg.x, w0.x, acc_g[r]);
          acc_c[r] = fmaf(vc.x, w0.y, acc_c[r]);
          acc_g[r] = fmaf(vg.y, w1.x, acc_g[r]);
          acc_c[r] = fmaf(vc.y, w1.y, acc_c[r]);
          acc_g[r] = fmaf(vg.z, w2.x, acc_g[r]);
          acc_c[r] = fmaf(vc.z, w2.y, acc_c[r]);
          acc_g[r] = fmaf(vg.w, w3.x, acc_g[r]);
          acc_c[r] = fmaf(vc.w, w3.y, acc_c[r]);
        }
      }
    }
    if (ksplit > 1) {
      if (unit) {
#pragma unroll
        for (int r = 0; r < R; ++r) red[(ks * R + r) * uq + u] = acc_g[r] + acc_c[r];
      }
      __syncthreads();
    }
    if (unit) {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int r = ks + i * ksplit;
        if (r >= R || row0 + r >= B) continue;
        float s = 0.f;
        if (ksplit > 1) {
          for (int p = 0; p < ksplit; ++p) s += red[(p * R + r) * uq + u];
        } else {
#pragma unroll
          for (int rr = 0; rr < R; ++rr)  // r == i: a register, not memory
            if (rr == r) s = acc_g[rr] + acc_c[rr];
        }
        dh_carry[i] = dhg_k[i] + s + dh_k[i] * (1.f - m_k[i]);
      }
    }
  }
  // the last remote write (step 0's da) precedes step 0's cluster barrier,
  // so a CTA may leave here while the others finish their carry
}

// The streaming chain (U past the resident layout): one block per kRows
// batch rows, one thread per hidden unit, da double-buffered in shared
// memory (one barrier a step), W_hh^T (w_t [2U, U], coalesced along the
// units) read from L2.  Dynamic shared memory: 2 * kRows * 2U floats.
constexpr int kRows = 2;

template <typename Scalar>
__global__ void ugrnn_bwd_stream_kernel(const Scalar* __restrict__ w_t,
                                        const uint8_t* __restrict__ mask,
                                        const float* __restrict__ hs,
                                        const Scalar* __restrict__ g_out,
                                        const float* __restrict__ acts,
                                        float* da, Scalar* dx, int B, int T,
                                        int U, float forget_bias) {
  extern __shared__ float da_s[];  // [2][kRows][2U]
  const int j = threadIdx.x;
  const int row0 = blockIdx.x * kRows;
  const int two_u = 2 * U;
  const bool write_dx = static_cast<void*>(dx) != static_cast<void*>(da);

  float dh_carry[kRows], dh_keep[kRows], dh_m_keep[kRows], g_keep[kRows],
      m_keep[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) dh_carry[r] = 0.f;

  for (int t = T - 1; t >= 0; --t) {
    float* ds = da_s + (t & 1) * kRows * two_u;
    if (j < U) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int b = row0 + r;
        float da_g = 0.f, da_c = 0.f;
        dh_keep[r] = dh_m_keep[r] = g_keep[r] = m_keep[r] = 0.f;
        if (b < B) {
          const size_t bt = (size_t)b * T + t;
          const float g = 1.f / (1.f + expf(-(acts[bt * two_u + j] + forget_bias)));
          const float c = tanhf(acts[bt * two_u + U + j]);
          const float h_prev = t > 0 ? hs[(bt - 1) * U + j] : 0.f;
          const float dh = dh_carry[r] + to_f32(g_out[bt * U + j]);
          const float m = mask[bt] ? 1.f : 0.f;
          const float dh_m = dh * m;
          const float dg = dh_m * (h_prev - c);
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
        ds[r * two_u + j] = da_g;
        ds[r * two_u + U + j] = da_c;
      }
    }
    __syncthreads();  // this step's da complete

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
          acc[r] = fmaf(ds[r * two_u + n], wv, acc[r]);
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        dh_carry[r] = dh_m_keep[r] * g_keep[r] + acc[r] +
                      dh_keep[r] * (1.f - m_keep[r]);
    }
  }
}

// dW_hh partials: part[s][k][n] = sum over the rows (b, t) of split s of
// h_prev(b, t)[k] * da(b, t)[n], h_prev(b, t) = hs[b, t - 1] (0 at t = 0).
// A block owns a kTile x kTile output tile of one split; 256 threads, 4 x 4
// outputs each; the rows pass through shared memory kDepth at a time, the
// next chunk fetched into registers while the current one is summed.  Row
// indices are 32-bit (B T < 2^31).
constexpr int kTile = 64;
constexpr int kDepth = 32;

__global__ void __launch_bounds__(256)
    ugrnn_bwd_dw_partial_kernel(const float* __restrict__ hs,
                                const float* __restrict__ da,
                                float* __restrict__ part, int B, int T, int U,
                                int chunk) {
  __shared__ __align__(16) float a_s[2][kDepth][kTile];
  __shared__ __align__(16) float b_s[2][kDepth][kTile];
  const int two_u = 2 * U;
  const int k0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;
  const int rows = B * T;
  const int r_begin = blockIdx.z * chunk;
  const int r_end = min(rows, r_begin + chunk);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) acc[i][jj] = 0.f;

  constexpr int kLoads = kDepth * kTile / 256;  // per thread and operand
  float ra[kLoads], rb[kLoads];
  // load i of this thread reads row r0 + rr(i), rr(i) = threadIdx.x / kTile +
  // 4 i, column c; tmod[i] tracks that row's step t = row % T, advanced by
  // kDepth % T a chunk (no division in the loop)
  const int c = threadIdx.x % kTile;
  const int step = kDepth % T;
  int tmod[kLoads];
#pragma unroll
  for (int i = 0; i < kLoads; ++i) tmod[i] = (r_begin + threadIdx.x / kTile + 4 * i) % T;
  auto fetch = [&](int r0) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int row = r0 + threadIdx.x / kTile + 4 * i;
      const bool in = row < r_end;
      ra[i] = in && tmod[i] != 0 && k0 + c < U ? hs[(size_t)(row - 1) * U + k0 + c]
                                                : 0.f;
      rb[i] = in && n0 + c < two_u ? da[(size_t)row * two_u + n0 + c] : 0.f;
      tmod[i] += step;
      if (tmod[i] >= T) tmod[i] -= T;
    }
  };
  auto stash = [&](int st) {
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = threadIdx.x + 256 * i;
      a_s[st][e / kTile][e % kTile] = ra[i];
      b_s[st][e / kTile][e % kTile] = rb[i];
    }
  };
  fetch(r_begin);
  stash(0);
  __syncthreads();
  int st = 0;
  for (int r0 = r_begin; r0 < r_end; r0 += kDepth) {
    const bool more = r0 + kDepth < r_end;
    if (more) fetch(r0 + kDepth);
#pragma unroll
    for (int rr = 0; rr < kDepth; ++rr) {
      const float4 a4 = *reinterpret_cast<const float4*>(&a_s[st][rr][ty * 4]);
      const float4 b4 = *reinterpret_cast<const float4*>(&b_s[st][rr][tx * 4]);
      const float av[4] = {a4.x, a4.y, a4.z, a4.w};
      const float bv[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) acc[i][jj] = fmaf(av[i], bv[jj], acc[i][jj]);
    }
    if (more) stash(st ^ 1);
    __syncthreads();
    st ^= 1;
  }
  float* out = part + (size_t)blockIdx.z * U * two_u;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int k = k0 + ty * 4 + i;
    if (k >= U) continue;
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = n0 + tx * 4 + jj;
      if (n < two_u) out[(size_t)k * two_u + n] = acc[i][jj];
    }
  }
}

// dw[i] = sum over s in order of part[s][i], rounded once to W_hh's dtype.
template <typename Scalar>
__global__ void ugrnn_bwd_dw_sum_kernel(const float* __restrict__ part,
                                        Scalar* __restrict__ dw, int splits,
                                        int size) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= size) return;
  float s = 0.f;
  for (int p = 0; p < splits; ++p) s += part[(size_t)p * size + i];
  dw[i] = from_f32<Scalar>(s);
}

// Row splits of dW_hh: as many as keep every block in one wave of three
// blocks an SM over the card's SMs (a second, partial wave would double the
// time), each split at least kDepth rows.  (chunk, splits)
void dw_splits(int B, int T, int U, int* chunk, int* splits) {
  const int rows = B * T;
  const int tiles = ugrnn::ceil_div(U, kTile) * ugrnn::ceil_div(2 * U, kTile);
  int s = 3 * ugrnn::sm_count() / tiles;
  const int most = ugrnn::ceil_div(rows, kDepth);
  if (s > most) s = most;
  if (s < 1) s = 1;
  *chunk = ugrnn::ceil_div(ugrnn::ceil_div(rows, s), kDepth) * kDepth;
  *splits = ugrnn::ceil_div(rows, *chunk);
}

// Clusters of a resident chain layout the card holds at once, per (dtype,
// R, n, U); cached, since the occupancy query costs host time.
template <typename Scalar>
int bwd_max_clusters(const Layout& L, int U) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int>, int> cache;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(L.rows, L.n, U);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int c = 0;
  switch (L.rows) {
    case 1: c = ugrnn::max_active_clusters(ugrnn_bwd_resident_kernel<Scalar, 1>, L); break;
    case 2: c = ugrnn::max_active_clusters(ugrnn_bwd_resident_kernel<Scalar, 2>, L); break;
    case 4: c = ugrnn::max_active_clusters(ugrnn_bwd_resident_kernel<Scalar, 4>, L); break;
    default: c = ugrnn::max_active_clusters(ugrnn_bwd_resident_kernel<Scalar, 8>, L); break;
  }
  cache[key] = c;
  return c;
}

// The resident chain's layout at batch B (ugrnn::launch_layout), cached
// per (B, U); false where no cluster can be placed.
template <typename Scalar>
bool bwd_layout(int B, int U, Layout* out) {
  static std::mutex lock;
  static std::map<std::pair<int, int>, std::pair<bool, Layout>> cache;
  {
    std::lock_guard<std::mutex> guard(lock);
    const auto hit = cache.find({B, U});
    if (hit != cache.end()) {
      *out = hit->second.second;
      return hit->second.first;
    }
  }
  Layout L = {};
  const bool ok = ugrnn::launch_layout(
      B, U, (int)sizeof(Scalar), true,
      [U](const Layout& l) { return bwd_max_clusters<Scalar>(l, U); }, &L);
  std::lock_guard<std::mutex> guard(lock);
  cache[{B, U}] = {ok, L};
  *out = L;
  return ok;
}

template <typename Scalar>
cudaError_t launch_chain(const void* w, const void* w_t, const void* mask,
                         const float* hs, const void* g_out,
                         const float* acts, float* da, void* dx, int B, int T,
                         int U, float fb, bool resident, cudaStream_t s) {
  const Scalar* go = static_cast<const Scalar*>(g_out);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  Scalar* d = static_cast<Scalar*>(dx);
  if (!resident) {
    const int threads = ((U + 31) / 32) * 32;
    const int blocks = (B + kRows - 1) / kRows;
    const size_t smem = 4u * kRows * U * sizeof(float);  // <= 32 KB at U <= 1024
    ugrnn_bwd_stream_kernel<Scalar><<<blocks, threads, smem, s>>>(
        static_cast<const Scalar*>(w_t), m, hs, go, acts, da, d, B, T, U, fb);
    return cudaGetLastError();
  }
  Layout L;
  const int R = bwd_layout<Scalar>(B, U, &L) ? L.rows : 0;
  const Scalar* ws = static_cast<const Scalar*>(w);
  switch (R) {
    case 1: return ugrnn::launch_clusters(ugrnn_bwd_resident_kernel<Scalar, 1>, L, B, s, ws, m, hs, go, acts, da, d, B, T, U, fb, L);
    case 2: return ugrnn::launch_clusters(ugrnn_bwd_resident_kernel<Scalar, 2>, L, B, s, ws, m, hs, go, acts, da, d, B, T, U, fb, L);
    case 4: return ugrnn::launch_clusters(ugrnn_bwd_resident_kernel<Scalar, 4>, L, B, s, ws, m, hs, go, acts, da, d, B, T, U, fb, L);
    case 8: return ugrnn::launch_clusters(ugrnn_bwd_resident_kernel<Scalar, 8>, L, B, s, ws, m, hs, go, acts, da, d, B, T, U, fb, L);
    default: return cudaErrorInvalidConfiguration;  // no cluster can be placed
  }
}

template <typename Scalar>
cudaError_t launch_typed(const void* w, const void* w_t, const void* mask,
                         const float* hs, const void* g_out,
                         const float* acts, float* da, void* dx, void* dw,
                         float* part, int B, int T, int U, float fb,
                         bool resident, cudaStream_t s) {
  cudaError_t err = launch_chain<Scalar>(w, w_t, mask, hs, g_out, acts, da, dx,
                                         B, T, U, fb, resident, s);
  if (err != cudaSuccess) return err;
  int chunk, splits;
  dw_splits(B, T, U, &chunk, &splits);
  const dim3 grid(ugrnn::ceil_div(2 * U, kTile), ugrnn::ceil_div(U, kTile), splits);
  ugrnn_bwd_dw_partial_kernel<<<grid, 256, 0, s>>>(hs, da, part, B, T, U, chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int size = U * 2 * U;
  ugrnn_bwd_dw_sum_kernel<Scalar><<<ugrnn::ceil_div(size, 256), 256, 0, s>>>(
      part, static_cast<Scalar*>(dw), splits, size);
  return cudaGetLastError();
}

}  // namespace

// Row splits of dW_hh at (B, T, U): the wrapper allocates the f32 partials
// [splits, U, 2U] that ugrnn_bwd sums.
extern "C" int ugrnn_bwd_dw_splits(int B, int T, int U) {
  if (B <= 0 || T <= 0 || U <= 0) return 0;
  int chunk, splits;
  dw_splits(B, T, U, &chunk, &splits);
  return splits;
}

// dtype codes: 0 = float32, 1 = bfloat16 (W_hh, its transpose w_t, g_out,
// dx and dw share it).  hs, acts, da and part are float32; da [B, T, 2U]
// and part [ugrnn_bwd_dw_splits, U, 2U] are scratch the caller allocates,
// and with float32 dx may be the same memory as da.  w_t [2U, U] is read by
// the streaming chain only (null with `resident`).  Returns the cudaError_t
// of the launches (0 on success); the kernels run on `stream` and are not
// waited for.
extern "C" int ugrnn_bwd(const void* w_hh, const void* w_t, const void* mask,
                         const void* hs, const void* g_out, const void* acts,
                         void* da, void* dx, void* dw, void* part, int B,
                         int T, int U, int dtype, float forget_bias,
                         int resident, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || U > 1024 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (resident) {
    ugrnn::Layout L;
    if (!ugrnn::resident_layout(U, dtype == 1 ? 2 : 4, true, 1, &L))
      return cudaErrorInvalidValue;
  } else if (w_t == nullptr) {
    return cudaErrorInvalidValue;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* h = static_cast<const float*>(hs);
  const float* a = static_cast<const float*>(acts);
  float* d = static_cast<float*>(da);
  float* p = static_cast<float*>(part);
  if (dtype == 0)
    return launch_typed<float>(w_hh, w_t, mask, h, g_out, a, d, dx, dw, p, B,
                               T, U, forget_bias, resident != 0, s);
  return launch_typed<__nv_bfloat16>(w_hh, w_t, mask, h, g_out, a, d, dx, dw,
                                     p, B, T, U, forget_bias, resident != 0, s);
}
