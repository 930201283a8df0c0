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
// [B, T, U], and a non-null `acts` every pre-activation a in f32 [B, T, 2U]:
// the stash from which the backward (ugrnn_bwd.cu) takes the gates instead
// of recomputing h_prev . W_hh inside its serial chain.
//
// What bounds it: the recurrence is T dependent steps (19 at G1), each a
// [rows, U] x [U, 2U] product that needs the previous step's h.  At G1 that
// is a few hundred MFLOP at most, microseconds at the card's f32 rate, so the
// time is the latency of the serial chain: per step, one pass over W_hh and
// one exchange of h.
//
// What the design does about it (the resident kernel, for every U whose
// layout fits a cluster of at most 8 CTAs; ugrnn_common.cuh): W_hh (255 x
// 510 at G1: 260 KB in bf16, above one block's 227 KB) is split by hidden
// unit across a thread-block cluster of n CTAs (n >= 2 in bf16 and >= 3 in
// f32 at U 255; the launch takes larger clusters where the batch leaves SMs
// idle, up to 8), and each CTA loads the (g, c) columns of its own units
// into shared memory once, for all T steps.  A step is then one pass over
// that slice from shared memory, split over up to 8 thread groups by depth,
// with the gate math local to the thread that owns the unit, and one
// exchange: each CTA writes its units' slice of h' into every CTA's next h
// buffer over distributed shared memory, then one cluster barrier (release
// / acquire).  h is double-buffered, so that one barrier a step suffices: a
// CTA writes buffer t % 2 at step t only after every CTA has passed the
// barrier that ends its reads of it.  The next step's x and mask are
// fetched during the product.  Wider U takes the streaming kernel (the first
// design): one block per 2 rows, one thread per unit, W_hh read from L2
// every step; the wrapper selects by the pure width predicate
// ops/kernels/ugrnn.py::resident_takes, never by a failed launch.

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
    ugrnn_fwd_resident_kernel(const Scalar* __restrict__ x,
                              const Scalar* __restrict__ w,
                              const uint8_t* __restrict__ mask,
                              Scalar* __restrict__ out,
                              float* __restrict__ hs32,
                              float* __restrict__ acts, int B, int T, int U,
                              float forget_bias, Layout L) {
  using P = ugrnn::PairOf<Scalar>;
  using Pair = typename P::type;
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int uq = L.uq, ws = L.ws, kc = L.kc, kpad = L.kpad;
  const int ksplit = L.ksplit;
  Pair* wsm = reinterpret_cast<Pair*>(smem);  // [kpad][ws]
  float* hbuf = reinterpret_cast<float*>(smem + (size_t)kpad * ws * sizeof(Pair));
  float2* red = reinterpret_cast<float2*>(hbuf + 2 * R * kpad);  // [ksplit][R][uq]
  const int q = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / L.n) * R;
  const int u0 = q * uq;
  const int own = min(uq, U - u0);
  const int ks = threadIdx.x / uq, u = threadIdx.x % uq;
  const int j = u0 + u;
  const bool unit = u < own;
  const int two_u = 2 * U;
  const int nthreads = blockDim.x;

  // the (g, c) columns of the own units: zero every slot (the rows past U
  // and the units past `own` stay 0), then run k of gate g is W[k, gate U +
  // u0 ...), landing in pair row k
  uint4* zero = reinterpret_cast<uint4*>(smem);
  const int words16 = (int)((size_t)kpad * ws * sizeof(Pair) / 16);
  for (int i = threadIdx.x; i < words16; i += nthreads) zero[i] = make_uint4(0, 0, 0, 0);
  for (int i = threadIdx.x; i < 2 * R * kpad; i += nthreads) hbuf[i] = 0.f;
  __syncthreads();
  ugrnn::load_pairs(
      w, U, own, [&](int k, int gate) { return k * two_u + gate * U + u0; },
      [&](int k, int i) { return k * ws + i; }, wsm);
  cluster.sync();  // every CTA's buffers are zero before any remote write

  // x and the mask of this thread's gate rows r = ks + i ksplit (i <
  // kGateRows), fetched a step ahead so that their latency hides behind the
  // product
  constexpr int kG = ugrnn::kGateRows;
  auto fetch = [&](int t, float* xg_, float* xc_, bool* mk_) {
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      const int r = ks + i * ksplit, b = row0 + r;
      const bool mine = unit && r < R && b < B && t < T;
      const size_t bt = (size_t)b * T + t;
      xg_[i] = mine ? to_f32(x[bt * two_u + j]) : 0.f;
      xc_[i] = mine ? to_f32(x[bt * two_u + U + j]) : 0.f;
      mk_[i] = mine && mask[bt];
    }
  };
  float xg[kG], xc[kG];
  bool mk[kG];
  fetch(0, xg, xc, mk);

  int cur = 0;
  for (int t = 0; t < T; ++t) {
    const float* h = hbuf + cur * R * kpad;
    float* h_next = hbuf + (cur ^ 1) * R * kpad;
    float xg_n[kG], xc_n[kG];
    bool mk_n[kG];
    fetch(t + 1, xg_n, xc_n, mk_n);

    float ag[R], ac[R];
#pragma unroll
    for (int r = 0; r < R; ++r) ag[r] = ac[r] = 0.f;
    if (unit) {
      const int k0 = ks * kc;
      const Pair* wp = wsm + (size_t)k0 * ws + u;
#pragma unroll 2
      for (int kk = 0; kk < kc; kk += 4, wp += 4 * ws) {
        const float2 w0 = P::widen(wp[0]), w1 = P::widen(wp[ws]);
        const float2 w2 = P::widen(wp[2 * ws]), w3 = P::widen(wp[3 * ws]);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float4 hv =
              *reinterpret_cast<const float4*>(h + r * kpad + k0 + kk);
          ag[r] = fmaf(hv.x, w0.x, ag[r]);
          ac[r] = fmaf(hv.x, w0.y, ac[r]);
          ag[r] = fmaf(hv.y, w1.x, ag[r]);
          ac[r] = fmaf(hv.y, w1.y, ac[r]);
          ag[r] = fmaf(hv.z, w2.x, ag[r]);
          ac[r] = fmaf(hv.z, w2.y, ac[r]);
          ag[r] = fmaf(hv.w, w3.x, ag[r]);
          ac[r] = fmaf(hv.w, w3.y, ac[r]);
        }
      }
    }
    if (ksplit > 1) {
      if (unit) {
#pragma unroll
        for (int r = 0; r < R; ++r)
          red[(ks * R + r) * uq + u] = make_float2(ag[r], ac[r]);
      }
      __syncthreads();
    }
    if (unit) {
#pragma unroll
      for (int i = 0; i < kG; ++i) {
        const int r = ks + i * ksplit, b = row0 + r;
        if (r >= R || b >= B) continue;
        float sg = 0.f, sc = 0.f;
        if (ksplit > 1) {
          for (int s = 0; s < ksplit; ++s) {  // a fixed order
            const float2 p = red[(s * R + r) * uq + u];
            sg += p.x;
            sc += p.y;
          }
        } else {
#pragma unroll
          for (int rr = 0; rr < R; ++rr) {  // r == i: a register, not memory
            if (rr == r) {
              sg = ag[rr];
              sc = ac[rr];
            }
          }
        }
        const size_t bt = (size_t)b * T + t;
        const float a_g = xg[i] + sg;
        const float a_c = xc[i] + sc;
        const float h_prev = h[r * kpad + j];
        float h_new = h_prev;
        if (mk[i]) {
          const float g = 1.f / (1.f + expf(-(a_g + forget_bias)));
          const float c = tanhf(a_c);
          h_new = g * h_prev + (1.f - g) * c;
        }
        for (int d = 0; d < L.n; ++d)
          cluster.map_shared_rank(h_next, d)[r * kpad + j] = h_new;
        out[bt * U + j] = from_f32<Scalar>(h_new);
        if (hs32 != nullptr) hs32[bt * U + j] = h_new;
        if (acts != nullptr) {
          acts[bt * two_u + j] = a_g;
          acts[bt * two_u + U + j] = a_c;
        }
      }
    }
    cluster.sync();  // h' complete in every CTA; every read of h done
    cur ^= 1;
#pragma unroll
    for (int i = 0; i < kG; ++i) {
      xg[i] = xg_n[i];
      xc[i] = xc_n[i];
      mk[i] = mk_n[i];
    }
  }
}

// The resident layout's chain alone: the same clusters, threads and shared
// memory, T steps of the h exchange (each gate thread writes one value into
// every CTA's next buffer) and the cluster barrier, with no product and no
// gate math.  What no design of this layout can take off a step.
template <int R>
__global__ void __launch_bounds__(ugrnn::kMaxThreads)
    ugrnn_chain_floor_kernel(float* __restrict__ sink, int B, int T, int U,
                             size_t w_bytes, Layout L) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int uq = L.uq, kpad = L.kpad, ksplit = L.ksplit;
  float* hbuf = reinterpret_cast<float*>(smem + w_bytes);
  const int q = (int)cluster.block_rank();
  const int row0 = (blockIdx.x / L.n) * R;
  const int ks = threadIdx.x / uq, u = threadIdx.x % uq;
  const int j = q * uq + u;
  const bool unit = u < min(uq, U - q * uq);
  for (int i = threadIdx.x; i < 2 * R * kpad; i += blockDim.x) hbuf[i] = 0.f;
  cluster.sync();
  int cur = 0;
  float last = 0.f;
  for (int t = 0; t < T; ++t) {
    const float* h = hbuf + cur * R * kpad;
    float* h_next = hbuf + (cur ^ 1) * R * kpad;
    if (unit) {
#pragma unroll
      for (int i = 0; i < ugrnn::kGateRows; ++i) {
        const int r = ks + i * ksplit;
        if (r >= R || row0 + r >= B) continue;
        last = h[r * kpad + j] + 1.f;
        for (int d = 0; d < L.n; ++d)
          cluster.map_shared_rank(h_next, d)[r * kpad + j] = last;
      }
    }
    cluster.sync();
    cur ^= 1;
  }
  if (unit) sink[(blockIdx.x * blockDim.x + threadIdx.x) & 0xffff] = last;
}

// The streaming kernel (U past the resident layout).
// x: [B, T, 2U], w: [U, 2U], mask: [B, T] (1 byte each), out: [B, T, U].
// Block: one thread per hidden unit (blockDim.x >= U), kRows batch rows.
// Dynamic shared memory: 2 * kRows * U floats (h, double-buffered).
constexpr int kRows = 2;

template <typename Scalar>
__global__ void ugrnn_fwd_stream_kernel(const Scalar* __restrict__ x,
                                        const Scalar* __restrict__ w,
                                        const uint8_t* __restrict__ mask,
                                        Scalar* __restrict__ out,
                                        float* __restrict__ hs32,
                                        float* __restrict__ acts, int B,
                                        int T, int U, float forget_bias) {
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
        const float a_g = to_f32(x[bt * two_u + j]) + acc_g[r];
        const float a_c = to_f32(x[bt * two_u + U + j]) + acc_c[r];
        float h_new = h_prev;
        if (mask[bt]) {
          const float g = 1.f / (1.f + expf(-(a_g + forget_bias)));
          const float c = tanhf(a_c);
          h_new = g * h_prev + (1.f - g) * c;
        }
        h_next[r * U + j] = h_new;
        out[bt * U + j] = from_f32<Scalar>(h_new);
        if (hs32 != nullptr) hs32[bt * U + j] = h_new;
        if (acts != nullptr) {
          acts[bt * two_u + j] = a_g;
          acts[bt * two_u + U + j] = a_c;
        }
      }
    }
    __syncthreads();
    cur ^= 1;
  }
}

// Clusters of a resident forward layout the card holds at once, per (dtype,
// R, n, U); cached, since the occupancy query costs host time.
template <typename Scalar>
int fwd_max_clusters(const Layout& L, int U) {
  static std::mutex lock;
  static std::map<std::tuple<int, int, int>, int> cache;
  std::lock_guard<std::mutex> guard(lock);
  const auto key = std::make_tuple(L.rows, L.n, U);
  const auto hit = cache.find(key);
  if (hit != cache.end()) return hit->second;
  int c = 0;
  switch (L.rows) {
    case 1: c = ugrnn::max_active_clusters(ugrnn_fwd_resident_kernel<Scalar, 1>, L); break;
    case 2: c = ugrnn::max_active_clusters(ugrnn_fwd_resident_kernel<Scalar, 2>, L); break;
    case 4: c = ugrnn::max_active_clusters(ugrnn_fwd_resident_kernel<Scalar, 4>, L); break;
    default: c = ugrnn::max_active_clusters(ugrnn_fwd_resident_kernel<Scalar, 8>, L); break;
  }
  cache[key] = c;
  return c;
}

// The resident forward's layout at batch B (ugrnn::launch_layout), cached
// per (B, U); false where no cluster can be placed.
template <typename Scalar>
bool fwd_layout(int B, int U, Layout* out) {
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
      B, U, (int)sizeof(Scalar), false,
      [U](const Layout& l) { return fwd_max_clusters<Scalar>(l, U); }, &L);
  std::lock_guard<std::mutex> guard(lock);
  cache[{B, U}] = {ok, L};
  *out = L;
  return ok;
}

template <typename Scalar>
cudaError_t launch_resident(const void* x, const void* w, const void* mask,
                            void* out, float* hs32, float* acts, int B, int T,
                            int U, float fb, cudaStream_t s) {
  Layout L;
  const int R = fwd_layout<Scalar>(B, U, &L) ? L.rows : 0;
  const Scalar* xs = static_cast<const Scalar*>(x);
  const Scalar* ws = static_cast<const Scalar*>(w);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  Scalar* o = static_cast<Scalar*>(out);
  switch (R) {
    case 1: return ugrnn::launch_clusters(ugrnn_fwd_resident_kernel<Scalar, 1>, L, B, s, xs, ws, m, o, hs32, acts, B, T, U, fb, L);
    case 2: return ugrnn::launch_clusters(ugrnn_fwd_resident_kernel<Scalar, 2>, L, B, s, xs, ws, m, o, hs32, acts, B, T, U, fb, L);
    case 4: return ugrnn::launch_clusters(ugrnn_fwd_resident_kernel<Scalar, 4>, L, B, s, xs, ws, m, o, hs32, acts, B, T, U, fb, L);
    case 8: return ugrnn::launch_clusters(ugrnn_fwd_resident_kernel<Scalar, 8>, L, B, s, xs, ws, m, o, hs32, acts, B, T, U, fb, L);
    default: return cudaErrorInvalidConfiguration;  // no cluster can be placed
  }
}

template <typename Scalar>
cudaError_t launch_stream(const void* x, const void* w, const void* mask,
                          void* out, float* hs32, float* acts, int B, int T,
                          int U, float forget_bias, cudaStream_t stream) {
  const int threads = ((U + 31) / 32) * 32;
  const int blocks = (B + kRows - 1) / kRows;
  const size_t smem = 2u * kRows * U * sizeof(float);  // <= 16 KB at U <= 1024
  ugrnn_fwd_stream_kernel<Scalar><<<blocks, threads, smem, stream>>>(
      static_cast<const Scalar*>(x), static_cast<const Scalar*>(w),
      static_cast<const uint8_t*>(mask), static_cast<Scalar*>(out), hs32, acts,
      B, T, U, forget_bias);
  return cudaGetLastError();
}

template <typename Scalar>
cudaError_t launch_floor(int B, int T, int U, float* sink, cudaStream_t s) {
  Layout L;
  const int R = fwd_layout<Scalar>(B, U, &L) ? L.rows : 0;
  const size_t w_bytes = (size_t)L.kpad * L.ws * 2 * sizeof(Scalar);
  switch (R) {
    case 1: return ugrnn::launch_clusters(ugrnn_chain_floor_kernel<1>, L, B, s, sink, B, T, U, w_bytes, L);
    case 2: return ugrnn::launch_clusters(ugrnn_chain_floor_kernel<2>, L, B, s, sink, B, T, U, w_bytes, L);
    case 4: return ugrnn::launch_clusters(ugrnn_chain_floor_kernel<4>, L, B, s, sink, B, T, U, w_bytes, L);
    case 8: return ugrnn::launch_clusters(ugrnn_chain_floor_kernel<8>, L, B, s, sink, B, T, U, w_bytes, L);
    default: return cudaErrorInvalidConfiguration;
  }
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16 (x_proj, W_hh and the output share
// it); hs32 is null or a float32 [B, T, U] copy of the states, acts null or
// the float32 [B, T, 2U] pre-activations.  `resident` selects the resident
// kernel (the wrapper asks ugrnn.resident_takes; it is refused where the
// layout does not fit) or the streaming one.  Returns the cudaError_t of the
// launch (0 on success); the kernel runs on `stream` and is not waited for.
extern "C" int ugrnn_fwd(const void* x_proj, const void* w_hh,
                         const void* mask, void* out, void* hs32, void* acts,
                         int B, int T, int U, int dtype, float forget_bias,
                         int resident, void* stream) {
  if (B <= 0 || T <= 0 || U <= 0 || U > 1024 || (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* h = static_cast<float*>(hs32);
  float* a = static_cast<float*>(acts);
  if (resident) {
    Layout L;
    if (!ugrnn::resident_layout(U, dtype == 1 ? 2 : 4, false, 1, &L))
      return cudaErrorInvalidValue;
    if (dtype == 0)
      return launch_resident<float>(x_proj, w_hh, mask, out, h, a, B, T, U,
                                    forget_bias, s);
    return launch_resident<__nv_bfloat16>(x_proj, w_hh, mask, out, h, a, B, T,
                                          U, forget_bias, s);
  }
  if (dtype == 0)
    return launch_stream<float>(x_proj, w_hh, mask, out, h, a, B, T, U,
                                forget_bias, s);
  return launch_stream<__nv_bfloat16>(x_proj, w_hh, mask, out, h, a, B, T, U,
                                      forget_bias, s);
}

// Dynamic shared memory of the resident layout (forward, or with `bwd` the
// backward's chain) at `rows` rows a cluster, or -1 where it does not fit a
// cluster of at most 8 CTAs.
extern "C" long long ugrnn_resident_smem_bytes(int U, int dtype, int bwd,
                                               int rows) {
  ugrnn::Layout L;
  if (!ugrnn::resident_layout(U, dtype == 1 ? 2 : 4, bwd != 0, rows, &L))
    return -1;
  return L.smem;
}

// CTAs in a cluster of the resident layout, 0 where it does not fit.
extern "C" int ugrnn_resident_cluster(int U, int dtype, int bwd) {
  ugrnn::Layout L;
  if (!ugrnn::resident_layout(U, dtype == 1 ? 2 : 4, bwd != 0, 1, &L)) return 0;
  return L.n;
}

// The resident forward's launch at batch B: writes (CTAs a cluster, rows a
// cluster) to n_rows and returns 1; 0 where it is not resident or no
// cluster can be placed.
extern "C" int ugrnn_fwd_layout(int B, int U, int dtype, int* n_rows) {
  ugrnn::Layout L;
  if (B <= 0 || !(dtype == 1 ? fwd_layout<__nv_bfloat16>(B, U, &L)
                             : fwd_layout<float>(B, U, &L)))
    return 0;
  n_rows[0] = L.n;
  n_rows[1] = L.rows;
  return 1;
}

// The chain floor: the resident forward's clusters at (B, T, U, dtype)
// running T steps of exchange and cluster barriers only; writes a value a
// thread into `sink` (65,536 f32).  Returns the launch's cudaError_t.
extern "C" int ugrnn_chain_floor(int B, int T, int U, int dtype, void* sink,
                                 void* stream) {
  ugrnn::Layout L;
  if (B <= 0 || T <= 0 ||
      !ugrnn::resident_layout(U, dtype == 1 ? 2 : 4, false, 1, &L))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* out = static_cast<float*>(sink);
  if (dtype == 1) return launch_floor<__nv_bfloat16>(B, T, U, out, s);
  return launch_floor<float>(B, T, U, out, s);
}
