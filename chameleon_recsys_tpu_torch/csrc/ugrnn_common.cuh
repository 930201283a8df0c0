// Shared pieces of the UGRNN scan's kernels (ugrnn_fwd.cu, ugrnn_bwd.cu):
// dtype conversions, the resident layout across a thread-block cluster, and
// the cluster launch.
//
// The resident layout.  A cluster of n CTAs owns R batch rows for the whole
// sequence; CTA q owns the hidden units [q Uq, min(U, (q + 1) Uq)), Uq =
// ceil(U / n), and keeps in shared memory, for all T steps, the W_hh entries
// its units need as (g, c) pairs: [kpad][ws] pairs, kpad >= U the depth
// (zero rows past U), ws = Uq rounded up to odd (a conflict-free stride for
// the backward's transposing load).  The forward's pair for unit j at depth
// k is (W[k, j], W[k, U + j]): the columns of its own units; the backward's
// is (W[j, k], W[j, U + k]): the rows.  Beside it each CTA keeps the full
// per-step vector that every unit's dot product reads (h in the forward; da_g
// and da_c in the backward) for its R rows, in f32, double-buffered, and the
// partial sums of its k-groups.  A CTA runs ksplit x Uq <= 512 threads:
// thread (ks, u) sums depth chunk ks of unit u over all R rows, and owns the
// gate math of the rows ks + i ksplit, i < kGateRows (so R <= kGateRows
// ksplit: the per-row state a thread carries stays a few registers).  The layout takes a width where some cluster
// of at most 8 CTAs (the portable limit) fits a block's 227 KB at R = 1
// (ops/kernels/ugrnn.py::_resident_layout mirrors this arithmetic and names
// the smallest such n).  A launch then picks n and R of {1, 2, 4, 8} for its
// batch: the least work a step on the busiest SM, then the least W_hh to
// load there, with every cluster on the card at once (launch_layout).
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>
#include <set>
#include <utility>

namespace ugrnn {

constexpr long long kMaxSmem = 232448;  // a block's dynamic shared memory
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxThreads = 512;        // the resident kernels' launch bound
constexpr int kGateRows = 2;            // gate rows a thread owns, at most

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

// A (g, c) pair of W_hh entries as stored in shared memory.
template <typename Scalar>
struct PairOf;
template <>
struct PairOf<float> {
  using type = float2;
  __device__ __forceinline__ static float2 widen(float2 p) { return p; }
};
template <>
struct PairOf<__nv_bfloat16> {
  using type = __nv_bfloat162;
  __device__ __forceinline__ static float2 widen(__nv_bfloat162 p) {
    return __bfloat1622float2(p);
  }
};

struct Layout {
  int n;       // CTAs in the cluster
  int uq;      // units a CTA owns (the last CTA may own fewer)
  int ws;      // pair stride of a shared-memory row (uq rounded up to odd)
  int ksplit;  // depth chunks, one thread group each
  int kc;      // depth of a chunk (a multiple of 4)
  int kpad;    // ksplit * kc >= U
  int rows;    // batch rows a cluster owns (R)
  long long smem;  // dynamic shared memory bytes
};

inline int ceil_div(int a, int b) { return (a + b - 1) / b; }

// Bytes of the resident layout with n CTAs at `rows` rows; fills `out`.
// es: bytes of a W_hh element; bwd: the backward's vectors (da_g and da_c)
// and one partial a row, else the forward's (h) and two.
inline long long layout_at(int U, int es, bool bwd, int n, int rows,
                           Layout* out) {
  Layout L;
  L.n = n;
  L.uq = ceil_div(U, n);
  L.ws = L.uq | 1;
  const int ks = kMaxThreads / L.uq;
  L.ksplit = ks < 1 ? 1 : (ks > 8 ? 8 : ks);
  L.kc = ceil_div(ceil_div(U, L.ksplit), 4) * 4;
  L.kpad = L.kc * L.ksplit;
  L.rows = rows;
  const long long w_bytes = (long long)L.kpad * L.ws * 2 * es;
  const long long vec_bytes = (long long)(bwd ? 4 : 2) * rows * L.kpad * 4;
  const long long red_bytes =
      L.ksplit > 1 ? (long long)L.ksplit * rows * L.uq * (bwd ? 1 : 2) * 4 : 0;
  L.smem = w_bytes + vec_bytes + red_bytes;
  if (out) *out = L;
  return L.smem;
}

// The resident layout at `rows` rows: false where no cluster of at most
// kMaxCluster CTAs fits it (U too wide: the wrapper takes the streaming
// kernels there).  n is chosen at one row, so that it depends on U alone.
inline bool resident_layout(int U, int es, bool bwd, int rows, Layout* out) {
  if (U <= 0) return false;
  for (int n = 1; n <= kMaxCluster; ++n) {
    if (n > 1 && (n - 1) * ceil_div(U, n) >= U) continue;  // a CTA owns none
    Layout L;
    if (layout_at(U, es, bwd, n, 1, &L) > kMaxSmem) continue;
    if (L.ksplit * L.uq > kMaxThreads) continue;
    layout_at(U, es, bwd, n, rows, out);
    return out->smem <= kMaxSmem;
  }
  return false;
}

// The card's SM count (device 0's kind: the port runs one model of card).
inline int sm_count() {
  static const int count = [] {
    int device = 0, sms = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    return sms > 0 ? sms : 1;
  }();
  return count;
}

// The launch's layout at batch B (see the head note): among every n from the
// smallest fitting cluster up to kMaxCluster and every R of {1, 2, 4, 8}
// whose layout fits (R <= kGateRows ksplit) and whose clusters the card
// holds at once, the least work a step on the busiest SM: R Uq times the
// CTAs an SM runs (ceil(CTAs / SMs)); on a tie the least W_hh to load on
// that SM (Uq times its CTAs: the set-up, ~1/4 of the time at batch 32),
// then the smaller R and n.  Where no layout puts every cluster on the card
// at once, the smallest n at the largest R that can be placed.  max_clusters(L) is the card's count of
// co-resident clusters of layout L.  False where none can be placed.
template <typename MaxClusters>
bool launch_layout(int B, int U, int es, bool bwd, MaxClusters max_clusters,
                   Layout* out) {
  Layout first;
  if (!resident_layout(U, es, bwd, 1, &first)) return false;
  bool found = false;
  long long best = 0, best_load = 0;
  for (int R = 1; R <= 8; R *= 2) {
    for (int n = first.n; n <= kMaxCluster; ++n) {
      if (n > 1 && (n - 1) * ceil_div(U, n) >= U) continue;
      Layout L;
      if (layout_at(U, es, bwd, n, R, &L) > kMaxSmem) continue;
      if (L.ksplit * L.uq > kMaxThreads || R > kGateRows * L.ksplit) continue;
      const int clusters = ceil_div(B, R);
      if (clusters > max_clusters(L)) continue;
      const int per_sm = ceil_div(clusters * n, sm_count());
      const long long work = (long long)R * L.uq * per_sm;
      const long long load = (long long)L.uq * per_sm;
      if (!found || work < best || (work == best && load < best_load)) {
        found = true;
        best = work;
        best_load = load;
        *out = L;
      }
    }
  }
  if (found) return true;
  for (int R = 8; R >= 1; R /= 2) {
    Layout L;
    if (resident_layout(U, es, bwd, R, &L) && R <= kGateRows * L.ksplit &&
        max_clusters(L) > 0) {
      *out = L;
      return true;
    }
  }
  return false;
}

// Copies W_hh into a resident layout's pair slots, 32 bits at a time (two
// bf16 elements a load).  Run (a, gate), a < runs, is `len` consecutive
// elements of w starting at element start(a, gate); its element i lands in
// component `gate` of pair slot(a, i).  Slot e of the block's sweep is word
// e % P of run e / P, P the words a run may touch rounded up to a power of
// two (shifts and masks, no division); each thread keeps kLoads loads in
// flight (the loop is latency-bound: 130 KB a CTA at G1).  The caller
// zeroes the slots first (padding stays 0).  W_hh's rows are 4-byte aligned
// (2U elements of 2 or 4 bytes).
template <typename Scalar, typename Pair, typename Start, typename Slot>
__device__ __forceinline__ void load_pairs(const Scalar* __restrict__ w,
                                           int runs, int len, Start start,
                                           Slot slot, Pair* wsm) {
  constexpr int kPer = 4 / sizeof(Scalar);  // elements a 32-bit word
  constexpr int kLoads = 16;
  const int words = len / kPer + 1;  // words a run may touch
  int log_p = 0;
  while ((1 << log_p) < words) ++log_p;
  const int total = (2 * runs) << log_p;
  const uint32_t* w32 = reinterpret_cast<const uint32_t*>(w);
  Scalar* comp = reinterpret_cast<Scalar*>(wsm);
  for (int e0 = threadIdx.x; e0 < total; e0 += kLoads * blockDim.x) {
    uint32_t v[kLoads];
    int first[kLoads];
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int e = e0 + i * blockDim.x;
      const int run = e >> log_p, word = e & ((1 << log_p) - 1);
      const bool live = e < total && word < words;
      const int s = live ? start(run >> 1, run & 1) : 0;
      const int f = (s / kPer + word) * kPer - s;  // run index of its first element
      const bool ok = live && f < len;
      first[i] = ok ? f : len;
      v[i] = ok ? w32[s / kPer + word] : 0u;
    }
#pragma unroll
    for (int i = 0; i < kLoads; ++i) {
      const int run = (e0 + i * blockDim.x) >> log_p;
#pragma unroll
      for (int h = 0; h < kPer; ++h) {
        const int idx = first[i] + h;
        if (idx < 0 || idx >= len) continue;
        Scalar value;
        if constexpr (kPer == 1) {
          value = __uint_as_float(v[i]);
        } else {
          value = __ushort_as_bfloat16(static_cast<unsigned short>(v[i] >> (16 * h)));
        }
        comp[2 * slot(run >> 1, idx) + (run & 1)] = value;
      }
    }
  }
}

// Lets `kernel` take up to kMaxSmem bytes of dynamic shared memory on the
// current device: set once per (device, kernel), not at every launch.
inline cudaError_t allow_max_smem(const void* kernel) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  static std::mutex lock;
  static std::set<std::pair<int, const void*>> done;
  std::lock_guard<std::mutex> guard(lock);
  if (done.count({device, kernel})) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)kMaxSmem);
  if (err == cudaSuccess) done.insert({device, kernel});
  return err;
}

// Launch `kernel` as clusters of L.n CTAs, L.ksplit * L.uq threads each,
// with L.smem bytes of dynamic shared memory, over ceil(B / L.rows)
// clusters.
template <typename Kernel, typename... Args>
cudaError_t launch_clusters(Kernel kernel, const Layout& L, int B,
                            cudaStream_t stream, Args... args) {
  cudaError_t err = allow_max_smem((const void*)kernel);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(ceil_div(B, L.rows) * L.n);
  config.blockDim = dim3(L.ksplit * L.uq);
  config.dynamicSmemBytes = L.smem;
  config.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  return cudaLaunchKernelEx(&config, kernel, args...);
}

// Clusters of this layout the card can hold at once (0: none can be placed).
template <typename Kernel>
int max_active_clusters(Kernel kernel, const Layout& L) {
  if (allow_max_smem((const void*)kernel) != cudaSuccess)
    return 0;
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(L.n);
  config.blockDim = dim3(L.ksplit * L.uq);
  config.dynamicSmemBytes = L.smem;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = L.n;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  int clusters = 0;
  if (cudaOccupancyMaxActiveClusters(&clusters, kernel, &config) != cudaSuccess)
    return 0;
  return clusters;
}

}  // namespace ugrnn
