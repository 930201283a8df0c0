// Native SkNN / V-SkNN batch predictor: the PyTorch port's own copy of
// chameleon_recsys_tpu/native/sknn.cc, with the same C ABI
// (sknn_predict_batch), built by native/build.py into the port's _build/.
//
// Bit-identical C++ twin of SessionBasedKNNRecommender._predict_row
// (baselines/session_knn.py; reference semantics from
// nar_module/nar/benchmarks/session_knn.py:200-266): every floating-point
// accumulation runs in IEEE double in the SAME order as the numpy path, so
// similarities, vote scores, tie-breaks at the neighbor cut and the final
// (-score, first-occurrence) ranking are exactly equal — the Python oracle
// test asserts id-level equality.
//
// Why native: the numpy path is bound by per-click Python/numpy dispatch
// overhead (~2,500 clicks/batch x ~30 micro-kernels), not by arithmetic.
// Here the whole batch is one call, rows run on a thread pool (disjoint
// output slices), and the recent-candidate cut is built incrementally in
// O(K) instead of materializing every occurrence.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline double decay_fn(int32_t kind, int64_t i) {
  switch (kind) {
    case 0: return 1.0;                                   // same
    case 1: return 1.0 / static_cast<double>(i);          // div
    case 2: return i <= 100 ? 1.0 - 0.1 * i : 0.0;        // linear
    case 3: return 1.0 / std::log10(i + 1.7);             // log
    default: return 1.0 / (static_cast<double>(i) * i);   // quadratic
  }
}

// index of `value` in sorted [arr, arr+n), or -1
inline int64_t bsearch_i64(const int64_t* arr, int64_t n, int64_t value) {
  const int64_t* it = std::lower_bound(arr, arr + n, value);
  if (it == arr + n || *it != value) return -1;
  return it - arr;
}

struct RowScratch {
  std::vector<int64_t> uniq, inv_all, arr_off, occ_cnt;
  std::vector<uint8_t> member;
  std::vector<double> inter_cum, numer, sim;
  std::vector<int64_t> sizes;
  std::vector<int64_t> items_row;      // sorted unique item universe
  std::vector<int64_t> inv_items;      // occurrence -> items_row index
  std::vector<int64_t> slice_start;    // per local sid, into inv_items
  std::vector<int64_t> rows_occ, sel_cnt, sel_rows;
  std::vector<double> scores;
  std::vector<int64_t> first_pos, stamp;
  std::vector<int64_t> vu;
  int64_t epoch = 0;
};

struct Args {
  const int64_t *g_sids, *g_starts, *g_lens, *g_items;
  int64_t n_buf;
  const int64_t *bi_off, *bi_sids;
  const int64_t* item_idx;
  int64_t B, T;
  const int64_t* valid;
  int64_t V;
  int64_t sample_size, nn, topk;
  int32_t similarity, decay;
  int64_t* out;
};

void predict_row(const Args& a, int64_t r, RowScratch& s) {
  // ---- columns with a real click (numpy: nonzero(sessions_items[r])) ----
  std::vector<int64_t> cols, qs;
  for (int64_t t = 0; t < a.T; ++t) {
    int64_t q = a.item_idx[r * a.T + t];
    if (q >= 0) { cols.push_back(t); qs.push_back(q); }
  }
  const int64_t m = (int64_t)cols.size();
  if (m == 0) return;

  // ---- candidate occurrences, per prefix item, + sorted unique sids ----
  s.arr_off.assign(m + 1, 0);
  for (int64_t j = 0; j < m; ++j)
    s.arr_off[j + 1] = s.arr_off[j] + (a.bi_off[qs[j] + 1] - a.bi_off[qs[j]]);
  const int64_t n_occ_total = s.arr_off[m];
  if (n_occ_total == 0) return;

  s.uniq.clear();
  s.uniq.reserve(n_occ_total);
  for (int64_t j = 0; j < m; ++j)
    s.uniq.insert(s.uniq.end(), a.bi_sids + a.bi_off[qs[j]],
                  a.bi_sids + a.bi_off[qs[j] + 1]);
  std::sort(s.uniq.begin(), s.uniq.end());
  s.uniq.erase(std::unique(s.uniq.begin(), s.uniq.end()), s.uniq.end());
  const int64_t u = (int64_t)s.uniq.size();

  s.inv_all.resize(n_occ_total);
  {
    int64_t o = 0;
    for (int64_t j = 0; j < m; ++j)
      for (int64_t x = a.bi_off[qs[j]]; x < a.bi_off[qs[j] + 1]; ++x, ++o)
        s.inv_all[o] =
            std::lower_bound(s.uniq.begin(), s.uniq.end(), a.bi_sids[x]) -
            s.uniq.begin();
  }

  // ---- membership / counts (member is 0/1 per column; each bi slice
  //      lists a sid once) ----
  s.member.assign(u * m, 0);
  for (int64_t j = 0; j < m; ++j)
    for (int64_t o = s.arr_off[j]; o < s.arr_off[j + 1]; ++o)
      s.member[s.inv_all[o] * m + j] = 1;

  // first occurrence of each distinct item / distinct-prefix counts
  std::vector<uint8_t> first_mask(m, 0);
  std::vector<int64_t> distinct(m);
  {
    std::vector<int64_t> seen;  // tiny m: linear scan
    int64_t d = 0;
    for (int64_t j = 0; j < m; ++j) {
      if (std::find(seen.begin(), seen.end(), qs[j]) == seen.end()) {
        seen.push_back(qs[j]);
        first_mask[j] = 1;
        ++d;
      }
      distinct[j] = d;
    }
  }

  // occ_cnt[ui*m+j] = cumulative column count (occurrence multiplicity of
  // sid ui in prefix j); inter_cum = cumulative distinct-item intersection
  s.occ_cnt.assign(u * m, 0);
  s.inter_cum.assign(u * m, 0.0);
  for (int64_t ui = 0; ui < u; ++ui) {
    int64_t cnt = 0;
    double inter = 0.0;
    for (int64_t j = 0; j < m; ++j) {
      cnt += s.member[ui * m + j];
      inter += s.member[ui * m + j] && first_mask[j] ? 1.0 : 0.0;
      s.occ_cnt[ui * m + j] = cnt;
      s.inter_cum[ui * m + j] = inter;
    }
  }

  // ---- numerator (V-SkNN positional decay, accumulated d ascending —
  //      the numpy path's exact float order) ----
  if (a.decay == 0) {
    s.numer = s.inter_cum;
  } else {
    s.numer.assign(u * m, 0.0);
    for (int64_t d = 1; d <= m; ++d) {
      const double w = decay_fn(a.decay, d);
      for (int64_t ui = 0; ui < u; ++ui)
        for (int64_t p = d - 1; p < m; ++p)
          if (s.member[ui * m + (p - d + 1)])
            s.numer[ui * m + p] += w;
    }
  }

  // ---- similarities ----
  s.sizes.resize(u);
  for (int64_t ui = 0; ui < u; ++ui) {
    int64_t gi = bsearch_i64(a.g_sids, a.n_buf, s.uniq[ui]);
    s.sizes[ui] = gi >= 0 ? a.g_lens[gi] : 0;  // train invariant: gi >= 0
  }
  s.sim.assign(u * m, 0.0);
  for (int64_t ui = 0; ui < u; ++ui) {
    const double size = (double)s.sizes[ui];
    for (int64_t j = 0; j < m; ++j) {
      double denom;
      if (a.similarity == 0)
        denom = std::sqrt((double)distinct[j]) * std::sqrt(size);
      else
        denom = (double)distinct[j] + size - s.inter_cum[ui * m + j];
      if (denom > 0.0)
        s.sim[ui * m + j] = s.numer[ui * m + j] / std::max(denom, 1e-12);
    }
  }

  // ---- row vote universe: the uniq sids' item slices from the global
  //      vote table, ascending sid order (identical to the numpy row
  //      table); occurrence -> unique-item inverse ----
  s.slice_start.assign(u + 1, 0);
  std::vector<int64_t> gidx(u);
  for (int64_t ui = 0; ui < u; ++ui) {
    gidx[ui] = bsearch_i64(a.g_sids, a.n_buf, s.uniq[ui]);
    s.slice_start[ui + 1] =
        s.slice_start[ui] + (gidx[ui] >= 0 ? a.g_lens[gidx[ui]] : 0);
  }
  const int64_t total_row = s.slice_start[u];
  s.items_row.clear();
  s.items_row.reserve(total_row);
  for (int64_t ui = 0; ui < u; ++ui)
    if (gidx[ui] >= 0)
      s.items_row.insert(s.items_row.end(), a.g_items + a.g_starts[gidx[ui]],
                         a.g_items + a.g_starts[gidx[ui]] + a.g_lens[gidx[ui]]);
  {
    std::vector<int64_t> sorted_items = s.items_row;
    std::sort(sorted_items.begin(), sorted_items.end());
    sorted_items.erase(std::unique(sorted_items.begin(), sorted_items.end()),
                       sorted_items.end());
    s.inv_items.resize(total_row);
    for (int64_t o = 0; o < total_row; ++o)
      s.inv_items[o] = std::lower_bound(sorted_items.begin(),
                                        sorted_items.end(), s.items_row[o]) -
                       sorted_items.begin();
    s.items_row.swap(sorted_items);  // items_row := sorted unique universe
  }
  const int64_t n_items_row = (int64_t)s.items_row.size();
  if ((int64_t)s.scores.size() < n_items_row) {
    s.scores.resize(n_items_row);
    s.first_pos.resize(n_items_row);
    s.stamp.assign(n_items_row, -1);
  } else {
    if ((int64_t)s.stamp.size() < n_items_row) s.stamp.resize(n_items_row, -1);
  }

  // ---- per click ----
  std::vector<std::pair<double, int64_t>> occ_sim;  // (sim, insertion order)
  std::vector<int64_t> occ_row;
  for (int64_t j = 0; j < m; ++j) {
    const int64_t c = cols[j];
    const int64_t n_occ = s.arr_off[j + 1];
    if (n_occ == 0) continue;

    // candidate occurrence list (row-local sid indices)
    s.rows_occ.clear();
    if (a.sample_size > 0 && a.sample_size < n_occ) {
      // "recent": all occurrences sorted by sid DESCENDING, first K —
      // built incrementally instead of materializing n_occ entries
      for (int64_t ui = u - 1;
           ui >= 0 && (int64_t)s.rows_occ.size() < a.sample_size; --ui) {
        int64_t cnt = s.occ_cnt[ui * m + j];
        for (int64_t x = 0;
             x < cnt && (int64_t)s.rows_occ.size() < a.sample_size; ++x)
          s.rows_occ.push_back(ui);
      }
    } else {
      s.rows_occ.assign(s.inv_all.begin(), s.inv_all.begin() + n_occ);
    }

    // stable sort occurrences by similarity descending; filter (0, 1);
    // keep the first `nn` slots
    const int64_t n_r = (int64_t)s.rows_occ.size();
    occ_sim.resize(n_r);
    for (int64_t o = 0; o < n_r; ++o)
      occ_sim[o] = {s.sim[s.rows_occ[o] * m + j], o};
    std::stable_sort(occ_sim.begin(), occ_sim.end(),
                     [](const auto& x, const auto& y) {
                       return x.first > y.first;
                     });
    s.sel_cnt.assign(u, 0);
    int64_t taken = 0;
    for (int64_t o = 0; o < n_r && taken < a.nn; ++o) {
      const double sv = occ_sim[o].first;
      if (sv > 0.0 && sv < 1.0) {
        ++s.sel_cnt[s.rows_occ[occ_sim[o].second]];
        ++taken;
      }
    }
    if (taken == 0) continue;

    // vote: selected sessions ascending sid, weight = count * sim;
    // occurrence order and float accumulation match np.bincount
    ++s.epoch;
    int64_t pos = 0;
    for (int64_t ui = 0; ui < u; ++ui) {
      if (!s.sel_cnt[ui]) continue;
      const double w = (double)s.sel_cnt[ui] * s.sim[ui * m + j];
      for (int64_t o = s.slice_start[ui]; o < s.slice_start[ui + 1];
           ++o, ++pos) {
        const int64_t it = s.inv_items[o];
        if (s.stamp[it] != s.epoch) {
          s.stamp[it] = s.epoch;
          s.scores[it] = 0.0;
          s.first_pos[it] = pos;
        }
        s.scores[it] += w;
      }
    }

    // rank the valid side: unique valid ids present with score > 0,
    // sorted by (-score, first occurrence), top-k
    const int64_t* valid_row = a.valid + (r * a.T + c) * a.V;
    s.vu.assign(valid_row, valid_row + a.V);
    std::sort(s.vu.begin(), s.vu.end());
    s.vu.erase(std::unique(s.vu.begin(), s.vu.end()), s.vu.end());
    std::vector<std::pair<std::pair<double, int64_t>, int64_t>> cand;
    cand.reserve(s.vu.size());
    for (int64_t v : s.vu) {
      int64_t it = bsearch_i64(s.items_row.data(), n_items_row, v);
      if (it >= 0 && s.stamp[it] == s.epoch && s.scores[it] > 0.0)
        cand.push_back({{s.scores[it], s.first_pos[it]}, v});
    }
    std::sort(cand.begin(), cand.end(), [](const auto& x, const auto& y) {
      if (x.first.first != y.first.first) return x.first.first > y.first.first;
      return x.first.second < y.first.second;  // first_pos unique per item
    });
    int64_t* out_row = a.out + (r * a.T + c) * a.topk;
    const int64_t n_out = std::min<int64_t>(a.topk, (int64_t)cand.size());
    for (int64_t k = 0; k < n_out; ++k) out_row[k] = cand[k].second;
  }
}

}  // namespace

extern "C" int sknn_predict_batch(
    const int64_t* g_sids, const int64_t* g_starts, const int64_t* g_lens,
    int64_t n_buf, const int64_t* g_items,
    const int64_t* bi_off, const int64_t* bi_sids, int64_t n_batch_items,
    const int64_t* item_idx, int64_t B, int64_t T,
    const int64_t* valid, int64_t V,
    int64_t sample_size, int64_t nn, int64_t topk,
    int32_t similarity, int32_t decay, int32_t n_threads,
    int64_t* out) {
  (void)n_batch_items;
  Args a{g_sids, g_starts, g_lens, g_items, n_buf, bi_off, bi_sids,
         item_idx, B, T, valid, V, sample_size, nn, topk,
         similarity, decay, out};
  std::memset(out, 0, sizeof(int64_t) * B * T * topk);

  int nt = n_threads > 0
               ? n_threads
               : std::max(1u, std::thread::hardware_concurrency());
  nt = (int)std::min<int64_t>(nt, B);
  if (nt <= 1) {
    RowScratch s;
    for (int64_t r = 0; r < B; ++r) predict_row(a, r, s);
    return 0;
  }
  std::atomic<int64_t> next(0);
  std::vector<std::thread> threads;
  threads.reserve(nt);
  for (int t = 0; t < nt; ++t)
    threads.emplace_back([&]() {
      RowScratch s;
      for (;;) {
        int64_t r = next.fetch_add(1);
        if (r >= B) break;
        predict_row(a, r, s);
      }
    });
  for (auto& th : threads) th.join();
  return 0;
}
