// chio — native session-data loader: the PyTorch port's own copy of
// chameleon_recsys_tpu/native/chio.cc, with the same C ABI (chio_load_sessions,
// chio_session_count, chio_collate, chio_free), built by native/build.py into
// the port's _build/.
//
// The reference feeds the model through tf.data's C++ TFRecord/proto kernels
// (nar_module/nar/datasets.py:100-143); this library is the port's
// equivalent input-pipeline backend: it decompresses gzipped TFRecord files,
// parses SequenceExample protos (wire format only — no protobuf dependency),
// and collates sessions straight into the padded int32/float32 batch arrays
// the train step consumes, so Python never touches per-click data.
//
// Exposed as a C ABI for ctypes (no pybind11 dependency).
//
// Build:  g++ -O3 -march=native -shared -fPIC -o libchio.so chio.cc -lz
// (native/build.py does this at first use)

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// gzip file -> raw bytes
// ---------------------------------------------------------------------------
bool read_gzip_file(const char* path, std::vector<uint8_t>* out) {
  gzFile f = gzopen(path, "rb");
  if (!f) return false;
  constexpr size_t kChunk = 1 << 20;
  size_t size = 0;
  out->clear();
  for (;;) {
    out->resize(size + kChunk);
    int n = gzread(f, out->data() + size, kChunk);
    if (n < 0) {
      gzclose(f);
      return false;
    }
    size += static_cast<size_t>(n);
    if (static_cast<size_t>(n) < kChunk) break;
  }
  out->resize(size);
  gzclose(f);
  return true;
}

// ---------------------------------------------------------------------------
// TFRecord framing: u64 length | u32 crc | data | u32 crc
// ---------------------------------------------------------------------------
struct RecordView {
  const uint8_t* data;
  size_t size;
};

void split_records(const std::vector<uint8_t>& buf,
                   std::vector<RecordView>* records) {
  size_t pos = 0;
  while (pos + 12 <= buf.size()) {
    uint64_t length;
    std::memcpy(&length, buf.data() + pos, 8);
    pos += 12;  // skip length crc
    if (pos + length + 4 > buf.size()) break;
    records->push_back({buf.data() + pos, static_cast<size_t>(length)});
    pos += length + 4;  // skip data crc
  }
}

// ---------------------------------------------------------------------------
// Protobuf wire primitives
// ---------------------------------------------------------------------------
struct Cursor {
  const uint8_t* p;
  const uint8_t* end;
};

uint64_t read_varint(Cursor* c) {
  uint64_t result = 0;
  int shift = 0;
  while (c->p < c->end) {
    uint8_t b = *c->p++;
    result |= static_cast<uint64_t>(b & 0x7F) << shift;
    if (!(b & 0x80)) break;
    shift += 7;
  }
  return result;
}

struct Field {
  uint32_t number;
  uint32_t wire;
  uint64_t varint;      // wire 0
  const uint8_t* data;  // wire 2
  size_t size;
};

bool next_field(Cursor* c, Field* f) {
  if (c->p >= c->end) return false;
  uint64_t key = read_varint(c);
  f->number = static_cast<uint32_t>(key >> 3);
  f->wire = static_cast<uint32_t>(key & 0x7);
  switch (f->wire) {
    case 0:
      f->varint = read_varint(c);
      return true;
    case 2: {
      uint64_t len = read_varint(c);
      f->data = c->p;
      f->size = static_cast<size_t>(len);
      c->p += len;
      return c->p <= c->end;
    }
    case 5:
      f->data = c->p;
      f->size = 4;
      c->p += 4;
      return c->p <= c->end;
    case 1:
      f->data = c->p;
      f->size = 8;
      c->p += 8;
      return c->p <= c->end;
    default:
      return false;
  }
}

// Feature { bytes_list=1, float_list=2, int64_list=3 }; lists use field 1.
void parse_feature_int64(const uint8_t* data, size_t size,
                         std::vector<int64_t>* out) {
  Cursor c{data, data + size};
  Field f;
  while (next_field(&c, &f)) {
    if (f.number != 3 || f.wire != 2) continue;
    Cursor inner{f.data, f.data + f.size};
    Field g;
    while (next_field(&inner, &g)) {
      if (g.number != 1) continue;
      if (g.wire == 2) {  // packed varints
        Cursor packed{g.data, g.data + g.size};
        while (packed.p < packed.end)
          out->push_back(static_cast<int64_t>(read_varint(&packed)));
      } else if (g.wire == 0) {
        out->push_back(static_cast<int64_t>(g.varint));
      }
    }
  }
}

void parse_feature_float(const uint8_t* data, size_t size,
                         std::vector<float>* out) {
  Cursor c{data, data + size};
  Field f;
  while (next_field(&c, &f)) {
    if (f.number != 2 || f.wire != 2) continue;
    Cursor inner{f.data, f.data + f.size};
    Field g;
    while (next_field(&inner, &g)) {
      if (g.number != 1) continue;
      if (g.wire == 2) {  // packed floats
        size_t n = g.size / 4;
        size_t base = out->size();
        out->resize(base + n);
        std::memcpy(out->data() + base, g.data, n * 4);
      } else if (g.wire == 5) {
        float v;
        std::memcpy(&v, g.data, 4);
        out->push_back(v);
      }
    }
  }
}

struct ParsedSession {
  std::map<std::string, int64_t> context;
  // sequence feature name -> per-step first values
  std::map<std::string, std::vector<int64_t>> int_seqs;
  std::map<std::string, std::vector<float>> float_seqs;
};

// FeatureList: repeated Feature feature = 1 (one Feature per step)
void parse_feature_list(const uint8_t* data, size_t size,
                        const std::string& name, ParsedSession* out) {
  Cursor c{data, data + size};
  Field f;
  std::vector<int64_t> ints;
  std::vector<float> floats;
  bool is_float = false;
  while (next_field(&c, &f)) {
    if (f.number != 1 || f.wire != 2) continue;
    std::vector<int64_t> step_i;
    parse_feature_int64(f.data, f.size, &step_i);
    if (!step_i.empty()) {
      ints.push_back(step_i[0]);
      continue;
    }
    std::vector<float> step_f;
    parse_feature_float(f.data, f.size, &step_f);
    if (!step_f.empty()) {
      is_float = true;
      floats.push_back(step_f[0]);
      ints.push_back(0);
    } else {
      ints.push_back(0);
      floats.push_back(0.0f);
    }
  }
  if (is_float)
    out->float_seqs[name] = std::move(floats);
  else
    out->int_seqs[name] = std::move(ints);
}

// Features map entry / FeatureLists map entry: { name=1, value=2 }
void parse_features_map(const uint8_t* data, size_t size, ParsedSession* out,
                        bool is_context) {
  Cursor c{data, data + size};
  Field f;
  while (next_field(&c, &f)) {
    if (f.number != 1 || f.wire != 2) continue;
    Cursor entry{f.data, f.data + f.size};
    Field g;
    std::string name;
    const uint8_t* vdata = nullptr;
    size_t vsize = 0;
    while (next_field(&entry, &g)) {
      if (g.number == 1 && g.wire == 2)
        name.assign(reinterpret_cast<const char*>(g.data), g.size);
      else if (g.number == 2 && g.wire == 2) {
        vdata = g.data;
        vsize = g.size;
      }
    }
    if (name.empty() || !vdata) continue;
    if (is_context) {
      std::vector<int64_t> vals;
      parse_feature_int64(vdata, vsize, &vals);
      out->context[name] = vals.empty() ? 0 : vals[0];
    } else {
      parse_feature_list(vdata, vsize, name, out);
    }
  }
}

void parse_sequence_example(const RecordView& rec, ParsedSession* out) {
  Cursor c{rec.data, rec.data + rec.size};
  Field f;
  while (next_field(&c, &f)) {
    if (f.wire != 2) continue;
    if (f.number == 1) parse_features_map(f.data, f.size, out, true);
    else if (f.number == 2) parse_features_map(f.data, f.size, out, false);
  }
}

struct Loader {
  std::vector<ParsedSession> sessions;
};

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------
extern "C" {

void* chio_load_sessions(const char* path) {
  std::vector<uint8_t> buf;
  if (!read_gzip_file(path, &buf)) return nullptr;
  std::vector<RecordView> records;
  split_records(buf, &records);
  auto* loader = new Loader();
  loader->sessions.resize(records.size());
  for (size_t i = 0; i < records.size(); ++i)
    parse_sequence_example(records[i], &loader->sessions[i]);
  return loader;
}

int chio_session_count(void* handle) {
  return static_cast<int>(static_cast<Loader*>(handle)->sessions.size());
}

// Collate sessions [start, start+count) into padded batch arrays:
//   ctx_out       [count, 4]            (user_id, session_id, session_start,
//                                        session_size — clamped to max_len)
//   clicks_out    [count, max_len-1]    item_clicked (inputs)
//   labels_out    [count, max_len-1]    label_next_item
//   last_out      [count]               label_last_item
//   ts_out        [count, max_len-1]    event_timestamp (rebased seconds)
//   int_seq_out   [n_int, count, max_len-1]
//   float_seq_out [n_float, count, max_len-1]
// Returns number of sessions filled (rest of the arrays stay zero).
int chio_collate(void* handle, int start, int count, int max_len,
                 int64_t epoch_ms, int64_t time_unit_ms,
                 const char** int_names, int n_int, const char** float_names,
                 int n_float, int64_t* ctx_out, int32_t* clicks_out,
                 int32_t* labels_out, int32_t* last_out, int32_t* ts_out,
                 int32_t* int_seq_out, float* float_seq_out) {
  auto* loader = static_cast<Loader*>(handle);
  int t = max_len - 1;
  int filled = 0;
  for (int i = 0; i < count; ++i) {
    size_t idx = static_cast<size_t>(start + i);
    if (idx >= loader->sessions.size()) break;
    ParsedSession& s = loader->sessions[idx];
    auto items_it = s.int_seqs.find("item_clicked");
    auto ts_it = s.int_seqs.find("event_timestamp");
    if (items_it == s.int_seqs.end()) continue;
    const auto& items = items_it->second;
    int n = static_cast<int>(items.size());
    if (n > max_len) n = max_len;
    if (n < 2) continue;

    auto ctx_val = [&](const char* key) -> int64_t {
      auto it = s.context.find(key);
      return it == s.context.end() ? 0 : it->second;
    };
    ctx_out[i * 4 + 0] = ctx_val("user_id");
    ctx_out[i * 4 + 1] = ctx_val("session_id");
    // on-disk timestamps are unix ms; in-memory they are rebased seconds
    ctx_out[i * 4 + 2] = (ctx_val("session_start") - epoch_ms) / time_unit_ms;
    ctx_out[i * 4 + 3] = n;

    for (int k = 0; k < n - 1; ++k) {
      clicks_out[i * t + k] = static_cast<int32_t>(items[k]);
      labels_out[i * t + k] = static_cast<int32_t>(items[k + 1]);
    }
    last_out[i] = static_cast<int32_t>(items[n - 1]);
    if (ts_it != s.int_seqs.end()) {
      const auto& ts = ts_it->second;
      for (int k = 0; k < n - 1 && k < static_cast<int>(ts.size()); ++k)
        ts_out[i * t + k] =
            static_cast<int32_t>((ts[k] - epoch_ms) / time_unit_ms);
    }
    for (int fi = 0; fi < n_int; ++fi) {
      auto it = s.int_seqs.find(int_names[fi]);
      if (it == s.int_seqs.end()) continue;
      for (int k = 0; k < n - 1 && k < static_cast<int>(it->second.size()); ++k)
        int_seq_out[(static_cast<size_t>(fi) * count + i) * t + k] =
            static_cast<int32_t>(it->second[k]);
    }
    for (int fi = 0; fi < n_float; ++fi) {
      auto it = s.float_seqs.find(float_names[fi]);
      if (it == s.float_seqs.end()) continue;
      for (int k = 0; k < n - 1 && k < static_cast<int>(it->second.size()); ++k)
        float_seq_out[(static_cast<size_t>(fi) * count + i) * t + k] =
            it->second[k];
    }
    ++filled;
  }
  return filled;
}

void chio_free(void* handle) { delete static_cast<Loader*>(handle); }

}  // extern "C"
