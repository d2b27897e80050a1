// Native GAME Avro block decoder (the port's copy of
// photon_ml_tpu/native/game_decoder.cpp, unchanged below this header).
//
// The fast path of host ingest (the reference's Avro decoding runs as
// compiled Java inside Spark executors — SURVEY.md §2 "Avro IO"; the Python
// flat decoder in data/game_reader.py is the fallback).  A session object
// consumes decompressed Avro block payloads (GAME example schema, validated
// Python-side) and accumulates COLUMNAR results entirely in C++:
//
//  - response / weight / offset as double columns;
//  - uids and per-id-column entity keys as string blobs + offset tables
//    (-1 offset = missing / null);
//  - per-shard feature triples ALREADY index-mapped: the name"\x01"term →
//    column-id hash map lives here, so the per-feature hot path (the
//    dominant ingest cost in Python) never crosses the language boundary.
//    Building mode assigns fresh ids; scoring mode is preloaded from the
//    Python index maps and counts dropped unseen features/shards.
//
// Exposed as a C ABI for ctypes (no pybind11 needed).  All
// output copies happen once, at the end, into NumPy-owned buffers.

#include <cstdint>
#include <cstring>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct ShardAcc {
  std::unordered_map<std::string, int64_t> index;  // key -> column id
  std::vector<std::string> keys;                   // id -> key (insertion order)
  std::vector<int64_t> rows;
  std::vector<int64_t> cols;
  std::vector<float> vals;
  int64_t dropped = 0;
  bool preloaded = false;  // scoring mode: never grow the index
  bool unknown = false;    // scoring mode: shard absent from index maps
  bool seen = false;       // shard actually appeared in the data
};

struct IdCol {
  // Offsets into blob per row; -1 = missing.  Lazily extended to the
  // current row count on first touch of a late-appearing column.
  std::vector<int64_t> start;
  std::vector<int64_t> end;
  std::string blob;
};

struct Session {
  bool building;
  int64_t n_rows = 0;
  std::vector<double> response, weight, offset;
  std::string uid_blob;
  std::vector<int64_t> uid_start, uid_end;  // -1 = null uid
  std::vector<std::string> shard_order;
  std::unordered_map<std::string, ShardAcc> shards;
  std::vector<std::string> id_order;
  std::unordered_map<std::string, IdCol> id_cols;
  std::string error;
};

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  int64_t read_long() {
    uint64_t acc = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      acc |= static_cast<uint64_t>(b & 0x7F) << shift;
      if (!(b & 0x80)) {
        return static_cast<int64_t>(acc >> 1) ^
               -static_cast<int64_t>(acc & 1);
      }
      shift += 7;
      if (shift > 63) break;
    }
    ok = false;
    return 0;
  }

  double read_double() {
    if (end - p < 8) { ok = false; return 0.0; }
    double v;
    std::memcpy(&v, p, 8);
    p += 8;
    return v;
  }

  bool read_str(const char** s, int64_t* len) {
    int64_t n = read_long();
    if (!ok || n < 0 || end - p < n) { ok = false; return false; }
    *s = reinterpret_cast<const char*>(p);
    *len = n;
    p += n;
    return true;
  }
};

void touch_id_col(Session* s, const std::string& name, IdCol** out) {
  auto it = s->id_cols.find(name);
  if (it == s->id_cols.end()) {
    s->id_order.push_back(name);
    IdCol col;
    col.start.assign(s->n_rows, -1);  // backfill rows before first sight
    col.end.assign(s->n_rows, -1);
    it = s->id_cols.emplace(name, std::move(col)).first;
  }
  *out = &it->second;
}

ShardAcc* touch_shard(Session* s, const std::string& name) {
  auto it = s->shards.find(name);
  if (it != s->shards.end()) {
    it->second.seen = true;
    return &it->second;
  }
  {
    s->shard_order.push_back(name);
    it = s->shards.emplace(name, ShardAcc{}).first;
    if (!s->building) {
      // Scoring: a shard absent from the supplied index maps drops every
      // feature (empty frozen index) and is excluded from the output —
      // it exists only to carry the drop count.
      it->second.preloaded = true;
      it->second.unknown = true;
    }
    it->second.seen = true;
    return &it->second;
  }
}

}  // namespace

extern "C" {

void* gd_new(int building) {
  auto* s = new Session();
  s->building = building != 0;
  return s;
}

void gd_free(void* h) { delete static_cast<Session*>(h); }

// Scoring mode: preload one shard's index map (keys in column order).
void gd_preload_shard(void* h, const char* shard, const char* const* keys,
                      int64_t nkeys) {
  auto* s = static_cast<Session*>(h);
  std::string name(shard);
  auto it = s->shards.find(name);
  if (it == s->shards.end()) {
    s->shard_order.push_back(name);
    it = s->shards.emplace(name, ShardAcc{}).first;
  }
  ShardAcc& acc = it->second;
  acc.preloaded = true;
  acc.keys.reserve(nkeys);
  for (int64_t i = 0; i < nkeys; ++i) {
    acc.keys.emplace_back(keys[i]);
    acc.index.emplace(acc.keys.back(), i);
  }
}

// Decode one decompressed block payload holding `count` records.
// Returns 0 on success, -1 on malformed input (see gd_error).
int64_t gd_decode_block(void* h, const uint8_t* payload, int64_t len,
                        int64_t count) {
  auto* s = static_cast<Session*>(h);
  Reader r{payload, payload + len};
  std::string key_buf;
  for (int64_t rec = 0; rec < count && r.ok; ++rec) {
    const int64_t row = s->n_rows;
    // uid: union [null, string]
    if (r.read_long() == 1) {
      const char* us; int64_t ul;
      if (!r.read_str(&us, &ul)) break;
      s->uid_start.push_back(static_cast<int64_t>(s->uid_blob.size()));
      s->uid_blob.append(us, ul);
      s->uid_end.push_back(static_cast<int64_t>(s->uid_blob.size()));
    } else {
      s->uid_start.push_back(-1);
      s->uid_end.push_back(-1);
    }
    s->response.push_back(r.read_double());
    s->weight.push_back(r.read_long() == 1 ? r.read_double() : 1.0);
    s->offset.push_back(r.read_long() == 1 ? r.read_double() : 0.0);

    // ids map
    for (;;) {
      int64_t c = r.read_long();
      if (!r.ok || c == 0) break;
      if (c < 0) { c = -c; r.read_long(); }
      for (int64_t i = 0; i < c && r.ok; ++i) {
        const char* ks; int64_t kl;
        const char* vs; int64_t vl;
        if (!r.read_str(&ks, &kl) || !r.read_str(&vs, &vl)) break;
        IdCol* col;
        touch_id_col(s, std::string(ks, kl), &col);
        if (static_cast<int64_t>(col->start.size()) < row) {
          col->start.resize(row, -1);
          col->end.resize(row, -1);
        }
        col->start.push_back(static_cast<int64_t>(col->blob.size()));
        col->blob.append(vs, vl);
        col->end.push_back(static_cast<int64_t>(col->blob.size()));
      }
    }

    // features map: shard -> [ {name, term, value} ]
    for (;;) {
      int64_t c = r.read_long();
      if (!r.ok || c == 0) break;
      if (c < 0) { c = -c; r.read_long(); }
      for (int64_t i = 0; i < c && r.ok; ++i) {
        const char* ss; int64_t sl;
        if (!r.read_str(&ss, &sl)) break;
        ShardAcc* acc = touch_shard(s, std::string(ss, sl));
        for (;;) {
          int64_t fc = r.read_long();
          if (!r.ok || fc == 0) break;
          if (fc < 0) { fc = -fc; r.read_long(); }
          for (int64_t j = 0; j < fc && r.ok; ++j) {
            const char* ns; int64_t nl;
            const char* ts; int64_t tl;
            if (!r.read_str(&ns, &nl) || !r.read_str(&ts, &tl)) break;
            double v = r.read_double();
            // feature_key semantics (data/index_map.py): empty term → the
            // bare name, else name + "\x01" + term.
            key_buf.assign(ns, nl);
            if (tl > 0) {
              key_buf.push_back('\x01');
              key_buf.append(ts, tl);
            }
            auto it = acc->index.find(key_buf);
            int64_t idx;
            if (it == acc->index.end()) {
              if (acc->preloaded || !s->building) {
                acc->dropped += 1;
                continue;
              }
              idx = static_cast<int64_t>(acc->keys.size());
              acc->keys.push_back(key_buf);
              acc->index.emplace(key_buf, idx);
            } else {
              idx = it->second;
            }
            acc->rows.push_back(row);
            acc->cols.push_back(idx);
            acc->vals.push_back(static_cast<float>(v));
          }
        }
      }
    }
    s->n_rows += 1;
  }
  if (!r.ok) {
    s->error = "malformed avro block payload";
    return -1;
  }
  return 0;
}

const char* gd_error(void* h) {
  return static_cast<Session*>(h)->error.c_str();
}

int64_t gd_n_rows(void* h) { return static_cast<Session*>(h)->n_rows; }

void gd_copy_row_data(void* h, double* response, double* weight,
                      double* offset) {
  auto* s = static_cast<Session*>(h);
  std::memcpy(response, s->response.data(), s->n_rows * sizeof(double));
  std::memcpy(weight, s->weight.data(), s->n_rows * sizeof(double));
  std::memcpy(offset, s->offset.data(), s->n_rows * sizeof(double));
}

int64_t gd_uid_blob_len(void* h) {
  return static_cast<int64_t>(static_cast<Session*>(h)->uid_blob.size());
}

void gd_copy_uids(void* h, char* blob, int64_t* start, int64_t* end) {
  auto* s = static_cast<Session*>(h);
  std::memcpy(blob, s->uid_blob.data(), s->uid_blob.size());
  std::memcpy(start, s->uid_start.data(), s->n_rows * sizeof(int64_t));
  std::memcpy(end, s->uid_end.data(), s->n_rows * sizeof(int64_t));
}

int64_t gd_n_id_cols(void* h) {
  return static_cast<int64_t>(static_cast<Session*>(h)->id_order.size());
}

const char* gd_id_col_name(void* h, int64_t i) {
  return static_cast<Session*>(h)->id_order[i].c_str();
}

int64_t gd_id_col_blob_len(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return static_cast<int64_t>(s->id_cols[s->id_order[i]].blob.size());
}

void gd_copy_id_col(void* h, int64_t i, char* blob, int64_t* start,
                    int64_t* end) {
  auto* s = static_cast<Session*>(h);
  IdCol& col = s->id_cols[s->id_order[i]];
  if (static_cast<int64_t>(col.start.size()) < s->n_rows) {
    col.start.resize(s->n_rows, -1);  // trailing rows missing this column
    col.end.resize(s->n_rows, -1);
  }
  std::memcpy(blob, col.blob.data(), col.blob.size());
  std::memcpy(start, col.start.data(), s->n_rows * sizeof(int64_t));
  std::memcpy(end, col.end.data(), s->n_rows * sizeof(int64_t));
}

int64_t gd_n_shards(void* h) {
  return static_cast<int64_t>(static_cast<Session*>(h)->shard_order.size());
}

const char* gd_shard_name(void* h, int64_t i) {
  return static_cast<Session*>(h)->shard_order[i].c_str();
}

int64_t gd_shard_nnz(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return static_cast<int64_t>(s->shards[s->shard_order[i]].rows.size());
}

int64_t gd_shard_dropped(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return s->shards[s->shard_order[i]].dropped;
}

int64_t gd_shard_unknown(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return s->shards[s->shard_order[i]].unknown ? 1 : 0;
}

int64_t gd_shard_seen(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return s->shards[s->shard_order[i]].seen ? 1 : 0;
}

void gd_copy_shard_coo(void* h, int64_t i, int64_t* rows, int64_t* cols,
                       float* vals) {
  auto* s = static_cast<Session*>(h);
  ShardAcc& acc = s->shards[s->shard_order[i]];
  std::memcpy(rows, acc.rows.data(), acc.rows.size() * sizeof(int64_t));
  std::memcpy(cols, acc.cols.data(), acc.cols.size() * sizeof(int64_t));
  std::memcpy(vals, acc.vals.data(), acc.vals.size() * sizeof(float));
}

int64_t gd_shard_nkeys(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  return static_cast<int64_t>(s->shards[s->shard_order[i]].keys.size());
}

int64_t gd_shard_keys_blob_len(void* h, int64_t i) {
  auto* s = static_cast<Session*>(h);
  int64_t total = 0;
  for (const auto& k : s->shards[s->shard_order[i]].keys) {
    total += static_cast<int64_t>(k.size());
  }
  return total;
}

void gd_copy_shard_keys(void* h, int64_t i, char* blob, int64_t* offsets) {
  auto* s = static_cast<Session*>(h);
  ShardAcc& acc = s->shards[s->shard_order[i]];
  int64_t pos = 0;
  int64_t k = 0;
  for (const auto& key : acc.keys) {
    std::memcpy(blob + pos, key.data(), key.size());
    pos += static_cast<int64_t>(key.size());
    offsets[k++] = pos;
  }
}

}  // extern "C"
