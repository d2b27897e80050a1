// Native Avro encoder for ScoringResultAvro blocks (io/schemas.py
// SCORING_RESULT) — the write-side mirror of game_decoder.cpp.  The
// port's own copy of the JAX package's encoder, built into the port's
// _build directory (native/__init__.py::load_score_encoder).
//
// The scoring drivers' per-record Python write (dict building + recursive
// write_datum) is an order of magnitude under the scoring rate, so
// streamed scoring is write-bound without it.  This encoder takes one
// COLUMNAR block (uid blob+offsets, score/label arrays, id columns as
// value blobs + null masks) and emits the Avro binary record body in one
// C++ pass; Python wraps framing/compression (zlib is already native
// there).
//
// Byte-level contract (kept bit-for-bit identical to the Python
// write_datum path; tests/test_torch_game_io.py pins it):
//   uid:   union [null, string] -> zigzag index 0|1, then len+bytes
//   predictionScore: 8-byte little-endian double
//   label: union [null, double] -> zigzag index, then double
//   ids:   map<string> -> varint(count), entries, varint(0); count>0
//          entries iterate the given column order (caller sorts keys)
//
// C ABI only (ctypes; no pybind11 in this image).

#include <cstdint>
#include <cstring>

namespace {

inline int64_t put_varint(uint8_t* out, uint64_t v) {
    int64_t n = 0;
    while (v & ~0x7FULL) {
        out[n++] = static_cast<uint8_t>((v & 0x7F) | 0x80);
        v >>= 7;
    }
    out[n++] = static_cast<uint8_t>(v);
    return n;
}

inline int64_t put_long(uint8_t* out, int64_t v) {
    // Avro zigzag
    return put_varint(out, (static_cast<uint64_t>(v) << 1) ^
                           static_cast<uint64_t>(v >> 63));
}

inline int64_t put_double(uint8_t* out, double v) {
    std::memcpy(out, &v, 8);  // little-endian hosts only (x86/ARM)
    return 8;
}

}  // namespace

extern "C" {

// Returns bytes written, or -(bytes needed) when out_cap is too small
// (caller reallocates and retries).  Offsets arrays have n+1 entries
// (and n_cols*n+1 for the column-major value offsets); is-null masks
// are 1 byte per entry.
int64_t se_encode(
    int64_t n,
    const char* uid_blob, const int64_t* uid_off,
    const uint8_t* uid_is_null,
    const double* scores,
    const double* labels, const uint8_t* label_is_null,
    int64_t n_cols,
    const char* vals_blob, const int64_t* vals_off,
    const uint8_t* val_is_null,
    const char* keys_blob, const int64_t* keys_off,
    char* out_c, int64_t out_cap) {
    // Upper bound: per row uid(10+len) + score(9) + label(10) +
    // map header/terminator(20) + per entry key+val lens + 20.
    int64_t need = 0;
    for (int64_t r = 0; r < n; ++r) {
        need += 10 + (uid_off[r + 1] - uid_off[r]) + 9 + 10 + 20;
    }
    for (int64_t c = 0; c < n_cols; ++c) {
        int64_t klen = keys_off[c + 1] - keys_off[c];
        for (int64_t r = 0; r < n; ++r) {
            int64_t i = c * n + r;
            if (!val_is_null[i]) {
                need += 20 + klen + (vals_off[i + 1] - vals_off[i]);
            }
        }
    }
    if (need > out_cap) return -need;

    uint8_t* out = reinterpret_cast<uint8_t*>(out_c);
    int64_t p = 0;
    for (int64_t r = 0; r < n; ++r) {
        if (uid_is_null[r]) {
            p += put_long(out + p, 0);
        } else {
            p += put_long(out + p, 1);
            int64_t len = uid_off[r + 1] - uid_off[r];
            p += put_long(out + p, len);
            std::memcpy(out + p, uid_blob + uid_off[r], len);
            p += len;
        }
        p += put_double(out + p, scores[r]);
        if (label_is_null[r]) {
            p += put_long(out + p, 0);
        } else {
            p += put_long(out + p, 1);
            p += put_double(out + p, labels[r]);
        }
        int64_t count = 0;
        for (int64_t c = 0; c < n_cols; ++c) {
            if (!val_is_null[c * n + r]) ++count;
        }
        if (count > 0) {
            p += put_long(out + p, count);
            for (int64_t c = 0; c < n_cols; ++c) {
                int64_t i = c * n + r;
                if (val_is_null[i]) continue;
                int64_t klen = keys_off[c + 1] - keys_off[c];
                p += put_long(out + p, klen);
                std::memcpy(out + p, keys_blob + keys_off[c], klen);
                p += klen;
                int64_t vlen = vals_off[i + 1] - vals_off[i];
                p += put_long(out + p, vlen);
                std::memcpy(out + p, vals_blob + vals_off[i], vlen);
                p += vlen;
            }
        }
        p += put_long(out + p, 0);  // map terminator
    }
    return p;
}

}  // extern "C"
