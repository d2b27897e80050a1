"""Minimal Avro object-container-file codec, dependency-free.

The reference's wire/storage format is Avro everywhere — training examples,
model coefficients (``BayesianLinearModelAvro``), scores (SURVEY.md §2,
"Avro IO" / "Avro schemas") — so this package speaks real Avro too.  No
Avro library is available in this environment, so this implements the Avro
1.x object container spec directly: files written here are readable by
standard Avro tooling and vice versa.

Supported schema subset (all the reference's schemas need): primitives
(null, boolean, int, long, float, double, bytes, string), records, arrays,
maps, unions, and enums.  Codecs: null (uncompressed), deflate, and snappy
(pure-Python block format — LinkedIn-ecosystem Avro is typically
snappy-compressed, so real reference datasets need it to ingest).
"""

from __future__ import annotations

import io as _io
import json
import os
import struct
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, BinaryIO, Iterable, Iterator, Optional

MAGIC = b"Obj\x01"


# ---------------------------------------------------------------------------
# Primitive binary encoding
# ---------------------------------------------------------------------------

def _zigzag_encode(n: int) -> int:
    return (n << 1) ^ (n >> 63)


def _zigzag_decode(n: int) -> int:
    return (n >> 1) ^ -(n & 1)


def write_long(buf: BinaryIO, n: int) -> None:
    n = _zigzag_encode(n)
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            buf.write(bytes([b | 0x80]))
        else:
            buf.write(bytes([b]))
            return


def read_long(buf: BinaryIO) -> int:
    shift = 0
    acc = 0
    while True:
        byte = buf.read(1)
        if not byte:
            raise EOFError("truncated varint")
        b = byte[0]
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc)
        shift += 7


def write_bytes(buf: BinaryIO, data: bytes) -> None:
    write_long(buf, len(data))
    buf.write(data)


def read_bytes(buf: BinaryIO) -> bytes:
    n = read_long(buf)
    data = buf.read(n)
    if len(data) != n:
        raise EOFError("truncated bytes")
    return data


# ---------------------------------------------------------------------------
# Schema-directed datum encoding
# ---------------------------------------------------------------------------

def _resolve(schema: Any) -> Any:
    """Normalize shorthand string schemas ("string") to dict form."""
    if isinstance(schema, str):
        return {"type": schema}
    return schema


def write_datum(buf: BinaryIO, schema: Any, datum: Any) -> None:
    if isinstance(schema, list):  # union
        for i, branch in enumerate(schema):
            if _matches(branch, datum):
                write_long(buf, i)
                write_datum(buf, branch, datum)
                return
        raise TypeError(f"datum {datum!r} matches no union branch in {schema}")
    s = _resolve(schema)
    t = s["type"]
    if t == "null":
        return
    if t == "boolean":
        buf.write(b"\x01" if datum else b"\x00")
    elif t in ("int", "long"):
        write_long(buf, int(datum))
    elif t == "float":
        buf.write(struct.pack("<f", float(datum)))
    elif t == "double":
        buf.write(struct.pack("<d", float(datum)))
    elif t == "bytes":
        write_bytes(buf, bytes(datum))
    elif t == "string":
        write_bytes(buf, datum.encode("utf-8"))
    elif t == "enum":
        write_long(buf, s["symbols"].index(datum))
    elif t == "record":
        for field in s["fields"]:
            try:
                write_datum(buf, field["type"], datum[field["name"]])
            except (KeyError, TypeError) as e:
                raise TypeError(
                    f"record field {field['name']!r}: {e}"
                ) from e
    elif t == "array":
        items = list(datum)
        if items:
            write_long(buf, len(items))
            for item in items:
                write_datum(buf, s["items"], item)
        write_long(buf, 0)
    elif t == "map":
        entries = dict(datum)
        if entries:
            write_long(buf, len(entries))
            for k, v in entries.items():
                write_bytes(buf, k.encode("utf-8"))
                write_datum(buf, s["values"], v)
        write_long(buf, 0)
    else:
        raise TypeError(f"unsupported Avro type {t!r}")


def _matches(schema: Any, datum: Any) -> bool:
    s = _resolve(schema)
    t = s["type"]
    if t == "null":
        return datum is None
    if t == "boolean":
        return isinstance(datum, bool)
    if t in ("int", "long"):
        return isinstance(datum, int) and not isinstance(datum, bool)
    if t in ("float", "double"):
        return isinstance(datum, float) or (
            isinstance(datum, int) and not isinstance(datum, bool)
        )
    if t == "bytes":
        return isinstance(datum, (bytes, bytearray))
    if t == "string":
        return isinstance(datum, str)
    if t == "enum":
        return isinstance(datum, str) and datum in s["symbols"]
    if t == "record":
        return isinstance(datum, dict)
    if t == "array":
        return isinstance(datum, (list, tuple))
    if t == "map":
        return isinstance(datum, dict)
    return False


def read_datum(buf: BinaryIO, schema: Any) -> Any:
    if isinstance(schema, list):  # union
        idx = read_long(buf)
        return read_datum(buf, schema[idx])
    s = _resolve(schema)
    t = s["type"]
    if t == "null":
        return None
    if t == "boolean":
        return buf.read(1) == b"\x01"
    if t in ("int", "long"):
        return read_long(buf)
    if t == "float":
        return struct.unpack("<f", buf.read(4))[0]
    if t == "double":
        return struct.unpack("<d", buf.read(8))[0]
    if t == "bytes":
        return read_bytes(buf)
    if t == "string":
        return read_bytes(buf).decode("utf-8")
    if t == "enum":
        return s["symbols"][read_long(buf)]
    if t == "record":
        return {
            field["name"]: read_datum(buf, field["type"]) for field in s["fields"]
        }
    if t == "array":
        out = []
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:  # block with byte size prefix
                count = -count
                read_long(buf)
            for _ in range(count):
                out.append(read_datum(buf, s["items"]))
    if t == "map":
        out = {}
        while True:
            count = read_long(buf)
            if count == 0:
                return out
            if count < 0:
                count = -count
                read_long(buf)
            for _ in range(count):
                k = read_bytes(buf).decode("utf-8")
                out[k] = read_datum(buf, s["values"])
    raise TypeError(f"unsupported Avro type {t!r}")


# ---------------------------------------------------------------------------
# Compiled codecs: the same encoding as write_datum / read_datum, with the
# schema walked once per container instead of once per value.  A GAME model
# holds a record per coefficient, so the walk was most of a save or load.
# ---------------------------------------------------------------------------

_ONE_BYTE = [bytes([i]) for i in range(256)]
_pack_f = struct.Struct("<f").pack
_pack_d = struct.Struct("<d").pack
_unpack_f = struct.Struct("<f").unpack_from
_unpack_d = struct.Struct("<d").unpack_from
#: encoded (length-prefixed) strings kept per compiled writer: feature
#: names and terms repeat in every entity's record.
_STRING_CACHE_LIMIT = 1 << 16


def _varint(n: int) -> bytes:
    n = _zigzag_encode(n)
    if n < 0x80:
        return _ONE_BYTE[n]
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _compile_writer(schema: Any) -> Any:
    """``enc(append, datum)``: appends the bytes ``write_datum(buf, schema,
    datum)`` would write, raising what it would raise."""
    if isinstance(schema, list):  # union
        branches = [(b, _compile_writer(b)) for b in schema]
        if len(schema) == 2 and _resolve(schema[0])["type"] == "null":
            other, enc_other = branches[1]

            def enc_nullable(append, d):
                if d is None:
                    append(b"\x00")
                elif _matches(other, d):
                    append(b"\x02")
                    enc_other(append, d)
                else:
                    raise TypeError(
                        f"datum {d!r} matches no union branch in {schema}")
            return enc_nullable

        def enc_union(append, d):
            for i, (branch, enc) in enumerate(branches):
                if _matches(branch, d):
                    append(_varint(i))
                    enc(append, d)
                    return
            raise TypeError(f"datum {d!r} matches no union branch in {schema}")
        return enc_union
    s = _resolve(schema)
    t = s["type"]
    if t == "null":
        return lambda append, d: None
    if t == "boolean":
        return lambda append, d: append(b"\x01" if d else b"\x00")
    if t in ("int", "long"):
        return lambda append, d: append(_varint(int(d)))
    if t == "float":
        return lambda append, d: append(_pack_f(float(d)))
    if t == "double":
        return lambda append, d: append(_pack_d(float(d)))
    if t == "bytes":
        def enc_bytes(append, d):
            d = bytes(d)
            append(_varint(len(d)))
            append(d)
        return enc_bytes
    if t == "string":
        cache: dict = {}

        def enc_string(append, d):
            if type(d) is str:
                b = cache.get(d)
                if b is None:
                    raw = d.encode("utf-8")
                    b = _varint(len(raw)) + raw
                    if len(cache) < _STRING_CACHE_LIMIT:
                        cache[d] = b
                append(b)
                return
            raw = d.encode("utf-8")
            append(_varint(len(raw)))
            append(raw)
        return enc_string
    if t == "enum":
        symbols = s["symbols"]
        return lambda append, d: append(_varint(symbols.index(d)))
    if t == "record":
        fields = [(f["name"], _compile_writer(f["type"])) for f in s["fields"]]

        def enc_record(append, d):
            for name, enc in fields:
                try:
                    enc(append, d[name])
                except (KeyError, TypeError) as e:
                    raise TypeError(f"record field {name!r}: {e}") from e
        return enc_record
    if t == "array":
        enc_item = _compile_writer(s["items"])

        def enc_array(append, d):
            items = list(d)
            if items:
                append(_varint(len(items)))
                for item in items:
                    enc_item(append, item)
            append(b"\x00")
        return enc_array
    if t == "map":
        enc_value = _compile_writer(s["values"])

        def enc_map(append, d):
            entries = dict(d)
            if entries:
                append(_varint(len(entries)))
                for k, v in entries.items():
                    raw = k.encode("utf-8")
                    append(_varint(len(raw)))
                    append(raw)
                    enc_value(append, v)
            append(b"\x00")
        return enc_map

    def enc_unsupported(append, d):
        raise TypeError(f"unsupported Avro type {t!r}")
    return enc_unsupported


def _read_varint(buf, pos: int) -> tuple[int, int]:
    if pos < len(buf) and buf[pos] < 0x80:
        b = buf[pos]
        return (b >> 1) ^ -(b & 1), pos + 1
    shift = 0
    acc = 0
    n = len(buf)
    while True:
        if pos >= n:
            raise EOFError("truncated varint")
        b = buf[pos]
        pos += 1
        acc |= (b & 0x7F) << shift
        if not b & 0x80:
            return _zigzag_decode(acc), pos
        shift += 7


def _read_raw(buf, pos: int) -> tuple[bytes, int]:
    n, pos = _read_varint(buf, pos)
    end = pos + n
    if n < 0 or end > len(buf):
        raise EOFError("truncated bytes")
    return bytes(buf[pos:end]), end


def _compile_reader(schema: Any) -> Any:
    """``dec(buf, pos) -> (datum, pos)`` over a bytes payload: the datum
    ``read_datum`` would read at ``pos``."""
    if isinstance(schema, list):  # union
        decs = [_compile_reader(b) for b in schema]

        def dec_union(buf, pos):
            idx, pos = _read_varint(buf, pos)
            return decs[idx](buf, pos)
        if len(schema) == 2 and _resolve(schema[0])["type"] == "null":
            dec_other = decs[1]

            def dec_nullable(buf, pos):
                b = buf[pos] if pos < len(buf) else None
                if b == 0:
                    return None, pos + 1
                if b == 2:
                    return dec_other(buf, pos + 1)
                return dec_union(buf, pos)
            return dec_nullable
        return dec_union
    s = _resolve(schema)
    t = s["type"]
    if t == "null":
        return lambda buf, pos: (None, pos)
    if t == "boolean":
        return lambda buf, pos: (buf[pos:pos + 1] == b"\x01", pos + 1)
    if t in ("int", "long"):
        return _read_varint
    if t == "float":
        return lambda buf, pos: (_unpack_f(buf, pos)[0], pos + 4)
    if t == "double":
        return lambda buf, pos: (_unpack_d(buf, pos)[0], pos + 8)
    if t == "bytes":
        return _read_raw
    if t == "string":
        def dec_string(buf, pos):
            n, pos = _read_varint(buf, pos)
            end = pos + n
            if n < 0 or end > len(buf):
                raise EOFError("truncated bytes")
            return str(buf[pos:end], "utf-8"), end
        return dec_string
    if t == "enum":
        symbols = s["symbols"]

        def dec_enum(buf, pos):
            i, pos = _read_varint(buf, pos)
            return symbols[i], pos
        return dec_enum
    if t == "record":
        fields = [(f["name"], _compile_reader(f["type"])) for f in s["fields"]]

        def dec_record(buf, pos):
            out = {}
            for name, dec in fields:
                out[name], pos = dec(buf, pos)
            return out, pos
        return dec_record
    if t in ("array", "map"):
        dec_value = _compile_reader(s["items" if t == "array" else "values"])

        def dec_blocks(buf, pos):
            out = [] if t == "array" else {}
            while True:
                count, pos = _read_varint(buf, pos)
                if count == 0:
                    return out, pos
                if count < 0:  # block with byte size prefix
                    count = -count
                    _, pos = _read_varint(buf, pos)
                for _ in range(count):
                    if t == "array":
                        v, pos = dec_value(buf, pos)
                        out.append(v)
                    else:
                        raw, pos = _read_raw(buf, pos)
                        out[raw.decode("utf-8")], pos = dec_value(buf, pos)
        return dec_blocks

    def dec_unsupported(buf, pos):
        raise TypeError(f"unsupported Avro type {t!r}")
    return dec_unsupported


def _decode_block(dec, count: int, payload: bytes) -> list:
    out = []
    pos = 0
    for _ in range(count):
        rec, pos = dec(payload, pos)
        out.append(rec)
    return out


# ---------------------------------------------------------------------------
# Object container files
# ---------------------------------------------------------------------------

# ---------------------------------------------------------------------------
# Snappy block format (pure Python — no snappy module in the image)
#
# LinkedIn-ecosystem Avro is typically snappy-compressed; without this
# codec, real reference datasets would not ingest.
# Avro's snappy framing is the raw snappy BLOCK format followed by a
# 4-byte big-endian CRC32 of the UNCOMPRESSED payload.
# ---------------------------------------------------------------------------


def _snappy_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _snappy_compress(data: bytes) -> bytes:
    """Greedy snappy block-format compressor: 4-byte hash matches within a
    64 KiB window become copy elements (length 4..64, 2-byte offsets), the
    rest literals.  Any conformant snappy decoder reads the output; the
    ratio is modest but real on repetitive payloads (Avro blocks of
    same-schema records are exactly that)."""
    out = bytearray(_snappy_varint(len(data)))
    n = len(data)

    def emit_literal(lo: int, hi: int) -> None:
        nonlocal out
        ln = hi - lo - 1
        if ln < 0:
            return
        if ln < 60:
            out.append(ln << 2)
        else:
            nb = (ln.bit_length() + 7) // 8
            out.append((59 + nb) << 2)
            out += ln.to_bytes(nb, "little")
        out += data[lo:hi]

    table: dict[bytes, int] = {}
    i = 0
    lit = 0
    while i + 4 <= n:
        key = data[i:i + 4]
        j = table.get(key)
        table[key] = i
        if j is not None and 0 < i - j <= 0xFFFF:
            k = 4
            limit = min(64, n - i)
            while k < limit and data[j + k] == data[i + k]:
                k += 1
            emit_literal(lit, i)
            out.append(((k - 1) << 2) | 2)  # 2-byte-offset copy
            out += (i - j).to_bytes(2, "little")
            i += k
            lit = i
        else:
            i += 1
    emit_literal(lit, n)
    return bytes(out)


def _snappy_uncompress(data: bytes) -> bytes:
    """Full snappy block-format decoder (all literal and copy tags,
    including overlapping copies)."""
    n = 0
    shift = 0
    i = 0
    while True:
        if i >= len(data):
            raise ValueError("snappy: truncated preamble")
        b = data[i]
        i += 1
        n |= (b & 0x7F) << shift
        if not b & 0x80:
            break
        shift += 7
    out = bytearray()
    while i < len(data):
        tag = data[i]
        i += 1
        t = tag & 3
        if t == 0:  # literal
            ln = tag >> 2
            if ln >= 60:
                nb = ln - 59
                if i + nb > len(data):
                    raise ValueError("snappy: truncated literal length")
                ln = int.from_bytes(data[i:i + nb], "little")
                i += nb
            ln += 1
            if i + ln > len(data):
                raise ValueError("snappy: truncated literal")
            out += data[i:i + ln]
            i += ln
            continue
        nb = {1: 1, 2: 2, 3: 4}[t]
        if i + nb > len(data):
            raise ValueError("snappy: truncated copy element")
        if t == 1:  # copy, 1-byte offset
            ln = ((tag >> 2) & 0x7) + 4
            off = ((tag >> 5) << 8) | data[i]
        elif t == 2:  # copy, 2-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[i:i + 2], "little")
        else:  # copy, 4-byte offset
            ln = (tag >> 2) + 1
            off = int.from_bytes(data[i:i + 4], "little")
        i += nb
        if off == 0 or off > len(out):
            raise ValueError("snappy: copy offset out of range")
        start = len(out) - off
        if off >= ln:
            out += out[start:start + ln]
        else:  # overlapping copy: byte-at-a-time per spec
            for k in range(ln):
                out.append(out[start + k])
    if len(out) != n:
        raise ValueError(
            f"snappy: decoded {len(out)} bytes, preamble said {n}"
        )
    return bytes(out)


def _snappy_frame_avro(raw: bytes) -> bytes:
    return _snappy_compress(raw) + (zlib.crc32(raw) & 0xFFFFFFFF).to_bytes(
        4, "big"
    )


def _snappy_unframe_avro(payload: bytes) -> bytes:
    if len(payload) < 4:
        raise ValueError("snappy: block too short for CRC")
    raw = _snappy_uncompress(payload[:-4])
    crc = int.from_bytes(payload[-4:], "big")
    if (zlib.crc32(raw) & 0xFFFFFFFF) != crc:
        raise ValueError("snappy: CRC mismatch (corrupt block)")
    return raw


_META_SCHEMA = {"type": "map", "values": "bytes"}
_SYNC = bytes(
    [0x70, 0x68, 0x6F, 0x74, 0x6F, 0x6E, 0x2D, 0x74,
     0x70, 0x75, 0x2D, 0x73, 0x79, 0x6E, 0x63, 0x21]
)  # deterministic marker ("photon-tpu-sync!") — valid per spec


def _write_container_header(f: BinaryIO, schema: Any, codec: str) -> None:
    """Container magic + metadata + sync."""
    f.write(MAGIC)
    write_datum(f, _META_SCHEMA, {
        "avro.schema": json.dumps(schema).encode("utf-8"),
        "avro.codec": codec.encode("utf-8"),
    })
    f.write(_SYNC)


def _compress(payload: bytes, codec: str) -> bytes:
    """A block's payload as the codec stores it."""
    if codec == "deflate":
        return zlib.compress(payload)[2:-4]  # raw deflate per spec
    if codec == "snappy":
        return _snappy_frame_avro(payload)
    return payload


def _write_framed(f: BinaryIO, count: int, payload: bytes) -> None:
    write_long(f, count)
    write_bytes(f, payload)
    f.write(_SYNC)


def _write_block(f: BinaryIO, count: int, payload: bytes, codec: str) -> None:
    """One container block: codec framing + count + payload + sync."""
    _write_framed(f, count, _compress(payload, codec))


def write_container(
    path: str,
    schema: Any,
    records: Iterable[Any],
    codec: str = "deflate",
    records_per_block: int = 4096,
) -> None:
    assert codec in ("null", "deflate", "snappy")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        _write_container_header(f, schema, codec)

        block: list[Any] = []
        enc = _compile_writer(schema)

        def flush():
            if not block:
                return
            parts: list = []
            for rec in block:
                enc(parts.append, rec)
            _write_block(f, len(block), b"".join(parts), codec)
            block.clear()

        for rec in records:
            block.append(rec)
            if len(block) >= records_per_block:
                flush()
        flush()


def write_container_blocks(
    path: str,
    schema: Any,
    blocks: Iterable[tuple[int, bytes]],
    codec: str = "deflate",
) -> None:
    """:func:`write_container` for records already encoded: ``blocks``
    yields ``(record count, the records' bytes)`` a container block.  The
    blocks are compressed on a few threads (zlib lets go of the GIL) and
    written in order: the file is the one-thread file."""
    assert codec in ("null", "deflate", "snappy")
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)

    def framed(block):
        count, payload = block
        return count, _compress(payload, codec)

    with open(path, "wb") as f, ThreadPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1)) as pool:
        _write_container_header(f, schema, codec)
        for count, payload in pool.map(framed, blocks):
            if count:
                _write_framed(f, count, payload)


def write_scoring_container(
    path: str,
    uids,
    scores,
    labels,
    ids: dict,
    codec: str = "deflate",
    records_per_block: int = 4096,
) -> int:
    """Write ``ScoringResultAvro`` records from one block of columns (see
    :func:`write_scoring_blocks`).  Returns the rows written."""
    return write_scoring_blocks(path, [(uids, scores, labels, ids)],
                                codec=codec,
                                records_per_block=records_per_block)


def _encode_scoring_block_native(lib, uids, scores, labels, ids_cols):
    """One columnar ScoringResultAvro block body through the native encoder
    (``native/score_encoder.cpp``); None when the call cannot proceed."""
    import ctypes

    import numpy as np

    n = len(scores)
    uid_b = [b"" if u is None else str(u).encode("utf-8") for u in uids]
    uid_off = np.zeros(n + 1, np.int64)
    np.cumsum([len(b) for b in uid_b], out=uid_off[1:])
    uid_null = np.frombuffer(bytes(1 if u is None else 0 for u in uids),
                             np.uint8)
    scores64 = np.ascontiguousarray(scores, np.float64)
    label_null = np.frombuffer(bytes(1 if v is None else 0 for v in labels),
                               np.uint8)
    labels64 = np.asarray([0.0 if v is None else float(v) for v in labels],
                          np.float64)
    keys = list(ids_cols)
    key_b = [k.encode("utf-8") for k in keys]
    keys_off = np.zeros(len(keys) + 1, np.int64)
    np.cumsum([len(b) for b in key_b], out=keys_off[1:])
    # Column-major, as se_encode reads them.
    val_b: list[bytes] = []
    null_cols: list[bytes] = []
    for k in keys:
        col = ids_cols[k]
        val_b.extend(b"" if v is None else str(v).encode("utf-8")
                     for v in col)
        null_cols.append(bytes(1 if v is None else 0 for v in col))
    val_null = np.frombuffer(b"".join(null_cols), np.uint8)
    vals_off = np.zeros(len(val_b) + 1, np.int64)
    np.cumsum([len(b) for b in val_b], out=vals_off[1:])

    p_i64 = ctypes.POINTER(ctypes.c_int64)
    p_u8 = ctypes.POINTER(ctypes.c_uint8)
    p_f64 = ctypes.POINTER(ctypes.c_double)
    cap = int(uid_off[-1] + vals_off[-1] + (keys_off[-1] + 40) * n
              + 60 * n + 64)
    for _ in range(2):
        out = ctypes.create_string_buffer(cap)
        wrote = lib.se_encode(
            n, b"".join(uid_b), uid_off.ctypes.data_as(p_i64),
            uid_null.ctypes.data_as(p_u8), scores64.ctypes.data_as(p_f64),
            labels64.ctypes.data_as(p_f64), label_null.ctypes.data_as(p_u8),
            len(keys), b"".join(val_b), vals_off.ctypes.data_as(p_i64),
            val_null.ctypes.data_as(p_u8), b"".join(key_b),
            keys_off.ctypes.data_as(p_i64), out, cap,
        )
        if wrote >= 0:
            return out.raw[:wrote]
        cap = -int(wrote)  # the size the encoder asked for
    return None


def write_scoring_blocks(
    path: str,
    blocks: Iterable[tuple],
    codec: str = "deflate",
    records_per_block: int = 4096,
    stats: Optional[dict] = None,
) -> int:
    """Write ``ScoringResultAvro`` records from an iterable of column blocks
    ``(uids, scores, labels, ids)``, consumed one block at a time (the
    streamed scoring driver's generator): ``uids`` str or None, ``scores``
    and ``labels`` floats (a label may be None), ``ids`` column name →
    per-row values (a None entry is left out of that row's map, the
    join-miss contract).  Container blocks hold ``records_per_block``
    records whatever the input blocks' sizes.  A column absent from some
    input blocks is None there; the map keys keep the first block's order,
    and once a new column appears the columns are sorted.  The bytes are
    those of the reference's ``write_scoring_container`` given the same
    blocks.  A block body is encoded by the native encoder
    (``native/__init__.py::load_score_encoder``) when it builds, else by
    the per-record Python path, with the same bytes; ``stats["encoder"]``
    says which ran ("native", "python", or "mixed" if a native call gave
    up on a block).  Returns the rows written."""
    from photon_ml_tpu_torch.io.schemas import SCORING_RESULT
    from photon_ml_tpu_torch.native import load_score_encoder

    assert codec in ("null", "deflate", "snappy")
    lib = load_score_encoder()
    used: set = set()
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pend_u: list = []
    pend_s: list = []
    pend_l: list = []
    pend_ids: Optional[dict] = None
    total = 0

    def tolist(col):
        return col.tolist() if hasattr(col, "tolist") else list(col)

    def body_bytes(u, sc, lb, ids) -> bytes:
        if lib is not None:
            enc = _encode_scoring_block_native(lib, u, sc, lb, ids)
            if enc is not None:
                used.add("native")
                return enc
        used.add("python")
        out = _io.BytesIO()
        for i in range(len(sc)):
            write_datum(out, SCORING_RESULT, {
                "uid": u[i],
                "predictionScore": float(sc[i]),
                "label": None if lb[i] is None else float(lb[i]),
                "ids": {k: str(ids[k][i]) for k in ids
                        if ids[k][i] is not None},
            })
        return out.getvalue()

    with open(path, "wb") as f:
        _write_container_header(f, SCORING_RESULT, codec)

        def flush(count):
            nonlocal pend_u, pend_s, pend_l, total
            u, pend_u = pend_u[:count], pend_u[count:]
            sc, pend_s = pend_s[:count], pend_s[count:]
            lb, pend_l = pend_l[:count], pend_l[count:]
            ids = {k: v[:count] for k, v in pend_ids.items()}
            for k in pend_ids:
                pend_ids[k] = pend_ids[k][count:]
            _write_block(f, count, body_bytes(u, sc, lb, ids), codec)
            total += count

        for uids, scores, labels, ids in blocks:
            n_blk = len(scores)
            bad = [name for name, col in (
                ("uids", uids), ("labels", labels),
                *((f"ids[{k!r}]", v) for k, v in ids.items()))
                if len(col) != n_blk]
            if bad:
                # A misaligned column would silently shift values into
                # other rows.
                raise ValueError(
                    f"columns {bad} do not match len(scores)={n_blk}")
            if pend_ids is None:
                pend_ids = {k: [] for k in ids}
            else:
                new = [k for k in ids if k not in pend_ids]
                for k in new:
                    pend_ids[k] = [None] * len(pend_s)
                if new:
                    pend_ids = {k: pend_ids[k] for k in sorted(pend_ids)}
            pend_u.extend(tolist(uids))
            pend_s.extend(tolist(scores))
            pend_l.extend(tolist(labels))
            for k in pend_ids:
                pend_ids[k].extend(tolist(ids[k]) if k in ids
                                   else [None] * n_blk)
            while len(pend_s) >= records_per_block:
                flush(records_per_block)
        if pend_s:
            flush(len(pend_s))
    if stats is not None:
        if not used:  # no rows: the encoder that would have run
            used.add("python" if lib is None else "native")
        stats["encoder"] = used.pop() if len(used) == 1 else "mixed"
    return total


def _read_header(f: BinaryIO, path: str) -> tuple[Any, str, bytes]:
    """Parse the container header → (schema, codec, sync marker)."""
    if f.read(4) != MAGIC:
        raise ValueError(f"{path}: not an Avro container file")
    meta = read_datum(f, _META_SCHEMA)
    schema = json.loads(meta["avro.schema"].decode("utf-8"))
    codec = meta.get("avro.codec", b"null").decode("utf-8")
    if codec not in ("null", "deflate", "snappy"):
        raise ValueError(f"unsupported codec {codec!r}")
    sync = f.read(16)
    return schema, codec, sync


def iter_blocks(path: str) -> Iterator[tuple[Any, int, bytes]]:
    """Stream a container file block-by-block WITHOUT materializing records:
    yields (schema, record_count, decompressed_block_payload).  This is the
    scale path — a multi-GB file is processed one ~records_per_block chunk
    at a time (the reference streams Avro through Spark partitions the same
    way; SURVEY.md §7 hard-part "host→device ingest")."""
    with open(path, "rb") as f:
        schema, codec, sync = _read_header(f, path)
        while True:
            head = f.read(1)
            if not head:
                break
            f.seek(-1, 1)
            count = read_long(f)
            payload = read_bytes(f)
            if codec == "deflate":
                payload = zlib.decompress(payload, -15)
            elif codec == "snappy":
                payload = _snappy_unframe_avro(payload)
            if f.read(16) != sync:
                raise ValueError(f"{path}: sync marker mismatch (corrupt file)")
            yield schema, count, payload


def iter_container(path: str) -> Iterator[Any]:
    """Yield records one at a time, holding at most one block in memory."""
    dec = None
    for schema, count, payload in iter_blocks(path):
        dec = dec or _compile_reader(schema)
        pos = 0
        for _ in range(count):
            rec, pos = dec(payload, pos)
            yield rec


def read_schema(path: str) -> Any:
    with open(path, "rb") as f:
        schema, _, _ = _read_header(f, path)
    return schema


def read_container(path: str) -> tuple[Any, list[Any]]:
    """Read an Avro object container file → (schema, records).  Convenience
    for small files; use :func:`iter_blocks` for anything large."""
    records: list[Any] = []
    schema = dec = None
    for schema, count, payload in iter_blocks(path):
        dec = dec or _compile_reader(schema)
        records.extend(_decode_block(dec, count, payload))
    if schema is None:
        schema = read_schema(path)
    return schema, records
