"""GAME training-data ingest (Avro) — port of
``photon_ml_tpu/data/game_reader.py`` on the port's own ``io/avro.py``,
``data/index_map.py`` and native decoder (``photon_ml_tpu_torch/native``).
Host code: it fills numpy columns and scipy matrices, nothing touches a
device.

The analogue of the reference's ``AvroDataReader`` for GAME data
(SURVEY.md §2 "Avro IO", §3.2): each record carries response / weight /
offset, an ``ids`` map (entity id columns: userId, itemId, ...), and
feature bags as a map shard-name → [ {name, term, value} ] — the reference's
"feature shards"/"bags".  Reading produces per-shard CSR matrices over
per-shard feature index maps (built on the fly or supplied, the reference's
``IndexMapLoader`` behaviors).

Scale path: the file is STREAMED block-by-block (``io.avro.iter_blocks``) —
no list of record dicts is ever materialized — and blocks whose schema
matches the GAME example layout decode through a specialized flat decoder
(direct byte-offset parsing into typed accumulators, no per-record dict /
BytesIO / recursion).  Files with other schemas fall back to the generic
datum decoder, record by record.
"""

from __future__ import annotations

import logging
import struct
from typing import Optional

import numpy as np
import scipy.sparse as sp

from photon_ml_tpu_torch.data.index_map import INTERCEPT_KEY, IndexMap, feature_key
from photon_ml_tpu_torch.io import avro

GAME_EXAMPLE_SCHEMA = {
    "type": "record",
    "name": "GameTrainingExampleAvro",
    "fields": [
        {"name": "uid", "type": ["null", "string"]},
        {"name": "response", "type": "double"},
        {"name": "weight", "type": ["null", "double"]},
        {"name": "offset", "type": ["null", "double"]},
        {"name": "ids", "type": {"type": "map", "values": "string"}},
        {
            "name": "features",
            "type": {
                "type": "map",
                "values": {
                    "type": "array",
                    "items": {
                        "type": "record",
                        "name": "GameFeatureAvro",
                        "fields": [
                            {"name": "name", "type": "string"},
                            {"name": "term", "type": "string"},
                            {"name": "value", "type": "double"},
                        ],
                    },
                },
            },
        },
    ],
}


def write_game_avro(path: str, rows: list[dict]) -> None:
    """Write GAME examples (dicts shaped like GAME_EXAMPLE_SCHEMA)."""
    avro.write_container(path, GAME_EXAMPLE_SCHEMA, rows)


def _normalize_schema(s):
    """Canonical form for structural comparison: expand shorthand strings,
    drop annotation-only keys (doc/aliases/namespace/default)."""
    if isinstance(s, str):
        return {"type": s}
    if isinstance(s, list):
        return [_normalize_schema(b) for b in s]
    if isinstance(s, dict):
        keep = {}
        for k in ("type", "name", "fields", "items", "values", "symbols"):
            if k in s:
                v = s[k]
                if k == "fields":
                    v = [
                        {
                            "name": f["name"],
                            "type": _normalize_schema(f["type"]),
                        }
                        for f in v
                    ]
                elif k in ("type", "items", "values") and not isinstance(
                    v, str
                ):
                    v = _normalize_schema(v)
                keep[k] = v
        return keep
    return s


def _is_game_schema(schema) -> bool:
    """The flat byte-offset decoder is only safe when the schema matches the
    GAME example layout EXACTLY (field order, types, union branch order) —
    name-only matching would misparse e.g. a non-union ``uid``."""
    try:
        return _normalize_schema(schema) == _normalize_schema(
            GAME_EXAMPLE_SCHEMA
        )
    except (TypeError, KeyError):
        return False


class _Accumulator:
    """Typed columnar sinks shared by both decode paths."""

    def __init__(self, building: bool, forward: dict):
        self.building = building
        self.forward = forward  # shard -> {feature key -> col}
        self.response: list[float] = []
        self.weight: list[float] = []
        self.offset: list[float] = []
        self.uids: list[Optional[str]] = []
        self.id_cols: dict[str, list] = {}
        # shard -> (rows list, cols list, vals list)
        self.shard_rows: dict[str, tuple[list, list, list]] = {}
        self.dropped: dict[str, int] = {}
        self.n = 0

    def add_id(self, key: str, value: str) -> None:
        lst = self.id_cols.get(key)
        if lst is None:
            lst = self.id_cols[key] = []
        if len(lst) < self.n:  # rows before this column first appeared
            lst.extend([None] * (self.n - len(lst)))
        lst.append(value)

    def touch_shard(self, shard: str) -> None:
        """A shard seen in the data materializes (possibly all-zero) unless
        the scoring path is dropping it wholesale."""
        if shard not in self.shard_rows and (
            self.building or shard in self.forward
        ):
            if self.building and shard not in self.forward:
                self.forward[shard] = {}
            self.shard_rows[shard] = ([], [], [])

    def add_feature(self, shard: str, key: str, value: float) -> None:
        fwd = self.forward.get(shard)
        if fwd is None:
            if not self.building:
                self.dropped[shard] = self.dropped.get(shard, 0) + 1
                return
            fwd = self.forward[shard] = {}
        # The shard entry must exist even if every feature is dropped:
        # scoring data whose features all drifted out of the index map still
        # needs an all-zero (n, d) matrix, not a missing dict key.
        entry = self.shard_rows.get(shard)
        if entry is None:
            entry = self.shard_rows[shard] = ([], [], [])
        idx = fwd.get(key)
        if idx is None:
            if not self.building:
                self.dropped[shard] = self.dropped.get(shard, 0) + 1
                return
            idx = len(fwd)
            fwd[key] = idx
        entry[0].append(self.n)
        entry[1].append(idx)
        entry[2].append(value)

    def finish_row(self) -> None:
        self.n += 1


def _decode_game_blocks(path: str, acc: _Accumulator) -> None:
    """Specialized streaming decoder for GAME-schema container files."""
    for _schema, count, payload in avro.iter_blocks(path):
        _decode_game_payload(payload, count, acc)


def _decode_game_payload(payload, count: int, acc: _Accumulator) -> None:
    """Decode ONE container block's payload into ``acc`` (shared by the
    whole-file reader and the bounded-block scoring iterator)."""
    unpack_double = struct.Struct("<d").unpack_from
    pos = 0
    mv = payload

    def read_long():
        nonlocal pos
        shift = 0
        n = 0
        while True:
            b = mv[pos]
            pos += 1
            n |= (b & 0x7F) << shift
            if not b & 0x80:
                return (n >> 1) ^ -(n & 1)
            shift += 7

    def read_str():
        nonlocal pos
        ln = read_long()
        s = mv[pos : pos + ln].decode("utf-8")
        pos += ln
        return s

    for _ in range(count):
        acc.uids.append(read_str() if read_long() == 1 else None)
        acc.response.append(unpack_double(mv, pos)[0])
        pos += 8
        if read_long() == 1:
            acc.weight.append(unpack_double(mv, pos)[0])
            pos += 8
        else:
            acc.weight.append(1.0)
        if read_long() == 1:
            acc.offset.append(unpack_double(mv, pos)[0])
            pos += 8
        else:
            acc.offset.append(0.0)
        # ids map
        while True:
            c = read_long()
            if c == 0:
                break
            if c < 0:
                c = -c
                read_long()  # skip byte-size prefix
            for _ in range(c):
                k = read_str()
                acc.add_id(k, read_str())
        # features map: shard -> [ {name, term, value} ]
        while True:
            c = read_long()
            if c == 0:
                break
            if c < 0:
                c = -c
                read_long()
            for _ in range(c):
                shard = read_str()
                acc.touch_shard(shard)
                while True:
                    fc = read_long()
                    if fc == 0:
                        break
                    if fc < 0:
                        fc = -fc
                        read_long()
                    for _ in range(fc):
                        name = read_str()
                        term = read_str()
                        val = unpack_double(mv, pos)[0]
                        pos += 8
                        acc.add_feature(
                            shard, feature_key(name, term), val
                        )
        acc.finish_row()


def _native_preload_args(forward: dict) -> list:
    """Encode the shard vocabularies ONCE for session preloading — the
    per-block sessions of the streaming iterator must not re-sort and
    re-encode a multi-million-key vocabulary per yielded block."""
    import ctypes

    out = []
    for shard, fwd in forward.items():
        keys = [k for k, _ in sorted(fwd.items(), key=lambda kv: kv[1])]
        arr = (ctypes.c_char_p * len(keys))(
            *[k.encode("utf-8") for k in keys]
        )
        out.append((shard.encode("utf-8"), arr, len(keys)))
    return out


def _native_new(lib, acc: _Accumulator, preload_args: list = None):
    """Fresh native decode session with the accumulator's shard maps
    preloaded (scoring mode)."""
    h = lib.gd_new(1 if acc.building else 0)
    if not acc.building:
        if preload_args is None:
            preload_args = _native_preload_args(acc.forward)
        for shard_b, arr, nkeys in preload_args:
            lib.gd_preload_shard(h, shard_b, arr, nkeys)
    return h


def _native_feed(lib, h, path: str, payload, count: int) -> None:
    rc = lib.gd_decode_block(h, payload, len(payload), count)
    if rc != 0:
        raise ValueError(
            f"{path}: {lib.gd_error(h).decode()} (native decoder)"
        )


def _decode_game_blocks_native(path: str, acc: _Accumulator) -> bool:
    """Decode through the C++ session (photon_ml_tpu_torch/native): the whole
    per-feature hot path — varint parsing AND the feature-key→column hash
    lookups — runs in native code; only columnar arrays cross back.
    Returns False (leaving ``acc`` untouched) when the native library is
    unavailable, True on success.  Raises ValueError on malformed input,
    like the Python decoders."""
    from photon_ml_tpu_torch.native import load_game_decoder

    lib = load_game_decoder()
    if lib is None:
        return False
    h = _native_new(lib, acc)
    try:
        for _schema, count, payload in avro.iter_blocks(path):
            _native_feed(lib, h, path, payload, count)
        _native_extract(lib, h, acc)
        return True
    finally:
        lib.gd_free(h)


def _native_extract(lib, h, acc: _Accumulator) -> None:
    """Pull the session's accumulated columnar arrays into ``acc``
    (REPLACES the columnar fields — callers pass a fresh accumulator)."""
    import ctypes

    n = lib.gd_n_rows(h)
    acc.n = int(n)

    resp = np.empty(n, np.float64)
    wt = np.empty(n, np.float64)
    off = np.empty(n, np.float64)
    as_d = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    as_i = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))
    as_f = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))
    if n:
        lib.gd_copy_row_data(h, as_d(resp), as_d(wt), as_d(off))
    acc.response = resp
    acc.weight = wt
    acc.offset = off

    def _strings(blob_len, copy_fn):
        blob = ctypes.create_string_buffer(max(int(blob_len), 1))
        start = np.empty(n, np.int64)
        end = np.empty(n, np.int64)
        if n:
            copy_fn(blob, as_i(start), as_i(end))
        raw = blob.raw
        return [
            raw[s:e].decode("utf-8") if s >= 0 else None
            for s, e in zip(start, end)
        ]

    acc.uids = _strings(
        lib.gd_uid_blob_len(h),
        lambda b, s, e: lib.gd_copy_uids(h, b, s, e),
    )
    for i in range(lib.gd_n_id_cols(h)):
        name = lib.gd_id_col_name(h, i).decode("utf-8")
        acc.id_cols[name] = _strings(
            lib.gd_id_col_blob_len(h, i),
            lambda b, s, e, i=i: lib.gd_copy_id_col(h, i, b, s, e),
        )

    for i in range(lib.gd_n_shards(h)):
        shard = lib.gd_shard_name(h, i).decode("utf-8")
        dropped = int(lib.gd_shard_dropped(h, i))
        if dropped:
            acc.dropped[shard] = dropped
        if lib.gd_shard_unknown(h, i) or not lib.gd_shard_seen(h, i):
            # Unknown shard (scoring) → excluded; preloaded shard never
            # seen in the data → excluded (matches the Python paths).
            continue
        nnz = int(lib.gd_shard_nnz(h, i))
        rows = np.empty(nnz, np.int64)
        cols = np.empty(nnz, np.int64)
        vals = np.empty(nnz, np.float32)
        if nnz:
            lib.gd_copy_shard_coo(h, i, as_i(rows), as_i(cols), as_f(vals))
        acc.shard_rows[shard] = (rows, cols, vals)
        if acc.building:
            nkeys = int(lib.gd_shard_nkeys(h, i))
            blob = ctypes.create_string_buffer(
                max(int(lib.gd_shard_keys_blob_len(h, i)), 1)
            )
            offsets = np.empty(nkeys, np.int64)
            if nkeys:
                lib.gd_copy_shard_keys(h, i, blob, as_i(offsets))
            raw = blob.raw
            keys = []
            pos = 0
            for koff in offsets:
                keys.append(raw[pos:koff].decode("utf-8"))
                pos = int(koff)
            acc.forward[shard] = {k: j for j, k in enumerate(keys)}


def _decode_generic(path: str, acc: _Accumulator) -> None:
    """Fallback: stream records through the generic datum decoder."""
    for rec in avro.iter_container(path):
        _add_generic_record(rec, acc)


def _add_generic_record(rec, acc: _Accumulator) -> None:
    acc.uids.append(rec.get("uid"))
    acc.response.append(float(rec["response"]))
    acc.weight.append(
        1.0 if rec.get("weight") is None else float(rec["weight"])
    )
    acc.offset.append(
        0.0 if rec.get("offset") is None else float(rec["offset"])
    )
    for k, v in rec.get("ids", {}).items():
        acc.add_id(k, v)
    for shard, feats in rec.get("features", {}).items():
        acc.touch_shard(shard)
        for f in feats:
            acc.add_feature(
                shard, feature_key(f["name"], f["term"]), f["value"]
            )
    acc.finish_row()


def read_game_avro(
    path: str,
    index_maps: Optional[dict] = None,
    add_intercept_shards: tuple[str, ...] = (),
    logger=None,
    stats: Optional[dict] = None,
):
    """Read GAME Avro data.

    Returns ``(shards, ids, response, weight, offset, uids, index_maps)``
    where ``shards`` maps shard name → CSR matrix indexed by
    ``index_maps[shard]`` (built from the data when not supplied — supplying
    them is the scoring path, where unseen features are dropped, as the
    reference's scoring driver does).  ``stats``, when given, receives
    ``"decoder"``: ``"native"`` or ``"python"`` for the GAME schema,
    ``"generic"`` for another one.  :func:`iter_game_avro` reads a file
    in bounded row blocks instead (the streamed scoring path).
    """
    building = index_maps is None
    forward: dict[str, dict] = {
        s: dict(m) for s, m in (index_maps or {}).items()
    }
    acc = _Accumulator(building, forward)
    if not _is_game_schema(avro.read_schema(path)):
        decoder = "generic"
        _decode_generic(path, acc)
    elif _decode_game_blocks_native(path, acc):
        decoder = "native"
    else:
        decoder = "python"
        _decode_game_blocks(path, acc)
    if stats is not None:
        stats["decoder"] = decoder
    n = acc.n

    if acc.dropped:
        # Default to the module logger; drivers pass their PhotonLogger so
        # the warning lands in the job's photon.log artifact too.
        (logger or logging.getLogger(__name__)).warning(
            "read_game_avro(%s): dropped features absent from supplied index "
            "maps: %s",
            path,
            ", ".join(f"{s}={c}" for s, c in sorted(acc.dropped.items())),
        )

    shards: dict = {}
    out_maps: dict = {}
    for shard, (rows, cols, vals) in acc.shard_rows.items():
        fwd = forward[shard]
        if building and shard in add_intercept_shards:
            fwd.setdefault(INTERCEPT_KEY, len(fwd))
        imap = index_maps[shard] if not building else IndexMap.build(fwd)
        rows = np.asarray(rows, np.int64)
        cols = np.asarray(cols, np.int64)
        vals = np.asarray(vals, np.float32)
        if shard in add_intercept_shards and INTERCEPT_KEY in imap:
            icol = imap[INTERCEPT_KEY]
            rows = np.concatenate([rows, np.arange(n, dtype=np.int64)])
            cols = np.concatenate([cols, np.full(n, icol, np.int64)])
            vals = np.concatenate([vals, np.ones(n, np.float32)])
        shards[shard] = sp.csr_matrix(
            (vals, (rows, cols)), shape=(n, len(fwd)),
        )
        out_maps[shard] = imap

    ids = {}
    for k, lst in acc.id_cols.items():
        if len(lst) < n:  # trailing rows missing this column
            lst.extend([None] * (n - len(lst)))
        ids[k] = np.asarray(lst)
    response = np.asarray(acc.response, np.float32)
    weight = np.asarray(acc.weight, np.float32)
    offset = np.asarray(acc.offset, np.float32)
    return shards, ids, response, weight, offset, acc.uids, out_maps


def iter_game_avro(
    path: str,
    index_maps: dict,
    block_rows: int = 1 << 16,
    logger=None,
    id_keys=(),
    stats: Optional[dict] = None,
):
    """Read GAME Avro data in bounded row blocks: the out-of-core scoring
    read path (memory is one block of rows, never the file).

    Yields ``(shards, ids, response, weight, offset, uids)`` a block.
    Blocks flush at container-block boundaries once at least ``block_rows``
    rows have accumulated, so a block can exceed ``block_rows`` by at most
    one container block's rows.  ``index_maps`` is required (scoring reads
    through the saved maps; features not in them drop and are counted, and
    one warning reports the totals).  Every index-mapped shard appears in
    every block (all-zero when the block has no features for it), and every
    key of ``id_keys`` (the model's entity-id columns) appears in every
    block's ``ids`` (None-padded), in sorted key order.  The native decoder
    runs one session a block, with the vocabularies encoded once.
    ``stats``, when given, receives ``"decoder"`` as in
    :func:`read_game_avro`.
    """
    if index_maps is None:
        raise ValueError(
            "iter_game_avro needs saved index maps (the scoring path)")
    if block_rows <= 0:
        raise ValueError(f"block_rows must be positive, got {block_rows}")
    forward: dict[str, dict] = {s: dict(m) for s, m in index_maps.items()}
    dropped_total: dict[str, int] = {}

    def fresh_acc() -> _Accumulator:
        return _Accumulator(False, forward)

    def assemble(acc: _Accumulator):
        n = acc.n
        shards = {}
        for shard, fwd in forward.items():
            rows, cols, vals = acc.shard_rows.get(shard, ([], [], []))
            shards[shard] = sp.csr_matrix(
                (np.asarray(vals, np.float32),
                 (np.asarray(rows, np.int64), np.asarray(cols, np.int64))),
                shape=(n, len(fwd)),
            )
        ids = {}
        # Sorted key order: the resident reader's columns come in
        # whole-file order, and the scoring writer's bytes depend on it.
        for k in sorted(set(acc.id_cols) | set(id_keys)):
            lst = acc.id_cols.get(k, [])
            if len(lst) < n:
                lst = list(lst) + [None] * (n - len(lst))
            ids[k] = np.asarray(lst)
        for s, c in acc.dropped.items():
            dropped_total[s] = dropped_total.get(s, 0) + c
        return (shards, ids, np.asarray(acc.response, np.float32),
                np.asarray(acc.weight, np.float32),
                np.asarray(acc.offset, np.float32), acc.uids)

    acc = fresh_acc()
    decoder = "generic"
    if _is_game_schema(avro.read_schema(path)):
        from photon_ml_tpu_torch.native import load_game_decoder

        lib = load_game_decoder()
        if lib is not None:
            decoder = "native"
            h = None
            preload = _native_preload_args(forward)
            try:
                for _schema, count, payload in avro.iter_blocks(path):
                    if h is None:
                        h = _native_new(lib, acc, preload)
                    _native_feed(lib, h, path, payload, count)
                    if int(lib.gd_n_rows(h)) >= block_rows:
                        _native_extract(lib, h, acc)
                        lib.gd_free(h)
                        h = None
                        yield assemble(acc)
                        acc = fresh_acc()
                if h is not None:
                    _native_extract(lib, h, acc)
                    lib.gd_free(h)
                    h = None
            finally:
                if h is not None:
                    lib.gd_free(h)
        else:
            decoder = "python"
            for _schema, count, payload in avro.iter_blocks(path):
                _decode_game_payload(payload, count, acc)
                if acc.n >= block_rows:
                    yield assemble(acc)
                    acc = fresh_acc()
    else:
        for rec in avro.iter_container(path):
            _add_generic_record(rec, acc)
            if acc.n >= block_rows:
                yield assemble(acc)
                acc = fresh_acc()
    if stats is not None:
        stats["decoder"] = decoder
    if acc.n:
        yield assemble(acc)
    if dropped_total:
        (logger or logging.getLogger(__name__)).warning(
            "iter_game_avro(%s): dropped features absent from supplied "
            "index maps: %s", path,
            ", ".join(f"{s}={c}" for s, c in sorted(dropped_total.items())),
        )
