"""Binary wire format for the serving data plane (port of
``photon_ml_tpu/serving/wire.py``: every frame byte for byte the
reference's).

JSON-over-HTTP is the compatibility path; this module is the fast one.
A frame is a fixed-layout, versioned container of dtype-tagged COLUMNS
(the ``ChunkCodec`` slot idiom from data/staging.py, applied to request
traffic): a 24-byte header, a 20-byte directory entry per column, a
names blob, then an 8-aligned payload holding each column as one
contiguous typed segment.  Decoding is zero-copy — every column comes
back as a ``np.frombuffer`` view straight over the received bytes, so a
thousand-row request costs a handful of pointer fixups, not a
thousand ``json.loads`` allocations.

Layout (all little-endian)::

    header   <4s magic "PHWF"> <u16 version> <u8 kind> <u8 flags>
             <u16 n_cols> <u16 reserved> <u32 n_rows>
             <u32 names_len> <u32 payload_len>
    dir[i]   <u32 name_off> <u16 name_len> <u8 dtype_tag> <u8 ndim>
             <u32 n0> <u32 n1> <u32 payload_off>
    names    UTF-8 blob, padded to 8 bytes
    payload  column segments, each 8-aligned

Three semantic layers ride the same container:

- **Request frames** (:func:`encode_request` / :func:`decode_request`):
  dense feature shards as ``(n, dim)`` float32 matrices with per-row
  presence masks, entity ids / tenants as offset+blob string columns,
  ``offset`` / ``timeout_ms`` as float64 so the binary path round-trips
  the exact doubles the JSON path carries (bitwise score parity is a
  contract, not an aspiration).  Named sparse features are JSON-only —
  the binary path refuses them at encode time.
- **Response frames** (:func:`encode_response` /
  :func:`decode_response`): float64 score/mean/latency columns plus a
  status byte and an error-string column, mirroring the JSON
  ``{"results": [...]}`` shape row for row.
- **Trusted row frames** (:func:`rows_to_request`): pre-parsed
  :class:`~photon_ml_tpu_torch.serving.runtime.Row` objects encoded for
  process-pool IPC (serving/protocol.py), replacing pickle on the
  score path.

Every decode refuses loudly (:class:`WireFormatError`) on a bad magic,
an unknown version, a truncated frame, a forged length, or an unknown
dtype tag — before trusting a single directory entry, mirroring the
256 MB frame cap discipline of serving/protocol.py.
"""

from __future__ import annotations

import struct
from typing import Optional, Sequence

import numpy as np

from photon_ml_tpu_torch.data.staging import wire_dtype_from_tag, wire_dtype_tag
from photon_ml_tpu_torch.serving.runtime import PRIORITIES, Row

#: HTTP content type negotiating the binary path on POST /score.
CONTENT_TYPE = "application/x-photon-frame"

#: Hard frame cap, mirroring serving/protocol.py — refuse before
#: believing a forged length.
MAX_WIRE_BYTES = 256 << 20

#: v2 adds OPTIONAL trace-context string columns (``trace:ctx`` on
#: request frames, ``meta:trace`` on worker-IPC frames) — distributed
#: tracing, PR 17.  Decoders accept every version in
#: :data:`COMPAT_VERSIONS`: a v1 frame simply has no trace column, so
#: old senders keep working against new receivers unchanged.
WIRE_VERSION = 2
COMPAT_VERSIONS = frozenset({1, 2})

#: frame kinds (header byte)
KIND_REQUEST = 1
KIND_RESPONSE = 2
#: worker-IPC frames (serving/protocol.py): one score submission with
#: routing metadata, and one successful score result.
KIND_SCORE_IPC = 3
KIND_RESULT_IPC = 4

_HEADER = struct.Struct("<4sHBBHHIII")
_DIR = struct.Struct("<IHBBIII")
_MAGIC = b"PHWF"
_ALIGN = 8

#: response status byte → JSON error kind (0 = success).
RESPONSE_STATUS = ("ok", "rejected", "deadline", "bad_request", "internal")
_STATUS_BY_KIND = {k: i for i, k in enumerate(RESPONSE_STATUS)}


class WireFormatError(ValueError):
    """A frame that must not be trusted: bad magic, unknown version,
    truncated or forged lengths, unknown dtype tag, or a semantic
    column that fails validation."""


def _pad(n: int) -> int:
    return (-n) % _ALIGN


# ---------------------------------------------------------------------------
# Container layer
# ---------------------------------------------------------------------------

def encode_columns(
    columns: dict, kind: int, n_rows: int
) -> bytes:
    """Pack named 1-D/2-D contiguous arrays into one frame.  Column
    order is preserved (decoders see insertion order)."""
    names_blob = bytearray()
    payload = bytearray()
    entries = []
    for name, arr in columns.items():
        arr = np.ascontiguousarray(arr)
        if arr.ndim not in (1, 2):
            raise ValueError(
                f"column {name!r} must be 1-D or 2-D, got {arr.ndim}-D"
            )
        tag = wire_dtype_tag(arr.dtype)
        nb = name.encode("utf-8")
        name_off = len(names_blob)
        names_blob += nb
        payload += b"\0" * _pad(len(payload))
        payload_off = len(payload)
        payload += arr.tobytes()
        n0 = arr.shape[0]
        n1 = arr.shape[1] if arr.ndim == 2 else 0
        entries.append(
            _DIR.pack(name_off, len(nb), tag, arr.ndim, n0, n1, payload_off)
        )
    names_padded = bytes(names_blob) + b"\0" * _pad(len(names_blob))
    header = _HEADER.pack(
        _MAGIC, WIRE_VERSION, kind, 0, len(entries), 0,
        n_rows, len(names_padded), len(payload),
    )
    return b"".join([header, *entries, names_padded, bytes(payload)])


def decode_columns(buf) -> tuple:
    """Decode a frame into ``(kind, n_rows, {name: array view})``.

    Views are zero-copy over ``buf`` (read-only when ``buf`` is
    ``bytes``).  Raises :class:`WireFormatError` before trusting any
    length field that disagrees with the actual byte count.
    """
    buf = memoryview(buf)
    if len(buf) < _HEADER.size:
        raise WireFormatError(
            f"truncated frame: {len(buf)} bytes < {_HEADER.size}-byte header"
        )
    (magic, version, kind, _flags, n_cols, _res, n_rows,
     names_len, payload_len) = _HEADER.unpack_from(buf, 0)
    if magic != _MAGIC:
        raise WireFormatError(
            f"bad magic {bytes(magic)!r}: not a wire frame"
        )
    if version not in COMPAT_VERSIONS:
        raise WireFormatError(
            f"unknown wire version {version} (this build speaks "
            f"{sorted(COMPAT_VERSIONS)})"
        )
    if names_len > MAX_WIRE_BYTES or payload_len > MAX_WIRE_BYTES:
        raise WireFormatError(
            f"forged frame lengths: names={names_len} "
            f"payload={payload_len} exceed the {MAX_WIRE_BYTES}-byte cap"
        )
    names_off = _HEADER.size + n_cols * _DIR.size
    payload_off = names_off + names_len
    total = payload_off + payload_len
    if len(buf) != total:
        raise WireFormatError(
            f"frame length mismatch: header promises {total} bytes, "
            f"got {len(buf)}"
        )
    names = buf[names_off:payload_off]
    payload = buf[payload_off:total]
    columns: dict = {}
    for i in range(n_cols):
        (name_off, name_len, tag, ndim, n0, n1, col_off) = _DIR.unpack_from(
            buf, _HEADER.size + i * _DIR.size
        )
        if name_off + name_len > names_len:
            raise WireFormatError(
                f"column {i} name range [{name_off}, {name_off + name_len}) "
                f"outside the {names_len}-byte names blob"
            )
        name = bytes(names[name_off:name_off + name_len]).decode("utf-8")
        try:
            dt = wire_dtype_from_tag(tag)
        except KeyError as exc:
            raise WireFormatError(
                f"column {name!r}: {exc.args[0]}"
            ) from None
        if ndim not in (1, 2):
            raise WireFormatError(
                f"column {name!r} claims {ndim} dims; frames carry 1-D "
                "or 2-D columns"
            )
        count = n0 * (n1 if ndim == 2 else 1)
        nbytes = count * dt.itemsize
        if col_off + nbytes > payload_len:
            raise WireFormatError(
                f"column {name!r} payload range [{col_off}, "
                f"{col_off + nbytes}) outside the {payload_len}-byte payload"
            )
        arr = np.frombuffer(payload, dt, count=count, offset=col_off)
        if ndim == 2:
            arr = arr.reshape(n0, n1)
        columns[name] = arr
    return kind, n_rows, columns


# ---------------------------------------------------------------------------
# String columns (offset + blob + presence mask)
# ---------------------------------------------------------------------------

def _encode_strings(
    columns: dict, name: str, values: Sequence[Optional[str]]
) -> None:
    offs = np.zeros(len(values) + 1, np.uint32)
    mask = np.zeros(len(values), np.uint8)
    blob = bytearray()
    for i, v in enumerate(values):
        if v is not None:
            mask[i] = 1
            blob += v.encode("utf-8")
        offs[i + 1] = len(blob)
    columns[f"{name}#off"] = offs
    columns[f"{name}#blob"] = np.frombuffer(bytes(blob), np.uint8) \
        if blob else np.zeros(0, np.uint8)
    columns[f"{name}#mask"] = mask


def _decode_strings(
    columns: dict, name: str, n: int
) -> list:
    offs = columns.get(f"{name}#off")
    blob = columns.get(f"{name}#blob")
    mask = columns.get(f"{name}#mask")
    if offs is None or blob is None or mask is None:
        raise WireFormatError(f"frame is missing string column {name!r}")
    if offs.shape != (n + 1,) or mask.shape != (n,):
        raise WireFormatError(
            f"string column {name!r} shaped {offs.shape}/{mask.shape} "
            f"for {n} rows"
        )
    raw = blob.tobytes()
    if len(offs) and int(offs[-1]) > len(raw):
        raise WireFormatError(
            f"string column {name!r} offsets overrun its blob"
        )
    out: list = []
    for i in range(n):
        if not mask[i]:
            out.append(None)
            continue
        lo, hi = int(offs[i]), int(offs[i + 1])
        if hi < lo:
            raise WireFormatError(
                f"string column {name!r} has non-monotone offsets"
            )
        out.append(raw[lo:hi].decode("utf-8"))
    return out


# ---------------------------------------------------------------------------
# Trace-context columns (optional, v2)
# ---------------------------------------------------------------------------

def _encode_trace(columns: dict, name: str, trace: Optional[str]) -> None:
    """Attach the serialized trace context (``TraceContext.
    header_value()``) as a one-entry optional string column.  None
    attaches nothing — an untraced frame is byte-identical to v1 except
    for the version field."""
    if trace is not None:
        _encode_strings(columns, name, [str(trace)])


def _decode_trace(columns: dict, name: str, n: int = 1) -> Optional[str]:
    if f"{name}#off" not in columns:
        return None  # v1 frame, or an untraced v2 frame
    return _decode_strings(columns, name, n)[0]


# ---------------------------------------------------------------------------
# Request layer
# ---------------------------------------------------------------------------

def encode_request(
    requests: Sequence[dict], trace: Optional[str] = None
) -> bytes:
    """Encode JSON-shaped request dicts into one request frame.

    Supports ``dense`` shards, ``ids``, ``offset``, ``timeout_ms``,
    ``priority`` and ``tenant``.  Named sparse ``features`` entries
    need the server-side index map — send those rows as JSON; this
    encoder refuses them so the fallback is explicit, not silent.
    """
    n = len(requests)
    if n == 0:
        raise ValueError("encode_request needs at least one request")
    offsets = np.zeros(n, np.float64)
    timeouts = np.full(n, np.nan, np.float64)
    priority = np.full(n, PRIORITIES.index("normal"), np.uint8)
    shard_vecs: dict = {}
    id_cols: dict = {}
    tenants: list = [None] * n
    for i, req in enumerate(requests):
        if not isinstance(req, dict):
            raise ValueError("each request must be a JSON-shaped dict")
        if req.get("features"):
            raise ValueError(
                "named sparse 'features' need the server-side index map; "
                "send those rows over the JSON path"
            )
        offsets[i] = float(req.get("offset") or 0.0)
        t = req.get("timeout_ms")
        if t is not None:
            timeouts[i] = float(t)
        p = req.get("priority", "normal")
        if p not in PRIORITIES:
            raise ValueError(
                f"priority must be one of {PRIORITIES}, got {p!r}"
            )
        priority[i] = PRIORITIES.index(p)
        tenant = req.get("tenant")
        if tenant is not None and not isinstance(tenant, str):
            raise ValueError(
                f"tenant must be a string, got {type(tenant).__name__}"
            )
        tenants[i] = tenant
        for shard, vec in (req.get("dense") or {}).items():
            arr = np.asarray(vec, np.float32)
            if arr.ndim != 1:
                raise ValueError(
                    f"shard {shard!r} must be a flat vector, got shape "
                    f"{arr.shape}"
                )
            shard_vecs.setdefault(str(shard), {})[i] = arr
        for key, value in (req.get("ids") or {}).items():
            if value is not None:
                id_cols.setdefault(str(key), [None] * n)[i] = str(value)
    columns: dict = {
        "offset": offsets,
        "timeout_ms": timeouts,
        "priority": priority,
    }
    for shard, by_row in shard_vecs.items():
        dim = {a.shape[0] for a in by_row.values()}
        if len(dim) != 1:
            raise ValueError(
                f"shard {shard!r} has inconsistent widths {sorted(dim)} "
                "across rows"
            )
        mat = np.zeros((n, dim.pop()), np.float32)
        mask = np.zeros(n, np.uint8)
        for i, arr in by_row.items():
            mat[i] = arr
            mask[i] = 1
        columns[f"dense:{shard}"] = mat
        columns[f"mask:{shard}"] = mask
    for key, values in id_cols.items():
        _encode_strings(columns, f"ids:{key}", values)
    _encode_strings(columns, "tenant", tenants)
    _encode_trace(columns, "trace:ctx", trace)
    return encode_columns(columns, KIND_REQUEST, n)


def rows_to_request(rows: Sequence[Row]) -> bytes:
    """Encode pre-parsed :class:`Row` objects — the trusted process-pool
    path (serving/protocol.py), where the parent already validated."""
    return encode_columns(
        _row_columns(rows), KIND_REQUEST, len(rows)
    )


def _row_columns(rows: Sequence[Row]) -> dict:
    n = len(rows)
    if n == 0:
        raise ValueError("rows_to_request needs at least one row")
    offsets = np.zeros(n, np.float64)
    timeouts = np.full(n, np.nan, np.float64)
    priority = np.zeros(n, np.uint8)
    shard_vecs: dict = {}
    id_cols: dict = {}
    tenants: list = [None] * n
    for i, row in enumerate(rows):
        offsets[i] = row.offset
        if row.timeout_ms is not None:
            timeouts[i] = row.timeout_ms
        priority[i] = PRIORITIES.index(row.priority)
        tenants[i] = row.tenant
        for shard, vec in row.features.items():
            if vec is None:
                continue
            shard_vecs.setdefault(shard, {})[i] = np.asarray(vec, np.float32)
        for key, value in row.ids.items():
            id_cols.setdefault(key, [None] * n)[i] = value
    columns: dict = {
        "offset": offsets,
        "timeout_ms": timeouts,
        "priority": priority,
    }
    for shard, by_row in shard_vecs.items():
        dim = next(iter(by_row.values())).shape[0]
        mat = np.zeros((n, dim), np.float32)
        mask = np.zeros(n, np.uint8)
        for i, arr in by_row.items():
            mat[i] = arr
            mask[i] = 1
        columns[f"dense:{shard}"] = mat
        columns[f"mask:{shard}"] = mask
    for key, values in id_cols.items():
        _encode_strings(columns, f"ids:{key}", values)
    _encode_strings(columns, "tenant", tenants)
    return columns


def decode_request(buf, parser=None) -> list:
    """Decode a request frame into :class:`Row` objects.

    With ``parser`` (a :class:`~photon_ml_tpu_torch.serving.runtime.
    RequestParser`) each dense shard is validated against the model's
    shard dims — unknown shards and wrong widths refuse exactly like
    the JSON parser.  ``parser=None`` is the trusted IPC path.  Feature
    vectors are zero-copy row views over ``buf``.
    """
    return decode_request_ex(buf, parser)[0]


def decode_request_ex(buf, parser=None) -> tuple:
    """:func:`decode_request` plus the frame's trace context:
    ``(rows, trace_str_or_None)``.  v1 frames and untraced v2 frames
    decode with ``trace=None``."""
    kind, n, columns = decode_columns(buf)
    if kind != KIND_REQUEST:
        raise WireFormatError(
            f"expected a request frame, got kind {kind}"
        )
    return (
        _rows_from_columns(n, columns, parser),
        _decode_trace(columns, "trace:ctx"),
    )


def _rows_from_columns(n: int, columns: dict, parser) -> list:
    if n == 0:
        raise WireFormatError("request frame carries zero rows")
    offsets = columns.get("offset")
    timeouts = columns.get("timeout_ms")
    priority = columns.get("priority")
    for name, col, shape in (
        ("offset", offsets, (n,)),
        ("timeout_ms", timeouts, (n,)),
        ("priority", priority, (n,)),
    ):
        if col is None:
            raise WireFormatError(f"request frame missing column {name!r}")
        if col.shape != shape:
            raise WireFormatError(
                f"column {name!r} shaped {col.shape}, expected {shape}"
            )
    shards: dict = {}
    for name, col in columns.items():
        if not name.startswith("dense:"):
            continue
        shard = name[len("dense:"):]
        if col.ndim != 2 or col.shape[0] != n:
            raise WireFormatError(
                f"shard {shard!r} shaped {col.shape} for {n} rows"
            )
        if parser is not None:
            dim = parser.shard_dims.get(shard)
            if dim is None:
                raise WireFormatError(f"unknown feature shard {shard!r}")
            if col.shape[1] != dim:
                raise WireFormatError(
                    f"shard {shard!r} expects {dim} features, got "
                    f"{col.shape[1]}"
                )
        mask = columns.get(f"mask:{shard}")
        if mask is None or mask.shape != (n,):
            raise WireFormatError(
                f"shard {shard!r} is missing its presence mask"
            )
        shards[shard] = (np.asarray(col, np.float32), mask)
    id_keys = sorted({
        name[len("ids:"):].rsplit("#", 1)[0]
        for name in columns if name.startswith("ids:")
    })
    ids_by_key = {
        key: _decode_strings(columns, f"ids:{key}", n) for key in id_keys
    }
    tenants = _decode_strings(columns, "tenant", n)
    rows: list = []
    for i in range(n):
        pr = int(priority[i])
        if pr >= len(PRIORITIES):
            raise WireFormatError(
                f"row {i} priority byte {pr} out of range"
            )
        features = {
            shard: mat[i]
            for shard, (mat, mask) in shards.items() if mask[i]
        }
        ids = {
            key: vals[i]
            for key, vals in ids_by_key.items() if vals[i] is not None
        }
        t = float(timeouts[i])
        rows.append(Row(
            features=features,
            ids=ids,
            offset=float(offsets[i]),
            timeout_ms=None if np.isnan(t) else t,
            priority=PRIORITIES[pr],
            tenant=tenants[i],
        ))
    return rows


# ---------------------------------------------------------------------------
# Response layer
# ---------------------------------------------------------------------------

def encode_response(results: Sequence[Optional[dict]]) -> bytes:
    """Encode ``score_many`` result dicts into one response frame.
    Scores ride as float64, so a JSON response and a binary response
    decode to bitwise-identical values."""
    n = len(results)
    score = np.zeros(n, np.float64)
    mean = np.zeros(n, np.float64)
    latency = np.zeros(n, np.float64)
    status = np.zeros(n, np.uint8)
    errors: list = [None] * n
    for i, r in enumerate(results):
        if r is None:
            status[i] = _STATUS_BY_KIND["internal"]
            errors[i] = "no result"
        elif "error" in r:
            status[i] = _STATUS_BY_KIND.get(
                r.get("kind", "internal"), _STATUS_BY_KIND["internal"]
            )
            errors[i] = str(r["error"])
        else:
            score[i] = r["score"]
            mean[i] = r["mean"]
            latency[i] = r["latency_ms"]
    columns: dict = {
        "score": score,
        "mean": mean,
        "latency_ms": latency,
        "status": status,
    }
    _encode_strings(columns, "error", errors)
    return encode_columns(columns, KIND_RESPONSE, n)


def decode_response(buf) -> list:
    """Decode a response frame back into the JSON ``results`` shape:
    ``{"score", "mean", "latency_ms"}`` per success row,
    ``{"error", "kind"}`` per failure row."""
    kind, n, columns = decode_columns(buf)
    if kind != KIND_RESPONSE:
        raise WireFormatError(
            f"expected a response frame, got kind {kind}"
        )
    for name in ("score", "mean", "latency_ms", "status"):
        col = columns.get(name)
        if col is None or col.shape != (n,):
            raise WireFormatError(
                f"response frame column {name!r} missing or misshaped"
            )
    errors = _decode_strings(columns, "error", n)
    status = columns["status"]
    out: list = []
    for i in range(n):
        s = int(status[i])
        if s >= len(RESPONSE_STATUS):
            raise WireFormatError(f"row {i} status byte {s} out of range")
        if s == 0:
            out.append({
                "score": float(columns["score"][i]),
                "mean": float(columns["mean"][i]),
                "latency_ms": float(columns["latency_ms"][i]),
            })
        else:
            out.append({
                "error": errors[i] or "",
                "kind": RESPONSE_STATUS[s],
            })
    return out


# ---------------------------------------------------------------------------
# Process-pool IPC layer (serving/protocol.py)
# ---------------------------------------------------------------------------

def encode_score_ipc(
    request_id: int,
    row: Row,
    tenant: Optional[str] = None,
    timeout_ms: Optional[float] = None,
    bypass: bool = False,
    trace: Optional[str] = None,
) -> bytes:
    """Encode one score submission for worker IPC: the parsed row plus
    the frame-level routing metadata that rides beside it."""
    columns = _row_columns([row])
    columns["meta:id"] = np.asarray([request_id], np.int64)
    columns["meta:timeout_ms"] = np.asarray(
        [np.nan if timeout_ms is None else float(timeout_ms)], np.float64
    )
    columns["meta:bypass"] = np.asarray([1 if bypass else 0], np.uint8)
    _encode_strings(columns, "meta:tenant", [tenant])
    _encode_trace(columns, "meta:trace", trace)
    return encode_columns(columns, KIND_SCORE_IPC, 1)


def decode_score_ipc(buf) -> dict:
    """Decode a score IPC frame back into the exact message dict shape
    serving/worker.py consumes."""
    kind, n, columns = decode_columns(buf)
    if kind != KIND_SCORE_IPC:
        raise WireFormatError(f"expected a score IPC frame, got kind {kind}")
    if n != 1:
        raise WireFormatError(f"score IPC frames carry one row, got {n}")
    rid = columns.get("meta:id")
    mt = columns.get("meta:timeout_ms")
    byp = columns.get("meta:bypass")
    for name, col in (("meta:id", rid), ("meta:timeout_ms", mt),
                      ("meta:bypass", byp)):
        if col is None or col.shape != (1,):
            raise WireFormatError(
                f"score IPC column {name!r} missing or misshaped"
            )
    row = _rows_from_columns(
        1, {k: v for k, v in columns.items() if not k.startswith("meta:")},
        None,
    )[0]
    t = float(mt[0])
    out = {
        "kind": "score",
        "id": int(rid[0]),
        "row": row,
        "tenant": _decode_strings(columns, "meta:tenant", 1)[0],
        "timeout_ms": None if np.isnan(t) else t,
        "bypass": bool(byp[0]),
    }
    trace = _decode_trace(columns, "meta:trace")
    if trace is not None:
        out["trace"] = trace
    return out


def encode_result_ipc(
    request_id: int, value: dict, trace: Optional[str] = None
) -> bytes:
    """Encode one successful score result for worker IPC.  Error
    results stay on the pickle path — they are rare and carry
    free-form strings."""
    columns: dict = {
        "meta:id": np.asarray([request_id], np.int64),
        "score": np.asarray([value["score"]], np.float64),
        "mean": np.asarray([value["mean"]], np.float64),
        "latency_ms": np.asarray([value["latency_ms"]], np.float64),
    }
    _encode_trace(columns, "meta:trace", trace)
    return encode_columns(columns, KIND_RESULT_IPC, 1)


def decode_result_ipc(buf) -> dict:
    """Decode a result IPC frame back into the worker's success
    message shape."""
    kind, n, columns = decode_columns(buf)
    if kind != KIND_RESULT_IPC:
        raise WireFormatError(f"expected a result IPC frame, got kind {kind}")
    if n != 1:
        raise WireFormatError(f"result IPC frames carry one row, got {n}")
    for name in ("meta:id", "score", "mean", "latency_ms"):
        col = columns.get(name)
        if col is None or col.shape != (1,):
            raise WireFormatError(
                f"result IPC column {name!r} missing or misshaped"
            )
    out = {
        "kind": "result",
        "id": int(columns["meta:id"][0]),
        "ok": True,
        "value": {
            "score": float(columns["score"][0]),
            "mean": float(columns["mean"][0]),
            "latency_ms": float(columns["latency_ms"][0]),
        },
    }
    trace = _decode_trace(columns, "meta:trace")
    if trace is not None:
        out["trace"] = trace
    return out
