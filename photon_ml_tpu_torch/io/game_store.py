"""GAME model persistence (port of ``photon_ml_tpu/io/game_store.py``).

The on-disk format is the reference's, byte for byte in the coefficient
files and key for key in ``metadata.json``, so a model written by either
package loads in the other.

The analogue of the reference's ``ModelProcessingUtils`` GAME save/load
(SURVEY.md §3.2 "save GameModel ... Avro: fixed-effect + per-entity
coefficient files"): a directory with one Avro file per coordinate —
``fixed-effect/<name>/coefficients.avro`` holding one
BayesianLinearModelAvro record, ``random-effect/<name>/coefficients.avro``
holding one record per entity — plus per-shard index maps and a metadata
manifest for coordinate order/types.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct

import numpy as np

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.io import avro
from photon_ml_tpu_torch.io.model_store import (
    _warn_unverified,
    load_glm_model,
    save_glm_model,
)
from photon_ml_tpu_torch.ops.sparse import stable_argsort

RANDOM_EFFECT_MODEL_SCHEMA = {
    "type": "record",
    "name": "RandomEffectCoefficientsAvro",
    "fields": [
        {"name": "entityId", "type": "string"},
        {
            "name": "coefficients",
            "type": {
                "type": "array",
                "items": {
                    "type": "record",
                    "name": "EntityCoefficientAvro",
                    "fields": [
                        {"name": "name", "type": "string"},
                        {"name": "term", "type": "string"},
                        {"name": "value", "type": "double"},
                        # Optional per-coefficient variance (the reference's
                        # BayesianLinearModelAvro carries variances too).
                        {"name": "variance", "type": ["null", "double"]},
                    ],
                },
            },
        },
    ],
}


def random_effect_checksum(records) -> str:
    """sha256 over per-entity (entityId, name, term, value, variance)
    entries in file order — both save and load feed the raw Avro records,
    so the checksum binds to the persisted content."""
    h = hashlib.sha256()
    pack = struct.Struct("<d").pack
    for rec in records:
        # One update an entity: the digest of the concatenation.
        parts = [b"\x00ENTITY\x00", str(rec["entityId"]).encode()]
        for e in rec["coefficients"]:
            var = e.get("variance")
            parts += (str(e["name"]).encode(), b"\x00",
                      str(e["term"]).encode(), pack(float(e["value"])),
                      b"\x01" if var is None else pack(float(var)))
        h.update(b"".join(parts))
    return h.hexdigest()


# -- the random-effect file's records as flat arrays ----------------------
#
# A random-effect coordinate holds one record a entity and a few
# coefficients a record, hundreds of thousands of them.  Encoding, hashing
# and decoding them one Python object at a time is most of a GAME driver's
# model save and load, so both go through flat arrays instead: the record
# heads (entity ids) and each coefficient's (name, term) piece are joined
# as bytes, the values and variances are packed by numpy, and the pieces
# are copied into place by offset.  The bytes are the record-at-a-time
# path's (Avro's ``write_container`` and :func:`random_effect_checksum`).

_RECORDS_PER_BLOCK = 4096
_ENTITY_MARK = b"\x00ENTITY\x00"


def _avro_string(raw: bytes) -> bytes:
    return avro._varint(len(raw)) + raw


def _exclusive_cumsum(a: np.ndarray) -> np.ndarray:
    out = np.zeros(a.shape[0], np.int64)
    np.cumsum(a[:-1], out=out[1:])
    return out


def _copy_segments(out, blob, src, lens, dst) -> None:
    """``out[dst[i]:dst[i]+lens[i]] = blob[src[i]:src[i]+lens[i]]``."""
    total = int(lens.sum())
    if total == 0:
        return
    start = _exclusive_cumsum(lens)
    at = np.arange(total, dtype=np.int64)
    out[at + np.repeat(dst - start, lens)] = blob[at + np.repeat(
        src - start, lens)]


def _place_f8(out, pos, values) -> None:
    if pos.size:
        out[pos[:, None] + np.arange(8)] = np.ascontiguousarray(
            values, "<f8").view(np.uint8).reshape(-1, 8)


def _assemble(heads, counts, piece, vals, cv, var, pieces, *,
              null_tag: bytes, var_tag: bytes, tail: bytes):
    """The bytes of ``len(heads)`` records, each ``head`` then its
    ``counts[r]`` coefficients ``pieces[piece] + f8(value) + (null_tag |
    var_tag + f8(variance))`` (a variance where ``cv``) then ``tail``
    (empty or one zero byte).  ``pieces`` is ``(blob, start,
    length)`` of the distinct coefficient pieces.  Returns ``(bytes,
    record offsets)``."""
    blob, p_start, p_len = pieces
    n = len(heads)
    head_len = np.fromiter(map(len, heads), np.int64, n)
    rec_of = np.repeat(np.arange(n, dtype=np.int64), counts)
    c_len = p_len[piece] + 8 + np.where(cv, len(var_tag) + 8, len(null_tag))
    c_sum = np.bincount(rec_of, weights=c_len, minlength=n).astype(np.int64)
    rec_off = np.zeros(n + 1, np.int64)
    np.cumsum(head_len + c_sum + len(tail), out=rec_off[1:])
    out = np.zeros(int(rec_off[-1]), np.uint8)
    _copy_segments(out, np.frombuffer(b"".join(heads), np.uint8),
                   _exclusive_cumsum(head_len), head_len, rec_off[:-1])
    start = (rec_off[:-1] + head_len - _exclusive_cumsum(c_sum))[rec_of] \
        + _exclusive_cumsum(c_len)
    _copy_segments(out, blob, p_start[piece], p_len[piece], start)
    at = start + p_len[piece]
    _place_f8(out, at, vals)
    at += 8
    out[at[~cv]] = null_tag[0]
    if var_tag:
        out[at[cv]] = var_tag[0]
    _place_f8(out, at[cv] + len(var_tag), var[cv])
    return out, rec_off


def _piece_table(parts) -> tuple:
    """``(blob, start, length)`` of a list of byte strings."""
    lens = np.fromiter(map(len, parts), np.int64, len(parts))
    return (np.frombuffer(b"".join(parts) or b"\x00", np.uint8),
            _exclusive_cumsum(lens), lens)


class _FlatEffect:
    """One random-effect coordinate's records as flat arrays, in file
    order: entity ids, coefficient counts, and each coefficient's (name,
    term) pair (an index into ``names``), value, whether it carries a
    variance, and the variance (0 where none)."""

    def __init__(self, eids, counts, pair, names, vals, has_var, var):
        self.eids, self.counts, self.pair, self.names = (eids, counts, pair,
                                                         names)
        self.vals, self.has_var, self.var = vals, has_var, var

    def blocks(self, avro_bytes: bool, per_block: int = _RECORDS_PER_BLOCK):
        """``(record count, bytes)`` per block of ``per_block`` records:
        the Avro encoding, or the checksum's byte stream."""
        if avro_bytes:
            raws = [_avro_string(n.encode()) + _avro_string(t.encode())
                    for n, t in self.names]
            opts = dict(null_tag=b"\x00", var_tag=b"\x02", tail=b"\x00")
        else:
            raws = [n.encode() + b"\x00" + t.encode() for n, t in self.names]
            opts = dict(null_tag=b"\x01", var_tag=b"", tail=b"")
        pieces = _piece_table(raws)
        c_off = np.zeros(len(self.eids) + 1, np.int64)
        np.cumsum(self.counts, out=c_off[1:])
        for r0 in range(0, len(self.eids), per_block):
            r1 = min(r0 + per_block, len(self.eids))
            a, b = int(c_off[r0]), int(c_off[r1])
            heads = []
            for eid, k in zip(self.eids[r0:r1], self.counts[r0:r1].tolist()):
                raw = eid.encode()
                heads.append(
                    _avro_string(raw) + (avro._varint(k) if k else b"")
                    if avro_bytes else _ENTITY_MARK + raw)
            out, _ = _assemble(heads, self.counts[r0:r1], self.pair[a:b],
                               self.vals[a:b], self.has_var[a:b],
                               self.var[a:b], pieces, **opts)
            yield r1 - r0, out.tobytes()

    def checksum(self) -> str:
        h = hashlib.sha256()
        for _, data in self.blocks(avro_bytes=False):
            h.update(data)
        return h.hexdigest()


def _ragged(arrays, dtype):
    """``(lengths, concatenation)`` of a list of 1-d array-likes."""
    arrays = [np.asarray(x, dtype).reshape(-1) for x in arrays]
    lens = np.fromiter(map(len, arrays), np.int64, len(arrays))
    return lens, (np.concatenate(arrays) if arrays else np.zeros(0, dtype))


def _firsts(lens, flat, k):
    """The first ``k[r]`` entries of each segment r (``lens[r]`` long) of
    ``flat``."""
    within = np.arange(flat.shape[0]) - np.repeat(_exclusive_cumsum(lens),
                                                  lens)
    return flat[within < np.repeat(k, lens)]


def _flatten_effect(name: str, sub, imap) -> _FlatEffect:
    """The records :func:`save_game_model` writes for random-effect
    coordinate ``name`` (an entity's ``zip(cols, vals)``), flat; refuses
    non-finite coefficients or variances."""
    items = list(sub.coefficients.items())
    n = len(items)
    c_len, cols = _ragged([c for _, (c, _) in items], np.int64)
    v_len, vals = _ragged([v for _, (_, v) in items], np.float64)
    var_of = ([sub.variances.get(e) for e, _ in items]
              if sub.variances is not None else [None] * n)
    has_var = np.fromiter((v is not None for v in var_of), bool, n)
    w_len, var = _ragged([v for v in var_of if v is not None], np.float64)
    bad = np.bincount(np.repeat(np.arange(n), v_len),
                      weights=~np.isfinite(vals), minlength=n)
    bad[has_var] += np.bincount(np.repeat(np.arange(w_len.shape[0]), w_len),
                                weights=~np.isfinite(var),
                                minlength=w_len.shape[0])
    if bad.any():
        raise ValueError(
            f"refusing to save coordinate {name!r}: entity "
            f"{items[int(np.flatnonzero(bad)[0])][0]!r} carries non-finite "
            "coefficients — a model with NaN/inf coefficients scores NaN; "
            "fix the training run instead of persisting it"
        )
    counts = np.minimum(c_len, v_len)
    short = np.flatnonzero(w_len < counts[has_var])
    if short.size:
        r = int(np.flatnonzero(has_var)[short[0]])
        raise IndexError(f"entity {items[r][0]!r}: {w_len[short[0]]} "
                         f"variances for {counts[r]} coefficients")
    cols = _firsts(c_len, cols, counts)
    vals = _firsts(v_len, vals, counts)
    var_full = np.zeros(vals.shape[0])
    var_full[np.repeat(has_var, counts)] = _firsts(w_len, var,
                                                   counts[has_var])
    distinct, pair = np.unique(cols, return_inverse=True)
    names = []
    for c in distinct.tolist():
        fname, _, term = imap.index_to_name(int(c)).partition("\x01")
        names.append((fname, term))
    return _FlatEffect([str(e) for e, _ in items], counts,
                       pair.reshape(-1).astype(np.int64), names, vals,
                       np.repeat(has_var, counts), var_full)


def _varint_at(buf, pos):
    b = buf[pos]
    if b < 0x80:
        return (b >> 1) ^ -(b & 1), pos + 1
    return avro._read_varint(buf, pos)


def _decode_effect_block(buf, count, eids, counts, pair, pair_ids, names,
                         val_at, var_at):
    """Append one block's records to the flat columns; the value and
    variance positions go to ``val_at`` / ``var_at`` (-1: no variance)."""
    pos = 0
    for _ in range(count):
        n, pos = _varint_at(buf, pos)
        end = pos + n
        if n < 0 or end > len(buf):
            raise EOFError("truncated bytes")
        eids.append(str(buf[pos:end], "utf-8"))
        pos = end
        total = 0
        while True:
            k, pos = _varint_at(buf, pos)
            if k == 0:
                break
            if k < 0:
                k = -k
                _, pos = _varint_at(buf, pos)
            total += k
            for _ in range(k):
                start = pos
                n, pos = _varint_at(buf, pos)
                n, pos = _varint_at(buf, pos + n)
                pos += n
                key = buf[start:pos]
                pid = pair_ids.get(key)
                if pid is None:
                    name, at = avro._read_raw(key, 0)
                    term, _ = avro._read_raw(key, at)
                    pid = pair_ids[key] = len(names)
                    names.append((str(name, "utf-8"), str(term, "utf-8")))
                pair.append(pid)
                val_at.append(pos)
                tag = buf[pos + 8]
                if tag == 0:
                    var_at.append(-1)
                    pos += 9
                elif tag == 2:
                    var_at.append(pos + 9)
                    pos += 17
                else:
                    raise ValueError(f"union branch byte {tag}")
        counts.append(total)
    if pos > len(buf):
        raise EOFError("truncated record")


def _gather_f8(buf: np.ndarray, at: np.ndarray) -> np.ndarray:
    return buf[at[:, None] + np.arange(8)].view("<f8").reshape(-1)


def _read_effect(path: str):
    """A random-effect file's records as a :class:`_FlatEffect`, or None
    when the file is not in :data:`RANDOM_EFFECT_MODEL_SCHEMA` or does not
    decode here (the caller then reads it record by record, which raises
    what it raises)."""
    eids, counts, pair, names, vals, flags, var = [], [], [], [], [], [], []
    pair_ids: dict = {}
    for schema, count, payload in avro.iter_blocks(path):
        if schema != RANDOM_EFFECT_MODEL_SCHEMA:
            return None
        val_at, var_at = [], []
        try:
            _decode_effect_block(payload, count, eids, counts, pair,
                                 pair_ids, names, val_at, var_at)
            buf = np.frombuffer(payload, np.uint8)
            var_at = np.asarray(var_at, np.int64)
            has = var_at >= 0
            v = np.zeros(var_at.shape[0])
            v[has] = _gather_f8(buf, var_at[has])
            vals.append(_gather_f8(buf, np.asarray(val_at, np.int64)))
        except (IndexError, ValueError, EOFError):
            return None
        flags.append(has)
        var.append(v)
    cat = (lambda xs, dt: np.concatenate(xs) if xs else np.zeros(0, dt))
    return _FlatEffect(eids, np.asarray(counts, np.int64),
                       np.asarray(pair, np.int64), names,
                       cat(vals, np.float64), cat(flags, bool),
                       cat(var, np.float64))


def _effect_tables(flat: _FlatEffect, imap) -> tuple[dict, dict]:
    """(coefficients, variances) of :class:`RandomEffectModel` from a
    file's flat records: each entity's features that ``imap`` knows, its
    columns ascending (ties in file order), values and variances float32;
    a variance row only for entities with a variance among those
    features."""
    n = len(flat.eids)
    pair_col = np.asarray([imap.get_index(feature_key(name, term))
                           for name, term in flat.names], np.int64)
    col = pair_col[flat.pair] if flat.pair.size else flat.pair
    keep = col >= 0
    rec = np.repeat(np.arange(n, dtype=np.int64), flat.counts)[keep]
    col = col[keep]
    bound = int(col.max()) + 1 if col.size else 1
    order = stable_argsort(rec * bound + col, max(n, 1) * bound)
    cols = col[order].astype(np.int32)
    vals = flat.vals[keep][order].astype(np.float32)
    var = flat.var[keep][order].astype(np.float32)
    with_var = np.bincount(rec, weights=flat.has_var[keep],
                           minlength=n) > 0
    off = np.zeros(n + 1, np.int64)
    np.cumsum(np.bincount(rec, minlength=n), out=off[1:])
    table, var_table = {}, {}
    bounds = off.tolist()
    for r, eid in enumerate(flat.eids):
        a, b = bounds[r], bounds[r + 1]
        table[eid] = (cols[a:b], vals[a:b])
        if with_var[r]:
            var_table[eid] = var[a:b]
    return table, var_table


def _tables_from_records(records, imap) -> tuple[dict, dict]:
    """:func:`_effect_tables` over decoded records (files in another
    schema, e.g. without the variance field)."""
    table: dict = {}
    var_table: dict = {}
    for rec in records:
        cols, vals, variances = [], [], []
        for e in rec["coefficients"]:
            idx = imap.get_index(feature_key(e["name"], e["term"]))
            if idx >= 0:
                cols.append(idx)
                vals.append(e["value"])
                # Older files lack the variance field entirely.
                variances.append(e.get("variance"))
        cols = np.asarray(cols, np.int32)
        vals = np.asarray(vals, np.float32)
        # Store invariant: columns ascending (coefficient_matrix_for
        # binary-searches them).
        order = np.argsort(cols, kind="stable")
        table[rec["entityId"]] = (cols[order], vals[order])
        if any(v is not None for v in variances):
            var = np.asarray(
                [0.0 if v is None else v for v in variances],
                np.float32,
            )
            var_table[rec["entityId"]] = var[order]
    return table, var_table


def save_game_model(
    model: GameModel, index_maps: dict, directory: str
) -> None:
    """``index_maps`` maps feature-shard name → IndexMap.

    ``metadata.json`` carries a per-coordinate fingerprint (feature
    count, task, coefficient checksum) that :func:`load_game_model`
    verifies; non-finite coefficients are rejected here instead of being
    silently persisted.  Fixed-effect means may be tensors on any device."""
    os.makedirs(directory, exist_ok=True)
    manifest = {"task": model.task, "coordinates": [], "fingerprints": {}}
    for name, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            sub_dir = os.path.join(directory, "fixed-effect", name)
            os.makedirs(sub_dir, exist_ok=True)
            manifest["fingerprints"][name] = save_glm_model(
                sub.model,
                index_maps[sub.feature_shard],
                os.path.join(sub_dir, "coefficients.avro"),
                model_id=name,
            )
            manifest["coordinates"].append(
                {"name": name, "type": "fixed", "feature_shard": sub.feature_shard}
            )
        else:
            sub_dir = os.path.join(directory, "random-effect", name)
            os.makedirs(sub_dir, exist_ok=True)
            imap = index_maps[sub.feature_shard]
            flat = _flatten_effect(name, sub, imap)
            avro.write_container_blocks(
                os.path.join(sub_dir, "coefficients.avro"),
                RANDOM_EFFECT_MODEL_SCHEMA,
                flat.blocks(avro_bytes=True),
            )
            manifest["fingerprints"][name] = {
                "version": 1,
                "task": model.task,
                "feature_count": sub.n_features,
                "n_entities": len(flat.eids),
                "coefficient_checksum": flat.checksum(),
            }
            manifest["coordinates"].append({
                "name": name,
                "type": "random",
                "feature_shard": sub.feature_shard,
                "entity_key": sub.entity_key,
                "n_features": sub.n_features,
            })
    for shard, imap in index_maps.items():
        imap.save(os.path.join(directory, "index-maps", shard))
    with open(os.path.join(directory, "metadata.json"), "w") as f:
        json.dump(manifest, f, indent=2)


def read_fingerprints(directory: str) -> dict:
    """Read per-coordinate fingerprints from ``metadata.json`` WITHOUT
    loading any coefficient Avro — the cheap HEAD that ops tooling (and the
    reference's delta differ, ``freshness/delta.py``) use to decide which
    coordinates changed before paying for a full parse.

    Returns coordinate name → fingerprint dict (``task``,
    ``feature_count``, ``coefficient_checksum``, and ``n_entities`` for
    random-effect coordinates).  A legacy directory whose manifest lacks
    fingerprints (entirely or for some coordinate) raises a pointed
    error: "unknown" would make a differ treat it as unchanged."""
    meta_path = os.path.join(directory, "metadata.json")
    with open(meta_path) as f:
        manifest = json.load(f)
    fingerprints = manifest.get("fingerprints") or {}
    missing = [
        c["name"] for c in manifest["coordinates"]
        if c["name"] not in fingerprints
    ]
    if missing:
        raise ValueError(
            f"{meta_path}: no fingerprint for coordinate(s) "
            f"{', '.join(repr(m) for m in missing)} — this model predates "
            "fingerprinting, so its content cannot be compared or "
            "delta-diffed; re-save it with the current writer "
            "(save_game_model) to attach fingerprints"
        )
    return fingerprints


def load_game_model(directory: str, device=None) -> tuple[GameModel, dict]:
    """Returns (model, index_maps-by-shard).  Fixed-effect coefficients
    land on ``device`` (default CUDA; ``"cpu"`` on request); random-effect
    tables are host numpy.

    Models saved with manifest fingerprints are verified per coordinate
    (random-effect checksums here, fixed-effect sidecars inside
    ``load_glm_model``); pre-fingerprint directories load unverified,
    with a pointed warning per unverified coordinate (tampering on such a
    model is undetectable, so the condition must be visible)."""
    with open(os.path.join(directory, "metadata.json")) as f:
        manifest = json.load(f)
    fingerprints = manifest.get("fingerprints") or {}
    index_maps: dict = {}
    imap_root = os.path.join(directory, "index-maps")
    if os.path.isdir(imap_root):
        for shard in os.listdir(imap_root):
            index_maps[shard] = IndexMap.load(os.path.join(imap_root, shard))

    models: dict = {}
    for coord in manifest["coordinates"]:
        name = coord["name"]
        if coord["type"] == "fixed":
            path = os.path.join(
                directory, "fixed-effect", name, "coefficients.avro"
            )
            glm, imap = load_glm_model(
                path, index_maps.get(coord["feature_shard"]), device=device
            )
            index_maps.setdefault(coord["feature_shard"], imap)
            models[name] = FixedEffectModel(glm, coord["feature_shard"])
        else:
            path = os.path.join(
                directory, "random-effect", name, "coefficients.avro"
            )
            flat = _read_effect(path)
            if flat is None:
                _, records = avro.read_container(path)
                n_entities = len(records)
            else:
                n_entities = len(flat.eids)
            fp = fingerprints.get(name)
            if fp:
                actual = (random_effect_checksum(records) if flat is None
                          else flat.checksum())
                if actual != fp.get("coefficient_checksum"):
                    raise ValueError(
                        f"{path}: coefficient checksum mismatch (file "
                        f"{actual[:16]}…, fingerprint "
                        f"{str(fp.get('coefficient_checksum'))[:16]}…) — "
                        "the coefficient file was modified/truncated "
                        "after save"
                    )
                if fp.get("n_entities") is not None and n_entities != \
                        fp["n_entities"]:
                    raise ValueError(
                        f"{path}: {n_entities} entities on disk, "
                        f"fingerprint says {fp['n_entities']}"
                    )
            else:
                _warn_unverified(
                    path, "no fingerprint in the metadata.json manifest"
                )
            imap = index_maps[coord["feature_shard"]]
            if flat is None:
                table, var_table = _tables_from_records(records, imap)
            else:
                table, var_table = _effect_tables(flat, imap)
            models[name] = RandomEffectModel(
                coefficients=table,
                feature_shard=coord["feature_shard"],
                entity_key=coord["entity_key"],
                task=manifest["task"],
                n_features=coord.get("n_features", len(imap)),
                variances=var_table or None,
            )
    return GameModel(models=models, task=manifest["task"]), index_maps
