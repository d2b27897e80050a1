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
            records = []
            for entity, (cols, vals) in sub.coefficients.items():
                variances = (
                    sub.variances.get(entity)
                    if sub.variances is not None
                    else None
                )
                if not np.all(np.isfinite(vals)) or (
                    variances is not None
                    and not np.all(np.isfinite(variances))
                ):
                    raise ValueError(
                        f"refusing to save coordinate {name!r}: entity "
                        f"{entity!r} carries non-finite coefficients — a "
                        "model with NaN/inf coefficients scores NaN; fix "
                        "the training run instead of persisting it"
                    )
                coefs = []
                for j, (c, v) in enumerate(zip(cols, vals)):
                    fname, _, term = imap.index_to_name(int(c)).partition("\x01")
                    coefs.append({
                        "name": fname,
                        "term": term,
                        "value": float(v),
                        "variance": (
                            float(variances[j]) if variances is not None
                            else None
                        ),
                    })
                records.append({"entityId": str(entity), "coefficients": coefs})
            avro.write_container(
                os.path.join(sub_dir, "coefficients.avro"),
                RANDOM_EFFECT_MODEL_SCHEMA,
                records,
            )
            manifest["fingerprints"][name] = {
                "version": 1,
                "task": model.task,
                "feature_count": sub.n_features,
                "n_entities": len(records),
                "coefficient_checksum": random_effect_checksum(records),
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
            _, records = avro.read_container(path)
            fp = fingerprints.get(name)
            if fp:
                actual = random_effect_checksum(records)
                if actual != fp.get("coefficient_checksum"):
                    raise ValueError(
                        f"{path}: coefficient checksum mismatch (file "
                        f"{actual[:16]}…, fingerprint "
                        f"{str(fp.get('coefficient_checksum'))[:16]}…) — "
                        "the coefficient file was modified/truncated "
                        "after save"
                    )
                if fp.get("n_entities") is not None and len(records) != \
                        fp["n_entities"]:
                    raise ValueError(
                        f"{path}: {len(records)} entities on disk, "
                        f"fingerprint says {fp['n_entities']}"
                    )
            else:
                _warn_unverified(
                    path, "no fingerprint in the metadata.json manifest"
                )
            imap = index_maps[coord["feature_shard"]]
            table = {}
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
            models[name] = RandomEffectModel(
                coefficients=table,
                feature_shard=coord["feature_shard"],
                entity_key=coord["entity_key"],
                task=manifest["task"],
                n_features=coord.get("n_features", len(imap)),
                variances=var_table or None,
            )
    return GameModel(models=models, task=manifest["task"]), index_maps
