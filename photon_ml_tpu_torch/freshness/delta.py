"""Model deltas: diff two models into a compact artifact, apply it back
(port of ``photon_ml_tpu/freshness/delta.py``: the same checksums,
manifest and segment files, so either package reads — and applies — the
other's artifacts).

A delta artifact is a directory:

    delta.json                  manifest (self-digested, shm_model style)
    segment-<coordinate>.npz    one payload file per CHANGED coordinate

The manifest records, per coordinate, an ORDER-INDEPENDENT table
checksum of the base and of the target (sha256 over sorted entities'
exact float32/int32 bit patterns — unlike the save-order Avro
fingerprints in ``io/game_store.py``, these are computable from any
in-memory model, so online refinement can diff without a disk round
trip).  Apply verifies the serving model against every base checksum
before touching anything ("this delta was diffed against a different
base" is a refusal, not a corruption), patches only the changed
entities, and verifies the result against the target checksums — so a
delta-applied model is PROVABLY bitwise-identical to a full reload of
the target.

Random-effect segments hold only the changed entities (CSR-style
concatenated cols/vals plus per-entity spans); fixed-effect segments
hold the replacement dense vector (a fixed coordinate has no per-entity
granularity).  Every segment carries its sha256 in the manifest; the
manifest carries a digest of itself — torn writes and tampering both
fail loudly at read.
"""

from __future__ import annotations

import dataclasses
import hashlib
import io as io_lib
import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel

DELTA_FORMAT = "photon-model-delta-v1"
MANIFEST_FILE = "delta.json"


class DeltaError(RuntimeError):
    """Base class for delta refusals — every message names the artifact
    or model at fault and what the operator should do about it."""


class DeltaFormatError(DeltaError):
    """The artifact itself is unreadable: torn, tampered, or not a
    delta.  Re-publish from the source models; never apply it."""


class DeltaBaseMismatchError(DeltaError):
    """The artifact is intact but was diffed against a DIFFERENT base
    than the model it is being applied to.  Applying it would produce a
    model that matches neither endpoint — do a full reload instead."""


# ---------------------------------------------------------------------------
# Order-independent table checksums
# ---------------------------------------------------------------------------

def _canon_cols(cols) -> np.ndarray:
    return np.ascontiguousarray(to_numpy(cols).astype(np.int32, copy=False))


def _canon_vals(vals) -> np.ndarray:
    return np.ascontiguousarray(
        to_numpy(vals).astype(np.float32, copy=False))


def fixed_table_checksum(glm: GeneralizedLinearModel) -> str:
    """sha256 over the dense float32 coefficient (and variance) bit
    patterns of one fixed-effect GLM."""
    h = hashlib.sha256()
    h.update(str(glm.task).encode())
    h.update(b"\x00MEANS\x00")
    h.update(_canon_vals(glm.coefficients.means).tobytes())
    h.update(b"\x00VARIANCES\x00")
    if glm.coefficients.variances is not None:
        h.update(_canon_vals(glm.coefficients.variances).tobytes())
    return h.hexdigest()


def random_table_checksum(sub: RandomEffectModel) -> str:
    """sha256 over (entity, cols, vals, variances) for every entity in
    SORTED entity order — two tables with the same content hash equal
    regardless of dict insertion order, so an in-memory refined model
    and its disk round trip agree."""
    h = hashlib.sha256()
    h.update(str(sub.task).encode())
    for entity in sorted(sub.coefficients, key=str):
        cols, vals = sub.coefficients[entity]
        h.update(b"\x00ENTITY\x00")
        h.update(str(entity).encode())
        h.update(b"\x00")
        h.update(_canon_cols(cols).tobytes())
        h.update(_canon_vals(vals).tobytes())
        var = None if sub.variances is None else sub.variances.get(entity)
        if var is None:
            h.update(b"\x00")
        else:
            h.update(b"\x01")
            h.update(_canon_vals(var).tobytes())
    return h.hexdigest()


def model_table_checksums(model: GameModel) -> Dict[str, str]:
    """Coordinate name → order-independent table checksum."""
    out = {}
    for name, sub in model.models.items():
        if isinstance(sub, FixedEffectModel):
            out[name] = fixed_table_checksum(sub.model)
        else:
            out[name] = random_table_checksum(sub)
    return out


# ---------------------------------------------------------------------------
# The delta value object
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CoordinateDelta:
    """One coordinate's change set.  ``changed_entities`` /
    ``removed`` carry the random-effect payload; ``means`` /
    ``variances`` the fixed-effect replacement.  An unchanged
    coordinate has neither — it rides along only so apply can verify
    its base checksum."""

    name: str
    kind: str  # "fixed" | "random"
    feature_shard: str
    base_checksum: str
    target_checksum: str
    entity_key: str = ""
    n_features: int = 0
    # random-effect payload: entity -> (cols int32, vals float32,
    # variances float32 | None)
    changed_entities: Optional[Dict[str, Tuple]] = None
    removed: Tuple[str, ...] = ()
    # fixed-effect payload
    means: Optional[np.ndarray] = None
    variances: Optional[np.ndarray] = None

    @property
    def changed(self) -> bool:
        return self.base_checksum != self.target_checksum

    @property
    def n_changed(self) -> int:
        if self.kind == "fixed":
            return 1 if self.changed else 0
        return len(self.changed_entities or {}) + len(self.removed)


@dataclasses.dataclass(frozen=True)
class ModelDelta:
    """An ordered set of coordinate deltas between two structurally
    identical models, plus the wall epoch of the newest event the
    target model has absorbed (the freshness anchor)."""

    task: str
    coordinates: List[CoordinateDelta]
    event_wall_epoch: Optional[float] = None

    @property
    def changed_coordinates(self) -> List[CoordinateDelta]:
        return [c for c in self.coordinates if c.changed]

    @property
    def n_changed_rows(self) -> int:
        return sum(c.n_changed for c in self.coordinates)

    @property
    def empty(self) -> bool:
        return not any(c.changed for c in self.coordinates)


# ---------------------------------------------------------------------------
# Diff
# ---------------------------------------------------------------------------

def _rows_equal(a: Tuple, b: Tuple, va, vb) -> bool:
    if _canon_cols(a[0]).tobytes() != _canon_cols(b[0]).tobytes():
        return False
    if _canon_vals(a[1]).tobytes() != _canon_vals(b[1]).tobytes():
        return False
    if (va is None) != (vb is None):
        return False
    if va is not None and _canon_vals(va).tobytes() != _canon_vals(vb).tobytes():
        return False
    return True


def _structural_refusal(name: str, why: str) -> DeltaError:
    return DeltaError(
        f"cannot delta coordinate {name!r}: {why} — a delta expresses "
        "changed coefficient VALUES only; structural changes (added/"
        "removed coordinates, kind or shard changes) need a full model "
        "publish + full reload"
    )


def diff_game_models(
    base: GameModel,
    target: GameModel,
    event_wall_epoch: Optional[float] = None,
) -> ModelDelta:
    """Diff two in-memory models with identical coordinate structure.

    ``event_wall_epoch`` is the wall time of the newest labeled event the
    target has absorbed; it rides the artifact so the apply side can
    record event→servable latency."""
    if base.task != target.task:
        raise _structural_refusal(
            "*", f"task changed ({base.task!r} -> {target.task!r})"
        )
    if list(base.models) != list(target.models):
        raise _structural_refusal(
            "*",
            f"coordinate set changed ({list(base.models)} -> "
            f"{list(target.models)})",
        )
    coords: List[CoordinateDelta] = []
    for name, base_sub in base.models.items():
        target_sub = target.models[name]
        if type(base_sub) is not type(target_sub):
            raise _structural_refusal(name, "coordinate kind changed")
        if base_sub.feature_shard != target_sub.feature_shard:
            raise _structural_refusal(name, "feature shard changed")
        if isinstance(base_sub, FixedEffectModel):
            base_ck = fixed_table_checksum(base_sub.model)
            target_ck = fixed_table_checksum(target_sub.model)
            coords.append(CoordinateDelta(
                name=name,
                kind="fixed",
                feature_shard=base_sub.feature_shard,
                base_checksum=base_ck,
                target_checksum=target_ck,
                means=(
                    None if base_ck == target_ck
                    else _canon_vals(target_sub.model.coefficients.means)
                ),
                variances=(
                    None
                    if base_ck == target_ck
                    or target_sub.model.coefficients.variances is None
                    else _canon_vals(target_sub.model.coefficients.variances)
                ),
            ))
            continue
        if base_sub.entity_key != target_sub.entity_key:
            raise _structural_refusal(name, "entity key changed")
        base_ck = random_table_checksum(base_sub)
        target_ck = random_table_checksum(target_sub)
        changed: Dict[str, Tuple] = {}
        removed: List[str] = []
        if base_ck != target_ck:
            bvar = base_sub.variances or {}
            tvar = target_sub.variances or {}
            for entity, row in target_sub.coefficients.items():
                prev = base_sub.coefficients.get(entity)
                if prev is not None and _rows_equal(
                    prev, row, bvar.get(entity), tvar.get(entity)
                ):
                    continue
                changed[str(entity)] = (
                    _canon_cols(row[0]),
                    _canon_vals(row[1]),
                    None if tvar.get(entity) is None
                    else _canon_vals(tvar[entity]),
                )
            removed = [
                str(e) for e in base_sub.coefficients
                if e not in target_sub.coefficients
            ]
        coords.append(CoordinateDelta(
            name=name,
            kind="random",
            feature_shard=base_sub.feature_shard,
            base_checksum=base_ck,
            target_checksum=target_ck,
            entity_key=base_sub.entity_key,
            n_features=target_sub.n_features,
            changed_entities=changed or None,
            removed=tuple(sorted(removed)),
        ))
    return ModelDelta(
        task=target.task,
        coordinates=coords,
        event_wall_epoch=event_wall_epoch,
    )


def diff_model_dirs(
    base_path: str,
    target_path: str,
    event_wall_epoch: Optional[float] = None,
) -> ModelDelta:
    """Diff two PERSISTED models (GAME directories or GLM ``.avro``
    files, as ``serving.runtime.ScoringRuntime.load_model`` accepts).

    The per-coordinate save-time fingerprints (``read_fingerprints`` in
    the io stores — a cheap manifest HEAD, no coefficient parse) gate
    the expensive per-entity comparison: a coordinate whose Avro
    checksum is unchanged is content-identical and skips straight to
    "unchanged".  Fingerprint-less legacy models are refused there with
    a pointed error."""
    # Imported here: serving.runtime pulls in the kernel machinery,
    # which delta consumers that never touch serving shouldn't pay for.
    from photon_ml_tpu_torch.io import game_store, model_store
    from photon_ml_tpu_torch.serving.runtime import ScoringRuntime

    equal_fingerprints: set = set()
    try:
        if os.path.isdir(base_path) or os.path.isdir(target_path):
            base_fps = game_store.read_fingerprints(base_path)
            target_fps = game_store.read_fingerprints(target_path)
        else:
            base_fps = {"fixed": model_store.read_fingerprints(base_path)}
            target_fps = {"fixed": model_store.read_fingerprints(target_path)}
    except FileNotFoundError as e:
        raise DeltaError(
            f"cannot diff {base_path!r} -> {target_path!r}: {e} — both "
            "endpoints must be persisted models with fingerprints"
        ) from e
    for name, fp in base_fps.items():
        other = target_fps.get(name)
        if other is not None and (
            fp.get("coefficient_checksum")
            == other.get("coefficient_checksum")
        ):
            equal_fingerprints.add(name)

    # A diff is host work: both endpoints load onto the CPU.
    base_model, _ = ScoringRuntime.load_model(base_path, device="cpu")
    target_model, _ = ScoringRuntime.load_model(target_path, device="cpu")
    delta = diff_game_models(
        base_model, target_model, event_wall_epoch=event_wall_epoch
    )
    # Soundness cross-check: a fingerprint-equal coordinate must have
    # diffed to "unchanged" (the converse is fine — save order differs).
    for coord in delta.coordinates:
        if coord.name in equal_fingerprints and coord.changed:
            raise DeltaError(
                f"coordinate {coord.name!r}: save-time fingerprints match "
                "but table content differs — one of the models was "
                "modified after save; re-save both endpoints"
            )
    return delta


# ---------------------------------------------------------------------------
# Artifact write / read
# ---------------------------------------------------------------------------

def _manifest_digest(manifest: dict) -> str:
    # Same discipline as serving/shm_model.py: sha256 over the canonical
    # JSON of everything but the self-digest field.
    body = {k: v for k, v in manifest.items() if k != "manifest_sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()


def _random_segment_arrays(coord: CoordinateDelta) -> Dict[str, np.ndarray]:
    entities = sorted(coord.changed_entities or {})
    starts = [0]
    var_starts = [0]
    cols_parts, vals_parts, var_parts = [], [], []
    has_var = []
    for e in entities:
        cols, vals, var = coord.changed_entities[e]
        cols_parts.append(cols)
        vals_parts.append(vals)
        starts.append(starts[-1] + len(cols))
        if var is None:
            has_var.append(0)
        else:
            has_var.append(1)
            var_parts.append(var)
        var_starts.append(var_starts[-1] + (0 if var is None else len(var)))
    return {
        "entity_ids": np.asarray(entities, dtype=np.str_),
        "starts": np.asarray(starts, np.int64),
        "cols": (
            np.concatenate(cols_parts) if cols_parts
            else np.zeros(0, np.int32)
        ),
        "vals": (
            np.concatenate(vals_parts) if vals_parts
            else np.zeros(0, np.float32)
        ),
        "has_var": np.asarray(has_var, np.uint8),
        "var_starts": np.asarray(var_starts, np.int64),
        "var_vals": (
            np.concatenate(var_parts) if var_parts
            else np.zeros(0, np.float32)
        ),
    }


def _fixed_segment_arrays(coord: CoordinateDelta) -> Dict[str, np.ndarray]:
    arrays = {"means": coord.means}
    if coord.variances is not None:
        arrays["variances"] = coord.variances
    return arrays


def write_delta(delta: ModelDelta, directory: str) -> dict:
    """Write the artifact into ``directory`` (created if needed) and
    return the manifest.  The npz bytes are built in memory first so the
    manifest's per-segment sha256 covers exactly what lands on disk."""
    os.makedirs(directory, exist_ok=True)
    manifest = {
        "format": DELTA_FORMAT,
        "task": delta.task,
        "event_wall_epoch": delta.event_wall_epoch,
        "coordinates": [],
    }
    for coord in delta.coordinates:
        entry = {
            "name": coord.name,
            "kind": coord.kind,
            "feature_shard": coord.feature_shard,
            "base_table_checksum": coord.base_checksum,
            "target_table_checksum": coord.target_checksum,
            "changed": coord.changed,
        }
        if coord.kind == "random":
            entry["entity_key"] = coord.entity_key
            entry["n_features"] = int(coord.n_features)
            entry["removed"] = list(coord.removed)
        if coord.changed:
            arrays = (
                _fixed_segment_arrays(coord) if coord.kind == "fixed"
                else _random_segment_arrays(coord)
            )
            buf = io_lib.BytesIO()
            np.savez(buf, **arrays)
            payload = buf.getvalue()
            fname = f"segment-{coord.name}.npz"
            with open(os.path.join(directory, fname), "wb") as f:
                f.write(payload)
            entry["file"] = fname
            entry["nbytes"] = len(payload)
            entry["sha256"] = hashlib.sha256(payload).hexdigest()
            entry["n_changed"] = coord.n_changed
        manifest["coordinates"].append(entry)
    manifest["manifest_sha256"] = _manifest_digest(manifest)
    with open(os.path.join(directory, MANIFEST_FILE), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def _read_manifest(directory: str) -> dict:
    path = os.path.join(directory, MANIFEST_FILE)
    if not os.path.exists(path):
        raise DeltaFormatError(
            f"{directory}: no {MANIFEST_FILE} — not a delta artifact "
            "(or a publish died before staging completed; the publisher "
            "journal names the survivor)"
        )
    try:
        with open(path) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise DeltaFormatError(
            f"{path}: unparseable manifest ({e}) — the artifact write "
            "was torn; re-publish the delta"
        ) from e
    if manifest.get("format") != DELTA_FORMAT:
        raise DeltaFormatError(
            f"{path}: format {manifest.get('format')!r}, expected "
            f"{DELTA_FORMAT!r}"
        )
    if manifest.get("manifest_sha256") != _manifest_digest(manifest):
        raise DeltaFormatError(
            f"{path}: manifest self-digest mismatch — the manifest was "
            "modified or torn after publish; refuse and re-publish"
        )
    return manifest


def read_delta(directory: str) -> ModelDelta:
    """Read and VERIFY an artifact: manifest self-digest, then every
    segment's sha256, then parse.  Any mismatch is a pointed
    :class:`DeltaFormatError` — a tampered or torn delta never reaches
    apply."""
    manifest = _read_manifest(directory)
    coords: List[CoordinateDelta] = []
    for entry in manifest["coordinates"]:
        kwargs = dict(
            name=entry["name"],
            kind=entry["kind"],
            feature_shard=entry["feature_shard"],
            base_checksum=entry["base_table_checksum"],
            target_checksum=entry["target_table_checksum"],
            entity_key=entry.get("entity_key", ""),
            n_features=int(entry.get("n_features", 0)),
            removed=tuple(entry.get("removed", ())),
        )
        if entry.get("changed"):
            seg_path = os.path.join(directory, entry["file"])
            try:
                with open(seg_path, "rb") as f:
                    payload = f.read()
            except FileNotFoundError:
                raise DeltaFormatError(
                    f"{seg_path}: segment named by the manifest is "
                    "missing — the artifact is incomplete; re-publish"
                ) from None
            actual = hashlib.sha256(payload).hexdigest()
            if actual != entry["sha256"]:
                raise DeltaFormatError(
                    f"{seg_path}: segment sha256 mismatch (file "
                    f"{actual[:16]}…, manifest {entry['sha256'][:16]}…) "
                    "— the segment was modified/truncated after "
                    "publish; refuse and re-publish"
                )
            arrays = dict(np.load(io_lib.BytesIO(payload)))
            if entry["kind"] == "fixed":
                kwargs["means"] = np.asarray(arrays["means"], np.float32)
                if "variances" in arrays:
                    kwargs["variances"] = np.asarray(
                        arrays["variances"], np.float32
                    )
            else:
                starts = arrays["starts"]
                var_starts = arrays["var_starts"]
                changed: Dict[str, Tuple] = {}
                for i, entity in enumerate(arrays["entity_ids"]):
                    cols = arrays["cols"][starts[i]:starts[i + 1]]
                    vals = arrays["vals"][starts[i]:starts[i + 1]]
                    var = None
                    if arrays["has_var"][i]:
                        var = arrays["var_vals"][
                            var_starts[i]:var_starts[i + 1]
                        ]
                    changed[str(entity)] = (
                        _canon_cols(cols), _canon_vals(vals),
                        None if var is None else _canon_vals(var),
                    )
                kwargs["changed_entities"] = changed or None
        coords.append(CoordinateDelta(**kwargs))
    return ModelDelta(
        task=manifest["task"],
        coordinates=coords,
        event_wall_epoch=manifest.get("event_wall_epoch"),
    )


# ---------------------------------------------------------------------------
# Apply
# ---------------------------------------------------------------------------

def _tensor_device(x) -> torch.device:
    return x.device if isinstance(x, torch.Tensor) else torch.device("cpu")


def apply_delta(model: GameModel, delta: ModelDelta) -> GameModel:
    """Return a NEW model = ``model`` patched by ``delta``.

    Never mutates ``model`` (its random-effect ``_packed`` caches are
    immutable-after-build, and the serving runtime may be scoring from
    it on another thread).  Verifies every coordinate's base checksum
    before building anything and the target checksum after — the result
    is provably bitwise-identical to a full load of the delta's target."""
    if model.task != delta.task:
        raise DeltaBaseMismatchError(
            f"delta is for task {delta.task!r} but the model is "
            f"{model.task!r} — wrong delta for this service"
        )
    by_name = {c.name: c for c in delta.coordinates}
    if set(by_name) != set(model.models):
        raise DeltaBaseMismatchError(
            f"delta covers coordinates {sorted(by_name)} but the model "
            f"has {sorted(model.models)} — the delta was diffed against "
            "a structurally different base; do a full reload"
        )
    # Verify the WHOLE base first: refusing before any work means a
    # mismatch can never leave a half-patched model behind.
    for name, sub in model.models.items():
        coord = by_name[name]
        actual = (
            fixed_table_checksum(sub.model)
            if isinstance(sub, FixedEffectModel)
            else random_table_checksum(sub)
        )
        if actual != coord.base_checksum:
            raise DeltaBaseMismatchError(
                f"coordinate {name!r}: serving table checksum "
                f"{actual[:16]}… does not match the delta's base "
                f"{coord.base_checksum[:16]}… — this delta was diffed "
                "against a DIFFERENT base model (stale serving version "
                "or out-of-order apply); do a full reload or re-diff "
                "against the live version"
            )
    new_models: Dict[str, object] = {}
    for name, sub in model.models.items():
        coord = by_name[name]
        if not coord.changed:
            new_models[name] = sub
            continue
        if isinstance(sub, FixedEffectModel):
            # The replacement vector lands where the base's lives (the
            # serving parent's host copy, or a runtime's device).
            where = _tensor_device(sub.model.coefficients.means)
            new_models[name] = FixedEffectModel(
                GeneralizedLinearModel(
                    Coefficients(
                        torch.from_numpy(coord.means.copy()).to(where),
                        None if coord.variances is None
                        else torch.from_numpy(
                            coord.variances.copy()).to(where),
                    ),
                    sub.model.task,
                ),
                sub.feature_shard,
            )
            continue
        table = dict(sub.coefficients)
        var_table = dict(sub.variances or {})
        for entity in coord.removed:
            table.pop(entity, None)
            var_table.pop(entity, None)
        for entity, (cols, vals, var) in (coord.changed_entities or {}).items():
            table[entity] = (cols, vals)
            if var is None:
                var_table.pop(entity, None)
            else:
                var_table[entity] = var
        new_models[name] = RandomEffectModel(
            coefficients=table,
            feature_shard=sub.feature_shard,
            entity_key=sub.entity_key,
            task=sub.task,
            n_features=coord.n_features or sub.n_features,
            variances=var_table or None,
        )
    patched = GameModel(models=new_models, task=model.task)
    for name, sub in patched.models.items():
        coord = by_name[name]
        actual = (
            fixed_table_checksum(sub.model)
            if isinstance(sub, FixedEffectModel)
            else random_table_checksum(sub)
        )
        if actual != coord.target_checksum:
            raise DeltaError(
                f"coordinate {name!r}: patched table checksum "
                f"{actual[:16]}… does not match the delta's target "
                f"{coord.target_checksum[:16]}… — the artifact is "
                "internally inconsistent; re-publish the delta"
            )
    return patched
