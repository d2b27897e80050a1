"""GLM model persistence.

The analogue of the reference's ``ModelProcessingUtils`` save/load path
(SURVEY.md §2, "Avro IO"): coefficients are written as real Avro
(``BayesianLinearModelAvro``-shaped records, one coefficient per
name/term/value entry) so models interchange with reference tooling.
Coefficients with value 0 are not written (the reference's sparse model
files do the same); loading uses an index map to place named coefficients.
"""

from __future__ import annotations

import hashlib
import json
import os
import struct
from typing import Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.device import resolve_device, to_numpy
from photon_ml_tpu_torch.io import avro
from photon_ml_tpu_torch.io.schemas import BAYESIAN_LINEAR_MODEL
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel

_MODEL_CLASS = {
    "logistic": "LogisticRegressionModel",
    "squared": "LinearRegressionModel",
    "poisson": "PoissonRegressionModel",
    "smoothed_hinge": "SmoothedHingeLossLinearSVMModel",
}
_CLASS_TO_TASK = {v: k for k, v in _MODEL_CLASS.items()}


def _split_key(key: str) -> tuple[str, str]:
    name, sep, term = key.partition("\x01")
    return name, term if sep else ""


# ---------------------------------------------------------------------------
# Fingerprints: a save-time identity the load path verifies, so a
# truncated / hand-edited / wrong-version coefficient file fails LOUDLY at
# load instead of silently serving garbage scores.
# ---------------------------------------------------------------------------

def coefficient_checksum(entry_lists) -> str:
    """sha256 over (name, term, value) coefficient entries, in file order.

    ``entry_lists`` is a sequence of entry lists (means, then variances
    when present, separated by a marker) — both save and load feed the
    RAW record entries, so the checksum binds to the Avro content
    regardless of which index map later places the coefficients.  Values
    hash as their exact float64 bit pattern (Avro stores doubles)."""
    h = hashlib.sha256()
    for entries in entry_lists:
        h.update(b"\x00SECTION\x00")
        if entries is None:
            continue
        for e in entries:
            h.update(str(e["name"]).encode())
            h.update(b"\x00")
            h.update(str(e["term"]).encode())
            h.update(struct.pack("<d", float(e["value"])))
    return h.hexdigest()


def _warn_unverified(path: str, why: str) -> None:
    """A model loading WITHOUT fingerprint verification is a quiet hole
    in the tamper story (a flipped bit serves wrong scores with no
    error) — make it loud: a pointed warning for the operator reading
    logs plus ``model_load_unverified_total`` on the telemetry hub.
    Re-save with the current writer to get a sidecar."""
    import warnings

    from photon_ml_tpu_torch import telemetry as telemetry_mod

    telemetry_mod.current().counter("model_load_unverified_total").inc()
    warnings.warn(
        f"{path}: loading UNVERIFIED ({why}); content tampering or "
        "truncation cannot be detected on this model — re-save it with "
        "the current writer to attach a fingerprint sidecar",
        stacklevel=3,
    )


def glm_fingerprint(task: str, feature_count: int, record: dict) -> dict:
    return {
        "version": 1,
        "task": task,
        "feature_count": int(feature_count),
        "n_coefficients": len(record["means"]),
        "coefficient_checksum": coefficient_checksum(
            [record["means"], record["variances"]]
        ),
    }


def _reject_nonfinite(vec: Optional[np.ndarray], what: str, path: str):
    """NaN/inf coefficients persist silently in Avro and then poison every
    score downstream; refuse at save time with a pointed error."""
    if vec is None:
        return
    bad = ~np.isfinite(vec)
    if bad.any():
        idx = np.flatnonzero(bad)
        raise ValueError(
            f"refusing to save {path}: {idx.size} non-finite {what} "
            f"value(s) (first at index {int(idx[0])}: {vec[idx[0]]!r}); "
            "a model with NaN/inf coefficients scores NaN — fix the "
            "training run (check for exploding optimizer steps or bad "
            "regularization) instead of persisting it"
        )


def save_glm_model(
    model: GeneralizedLinearModel,
    index_map: IndexMap,
    path: str,
    model_id: str = "",
    sparsify: bool = True,
) -> dict:
    """Write a model as an Avro container file (.avro) plus a
    ``<path>.meta.json`` sidecar carrying the model fingerprint (feature
    count, task, coefficient checksum) that :func:`load_glm_model`
    verifies.  Returns the fingerprint.  Non-finite coefficients are
    rejected here rather than silently persisted."""
    means = to_numpy(model.coefficients.means).astype(np.float64)
    variances = (
        None
        if model.coefficients.variances is None
        else to_numpy(model.coefficients.variances).astype(np.float64)
    )
    _reject_nonfinite(means, "coefficient", path)
    _reject_nonfinite(variances, "variance", path)

    def entries(vec):
        out = []
        for j, v in enumerate(vec):
            if sparsify and v == 0.0:
                continue
            name, term = _split_key(index_map.index_to_name(j))
            out.append({"name": name, "term": term, "value": float(v)})
        return out

    record = {
        "modelId": model_id,
        "modelClass": _MODEL_CLASS[model.task],
        "lossFunction": model.task,
        "means": entries(means),
        "variances": None if variances is None else entries(variances),
    }
    avro.write_container(path, BAYESIAN_LINEAR_MODEL, [record])
    fingerprint = glm_fingerprint(model.task, len(index_map), record)
    with open(path + ".meta.json", "w") as f:
        json.dump({"fingerprint": fingerprint}, f, indent=2)
    return fingerprint


def verify_glm_fingerprint(
    path: str, task: str, record: dict, index_map: Optional[IndexMap]
) -> Optional[dict]:
    """Check file content against the save-time fingerprint sidecar.
    Returns the fingerprint when one was verified; a pre-fingerprint
    file (no sidecar) loads UNVERIFIED — loudly, with a pointed
    warning."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        _warn_unverified(path, "no .meta.json fingerprint sidecar")
        return None
    with open(meta_path) as f:
        fingerprint = json.load(f).get("fingerprint")
    if not fingerprint:
        _warn_unverified(meta_path, "sidecar carries no fingerprint")
        return None
    actual = coefficient_checksum([record["means"], record["variances"]])
    if actual != fingerprint.get("coefficient_checksum"):
        raise ValueError(
            f"{path}: coefficient checksum mismatch (file {actual[:16]}…, "
            f"fingerprint {str(fingerprint.get('coefficient_checksum'))[:16]}…) "
            "— the model file was modified/truncated after save, or the "
            "sidecar belongs to a different save"
        )
    if fingerprint.get("task") != task:
        raise ValueError(
            f"{path}: task mismatch — file says {task!r}, fingerprint "
            f"says {fingerprint.get('task')!r}"
        )
    if (
        index_map is not None
        and fingerprint.get("feature_count") is not None
        and len(index_map) != fingerprint["feature_count"]
    ):
        raise ValueError(
            f"{path}: model was saved with "
            f"{fingerprint['feature_count']} features but the provided "
            f"index map has {len(index_map)}; read the data with the "
            "model's saved index maps"
        )
    return fingerprint


def read_fingerprints(path: str) -> dict:
    """Read the ``<path>.meta.json`` fingerprint sidecar WITHOUT loading
    the coefficient arrays — the cheap HEAD the delta differ
    (``freshness/delta.py``) and ops tooling use to decide whether a
    model changed at all before paying for an Avro parse.

    Returns the fingerprint dict (``task``, ``feature_count``,
    ``n_coefficients``, ``coefficient_checksum``).  A pre-fingerprint
    file (no sidecar) raises a pointed error: there is nothing to diff
    against, and quietly answering "unknown" would make a delta differ
    treat every legacy model as unchanged."""
    meta_path = path + ".meta.json"
    if not os.path.exists(meta_path):
        raise ValueError(
            f"{path}: no .meta.json fingerprint sidecar — this model "
            "predates fingerprinting, so its content cannot be compared "
            "or delta-diffed; re-save it with the current writer "
            "(save_glm_model) to attach a fingerprint"
        )
    with open(meta_path) as f:
        fingerprint = json.load(f).get("fingerprint")
    if not fingerprint:
        raise ValueError(
            f"{meta_path}: sidecar carries no fingerprint — re-save the "
            "model with the current writer (save_glm_model) to attach one"
        )
    return fingerprint


def load_glm_model(
    path: str, index_map: Optional[IndexMap] = None, device=None
) -> tuple[GeneralizedLinearModel, IndexMap]:
    """Read a model written by :func:`save_glm_model`.

    Without an index map, one is reconstructed from the coefficient names in
    file order (sufficient for scoring data indexed with the same map).

    When the save-time ``<path>.meta.json`` fingerprint sidecar is
    present (absent on pre-fingerprint files: those load unverified), the
    file content is verified against it — coefficient checksum, task,
    and, when ``index_map`` is given, feature count — and a mismatch
    raises instead of returning a silently-wrong model.  The coefficients
    land on ``device`` (default CUDA; ``"cpu"`` on request)."""
    dev = resolve_device(device)
    _, records = avro.read_container(path)
    if len(records) != 1:
        raise ValueError(f"{path}: expected 1 model record, found {len(records)}")
    rec = records[0]
    task = _CLASS_TO_TASK.get(rec["modelClass"], rec["lossFunction"])
    verify_glm_fingerprint(path, task, rec, index_map)

    keys = [feature_key(e["name"], e["term"]) for e in rec["means"]]
    if index_map is None:
        # Union of means and variances keys: a coefficient sparsified out of
        # the means (value 0) can still carry a nonzero variance, and must
        # keep a slot or the variance is silently dropped on round trip.
        all_keys = list(keys)
        seen = set(keys)
        for e in rec["variances"] or []:
            key = feature_key(e["name"], e["term"])
            if key not in seen:
                seen.add(key)
                all_keys.append(key)
        index_map = IndexMap.build(all_keys)
    d = len(index_map)
    means = np.zeros(d, np.float32)
    for e, key in zip(rec["means"], keys):
        idx = index_map.get_index(key)
        if idx >= 0:
            means[idx] = e["value"]
    variances = None
    if rec["variances"] is not None:
        variances = np.zeros(d, np.float32)
        for e in rec["variances"]:
            idx = index_map.get_index(feature_key(e["name"], e["term"]))
            if idx >= 0:
                variances[idx] = e["value"]
    model = GeneralizedLinearModel(
        Coefficients(
            torch.as_tensor(means, device=dev),
            None if variances is None else torch.as_tensor(variances, device=dev),
        ),
        task,
    )
    return model, index_map
