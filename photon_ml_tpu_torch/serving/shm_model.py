"""Shared-memory model publication for process-level serving workers
(port of ``photon_ml_tpu/serving/shm_model.py``: the same segments,
per-segment digests and manifest self-digest, so either package attaches
the other's publication).

The parent process packs a :class:`~photon_ml_tpu_torch.game.model.GameModel`
into ``multiprocessing.shared_memory`` segments exactly ONCE — one
segment per coordinate: the fixed-effect coefficient vector, or, for a
random-effect coordinate, the sorted entity-id blob plus CSR-style
``(cols, vals)`` coefficient rows — and hands workers a
sha256-fingerprinted **manifest** (segment names, array offsets,
per-segment digests, and a self-digest over the manifest body, riding
the PR-3 fingerprint-sidecar discipline).  Workers attach zero-copy:
every array the reconstructed model exposes is an ``np.frombuffer``
view into the mapped segment, so N workers pay ~1x (not Nx) the bytes
reported by the ``serving_shared_segment_bytes`` gauge.

Attach is verify-or-die (docs/serving.md "Process-level workers"): a
torn or tampered manifest, a missing segment, or a checksum mismatch
raises a pointed :class:`ModelMapError` and bumps
``model_map_unverified_total`` — never a silent partial map.

Segment lifecycle: the PARENT owns unlink.  :func:`publish_model`
creates segments (tracked in a module-level live set so leaks are
visible), :func:`unpublish_model` unlinks them; the worker pool keeps
the last TWO generations linked so a worker restarted inside a
swap/rollback window can still attach its pool's current manifest
(serving/procpool.py).  Workers attach and then *unregister* the
segment from their own ``resource_tracker`` — Python 3.10 registers
attached segments for cleanup, so without this a dying worker would
unlink shared state out from under its peers.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import multiprocessing
import os
import threading
from multiprocessing import resource_tracker, shared_memory
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.model import (
    FixedEffectModel,
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel

__all__ = [
    "MANIFEST_FORMAT",
    "ModelMapError",
    "ModelAttachment",
    "SharedEntityTable",
    "publish_model",
    "unpublish_model",
    "attach_model",
    "live_segments",
]

MANIFEST_FORMAT = "photon-shm-model-v1"

#: segment-internal arrays start on 8-byte boundaries (int64 offsets
#: must be aligned for zero-copy np.frombuffer views).
_ALIGN = 8

# Parent-side live-segment registry: name -> (handle, logical bytes).
# publish/unpublish keep it and the serving_shared_segment_bytes gauge
# in sync; tests and the process selfcheck assert it drains to empty.
_live_lock = threading.Lock()
_live: Dict[str, Tuple[shared_memory.SharedMemory, int]] = {}


class ModelMapError(RuntimeError):
    """A shared-memory model could not be verified at attach.

    Raised for a torn/tampered manifest, a missing or undersized
    segment, or a checksum mismatch — always BEFORE any partially
    mapped model is visible to the caller."""


def _unverified(message: str) -> None:
    telemetry_mod.current().counter("model_map_unverified_total").inc()
    raise ModelMapError(message)


def _manifest_digest(manifest: dict) -> str:
    """sha256 over the canonical JSON of everything but the self-digest
    field — torn writes and field tampering both change it."""
    body = {k: v for k, v in manifest.items() if k != "manifest_sha256"}
    return hashlib.sha256(
        json.dumps(body, sort_keys=True, default=str).encode("utf-8")
    ).hexdigest()


def _update_gauge() -> None:
    with _live_lock:
        total = sum(nbytes for _, nbytes in _live.values())
    telemetry_mod.current().gauge("serving_shared_segment_bytes").set(total)


def live_segments() -> List[str]:
    """Names of segments this process has published and not yet
    unlinked (diagnostic / leak-sentinel view)."""
    with _live_lock:
        return sorted(_live)


# -- packing (parent side) --------------------------------------------------
class _SegmentWriter:
    """Accumulates named arrays, then lays them into one shared-memory
    segment at aligned offsets and returns the per-array specs the
    manifest records."""

    def __init__(self) -> None:
        self._arrays: List[Tuple[str, np.ndarray]] = []

    def add(self, name: str, arr: np.ndarray) -> None:
        self._arrays.append((name, np.ascontiguousarray(arr)))

    def build(self) -> Tuple[shared_memory.SharedMemory, dict, int, str]:
        offsets = []
        cursor = 0
        for _, arr in self._arrays:
            cursor = (cursor + _ALIGN - 1) // _ALIGN * _ALIGN
            offsets.append(cursor)
            cursor += arr.nbytes
        nbytes = max(cursor, 1)  # SharedMemory size must be > 0
        shm = shared_memory.SharedMemory(create=True, size=nbytes)
        specs = {}
        for (name, arr), offset in zip(self._arrays, offsets):
            if arr.nbytes:
                dst = np.frombuffer(
                    shm.buf, dtype=arr.dtype, count=arr.size, offset=offset
                )
                dst[:] = arr.reshape(-1)
            specs[name] = {
                "offset": offset,
                "dtype": np.dtype(arr.dtype).str,
                "shape": [int(s) for s in arr.shape],
            }
        digest = hashlib.sha256(bytes(shm.buf[:nbytes])).hexdigest()
        return shm, specs, nbytes, digest


def _pack_random(sub: RandomEffectModel) -> Tuple[_SegmentWriter, dict]:
    # Sort by the ENCODED id (the attach-side binary search compares
    # utf-8 bytes); for str keys this equals Python's sort order.
    items = sorted(
        ((str(k).encode("utf-8"), k) for k in sub.coefficients),
        key=lambda kv: kv[0],
    )
    enc = [e for e, _ in items]
    blob = b"".join(enc)
    id_offsets = np.zeros(len(enc) + 1, np.int64)
    np.cumsum([len(e) for e in enc], out=id_offsets[1:])
    cols_parts: List[np.ndarray] = []
    vals_parts: List[np.ndarray] = []
    row_offsets = np.zeros(len(enc) + 1, np.int64)
    for i, (_, key) in enumerate(items):
        cols, vals = sub.coefficients[key]
        cols_parts.append(np.asarray(cols, np.int64).reshape(-1))
        vals_parts.append(np.asarray(vals, np.float32).reshape(-1))
        row_offsets[i + 1] = row_offsets[i] + cols_parts[-1].size
    w = _SegmentWriter()
    w.add("ids_blob", np.frombuffer(blob, np.uint8))
    w.add("id_offsets", id_offsets)
    w.add("row_offsets", row_offsets)
    w.add("cols", np.concatenate(cols_parts or [np.zeros(0, np.int64)]))
    w.add("vals", np.concatenate(vals_parts or [np.zeros(0, np.float32)]))
    extra = {
        "entity_key": sub.entity_key,
        "task": sub.task,
        "n_features": int(sub.n_features),
        "n_entities": len(enc),
    }
    return w, extra


def publish_model(
    model: GameModel, version: int = 1, path: Optional[str] = None
) -> dict:
    """Pack ``model`` into shared-memory segments and return the
    manifest workers attach with.  The caller (the worker pool) owns
    the segments' lifetime via :func:`unpublish_model`."""
    coordinates = []
    segments = {}
    created: List[shared_memory.SharedMemory] = []
    try:
        for name in sorted(model.models):
            sub = model.models[name]
            if isinstance(sub, RandomEffectModel):
                writer, extra = _pack_random(sub)
                kind = "random"
            elif isinstance(sub, FixedEffectModel):
                means = to_numpy(sub.model.coefficients.means).astype(
                    np.float32, copy=False)
                writer = _SegmentWriter()
                writer.add("means", means)
                kind = "fixed"
                extra = {
                    "task": sub.model.task,
                    "n_features": int(means.shape[0]),
                }
            else:
                raise TypeError(f"unsupported coordinate type: {type(sub)}")
            shm, arrays, nbytes, digest = writer.build()
            created.append(shm)
            segments[shm.name] = {"nbytes": nbytes, "sha256": digest}
            coordinates.append({
                "name": name,
                "kind": kind,
                "feature_shard": sub.feature_shard,
                "segment": shm.name,
                "arrays": arrays,
                **extra,
            })
    except Exception:
        for shm in created:
            shm.close()
            shm.unlink()
        raise
    manifest = {
        "format": MANIFEST_FORMAT,
        "version": int(version),
        "path": path,
        "task": model.task,
        "publisher_pid": os.getpid(),
        "coordinates": coordinates,
        "segments": segments,
    }
    manifest["manifest_sha256"] = _manifest_digest(manifest)
    with _live_lock:
        for shm in created:
            _live[shm.name] = (shm, segments[shm.name]["nbytes"])
    _update_gauge()
    return manifest


def unpublish_model(manifest: dict) -> None:
    """Unlink the segments a manifest names (idempotent)."""
    for name in manifest.get("segments", {}):
        with _live_lock:
            entry = _live.pop(name, None)
        if entry is None:
            continue
        shm, _ = entry
        try:
            shm.close()
        except BufferError:
            pass  # a parent-side view still holds the buffer; unlink anyway
        try:
            shm.unlink()
        except FileNotFoundError:
            pass
    _update_gauge()


# -- attaching (worker side) ------------------------------------------------
class SharedEntityTable:
    """Read-only entity-id → ``(cols, vals)`` mapping over shared memory.

    Drop-in for ``RandomEffectModel.coefficients``: ``get`` /
    ``__getitem__`` / iteration / ``len`` are what the serving host
    path, :func:`~photon_ml_tpu_torch.serving.kernels.dense_coefficient_rows`,
    and ``_ensure_packed`` use.  Lookups binary-search the sorted
    utf-8 id blob (O(log n) small decodes, no per-worker key dict) and
    return zero-copy ``np.frombuffer`` views of the row's columns and
    values."""

    __slots__ = ("_blob", "_id_offsets", "_row_offsets", "_cols", "_vals")

    def __init__(self, blob, id_offsets, row_offsets, cols, vals):
        self._blob = blob
        self._id_offsets = id_offsets
        self._row_offsets = row_offsets
        self._cols = cols
        self._vals = vals

    def __len__(self) -> int:
        return len(self._id_offsets) - 1

    def _id_bytes(self, i: int) -> bytes:
        return self._blob[self._id_offsets[i]:self._id_offsets[i + 1]].tobytes()

    def _rank(self, encoded: bytes) -> int:
        lo, hi = 0, len(self)
        while lo < hi:
            mid = (lo + hi) // 2
            if self._id_bytes(mid) < encoded:
                lo = mid + 1
            else:
                hi = mid
        return lo

    def get(self, key, default=None):
        encoded = str(key).encode("utf-8")
        i = self._rank(encoded)
        if i >= len(self) or self._id_bytes(i) != encoded:
            return default
        lo, hi = self._row_offsets[i], self._row_offsets[i + 1]
        return (self._cols[lo:hi], self._vals[lo:hi])

    def __getitem__(self, key):
        entry = self.get(key)
        if entry is None:
            raise KeyError(key)
        return entry

    def __contains__(self, key) -> bool:
        return self.get(key) is not None

    def __iter__(self) -> Iterator[str]:
        for i in range(len(self)):
            yield self._id_bytes(i).decode("utf-8")

    def keys(self) -> Iterator[str]:
        return iter(self)


@dataclasses.dataclass
class ModelAttachment:
    """Open handles on a mapped model's segments; the reconstructed
    model's arrays are views into these, so keep it alive as long as
    the model is in use and :meth:`close` it afterwards."""

    manifest: dict
    segments: Dict[str, shared_memory.SharedMemory]

    @property
    def nbytes(self) -> int:
        return sum(
            int(s["nbytes"]) for s in self.manifest["segments"].values()
        )

    def __enter__(self) -> "ModelAttachment":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def close(self) -> None:
        for shm in self.segments.values():
            try:
                shm.close()
            except BufferError:
                # A model view still references the buffer.  Unmapping
                # under a live view would be a use-after-free, so pin
                # the mapping for as long as the views need it (the
                # view chain keeps the mmap alive) and disarm
                # SharedMemory.__del__'s retry so shutdown isn't a wall
                # of "Exception ignored" tracebacks.  The fd can close
                # now — a POSIX mapping outlives its descriptor.
                shm._buf = None
                shm._mmap = None
                fd = getattr(shm, "_fd", -1)
                if fd >= 0:
                    try:
                        os.close(fd)
                    except OSError:
                        pass
                    shm._fd = -1
        self.segments = {}


def _attach_segment(
    name: str, spec: dict, publisher_pid: int
) -> shared_memory.SharedMemory:
    try:
        shm = shared_memory.SharedMemory(name=name)
    except FileNotFoundError:
        _unverified(
            f"shared segment {name!r} is gone (unlinked or never "
            "published) — the manifest is stale; re-fetch it from the pool"
        )
    if (
        os.getpid() != publisher_pid
        and multiprocessing.parent_process() is None
    ):
        # Python 3.10 registers ATTACHED segments with the resource
        # tracker; in a STANDALONE attaching process (own tracker) that
        # registration would unlink the segment out from under the
        # publisher when this process exits, so drop it.  A
        # multiprocessing child SHARES its parent's tracker daemon —
        # there the attach-register was a no-op on the already-present
        # entry, and unregistering would strip the publisher's own
        # registration (double-unregister KeyErrors at unlink, and no
        # crash cleanup).
        try:
            resource_tracker.unregister(shm._name, "shared_memory")
        except Exception:  # noqa: BLE001 — tracker internals vary
            pass
    nbytes = int(spec["nbytes"])
    if shm.size < nbytes:
        shm.close()
        _unverified(
            f"shared segment {name!r} is torn: {shm.size} bytes mapped, "
            f"manifest promises {nbytes}"
        )
    digest = hashlib.sha256(bytes(shm.buf[:nbytes])).hexdigest()
    if digest != spec["sha256"]:
        shm.close()
        _unverified(
            f"shared segment {name!r} failed checksum verification "
            f"(got {digest[:12]}…, manifest says "
            f"{str(spec['sha256'])[:12]}…) — refusing to map a "
            "corrupt model"
        )
    return shm


def _view(shm: shared_memory.SharedMemory, spec: dict) -> np.ndarray:
    dtype = np.dtype(spec["dtype"])
    shape = tuple(spec["shape"])
    count = int(np.prod(shape)) if shape else 1
    arr = np.frombuffer(
        shm.buf, dtype=dtype, count=count, offset=int(spec["offset"])
    )
    return arr.reshape(shape)


def _format_of(manifest):
    if isinstance(manifest, dict):
        return manifest.get("format")
    return type(manifest).__name__


def attach_model(manifest: dict) -> Tuple[GameModel, ModelAttachment]:
    """Map a published model: verify the manifest self-digest, attach
    and checksum every segment, and only then reconstruct the
    :class:`GameModel` over zero-copy views.  Any failure raises
    :class:`ModelMapError` (and bumps ``model_map_unverified_total``)
    with nothing mapped."""
    if not isinstance(manifest, dict) or manifest.get("format") != (
        MANIFEST_FORMAT
    ):
        _unverified(
            "not a shared-memory model manifest (expected format "
            f"{MANIFEST_FORMAT!r}, got {_format_of(manifest)!r})"
        )
    for field in ("version", "task", "coordinates", "segments",
                  "manifest_sha256", "publisher_pid"):
        if field not in manifest:
            _unverified(f"torn manifest: missing field {field!r}")
    expected = _manifest_digest(manifest)
    if manifest["manifest_sha256"] != expected:
        _unverified(
            "torn manifest: self-digest mismatch (body hashes to "
            f"{expected[:12]}…, manifest claims "
            f"{str(manifest['manifest_sha256'])[:12]}…) — refusing to "
            "map from an inconsistent manifest"
        )
    publisher_pid = int(manifest["publisher_pid"])
    attached: Dict[str, shared_memory.SharedMemory] = {}
    try:
        for name, spec in manifest["segments"].items():
            attached[name] = _attach_segment(name, spec, publisher_pid)
        models = {}
        for coord in manifest["coordinates"]:
            shm = attached[coord["segment"]]
            arrays = coord["arrays"]
            if coord["kind"] == "fixed":
                models[coord["name"]] = FixedEffectModel(
                    model=GeneralizedLinearModel(
                        # A host tensor over the segment: the runtime copies
                        # it onto its device, and close() pins the mapping
                        # while this view lives (ModelAttachment.close).
                        coefficients=Coefficients(
                            means=torch.from_numpy(
                                _view(shm, arrays["means"]))
                        ),
                        task=coord["task"],
                    ),
                    feature_shard=coord["feature_shard"],
                )
            elif coord["kind"] == "random":
                table = SharedEntityTable(
                    blob=_view(shm, arrays["ids_blob"]),
                    id_offsets=_view(shm, arrays["id_offsets"]),
                    row_offsets=_view(shm, arrays["row_offsets"]),
                    cols=_view(shm, arrays["cols"]),
                    vals=_view(shm, arrays["vals"]),
                )
                models[coord["name"]] = RandomEffectModel(
                    coefficients=table,
                    feature_shard=coord["feature_shard"],
                    entity_key=coord["entity_key"],
                    task=coord["task"],
                    n_features=int(coord["n_features"]),
                )
            else:
                _unverified(
                    f"torn manifest: unknown coordinate kind "
                    f"{coord['kind']!r}"
                )
    except ModelMapError:
        for shm in attached.values():
            try:
                shm.close()
            except BufferError:
                pass
        raise
    except Exception as exc:
        for shm in attached.values():
            try:
                shm.close()
            except BufferError:
                pass
        _unverified(f"shared model attach failed: {exc}")
    model = GameModel(models=models, task=manifest["task"])
    return model, ModelAttachment(manifest=manifest, segments=attached)
