"""Checkpoint / resume for training jobs (port of
``photon_ml_tpu/io/checkpoint.py``).

- ``CoordinateDescentCheckpointer`` persists the full GAME coordinate-
  descent state (per-coordinate states, per-coordinate scores, the running
  ``total`` offsets, the iteration counter and the metric history) after
  every CD iteration.  A killed job restarted with ``--resume`` continues
  from the last completed iteration and reproduces the uninterrupted result
  bit for bit: the restored ``total`` and scores ARE the accumulated float
  values, not recomputations.  Restored arrays come back as numpy;
  ``CoordinateDescent.run`` puts them on the problem's device.
- ``GridCheckpointer`` records each solved (λ → coefficients) of the GLM
  driver, so a restart skips finished λs and continues the warm-start
  chain from the last solution.
- ``GameGridCheckpointer`` persists each COMPLETED point of a GAME
  coordinate-config grid as a saved model plus its metric and history.

The file formats are the reference's (numpy ``.npz`` with embedded JSON
metadata, and the GAME model store), so a checkpoint written by either
package loads in the other.

Write protocol: ONE ``.npz`` file per checkpoint holding the arrays and an
embedded JSON metadata string, written to a temp path, fsynced and
atomically renamed — a kill at any instant leaves either the previous
complete checkpoint or the new one.  Every save embeds a sha256 digest of
the payload (``__checksum__``), checked at restore: a torn or bit-rotted
file raises :class:`CheckpointCorruptError` naming the path.  Saves keep
the last ``keep_last`` generations (``path``, ``path.1``, ...), and restore
falls back to the newest one that verifies.  Each save and restore is a
``checkpoint.save``/``checkpoint.restore`` telemetry event and counter
(corruptions and fallbacks too), and the ``checkpoint.save`` (between the
temp write and the rename) and ``checkpoint.restore`` fault sites sit
where the reference has them.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

from photon_ml_tpu_torch import chaos as chaos_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.device import to_numpy

#: retained checkpoint generations per path (newest + K-1 fallbacks).
DEFAULT_KEEP_LAST = 2

_CHECKSUM_KEY = "__checksum__"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint file exists but cannot be trusted: an unreadable npz
    (truncated or torn) or a payload-checksum mismatch.  Carries the path
    and the reason."""

    def __init__(self, path: str, reason: str):
        super().__init__(f"corrupt checkpoint {path}: {reason}")
        self.path = path
        self.reason = reason


def fsync_file(f) -> None:
    """Flush + fsync an open file object (the durability barrier)."""
    f.flush()
    os.fsync(f.fileno())


def _payload_digest(arrays: dict) -> str:
    """sha256 over every payload array's (name, dtype, shape, bytes), in
    sorted name order: save-time and restore-time digests agree iff the
    arrays round-tripped intact."""
    h = hashlib.sha256()
    for name in sorted(arrays):
        a = np.asarray(arrays[name])
        h.update(name.encode())
        h.update(str(a.dtype).encode())
        h.update(repr(tuple(a.shape)).encode())
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()


def _retained_paths(path: str, keep_last: int) -> list[str]:
    """Newest-first candidate list: ``path``, ``path.1``, ..."""
    return [path] + [f"{path}.{i}" for i in range(1, max(keep_last, 1))]


def _atomic_savez(path: str, arrays: dict, keep_last: int = 1) -> None:
    arrays = dict(arrays)
    arrays[_CHECKSUM_KEY] = np.asarray(_payload_digest(arrays))
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        # fsync BEFORE the rename: os.replace is atomic in the namespace
        # but not a data barrier.
        fsync_file(f)
    # Mid-save crash boundary: tmp is complete but unpublished — a kill
    # here must leave the previous checkpoint (and its fallbacks) intact.
    chaos_mod.maybe_fail("checkpoint.save", path=path)
    # Keep-last-K rotation (newest -> .1 -> .2 ...), each shift its own
    # atomic replace, so every retained slot is always a complete file.
    for i in range(max(keep_last, 1) - 1, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")
    os.replace(tmp, path)


def _checkpoint_event(kind: str, path: str, **attrs) -> None:
    """One telemetry event + counter per checkpoint save/restore, with
    the on-disk size when the file exists (a host stat, never a device
    touch)."""
    tel = telemetry_mod.current()
    if not tel.enabled:
        return
    try:
        attrs["bytes"] = os.path.getsize(path)
    except OSError:
        pass
    tel.event(f"checkpoint.{kind}", path=path, **attrs)
    tel.counter(f"checkpoint_{kind}s").inc()


def _verified_load(path: str) -> tuple[dict, dict]:
    """Load and verify ONE npz checkpoint file; raises
    :class:`CheckpointCorruptError` on a torn file or a checksum mismatch.
    Files without a ``__checksum__`` entry load unverified."""
    try:
        with np.load(path) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as exc:  # noqa: BLE001 — numpy raises zipfile/OSError/
        # EOFError/ValueError depending on WHERE the file is torn; all of
        # them mean the same thing here.
        raise CheckpointCorruptError(
            path,
            f"unreadable npz ({type(exc).__name__}: {exc}) — the file is "
            "truncated or torn",
        ) from exc
    recorded = arrays.pop(_CHECKSUM_KEY, None)
    if recorded is not None:
        computed = _payload_digest(arrays)
        if str(recorded) != computed:
            raise CheckpointCorruptError(
                path,
                f"payload checksum mismatch (recorded {recorded}, "
                f"computed {computed}) — the arrays do not match what "
                "was saved",
            )
    try:
        meta = json.loads(str(arrays.pop("__meta__")))
    except (KeyError, ValueError) as exc:
        raise CheckpointCorruptError(
            path, f"missing/unparseable __meta__ record ({exc})"
        ) from exc
    return meta, arrays


def _load_npz_with_meta(
    path: str, keep_last: int = 1
) -> Optional[tuple[dict, dict]]:
    """(meta, arrays) from the newest VERIFIABLE retained checkpoint, or
    None if none exists.  A corrupt newest file falls back to the next
    generation with a warning; when every existing candidate is corrupt the
    newest one's error propagates (returning None would restart the run
    from scratch as if no checkpoint had been written)."""
    chaos_mod.maybe_fail("checkpoint.restore", path=path)
    first_error: Optional[CheckpointCorruptError] = None
    tel = telemetry_mod.current()
    for p in _retained_paths(path, keep_last):
        if not os.path.exists(p):
            continue
        try:
            result = _verified_load(p)
        except CheckpointCorruptError as exc:
            first_error = first_error or exc
            tel.counter("checkpoint_corruptions").inc()
            tel.event("checkpoint.corrupt", path=p, reason=exc.reason)
            logging.getLogger(__name__).warning(
                "%s; trying the previous retained checkpoint", exc
            )
            continue
        if p != path:
            tel.counter("checkpoint_fallbacks").inc()
            tel.event("checkpoint.fallback", path=p, wanted=path)
        return result
    if first_error is not None:
        raise first_error
    return None


def _flatten_state(prefix: str, st, arrays: dict):
    """Flatten a (possibly nested) coordinate state into ``arrays`` as host
    numpy.  Returns a JSON-able structure spec: "array", a list of child
    specs (lists and tuples both load back as lists), or None."""
    if st is None:
        return None
    if isinstance(st, (list, tuple)):
        return [
            _flatten_state(f"{prefix}__{i}", child, arrays)
            for i, child in enumerate(st)
        ]
    arrays[prefix] = to_numpy(st)
    return "array"


def _unflatten_state(prefix: str, spec, arrays: dict):
    if spec is None:
        return None
    if spec == "array":
        return arrays[prefix]
    return [
        _unflatten_state(f"{prefix}__{i}", child, arrays)
        for i, child in enumerate(spec)
    ]


class CoordinateDescentCheckpointer:
    """Persist / restore CoordinateDescent loop state.

    Array layout inside ``cd_checkpoint.npz``:
      ``total``             — (N,) accumulated offsets
      ``score__<coord>``    — (N,) that coordinate's scores
      ``state__<coord>...`` — that coordinate's state arrays: a bare vector
                              (fixed effects) or per-bucket ``__<i>`` arrays
                              (random effects)
      ``__meta__``          — JSON: iteration counter, coordinate names,
                              per-coordinate state STRUCTURE specs
                              ("array" | [specs...] | null), history, the
                              locked set and the bucket-padding generation
    """

    FILENAME = "cd_checkpoint.npz"
    #: the reference's bucket-padding generation of per-bucket state shapes.
    PADDING_GEN = 2

    def __init__(self, directory: str, keep_last: int = DEFAULT_KEEP_LAST):
        self.directory = directory
        self.path = os.path.join(directory, self.FILENAME)
        self.keep_last = max(int(keep_last), 1)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def clear(self) -> None:
        for p in _retained_paths(self.path, self.keep_last):
            if os.path.exists(p):
                os.remove(p)

    def save(self, iteration: int, total, scores: dict, states: dict,
             history: list, locked: list | tuple = ()) -> None:
        """Arrays may be tensors on any device; they are stored as numpy."""
        os.makedirs(self.directory, exist_ok=True)
        arrays = {"total": to_numpy(total)}
        for name, sc in scores.items():
            arrays[f"score__{name}"] = to_numpy(sc)
        specs = {
            name: _flatten_state(f"state__{name}", st, arrays)
            for name, st in states.items()
        }
        arrays["__meta__"] = np.asarray(json.dumps({
            "iteration": iteration,
            "coordinates": list(scores),
            "state_specs": specs,
            "history": history,
            # A resume must train the SAME coordinates the checkpointed
            # run did.
            "locked": sorted(locked),
            "padding_gen": self.PADDING_GEN,
        }))
        _atomic_savez(self.path, arrays, keep_last=self.keep_last)
        _checkpoint_event("save", self.path, store="cd", iteration=iteration)

    def load(self) -> Optional[dict]:
        """{iteration, total, scores, states, history, locked} or None.

        A checkpoint from another bucket-padding generation whose states
        are per-bucket is refused (None, with a warning): its random-effect
        state shapes do not fit the rebuilt datasets."""
        loaded = _load_npz_with_meta(self.path, keep_last=self.keep_last)
        if loaded is None:
            return None
        meta, arrays = loaded
        specs = meta.get("state_specs")
        if specs is None:
            # The reference's pre-nesting format: "list_states" held only
            # the per-coordinate list lengths.
            specs = {}
            for name in meta["coordinates"]:
                if name in meta.get("list_states", {}):
                    specs[name] = ["array"] * meta["list_states"][name]
                elif f"state__{name}" in arrays:
                    specs[name] = "array"
                else:
                    specs[name] = None
        if meta.get("padding_gen", 1) != self.PADDING_GEN and any(
                isinstance(sp, list) for sp in specs.values()):
            logging.getLogger(__name__).warning(
                "%s: checkpoint written under bucket-padding generation %s "
                "(current: %s) carries per-bucket states whose shapes do "
                "not fit the rebuilt datasets; starting fresh",
                self.path, meta.get("padding_gen", 1), self.PADDING_GEN,
            )
            return None
        states = {
            name: _unflatten_state(f"state__{name}", specs.get(name), arrays)
            for name in meta["coordinates"]
        }
        _checkpoint_event(
            "restore", self.path, store="cd", iteration=int(meta["iteration"])
        )
        return {
            "iteration": int(meta["iteration"]),
            "total": arrays["total"],
            "scores": {name: arrays[f"score__{name}"]
                       for name in meta["coordinates"]},
            "states": states,
            "history": meta["history"],
            "locked": meta.get("locked", []),
        }


class GridCheckpointer:
    """λ-grid checkpoint for the GLM driver: one coefficient vector per
    solved regularization weight, so a restart skips finished λs and keeps
    the warm-start chain intact."""

    FILENAME = "grid_checkpoint.npz"

    def __init__(self, directory: str, keep_last: int = DEFAULT_KEEP_LAST):
        self.directory = directory
        self.path = os.path.join(directory, self.FILENAME)
        self.keep_last = max(int(keep_last), 1)

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def clear(self) -> None:
        for p in _retained_paths(self.path, self.keep_last):
            if os.path.exists(p):
                os.remove(p)

    def save(self, solved: dict, extra_meta: Optional[dict] = None) -> None:
        """``solved``: λ (float) → coefficient vector (numpy), in solve
        order.  ``extra_meta``: JSON-able run configuration persisted
        alongside (the driver's ``--coefficient-bounds`` fingerprint), so a
        ``--resume`` can refuse a checkpoint written under another one."""
        os.makedirs(self.directory, exist_ok=True)
        arrays = {
            f"w__{i}": np.asarray(w) for i, w in enumerate(solved.values())
        }
        meta = {"lambdas": [float(lam) for lam in solved]}
        if extra_meta:
            meta.update(extra_meta)
        arrays["__meta__"] = np.asarray(json.dumps(meta))
        _atomic_savez(self.path, arrays, keep_last=self.keep_last)
        _checkpoint_event(
            "save", self.path, store="grid", solved=len(solved)
        )

    def load(self) -> dict:
        """λ → coefficient vector (insertion order = solve order)."""
        loaded = _load_npz_with_meta(self.path, keep_last=self.keep_last)
        if loaded is None:
            return {}
        meta, arrays = loaded
        _checkpoint_event(
            "restore", self.path, store="grid", solved=len(meta["lambdas"])
        )
        return {lam: arrays[f"w__{i}"] for i, lam in enumerate(meta["lambdas"])}

    def load_meta(self) -> dict:
        """The checkpoint's metadata ({} when none exists): ``lambdas``
        plus whatever ``extra_meta`` the writer recorded."""
        loaded = _load_npz_with_meta(self.path, keep_last=self.keep_last)
        return {} if loaded is None else loaded[0]


class GameGridCheckpointer:
    """Per-grid-point checkpoint for the GAME coordinate-config grid.

    Each COMPLETED grid point persists as the trained GameModel (the model
    store) plus metric/history metadata, so a retried or ``--resume``d grid
    skips finished points and re-fits only the interrupted one.  A
    fingerprint of the point's configs (every field, recursively) is stored
    with it; a point whose fingerprint does not match the current grid is
    ignored, so a changed grid never serves stale models.  Restored models
    load onto ``device`` (default CUDA; ``"cpu"`` on request).
    """

    DIRNAME = "grid"

    def __init__(self, directory: str, index_maps: dict, device=None):
        self.root = os.path.join(directory, self.DIRNAME)
        self.index_maps = index_maps
        self.device = device

    def _point_dir(self, gi: int) -> str:
        return os.path.join(self.root, f"point_{gi}")

    @classmethod
    def fingerprint(cls, configs: dict) -> dict:
        """JSON-stable image of the ENTIRE config per coordinate: any field
        change (optimizer settings, regularization type, sampling) must
        invalidate the point, not just reg_weight.  Equal to the
        reference's image of the same config."""
        import dataclasses as _dc
        import enum

        def conv(o):
            if _dc.is_dataclass(o) and not isinstance(o, type):
                return {f.name: conv(getattr(o, f.name))
                        for f in _dc.fields(o)}
            if isinstance(o, enum.Enum):
                return o.value
            if isinstance(o, (list, tuple)):
                return [conv(x) for x in o]
            if isinstance(o, dict):
                return {str(k): conv(v) for k, v in o.items()}
            if isinstance(o, (int, float, str, bool)) or o is None:
                return o
            return repr(o)

        return {
            name: {"type": type(cfg).__name__, "config": conv(cfg)}
            for name, cfg in configs.items()
        }

    def clear(self) -> None:
        import shutil

        shutil.rmtree(self.root, ignore_errors=True)

    def save_point(self, gi: int, configs: dict, model, metric,
                   metric_key: str, history: list) -> None:
        import shutil

        from photon_ml_tpu_torch.io.game_store import save_game_model

        def _default(o):
            if isinstance(o, np.generic):
                return o.item()
            if isinstance(o, np.ndarray):
                return o.tolist()
            return float(o)

        d = self._point_dir(gi)
        tmp = d + ".tmp"
        shutil.rmtree(tmp, ignore_errors=True)
        save_game_model(model, self.index_maps, tmp)
        meta = {
            "fingerprint": self.fingerprint(configs),
            "metric": None if metric is None else float(metric),
            "metric_key": metric_key,
            "history": history,
        }
        with open(os.path.join(tmp, "grid_meta.json"), "w") as f:
            json.dump(meta, f, default=_default)
        # Directory-level atomic publish: the meta file is written inside
        # tmp before the rename, so a surviving point dir always carries a
        # complete model and its metadata.
        shutil.rmtree(d, ignore_errors=True)
        os.replace(tmp, d)
        telemetry_mod.current().event(
            "checkpoint.save", store="game_grid", grid_index=gi, path=d
        )
        telemetry_mod.current().counter("checkpoint_saves").inc()

    def load_point(self, gi: int, configs: dict, metric_key: str):
        """``(model, metric, history)`` for a completed matching point, else
        None.  ``metric_key`` must match the saved point's: a point selected
        by train metric must not be compared with other points' validation
        metrics."""
        from photon_ml_tpu_torch.io.game_store import load_game_model

        meta_path = os.path.join(self._point_dir(gi), "grid_meta.json")
        if not os.path.exists(meta_path):
            return None
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("fingerprint") != self.fingerprint(configs):
            return None
        if meta.get("metric_key") != metric_key:
            return None
        model, _ = load_game_model(self._point_dir(gi), device=self.device)
        telemetry_mod.current().event(
            "checkpoint.restore", store="game_grid", grid_index=gi,
            path=self._point_dir(gi),
        )
        telemetry_mod.current().counter("checkpoint_restores").inc()
        return model, meta["metric"], meta.get("history", [])
