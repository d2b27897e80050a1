"""λ-grid checkpoint / resume for the GLM driver (port of the GLM part of
``photon_ml_tpu/io/checkpoint.py``).

``GridCheckpointer`` records each solved (λ → coefficients) so a restarted
driver skips finished λs and continues the warm-start chain from the last
solution.  The file format is the reference's, numpy only, so a checkpoint
written by either package loads in the other.

Write protocol: ONE ``.npz`` file per checkpoint holding the arrays and an
embedded JSON metadata string, written to a temp path, fsynced and
atomically renamed — a kill at any instant leaves either the previous
complete checkpoint or the new one.  Every save embeds a sha256 digest of
the payload (``__checksum__``), checked at restore: a torn or bit-rotted
file raises :class:`CheckpointCorruptError` naming the path.  Saves keep
the last ``keep_last`` generations (``path``, ``path.1``, ...), and restore
falls back to the newest one that verifies.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Optional

import numpy as np

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
    # Keep-last-K rotation (newest -> .1 -> .2 ...), each shift its own
    # atomic replace, so every retained slot is always a complete file.
    for i in range(max(keep_last, 1) - 1, 0, -1):
        src = path if i == 1 else f"{path}.{i - 1}"
        if os.path.exists(src):
            os.replace(src, f"{path}.{i}")
    os.replace(tmp, path)


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
    first_error: Optional[CheckpointCorruptError] = None
    for p in _retained_paths(path, keep_last):
        if not os.path.exists(p):
            continue
        try:
            return _verified_load(p)
        except CheckpointCorruptError as exc:
            first_error = first_error or exc
            logging.getLogger(__name__).warning(
                "%s; trying the previous retained checkpoint", exc
            )
    if first_error is not None:
        raise first_error
    return None


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

    def load(self) -> dict:
        """λ → coefficient vector (insertion order = solve order)."""
        loaded = _load_npz_with_meta(self.path, keep_last=self.keep_last)
        if loaded is None:
            return {}
        meta, arrays = loaded
        return {lam: arrays[f"w__{i}"] for i, lam in enumerate(meta["lambdas"])}

    def load_meta(self) -> dict:
        """The checkpoint's metadata ({} when none exists): ``lambdas``
        plus whatever ``extra_meta`` the writer recorded."""
        loaded = _load_npz_with_meta(self.path, keep_last=self.keep_last)
        return {} if loaded is None else loaded[0]
