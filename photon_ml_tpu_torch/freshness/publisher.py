"""Crash-safe delta publication (port of
``photon_ml_tpu/freshness/publisher.py``).

A publication root is a directory:

    publish_journal.jsonl    append-only decision log (tuning/state.py
                             discipline: one JSON line per record,
                             flush+fsync before append returns)
    delta-<seq>/             published artifacts (delta.py layout)
    delta-<seq>.staging/     an in-flight write (never read by anyone)

The publish protocol brackets an atomic-rename artifact write with
journal records, so a kill at ANY instant leaves the root in a state
the next :class:`DeltaPublisher` (or an explicit :meth:`resume`)
completes deterministically:

    begin(seq)        journaled first — the staging dir is claimed
    <stage artifact>  written into delta-<seq>.staging/, self-digested
    <atomic rename>   delta-<seq>.staging/ -> delta-<seq>/
    commit(seq)       journaled last — the publication is now visible

Crash before the rename: the staging dir is garbage; resume removes it
and journals ``abort``.  Crash after the rename but before ``commit``:
the artifact is complete and verified on disk; resume journals the
missing ``commit`` — the SAME publication an uninterrupted run would
have made, never a half-published artifact.  Subscribers only ever see
``commit``-journaled sequence numbers (:meth:`publications`), so a torn
publish is invisible to the apply side.

Retention (bounded roots)
-------------------------

A continuously-refining loop publishes forever; without pruning the
root grows without bound.  :meth:`DeltaPublisher.retain` (or the
``retain_last`` constructor knob, which prunes after every publish)
keeps the newest K committed publications and removes the rest —
journal compaction first (write-temp + fsync + atomic rename, so the
journal is never torn), artifact directories second (a kill in between
leaves orphan ``delta-*`` dirs that the next retention sweeps).  Two
things are NEVER pruned: an unsettled ``begin`` (an in-flight publish
is not ours to judge) and the newest committed publication (an empty
root would strand every subscriber).  Sequence numbering survives
compaction — the kept records still carry the max seq, so
``_next_seq`` never moves backward and a resumed publisher continues
the same sequence.

Ack sidecar (``acks/<subscriber_id>``)
--------------------------------------

Deltas are incremental: pruning a publication a subscriber has not yet
applied forces that subscriber into a full reload.  Subscribers
therefore register an ack file under ``acks/`` (atomic write via
:func:`write_ack`; :class:`~photon_ml_tpu_torch.freshness.applier.DeltaApplier`
does this when given a ``subscriber_id``), and retention refuses to
prune any publication newer than the slowest registered ack — those
sequences are reported as ``blocked`` with the GUILTY subscriber ids
(``blocking``), so the operator knows exactly which subscriber to chase
or unregister (:func:`remove_ack` releases the prune).  A root with no
registered subscribers prunes on age alone.

Snapshot publications (cluster cold start)
------------------------------------------

Deltas patch a base the subscriber already has; a brand-new host has no
base.  :meth:`DeltaPublisher.publish_snapshot` publishes a FULL model
directory under the same journal protocol (``snapshot-<seq>/`` with a
self-digested ``snapshot.json`` listing every file's sha256), so a cold
host can bootstrap from the newest snapshot over the wire
(photon_ml_tpu_torch/cluster/distribution.py) and then catch up by deltas —
no shared filesystem anywhere on the serving path.  Snapshots ride the
same sequence space, retention, and ack discipline as deltas;
:class:`Publication.kind` tells the apply side which reload path to
take.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Dict, List, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.freshness.delta import (
    MANIFEST_FILE,
    DeltaError,
    ModelDelta,
    _manifest_digest,
    _read_manifest,
    write_delta,
)
from photon_ml_tpu_torch.io.checkpoint import fsync_file


@dataclasses.dataclass(frozen=True)
class Publication:
    """One committed publication, as subscribers see it.  ``kind`` is
    ``"delta"`` (incremental, delta.py layout) or ``"snapshot"`` (full
    model dir + ``snapshot.json``, the cold-start bootstrap)."""

    seq: int
    path: str
    manifest_sha256: str
    event_wall_epoch: Optional[float]
    n_changed_rows: int
    publish_wall_epoch: float
    kind: str = "delta"


class PublishAborted(RuntimeError):
    """Raised by the journal's test abort hook to simulate a kill at a
    deterministic record boundary (tuning/state.py idiom)."""


ACKS_DIR = "acks"

#: Subscriber ids become filenames under ``acks/`` — keep them to the
#: same safe alphabet as tenant slugs, no path separators or dots-only.
_SUBSCRIBER_ID_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._-]{0,63}$")

_ARTIFACT_DIR_RE = re.compile(r"^(?:delta|snapshot)-(\d+)$")

#: Snapshot artifact manifest filename and format tag (delta.py keeps
#: ``delta.json`` / photon-model-delta-v1 for incremental artifacts).
SNAPSHOT_MANIFEST = "snapshot.json"
SNAPSHOT_FORMAT = "photon-model-snapshot-v1"
#: Model files live under this subdir of a snapshot artifact, so the
#: apply side reloads ``<artifact>/model`` without the manifest riding
#: along inside the model directory.
SNAPSHOT_MODEL_DIR = "model"


def write_ack(
    root: str, subscriber_id: str, seq: int, fsync: bool = True
) -> str:
    """Record that ``subscriber_id`` has applied (or deliberately
    skipped) every publication up to and including ``seq``.  Atomic
    (write-temp + rename), so retention never reads a torn ack.
    Returns the ack file path."""
    if not _SUBSCRIBER_ID_RE.match(subscriber_id):
        raise ValueError(
            f"subscriber id {subscriber_id!r} is not a safe filename "
            "([A-Za-z0-9][A-Za-z0-9._-]*, max 64 chars)"
        )
    acks = os.path.join(root, ACKS_DIR)
    os.makedirs(acks, exist_ok=True)
    path = os.path.join(acks, subscriber_id + ".json")
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({
            "subscriber_id": subscriber_id,
            "acked_seq": int(seq),
            "wall_epoch": time.time(),
        }, f)
        if fsync:
            fsync_file(f)
    os.replace(tmp, path)
    return path


def read_acks(root: str) -> Dict[str, int]:
    """Acked sequence number per registered subscriber.  A missing
    ``acks/`` dir means no subscribers are registered (retention prunes
    on age alone); an unparseable ack file is skipped — ack writes are
    atomic, so garbage there is not ours."""
    acks = os.path.join(root, ACKS_DIR)
    if not os.path.isdir(acks):
        return {}
    out: Dict[str, int] = {}
    for name in sorted(os.listdir(acks)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(acks, name)) as f:
                record = json.load(f)
            out[str(record["subscriber_id"])] = int(record["acked_seq"])
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            continue
    return out


def remove_ack(root: str, subscriber_id: str) -> bool:
    """Unregister a subscriber from the root's ack sidecar, releasing
    any retention hold its stale ack was keeping (``retain`` reports
    the guilty id in ``blocking``).  Returns ``True`` when an ack file
    was actually removed.  This is the operator's lever against a
    subscriber that registered and then died without acking — the
    runbook move after ``blocking`` names it."""
    if not _SUBSCRIBER_ID_RE.match(subscriber_id):
        raise ValueError(
            f"subscriber id {subscriber_id!r} is not a safe filename "
            "([A-Za-z0-9][A-Za-z0-9._-]*, max 64 chars)"
        )
    path = os.path.join(root, ACKS_DIR, subscriber_id + ".json")
    try:
        os.remove(path)
    except FileNotFoundError:
        return False
    telemetry_mod.current().event(
        "freshness.subscriber_unregistered",
        root=root, subscriber_id=subscriber_id,
    )
    return True


def _write_snapshot_manifest(
    staging: str, event_wall_epoch: Optional[float]
) -> dict:
    """Digest every file under ``staging/model`` into a self-digested
    ``snapshot.json`` (delta.py's manifest discipline: sha256 per file,
    manifest_sha256 over the canonical JSON of the rest)."""
    model_root = os.path.join(staging, SNAPSHOT_MODEL_DIR)
    files: Dict[str, dict] = {}
    for dirpath, _dirnames, filenames in os.walk(model_root):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.join(
                SNAPSHOT_MODEL_DIR, os.path.relpath(full, model_root)
            )
            with open(full, "rb") as f:
                payload = f.read()
            files[rel] = {
                "sha256": hashlib.sha256(payload).hexdigest(),
                "nbytes": len(payload),
            }
    if not files:
        raise DeltaError(
            f"{model_root}: empty model directory — nothing to snapshot"
        )
    manifest = {
        "format": SNAPSHOT_FORMAT,
        "event_wall_epoch": event_wall_epoch,
        "files": files,
    }
    manifest["manifest_sha256"] = _manifest_digest(manifest)
    with open(os.path.join(staging, SNAPSHOT_MANIFEST), "w") as f:
        json.dump(manifest, f, indent=2)
    return manifest


def read_snapshot_manifest(directory: str) -> dict:
    """Parse and digest-verify a snapshot artifact's ``snapshot.json``.
    Raises :class:`DeltaError` on a missing/torn/tampered manifest —
    the same refusal contract as delta.py's ``read_delta``."""
    path = os.path.join(directory, SNAPSHOT_MANIFEST)
    if not os.path.exists(path):
        raise DeltaError(
            f"{directory}: no {SNAPSHOT_MANIFEST} — not a snapshot "
            "artifact (or the publish died before staging completed)"
        )
    try:
        with open(path) as f:
            manifest = json.load(f)
    except ValueError as e:
        raise DeltaError(
            f"{path}: unparseable snapshot manifest ({e}) — the "
            "artifact write was torn; re-publish the snapshot"
        ) from e
    if manifest.get("format") != SNAPSHOT_FORMAT:
        raise DeltaError(
            f"{path}: format {manifest.get('format')!r}, expected "
            f"{SNAPSHOT_FORMAT!r}"
        )
    expected = manifest.get("manifest_sha256")
    if _manifest_digest(manifest) != expected:
        raise DeltaError(
            f"{path}: manifest self-digest mismatch — the manifest was "
            "modified after publish; refuse and re-publish"
        )
    return manifest


class DeltaPublisher:
    """Publish :class:`~photon_ml_tpu_torch.freshness.delta.ModelDelta`
    artifacts into a root directory, crash-safely.

    Thread-safe; one lock serializes publishes (a publication root has
    one writer — concurrent publishers on one root would race the
    sequence counter, which the claim-by-journal protocol would surface
    as a rename failure rather than corruption).
    """

    JOURNAL = "publish_journal.jsonl"

    def __init__(
        self,
        root: str,
        fsync: bool = True,
        abort_after: Optional[int] = None,
        retain_last: Optional[int] = None,
    ):
        if retain_last is not None and retain_last < 1:
            raise ValueError(
                f"retain_last must be >= 1 (the newest committed "
                f"publication is never pruned), got {retain_last}"
            )
        self.root = root
        self.fsync = fsync
        self.abort_after = abort_after
        self.retain_last = retain_last
        self.path = os.path.join(root, self.JOURNAL)
        self._lock = sanitizers.tracked(
            threading.Lock(), "freshness.publisher"
        )
        self._f = None
        self._written = 0
        os.makedirs(root, exist_ok=True)
        self.resume()

    # -- journal ------------------------------------------------------------
    def _append(self, record: dict) -> None:
        # Caller holds self._lock.
        if self.abort_after is not None and self._written >= self.abort_after:
            raise PublishAborted(
                f"journal abort hook: {self._written} records written"
            )
        if self._f is None:
            self._f = open(self.path, "a")
        self._f.write(json.dumps(record) + "\n")
        if self.fsync:
            fsync_file(self._f)
        else:
            self._f.flush()
        self._written += 1

    def _read(self) -> List[dict]:
        """Every complete journal record; a torn FINAL line is dropped,
        a torn line anywhere else raises (not an append-only journal)."""
        if not os.path.exists(self.path):
            return []
        if self._f is not None:
            self._f.flush()
        with open(self.path) as f:
            lines = f.read().splitlines()
        records = []
        for i, line in enumerate(lines):
            if not line.strip():
                continue
            try:
                records.append(json.loads(line))
            except json.JSONDecodeError:
                if i == len(lines) - 1:
                    break
                raise DeltaError(
                    f"{self.path}: corrupt journal line {i + 1} (not the "
                    "tail) — the file was edited or is not an append-only "
                    "journal; restore it from backup"
                ) from None
        return records

    # -- paths --------------------------------------------------------------
    def _final_dir(self, seq: int, artifact: str = "delta") -> str:
        return os.path.join(self.root, f"{artifact}-{seq:06d}")

    def _staging_dir(self, seq: int, artifact: str = "delta") -> str:
        return self._final_dir(seq, artifact) + ".staging"

    def _artifact_dirs(self, seq: int) -> List[str]:
        """Every directory (final or staging, either kind) a sequence
        number may occupy — retention removes whichever exists."""
        return [
            self._final_dir(seq, a) + suffix
            for a in ("delta", "snapshot")
            for suffix in ("", ".staging")
        ]

    # -- resume -------------------------------------------------------------
    def resume(self) -> List[dict]:
        """Complete or clean every in-flight publication, exactly as an
        uninterrupted run would have.  Returns the repair records
        journaled (empty on a clean root).  Called from ``__init__`` so
        merely constructing a publisher heals its root."""
        with self._lock:
            records = self._read()
            settled = {
                r["seq"] for r in records if r["kind"] in ("commit", "abort")
            }
            repairs: List[dict] = []
            max_seq = 0
            for r in records:
                max_seq = max(max_seq, r["seq"])
                if r["kind"] != "begin" or r["seq"] in settled:
                    continue
                seq = r["seq"]
                artifact = r.get("artifact", "delta")
                final = self._final_dir(seq, artifact)
                staging = self._staging_dir(seq, artifact)
                manifest_name = (
                    SNAPSHOT_MANIFEST if artifact == "snapshot"
                    else MANIFEST_FILE
                )
                if os.path.exists(os.path.join(final, manifest_name)):
                    # Crashed between the atomic rename and the commit
                    # record: the artifact is complete — verify and
                    # journal the commit an uninterrupted run would have.
                    manifest = (
                        read_snapshot_manifest(final)
                        if artifact == "snapshot"
                        else _read_manifest(final)
                    )
                    repair = {
                        "kind": "commit",
                        "seq": seq,
                        "artifact": artifact,
                        "path": final,
                        "manifest_sha256": manifest["manifest_sha256"],
                        "event_wall_epoch": manifest.get("event_wall_epoch"),
                        "n_changed_rows": (
                            0 if artifact == "snapshot"
                            else _manifest_rows(manifest)
                        ),
                        "publish_wall_epoch": r["publish_wall_epoch"],
                        "resumed": True,
                    }
                else:
                    # Crashed before the rename: nothing was published.
                    if os.path.isdir(staging):
                        shutil.rmtree(staging)
                    repair = {"kind": "abort", "seq": seq, "resumed": True}
                self._append(repair)
                repairs.append(repair)
            self._next_seq = max_seq + 1
            return repairs

    # -- publish ------------------------------------------------------------
    def publish(self, delta: ModelDelta) -> Publication:
        """Write ``delta`` as the next sequenced artifact.  Returns the
        committed :class:`Publication`.  Raises whatever the chaos
        harness injects at the ``publish.delta`` boundaries — after
        which a :meth:`resume` (or the next constructor) settles the
        root deterministically."""
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            publish_wall = time.time()
            self._append({
                "kind": "begin",
                "seq": seq,
                "publish_wall_epoch": publish_wall,
                "event_wall_epoch": delta.event_wall_epoch,
            })
            chaos_mod.maybe_fail("publish.delta", stage="journal", seq=seq)
            staging = self._staging_dir(seq)
            if os.path.isdir(staging):
                shutil.rmtree(staging)
            manifest = write_delta(delta, staging)
            chaos_mod.maybe_fail("publish.delta", stage="artifact", seq=seq)
            final = self._final_dir(seq)
            os.rename(staging, final)
            chaos_mod.maybe_fail("publish.delta", stage="commit", seq=seq)
            record = {
                "kind": "commit",
                "seq": seq,
                "path": final,
                "manifest_sha256": manifest["manifest_sha256"],
                "event_wall_epoch": delta.event_wall_epoch,
                "n_changed_rows": delta.n_changed_rows,
                "publish_wall_epoch": publish_wall,
            }
            self._append(record)
            retention = (
                self._retain_locked(self.retain_last)
                if self.retain_last is not None
                else None
            )
        hub = telemetry_mod.current()
        hub.counter("freshness_deltas_published_total").inc()
        hub.counter("freshness_delta_rows").inc(delta.n_changed_rows)
        hub.counter("freshness_delta_bytes").inc(_artifact_bytes(manifest))
        if retention is not None and retention["pruned"]:
            hub.counter("freshness_retention_pruned_total").inc(
                len(retention["pruned"])
            )
        return _publication(record)

    def publish_snapshot(
        self,
        model_dir: str,
        event_wall_epoch: Optional[float] = None,
    ) -> Publication:
        """Publish a FULL model directory as the next sequenced
        artifact (``snapshot-<seq>/model/`` + self-digested
        ``snapshot.json``) under the same begin/stage/rename/commit
        journal protocol as :meth:`publish` — a kill at any instant is
        settled by the next :meth:`resume`.  This is the cold-start
        anchor for publication-based model distribution: a host with no
        base pulls the newest snapshot, then catches up by deltas."""
        if not os.path.isdir(model_dir):
            raise DeltaError(
                f"{model_dir}: not a directory — publish_snapshot "
                "takes a saved model directory"
            )
        with self._lock:
            seq = self._next_seq
            self._next_seq += 1
            publish_wall = time.time()
            self._append({
                "kind": "begin",
                "seq": seq,
                "artifact": "snapshot",
                "publish_wall_epoch": publish_wall,
                "event_wall_epoch": event_wall_epoch,
            })
            chaos_mod.maybe_fail("publish.delta", stage="journal", seq=seq)
            staging = self._staging_dir(seq, "snapshot")
            if os.path.isdir(staging):
                shutil.rmtree(staging)
            shutil.copytree(
                model_dir, os.path.join(staging, SNAPSHOT_MODEL_DIR)
            )
            manifest = _write_snapshot_manifest(staging, event_wall_epoch)
            chaos_mod.maybe_fail("publish.delta", stage="artifact", seq=seq)
            final = self._final_dir(seq, "snapshot")
            os.rename(staging, final)
            chaos_mod.maybe_fail("publish.delta", stage="commit", seq=seq)
            record = {
                "kind": "commit",
                "seq": seq,
                "artifact": "snapshot",
                "path": final,
                "manifest_sha256": manifest["manifest_sha256"],
                "event_wall_epoch": event_wall_epoch,
                "n_changed_rows": 0,
                "publish_wall_epoch": publish_wall,
            }
            self._append(record)
            retention = (
                self._retain_locked(self.retain_last)
                if self.retain_last is not None
                else None
            )
        hub = telemetry_mod.current()
        hub.counter("freshness_snapshots_published_total").inc()
        hub.counter("freshness_snapshot_bytes").inc(
            sum(int(e["nbytes"]) for e in manifest["files"].values())
        )
        if retention is not None and retention["pruned"]:
            hub.counter("freshness_retention_pruned_total").inc(
                len(retention["pruned"])
            )
        return _publication(record)

    # -- retention ----------------------------------------------------------
    def retain(self, keep_last: int) -> dict:
        """Prune committed publications older than the newest
        ``keep_last``, compacting the journal and removing their
        artifact directories.  Returns a summary dict::

            {"pruned": [seq...],    # removed this call
             "blocked": [seq...],   # prunable by age, held by an ack
             "blocking": {seq: [subscriber_id...]},  # who holds each
             "kept": [seq...]}      # committed seqs still in the root

        Never removes an unsettled ``begin`` or the newest committed
        publication, and refuses any sequence a registered subscriber
        (``acks/``) has not acked yet — ``blocking`` names the guilty
        subscriber per held sequence, so the operator can chase it or
        :func:`remove_ack` it to release the prune.  Crash-safe: the
        journal is compacted by atomic rename BEFORE any artifact dir
        is removed, and orphan dirs from a kill in between are swept by
        the next retention."""
        with self._lock:
            retention = self._retain_locked(keep_last)
        hub = telemetry_mod.current()
        if retention["pruned"]:
            hub.counter(
                "freshness_retention_pruned_total"
            ).inc(len(retention["pruned"]))
        if retention["blocked"]:
            hub.counter(
                "freshness_retention_blocked_total"
            ).inc(len(retention["blocked"]))
            hub.event(
                "freshness.retention_blocked",
                root=self.root,
                blocked=retention["blocked"],
                blocking={
                    str(s): ids
                    for s, ids in retention["blocking"].items()
                },
            )
        return retention

    def _retain_locked(self, keep_last: int) -> dict:
        # Caller holds self._lock.
        if keep_last < 1:
            raise ValueError(
                f"keep_last must be >= 1 (the newest committed "
                f"publication is never pruned), got {keep_last}"
            )
        records = self._read()
        committed = sorted(
            {r["seq"] for r in records if r["kind"] == "commit"}
        )
        candidates = committed[:-keep_last]
        acks = read_acks(self.root)
        min_acked = min(acks.values()) if acks else None
        pruned = sorted(
            s for s in candidates if min_acked is None or s <= min_acked
        )
        blocked = sorted(set(candidates) - set(pruned))
        blocking = {
            s: sorted(sid for sid, acked in acks.items() if acked < s)
            for s in blocked
        }
        kept = sorted(set(committed) - set(pruned))
        summary = {
            "pruned": pruned, "blocked": blocked,
            "blocking": blocking, "kept": kept,
        }
        if not pruned:
            # Still sweep orphan dirs a prior kill may have left.
            self._sweep_orphans(records)
            return summary
        # floor: the oldest surviving commit.  Everything pruned sits
        # below it, so journal records for settled aborts down there are
        # noise too — drop them with the pruned commits.  Unsettled
        # begins and anything >= floor (including a trailing abort with
        # the max seq, which anchors _next_seq) survive compaction.
        floor = kept[0]
        settled = {
            r["seq"] for r in records if r["kind"] in ("commit", "abort")
        }
        drop = set(pruned) | {
            s for s in settled if s < floor and s not in set(committed)
        }
        compacted = [r for r in records if r["seq"] not in drop]
        compacted.append({
            "kind": "retention",
            "seq": max(drop),
            "pruned": sorted(drop),
            "floor_seq": floor,
            "wall_epoch": time.time(),
        })
        # Compact via write-temp + fsync + atomic rename.  The open
        # append handle points at the OLD inode — close it first so the
        # next _append reopens the compacted file.
        if self._f is not None:
            self._f.close()
            self._f = None
        tmp = self.path + ".tmp"
        with open(tmp, "w") as f:
            for r in compacted:
                f.write(json.dumps(r) + "\n")
            if self.fsync:
                fsync_file(f)
        os.replace(tmp, self.path)
        # Only now remove artifacts: a kill before this point leaves
        # orphan dirs (swept below / next time), never a journal that
        # references a missing artifact.
        for seq in sorted(drop):
            for path in self._artifact_dirs(seq):
                if os.path.isdir(path):
                    shutil.rmtree(path)
        self._sweep_orphans(compacted)
        return summary

    def _sweep_orphans(self, records: List[dict]) -> None:
        # Caller holds self._lock.  A delta-*/snapshot-* dir whose seq
        # no journal record references is a leftover from a kill between
        # journal compaction and artifact removal — safe to delete
        # (subscribers only ever follow commit records).  Retention
        # records describe PRUNED seqs, so they don't count as
        # references.
        referenced = {
            r["seq"] for r in records if r["kind"] != "retention"
        }
        for name in os.listdir(self.root):
            m = _ARTIFACT_DIR_RE.match(name)
            if m is None or int(m.group(1)) in referenced:
                continue
            path = os.path.join(self.root, name)
            if os.path.isdir(path):
                shutil.rmtree(path)

    def publications(self) -> List[Publication]:
        """Committed publications in sequence order — the only view
        subscribers get, so in-flight or aborted publishes are
        invisible to the apply side."""
        with self._lock:
            return [
                _publication(r)
                for r in self._read()
                if r["kind"] == "commit"
            ]

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "DeltaPublisher":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def read_publications(root: str) -> List[Publication]:
    """Committed publications under ``root``, in sequence order, without
    constructing a :class:`DeltaPublisher` (whose constructor RESUMES —
    i.e. writes).  This is the subscriber entry point: read-only, torn
    final journal line tolerated, in-flight/aborted publishes invisible.
    A missing journal is an empty root, not an error."""
    journal = os.path.join(root, DeltaPublisher.JOURNAL)
    if not os.path.exists(journal):
        return []
    with open(journal) as f:
        lines = f.read().splitlines()
    out: List[Publication] = []
    for i, line in enumerate(lines):
        if not line.strip():
            continue
        try:
            record = json.loads(line)
        except json.JSONDecodeError:
            if i == len(lines) - 1:
                break
            raise DeltaError(
                f"{journal}: corrupt journal line {i + 1} (not the tail) "
                "— the file was edited or is not an append-only journal; "
                "restore it from backup"
            ) from None
        if record["kind"] == "commit":
            out.append(_publication(record))
    return out


def _manifest_rows(manifest: dict) -> int:
    # n_changed already counts removals (CoordinateDelta.n_changed).
    return sum(int(c.get("n_changed", 0)) for c in manifest["coordinates"])


def _artifact_bytes(manifest: dict) -> int:
    return sum(int(c.get("nbytes", 0)) for c in manifest["coordinates"])


def _publication(record: dict) -> Publication:
    return Publication(
        seq=record["seq"],
        path=record["path"],
        manifest_sha256=record["manifest_sha256"],
        event_wall_epoch=record.get("event_wall_epoch"),
        n_changed_rows=int(record.get("n_changed_rows", 0)),
        publish_wall_epoch=record["publish_wall_epoch"],
        kind=record.get("artifact", "delta"),
    )
