"""Crash-safe tuning state: the append-only journal and the trial store
(port of ``photon_ml_tpu/tuning/state.py``).

The orchestrator (tuning/executor.py) survives kills the same way the
training drivers do — by persisting state as it goes and replaying it on
``--resume`` (io/checkpoint.py).  A hyperparameter search's state is not
one blob but an ordered DECISION LOG: every ask (with the proposer's RNG
state after it), every intermediate rung report, every ASHA
promote/kill, every completion fed back to the proposer, every failure.
``TuningJournal`` appends each decision as one JSON line to
``tuning_state.jsonl`` with the same durability discipline as
io/checkpoint's atomic writes (flush + fsync before the append returns),
so a kill at any instant leaves a clean prefix of the uninterrupted
run's log — plus possibly one torn trailing line, which replay drops.

``replay_journal`` folds the record stream back into orchestrator state:
trials with their per-rung metrics and statuses, the event feed that
rebuilds the proposer (asks re-enter the pending set, tells re-enter the
observation set, in the original order), the last journaled RNG state
(so the resumed search proposes the SAME future points an uninterrupted
run would — reproducibility under resume), and the trailing reports
whose promote/kill/tell decision had not been journaled yet (the resumed
orchestrator re-derives those decisions deterministically).

A resume is REFUSED when the journal's search-space fingerprint (or the
proposer / ASHA / direction configuration) differs from the current
run's: replaying half a search into a different search silently blends
two experiments.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import os
import threading
from typing import Optional

import numpy as np

from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.io.checkpoint import _atomic_savez, fsync_file

JOURNAL_VERSION = 1


class SearchAborted(RuntimeError):
    """Raised by the journal's test/selfcheck abort hook to simulate a
    mid-flight kill at a deterministic record boundary."""


class ResumeMismatch(ValueError):
    """The journal on disk belongs to a DIFFERENT search (space
    fingerprint or search configuration changed); resuming would blend
    two experiments."""


class TuningJournal:
    """Append-only JSONL decision log with fsync-per-record durability.

    Threads: the orchestrator appends state-bearing records from its
    processing loop, but worker threads append informational ``retry``
    records mid-trial — the lock keeps lines whole.  ``abort_after``
    raises :class:`SearchAborted` INSTEAD of writing the (n+1)-th record
    of this process, simulating a kill exactly at a record boundary
    (torn trailing lines are covered separately by replay's tolerance).
    """

    FILENAME = "tuning_state.jsonl"

    def __init__(
        self,
        directory: str,
        fsync: bool = True,
        abort_after: Optional[int] = None,
    ):
        self.directory = directory
        self.path = os.path.join(directory, self.FILENAME)
        self.fsync = fsync
        self.abort_after = abort_after
        self._lock = sanitizers.tracked(threading.Lock(), "tuning.journal")
        self._f = None
        self._written = 0

    def exists(self) -> bool:
        return os.path.exists(self.path)

    def clear(self) -> None:
        self.close()
        if self.exists():
            os.remove(self.path)

    def append(self, record: dict) -> None:
        with self._lock:
            if (
                self.abort_after is not None
                and self._written >= self.abort_after
            ):
                raise SearchAborted(
                    f"journal abort hook: {self._written} records written"
                )
            if self._f is None:
                os.makedirs(self.directory, exist_ok=True)
                self._f = open(self.path, "a")
            self._f.write(json.dumps(record, default=_json_default) + "\n")
            if self.fsync:
                fsync_file(self._f)
            else:
                self._f.flush()
            self._written += 1

    def read(self) -> list[dict]:
        """Every complete record on disk.  A torn final line (kill mid-
        write without fsync, or a crashed filesystem) is dropped; a torn
        line anywhere ELSE means the file is not an append-only journal
        and raises."""
        if not self.exists():
            return []
        with self._lock:
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
                    break  # torn tail from a mid-write kill
                raise ValueError(
                    f"{self.path}: corrupt journal line {i + 1} (not the "
                    "trailing line — the file was edited or is not a "
                    "journal)"
                )
        return records

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    def __enter__(self) -> "TuningJournal":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False


def _json_default(o):
    if isinstance(o, np.generic):
        return o.item()
    if isinstance(o, np.ndarray):
        return o.tolist()
    raise TypeError(f"not JSON-serializable: {type(o).__name__}")


class TrialStore:
    """Per-trial coefficient persistence (``trial_<id>.npz`` next to the
    journal, atomic write via io/checkpoint's protocol).

    Completed trials' coefficient vectors feed the executor's
    nearest-point warm-start cache; journaling them as JSON would bloat
    the decision log at real GLM widths, so they live in sidecar .npz
    files the journal's ``tell`` records imply.  Saved BEFORE the
    trial's ``report`` record is appended, so any journaled completion
    has its coefficients on disk.

    Each rung's coefficients also go to ``trial_<id>_rung<r>.npz``, and a
    resume reads the file of the trial's last JOURNALED rung: a kill
    between a rung's save and its report record leaves that rung's
    coefficients in ``trial_<id>.npz``, and the reference's resume, which
    reads that file, warm-starts the rung's re-run from the rung's own
    result instead of the previous rung's, so the resumed search parts
    from the uninterrupted one.  ``trial_<id>.npz`` keeps the reference's
    format (the latest rung), and a store without rung files (one the
    reference wrote) is read as the reference reads it."""

    def __init__(self, directory: str):
        self.directory = directory

    def _path(self, trial_id: int, rung: Optional[int] = None) -> str:
        tail = "" if rung is None else f"_rung{int(rung)}"
        return os.path.join(self.directory, f"trial_{trial_id}{tail}.npz")

    def save(
        self, trial_id: int, params: np.ndarray, coefficients: np.ndarray,
        rung: Optional[int] = None,
    ) -> None:
        os.makedirs(self.directory, exist_ok=True)
        arrays = {
            "params": np.asarray(params, np.float64),
            "coefficients": np.asarray(coefficients),
        }
        if rung is not None:
            _atomic_savez(self._path(trial_id, rung), arrays)
        _atomic_savez(self._path(trial_id), arrays)

    def load(self, trial_id: int, rung: Optional[int] = None):
        """(params, coefficients) of the latest rung saved, or of ``rung``
        (the latest when no rung files exist); None when nothing is."""
        path = self._path(trial_id, rung)
        if rung is not None and not os.path.exists(path):
            rungs = glob.glob(os.path.join(self.directory,
                                           f"trial_{trial_id}_rung*.npz"))
            if rungs:
                return None
            path = self._path(trial_id)
        if not os.path.exists(path):
            return None
        with np.load(path) as z:
            return z["params"], z["coefficients"]

    def clear(self) -> None:
        for path in glob.glob(os.path.join(self.directory, "trial_*.npz")):
            os.remove(path)


# ---------------------------------------------------------------------------
# Replay
# ---------------------------------------------------------------------------

#: journal record types that carry orchestrator state; anything else
#: ("retry", "resumed", future additions) is informational and skipped.
STATE_RECORD_TYPES = (
    "header", "ask", "wave", "report", "promote", "kill", "tell", "fail",
)


@dataclasses.dataclass
class ReplayedTrial:
    id: int
    params: np.ndarray
    status: str = "running"  # running | completed | killed | failed
    rung: int = 0  # current rung (promotions applied)
    reports: dict = dataclasses.field(default_factory=dict)  # rung → record
    final_metric: Optional[float] = None
    #: a failed trial's journaled error (the reference's replay drops it,
    #: so its resumed trial history reads ``error: None``)
    error: Optional[str] = None


@dataclasses.dataclass
class ReplayState:
    """Everything the orchestrator needs to continue a journaled search."""

    header: dict
    trials: dict  # id → ReplayedTrial
    #: ("ask", params) | ("tell", params, y) | ("resolve", params) in
    #: journal order — folded into the proposer to rebuild its
    #: observation + pending sets.
    proposer_events: list
    #: proposer RNG state after the last journaled ask (None = no asks).
    rng_state: Optional[dict]
    #: (trial_id, rung, y) for every report whose decision WAS journaled —
    #: inserted into the ASHA rung tables without re-deciding.
    decided_reports: list
    #: report records whose promote/kill/tell decision was lost with the
    #: crash — the resumed orchestrator re-derives them, in this order.
    undecided: list
    #: the last journaled wave's [trial, rung] tasks — the wave in flight
    #: at the crash.  Its unreported tasks must re-run as ONE wave (not
    #: merge with later promotions), or the resumed schedule compresses
    #: rungs relative to the uninterrupted run and proposals diverge.
    last_wave: list = dataclasses.field(default_factory=list)
    n_records: int = 0
    #: trials completed before the last wave record: the warm-start cache
    #: the in-flight wave was submitted with.  The re-run of that wave must
    #: warm-start from these only, not from completions its own processing
    #: journaled before the crash (the reference's resume uses every
    #: replayed completion, and its warm starts part from the
    #: uninterrupted run's).
    completed_before_wave: frozenset = frozenset()


def replay_journal(records: list[dict]) -> ReplayState:
    """Fold a journal record stream back into orchestrator state.

    Raises ``ValueError`` if the stream does not start with a header.
    Decision records referencing unknown trials raise — the journal is
    append-only, so that can only mean a hand-edited file."""
    if not records or records[0].get("type") != "header":
        raise ValueError(
            "tuning journal has no header record — not a tuning_state.jsonl"
        )
    header = records[0]
    sign = -1.0 if header.get("maximize") else 1.0
    trials: dict[int, ReplayedTrial] = {}
    proposer_events: list = []
    rng_state = None
    decided: list = []

    def trial(rec) -> ReplayedTrial:
        t = trials.get(rec["trial"])
        if t is None:
            raise ValueError(
                f"journal decision for unknown trial {rec['trial']} "
                "(record without a preceding ask)"
            )
        return t

    last_wave: list = []
    told: list = []  # trial ids in the order of their tell records
    completed_before_wave: frozenset = frozenset()
    for rec in records[1:]:
        kind = rec.get("type")
        if kind == "wave":
            last_wave = [tuple(t) for t in rec["tasks"]]
            completed_before_wave = frozenset(told)
        elif kind == "ask":
            params = np.asarray(rec["params"], float)
            trials[rec["trial"]] = ReplayedTrial(rec["trial"], params)
            proposer_events.append(("ask", params))
            rng_state = rec.get("rng_state", rng_state)
        elif kind == "report":
            trial(rec).reports[int(rec["rung"])] = rec
        elif kind == "promote":
            t = trial(rec)
            r = int(rec["rung"]) - 1
            decided.append((t.id, r, sign * t.reports[r]["metric"]))
            t.rung = int(rec["rung"])
        elif kind == "kill":
            t = trial(rec)
            t.status = "killed"
            decided.append((t.id, int(rec["rung"]), sign * rec["metric"]))
            proposer_events.append(("tell", t.params, sign * rec["metric"]))
        elif kind == "tell":
            t = trial(rec)
            t.status = "completed"
            t.final_metric = float(rec["metric"])
            decided.append((t.id, t.rung, sign * rec["metric"]))
            proposer_events.append(("tell", t.params, sign * rec["metric"]))
            told.append(t.id)
        elif kind == "fail":
            t = trial(rec)
            t.status = "failed"
            t.error = rec.get("error")
            proposer_events.append(("resolve", t.params))
        # informational records ("retry", "resumed") carry no state

    # Reports whose decision record was lost with the crash: the trial is
    # still "running" and the report sits at its CURRENT rung.
    undecided = [
        t.reports[t.rung]
        for t in sorted(trials.values(), key=lambda t: t.id)
        if t.status == "running" and t.rung in t.reports
    ]
    return ReplayState(
        header=header,
        trials=trials,
        proposer_events=proposer_events,
        rng_state=rng_state,
        decided_reports=decided,
        undecided=undecided,
        last_wave=last_wave,
        n_records=len(records),
        completed_before_wave=completed_before_wave,
    )
