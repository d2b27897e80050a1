"""The subscribe side of the publish/subscribe loop (port of
``photon_ml_tpu/freshness/applier.py``).

:class:`DeltaApplier` watches a publication root (the journal a
:class:`~photon_ml_tpu_torch.freshness.publisher.DeltaPublisher` writes) and
applies every newly-committed delta to a live
:class:`~photon_ml_tpu_torch.serving.service.ScoringService` in sequence
order, via the service's delta reload path (``swap_delta`` — bitwise
parity, zero dropped requests, one-step rollback).  It reads the
journal READ-ONLY: a subscriber never repairs or advances the
publisher's state.

Freshness accounting lives here and in the swapper: the swapper records
``freshness_event_to_servable_seconds`` at the commit instant; the
applier keeps the STALENESS gauges current between applies —
``freshness_model_age_seconds`` is how long ago the newest servable
event happened, and it grows until the next delta lands (the "model is
stale — now what?" runbook in docs/freshness.md keys off it).
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.freshness.publisher import (
    SNAPSHOT_MODEL_DIR,
    Publication,
    read_publications,
    write_ack,
)


class DeltaApplier:
    """Apply committed publications from ``root`` to ``service``.

    Use :meth:`poll_once` synchronously (the selfcheck and tests do) or
    :meth:`start`/:meth:`stop` for a background polling thread.  A
    publication whose apply comes back ``rolled_back`` (torn artifact,
    base mismatch, failed probe) is NOT retried — its sequence number
    is recorded as failed and the loop moves on, because re-applying
    the same artifact to the same base deterministically fails the same
    way; the operator escalates to a full reload (the runbook).

    Pass a ``subscriber_id`` to register with the root's ack sidecar
    (``acks/<subscriber_id>``): the applier acks its high-water
    ``applied_seq`` after every advance, and the publisher's retention
    then refuses to prune any publication this subscriber has not
    consumed yet.  Registration happens at construction (acked seq 0),
    so a freshly-attached subscriber immediately pins the whole root.
    Failed sequences are acked too — they are never retried, so
    holding their artifacts would pin the root forever.
    """

    def __init__(
        self,
        service,
        root: str,
        poll_interval_s: float = 0.25,
        subscriber_id: Optional[str] = None,
    ):
        self._service = service
        self.root = root
        self.poll_interval_s = float(poll_interval_s)
        self.subscriber_id = subscriber_id
        self.applied_seq = 0
        if subscriber_id is not None:
            write_ack(root, subscriber_id, self.applied_seq)
        self.applied = 0
        self.failed: List[int] = []
        #: wall epoch of the newest event now servable (staleness anchor).
        self._servable_event_wall: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- synchronous ---------------------------------------------------------
    def pending(self) -> List[Publication]:
        """Committed publications not yet applied, in sequence order."""
        return [
            p for p in read_publications(self.root)
            if p.seq > self.applied_seq
        ]

    def poll_once(self) -> list:
        """Apply every pending publication; returns their SwapResults
        (empty when the root has nothing new) and refreshes the
        staleness gauges either way."""
        tel = telemetry_mod.current()
        results = []
        seq_before = self.applied_seq
        for pub in self.pending():
            result = self._apply(pub)
            results.append(result)
            self.applied_seq = pub.seq
            if result.status == "swapped":
                self.applied += 1
                if pub.event_wall_epoch is not None:
                    self._servable_event_wall = pub.event_wall_epoch
            else:
                self.failed.append(pub.seq)
                tel.counter("freshness_apply_failures_total").inc()
                tel.event(
                    "freshness.apply_failed",
                    seq=pub.seq,
                    path=pub.path,
                    stage=result.stage,
                    reason=result.reason,
                )
        if self.subscriber_id is not None and self.applied_seq > seq_before:
            write_ack(self.root, self.subscriber_id, self.applied_seq)
        self._refresh_staleness()
        return results

    def _apply(self, pub: Publication):
        """One publication -> the matching reload path: deltas patch
        the live model (``mode="delta"``), snapshots full-reload from
        the artifact's ``model/`` subdir (a snapshot is a complete
        model, not a patch — applying one re-bases the subscriber)."""
        if pub.kind == "snapshot":
            return self._service.reload(
                os.path.join(pub.path, SNAPSHOT_MODEL_DIR)
            )
        return self._service.reload(pub.path, mode="delta")

    def _refresh_staleness(self) -> None:
        if self._servable_event_wall is None:
            return
        now_wall = time.time()
        telemetry_mod.current().gauge(
            "freshness_model_age_seconds"
        ).set(max(0.0, now_wall - self._servable_event_wall))

    # -- background ----------------------------------------------------------
    def start(self) -> "DeltaApplier":
        if self._thread is not None:
            raise RuntimeError("applier already started")
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="freshness-applier", daemon=True
        )
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self.poll_once()
            except Exception as exc:  # noqa: BLE001 — keep polling
                # A transient reload refusal (SwapInProgressError from a
                # concurrent operator /reload) must not kill the loop.
                telemetry_mod.current().event(
                    "freshness.poll_error",
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
            self._stop.wait(self.poll_interval_s)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def __enter__(self) -> "DeltaApplier":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stats(self) -> dict:
        return {
            "root": self.root,
            "subscriber_id": self.subscriber_id,
            "applied_seq": self.applied_seq,
            "applied": self.applied,
            "failed": list(self.failed),
            "servable_event_wall": self._servable_event_wall,
        }
