"""Publication-based model distribution: cold start + catch-up over
the wire, no shared filesystem anywhere on the serving path (port of
``photon_ml_tpu/cluster/distribution.py``; host code, copied, the same
routes and cache layout).

The freshness root holds journaled snapshot/delta publications with
per-subscriber acks, but a local subscriber reads the root's DIRECTORY.
Cross-machine fleets have no shared directory.  This module puts an HTTP transport around the root:

- :class:`PublicationServer` — serves a freshness root read-only over
  HTTP: ``GET /publications`` (the committed journal view,
  ``read_publications``), ``GET /blob/<seq>/<relpath>`` (raw artifact
  bytes, traversal-guarded), plus the ack sidecar as POSTs
  (``/ack``, ``/unregister``) so remote subscribers participate in
  retention exactly like local ones.
- :class:`PublicationClient` — the pull side: list publications, then
  ``fetch`` one into a local cache dir — manifest FIRST, verified
  against the journal's ``manifest_sha256`` (so a tampered or torn
  server-side artifact is refused before any payload downloads), then
  every listed file with its own sha256 check, staged and atomically
  renamed.  End-to-end the checksums chain journal -> manifest ->
  file bytes; a mismatch anywhere refuses the artifact.  Transient
  download failures retry per file (``cluster.fetch`` chaos seam).
- :func:`cold_start` — a brand-new host's bootstrap: newest committed
  SNAPSHOT publication (deltas patch a base; a cold host has none),
  fetched and verified, returns the local model dir + the snapshot
  seq to resume catching up from.  A root with no snapshot is a
  pointed error naming the fix (``publish_snapshot``).
- :class:`RemoteApplier` — ``DeltaApplier``'s contract over the wire:
  apply every newly-committed publication in sequence order (deltas
  via the delta reload path, snapshots via full reload), ack the
  high-water seq through the server, never retry a failed apply.

Metric family: ``cluster_*``.  Chaos seam: ``cluster.fetch`` fires
per blob download (a fault is a dropped transfer — the client
retries; exhausted retries fail the fetch, which cold start/apply
surface).  docs/serving.md "Cluster" has the cold-start walkthrough.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import threading
import time
import urllib.request
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.freshness.delta import (
    MANIFEST_FILE,
    DeltaError,
    _manifest_digest,
)
from photon_ml_tpu_torch.freshness.publisher import (
    SNAPSHOT_MANIFEST,
    SNAPSHOT_MODEL_DIR,
    Publication,
    read_publications,
    remove_ack,
    write_ack,
)


class FetchError(RuntimeError):
    """A publication could not be fetched/verified over the wire."""


# ---------------------------------------------------------------------------
# Server
# ---------------------------------------------------------------------------

class PublicationServer:
    """Serve a freshness root over HTTP, read-only plus the ack
    sidecar.  The root's PUBLISHER stays wherever the training loop
    runs; this server is just the wire in front of its directory."""

    def __init__(self, root: str):
        self.root = root
        self._server = None
        self._thread: Optional[threading.Thread] = None

    def serve(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> "PublicationServer":
        if self._server is not None:
            return self
        server = _PubServer((host, port), _PubHandler)
        server.pub_root = self.root
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="cluster-publication-http", daemon=True,
        )
        self._thread.start()
        return self

    @property
    def base_url(self) -> str:
        if self._server is None:
            raise RuntimeError("publication server is not serving")
        h, p = self._server.server_address[:2]
        return f"http://{h}:{p}"

    def close(self, timeout: float = 5.0) -> None:
        server, thread = self._server, self._thread
        self._server, self._thread = None, None
        if server is not None:
            server.shutdown()
            server.server_close()
        if thread is not None:
            thread.join(timeout=timeout)


class _PubServer(ThreadingHTTPServer):
    daemon_threads = True
    #: listen backlog: the serving host's (``serving/service.py``).
    request_queue_size = 128
    pub_root: str


class _PubHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass

    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def _send_bytes(self, payload: bytes) -> None:
        self.send_response(200)
        self.send_header("Content-Type", "application/octet-stream")
        self.send_header("Content-Length", str(len(payload)))
        self.end_headers()
        self.wfile.write(payload)

    def do_GET(self) -> None:  # noqa: N802 — stdlib casing
        root = self.server.pub_root
        if self.path == "/publications":
            pubs = read_publications(root)
            self._send_json(200, {"publications": [
                {
                    "seq": p.seq,
                    "kind": p.kind,
                    "manifest_sha256": p.manifest_sha256,
                    "event_wall_epoch": p.event_wall_epoch,
                    "n_changed_rows": p.n_changed_rows,
                    "publish_wall_epoch": p.publish_wall_epoch,
                    "dir": os.path.basename(p.path),
                }
                for p in pubs
            ]})
            return
        if self.path == "/healthz":
            self._send_json(200, {
                "status": "ok",
                "publications": len(read_publications(root)),
            })
            return
        if self.path.startswith("/blob/"):
            self._do_blob(root, self.path[len("/blob/"):])
            return
        self._send_json(404, {"error": f"no route {self.path}"})

    def _do_blob(self, root: str, rest: str) -> None:
        # /blob/<seq>/<relpath>: only files inside a COMMITTED
        # publication's directory are served — the journal, staging
        # dirs, and anything path-traversal can reach are refused.
        seq_s, _, relpath = rest.partition("/")
        try:
            seq = int(seq_s)
        except ValueError:
            self._send_json(400, {"error": f"bad seq {seq_s!r}"})
            return
        pub = next(
            (p for p in read_publications(root) if p.seq == seq), None
        )
        if pub is None:
            self._send_json(
                404, {"error": f"no committed publication seq {seq}"}
            )
            return
        base = os.path.realpath(pub.path)
        full = os.path.realpath(os.path.join(base, relpath))
        if not (full == base or full.startswith(base + os.sep)):
            self._send_json(
                403, {"error": f"path {relpath!r} escapes the artifact"}
            )
            return
        try:
            with open(full, "rb") as f:
                payload = f.read()
        except (FileNotFoundError, IsADirectoryError):
            self._send_json(
                404, {"error": f"no file {relpath!r} in seq {seq}"}
            )
            return
        tel = telemetry_mod.current()
        tel.counter("cluster_blob_requests_total").inc()
        tel.counter("cluster_blob_bytes_total").inc(len(payload))
        self._send_bytes(payload)

    def do_POST(self) -> None:  # noqa: N802 — stdlib casing
        root = self.server.pub_root
        n = int(self.headers.get("Content-Length") or 0)
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as exc:
            self._send_json(400, {"error": f"bad JSON body: {exc}"})
            return
        subscriber = payload.get("subscriber_id")
        if not subscriber:
            self._send_json(400, {"error": "subscriber_id is required"})
            return
        if self.path == "/ack":
            try:
                write_ack(root, subscriber, int(payload.get("seq", 0)))
            except (TypeError, ValueError) as exc:
                self._send_json(400, {"error": str(exc)})
                return
            telemetry_mod.current().counter("cluster_acks_total").inc()
            self._send_json(200, {"ok": True})
        elif self.path == "/unregister":
            try:
                removed = remove_ack(root, subscriber)
            except ValueError as exc:
                self._send_json(400, {"error": str(exc)})
                return
            self._send_json(200, {"ok": True, "removed": removed})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})


# ---------------------------------------------------------------------------
# Client
# ---------------------------------------------------------------------------

def _http_get(url: str, timeout_s: float) -> bytes:
    with urllib.request.urlopen(url, timeout=timeout_s) as resp:
        if resp.status != 200:
            raise FetchError(f"GET {url} -> HTTP {resp.status}")
        return resp.read()


class PublicationClient:
    """Pull publications from a :class:`PublicationServer` into a
    local cache, checksum-verified end to end."""

    def __init__(
        self,
        base_url: str,
        cache_dir: str,
        timeout_s: float = 30.0,
        retries: int = 2,
    ):
        self.base_url = str(base_url).rstrip("/")
        self.cache_dir = cache_dir
        self.timeout_s = float(timeout_s)
        self.retries = int(retries)
        self.fetches = 0
        self.fetch_retries = 0
        os.makedirs(cache_dir, exist_ok=True)

    # -- listing ------------------------------------------------------------
    def publications(self) -> List[Publication]:
        raw = _http_get(
            self.base_url + "/publications", self.timeout_s
        )
        out = []
        for p in json.loads(raw)["publications"]:
            out.append(Publication(
                seq=int(p["seq"]),
                path=p["dir"],  # server-relative name; fetch localizes
                manifest_sha256=p["manifest_sha256"],
                event_wall_epoch=p.get("event_wall_epoch"),
                n_changed_rows=int(p.get("n_changed_rows", 0)),
                publish_wall_epoch=p["publish_wall_epoch"],
                kind=p.get("kind", "delta"),
            ))
        return out

    # -- fetching -----------------------------------------------------------
    def _local_dir(self, pub: Publication) -> str:
        return os.path.join(
            self.cache_dir, f"{pub.kind}-{pub.seq:06d}"
        )

    def _get_blob(self, pub: Publication, relpath: str) -> bytes:
        """One artifact file over the wire, with per-file retry: a
        transient drop (the ``cluster.fetch`` seam) re-requests the
        SAME file; checksums downstream make re-reads safe."""
        url = f"{self.base_url}/blob/{pub.seq}/{relpath}"
        tel = telemetry_mod.current()
        last: Optional[Exception] = None
        for attempt in range(self.retries + 1):
            try:
                # The transfer seam: a fault is this blob's download
                # dropped mid-flight (docs/robustness.md).
                chaos_mod.maybe_fail(
                    "cluster.fetch", seq=pub.seq, file=relpath,
                )
                return _http_get(url, self.timeout_s)
            except Exception as exc:  # noqa: BLE001 — retry transfers
                last = exc
                if attempt < self.retries:
                    self.fetch_retries += 1
                    tel.counter("cluster_fetch_retries").inc()
        tel.counter("cluster_fetch_failures_total").inc()
        raise FetchError(
            f"blob {relpath} of seq {pub.seq} failed after "
            f"{self.retries + 1} attempts: {last}"
        ) from last

    def _manifest_and_files(
        self, pub: Publication
    ) -> Tuple[str, bytes, Dict[str, dict]]:
        """Download + verify the manifest; returns ``(manifest_name,
        manifest_bytes, {relpath: {"sha256", "nbytes"}})``.  The
        manifest's self-digest must equal the JOURNAL's recorded
        digest — the end-to-end anchor: a server whose artifact
        diverged from its journal is refused here, before any payload
        moves."""
        name = (
            SNAPSHOT_MANIFEST if pub.kind == "snapshot"
            else MANIFEST_FILE
        )
        raw = self._get_blob(pub, name)
        try:
            manifest = json.loads(raw)
        except json.JSONDecodeError as exc:
            raise FetchError(
                f"seq {pub.seq}: unparseable manifest {name}: {exc}"
            ) from exc
        digest = _manifest_digest(manifest)
        if digest != pub.manifest_sha256 or \
                digest != manifest.get("manifest_sha256"):
            raise FetchError(
                f"seq {pub.seq}: manifest digest mismatch (journal "
                f"{pub.manifest_sha256[:16]}…, computed {digest[:16]}…)"
                " — the artifact diverged from the journal; refuse"
            )
        if pub.kind == "snapshot":
            files = {
                rel: {"sha256": e["sha256"], "nbytes": e["nbytes"]}
                for rel, e in manifest["files"].items()
            }
        else:
            files = {
                c["file"]: {"sha256": c["sha256"], "nbytes": c["nbytes"]}
                for c in manifest["coordinates"]
                if c.get("file")
            }
        return name, raw, files

    def fetch(self, pub: Publication) -> str:
        """Materialize one publication into the local cache; returns
        the local artifact directory (same layout as the root's).
        Idempotent: an already-fetched seq returns its cached dir
        without touching the wire (the atomic rename below is the
        completeness marker)."""
        final = self._local_dir(pub)
        if os.path.isdir(final):
            return final
        t0 = time.perf_counter()
        tel = telemetry_mod.current()
        name, raw_manifest, files = self._manifest_and_files(pub)
        staging = final + ".staging"
        if os.path.isdir(staging):
            shutil.rmtree(staging)
        os.makedirs(staging)
        total = 0
        try:
            for relpath, entry in sorted(files.items()):
                payload = self._get_blob(pub, relpath)
                actual = hashlib.sha256(payload).hexdigest()
                if actual != entry["sha256"]:
                    raise FetchError(
                        f"seq {pub.seq} file {relpath}: sha256 "
                        f"mismatch (wire {actual[:16]}…, manifest "
                        f"{entry['sha256'][:16]}…) — transfer "
                        "corrupted or server tampered; refuse"
                    )
                dest = os.path.join(staging, relpath)
                os.makedirs(os.path.dirname(dest), exist_ok=True)
                with open(dest, "wb") as f:
                    f.write(payload)
                total += len(payload)
            with open(os.path.join(staging, name), "wb") as f:
                f.write(raw_manifest)
        except Exception:
            shutil.rmtree(staging, ignore_errors=True)
            raise
        if os.path.isdir(final):
            # A concurrent fetch won the rename; ours is redundant.
            shutil.rmtree(staging)
        else:
            os.replace(staging, final)
        self.fetches += 1
        tel.counter("cluster_fetches_total").inc()
        tel.counter("cluster_fetch_bytes_total").inc(
            total + len(raw_manifest)
        )
        tel.histogram("cluster_fetch_seconds").observe(
            time.perf_counter() - t0
        )
        return final

    # -- ack sidecar over the wire ------------------------------------------
    def _post(self, route: str, payload: dict) -> dict:
        body = json.dumps(payload).encode()
        req = urllib.request.Request(
            self.base_url + route, data=body, method="POST",
            headers={"Content-Type": "application/json"},
        )
        with urllib.request.urlopen(req, timeout=self.timeout_s) as resp:
            return json.loads(resp.read() or b"{}")

    def ack(self, subscriber_id: str, seq: int) -> None:
        self._post("/ack", {"subscriber_id": subscriber_id, "seq": seq})

    def unregister(self, subscriber_id: str) -> bool:
        out = self._post(
            "/unregister", {"subscriber_id": subscriber_id}
        )
        return bool(out.get("removed"))


# ---------------------------------------------------------------------------
# Cold start + remote catch-up
# ---------------------------------------------------------------------------

def cold_start(
    client: PublicationClient,
    subscriber_id: Optional[str] = None,
) -> Tuple[str, Publication]:
    """Bootstrap a host with NO local model state: fetch the newest
    committed snapshot publication and return ``(local_model_dir,
    snapshot_publication)`` — load the dir, then hand the seq to a
    :class:`RemoteApplier` to catch up by deltas.  Registers
    ``subscriber_id``'s ack at the snapshot seq when given, so
    retention holds every delta this host still needs."""
    snapshots = [
        p for p in client.publications() if p.kind == "snapshot"
    ]
    if not snapshots:
        raise DeltaError(
            "cold start needs a snapshot publication and the root has "
            "none — deltas patch a base a cold host does not have; "
            "run DeltaPublisher.publish_snapshot(model_dir) on the "
            "publisher side first"
        )
    newest = max(snapshots, key=lambda p: p.seq)
    local = client.fetch(newest)
    if subscriber_id is not None:
        client.ack(subscriber_id, newest.seq)
    telemetry_mod.current().counter("cluster_cold_starts_total").inc()
    telemetry_mod.current().event(
        "cluster.cold_start",
        seq=newest.seq, subscriber_id=subscriber_id,
    )
    return os.path.join(local, SNAPSHOT_MODEL_DIR), newest


class RemoteApplier:
    """:class:`~photon_ml_tpu_torch.freshness.applier.DeltaApplier`'s
    contract, over the wire: poll the publication server, fetch every
    newly-committed publication (checksum-verified), apply in sequence
    order — deltas via the service's delta reload, snapshots via full
    reload — and ack the high-water seq through the server.  A failed
    apply is recorded and NEVER retried (same reasoning as the local
    applier: a deterministic failure repeats; the runbook escalates to
    a fresh cold start)."""

    def __init__(
        self,
        service,
        client: PublicationClient,
        subscriber_id: str,
        start_seq: int = 0,
        poll_interval_s: float = 0.25,
    ):
        self._service = service
        self.client = client
        self.subscriber_id = str(subscriber_id)
        self.applied_seq = int(start_seq)
        self.poll_interval_s = float(poll_interval_s)
        self.applied = 0
        self.failed: List[int] = []
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> list:
        """Fetch + apply every pending publication; returns their
        SwapResults.  Listing failures (server briefly down) return
        empty — the next poll catches up."""
        try:
            pending = [
                p for p in self.client.publications()
                if p.seq > self.applied_seq
            ]
        except Exception as exc:  # noqa: BLE001 — degrade, never die
            telemetry_mod.current().event(
                "cluster.applier_poll_failed",
                subscriber_id=self.subscriber_id,
                error=f"{type(exc).__name__}: {exc}"[:200],
            )
            return []
        results = []
        seq_before = self.applied_seq
        tel = telemetry_mod.current()
        for pub in sorted(pending, key=lambda p: p.seq):
            try:
                local = self.client.fetch(pub)
                if pub.kind == "snapshot":
                    result = self._service.reload(
                        os.path.join(local, SNAPSHOT_MODEL_DIR)
                    )
                else:
                    result = self._service.reload(local, mode="delta")
            except Exception as exc:  # noqa: BLE001 — never retried
                self.failed.append(pub.seq)
                self.applied_seq = pub.seq
                tel.event(
                    "cluster.apply_failed",
                    subscriber_id=self.subscriber_id,
                    seq=pub.seq,
                    error=f"{type(exc).__name__}: {exc}"[:200],
                )
                continue
            results.append(result)
            self.applied_seq = pub.seq
            if result.status == "swapped":
                self.applied += 1
            else:
                self.failed.append(pub.seq)
                tel.event(
                    "cluster.apply_failed",
                    subscriber_id=self.subscriber_id,
                    seq=pub.seq,
                    stage=result.stage,
                    reason=result.reason,
                )
        if self.applied_seq > seq_before:
            try:
                self.client.ack(self.subscriber_id, self.applied_seq)
            except Exception:  # noqa: BLE001 — next advance re-acks
                pass
        return results

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "RemoteApplier":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._run,
                name=f"cluster-applier-{self.subscriber_id}",
                daemon=True,
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop_evt.is_set():
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — keep polling
                pass
            self._stop_evt.wait(self.poll_interval_s)

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=timeout)

    def stats(self) -> dict:
        return {
            "subscriber_id": self.subscriber_id,
            "applied_seq": self.applied_seq,
            "applied": self.applied,
            "failed": list(self.failed),
        }
