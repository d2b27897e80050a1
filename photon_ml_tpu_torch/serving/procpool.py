"""Process-backed replica pool: crash-isolated workers behind the supervisor
(port of ``photon_ml_tpu/serving/procpool.py``).

The GIL-escape half of the serving HA story (docs/serving.md
"Process-level workers"): each replica is an OS process
(serving/worker.py) with its own fault domain — a native crash, an OOM
kill, or a SIGKILL costs one worker, never the serving parent.  The
pieces:

- :class:`WorkerPool` — publishes the model into shared memory ONCE
  (serving/shm_model.py; N workers map ~1x the bytes, reported by
  ``serving_shared_segment_bytes``), tracks model generations for the
  swap/rollback window (the last TWO stay linked so a worker restarted
  mid-swap can still attach), parses requests parent-side via
  :class:`~photon_ml_tpu_torch.serving.runtime.RequestParser`, and merges
  every worker's heartbeat metrics into the parent registry so
  /metrics, /stats, and the flight recorder keep a pool-wide view.
- :class:`ProcessReplica` — the parent-side stub satisfying the
  supervisor's route/probe/restart interface (``submit`` / ``stop`` /
  ``runtime`` / ``queue_depth`` / ``stats``, plus ``kill`` for scripted
  crashes): spawns its worker (spawn context — a forked child of a
  process that holds a CUDA context cannot use the card), frames
  requests over the socketpair, resolves futures off a reader thread,
  and on worker death fails every in-flight row
  with the watchdog's TRANSIENT vocabulary — which is exactly what
  makes the supervisor resubmit them to a peer, so a SIGKILL under load
  costs zero failed requests.

The chaos seam ``serving.worker`` fires at routing time and — unlike
the in-process ``serving.replica`` seam — actually SIGKILLs the routed
worker before raising, so a scripted fault exercises the real
death-mid-batch path: EOF on the pipe, transient failure of in-flight
rows, supervisor mark-down, decorrelated-jitter respawn.

The device is explicit (``RuntimeConfig.device``: None is the card,
``"cpu"`` the plain version) and rides the spawn arguments; no CUDA
tensor crosses the process boundary — only shared-memory numpy segments
and frames do.  On the card the pool builds the serving library once
before spawning, so no worker pays ``nvcc``; a worker that cannot build
or launch the kernel fails its spawn, and with it the supervisor's
start.  Each worker's ``serve_margins`` launches (heartbeat
``launches``) fold into the parent's ``ops/_kernels.py::LAUNCHES`` and
into :attr:`WorkerPool.worker_launches`.
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
import queue
import signal
import socket
import threading
import time
from concurrent.futures import Future
from typing import Dict, List, Optional

import torch

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.serving import shm_model
from photon_ml_tpu_torch.serving import worker as worker_mod
from photon_ml_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    RejectedError,
)
from photon_ml_tpu_torch.serving.protocol import FrameConn
from photon_ml_tpu_torch.serving.runtime import RequestParser, RuntimeConfig

__all__ = ["WorkerPool", "ProcessReplica"]

#: the key under which a worker's batch count rides the launch fold.
_BATCHES = "batches"


@dataclasses.dataclass
class _Generation:
    """One published model generation: its shared-memory manifest plus
    the parent-side parser state needed to serve it.  The host-side
    model object is retained so the delta-apply path (serving/swap.py
    ``swap_delta``) can patch the CURRENT generation parent-side and
    publish the result as the next one — without it, a delta would have
    to re-load the base from disk, defeating the point."""

    manifest: dict
    parser: RequestParser
    version: int
    path: Optional[str]
    model: object = None
    index_maps: Optional[dict] = None
    #: the runtime_config a tenant swap carried, so a respawned worker
    #: replays the route with the same knobs (None = pool default).
    runtime_config: Optional[RuntimeConfig] = None


class _WorkerRuntimeView:
    """What ``replica.batcher.runtime`` reads as in pool mode: the
    heartbeat-fed identity/health attributes the supervisor, service,
    and swapper consult via getattr — never a scorable runtime (scoring
    lives in the worker process)."""

    def __init__(self, pool: "WorkerPool"):
        self._pool = pool
        self.model_version = pool.version
        self.model_path = pool.model_path
        self.degraded = False
        self.ready = False
        self.pid: Optional[int] = None

    @property
    def config(self) -> RuntimeConfig:
        return self._pool.runtime_config

    def parse_request(self, obj: dict):
        return self._pool.parser.parse(obj)


class _PoolRuntimeView:
    """Pool-level stand-in for ``ScoringService.current_runtime``:
    version identity from the pool's current generation, parsing via
    the shared parser.  The service's isinstance(ScoringRuntime) guards
    skip runtime-only extras for it by design."""

    def __init__(self, pool: "WorkerPool"):
        self._pool = pool

    @property
    def model_version(self) -> int:
        return self._pool.version

    @property
    def model_path(self) -> Optional[str]:
        return self._pool.model_path

    @property
    def config(self) -> RuntimeConfig:
        return self._pool.runtime_config

    ready = True
    degraded = False

    def parse_request(self, obj: dict):
        return self._pool.parser.parse(obj)

    def probe_row(self):
        return self._pool.parser.probe_row()

    def stats(self) -> dict:
        return self._pool.stats()


class ProcessReplica:
    """Parent-side handle on one worker process, duck-typed to the
    MicroBatcher surface the supervisor routes/probes/stops."""

    def __init__(
        self,
        pool: "WorkerPool",
        rid: int,
        batcher_config: Optional[BatcherConfig] = None,
        start_timeout_s: float = 120.0,
    ):
        self.pool = pool
        self.rid = rid
        self.config = batcher_config or BatcherConfig()
        self.runtime = _WorkerRuntimeView(pool)
        self._lock = sanitizers.tracked(
            threading.Lock(), "serving.procpool"
        )
        self._inflight: Dict[int, Future] = {}
        self._next_id = 0
        # Parent-side backstop only — real admission control runs in the
        # worker's batcher; this just bounds parent memory if a worker
        # wedges with the socket open.
        self._max_inflight = 4 * self.config.max_queue
        self._control: "queue.Queue" = queue.Queue()
        self._ready_evt = threading.Event()
        self._bye = threading.Event()
        self._fatal: Optional[str] = None
        self._stopped = False
        self._hb: dict = {}

        parent_sock, child_sock = socket.socketpair()
        self._proc = pool._ctx.Process(
            target=worker_mod.worker_main,
            args=(
                child_sock, pool.manifest, rid,
                pool.runtime_config, self.config,
                pool.heartbeat_interval_s, pool.device,
            ),
            name=f"photon-serving-worker-{rid}",
            daemon=True,
        )
        self._proc.start()
        child_sock.close()
        self._conn = FrameConn(parent_sock)
        self._reader = threading.Thread(
            target=self._read_loop,
            name=f"procpool-reader-{rid}",
            daemon=True,
        )
        self._reader.start()
        if not self._ready_evt.wait(start_timeout_s):
            self.stop(timeout=1.0)
            raise RuntimeError(
                f"UNAVAILABLE: worker {rid} did not become ready within "
                f"{start_timeout_s}s"
            )
        if self._fatal is not None or not self.runtime.ready:
            # A fatal frame, or EOF before the ready frame (the worker
            # died during spawn/import) — either way it never came up.
            error = self._fatal or "worker exited before becoming ready"
            self.stop(timeout=1.0)
            raise RuntimeError(f"worker {rid} failed to start: {error}")
        pool._register(self)
        # Replay committed tenant routes: a worker respawned after a
        # tenant swap must serve the same tenant → version map as its
        # peers, or a restart would silently undo a tenant's isolation.
        # A replay failure fails the spawn — the supervisor's restart
        # path reschedules with backoff rather than admitting a worker
        # with a stale route table.
        try:
            for tenant, generation in pool.tenant_generations().items():
                self.swap_prepare(
                    generation.manifest, generation.runtime_config
                )
                self.swap_commit(generation.version, tenant=tenant)
        except Exception as exc:
            self.stop(timeout=1.0)
            raise RuntimeError(
                f"worker {rid} failed to replay tenant routes: {exc}"
            ) from exc

    # -- reader thread -----------------------------------------------------
    def _read_loop(self) -> None:
        while True:
            try:
                message = self._conn.recv()
            except Exception:  # noqa: BLE001 — desync == worker gone
                message = None
            if message is None:
                break
            kind = message.get("kind")
            if kind == "result":
                self._resolve(message)
            elif kind == "heartbeat":
                self._on_heartbeat(message)
            elif kind == "ready":
                self.runtime.ready = True
                self.runtime.pid = message.get("pid")
                self.runtime.model_version = message.get(
                    "model_version", self.runtime.model_version
                )
                self._ready_evt.set()
            elif kind == "fatal":
                self._fatal = message.get("error")
                self._ready_evt.set()
            elif kind == "bye":
                self._bye.set()
            elif kind in ("swap_ready", "swap_failed", "swap_done"):
                self._control.put(message)
        # EOF: the worker is gone.  Every in-flight row fails with the
        # transient vocabulary — the supervisor's _on_done resubmits
        # each to a peer, which is the zero-failed-requests contract.
        self._fail_inflight(
            f"UNAVAILABLE: worker process {self.rid} died mid-request; "
            "resubmitting to a peer"
        )
        self.runtime.ready = False
        self._control.put({"kind": "eof"})
        self._ready_evt.set()

    def _resolve(self, message: dict) -> None:
        with self._lock:
            future = self._inflight.pop(message.get("id"), None)
        if future is None or not future.set_running_or_notify_cancel():
            return
        if message.get("ok"):
            future.set_result(message.get("value"))
            return
        error = message.get("error") or "worker error"
        error_kind = message.get("error_kind")
        if error_kind == "rejected":
            future.set_exception(RejectedError(error))
        elif error_kind == "deadline":
            future.set_exception(DeadlineExceededError(error))
        else:
            future.set_exception(RuntimeError(error))

    def _on_heartbeat(self, message: dict) -> None:
        self._hb = message
        self.runtime.model_version = message.get(
            "model_version", self.runtime.model_version
        )
        self.runtime.degraded = bool(message.get("degraded", False))
        self.runtime.ready = bool(message.get("ready", True))
        self.pool._absorb(self.rid, message)

    def _fail_inflight(self, reason: str) -> None:
        with self._lock:
            pending = list(self._inflight.values())
            self._inflight.clear()
        for future in pending:
            if future.set_running_or_notify_cancel():
                future.set_exception(RuntimeError(reason))

    # -- MicroBatcher surface ----------------------------------------------
    def submit(
        self,
        row,
        timeout_ms: Optional[float] = None,
        bypass_admission: bool = False,
    ) -> Future:
        # The scripted-crash seam: unlike the in-process serving.replica
        # seam, a fault here SIGKILLs the routed worker for real before
        # raising, so the whole death-mid-batch path (pipe EOF →
        # transient in-flight failure → resubmission → respawn) runs.
        try:
            chaos_mod.maybe_fail("serving.worker", worker=self.rid)
        except Exception:
            self.kill("chaos: serving.worker fault")
            raise
        with self._lock:
            if self._stopped or not self._proc.is_alive():
                raise RuntimeError(
                    f"UNAVAILABLE: worker process {self.rid} is not "
                    "running; retry with backoff"
                )
            if (
                len(self._inflight) >= self._max_inflight
                and not bypass_admission
            ):
                raise RejectedError(
                    f"UNAVAILABLE: worker {self.rid} in-flight window "
                    f"full ({self._max_inflight} pending); retry with "
                    "backoff"
                )
            request_id = self._next_id
            self._next_id += 1
            future: Future = Future()
            self._inflight[request_id] = future
        # Cross-process trace propagation: the submitting span's global
        # context rides the score frame (wire.py meta:trace column) so
        # the worker's serving.batch span parents to it and the request
        # stitches into ONE trace across the process boundary.
        pctx = telemetry_mod.current().propagation_context()
        message = {
            "kind": "score",
            "id": request_id,
            "row": row,
            # The tenant id rides the frame explicitly (not only
            # inside the pickled row) so the worker can stamp rows
            # built by older parsers and the wire stays greppable.
            "tenant": getattr(row, "tenant", None),
            "timeout_ms": timeout_ms,
            "bypass": bypass_admission,
        }
        if pctx is not None:
            message["trace"] = pctx.header_value()
        if getattr(row, "want_stages", False):
            # Stage-annotation opt-in must survive the wire fast path
            # (which re-builds the row from columns); the flag rides the
            # frame and the worker re-stamps the row.
            message["stages"] = True
        try:
            self._conn.send(message)
        except Exception as exc:  # noqa: BLE001 — connection is gone
            with self._lock:
                self._inflight.pop(request_id, None)
            raise RuntimeError(
                f"UNAVAILABLE: lost connection to worker {self.rid}: "
                f"{exc}"
            ) from exc
        return future

    @property
    def queue_depth(self) -> int:
        with self._lock:
            return len(self._inflight)

    def stats(self) -> dict:
        """Request-response stats from the live worker, falling back to
        the last heartbeat when it is slow or gone."""
        try:
            with self._lock:
                request_id = self._next_id
                self._next_id += 1
                future = Future()
                self._inflight[request_id] = future
            self._conn.send({"kind": "stats", "id": request_id})
            stats = future.result(timeout=2.0)
        except Exception:  # noqa: BLE001 — fall back to heartbeat view
            stats = {
                "source": "heartbeat",
                "queue_depth": self._hb.get("queue_depth", 0),
                "model_version": self.runtime.model_version,
            }
        stats["replica"] = self.rid
        stats["inflight"] = self.queue_depth
        stats["alive"] = self._proc.is_alive()
        return stats

    def set_tenant_quota(
        self,
        tenant: str,
        rate_rps,
        burst=None,
        timeout: float = 5.0,
    ) -> None:
        """Apply a fleet quota lease to the worker's batcher (the
        ``set_quota`` frame; admission runs worker-side in process
        mode).  Raises on an unknown tenant or a dead worker — the
        lease client treats either as one host's failed apply."""
        with self._lock:
            request_id = self._next_id
            self._next_id += 1
            future = Future()
            self._inflight[request_id] = future
        try:
            self._conn.send({
                "kind": "set_quota", "id": request_id,
                "tenant": tenant, "rate_rps": rate_rps, "burst": burst,
            })
        except Exception as exc:  # noqa: BLE001 — worker is gone
            with self._lock:
                self._inflight.pop(request_id, None)
            raise RuntimeError(
                f"UNAVAILABLE: lost connection to worker {self.rid}: "
                f"{exc}"
            ) from exc
        future.result(timeout=timeout)

    def pause(self) -> None:
        """Freeze the worker (SIGSTOP), as a wedged process freezes: it
        keeps every row it was sent and answers nothing until it is
        killed.  A fault script pauses a worker before it loads it, so
        that the kill that follows finds those rows in flight."""
        if self._proc.is_alive():
            os.kill(self._proc.pid, signal.SIGSTOP)

    def kill(self, reason: str = "scripted kill") -> None:
        """SIGKILL the worker — no drain, no goodbye: the real crash.
        The reader thread's EOF handling fails in-flight rows
        transiently, and the supervisor's mark-down → backoff → respawn
        path takes it from there."""
        telemetry_mod.current().event(
            "serving.worker_killed", worker=self.rid, reason=reason
        )
        if self._proc.is_alive():
            self._proc.kill()

    def stop(self, timeout: float = 5.0) -> None:
        """Graceful drain: ask the worker to stop, then escalate.
        Idempotent — the supervision thread calls this every tick while
        the replica is down."""
        with self._lock:
            first = not self._stopped
            self._stopped = True
        if first:
            try:
                self._conn.send({"kind": "shutdown"})
            except Exception:  # noqa: BLE001 — already gone
                pass
        try:
            self._bye.wait(timeout)
            self._proc.join(timeout=timeout)
        finally:
            if self._proc.is_alive():
                self._proc.terminate()
                self._proc.join(timeout=2.0)
            if self._proc.is_alive():
                self._proc.kill()
                self._proc.join(timeout=2.0)
            self._conn.close()
            self._reader.join(timeout=2.0)
            self._fail_inflight(
                "UNAVAILABLE: batcher stopped before dispatch; retry "
                "with backoff"
            )
            self.pool._unregister(self)

    # -- swap protocol (serving/swap.py remote branch) ---------------------
    def _await_control(
        self, kinds: tuple, timeout: float, what: str
    ) -> dict:
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(
                    f"{what} on worker {self.rid} timed out after "
                    f"{timeout}s"
                )
            try:
                message = self._control.get(timeout=remaining)
            except queue.Empty:
                continue
            if message.get("kind") == "eof":
                # Leave a marker for any later waiter before raising.
                self._control.put(message)
                raise RuntimeError(
                    f"UNAVAILABLE: worker {self.rid} died during {what}"
                )
            if message.get("kind") in kinds:
                return message

    def swap_prepare(
        self, manifest: dict, runtime_config=None,
        carry_hot: bool = False, timeout: float = 120.0,
    ) -> None:
        """Stage a published generation in the worker: attach + build +
        warm + probe off the request path; raises on any failure.
        ``carry_hot`` (the delta-apply path) asks the worker to clone
        its serving runtime's warmed buckets and hot sets around the
        attached model instead of rebuilding cold."""
        self._conn.send({
            "kind": "swap_prepare",
            "manifest": manifest,
            "runtime_config": runtime_config,
            "carry_hot": carry_hot,
        })
        message = self._await_control(
            ("swap_ready", "swap_failed"), timeout,
            f"swap_prepare(v{manifest.get('version')})",
        )
        if message["kind"] == "swap_failed":
            raise RuntimeError(
                f"worker {self.rid} failed to prepare "
                f"v{manifest.get('version')}: {message.get('error')}"
            )

    def swap_commit(
        self, version: int, timeout: float = 30.0,
        tenant: Optional[str] = None,
    ) -> None:
        """Commit a prepared version — as the default serving runtime,
        or (with ``tenant``) as that one tenant's route, leaving the
        worker's default runtime untouched."""
        frame = {"kind": "swap_commit", "version": version}
        if tenant is not None:
            frame["tenant"] = tenant
        self._conn.send(frame)
        self._await_control(
            ("swap_done",), timeout, f"swap_commit(v{version})"
        )

    def swap_rollback(
        self, timeout: float = 30.0, tenant: Optional[str] = None
    ) -> bool:
        """Restore the worker's retained previous runtime (or, with
        ``tenant``, that tenant's retained previous route).  Returns
        False when the worker had nothing retained (it was restarted
        after the commit and attached the new generation directly) —
        the caller converges it by killing it onto the restored
        generation."""
        frame: dict = {"kind": "swap_rollback"}
        if tenant is not None:
            frame["tenant"] = tenant
        self._conn.send(frame)
        message = self._await_control(
            ("swap_done",), timeout, "swap_rollback"
        )
        return bool(message.get("rolled_back", True))

    def swap_abort(self, version: int) -> None:
        try:
            self._conn.send({"kind": "swap_abort", "version": version})
        except Exception:  # noqa: BLE001 — worker gone; nothing staged
            pass


class WorkerPool:
    """Shared model state + spawn context for process replicas.

    Construct it with the loaded model, hand it to
    :class:`~photon_ml_tpu_torch.serving.supervisor.ReplicaSupervisor` via
    ``pool=``, and the supervisor builds/restarts
    :class:`ProcessReplica` instances through :meth:`new_replica`
    instead of in-process batchers.  ``close()`` (called by the
    supervisor's stop) unlinks every published generation.
    """

    def __init__(
        self,
        model,
        index_maps: Optional[dict] = None,
        runtime_config: Optional[RuntimeConfig] = None,
        model_path: Optional[str] = None,
        version: int = 1,
        heartbeat_interval_s: float = 0.25,
        start_timeout_s: float = 120.0,
    ):
        # Spawn, never fork: the parent may hold a CUDA context and live
        # threads; a forked child could not use the card.
        self._ctx = multiprocessing.get_context("spawn")
        self.runtime_config = runtime_config or RuntimeConfig()
        #: the device every worker scores on, passed in its spawn
        #: arguments (None in the config is the card).
        self.device = self.runtime_config.device or "cuda"
        if self.device == "cuda" and torch.cuda.is_available():
            # Build once here: the workers find the library on disk.
            _kernels.build_libraries("serve_margins")
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.start_timeout_s = float(start_timeout_s)
        self._lock = sanitizers.tracked(
            threading.Lock(), "serving.procpool"
        )
        self._generations: List[_Generation] = [
            self.publish(model, index_maps, version=version,
                         path=model_path)
        ]
        # Tenant route registry: tenant → its committed generation, plus
        # one retained previous generation per tenant (the rollback
        # window).  Tenant generations live ONLY here — never in
        # ``_generations`` — so a tenant swap can never evict the
        # default route's rollback window and vice versa.
        self._tenant_generations: Dict[str, _Generation] = {}
        self._tenant_previous: Dict[str, Optional[_Generation]] = {}
        self._replicas: Dict[int, ProcessReplica] = {}
        #: rid → (pid, the last metrics snapshot absorbed from it)
        self._hb_prev: Dict[int, tuple] = {}
        #: kernel launches folded from the workers: rid → {kernel: n},
        #: summed over every process that rid has been (respawns too).
        self.worker_launches: Dict[int, Dict[str, int]] = {}
        #: the batches those processes scored, from the same heartbeats
        #: (a launch that is no batch is a warm-up bucket): rid → n.
        self.worker_batches: Dict[int, int] = {}
        #: rid → how many of its processes have sent a heartbeat.
        self.worker_processes: Dict[int, int] = {}
        self._launch_prev: Dict[int, tuple] = {}
        self._view = _PoolRuntimeView(self)
        self._closed = False

    # -- current generation ------------------------------------------------
    @property
    def _current(self) -> _Generation:
        with self._lock:
            return self._generations[-1]

    @property
    def manifest(self) -> dict:
        return self._current.manifest

    @property
    def parser(self) -> RequestParser:
        return self._current.parser

    @property
    def version(self) -> int:
        return self._current.version

    @property
    def model_path(self) -> Optional[str]:
        return self._current.path

    # -- generation lifecycle (the swap machinery drives these) ------------
    def publish(
        self,
        model,
        index_maps: Optional[dict] = None,
        version: int = 1,
        path: Optional[str] = None,
    ) -> _Generation:
        """Pack a model into shared memory; the generation is STAGED
        (not current) until :meth:`commit_generation`."""
        manifest = shm_model.publish_model(model, version=version, path=path)
        parser = RequestParser.for_model(model, index_maps)
        return _Generation(
            manifest=manifest, parser=parser, version=version, path=path,
            model=model, index_maps=index_maps,
        )

    def current_model(self) -> tuple:
        """The host-side ``(model, index_maps)`` of the CURRENT
        generation — the base the delta-apply path patches."""
        current = self._current
        return current.model, current.index_maps

    def commit_generation(self, generation: _Generation) -> None:
        """Make a staged generation current.  Keeps the last TWO
        generations linked — the rollback window, and what a worker
        respawned mid-swap attaches — and unlinks anything older."""
        retired = []
        with self._lock:
            self._generations.append(generation)
            while len(self._generations) > 2:
                retired.append(self._generations.pop(0))
        for old in retired:
            shm_model.unpublish_model(old.manifest)

    def retire_generation(self, generation: _Generation) -> None:
        """Unlink a STAGED generation after a failed swap."""
        shm_model.unpublish_model(generation.manifest)

    def rollback_generation(self) -> _Generation:
        """Drop the current generation and restore the previous one
        (the swapper's one-step rollback)."""
        with self._lock:
            if len(self._generations) < 2:
                raise RuntimeError(
                    "no previous model generation to roll back to"
                )
            dropped = self._generations.pop()
        shm_model.unpublish_model(dropped.manifest)
        return self._current

    # -- tenant generations (serving/swap.py tenant-scoped swaps) ----------
    def _referenced_locked(self, generation: _Generation) -> bool:
        """Whether any registry slot still points at ``generation``
        (identity, not equality — generations wrap live model arrays).
        Call under ``self._lock``."""
        for g in self._generations:
            if g is generation:
                return True
        for g in self._tenant_generations.values():
            if g is generation:
                return True
        for g in self._tenant_previous.values():
            if g is generation:
                return True
        return False

    def tenant_generations(self) -> Dict[str, _Generation]:
        """Snapshot of committed tenant routes — what a respawned
        worker replays before taking traffic."""
        with self._lock:
            return dict(self._tenant_generations)

    def commit_tenant_generation(
        self, tenant: str, generation: _Generation
    ) -> None:
        """Make a staged generation the tenant's committed route.  The
        displaced route (if any) moves into the tenant's one-slot
        rollback window; whatever that evicts is unlinked unless some
        other slot still references it."""
        with self._lock:
            evicted = self._tenant_previous.get(tenant)
            self._tenant_previous[tenant] = (
                self._tenant_generations.get(tenant)
            )
            self._tenant_generations[tenant] = generation
            unlink = (
                evicted is not None
                and not self._referenced_locked(evicted)
            )
        if unlink:
            shm_model.unpublish_model(evicted.manifest)

    def rollback_tenant_generation(self, tenant: str) -> None:
        """Drop the tenant's committed generation and restore the one
        its last swap displaced (or no route at all — back to the
        default generation)."""
        with self._lock:
            dropped = self._tenant_generations.pop(tenant, None)
            previous = self._tenant_previous.pop(tenant, None)
            if previous is not None:
                self._tenant_generations[tenant] = previous
            unlink = (
                dropped is not None
                and not self._referenced_locked(dropped)
            )
        if unlink:
            shm_model.unpublish_model(dropped.manifest)

    # -- replicas ----------------------------------------------------------
    def new_replica(
        self,
        rid: int,
        batcher_config: Optional[BatcherConfig] = None,
        policy=None,  # accepted for interface parity; admission runs worker-side
    ) -> ProcessReplica:
        if self._closed:
            raise RuntimeError("worker pool is closed")
        return ProcessReplica(
            self, rid, batcher_config,
            start_timeout_s=self.start_timeout_s,
        )

    def _register(self, replica: ProcessReplica) -> None:
        with self._lock:
            if not self._closed:
                self._replicas[replica.rid] = replica
                return
        # The pool closed while this replica was spawning (a supervisor
        # restart racing stop()): close() snapshotted the replica map
        # before this one joined it, so reap it here — otherwise the
        # worker process outlives the pool and trips the strict
        # process-leak sentinels.  Failing the spawn sends the restart
        # path to its reschedule branch, which the stopping supervisor
        # never services again.
        replica.stop(timeout=1.0)
        raise RuntimeError("worker pool is closed")

    def _unregister(self, replica: ProcessReplica) -> None:
        with self._lock:
            if self._replicas.get(replica.rid) is replica:
                del self._replicas[replica.rid]
                self._hb_prev.pop(replica.rid, None)

    def runtime_view(self) -> _PoolRuntimeView:
        return self._view

    # -- telemetry merge ---------------------------------------------------
    def _absorb(self, rid: int, heartbeat: dict) -> None:
        """Fold one worker's cumulative metrics snapshot into the parent
        registry as a delta vs the last snapshot absorbed from that
        worker (telemetry/core.py transport discipline), and its
        cumulative kernel launch counts into the parent's."""
        self._absorb_launches(rid, heartbeat)
        metrics = heartbeat.get("metrics")
        if not metrics:
            return
        pid = heartbeat.get("pid")
        try:
            registry = telemetry_mod.current().metrics
            with self._lock:
                prev_pid, previous = self._hb_prev.get(rid, (None, None))
                self._hb_prev[rid] = (pid, metrics)
            if prev_pid != pid:
                # A respawned worker counts from zero, even when its
                # first heartbeat beats the dead one's unregister.
                previous = None
            registry.absorb_delta(metrics, previous)
        except Exception:  # noqa: BLE001 — telemetry must not kill reads
            pass

    def _absorb_launches(self, rid: int, heartbeat: dict) -> None:
        launches = heartbeat.get("launches")
        if not launches:
            return
        pid = heartbeat.get("pid")
        batches = heartbeat.get("batches_total")
        with self._lock:
            prev_pid, prev = self._launch_prev.get(rid, (None, {}))
            if prev_pid != pid:
                prev = {}  # a respawned worker counts from zero
                self.worker_processes[rid] = (
                    self.worker_processes.get(rid, 0) + 1
                )
            now = dict(launches)
            if batches is not None:
                now[_BATCHES] = int(batches)
            self._launch_prev[rid] = (pid, now)
            mine = self.worker_launches.setdefault(rid, {})
            for key, n in now.items():
                delta = int(n) - int(prev.get(key, 0))
                if delta <= 0:
                    continue
                if key == _BATCHES:
                    self.worker_batches[rid] = (
                        self.worker_batches.get(rid, 0) + delta
                    )
                    continue
                mine[key] = mine.get(key, 0) + delta
                if key in _kernels.LAUNCHES:
                    _kernels.count_launch(key, delta)

    def launch_counts(self, reset: bool = False) -> Dict[int, dict]:
        """rid → its folded ``launches`` (by kernel), ``batches`` and
        ``processes``, read together: every heartbeat folds all three at
        once, and a worker reads its launches and batches under its
        runtime's score lock, so the two describe the same batches.
        ``reset`` zeroes ``ops/_kernels.py::LAUNCHES`` in the same
        critical section, so the parent's count from then on holds
        exactly the launches folded after this reading."""
        with self._lock:
            if reset:
                _kernels.reset_launches()
            return {
                rid: {
                    "launches": dict(self.worker_launches.get(rid, {})),
                    "batches": self.worker_batches.get(rid, 0),
                    "processes": self.worker_processes.get(rid, 0),
                }
                for rid in sorted(
                    set(self.worker_launches) | set(self.worker_processes)
                )
            }

    # -- observability / shutdown ------------------------------------------
    def stats(self) -> dict:
        with self._lock:
            replicas = sorted(self._replicas)
            tenant_versions = {
                tenant: generation.version
                for tenant, generation in self._tenant_generations.items()
            }
            worker_launches = {
                rid: dict(n) for rid, n in self.worker_launches.items()
            }
        return {
            "source": "pool",
            "workers": replicas,
            "model_version": self.version,
            "model_path": self.model_path,
            "generations": len(self._generations),
            "tenant_versions": tenant_versions,
            "live_segments": shm_model.live_segments(),
            "device": self.device,
            "worker_launches": worker_launches,
        }

    def close(self, timeout: float = 5.0) -> None:
        """Stop every worker, then unlink every generation.  Idempotent;
        after this the strict sentinels must see zero leaked processes
        and zero live segments."""
        with self._lock:
            if self._closed:
                return
            # Under the same lock as _register: every replica either
            # made this snapshot (stopped below) or will observe
            # _closed at registration and reap itself.
            self._closed = True
            replicas = list(self._replicas.values())
        for replica in replicas:
            replica.stop(timeout=timeout)
        with self._lock:
            generations = list(self._generations)
            for g in self._tenant_generations.values():
                generations.append(g)
            for g in self._tenant_previous.values():
                if g is not None:
                    generations.append(g)
            self._generations = self._generations[-1:]
            self._tenant_generations = {}
            self._tenant_previous = {}
        seen: set = set()
        for generation in generations:
            if id(generation) in seen:
                continue
            seen.add(id(generation))
            shm_model.unpublish_model(generation.manifest)
