"""Worker process main for process-level serving replicas (port of
``photon_ml_tpu/serving/worker.py``).

One worker = one OS process with its own fault domain: it attaches the
pool's shared-memory model (zero-copy, checksum-verified —
serving/shm_model.py), runs a private :class:`ScoringRuntime` +
:class:`MicroBatcher`, and speaks the length-prefixed frame protocol
(serving/protocol.py) over the socketpair its parent spawned it with.
A native crash, an OOM kill, or a SIGKILL here costs exactly one
worker; the parent's :class:`~photon_ml_tpu_torch.serving.procpool.
ProcessReplica` fails the in-flight rows with the watchdog's transient
vocabulary and the supervisor resubmits them to a peer.

Frames the worker understands (parent → worker)::

    score         {id, row, tenant?, timeout_ms, bypass}
                                                 → result {id, ok, ...}
    stats         {id}                           → result {id, ok, value}
    swap_prepare  {manifest, runtime_config?, carry_hot?}
                                                 → swap_ready | swap_failed
    swap_commit   {version, tenant?}             → swap_done
    swap_rollback {tenant?}                      → swap_done
    swap_abort    {version}                      (no reply)
    shutdown      {}                             → bye (after drain)

A ``tenant`` on swap_commit routes ONE tenant onto the prepared
runtime (``batcher.set_tenant_route``) without touching the worker's
default serving runtime; each tenant retains exactly one displaced
route for one-step rollback, mirroring the default-route discipline.

and emits unprompted ``heartbeat`` frames every
``heartbeat_interval_s``: liveness + queue depth + model version + a
mergeable :meth:`~photon_ml_tpu_torch.telemetry.core.MetricsRegistry.
transport_snapshot` of the worker's private metrics registry, which the
parent folds into its own registry so /metrics and the admission tiers
keep a pool-wide view.

Swap discipline (the cross-process half of serving/swap.py): prepare
attaches + warms the staged model on a helper thread (the recv loop
keeps answering scores and probes — a seconds-long warmup must not read
as replica death), commit is the same GIL-atomic ``batcher.runtime``
assignment as in-process serving and retains the previous runtime for
exactly one-step rollback.

The device is explicit: the pool passes it in the spawn arguments
(``device``: ``"cuda"`` or ``"cpu"``) and the worker builds every
runtime on it — a worker told ``cuda`` on a machine without a card
raises at startup (a ``fatal`` frame, so the pool's spawn fails with
that error) and never carries on on the CPU.  Each worker owns its own
CUDA context (spawned, never forked) and builds nothing: the parent
built the serving library before spawning, and the build is keyed on
disk.  Heartbeats carry the worker's cumulative kernel launch counts
(``ops/_kernels.py::LAUNCHES``), which the pool folds into the parent's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import threading
from functools import partial
from typing import Optional, Tuple

import numpy as np

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.serving import shm_model
from photon_ml_tpu_torch.serving.batcher import (
    BatcherConfig,
    DeadlineExceededError,
    MicroBatcher,
    RejectedError,
)
from photon_ml_tpu_torch.serving.protocol import FrameConn
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime

__all__ = ["worker_main"]


def _on_device(config: Optional[RuntimeConfig], device: str
               ) -> RuntimeConfig:
    """``config`` (None = the defaults) placed on the worker's device."""
    return dataclasses.replace(config or RuntimeConfig(), device=device)


def _error_kind(exc: BaseException) -> str:
    """Collapse a scoring failure to the protocol's error taxonomy so
    the parent can reconstruct the SAME exception type — the supervisor
    type-checks RejectedError/DeadlineExceededError when deciding
    resubmit-vs-fail."""
    if isinstance(exc, RejectedError):
        return "rejected"
    if isinstance(exc, DeadlineExceededError):
        return "deadline"
    return "other"


class _WorkerMain:
    def __init__(
        self,
        conn: FrameConn,
        manifest: dict,
        worker_id: int,
        runtime_config: Optional[RuntimeConfig],
        batcher_config: Optional[BatcherConfig],
        heartbeat_interval_s: float,
        device: str,
    ):
        self._conn = conn
        self._worker_id = int(worker_id)
        self._device = device
        self._runtime_config = _on_device(runtime_config, device)
        self._batcher_config = batcher_config or BatcherConfig()
        self._heartbeat_interval_s = float(heartbeat_interval_s)
        self._stop = threading.Event()
        self._hb_thread: Optional[threading.Thread] = None
        self._prepare_thread: Optional[threading.Thread] = None
        # Swap state: version -> (runtime, attachment) staged by prepare;
        # exactly one (runtime, attachment, version) retained for
        # one-step rollback after a commit.
        self._prepared: dict = {}
        self._previous: Optional[Tuple] = None
        # Tenant routes: tenant -> (runtime, attachment, version) the
        # batcher dispatches that tenant against, plus the one displaced
        # tuple (or None = "was on the default route") each tenant
        # retains for one-step rollback.
        self._tenant_routes: dict = {}
        self._tenant_prev: dict = {}
        model, attachment = shm_model.attach_model(manifest)
        self._runtime = ScoringRuntime(model, {}, self._runtime_config)
        self._runtime.model_version = int(manifest["version"])
        self._runtime.model_path = manifest.get("path")
        self._attachment = attachment
        self._batcher = MicroBatcher(
            self._runtime, self._batcher_config
        ).start()

    # -- plumbing ----------------------------------------------------------
    def _send(self, message: dict) -> None:
        try:
            self._conn.send(message)
        except Exception:  # noqa: BLE001 — parent gone; wind down
            self._stop.set()

    def _send_result(self, request_id, future) -> None:
        exc = future.exception()
        if exc is None:
            self._send({
                "kind": "result", "id": request_id,
                "ok": True, "value": future.result(),
            })
        else:
            self._send({
                "kind": "result", "id": request_id, "ok": False,
                "error": str(exc), "error_kind": _error_kind(exc),
            })

    # -- heartbeats --------------------------------------------------------
    def _heartbeat_once(self) -> None:
        runtime = self._batcher.runtime
        tel = telemetry_mod.current()
        # The launch counts and the process's batch count of the same
        # finished batches: a batch holds the serving runtime's score
        # lock from its launch to its count.
        with getattr(runtime, "score_lock", contextlib.nullcontext()):
            launches = dict(_kernels.LAUNCHES)
            batches_total = getattr(tel.metrics.counter(
                "serving_batches_total"), "value", 0)
        self._send({
            "kind": "heartbeat",
            "worker": self._worker_id,
            "pid": os.getpid(),
            # Host identity block (telemetry/exporter.py): which machine
            # and process this heartbeat speaks for — the parent and the
            # fleet aggregator label merged metrics with it.
            "host": telemetry_mod.host_identity(),
            "queue_depth": self._batcher.queue_depth,
            "model_version": getattr(runtime, "model_version", 1),
            "degraded": getattr(runtime, "degraded", False),
            "ready": getattr(runtime, "ready", False),
            "metrics": tel.metrics.transport_snapshot(),
            "launches": launches,
            # The serving runtime's batch count, and every runtime's of
            # this process: a launch that is no batch is a warm-up bucket.
            "batches": getattr(runtime, "batches", 0),
            "batches_total": int(batches_total),
        })

    def _heartbeat_loop(self) -> None:
        while not self._stop.wait(self._heartbeat_interval_s):
            self._heartbeat_once()

    # -- swap protocol -----------------------------------------------------
    def _do_prepare(
        self, manifest: dict, runtime_config, carry_hot: bool = False
    ) -> None:
        version = int(manifest.get("version", 0))
        try:
            model, attachment = shm_model.attach_model(manifest)
            if carry_hot:
                # Delta apply: clone the SERVING runtime's warmed
                # kernels and hot sets around the attached model
                # (ScoringRuntime.patched) — the staged runtime costs
                # row rebuilds, not a cold warm-up pass.
                runtime = ScoringRuntime.patched(
                    self._batcher.runtime, model, {},
                    self._staged_config(runtime_config),
                )
            else:
                runtime = ScoringRuntime(
                    model, {}, self._staged_config(runtime_config)
                )
            runtime.model_version = version
            runtime.model_path = manifest.get("path")
            margins, _ = runtime.score_rows([runtime.probe_row()])
            if not np.isfinite(margins[0]):
                raise ValueError(
                    f"staged v{version} probe scored non-finite "
                    f"{margins[0]!r}"
                )
        except Exception as exc:  # noqa: BLE001 — verdict crosses the pipe
            self._send({
                "kind": "swap_failed", "version": version,
                "error": f"{type(exc).__name__}: {exc}",
            })
            return
        old = self._prepared.pop(version, None)
        if old is not None:
            old[1].close()
        self._prepared[version] = (runtime, attachment)
        self._send({"kind": "swap_ready", "version": version})

    def _staged_config(self, runtime_config) -> RuntimeConfig:
        """A swap's runtime config, kept on this worker's device."""
        if runtime_config is None:
            return self._runtime_config
        return _on_device(runtime_config, self._device)

    def _handle_swap_prepare(self, msg: dict) -> None:
        if self._prepare_thread is not None:
            self._prepare_thread.join()
        self._prepare_thread = threading.Thread(
            target=self._do_prepare,
            args=(
                msg["manifest"], msg.get("runtime_config"),
                bool(msg.get("carry_hot")),
            ),
            name=f"worker-{self._worker_id}-swap-prepare",
            daemon=True,
        )
        self._prepare_thread.start()

    def _handle_swap_commit(self, msg: dict) -> None:
        version = int(msg["version"])
        tenant = msg.get("tenant")
        runtime, attachment = self._prepared.pop(version)
        if tenant is not None:
            # Tenant-scoped commit: route ONE tenant onto the prepared
            # runtime; the default serving runtime never moves.  The
            # displaced route fills the tenant's one-slot rollback
            # window; whatever that evicts is done serving and closes.
            evicted = self._tenant_prev.pop(tenant, None)
            self._tenant_prev[tenant] = self._tenant_routes.get(tenant)
            self._tenant_routes[tenant] = (runtime, attachment, version)
            self._batcher.set_tenant_route(tenant, runtime)
            if evicted is not None:
                evicted[1].close()
            self._send({"kind": "swap_done", "version": version})
            return
        if self._previous is not None:
            self._previous[1].close()
        self._previous = (
            self._batcher.runtime, self._attachment,
            getattr(self._batcher.runtime, "model_version", 1),
        )
        # Same commit point as in-process swaps: one GIL-atomic
        # attribute write; the next dispatch scores on the new model.
        self._batcher.runtime = runtime
        self._attachment = attachment
        self._send({"kind": "swap_done", "version": version})

    def _handle_swap_rollback(self, msg: dict) -> None:
        tenant = msg.get("tenant")
        if tenant is not None:
            self._rollback_tenant_route(tenant)
            return
        if self._previous is None:
            self._send({
                "kind": "swap_done",
                "version": getattr(self._batcher.runtime, "model_version", 1),
                "rolled_back": False,
            })
            return
        runtime, attachment, version = self._previous
        self._previous = None
        retired_attachment = self._attachment
        self._batcher.runtime = runtime
        self._attachment = attachment
        retired_attachment.close()
        self._send({
            "kind": "swap_done", "version": version, "rolled_back": True,
        })

    def _rollback_tenant_route(self, tenant: str) -> None:
        """Restore the route the tenant's last swap displaced — or clear
        it (back to the default route) when that swap was the tenant's
        first.  No retained window (this worker respawned after the
        commit and replayed the route directly) answers
        ``rolled_back: False`` so the parent converge-kills us onto the
        restored registry."""
        if tenant not in self._tenant_prev:
            self._send({
                "kind": "swap_done",
                "version": getattr(self._batcher.runtime, "model_version", 1),
                "rolled_back": False,
            })
            return
        previous = self._tenant_prev.pop(tenant)
        dropped = self._tenant_routes.pop(tenant, None)
        if previous is None:
            self._batcher.clear_tenant_route(tenant)
            version = getattr(self._batcher.runtime, "model_version", 1)
        else:
            self._tenant_routes[tenant] = previous
            self._batcher.set_tenant_route(tenant, previous[0])
            version = previous[2]
        if dropped is not None:
            dropped[1].close()
        self._send({
            "kind": "swap_done", "version": version, "rolled_back": True,
        })

    def _handle_swap_abort(self, msg: dict) -> None:
        staged = self._prepared.pop(int(msg["version"]), None)
        if staged is not None:
            staged[1].close()

    # -- main loop ---------------------------------------------------------
    def run(self) -> None:
        self._hb_thread = threading.Thread(
            target=self._heartbeat_loop,
            name=f"worker-{self._worker_id}-heartbeat",
            daemon=True,
        )
        self._hb_thread.start()
        self._send({
            "kind": "ready",
            "worker": self._worker_id,
            "pid": os.getpid(),
            "model_version": self._runtime.model_version,
        })
        clean = False
        try:
            while not self._stop.is_set():
                message = self._conn.recv()
                if message is None:
                    break  # parent closed; wind down without a bye
                kind = message.get("kind")
                if kind == "score":
                    self._handle_score(message)
                elif kind == "stats":
                    self._send({
                        "kind": "result", "id": message.get("id"),
                        "ok": True, "value": self._stats(),
                    })
                elif kind == "set_quota":
                    # Fleet quota lease landing on this worker's batcher
                    # (serving/fleet.py): process-mode admission runs
                    # HERE, so the lease must cross the wire to bite.
                    try:
                        self._batcher.set_tenant_quota(
                            message["tenant"],
                            message.get("rate_rps"),
                            message.get("burst"),
                        )
                        self._send({
                            "kind": "result", "id": message.get("id"),
                            "ok": True, "value": True,
                        })
                    except Exception as exc:  # noqa: BLE001 — report
                        self._send({
                            "kind": "result", "id": message.get("id"),
                            "ok": False, "error": str(exc),
                            "error_kind": "bad_request",
                        })
                elif kind == "swap_prepare":
                    self._handle_swap_prepare(message)
                elif kind == "swap_commit":
                    self._handle_swap_commit(message)
                elif kind == "swap_rollback":
                    self._handle_swap_rollback(message)
                elif kind == "swap_abort":
                    self._handle_swap_abort(message)
                elif kind == "shutdown":
                    clean = True
                    break
        except Exception:  # noqa: BLE001 — desynced stream = wind down
            pass
        finally:
            self._stop.set()
            if self._prepare_thread is not None:
                self._prepare_thread.join(timeout=5.0)
            if self._hb_thread is not None:
                self._hb_thread.join(timeout=5.0)
            # Graceful drain: everything already admitted dispatches;
            # raced rows fail with the transient stopped-batcher verdict
            # the parent resubmits.
            self._batcher.stop()
            if clean:
                # A last heartbeat: the launches and metrics since the
                # previous one reach the parent before the goodbye.
                self._heartbeat_once()
                try:
                    self._conn.send({"kind": "bye"})
                except Exception:  # noqa: BLE001 — parent may be gone
                    pass
            self._conn.close()
            for staged in self._prepared.values():
                staged[1].close()
            if self._previous is not None:
                self._previous[1].close()
            for route in self._tenant_routes.values():
                route[1].close()
            for prev in self._tenant_prev.values():
                if prev is not None:
                    prev[1].close()
            self._attachment.close()

    def _handle_score(self, message: dict) -> None:
        request_id = message.get("id")
        row = message["row"]
        # The frame's tenant id wins over a missing row field so rows
        # pickled by an older parser still land in the right partition.
        tenant = message.get("tenant")
        if tenant is not None and getattr(row, "tenant", None) is None:
            row.tenant = tenant
        if message.get("stages"):
            row.want_stages = True
        # Cross-process trace adoption: the parent's propagated context
        # rides the score frame; adopting it around submit makes the
        # submitting thread's context — and through _Pending.ctx the
        # dispatch thread's serving.batch span — parent to the PARENT
        # process's span, so the request stitches into one trace.
        trace = message.get("trace")
        ctx = (
            telemetry_mod.TraceContext.parse(trace)
            if isinstance(trace, str) else None
        )
        try:
            with telemetry_mod.current().adopt(ctx):
                future = self._batcher.submit(
                    row,
                    timeout_ms=message.get("timeout_ms"),
                    bypass_admission=bool(message.get("bypass")),
                )
        except Exception as exc:  # noqa: BLE001 — sync admission verdict
            self._send({
                "kind": "result", "id": request_id, "ok": False,
                "error": str(exc), "error_kind": _error_kind(exc),
            })
            return
        future.add_done_callback(partial(self._send_result, request_id))

    def _stats(self) -> dict:
        stats = self._batcher.stats()
        stats["worker"] = self._worker_id
        stats["pid"] = os.getpid()
        stats["device"] = self._device
        stats["launches"] = dict(_kernels.LAUNCHES)
        # The port imports no JAX, in the parent or here.
        stats["jax_imported"] = "jax" in sys.modules
        stats["tenant_versions"] = {
            tenant: route[2]
            for tenant, route in self._tenant_routes.items()
        }
        runtime = self._batcher.runtime
        if isinstance(runtime, ScoringRuntime):
            stats["runtime"] = runtime.stats()
        return stats


def worker_main(
    sock,
    manifest: dict,
    worker_id: int,
    runtime_config=None,
    batcher_config=None,
    heartbeat_interval_s: float = 0.25,
    device: str = "cuda",
) -> None:
    """Spawn target (module-level so the spawn pickler can import it).

    Installs a private enabled telemetry hub (sink-less by default:
    metrics only — the parent's heartbeat merge is this process's event
    stream), attaches the shared model, and serves frames until
    shutdown/EOF.  With ``PHOTON_TRACE_DIR`` set in the environment the
    hub grows real trace sinks — ``trace-worker-<id>-<pid>.trace.json``
    (Chrome trace array) and ``.jsonl`` (record log) under that
    directory — so the worker's spans can be merged with the parent's
    into one stitched distributed trace.  Every runtime is built on
    ``device``.  Startup failures (a ``cuda`` device without a card
    included) are reported as a ``fatal`` frame so the parent's spawn
    raises a pointed error instead of timing out.
    """
    conn = FrameConn(sock)
    sinks: list = []
    trace_dir = os.environ.get("PHOTON_TRACE_DIR")
    if trace_dir:
        try:
            os.makedirs(trace_dir, exist_ok=True)
            base = os.path.join(
                trace_dir, f"trace-worker-{worker_id}-{os.getpid()}"
            )
            sinks = [
                telemetry_mod.ChromeTraceSink(base + ".trace.json"),
                telemetry_mod.JsonlSink(base + ".jsonl"),
            ]
        except OSError:
            sinks = []  # tracing must never block serving startup
    hub = telemetry_mod.Telemetry(
        enabled=True, sinks=sinks, run_name=f"serving-worker-{worker_id}"
    )
    telemetry_mod.set_current(hub)
    try:
        main = _WorkerMain(
            conn, manifest, worker_id,
            runtime_config, batcher_config, heartbeat_interval_s, device,
        )
    except BaseException as exc:  # noqa: BLE001 — verdict crosses the pipe
        try:
            conn.send({
                "kind": "fatal",
                "worker": worker_id,
                "error": f"{type(exc).__name__}: {exc}",
            })
        except Exception:  # noqa: BLE001
            pass
        conn.close()
        hub.close()
        raise SystemExit(1)
    try:
        main.run()
    finally:
        # Flush the trace sinks (a sink-less close is a no-op): the
        # parent merges the written trace-worker files after stop.
        hub.close()
