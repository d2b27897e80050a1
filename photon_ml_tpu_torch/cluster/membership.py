"""Service discovery: a registration/heartbeat membership registry (port
of ``photon_ml_tpu/cluster/membership.py``; host code, copied, the same
HTTP protocol).

A ``FleetRouter`` built alone takes a STATIC host list, and a
``FleetAggregator`` scrapes a fixed dict.  Real fleets churn: hosts
boot, die, drain, and come back, and nobody restarts the front door for
any of it.  This module is the discovery plane that replaces both
static lists:

- :class:`MembershipRegistry` — the source of truth: hosts
  ``register`` at startup (id + serving URL + optional metrics URL),
  ``heartbeat`` every interval, and are EXPIRED from the member set
  after ``heartbeat_ttl_s`` without a beat (expiry-on-read: the member
  view is correct the instant it is read, no sweeper thread to race).
  ``drain``/``leave`` are first-class: a draining member stays visible
  (so the router can finish its in-flight work) but is marked, and a
  left member disappears immediately.  ``serve()`` exposes the whole
  surface over HTTP so registration crosses machines.
- :class:`RegistryClient` — one client for both transports: hand it a
  registry OBJECT (in-process: tests, selfcheck, single box) or a base
  URL string (HTTP: real fleets).  The protocol is identical — the
  discovery algebra does not change when it crosses a socket
  (QuotaCoordinator's design note, one tier down).
- :class:`HeartbeatAgent` — the host-side beat loop: registers, beats
  every ``interval_s`` through the ``cluster.heartbeat`` chaos seam,
  and RE-REGISTERS automatically when the registry answers "unknown"
  (a registry restart or an expiry during a stall must not strand a
  live host — the agent heals its own membership).
- :class:`MembershipWatcher` — closes the loop to the fleet tier: diffs the
  discovered member set against a live :class:`FleetRouter`'s hosts
  and calls ``router.join`` / ``router.drain`` to converge, and feeds
  the same membership to ``FleetAggregator.sync_membership`` so the
  ops plane follows the fleet instead of a config file.

Metric family: ``cluster_*`` (docs/telemetry.md).  Chaos seam:
``cluster.heartbeat`` (a fault is a lost beat — enough of them expires
the host, the watcher drains it from the router, and the agent's
re-register brings it back).  docs/serving.md "Cluster" has the
membership + failover diagram and the TTL math.

The registry's HTTP server (and ``distribution.py``'s) listens with a
backlog of 128, as the serving host does (``serving/service.py``); the
reference keeps the standard library's 5.
"""

from __future__ import annotations

import json
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.analysis import sanitizers
from photon_ml_tpu_torch.chaos import core as chaos_mod
from photon_ml_tpu_torch.serving.fleet import _http_json


class MembershipRegistry:
    """The authoritative member set, with expiry-on-read.

    A member is ``{host_id, url, metrics_url, state, registered_wall_epoch,
    heartbeats}``; ``state`` is ``"alive"`` or ``"draining"``.  Liveness
    bookkeeping rides the injectable monotonic ``clock`` (never wall
    time — a clock step must not expire the fleet)."""

    def __init__(
        self,
        heartbeat_ttl_s: float = 2.0,
        clock: Callable[[], float] = time.monotonic,
    ):
        if heartbeat_ttl_s <= 0:
            raise ValueError(
                f"heartbeat_ttl_s must be > 0, got {heartbeat_ttl_s}"
            )
        self.heartbeat_ttl_s = float(heartbeat_ttl_s)
        self._clock = clock
        self._lock = sanitizers.tracked(
            threading.Lock(), "cluster.membership"
        )
        #: host_id -> member record (plus internal ``last_beat_t``).
        self._members: Dict[str, dict] = {}
        self._server = None
        self._thread: Optional[threading.Thread] = None

    # -- the protocol ------------------------------------------------------
    def register(
        self,
        host_id: str,
        url: str,
        metrics_url: Optional[str] = None,
    ) -> dict:
        """Admit (or re-admit) a host.  Registering an id that is
        already a member REPLACES its record — the newest registration
        wins, which is what a restarted host needs."""
        host_id = str(host_id)
        now = self._clock()
        with self._lock:
            rejoin = host_id in self._members
            self._members[host_id] = {
                "host_id": host_id,
                "url": str(url).rstrip("/"),
                "metrics_url": (
                    str(metrics_url).rstrip("/") if metrics_url else None
                ),
                "state": "alive",
                "registered_wall_epoch": time.time(),
                "heartbeats": 0,
                "last_beat_t": now,
            }
            count = len(self._members)
        tel = telemetry_mod.current()
        tel.counter("cluster_joins_total").inc()
        tel.gauge("cluster_members_count").set(count)
        tel.event(
            "cluster.member_registered",
            host=host_id, url=url, rejoin=rejoin,
        )
        return self._public(self._members[host_id])

    def heartbeat(self, host_id: str) -> bool:
        """Refresh a member's liveness.  Returns ``False`` for an id
        that is not (or no longer) a member — the caller must
        re-register; beating cannot resurrect an expired host because
        its registration record (URL, metrics URL) is gone."""
        host_id = str(host_id)
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            member = self._members.get(host_id)
            if member is None:
                return False
            member["last_beat_t"] = now
            member["heartbeats"] += 1
        telemetry_mod.current().counter("cluster_heartbeats_total").inc()
        return True

    def drain(self, host_id: str) -> bool:
        """Mark a member draining: still visible (the router needs to
        see it to drain it gracefully), no longer a routing target once
        the watcher converges.  Returns ``False`` for an unknown id."""
        with self._lock:
            member = self._members.get(str(host_id))
            if member is None:
                return False
            member["state"] = "draining"
        tel = telemetry_mod.current()
        tel.counter("cluster_drains_total").inc()
        tel.event("cluster.member_draining", host=str(host_id))
        return True

    def leave(self, host_id: str) -> bool:
        """Remove a member immediately (the graceful-shutdown path —
        a leaving host should not wait out its own TTL)."""
        with self._lock:
            member = self._members.pop(str(host_id), None)
            count = len(self._members)
        if member is None:
            return False
        tel = telemetry_mod.current()
        tel.counter("cluster_leaves_total").inc()
        tel.gauge("cluster_members_count").set(count)
        tel.event("cluster.member_left", host=str(host_id))
        return True

    def members(self) -> Dict[str, dict]:
        """The CURRENT member set (expired hosts removed as a side
        effect of reading — the view is correct at read time)."""
        now = self._clock()
        with self._lock:
            self._expire_locked(now)
            return {
                hid: self._public(m) for hid, m in self._members.items()
            }

    def _expire_locked(self, now: float) -> None:
        # Caller holds self._lock.
        expired = [
            hid for hid, m in self._members.items()
            if now - m["last_beat_t"] > self.heartbeat_ttl_s
        ]
        if not expired:
            return
        for hid in expired:
            del self._members[hid]
        count = len(self._members)
        tel = telemetry_mod.current()
        tel.counter("cluster_expirations_total").inc(len(expired))
        tel.gauge("cluster_members_count").set(count)
        for hid in expired:
            tel.event(
                "cluster.member_expired",
                host=hid, ttl_s=self.heartbeat_ttl_s,
            )

    @staticmethod
    def _public(member: dict) -> dict:
        return {k: v for k, v in member.items() if k != "last_beat_t"}

    def stats(self) -> dict:
        with self._lock:
            states = [m["state"] for m in self._members.values()]
        return {
            "heartbeat_ttl_s": self.heartbeat_ttl_s,
            "members": len(states),
            "alive": states.count("alive"),
            "draining": states.count("draining"),
        }

    # -- HTTP --------------------------------------------------------------
    def serve(
        self, host: str = "127.0.0.1", port: int = 0
    ) -> "MembershipRegistry":
        """Expose the registry over HTTP on a daemon thread (POST
        ``/register`` ``/heartbeat`` ``/drain`` ``/leave``, GET
        ``/members`` ``/healthz``).  ``port=0`` binds an ephemeral
        port; read :attr:`base_url` back."""
        if self._server is not None:
            return self
        server = _RegistryServer((host, port), _RegistryHandler)
        server.registry = self
        self._server = server
        self._thread = threading.Thread(
            target=server.serve_forever,
            name="cluster-registry-http", daemon=True,
        )
        self._thread.start()
        return self

    @property
    def base_url(self) -> str:
        if self._server is None:
            raise RuntimeError("registry is not serving (call serve())")
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


class _RegistryServer(ThreadingHTTPServer):
    daemon_threads = True
    #: listen backlog: the serving host's (a fleet's agents and watchers
    #: connect at once; the stdlib's 5 lets some stacks reset the excess).
    request_queue_size = 128
    registry: MembershipRegistry


class _RegistryHandler(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"

    def log_message(self, fmt, *args):  # noqa: A003 — stdlib signature
        pass  # request logging rides telemetry, not stderr

    def _send_json(self, status: int, payload: dict) -> None:
        body = json.dumps(payload).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        self.end_headers()
        self.wfile.write(body)

    def do_GET(self) -> None:  # noqa: N802 — stdlib casing
        registry = self.server.registry
        if self.path == "/members":
            self._send_json(200, {"members": registry.members()})
        elif self.path == "/healthz":
            self._send_json(200, {"status": "ok", **registry.stats()})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})

    def do_POST(self) -> None:  # noqa: N802 — stdlib casing
        registry = self.server.registry
        n = int(self.headers.get("Content-Length") or 0)
        try:
            payload = json.loads(self.rfile.read(n) or b"{}")
        except json.JSONDecodeError as exc:
            self._send_json(400, {"error": f"bad JSON body: {exc}"})
            return
        host_id = payload.get("host_id")
        if not host_id:
            self._send_json(400, {"error": "host_id is required"})
            return
        if self.path == "/register":
            member = registry.register(
                host_id, payload.get("url", ""),
                metrics_url=payload.get("metrics_url"),
            )
            self._send_json(200, {"member": member})
        elif self.path == "/heartbeat":
            ok = registry.heartbeat(host_id)
            # 410 Gone = "re-register": the contract the agent heals on.
            self._send_json(
                200 if ok else 410,
                {"ok": ok, "host_id": host_id},
            )
        elif self.path == "/drain":
            ok = registry.drain(host_id)
            self._send_json(200 if ok else 404, {"ok": ok})
        elif self.path == "/leave":
            ok = registry.leave(host_id)
            self._send_json(200 if ok else 404, {"ok": ok})
        else:
            self._send_json(404, {"error": f"no route {self.path}"})


class RegistryClient:
    """One membership client for both transports.

    ``registry`` is either a :class:`MembershipRegistry` (in-process)
    or a base-URL string (HTTP).  Methods mirror the registry surface;
    HTTP transport failures raise (the caller — usually the
    :class:`HeartbeatAgent` — owns the retry/degrade policy)."""

    def __init__(self, registry, timeout_s: float = 5.0):
        self.timeout_s = float(timeout_s)
        if isinstance(registry, str):
            self._url: Optional[str] = registry.rstrip("/")
            self._local: Optional[MembershipRegistry] = None
        else:
            self._url = None
            self._local = registry

    def _post(self, route: str, payload: dict) -> tuple[int, dict]:
        return _http_json(
            "POST", self._url + route, payload, timeout_s=self.timeout_s
        )

    def register(
        self, host_id: str, url: str, metrics_url: Optional[str] = None
    ) -> dict:
        if self._local is not None:
            return self._local.register(host_id, url, metrics_url)
        status, obj = self._post("/register", {
            "host_id": host_id, "url": url, "metrics_url": metrics_url,
        })
        if status != 200:
            raise RuntimeError(
                f"register({host_id}) -> HTTP {status}: {obj}"
            )
        return obj["member"]

    def heartbeat(self, host_id: str) -> bool:
        if self._local is not None:
            return self._local.heartbeat(host_id)
        status, obj = self._post("/heartbeat", {"host_id": host_id})
        if status not in (200, 410):
            raise RuntimeError(
                f"heartbeat({host_id}) -> HTTP {status}: {obj}"
            )
        return bool(obj.get("ok"))

    def drain(self, host_id: str) -> bool:
        if self._local is not None:
            return self._local.drain(host_id)
        _status, obj = self._post("/drain", {"host_id": host_id})
        return bool(obj.get("ok"))

    def leave(self, host_id: str) -> bool:
        if self._local is not None:
            return self._local.leave(host_id)
        _status, obj = self._post("/leave", {"host_id": host_id})
        return bool(obj.get("ok"))

    def members(self) -> Dict[str, dict]:
        if self._local is not None:
            return self._local.members()
        status, obj = _http_json(
            "GET", self._url + "/members", timeout_s=self.timeout_s
        )
        if status != 200:
            raise RuntimeError(f"members() -> HTTP {status}: {obj}")
        return obj["members"]


class HeartbeatAgent:
    """The host-side membership loop: register once, then beat.

    A missed beat (registry down, network fault, the
    ``cluster.heartbeat`` chaos seam) only increments a failure
    counter — the host keeps serving; liveness is the REGISTRY's
    verdict, not the agent's.  A beat answered "unknown" re-registers
    on the next cycle, so an expiry during a stall (or a registry
    restart that lost the member set) heals without operator action.
    ``interval_s`` defaults to half the registry TTL so one missed
    beat never expires a healthy host."""

    def __init__(
        self,
        registry,
        host_id: str,
        url: str,
        metrics_url: Optional[str] = None,
        interval_s: Optional[float] = None,
        heartbeat_ttl_s: Optional[float] = None,
    ):
        self.client = (
            registry if isinstance(registry, RegistryClient)
            else RegistryClient(registry)
        )
        self.host_id = str(host_id)
        self.url = url
        self.metrics_url = metrics_url
        if interval_s is None:
            ttl = (
                heartbeat_ttl_s
                if heartbeat_ttl_s is not None
                else getattr(
                    self.client._local, "heartbeat_ttl_s", 2.0
                )
            )
            interval_s = ttl / 2.0
        self.interval_s = float(interval_s)
        self.beats = 0
        self.beat_failures = 0
        self.reregisters = 0
        self._registered = False
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def beat_once(self) -> bool:
        """One register-or-beat cycle; returns True when the registry
        acknowledged this host as a live member."""
        tel = telemetry_mod.current()
        try:
            # The liveness seam: a fault here is this host's beat lost
            # on the wire (docs/robustness.md).
            chaos_mod.maybe_fail("cluster.heartbeat", host=self.host_id)
            if not self._registered:
                self.client.register(
                    self.host_id, self.url, self.metrics_url
                )
                self._registered = True
                return True
            if self.client.heartbeat(self.host_id):
                self.beats += 1
                return True
            # Known protocol verdict: the registry dropped us (expiry
            # or restart) — re-register on the NEXT cycle, so a flappy
            # registry sees beats, not a register storm.
            self._registered = False
            self.reregisters += 1
            tel.counter("cluster_reregister_total").inc()
            tel.event(
                "cluster.agent_reregistering", host=self.host_id,
            )
            return False
        except Exception as exc:  # noqa: BLE001 — degrade, never die
            self.beat_failures += 1
            tel.counter("cluster_heartbeat_failures_total").inc()
            tel.event(
                "cluster.heartbeat_failed",
                host=self.host_id,
                error=f"{type(exc).__name__}: {exc}"[:200],
            )
            return False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "HeartbeatAgent":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name=f"cluster-heartbeat-{self.host_id}", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        # First beat immediately: a host should be discoverable before
        # its first interval elapses, not after.
        while True:
            self.beat_once()
            if self._stop_evt.wait(self.interval_s):
                return

    def stop(self, timeout: float = 5.0, leave: bool = True) -> None:
        self._stop_evt.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=timeout)
        if leave and self._registered:
            try:
                self.client.leave(self.host_id)
            except Exception:  # noqa: BLE001 — expiry will catch up
                pass
            self._registered = False

    def stats(self) -> dict:
        return {
            "host_id": self.host_id,
            "registered": self._registered,
            "beats": self.beats,
            "beat_failures": self.beat_failures,
            "reregisters": self.reregisters,
        }


class MembershipWatcher:
    """Converge a live :class:`FleetRouter` (and optionally a
    :class:`FleetAggregator`) onto the discovered member set.

    Each ``poll_once``: read ``members()``, then

    - a member URL the router does not route yet -> ``router.join``
      (the host enters as down-until-ready, so a warming host never
      costs a request);
    - a routed URL whose member is gone or draining -> ``router.drain``
      (graceful: in-flight completes; drain timeouts are retried next
      poll);
    - the aggregator, when given, gets the full
      ``{host_id: metrics_url}`` view via ``sync_membership`` so ops
      series follow the fleet (stale hosts marked, then dropped).

    A registry read failure keeps the LAST converged state — the same
    degrade-don't-die contract as the lease client; discovery going
    dark must not drain a healthy fleet."""

    def __init__(
        self,
        registry,
        router,
        aggregator=None,
        interval_s: float = 0.25,
        drain_timeout_s: float = 5.0,
    ):
        self.client = (
            registry if isinstance(registry, RegistryClient)
            else RegistryClient(registry)
        )
        self.router = router
        self.aggregator = aggregator
        self.interval_s = float(interval_s)
        self.drain_timeout_s = float(drain_timeout_s)
        self.polls = 0
        self.poll_failures = 0
        self.joined = 0
        self.drained = 0
        self._stop_evt = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> bool:
        """One convergence round; returns False when the registry read
        failed (last converged state kept)."""
        tel = telemetry_mod.current()
        try:
            members = self.client.members()
        except Exception as exc:  # noqa: BLE001 — degrade, never die
            self.poll_failures += 1
            tel.event(
                "cluster.watcher_poll_failed",
                error=f"{type(exc).__name__}: {exc}"[:200],
            )
            return False
        self.polls += 1
        target_urls = {
            m["url"] for m in members.values() if m["state"] == "alive"
        }
        routed = {
            h["url"]: (h["hid"], h["state"])
            for h in self.router.healthz()["hosts"]
        }
        for url in sorted(target_urls):
            hid_state = routed.get(url)
            if hid_state is None or hid_state[1] == "removed":
                self.router.join(url)
                self.joined += 1
        for url, (hid, state) in routed.items():
            if url in target_urls or state in ("removed", "draining"):
                continue
            self.router.drain(hid, timeout_s=self.drain_timeout_s)
            self.drained += 1
        if self.aggregator is not None:
            self.aggregator.sync_membership({
                hid: (m["metrics_url"] or m["url"])
                for hid, m in members.items()
            })
        return True

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MembershipWatcher":
        if self._thread is None:
            self._stop_evt.clear()
            self._thread = threading.Thread(
                target=self._loop,
                name="cluster-membership-watcher", daemon=True,
            )
            self._thread.start()
        return self

    def _loop(self) -> None:
        while True:
            try:
                self.poll_once()
            except Exception:  # noqa: BLE001 — the watcher must survive
                pass
            if self._stop_evt.wait(self.interval_s):
                return

    def stop(self, timeout: float = 5.0) -> None:
        self._stop_evt.set()
        thread = self._thread
        self._thread = None
        if thread is not None:
            thread.join(timeout=timeout)

    def stats(self) -> dict:
        return {
            "polls": self.polls,
            "poll_failures": self.poll_failures,
            "joined": self.joined,
            "drained": self.drained,
        }
