"""Runtime sanitizers: lock-order witness tracking + thread- and
process-leak sentinels (port of ``photon_ml_tpu/analysis/sanitizers.py``,
framework-neutral, copied).

These police what only execution can see — the ORDER locks are actually
taken in, and the threads and processes actually left behind.  The
reference's static rules (``engine.py``, ``rules_*.py``) are ROADMAP
item 8d.

**Lock-order sanitizer** (the lockdep idea, witness-style): every
tracked lock carries a witness NAME (a class of locks, not an
instance — ``"serving.batcher"`` covers every MicroBatcher's lock).
While a sanitizer is installed, each acquisition records edges
``held_witness -> acquired_witness`` into a global acquisition-order
graph; an acquisition that would close a cycle (thread 1 takes A then
B, thread 2 takes B then A — even at different times, even without an
actual deadlock occurring) is reported as a potential deadlock via the
telemetry flight recorder, and raised when ``strict=True``.  This turns
a deadlock from a 1-in-1000 CI hang into a deterministic report the
first time the inverted order RUNS, on any thread, under no contention.

**Thread-leak sentinel**: snapshots live threads on entry and reports
any new thread still alive at exit (after a grace poll) — the runtime
counterpart of the ``thread-lifecycle`` static rule, catching leaks
from code paths the AST cannot prove (wedged daemons, leaked pool
workers).

**Process-leak sentinel**: the same contract one isolation level up —
any child process spawned inside the scope (serving worker processes)
must be gone at exit.  A leaked process is worse than a leaked thread:
it pins shared-memory model segments and sockets, and survives the
parent interpreter.

Cost contract (mirrors chaos/core.py): with no sanitizer installed,
``tracked()`` returns the RAW lock — zero added cost on the hot path,
cheaper than chaos's one-branch contract.  Locks created WHILE a
sanitizer is installed pay one module-global read + branch per
acquire/release plus the witness bookkeeping.  Consequence of the
construction-time choice: install the sanitizer BEFORE building the
objects under test (the tests do).
"""

from __future__ import annotations

import multiprocessing
import threading
import time
from typing import Iterable, Optional

from photon_ml_tpu_torch import telemetry as telemetry_mod


class LockOrderViolation(RuntimeError):
    """Raised (strict mode) when an acquisition closes a cycle in the
    lock acquisition-order graph — a potential deadlock."""


class ThreadLeakError(RuntimeError):
    """Raised (strict mode) when threads created inside a sentinel
    scope are still alive at scope exit."""


class ProcessLeakError(RuntimeError):
    """Raised (strict mode) when child processes spawned inside a
    sentinel scope are still alive at scope exit."""


class LockOrderSanitizer:
    """Witness-based acquisition-order tracker.  Install with
    :meth:`install`/:meth:`uninstall` or as a context manager; only one
    sanitizer may be installed at a time (two would each see half the
    ordering history)."""

    def __init__(self, strict: bool = False):
        self.strict = strict
        #: confirmed orderings: witness -> witnesses acquired while it
        #: was held, with the first site that witnessed each edge.
        self._edges: dict[str, set[str]] = {}
        self._edge_threads: dict[tuple[str, str], str] = {}
        self._graph_lock = threading.Lock()
        self._tls = threading.local()
        #: potential-deadlock reports, in detection order (deduped per
        #: witness pair so a hot loop reports once, not per iteration).
        self.reports: list[dict] = []
        self._reported: set[tuple[str, str]] = set()

    # -- installation (FaultPlan's shape) -----------------------------------
    def install(self) -> "LockOrderSanitizer":
        global _SANITIZER
        with _INSTALL_LOCK:
            if _SANITIZER is not None and _SANITIZER is not self:
                raise RuntimeError(
                    "another LockOrderSanitizer is already installed; "
                    "uninstall it first"
                )
            _SANITIZER = self
        return self

    def uninstall(self) -> None:
        global _SANITIZER
        with _INSTALL_LOCK:
            if _SANITIZER is self:
                _SANITIZER = None

    def __enter__(self) -> "LockOrderSanitizer":
        return self.install()

    def __exit__(self, *exc) -> bool:
        self.uninstall()
        return False

    # -- the hot path --------------------------------------------------------
    def _stack(self) -> list[str]:
        stack = getattr(self._tls, "stack", None)
        if stack is None:
            stack = self._tls.stack = []
        return stack

    def note_acquire(self, witness: str) -> None:
        """Record intent to acquire ``witness`` with the current
        thread's held set.  Called BEFORE the real acquire — a blocked
        acquire must still have recorded the ordering that blocked it."""
        stack = self._stack()
        if stack:
            cycle = None
            with self._graph_lock:
                for held in stack:
                    if held == witness:
                        continue  # same-witness nesting: distinct
                        # instances sharing a class; legal here (the
                        # graph tracks classes, instances may nest)
                    path = self._path(witness, held)
                    if path is not None:
                        cycle = path + [witness]
                        break
                    self._edges.setdefault(held, set()).add(witness)
                    self._edge_threads.setdefault(
                        (held, witness), threading.current_thread().name
                    )
            if cycle is not None:
                self._report(witness, stack, cycle)
        stack.append(witness)

    def note_release(self, witness: str) -> None:
        stack = getattr(self._tls, "stack", None)
        if stack:
            # remove the most recent occurrence (locks release LIFO in
            # with-blocks, but tolerate hand-over-hand patterns)
            for i in range(len(stack) - 1, -1, -1):
                if stack[i] == witness:
                    del stack[i]
                    break

    def _path(self, src: str, dst: str) -> Optional[list[str]]:
        """Existing-edge path src -> ... -> dst, else None (DFS over a
        graph of a handful of witnesses; runs under _graph_lock)."""
        seen = {src}
        order = [(src, [src])]
        while order:
            node, path = order.pop()
            if node == dst:
                return path
            for nxt in self._edges.get(node, ()):
                if nxt not in seen:
                    seen.add(nxt)
                    order.append((nxt, path + [nxt]))
        return None

    def _report(
        self, witness: str, held: list[str], cycle: list[str]
    ) -> None:
        key = (cycle[0], cycle[-2] if len(cycle) > 1 else cycle[0])
        with self._graph_lock:
            if key in self._reported:
                return
            self._reported.add(key)
            first_thread = self._edge_threads.get(
                (cycle[0], cycle[1]) if len(cycle) > 1 else key, "?"
            )
            report = {
                "kind": "lock-order-inversion",
                "acquiring": witness,
                "held": list(held),
                "cycle": cycle,
                "thread": threading.current_thread().name,
                "first_seen_thread": first_thread,
            }
            self.reports.append(report)
        tel = telemetry_mod.current()
        tel.counter("analysis_lock_order_reports_total").inc()
        tel.event("analysis.lock_order_inversion", **report)
        # Same forensics contract as a chaos fault: the flight-recorder
        # ring is dumped ENDING at the inversion event, so the report
        # arrives with the event window that led to it.
        telemetry_mod.dump_flight_recorder(
            reason=f"lockorder:{'->'.join(cycle)}"
        )
        if self.strict:
            raise LockOrderViolation(
                f"lock acquisition order inversion: acquiring "
                f"{witness!r} while holding {held!r} closes the cycle "
                f"{' -> '.join(cycle)} (first seen on thread "
                f"{first_thread!r}); two threads taking these in "
                "opposite orders can deadlock"
            )


_INSTALL_LOCK = threading.Lock()
_SANITIZER: Optional[LockOrderSanitizer] = None


def current_sanitizer() -> Optional[LockOrderSanitizer]:
    return _SANITIZER


class TrackedLock:
    """A lock proxy that reports acquisition order to the installed
    sanitizer.  Disabled path (sanitizer uninstalled after creation):
    one module-global read + branch per operation, the chaos
    ``maybe_fail`` contract."""

    __slots__ = ("_lock", "witness")

    def __init__(self, lock, witness: str):
        self._lock = lock
        self.witness = witness

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        s = _SANITIZER
        if s is not None:
            s.note_acquire(self.witness)
        ok = self._lock.acquire(blocking, timeout)
        if not ok and s is not None:
            s.note_release(self.witness)  # failed try-acquire: unwind
        return ok

    def release(self) -> None:
        self._lock.release()
        s = _SANITIZER
        if s is not None:
            s.note_release(self.witness)

    def locked(self) -> bool:
        return self._lock.locked()

    def __enter__(self) -> bool:
        return self.acquire()

    def __exit__(self, *exc) -> bool:
        self.release()
        return False


def tracked(lock, witness: str):
    """Wrap ``lock`` for lock-order tracking under witness class
    ``witness`` — or return it untouched when no sanitizer is installed
    (zero overhead; the construction-time decision the module docstring
    documents).  Subsystems wire their locks through this at creation:

        self._lock = sanitizers.tracked(threading.Lock(), "serving.batcher")
    """
    if _SANITIZER is None:
        return lock
    return TrackedLock(lock, witness)


# ---------------------------------------------------------------------------
# Thread-leak sentinel
# ---------------------------------------------------------------------------

class ThreadLeakSentinel:
    """Context manager: any thread created inside the scope must be
    gone by exit (after a ``grace_s`` poll — healthy daemon threads
    finish in microseconds once their work is consumed).

    ``allow`` lists thread-name prefixes that may legitimately outlive
    the scope (e.g. a process-lifetime exporter).  ``leaked`` holds the
    offending thread names after exit; ``strict=True`` raises
    :class:`ThreadLeakError` instead (unless the body is already
    unwinding an exception — the original error keeps priority, the
    leak is still counted, prefetch's join-timeout discipline)."""

    def __init__(
        self,
        grace_s: float = 2.0,
        allow: Iterable[str] = (),
        strict: bool = False,
    ):
        self.grace_s = grace_s
        self.allow = tuple(allow)
        self.strict = strict
        self.leaked: list[str] = []
        self._before: set[int] = set()

    def __enter__(self) -> "ThreadLeakSentinel":
        self._before = {
            t.ident for t in threading.enumerate() if t.ident is not None
        }
        return self

    def _new_alive(self) -> list[threading.Thread]:
        return [
            t for t in threading.enumerate()
            if t.ident is not None
            and t.ident not in self._before
            and t.is_alive()
            and not t.name.startswith(self.allow)
        ]

    def __exit__(self, exc_type, exc, tb) -> bool:
        deadline = time.monotonic() + self.grace_s
        alive = self._new_alive()
        while alive and time.monotonic() < deadline:
            time.sleep(0.01)
            alive = self._new_alive()
        if alive:
            self.leaked = sorted(t.name for t in alive)
            tel = telemetry_mod.current()
            tel.counter("analysis_thread_leak_total").inc(len(alive))
            tel.event("analysis.thread_leak", threads=self.leaked)
            telemetry_mod.dump_flight_recorder(
                reason=f"threadleak:{','.join(self.leaked)}"
            )
            if self.strict and exc_type is None:
                raise ThreadLeakError(
                    f"thread(s) {self.leaked} created inside the "
                    f"sentinel scope are still alive {self.grace_s}s "
                    "after exit: a background thread leaked past its "
                    "owner's lifecycle"
                )
        return False


class ProcessLeakSentinel:
    """Context manager: any CHILD PROCESS spawned inside the scope must
    be gone by exit — the serving worker pool's
    shutdown acceptance gate (a leaked worker pins its shared-memory
    mapping and a socket, not just a thread stack).

    Mirrors :class:`ThreadLeakSentinel`: ``allow`` lists process-name
    prefixes that may outlive the scope, ``leaked`` holds offending
    process names after exit, ``strict=True`` raises
    :class:`ProcessLeakError` unless the body is already unwinding an
    exception.  The grace default is longer than the thread sentinel's —
    a worker draining its batcher is finishing real scoring work.
    Polling uses ``multiprocessing.active_children()``, which also reaps
    finished children, so a passed scope leaves no zombies either."""

    def __init__(
        self,
        grace_s: float = 10.0,
        allow: Iterable[str] = (),
        strict: bool = False,
    ):
        self.grace_s = grace_s
        self.allow = tuple(allow)
        self.strict = strict
        self.leaked: list[str] = []
        self._before: set[Optional[int]] = set()

    def __enter__(self) -> "ProcessLeakSentinel":
        self._before = {
            p.pid for p in multiprocessing.active_children()
        }
        return self

    def _new_alive(self) -> list:
        return [
            p for p in multiprocessing.active_children()
            if p.pid not in self._before
            and p.is_alive()
            and not p.name.startswith(self.allow)
        ]

    def __exit__(self, exc_type, exc, tb) -> bool:
        deadline = time.monotonic() + self.grace_s
        alive = self._new_alive()
        while alive and time.monotonic() < deadline:
            time.sleep(0.05)
            alive = self._new_alive()
        if alive:
            self.leaked = sorted(
                f"{p.name}(pid={p.pid})" for p in alive
            )
            tel = telemetry_mod.current()
            tel.counter("analysis_process_leak_total").inc(len(alive))
            tel.event("analysis.process_leak", processes=self.leaked)
            telemetry_mod.dump_flight_recorder(
                reason=f"processleak:{','.join(self.leaked)}"
            )
            if self.strict and exc_type is None:
                raise ProcessLeakError(
                    f"child process(es) {self.leaked} spawned inside "
                    f"the sentinel scope are still alive {self.grace_s}s "
                    "after exit: a worker leaked past its owner's "
                    "lifecycle (and pins its shared-memory mappings)"
                )
        return False
