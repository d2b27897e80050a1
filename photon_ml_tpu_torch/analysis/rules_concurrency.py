"""Concurrency rules: thread lifecycle, lock hygiene, clock discipline
(port of ``photon_ml_tpu/analysis/rules_concurrency.py``).

The port has the reference's threads and locks across prefetch,
streaming, serving, tuning, the ops plane and the cluster, policed only
by convention.  These rules make the conventions machine-checked:

- ``thread-lifecycle``: a non-daemon ``threading.Thread`` that is not
  joined on EVERY exit path (a ``finally``, or a separate lifecycle
  method like ``stop()``/``close()``) wedges interpreter shutdown the
  first time an exception lands between ``start()`` and ``join()``.
  The repo convention after the reference's prefetch-leak incident is:
  every background thread is ``daemon=True`` AND joined by its owner.
- ``process-lifecycle``: the same discipline one isolation level up —
  every ``multiprocessing.Process`` / ``subprocess.Popen`` is
  join()ed/wait()ed on every exit path AND carries a terminate/kill
  escalation, because a leaked child outlives the interpreter and pins
  shared memory; a wedged one hangs shutdown behind an unbounded reap.
- ``lock-blocking-call``: a blocking call (sleep, network, thread join,
  device sync, future result, fsync) while holding a
  ``threading.Lock`` turns a micro-critical-section into a convoy —
  and on the serving path, into tail latency.  chaos/core.py's
  sleep-outside-the-lock shape is the model.  The device syncs are
  torch's: ``torch.cuda.synchronize()`` (and a stream's or event's
  ``.synchronize()``), and ``.item()`` / ``.cpu()``, which wait for the
  card when the tensor is on it.  A static check cannot see where a
  tensor lives, so it counts every such call under a lock; one on a
  tensor known to be on the host carries a suppression saying so.
- ``wall-clock-interval``: ``time.time()`` is wall clock — NTP steps
  it, VM migration steps it.  Every latency/interval measurement must
  use ``time.monotonic()``/``perf_counter()``; ``time.time()`` is only
  for wall-anchoring (epoch fields, ``*_wall`` keys) where the absolute
  date IS the datum.
"""

from __future__ import annotations

import ast
from typing import Iterable, Optional

from photon_ml_tpu_torch.analysis.engine import (
    Finding,
    PyFile,
    Rule,
    SourceTree,
    dotted_name,
    kwarg,
)

# ---------------------------------------------------------------------------
# thread-lifecycle
# ---------------------------------------------------------------------------

def _thread_target_name(pf: PyFile, call: ast.Call) -> Optional[str]:
    """The name the new Thread is bound to ('t', 'self._thread'), if the
    creation is a plain single-target assignment."""
    parent = pf.parents.get(call)
    if isinstance(parent, ast.Assign) and len(parent.targets) == 1:
        return dotted_name(parent.targets[0])
    return None


def _is_daemon(call: ast.Call) -> bool:
    v = kwarg(call, "daemon")
    return isinstance(v, ast.Constant) and v.value is True


def _method_calls_on(pf: PyFile, name: str, method: str) -> list[ast.Call]:
    """Calls ``<name>.<method>(...)`` anywhere in the file."""
    out = []
    for node in ast.walk(pf.tree):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == method
            and dotted_name(node.func.value) == name
        ):
            out.append(node)
    return out


def _in_finally(pf: PyFile, node: ast.AST) -> bool:
    cur = node
    for anc in pf.parent_chain(node):
        if isinstance(anc, ast.Try):
            for stmt in anc.finalbody:
                if cur is stmt or any(
                    cur is d for d in ast.walk(stmt)
                ):
                    return True
        cur = anc
    return False


def _check_thread_lifecycle(tree: SourceTree) -> Iterable[Finding]:
    for pf in tree.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            callee = dotted_name(node.func)
            if callee not in ("threading.Thread", "Thread"):
                continue
            if _is_daemon(node):
                continue
            name = _thread_target_name(pf, node)
            if name is None:
                # Unbound creation (list comprehension, direct .start()):
                # nothing can ever join it by name.
                yield Finding(
                    "thread-lifecycle", pf.relpath, node.lineno,
                    "non-daemon Thread created without a binding that "
                    "could be joined; pass daemon=True (and join where "
                    "results are needed)",
                )
                continue
            joins = _method_calls_on(pf, name, "join")
            if not joins:
                yield Finding(
                    "thread-lifecycle", pf.relpath, node.lineno,
                    f"non-daemon Thread {name!r} is never joined in this "
                    "file; pass daemon=True or join it on every exit "
                    "path",
                )
                continue
            starts = _method_calls_on(pf, name, "start")
            start_fns = {pf.enclosing_function(c) for c in starts}
            for j in joins:
                if _in_finally(pf, j):
                    break  # exception-safe join exists
                if pf.enclosing_function(j) not in start_fns:
                    break  # lifecycle pattern: joined by stop()/close()
            else:
                yield Finding(
                    "thread-lifecycle", pf.relpath, node.lineno,
                    f"non-daemon Thread {name!r} is joined only on the "
                    "happy path: an exception between start() and join() "
                    "leaks it and wedges interpreter exit; join in a "
                    "finally: block or pass daemon=True",
                )


# ---------------------------------------------------------------------------
# process-lifecycle
# ---------------------------------------------------------------------------

#: process-constructor name -> the call that reaps it.  ``subprocess.run``
#: / ``call`` / ``check_output`` wait internally and are exempt.
_PROC_KINDS = {"Process": "join", "Popen": "wait"}


def _process_kind(callee: Optional[str]) -> Optional[str]:
    """'Process' for multiprocessing.Process / ctx.Process /
    mp.get_context(...).Process, 'Popen' for subprocess.Popen — matched
    on the final attribute so spawn-context construction counts too."""
    if not callee:
        return None
    base = callee.rsplit(".", 1)[-1]
    return base if base in _PROC_KINDS else None


def _check_process_lifecycle(tree: SourceTree) -> Iterable[Finding]:
    """A child process needs MORE than a thread: ``join``/``wait`` on
    every exit path (else zombies accumulate), AND a ``terminate()`` or
    ``kill()`` escalation reachable somewhere (else a wedged child hangs
    its owner's shutdown forever — a thread can at worst wedge exit, a
    process also pins shared memory and sockets past the interpreter)."""
    for pf in tree.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            kind = _process_kind(dotted_name(node.func))
            if kind is None:
                continue
            reap = _PROC_KINDS[kind]
            name = _thread_target_name(pf, node)
            if name is None:
                yield Finding(
                    "process-lifecycle", pf.relpath, node.lineno,
                    f"{kind} created without a binding that could be "
                    f"{reap}ed/terminated; bind it and reap it on every "
                    "exit path",
                )
                continue
            reaps = _method_calls_on(pf, name, reap)
            if not reaps:
                yield Finding(
                    "process-lifecycle", pf.relpath, node.lineno,
                    f"{kind} {name!r} is never {reap}ed in this file: "
                    "an unreaped child is a zombie and its exit status "
                    f"is lost; {reap} it on every exit path",
                )
                continue
            if not (
                _method_calls_on(pf, name, "terminate")
                or _method_calls_on(pf, name, "kill")
            ):
                yield Finding(
                    "process-lifecycle", pf.relpath, node.lineno,
                    f"{kind} {name!r} is {reap}ed but never "
                    "terminate()d/kill()ed: a wedged child makes the "
                    f"{reap} wait forever; escalate "
                    f"{reap}(timeout) -> terminate -> kill on shutdown",
                )
                continue
            # Exception safety, same discipline as thread-lifecycle: the
            # reap runs in a finally, or lives in a different method than
            # the one that launched the child (stop()/close() pattern).
            starts = _method_calls_on(pf, name, "start") or [node]
            start_fns = {pf.enclosing_function(c) for c in starts}
            for r in reaps:
                if _in_finally(pf, r):
                    break
                if pf.enclosing_function(r) not in start_fns:
                    break
            else:
                yield Finding(
                    "process-lifecycle", pf.relpath, node.lineno,
                    f"{kind} {name!r} is {reap}ed only on the happy "
                    "path: an exception after launch leaks the child "
                    f"(and whatever it maps); {reap} in a finally: "
                    "block or from a lifecycle stop()/close()",
                )


# ---------------------------------------------------------------------------
# lock-blocking-call
# ---------------------------------------------------------------------------

_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}

#: Callee patterns that block the calling thread for unbounded /
#: milliseconds-scale time.  Attribute tails match any receiver
#: (``x.item``), dotted names match exactly.  The device syncs stand
#: where the reference names ``jax.device_put`` and
#: ``.block_until_ready()``.
_BLOCKING_DOTTED = {
    "time.sleep", "sleep",
    "urllib.request.urlopen", "urlopen",
    "socket.create_connection", "socket.getaddrinfo",
    "subprocess.run", "subprocess.call", "subprocess.check_output",
    "torch.cuda.synchronize", "os.fsync",
}
_BLOCKING_ATTRS = {
    "synchronize",  # a stream's or an event's device sync
    "item", "cpu",  # a device sync when the tensor is on the card
    "result",  # concurrent.futures
    "recv", "accept", "connect", "urlopen",
    "fsync",
}
#: join() blocks too, but Condition/Barrier-free code here only joins
#: THREADS; flag it separately for a pointed message.
_JOIN_ATTR = "join"


def _lock_names(pf: PyFile) -> set[str]:
    """Names (vars and self-attrs) bound to lock objects in this file,
    including locks wrapped by ``sanitizers.tracked(...)``."""
    names: set[str] = set()
    for node in ast.walk(pf.tree):
        if not isinstance(node, ast.Assign) or len(node.targets) != 1:
            continue
        value = node.value
        # unwrap sanitizers.tracked(threading.Lock(), "witness")
        if (
            isinstance(value, ast.Call)
            and (dotted_name(value.func) or "").endswith("tracked")
            and value.args
        ):
            value = value.args[0]
        if (
            isinstance(value, ast.Call)
            and dotted_name(value.func) in _LOCK_FACTORIES
        ):
            target = dotted_name(node.targets[0])
            if target:
                names.add(target)
    return names


# ``.join()`` attribute calls that can never block: path joins and
# string joins on a literal separator.  Everything else named .join()
# under a lock is treated as a thread join.
_PATH_JOINS = {"os.path.join", "posixpath.join", "ntpath.join"}


def _is_thread_join(call: ast.Call, callee: Optional[str]) -> bool:
    if callee in _PATH_JOINS:
        return False
    if (
        isinstance(call.func, ast.Attribute)
        and isinstance(call.func.value, ast.Constant)
        and isinstance(call.func.value.value, str)
    ):
        return False
    return True


def _blocking_reason(callee: Optional[str], attr: Optional[str]
                     ) -> Optional[str]:
    if callee in _BLOCKING_DOTTED:
        return f"{callee}()"
    if attr in _BLOCKING_ATTRS:
        return f".{attr}()"
    return None


def _check_lock_blocking(tree: SourceTree) -> Iterable[Finding]:
    for pf in tree.files:
        if pf.tree is None:
            continue
        locks = _lock_names(pf)
        if not locks:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.With):
                continue
            held = [
                dotted_name(item.context_expr)
                for item in node.items
                if dotted_name(item.context_expr) in locks
            ]
            if not held:
                continue
            for body_stmt in node.body:
                for sub in ast.walk(body_stmt):
                    if not isinstance(sub, ast.Call):
                        continue
                    callee = dotted_name(sub.func)
                    attr = (
                        sub.func.attr
                        if isinstance(sub.func, ast.Attribute) else None
                    )
                    if attr == _JOIN_ATTR and _is_thread_join(
                        sub, callee
                    ):
                        yield Finding(
                            "lock-blocking-call", pf.relpath, sub.lineno,
                            f"thread join while holding lock "
                            f"{held[0]!r}: every other user of the lock "
                            "convoys behind the joined thread; join "
                            "outside the critical section",
                        )
                        continue
                    reason = _blocking_reason(callee, attr)
                    if reason:
                        yield Finding(
                            "lock-blocking-call", pf.relpath, sub.lineno,
                            f"blocking call {reason} while holding lock "
                            f"{held[0]!r}; move it outside the critical "
                            "section (chaos/core.py's sleep-after-"
                            "release is the model)",
                        )


# ---------------------------------------------------------------------------
# wall-clock-interval
# ---------------------------------------------------------------------------

_WALL_OK_TOKENS = ("wall", "epoch")


def _wall_anchored_context(pf: PyFile, call: ast.Call) -> bool:
    """True when the time.time() value is being used AS a wall-clock
    datum: assigned to / keyed under a name containing 'wall' or
    'epoch'.  Everything else (subtraction, comparison, latency math)
    must use a monotonic clock."""
    node: ast.AST = call
    for anc in pf.parent_chain(call):
        if isinstance(anc, ast.Dict):
            for k, v in zip(anc.keys, anc.values):
                if v is node and isinstance(k, ast.Constant) and any(
                    t in str(k.value).lower() for t in _WALL_OK_TOKENS
                ):
                    return True
            return False
        if isinstance(anc, ast.keyword):
            return anc.arg is not None and any(
                t in anc.arg.lower() for t in _WALL_OK_TOKENS
            )
        if isinstance(anc, (ast.Assign, ast.AnnAssign)):
            targets = (
                anc.targets if isinstance(anc, ast.Assign)
                else [anc.target]
            )
            return any(
                any(t in (dotted_name(tgt) or "").lower()
                    for t in _WALL_OK_TOKENS)
                for tgt in targets
            )
        if isinstance(anc, (ast.BinOp, ast.Compare)):
            return False  # arithmetic on wall clock = interval math
        if isinstance(anc, ast.stmt):
            return False
        node = anc
    return False


def _check_wall_clock(tree: SourceTree) -> Iterable[Finding]:
    for pf in tree.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            if dotted_name(node.func) != "time.time":
                continue
            if _wall_anchored_context(pf, node):
                continue
            yield Finding(
                "wall-clock-interval", pf.relpath, node.lineno,
                "time.time() outside a wall-anchoring context (no "
                "'wall'/'epoch' in the target name or dict key): "
                "latency and interval accounting must use "
                "time.monotonic()/perf_counter() — wall clock steps "
                "under NTP and corrupts the measurement",
            )


RULES = [
    Rule(
        id="thread-lifecycle",
        family="concurrency",
        summary="every threading.Thread is daemon=True or joined on "
                "every exit path (finally / lifecycle stop())",
        explain=(
            "A non-daemon thread that is never joined — or joined only "
            "on the happy path — blocks interpreter exit the first time "
            "an exception lands between start() and join(): CI wedges "
            "instead of failing, and the thread pins whatever buffers "
            "it holds (the reference's prefetch leak).  The rule accepts: "
            "daemon=True; a join inside a finally: block; or the "
            "lifecycle-object pattern where start() and join() live in "
            "different methods (MicroBatcher.start/stop).  Fix: pass "
            "daemon=True and keep the join for result correctness, "
            "moving it into a finally: when start and join share a "
            "function."
        ),
        fn=_check_thread_lifecycle,
    ),
    Rule(
        id="process-lifecycle",
        family="concurrency",
        summary="every multiprocessing.Process / subprocess.Popen is "
                "join()ed/wait()ed on every exit path AND has a "
                "terminate/kill escalation",
        explain=(
            "thread-lifecycle, one isolation level up — and stricter, "
            "because a leaked child process outlives the interpreter "
            "and pins shared-memory segments and sockets, and an "
            "unreaped one is a zombie.  The rule matches constructors "
            "by final attribute (multiprocessing.Process, ctx.Process "
            "from a spawn context, subprocess.Popen; subprocess.run/"
            "call/check_output wait internally and are exempt) and "
            "requires: a binding; a join() (Process) or wait() (Popen) "
            "somewhere in the file, exception-safe (in a finally:, or "
            "in a different method than the launch — the stop()/close() "
            "lifecycle split); and a terminate() or kill() call so a "
            "WEDGED child cannot hang shutdown behind an unbounded "
            "reap.  serving/procpool.py's stop() — shutdown frame, "
            "join(timeout), then terminate+join and kill+join in a "
            "finally: — is the model.  Runtime counterpart: "
            "sanitizers.ProcessLeakSentinel."
        ),
        fn=_check_process_lifecycle,
    ),
    Rule(
        id="lock-blocking-call",
        family="concurrency",
        summary="no blocking call (sleep/network/join/device/fsync/"
                "future-result) while holding a known lock",
        explain=(
            "The engine learns which names hold locks (assignments from "
            "threading.Lock/RLock/Condition, including "
            "sanitizers.tracked(...) wrappers) and flags blocking calls "
            "lexically inside `with <lock>:` bodies: time.sleep, "
            "urlopen/socket/subprocess, thread .join(), "
            "torch.cuda.synchronize() / .synchronize(), .item() / .cpu() "
            "(device syncs when the tensor is on the card), future "
            ".result(), os.fsync.  Holding a lock across any of these convoys "
            "every other user of the lock — on the serving path that is "
            "directly request tail latency; on the streamed path it "
            "stalls the pack/transfer overlap.  Fix: copy state under "
            "the lock, block outside it (chaos/core.py _hit sleeps "
            "after releasing; prefetch snapshots under live_lock and "
            "publishes outside).  Deliberate holds (a journal fsync "
            "that IS the critical section) carry a suppression or a "
            "baseline entry with the justification."
        ),
        fn=_check_lock_blocking,
    ),
    Rule(
        id="wall-clock-interval",
        family="concurrency",
        summary="time.time() only for wall-anchoring; intervals use "
                "monotonic()/perf_counter()",
        explain=(
            "time.time() is stepped by NTP and VM migration; a latency "
            "histogram fed from it can go negative or jump hours.  The "
            "telemetry contract is: monotonic "
            "timestamps everywhere, wall clock ONLY to anchor a run's "
            "epoch (`_epoch_wall`, `t_wall`, `wall_epoch` fields) for "
            "cross-process trace merging.  The rule allows time.time() "
            "when the value lands under a name or dict key containing "
            "'wall' or 'epoch', and flags every other use — especially "
            "arithmetic (`time.time() - t0`), which is interval math on "
            "the wrong clock.  Fix: time.perf_counter() for intervals, "
            "or rename the anchor field to say wall/epoch."
        ),
        fn=_check_wall_clock,
    ),
]
