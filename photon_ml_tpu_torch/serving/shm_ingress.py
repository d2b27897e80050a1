"""Same-machine shared-memory ingress: the zero-HTTP fast path (port of
``photon_ml_tpu/serving/shm_ingress.py``).

A co-located client (a sidecar, a feature service, a gateway sharing
the host) should not pay TCP + HTTP framing to reach a scoring
process a context switch away.  This module runs a fixed ring of
request/response slots in one POSIX shared-memory segment — the same
``multiprocessing.shared_memory`` machinery the zero-copy model pool
uses (serving/shm_model.py) — and carries serving/wire.py frames as
the payloads, so the shm path and the HTTP binary path decode through
the SAME codec and produce bitwise-identical scores.

Layout (all little-endian)::

    ring header  <4s magic "PHSI"> <u16 version> <u16 reserved>
                 <u32 n_slots> <u32 slot_bytes> <u32 publisher_pid>
    slot[i]      <u32 state> <u32 seq> <u32 length> <u32 reserved>
                 <u64 trace> <u64 span> <u32 flags>
                 + slot_bytes of payload

Ring version 2 grew the per-slot trace-context words (trace / span /
flags — :meth:`~photon_ml_tpu_torch.telemetry.core.TraceContext.to_words`):
a client inside a traced request writes its propagated context before
flipping the slot to REQUEST, and the server adopts it around scoring
so the shm hop's spans stitch into the caller's distributed trace.
All-zero words (``trace == 0``) mean "untraced" and cost nothing.

Slot states walk ``FREE → REQUEST → BUSY → RESPONSE → FREE``: the
client owns a FREE slot, writes a request frame, flips it to REQUEST;
the server's poll thread claims it (BUSY), scores through the regular
:meth:`~photon_ml_tpu_torch.serving.service.ScoringService.score_many` path
(admission, batching, tenancy — the shm path skips HTTP, not policy),
writes a response frame, flips to RESPONSE; the client reads it back
and frees the slot.  The ``seq`` counter increments per use so a
late reader can never mistake a stale response for its own.

Writes are ordered payload → length/seq → state, and each header
field is one aligned 32-bit store, so a reader that observes the
state flip observes the fields behind it.  Multiple client PROCESSES
must be handed disjoint ``slot_range``s — slot acquisition is
lock-free only within a process (a lock guards the local free list).

The server's poll loop backs off adaptively: it spins at ~50 µs while
traffic flows and decays to 2 ms when idle, so an idle ring costs
near-zero CPU without adding tail latency under load.
"""

from __future__ import annotations

import multiprocessing
import os
import struct
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from multiprocessing import shared_memory
from typing import Optional, Sequence

from photon_ml_tpu_torch.serving import wire as wire_mod
from photon_ml_tpu_torch.serving.batcher import DeadlineExceededError, RejectedError
from photon_ml_tpu_torch import telemetry as telemetry_mod

__all__ = ["ShmIngress", "ShmIngressClient", "ShmIngressError"]

_RING_HEADER = struct.Struct("<4sHHIII")
_SLOT_HEADER = struct.Struct("<IIIIQQI")
#: the trace-context words alone, at offset 16 inside the slot header
#: (after the four aligned u32 control fields, whose offsets v2 keeps).
_TRACE_WORDS = struct.Struct("<QQI")
_MAGIC = b"PHSI"
_VERSION = 2

#: slot states
_FREE, _REQUEST, _BUSY, _RESPONSE = 0, 1, 2, 3

_U32 = struct.Struct("<I")

#: idle poll backoff bounds (seconds): spin fast under load, decay
#: when the ring is quiet.
_MIN_POLL_S = 50e-6
_MAX_POLL_S = 2e-3


class ShmIngressError(RuntimeError):
    """The ring is unusable: bad magic/version on attach, a frame too
    large for its slot, or the segment disappeared."""


def _slot_offsets(i: int, slot_bytes: int) -> tuple:
    """(header_off, payload_off) for slot ``i``."""
    base = _RING_HEADER.size + i * (_SLOT_HEADER.size + slot_bytes)
    return base, base + _SLOT_HEADER.size


class ShmIngress:
    """Server side: owns the segment, polls for requests, scores them
    through ``service`` and answers in place.

    Parameters
    ----------
    service:
        The :class:`~photon_ml_tpu_torch.serving.service.ScoringService` to
        score through — same parser, same admission, same batcher as
        the HTTP paths.
    n_slots / slot_bytes:
        Ring geometry.  One slot holds one request frame and, later,
        its response frame; size slots for your largest batch.
    workers:
        Concurrent scoring handlers.  More than one lets requests from
        different slots coalesce into shared device batches.
    """

    def __init__(
        self,
        service,
        n_slots: int = 16,
        slot_bytes: int = 1 << 20,
        name: Optional[str] = None,
        workers: int = 4,
    ):
        if n_slots < 1:
            raise ValueError(f"shm ingress needs n_slots >= 1, got {n_slots}")
        if slot_bytes < 4096:
            raise ValueError(
                f"shm ingress needs slot_bytes >= 4096, got {slot_bytes}"
            )
        if workers < 1:
            raise ValueError(f"shm ingress needs workers >= 1, got {workers}")
        self.service = service
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        self._workers = workers
        size = _RING_HEADER.size + n_slots * (_SLOT_HEADER.size + slot_bytes)
        self._shm = shared_memory.SharedMemory(
            create=True, size=size, name=name
        )
        _RING_HEADER.pack_into(
            self._shm.buf, 0, _MAGIC, _VERSION, 0, n_slots, slot_bytes,
            os.getpid(),
        )
        for i in range(n_slots):
            off, _ = _slot_offsets(i, slot_bytes)
            _SLOT_HEADER.pack_into(
                self._shm.buf, off, _FREE, 0, 0, 0, 0, 0, 0
            )
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def name(self) -> str:
        """Segment name a co-located client attaches by."""
        return self._shm.name

    def start(self) -> "ShmIngress":
        if self._thread is not None:
            return self
        self._pool = ThreadPoolExecutor(
            max_workers=self._workers, thread_name_prefix="shm-ingress"
        )
        self._thread = threading.Thread(
            target=self._poll_loop, name="shm-ingress-poll", daemon=True
        )
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        try:
            self._shm.close()
            self._shm.unlink()
        except (OSError, FileNotFoundError):
            pass

    # -- poll loop ---------------------------------------------------------
    def _poll_loop(self) -> None:
        backoff = _MIN_POLL_S
        buf = self._shm.buf
        while not self._stop.is_set():
            claimed = False
            for i in range(self.n_slots):
                off, _ = _slot_offsets(i, self.slot_bytes)
                (state,) = _U32.unpack_from(buf, off)
                if state != _REQUEST:
                    continue
                _U32.pack_into(buf, off, _BUSY)
                claimed = True
                self._pool.submit(self._handle_slot, i)
            if claimed:
                backoff = _MIN_POLL_S
                continue
            self._stop.wait(backoff)
            backoff = min(backoff * 2, _MAX_POLL_S)

    def _handle_slot(self, i: int) -> None:
        tel = telemetry_mod.current()
        buf = self._shm.buf
        off, data_off = _slot_offsets(i, self.slot_bytes)
        (_state, seq, length, _res,
         trace_w, span_w, flags) = _SLOT_HEADER.unpack_from(buf, off)
        # Trace adoption from the slot header's words: the handler's
        # spans (and the batcher's serving.batch span downstream) parent
        # to the CLIENT's span, so the shm hop rides the caller's
        # distributed trace.  Zero words = untraced, ctx = None.
        ctx = telemetry_mod.TraceContext.from_words(trace_w, span_w, flags)
        payload = bytes(buf[data_off:data_off + min(length, self.slot_bytes)])
        tel.counter("serving_ingress_rx_bytes").inc(len(payload))
        n_rows = 1
        try:
            with tel.adopt(ctx):
                rows = wire_mod.decode_request(
                    payload, self.service.request_parser()
                )
                n_rows = len(rows)
                tel.counter("serving_ingress_requests_total").inc()
                tel.counter("serving_ingress_rows_total").inc(n_rows)
                results = self.service.score_many(rows)
        except Exception as exc:  # noqa: BLE001 — answer in-band
            tel.counter("serving_ingress_errors_total").inc()
            kind = (
                "rejected" if isinstance(exc, RejectedError)
                else "deadline" if isinstance(exc, DeadlineExceededError)
                else "bad_request" if isinstance(exc, ValueError)
                else "internal"
            )
            results = [{"error": str(exc), "kind": kind}] * n_rows
        t_encode = time.perf_counter()
        frame = wire_mod.encode_response(results)
        tel.histogram("serving_stage_encode_seconds").observe(
            time.perf_counter() - t_encode
        )
        if len(frame) > self.slot_bytes:
            tel.counter("serving_ingress_errors_total").inc()
            overflow = {
                "error": (
                    f"response frame ({len(frame)} bytes) exceeds the "
                    f"{self.slot_bytes}-byte slot; use fewer rows per "
                    "request or a larger ring"
                ),
                "kind": "internal",
            }
            frame = wire_mod.encode_response([overflow] * len(results))
            if len(frame) > self.slot_bytes:
                frame = wire_mod.encode_response([overflow])
        tel.counter("serving_ingress_tx_bytes").inc(len(frame))
        buf[data_off:data_off + len(frame)] = frame
        _U32.pack_into(buf, off + 8, len(frame))
        _U32.pack_into(buf, off + 4, seq)
        _U32.pack_into(buf, off, _RESPONSE)


class ShmIngressClient:
    """Client side: attach by name, submit request frames, block for
    responses.  One instance is thread-safe; separate PROCESSES need
    disjoint ``slot_range``s (e.g. process 0 takes ``(0, 8)``,
    process 1 ``(8, 16)``)."""

    def __init__(
        self, name: str, slot_range: Optional[tuple] = None
    ):
        try:
            self._shm = shared_memory.SharedMemory(name=name)
        except FileNotFoundError:
            raise ShmIngressError(
                f"shm ingress segment {name!r} is gone — is the server "
                "running on this machine?"
            ) from None
        if self._shm.size < _RING_HEADER.size:
            raise ShmIngressError(
                f"segment {name!r} is {self._shm.size} bytes — smaller "
                "than a ring header; not an ingress ring"
            )
        (magic, version, _res, n_slots, slot_bytes,
         publisher_pid) = _RING_HEADER.unpack_from(self._shm.buf, 0)
        if magic != _MAGIC:
            raise ShmIngressError(
                f"segment {name!r} has magic {bytes(magic)!r}; not an "
                "ingress ring"
            )
        if version != _VERSION:
            raise ShmIngressError(
                f"ring version {version} unsupported (this build speaks "
                f"{_VERSION})"
            )
        # A STANDALONE attacher must drop the resource-tracker
        # registration or its exit unlinks the server's ring out from
        # under it; the publisher itself and multiprocessing children
        # (shared tracker daemon) must NOT — shm_model.py documents the
        # Python 3.10 behavior this mirrors.
        if (
            os.getpid() != publisher_pid
            and multiprocessing.parent_process() is None
        ):
            try:
                from multiprocessing import resource_tracker
                resource_tracker.unregister(self._shm._name, "shared_memory")
            except Exception:  # noqa: BLE001 — tracker internals vary
                pass
        self.n_slots = n_slots
        self.slot_bytes = slot_bytes
        lo, hi = slot_range if slot_range is not None else (0, n_slots)
        if not (0 <= lo < hi <= n_slots):
            raise ValueError(
                f"slot_range {slot_range} out of bounds for a "
                f"{n_slots}-slot ring"
            )
        self._lock = threading.Lock()
        self._free = list(range(lo, hi))
        self._zombies: set = set()

    # -- slot bookkeeping --------------------------------------------------
    def _acquire(self, deadline: float) -> int:
        while True:
            with self._lock:
                # Reclaim zombies whose server-side work has finished:
                # a RESPONSE (or re-FREE) state means nobody is writing.
                for z in list(self._zombies):
                    off, _ = _slot_offsets(z, self.slot_bytes)
                    (state,) = _U32.unpack_from(self._shm.buf, off)
                    if state in (_RESPONSE, _FREE):
                        _U32.pack_into(self._shm.buf, off, _FREE)
                        self._zombies.discard(z)
                        self._free.append(z)
                if self._free:
                    return self._free.pop()
            if time.monotonic() > deadline:
                raise DeadlineExceededError(
                    "DEADLINE_EXCEEDED: no free ingress slot before the "
                    "deadline"
                )
            time.sleep(_MIN_POLL_S)

    # -- scoring -----------------------------------------------------------
    def score_many(
        self, requests: Sequence[dict], timeout_s: float = 30.0
    ) -> list:
        """Encode JSON-shaped requests, ride the ring, decode results —
        the same per-row result dicts the HTTP paths return."""
        frame = wire_mod.encode_request(requests)
        return self._roundtrip(frame, timeout_s)

    def score(self, request: dict, timeout_s: float = 30.0) -> dict:
        return self.score_many([request], timeout_s=timeout_s)[0]

    def _roundtrip(self, frame: bytes, timeout_s: float) -> list:
        if len(frame) > self.slot_bytes:
            raise ShmIngressError(
                f"request frame ({len(frame)} bytes) exceeds the "
                f"{self.slot_bytes}-byte slot; split the batch or size "
                "the ring larger"
            )
        deadline = time.monotonic() + timeout_s
        i = self._acquire(deadline)
        buf = self._shm.buf
        off, data_off = _slot_offsets(i, self.slot_bytes)
        (_state, seq, _len, _res,
         _tw, _sw, _fl) = _SLOT_HEADER.unpack_from(buf, off)
        seq = (seq + 1) & 0xFFFFFFFF
        buf[data_off:data_off + len(frame)] = frame
        # Trace-context words ride the slot header (before the state
        # flip, like the payload): the server parents its handling spans
        # to this caller's span.  No active trace writes zeros.
        pctx = telemetry_mod.current().propagation_context()
        words = pctx.to_words() if pctx is not None else (0, 0, 0)
        _TRACE_WORDS.pack_into(buf, off + 16, *words)
        _U32.pack_into(buf, off + 8, len(frame))
        _U32.pack_into(buf, off + 4, seq)
        _U32.pack_into(buf, off, _REQUEST)
        backoff = _MIN_POLL_S
        try:
            while True:
                (state,) = _U32.unpack_from(buf, off)
                if state == _RESPONSE:
                    (seq_r,) = _U32.unpack_from(buf, off + 4)
                    if seq_r == seq:
                        (length,) = _U32.unpack_from(buf, off + 8)
                        payload = bytes(
                            buf[data_off:data_off
                                + min(length, self.slot_bytes)]
                        )
                        _U32.pack_into(buf, off, _FREE)
                        with self._lock:
                            self._free.append(i)
                        return wire_mod.decode_response(payload)
                if time.monotonic() > deadline:
                    # The server may still be scoring this slot; park it
                    # as a zombie and reclaim once a response lands.
                    with self._lock:
                        self._zombies.add(i)
                    raise DeadlineExceededError(
                        f"DEADLINE_EXCEEDED: no ingress response within "
                        f"{timeout_s:.3f}s"
                    )
                time.sleep(backoff)
                backoff = min(backoff * 2, _MAX_POLL_S)
        except ShmIngressError:
            with self._lock:
                self._free.append(i)
            raise

    def close(self) -> None:
        try:
            self._shm.close()
        except (OSError, BufferError):
            pass
