"""Bounded-depth background prefetch for host→device chunk streams (port of
``photon_ml_tpu/data/prefetch.py``).

A three-stage software pipeline, as in the reference:

    pack thread:      get_item(k) ──bounded hand-off queue──►
    transfer thread:  put(item) → [wait for the copy to complete] ──►
    caller thread:    queue → consume(k, dev) → release permit

Pack and transfer are separate threads, so chunk k+1's host copy runs
while chunk k's bytes cross the link.  A hand-off queue of ``depth`` items
bounds how far the packer runs ahead, and a semaphore of ``depth`` permits
bounds the device items that are live (transferred, not yet consumed):
``depth=2`` is the double buffer, ``depth=1`` serialises transfer and
compute (the measurement baseline).

On the card, :class:`HostToDevice` supplies the three stages:

- ``pack`` (pack thread) copies an item's numpy arrays into one of a ring
  of ``depth`` pinned host slots, one pinned buffer per dtype sized to the
  largest item (pinning every chunk every pass would cost more than the
  copy, and memmap leaves cannot be pinned).  These are a few large
  ``np.copyto`` calls, which release the interpreter lock.  A slot is
  reused only after the event of its last copy has completed;
- ``put`` (transfer thread) issues one ``copy_(non_blocking=True)`` per
  dtype on a dedicated copy stream, between two timing events; the
  transfer thread then waits for the end event (so ``depth`` bounds the
  bytes in flight and the time is the copy's own), and frees the slot;
- ``ready`` (caller thread) makes the compute stream wait on that event
  and records the buffers as used by the compute stream
  (``record_stream``), so the caching allocator cannot hand their memory
  to a later chunk's copy while kernels still read it.

On the CPU the same pipeline runs with a plain host copy as its transfer.

Over a process group each rank runs its own pipeline over its own items:
a rank's store holds only its shard of every chunk (``data/streaming.py``)
and an out-of-core random effect's pass group only the rank's part of
each slice, so the pinned ring, the copies and :class:`TransferStats`
(its bytes included) are that rank's.

Every transfer is timed to completion, and :class:`TransferStats`
attributes wall time to the stages as the reference defines them
(``pack_seconds``, ``dispatch_seconds`` ⊂ ``h2d_seconds``,
``consume_seconds``, the two stall counters), plus a third stall counter
for the pack's wait on a free pinned slot, which ``pack_seconds`` leaves
out so that it is the host copy alone; on the card
``h2d_device_seconds`` is the copies' time between their CUDA events on
the copy stream, and :attr:`TransferStats.gbps` is measured against it.

Each pass publishes its :class:`TransferStats` DELTAS to the process
telemetry hub (``h2d_bytes_total``, ``h2d_chunks_total``, the stage
seconds and stalls, a ``prefetch.pass`` event) and keeps the
``hbm_live_bytes`` / ``prefetch_ring_occupancy_ratio`` gauges current,
all from host bookkeeping (no device read).  The ``prefetch.pack`` and
``prefetch.transfer`` fault sites fire before each item's pack and put.
"""

from __future__ import annotations

import dataclasses
import queue
import sys
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch import chaos as chaos_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.data.staging import torch_dtype

#: how long the caller waits for the background threads after a pass (a
#: healthy pipeline joins in microseconds; this bounds a wedged thread).
JOIN_TIMEOUT_SECONDS = 30.0

_POLL_SECONDS = 0.05

#: elements each array of an item is aligned to inside its slot (256 bytes
#: for 4-byte dtypes).
ALIGN = 64


@dataclasses.dataclass
class TransferStats:
    """Cumulative host→device transfer observability for one stream,
    aggregated across passes (``reset()`` between measurement windows)."""

    chunks: int = 0  # transfers completed
    bytes: int = 0  # wire bytes moved (what crossed the link)
    logical_bytes: int = 0  # decoded bytes those transfers stand for
    pack_seconds: float = 0.0  # summed get_item wall less slot waits
    pack_stalls: int = 0  # pack waited for a free pinned slot
    pack_stall_seconds: float = 0.0
    dispatch_seconds: float = 0.0  # summed put() call wall (⊂ h2d_seconds)
    h2d_seconds: float = 0.0  # summed transfer wall, dispatch to completion
    h2d_device_seconds: float = 0.0  # summed copy time between CUDA events
    consume_seconds: float = 0.0  # summed consume() wall (compute stage)
    producer_stalls: int = 0  # transfer waited for a free permit
    producer_stall_seconds: float = 0.0
    consumer_stalls: int = 0  # compute waited for a transfer
    consumer_stall_seconds: float = 0.0
    passes: int = 0  # completed pipeline runs
    max_live: int = 0  # high-water of concurrently live device items
    max_live_bytes: int = 0  # high-water of live device bytes

    @property
    def gbps(self) -> float:
        """Achieved host→device rate in GB/s of wire bytes: over the CUDA
        events' copy time on the card, over the transfer wall elsewhere."""
        secs = self.h2d_device_seconds or self.h2d_seconds
        return self.bytes / secs / 1e9 if secs else 0.0

    @property
    def compression_ratio(self) -> float:
        """logical/wire bytes over everything recorded (1.0 = raw)."""
        return self.logical_bytes / self.bytes if self.bytes else 1.0

    @property
    def stage_seconds(self) -> float:
        """Summed wall across the three stages; above a pass's wall time,
        the stages overlapped (dispatch is inside h2d, not counted
        twice)."""
        return self.pack_seconds + self.h2d_seconds + self.consume_seconds

    def snapshot(self) -> dict:
        d = dataclasses.asdict(self)
        d["gbps"] = self.gbps
        d["stage_seconds"] = self.stage_seconds
        d["compression_ratio"] = self.compression_ratio
        return d

    def reset(self) -> None:
        for f in dataclasses.fields(self):
            setattr(self, f.name, f.default)


class _Packed:
    """One item in a pinned slot: per dtype the slot's pinned buffer and
    the elements used, per array its (dtype, offset, shape), and the
    seconds the pack waited for the slot."""

    __slots__ = ("slot", "totals", "index", "nbytes", "stall_seconds")

    def __init__(self, slot, totals, index, nbytes, stall_seconds):
        self.slot = slot
        self.totals = totals
        self.index = index
        self.nbytes = nbytes
        self.stall_seconds = stall_seconds


class _InFlight:
    """An item whose copies were issued on the copy stream; ``wait()``
    blocks until they completed, frees the pinned slot and returns the
    copies' time between their events."""

    __slots__ = ("tensors", "bases", "event", "_start", "_ring", "_slot")

    def __init__(self, tensors, bases, start, event, ring, slot):
        self.tensors = tensors
        self.bases = bases
        self._start = start
        self.event = event
        self._ring = ring
        self._slot = slot

    def wait(self) -> float:
        self.event.synchronize()
        self._ring._release(self._slot)
        return self._start.elapsed_time(self.event) / 1e3


class HostToDevice:
    """The pack / put / ready stages of a chunk stream to ``device``.

    An item is a sequence of numpy arrays; the consumer receives torch
    tensors of the same shapes and dtypes, views into one device buffer per
    dtype (on the CPU, host copies).  The ring of ``depth`` pinned slots
    and the copy stream live as long as this object, across passes.  Call
    :meth:`begin_pass` before each pass with the pass's abort flag."""

    def __init__(self, device: torch.device, depth: int):
        self.device = torch.device(device)
        self.depth = int(depth)
        self.cuda = self.device.type == "cuda"
        self._slots = [dict() for _ in range(self.depth)]  # dtype → pinned
        self._free = [threading.Semaphore(1) for _ in range(self.depth)]
        self._next = 0
        self._abort: Optional[threading.Event] = None
        self.copy_stream = (torch.cuda.Stream(device=self.device)
                            if self.cuda else None)

    def begin_pass(self, abort: threading.Event) -> None:
        """Reset the ring: nothing of an earlier pass (a pass that failed
        midway included) may still read a slot."""
        if self.cuda:
            self.copy_stream.synchronize()
        self._free = [threading.Semaphore(1) for _ in range(self.depth)]
        self._next = 0
        self._abort = abort

    def _release(self, slot: int) -> None:
        self._free[slot].release()

    def _acquire(self, slot: int) -> Optional[float]:
        """Take ``slot``: the seconds waited for it (0.0 when it was free),
        or None when the pass aborted meanwhile."""
        if self._free[slot].acquire(blocking=False):
            return 0.0
        t0 = time.perf_counter()
        while not self._free[slot].acquire(timeout=_POLL_SECONDS):
            if self._abort is not None and self._abort.is_set():
                return None
        return time.perf_counter() - t0

    @staticmethod
    def layout(specs) -> tuple[dict, list]:
        """Where an item's arrays, given as ``(shape, dtype)`` pairs, sit
        in its slot: per dtype the elements used, per array its (dtype,
        offset, shape).  Each array starts at a multiple of ``ALIGN``
        elements, so its device view is as aligned as a fresh allocation
        whatever precedes it in the item."""
        totals: dict = {}
        index = []
        for shape, dtype in specs:
            dt = np.dtype(dtype)
            off = -(-totals.get(dt, 0) // ALIGN) * ALIGN
            index.append((dt, off, tuple(shape)))
            totals[dt] = off + int(np.prod(shape, dtype=np.int64))
        return totals, index

    def reserve(self, totals: dict) -> None:
        """Allocate every slot's pinned buffers for items of up to
        ``totals`` elements a dtype, before a pass (the pack would otherwise
        grow them mid-pass, one pinned allocation each time)."""
        if not self.cuda:
            return
        for bufs in self._slots:
            for dt, n in totals.items():
                dt = np.dtype(dt)
                have = bufs.get(dt)
                if have is None or have.numel() < n:
                    bufs[dt] = torch.empty(max(int(n), 1),
                                           dtype=torch_dtype(dt),
                                           pin_memory=True)

    # -- pack thread ---------------------------------------------------------
    def pack(self, arrays):
        """Copy an item's arrays into the next pinned slot (on the card),
        or hand them on as they are (CPU)."""
        if not self.cuda:
            return list(arrays)
        slot = self._next
        self._next = (slot + 1) % self.depth
        stall = self._acquire(slot)
        if stall is None:
            raise RuntimeError("prefetch pipeline aborted while packing")
        totals, index = self.layout([(a.shape, a.dtype) for a in arrays])
        nbytes = int(sum(a.nbytes for a in arrays))
        bufs = self._slots[slot]
        for dt, n in totals.items():
            have = bufs.get(dt)
            if have is None or have.numel() < n:
                bufs[dt] = torch.empty(max(n, 1), dtype=torch_dtype(dt),
                                       pin_memory=True)
        for a, (dt, off, _) in zip(arrays, index):
            np.copyto(bufs[dt].numpy()[off:off + a.size], a.reshape(-1),
                      casting="no")
        return _Packed(slot, totals, index, nbytes, stall)

    # -- transfer thread -----------------------------------------------------
    def put(self, packed):
        """Issue the item's copies (one per dtype) on the copy stream; on
        the CPU, copy the arrays into torch tensors."""
        if not self.cuda:
            return [torch.from_numpy(np.array(a)) for a in packed]
        bufs = self._slots[packed.slot]
        with torch.cuda.device(self.device), \
                torch.cuda.stream(self.copy_stream):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record(self.copy_stream)
            bases = {}
            for dt, n in packed.totals.items():
                dev = torch.empty(n, dtype=torch_dtype(dt),
                                  device=self.device)
                dev.copy_(bufs[dt][:n], non_blocking=True)
                bases[dt] = dev
            end.record(self.copy_stream)
        tensors = [bases[dt][off:off + int(np.prod(shape, dtype=np.int64))]
                   .view(shape) for dt, off, shape in packed.index]
        return _InFlight(tensors, list(bases.values()), start, end, self,
                         packed.slot)

    # -- caller thread -------------------------------------------------------
    def ready(self, item) -> list:
        """The item's device tensors, safe to use on the current stream."""
        if not self.cuda:
            return item
        stream = torch.cuda.current_stream(self.device)
        stream.wait_event(item.event)
        for base in item.bases:
            base.record_stream(stream)
        return item.tensors


def item_nbytes(item) -> int:
    """Host bytes of a packed item (what its transfer moves)."""
    if isinstance(item, _Packed):
        return item.nbytes
    return int(sum(getattr(a, "nbytes", 0) for a in item))


class _ProducerFailure:
    __slots__ = ("exc",)

    def __init__(self, exc: BaseException):
        self.exc = exc


def _publish_pass(stats: TransferStats, before: tuple, run_max: int,
                  run_max_bytes: int = 0) -> None:
    """Feed this pass's TransferStats DELTAS into the process telemetry
    registry: counters accumulate across every stream of the process
    because each pass adds only its own delta; gauges carry the LAST
    pass's rates.  One call a pass, nothing a chunk."""
    tel = telemetry_mod.current()
    if not tel.enabled:
        return
    (bytes0, h2d0, chunks0, cs0, css0, ps0, pss0,
     pack0, disp0, cons0, logical0) = before
    d_bytes = stats.bytes - bytes0
    d_logical = stats.logical_bytes - logical0
    d_h2d = stats.h2d_seconds - h2d0
    d_chunks = stats.chunks - chunks0
    d_pack = stats.pack_seconds - pack0
    d_disp = stats.dispatch_seconds - disp0
    d_cons = stats.consume_seconds - cons0
    tel.counter("h2d_bytes_total").inc(d_bytes)
    # Wire vs logical split (compressed chunk formats): h2d_bytes_total
    # and h2d_gbps stay wire-denominated, the link's own measurement.
    tel.counter("stream_wire_bytes_total").inc(d_bytes)
    tel.counter("stream_logical_bytes_total").inc(d_logical)
    tel.counter("h2d_chunks_total").inc(d_chunks)
    tel.counter("h2d_seconds").inc(d_h2d)
    tel.counter("prefetch_pack_seconds").inc(d_pack)
    tel.counter("prefetch_dispatch_seconds").inc(d_disp)
    tel.counter("prefetch_consume_seconds").inc(d_cons)
    tel.counter("consumer_stalls").inc(stats.consumer_stalls - cs0)
    tel.counter("consumer_stall_seconds").inc(
        stats.consumer_stall_seconds - css0)
    tel.counter("producer_stalls").inc(stats.producer_stalls - ps0)
    tel.counter("producer_stall_seconds").inc(
        stats.producer_stall_seconds - pss0)
    tel.counter("prefetch_passes").inc()
    if d_h2d > 0.0:
        tel.gauge("h2d_gbps").set(d_bytes / d_h2d / 1e9)
    if d_bytes > 0:
        tel.gauge("stream_compression_ratio").set(d_logical / d_bytes)
    if d_chunks > 0:
        tel.gauge("h2d_chunk_seconds").set(d_h2d / d_chunks)
        tel.gauge("prefetch_pack_chunk_seconds").set(d_pack / d_chunks)
        tel.gauge("prefetch_dispatch_chunk_seconds").set(d_disp / d_chunks)
        tel.gauge("prefetch_consume_chunk_seconds").set(d_cons / d_chunks)
    tel.gauge("prefetch_max_live").set(run_max)
    # The pass's high-water of transferred-not-yet-consumed device bytes.
    tel.gauge("hbm_live_peak_bytes").set(run_max_bytes)
    tel.event(
        "prefetch.pass",
        chunks=d_chunks,
        bytes=d_bytes,
        h2d_seconds=round(d_h2d, 6),
        pack_seconds=round(d_pack, 6),
        dispatch_seconds=round(d_disp, 6),
        consume_seconds=round(d_cons, 6),
        logical_bytes=d_logical,
        consumer_stalls=stats.consumer_stalls - cs0,
        producer_stalls=stats.producer_stalls - ps0,
        max_live=run_max,
        max_live_bytes=run_max_bytes,
    )


def run_prefetched(
    n_items: int,
    get_item: Callable[[int], object],
    put: Callable[[object], object],
    consume: Callable[[int, object], None],
    depth: int = 2,
    stats: TransferStats | None = None,
    logical_nbytes: Callable[[int], int] | None = None,
    abort: threading.Event | None = None,
) -> int:
    """Stream ``n_items`` through the bounded-depth three-stage pipeline.

    ``get_item(k)`` runs on the pack thread, ``put(item)`` on the transfer
    thread, ``consume(k, dev)`` on the caller's thread, strictly in order.
    When ``put`` returns an object with a ``wait()`` method, the transfer
    thread calls it to wait for the copy to complete and adds what it
    returns (device seconds) to ``stats.h2d_device_seconds``; when
    ``get_item`` returns one with a ``stall_seconds`` attribute (the wait
    for a pinned slot), that wait counts as a pack stall, not as pack
    time.  Returns this
    run's high-water of live device items (≤ ``depth``).

    Pack or transfer exceptions re-raise on the caller's thread at the
    failed item's position; a consumer exception sets ``abort`` (a fresh
    event unless the caller passes the one its stages poll), which winds
    both threads down.  ``logical_nbytes(k)``: the decoded bytes item ``k``
    stands for, when the items are compressed wire buffers."""
    if depth < 1:
        raise ValueError(f"prefetch depth must be >= 1, got {depth}")
    if stats is None:
        stats = TransferStats()
    if n_items == 0:
        stats.passes += 1
        return 0
    stats_before = (
        stats.bytes, stats.h2d_seconds, stats.chunks,
        stats.consumer_stalls, stats.consumer_stall_seconds,
        stats.producer_stalls, stats.producer_stall_seconds,
        stats.pack_seconds, stats.dispatch_seconds, stats.consume_seconds,
        stats.logical_bytes,
    )

    handoff: queue.Queue = queue.Queue(maxsize=depth)
    q: queue.Queue = queue.Queue()
    permits = threading.Semaphore(depth)
    if abort is None:
        abort = threading.Event()
    live_lock = threading.Lock()
    live = [0, 0]  # items, bytes
    run_max = [0, 0]
    # Gauges resolved once a pass (no-op metrics on a disabled hub): the
    # device bytes this pipeline pins and how full the ring is.
    tel = telemetry_mod.current()
    ctx = tel.current_context()
    g_live = tel.gauge("hbm_live_bytes")
    g_occ = tel.gauge("prefetch_ring_occupancy_ratio")

    def _bump(delta: int, nbytes: int) -> None:
        with live_lock:
            live[0] += delta
            live[1] += nbytes
            run_max[0] = max(run_max[0], live[0])
            run_max[1] = max(run_max[1], live[1])
            lb, occ = live[1], live[0] / depth
        g_live.set(lb)
        g_occ.set(occ)

    def _handoff_put(item) -> bool:
        while not abort.is_set():
            try:
                handoff.put(item, timeout=_POLL_SECONDS)
                return True
            except queue.Full:
                pass
        return False

    def _packer() -> None:
        # The attached context parents this thread's span under the
        # caller's, so the trace nests the pack track inside the solve.
        try:
            with tel.attach(ctx), tel.span("prefetch.pack_stage",
                                           items=n_items):
                for k in range(n_items):
                    if abort.is_set():
                        return
                    chaos_mod.maybe_fail("prefetch.pack", item=k)
                    t0 = time.perf_counter()
                    host = get_item(k)
                    stall = getattr(host, "stall_seconds", 0.0)
                    stats.pack_seconds += time.perf_counter() - t0 - stall
                    if stall:
                        stats.pack_stalls += 1
                        stats.pack_stall_seconds += stall
                    nbytes = item_nbytes(host)
                    lb = logical_nbytes(k) if logical_nbytes else nbytes
                    if not _handoff_put((k, host, nbytes, lb)):
                        return
                    del host
        except BaseException as exc:  # surfaced on the caller's thread
            # In order: the failure rides the hand-off queue behind the
            # items that packed, so the consumer sees 0..k-1, then it.
            _handoff_put(_ProducerFailure(exc))

    def _transfer() -> None:
        try:
            with tel.attach(ctx), tel.span("prefetch.transfer_stage",
                                           items=n_items):
                for _ in range(n_items):
                    item = None
                    while not abort.is_set():
                        try:
                            item = handoff.get(timeout=_POLL_SECONDS)
                            break
                        except queue.Empty:
                            pass
                    if item is None:
                        return
                    if isinstance(item, _ProducerFailure):
                        q.put(item)
                        return
                    k, host, nbytes, lb = item
                    if not permits.acquire(blocking=False):
                        t0 = time.perf_counter()
                        while not permits.acquire(timeout=_POLL_SECONDS):
                            if abort.is_set():
                                return
                        stats.producer_stalls += 1
                        stats.producer_stall_seconds += (
                            time.perf_counter() - t0)
                    if abort.is_set():
                        return
                    chaos_mod.maybe_fail("prefetch.transfer", item=k)
                    t0 = time.perf_counter()
                    dev = put(host)
                    stats.dispatch_seconds += time.perf_counter() - t0
                    wait = getattr(dev, "wait", None)
                    if wait is not None:
                        stats.h2d_device_seconds += wait()
                    stats.h2d_seconds += time.perf_counter() - t0
                    stats.bytes += nbytes
                    stats.logical_bytes += lb
                    stats.chunks += 1
                    _bump(+1, nbytes)
                    q.put((k, dev, nbytes))
                    del dev, host, item
        except BaseException as exc:  # surfaced on the caller's thread
            q.put(_ProducerFailure(exc))

    packer = threading.Thread(target=_packer, name="h2d-pack", daemon=True)
    transfer = threading.Thread(target=_transfer, name="h2d-prefetch",
                                daemon=True)
    packer.start()
    transfer.start()
    try:
        for _ in range(n_items):
            if q.empty():
                t0 = time.perf_counter()
                item = q.get()
                stats.consumer_stalls += 1
                stats.consumer_stall_seconds += time.perf_counter() - t0
            else:
                item = q.get()
            if isinstance(item, _ProducerFailure):
                raise item.exc
            k, dev, nbytes = item
            t0 = time.perf_counter()
            consume(k, dev)
            stats.consume_seconds += time.perf_counter() - t0
            # Drop the device reference before releasing the permit: the
            # permit accounting bounds live device memory.
            del dev, item
            _bump(-1, -nbytes)
            permits.release()
    except BaseException:
        abort.set()
        raise
    finally:
        packer.join(timeout=JOIN_TIMEOUT_SECONDS)
        transfer.join(timeout=JOIN_TIMEOUT_SECONDS)
        leaked = [t.name for t in (packer, transfer) if t.is_alive()]
        if leaked:
            # A wedged thread outliving its pass pins chunk buffers: count
            # it, and raise when the pass was otherwise about to succeed
            # (a failure already propagating keeps priority).
            tel.counter("prefetch_thread_leak").inc(len(leaked))
            tel.event("prefetch.thread_leak", threads=leaked)
        if leaked and sys.exc_info()[0] is None:
            raise RuntimeError(
                f"prefetch pipeline thread(s) {leaked} still alive after "
                f"join(timeout={JOIN_TIMEOUT_SECONDS}s): a blocking call "
                "(get_item/put/transfer wait) never returned; the pass's "
                "results cannot be trusted to be complete"
            )
        while True:  # drop any queued device references
            try:
                q.get_nowait()
            except queue.Empty:
                break
    stats.passes += 1
    stats.max_live = max(stats.max_live, run_max[0])
    stats.max_live_bytes = max(stats.max_live_bytes, run_max[1])
    _publish_pass(stats, stats_before, run_max[0], run_max[1])
    return run_max[0]
