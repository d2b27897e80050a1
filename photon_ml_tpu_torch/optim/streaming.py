"""Out-of-core GLM training: stream host chunks through the card per pass
(port of ``photon_ml_tpu/optim/streaming.py``).

When the dataset does not fit on the card, the solver's outer loop runs on
the host (the reference's driver-side Breeze L-BFGS) and each objective
evaluation is one full pass over the chunk store (its ``treeAggregate``):

    pack thread:     copy chunk k+2's staging buffers into a pinned slot ──►
    transfer thread: chunk k+1 ──one copy a dtype, copy stream──► card
    caller thread:   chunk k ──decode + SpMV kernels──► (value, grad) +=

Each chunk crosses as a few dtype-segregated staging buffers
(``data/staging.py``) through :class:`~photon_ml_tpu_torch.data.prefetch.HostToDevice`
(``prefetch_depth`` pinned slots, a copy stream, an event a chunk), and the
caller runs the chunk's kernels on the compute stream once that stream has
waited on the chunk's event.  Chunks accumulate strictly in order, one
in-place ``add_`` each, into preallocated accumulators, so results are
bitwise the same at any ``prefetch_depth``, under ``chunk_fuse`` (a Python
loop over a group of chunks that crossed in one transfer), from a disk
store, under lossless compression and with the hot cache.  The caller
syncs on a window of ``prefetch_depth`` chunk events behind the newest, so
the card holds O(``prefetch_depth``) chunks whatever the dataset size.
``accumulate="kahan"`` carries a compensation term for the value and one
for the gradient.

The port's solvers are host loops over callables already, so the streamed
grid runs the registry's own L-BFGS, OWL-QN and TRON with one streamed pass
an evaluation (TRON: one streamed HVP pass a CG step).  The reference keeps
separate streamed solvers only because its resident ones are device
``while_loop``s that cannot call host code.  A batched trial runs each
candidate through the same launches on the same transferred chunk as a
single evaluation, so ``value_and_grad_batch`` row i is bitwise
``value_and_grad(w_i)``, and the line searches' batched forms
(``linesearch.wolfe_line_search``, ``owlqn.owlqn_solve``) take the
one-trial-per-pass trajectory exactly in fewer passes.

**Over a process group** (``mesh``, a
:class:`~photon_ml_tpu_torch.parallel.distributed.DataGroup`), every rank
streams its own shard of each chunk (a store built with the same ``mesh``,
``data/streaming.py``) through its own card and accumulates its own
partial sums; a pass ends in ONE fused all-reduce of ``[value, grad]``
(of every candidate's, for a batched trial; TRON's HVP pass one more), the
streamed counterpart of the reference's psum.  Every rank then holds the
same reduced numbers, so every solver decision agrees.  A store that keeps
all k shards (``mesh=None``) is k LOGICAL shards: each shard accumulates
apart and the shards' sums are added in shard order, so a group of two
ranks gives the bits of two logical shards; more than two ranks sum in the
backend's order, which may differ between buffers of different lengths,
so there a batched trial's row equals its single pass to rounding only.
Under a group that spans several hosts a rank streams a store of its own
``host_local_rows`` instead (``row_block``).

Every pass publishes the reference's per-pass telemetry (one logical
all-reduce round, the staged-window and hot-cache gauges, the effective
ingest rate) from host bookkeeping only, and the reference's fault sites
sit at its places: ``staging.put`` before each transfer,
``staging.decode`` (compressed items) and ``streaming.carry_sync`` before
each item's dispatch, ``streaming.cache_evict`` at the cache's replan
(which clears the cache before the fault propagates).
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch import chaos as chaos_mod
from photon_ml_tpu_torch import telemetry as telemetry_mod
from photon_ml_tpu_torch.data.prefetch import (
    HostToDevice,
    TransferStats,
    run_prefetched,
)
from photon_ml_tpu_torch.data.staging import (
    COMPRESSION_MODES,
    plan_compression,
)
from photon_ml_tpu_torch.data.streaming import StreamingGlmData
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops import ordered
from photon_ml_tpu_torch.optim.objective import GlmObjective
from photon_ml_tpu_torch.parallel.distributed import reduce_shards

Tensor = torch.Tensor


def check_stream_mesh(stream: StreamingGlmData, mesh) -> None:
    """The reference's guards on a store and a group: a rank streams the
    shard the group gives it; a store without shards is refused with a
    group, and a rank's store without one."""
    if mesh is None:
        if stream.held is not None or stream.row_block is not None:
            raise ValueError(
                "sharded chunks need a mesh: this store holds one rank's "
                "part of each chunk")
        return
    if stream.row_block is not None:
        return  # a rank's host-local rows under a group of several hosts
    if stream.held is None:
        if stream.n_shards == 1:
            raise ValueError(
                "single-shard chunks carry no shard axis: a group needs a "
                "store built with mesh= (one shard a rank); pass mesh=None "
                "for a single-device stream")
        raise ValueError(
            f"this store holds all {stream.n_shards} logical shards; a "
            "rank of a group streams a store built with mesh=")
    if stream.n_shards != mesh.size or stream.held != (mesh.rank,):
        raise ValueError(
            f"stream has n_shards={stream.n_shards} holding "
            f"{stream.held}; rank {mesh.rank} of this group needs "
            f"{mesh.size} shards holding ({mesh.rank},)")


# ---------------------------------------------------------------------------
# Importance-aware working set: hot chunks skip pack and transfer
# ---------------------------------------------------------------------------


class HotChunkCache:
    """Byte-budgeted resident working set of streamed items.

    Keeps the most influential items resident on the card and streams only
    the cold tail (DuHL, arXiv:1708.05357).  Importance is re-derived each
    value pass from the items' own contributions to the value (|value| of
    the item's chunks, read once at the end of the pass).  A hot hit hands
    the consumer the item's device tensors directly, skipping pack and
    transfer; the same code serves hot and cold items in their global
    order, so results stay bitwise those of the uncached stream.

    Admission is one pass deferred: pass N's scores pick the wanted set
    (:meth:`replan`), pass N+1 admits those items as they stream by, pass
    N+2 onward hits.  Ties break by item index, so admission is
    deterministic.  The lock guards bookkeeping only; evicted device
    references are dropped outside it."""

    def __init__(self, budget_bytes: int):
        self.budget_bytes = int(budget_bytes)
        self._lock = threading.Lock()
        self._entries: dict = {}  # item index -> (device tensors, nbytes)
        self._want: set = set()
        self._bytes = 0
        self.hits = 0
        self.misses = 0
        self.admissions = 0
        self.evictions = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._entries)

    @property
    def resident_bytes(self) -> int:
        with self._lock:
            return self._bytes

    def get(self, i: int):
        """Resident device tensors of item ``i``, or None (counted)."""
        with self._lock:
            e = self._entries.get(i)
            if e is None:
                self.misses += 1
                return None
            self.hits += 1
            return e[0]

    def maybe_admit(self, i: int, dev, nbytes: int) -> bool:
        """Admit item ``i``'s just-transferred tensors iff the last replan
        wants it and it fits the remaining budget."""
        with self._lock:
            if i in self._entries or i not in self._want:
                return False
            if self._bytes + int(nbytes) > self.budget_bytes:
                return False
            self._entries[i] = (dev, int(nbytes))
            self._bytes += int(nbytes)
            self.admissions += 1
            return True

    def clear(self) -> None:
        """Drop every resident item and the wanted set."""
        with self._lock:
            dropped = list(self._entries.values())
            self._entries.clear()
            self._want = set()
            self._bytes = 0
        del dropped  # device references released outside the lock

    def replan(self, scores: dict, item_nbytes: Callable[[int], int]):
        """Recompute the wanted set from this pass's scores (greedy by
        descending score, ties by ascending index, until the budget is
        spent) and evict residents that fell out of it.  On an injected
        eviction fault the cache is CLEARED before the fault propagates:
        a half-applied plan never survives into the next pass (which then
        streams everything; results are unaffected)."""
        try:
            chaos_mod.maybe_fail("streaming.cache_evict")
        except BaseException:
            self.clear()
            raise
        dropped = []
        with self._lock:
            want: set = set()
            budget = self.budget_bytes
            for i in sorted(scores, key=lambda j: (-scores[j], j)):
                nb = int(item_nbytes(i))
                if nb <= budget:
                    want.add(i)
                    budget -= nb
            self._want = want
            for i in [j for j in self._entries if j not in want]:
                dev, nb = self._entries.pop(i)
                self._bytes -= nb
                self.evictions += 1
                dropped.append(dev)
        del dropped  # device references released outside the lock


# ---------------------------------------------------------------------------
# Streamed objective: value+grad as one pass over host chunks
# ---------------------------------------------------------------------------


def _kahan_add(acc: Tensor, comp: Tensor, x: Tensor) -> None:
    """acc += x with compensation ``comp``, in place (Kahan)."""
    y = x - comp
    t = acc + y
    comp.copy_((t - acc) - y)
    acc.copy_(t)


class StreamingObjective:
    """A GLM objective evaluated by streaming host chunks through the card.

    ``accumulate``: "f32" adds chunk contributions directly; "kahan" carries
    a compensation term per accumulator (value and gradient), so the
    cross-chunk summation error stays O(ε) instead of O(n_chunks·ε).  The
    value accumulates in the objective's value dtype (float64 under
    ``GlmObjective(accumulate="f64")``).

    ``prefetch_depth`` chunks are in flight (pinned slots, device items and
    the compute window each); 1 serialises transfer and compute.
    ``chunk_fuse > 1`` moves that many chunks in one transfer and runs them
    in one consumer step, in order.  ``compress`` (off|lossless|fp16|int8)
    moves encoded wire buffers, decoded on the card; "lossless" keeps every
    result bitwise.  ``hot_budget_bytes > 0`` keeps up to that many bytes
    of transferred items resident across passes (:class:`HotChunkCache`;
    ``scores()`` always streams).  ``transfer_stats`` accumulates the
    per-stage times, bytes and stalls across passes.  The objective runs on
    the device the store was built for."""

    def __init__(
        self,
        task_or_objective,
        stream: StreamingGlmData,
        normalization=None,
        mesh=None,
        accumulate: str = "f32",
        prefetch_depth: int = 2,
        chunk_fuse: int = 1,
        compress: str = "off",
        hot_budget_bytes: int = 0,
    ):
        from photon_ml_tpu_torch.ops import losses as losses_lib

        if isinstance(task_or_objective, GlmObjective):
            self.objective = task_or_objective
        else:
            self.objective = GlmObjective(losses_lib.get(task_or_objective),
                                          normalization)
        if accumulate not in ("f32", "kahan"):
            raise ValueError(f"accumulate must be f32|kahan, got {accumulate}")
        if prefetch_depth < 1:
            raise ValueError(
                f"prefetch_depth must be >= 1, got {prefetch_depth}")
        if chunk_fuse < 1:
            raise ValueError(f"chunk_fuse must be >= 1, got {chunk_fuse}")
        if chunk_fuse > 1 and mesh is not None:
            raise ValueError(
                "chunk_fuse > 1 is single-device only: pass chunk_fuse=1 "
                "with a mesh")
        if compress not in COMPRESSION_MODES:
            raise ValueError(
                f"compress must be one of {COMPRESSION_MODES}, got "
                f"{compress!r}")
        if hot_budget_bytes < 0:
            raise ValueError(
                f"hot_budget_bytes must be >= 0, got {hot_budget_bytes}")
        if hot_budget_bytes and mesh is not None:
            from photon_ml_tpu_torch.parallel.multihost import spans_hosts

            if spans_hosts(mesh):
                raise ValueError(
                    "the hot working-set cache is single-host only: pass "
                    "hot_budget_bytes=0 under a group of several hosts")
        check_stream_mesh(stream, mesh)
        self.mesh = mesh
        self.stream = stream
        self.device = resolve_device(stream.device)
        self.accumulate = accumulate
        self.prefetch_depth = int(prefetch_depth)
        self.chunk_fuse = int(chunk_fuse)
        self.compress = compress
        self.hot_budget_bytes = int(hot_budget_bytes)
        self.transfer_stats = TransferStats()
        if not stream.ensure_staged() and (
                chunk_fuse > 1 or compress != "off" or hot_budget_bytes):
            raise ValueError(
                "chunk_fuse > 1, compress and hot_budget_bytes need the "
                "staged (coalesced-buffer) representation; this store could "
                "not be staged (a hand-built disk-backed store?)")
        # Items are groups of parts: a chunk's held shard parts, times
        # chunk_fuse chunks.
        n_ch = stream.n_chunks
        self._n_held = nh = len(stream.held_shards)
        fuse = min(self.chunk_fuse, max(n_ch, 1))
        self._groups = [range(lo * nh, min(lo + fuse, n_ch) * nh)
                        for lo in range(0, n_ch, fuse)]
        # Compressed wire formats: one codec a part (each part has its
        # own staging plan), every part encoded once, here.
        self._codecs = self._wire = None
        if compress != "off":
            self._codecs = [plan_compression(st, [bufs], compress)
                            for st, bufs in zip(stream.staging,
                                                stream.staged)]
            self._wire = [c.encode(bufs) for c, bufs in
                          zip(self._codecs, stream.staged)]
        self._hot_cache = (HotChunkCache(hot_budget_bytes)
                           if hot_budget_bytes else None)
        self._mover = HostToDevice(self.device, self.prefetch_depth)
        self._value_dtype = (torch.float64 if self.objective.accumulate == "f64"
                             else torch.float32)

    @property
    def n_features(self) -> int:
        return self.stream.n_features

    @property
    def n_chunks(self) -> int:
        return self.stream.n_chunks

    @property
    def compression_ratio(self) -> float:
        """logical/wire bytes of one pass (1.0 uncompressed)."""
        if self._codecs is None:
            return 1.0
        return (sum(c.logical_nbytes for c in self._codecs)
                / sum(c.wire_nbytes for c in self._codecs))

    # -- what crosses the link ---------------------------------------------
    def _host_buffers(self, k: int) -> tuple:
        """Chunk k's host arrays: its wire buffers when compressing, else
        its staging buffers, else (an unstaged store) its leaves in
        sorted-key order."""
        if self._wire is not None:
            return self._wire[k]
        if self.stream.staged is not None:
            return self.stream.staged[k]
        leaves = self.stream.chunks[k].leaves
        return tuple(leaves[name] for name in sorted(leaves))

    def _host_item(self, i: int) -> list:
        """Item i's arrays: its group's chunks' arrays, in order."""
        return [a for k in self._groups[i] for a in self._host_buffers(k)]

    def _item_wire(self, i: int) -> int:
        return sum(int(a.nbytes) for a in self._host_item(i))

    def _item_logical(self, i: int) -> int:
        if self.stream.staging is None:
            return self._item_wire(i)
        return sum(self.stream.staging[k].nbytes for k in self._groups[i])

    def _chunk_data(self, k: int, tensors):
        """Chunk k's GlmData over its transferred arrays (views, or the
        decoded arrays when compressing)."""
        chunk = self.stream.chunks[k]
        if self._codecs is not None:
            leaves = self._codecs[k].unpack_device(tensors)
        elif self.stream.staging is not None:
            leaves = self.stream.staging[k].unpack_device(tensors)
        else:
            leaves = dict(zip(sorted(chunk.leaves), tensors))
        return chunk.to_data(leaves)

    def offset_slices(self, offsets) -> list:
        """Per-chunk slices of extra margin offsets (the other coordinates'
        scores), zero-padded to the chunk grid; None per chunk when absent.
        A list is taken as already sliced."""
        if isinstance(offsets, list):
            return offsets
        st = self.stream
        n_ch, cr = st.n_chunks, st.chunk_rows
        n_parts = len(st.chunks)
        if offsets is None:
            return [None] * n_parts
        want = st.n_rows if st.row_block is None else st.row_block[2]
        if offsets.shape[0] != want:
            # A silently zero-padded short array would train the tail rows
            # against offset 0.
            raise ValueError(
                f"offsets has {offsets.shape[0]} rows; the stream has "
                f"{want}")
        off = torch.as_tensor(offsets, dtype=torch.float32,
                              device=self.device)
        if st.row_block is not None:
            off = off[st.row_block[0]:st.row_block[1]]
        pad = n_ch * cr - off.shape[0]
        if pad:
            off = torch.cat([off, off.new_zeros(pad)])
        ps = st.per_shard
        out = []
        for p in range(n_parts):
            start = st.part_rows(p)[2]
            out.append(off[start:start + ps])
        return out

    @staticmethod
    def _with_offsets(data, off):
        if off is None:
            return data
        return dataclasses.replace(data, offsets=data.offsets + off)

    # -- the pass ------------------------------------------------------------
    def _put(self, packed):
        chaos_mod.maybe_fail("staging.put")
        return self._mover.put(packed)

    def _stream(self, fn, scoring: bool = False,
                batch: Optional[int] = None) -> None:
        """One pass: ``fn(k, data)`` for every chunk k in order, on the
        caller's (compute) stream; ``fn`` returns a 0-d tensor (the chunk's
        value, the hot cache's importance) on value passes.

        Cold items ride :func:`run_prefetched`; hot (resident) items are
        dispatched at their exact global positions before the next cold
        item, so the accumulation order is always 0..n-1.  After each item
        the caller records an event on the compute stream and waits for
        the one ``prefetch_depth`` items back (every item at depth 1).
        ``batch``: the candidates a batched trial carries (the size of the
        pass's all-reduce round in the telemetry)."""
        n_items = len(self._groups)
        cache = self._hot_cache
        mover = self._mover
        cuda = self.device.type == "cuda"
        window = 0 if self.prefetch_depth == 1 else self.prefetch_depth
        pending: collections.deque = collections.deque()
        scores: Optional[dict] = (
            {} if cache is not None and scoring else None)
        hot = {}
        if cache is not None:
            for i in range(n_items):
                dev = cache.get(i)
                if dev is not None:
                    hot[i] = dev
        cold = [i for i in range(n_items) if i not in hot]
        next_i = [0]
        stats = self.transfer_stats
        bytes0, chunks0 = stats.bytes, stats.chunks
        hot0 = ((cache.hits, cache.misses, cache.admissions, cache.evictions)
                if cache is not None else None)
        ring_peak = [0]
        t_pass0 = time.perf_counter()

        def dispatch(i, tensors) -> None:
            if self._codecs is not None:
                chaos_mod.maybe_fail("staging.decode", item=i)
            chaos_mod.maybe_fail("streaming.carry_sync", item=i)
            pos = 0
            for k in self._groups[i]:
                nb = len(self._host_buffers(k))
                out = fn(k, self._chunk_data(k, tensors[pos:pos + nb]))
                pos += nb
                if scores is not None:
                    scores.setdefault(i, []).append(out.abs())
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append(ev)
                if len(pending) > window:
                    pending.popleft().synchronize()
                ring_peak[0] = max(ring_peak[0], len(pending))

        def advance_hot(upto: int) -> None:
            while next_i[0] < upto:
                j = next_i[0]
                if j in hot:
                    if cuda:
                        stream = torch.cuda.current_stream(self.device)
                        for t in hot[j]:
                            t.record_stream(stream)
                    dispatch(j, hot[j])
                next_i[0] = j + 1

        def consume(ci, dev) -> None:
            i = cold[ci]
            advance_hot(i)
            tensors = mover.ready(dev)
            dispatch(i, tensors)
            next_i[0] = i + 1
            if cache is not None:
                cache.maybe_admit(i, tensors, self._item_wire(i))

        abort = threading.Event()
        mover.begin_pass(abort)
        run_max = run_prefetched(
            len(cold), lambda ci: mover.pack(self._host_item(cold[ci])),
            self._put, consume, depth=self.prefetch_depth,
            stats=self.transfer_stats,
            logical_nbytes=(
                (lambda ci: self._item_logical(cold[ci]))
                if self._codecs is not None else None),
            abort=abort,
        )
        advance_hot(n_items)
        if scores:
            # One host read for the pass's importance scores; admission
            # follows in the next pass.
            flat = [(i, s) for i, ss in scores.items() for s in ss]
            vals = torch.stack([s.to(torch.float64) for _, s in flat]).cpu()
            totals: dict = {}
            for (i, _), v in zip(flat, vals.tolist()):
                totals[i] = totals.get(i, 0.0) + v
            cache.replan(totals, self._item_wire)
        self._publish_pass(batch, n_items, bytes0, chunks0, hot0,
                           run_max + ring_peak[0], t_pass0)

    def _publish_pass(self, batch, n_items, bytes0, chunks0, hot0,
                      window_peak, t_pass0) -> None:
        """The pass's telemetry, once a pass and from host bookkeeping
        only: one logical all-reduce round (the carry a pass folds), the
        staged-buffer residency peak (live transfers + the compute window,
        times the pass's mean item bytes), the effective ingest rate under
        compression or the hot cache, and the cache's counters."""
        tel = telemetry_mod.current()
        if not tel.enabled:
            return
        stats = self.transfer_stats
        cache = self._hot_cache
        tel.counter("solver_allreduce_count").inc(1)
        tel.counter("solver_allreduce_bytes_total").inc(
            (batch or 1) * (self.stream.n_features + 1) * 4)
        d_chunks = stats.chunks - chunks0
        if d_chunks > 0:
            chunk_bytes = (stats.bytes - bytes0) / d_chunks
            tel.gauge("hbm_stream_chunk_bytes").set(int(chunk_bytes))
            tel.gauge("hbm_stream_window_peak_bytes").set(
                int(window_peak * chunk_bytes))
        if self._codecs is not None or cache is not None:
            # Logical bytes of every item the pass processed (a hot hit
            # moves no wire bytes but stands for its decoded size) over
            # the pass wall; h2d_gbps reports the link alone.
            wall = time.perf_counter() - t_pass0
            if wall > 0.0:
                tel.gauge("stream_effective_gbps").set(
                    sum(self._item_logical(i) for i in range(n_items))
                    / wall / 1e9)
        if cache is not None:
            d_hit = cache.hits - hot0[0]
            d_miss = cache.misses - hot0[1]
            tel.counter("stream_hot_hits_total").inc(d_hit)
            tel.counter("stream_hot_misses_total").inc(d_miss)
            tel.counter("stream_hot_admissions_total").inc(
                cache.admissions - hot0[2])
            tel.counter("stream_hot_evictions_total").inc(
                cache.evictions - hot0[3])
            if d_hit + d_miss:
                tel.gauge("stream_hot_hit_ratio").set(
                    d_hit / (d_hit + d_miss))
            tel.gauge("hbm_hot_bytes").set(cache.resident_bytes)
            tel.gauge("hbm_hot_budget_bytes").set(cache.budget_bytes)
            tel.gauge("hbm_hot_chunk_count").set(len(cache))

    def _zeros(self, shape, dtype=torch.float32) -> Tensor:
        return torch.zeros(shape, dtype=dtype, device=self.device)

    def _adder(self, acc: Tensor):
        """An in-place accumulate of the configured kind into ``acc``."""
        if self.accumulate == "f32":
            return acc.add_
        comp = torch.zeros_like(acc)
        return lambda x: _kahan_add(acc, comp, x)

    def _reduce(self, per_shard) -> tuple:
        """The pass's partial sums, one tuple a held shard, reduced over the
        shards and the group (no reduction for one shard alone)."""
        if self.mesh is None and len(per_shard) == 1:
            return tuple(per_shard[0])
        return reduce_shards(per_shard, self.mesh)

    @staticmethod
    def _fresh(w: Tensor) -> Tensor:
        """A fresh contiguous copy of ``w``: a single evaluation and a
        batched candidate then read identically allocated operands, so
        their reductions (BLAS dots included) see the same memory layout."""
        return w.detach().clone(memory_format=torch.contiguous_format)

    def value_and_grad(self, w: Tensor, l2_weight=0.0, offsets=None):
        """One streamed pass: (value, grad) with the L2 term applied.
        ``offsets``: optional (n_rows,) extra margins added per row."""
        w = self._fresh(w)
        slices = self.offset_slices(offsets)
        nh = self._n_held
        accs = [(self._zeros((), self._value_dtype),
                 self._zeros((self.n_features,))) for _ in range(nh)]
        adders = [(self._adder(v), self._adder(g)) for v, g in accs]
        obj = self.objective

        def step(k, data):
            v, g = obj.raw_value_and_grad(
                w, self._with_offsets(data, slices[k]))
            add_v, add_g = adders[k % nh]
            add_v(v)
            add_g(g)
            return v

        self._stream(step, scoring=True)
        vacc, gacc = self._reduce(accs)
        return (vacc + 0.5 * l2_weight * ordered.dot(w, w),
                gacc + l2_weight * w)

    def value_and_grad_batch(self, ws: Tensor, l2_weight=0.0, offsets=None):
        """K evaluations in one streamed pass: ``ws`` is (K, d) candidate
        coefficient vectors (a line search's trial bracket).  Each chunk
        runs every candidate through the same launches as
        :meth:`value_and_grad`, and each candidate accumulates and finishes
        as a single evaluation does, so row i is bitwise
        ``value_and_grad(ws[i])``.  Returns ((K,), (K, d))."""
        if ws.dim() != 2:
            raise ValueError(
                f"value_and_grad_batch wants (K, n_features), got "
                f"{tuple(ws.shape)}")
        wl = [self._fresh(w) for w in ws]
        K = len(wl)
        slices = self.offset_slices(offsets)
        nh = self._n_held
        # Per held shard: K value accumulators, then K gradients.
        accs = [[self._zeros((), self._value_dtype) for _ in range(K)]
                + [self._zeros((self.n_features,)) for _ in range(K)]
                for _ in range(nh)]
        adders = [[(self._adder(a[i]), self._adder(a[K + i]))
                   for i in range(K)] for a in accs]
        obj = self.objective

        def step(k, data):
            data = self._with_offsets(data, slices[k])
            first = None
            for w, (add_v, add_g) in zip(wl, adders[k % nh]):
                v, g = obj.raw_value_and_grad(w, data)
                add_v(v)
                add_g(g)
                first = v if first is None else first
            return first

        self._stream(step, scoring=True, batch=K)
        red = self._reduce(accs)
        vaccs, gaccs = red[:K], red[K:]
        vals = torch.stack([v + 0.5 * l2_weight * ordered.dot(w, w)
                            for v, w in zip(vaccs, wl)])
        grads = torch.stack([g + l2_weight * w for g, w in zip(gaccs, wl)])
        return vals, grads

    def hessian_diagonal(self, w: Tensor, offsets=None) -> Tensor:
        """Σᵢ weightᵢ·d2ᵢ·X²ᵢⱼ streamed over the chunks (for coefficient
        variances)."""
        w = self._fresh(w)
        slices = self.offset_slices(offsets)
        nh = self._n_held
        diags = [(self._zeros((self.n_features,)),) for _ in range(nh)]
        obj = self.objective

        def step(k, data):
            data = self._with_offsets(data, slices[k])
            diags[k % nh][0].add_(
                data.features.sq_rmatvec(obj.d2_weights(w, data)))

        self._stream(step)
        return self._reduce(diags)[0]

    def hvp(self, w: Tensor, v: Tensor, l2_weight=0.0, offsets=None):
        """H(w)·v = Xᵀ(d2w ⊙ (Xv)) + λ·v as one streamed pass (the
        reference's ``HessianVectorAggregator`` round).  The d2 weights are
        recomputed per chunk (one extra matvec): caching them would hold
        n_rows of state on the card."""
        w, v = self._fresh(w), self._fresh(v)
        slices = self.offset_slices(offsets)
        nh = self._n_held
        hs = [(self._zeros((self.n_features,)),) for _ in range(nh)]
        adders = [self._adder(h[0]) for h in hs]
        obj = self.objective

        def step(k, data):
            adders[k % nh](
                obj.raw_hvp(w, v, self._with_offsets(data, slices[k])))

        self._stream(step)
        return self._reduce(hs)[0] + l2_weight * v

    def scores(self, w: Tensor) -> np.ndarray:
        """Margins of every row of the store, streamed; each chunk's margins
        start an asynchronous copy to a pinned host buffer and are read a
        window of ``prefetch_depth`` chunks later.  Always streams (the hot
        cache is not consulted).  Over a group every rank returns all the
        rows: the ranks' parts are all-gathered and put back in row
        order."""
        w = self._fresh(w)
        cuda = self.device.type == "cuda"
        window = 0 if self.prefetch_depth == 1 else self.prefetch_depth
        outs: list = [None] * len(self.stream.chunks)
        pend: collections.deque = collections.deque()
        obj = self.objective

        def materialize(k, host, ev):
            if ev is not None:
                ev.synchronize()
            outs[k] = host.numpy().copy()

        def step(k, data):
            m = obj.margins(w, data)
            if cuda:
                host = torch.empty(m.shape, dtype=m.dtype, pin_memory=True)
                host.copy_(m, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record()
                pend.append((k, host, ev))
            else:
                pend.append((k, m, None))
            if len(pend) > window:
                materialize(*pend.popleft())

        cache, self._hot_cache = self._hot_cache, None
        try:
            self._stream(step)
        finally:
            self._hot_cache = cache
        while pend:
            materialize(*pend.popleft())
        local = np.concatenate(outs)
        st = self.stream
        if self.mesh is None:
            # Parts in (chunk, shard) order are the rows in order.
            return local[: st.n_rows]
        mesh = self.mesh
        if st.row_block is not None:
            # Ranks' host-local blocks: ceil(n / k) rows each, the last
            # short (multihost.host_local_rows).
            start, stop, n = st.row_block
            per = -(-n // mesh.size)
            block = np.zeros(per, local.dtype)
            block[: stop - start] = local[: stop - start]
            rows = mesh.gather_rows(torch.as_tensor(block,
                                                    device=self.device), n)
            return rows.cpu().numpy()
        parts = mesh.all_gather(torch.as_tensor(
            local.reshape(st.n_chunks, st.per_shard), device=self.device))
        # (rank, chunk, row) → (chunk, rank, row): the rows in order.
        return parts.transpose(0, 1).reshape(-1)[: st.n_rows].cpu().numpy()


# ---------------------------------------------------------------------------
# Grid sweep over a streamed dataset
# ---------------------------------------------------------------------------


class StorePasses:
    """A :class:`StreamingObjective` behind the objective interface the
    registry's solvers call (``value_and_grad(w, data, l2_weight)``,
    ``hvp(w, v, data, l2_weight, d2w)``, ``d2_weights(w, data)``): every
    call is one pass over the store (with ``offsets``, the per-chunk extra
    margins, added), so ``data`` is unused, and TRON gets
    no per-iterate d2 cache (the HVP pass recomputes the weights per chunk;
    caching them would hold n_rows of state on the card)."""

    def __init__(self, sobj: StreamingObjective, offsets=None):
        self.sobj = sobj
        self.offsets = offsets  # per-chunk slices (offset_slices) or None

    def value_and_grad(self, w, data, l2_weight=0.0):
        return self.sobj.value_and_grad(w, l2_weight, offsets=self.offsets)

    def hvp(self, w, v, data, l2_weight=0.0, d2w=None):
        return self.sobj.hvp(w, v, l2_weight, offsets=self.offsets)

    def d2_weights(self, w, data):
        return None


def ensure_streamable(config) -> None:
    """Refuse configs the streamed path cannot train, before the chunk
    store's (possibly long) ingest.  L-BFGS, OWL-QN and smooth TRON stream;
    the registry refuses an explicit SPG here, since the streamed grid
    takes no box constraints."""
    from photon_ml_tpu_torch.solvers import registry as solver_registry

    solver_registry.resolve(config.optimizer,
                            l1_frac=config.regularization.l1_weight(1.0))


def streaming_run_grid(
    problem,
    sobj: StreamingObjective,
    reg_weights: Sequence[float],
    w0: Optional[Tensor] = None,
    mesh=None,
    warm_start: bool = True,
    solved: Optional[dict] = None,
    on_solved=None,
    l1_mask: Optional[Tensor] = None,
    batch_linesearch: bool = True,
):
    """The λ-grid warm-start chain (``problem.grid_loop``) over a streamed
    dataset, each λ solved by the solver ``problem.solve`` would pick
    (L1/elastic net → OWL-QN, else the configured optimizer) with one
    streamed pass an evaluation.  Over a group (``sobj.mesh``) every pass
    ends in one all-reduce, so every rank returns the same models.

    ``sobj`` is a :class:`StreamingObjective` over ``problem.objective``
    (the same loss, accumulation and normalization); its settings (depth,
    fusion, compression, hot cache) apply to every solve, and its transfer
    statistics and hot cache span the grid.  ``batch_linesearch``
    evaluates a bracket of line-search candidates a pass (the same trials,
    about half the passes)."""
    from photon_ml_tpu_torch.solvers import registry as solver_registry

    if mesh is not None and mesh is not sobj.mesh:
        raise ValueError("streaming_run_grid's mesh must be the "
                         "StreamingObjective's (build it with mesh=)")
    a, b = sobj.objective, problem.objective
    if ((a.loss.name, a.accumulate) != (b.loss.name, b.accumulate)
            or a.normalization is not b.normalization):
        raise ValueError(
            "streaming_run_grid needs a StreamingObjective over "
            "problem.objective: its loss, accumulation and normalization "
            "differ from the problem's")
    cfg = problem.config
    ensure_streamable(cfg)
    opt = cfg.optimizer
    l1_frac = cfg.regularization.l1_weight(1.0)
    defn = solver_registry.resolve(opt, l1_frac=l1_frac)
    passes = StorePasses(sobj)

    def solve_fn(lam, w_prev):
        l1 = l1_frac * float(lam)
        l2 = cfg.regularization.l2_weight(1.0) * float(lam)
        if w_prev is None:
            w_prev = torch.zeros(sobj.n_features, dtype=torch.float32,
                                 device=sobj.device)
        vgb = ((lambda ws: sobj.value_and_grad_batch(ws, l2))
               if batch_linesearch else None)
        return defn.resident(solver_registry.ResidentSolve(
            objective=passes, data=None, w0=w_prev, l1=l1, l2=l2, opt=opt,
            l1_mask=l1_mask, value_and_grad_batch=vgb,
        ))

    variance_fn = None
    if cfg.compute_variances:
        def variance_fn(w, lam):
            l2 = cfg.regularization.l2_weight(1.0) * float(lam)
            diag = sobj.hessian_diagonal(w)
            return 1.0 / torch.clamp(diag + l2, min=1e-12)

    return problem.grid_loop(solve_fn, reg_weights, w0, warm_start, solved,
                             on_solved, variance_fn, device=sobj.device)
