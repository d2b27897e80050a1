"""Leaf coalescing: a few dtype-segregated staging buffers per chunk (port
of ``photon_ml_tpu/data/staging.py``).

A chunk of streamed GLM data is a dictionary of numpy leaves (the kernel
layout alone carries CSR and CSC indices, values, the row-block table and
the dense stripes).  Moving it one leaf at a time pays the link's fixed
per-copy cost per leaf.  This module lays a chunk's leaves out over one
contiguous buffer per distinct dtype, so a chunk crosses the link as a few
large copies:

- :func:`plan_staging` maps a chunk's leaves onto the buffers (one per
  dtype, each shaped ``(n_shards, elems)``; leaves in sorted-key order, as
  a JAX pytree flattens a dictionary).  With ``n_shards > 1`` every leaf
  carries a leading shard axis and each buffer row holds one shard's part,
  the reference's layout for a chunk stacked over a mesh;
- :func:`pack_chunk` fills the buffers from the leaves (host side, at store
  build time);
- :func:`chunk_view` rebuilds the chunk as zero-copy numpy views into the
  buffers, so the host store holds one copy;
- :func:`unpack_device` rebuilds it as zero-copy views into the buffers
  once they are on the device (slicing and ``view`` only, no copy).

The port's chunks differ in shape (a CSR chunk has its own entry count;
the kernels launch on any shape), so every chunk has its own plan, where
the reference pads all chunks to one so that one compiled program serves
them.  For the same reason a sharded chunk store
(``data/streaming.py``) stages each shard's part of a chunk under its own
one-shard plan: a shard's kernel layout has its own shapes, and a rank of
a process group moves only its own part.

**Compressed chunk formats** (:class:`ChunkCodec`, :func:`plan_compression`)
ride the same discipline one level down: every staging slot (one leaf's
segment) gets a wire encoding — delta or downcast narrowing for index
blocks, bitmaps for {0,1}-valued float segments (f32 and f64), an f32 wire
for f64 blocks whose every value round-trips bitwise, fp16/int8
quantization with per-slot scale sidecars — and the encoded slots are
re-segregated into wire buffers by wire dtype.  The decode
(:meth:`ChunkCodec.unpack_device`) runs on the device as torch ops on the
compute stream: slices, casts, an integer ``cumsum`` (exact in int32 and
int64) and bit shifts.  ``lossless`` gives the raw buffers back byte for
byte; fp16/int8 are lossy and opt-in.  The host encoding is the
reference's byte for byte.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Sequence

import numpy as np
import torch

_TORCH_DTYPES = {
    np.dtype(np.float64): torch.float64,
    np.dtype(np.float32): torch.float32,
    np.dtype(np.float16): torch.float16,
    np.dtype(np.int64): torch.int64,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.int16): torch.int16,
    np.dtype(np.int8): torch.int8,
    np.dtype(np.uint8): torch.uint8,
    np.dtype(np.bool_): torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype of a numpy dtype the staging layer moves."""
    try:
        return _TORCH_DTYPES[np.dtype(dtype)]
    except KeyError:
        raise TypeError(f"staging cannot move dtype {np.dtype(dtype)}")


def _flatten(chunk) -> tuple[tuple, list]:
    """(structure, leaves) of a chunk: a mapping flattens in sorted-key
    order, a list or tuple in index order."""
    if isinstance(chunk, dict):
        keys = tuple(sorted(chunk))
        return ("dict", keys), [chunk[k] for k in keys]
    if isinstance(chunk, (list, tuple)):
        return ("seq", len(chunk)), list(chunk)
    raise TypeError(
        f"a chunk is a dict or a sequence of arrays, got {type(chunk)}")


def _unflatten(treedef: tuple, leaves: list):
    kind, spec = treedef
    if kind == "dict":
        return dict(zip(spec, leaves))
    return list(leaves)


@dataclasses.dataclass(frozen=True)
class _LeafSlot:
    """Where one leaf lives inside the staging buffers."""

    buffer: int  # index into the dtype-segregated buffer list
    offset: int  # element offset within one shard's row of the buffer
    size: int  # elements a shard row
    shape: tuple  # full leaf shape
    shard_shape: tuple  # one shard's shape (== shape when n_shards == 1)


@dataclasses.dataclass(frozen=True)
class ChunkStaging:
    """The staging-buffer layout of one chunk.  Buffers are
    dtype-segregated: a chunk has a handful of dtypes, so it moves in
    O(1) copies."""

    treedef: Any  # ("dict", sorted keys) | ("seq", n)
    dtypes: tuple  # per-buffer numpy dtype
    row_elems: tuple  # per-buffer elements a shard row
    slots: tuple  # _LeafSlot per leaf, in flatten order
    n_shards: int = 1

    @property
    def n_buffers(self) -> int:
        return len(self.dtypes)

    @property
    def nbytes(self) -> int:
        """Staged bytes of the chunk (= bytes of one chunk transfer)."""
        return sum(self.n_shards * r * np.dtype(dt).itemsize
                   for r, dt in zip(self.row_elems, self.dtypes))

    def unpack_device(self, buffers):
        return unpack_device(self, buffers)


def _shard_split(shape: tuple, n_shards: int) -> tuple:
    """One shard's shape of a leaf: with ``n_shards > 1`` every leaf
    carries the leading shard axis."""
    if n_shards == 1:
        return shape
    if not shape or shape[0] != n_shards:
        raise ValueError(
            f"sharded chunk leaf has shape {shape}; expected leading "
            f"shard axis of {n_shards}"
        )
    return shape[1:]


def plan_staging(chunk, n_shards: int = 1) -> ChunkStaging:
    """Lay the chunk's leaves out over dtype-segregated staging buffers of
    ``n_shards`` rows (one a shard)."""
    treedef, leaves = _flatten(chunk)
    dtypes: list = []
    row_elems: list = []
    slots: list = []
    for leaf in leaves:
        arr = np.asarray(leaf)
        shard_shape = _shard_split(tuple(arr.shape), n_shards)
        size = int(math.prod(shard_shape))
        dt = arr.dtype
        if dt not in dtypes:
            dtypes.append(dt)
            row_elems.append(0)
        b = dtypes.index(dt)
        slots.append(_LeafSlot(buffer=b, offset=row_elems[b], size=size,
                               shape=tuple(arr.shape),
                               shard_shape=shard_shape))
        row_elems[b] += size
    return ChunkStaging(treedef=treedef, dtypes=tuple(dtypes),
                        row_elems=tuple(row_elems), slots=tuple(slots),
                        n_shards=n_shards)


def pack_chunk(staging: ChunkStaging, chunk) -> tuple:
    """Copy a chunk's leaves into freshly allocated staging buffers, one
    contiguous ``(n_shards, row_elems)`` array per dtype.  Memmap leaves are
    paged in transiently (one chunk of RAM)."""
    treedef, leaves = _flatten(chunk)
    if treedef != staging.treedef:
        raise ValueError(
            "chunk structure does not match the staging plan "
            f"({treedef} vs {staging.treedef})"
        )
    k = staging.n_shards
    bufs = [np.empty((k, r), dt)
            for r, dt in zip(staging.row_elems, staging.dtypes)]
    for leaf, slot in zip(leaves, staging.slots):
        arr = np.asarray(leaf)
        if (tuple(arr.shape) != slot.shape
                or arr.dtype != staging.dtypes[slot.buffer]):
            raise ValueError(
                f"chunk leaf {arr.shape}/{arr.dtype} does not match the "
                f"staging plan's {slot.shape}/"
                f"{staging.dtypes[slot.buffer]}"
            )
        bufs[slot.buffer][:, slot.offset:slot.offset + slot.size] = (
            arr.reshape(k, slot.size))
    return tuple(bufs)


def chunk_view(staging: ChunkStaging, buffers: Sequence[np.ndarray]):
    """The chunk as zero-copy numpy views into its staging buffers."""
    leaves = [
        buffers[s.buffer][:, s.offset:s.offset + s.size].reshape(s.shape)
        for s in staging.slots
    ]
    return _unflatten(staging.treedef, leaves)


def unpack_device(staging: ChunkStaging, buffers):
    """The chunk as zero-copy views into its buffers on the device (torch
    tensors): a slice and a ``view`` per leaf.  The leading dimension is
    read off the buffer, so a sharded plan unpacks its full
    ``(n_shards, row)`` buffers and one shard's ``(1, row)`` rows alike."""
    leaves = []
    for s in staging.slots:
        buf = buffers[s.buffer]
        if staging.n_shards == 1:
            leaves.append(buf[0, s.offset:s.offset + s.size].view(s.shape))
        else:
            leaves.append(buf[:, s.offset:s.offset + s.size].reshape(
                (buf.shape[0],) + s.shard_shape))
    return _unflatten(staging.treedef, leaves)


# ---------------------------------------------------------------------------
# Compressed chunk formats: per-slot wire encodings + on-device decode
# ---------------------------------------------------------------------------

#: the ``compress`` knob's values.  "lossless" applies only encodings whose
#: device decode reconstructs the uncompressed arrays bitwise (delta,
#: integer downcast, {0,1} bitmaps, the f64-over-f32-wire downcast when
#: every value round-trips); "fp16" and "int8" also quantize float32
#: segments (lossy, bounded error), keeping the lossless integer encodings.
COMPRESSION_MODES = ("off", "lossless", "fp16", "int8")

#: encodings whose decode is exact (bitwise).
_LOSSLESS_KINDS = frozenset({"raw", "downcast", "delta", "bitmap"})

#: narrowing ladder for signed integer slots (delta wire values can be
#: negative).  The port stages no unsigned leaf wider than a byte, so
#: unsigned slots stay raw.
_SIGNED_LADDER = (np.int8, np.int16, np.int32)


@dataclasses.dataclass(frozen=True)
class _SlotEncoding:
    """How one staging slot crosses the wire."""

    kind: str  # raw | downcast | delta | bitmap | fp16 | int8
    wire_buffer: int  # index into the codec's wire buffer list
    wire_offset: int  # element offset within the wire buffer's row
    wire_size: int  # wire elements (bitmap: packed bytes)
    scale_index: int = -1  # int8 only: column in the scale sidecar


@dataclasses.dataclass(frozen=True)
class ChunkCodec:
    """The wire format of the chunks that share one staging plan.

    Per-chunk data (int8 scales) rides inside the float32 wire buffer as a
    fixed-offset sidecar, never as a separate transfer."""

    staging: ChunkStaging  # the logical layout being encoded
    mode: str
    encodings: tuple  # _SlotEncoding per slot, in staging.slots order
    wire_dtypes: tuple  # per wire buffer
    wire_row_elems: tuple  # per wire buffer, elements
    n_scales: int  # int8-quantized slot count (sidecar width)
    scale_buffer: int = -1  # wire buffer holding the scale sidecar
    scale_offset: int = 0

    @property
    def logical_nbytes(self) -> int:
        """Decoded bytes one chunk expands to on the device."""
        return self.staging.nbytes

    @property
    def wire_nbytes(self) -> int:
        """Encoded bytes one chunk moves across the link."""
        return sum(self.staging.n_shards * r * np.dtype(dt).itemsize
                   for r, dt in zip(self.wire_row_elems, self.wire_dtypes))

    @property
    def ratio(self) -> float:
        """logical/wire; above 1 the encoding shrinks the transfers."""
        w = self.wire_nbytes
        return self.logical_nbytes / w if w else 1.0

    @property
    def kinds(self) -> tuple:
        """Distinct non-raw encodings in use (empty = fell back to raw)."""
        return tuple(sorted({e.kind for e in self.encodings
                             if e.kind != "raw"}))

    @property
    def is_lossless(self) -> bool:
        return all(e.kind in _LOSSLESS_KINDS for e in self.encodings)

    def encode(self, buffers: Sequence[np.ndarray]) -> tuple:
        """Encode one chunk's staged buffers into wire buffers (host side,
        once per chunk when the codec is planned, never per pass)."""
        st = self.staging
        wire = [np.zeros((st.n_shards, r), dt)
                for r, dt in zip(self.wire_row_elems, self.wire_dtypes)]
        for slot, enc in zip(st.slots, self.encodings):
            seg = np.asarray(buffers[slot.buffer])[
                :, slot.offset:slot.offset + slot.size]
            dst = wire[enc.wire_buffer][
                :, enc.wire_offset:enc.wire_offset + enc.wire_size]
            if enc.kind == "raw":
                dst[...] = seg
            elif enc.kind == "downcast":
                dst[...] = seg.astype(dst.dtype)
            elif enc.kind == "delta":
                d = seg.astype(np.int64)
                d[:, 1:] -= seg[:, :-1].astype(np.int64)
                dst[...] = d.astype(dst.dtype)
            elif enc.kind == "bitmap":
                dst[...] = np.packbits(seg != 0, axis=1)
            elif enc.kind == "fp16":
                dst[...] = seg.astype(np.float16)
            else:  # int8
                m = np.max(np.abs(seg), axis=1, keepdims=True)
                sc = np.where(m > 0.0, m / 127.0, 1.0).astype(np.float32)
                col = self.scale_offset + enc.scale_index
                wire[self.scale_buffer][:, col:col + 1] = sc
                dst[...] = np.clip(np.rint(seg / sc), -127, 127).astype(
                    np.int8)
        return tuple(wire)

    def unpack_device(self, wire):
        """Decode the chunk's wire buffers (torch tensors on the device,
        each ``(n_shards, elems)``) into its leaves, as torch ops on the
        current stream: slices, casts, an integer cumsum and bit shifts.
        Raw slots stay views of the wire buffers."""
        st = self.staging
        scales = None
        if self.n_scales:
            scales = wire[self.scale_buffer][
                :, self.scale_offset:self.scale_offset + self.n_scales]
        leaves = []
        for slot, enc in zip(st.slots, self.encodings):
            seg = wire[enc.wire_buffer][
                :, enc.wire_offset:enc.wire_offset + enc.wire_size]
            odt = torch_dtype(st.dtypes[slot.buffer])
            if enc.kind in ("downcast", "fp16"):
                seg = seg.to(odt)
            elif enc.kind == "delta":
                # The deltas were taken from values that fit ``odt``, so
                # their running integer sum gives every value back exactly.
                seg = torch.cumsum(seg, dim=1, dtype=odt)
            elif enc.kind == "bitmap":
                shifts = torch.arange(7, -1, -1, dtype=torch.uint8,
                                      device=seg.device)
                bits = (seg.unsqueeze(-1) >> shifts) & 1
                seg = bits.reshape(seg.shape[0], -1)[:, :slot.size].to(odt)
            elif enc.kind == "int8":
                sc = scales[:, enc.scale_index:enc.scale_index + 1]
                seg = seg.to(odt) * sc
            leaves.append(seg.reshape(slot.shape) if st.n_shards == 1
                          else seg.reshape((seg.shape[0],)
                                           + slot.shard_shape))
        return _unflatten(st.treedef, leaves)


def _narrowest(ladder, lo: int, hi: int, max_itemsize: int):
    """Narrowest ladder dtype (strictly below ``max_itemsize``) that holds
    every value in [lo, hi], or None."""
    for dt in ladder:
        if np.dtype(dt).itemsize >= max_itemsize:
            return None
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return dt
    return None


def _plan_int_slot(dt, segments: list):
    """delta/downcast choice for one signed integer slot: the narrowest wire
    dtype over both the raw range and the per-row delta range (delta needs
    a cumsum on the device, so it must buy strictly more narrowing)."""
    vmin = min(int(s.min()) for s in segments)
    vmax = max(int(s.max()) for s in segments)
    size = np.dtype(dt).itemsize
    down = _narrowest(_SIGNED_LADDER, vmin, vmax, size)
    # Only each row's first element rides the delta wire raw, so the wire
    # range is (first-column values) ∪ (pairwise deltas).
    dmin = min(int(s[:, 0].min()) for s in segments)
    dmax = max(int(s[:, 0].max()) for s in segments)
    for s in segments:
        if s.shape[1] < 2:
            continue
        d = s[:, 1:].astype(np.int64) - s[:, :-1].astype(np.int64)
        dmin = min(dmin, int(d.min()))
        dmax = max(dmax, int(d.max()))
    delta = _narrowest(_SIGNED_LADDER, dmin, dmax, size)
    if delta is not None and (
            down is None
            or np.dtype(delta).itemsize < np.dtype(down).itemsize):
        return "delta", np.dtype(delta)
    if down is not None:
        return "downcast", np.dtype(down)
    return "raw", np.dtype(dt)


def _bits_in(segments: list, view, allowed) -> bool:
    """Every element's bit pattern is one of ``allowed`` (the bitmap
    precondition: -0.0 would decode to +0.0, a bit flip)."""
    return all(
        np.isin(np.ascontiguousarray(s).view(view), allowed).all()
        for s in segments)


def _f32_roundtrips_f64(segments: list) -> bool:
    """Every f64 value survives an f32 wire bitwise."""
    for s in segments:
        rt = s.astype(np.float32).astype(np.float64)
        if not (np.ascontiguousarray(rt).view(np.uint64)
                == np.ascontiguousarray(s).view(np.uint64)).all():
            return False
    return True


def plan_compression(staging: ChunkStaging, staged: Sequence,
                     mode: str) -> ChunkCodec | None:
    """Choose one wire encoding per staging slot, valid for every chunk in
    ``staged`` (buffer tuples that share ``staging``), and lay the encoded
    slots out over wire buffers re-segregated by wire dtype.

    Returns None for mode "off".  A slot falls back to "raw" whenever its
    values rule the candidates out (an int64 block that needs 64 bits, a
    float segment beyond fp16's range in fp16 mode); callers that require a
    win check :attr:`ChunkCodec.ratio`."""
    if mode == "off":
        return None
    if mode not in COMPRESSION_MODES:
        raise ValueError(
            f"compress must be one of {COMPRESSION_MODES}, got {mode!r}")
    if not staged:
        raise ValueError("plan_compression needs a non-empty staged store")

    def segments(slot):
        return [np.asarray(bufs[slot.buffer])[
            :, slot.offset:slot.offset + slot.size] for bufs in staged]

    plans: list = []  # (kind, wire dtype) per slot
    n_scales = 0
    for slot in staging.slots:
        dt = np.dtype(staging.dtypes[slot.buffer])
        if slot.size == 0:
            plans.append(("raw", dt))
        elif dt.kind == "i" and dt.itemsize >= 2:
            plans.append(_plan_int_slot(dt, segments(slot)))
        elif dt == np.float64:
            segs = segments(slot)
            if _bits_in(segs, np.uint64,
                        (0x0000000000000000, 0x3FF0000000000000)):
                plans.append(("bitmap", np.dtype(np.uint8)))
            elif _f32_roundtrips_f64(segs):
                plans.append(("downcast", np.dtype(np.float32)))
            else:
                plans.append(("raw", dt))
        elif dt == np.float32:
            segs = segments(slot)
            if _bits_in(segs, np.uint32, (0x00000000, 0x3F800000)):
                plans.append(("bitmap", np.dtype(np.uint8)))
            elif mode == "fp16" and math.isfinite(
                    maxabs := max(float(np.max(np.abs(s))) for s in segs)
            ) and maxabs <= 65504.0:
                plans.append(("fp16", np.dtype(np.float16)))
            elif mode == "int8" and all(np.isfinite(s).all() for s in segs):
                plans.append(("int8", np.dtype(np.int8)))
                n_scales += 1
            else:
                plans.append(("raw", dt))
        else:
            plans.append(("raw", dt))

    # Wire layout: slots grouped by wire dtype in first-appearance order;
    # the int8 scale sidecar claims float32 wire space first, so its
    # offset does not depend on the data that follows.  A bitmap's wire
    # length is its packed byte count.
    wire_dtypes: list = []
    wire_row_elems: list = []

    def wire_alloc(dt, elems: int) -> tuple:
        if dt not in wire_dtypes:
            wire_dtypes.append(dt)
            wire_row_elems.append(0)
        b = wire_dtypes.index(dt)
        off = wire_row_elems[b]
        wire_row_elems[b] += elems
        return b, off

    scale_buffer, scale_offset = -1, 0
    if n_scales:
        scale_buffer, scale_offset = wire_alloc(np.dtype(np.float32),
                                                n_scales)
    encodings: list = []
    scale_i = 0
    for slot, (kind, wdt) in zip(staging.slots, plans):
        elems = (slot.size + 7) // 8 if kind == "bitmap" else slot.size
        b, off = wire_alloc(wdt, elems)
        si = -1
        if kind == "int8":
            si = scale_i
            scale_i += 1
        encodings.append(_SlotEncoding(kind, b, off, elems, si))
    return ChunkCodec(
        staging=staging, mode=mode, encodings=tuple(encodings),
        wire_dtypes=tuple(wire_dtypes), wire_row_elems=tuple(wire_row_elems),
        n_scales=n_scales, scale_buffer=scale_buffer,
        scale_offset=scale_offset,
    )


# ---------------------------------------------------------------------------
# Wire dtype tags
# ---------------------------------------------------------------------------

#: Stable one-byte tags for the dtypes that may ride a binary wire
#: frame (serving/wire.py).  The table is append-only: tags are part of
#: the framed layout, so a tag must never be renumbered once a frame
#: version has shipped with it.  Segregating payload segments by dtype
#: tag is the same slot idiom :class:`ChunkCodec` uses for compressed
#: chunk buffers — a decoder maps each directory entry straight onto a
#: typed view of the payload, no per-element parsing.
WIRE_DTYPE_TAGS: tuple = (
    np.dtype(np.float32),   # 0
    np.dtype(np.float64),   # 1
    np.dtype(np.float16),   # 2
    np.dtype(np.int8),      # 3
    np.dtype(np.int16),     # 4
    np.dtype(np.int32),     # 5
    np.dtype(np.int64),     # 6
    np.dtype(np.uint8),     # 7
    np.dtype(np.uint16),    # 8
    np.dtype(np.uint32),    # 9
    np.dtype(np.uint64),    # 10
    np.dtype(np.bool_),     # 11
)

_WIRE_TAG_BY_DTYPE = {dt: i for i, dt in enumerate(WIRE_DTYPE_TAGS)}


def wire_dtype_tag(dtype) -> int:
    """The one-byte wire tag for ``dtype``; raises ``KeyError`` with the
    offending dtype named when it has no tag (complex, object, …)."""
    dt = np.dtype(dtype)
    tag = _WIRE_TAG_BY_DTYPE.get(dt)
    if tag is None:
        raise KeyError(
            f"dtype {dt} has no wire tag; supported: "
            f"{[str(d) for d in WIRE_DTYPE_TAGS]}"
        )
    return tag


def wire_dtype_from_tag(tag: int) -> np.dtype:
    """Inverse of :func:`wire_dtype_tag`; raises ``KeyError`` on an
    unknown tag so decoders refuse rather than misread."""
    if not 0 <= tag < len(WIRE_DTYPE_TAGS):
        raise KeyError(f"unknown wire dtype tag {tag}")
    return WIRE_DTYPE_TAGS[tag]
