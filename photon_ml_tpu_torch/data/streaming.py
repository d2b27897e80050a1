"""Out-of-core GLM training data: a host chunk store streamed to the device
(port of ``photon_ml_tpu/data/streaming.py``).

The dataset lives in host RAM (or on disk) as a list of chunks, and every
objective evaluation streams them through the card (``optim/streaming.py``),
so the trainable size is bounded by host memory or disk, not by the card.

- **A chunk is its device layout, held as host arrays.**  On the card a
  sparse chunk is the kernel layout of ``ops/sparse_cuda.py`` — CSR, the
  CSC copy with its row-block table, the dense stripes — built by
  :func:`~photon_ml_tpu_torch.ops.sparse_cuda.build_cuda_layout` on the
  host when the chunk fills; on the CPU it is the COO form of the plain
  path with its sorted orders (:func:`~photon_ml_tpu_torch.ops.sparse.coo_parts`);
  dense features are one ``(chunk_rows, d)`` array.  Every chunk is built
  once, so the store's total build is about the resident build's.
- **Chunks move as coalesced staging buffers, and live there too.**  Each
  finished chunk is packed into one contiguous buffer per dtype
  (``data/staging.py``), and :attr:`HostChunk.leaves` are zero-copy views
  into those buffers: the store holds one copy, and a chunk crosses the
  link as a few large copies.  The port launches its kernels on any shape,
  so chunks are not padded to a common entry count (the reference's layout
  uniformisation exists for the TPU's compiled programs); each chunk has
  its own staging plan.
- **Ingest is incremental**: :func:`streaming_from_blocks` re-cuts a block
  stream at ``chunk_rows`` boundaries as blocks arrive and builds each
  chunk the moment it fills, so peak host memory is the store plus about
  one chunk of raw rows.
- **Disk-backed stores** (``storage_dir``) spill each chunk's staging
  buffers to ``.npy`` files and train from memmaps of them.
- **Padding**: rows added to fill the last chunk carry weight 0, so every
  weighted reduction is unchanged.
- **Sharded stores** (``n_shards = k``) keep the reference's chunk
  arithmetic: ``chunk_rows`` rounds up to a multiple of k and shard s of
  chunk c holds its rows ``[s·per_shard, (s+1)·per_shard)`` with
  ``per_shard = chunk_rows // k``.  Each shard's part is a chunk of its
  own (its own kernel layout with local row ids, its own staging plan), so
  the SpMV kernels run on every part.  A store built for a rank of a
  process group (``mesh``) holds and stages that rank's shard of every
  chunk only; ``mesh=None`` holds all k parts (logical shards).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterable, Optional

import numpy as np
import torch

from photon_ml_tpu_torch.data.dataset import GlmData
from photon_ml_tpu_torch.data.staging import (
    chunk_view,
    pack_chunk,
    plan_staging,
)
from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.ops.sparse import (
    DenseMatrix,
    SparseMatrix,
    canonicalize_coo,
    coo_parts,
)
from photon_ml_tpu_torch.ops.sparse_cuda import (
    LAYOUT_FIELDS,
    CudaLayout,
    build_cuda_layout,
)

@dataclasses.dataclass
class HostChunk:
    """One chunk on the host: ``leaves`` maps ``"X.<field>"``, ``"labels"``,
    ``"weights"`` and ``"offsets"`` to numpy arrays (views into the chunk's
    staging buffers once staged); ``meta`` is the layout's metadata (the
    kernel layout's lanes and unit flag).  :meth:`to_data` builds the
    :class:`GlmData` over the same leaves once they are tensors on a
    device."""

    kind: str  # "kernel" (the CSR/CSC layout), "coo" or "dense"
    leaves: dict
    n_rows: int
    n_cols: int
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def weights(self) -> np.ndarray:
        return self.leaves["weights"]

    def to_data(self, tensors: dict) -> GlmData:
        """The chunk's :class:`GlmData` over ``tensors`` (its leaves as
        torch tensors, e.g. views into the transferred buffers)."""
        X = {k[2:]: v for k, v in tensors.items() if k.startswith("X.")}
        if self.kind == "kernel":
            feats = CudaLayout(
                arrays=None, n_rows=self.n_rows, n_cols=self.n_cols,
                **self.meta).matrix(X)
        elif self.kind == "coo":
            feats = SparseMatrix.from_parts(
                X["row_ids"], X["col_ids"], X["values"], self.n_rows,
                self.n_cols, X["row_offsets"], X["col_order"],
                X["col_offsets"])
        else:
            feats = DenseMatrix(X["data"])
        return GlmData(features=feats, labels=tensors["labels"],
                       weights=tensors["weights"],
                       offsets=tensors["offsets"])


def _with_leaves(chunk: HostChunk, leaves: dict) -> HostChunk:
    return dataclasses.replace(chunk, leaves=leaves)


@dataclasses.dataclass
class StreamingGlmData:
    """A GLM dataset as a list of host chunks of ``chunk_rows`` rows each
    (the last one row-padded with weight 0).

    ``chunks`` holds the PARTS this store keeps: one a chunk unsharded;
    with ``n_shards = k``, the held shards' parts of every chunk in (chunk,
    shard) order, each ``per_shard`` rows (:meth:`part_rows` says which
    rows).  ``held`` lists the shards kept (None: all k, logical shards; a
    process-group rank keeps its own).  ``staging[p]`` and ``staged[p]`` are
    part p's staging plan and its dtype-segregated buffers;
    ``chunks[p].leaves`` are zero-copy views into ``staged[p]``.
    ``device`` is the device the layout was built for (the kernel layout on
    CUDA, COO on the CPU).  ``row_block`` is the ``[start, stop)`` of a
    global row space the store's rows are (a rank's ``host_local_rows``
    under a group of several hosts), None when they are all of it."""

    chunks: list  # list[HostChunk], one a held part
    n_rows: int  # real (unpadded) rows over all chunks
    n_features: int
    chunk_rows: int
    device: torch.device
    staging: Optional[list] = None  # list[ChunkStaging], one per part
    staged: Optional[list] = None  # per part: tuple of staging buffers
    n_shards: int = 1
    held: Optional[tuple] = None
    row_block: Optional[tuple] = None
    _nonzero_offsets: Optional[bool] = dataclasses.field(
        default=None, repr=False, compare=False)

    @property
    def held_shards(self) -> tuple:
        return (tuple(range(self.n_shards)) if self.held is None
                else tuple(self.held))

    @property
    def per_shard(self) -> int:
        return self.chunk_rows // self.n_shards

    @property
    def n_chunks(self) -> int:
        return len(self.chunks) // len(self.held_shards)

    def part_rows(self, p: int) -> tuple:
        """(chunk, shard, first padded row) of part ``p``."""
        held = self.held_shards
        c, s = divmod(p, len(held))
        s = held[s]
        return c, s, c * self.chunk_rows + s * self.per_shard

    @property
    def kind(self) -> str:
        return self.chunks[0].kind

    def nbytes(self) -> int:
        """Host bytes held by all chunk leaves."""
        return int(sum(a.nbytes for c in self.chunks
                       for a in c.leaves.values()))

    def has_nonzero_offsets(self) -> bool:
        """Whether any chunk carries a nonzero offset (computed once: the
        streamed GAME fixed effect refuses such stores, its offsets riding
        the coordinate-descent total)."""
        if self._nonzero_offsets is None:
            self._nonzero_offsets = any(
                bool(np.any(np.asarray(c.leaves["offsets"]) != 0))
                for c in self.chunks)
        return self._nonzero_offsets

    def ensure_staged(self) -> bool:
        """Pack the chunks into staging buffers if they are not already
        (hand-built stores; builder output is staged).  Disk-backed
        (memmap-leaf) stores are left alone: packing them would bring the
        whole store into RAM.  Returns whether the store is staged."""
        if self.staged is not None:
            return True
        if not self.chunks or any(isinstance(a, np.memmap)
                                  for a in self.chunks[0].leaves.values()):
            return False
        plans, staged, chunks = [], [], []
        for c in self.chunks:
            plan = plan_staging(c.leaves)
            bufs = pack_chunk(plan, c.leaves)
            plans.append(plan)
            staged.append(bufs)
            chunks.append(_with_leaves(c, chunk_view(plan, bufs)))
        self.staging, self.staged, self.chunks = plans, staged, chunks
        return True


def spill_tree(tree, dir_: str, tag: str):
    """Replace a dictionary's (or sequence's) non-empty numpy leaves with
    disk-backed memmaps, one ``.npy`` per leaf under ``dir_``; downstream
    code reads ``np.memmap`` as any ndarray."""
    os.makedirs(dir_, exist_ok=True)

    def spill(key, leaf):
        if isinstance(leaf, np.ndarray) and leaf.size > 0:
            path = os.path.join(dir_, f"{tag}_{key}.npy")
            np.save(path, np.ascontiguousarray(leaf))
            return np.load(path, mmap_mode="r")
        return leaf

    if isinstance(tree, dict):
        return {k: spill(k, v) for k, v in tree.items()}
    return [spill(i, v) for i, v in enumerate(tree)]


def spill_random_effect_dataset(dataset, dir_: str):
    """A host random-effect dataset (``build_random_effect_dataset(...,
    device=False)``) with every block's leaves on disk, for the out-of-core
    coordinates when even the host copy exceeds RAM: the blocks page
    through the OS cache as pass groups slice them."""

    def spill_block(block, tag):
        if block is None:
            return None
        leaves = spill_tree({k: getattr(block, k) for k in block.LEAVES},
                            dir_, tag)
        return dataclasses.replace(block, **leaves)

    return dataclasses.replace(
        dataset,
        blocks=[spill_block(b, f"re_block{i}")
                for i, b in enumerate(dataset.blocks)],
        passive_blocks=[spill_block(b, f"re_passive{i}")
                        for i, b in enumerate(dataset.passive_blocks)],
    )


def make_streaming_glm_data(
    features,
    labels,
    weights=None,
    offsets=None,
    chunk_rows: int = 1 << 20,
    use_kernel: bool | str = "auto",
    n_shards: int = 1,
    storage_dir: Optional[str] = None,
    device=None,
    mesh=None,
) -> StreamingGlmData:
    """Cut already-materialized host data into chunks: a wrapper over
    :func:`streaming_from_blocks` with the whole dataset as one block.
    ``features``: a numpy 2-D array or a scipy sparse matrix."""
    n = features.shape[0]
    weights = (np.ones(n, np.float32) if weights is None
               else np.asarray(weights, np.float32))
    offsets = (np.zeros(n, np.float32) if offsets is None
               else np.asarray(offsets, np.float32))
    return streaming_from_blocks(
        [(features, np.asarray(labels, np.float32), weights, offsets)],
        n_features=features.shape[1], chunk_rows=chunk_rows,
        use_kernel=use_kernel, n_shards=n_shards, storage_dir=storage_dir,
        device=device, mesh=mesh,
    )


def _host_chunk(mode: str, X, y, w, o, chunk_rows: int, d: int) -> HostChunk:
    """One finished chunk's host layout (X has exactly ``chunk_rows``
    rows)."""
    leaves = {"labels": y, "weights": w, "offsets": o}
    meta: dict = {}
    if mode == "dense":
        leaves["X.data"] = np.ascontiguousarray(X, np.float32)
    else:
        coo = X.tocoo()
        if mode == "kernel":
            layout = build_cuda_layout(
                coo.row.astype(np.int64), coo.col.astype(np.int64),
                coo.data.astype(np.float32), chunk_rows, d, keep_coo=False)
            leaves.update({f"X.{f}": layout.arrays[f] for f in LAYOUT_FIELDS})
            meta = {"row_group": layout.row_group,
                    "col_group": layout.col_group,
                    "unit_vals": layout.unit_vals}
        else:
            r, c, v = canonicalize_coo(coo.row, coo.col,
                                       coo.data.astype(np.float32),
                                       chunk_rows, d)
            leaves.update({f"X.{k}": a for k, a in
                           coo_parts(r, c, v, chunk_rows, d).items()})
    return HostChunk(kind=mode, leaves=leaves, n_rows=chunk_rows, n_cols=d,
                     meta=meta)


def streaming_from_blocks(
    blocks: Iterable,
    n_features: int,
    chunk_rows: int = 1 << 20,
    use_kernel: bool | str = "auto",
    n_shards: int = 1,
    storage_dir: Optional[str] = None,
    device=None,
    mesh=None,
) -> StreamingGlmData:
    """Build the chunk store from an iterator of ``(X, y[, w[, o]])``
    blocks, re-cut to ``chunk_rows`` boundaries as they arrive: each chunk's
    layout is built, staged (and, with ``storage_dir``, spilled) the moment
    it fills, and its raw rows are dropped.

    ``n_shards = k > 1`` cuts every chunk into k shard parts (``chunk_rows``
    rounded up to a multiple of k, as the reference does); under a process
    group (``mesh``) k is the group's size and only this rank's part of
    each chunk is built and kept.

    Blocks may be scipy sparse or numpy (the first block decides).
    ``use_kernel`` picks the sparse chunk layout as ``make_glm_data`` does:
    ``True`` the kernel's CSR/CSC layout, ``False`` COO, ``"auto"`` the
    kernel when ``device`` (CUDA by default) is a CUDA device.
    ``storage_dir`` must be empty or missing."""
    import scipy.sparse as sp

    if chunk_rows <= 0:
        raise ValueError(f"chunk_rows must be positive, got {chunk_rows}")
    held = None
    if mesh is not None:
        if n_shards not in (1, mesh.size):
            raise ValueError(f"n_shards={n_shards} under a group of "
                             f"{mesh.size} ranks")
        n_shards, held = mesh.size, (mesh.rank,)
    if n_shards < 1:
        raise ValueError(f"n_shards must be >= 1, got {n_shards}")
    if n_shards > 1 and chunk_rows % n_shards:
        chunk_rows = -(-chunk_rows // n_shards) * n_shards
    per_shard = chunk_rows // n_shards
    parts = tuple(range(n_shards)) if held is None else held
    dev = resolve_device(device)
    if storage_dir is not None:
        os.makedirs(storage_dir, exist_ok=True)
        if os.listdir(storage_dir):
            # A reused directory would leave an earlier build's chunk files
            # beside this one's.
            raise ValueError(
                f"storage_dir {storage_dir!r} is not empty; point each "
                "build at a fresh directory (or clear it first)"
            )
    d = int(n_features)

    buf: list = []  # raw (X, y, w, o) blocks not yet cut
    buf_off = 0  # rows of buf[0] already consumed
    buffered = 0
    n_rows = 0
    mode = None
    chunks: list = []
    plans: list = []
    staged: list = []

    def finish(X, y, w, o) -> None:
        c = len(chunks) // len(parts)
        for sh in parts:
            rows = slice(sh * per_shard, (sh + 1) * per_shard)
            chunk = _host_chunk(mode, X[rows], y[rows], w[rows], o[rows],
                                per_shard, d)
            plan = plan_staging(chunk.leaves)
            bufs = pack_chunk(plan, chunk.leaves)
            if storage_dir is not None:
                tag = f"chunk{c}" if n_shards == 1 else f"chunk{c}_shard{sh}"
                spilled = []
                for b, arr in enumerate(bufs):
                    path = os.path.join(storage_dir, f"{tag}_stage{b}.npy")
                    np.save(path, arr)
                    spilled.append(np.load(path, mmap_mode="r"))
                bufs = tuple(spilled)
            plans.append(plan)
            staged.append(bufs)
            chunks.append(_with_leaves(chunk, chunk_view(plan, bufs)))

    def pop_rows(take: int):
        """Copy exactly ``take`` rows off the front of the buffer (a cursor
        walks the straddling first block, so each cut touches one chunk's
        rows)."""
        nonlocal buffered, buf_off
        parts = []
        got = 0
        while got < take:
            X, y, w, o = buf[0]
            use = min(X.shape[0] - buf_off, take - got)
            lo, hi = buf_off, buf_off + use
            parts.append((X[lo:hi], y[lo:hi], w[lo:hi], o[lo:hi]))
            got += use
            buf_off += use
            if buf_off == X.shape[0]:
                buf.pop(0)
                buf_off = 0
        buffered -= take
        Xs = [p[0] for p in parts]
        X = np.vstack(Xs) if mode == "dense" else sp.vstack(Xs).tocsr()
        return (X, *(np.concatenate([p[i] for p in parts])
                     for i in (1, 2, 3)))

    def drain(final: bool) -> None:
        while buffered >= chunk_rows or (final and buffered > 0):
            take = min(buffered, chunk_rows)
            X, y, w, o = pop_rows(take)
            pad = chunk_rows - take
            if pad:
                if mode == "dense":
                    X = np.concatenate([X, np.zeros((pad, d), np.float32)])
                else:
                    X = sp.vstack([X, sp.csr_matrix((pad, d),
                                                    dtype=np.float32)]
                                  ).tocsr()
                zeros = np.zeros(pad, np.float32)
                y, w, o = (np.concatenate([a, zeros]) for a in (y, w, o))
            finish(X, y, w, o)

    for block in blocks:
        X, y = block[0], block[1]
        m = X.shape[0]
        w = (np.asarray(block[2], np.float32)
             if len(block) > 2 and block[2] is not None
             else np.ones(m, np.float32))
        o = (np.asarray(block[3], np.float32)
             if len(block) > 3 and block[3] is not None
             else np.zeros(m, np.float32))
        if X.shape[1] != d:
            raise ValueError(f"block has {X.shape[1]} features, expected {d}")
        if mode is None:
            if sp.issparse(X):
                uk = use_kernel
                if uk == "auto":
                    uk = dev.type == "cuda"
                mode = "kernel" if uk else "coo"
            elif use_kernel is True:
                raise ValueError("use_kernel=True needs sparse features")
            else:
                mode = "dense"
        if mode == "dense":
            X = (X.toarray() if sp.issparse(X) else np.asarray(X)).astype(
                np.float32, copy=False)
        else:
            X = sp.csr_matrix(X) if not sp.issparse(X) else X.tocsr()
            X.sum_duplicates()
        buf.append((X, np.asarray(y, np.float32), w, o))
        buffered += m
        n_rows += m
        drain(final=False)
    if mode is None:
        raise ValueError("no blocks")
    drain(final=True)
    return StreamingGlmData(
        chunks=chunks, n_rows=n_rows, n_features=d, chunk_rows=chunk_rows,
        device=dev, staging=plans, staged=staged, n_shards=n_shards,
        held=held,
    )
