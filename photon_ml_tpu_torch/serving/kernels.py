"""GAME scoring math (port of ``photon_ml_tpu/serving/kernels.py``).

Both scoring surfaces route through this module:

- **Batch** (``GameTransformer`` → ``game_scoring_driver``): host compute
  over whole datasets — :func:`fixed_effect_matvec` (a scipy CSR matvec),
  :func:`random_effect_block_scores` (pre-grouped block gather + einsum,
  ``np.add.at`` into the row space, deterministic) and :func:`sum_margins`
  (offset + per-coordinate margins).
- **Online** (``serving.runtime.ScoringRuntime``):
  :func:`build_fused_bucket_kernel` / :func:`build_bucket_kernel` return
  the padded-bucket margin program over :func:`serve_margins`, and
  :func:`dense_coefficient_rows` materializes the cold tail's per-entity
  coefficients on the host for it.

Numerical contract of the online path: a row's margin and mean are
bit-identical whatever bucket it is padded into and whoever its
batch-mates are, whether its entity is hot or cold, and between the fused
and the composed argument layouts.  The reference gets this from XLA's row
reductions; on CUDA ``torch.sum(dim=1)`` picks its blocking from the
number of output rows, so the port spells out ONE summation order that
depends only on a coordinate's width and keeps it on both sides:

- on the card, ``csrc/serve_margins.cu`` (one warp a row: lane ``l`` sums
  columns ``d ≡ l (mod 32)`` in increasing ``d``, then an xor-shuffle tree
  over 16, 8, 4, 2, 1, every step an explicit round-to-nearest add);
- on the CPU, :func:`serve_margins_plain`, the same order in elementwise
  torch ops (each output element rounds alone, so the bits cannot depend
  on the row's position).  The mean link on the CPU is evaluated one
  element at a time in float32 (CPU ``torch.exp``/``torch.sigmoid`` round
  a vector loop's tail apart from its body, and a bucket-1 row is all
  tail).

:func:`serve_margins` launches the kernel on CUDA tensors (or raises) and
runs the plain version on CPU tensors; nothing falls back from the card.
The runtime's card path launches from a prebuilt argument block instead
(:class:`Coords`, :func:`launch_block`, :func:`launch`): built once per
(runtime, bucket) over the bucket's page-locked staging buffers, which the
kernel reads and writes in place (:func:`mapped_pointer` refuses memory
the card cannot address), so a batch is one ctypes call and one launch,
with no copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from photon_ml_tpu_torch.device import to_numpy
from photon_ml_tpu_torch.game.model import RandomEffectModel
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops import losses as losses_lib

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Host batch path (GameTransformer / game_scoring_driver)
# ---------------------------------------------------------------------------

def fixed_effect_matvec(shard_matrix, means) -> np.ndarray:
    """Fixed-effect margins of a whole scoring shard: one CSR matvec.
    ``means`` may be a tensor on any device."""
    w = to_numpy(means).astype(np.float32, copy=False)
    return np.asarray(shard_matrix @ w, np.float32).ravel()


def random_effect_block_scores(model: RandomEffectModel,
                               dataset) -> np.ndarray:
    """Score a pre-grouped random-effect dataset (its blocks on the host)
    through the block pipeline; entities without trained coefficients (and
    padding lanes) contribute zero."""
    n = dataset.n_global_rows
    out = np.zeros(n + 1, np.float32)
    for block, block_ids in zip(dataset.blocks, dataset.entity_ids):
        coefs = model.coefficient_matrix_for(to_numpy(block.col_map),
                                             block_ids)
        scores = np.einsum("erd,ed->er", to_numpy(block.X), coefs)
        np.add.at(out, to_numpy(block.row_index).ravel(), scores.ravel())
    return out[:n]


def sum_margins(n_rows: int, offset: Optional[np.ndarray],
                parts: Sequence[np.ndarray]) -> np.ndarray:
    """Offset + per-coordinate margin sum (the GAME score definition)."""
    total = (np.zeros(n_rows, np.float32) if offset is None
             else np.asarray(offset, np.float32).copy())
    for p in parts:
        total += p
    return total


# ---------------------------------------------------------------------------
# Shared gather: sparse per-entity table -> dense coefficient rows
# ---------------------------------------------------------------------------

def dense_coefficient_rows(model: RandomEffectModel,
                           entity_ids: Sequence) -> np.ndarray:
    """Materialize ``(B, n_features)`` dense coefficient rows from the
    entity→(cols, vals) table — the host-side gather behind the online
    cold tail and hot-set fills.  Unknown entities (and ``None``) get the
    zero row, the same join-miss semantics as batch scoring."""
    out = np.zeros((len(entity_ids), model.n_features), np.float32)
    table = model.coefficients
    for i, key in enumerate(entity_ids):
        entry = table.get(key) if key is not None else None
        if entry is not None:
            cols, vals = entry
            out[i, cols] = vals
    return out


# ---------------------------------------------------------------------------
# Online bucket margins (ScoringRuntime)
# ---------------------------------------------------------------------------

#: lanes of one row's reduction (a warp on the card).
LANES = 32
#: the mean links the kernel knows, by its C enumeration.
LINKS = {"identity": 0, "logistic": 1, "exp": 2}
#: the most fixed / random coordinates one launch takes
#: (``kMaxFixed`` / ``kMaxRandom`` in ``csrc/serve_margins.cu``).
MAX_FIXED = 8
MAX_RANDOM = 8


def link_for_task(task: str) -> str:
    """The mean link of a loss (a name or task alias): logistic → the
    sigmoid, Poisson → exp, squared and smoothed hinge → the identity
    (``ops/losses.py``)."""
    name = losses_lib.get(task).name
    return {"logistic": "logistic", "poisson": "exp"}.get(name, "identity")


def lane_sum(prod: Tensor) -> Tensor:
    """Row sums of ``prod`` (B, D) in the kernel's order: lane ``l`` adds
    columns ``l, l+32, ...`` from zero, then the xor tree 16, 8, 4, 2, 1."""
    b, d = prod.shape
    acc = torch.zeros((b, LANES), dtype=prod.dtype, device=prod.device)
    for start in range(0, d, LANES):
        chunk = prod[:, start:start + LANES]
        w = chunk.shape[1]
        if w == LANES:
            acc = acc + chunk
        else:
            acc[:, :w] = acc[:, :w] + chunk
    lanes = torch.arange(LANES, device=prod.device)
    for off in (16, 8, 4, 2, 1):
        acc = acc + acc.index_select(1, lanes ^ off)
    return acc[:, 0]


def _link_scalar(v: np.float32, link: str) -> np.float32:
    if link == "logistic":
        one = np.float32(1.0)
        if v >= 0:
            return one / (one + np.exp(-v))
        e = np.exp(v)
        return e / (one + e)
    return np.exp(v)


def mean_link_plain(margins: Tensor, link: str) -> Tensor:
    """The mean link in float32 with the kernel's stable logistic split.
    On the CPU one element at a time, so a row's bits do not depend on its
    position; on the card as elementwise torch ops."""
    if link == "identity":
        return margins.clone()
    if margins.device.type == "cpu":
        vals = margins.numpy()
        out = np.empty_like(vals)
        with np.errstate(over="ignore"):
            for i, v in enumerate(vals):
                out[i] = _link_scalar(v, link)
        return torch.from_numpy(out)
    if link == "logistic":
        pos = margins >= 0
        e = torch.exp(torch.where(pos, -margins, margins))
        return torch.where(pos, 1.0 / (1.0 + e), e / (1.0 + e))
    return torch.exp(margins)


def serve_margins_plain(offset: Tensor, fixed: Sequence, random: Sequence,
                        link: str) -> Tensor:
    """The plain PyTorch version of the kernel: the same function and the
    same summation order.  ``fixed`` holds ``(x (B, D), w (D,))`` pairs,
    ``random`` holds ``(x (B, D), table (H+1, D), slots (B,), cold (B, D))``
    tuples; returns the stacked ``(2, B)`` margins and means."""
    total = offset.clone()
    for x, w in fixed:
        total = total + lane_sum(x * w)
    for x, table, slots, cold in random:
        coefs = table.index_select(0, slots.long()) + cold
        total = total + lane_sum(x * coefs)
    return torch.stack([total, mean_link_plain(total, link)])


def _check(offset, fixed, random, link, model_device=None) -> torch.device:
    """Refuse operands the kernel does not take.  The request side
    (offsets, features, slots, cold rows) lives on the offsets' device, the
    model side (fixed means, hot tables) on ``model_device`` (default the
    same)."""
    need = _kernels.need
    need(link in LINKS, f"unknown link {link!r}", "serve_margins")
    dev = offset.device
    model_dev = dev if model_device is None else model_device
    _kernels.check_device(dev, "serve_margins")
    need(offset.dtype == torch.float32 and offset.dim() == 1,
         "offset must be a 1-D float32 tensor", "serve_margins")
    b = offset.shape[0]
    need(len(fixed) <= MAX_FIXED and len(random) <= MAX_RANDOM,
         f"at most {MAX_FIXED} fixed and {MAX_RANDOM} random coordinates",
         "serve_margins")

    def block(x, d, what):
        need(x.dtype == torch.float32 and x.dim() == 2
             and x.shape == (b, d) and (d <= 1 or x.stride(1) == 1),
             f"{what} must be a ({b}, {d}) float32 view with contiguous "
             "columns", "serve_margins")
        need(x.device == dev, "all operands must live on one device",
             "serve_margins")

    for x, w in fixed:
        need(w.dtype == torch.float32 and w.dim() == 1 and w.is_contiguous()
             and w.device == model_dev,
             "a fixed coefficient vector must be a contiguous 1-D float32 "
             "tensor on the model's device", "serve_margins")
        block(x, w.shape[0], "fixed features")
    for x, table, slots, cold in random:
        need(table.dtype == torch.float32 and table.dim() == 2
             and table.is_contiguous() and table.device == model_dev,
             "a hot table must be a contiguous (H+1, D) float32 tensor on "
             "the model's device", "serve_margins")
        need(slots.dtype == torch.int32 and slots.shape == (b,)
             and slots.is_contiguous() and slots.device == dev,
             f"slots must be a contiguous ({b},) int32 tensor",
             "serve_margins")
        block(x, table.shape[1], "random-effect features")
        block(cold, table.shape[1], "cold rows")
    return dev


def _array(ctype, values) -> ctypes.Array:
    values = list(values)
    return (ctype * len(values))(*values)


def _ptrs(tensors) -> ctypes.Array:
    return _array(ctypes.c_void_p, (t.data_ptr() for t in tensors))


def _lls(values) -> ctypes.Array:
    return _array(ctypes.c_longlong, (int(v) for v in values))


def _ints(values) -> ctypes.Array:
    return _array(ctypes.c_int, (int(v) for v in values))


def serve_margins(offset: Tensor, fixed: Sequence, random: Sequence,
                  link: str) -> Tensor:
    """One padded bucket's ``(2, B)`` margins and means (arguments as in
    :func:`serve_margins_plain`; feature blocks may be row-strided views).
    CUDA tensors launch ``csrc/serve_margins.cu`` on the current stream of
    their device (or raise); CPU tensors run the plain version."""
    dev = _check(offset, fixed, random, link)
    if dev.type == "cpu":
        return serve_margins_plain(offset, fixed, random, link)
    out = torch.empty((2, offset.shape[0]), dtype=torch.float32,
                      device=dev)
    _library()
    _kernels.launch("serve_margins", "photon_serve_margins", "serve_margins",
                    dev, *launch_args(offset, fixed, random, link, out))
    return out


def launch_args(offset: Tensor, fixed: Sequence, random: Sequence,
                link: str, out: Tensor) -> tuple:
    """The C arguments of ``photon_serve_margins`` (all but the stream):
    pointers, row strides in floats, widths, the link and the row count."""
    fx = [x for x, _ in fixed]
    rx = [r[0] for r in random]
    cold = [r[3] for r in random]
    return (
        offset.data_ptr(), offset.stride(0),
        len(fixed), _ptrs(fx), _lls(x.stride(0) for x in fx),
        _ptrs(w for _, w in fixed), _ints(w.shape[0] for _, w in fixed),
        len(random), _ptrs(rx), _lls(x.stride(0) for x in rx),
        _ptrs(cold), _lls(c.stride(0) for c in cold),
        _ptrs(r[1] for r in random), _ptrs(r[2] for r in random),
        _ints(r[1].shape[1] for r in random),
        LINKS[link], out.data_ptr(), offset.shape[0],
    )


# ---------------------------------------------------------------------------
# Prebuilt launches: the runtime's bucket path
# ---------------------------------------------------------------------------

_VP, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int


class Coords(ctypes.Structure):
    """The kernel's argument block, field for field the ``Coords`` of
    ``csrc/serve_margins.cu`` (the library's reported layout is checked
    against this one when it loads)."""

    _fields_ = [
        ("offset", _VP), ("offset_stride", _LL),
        ("n_fixed", _I), ("n_random", _I), ("link", _I),
        ("n", _LL), ("out", _VP),
        ("fx", _VP * MAX_FIXED), ("fx_stride", _LL * MAX_FIXED),
        ("fw", _VP * MAX_FIXED), ("fd", _I * MAX_FIXED),
        ("rx", _VP * MAX_RANDOM), ("rx_stride", _LL * MAX_RANDOM),
        ("rcold", _VP * MAX_RANDOM), ("rcold_stride", _LL * MAX_RANDOM),
        ("rtable", _VP * MAX_RANDOM), ("rslot", _VP * MAX_RANDOM),
        ("rd", _I * MAX_RANDOM),
    ]


#: the fields whose offsets ``photon_serve_coords_layout`` reports, after
#: ``sizeof(Coords)``, in its order.
_LAYOUT_FIELDS = ("offset", "n", "out", "fx", "fd", "rx", "rslot", "rd")

_CHECKED: set = set()


def _library(name: str = "serve_margins"):
    """The ``serve_margins`` library (or a :func:`_kernels.variant` of it),
    its ``Coords`` layout checked against :class:`Coords` at first use (a
    mismatch would hand the kernel wrong pointers)."""
    lib = _kernels.load_library(name)
    if name not in _CHECKED:
        vals = (ctypes.c_longlong * 16)()
        n = lib.photon_serve_coords_layout(vals, 16)
        want = [ctypes.sizeof(Coords)] + [getattr(Coords, f).offset
                                          for f in _LAYOUT_FIELDS]
        if list(vals[:n]) != want:
            raise RuntimeError(
                f"serve_margins: the library's Coords layout {list(vals[:n])}"
                f" differs from serving/kernels.py's {want}")
        _CHECKED.add(name)
    return lib


def _index(device: torch.device) -> int:
    return (torch.cuda.current_device() if device.index is None
            else device.index)


def mapped_pointer(t: Tensor, what: str, device: torch.device) -> int:
    """The address at which ``device`` reads the host tensor ``t``: ``t``
    must lie in page-locked host memory that the card can address (under
    unified addressing, any ``pin_memory`` tensor).  Raises ``ValueError``
    naming ``what`` for anything else (pageable memory has no device
    address, and nothing falls back to a copy)."""
    _kernels.need(t.device.type == "cpu", f"{what} is on {t.device}, not "
                  "in host memory", "serve_margins")
    if t.numel() == 0:
        return t.data_ptr()  # never read
    base = t.untyped_storage().data_ptr()
    dev_base = ctypes.c_void_p()
    rc = _library().photon_serve_mapped(base, _index(device),
                                        ctypes.byref(dev_base))
    _kernels.need(rc == 0, f"{what} is not page-locked host memory that "
                  f"{device} can address (cudaPointerGetAttributes: "
                  f"{'not mapped host memory' if rc == 1 else rc}); allocate "
                  "it with pin_memory=True", "serve_margins")
    return dev_base.value + (t.data_ptr() - base)


def launch_block(offset: Tensor, fixed: Sequence, random: Sequence,
                 link: str, out: Tensor, address=None) -> Coords:
    """The kernel's argument block for these operands (as
    :func:`serve_margins` takes them, plus the ``(2, B)`` output): the
    fields :func:`launch_args` passes, in one :class:`Coords`.
    ``address(tensor)`` gives the pointer the card reads each operand at
    (default ``data_ptr``)."""
    address = address or (lambda t: t.data_ptr())
    c = Coords()
    c.offset, c.offset_stride = address(offset), offset.stride(0)
    c.n_fixed, c.n_random = len(fixed), len(random)
    c.link, c.n, c.out = LINKS[link], offset.shape[0], address(out)
    for i, (x, w) in enumerate(fixed):
        c.fx[i], c.fx_stride[i] = address(x), x.stride(0)
        c.fw[i], c.fd[i] = address(w), w.shape[0]
    for j, (x, table, slots, cold) in enumerate(random):
        c.rx[j], c.rx_stride[j] = address(x), x.stride(0)
        c.rcold[j], c.rcold_stride[j] = address(cold), cold.stride(0)
        c.rtable[j], c.rslot[j] = address(table), address(slots)
        c.rd[j] = table.shape[1]
    return c


def launch(block: Coords, device: torch.device,
           library: str = "serve_margins", stream=None) -> None:
    """One launch of the kernel from a prebuilt block on ``stream`` (default
    the current stream of ``device``), counted under
    ``LAUNCHES["serve_margins"]`` (``library`` may be a
    :func:`_kernels.variant` of it, for design probes)."""
    lib = _library(library)
    if stream is None:
        stream = torch.cuda.current_stream(device)
    rc = lib.photon_serve_launch(ctypes.addressof(block), _index(device),
                                 stream.cuda_stream)
    if rc != 0:
        raise RuntimeError(
            f"serve_margins launch failed: CUDA error {rc} "
            f"({lib.photon_cuda_error_string(rc).decode()})")
    _kernels.count_launch("serve_margins")


def mapped_block(offset: Tensor, fixed: Sequence, random: Sequence,
                 link: str, out: Tensor, device: torch.device) -> Coords:
    """The argument block for the runtime's placement: the request side
    (offsets, features, slots, cold rows) and the ``(2, B)`` ``out`` in
    page-locked host memory that the kernel on ``device`` reads and writes
    in place, the model side (fixed means, hot tables) on ``device``."""
    device = torch.device("cuda", _index(device))
    _check(offset, fixed, random, link, model_device=device)
    _kernels.need(out.dtype == torch.float32 and out.is_contiguous()
                  and out.shape == (2, offset.shape[0]),
                  "out must be a contiguous (2, B) float32 tensor",
                  "serve_margins")

    def address(t):
        if t.device.type == "cuda":
            return t.data_ptr()
        return mapped_pointer(t, "a request-side operand", device)

    return launch_block(offset, fixed, random, link, out, address)


def serve_margins_mapped(offset: Tensor, fixed: Sequence, random: Sequence,
                         link: str, out: Tensor,
                         device: torch.device) -> Tensor:
    """:func:`serve_margins` in the runtime's placement
    (:func:`mapped_block`): one launch on ``device``'s current stream, a
    wait for it, and ``out`` holds the margins and means."""
    launch(mapped_block(offset, fixed, random, link, out, device), device)
    torch.cuda.current_stream(device).synchronize()
    return out


def launch_empty(device: torch.device) -> None:
    """One launch of an empty one-warp kernel (the launch floor of a
    latency-bound kernel), counted under ``LAUNCHES["serve_empty_probe"]``."""
    lib = _library()
    rc = lib.photon_serve_empty(torch.cuda.current_stream(device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"empty kernel launch failed: CUDA error {rc}")
    _kernels.count_launch("serve_empty_probe")


# ---------------------------------------------------------------------------
# The reference's bucket programs
# ---------------------------------------------------------------------------

def composed_operands(offsets, fixed_x, fixed_w, re_x, re_tables, re_slots,
                      re_cold) -> tuple:
    """``(offset, fixed, random)`` of the composed layout's per-coordinate
    arrays (:func:`build_bucket_kernel`'s arguments)."""
    return (offsets, list(zip(fixed_x, fixed_w)),
            list(zip(re_x, re_tables, re_slots, re_cold)))


def fused_operands(packed, slots, fixed_w, re_tables) -> tuple:
    """``(offset, fixed, random)`` as views of the fused layout's packed
    buffer (:func:`build_fused_bucket_kernel`'s arguments)."""
    fixed, random = [], []
    off = 1
    for w in fixed_w:
        d = w.shape[0]
        fixed.append((packed[:, off:off + d], w))
        off += d
    for j, table in enumerate(re_tables):
        d = table.shape[1]
        random.append((packed[:, off:off + d], table, slots[j],
                       packed[:, off + d:off + 2 * d]))
        off += 2 * d
    return packed[:, 0], fixed, random


def build_bucket_kernel(task: str):
    """The composed padded-batch program of one model structure.

    Called as ``kernel(offsets, fixed_x, fixed_w, re_x, re_tables,
    re_slots, re_cold)`` with per-coordinate tuples (the reference's
    signature): ``fixed_x[i]`` ``(B, D_i)``, ``fixed_w[i]`` ``(D_i,)``;
    ``re_x[j]`` ``(B, D_j)``, ``re_tables[j]`` the ``(H+1, D_j)`` hot set
    (row 0 zero), ``re_slots[j]`` ``(B,)`` int32 hot slots (0 = cold,
    unknown or padding), ``re_cold[j]`` ``(B, D_j)`` host-gathered rows
    (zero on hot rows).  Returns ``(margins, means)``.  It runs the same
    kernel as :func:`build_fused_bucket_kernel`, so the two agree bitwise.
    """
    link = link_for_task(task)

    def kernel(*args):
        out = serve_margins(*composed_operands(*args), link)
        return out[0], out[1]

    return kernel


def build_fused_bucket_kernel(task: str):
    """The single-round-trip program: ``kernel(packed, slots, fixed_w,
    re_tables)`` with ``packed`` ``(B, 1 + Σ fixed_dims + Σ 2·re_dims)``
    laid out as the offset column, each fixed coordinate's features, then
    per random coordinate its features followed by its cold rows, and
    ``slots`` the ``(n_random, B)`` int32 hot slots.  Returns the stacked
    ``(2, B)`` margins and means."""
    link = link_for_task(task)

    def kernel(packed, slots, fixed_w, re_tables):
        return serve_margins(*fused_operands(packed, slots, fixed_w,
                                             re_tables), link)

    return kernel
