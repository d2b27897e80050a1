"""Build, bind and launch the port's hand-written CUDA kernels (``csrc/``).

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use — never at import —
into ``photon_ml_tpu_torch/_build/``, keyed by a hash of the source, the
shared headers and the compiler flags, and loaded with ``ctypes``.
:func:`build_libraries` starts one ``nvcc`` per missing library, all at
once, and waits for them together.

The libraries and the TPU kernels they replace:

- ``spmv`` — ``photon_ml_tpu/ops/sparse_pallas.py::_tile_kernel``: the row
  kernel (CSR, ``G`` lanes a row) and the column kernel (the CSC copy cut
  into row blocks of :data:`ROW_BLOCK` rows, then a combine over the
  blocks); in their ablation modes, ``experiments/exp_ablate.py``'s kernels;
- ``ell_matvec`` — ``experiments/exp_g8192.py``'s ``pallas_matvec``;
- ``window_matvec`` — ``experiments/exp_g8192_v2.py``'s ``make_matvec``;
- ``serve_margins`` — not a TPU kernel: the serving runtime's padded-bucket
  margin program (``photon_ml_tpu/serving/kernels.py``'s
  ``build_bucket_kernel`` / ``build_fused_bucket_kernel``), wrapped by
  ``serving/kernels.py::serve_margins`` and, from a prebuilt argument
  block, ``serving/kernels.py::launch_block`` (the runtime's bucket path).

:func:`spmv_rows` and :func:`spmv_cols` are the SpMV wrappers; the others
live with their experiments under ``photon_ml_tpu_torch/experiments/`` and launch through
:func:`launch`.  On a CUDA tensor a wrapper launches its kernel on
PyTorch's current stream (or raises); on a CPU tensor it runs the plain
PyTorch version of the same function.  Nothing falls back from the card to
the plain version.  Every launch adds one to its key of ``LAUNCHES``, so a
run can show that its main path went through the kernel.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("spmv", "ell_matvec", "window_matvec",
                        "serve_margins")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry points of each library: name → (argument types, result type).
SIGNATURES = {
    "spmv": {
        "photon_spmv_rows": ([_I, _I, _I, _I, _P, _P, _P, _P, _P, _LL, _LL,
                              _P], _I),
        "photon_spmv_cols": ([_I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _LL,
                              _LL, _I, _P], _I),
        "photon_spmv_row_block": ([], _I),
        "photon_spmv_col_unroll": ([], _I),
        "photon_spmv_col_ranges": ([_I, _LL, _LL], _I),
    },
    "ell_matvec": {
        "photon_ell_matvec": ([_P, _P, _P, _P, _LL, _I, _I, _P], _I),
        "photon_ell_max_dim": ([], _I),
    },
    "window_matvec": {
        "photon_window_matvec": ([_P, _P, _P, _P, _P, _LL, _P], _I),
        "photon_window_config": ([_LL, _P], _I),
    },
    "serve_margins": {
        "photon_serve_margins": ([_P, _LL, _I, _P, _P, _P, _P, _I, _P, _P,
                                  _P, _P, _P, _P, _P, _I, _P, _LL, _P], _I),
        "photon_serve_launch": ([_P, _I, _P], _I),
        "photon_serve_coords_layout": ([_P, _I], _I),
        "photon_serve_mapped": ([_P, _I, _P], _I),
        "photon_serve_empty": ([_P], _I),
    },
}

OPS = ("matvec", "rmatvec", "row_sq_matvec", "sq_rmatvec")
ROW_OPS = ("matvec", "row_sq_matvec")  # the row kernel's; the rest columns'
COL_OPS = ("rmatvec", "sq_rmatvec")
#: rows in one block of the column kernel's layout (2^15 rows: 128 KB of u
#: staged in shared memory); the built library must report the same
#: (checked at load).
ROW_BLOCK = 1 << 15
#: the kernels' lanes per row (row kernel) or per column sub-range (column
#: kernel), and the index/value loads each lane keeps in flight
#: (``kRowUnroll`` and ``kColUnroll`` in ``csrc/spmv.cu``; the library's
#: column unroll is checked at load).
GROUPS = (4, 8, 16, 32)
ROW_UNROLL = 4
COL_UNROLL = 8
#: the most lanes the host gives a column sub-range: at 32 a warp walks its
#: sub-ranges one at a time, slower than 16 on every matrix that
#: ``experiments/row_block.py`` measures (valued, binary and skewed).
COL_GROUP_MAX = 16
#: the ablation modes of the SpMV kernel, in their C enumeration order.
ABLATE_MODES = ("full", "nogather", "stream")
ABLATE_OPS = ("matvec", "rmatvec")
#: launches per kernel and operation since the last :func:`reset_launches`
#: (written under :data:`_COUNT_LOCK` only: see :func:`count_launch`).
LAUNCHES: dict[str, int] = {
    **{op + sfx: 0 for op in OPS for sfx in ("", "_unit")},
    "ell_matvec": 0,
    "window_matvec": 0,
    "window_ring_probe": 0,
    "serve_margins": 0,
    "serve_empty_probe": 0,
    "spmv_row_block_probe": 0,
    **{f"spmv_ablate_{mode}_{op}": 0
       for mode in ABLATE_MODES for op in ABLATE_OPS},
}
#: per library, what its last load did: library path, whether it was built
#: in this process, build seconds, and the ptxas lines (registers, spills).
BUILD_INFO: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


_COUNT_LOCK = threading.Lock()


def count_launch(key: str, n: int = 1) -> None:
    """Add ``n`` to ``LAUNCHES[key]``.  ``+=`` on a dict entry is a
    read-modify-write, and trials of a tuning search launch from several
    threads at once, so every count goes through this lock."""
    with _COUNT_LOCK:
        LAUNCHES[key] += n


def reset_launches() -> None:
    with _COUNT_LOCK:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def _nvcc() -> str:
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                     "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH or $CUDA_HOME/bin); the CUDA toolkit is "
        "needed to build the kernels under photon_ml_tpu_torch/csrc/"
    )


def variant(name: str, *defines: str) -> str:
    """The key of library ``name`` built with extra ``-D`` definitions
    (``"NAME=VALUE"``), for design probes; production launches use the
    plain ``name``."""
    return f"{name}[{','.join(defines)}]" if defines else name


def _split(key: str) -> tuple[str, tuple[str, ...]]:
    name, _, defines = key.partition("[")
    return name, tuple(d for d in defines.rstrip("]").split(",") if d)


def _flags(key: str) -> tuple[str, ...]:
    return NVCC_FLAGS + tuple(f"-D{d}" for d in _split(key)[1])


def _artifacts(key: str) -> tuple[Path, Path]:
    name = _split(key)[0]
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(_flags(key)).encode())
    tag = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{tag}.so", BUILD_DIR / f"lib{name}_{tag}.log"


#: Serializes builds and loads: threads that reach a missing library at
#: once (tuning trials) would share one temporary file name.
_BUILD_LOCK = threading.RLock()


def build_libraries(*names: str) -> None:
    """Build (once per hash) and load the named libraries (all by default;
    a name may be a :func:`variant` key): one ``nvcc`` per missing library,
    all started together."""
    with _BUILD_LOCK:
        _build_libraries(names)


def _build_libraries(names) -> None:
    todo = [n for n in dict.fromkeys(names or SOURCES) if n not in _LIBS]
    missing = [n for n in todo if not _artifacts(n)[0].exists()]
    builds = {}
    t0 = time.perf_counter()
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    seconds = {}
    failed = []
    try:
        for name in missing:
            so, log = _artifacts(name)
            tmp = BUILD_DIR / f".{so.name}.{os.getpid()}"
            with open(log, "w") as out:  # the child keeps its own descriptor
                proc = subprocess.Popen(
                    [nvcc, *_flags(name), "-I", str(CSRC), "-o", str(tmp),
                     str(SOURCES[_split(name)[0]])],
                    stdout=out, stderr=subprocess.STDOUT,
                )
            builds[name] = (proc, tmp)
        for name, (proc, tmp) in builds.items():
            rc = proc.wait()
            seconds[name] = time.perf_counter() - t0
            so, log = _artifacts(name)
            if rc != 0:
                tmp.unlink(missing_ok=True)
                failed.append(f"nvcc failed ({rc}) building {name}:\n"
                              f"{log.read_text()}")
            else:
                # atomic: a concurrent build never sees half
                os.replace(tmp, so)
    finally:
        # An exception mid-build (a failed launch, an interrupt) leaves no
        # compiler running behind it.
        for proc, _ in builds.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        so, log = _artifacts(name)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in SIGNATURES[_split(name)[0]].items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = restype
        lib.photon_cuda_error_string.argtypes = [_I]
        lib.photon_cuda_error_string.restype = ctypes.c_char_p
        ptxas = [
            ln.strip() for ln in (log.read_text() if log.exists() else "")
            .splitlines() if "ptxas" in ln or "spill" in ln
        ]
        BUILD_INFO[name] = dict(path=str(so), built=name in builds,
                                seconds=seconds.get(name, 0.0), ptxas=ptxas)
        if name == "spmv" and (lib.photon_spmv_row_block(),
                               lib.photon_spmv_col_unroll()) != (
                                   ROW_BLOCK, COL_UNROLL):
            raise RuntimeError(
                f"{so} was built with row blocks of "
                f"{lib.photon_spmv_row_block()} rows and a column unroll of "
                f"{lib.photon_spmv_col_unroll()}; _kernels expects "
                f"{ROW_BLOCK} and {COL_UNROLL}")
        _LIBS[name] = lib


def load_library(name: str = "spmv") -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    if name not in _LIBS:
        with _BUILD_LOCK:
            if name not in _LIBS:
                build_libraries(name)
    return _LIBS[name]


def launch(name: str, fn: str, key: str, device: torch.device,
           *args) -> None:
    """Call ``fn`` of library ``name`` with ``args`` and PyTorch's current
    stream of ``device``; raise if the launch was refused, else count it
    under ``LAUNCHES[key]``."""
    lib = load_library(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib, fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(
            f"{key} launch failed: CUDA error {rc} "
            f"({lib.photon_cuda_error_string(rc).decode()})"
        )
    count_launch(key)


def need(ok: bool, what: str, kernel: str) -> None:
    """Raise ``ValueError("<kernel>: <what>")`` unless ``ok``."""
    if not ok:
        raise ValueError(f"{kernel}: {what}")


def check_device(device: torch.device, kernel: str) -> None:
    need(device.type in ("cpu", "cuda"), f"unsupported device {device}",
         kernel)


def _group(mean: float, unroll: int) -> int:
    """The fewest of :data:`GROUPS` lanes whose ``unroll`` loads each cover
    a segment of ``mean`` entries in one round."""
    return next((g for g in GROUPS if g * unroll >= mean), GROUPS[-1])


def row_group(nnz: int, n_rows: int) -> int:
    """The row kernel's lanes per row for rows of ``nnz / n_rows`` entries
    on average (8 for 32-entry rows)."""
    return _group(nnz / max(n_rows, 1), ROW_UNROLL)


def col_group(lengths) -> int:
    """The column kernel's lanes per (column, row block) sub-range, for
    sub-ranges of the given ``lengths``: from their entry-weighted mean
    Σlen²/Σlen, the length of the sub-range an average entry lies in (a
    skewed column head makes it far longer than the plain mean), within a
    tenth, so that sub-ranges scattered about a mean of ``G·COL_UNROLL``
    keep G; at most :data:`COL_GROUP_MAX`.  16 for the ~128-entry
    sub-ranges of 2^20 rows x 8192 columns at 32 a row."""
    lengths = np.asarray(lengths, np.float64)
    total = lengths.sum()
    weighted = float((lengths * lengths).sum() / total) if total else 0.0
    return min(_group(0.9 * weighted, COL_UNROLL), COL_GROUP_MAX)


def n_row_blocks(n_rows: int, block_rows: int = ROW_BLOCK) -> int:
    """Row blocks of the column layout: ``ceil(n_rows / block_rows)``, and
    at least one."""
    return max(1, -(-n_rows // block_rows))


def col_ranges(group: int, n_cols: int, n_rows: int) -> int:
    """The column ranges of one production column launch with ``group``
    lanes a sub-range on the current card (the column kernel's grid is
    ``n_row_blocks × col_ranges``)."""
    n = load_library("spmv").photon_spmv_col_ranges(group, n_cols, n_rows)
    if n < 0:
        raise RuntimeError("photon_spmv_col_ranges: a device query failed")
    return n


def spmv_plain(indptr, idx, val, x, *, unit: bool, square: bool = False):
    """The plain PyTorch version: a gather, a multiply, and a sorted segment
    sum over the CSR segments (same arrays, same function as the kernel)."""
    g = x.index_select(0, idx)
    if not unit:
        g = g * (val * val if square else val)
    return torch.segment_reduce(g, "sum", offsets=indptr)


def spmv_cols_plain(blockptr, idx, val, x, *, unit: bool,
                    square: bool = False):
    """The column kernel's plain version, following its block table: a
    segment sum over every (column j, row block t) sub-range
    ``[blockptr[j, t], blockptr[j, t+1])``, then a sum over t."""
    n_out, n_rb = blockptr.shape[0], blockptr.shape[1] - 1
    starts = blockptr[:, :-1].reshape(-1)
    lengths = (blockptr[:, 1:] - blockptr[:, :-1]).reshape(-1)
    # The entries of every sub-range in (j, t) order, read from the table
    # alone: entry i of sub-range s sits at starts[s] + i.
    first = torch.cumsum(lengths, 0) - lengths
    pos = (torch.repeat_interleave(starts - first, lengths)
           + torch.arange(int(lengths.sum()), device=x.device))
    g = x.index_select(0, idx.index_select(0, pos))
    if not unit:
        v = val.index_select(0, pos)
        g = g * (v * v if square else v)
    partial = torch.segment_reduce(g, "sum", lengths=lengths)
    return partial.reshape(n_out, n_rb).sum(1)


def _check_operands(table, idx, val, x, n_in: int, unit: bool,
                    kernel: str) -> None:
    """Refuse what both kernels refuse (types, shapes, contiguity, one
    device); ``table`` is the indptr or block table, checked by the
    caller."""
    need(idx.dtype == torch.int32 and idx.dim() == 1 and idx.is_contiguous(),
         "idx must be a contiguous 1-D int32 tensor", kernel)
    need(x.dtype == torch.float32 and x.dim() == 1 and x.is_contiguous(),
         "x must be a contiguous 1-D float32 tensor", kernel)
    need(x.shape[0] == n_in, f"x has {x.shape[0]} entries, expected {n_in}",
         kernel)
    tensors = [table, idx, x]
    if not unit:
        need(val is not None and val.dtype == torch.float32
             and val.dim() == 1 and val.is_contiguous()
             and val.shape == idx.shape,
             "val must be a contiguous float32 tensor shaped like idx",
             kernel)
        tensors.append(val)
    need(all(t.device == x.device for t in tensors),
         "all operands must live on one device", kernel)
    check_device(x.device, kernel)


def check_csr(indptr, idx, val, x, n_in: int, unit: bool,
              kernel: str = "spmv_rows") -> None:
    """Refuse operands the row kernel does not take (types, shapes,
    contiguity, one device)."""
    need(indptr.dtype == torch.int64 and indptr.dim() == 1
         and indptr.numel() >= 1 and indptr.is_contiguous(),
         "indptr must be a contiguous 1-D int64 tensor", kernel)
    _check_operands(indptr, idx, val, x, n_in, unit, kernel)


def check_blocks(blockptr, idx, val, x, n_in: int, unit: bool,
                 kernel: str = "spmv_cols") -> None:
    """Refuse operands the column kernel does not take; on the card the
    table must have the library's row blocks."""
    need(blockptr.dtype == torch.int64 and blockptr.dim() == 2
         and blockptr.shape[1] >= 2 and blockptr.is_contiguous(),
         "blockptr must be a contiguous (n_out, n_rb + 1) int64 tensor",
         kernel)
    _check_operands(blockptr, idx, val, x, n_in, unit, kernel)
    if x.device.type == "cuda":
        need(blockptr.shape[1] - 1 == n_row_blocks(n_in),
             f"blockptr has {blockptr.shape[1] - 1} row blocks; the kernel "
             f"cuts {n_in} rows into {n_row_blocks(n_in)} blocks of "
             f"{ROW_BLOCK}", kernel)


def launch_rows(mode: int, key: str, indptr, idx, val, x, *, group: int,
                n_in: int, unit: bool, square: bool):
    """Launch the row kernel (operands already checked) in ``mode`` (0 is
    the production FULL) and count it under ``LAUNCHES[key]``."""
    need(group in GROUPS, f"group must be one of {GROUPS}, got {group}",
         "spmv_rows")
    n_out = indptr.shape[0] - 1
    y = torch.empty(n_out, dtype=torch.float32, device=x.device)
    if n_out == 0:
        return y
    launch("spmv", "photon_spmv_rows", key, x.device, mode, group, int(unit),
           int(square), indptr.data_ptr(), idx.data_ptr(),
           None if unit else val.data_ptr(), x.data_ptr(), y.data_ptr(),
           n_out, n_in)
    return y


def launch_cols(mode: int, key: str, blockptr, idx, val, x, *, group: int,
                n_in: int, unit: bool, square: bool, library: str = "spmv"):
    """Launch the column kernel and its combine (operands already checked)
    in ``mode`` and count them once under ``LAUNCHES[key]``; ``library``
    may be a :func:`variant` of ``spmv``."""
    need(group in GROUPS, f"group must be one of {GROUPS}, got {group}",
         "spmv_cols")
    n_out, n_rb = blockptr.shape[0], blockptr.shape[1] - 1
    y = torch.empty(n_out, dtype=torch.float32, device=x.device)
    if n_out == 0:
        return y
    partial = (torch.empty((n_rb, n_out), dtype=torch.float32,
                           device=x.device) if n_rb > 1 else None)
    launch(library, "photon_spmv_cols", key, x.device, mode, group,
           int(unit), int(square), blockptr.data_ptr(), idx.data_ptr(),
           None if unit else val.data_ptr(), x.data_ptr(),
           None if partial is None else partial.data_ptr(), y.data_ptr(),
           n_out, n_in, n_rb)
    return y


def _launch_key(op: str, ops, unit: bool, kernel: str) -> str:
    need(op in ops, f"unknown op {op!r}; expected one of {ops}", kernel)
    return op + ("_unit" if unit else "")


def spmv_rows(indptr, idx, val, x, *, group: int, n_in: int, op: str,
              unit: bool, square: bool = False):
    """The row side, ``y[r] = Σ_{k ∈ [indptr[r], indptr[r+1])}
    f(val[k])·x[idx[k]]``, with ``group`` lanes a row on the card.

    ``op`` names the matrix operation this launch serves (``matvec`` or
    ``row_sq_matvec``), for the launch count.  CUDA tensors run the
    kernel, CPU tensors :func:`spmv_plain`; any other device raises.  Index
    bounds are ``build_cuda_matrix``'s guarantee (reading them back would
    synchronise)."""
    key = _launch_key(op, ROW_OPS, unit, "spmv_rows")
    check_csr(indptr, idx, val, x, n_in, unit)
    if x.device.type == "cpu":
        return spmv_plain(indptr, idx, val, x, unit=unit, square=square)
    return launch_rows(0, key, indptr, idx, val, x, group=group, n_in=n_in,
                       unit=unit, square=square)


def spmv_cols(blockptr, idx, val, x, *, group: int, n_in: int, op: str,
              unit: bool, square: bool = False):
    """The column side, ``y[j] = Σ_t Σ_{k ∈ [blockptr[j, t],
    blockptr[j, t+1])} f(val[k])·x[idx[k]]`` over the CSC entries
    (``idx`` holds rows, ascending in each column), with ``group`` lanes a
    (column, row block) sub-range on the card.

    ``op`` is ``rmatvec`` or ``sq_rmatvec``.  CUDA tensors run the column
    kernel and its combine (the table's row blocks must be
    :data:`ROW_BLOCK` rows), CPU tensors :func:`spmv_cols_plain` over the
    same table; any other device raises."""
    key = _launch_key(op, COL_OPS, unit, "spmv_cols")
    check_blocks(blockptr, idx, val, x, n_in, unit)
    if x.device.type == "cpu":
        return spmv_cols_plain(blockptr, idx, val, x, unit=unit,
                               square=square)
    return launch_cols(0, key, blockptr, idx, val, x, group=group, n_in=n_in,
                       unit=unit, square=square)
