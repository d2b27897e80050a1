"""Build, bind and launch the port's hand-written CUDA kernels (``csrc/``).

Each ``csrc/<name>.cu`` is compiled with ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface at first use — never at import —
into ``photon_ml_tpu_torch/_build/``, keyed by a hash of the source, the
shared headers and the compiler flags, and loaded with ``ctypes``.
:func:`build_libraries` starts one ``nvcc`` per missing library, all at
once, and waits for them together.

The libraries and the TPU kernels they replace:

- ``spmv`` — ``photon_ml_tpu/ops/sparse_pallas.py::_tile_kernel`` (and, in
  its ablation modes, ``experiments/exp_ablate.py``'s kernels);
- ``ell_matvec`` — ``experiments/exp_g8192.py``'s ``pallas_matvec``;
- ``window_matvec`` — ``experiments/exp_g8192_v2.py``'s ``make_matvec``.

:func:`spmv` is the SpMV wrapper; the other wrappers live with their
experiments under ``photon_ml_tpu_torch/experiments/`` and launch through
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
import time
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = {name: CSRC / f"{name}.cu"
           for name in ("spmv", "ell_matvec", "window_matvec")}
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
#: the C entry points of each library: name → (argument types, result type).
SIGNATURES = {
    "spmv": {
        "photon_spmv": ([_P, _P, _P, _P, _P, _LL, _I, _I, _P], _I),
        "photon_spmv_ablate": ([_I, _P, _P, _P, _P, _P, _LL, _LL, _P], _I),
    },
    "ell_matvec": {
        "photon_ell_matvec": ([_P, _P, _P, _P, _LL, _I, _I, _P], _I),
        "photon_ell_max_dim": ([], _I),
    },
    "window_matvec": {
        "photon_window_matvec": ([_P, _P, _P, _P, _P, _LL, _P], _I),
    },
}

OPS = ("matvec", "rmatvec", "row_sq_matvec", "sq_rmatvec")
#: the ablation modes of the SpMV kernel, in their C enumeration order.
ABLATE_MODES = ("full", "nogather", "stream")
ABLATE_OPS = ("matvec", "rmatvec")
#: launches per kernel and operation since the last :func:`reset_launches`.
LAUNCHES: dict[str, int] = {
    **{op + sfx: 0 for op in OPS for sfx in ("", "_unit")},
    "ell_matvec": 0,
    "window_matvec": 0,
    **{f"spmv_ablate_{mode}_{op}": 0
       for mode in ABLATE_MODES for op in ABLATE_OPS},
}
#: per library, what its last load did: library path, whether it was built
#: in this process, build seconds, and the ptxas lines (registers, spills).
BUILD_INFO: dict[str, dict] = {}

_LIBS: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
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


def _artifacts(name: str) -> tuple[Path, Path]:
    h = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    key = h.hexdigest()[:16]
    return BUILD_DIR / f"lib{name}_{key}.so", BUILD_DIR / f"lib{name}_{key}.log"


def build_libraries(*names: str) -> None:
    """Build (once per hash) and load the named libraries (all by default):
    one ``nvcc`` per missing library, all started together."""
    todo = [n for n in dict.fromkeys(names or SOURCES) if n not in _LIBS]
    missing = [n for n in todo if not _artifacts(n)[0].exists()]
    builds = {}
    t0 = time.perf_counter()
    if missing:
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for name in missing:
        so, log = _artifacts(name)
        tmp = BUILD_DIR / f".{so.name}.{os.getpid()}"
        with open(log, "w") as out:  # the child keeps its own descriptor
            builds[name] = (subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                 str(SOURCES[name])],
                stdout=out, stderr=subprocess.STDOUT,
            ), tmp)
    seconds = {}
    failed = []
    for name, (proc, tmp) in builds.items():
        rc = proc.wait()
        seconds[name] = time.perf_counter() - t0
        so, log = _artifacts(name)
        if rc != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed ({rc}) building {SOURCES[name]}:\n"
                          f"{log.read_text()}")
        else:
            os.replace(tmp, so)  # atomic: a concurrent build never sees half
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in todo:
        so, log = _artifacts(name)
        lib = ctypes.CDLL(str(so))
        for fn, (argtypes, restype) in SIGNATURES[name].items():
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
        _LIBS[name] = lib


def load_library(name: str = "spmv") -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
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
    LAUNCHES[key] += 1


def need(ok: bool, what: str, kernel: str) -> None:
    """Raise ``ValueError("<kernel>: <what>")`` unless ``ok``."""
    if not ok:
        raise ValueError(f"{kernel}: {what}")


def check_device(device: torch.device, kernel: str) -> None:
    need(device.type in ("cpu", "cuda"), f"unsupported device {device}",
         kernel)


def spmv_plain(indptr, idx, val, x, *, unit: bool, square: bool = False):
    """The plain PyTorch version: a gather, a multiply, and a sorted segment
    sum over the CSR segments (same arrays, same function as the kernel)."""
    g = x.index_select(0, idx)
    if not unit:
        g = g * (val * val if square else val)
    return torch.segment_reduce(g, "sum", offsets=indptr)


def check_csr(indptr, idx, val, x, n_in: int, unit: bool,
              kernel: str = "spmv") -> None:
    """Refuse operands the SpMV kernel does not take (types, shapes,
    contiguity, one device)."""
    need(indptr.dtype == torch.int64 and indptr.dim() == 1
         and indptr.numel() >= 1 and indptr.is_contiguous(),
         "indptr must be a contiguous 1-D int64 tensor", kernel)
    need(idx.dtype == torch.int32 and idx.dim() == 1 and idx.is_contiguous(),
         "idx must be a contiguous 1-D int32 tensor", kernel)
    need(x.dtype == torch.float32 and x.dim() == 1 and x.is_contiguous(),
         "x must be a contiguous 1-D float32 tensor", kernel)
    need(x.shape[0] == n_in, f"x has {x.shape[0]} entries, expected {n_in}",
         kernel)
    tensors = [indptr, idx, x]
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


def spmv(indptr, idx, val, x, *, n_in: int, op: str, unit: bool,
         square: bool = False):
    """``y[r] = Σ_{k ∈ [indptr[r], indptr[r+1])} f(val[k])·x[idx[k]]``.

    ``op`` names the matrix operation this launch serves (a key of
    ``OPS``), for the launch count.  CUDA tensors run the kernel, CPU
    tensors the plain version; any other device raises.  Index bounds are
    ``build_cuda_matrix``'s guarantee (reading them back would
    synchronise)."""
    if op not in OPS:
        raise ValueError(f"spmv: unknown op {op!r}; expected one of {OPS}")
    check_csr(indptr, idx, val, x, n_in, unit)
    if x.device.type == "cpu":
        return spmv_plain(indptr, idx, val, x, unit=unit, square=square)
    n_out = indptr.shape[0] - 1
    y = torch.empty(n_out, dtype=torch.float32, device=x.device)
    if n_out == 0:
        return y
    launch("spmv", "photon_spmv", op + ("_unit" if unit else ""), x.device,
           indptr.data_ptr(), idx.data_ptr(),
           None if unit else val.data_ptr(), x.data_ptr(), y.data_ptr(),
           n_out, int(unit), int(square))
    return y
