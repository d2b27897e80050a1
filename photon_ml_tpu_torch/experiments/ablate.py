"""The SpMV kernel with parts taken away (the counterpart of
``experiments/exp_ablate.py``).

    python -m photon_ml_tpu_torch.experiments.ablate [--rows N] [--device D]

The reference ablates the TPU tile kernel on its production layout to find
its dominant cost.  Here the production kernels of ``csrc/spmv.cu`` run on
the port's production layout — the row kernel on the CSR of
``build_cuda_matrix`` for matvec, the column kernel on its CSC copy and
row-block table for rmatvec — in three modes:

- ``full``     — the production kernel;
- ``nogather`` — x read at ``x[k mod n_in]``, k the entry's position in
                 ``idx``: an address that does not depend on the index (the
                 reference's ``nogather``; the column kernel then stages no
                 u in shared memory);
- ``stream``   — no x at all: the index and value streams and the segment
                 sums (the reference's ``dma``).

So ``full − nogather`` is the cost of the dependent gather and
``nogather − stream`` the cost of reading x.  The script builds the
2^20 x 8192 matrix with 32 normal values a row (seed 0, the reference's
data), checks every mode against its plain version, and times each.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.experiments import common
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse_cuda import build_cuda_matrix

N_ROWS, D, K = 1 << 20, 1 << 13, 32
#: the port's names for the reference's dma / nogather / full.
MODES = ("stream", "nogather", "full")
OPS = _kernels.ABLATE_OPS
RTOL = 1e-5
KERNEL = "spmv_ablate"


def spmv_ablate_plain(mode, indptr, idx, val, x, n_in):
    """The plain PyTorch version of each mode, over the same CSR arrays."""
    if mode == "full":
        return _kernels.spmv_plain(indptr, idx, val, x, unit=False)
    if mode == "nogather":
        k = torch.arange(idx.shape[0], device=x.device)
        val = val * x[k % n_in]
    return torch.segment_reduce(val, "sum", offsets=indptr)


def spmv_ablate(mode, indptr, idx, val, x, n_in, op, *, group=None,
                blockptr=None):
    """The valued SpMV ``y[r] = Σ_{k ∈ segment r} val[k]·x[…]`` in ablation
    ``mode`` (see the module docstring), counted under
    ``LAUNCHES["spmv_ablate_<mode>_<op>"]``.  On the card matvec runs the
    row kernel with ``group`` lanes a row and rmatvec the column kernel over
    the row-block table ``blockptr`` (the segments of ``indptr`` cut into
    row blocks) with ``group`` lanes a sub-range; CPU tensors run the plain
    version over ``indptr``; any other device raises."""
    _kernels.need(mode in MODES, f"unknown mode {mode!r}; expected one of "
                  f"{MODES}", KERNEL)
    _kernels.need(op in OPS, f"unknown op {op!r}; expected one of {OPS}",
                  KERNEL)
    _kernels.need(n_in >= 1, "n_in must be positive", KERNEL)
    _kernels.check_csr(indptr, idx, val, x, n_in, unit=False, kernel=KERNEL)
    if x.device.type == "cpu":
        return spmv_ablate_plain(mode, indptr, idx, val, x, n_in)
    key = f"{KERNEL}_{mode}_{op}"
    code = _kernels.ABLATE_MODES.index(mode)
    _kernels.need(group is not None, f"{op} needs the kernel's group",
                  KERNEL)
    if op == "matvec":
        return _kernels.launch_rows(code, key, indptr, idx, val, x,
                                    group=group, n_in=n_in, unit=False,
                                    square=False)
    _kernels.need(blockptr is not None
                  and blockptr.shape[0] == indptr.shape[0] - 1,
                  "rmatvec needs the row-block table of indptr's segments",
                  KERNEL)
    _kernels.check_blocks(blockptr, idx, val, x, n_in, unit=False,
                          kernel=KERNEL)
    return _kernels.launch_cols(code, key, blockptr, idx, val, x,
                                group=group, n_in=n_in, unit=False,
                                square=False)


def side(M, op):
    """``(indptr, idx, val, n_in, layout)`` of the orientation ``op`` runs
    on: the CSR for matvec (layout: its row group), the CSC copy for rmatvec
    (layout: its row-block table and column group).  ``layout`` is the
    keyword arguments of :func:`spmv_ablate`."""
    if op == "matvec":
        return (M.f_indptr, M.f_idx, M.f_val, M.n_cols,
                {"group": M.row_group})
    return (M.b_indptr, M.b_idx, M.b_val, M.n_rows,
            {"blockptr": M.b_blockptr, "group": M.col_group})


def operand(M, op, seed: int = 1):
    """A normal input vector for ``op`` on ``M``, from ``seed``."""
    n_in = side(M, op)[3]
    x = np.random.default_rng(seed).normal(size=n_in).astype(np.float32)
    return torch.as_tensor(x, device=M.device)


def run_mode(mode, M, op):
    """Time one mode on the valued matrix ``M`` for ``op``: ``(ms, clock)``,
    the median of single launches."""
    indptr, idx, val, n_in, layout = side(M, op)
    x = operand(M, op)
    return common.timed_ms(
        lambda: spmv_ablate(mode, indptr, idx, val, x, n_in, op, **layout),
        M.device)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--rows", type=int, default=N_ROWS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.rows
    rng = np.random.default_rng(0)
    nnz = n * K
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    cols = rng.integers(0, D, size=nnz).astype(np.int64)
    vals = rng.normal(size=nnz).astype(np.float32)
    M = build_cuda_matrix(rows, cols, vals, n, D, unit_values=False,
                          device=dev)
    print(f"{n} x {D}, {M.f_idx.shape[0]} streamed entries, on "
          f"{common.describe(dev)}")

    times = {op: {} for op in OPS}
    for op in OPS:
        indptr, idx, val, n_in, layout = side(M, op)
        x = operand(M, op)
        for mode in MODES:
            y = spmv_ablate(mode, indptr, idx, val, x, n_in, op, **layout)
            ref = spmv_ablate_plain(mode, indptr, idx, val, x, n_in)
            scale = spmv_ablate_plain(mode, indptr, idx, val.abs(), x.abs(),
                                      n_in)
            err = float((y - ref).abs().max()) if y.numel() else 0.0
            if not bool(((y - ref).abs() <= RTOL * scale).all()):
                raise RuntimeError(f"{KERNEL} {mode} {op}: kernel vs plain "
                                   f"beyond rtol {RTOL}")
            ms, clock = run_mode(mode, M, op)
            times[op][mode] = ms
            print(f"{op:8s} {mode:10s} {ms:8.4f} ms/pass ({clock})  "
                  f"max|kernel - plain| {err:.3g}")
        t = times[op]
        print(f"{op}: full - nogather = {t['full'] - t['nogather']:.4f} ms "
              f"(the dependent gather), nogather - stream = "
              f"{t['nogather'] - t['stream']:.4f} ms (reading x), stream = "
              f"{t['stream']:.4f} ms (index and value streams)")
    return {"rows": n, "ms": times}


if __name__ == "__main__":
    main()
