"""Choose the column kernel's row block R and lanes a sub-range G by
measurement.

    python -m photon_ml_tpu_torch.experiments.row_block [--rows N]
        [--blocks 14,15] [--device D]

The column kernel of ``csrc/spmv.cu`` stages R rows of u in shared memory
per CTA, and R is a constant of the library (``_kernels.ROW_BLOCK``); G
lanes sum each (column, row block) sub-range, G picked on the host by
``_kernels.col_group``.  This probe builds the library once per candidate
R = 2^b (``-DPHOTON_SPMV_ROW_BLOCK=R``; one ``nvcc`` each, started
together) and runs rmatvec over the same CSC entries through a block table
of each R with each G of ``_kernels.GROUPS``, on three matrices of
``chip_smoke.py``'s phase 2: the valued and the binary 2^20 x 8192 with 32
entries a row (seeds 0 and 1), and the skewed one (2^18 rows, an
intercept and 31 zipf(1.1) columns a row, seed 2; stripes as
``build_cuda_matrix`` extracts them).  Each result is checked against the
plain version (rtol 1e-5) and timed: the median of single launches under
CUDA events on the card; on the CPU the plain version follows each table,
timed by the host clock, once per table.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.experiments import common
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse_cuda import (
    build_cuda_matrix,
    row_block_table,
)

N_ROWS, D, K = 1 << 20, 1 << 13, 32
BLOCKS = "14,15"
RTOL = 1e-5
KEY = "spmv_row_block_probe"


def matrices(n: int, device) -> dict:
    """The valued and the binary n x 8192 matrices of 32 entries a row, and
    the skewed one of n / 4 rows."""
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n, dtype=np.int64), K)
    cols = rng.integers(0, D, size=n * K)
    vals = rng.normal(size=n * K).astype(np.float32)
    valued = build_cuda_matrix(rows, cols, vals, n, D, device=device)
    keys = np.unique(rows * D
                     + np.random.default_rng(1).integers(0, D, size=n * K))
    binary = build_cuda_matrix(keys // D, keys % D,
                               np.ones(keys.size, np.float32), n, D,
                               device=device)
    rng = np.random.default_rng(2)
    m, k = n // 4, K - 1
    rows = np.repeat(np.arange(m, dtype=np.int64), k)
    cols = np.minimum(rng.zipf(1.1, size=m * k) - 1, D - 2)
    vals = rng.normal(size=m * k).astype(np.float32)
    rows = np.concatenate([rows, np.arange(m, dtype=np.int64)])
    cols = np.concatenate([cols, np.full(m, D - 1, np.int64)])
    vals = np.concatenate([vals, np.ones(m, np.float32)])
    skewed = build_cuda_matrix(rows, cols, vals, m, D, device=device)
    return {"valued": valued, "binary": binary, "skewed": skewed}


def rmatvec(M, blockptr, group, u, library: str):
    """Xᵀu of M's streamed entries over ``blockptr``: the column kernel of
    ``library`` with ``group`` lanes a sub-range on the card, the plain
    version following the same table on the CPU."""
    if u.device.type == "cpu":
        return _kernels.spmv_cols_plain(blockptr, M.b_idx, M.b_val, u,
                                        unit=M.unit_vals)
    return _kernels.launch_cols(0, KEY, blockptr, M.b_idx, M.b_val, u,
                                group=group, n_in=M.n_rows, unit=M.unit_vals,
                                square=False, library=library)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--rows", type=int, default=N_ROWS)
    p.add_argument("--blocks", default=BLOCKS,
                   help="comma-separated exponents b of R = 2^b")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    exps = [int(b) for b in args.blocks.split(",")]
    libs = {b: _kernels.variant("spmv", f"PHOTON_SPMV_ROW_BLOCK={1 << b}")
            for b in exps}
    if dev.type == "cuda":
        _kernels.build_libraries(*libs.values())
    groups = _kernels.GROUPS if dev.type == "cuda" else ("-",)
    mats = matrices(args.rows, dev)
    print(f"{args.rows} x {D} (skewed {args.rows // 4} rows), on "
          f"{common.describe(dev)}")
    times = {label: {} for label in mats}
    for label, M in mats.items():
        u = torch.as_tensor(np.random.default_rng(3).normal(
            size=M.n_rows).astype(np.float32), device=dev)
        val = None if M.unit_vals else M.b_val
        ref = _kernels.spmv_plain(M.b_indptr, M.b_idx, val, u,
                                  unit=M.unit_vals)
        scale = _kernels.spmv_plain(M.b_indptr, M.b_idx,
                                    None if val is None else val.abs(),
                                    u.abs(), unit=M.unit_vals)
        b_indptr, b_idx = M.b_indptr.cpu().numpy(), M.b_idx.cpu().numpy()
        for b in exps:
            t0 = time.perf_counter()
            table = row_block_table(b_indptr, b_idx, M.n_rows, 1 << b)
            host_s = time.perf_counter() - t0
            chosen = _kernels.col_group(np.diff(table, axis=1))
            table = torch.as_tensor(table, device=dev)
            ms = {}
            for g in groups:
                y = rmatvec(M, table, g, u, libs[b])
                if not bool(((y - ref).abs() <= RTOL * scale).all()):
                    raise RuntimeError(f"{label} R=2^{b} G={g}: column "
                                       f"kernel vs plain beyond rtol {RTOL}")
                ms[g], clock = common.timed_ms(
                    lambda g=g: rmatvec(M, table, g, u, libs[b]), dev)
            times[label][b] = ms
            ranges = (_kernels.load_library(libs[b]).photon_spmv_col_ranges(
                chosen, M.n_cols, M.n_rows) if dev.type == "cuda" else "-")
            print(f"{label:7s} rmatvec R=2^{b} ({clock}): "
                  + ", ".join(f"G={g} {t:.4f} ms" for g, t in ms.items())
                  + f"; host picks G={chosen}; {table.shape[1] - 1} row "
                  f"blocks x {ranges} column ranges; table "
                  f"{table.numel() * 8} bytes, host build {host_s:.3f} s")
    return {"rows": args.rows, "ms": times}


if __name__ == "__main__":
    main()
