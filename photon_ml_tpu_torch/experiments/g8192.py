"""The G8192 ELL mat-vec on the card (the counterpart of
``experiments/exp_g8192.py``).

    python -m photon_ml_tpu_torch.experiments.g8192 [--rows N] [--device D]

The reference gathers 33.5M values from an 8192-wide w with a Pallas
window sweep over ``dynamic_gather``.  Here the gather runs from shared
memory in the hand-written CUDA kernel ``csrc/ell_matvec.cu``: every CTA
stages w once and walks rows with one thread a row.

The script builds the reference's data (2^20 rows, 32 entries a row, seed
0), checks the first 8192 rows against numpy, and times a chain of 10
passes ``w ← w + 1e-20·m[:8192]``: captured once as a CUDA graph (the
counterpart of the reference's one jitted ``fori_loop``) and as an eager
host loop.  The margins come back as ``(N,)`` in row order; the
reference's ``(128, 1, 8192)`` output flattens to the same order.
"""

from __future__ import annotations

import argparse
import functools

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.experiments import common
from photon_ml_tpu_torch.ops import _kernels

N_ROWS = 1 << 20
K = 32
D = 8192
LANE = 8192  # rows checked against numpy: the reference's block 0
KERNEL = "ell_matvec"

_max_dim: dict[torch.device, int] = {}


def make_ell(n_rows: int = N_ROWS, k: int = K, d: int = D, seed: int = 0):
    """The reference's data: ``(cols_T, vals_T, w)`` with cols_T int32 and
    vals_T float32, both ``(k, n_rows)`` (transposed ELL: row = lane), and
    w float32 ``(d,)``, drawn in the reference's order from
    ``default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, d, size=(n_rows, k), dtype=np.int32)
    vals = rng.normal(size=(n_rows, k)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    return np.ascontiguousarray(cols.T), np.ascontiguousarray(vals.T), w


def ell_matvec_plain(cols_T, vals_T, w):
    """The plain PyTorch version: ``m[r] = Σ_j vals_T[j, r]·w[cols_T[j, r]]``."""
    return (vals_T * w[cols_T.long()]).sum(0)


def _check(cols_T, vals_T, w) -> None:
    def need(ok, what):
        _kernels.need(ok, what, KERNEL)

    need(cols_T.dtype == torch.int32 and cols_T.dim() == 2
         and cols_T.is_contiguous(),
         "cols_T must be a contiguous 2-D (k, n) int32 tensor")
    need(vals_T.dtype == torch.float32 and vals_T.shape == cols_T.shape
         and vals_T.is_contiguous(),
         "vals_T must be a contiguous float32 tensor shaped like cols_T")
    need(w.dtype == torch.float32 and w.dim() == 1 and w.shape[0] >= 1
         and w.is_contiguous(),
         "w must be a non-empty contiguous 1-D float32 tensor")
    need(cols_T.device == w.device and vals_T.device == w.device,
         "all operands must live on one device")
    _kernels.check_device(w.device, KERNEL)


def max_dim(device: torch.device) -> int:
    """The widest w (floats) one CTA can stage in shared memory on
    ``device``."""
    if device not in _max_dim:
        lib = _kernels.load_library(KERNEL)
        with torch.cuda.device(device):
            _max_dim[device] = lib.photon_ell_max_dim()
        if _max_dim[device] < 0:
            raise RuntimeError(f"{KERNEL}: shared-memory query failed on "
                               f"{device}")
    return _max_dim[device]


def ell_matvec(cols_T, vals_T, w):
    """``m = Σ_j vals_T[j]·w[cols_T[j]]`` over the transposed ELL arrays
    ``(k, n)``; returns ``(n,)``.  CUDA tensors run the kernel, CPU tensors
    the plain version; any other device raises.  ``cols_T`` must lie in
    ``[0, len(w))`` (reading it back would synchronise)."""
    _check(cols_T, vals_T, w)
    if w.device.type == "cpu":
        return ell_matvec_plain(cols_T, vals_T, w)
    k, n = cols_T.shape
    d = w.shape[0]
    limit = max_dim(w.device)
    if d > limit:
        raise ValueError(
            f"{KERNEL}: w has {d} entries ({4 * d} B), more than the "
            f"{limit} floats ({4 * limit} B) of shared memory one CTA can "
            f"opt into on {torch.cuda.get_device_name(w.device)}")
    m = torch.empty(n, dtype=torch.float32, device=w.device)
    if n == 0:
        return m
    _kernels.launch(KERNEL, "photon_ell_matvec", KERNEL, w.device,
                    cols_T.data_ptr(), vals_T.data_ptr(), w.data_ptr(),
                    m.data_ptr(), n, k, d)
    return m


def step(w, cols_T, vals_T):
    """One pass of the reference's timing loop: ``w + 1e-20·m[:D]``."""
    return w + 1e-20 * ell_matvec(cols_T, vals_T, w)[: w.shape[0]]


def chain(w, cols_T, vals_T, reps: int = common.REPS, graph: bool = True):
    """``reps`` chained passes of :func:`step` from ``w`` (the loop of
    ``exp_g8192.py:85-90``): one CUDA-graph replay on the card when
    ``graph``, else an eager loop."""
    return common.chain(functools.partial(step, cols_T=cols_T, vals_T=vals_T),
                        w, reps, graph)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--rows", type=int, default=N_ROWS)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    if args.rows < D:
        raise ValueError(f"--rows must be at least {D}: the chain feeds "
                         f"m[:{D}] back into w")
    n = args.rows
    cols_T, vals_T, w = make_ell(n)
    cols_d, vals_d, w_d = (torch.as_tensor(a, device=dev)
                           for a in (cols_T, vals_T, w))
    print(f"ELL {n} x {K} entries, w {D} wide, on {common.describe(dev)}")

    m = ell_matvec(cols_d, vals_d, w_d)
    m0 = m[:LANE].cpu().numpy()
    expect = (vals_T[:, :LANE] * w[cols_T[:, :LANE]]).sum(0)
    err = float(np.abs(m0 - expect).max())
    print("correctness max err:", err)
    if not err < 1e-3:
        raise RuntimeError(f"{KERNEL}: block 0 disagrees with numpy by {err}")

    passes = functools.partial(step, cols_T=cols_d, vals_T=vals_d)
    out = {"rows": n, "max_err": err, "reps": common.REPS}
    runs = []
    if dev.type == "cuda":
        g = common.ChainGraph(passes, w_d)
        runs.append(("graph", g.replay))
    runs.append(("eager", lambda: common.run_chain(passes, w_d, common.REPS)))
    for label, fn in runs:
        ms, clock = common.timed_ms(fn, dev)
        per_pass = ms / common.REPS
        dt = per_pass / 1e3
        print(f"ELL matvec chain ({label}, {clock}): {per_pass:.4f} ms/pass  "
              f"{n / dt / 1e6:.1f} Mrows/s  {n * K / dt / 1e9:.2f} Gnnz/s")
        out[f"{label}_ms_per_pass"] = per_pass
    if dev.type == "cuda":
        out["graph_replays"] = g.replays
    return out


if __name__ == "__main__":
    main()
