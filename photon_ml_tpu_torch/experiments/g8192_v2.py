"""The v2 window-layout mat-vec on the card (the counterpart of
``experiments/exp_g8192_v2.py``).

    python -m photon_ml_tpu_torch.experiments.g8192_v2 [--rows N] [--device D]

The same ELL mat-vec as ``g8192`` over the reference's v2 layout: per
8192-row block, each entry sits at sublane ``window·64 + depth`` (window =
column // 128) and lane ``row % 128``, with ``lo = column % 128`` and
``rhi = (row % 8192) // 128`` beside its value.  The layout is built on
the host by :func:`build_layout`, this package's own copy of the
reference's; the mat-vec runs in the hand-written CUDA kernel
``csrc/window_matvec.cu`` (a ring of shared-memory stages filled by bulk
copies, one owner thread per accumulator lane; its constants are reported
by :func:`window_config`).

The script builds the reference's data (2^20 rows, 32 entries a row, seed
0), prints the layout's build time and spill, checks every row against
numpy when nothing spilled (as the reference does), and times a chain of
10 passes as one CUDA graph and as an eager host loop.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import time

import numpy as np
import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.experiments import common
from photon_ml_tpu_torch.experiments.g8192 import K, N_ROWS, make_ell
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse import stable_argsort

BLOCK_ROWS = 8192
W = 64          # column windows of 128
DEPTH = 64      # sublane slots per (window, lane) cell
A = W * DEPTH   # 4096 sublanes per block
LANES = 128
D = W * LANES   # 8192: the width of w the layout addresses
KERNEL = "window_matvec"
#: the kernel moves lo, v and rhi by bulk copies, which need their bases on
#: a 16-byte boundary.
ALIGN = 16
CONFIG = ("tile", "stages", "copies", "threads", "shared_bytes", "ctas",
          "stream_only")


def build_layout(cols, vals, n_rows: int):
    """Host layout build (``exp_g8192_v2.py:27-59`` with ``n_rows`` for the
    module global).  cols/vals: ``(n_rows, K)``.  Returns ``lo``
    ``(NB, A, 128)`` int32, ``v`` ``(NB, A, 128)`` f32, ``rhi``
    ``(NB, A, 128)`` int32 and ``n_spill``, the entries past ``DEPTH`` in
    their cell, which the layout leaves out."""
    NB = n_rows // BLOCK_ROWS
    K = cols.shape[1]
    lo = np.zeros((NB, A, 128), np.int32)
    v = np.zeros((NB, A, 128), np.float32)
    rhi = np.zeros((NB, A, 128), np.int32)
    n_spill = 0
    rows = np.repeat(np.arange(n_rows, dtype=np.int64), K)
    b = rows // BLOCK_ROWS
    r_local = rows % BLOCK_ROWS
    c = cols.reshape(-1).astype(np.int64)
    win = c >> 7
    lane = r_local % 128
    # fill order: sort by (block, win, lane) then assign depth slots
    key = (b * W + win) * 128 + lane
    order = stable_argsort(key, max(NB, 1) * W * 128)
    key = key[order]
    bs, ws, ls = b[order], win[order], lane[order]
    rh = (r_local // 128)[order]
    los = (c & 127)[order]
    vs = vals.reshape(-1)[order]
    # depth position within each (block, win, lane) cell: the first entry
    # of each run of the sorted key
    start = np.flatnonzero(np.diff(key, prepend=-1))
    depth_pos = np.arange(len(key)) - np.repeat(start, np.diff(
        np.append(start, len(key))))
    ok = depth_pos < DEPTH
    n_spill = int((~ok).sum())
    sub = (ws * DEPTH + depth_pos)[ok]
    lo[bs[ok], sub, ls[ok]] = los[ok]
    v[bs[ok], sub, ls[ok]] = vs[ok]
    rhi[bs[ok], sub, ls[ok]] = rh[ok]
    return lo, v, rhi, n_spill


def window_matvec_plain(lo, v, rhi, w):
    """The plain PyTorch version, as the reference computes it: gather each
    slot's value from its sublane's window of w, multiply by ``v``, then sum
    the slots of each row group ``h`` with a 64-step masked sweep over
    ``rhi``."""
    nb = lo.shape[0]
    tables = w.view(W, LANES).repeat_interleave(DEPTH, 0)     # (A, 128)
    g = torch.gather(tables.expand(nb, A, LANES), 2, lo.long())
    contrib = v * g
    out = torch.empty((nb, W, LANES), dtype=torch.float32, device=w.device)
    for h in range(W):
        out[:, h, :] = torch.where(rhi == h, contrib, 0.0).sum(1)
    return out


def _check(lo, v, rhi, w) -> None:
    def need(ok, what):
        _kernels.need(ok, what, KERNEL)

    need(lo.dtype == torch.int32 and lo.dim() == 3
         and tuple(lo.shape[1:]) == (A, LANES) and lo.is_contiguous(),
         f"lo must be a contiguous (n_blocks, {A}, {LANES}) int32 tensor")
    need(v.dtype == torch.float32 and v.shape == lo.shape
         and v.is_contiguous(),
         "v must be a contiguous float32 tensor shaped like lo")
    need(rhi.dtype == torch.int32 and rhi.shape == lo.shape
         and rhi.is_contiguous(),
         "rhi must be a contiguous int32 tensor shaped like lo")
    need(w.dtype == torch.float32 and tuple(w.shape) == (D,)
         and w.is_contiguous(),
         f"w must be a contiguous ({D},) float32 tensor")
    need(all(t.device == w.device for t in (lo, v, rhi)),
         "all operands must live on one device")
    _kernels.check_device(w.device, KERNEL)
    if w.device.type == "cuda":
        need(all(t.data_ptr() % ALIGN == 0 for t in (lo, v, rhi)),
             f"lo, v and rhi must start on a {ALIGN}-byte aligned address "
             f"on the card (the kernel moves them by bulk copies)")


def launch_window(library: str, key: str, lo, v, rhi, w):
    """Launch the window kernel of ``library`` (``window_matvec`` or a
    :func:`_kernels.variant` of it) on checked CUDA operands and count it
    under ``LAUNCHES[key]``."""
    nb = lo.shape[0]
    out = torch.empty((nb, W, LANES), dtype=torch.float32, device=w.device)
    if nb == 0:
        return out
    _kernels.launch(library, "photon_window_matvec", key, w.device,
                    lo.data_ptr(), v.data_ptr(), rhi.data_ptr(),
                    w.data_ptr(), out.data_ptr(), nb)
    return out


def window_matvec(lo, v, rhi, w):
    """``out[b, h, l] = Σ_{a: rhi[b,a,l]=h} v[b,a,l]·w[(a // 64)·128 +
    lo[b,a,l]]`` → ``(n_blocks, 64, 128)``, the margin of row
    ``b·8192 + h·128 + l``.  Every slot is summed, padded ones included, as
    the reference sums them (a non-finite ``w[window·128]`` makes row group
    0 NaN).  CUDA tensors run the kernel, CPU tensors the plain version; any
    other device raises.  ``lo`` in ``[0, 128)`` and ``rhi`` in ``[0, 64)``
    are :func:`build_layout`'s guarantee."""
    _check(lo, v, rhi, w)
    if w.device.type == "cpu":
        return window_matvec_plain(lo, v, rhi, w)
    return launch_window(KERNEL, KERNEL, lo, v, rhi, w)


def window_config(device, n_blocks: int, library: str = KERNEL) -> dict:
    """The design of ``library``'s kernel on ``device``: S (``tile``
    sublanes a stage), P (``stages``), C (accumulator ``copies``), threads
    and dynamic shared bytes a CTA, the ``ctas`` of a launch over
    ``n_blocks`` blocks, and whether it is the read-only build."""
    lib = _kernels.load_library(library)
    buf = (ctypes.c_int * len(CONFIG))()
    with torch.cuda.device(device):
        rc = lib.photon_window_config(n_blocks, buf)
    if rc != 0:
        raise RuntimeError(f"photon_window_config: CUDA error {rc} "
                           f"({lib.photon_cuda_error_string(rc).decode()})")
    return dict(zip(CONFIG, buf))


def step(w, lo, v, rhi):
    """One pass of the reference's timing loop: ``w + 1e-20·m[:D]``, with
    m in row order (block 0's margins)."""
    return w + 1e-20 * window_matvec(lo, v, rhi, w).view(-1)[:D]


def chain(w, lo, v, rhi, reps: int = common.REPS, graph: bool = True):
    """``reps`` chained passes of :func:`step` from ``w`` (the loop of
    ``exp_g8192_v2.py:129-134``): one CUDA-graph replay on the card when
    ``graph``, else an eager loop."""
    return common.chain(functools.partial(step, lo=lo, v=v, rhi=rhi), w,
                        reps, graph)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--rows", type=int, default=N_ROWS,
                   help=f"a positive multiple of {BLOCK_ROWS}")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.rows
    if n < BLOCK_ROWS or n % BLOCK_ROWS:
        raise ValueError(f"--rows must be a positive multiple of "
                         f"{BLOCK_ROWS}, got {n}")
    cols_T, vals_T, w = make_ell(n, K, D)
    cols, vals = cols_T.T, vals_T.T
    print(f"window layout of {n} x {K} entries, w {D} wide, on "
          f"{common.describe(dev)}")

    t0 = time.perf_counter()
    lo, v, rhi, n_spill = build_layout(cols, vals, n)
    build_s = time.perf_counter() - t0
    print(f"layout build: {build_s:.1f}s, spill={n_spill} "
          f"({100 * n_spill / (n * K):.3f}%)")

    lo_d, v_d, rhi_d, w_d = (torch.as_tensor(a, device=dev)
                             for a in (lo, v, rhi, w))
    m = window_matvec(lo_d, v_d, rhi_d, w_d).reshape(-1).cpu().numpy()
    err = None
    if n_spill == 0:
        expect = (vals * w[cols]).sum(1)
        err = float(np.abs(m - expect).max())
        if not err < 1e-3:
            raise RuntimeError(f"{KERNEL}: disagrees with numpy by {err}")
    print("correctness max err:", err)
    if dev.type == "cuda":
        design = window_config(dev, lo_d.shape[0])
        print("kernel design: " + ", ".join(f"{k}={v}" for k, v in
                                            design.items()))

    passes = functools.partial(step, lo=lo_d, v=v_d, rhi=rhi_d)
    out = {"rows": n, "n_spill": n_spill, "layout_seconds": build_s,
           "max_err": err, "reps": common.REPS}
    runs = []
    if dev.type == "cuda":
        g = common.ChainGraph(passes, w_d)
        runs.append(("graph", g.replay))
    runs.append(("eager", lambda: common.run_chain(passes, w_d, common.REPS)))
    for label, fn in runs:
        ms, clock = common.timed_ms(fn, dev)
        per_pass = ms / common.REPS
        dt = per_pass / 1e3
        print(f"window matvec chain ({label}, {clock}): {per_pass:.4f} "
              f"ms/pass  {n / dt / 1e6:.1f} Mrows/s  "
              f"{n * K / dt / 1e9:.2f} Gnnz/s")
        out[f"{label}_ms_per_pass"] = per_pass
    if dev.type == "cuda":
        out["graph_replays"] = g.replays
    return out


if __name__ == "__main__":
    main()
