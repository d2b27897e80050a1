"""Choose the window kernel's tile, ring depth and accumulator copies by
measurement, and measure the ceiling of its stream.

    python -m photon_ml_tpu_torch.experiments.window_ring [--rows N]
        [--designs SxPxC,...] [--device D]

``csrc/window_matvec.cu`` streams the three slot arrays through a ring of
P shared-memory stages of S sublanes each (bulk copies started by one
producer thread) into C accumulator copies; S, P and C are constants of
the library.  This probe builds the library once per candidate design
(``-DPHOTON_WINDOW_TILE=S -DPHOTON_WINDOW_STAGES=P
-DPHOTON_WINDOW_COPIES=C``) and once more as its read-only pass
(``-DPHOTON_WINDOW_STREAM_ONLY=1``: the same ring and grid, every tile
waited for and released, no arithmetic), one ``nvcc`` each, all started
together.  On the reference's data (``g8192_v2``'s: 2^20 rows of 32
entries from an 8192-wide w, seed 0) each design is checked against the
plain version (rtol 1e-5 of Σ|v·w|, two launches bitwise equal) and timed
with its read-only pass, in two rounds (the designs in order, then in
reverse): the median of single launches under CUDA events, beside the
slot bound (each slot array read once at 3.35 TB/s) and the time of three
float32 ``torch.sum`` calls over the same arrays' bits, which read them
with every SM busy.  On the CPU the plain version runs once, timed by the host clock.
"""

from __future__ import annotations

import argparse

import torch

from photon_ml_tpu_torch.device import resolve_device
from photon_ml_tpu_torch.experiments import common, g8192_v2
from photon_ml_tpu_torch.experiments.g8192 import K, N_ROWS, make_ell
from photon_ml_tpu_torch.ops import _kernels

#: S x P x C candidates; each fits 227 KB of shared memory
#: (P·3·S·512 B + 32 KB + C·32 KB).
DESIGNS = "16x4x2,16x4x1,16x6x1,8x8x2,32x2x2,32x3x1,8x4x4,16x2x4,8x2x2"
RTOL = 1e-5
KEY = "window_ring_probe"
#: H100 SXM HBM3 (NVIDIA data sheet); a card set below 700 W is slower.
HBM_BYTES_PER_S = 3.35e12


def parse_designs(text: str) -> list[tuple[int, int, int]]:
    designs = []
    for item in text.split(","):
        s, p, c = (int(x) for x in item.split("x"))
        if (g8192_v2.DEPTH % s or s % c
                or p * 3 * s * 512 + (1 + c) * 4 * g8192_v2.D > 227 * 1024):
            raise ValueError(f"design {item}: S must divide 64, C divide S, "
                             f"and the ring, w and C copies fit 227 KB")
        designs.append((s, p, c))
    return designs


def library(design, stream_only: bool = False) -> str:
    s, p, c = design
    defines = [f"PHOTON_WINDOW_TILE={s}", f"PHOTON_WINDOW_STAGES={p}",
               f"PHOTON_WINDOW_COPIES={c}"]
    if stream_only:
        defines.append("PHOTON_WINDOW_STREAM_ONLY=1")
    return _kernels.variant("window_matvec", *defines)


def slot_bound_ms(lo) -> float:
    """Least time to read lo, v and rhi once and w, write out once."""
    nb = lo.shape[0]
    nbytes = 12 * lo.numel() + 4 * g8192_v2.D + 4 * nb * g8192_v2.D
    return nbytes / HBM_BYTES_PER_S * 1e3


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default) or cpu; no fallback between them")
    p.add_argument("--rows", type=int, default=N_ROWS,
                   help=f"a positive multiple of {g8192_v2.BLOCK_ROWS}")
    p.add_argument("--designs", default=DESIGNS,
                   help="comma-separated SxPxC: sublanes a tile, stages, "
                        "accumulator copies")
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    n = args.rows
    if n < g8192_v2.BLOCK_ROWS or n % g8192_v2.BLOCK_ROWS:
        raise ValueError(f"--rows must be a positive multiple of "
                         f"{g8192_v2.BLOCK_ROWS}, got {n}")
    designs = parse_designs(args.designs)
    if dev.type == "cuda":
        _kernels.build_libraries(*(library(d, ro) for d in designs
                                   for ro in (False, True)))
    cols_T, vals_T, w = make_ell(n, K, g8192_v2.D)
    lo, v, rhi, n_spill = g8192_v2.build_layout(cols_T.T, vals_T.T, n)
    lo, v, rhi, w = (torch.as_tensor(a, device=dev) for a in (lo, v, rhi, w))
    bound = slot_bound_ms(lo)
    print(f"window layout of {n} x {K} entries (spill {n_spill}) on "
          f"{common.describe(dev)}; slot bound {bound:.4f} ms")
    ref = g8192_v2.window_matvec_plain(lo, v, rhi, w)
    scale = g8192_v2.window_matvec_plain(lo, v.abs(), rhi, w.abs())
    if dev.type == "cpu":
        ms, clock = common.timed_ms(
            lambda: g8192_v2.window_matvec_plain(lo, v, rhi, w), dev)
        print(f"plain ({clock}): {ms:.4f} ms")
        return {"rows": n, "bound_ms": bound, "ms": {"plain": ms}}

    def run(lib):
        return g8192_v2.launch_window(lib, KEY, lo, v, rhi, w)

    for d in designs:
        out, out2 = run(library(d)), run(library(d))
        torch.cuda.synchronize()
        name = "x".join(map(str, d))
        if not torch.equal(out, out2):
            raise RuntimeError(f"design {name}: two launches differ")
        if not bool(((out - ref).abs() <= RTOL * scale).all()):
            raise RuntimeError(f"design {name}: kernel vs plain beyond rtol "
                               f"{RTOL}")
    times = {d: {"ms": [], "stream_ms": []} for d in designs}
    for order in (designs, designs[::-1]):
        for d in order:
            times[d]["ms"].append(common.timed_ms(
                lambda: run(library(d)), dev)[0])
            times[d]["stream_ms"].append(common.timed_ms(
                lambda: run(library(d, True)), dev)[0])
    # The card's read rate over the same bytes with every SM busy: one
    # PyTorch float reduction per slot array, lo and rhi read as float32
    # bits (a yardstick the port never calls).
    flat = [t.view(torch.float32) for t in (lo, v, rhi)]
    lib_ms = common.timed_ms(lambda: [t.sum() for t in flat], dev)[0]
    print(f"library read ceiling (torch.sum of lo, v and rhi as float32, "
          f"all SMs): "
          f"{lib_ms:.4f} ms ({bound / lib_ms:.1%} of the slot bound)")
    res = {}
    for d in designs:
        cfg = g8192_v2.window_config(dev, lo.shape[0], library(d))
        ms = sum(times[d]["ms"]) / 2
        stream = sum(times[d]["stream_ms"]) / 2
        name = "x".join(map(str, d))
        res[name] = dict(times[d], config=cfg)
        print(f"S={d[0]:2d} P={d[1]} C={d[2]} ({cfg['threads']} threads, "
              f"{cfg['shared_bytes']} B shared, {cfg['ctas']} CTAs, "
              f"{d[1] * 3 * d[0] * 512} B in flight a CTA): kernel "
              + " / ".join(f"{t:.4f}" for t in times[d]["ms"])
              + f" ms ({bound / ms:.1%} of the slot bound), read-only "
              + " / ".join(f"{t:.4f}" for t in times[d]["stream_ms"])
              + f" ms ({bound / stream:.1%})")
    return {"rows": n, "bound_ms": bound, "library_read_ms": lib_ms,
            "ms": res}


if __name__ == "__main__":
    main()
