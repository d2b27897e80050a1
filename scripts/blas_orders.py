"""Show the order in which this host's BLAS sums, and hold
``photon_ml_tpu_torch/ops/ordered.py`` against it.

The port's CPU inner products (``ops/ordered.py``) add in one fixed order:
the order MKL's AVX-512 ``sdot``/``ddot`` and its one-row ``sgemv`` take on
one thread.  This script shows, on the host it runs on:

- ``tree``: the summation tree of ``torch.dot`` and of a one-row
  ``x @ v`` at a few lengths, revealed with ones and a pair ``+M, -M``
  (M = 2^60 in float32): the ones that meet ``M`` or ``-M`` before the two
  cancel are absorbed, so the sum counts the leaves outside the pair's
  lowest common subtree, and the subtree sizes of all pairs give the tree
  (the method of "Revealing the order of floating-point summation",
  FPRev);
- ``match``: for random operands of many lengths, whether ``ordered.dot``
  gives ``torch.dot``'s bits, ``ordered.matvec`` of one row gives
  ``x @ v``'s and ``ordered.rmatvec`` of a few rows gives ``x.T @ u``'s,
  with torch on one thread.  On a host whose BLAS takes the AVX-512 path
  every length matches; elsewhere the mismatches show the BLAS's other
  order, which the port no longer follows.

    python scripts/blas_orders.py [--tree-lengths 5,17,40] [--seed 0]

Imports torch, numpy and the port only (no JAX).  Prints one line per
finding and a JSON summary as the last line; exits 0 either way (it
describes the host, it tests nothing).
"""

from __future__ import annotations

import argparse
import json
import platform
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from photon_ml_tpu_torch.ops import ordered  # noqa: E402

LENGTHS = list(range(1, 140)) + [199, 256, 257, 600, 1000, 4096, 4097]


def _tree(n: int, lost) -> str:
    """The nested sum over ``n`` leaves whose subtree sizes
    ``lost(i, j)`` reports."""
    size = np.zeros((n, n), int)
    for i in range(n):
        for j in range(i + 1, n):
            size[i, j] = size[j, i] = lost(i, j)
    nodes = {i: (str(i), {i}) for i in range(n)}
    while len(nodes) > 1:
        best = None
        keys = list(nodes)
        for a in range(len(keys)):
            for b in range(a + 1, len(keys)):
                sa, sb = nodes[keys[a]][1], nodes[keys[b]][1]
                s = size[min(sa), min(sb)]
                if len(sa | sb) == s and (best is None or s < best[0]):
                    best = (s, keys[a], keys[b])
        if best is None:
            return "not a tree"
        _, ka, kb = best
        nodes[ka] = (f"({nodes[ka][0]}+{nodes[kb][0]})",
                     nodes[ka][1] | nodes[kb][1])
        del nodes[kb]
    return next(iter(nodes.values()))[0]


def trees(lengths) -> dict:
    big = 2.0 ** 60
    out = {}
    for n in lengths:
        def dot_lost(i, j, n=n):
            x = torch.ones(n)
            x[i], x[j] = big, -big
            return n - round(float(torch.dot(x, torch.ones(n))))

        def row_lost(i, j, n=n):
            x = torch.ones(1, n)
            x[0, i], x[0, j] = big, -big
            return n - round(float((x @ torch.ones(n))[0]))

        out[n] = {"dot": _tree(n, dot_lost),
                  "one_row_matvec": _tree(n, row_lost)}
    return out


def matches(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    bad = {"dot_f32": [], "dot_f64": [], "one_row_matvec_f32": [],
           "few_row_rmatvec_f32": [], "few_row_rmatvec_f64": []}
    for n in LENGTHS:
        for dtype, key in ((np.float32, "dot_f32"), (np.float64, "dot_f64")):
            a = torch.from_numpy(rng.normal(size=n).astype(dtype))
            b = torch.from_numpy(rng.normal(size=n).astype(dtype))
            if not torch.equal(ordered.dot(a, b), torch.dot(a, b)):
                bad[key].append(n)
        x = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32))
        v = torch.from_numpy(rng.normal(size=n).astype(np.float32))
        if not torch.equal(ordered.matvec(x, v), x @ v):
            bad["one_row_matvec_f32"].append(n)
    for k in range(1, ordered.SEQUENTIAL_ROWS + 1):
        for n in (1, 5, 40, 600):
            for dtype, key in ((np.float32, "few_row_rmatvec_f32"),
                               (np.float64, "few_row_rmatvec_f64")):
                x = torch.from_numpy(rng.normal(size=(k, n)).astype(dtype))
                u = torch.from_numpy(rng.normal(size=k).astype(dtype))
                if not torch.equal(ordered.rmatvec(x, u), x.T @ u):
                    bad[key].append([k, n])
    return bad


def host() -> dict:
    cpu = "unknown"
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if line.startswith("model name"):
                cpu = line.split(":", 1)[1].strip()
                break
    except OSError:
        pass
    blas = [line.strip() for line in torch.__config__.show().splitlines()
            if "Math Kernel Library" in line or "BLAS_INFO" in line]
    return {"cpu": cpu, "machine": platform.machine(),
            "torch": torch.__version__,
            "capability": torch.backends.cpu.get_cpu_capability(),
            "blas": blas[:1]}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tree-lengths", default="5,17,40")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    h = host()
    print(f"host: {h}")
    tr = trees([int(n) for n in args.tree_lengths.split(",")])
    for n, t in tr.items():
        print(f"n={n} torch.dot: {t['dot']}")
        print(f"n={n} one-row x @ v: {t['one_row_matvec']}")
    bad = matches(args.seed)
    for key, lengths in bad.items():
        print(f"{key}: ordered gives the BLAS's bits at every length tried"
              if not lengths else
              f"{key}: ordered parts from the BLAS at {lengths}")
    print(json.dumps({"host": h, "trees": tr, "mismatches": bad,
                      "lengths": len(LENGTHS),
                      "all_match": not any(bad.values())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
