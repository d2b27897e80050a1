"""CPU arithmetic whose bits do not depend on the host's BLAS: inner
products in one fixed order, ``exp`` and ``sqrt``.

On the CPU ``torch.dot`` and a dense ``@`` call the host's BLAS, and the
bits of its sums depend on the path it dispatches to.  MKL takes one
instruction path on one vendor's CPU and another elsewhere, and without its
reproducibility mode it may also split a long sum between threads or peel a
vector's head up to an alignment boundary.  The port's solves sit on those
sums: a group of k ranks is meant to give the bits of k logical shards or
tiles (``parallel/distributed.py``, ``parallel/tensor.py``), and a solve
that stops when one step improves the value by less than a relative 1e-6
can take one iteration more or less when the last bit of a sum moves.  The
same tests passed on one host and failed on another.

So the port's CPU paths never call the BLAS for these sums:

- :func:`dot` forms each product and adds in the order of MKL's AVX-512
  ``sdot``/``ddot`` on one thread (16 float32 or 8 float64 lanes; four
  accumulators over blocks of 4 lanes-widths, then at most one block pair
  into the first two, one block and a zero-padded tail into the first; the
  accumulators added as ``(a0 + a1) + (a2 + a3)``; the lanes halved to 4,
  and the last four added as ``(l0 + l1) + (l2 + l3)`` for float32 or
  halved to 1 for float64), every lane step a fused multiply-add.  So a
  dot keeps the bits the BLAS gave on the hosts where it took that path,
  and gives them on every other host.
- :func:`matvec` takes each row in the order of MKL's AVX-512 ``sgemv``
  over one row (:func:`_rows`), and :func:`rmatvec` adds a few rows in
  row order as its ``sgemv`` does (:func:`_cols`), more rows by a pairwise
  tree.  A dense feature stripe of one row or column (the intercept) keeps
  the bits the BLAS gave on those hosts.
- :func:`exp` and :func:`sqrt` stand for ``torch.exp`` and ``torch.sqrt``,
  which ATen's CPU kernels take from MKL's vector math library, whose
  bits also depend on the path (its ``sqrt`` is not even correctly
  rounded).  ``sqrt`` is numpy's, correctly rounded, so the same
  everywhere.  ``exp`` is numpy's in float64, rounded once to the input's
  dtype (a float32 result nearly always the correctly rounded one).  numpy
  dispatches its float64 ``exp`` by instruction set, so these bits are the
  same only on hosts where numpy takes the same path (AVX-512 on x86) and
  between numpy versions that keep that code: less than the sums promise.

Why MKL's order and not some simpler fixed one: any fixed order makes the
bits independent of the host, but the port's solves stop on rules that one
ulp decides, and its tests hold them against the reference's solves and a
process group against one process.  With MKL's AVX-512 order their
outcomes are the ones the BLAS gave on the Intel hosts where they passed;
a plain pairwise tree of the products (:func:`_fold`) moved seven of those
tests (three TRON and elastic-net driver routes, the warm-started streamed
grid, the driver's selection against the reference's and the two
data-parallel driver runs).  The price is a Python loop of numpy calls
over blocks of 64 float32 (32 float64) values a dot:
``scripts/ordered_cpu_cost.py`` times a CPU solve both ways.

All use numpy's elementwise arithmetic on the tensors' own memory, which
rounds each operation exactly whatever the vector width, alignment or
thread count: the sums are a function of the operands' values and shape
alone.  The fused multiply-add is formed exactly (the float32 product is
exact in float64, and a float64 product splits into two parts) and rounded
once, through round-to-odd.

On a CUDA tensor each function is the library call it replaces: the
card's path is its kernels' and cuBLAS's, and nothing here changes it.
"""

from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor

_LANES = {np.dtype(np.float32): 16, np.dtype(np.float64): 8}
_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's split of a float64


def _two_sum(a, b):
    """``s + e == a + b`` exactly, ``s`` the rounded sum."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _to_odd(s, e):
    """Round-to-odd of ``s + e`` from its round-to-nearest ``s``: an
    inexact sum whose last bit is even moves to its neighbour toward the
    exact value."""
    bits = s.view(np.int64)
    fix = (e != 0) & np.isfinite(e) & ((bits & 1) == 0)
    if fix.any():
        s = np.where(fix, np.nextafter(s, np.where(e > 0, np.inf, -np.inf)),
                     s)
    return s


def _fma32(x, y, c):
    """``x·y + c`` in float32, rounded once."""
    p = x.astype(np.float64) * y.astype(np.float64)  # exact
    s, e = _two_sum(p, c.astype(np.float64))
    # A float64 rounded to odd rounds to float32 as the exact sum would.
    return _to_odd(s, e).astype(np.float32)


def _fma64(x, y, c):
    """``x·y + c`` in float64, rounded once (Boldo and Melquiond's
    emulation: an exact product, an exact sum, one sum rounded to odd)."""
    p = x * y
    cx = _SPLIT * x
    xh = cx - (cx - x)
    xl = x - xh
    cy = _SPLIT * y
    yh = cy - (cy - y)
    yl = y - yh
    pe = ((xh * yh - p) + xh * yl + xl * yh) + xl * yl  # x·y == p + pe
    sh, sl = _two_sum(c, p)
    v, ve = _two_sum(sl, pe)
    out = sh + _to_odd(v, ve)
    plain = c + p
    return np.where(np.isfinite(plain), out, plain)


def _dot(a: np.ndarray, b: np.ndarray):
    lanes = _LANES[a.dtype]
    fma = _fma32 if a.dtype == np.float32 else _fma64
    n = a.shape[0]
    acc = np.zeros((4, lanes), a.dtype)
    step = 4 * lanes
    full = n - n % step
    for i in range(0, full, step):
        acc = fma(a[i:i + step].reshape(4, lanes),
                  b[i:i + step].reshape(4, lanes), acc)
    i = full
    if n - i >= 2 * lanes:
        acc[:2] = fma(a[i:i + 2 * lanes].reshape(2, lanes),
                      b[i:i + 2 * lanes].reshape(2, lanes), acc[:2])
        i += 2 * lanes
    if n - i >= lanes:
        acc[0] = fma(a[i:i + lanes], b[i:i + lanes], acc[0])
        i += lanes
    if n > i:
        ta = np.zeros(lanes, a.dtype)
        tb = np.zeros(lanes, a.dtype)
        ta[:n - i] = a[i:]
        tb[:n - i] = b[i:]
        acc[0] = fma(ta, tb, acc[0])
    s = (acc[0] + acc[1]) + (acc[2] + acc[3])
    while s.shape[0] > 4:
        s = s[:s.shape[0] // 2] + s[s.shape[0] // 2:]
    if a.dtype == np.float32:
        return (s[0] + s[1]) + (s[2] + s[3])
    s = s[:2] + s[2:]
    return s[0] + s[1]


def _host(t: Tensor) -> np.ndarray:
    return t.detach().numpy()


def _on_host(*ts: Tensor) -> bool:
    """All on the CPU, in one float32 or float64 dtype."""
    t = ts[0]
    return (t.device.type == "cpu"
            and t.dtype in (torch.float32, torch.float64)
            and all(u.dtype == t.dtype for u in ts))


def dot(a: Tensor, b: Tensor) -> Tensor:
    """``⟨a, b⟩`` of two 1-D tensors (``torch.dot`` on a card or for
    another dtype)."""
    if not _on_host(a, b):
        return torch.dot(a, b)
    x = np.ascontiguousarray(_host(a))
    y = np.ascontiguousarray(_host(b))
    with np.errstate(all="ignore"):  # IEEE results, as the BLAS gives
        return torch.from_numpy(np.asarray(_dot(x, y), x.dtype))


def _fold(p: np.ndarray) -> np.ndarray:
    """Σ over axis 0 of ``p`` by the pairwise tree: zero-pad the axis to a
    power of two, then add its second half onto its first, level by
    level."""
    n = p.shape[0]
    size = 1 << max(n - 1, 0).bit_length()
    buf = np.zeros((size, *p.shape[1:]), p.dtype)
    buf[:n] = p
    while size > 1:
        size //= 2
        buf[:size] += buf[size:2 * size]
    return buf[0]


def _rows(x: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``x @ v`` row by row: the first product alone, the rest streamed
    through two accumulators over pairs of lane blocks, the two added, the
    rest of the row streamed into their sum block by zero-padded block, the
    lanes halved to one, and the first product added last."""
    lanes = _LANES[x.dtype]
    fma = _fma32 if x.dtype == np.float32 else _fma64
    r, n = x.shape
    first = x[:, 0] * v[0] if n else np.zeros(r, x.dtype)
    acc = np.zeros((r, 2, lanes), x.dtype)
    i = 1
    while n - i >= 2 * lanes:
        acc = fma(x[:, i:i + 2 * lanes].reshape(r, 2, lanes),
                  v[i:i + 2 * lanes].reshape(2, lanes), acc)
        i += 2 * lanes
    s = acc[:, 0] + acc[:, 1]
    while n > i:
        k = min(lanes, n - i)
        tx = np.zeros((r, lanes), x.dtype)
        tv = np.zeros(lanes, x.dtype)
        tx[:, :k] = x[:, i:i + k]
        tv[:k] = v[i:i + k]
        s = fma(tx, tv, s)
        i += k
    while s.shape[1] > 1:
        s = s[:, :s.shape[1] // 2] + s[:, s.shape[1] // 2:]
    return first + s[:, 0]


#: ``rmatvec`` adds up to this many rows one by one, more by the tree.
SEQUENTIAL_ROWS = 7


def _cols(x: np.ndarray, u: np.ndarray) -> np.ndarray:
    """``xᵀ @ u``: a few rows added in row order, each a fused
    multiply-add into the running sum; more rows by the pairwise tree."""
    if x.shape[0] > SEQUENTIAL_ROWS:
        return _fold(x * u[:, None])
    fma = _fma32 if x.dtype == np.float32 else _fma64
    acc = np.zeros(x.shape[1], x.dtype)
    for i in range(x.shape[0]):
        acc = fma(x[i], u[i:i + 1], acc)
    return acc


def matvec(x: Tensor, v: Tensor) -> Tensor:
    """``x @ v`` for a 2-D ``x`` (the plain ``@`` on a card or for another
    dtype).  A row's result does not depend on the rows beside it."""
    if not _on_host(x, v):
        return x @ v
    with np.errstate(all="ignore"):
        return torch.from_numpy(_rows(_host(x), _host(v)))


def rmatvec(x: Tensor, u: Tensor) -> Tensor:
    """``xᵀ @ u`` for a 2-D ``x`` (the plain ``@`` on a card or for another
    dtype)."""
    if not _on_host(x, u):
        return x.T @ u
    with np.errstate(all="ignore"):
        return torch.from_numpy(
            np.ascontiguousarray(_cols(_host(x), _host(u))))


def exp(x: Tensor) -> Tensor:
    """``exp(x)`` (``torch.exp`` on a card or for another dtype)."""
    if not _on_host(x):
        return torch.exp(x)
    with np.errstate(over="ignore"):
        e = np.exp(_host(x).astype(np.float64))
    return torch.from_numpy(np.asarray(e)).to(x.dtype)


def sqrt(x: Tensor) -> Tensor:
    """``sqrt(x)``, correctly rounded (``torch.sqrt`` on a card or for
    another dtype)."""
    if not _on_host(x):
        return torch.sqrt(x)
    with np.errstate(invalid="ignore"):
        return torch.from_numpy(np.asarray(np.sqrt(_host(x))))
