"""The port's experiment kernels against the reference's, on the CPU.

The port's wrappers (``photon_ml_tpu_torch/experiments/``) run here
through their plain PyTorch versions (CPU tensors).  The references are
the reference scripts' own kernel bodies (``experiments/exp_g8192.py``,
``exp_g8192_v2.py``, ``exp_ablate.py``), each run as a one-block
``pl.pallas_call(..., interpret=True)`` built here; nothing under
``experiments/`` or ``photon_ml_tpu/`` changes.  Inputs come from numpy
seeds.

Tolerances: reductions are compared at rtol 1e-5 on the scale Σ|v·w| of
each output (the TPU kernels sum in window-sweep order, the plain versions
in PyTorch's reduction order, so the two agree to float32 rounding, never
bitwise).  Layouts (the v2 host build) must match exactly.
"""

import importlib.util
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from photon_ml_tpu.ops.sparse_pallas import TILE_C, WIN, WINS, build_pallas_matrix

from photon_ml_tpu_torch.experiments import (
    ablate,
    common,
    g8192,
    g8192_v2,
    row_block,
    window_ring,
)
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse_cuda import build_cuda_matrix
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
RTOL = 1e-5
BLOCK = 8192  # one reference block: exp_g8192's LANE, exp_g8192_v2's BLOCK_ROWS


def _reference(name):
    """Import ``experiments/<name>.py`` (a script, not a package) by path."""
    spec = importlib.util.spec_from_file_location(
        f"_reference_{name}", ROOT / "experiments" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ref_g8192():
    return _reference("exp_g8192")


@pytest.fixture(scope="module")
def ref_v2():
    return _reference("exp_g8192_v2")


@pytest.fixture(scope="module")
def ref_ablate():
    return _reference("exp_ablate")


@pytest.fixture(scope="module")
def ell():
    """One reference block of the reference's data: (cols_T, vals_T, w)."""
    return g8192.make_ell(BLOCK, g8192.K, g8192.D, seed=0)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _assert_close(out, ref, scale):
    out = np.asarray(out, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    scale = np.asarray(scale, np.float64).reshape(-1)
    assert out.shape == ref.shape == scale.shape
    excess = np.abs(out - ref) - RTOL * scale
    assert excess.max() <= 0.0, float(excess.max())


def _layout_case(case):
    """(cols, vals) of one block: the reference's uniform draw, or one built
    to overflow DEPTH: every row of lane 0 puts all its entries in column
    window 0, so cell (0, 0, 0) receives 64 × 32 entries."""
    rng = np.random.default_rng(3)
    cols = rng.integers(0, g8192.D, size=(BLOCK, g8192.K), dtype=np.int32)
    vals = rng.normal(size=(BLOCK, g8192.K)).astype(np.float32)
    if case == "overflow":
        lane0 = np.arange(0, BLOCK, 128)
        cols[lane0] = rng.integers(0, 128, size=(len(lane0), g8192.K),
                                   dtype=np.int32)
    return cols, vals


# -- (a) the ELL mat-vec ------------------------------------------------------


def test_ell_plain_matches_reference_kernel(ref_g8192, ell):
    cols_T, vals_T, w = ell
    K, L = cols_T.shape
    out = pl.pallas_call(
        ref_g8192.matvec_kernel, grid=(1,),
        out_shape=jax.ShapeDtypeStruct((1, 1, L), jnp.float32),
        in_specs=[pl.BlockSpec((K, L), lambda i: (0, i)),
                  pl.BlockSpec((K, L), lambda i: (0, i)),
                  pl.BlockSpec((1, L), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, 1, L), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(cols_T), jnp.asarray(vals_T), jnp.asarray(w).reshape(1, L))
    m = g8192.ell_matvec(_t(cols_T), _t(vals_T), _t(w))
    assert m.shape == (L,) and m.dtype == torch.float32
    scale = np.abs(vals_T * w[cols_T]).sum(0)
    _assert_close(m.numpy(), out, scale)


# -- (b) the v2 layout: bitwise equal to the reference's build ---------------


@pytest.mark.parametrize("case", ["uniform", "overflow"])
def test_window_layout_is_the_reference_layout(ref_v2, monkeypatch, case):
    cols, vals = _layout_case(case)
    monkeypatch.setattr(ref_v2, "N", BLOCK)
    monkeypatch.setattr(ref_v2, "N_BLOCKS", 1)
    lo_r, v_r, rhi_r, spill_r = ref_v2.build_layout(cols, vals)
    lo, v, rhi, spill = g8192_v2.build_layout(cols, vals, BLOCK)
    assert spill == spill_r
    assert (spill > 0) == (case == "overflow")
    for mine, theirs in ((lo, lo_r), (v, v_r), (rhi, rhi_r)):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        np.testing.assert_array_equal(mine, theirs)


# -- (c) the window mat-vec ----------------------------------------------------


def _reference_window(ref_v2, lo, v, rhi, w):
    """The reference's ``matvec_kernel`` over one block, in interpret mode,
    with the per-sublane tables of ``make_matvec``."""
    A, W = g8192_v2.A, g8192_v2.W
    wt = jnp.repeat(jnp.asarray(w).reshape(W, 128), g8192_v2.DEPTH, axis=0)
    slots = pl.BlockSpec((1, A, 128), lambda i: (i, 0, 0))
    out = pl.pallas_call(
        ref_v2.matvec_kernel, grid=(1,),
        out_shape=jax.ShapeDtypeStruct((1, W, 128), jnp.float32),
        in_specs=[slots, slots, slots,
                  pl.BlockSpec((A, 128), lambda i: (0, 0))],
        out_specs=pl.BlockSpec((1, W, 128), lambda i: (i, 0, 0)),
        interpret=True,
    )(jnp.asarray(lo), jnp.asarray(v), jnp.asarray(rhi), wt)
    return np.asarray(out)


@pytest.mark.parametrize("case", ["uniform", "overflow"])
def test_window_plain_matches_reference_kernel(ref_v2, case):
    cols, vals = _layout_case(case)
    w = np.random.default_rng(4).normal(size=g8192_v2.D).astype(np.float32)
    lo, v, rhi, spill = g8192_v2.build_layout(cols, vals, BLOCK)
    W = g8192_v2.W
    out = _reference_window(ref_v2, lo, v, rhi, w)
    m = g8192_v2.window_matvec(_t(lo), _t(v), _t(rhi), _t(w))
    assert m.shape == (1, W, 128)
    scale = g8192_v2.window_matvec_plain(_t(lo), _t(np.abs(v)), _t(rhi),
                                         _t(np.abs(w)))
    _assert_close(m.numpy(), out, scale.numpy())
    if spill == 0:  # the layout holds every entry: the ELL margins, in row order
        ell_m = g8192.ell_matvec_plain(_t(cols.T), _t(vals.T), _t(w))
        _assert_close(m.numpy(), ell_m.numpy(),
                      np.abs(vals * w[cols]).sum(1))


@pytest.mark.parametrize("case", ["uniform", "overflow"])
def test_window_padded_slots_carry_nonfinite_w(ref_v2, case):
    """The reference sums every slot, padded ones included: an inf at
    w[5·128] reaches row group 0 as 0·inf = NaN through every padded slot
    of window 5.  The plain version (what the card's kernel is held to)
    puts NaN and inf in the same places; the rest agree within rtol."""
    cols, vals = _layout_case(case)
    w = np.random.default_rng(4).normal(size=g8192_v2.D).astype(np.float32)
    w[5 * 128] = np.inf
    lo, v, rhi, _ = g8192_v2.build_layout(cols, vals, BLOCK)
    out = _reference_window(ref_v2, lo, v, rhi, w)
    m = g8192_v2.window_matvec(_t(lo), _t(v), _t(rhi), _t(w)).numpy()
    for kind in (np.isnan, np.isposinf, np.isneginf):
        np.testing.assert_array_equal(kind(m), kind(out))
    assert np.isnan(out[0, 0]).any()
    finite = np.isfinite(out)
    scale = g8192_v2.window_matvec_plain(_t(lo), _t(np.abs(v)), _t(rhi),
                                         _t(np.abs(w))).numpy()
    _assert_close(m[finite], out[finite], scale[finite])


# -- (d) the ablation modes ----------------------------------------------------


@pytest.fixture(scope="module")
def ablate_data():
    """16384 x 8192 with 32 normal values a row (exp_ablate's recipe)."""
    n, d, k = 2 * BLOCK, ablate.D, ablate.K
    rng = np.random.default_rng(0)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    cols = rng.integers(0, d, size=n * k).astype(np.int64)
    vals = rng.normal(size=n * k).astype(np.float32)
    M = build_cuda_matrix(rows, cols, vals, n, d, unit_values=False,
                          device="cpu")
    return rows, cols, vals, M


def test_ablate_full_matches_reference_kernel(ref_ablate, ablate_data):
    rows, cols, vals, M = ablate_data
    n, d = M.shape
    P = build_pallas_matrix(rows, cols, vals, n, d)
    # The production layout in identity order, with nothing outside the
    # tiles, so the tile kernel alone computes X·w.
    assert not (P.has_col_perm or P.spill.has_spill or P.has_dense_cols
                or P.has_dense_rows)
    a, nbo, nbg = P.a_f, P.nbr, P.nbc
    w = np.random.default_rng(5).normal(size=d).astype(np.float32)
    vec = np.zeros(nbg * TILE_C, np.float32)
    vec[:d] = w
    out = pl.pallas_call(
        ref_ablate.make_kernel("full", a), grid=(nbo, nbg),
        out_shape=jax.ShapeDtypeStruct((nbo, WINS, WIN), jnp.float32),
        in_specs=[pl.BlockSpec((1, a, WIN), lambda i, j: (i * nbg + j, 0, 0)),
                  pl.BlockSpec((1, a, WIN), lambda i, j: (i * nbg + j, 0, 0)),
                  pl.BlockSpec((1, WINS, WIN), lambda i, j: (j, 0, 0))],
        out_specs=pl.BlockSpec((1, WINS, WIN), lambda i, j: (i, 0, 0)),
        interpret=True,
    )(P.f_code.reshape(nbo * nbg, a, WIN), P.f_val.reshape(nbo * nbg, a, WIN),
      jnp.asarray(vec).reshape(nbg, WINS, WIN))
    ref = np.asarray(out).reshape(-1)[:n]
    indptr, idx, val, n_in, layout = ablate.side(M, "matvec")
    y = ablate.spmv_ablate("full", indptr, idx, val, _t(w), n_in, "matvec",
                           **layout)
    scale = np.bincount(rows, weights=np.abs(vals * w[cols]), minlength=n)
    _assert_close(y.numpy(), ref, scale)


@pytest.mark.parametrize("op", ablate.OPS)
@pytest.mark.parametrize("mode", ["stream", "nogather"])
def test_ablate_modes_match_numpy(ablate_data, mode, op):
    _, _, _, M = ablate_data
    indptr, idx, val, n_in, layout = ablate.side(M, op)
    x = ablate.operand(M, op)
    y = ablate.spmv_ablate(mode, indptr, idx, val, x, n_in, op, **layout)
    ip, v = indptr.numpy(), val.numpy().astype(np.float64)
    seg = np.repeat(np.arange(len(ip) - 1), np.diff(ip))
    if mode == "nogather":
        v = v * x.numpy()[np.arange(len(v)) % n_in]
    want = np.bincount(seg, weights=v, minlength=len(ip) - 1)
    scale = np.bincount(seg, weights=np.abs(v), minlength=len(ip) - 1)
    _assert_close(y.numpy(), want, scale)


# -- (e) the chains ------------------------------------------------------------


@pytest.mark.parametrize("which", ["g8192", "g8192_v2"])
def test_chain_matches_numpy_loop(ell, which):
    """Three passes of w ← w + 1e-20·m[:D].  The values are scaled by 1e19
    so that each pass changes w (at the scripts' scale the update is far
    below one ulp of w, and any loop would pass)."""
    cols_T, vals_T, w = ell
    vals_T = vals_T * np.float32(1e19)
    reps, D = 3, g8192.D
    want = w.astype(np.float64)
    for _ in range(reps):
        m = (vals_T * want[cols_T]).sum(0)
        want = want + 1e-20 * m[:D]
    if which == "g8192":
        got = g8192.chain(_t(w), _t(cols_T), _t(vals_T), reps)
    else:
        lo, v, rhi, spill = g8192_v2.build_layout(cols_T.T, vals_T.T, BLOCK)
        assert spill == 0
        got = g8192_v2.chain(_t(w), _t(lo), _t(v), _t(rhi), reps)
    assert got.shape == (D,) and got.dtype == torch.float32
    assert np.abs(got.numpy() - w).max() > 1.0  # the passes moved w
    # Each pass's rounding is relative to Σ|v·w|; three passes compound it.
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


# -- (f) the entry points -------------------------------------------------------

ENTRY_POINTS = {"g8192": g8192, "g8192_v2": g8192_v2, "ablate": ablate,
                "row_block": row_block, "window_ring": window_ring}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_main_refuses_without_cuda(monkeypatch, name):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ENTRY_POINTS[name].main([])


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_main_runs_on_cpu(capsys, name):
    res = ENTRY_POINTS[name].main(["--device", "cpu", "--rows", str(BLOCK)])
    printed = capsys.readouterr().out
    assert res["rows"] == BLOCK
    assert "host clock, cpu" in printed  # never labelled as device time
    if name == "ablate":
        assert set(res["ms"]) == set(ablate.OPS)
        assert all(set(t) == set(ablate.MODES) for t in res["ms"].values())
        assert "nogather - stream" in printed
    elif name == "row_block":
        assert set(res["ms"]) == {"valued", "binary", "skewed"}
        assert all(set(t) == {14, 15} for t in res["ms"].values())
        assert "1 row blocks" in printed  # 8192 rows: one block of each R
    elif name == "window_ring":
        assert set(res["ms"]) == {"plain"} and res["bound_ms"] > 0
    else:
        assert res["max_err"] is not None and res["max_err"] < 1e-3
        assert res["eager_ms_per_pass"] > 0 and "graph_ms_per_pass" not in res
        assert "correctness max err" in printed


def test_window_ring_refuses_designs_that_do_not_fit():
    assert window_ring.parse_designs("16x4x2,8x2x2") == [(16, 4, 2),
                                                          (8, 2, 2)]
    for bad in ("16x6x2", "12x4x1", "16x4x3"):  # 240 KB; S ∤ 64; C ∤ S
        with pytest.raises(ValueError, match="227 KB"):
            window_ring.parse_designs(bad)
    names = {window_ring.library(d, ro) for d in
             window_ring.parse_designs(window_ring.DESIGNS)
             for ro in (False, True)}
    assert len(names) == 2 * len(window_ring.DESIGNS.split(","))
    assert all(n.startswith("window_matvec[PHOTON_WINDOW_TILE=")
               for n in names)


def test_plain_paths_do_not_count_launches(ell):
    cols_T, vals_T, w = ell
    _kernels.reset_launches()
    g8192.chain(_t(w), _t(cols_T), _t(vals_T), 2)
    lo, v, rhi, _ = g8192_v2.build_layout(cols_T.T, vals_T.T, BLOCK)
    g8192_v2.window_matvec(_t(lo), _t(v), _t(rhi), _t(w))
    assert all(n == 0 for n in _kernels.LAUNCHES.values())


# -- (g) the wrappers refuse what the kernels do not take ----------------------


def _meta(*ts):
    return [t.to("meta") for t in ts]


@pytest.mark.parametrize("wrapper", ["ell_matvec", "window_matvec",
                                     "spmv_ablate"])
def test_wrappers_refuse_bad_operands(wrapper):
    if wrapper == "ell_matvec":
        cols = torch.zeros((4, 16), dtype=torch.int32)
        vals = torch.ones((4, 16))
        w = torch.ones(8)
        f = g8192.ell_matvec
        assert f(cols, vals, w).tolist() == [4.0] * 16
        bad = [(cols.long(), vals, w, "cols_T"),
               (cols[0], vals[0], w, "cols_T"),
               (cols, vals.double(), w, "vals_T"),
               (cols, vals[:, :8], w, "vals_T"),
               (cols, vals, w.reshape(2, 4), "w"),
               (cols, vals, w[:0], "w"),
               (cols.t(), vals.t(), w, "contiguous")]
        meta = (*_meta(cols, vals, w), "unsupported device")
    elif wrapper == "window_matvec":
        shape = (1, g8192_v2.A, g8192_v2.LANES)
        lo = torch.zeros(shape, dtype=torch.int32)
        v = torch.zeros(shape)
        w = torch.ones(g8192_v2.D)
        f = g8192_v2.window_matvec
        assert f(lo, v, lo, w).shape == (1, g8192_v2.W, g8192_v2.LANES)
        bad = [(lo.long(), v, lo, w, "lo"),
               (lo[:, :8], v[:, :8], lo[:, :8], w, "lo"),
               (lo, v.double(), lo, w, "v"),
               (lo, v, v, w, "rhi"),
               (lo, v, lo, w[:8], "w"),
               (lo, v, lo, w.cpu().view(2, -1), "w")]
        meta = (*_meta(lo, v, lo, w), "unsupported device")
    else:
        indptr = torch.tensor([0, 1, 2], dtype=torch.int64)
        idx = torch.tensor([0, 1], dtype=torch.int32)
        val = torch.ones(2)
        x = torch.ones(3)

        def f(indptr, idx, val, x, mode="full", op="matvec"):
            return ablate.spmv_ablate(mode, indptr, idx, val, x, 3, op)

        assert f(indptr, idx, val, x).tolist() == [1.0, 1.0]
        bad = [(indptr, idx.long(), val, x, "idx"),
               (indptr.int(), idx, val, x, "indptr"),
               (indptr, idx, val.double(), x, "val"),
               (indptr, idx, val, x[:2], "x has")]
        meta = (*_meta(indptr, idx, val, x), "unsupported device")
        with pytest.raises(ValueError, match="unknown mode"):
            f(indptr, idx, val, x, mode="dma")
        with pytest.raises(ValueError, match="unknown op"):
            f(indptr, idx, val, x, op="row_sq_matvec")
    for *args, what in bad:
        with pytest.raises(ValueError, match=what):
            f(*args)
    *args, what = meta
    with pytest.raises(ValueError, match=what):
        f(*args)
    with pytest.raises(ValueError, match="CUDA graphs need a CUDA tensor"):
        common.ChainGraph(lambda w: w, torch.ones(3))
