"""The port's CUDA kernels on the card, against their plain PyTorch versions.

Needs a CUDA card and ``nvcc`` (the kernels are built at first use); skips
without a card.  This file imports only torch, numpy and the port, so it
runs on a machine without JAX:

    python -m pytest --noconftest -q -m gpu tests/test_torch_gpu.py

Tolerance: each kernel sums in its own fixed order (the SpMV row and column
kernels lane-strided with a shuffle tree, the column kernel then over its
row blocks in order; the ELL kernel one thread per output; the window
kernel one owner thread per accumulator copy and lane, then its copies in
order), the
plain versions in PyTorch's reduction order, so they agree to rtol 1e-5 on
the scale Σ|f(v)·x| of each output, and never bitwise.  Two launches of one
kernel are bitwise equal (no atomics).
"""

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch.experiments import ablate, common, g8192, g8192_v2
from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.ops.sparse import from_coo
from photon_ml_tpu_torch.ops.sparse_cuda import build_cuda_matrix

pytestmark = pytest.mark.gpu

OPS = ("matvec", "rmatvec", "row_sq_matvec", "sq_rmatvec")


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the SpMV kernel has no CPU mode")
    return torch.device("cuda")


def _matrix(seed, n, d, k, unit, skew=False):
    rng = np.random.default_rng(seed)
    rows = np.repeat(np.arange(n, dtype=np.int64), k)
    if skew:  # zipf head: dense stripes plus long segments just below them
        cols = np.minimum(rng.zipf(1.1, size=n * k) - 1, d - 1)
    else:
        cols = rng.integers(0, d, size=n * k)
    keys = np.unique(rows * d + cols)  # unique coordinates keep 0/1 values
    rows, cols = keys // d, keys % d
    vals = (np.ones(len(rows), np.float32) if unit
            else rng.normal(size=len(rows)).astype(np.float32))
    return rows, cols, vals


def _side(M, op):
    """(indptr, idx, val, n_in) of the CSR ``op`` runs on: the plain
    version's operands."""
    if op in _kernels.ROW_OPS:
        return M.f_indptr, M.f_idx, M.f_val, M.n_cols
    return M.b_indptr, M.b_idx, M.b_val, M.n_rows


def _kernel(M, op, x):
    """``op``'s kernel launch on M's own layout (no dense stripes)."""
    sq = "sq" in op
    if op in _kernels.ROW_OPS:
        return _kernels.spmv_rows(M.f_indptr, M.f_idx, M.f_val, x,
                                  group=M.row_group, n_in=M.n_cols, op=op,
                                  unit=M.unit_vals, square=sq)
    return _kernels.spmv_cols(M.b_blockptr, M.b_idx, M.b_val, x,
                              group=M.col_group, n_in=M.n_rows, op=op,
                              unit=M.unit_vals, square=sq)


def _check_ops(M, gen, ops=OPS):
    """Every op's kernel against its plain version (rtol 1e-5 of
    Σ|f(v)·x|), twice (bitwise), one launch count each."""
    for op in ops:
        indptr, idx, val, n_in = _side(M, op)
        sq = "sq" in op
        x = torch.randn(n_in, device=indptr.device, generator=gen)
        _kernels.reset_launches()
        y, y2 = _kernel(M, op, x), _kernel(M, op, x)
        torch.cuda.synchronize()
        assert _kernels.LAUNCHES[op + ("_unit" if M.unit_vals else "")] == 2
        assert torch.equal(y, y2), op  # no atomics: bitwise repeatable
        ref = _kernels.spmv_plain(indptr, idx, val, x, unit=M.unit_vals,
                                  square=sq)
        mag = (val.abs() if not M.unit_vals
               else torch.ones_like(idx, dtype=x.dtype))
        scale = _kernels.spmv_plain(indptr, idx, mag * mag if sq else mag,
                                    x.abs(), unit=False)
        assert _within(y, ref, scale), op


@pytest.mark.parametrize("skew", [False, True], ids=["uniform", "zipf"])
@pytest.mark.parametrize("unit", [False, True], ids=["valued", "unit"])
def test_kernel_matches_plain(cuda, unit, skew):
    rows, cols, vals = _matrix(0, 1 << 16, 8192, 32, unit, skew)
    M = build_cuda_matrix(rows, cols, vals, 1 << 16, 8192, device=cuda)
    assert M.unit_vals is unit
    if skew:
        assert M.has_dense_cols
    C = from_coo(rows, cols, vals, 1 << 16, 8192, device=cuda)
    C_abs = from_coo(rows, cols, np.abs(vals), 1 << 16, 8192, device=cuda)
    assert M.b_blockptr.shape == (8192, 3)  # 2^16 rows: two row blocks
    gen = torch.Generator(device=cuda).manual_seed(1)
    _check_ops(M, gen)
    for op in OPS:
        x = torch.randn(_side(M, op)[3], device=cuda, generator=gen)
        # The full matrix operation (stripes included) against the COO
        # matrix built from the same triples.
        full = getattr(M, op)(x)
        coo = getattr(C, op)(x)
        coo_scale = getattr(C_abs, op)(x.abs())
        assert float(((full - coo).abs() - 1e-5 * coo_scale).max()) <= 0.0


@pytest.mark.parametrize("unit", [False, True], ids=["valued", "unit"])
def test_nonfinite_entries_stay_local(cuda, unit):
    n, d = 4096, 512
    rows, cols, vals = _matrix(2, n, d, 8, unit)
    M = build_cuda_matrix(rows, cols, vals, n, d, device=cuda)
    j = 77
    w = torch.ones(d, device=cuda)
    base = M.matvec(w)
    w[j] = float("inf")
    probe = M.matvec(w)
    touched = torch.zeros(n, dtype=torch.bool, device=cuda)
    touched[torch.as_tensor(rows[cols == j], device=cuda)] = True
    assert (~torch.isfinite(probe[touched])).all()
    assert torch.equal(probe[~touched], base[~touched])


def test_wrapper_refuses_bad_operands_on_the_card(cuda):
    indptr = torch.tensor([0, 1, 2], dtype=torch.int64, device=cuda)
    idx = torch.tensor([0, 1], dtype=torch.int32, device=cuda)
    val = torch.ones(2, device=cuda)
    x = torch.ones(3, device=cuda)
    with pytest.raises(ValueError, match="idx"):
        _kernels.spmv_rows(indptr, idx.long(), val, x, group=8, n_in=3,
                           op="matvec", unit=False)
    with pytest.raises(ValueError, match="one device"):
        _kernels.spmv_rows(indptr, idx, val, x.cpu(), group=8, n_in=3,
                           op="matvec", unit=False)
    with pytest.raises(ValueError, match="group"):
        _kernels.spmv_rows(indptr, idx, val, x, group=6, n_in=3,
                           op="matvec", unit=False)
    out = _kernels.spmv_rows(indptr, idx, val, x, group=8, n_in=3,
                             op="matvec", unit=False)
    assert out.device.type == "cuda" and out.tolist() == [1.0, 1.0]
    # A table cut into other row blocks than the library's is refused.
    two_blocks = torch.tensor([[0, 1, 1], [1, 1, 2]], dtype=torch.int64,
                              device=cuda)
    with pytest.raises(ValueError, match="row blocks"):
        _kernels.spmv_cols(two_blocks, idx, val, x, group=4, n_in=3,
                           op="rmatvec", unit=False)
    blockptr = two_blocks[:, ::2].contiguous()
    for group in _kernels.GROUPS:
        out = _kernels.spmv_cols(blockptr, idx, val, x, group=group, n_in=3,
                                 op="rmatvec", unit=False)
        assert out.tolist() == [1.0, 1.0]


R = _kernels.ROW_BLOCK


def _edge_case(case):
    """(rows, cols, vals, n_rows, n_cols) for the row-block edge cases."""
    rng = np.random.default_rng(7)
    d = 512
    if case == "column-in-every-block":
        n = 3 * R + 123  # not a multiple of R: a short last block
        rows = np.repeat(np.arange(n, dtype=np.int64), 2)
        cols = rng.integers(1, d, size=2 * n)
        hot = np.append(np.arange(0, n, R // 4), n - 1)  # column 0
        rows, cols = np.append(rows, hot), np.append(cols, np.zeros_like(hot))
    elif case == "empty-row-block":
        n = 2 * R + R // 2
        rows = np.repeat(np.arange(n, dtype=np.int64), 3)
        rows = rows[(rows < R) | (rows >= 2 * R)]  # block 1 holds nothing
        cols = rng.integers(0, d, size=rows.size)
    elif case == "short-and-long-rows":
        n = R + 1000  # rows of 1 entry, every 97th row of 120
        long_rows = np.arange(0, n, 97, dtype=np.int64)
        rows = np.concatenate([np.arange(n, dtype=np.int64),
                               np.repeat(long_rows, 120)])
        cols = np.concatenate([rng.integers(0, d, size=n),
                               np.tile(np.arange(120) * 4 + 1,
                                       long_rows.size)])
    else:  # one row block: the column kernel writes y, nothing combines
        n = 5000
        rows = np.repeat(np.arange(n, dtype=np.int64), 6)
        cols = rng.integers(0, d, size=rows.size)
    keys = np.unique(rows * d + cols)
    rows, cols = keys // d, keys % d
    return rows, cols, rng.normal(size=rows.size).astype(np.float32), n, d


@pytest.mark.parametrize("case", ["column-in-every-block", "empty-row-block",
                                  "short-and-long-rows", "one-row-block"])
@pytest.mark.parametrize("unit", [False, True], ids=["valued", "unit"])
def test_kernels_on_row_block_edges(cuda, case, unit):
    rows, cols, vals, n, d = _edge_case(case)
    if unit:
        vals = np.ones_like(vals)
    M = build_cuda_matrix(rows, cols, vals, n, d, dense_budget_bytes=0,
                          device=cuda)
    assert M.unit_vals is unit and not M.has_dense_cols
    n_rb = M.b_blockptr.shape[1] - 1
    assert n_rb == -(-n // R)
    bp = M.b_blockptr.cpu()
    if case == "column-in-every-block":
        assert bool((bp[0, 1:] > bp[0, :-1]).all())  # column 0 spans them
    if case == "empty-row-block":
        assert torch.equal(bp[:, 1], bp[:, 2])
    if case == "short-and-long-rows":
        assert M.row_group == 4
        assert int((M.f_indptr[1:] - M.f_indptr[:-1]).max()) > 8 * 4
    _check_ops(M, torch.Generator(device=cuda).manual_seed(3))
    # An inf in u at the last row reaches exactly the columns holding it.
    u = torch.ones(n, device=cuda)
    base = _kernel(M, "rmatvec", u)
    u[n - 1] = float("inf")
    probe = _kernel(M, "rmatvec", u)
    touched = torch.zeros(d, dtype=torch.bool, device=cuda)
    touched[torch.as_tensor(cols[rows == n - 1], device=cuda)] = True
    assert bool(touched.any())
    assert bool((~torch.isfinite(probe[touched])).all())
    assert torch.equal(probe[~touched], base[~touched])


def _within(y, ref, scale):
    return float(((y - ref).abs() - 1e-5 * scale).max()) <= 0.0


@pytest.mark.parametrize("n,k,d", [(50_000, 32, 8192), (1000, 7, 16384),
                                   (300, 0, 64)],
                         ids=["reference-width", "64KB-table", "empty-rows"])
def test_ell_kernel_matches_plain(cuda, n, k, d):
    cols_T, vals_T, w = (torch.as_tensor(a, device=cuda)
                         for a in g8192.make_ell(n, k, d, seed=1))
    _kernels.reset_launches()
    m = g8192.ell_matvec(cols_T, vals_T, w)
    m2 = g8192.ell_matvec(cols_T, vals_T, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["ell_matvec"] == 2
    assert m.shape == (n,) and torch.equal(m, m2)
    ref = g8192.ell_matvec_plain(cols_T, vals_T, w)
    scale = g8192.ell_matvec_plain(cols_T, vals_T.abs(), w.abs())
    assert _within(m, ref, scale)


def test_ell_table_beyond_shared_memory_is_refused(cuda):
    limit = g8192.max_dim(cuda)
    assert limit >= 8192  # 227 KB on an H100
    cols_T = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    vals_T = torch.ones((2, 64), device=cuda)
    with pytest.raises(ValueError, match="shared memory"):
        g8192.ell_matvec(cols_T, vals_T, torch.ones(limit + 1, device=cuda))
    m = g8192.ell_matvec(cols_T, vals_T, torch.ones(limit, device=cuda))
    assert m.tolist() == [2.0] * 64


WINDOW_CASES = ["1-block", "3-blocks", "133-blocks", "overflow"]


def _window_case(case, cuda):
    """(lo, v, rhi, w, ell) on the card: the reference's layout of 1 or 3
    blocks, with ell = (cols_T, vals_T) when nothing spilled; a random
    layout of 133 blocks, more than an H100 has SMs, so the persistent
    grid wraps (ell None); or one block where every row of lane 0 puts its
    32 entries in column window 0, so cell (window 0, lane 0) holds all 64
    slots live and the rest spill (ell None)."""
    B = g8192_v2.BLOCK_ROWS
    if case == "133-blocks":
        gen = torch.Generator(device=cuda).manual_seed(5)
        shape = (133, g8192_v2.A, g8192_v2.LANES)
        lo = torch.randint(0, 128, shape, generator=gen, device=cuda,
                           dtype=torch.int32)
        rhi = torch.randint(0, 64, shape, generator=gen, device=cuda,
                            dtype=torch.int32)
        live = torch.rand(shape, generator=gen, device=cuda) < 0.5
        v = torch.randn(shape, generator=gen, device=cuda) * live
        w = torch.randn(g8192_v2.D, generator=gen, device=cuda)
        return lo, v, rhi, w, None
    if case == "overflow":
        rng = np.random.default_rng(3)
        cols = rng.integers(0, 8192, size=(B, 32), dtype=np.int32)
        vals = rng.normal(size=(B, 32)).astype(np.float32)
        lane0 = np.arange(0, B, 128)
        cols[lane0] = rng.integers(0, 128, size=(len(lane0), 32),
                                   dtype=np.int32)
        w = np.random.default_rng(4).normal(size=8192).astype(np.float32)
        lo, v, rhi, spill = g8192_v2.build_layout(cols, vals, B)
        assert spill > 0 and bool((v[0, :g8192_v2.DEPTH, 0] != 0).all())
        ell = None
    else:
        nb = 1 if case == "1-block" else 3
        cols_T, vals_T, w = g8192.make_ell(nb * B, 32, 8192, 2)
        lo, v, rhi, spill = g8192_v2.build_layout(cols_T.T, vals_T.T, nb * B)
        ell = (cols_T, vals_T) if spill == 0 else None
    lo, v, rhi, w = (torch.as_tensor(a, device=cuda) for a in (lo, v, rhi, w))
    return lo, v, rhi, w, ell


@pytest.mark.parametrize("case", WINDOW_CASES)
def test_window_kernel_matches_plain(cuda, case):
    lo, v, rhi, w, ell = _window_case(case, cuda)
    nb = lo.shape[0]
    _kernels.reset_launches()
    out = g8192_v2.window_matvec(lo, v, rhi, w)
    out2 = g8192_v2.window_matvec(lo, v, rhi, w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["window_matvec"] == 2
    assert out.shape == (nb, 64, 128) and torch.equal(out, out2)
    ref = g8192_v2.window_matvec_plain(lo, v, rhi, w)
    scale = g8192_v2.window_matvec_plain(lo, v.abs(), rhi, w.abs())
    assert _within(out, ref, scale)
    if ell is not None:
        cols_T, vals_T = (torch.as_tensor(a, device=cuda) for a in ell)
        m = g8192.ell_matvec(cols_T, vals_T, w)
        ell_scale = g8192.ell_matvec_plain(cols_T, vals_T.abs(), w.abs())
        assert _within(out.reshape(-1), m, ell_scale)


def test_window_kernel_nonfinite_w_matches_plain(cuda):
    """inf at w[5·128] (read by every padded slot of window 5: 0·inf = NaN
    in row group 0) and at a live column of window 9: the kernel's NaN and
    inf land where the plain version's do, the rest within rtol."""
    lo, v, rhi, w, _ = _window_case("3-blocks", cuda)
    sub = slice(9 * g8192_v2.DEPTH, 10 * g8192_v2.DEPTH)
    live = lo[:, sub][(v[:, sub] != 0) & (lo[:, sub] != 0)]
    w = w.clone()
    w[5 * 128] = float("inf")
    w[9 * 128 + int(live[0])] = float("inf")
    out = g8192_v2.window_matvec(lo, v, rhi, w)
    ref = g8192_v2.window_matvec_plain(lo, v, rhi, w)
    torch.cuda.synchronize()
    for kind in (torch.isnan, torch.isposinf, torch.isneginf):
        assert torch.equal(kind(out), kind(ref)), kind.__name__
    assert bool(torch.isnan(ref[:, 0]).any()) and bool(torch.isinf(ref).any())
    finite = torch.isfinite(ref)
    scale = g8192_v2.window_matvec_plain(lo, v.abs(), rhi, w.abs())
    assert _within(out[finite], ref[finite], scale[finite])


@pytest.mark.parametrize("operand", ["lo", "v", "rhi"])
def test_window_kernel_refuses_misaligned_operands(cuda, operand):
    """A contiguous view that starts 4 bytes past a 16-byte boundary: the
    wrapper raises ValueError naming the alignment, and the library itself
    refuses the launch (no bulk copy from a misaligned address)."""
    lo, v, rhi, w, _ = _window_case("1-block", cuda)
    ops = {"lo": lo, "v": v, "rhi": rhi}
    t = ops[operand]
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=cuda)
    view = flat[1:].view(t.shape)
    view.copy_(t)
    assert view.is_contiguous() and view.data_ptr() % 16 == 4
    ops[operand] = view
    with pytest.raises(ValueError, match="16-byte aligned"):
        g8192_v2.window_matvec(ops["lo"], ops["v"], ops["rhi"], w)
    with pytest.raises(RuntimeError, match="misaligned"):
        g8192_v2.launch_window(g8192_v2.KERNEL, g8192_v2.KERNEL, ops["lo"],
                               ops["v"], ops["rhi"], w)
    assert torch.equal(g8192_v2.window_matvec_plain(ops["lo"], ops["v"],
                                                    ops["rhi"], w),
                       g8192_v2.window_matvec_plain(lo, v, rhi, w))


def test_window_kernel_design_fits_the_card(cuda):
    cfg = g8192_v2.window_config(cuda, 133)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert min(133, sms) <= cfg["ctas"] <= 133 and cfg["stream_only"] == 0
    assert cfg["threads"] == 128 * cfg["copies"] + 32
    ring = cfg["stages"] * 3 * cfg["tile"] * 512
    assert cfg["shared_bytes"] == ring + (1 + cfg["copies"]) * 32768
    assert cfg["shared_bytes"] <= 227 * 1024


@pytest.mark.parametrize("which", ["g8192", "g8192_v2"])
def test_graph_chain_equals_eager_chain(cuda, which):
    cols_T, vals_T, w = g8192.make_ell(g8192_v2.BLOCK_ROWS, 32, 8192, 3)
    vals_T = vals_T * np.float32(1e19)  # each pass moves w
    w = torch.as_tensor(w, device=cuda)
    if which == "g8192":
        args = [torch.as_tensor(a, device=cuda) for a in (cols_T, vals_T)]
        mod = g8192
    else:
        lo, v, rhi, _ = g8192_v2.build_layout(cols_T.T, vals_T.T,
                                              g8192_v2.BLOCK_ROWS)
        args = [torch.as_tensor(a, device=cuda) for a in (lo, v, rhi)]
        mod = g8192_v2
    eager = mod.chain(w, *args, reps=4, graph=False)
    graph = mod.chain(w, *args, reps=4, graph=True)
    torch.cuda.synchronize()
    assert not torch.equal(eager, w)
    assert torch.equal(graph, eager)
    # Replaying one captured graph twice from the same input repeats it.
    g = common.ChainGraph(lambda x: mod.step(x, *args), w, reps=4)
    assert torch.equal(g(w), eager) and torch.equal(g(w), eager)
    assert g.replays == 2


@pytest.mark.parametrize("op", ablate.OPS)
def test_ablation_modes_match_plain(cuda, op):
    n = 3 * (1 << 14)  # one and a half row blocks of the column kernel
    rows, cols, vals = _matrix(4, n, 8192, 32, unit=False)
    M = build_cuda_matrix(rows, cols, vals, n, 8192, unit_values=False,
                          device=cuda)
    indptr, idx, val, n_in, layout = ablate.side(M, op)
    x = ablate.operand(M, op)
    _kernels.reset_launches()
    for mode in ablate.MODES:
        y = ablate.spmv_ablate(mode, indptr, idx, val, x, n_in, op, **layout)
        y2 = ablate.spmv_ablate(mode, indptr, idx, val, x, n_in, op,
                                **layout)
        torch.cuda.synchronize()
        assert torch.equal(y, y2), mode
        ref = ablate.spmv_ablate_plain(mode, indptr, idx, val, x, n_in)
        scale = ablate.spmv_ablate_plain(mode, indptr, idx, val.abs(),
                                         x.abs(), n_in)
        assert _within(y, ref, scale), mode
        assert _kernels.LAUNCHES[f"spmv_ablate_{mode}_{op}"] == 2
    # FULL is the production instance: bitwise the same as the wrapper.
    prod = _kernel(M, op, x)
    full = ablate.spmv_ablate("full", indptr, idx, val, x, n_in, op, **layout)
    assert torch.equal(prod, full)


# -- the solvers on the kernels ------------------------------------------------


def _glm_pair(cuda, task="logistic", n=1 << 15, d=2048, k=16):
    """The same GLM data twice on the card: through the SpMV kernels and as
    the COO matrix (plain PyTorch products)."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.data.dataset import make_glm_data

    rows, cols, vals = _matrix(11, n, d, k, unit=False)
    rng = np.random.default_rng(12)
    w_true = rng.normal(size=d) * (rng.uniform(size=d) < 0.2)
    m = np.bincount(rows, weights=vals * w_true[cols], minlength=n)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
    return (make_glm_data(X, y, use_kernel=True, device=cuda),
            make_glm_data(X, y, use_kernel=False, device=cuda))


def _solver_problem(solver):
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    reg = (RegularizationContext.elastic_net(0.5) if solver == "owlqn"
           else RegularizationContext.l2())
    # A float64 value: above the float32 noise floor, where the kernels'
    # and the COO products' summation orders would decide the last steps.
    return GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=200, tolerance=1e-5,
                                  solver=solver),
        regularization=reg), accumulate="f64")


@pytest.mark.parametrize("solver", ["owlqn", "tron", "spg"])
def test_solver_on_kernels_matches_coo(cuda, solver):
    """Each solver through the SpMV kernels against the same solve on the
    COO matrix: coefficients within 1e-4 of max|w|, the objective within
    rtol 1e-6, iterations within ±3, the same convergence (and support for
    OWL-QN, active bounds for SPG, up to coefficients within 1e-4·max|w|)."""
    kernel, plain = _glm_pair(cuda)
    d = kernel.n_features
    bounds = None
    if solver == "spg":
        bounds = (torch.full((d,), -0.05, device=cuda),
                  torch.full((d,), 0.05, device=cuda))
    problem = _solver_problem(solver)
    _kernels.reset_launches()
    res = problem.solve(kernel, 4.0, bounds=bounds)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["matvec"] > 0 and _kernels.LAUNCHES["rmatvec"] > 0
    ref = problem.solve(plain, 4.0, bounds=bounds)
    w, rw = res.w.cpu().numpy(), ref.w.cpu().numpy()
    scale = np.abs(rw).max()
    assert np.abs(w - rw).max() <= 1e-4 * scale
    np.testing.assert_allclose(float(res.value), float(ref.value), rtol=1e-6)
    assert abs(res.iterations - ref.iterations) <= 3
    assert res.converged == ref.converged and res.stalled == ref.stalled
    small = np.maximum(np.abs(w), np.abs(rw)) <= 1e-4 * scale
    if solver == "owlqn":
        assert 0 < int((w == 0).sum()) < d
        assert np.all(small[(w == 0) != (rw == 0)])
    if solver == "spg":
        lo, hi = (b.cpu().numpy() for b in bounds)
        assert np.all((w >= lo) & (w <= hi))
        for b in (lo, hi):
            near = np.maximum(np.abs(w - b), np.abs(rw - b)) <= 1e-4 * scale
            assert np.all(near[(w == b) != (rw == b)])


def test_owlqn_solve_repeats_bitwise(cuda):
    kernel, _ = _glm_pair(cuda)
    problem = _solver_problem("owlqn")
    a = problem.solve(kernel, 4.0)
    b = problem.solve(kernel, 4.0)
    assert torch.equal(a.w, b.w) and a.iterations == b.iterations
    assert int((a.w == 0).sum()) > 0


def test_tron_hvp_on_kernels_matches_plain(cuda):
    kernel, plain = _glm_pair(cuda)
    obj = _solver_problem("tron").objective
    gen = torch.Generator(device=cuda).manual_seed(13)
    w = 0.1 * torch.randn(kernel.n_features, device=cuda, generator=gen)
    v = torch.randn(kernel.n_features, device=cuda, generator=gen)
    d2w = obj.d2_weights(w, kernel)
    _kernels.reset_launches()
    hv = obj.hvp(w, v, kernel, l2_weight=0.5, d2w=d2w)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["matvec"] == 1 and _kernels.LAUNCHES["rmatvec"] == 1
    ref = obj.hvp(w, v, plain, l2_weight=0.5)
    F = plain.features
    absF = type(F)(F.row_ids, F.col_ids, F.values.abs(), F.n_rows, F.n_cols)
    scale = absF.rmatvec(obj.d2_weights(w, plain) * absF.matvec(v.abs()))
    assert _within(hv, ref, scale + 0.5 * v.abs())
    assert torch.equal(hv, obj.hvp(w, v, kernel, l2_weight=0.5, d2w=d2w))


# -- GAME on the card ----------------------------------------------------------


def _game_dataset(device, d=5, n=6000, cap=None, dtype=torch.float32):
    """A random effect whose buckets take every solver path: rank-1
    (single-row entities), scalar Newton (d = 1) or batched Newton."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.data import build_random_effect_dataset

    rng = np.random.default_rng(21)
    sizes = np.minimum(rng.zipf(1.7, 800), 64)
    keys = np.repeat(np.array([f"e{i}" for i in range(800)], dtype=object),
                     sizes)[: n]
    n = len(keys)
    X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (0.3 * rng.normal(size=n)).astype(np.float32)
    ds = build_random_effect_dataset(keys, X, y, np.ones(n, np.float32),
                                     max_rows_per_entity=cap, device=device,
                                     dtype=dtype)
    return ds, torch.as_tensor(off, device=device)


def _re_coordinate(ds):
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    cfg = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=20, tolerance=1e-6),
        regularization=RegularizationContext.l2())
    return RandomEffectCoordinate("re", ds, "logistic", cfg, reg_weight=0.5)


@pytest.mark.parametrize("d", [1, 5])
def test_block_solvers_on_card_match_float64_cpu(cuda, d):
    """Each bucket's float32 solve on the card against the same solver run
    in float64 on the CPU: within 1e-4 of the bucket's largest coefficient
    (the float32 solve stops at its own noise floor)."""
    ds, off = _game_dataset(cuda, d=d)
    ds64, off64 = _game_dataset("cpu", d=d, dtype=torch.float64)
    coord, coord64 = _re_coordinate(ds), _re_coordinate(ds64)
    assert ds.blocks[0].rows_per_entity == 1  # the rank-1 path runs
    state = coord.train(off)
    state64 = coord64.train(off64.double())
    for w, w64 in zip(state, state64):
        w64 = w64.numpy()
        err = np.abs(w.cpu().numpy() - w64).max()
        assert err <= 1e-4 * np.abs(w64).max(), err
    assert coord.last_solve.host_reads == max(coord.last_solve.bodies) + 1


def test_re_scoring_on_card_repeats_bitwise(cuda):
    ds, off = _game_dataset(cuda, cap=8)
    assert any(b is not None for b in ds.passive_blocks)
    coord = _re_coordinate(ds)
    state = coord.train(off)
    a, b = coord.score(state), coord.score(state)
    assert torch.equal(a, b) and bool((a != 0).all())
    import dataclasses

    from photon_ml_tpu_torch.game.coordinates import score_blocks

    ds_cpu, _ = _game_dataset("cpu", cap=8)
    host = _re_coordinate(ds_cpu).score([s.cpu() for s in state])

    def absolute(blocks):
        return [None if b is None else dataclasses.replace(b, X=b.X.abs())
                for b in blocks]

    scale = score_blocks(ds_cpu.n_global_rows, absolute(ds_cpu.blocks),
                         absolute(ds_cpu.passive_blocks),
                         [s.cpu().abs() for s in state], "cpu")
    assert bool(((a.cpu() - host).abs() <= 1e-6 * scale).all())


def test_device_auc_on_card_matches_host(cuda):
    from photon_ml_tpu_torch.evaluation.device import device_auc
    from photon_ml_tpu_torch.evaluation.evaluators import (
        AreaUnderROCCurveEvaluator,
    )

    rng = np.random.default_rng(22)
    s = np.round(rng.normal(size=200_000), 2).astype(np.float32)
    y = (rng.uniform(size=s.size) < 0.3).astype(np.float32)
    w = rng.uniform(0, 2, size=s.size).astype(np.float32)
    got = device_auc(*(torch.as_tensor(a, device=cuda) for a in (s, y, w)))
    assert got.device.type == "cuda"
    assert abs(float(got) - AreaUnderROCCurveEvaluator().evaluate(s, y, w)
               ) <= 1e-9


def test_game_descent_on_card_runs_the_kernels_and_repeats(cuda):
    import scipy.sparse as sp

    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    from photon_ml_tpu_torch.game.data import FixedEffectDataset
    from photon_ml_tpu_torch.game.descent import CoordinateDescent

    ds, _ = _game_dataset(cuda)
    re = _re_coordinate(ds)
    n = ds.n_global_rows
    rows, cols, vals = _matrix(23, n, 256, 8, unit=False)
    y = (np.random.default_rng(24).uniform(size=n) < 0.5).astype(np.float32)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, 256))
    fe = FixedEffectCoordinate(
        "fixed", FixedEffectDataset(make_glm_data(X, y, device=cuda), n),
        "logistic", re.config, reg_weight=1.0)
    _kernels.reset_launches()
    a = CoordinateDescent([fe, re]).run(torch.zeros(n, device=cuda), 2)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["matvec"] > 0 and _kernels.LAUNCHES["rmatvec"] > 0
    b = CoordinateDescent([fe, re]).run(torch.zeros(n, device=cuda), 2)
    assert torch.equal(a.states["fixed"], b.states["fixed"])
    assert all(torch.equal(u, v) for u, v in zip(a.states["re"],
                                                 b.states["re"]))
    assert [h["score_norm"] for h in a.history] == [
        h["score_norm"] for h in b.history]


def test_grid_loop_restores_onto_the_card(cuda):
    from photon_ml_tpu_torch.optim.lbfgs import SolveResult
    from photon_ml_tpu_torch.optim.problem import GlmOptimizationProblem

    received = []

    def solve_fn(lam, w_prev):
        received.append(w_prev)
        return SolveResult(w_prev, w_prev.sum(), w_prev, 0, True,
                           torch.zeros(1), torch.zeros(1))

    solved = {10.0: np.arange(5, dtype=np.float32)}
    GlmOptimizationProblem("logistic").grid_loop(
        solve_fn, [10.0, 1.0], solved=solved, device=cuda)
    assert received[0].device.type == "cuda"
    assert received[0].dtype == torch.float32
    # Without a device: the default device, CUDA here.
    received.clear()
    GlmOptimizationProblem("logistic").grid_loop(solve_fn, [10.0, 1.0],
                                                 solved=solved)
    assert received[0].device.type == "cuda"


def test_validation_scorers_on_card_match_plain(cuda):
    """The fixed-effect validation scorer's matvec runs the row kernel on
    the card and agrees with its plain version (the same scorer on the
    CPU); the random-effect scorer agrees with the CPU's and repeats
    bitwise."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.validation import (
        FixedEffectValidationScorer,
        RandomEffectValidationScorer,
    )

    rows, cols, vals = _matrix(25, 20_000, 512, 8, unit=False)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(20_000, 512))
    w = np.random.default_rng(26).normal(size=512).astype(np.float32)
    _kernels.reset_launches()
    got = FixedEffectValidationScorer(X, device=cuda).score(
        torch.as_tensor(w, device=cuda))
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["matvec"] == 1
    plain = FixedEffectValidationScorer(X, device="cpu").score(
        torch.as_tensor(w))
    scale = torch.as_tensor(abs(X) @ np.abs(w))
    assert bool(((got.cpu() - plain).abs() <= 1e-5 * scale).all())

    ds, _ = _game_dataset(cuda)
    ds_cpu, _ = _game_dataset("cpu")
    rng = np.random.default_rng(27)
    keys = np.array([f"e{i}" for i in rng.integers(0, 900, size=3000)],
                    dtype=object)
    Xv = sp.csr_matrix(rng.normal(size=(3000, 5)).astype(np.float32))
    state = [rng.normal(size=(b.n_entities, b.block_dim)).astype(np.float32)
             for b in ds.blocks]
    card = RandomEffectValidationScorer(ds, keys, Xv, device=cuda)
    host = RandomEffectValidationScorer(ds_cpu, keys, Xv, device="cpu")
    a = card.score([torch.as_tensor(s, device=cuda) for s in state])
    b = card.score([torch.as_tensor(s, device=cuda) for s in state])
    h = host.score([torch.as_tensor(s) for s in state])
    assert torch.equal(a, b)
    assert bool(((a.cpu() - h).abs() <= 1e-6 * (1 + h.abs())).all())
    unseen = np.array([int(k[1:]) >= 800 for k in keys])
    assert bool((a.cpu()[torch.as_tensor(unseen)] == 0).all())


def test_game_drivers_on_card(cuda, tmp_path):
    """A small training run with validation and a scoring run on the card:
    the kernels launch in training and in validation scoring, the scoring
    driver's device AUC equals the training driver's validation AUC, and
    the card's run agrees with the same run on the CPU."""
    import json

    from photon_ml_tpu_torch.data.game_reader import write_game_avro
    from photon_ml_tpu_torch.drivers import (
        game_scoring_driver,
        game_training_driver,
    )

    rng = np.random.default_rng(28)
    effect = {f"u{u}": rng.normal(scale=2.0) for u in range(50)}

    def rows(n, start):
        out = []
        for i in range(start, start + n):
            u = f"u{rng.integers(55)}"
            # 6 of 200 global features a row: no column reaches the dense
            # stripe threshold, so every product streams through the kernel.
            cols = rng.choice(200, size=6, replace=False)
            xg = rng.normal(size=6)
            m = 1.5 * xg[0] * (cols[0] < 100) + effect.get(u, 0.0)
            out.append({
                "uid": f"r{i}", "weight": None, "offset": None,
                "response": float(rng.uniform() < 1 / (1 + np.exp(-m))),
                "ids": {"userId": u},
                "features": {
                    "global": [{"name": f"g{c}", "term": "",
                                "value": float(v)} for c, v in zip(cols, xg)],
                    "userFeatures": [{"name": "b", "term": "",
                                      "value": 1.0}],
                },
            })
        return out

    train, val = str(tmp_path / "t.avro"), str(tmp_path / "v.avro")
    write_game_avro(train, rows(3000, 0))
    write_game_avro(val, rows(800, 3000))
    cfg = str(tmp_path / "c.json")
    with open(cfg, "w") as f:
        json.dump({"task": "logistic", "iterations": 2, "evaluator": "auc",
                   "coordinates": [
                       {"name": "fixed", "type": "fixed",
                        "feature_shard": "global", "max_iters": 30,
                        "reg_type": "l2", "reg_weight": 0.5},
                       {"name": "per_user", "type": "random",
                        "feature_shard": "userFeatures",
                        "entity_key": "userId", "max_iters": 20,
                        "reg_type": "l2", "reg_weight": 0.5}]}, f)
    runs = {}
    for dev in ("cuda", "cpu"):
        _kernels.reset_launches()
        runs[dev] = game_training_driver.run([
            "--train-data", train, "--validate-data", val, "--config", cfg,
            "--output-dir", str(tmp_path / dev), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
            launches = dict(_kernels.LAUNCHES)
    assert launches["matvec"] > 0 and launches["rmatvec"] > 0
    assert abs(runs["cuda"]["validation_metric"]
               - runs["cpu"]["validation_metric"]) <= 2e-3
    score = game_scoring_driver.run([
        "--data", val, "--model-dir", str(tmp_path / "cuda"),
        "--output-dir", str(tmp_path / "s"), "--evaluator", "auc",
        "--device-metrics", "--device", "cuda"])
    assert abs(score["metric"] - runs["cuda"]["validation_metric"]) <= 1e-6


# -- the batched random-effect fallback and the factored random effect -------


def _wide_dataset(device, d=64, n_ent=300, dtype=torch.float32):
    """A random effect over ``d`` sparse features: several D > 32 buckets
    of R > 1 (the batched fallback's buckets), and narrow rank-1 ones."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.data import build_random_effect_dataset

    rng = np.random.default_rng(25)
    sizes = np.minimum(rng.zipf(1.6, n_ent), 60)
    n = int(sizes.sum())
    keys = np.repeat(np.array([f"e{i}" for i in range(n_ent)], dtype=object),
                     sizes)[rng.permutation(n)]
    X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32)
                      * (rng.uniform(size=(n, d)) < 0.2))
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    off = (0.3 * rng.normal(size=n)).astype(np.float32)
    ds = build_random_effect_dataset(keys, X, y, np.ones(n, np.float32),
                                     bucket_growth=4.0, device=device,
                                     dtype=dtype)
    return ds, torch.as_tensor(off, device=device, dtype=dtype)


def _fallback_solver(kind):
    from photon_ml_tpu_torch.game.coordinates import BlockSolver
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
        OptimizerType,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    reg = (RegularizationContext.elastic_net(0.5) if kind == "owlqn"
           else RegularizationContext.l2())
    opt = OptimizerType.TRON if kind == "tron" else OptimizerType.LBFGS
    cfg = GlmOptimizationConfig(
        optimizer=OptimizerConfig(optimizer=opt, max_iters=10,
                                  tolerance=1e-6),
        regularization=reg)
    return BlockSolver("logistic", cfg), reg.l1_weight(1.0), \
        reg.l2_weight(1.0)


@pytest.mark.parametrize("kind", ["lbfgs", "owlqn", "tron"])
def test_batched_solvers_on_card_follow_each_lanes_single_solve(cuda, kind):
    """Every fallback bucket on the card in float64, each lane re-solved
    alone by the port's single-problem solver: the same iterations and the
    same coefficients within 1e-9 of ‖w‖ (each lane follows its own
    trajectory).  In float32 the lanes part at the noise floor (one ulp
    decides a trial or the stall test) and land within 5e-3 of the largest
    ‖w‖ of the lanes tested in the bucket."""
    from photon_ml_tpu_torch.game.coordinates import _gather_block_offsets

    solver, l1, l2 = _fallback_solver(kind)
    tested = 0
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 5e-3)):
        ds, off = _wide_dataset(cuda, dtype=dtype)
        for b in ds.blocks:
            w0 = torch.zeros(b.n_entities, b.block_dim, dtype=dtype,
                             device=cuda)
            ob = _gather_block_offsets(off, b)
            prog = solver.program(b, ob, w0, l1, l2)
            if prog.iterations is None:
                continue
            ws, stats = solver.solve_all([(b, ob, w0)], l1, l2)
            its = stats.iterations[0].cpu().numpy()
            errs, norms = [], []
            for e in range(min(b.n_entities, 64)):
                res = prog.single(e, w0[e])
                norms.append(float(torch.linalg.vector_norm(res.w)))
                errs.append(float(torch.linalg.vector_norm(ws[0][e]
                                                           - res.w)))
                if dtype == torch.float64:
                    assert res.iterations == its[e]
                    assert errs[-1] <= tol * max(norms[-1], 1e-30)
                tested += 1
            assert max(errs) <= tol * max(max(norms), 1e-30), (
                b.X.shape, max(errs), max(norms))
    assert tested >= 128


def test_fallback_lockstep_on_card_repeats_bitwise(cuda):
    from photon_ml_tpu_torch.game.coordinates import _gather_block_offsets

    ds, off = _wide_dataset(cuda)
    for kind in ("lbfgs", "owlqn", "tron"):
        solver, l1, l2 = _fallback_solver(kind)
        items = [(b, _gather_block_offsets(off, b),
                  torch.zeros(b.n_entities, b.block_dim, device=cuda))
                 for b in ds.blocks]
        a, sa = solver.solve_all(items, l1, l2)
        b, sb = solver.solve_all(items, l1, l2)
        assert all(torch.equal(x, y) for x, y in zip(a, b))
        assert sa.bodies == sb.bodies
        assert max(sa.bodies) <= sa.host_reads <= max(sa.bodies) + 1


def test_factored_projection_gradient_on_card_repeats_bitwise(cuda):
    """The projection gradient's deterministic column sums: bitwise equal
    across calls and within 1e-5 of the float64 CPU computation."""
    from photon_ml_tpu_torch.game.factored import (
        FactoredRandomEffectCoordinate,
    )

    def coord(device, dtype):
        ds, off = _wide_dataset(device, dtype=dtype)
        cfg = _fallback_solver("lbfgs")[0].config
        return FactoredRandomEffectCoordinate("f", ds, "logistic", cfg,
                                              rank=8, reg_weight=1.0,
                                              projection_reg_weight=0.1), off

    c, off = coord(cuda, torch.float32)
    c64, off64 = coord("cpu", torch.float64)
    rng = np.random.default_rng(26)
    u_np = [rng.normal(size=(b.n_entities, 8)) for b in c.dataset.blocks]
    V_np = rng.normal(size=(c.dataset.n_features, 8)) * 0.3
    args = (torch.as_tensor(V_np.reshape(-1), dtype=torch.float32,
                            device=cuda), c.block_offsets(off),
            [torch.as_tensor(u, dtype=torch.float32, device=cuda)
             for u in u_np])
    val, g = c.projection_value_grad(*args)
    for _ in range(3):
        val2, g2 = c.projection_value_grad(*args)
        assert torch.equal(g, g2) and torch.equal(val, val2)
    val64, g64 = c64.projection_value_grad(
        torch.as_tensor(V_np.reshape(-1)), c64.block_offsets(off64),
        [torch.as_tensor(u) for u in u_np])
    err = float((g.double().cpu() - g64).abs().max())
    assert err <= 1e-5 * float(g64.abs().max()), err
    assert abs(float(val) - float(val64)) <= 1e-5 * abs(float(val64))
    state = c.train(off)
    again = c.train(off)
    assert torch.equal(state[1], again[1])
    assert all(torch.equal(u, v) for u, v in zip(state[0], again[0]))


def _stream_problem(seed, n, d, k):
    """n rows of about k normal values over d columns, logistic labels."""
    import scipy.sparse as sp

    rows, cols, vals = _matrix(seed, n, d, k, unit=False)
    X = sp.csr_matrix((vals, (rows, cols)), shape=(n, d))
    rng = np.random.default_rng(seed + 1)
    m = np.asarray(X @ (rng.normal(size=d) * 0.3)).ravel()
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-m))).astype(np.float32)
    return X, y


def test_streamed_pass_on_card_matches_resident(cuda):
    """A streamed value+grad pass over kernel-layout chunks (pinned slots,
    the copy stream, one event a chunk) equals the resident kernel pass
    within 1e-5 of the largest gradient entry, launches both SpMV kernels
    per chunk, and depth 1 equals depth 2 bitwise."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.optim.objective import GlmObjective
    from photon_ml_tpu_torch.optim.streaming import StreamingObjective
    from photon_ml_tpu_torch.ops import losses

    X, y = _stream_problem(31, 1 << 16, 4096, 32)
    stream = make_streaming_glm_data(X, y, chunk_rows=1 << 14, device=cuda)
    assert stream.kind == "kernel" and stream.n_chunks == 4
    w = torch.randn(4096, device=cuda,
                    generator=torch.Generator(cuda).manual_seed(3)) * 0.1
    obj = GlmObjective(losses.get("logistic"))
    v_r, g_r = obj.value_and_grad(w, make_glm_data(X, y, device=cuda), 0.5)
    _kernels.reset_launches()
    s1 = StreamingObjective(obj, stream, prefetch_depth=1)
    v1, g1 = s1.value_and_grad(w, 0.5)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["matvec"] == _kernels.LAUNCHES["rmatvec"] == 4
    assert abs(float(v1) - float(v_r)) <= 1e-5 * abs(float(v_r))
    assert float((g1 - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
    v2, g2 = StreamingObjective(obj, stream, prefetch_depth=2
                                ).value_and_grad(w, 0.5)
    assert torch.equal(v1, v2) and torch.equal(g1, g2)
    assert s1.transfer_stats.h2d_device_seconds > 0.0


def test_cross_stream_stress_depth3_bitwise_depth1(cuda):
    """Many small chunks at depth 3 (copies on the copy stream racing the
    kernels on the compute stream, the allocator recycling chunk buffers):
    every pass kind bitwise equal to depth 1, five passes in a row, with
    the lossless codec and the hot cache too."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.optim.streaming import StreamingObjective

    X, y = _stream_problem(37, 1 << 15, 2048, 16)
    stream = make_streaming_glm_data(X, y, chunk_rows=512, device=cuda)
    assert stream.n_chunks == 64
    gen = torch.Generator(cuda).manual_seed(5)
    w = torch.randn(2048, device=cuda, generator=gen) * 0.1
    v = torch.randn(2048, device=cuda, generator=gen)
    ref = StreamingObjective("logistic", stream, prefetch_depth=1)
    want = (ref.value_and_grad(w, 0.5), ref.hvp(w, v, 0.5), ref.scores(w))
    for kw in ({}, {"compress": "lossless", "hot_budget_bytes": 1 << 22}):
        fast = StreamingObjective("logistic", stream, prefetch_depth=3, **kw)
        for _ in range(5):
            vg = fast.value_and_grad(w, 0.5)
            assert torch.equal(vg[0], want[0][0])
            assert torch.equal(vg[1], want[0][1])
        assert torch.equal(fast.hvp(w, v, 0.5), want[1])
        np.testing.assert_array_equal(fast.scores(w), want[2])


def _ooc_problem(seed=41, n_entities=400):
    """A zipf-tailed per-entity problem (several buckets) as a resident
    dataset on the card and a host dataset, with its logistic config."""
    import scipy.sparse as sp

    from photon_ml_tpu_torch.game.data import build_random_effect_dataset
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    rng = np.random.default_rng(seed)
    counts = np.clip(rng.zipf(1.6, size=n_entities), 1, 64)
    keys = np.repeat([f"e{i}" for i in range(n_entities)], counts)
    n, d = len(keys), 6
    X = sp.random(n, d, density=0.6, random_state=seed, format="csr",
                  dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    w = np.ones(n, np.float32)
    cfg = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=20, tolerance=1e-6),
        regularization=RegularizationContext.l2())
    return (build_random_effect_dataset(keys, X, y, w, device="cuda"),
            build_random_effect_dataset(keys, X, y, w, device=False), cfg,
            rng.normal(size=n).astype(np.float32))


def test_out_of_core_random_effect_on_card(cuda):
    """The out-of-core random effect on the card at an eighth of its host
    bytes: coefficients within 1e-5 and scores within 1e-4 of the resident
    coordinate (the reference's tolerances), depth 1 = depth 2 and a hot
    cache at half the static bytes = uncached, bitwise over three updates,
    at most ``prefetch_depth`` groups live."""
    from photon_ml_tpu_torch.game.coordinates import RandomEffectCoordinate
    from photon_ml_tpu_torch.game.ooc_random import (
        OutOfCoreRandomEffectCoordinate,
    )

    res_ds, host, cfg, off_np = _ooc_problem()
    budget = sum(a.nbytes for b in host.blocks for a in b.leaves()) // 8
    off = torch.as_tensor(off_np, device=cuda)
    res = RandomEffectCoordinate("re", res_ds, "logistic", cfg,
                                 reg_weight=0.5)
    st_r = res.train(off)

    def run(budget=budget, **kw):
        c = OutOfCoreRandomEffectCoordinate(
            "re", host, "logistic", cfg, reg_weight=0.5,
            device_budget_bytes=budget, device=cuda, **kw)
        state, scores = None, []
        for _ in range(3):
            state = c.train(off, warm_state=state)
            scores.append(c.score(state))
            assert 1 <= c.live_groups_high_water <= c.prefetch_depth
        return c, state, scores

    c, st, sc = run()
    assert len(c.pass_plan) >= 8
    first = OutOfCoreRandomEffectCoordinate(
        "re", host, "logistic", cfg, reg_weight=0.5,
        device_budget_bytes=budget, device=cuda)
    st1 = first.train(off)
    for a, b in zip(st1, st_r):
        assert np.abs(a - b.cpu().numpy()).max() <= 1e-5
    assert float((first.score(st1) - res.score(st_r)).abs().max()) <= 1e-4
    static = sum(c._group_static_bytes(k, g) for g in c.pass_plan
                 for k in ("train", "score"))
    # Depth 1 at half the budget: the same per-pass budget, the same plan.
    for kw in ({"prefetch_depth": 1, "budget": budget // 2},
               {"hot_budget_bytes": static // 2}):
        c2, st2, sc2 = run(**kw)
        assert c2.pass_plan == c.pass_plan
        assert all(np.array_equal(a, b) for a, b in zip(st, st2))
        assert all(torch.equal(a, b) for a, b in zip(sc, sc2))
    assert c2.hot_cache.hits > 0


def test_streamed_game_fixed_effect_on_card(cuda):
    """The streamed GAME fixed effect (kernel-layout chunks) against the
    resident fixed effect on the card: within the reference's 5e-3, the
    SpMV kernels launched per chunk, and depth 1 = depth 2 bitwise."""
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.game.coordinates import FixedEffectCoordinate
    from photon_ml_tpu_torch.game.data import FixedEffectDataset
    from photon_ml_tpu_torch.game.streaming import (
        StreamingFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext

    X, y = _stream_problem(43, 1 << 15, 512, 8)
    cfg = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=30, tolerance=1e-6),
        regularization=RegularizationContext.l2())
    off = torch.as_tensor(np.random.default_rng(2).normal(
        size=X.shape[0]).astype(np.float32) * 0.1, device=cuda)
    res = FixedEffectCoordinate("fixed", FixedEffectDataset(
        make_glm_data(X, y, device=cuda), X.shape[0]), "logistic", cfg,
        reg_weight=1.0)
    stream = make_streaming_glm_data(X, y, chunk_rows=1 << 13, device=cuda)
    assert stream.kind == "kernel" and stream.n_chunks == 4
    _kernels.reset_launches()
    ws = [StreamingFixedEffectCoordinate(
        "fixed", stream, "logistic", cfg, reg_weight=1.0,
        prefetch_depth=depth).train(off) for depth in (1, 2)]
    assert _kernels.LAUNCHES["matvec"] > 0 and _kernels.LAUNCHES["rmatvec"] > 0
    assert torch.equal(ws[0], ws[1])
    w_r = res.train(off)
    assert float((ws[0] - w_r).abs().max()) <= 5e-3


def _serve_inputs(seed, b, d_fixed, d_re, hot, dev):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    table = f32(hot + 1, d_re)
    table[0] = 0.0
    slots = torch.as_tensor(rng.integers(0, hot + 1, size=b).astype(np.int32),
                            device=dev)
    cold = f32(b, d_re) * (slots == 0).float()[:, None]
    return f32(b), [(f32(b, d_fixed), f32(d_fixed))], [
        (f32(b, d_re), table, slots, cold)]


@pytest.mark.parametrize("b,d_fixed,d_re", [(1, 512, 8), (64, 512, 8),
                                            (37, 64, 8), (64, 33, 1)])
@pytest.mark.parametrize("link", ["logistic", "exp", "identity"])
def test_serve_margins_matches_plain(cuda, b, d_fixed, d_re, link):
    """The serving kernel against its plain version (the same summation
    order in torch ops): margins bitwise (every add and multiply rounds
    alone on both sides), means within 2 ulp-scale of float32 (CUDA's
    expf against torch.exp); two launches bitwise equal."""
    from photon_ml_tpu_torch.serving import kernels

    offset, fixed, random = _serve_inputs(b + d_fixed, b, d_fixed, d_re, 16,
                                          cuda)
    before = _kernels.LAUNCHES["serve_margins"]
    out = kernels.serve_margins(offset, fixed, random, link)
    again = kernels.serve_margins(offset, fixed, random, link)
    assert _kernels.LAUNCHES["serve_margins"] == before + 2
    plain = kernels.serve_margins_plain(offset, fixed, random, link)
    assert torch.equal(out, again)
    assert torch.equal(out[0], plain[0])
    scale = 1e-6 * plain[1].abs().clamp_min(1.0)
    assert bool(((out[1] - plain[1]).abs() <= scale).all())


def test_serve_margins_batched_equals_single_on_card(cuda):
    """Every row of a full bucket is bitwise the row scored alone, and the
    fused layout (one packed buffer) equals the composed arrays."""
    from photon_ml_tpu_torch.serving import kernels

    offset, fixed, random = _serve_inputs(5, 64, 512, 8, 32, cuda)
    full = kernels.serve_margins(offset, fixed, random, "logistic")
    for i in range(64):
        one = kernels.serve_margins(
            offset[i:i + 1], [(x[i:i + 1], w) for x, w in fixed],
            [(x[i:i + 1], t, s[i:i + 1], c[i:i + 1])
             for x, t, s, c in random], "logistic")
        assert torch.equal(one[:, 0], full[:, i]), i
    (xf, w), = fixed
    (xr, table, slots, cold), = random
    packed = torch.cat([offset[:, None], xf, xr, cold], dim=1).contiguous()
    fused = kernels.build_fused_bucket_kernel("logistic")(
        packed, slots[None, :].contiguous(), (w,), (table,))
    assert torch.equal(fused, full)


def test_serve_margins_refuses_bad_operands_on_the_card(cuda):
    from photon_ml_tpu_torch.serving import kernels

    offset, fixed, random = _serve_inputs(1, 4, 8, 4, 4, cuda)
    (x, t, s, c), = random
    with pytest.raises(ValueError, match="int32"):
        kernels.serve_margins(offset, fixed, [(x, t, s.long(), c)],
                              "logistic")
    with pytest.raises(ValueError, match="one device"):
        kernels.serve_margins(offset, [(fixed[0][0].cpu(), fixed[0][1])],
                              random, "logistic")


def _serve_width_inputs(d, dev):
    """One 64-row bucket at width ``d`` for both coordinates (the fixed
    one's columns past the register cap of 16 a lane, and a random one
    wider than 32, take the kernel's loops), half its rows hot."""
    rng = np.random.default_rng(d)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=dev)

    b = 64
    table = f32(b + 1, d)
    table[0] = 0.0
    slots = torch.as_tensor(np.where(np.arange(b) % 2 == 0,
                                     np.arange(b) + 1, 0).astype(np.int32),
                            device=dev)
    cold = f32(b, d) * (slots == 0).float()[:, None]
    return f32(b), [(f32(b, d), f32(d))], [(f32(b, d), table, slots, cold)]


@pytest.mark.parametrize("d", [1, 31, 33, 512, 1000])
def test_serve_margins_redesign_bitwise_plain_in_both_placements(cuda, d):
    """At every bucket of the ladder the kernel's margins are bitwise the
    plain version's with the request side in HBM and with it read in
    place from page-locked host memory (a prebuilt block), and the two
    placements give the same bits; the means within 1e-6 of
    max(|mean|, 1) of the plain version's."""
    from photon_ml_tpu_torch.serving import kernels

    ops = _serve_width_inputs(d, cuda)
    for b in (1, 2, 4, 8, 16, 32, 64):
        off, fixed, random = ops
        part = (off[:b], [(x[:b], w) for x, w in fixed],
                [(x[:b], t, s[:b], c[:b]) for x, t, s, c in random])
        before = _kernels.LAUNCHES["serve_margins"]
        hbm = kernels.serve_margins(*part, "logistic")
        host = (part[0].cpu().pin_memory(),
                [(x.cpu().pin_memory(), w) for x, w in part[1]],
                [(x.cpu().pin_memory(), t, s.cpu().pin_memory(),
                  c.cpu().pin_memory()) for x, t, s, c in part[2]])
        out = torch.full((2, b), float("nan"), pin_memory=True)
        pinned = kernels.serve_margins_mapped(*host, "logistic", out, cuda)
        assert _kernels.LAUNCHES["serve_margins"] == before + 2
        plain = kernels.serve_margins_plain(*part, "logistic")
        assert torch.equal(hbm[0], plain[0]), b
        assert torch.equal(pinned[0], hbm[0].cpu()), b
        assert torch.equal(pinned[1], hbm[1].cpu()), b
        scale = 1e-6 * plain[1].abs().clamp_min(1.0)
        assert bool(((hbm[1] - plain[1]).abs() <= scale).all()), b


def test_serve_margins_many_coordinates_bitwise_plain(cuda):
    """Two fixed coordinates (the second loaded in its own round trip, one
    past 16 columns a lane) and three random ones (one wider than 32, one
    past the kernel's register slots): margins bitwise the plain
    version's in both placements at every bucket."""
    from photon_ml_tpu_torch.serving import kernels

    rng = np.random.default_rng(7)

    def f32(*shape):
        return torch.as_tensor(rng.normal(size=shape).astype(np.float32),
                               device=cuda)

    b = 64
    fixed = [(f32(b, d), f32(d)) for d in (20, 600)]
    random = []
    for d in (8, 40, 8):
        table = f32(b + 1, d)
        table[0] = 0.0
        slots = torch.as_tensor(
            np.where(np.arange(b) % 3 == 0, np.arange(b) + 1, 0).astype(
                np.int32), device=cuda)
        random.append((f32(b, d), table, slots,
                       f32(b, d) * (slots == 0).float()[:, None]))
    offset = f32(b)
    for n in (1, 7, 64):
        part = (offset[:n], [(x[:n], w) for x, w in fixed],
                [(x[:n], t, s[:n], c[:n]) for x, t, s, c in random])
        hbm = kernels.serve_margins(*part, "exp")
        host = (part[0].cpu().pin_memory(),
                [(x.cpu().pin_memory(), w) for x, w in part[1]],
                [(x.cpu().pin_memory(), t, s.cpu().pin_memory(),
                  c.cpu().pin_memory()) for x, t, s, c in part[2]])
        pinned = kernels.serve_margins_mapped(
            *host, "exp", torch.zeros((2, n), pin_memory=True), cuda)
        plain = kernels.serve_margins_plain(*part, "exp")
        assert torch.equal(hbm[0], plain[0]), n
        assert torch.equal(pinned, hbm.cpu()), n


def test_serve_margins_refuses_pageable_host_memory(cuda):
    """A request-side buffer in pageable host memory has no device
    address: it is refused by name, with no copy to fall back on."""
    from photon_ml_tpu_torch.serving import kernels

    with pytest.raises(ValueError, match="the probe buffer is not "
                       "page-locked"):
        kernels.mapped_pointer(torch.zeros(64), "the probe buffer", cuda)
    off, fixed, random = _serve_width_inputs(8, cuda)
    with pytest.raises(ValueError, match="request-side operand is not "
                       "page-locked"):
        kernels.serve_margins_mapped(
            off.cpu(), [(x.cpu(), w) for x, w in fixed],
            [(x.cpu(), t, s.cpu(), c.cpu()) for x, t, s, c in random],
            "logistic", torch.zeros((2, 64), pin_memory=True), cuda)
    assert kernels.mapped_pointer(torch.zeros(64, pin_memory=True), "a "
                                  "pinned buffer", cuda) != 0


def test_serving_runtime_launches_one_prebuilt_block_a_batch(cuda):
    """A card runtime's staging buffers are page-locked and checked, its
    blocks point into them and at its own hot table, a batch is one launch,
    and the library's Coords layout is the mirror's."""
    from photon_ml_tpu_torch.serving import kernels
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    wl = SyntheticWorkload(n_entities=64, fixed_dim=512, re_dim=8, seed=9)
    rt = ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
        max_batch_size=16, hot_entities=8, device="cuda"))
    for b in rt.buckets:
        st = rt._staging_buffers(b)
        assert all(t.is_pinned() for t in st.tensors)
        assert st.block.rtable[0] == rt.random[0].hot.table.data_ptr()
        assert st.block.n == b
    rows = [rt.parse_request(wl.request(i)) for i in range(5)]
    before = _kernels.LAUNCHES["serve_margins"]
    rt.score_rows(rows)
    assert _kernels.LAUNCHES["serve_margins"] == before + 1


def test_serving_runtime_on_card_bitwise(cuda):
    """The runtime on the card: batched == single at every bucket, hot ==
    cold, fused == composed, and the CPU runtime's margins within 1e-5 of
    Σ|x·w|."""
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    wl = SyntheticWorkload(n_entities=64, fixed_dim=512, re_dim=8, seed=9)
    cfg = dict(max_batch_size=16, hot_entities=8)
    rts = {name: ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
        **cfg, device=dev, fused=fused))
        for name, dev, fused in (("fused", "cuda", True),
                                 ("composed", "cuda", False),
                                 ("cpu", "cpu", True))}
    rows = [rts["fused"].parse_request(wl.request(i)) for i in range(16)]
    single = np.asarray([rts["fused"].score_rows([r])[0][0] for r in rows])
    hot_again = np.asarray([rts["fused"].score_rows([r])[0][0]
                            for r in rows])
    assert single.tobytes() == hot_again.tobytes()
    for n in (1, 2, 5, 8, 16):
        m, _ = rts["fused"].score_rows(rows[:n])
        assert m.tobytes() == single[:n].tobytes(), n
        mc, _ = rts["composed"].score_rows(rows[:n])
        assert mc.tobytes() == m.tobytes(), n
    m_cpu, _ = rts["cpu"].score_rows(rows)
    assert m_cpu.tobytes() == single.tobytes()


def test_worker_pool_on_card_bitwise(cuda):
    """Two spawned workers on the card score bitwise the in-process card
    runtime, and each worker's kernel launches fold into the parent's
    count: its batches plus its warm-up buckets."""
    import time

    from photon_ml_tpu_torch.serving import shm_model
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.procpool import WorkerPool
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    wl = SyntheticWorkload(n_entities=64, fixed_dim=512, re_dim=8, seed=9)
    cfg = RuntimeConfig(max_batch_size=16, hot_entities=8, device="cuda")
    rt = ScoringRuntime(wl.model, wl.index_maps, cfg)
    requests = [wl.request(i) for i in range(64)]
    want = np.asarray([rt.score_rows([rt.parse_request(r)])[0][0]
                       for r in requests], np.float32)
    before = _kernels.LAUNCHES["serve_margins"]
    pool = WorkerPool(wl.model, wl.index_maps, runtime_config=cfg)
    sup = ReplicaSupervisor(pool=pool, n_replicas=2, probe_interval_s=60.0)
    with ScoringService(sup, BatcherConfig(max_batch_size=16,
                                           max_wait_us=500)) as service:
        got = np.asarray([np.float32(f.result(timeout=120)["score"])
                          for f in [service.submit(r) for r in requests]],
                         np.float32)
        stats = [rep.batcher.stats() for rep in sup.replicas]
    assert got.tobytes() == want.tobytes()
    assert shm_model.live_segments() == []
    for st in stats:
        assert st["device"] == "cuda" and st["jax_imported"] is False
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline and sum(
            n.get("serve_margins", 0)
            for n in pool.worker_launches.values()) == 0:
        time.sleep(0.1)
    folded = {rid: n.get("serve_margins", 0)
              for rid, n in pool.worker_launches.items()}
    counts = pool.launch_counts()
    for st in stats:
        rid = st["replica"]
        assert folded[rid] == st["runtime"]["batches"] + len(rt.buckets)
        assert counts[rid]["batches"] == st["runtime"]["batches"]
        assert counts[rid]["processes"] == 1
    assert _kernels.LAUNCHES["serve_margins"] - before == \
        sum(folded.values())
