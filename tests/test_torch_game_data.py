"""The port's GAME data layer against the JAX package's, on the CPU.

Host numpy in both packages, so everything here is held EXACTLY: the entity
shape histogram, the cost-model bucket plan, every block of
``build_random_effect_dataset`` (bucket shapes, lane order, ``col_map``,
``row_index``, padding, passive blocks), ``pack_entity_tables``, the
down-samplers' kept rows and weights, ``coefficient_matrix_for``, and the
random-effect scoring scatter (bitwise for D = 1, where no summation order
enters; within 1e-6 of Σ|x·w| otherwise).
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu.data import sampling as ref_sampling
from photon_ml_tpu.data.stats import entity_shape_histogram as ref_hist
from photon_ml_tpu.game import coordinates as ref_coords
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game.model import RandomEffectModel as RefREModel
from photon_ml_tpu_torch.data import sampling
from photon_ml_tpu_torch.data.stats import entity_shape_histogram
from photon_ml_tpu_torch.game import coordinates, data
from photon_ml_tpu_torch.game.model import RandomEffectModel
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

CPU = "cpu"


def _np(a):
    return a.cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_same_dataset(ds, ref):
    """Every field of the port's dataset equals the reference's, exactly."""
    assert ds.n_global_rows == ref.n_global_rows
    assert ds.n_features == ref.n_features
    assert ds.entity_to_slot == ref.entity_to_slot
    assert [list(i) for i in ds.entity_ids] == [list(i) for i in
                                                ref.entity_ids]
    assert (ds.padded_flops, ds.exact_flops) == (ref.padded_flops,
                                                 ref.exact_flops)
    assert len(ds.blocks) == len(ref.blocks)
    assert len(ds.passive_blocks) == len(ref.passive_blocks)
    pairs = list(zip(ds.blocks, ref.blocks)) + list(
        zip(ds.passive_blocks, ref.passive_blocks))
    for b, rb in pairs:
        if rb is None:
            assert b is None
            continue
        assert (b.n_entities, b.rows_per_entity, b.block_dim) == (
            rb.n_entities, rb.rows_per_entity, rb.block_dim)
        for field in ("X", "labels", "weights", "col_map", "row_index"):
            got, want = _np(getattr(b, field)), _np(getattr(rb, field))
            # The reference's re-pointed rows (allow_missing) come back as
            # int64; the port keeps every row_index int32.
            assert got.dtype == (np.int32 if field == "row_index"
                                 else want.dtype), field
            np.testing.assert_array_equal(got, want, err_msg=field)


def _random_problem(trial):
    rng = np.random.default_rng(100 + trial)
    n = int(rng.integers(30, 400))
    d = int(rng.integers(1, 12))
    n_ent = int(rng.integers(1, 40))
    density = float(rng.uniform(0.05, 0.9))
    X = sp.random(n, d, density, "csr", dtype=np.float32,
                  random_state=int(rng.integers(1 << 30)))
    keys = np.array([f"e{rng.integers(n_ent)}" for _ in range(n)],
                    dtype=object)
    labels = rng.normal(size=n).astype(np.float32)
    weights = rng.uniform(0.5, 2.0, size=n).astype(np.float32)
    cap = (None if trial % 2 == 0
           else int(rng.integers(1, max(2, n // max(1, n_ent)))))
    return keys, X, labels, weights, cap


class TestBuildRandomEffectDataset:
    @pytest.mark.parametrize("trial", range(8))
    def test_matches_reference_exactly(self, trial):
        keys, X, labels, weights, cap = _random_problem(trial)
        ds = data.build_random_effect_dataset(
            keys, X, labels, weights, max_rows_per_entity=cap, device=CPU)
        ref = ref_data.build_random_effect_dataset(
            keys, X, labels, weights, max_rows_per_entity=cap, device=False)
        assert_same_dataset(ds, ref)

    @pytest.mark.parametrize("growth,repack", [(4.0, "geometric"),
                                               (2.0, "cost_model")])
    def test_bucket_policies_match_reference(self, growth, repack):
        rng = np.random.default_rng(5)
        sizes = np.minimum(rng.zipf(1.7, 300), 64)
        n = int(sizes.sum())
        users = np.repeat(np.array([f"u{i}" for i in range(300)],
                                   dtype=object), sizes)
        X = sp.csr_matrix(rng.normal(size=(n, 5)).astype(np.float32)
                          * (rng.uniform(size=(n, 5)) < 0.6))
        y = (rng.uniform(size=n) < 0.5).astype(np.float32)
        w = np.ones(n, np.float32)
        kw = dict(bucket_growth=growth, repack=repack, program_budget=3,
                  max_rows_per_entity=24)
        ds = data.build_random_effect_dataset(users, X, y, w, device=CPU,
                                              **kw)
        ref = ref_data.build_random_effect_dataset(users, X, y, w,
                                                   device=False, **kw)
        assert_same_dataset(ds, ref)
        assert any(b is not None for b in ds.passive_blocks)

    def test_small_example_and_tight_padding(self):
        keys = np.array(["b", "a", "b", "c", "a", "b"] + ["big"] * 100
                        + ["s"] * 3)
        rng = np.random.default_rng(0)
        X = sp.csr_matrix(rng.normal(size=(len(keys), 4)).astype(np.float32)
                          * (rng.uniform(size=(len(keys), 4)) < 0.5))
        y = np.arange(len(keys), dtype=np.float32)
        w = np.ones(len(keys), np.float32)
        ds = data.build_random_effect_dataset(keys, X, y, w, device=CPU)
        ref = ref_data.build_random_effect_dataset(keys, X, y, w,
                                                   device=False)
        assert_same_dataset(ds, ref)
        # Blocks pad to their members' maxima, not to the grid point.
        assert max(b.rows_per_entity for b in ds.blocks) == 100

    def test_all_zero_kept_rows_with_passive_features(self):
        X = np.zeros((5, 3), np.float32)
        X[1:4] = 1.0  # the rows the linspace keeps for cap = 2 are empty
        args = (np.array(["e"] * 5, dtype=object), sp.csr_matrix(X),
                np.zeros(5, np.float32), np.ones(5, np.float32))
        ds = data.build_random_effect_dataset(*args, max_rows_per_entity=2,
                                              device=CPU)
        ref = ref_data.build_random_effect_dataset(
            *args, max_rows_per_entity=2, device=False)
        assert_same_dataset(ds, ref)
        assert bool((ds.blocks[0].col_map == -1).all())
        assert bool((ds.passive_blocks[0].X == 0).all())

    def test_missing_ids_allowed_and_refused(self):
        keys = np.array(["a", None, "b", "a", None], dtype=object)
        X = sp.csr_matrix(np.arange(10, dtype=np.float32).reshape(5, 2))
        y, w = np.zeros(5, np.float32), np.ones(5, np.float32)
        with pytest.raises(ValueError, match="no entity id"):
            data.build_random_effect_dataset(keys, X, y, w, device=CPU)
        ds = data.build_random_effect_dataset(keys, X, y, w, device=CPU,
                                              allow_missing=True)
        ref = ref_data.build_random_effect_dataset(keys, X, y, w,
                                                   device=False,
                                                   allow_missing=True)
        assert_same_dataset(ds, ref)
        empty = data.build_random_effect_dataset(
            np.array([None, None], dtype=object), X[:2], y[:2], w[:2],
            device=CPU, allow_missing=True)
        assert empty.blocks == [] and empty.n_global_rows == 2

    def test_each_row_checked_once(self):
        ri = np.array([[0, 1], [2, 5]], np.int32)
        data.check_rows_once([ri, np.array([[3, 4]], np.int32)], 5)
        with pytest.raises(ValueError, match="appears 2 times"):
            data.check_rows_once([ri, np.array([[1, 5]], np.int32)], 5)

    def test_blocks_land_on_the_requested_device(self):
        keys, X, labels, weights, cap = _random_problem(1)
        ds = data.build_random_effect_dataset(keys, X, labels, weights,
                                              max_rows_per_entity=cap,
                                              device=CPU)
        for b in ds.blocks:
            assert b.X.device.type == "cpu" and b.X.dtype == torch.float32
            assert b.row_index.dtype == torch.int32


class TestBucketPlanning:
    @pytest.mark.parametrize("max_entities", [500_000, 50])
    def test_entity_shape_histogram(self, max_entities):
        rng = np.random.default_rng(3)
        rows = rng.integers(1, 30, size=400)
        cols = rng.integers(0, 6, size=400)
        got = entity_shape_histogram(rows, cols, max_entities=max_entities,
                                     seed=7)
        want = ref_hist(rows, cols, max_entities=max_entities, seed=7)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    @pytest.mark.parametrize("budget,spread", [(1, 20), (4, 20), (16, 20),
                                               (8, 400)])
    def test_plan_matches_reference(self, budget, spread):
        rng = np.random.default_rng(budget + spread)
        rows = rng.integers(1, spread, size=3000)
        cols = rng.integers(0, spread, size=3000)
        got = data.plan_entity_buckets(rows, cols, program_budget=budget)
        want = ref_data.plan_entity_buckets(rows, cols,
                                            program_budget=budget)
        np.testing.assert_array_equal(got.shapes, want.shapes)
        np.testing.assert_array_equal(got.assignment, want.assignment)
        assert (got.padded_flops, got.exact_flops) == (want.padded_flops,
                                                       want.exact_flops)
        assert len(got.shapes) <= budget

    def test_plan_refuses_zero_budget_and_handles_empty(self):
        with pytest.raises(ValueError, match="program_budget"):
            data.plan_entity_buckets([1], [1], program_budget=0)
        empty = data.plan_entity_buckets([], [])
        assert empty.shapes.shape == (0, 2) and empty.padded_flops == 0

    @pytest.mark.parametrize("n,growth", [(1, 2.0), (5, 2.0), (100, 4.0),
                                          (7, 1.5)])
    def test_round_up_geometric(self, n, growth):
        assert data._round_up_geometric(n, growth) == \
            ref_data._round_up_geometric(n, growth)


class TestTablesAndSampling:
    def test_pack_entity_tables(self):
        rng = np.random.default_rng(1)
        cmap = rng.integers(-1, 20, size=(9, 5)).astype(np.int32)
        w = (rng.normal(size=(9, 5)) * (rng.uniform(size=(9, 5)) < 0.7)
             ).astype(np.float32)
        var = rng.uniform(size=(9, 5)).astype(np.float32)
        for v in (None, var):
            got = coordinates.pack_entity_tables(cmap, w, v)
            want = ref_coords.pack_entity_tables(cmap, w, v)
            for g_parts, w_parts in zip(got, want):
                if w_parts is None:
                    assert g_parts is None
                    continue
                assert len(g_parts) == len(w_parts)
                for a, b in zip(g_parts, w_parts):
                    np.testing.assert_array_equal(a, b)

    @pytest.mark.parametrize("binary", [True, False])
    @pytest.mark.parametrize("rate", [0.1, 0.5, 1.0])
    def test_down_samplers_match_reference(self, binary, rate):
        rng = np.random.default_rng(2)
        labels = (rng.uniform(size=500) < 0.2).astype(np.float32)
        weights = rng.uniform(0.5, 2, size=500).astype(np.float32)
        cls, ref_cls = (
            (sampling.BinaryClassificationDownSampler,
             ref_sampling.BinaryClassificationDownSampler) if binary
            else (sampling.DefaultDownSampler, ref_sampling.DefaultDownSampler)
        )
        idx, w = cls(rate, seed=4).downsample(labels, weights)
        ridx, rw = ref_cls(rate, seed=4).downsample(labels, weights)
        np.testing.assert_array_equal(idx, ridx)
        np.testing.assert_array_equal(w, rw)

    def test_down_sampler_refuses_bad_rate(self):
        for cls in (sampling.DefaultDownSampler,
                    sampling.BinaryClassificationDownSampler):
            with pytest.raises(ValueError, match="rate"):
                cls(0.0)

    def test_coefficient_matrix_for(self):
        rng = np.random.default_rng(3)
        table = {}
        for e in range(12):
            cols = np.sort(rng.choice(30, size=rng.integers(0, 6),
                                      replace=False)).astype(np.int32)
            table[f"k{e}"] = (cols, rng.normal(size=len(cols)).astype(
                np.float32))
        kw = dict(feature_shard="s", entity_key="k", task="logistic",
                  n_features=30)
        model, ref = RandomEffectModel(dict(table), **kw), RefREModel(
            dict(table), **kw)
        ids = [f"k{e}" for e in rng.integers(0, 15, size=10)]  # some unseen
        cmap = rng.integers(-1, 30, size=(10, 6)).astype(np.int32)
        got = model.coefficient_matrix_for(cmap, ids)
        np.testing.assert_array_equal(got, ref.coefficient_matrix_for(
            cmap, ids))
        assert model.n_entities == 12


class TestScoringScatter:
    @staticmethod
    def _dataset(d, cap):
        rng = np.random.default_rng(d)
        n = 600
        keys = np.array([f"u{rng.integers(40)}" for _ in range(n)],
                        dtype=object)
        X = sp.csr_matrix(rng.normal(size=(n, d)).astype(np.float32))
        y = np.zeros(n, np.float32)
        w = np.ones(n, np.float32)
        ds = data.build_random_effect_dataset(
            keys, X, y, w, max_rows_per_entity=cap, device=CPU)
        ref = ref_data.build_random_effect_dataset(
            keys, X, y, w, max_rows_per_entity=cap)
        coefs = [rng.normal(size=(b.n_entities, b.block_dim)).astype(
            np.float32) for b in ds.blocks]
        return ds, ref, coefs, n

    @pytest.mark.parametrize("cap", [None, 6])
    def test_bias_scores_match_reference_bitwise(self, cap):
        ds, ref, coefs, n = self._dataset(1, cap)
        got = coordinates.score_blocks(
            n, ds.blocks, ds.passive_blocks,
            [torch.as_tensor(c) for c in coefs], CPU).numpy()
        sig = ref_coords._layout_sig((ref.blocks, ref.passive_blocks))
        want = np.asarray(ref_coords._re_score_all_jit(n, sig)(
            ref.blocks, ref.passive_blocks, [jnp.asarray(c) for c in coefs]))
        assert got.tobytes() == want.tobytes()
        if cap is not None:
            assert any(b is not None for b in ds.passive_blocks)

    @pytest.mark.parametrize("cap", [None, 6])
    def test_wide_scores_match_reference(self, cap):
        ds, ref, coefs, n = self._dataset(5, cap)
        got = coordinates.score_blocks(
            n, ds.blocks, ds.passive_blocks,
            [torch.as_tensor(c) for c in coefs], CPU).numpy()
        sig = ref_coords._layout_sig((ref.blocks, ref.passive_blocks))
        want = np.asarray(ref_coords._re_score_all_jit(n, sig)(
            ref.blocks, ref.passive_blocks, [jnp.asarray(c) for c in coefs]))
        scale = np.zeros(n + 1)  # Σ|x·w| a row
        for blocks in (ds.blocks, ds.passive_blocks):
            for b, c in zip(blocks, coefs):
                if b is None:
                    continue
                s = (np.abs(_np(b.X)) * np.abs(c)[:, None, :]).sum(-1)
                np.add.at(scale, _np(b.row_index).ravel(), s.ravel())
        assert np.all(np.abs(got - want) <= 1e-6 * scale[:n])
        assert np.count_nonzero(got) == n  # every row scored once
