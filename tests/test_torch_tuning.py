"""The port's hyperparameter search and tuning orchestrator
(``hyperparameter/``, ``tuning/``) against the JAX package's, on the CPU.

The reference's ``tests/test_tuning.py`` classes and ``tests/test_aux.py``'s
GP cases, run through the port, and wherever both packages take the same
decisions, through both: search spaces and their fingerprints, proposals
for the same seed, GP posteriors, ASHA decisions and whole journals (every
state-bearing record, RNG states included) are equal to the reference's.
The GLM sweep's trials are bitwise equal between 4 workers and 1 through
the port's ``make_fit_once``; a killed and resumed search replays the
uninterrupted one exactly; kernel launch counts stay exact when 8 threads
launch at once.
"""

import json
import os
import threading
import types

import numpy as np
import pytest
import torch

from photon_ml_tpu.hyperparameter import search as r_search
from photon_ml_tpu.tuning import executor as r_executor
from photon_ml_tpu.tuning import scheduler as r_scheduler
from photon_ml_tpu.tuning import state as r_state
from photon_ml_tpu.utils import watchdog as r_watchdog
from photon_ml_tpu_torch.hyperparameter import search
from photon_ml_tpu_torch.hyperparameter.search import (
    GaussianProcessModel,
    GaussianProcessSearch,
    RandomSearch,
    _chol_with_jitter,
    expected_improvement,
)
from photon_ml_tpu_torch.tuning import executor, scheduler, state
from photon_ml_tpu_torch.tuning.executor import (
    TrialReport,
    TuningConfig,
    TuningOrchestrator,
)
from photon_ml_tpu_torch.tuning.scheduler import (
    AshaConfig,
    AshaScheduler,
    GPProposer,
    GridProposer,
    RandomProposer,
    SearchSpace,
    make_proposer,
)
from photon_ml_tpu_torch.tuning.state import (
    STATE_RECORD_TYPES,
    ResumeMismatch,
    SearchAborted,
    TrialStore,
    TuningJournal,
    replay_journal,
)
from photon_ml_tpu_torch.utils import watchdog
from photon_ml_tpu_torch.utils.watchdog import RetryPolicy
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

PORT = types.SimpleNamespace(search=search, sched=scheduler, state=state,
                             ex=executor, wd=watchdog)
REF = types.SimpleNamespace(search=r_search, sched=r_scheduler,
                            state=r_state, ex=r_executor, wd=r_watchdog)


def _cfg(pkg=PORT, **kw):
    kw.setdefault("max_trials", 8)
    kw.setdefault("workers", 2)
    kw.setdefault("retry", pkg.wd.RetryPolicy())
    kw.setdefault("sleep", lambda s: None)
    return pkg.ex.TuningConfig(**kw)


def _decisions(journal):
    """State-bearing journal records minus run-local noise."""
    return [{k: v for k, v in rec.items() if k not in ("wall", "wall_epoch")}
            for rec in journal.read()
            if rec.get("type") in STATE_RECORD_TYPES]


def _gp_search(pkg, directory, fn, seed=5, abort=None, resume=False,
               **cfg):
    """The resume tests' search: a GP with ASHA over a log-scaled λ."""
    sp = pkg.sched.SearchSpace.create([(1e-2, 1e2)], log_scale=True)
    journal = pkg.state.TuningJournal(directory, abort_after=abort)
    cfg.setdefault("max_trials", 6)
    cfg.setdefault("workers", 3)
    cfg.setdefault("asha", pkg.sched.AshaConfig(1, 2, 2))
    orch = pkg.ex.TuningOrchestrator(
        sp, fn, pkg.sched.GPProposer(sp, seed=seed), _cfg(pkg, **cfg),
        journal)
    try:
        return orch.run(resume=resume), journal
    finally:
        journal.close()


def _objective(p, r, w):
    return float(np.log10(p[0]) ** 2 + 0.01 * r)


class TestSearchSpace:
    def test_validation(self):
        with pytest.raises(ValueError):
            SearchSpace.create([(1.0, 1.0)])
        with pytest.raises(ValueError):
            SearchSpace.create([(0.0, 1.0)], log_scale=True)
        with pytest.raises(ValueError):
            SearchSpace.create([(0.0, 1.0)], names=["a", "b"])

    def test_fingerprint_and_config_match_the_reference(self):
        a = SearchSpace.create([(1e-3, 1e3)], log_scale=True, names=["lam"])
        c = SearchSpace.create([(1e-3, 1e2)], log_scale=True, names=["lam"])
        d = SearchSpace.create([(1e-3, 1e3)], log_scale=False, names=["lam"])
        assert a.fingerprint() != c.fingerprint() != d.fingerprint()
        assert SearchSpace.from_config(a.to_config()) == a
        ref = r_scheduler.SearchSpace.create([(1e-3, 1e3)], log_scale=True,
                                             names=["lam"])
        assert a.fingerprint() == ref.fingerprint()
        assert a.to_config() == ref.to_config()

    def test_sample_and_normalize_match_the_reference(self):
        sp = SearchSpace.create([(1e-2, 1e2), (-1.0, 3.0)],
                                log_scale=[True, False])
        rsp = r_scheduler.SearchSpace.create([(1e-2, 1e2), (-1.0, 3.0)],
                                             log_scale=[True, False])
        X = sp.sample(np.random.default_rng(0), 200)
        np.testing.assert_array_equal(
            X, rsp.sample(np.random.default_rng(0), 200))
        assert np.all(X[:, 0] >= 1e-2) and np.all(X[:, 0] <= 1e2)
        Z = sp.normalize(X)
        np.testing.assert_array_equal(Z, rsp.normalize(X))
        assert np.all(Z >= 0.0) and np.all(Z <= 1.0)
        assert sp.normalize(np.array([[1.0, 1.0]]))[0, 0] == \
            pytest.approx(0.5)


class TestProposers:
    def test_random_deterministic_and_rng_roundtrip(self):
        sp = SearchSpace.create([(0.0, 1.0)] * 2)
        a, b = RandomProposer(sp, seed=3), RandomProposer(sp, seed=3)
        np.testing.assert_array_equal(a.ask(), b.ask())
        st = a.rng_state
        x1 = a.ask()
        a.set_rng_state(st)
        np.testing.assert_array_equal(a.ask(), x1)

    def test_pending_bookkeeping(self):
        p = RandomProposer(SearchSpace.create([(0.0, 1.0)]), seed=0)
        x1, x2 = p.ask(), p.ask()
        assert len(p.pending) == 2
        p.tell(x1, 0.5)
        assert len(p.pending) == 1 and len(p.observations) == 1
        p.resolve(x2)
        assert not p.pending and len(p.observations) == 1

    def test_grid_order_exhaustion_restore(self):
        sp = SearchSpace.create([(0.0, 10.0)])
        g = GridProposer(sp, [[1.0], [2.0], [3.0]])
        assert [g.ask()[0] for _ in range(3)] == [1.0, 2.0, 3.0]
        assert g.exhausted()
        g2 = GridProposer(sp, [[1.0], [2.0], [3.0]])
        g2.restore_ask(np.array([1.0]))
        assert g2.ask()[0] == 2.0

    @pytest.mark.parametrize("kind", ["random", "gp"])
    def test_proposals_equal_the_reference(self, kind):
        """The same seed, asks and tells give the reference's points bit
        for bit, the GP's constant-liar batches included."""
        def run(pkg):
            sp = pkg.sched.SearchSpace.create([(1e-3, 1e3), (0.0, 1.0)],
                                              log_scale=[True, False])
            p = pkg.sched.make_proposer(kind, sp, seed=11)
            out = []
            for wave in range(4):
                batch = [p.ask() for _ in range(3)]
                out.extend(batch)
                for x in batch:
                    p.tell(x, float(np.log10(x[0]) ** 2 + (x[1] - 0.3) ** 2))
            return np.array(out), p.rng_state

        got, got_state = run(PORT)
        want, want_state = run(REF)
        np.testing.assert_array_equal(got, want)
        assert got_state == want_state

    def test_gp_constant_liar_batch_is_diverse(self):
        p = GPProposer(SearchSpace.create([(0.0, 1.0)]), seed=2,
                       n_seed_points=2, n_candidates=128)
        p.tell(np.array([0.2]), 0.04)
        p.tell(np.array([0.8]), 0.16)
        flat = [float(p.ask()[0]) for _ in range(4)]
        assert len(p.pending) == 4
        assert len({round(v, 6) for v in flat}) == 4, flat
        assert all(0.0 <= v <= 1.0 for v in flat)

    def test_make_proposer_rejects_unknown(self):
        with pytest.raises(ValueError):
            make_proposer("annealing", SearchSpace.create([(0.0, 1.0)]))


class TestGPRobustness:
    def test_duplicate_observations_do_not_crash_fit(self):
        X = np.array([[0.3], [0.3], [0.7], [0.7], [0.7]])
        y = np.array([1.0, 3.0, 2.0, 2.0, 2.0])
        mean, std = GaussianProcessModel().fit(X, y).predict(
            np.array([[0.3], [0.7]]))
        assert mean == pytest.approx([2.0, 2.0], abs=0.1)
        assert np.all(np.isfinite(std))

    def test_near_duplicates_merge(self):
        X = np.array([[0.5], [0.5 + 1e-12], [0.9]])
        gp = GaussianProcessModel().fit(X, np.array([1.0, 2.0, 0.0]))
        assert gp._X.shape[0] == 2

    def test_jitter_ladder(self):
        assert np.all(np.isfinite(_chol_with_jitter(np.ones((6, 6)))))
        with pytest.raises(np.linalg.LinAlgError, match="jitter"):
            _chol_with_jitter(-np.eye(3))

    def test_posterior_equals_the_reference(self):
        rng = np.random.default_rng(3)
        X, y = rng.uniform(size=(12, 2)), rng.normal(size=12)
        Xq = rng.uniform(size=(50, 2))
        got = GaussianProcessModel().fit(X, y).predict(Xq)
        want = r_search.GaussianProcessModel().fit(X, y).predict(Xq)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)

    def test_search_survives_duplicate_priors(self):
        def f(x):
            return float((x[0] - 2.0) ** 2)

        prior = (np.array([1.0]), f(np.array([1.0])))
        res = GaussianProcessSearch([(0.0, 5.0)], seed=1).find(
            f, 8, priors=[prior, prior, prior])
        assert np.isfinite(res.best_value)


class TestHyperparameterSearch:
    """``tests/test_aux.py``'s GP and random-search cases, and the same
    histories as the reference's searches."""

    def test_random_search_finds_decent_point(self):
        def f(x):
            return float((x[0] - 3.0) ** 2 + (x[1] + 1.0) ** 2)

        res = RandomSearch([(0, 5), (-3, 3)], seed=4).find(f, 60)
        ref = r_search.RandomSearch([(0, 5), (-3, 3)], seed=4).find(f, 60)
        assert res.best_value < 0.5 and len(res.history) == 60
        np.testing.assert_array_equal(res.best_params, ref.best_params)

    def test_gp_posterior_interpolates(self):
        X = np.array([[0.0], [0.5], [1.0]])
        y = np.array([1.0, 0.0, 1.0])
        gp = GaussianProcessModel().fit(X, y)
        mean, std = gp.predict(X)
        np.testing.assert_allclose(mean, y, atol=1e-2)
        assert np.all(std < 0.1)
        assert gp.predict(np.array([[0.25]]))[1][0] > std[0]

    def test_ei_prefers_low_mean_and_high_std(self):
        ei = expected_improvement(np.array([0.0, 1.0]), np.array([0.1, 0.1]),
                                  best=0.5)
        assert ei[0] > ei[1]
        ei2 = expected_improvement(np.array([1.0, 1.0]),
                                   np.array([1.0, 0.01]), best=0.5)
        assert ei2[0] > ei2[1]
        np.testing.assert_array_equal(ei2, r_search.expected_improvement(
            np.array([1.0, 1.0]), np.array([1.0, 0.01]), best=0.5))

    def test_gp_search_equals_the_reference(self):
        def f(x):
            return float(np.sin(3 * x[0]) + 0.3 * (x[0] - 4.0) ** 2)

        gp = GaussianProcessSearch([(0.0, 8.0)], seed=5).find(f, 18)
        ref = r_search.GaussianProcessSearch([(0.0, 8.0)], seed=5).find(
            f, 18)
        assert gp.best_value < 0.1 and len(gp.history) == 18
        for (xa, ya), (xb, yb) in zip(gp.history, ref.history):
            np.testing.assert_array_equal(xa, xb)
            assert ya == yb

    def test_gp_search_log_scale_and_priors(self):
        def f(x):
            return float((np.log10(x[0]) + 2.0) ** 2)

        priors = [(np.array([1.0]), f(np.array([1.0])))]
        res = GaussianProcessSearch([(1e-4, 1e2)], log_scale=True,
                                    seed=6).find(f, 15, priors=priors)
        assert res.best_value < 0.1 and len(res.history) == 16

    def test_maximize_mode(self):
        def f(x):
            return float(-((x[0] - 2.0) ** 2))

        res = GaussianProcessSearch([(0.0, 5.0)], seed=7).find(
            f, 15, maximize=True)
        assert abs(res.best_params[0] - 2.0) < 0.3


class TestAsha:
    def test_resource_geometry(self):
        cfg = AshaConfig(min_resource=2, reduction_factor=3, num_rungs=3)
        assert [cfg.resource(r) for r in range(3)] == [2, 6, 18]
        assert cfg.top_rung == 2

    def test_promote_kill_sequence(self):
        s = AshaScheduler(AshaConfig(1, 2, 3))
        assert s.report(0, 0, 0.5) == "promote"
        assert s.report(1, 0, 0.9) == "stop"
        assert s.report(2, 0, 0.1) == "promote"
        assert s.decide(0, 0) == "stop"
        assert s.report(2, 2, 0.1) == "complete"

    def test_ties_break_by_trial_id(self):
        s = AshaScheduler(AshaConfig(1, 2, 2))
        s.record(0, 0, 0.5)
        s.record(1, 0, 0.5)
        assert (s.decide(0, 0), s.decide(1, 0)) == ("promote", "stop")

    def test_decisions_equal_the_reference(self):
        a = AshaScheduler(AshaConfig(1, 3, 3))
        b = r_scheduler.AshaScheduler(r_scheduler.AshaConfig(1, 3, 3))
        rng = np.random.default_rng(0)
        for i in range(30):
            rung, y = int(rng.integers(0, 3)), float(rng.uniform())
            assert a.report(i, rung, y) == b.report(i, rung, y)

    def test_config_validation(self):
        with pytest.raises(ValueError):
            AshaConfig(min_resource=0)
        with pytest.raises(ValueError):
            AshaConfig(reduction_factor=1)


class TestExecutor:
    def test_simple_search_finds_minimum(self, tmp_path):
        sp = SearchSpace.create([(0.0, 1.0)])
        journal = TuningJournal(str(tmp_path))
        res = TuningOrchestrator(
            sp, lambda p, r, w: float((p[0] - 0.37) ** 2),
            RandomProposer(sp, seed=4), _cfg(max_trials=12, workers=3),
            journal).run()
        journal.close()
        assert res.completed == 12 and res.failed == 0
        assert abs(res.best_params[0] - 0.37) < 0.2
        assert {t["status"] for t in res.trials} == {"completed"}

    def test_warm_start_chains_from_nearest_completed(self, tmp_path):
        sp = SearchSpace.create([(0.0, 10.0)])
        seen = {}
        lock = threading.Lock()

        def fn(p, r, w):
            with lock:
                seen[float(p[0])] = (None if w is None
                                     else float(np.asarray(w)[0]))
            return TrialReport(metric=float(p[0]),
                               coefficients=np.array([p[0]], np.float32))

        journal = TuningJournal(str(tmp_path))
        TuningOrchestrator(sp, fn, GridProposer(sp, [[1.0], [2.0], [9.0]]),
                           _cfg(max_trials=3, workers=1), journal).run()
        journal.close()
        assert seen == {1.0: None, 2.0: 1.0, 9.0: 2.0}

    def test_warm_start_disabled(self, tmp_path):
        sp = SearchSpace.create([(0.0, 10.0)])
        warm = []

        def fn(p, r, w):
            warm.append(w)
            return TrialReport(0.0, coefficients=np.zeros(1))

        journal = TuningJournal(str(tmp_path))
        TuningOrchestrator(sp, fn, GridProposer(sp, [[1.0], [2.0]]),
                           _cfg(max_trials=2, workers=1, warm_start=False),
                           journal).run()
        journal.close()
        assert warm == [None, None]

    @pytest.mark.parametrize("message", [
        "bad hyperparameters",
        "CUDA error: an illegal memory access was encountered",
        "CUDA out of memory. Tried to allocate 2.00 GiB",
    ])
    def test_fatal_failure_marks_trial_and_continues(self, tmp_path,
                                                     message):
        """A fatal verdict (a CUDA error among them, as the watchdog
        classifies it) fails the trial once, unretried, and the search
        goes on."""
        sp = SearchSpace.create([(0.0, 1.0)])
        calls = []

        def fn(p, r, w):
            calls.append(float(p[0]))
            if 0.55 < p[0] < 0.65:
                raise RuntimeError(message)
            return float(p[0])

        journal = TuningJournal(str(tmp_path))
        res = TuningOrchestrator(
            sp, fn, GridProposer(sp, [[0.1], [0.6], [0.9]]),
            _cfg(max_trials=3, retry=RetryPolicy(max_retries=3)),
            journal).run()
        journal.close()
        assert res.failed == 1 and res.completed == 2
        assert calls.count(0.6) == 1
        failed = [t for t in res.trials if t["status"] == "failed"]
        assert message[:20] in failed[0]["error"]
        assert res.best_metric == 0.1
        fail = [r for r in journal.read() if r["type"] == "fail"][0]
        assert fail["transient"] is False

    def test_transient_failure_retries_in_place(self, tmp_path):
        sp = SearchSpace.create([(0.0, 1.0)])
        attempts, sleeps = [], []

        def fn(p, r, w):
            attempts.append(float(p[0]))
            if len(attempts) == 1:
                raise RuntimeError("UNAVAILABLE: Socket closed")
            return 0.0

        journal = TuningJournal(str(tmp_path))
        res = TuningOrchestrator(
            sp, fn, GridProposer(sp, [[0.5]]),
            _cfg(max_trials=1, workers=1,
                 retry=RetryPolicy(max_retries=2, backoff_seconds=7.0),
                 sleep=sleeps.append), journal).run()
        journal.close()
        assert len(attempts) == 2 and res.completed == 1
        assert sleeps == [7.0] and res.trials[0]["retries"] == 1
        kinds = [r["type"] for r in journal.read()]
        assert "retry" in kinds and "fail" not in kinds

    def test_transient_budget_exhausted_fails(self, tmp_path):
        sp = SearchSpace.create([(0.0, 1.0)])

        def fn(p, r, w):
            raise RuntimeError("UNAVAILABLE: device lost")

        journal = TuningJournal(str(tmp_path))
        res = TuningOrchestrator(
            sp, fn, GridProposer(sp, [[0.5]]),
            _cfg(max_trials=1, retry=RetryPolicy(max_retries=1)),
            journal).run()
        journal.close()
        fail = [r for r in journal.read() if r["type"] == "fail"][0]
        assert res.failed == 1
        assert fail["transient"] is True and fail["retries"] == 1

    def test_asha_prunes_and_promotes(self, tmp_path):
        sp = SearchSpace.create([(0.0, 1.0)])
        resources = {}
        lock = threading.Lock()

        def fn(p, r, w):
            with lock:
                resources.setdefault(float(p[0]), []).append(r)
            return float((p[0] - 0.3) ** 2)

        journal = TuningJournal(str(tmp_path))
        res = TuningOrchestrator(
            sp, fn, GridProposer(sp, [[0.3], [0.9], [0.35], [0.8]]),
            _cfg(max_trials=4, workers=2,
                 asha=AshaConfig(min_resource=5, reduction_factor=2,
                                 num_rungs=2)), journal).run()
        journal.close()
        assert res.pruned >= 1 and res.completed >= 1
        assert res.best_params == [0.3]
        assert resources[0.3] == [5, 10]
        assert all(rs[0] == 5 for rs in resources.values())

    def test_trial_spans_and_counters(self, tmp_path):
        from photon_ml_tpu_torch import telemetry

        sp = SearchSpace.create([(0.0, 1.0)])

        def fn(p, r, w):
            if p[0] > 0.85:
                raise ValueError("fatal")
            return float((p[0] - 0.3) ** 2)

        with telemetry.Telemetry(output_dir=str(tmp_path)) as tel:
            journal = TuningJournal(str(tmp_path / "j"))
            TuningOrchestrator(
                sp, fn, GridProposer(sp, [[0.3], [0.9], [0.35], [0.8]]),
                _cfg(max_trials=4, asha=AshaConfig(1, 2, 2)), journal).run()
            journal.close()
            snap = tel.snapshot()
        counters = snap["counters"]
        assert counters["tuning_trials_started"] == 4
        assert counters["tuning_trials_failed"] == 1
        assert counters["tuning_trials_pruned"] >= 1
        with open(tmp_path / "events.jsonl") as f:
            spans = [json.loads(ln) for ln in f]
        assert sum(1 for s in spans if s.get("type") == "span"
                   and s.get("name") == "tuning.trial") >= 4


class TestJournal:
    def test_fsync_append_read_and_torn_tail(self, tmp_path):
        j = TuningJournal(str(tmp_path))
        j.append({"type": "header", "x": 1})
        j.append({"type": "ask", "trial": 0, "params": [1.0]})
        j.close()
        with open(j.path, "a") as f:
            f.write('{"type": "report", "trial": 0, "met')
        assert [r["type"] for r in j.read()] == ["header", "ask"]

    def test_mid_file_corruption_raises(self, tmp_path):
        j = TuningJournal(str(tmp_path))
        j.append({"type": "header"})
        j.close()
        with open(j.path, "a") as f:
            f.write("garbage\n")
            f.write('{"type": "ask", "trial": 0}\n')
        with pytest.raises(ValueError, match="corrupt journal"):
            j.read()

    def test_abort_hook_fires_at_boundary(self, tmp_path):
        j = TuningJournal(str(tmp_path), abort_after=2)
        j.append({"type": "header"})
        j.append({"type": "ask"})
        with pytest.raises(SearchAborted):
            j.append({"type": "ask"})
        j.close()
        assert len(j.read()) == 2

    def test_replay_requires_header(self):
        with pytest.raises(ValueError, match="header"):
            replay_journal([{"type": "ask", "trial": 0}])

    def test_trial_store_roundtrip_and_clear(self, tmp_path):
        store = TrialStore(str(tmp_path))
        store.save(3, np.array([0.5]), np.arange(4, dtype=np.float32))
        params, coefs = store.load(3)
        assert params[0] == 0.5
        np.testing.assert_array_equal(coefs, np.arange(4, dtype=np.float32))
        assert store.load(7) is None
        store.clear()
        assert store.load(3) is None

    def test_journal_equals_the_reference(self, tmp_path):
        """The same search journals the reference's records, header
        included (wall clocks aside), and folds back to the same replay
        state."""
        got, gj = _gp_search(PORT, str(tmp_path / "port"), _objective)
        want, wj = _gp_search(REF, str(tmp_path / "ref"), _objective)
        assert _decisions(gj) == _decisions(wj)
        assert got.trials == want.trials
        assert (got.best_trial, got.best_metric) == (want.best_trial,
                                                     want.best_metric)
        a, b = replay_journal(gj.read()), r_state.replay_journal(wj.read())
        assert a.rng_state == b.rng_state and a.n_records == b.n_records
        assert a.decided_reports == b.decided_reports


class TestResume:
    def test_kill_resume_bit_parity(self, tmp_path):
        ref, ref_journal = _gp_search(PORT, str(tmp_path / "ref"), _objective)
        n = len(ref_journal.read())
        assert n > 10
        for abort_at in range(2, n, 7):
            d = str(tmp_path / f"killed_{abort_at}")
            with pytest.raises(SearchAborted):
                _gp_search(PORT, d, _objective, abort=abort_at)
            resumed, journal = _gp_search(PORT, d, _objective, resume=True)
            assert resumed.trials == ref.trials, f"abort@{abort_at}"
            assert _decisions(journal) == _decisions(ref_journal)
            assert resumed.best_metric == ref.best_metric

    def test_kill_resume_bit_parity_with_warm_starts(self, tmp_path):
        """Trials that warm-start from coefficients: a kill after a rung's
        coefficients are saved but before its report is journaled must not
        leak that rung's result into its re-run.  (The reference's resume
        reads the trial's latest sidecar and parts from the uninterrupted
        history here; the port reads the last journaled rung's.)"""
        def fn(p, r, w):
            c = (0.0 if w is None else float(np.asarray(w)[0])) + r
            return TrialReport(float(np.log10(p[0]) ** 2 + 1e-3 * c),
                               coefficients=np.array([c]))

        ref, ref_journal = _gp_search(PORT, str(tmp_path / "ref"), fn)
        n = len(ref_journal.read())
        for abort_at in range(2, n):
            d = str(tmp_path / f"killed_{abort_at}")
            with pytest.raises(SearchAborted):
                _gp_search(PORT, d, fn, abort=abort_at)
            resumed, journal = _gp_search(PORT, d, fn, resume=True)
            assert resumed.trials == ref.trials, f"abort@{abort_at}"
            assert _decisions(journal) == _decisions(ref_journal)

    def test_resumed_failed_trial_keeps_its_error(self, tmp_path):
        """A trial that failed before the kill reads the same in the
        resumed history (the reference's replay drops its error)."""
        def fn(p, r, w):
            if p[0] < 0.05:
                raise ValueError("bad hyperparameters")
            return float(np.log10(p[0]) ** 2)

        ref, journal = _gp_search(PORT, str(tmp_path / "ref"), fn)
        assert ref.failed >= 1
        n = len(journal.read())
        d = str(tmp_path / "killed")
        with pytest.raises(SearchAborted):
            _gp_search(PORT, d, fn, abort=n - 2)
        resumed, _ = _gp_search(PORT, d, fn, resume=True)
        assert resumed.trials == ref.trials

    def test_resume_refuses_changed_space_and_config(self, tmp_path):
        d = str(tmp_path)
        with pytest.raises(SearchAborted):
            _gp_search(PORT, d, _objective, abort=4)
        sp = SearchSpace.create([(1e-3, 1e2)], log_scale=True)  # changed
        journal = TuningJournal(d)
        with pytest.raises(ResumeMismatch, match="search space"):
            TuningOrchestrator(
                sp, _objective, GPProposer(sp, seed=5),
                _cfg(max_trials=6, workers=3, asha=AshaConfig(1, 2, 2)),
                journal).run(resume=True)
        journal.close()
        with pytest.raises(ResumeMismatch, match="workers"):
            _gp_search(PORT, d, _objective, resume=True, workers=4)

    def test_resume_without_journal_fails(self, tmp_path):
        sp = SearchSpace.create([(0.0, 1.0)])
        journal = TuningJournal(str(tmp_path))
        with pytest.raises(ResumeMismatch, match="no journal"):
            TuningOrchestrator(sp, lambda p, r, w: 0.0, RandomProposer(sp),
                               _cfg(max_trials=2), journal).run(resume=True)
        journal.close()

    def test_resume_after_torn_tail(self, tmp_path):
        d = str(tmp_path / "killed")
        with pytest.raises(SearchAborted):
            _gp_search(PORT, d, _objective, abort=6)
        with open(os.path.join(d, TuningJournal.FILENAME), "a") as f:
            f.write('{"type": "report", "tri')
        resumed, _ = _gp_search(PORT, d, _objective, resume=True)
        ref, _ = _gp_search(PORT, str(tmp_path / "ref"), _objective)
        assert resumed.trials == ref.trials

    def test_reference_journal_resumes_in_the_port(self, tmp_path):
        """A search the reference journaled and was killed in continues
        in the port to the reference's uninterrupted history."""
        want, _ = _gp_search(REF, str(tmp_path / "ref"), _objective)
        d = str(tmp_path / "killed")
        with pytest.raises(r_state.SearchAborted):
            _gp_search(REF, d, _objective, abort=9)
        resumed, _ = _gp_search(PORT, d, _objective, resume=True)
        assert resumed.trials == want.trials


def _glm_xy(rng, n=600, d=16):
    X = rng.normal(size=(n, d)).astype(np.float32)
    w = rng.normal(size=d).astype(np.float32)
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-(X @ w)))).astype(np.float32)
    return X, y


class TestGlmSweepParity:
    """A 6-λ grid sweep through the port's ``make_fit_once``: with warm
    starts off every trial's coefficients are bitwise equal between 4
    workers and 1 (threads share nothing a fit reads); with them on, the
    reference's bar — the same best λ, the metric within 1e-6 — holds
    against 1 worker and against the reference's own sweep."""

    @staticmethod
    def _sweep(pkg, fit_once, tmp_path, workers, sub, warm_start):
        sp = pkg.sched.SearchSpace.create([(1e-4, 1e2)], log_scale=True)
        lambdas = [[lam] for lam in np.geomspace(1e-3, 10.0, 6)]
        journal = pkg.state.TuningJournal(str(tmp_path / sub))
        res = pkg.ex.TuningOrchestrator(
            sp, fit_once, pkg.sched.GridProposer(sp, lambdas),
            _cfg(pkg, max_trials=6, workers=workers, warm_start=warm_start,
                 maximize=fit_once.larger_is_better), journal).run()
        journal.close()
        return res

    def test_parity(self, tmp_path, rng):
        from photon_ml_tpu.drivers.glm_driver import (
            make_fit_once as r_make_fit_once,
        )
        from photon_ml_tpu_torch.drivers.glm_driver import make_fit_once

        X, y = _glm_xy(rng)
        kw = dict(task="logistic", reg_type="l2", max_iters=50,
                  tolerance=1e-9)
        fit_once = make_fit_once(X[:400], y[:400], X[400:], y[400:],
                                 device="cpu", **kw)
        cold1 = self._sweep(PORT, fit_once, tmp_path, 1, "c1", False)
        cold4 = self._sweep(PORT, fit_once, tmp_path, 4, "c4", False)
        store1 = TrialStore(str(tmp_path / "c1"))
        store4 = TrialStore(str(tmp_path / "c4"))
        for t in range(6):
            np.testing.assert_array_equal(store1.load(t)[1],
                                          store4.load(t)[1])
        assert cold1.trials == cold4.trials

        seq = self._sweep(PORT, fit_once, tmp_path, 1, "seq", True)
        par = self._sweep(PORT, fit_once, tmp_path, 4, "par", True)
        assert seq.best_params == par.best_params
        assert abs(seq.best_metric - par.best_metric) <= 1e-6
        ref = self._sweep(REF, r_make_fit_once(X[:400], y[:400], X[400:],
                                               y[400:], **kw),
                          tmp_path, 1, "ref", True)
        assert seq.best_params == ref.best_params
        assert abs(seq.best_metric - ref.best_metric) <= 1e-6


class TestFitOnceEntries:
    def test_glm_fit_once(self, rng):
        from photon_ml_tpu_torch.drivers.glm_driver import make_fit_once

        X, y = _glm_xy(rng, n=300, d=8)
        fit_once = make_fit_once(X[:200], y[:200], X[200:], y[200:],
                                 task="logistic", reg_type="l2",
                                 device="cpu")
        assert fit_once.larger_is_better  # AUC
        metric, metrics, coefs = fit_once(np.array([0.1]), 0, None)
        assert 0.0 <= metric <= 1.0 and fit_once.suite.primary in metrics
        assert coefs.shape == (8,) and coefs.dtype == np.float32
        _, _, weak = fit_once(np.array([0.1]), 1, None)
        assert not np.allclose(weak, coefs)
        again, _, _ = fit_once(np.array([0.1]), 0, coefs)
        assert again == pytest.approx(metric, abs=1e-6)

    def test_glm_fit_once_host_kind_solver(self, rng):
        from photon_ml_tpu_torch.drivers.glm_driver import make_fit_once

        X, y = _glm_xy(rng, n=300, d=8)
        fit_once = make_fit_once(X[:200], y[:200], X[200:], y[200:],
                                 task="logistic", reg_type="l2",
                                 solver="admm", device="cpu")
        metric, _, coefs = fit_once(np.array([0.5]), 0, None)
        plain = make_fit_once(X[:200], y[:200], X[200:], y[200:],
                              task="logistic", reg_type="l2", device="cpu")
        m2, _, c2 = plain(np.array([0.5]), 0, None)
        np.testing.assert_allclose(coefs, c2, atol=5e-3)

    def test_game_fit_once(self):
        from photon_ml_tpu_torch.tuning.__main__ import (
            synthetic_game_fit_once,
        )

        fit_once = synthetic_game_fit_once(seed=1, device="cpu")
        m1, metrics, coefs = fit_once(np.array([1.0, 1.0]), 1, None)
        assert 0.0 <= m1 <= 1.0 and coefs is None
        assert fit_once.suite.primary in metrics
        m2, _, _ = fit_once(np.array([100.0, 100.0]), 1, None)
        assert m1 != m2
        assert fit_once(np.array([1.0, 1.0]), 1, None)[0] == m1


class TestSelfcheck:
    def test_selfcheck_passes(self, tmp_path):
        from photon_ml_tpu_torch.tuning.__main__ import run_selfcheck

        assert run_selfcheck(str(tmp_path), device="cpu") == []
        assert os.path.exists(tmp_path / "search_a" / TuningJournal.FILENAME)
        with open(tmp_path / "metrics.json") as f:
            snap = json.load(f)
        assert snap["counters"]["tuning_trials_pruned"] >= 1
        assert snap["counters"]["tuning_trials_failed"] == 1

    def test_cli_glm_search_and_resume(self, tmp_path, rng, capsys):
        import scipy.sparse as sp

        from photon_ml_tpu_torch.data.libsvm import write_libsvm
        from photon_ml_tpu_torch.tuning.__main__ import main

        X, y = _glm_xy(rng, n=300, d=6)
        write_libsvm(str(tmp_path / "t.libsvm"), sp.csr_matrix(X[:200]),
                     np.where(y[:200] > 0, 1.0, -1.0))
        write_libsvm(str(tmp_path / "v.libsvm"), sp.csr_matrix(X[200:]),
                     np.where(y[200:] > 0, 1.0, -1.0))
        argv = ["--driver", "glm", "--train-data", str(tmp_path / "t.libsvm"),
                "--validate-data", str(tmp_path / "v.libsvm"),
                "--trials", "4", "--workers", "2", "--asha",
                "--min-resource", "2", "--num-rungs", "2",
                "--max-iters", "20", "--no-fsync", "--device", "cpu"]
        assert main(argv + ["--output-dir", str(tmp_path / "a")]) == 0
        with open(tmp_path / "a" / "tuning_result.json") as f:
            out = json.load(f)
        assert out["n_trials"] == 4
        assert out["primary_metric"] == "AreaUnderROCCurveEvaluator"
        assert 0.5 < out["best_metric"] <= 1.0
        # A resume of the finished search replays it and proposes nothing.
        assert main(argv + ["--output-dir", str(tmp_path / "a"),
                            "--resume"]) == 0
        with open(tmp_path / "a" / "tuning_result.json") as f:
            again = json.load(f)
        assert again["trials"] == out["trials"]
        # The ops plane mounts beside the search: the time series brackets
        # the run and the search is the same.
        assert main(argv + ["--output-dir", str(tmp_path / "b"),
                            "--metrics-port", "0",
                            "--metrics-interval-s", "0.05"]) == 0
        with open(tmp_path / "b" / "tuning_result.json") as f:
            assert json.load(f)["trials"] == out["trials"]
        from photon_ml_tpu_torch.telemetry import read_series

        assert len(read_series(str(tmp_path / "b" / "metrics_ts.jsonl"))) >= 2

    def test_cli_selfcheck_without_a_card_refuses(self, monkeypatch):
        from photon_ml_tpu_torch.tuning.__main__ import main

        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            main(["--selfcheck"])


class TestThreadSafeCounting:
    def test_eight_threads_lose_no_launch(self, monkeypatch):
        """8 threads launch through ``_kernels.launch`` at once (a stand-in
        library, no card): every launch is counted."""
        from photon_ml_tpu_torch.ops import _kernels

        class Lib:
            @staticmethod
            def fake(*args):
                return 0

        class Stream:
            cuda_stream = 0

        monkeypatch.setattr(_kernels, "load_library", lambda name: Lib)
        monkeypatch.setattr(torch.cuda, "device", lambda d: _Null())
        monkeypatch.setattr(torch.cuda, "current_stream",
                            lambda d=None: Stream)
        _kernels.reset_launches()
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            for _ in range(2000):
                _kernels.launch("spmv", "fake", "matvec", "cuda")

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert _kernels.LAUNCHES["matvec"] == 8 * 2000
        _kernels.reset_launches()

    def test_eight_threads_lose_no_reduction(self):
        from photon_ml_tpu_torch.parallel import distributed

        distributed.reset_allreduces()
        parts = [torch.ones(4) for _ in range(2)]
        barrier = threading.Barrier(8)

        def worker():
            barrier.wait()
            for _ in range(500):
                distributed.sum_shards(parts, None)

        threads = [threading.Thread(target=worker) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert distributed.ALLREDUCES["count"] == 8 * 500
        assert distributed.ALLREDUCES["bytes"] == 8 * 500 * 16
        distributed.reset_allreduces()

    def test_threaded_fits_count_like_sequential_ones(self, rng):
        """The tuning route's fits on the kernel layout's plain versions
        (the CPU) are bitwise the same from 4 threads as one after
        another."""
        from photon_ml_tpu_torch.drivers.glm_driver import make_fit_once

        X, y = _glm_xy(rng, n=240, d=10)
        fit_once = make_fit_once(X[:160], y[:160], X[160:], y[160:],
                                 device="cpu", max_iters=30)
        lams = [0.01, 0.1, 1.0, 10.0]
        seq = [fit_once(np.array([lam]), 0, None)[2] for lam in lams]
        out = [None] * 4

        def run(i):
            out[i] = fit_once(np.array([lams[i]]), 0, None)[2]

        threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for a, b in zip(seq, out):
            np.testing.assert_array_equal(a, b)


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False
