"""The port's training fault sites and chaos CLI against the JAX package's,
on the CPU.

Mirrors the training cases of ``tests/test_chaos.py``: each of the ten
training sites (``prefetch.pack``/``transfer``, ``staging.put``/
``decode``, ``streaming.carry_sync``/``cache_evict``,
``checkpoint.save``/``restore``, ``cd.iteration``, ``grid.point``) is
armed in both packages on the same workload and must fire exactly once,
at the same occurrence index with the same context; a pass torn down by
a pipeline fault leaks no thread and the next clean pass is bitwise a
clean one; ``--list-sites`` prints the reference's catalog and ``--plan``
validates or refuses a plan as the reference does; the selfcheck passes
with ``--device cpu``.  The GAME and sharded-solver sites
(``game.repack``, ``game.bucket_shard`` in the bucket-shard plan and out
of core, ``distributed.allreduce`` in ADMM and block CD,
``admm.consensus``) fire as the reference's do, and the update or solve
they abort, run again, is bitwise the uninterrupted one; every site of
the catalog has a caller in the port's source.
"""

import ast

import json
import os
import pathlib
import threading

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

from photon_ml_tpu import chaos as ref_chaos
from photon_ml_tpu.chaos import __main__ as ref_cli
from photon_ml_tpu_torch import chaos, telemetry
from photon_ml_tpu_torch.chaos import __main__ as cli
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

TRAINING_SITES = (
    "prefetch.pack", "prefetch.transfer", "staging.put", "staging.decode",
    "streaming.carry_sync", "streaming.cache_evict", "checkpoint.save",
    "checkpoint.restore", "cd.iteration", "grid.point",
)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def _xy(n=160, d=10):
    rng = np.random.default_rng(11)
    X = sp.random(n, d, density=0.5, random_state=2, format="csr",
                  dtype=np.float32)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    return X, y


def _port_sobj(**kw):
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.optim.streaming import StreamingObjective

    X, y = _xy()
    stream = make_streaming_glm_data(X, y, chunk_rows=40, device="cpu")
    return StreamingObjective("logistic", stream, **kw)


def _ref_sobj(**kw):
    from photon_ml_tpu.data.streaming import make_streaming_glm_data
    from photon_ml_tpu.optim.streaming import StreamingObjective

    X, y = _xy()
    stream = make_streaming_glm_data(X, y, chunk_rows=40, use_pallas=False)
    return StreamingObjective("logistic", stream, **kw)


def _pass_port(**kw):
    sobj = _port_sobj(**kw)
    return lambda: sobj.value_and_grad(torch.zeros(sobj.n_features), 1.0)


def _pass_ref(**kw):
    sobj = _ref_sobj(**kw)
    return lambda: sobj.value_and_grad(
        jnp.zeros(sobj.stream.n_features, jnp.float32), 1.0)


def _checkpoint_workload(pkg, tmp, site):
    if pkg == "port":
        from photon_ml_tpu_torch.io.checkpoint import GridCheckpointer
    else:
        from photon_ml_tpu.io.checkpoint import GridCheckpointer
    ck = GridCheckpointer(os.path.join(tmp, pkg))
    ck.save({1.0: np.ones(4, np.float32)})

    def run():
        if site == "checkpoint.save":
            ck.save({1.0: np.ones(4, np.float32),
                     0.5: np.zeros(4, np.float32)})
        else:
            ck.load()
    return run


def _grid_workload(pkg):
    X, y = _xy()
    if pkg == "port":
        from photon_ml_tpu_torch.data.dataset import make_glm_data
        from photon_ml_tpu_torch.optim.problem import (
            GlmOptimizationConfig,
            GlmOptimizationProblem,
            OptimizerConfig,
        )
        from photon_ml_tpu_torch.optim.regularization import (
            RegularizationContext,
        )
        data = make_glm_data(X, y, device="cpu")
    else:
        from photon_ml_tpu.data.dataset import make_glm_data
        from photon_ml_tpu.optim.problem import (
            GlmOptimizationConfig,
            GlmOptimizationProblem,
            OptimizerConfig,
        )
        from photon_ml_tpu.optim.regularization import RegularizationContext
        data = make_glm_data(X, y)
    problem = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=10, tolerance=1e-6),
        regularization=RegularizationContext.l2()))
    return lambda: problem.run_grid(data, [3.0, 1.0, 0.3])


def _cd_workload(pkg):
    rng = np.random.default_rng(13)
    n, n_users = 120, 6
    Xg = rng.normal(size=(n, 3)).astype(np.float32)
    users = rng.integers(n_users, size=n)
    y = (rng.uniform(size=n) < 0.5).astype(np.float32)
    shards = {"global": sp.csr_matrix(Xg),
              "userFeatures": sp.csr_matrix(np.ones((n, 1), np.float32))}
    ids = {"userId": np.array([f"u{u}" for u in users])}
    if pkg == "port":
        from photon_ml_tpu_torch.game import estimator as est
        from photon_ml_tpu_torch.optim.problem import (
            GlmOptimizationConfig,
            OptimizerConfig,
        )
        kw = {"device": "cpu"}
    else:
        from photon_ml_tpu.game import estimator as est
        from photon_ml_tpu.optim.problem import (
            GlmOptimizationConfig,
            OptimizerConfig,
        )
        kw = {}
    opt = GlmOptimizationConfig(optimizer=OptimizerConfig(max_iters=10))
    configs = {
        "fixed": est.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=opt, reg_weight=0.5),
        "per_user": est.RandomEffectCoordinateConfig(
            feature_shard="userFeatures", entity_key="userId",
            optimization=opt, reg_weight=0.5),
    }
    gest = est.GameEstimator("logistic", configs, n_iterations=3, **kw)
    return lambda: gest.fit(shards, ids, y)


def _workloads(site, tmp):
    """(port workload, reference workload) reaching ``site``, and the
    occurrence to arm."""
    if site in ("prefetch.pack", "prefetch.transfer", "staging.put",
                "streaming.carry_sync"):
        return _pass_port(), _pass_ref(), 2
    if site == "staging.decode":
        return (_pass_port(compress="lossless"),
                _pass_ref(compress="lossless"), 2)
    if site == "streaming.cache_evict":
        return (_pass_port(hot_budget_bytes=1 << 20),
                _pass_ref(hot_budget_bytes=1 << 20), 0)
    if site.startswith("checkpoint."):
        return (_checkpoint_workload("port", tmp, site),
                _checkpoint_workload("ref", tmp, site), 0)
    if site == "cd.iteration":
        return _cd_workload("port"), _cd_workload("ref"), 1
    assert site == "grid.point"
    return _grid_workload("port"), _grid_workload("ref"), 1


def _normalized(fired, tmp):
    out = []
    for rec in fired:
        rec = dict(rec)
        if "path" in rec:
            rec["path"] = os.path.basename(rec["path"])
        out.append(rec)
    return out


class TestTrainingSites:
    @pytest.mark.parametrize("site", TRAINING_SITES)
    def test_site_fires_once_at_the_references_occurrence(self, site,
                                                          tmp_path):
        port_run, ref_run, at = _workloads(site, str(tmp_path))
        plans = (chaos.FaultPlan([chaos.FaultSpec(site=site, at=at)]),
                 ref_chaos.FaultPlan([ref_chaos.FaultSpec(site=site,
                                                          at=at)]))
        for plan, run, exc in ((plans[0], port_run, chaos.InjectedFault),
                               (plans[1], ref_run,
                                ref_chaos.InjectedFault)):
            with plan:
                with pytest.raises(exc, match=site.replace(".", r"\.")):
                    run()
        ours, ref = plans[0].fired, plans[1].fired
        assert len(ours) == 1 and ours[0]["occurrence"] == at
        assert _normalized(ours, tmp_path) == _normalized(ref, tmp_path)
        assert plans[0].occurrences(site) == plans[1].occurrences(site)

    def test_every_training_site_is_in_the_catalog(self):
        assert set(TRAINING_SITES) <= set(chaos.KNOWN_SITES)

    @pytest.mark.parametrize("site", ["prefetch.pack", "prefetch.transfer",
                                      "staging.put", "streaming.carry_sync"])
    def test_teardown_leaks_nothing_and_the_next_pass_is_bitwise(self,
                                                                 site):
        sobj = _port_sobj()
        w = torch.full((sobj.n_features,), 0.05)
        v0, g0 = sobj.value_and_grad(w, 1.0)
        with telemetry.Telemetry() as tel:
            with chaos.FaultPlan([chaos.FaultSpec(site=site, at=1)]):
                with pytest.raises(chaos.InjectedFault):
                    sobj.value_and_grad(w, 1.0)
            assert tel.counter("prefetch_thread_leak").value == 0
        assert not [t for t in threading.enumerate()
                    if t.name in ("h2d-pack", "h2d-prefetch")]
        v1, g1 = sobj.value_and_grad(w, 1.0)
        assert torch.equal(v0, v1) and torch.equal(g0, g1)

    def test_an_evict_fault_clears_the_cache_and_results_stay_bitwise(
            self):
        sobj = _port_sobj(hot_budget_bytes=1 << 20)
        plain = _port_sobj()
        w = torch.full((sobj.n_features,), 0.05)
        with chaos.FaultPlan([chaos.FaultSpec(site="streaming.cache_evict",
                                              at=1)]):
            sobj.value_and_grad(w, 1.0)  # replans: admits next pass
            with pytest.raises(chaos.InjectedFault):
                sobj.value_and_grad(w, 1.0)
        assert len(sobj._hot_cache) == 0
        for _ in range(3):
            a, b = sobj.value_and_grad(w, 1.0), plain.value_and_grad(w, 1.0)
            assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])

    def test_a_killed_grid_resumes_bitwise_through_the_watchdog(self,
                                                                tmp_path):
        from photon_ml_tpu_torch.io.checkpoint import GridCheckpointer
        from photon_ml_tpu_torch.utils.watchdog import (
            RetryPolicy,
            RetryStats,
            run_with_retries,
        )

        problem_run = _grid_workload("port")
        full = [m.coefficients.means for _, m, _ in problem_run()]
        from photon_ml_tpu_torch.data.dataset import make_glm_data
        from photon_ml_tpu_torch.optim.problem import (
            GlmOptimizationConfig,
            GlmOptimizationProblem,
            OptimizerConfig,
        )
        from photon_ml_tpu_torch.optim.regularization import (
            RegularizationContext,
        )

        X, y = _xy()
        data = make_glm_data(X, y, device="cpu")
        problem = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=10, tolerance=1e-6),
            regularization=RegularizationContext.l2()))
        ck = GridCheckpointer(str(tmp_path))

        def train(attempt):
            solved = ck.load() if attempt else {}
            acc = dict(solved)

            def on_solved(lam, w):
                acc[lam] = w.numpy()
                ck.save(acc)

            return problem.run_grid(data, [3.0, 1.0, 0.3], solved=solved,
                                    on_solved=on_solved)

        stats = RetryStats()
        with telemetry.Telemetry(output_dir=str(tmp_path / "tel")):
            with chaos.FaultPlan([chaos.FaultSpec(site="grid.point",
                                                  at=1)]):
                resumed = run_with_retries(train, RetryPolicy(max_retries=2),
                                           sleep=lambda s: None, stats=stats)
        assert stats.retries == 1
        assert [res is None for _, _, res in resumed] == [True, True, False]
        for a, (_, m, _) in zip(full, resumed):
            assert torch.equal(a, m.coefficients.means)
        names = []
        with open(tmp_path / "tel" / "events.jsonl") as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("type") == "event":
                    names.append(rec["name"])
        assert names.count("grid.restored") == 2
        assert "chaos.fault" in names and "watchdog.recovered" in names


class TestCli:
    def test_list_sites_prints_the_references_catalog(self, capsys):
        assert cli.main(["--list-sites"]) == 0
        ours = json.loads(capsys.readouterr().out)
        assert ref_cli.main(["--list-sites"]) == 0
        assert ours == json.loads(capsys.readouterr().out)

    @pytest.mark.parametrize("plan", [
        [{"site": "grid.point", "at": 1}],
        [{"site": "streaming.carry_sync", "at": 2, "count": 3,
          "exception": "InjectedDeviceLost"},
         {"site": "prefetch.pack", "action": "delay", "seconds": 0.01}],
        [{"site": "typo.site"}],
        [{"site": "grid.point", "exception": "NoSuchError"}],
        [{"site": "grid.point", "at": -1}],
        [{"site": "grid.point", "action": "explode"}],
    ])
    def test_plan_validates_or_is_refused_as_by_the_reference(
            self, plan, tmp_path, capsys):
        path = str(tmp_path / "plan.json")
        with open(path, "w") as f:
            json.dump({"faults": plan}, f)
        results = []
        for main in (cli.main, ref_cli.main):
            try:
                results.append(("ok", main(["--plan", path])))
            except (ValueError, TypeError, KeyError) as exc:
                results.append((type(exc).__name__, str(exc)))
            results.append(capsys.readouterr().out)
        assert results[:2] == results[2:]

    def test_selfcheck_passes_on_the_cpu(self, tmp_path, capsys):
        assert cli.main(["--selfcheck", "--device", "cpu",
                         "--output-dir", str(tmp_path)]) == 0
        out = capsys.readouterr().out
        for name, _ in cli.SCENARIOS:
            assert f"chaos scenario {name}: PASS" in out
        assert "chaos selfcheck PASSED" in out
        with open(tmp_path / "metrics.json") as f:
            counters = json.load(f)["counters"]
        assert counters["chaos_faults_injected"] >= 4
        assert counters.get("prefetch_thread_leak", 0) == 0

    def test_selfcheck_without_a_card_refuses(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--selfcheck"])


# -- the GAME and sharded-solver sites ---------------------------------------

#: (site, workload) pairs: each site at each of the reference's places.
LATE_SITES = (
    ("game.repack", "repack"),
    ("game.bucket_shard", "bucket_plan"),
    ("game.bucket_shard", "out_of_core"),
    ("distributed.allreduce", "admm"),
    ("distributed.allreduce", "block_cd"),
    ("admm.consensus", "admm"),
)
#: The occurrence each workload's site is armed at (a later one than the
#: first, so the context of a running loop is compared).
LATE_AT = {"repack": 0, "bucket_plan": 1, "out_of_core": 1, "admm": 2,
           "block_cd": 2}
#: The out-of-core workload's device budget: several pass groups.
OOC_BUDGET = 20_000


def _re_data():
    """The reference's zipf entity draw (``tests/test_game_hierarchical.py``
    ``_zipf_data``; ``tests/torch_dist_workers.py``)."""
    import torch_dist_workers as workers

    return workers.zipf_entities(3, 120, 5)


def _late_workload(pkg, kind):
    """A zero-argument callable running ``kind``'s update or solve in
    ``pkg`` ("port" or "ref"); its result is the state to compare."""
    keys, X, y, w, offsets = _re_data()
    if kind == "repack":
        if pkg == "port":
            from photon_ml_tpu_torch.game.data import (
                build_random_effect_dataset,
            )
            kw = {"device": "cpu"}
        else:
            from photon_ml_tpu.game.data import build_random_effect_dataset
            kw = {}
        return lambda: [np.asarray(b.X) for b in build_random_effect_dataset(
            keys, X, y, w, repack="cost_model", program_budget=3,
            **kw).blocks]
    if kind in ("bucket_plan", "out_of_core"):
        return _re_workload(pkg, kind, keys, X, y, w, offsets)
    return _sharded_workload(pkg, kind)


def _re_workload(pkg, kind, keys, X, y, w, offsets):
    import torch_dist_workers as workers

    if pkg == "port":
        from photon_ml_tpu_torch.game.data import build_random_effect_dataset
        from photon_ml_tpu_torch.game.hierarchical import (
            ShardedBucketRandomEffectCoordinate,
        )
        from photon_ml_tpu_torch.game.ooc_random import (
            OutOfCoreRandomEffectCoordinate,
        )

        host = build_random_effect_dataset(keys, X, y, w, device=False)
        cfg = workers.game_config()
        if kind == "bucket_plan":
            coord = ShardedBucketRandomEffectCoordinate(
                "re", host, None, "logistic", cfg, reg_weight=0.7,
                n_shards=2, device="cpu")
        else:
            coord = OutOfCoreRandomEffectCoordinate(
                "re", host, "logistic", cfg, reg_weight=0.7,
                device_budget_bytes=OOC_BUDGET, device="cpu")
        off = torch.from_numpy(offsets)
        return lambda: [np.asarray(s) for s in coord.train(off)]
    import jax

    from photon_ml_tpu.game import hierarchical as ref_hier
    from photon_ml_tpu.game import ooc_random as ref_ooc
    from photon_ml_tpu.game.data import build_random_effect_dataset
    from photon_ml_tpu.optim import problem as jp
    from photon_ml_tpu.optim.regularization import RegularizationContext
    from photon_ml_tpu.parallel.distributed import data_mesh

    host = build_random_effect_dataset(keys, X, y, w, device=False)
    cfg = jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(max_iters=25, tolerance=1e-7),
        regularization=RegularizationContext.l2())
    if kind == "bucket_plan":
        coord = ref_hier.ShardedBucketRandomEffectCoordinate(
            "re", host, data_mesh(jax.devices()[:2]), "logistic", cfg,
            reg_weight=0.7)
    else:
        coord = ref_ooc.OutOfCoreRandomEffectCoordinate(
            "re", host, "logistic", cfg, reg_weight=0.7,
            device_budget_bytes=OOC_BUDGET)
    return lambda: coord.train(jnp.asarray(offsets))


def _sharded_workload(pkg, solver):
    rng = np.random.default_rng(21)
    n, d = 256, 10
    X = (rng.normal(size=(n, d)) / np.sqrt(d)).astype(np.float32)
    p = 1.0 / (1.0 + np.exp(-3.0 * (X @ rng.normal(size=d))))
    y = (rng.uniform(size=n) < p).astype(np.float32)
    opts = (("shards", "4"),) + ((("n_blocks", "2"), ("max_rounds", "30"))
                                 if solver == "block_cd" else ())
    if pkg == "port":
        from photon_ml_tpu_torch.optim.problem import (
            GlmOptimizationConfig,
            GlmOptimizationProblem,
            OptimizerConfig,
        )
        from photon_ml_tpu_torch.optim.regularization import (
            RegularizationContext,
        )
        from photon_ml_tpu_torch.parallel.distributed import shard_glm_data
        from photon_ml_tpu_torch.solvers import sharded

        data = shard_glm_data(X, y, None, n_shards=4, device="cpu")
    else:
        from photon_ml_tpu.optim.problem import (
            GlmOptimizationConfig,
            GlmOptimizationProblem,
            OptimizerConfig,
        )
        from photon_ml_tpu.optim.regularization import RegularizationContext
        from photon_ml_tpu.parallel.distributed import shard_glm_data
        from photon_ml_tpu.solvers import sharded

        data = shard_glm_data(X, y, None, n_shards=4)
    problem = GlmOptimizationProblem("logistic", GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=50, tolerance=1e-8,
                                  solver=solver, solver_options=opts),
        regularization=RegularizationContext.elastic_net(0.5)))
    return lambda: [np.asarray(m.coefficients.means) for _, m, _ in
                    sharded.run_grid_sharded(problem, data, None, [0.1])]


class TestLateTrainingSites:
    @pytest.mark.parametrize("site,kind", LATE_SITES)
    def test_site_fires_once_at_the_references_occurrence(self, site, kind):
        at = LATE_AT[kind]
        plans = (chaos.FaultPlan([chaos.FaultSpec(site=site, at=at)]),
                 ref_chaos.FaultPlan([ref_chaos.FaultSpec(site=site,
                                                          at=at)]))
        for plan, pkg, exc in ((plans[0], "port", chaos.InjectedFault),
                               (plans[1], "ref", ref_chaos.InjectedFault)):
            run = _late_workload(pkg, kind)
            with plan:
                with pytest.raises(exc, match=site.replace(".", r"\.")):
                    run()
        ours, ref = plans[0].fired, plans[1].fired
        assert len(ours) == 1 and ours[0]["occurrence"] == at
        assert ours == ref
        assert plans[0].occurrences(site) == plans[1].occurrences(site)

    @pytest.mark.parametrize("site,kind", LATE_SITES)
    def test_the_retried_update_is_bitwise_the_uninterrupted_one(self, site,
                                                                  kind):
        """The same object's update or solve, aborted at the site and run
        again, gives the clean run's state bit for bit."""
        clean = _late_workload("port", kind)()
        run = _late_workload("port", kind)
        with chaos.FaultPlan([chaos.FaultSpec(site=site, at=LATE_AT[kind])]):
            with pytest.raises(chaos.InjectedFault):
                run()
        again = run()
        assert len(again) == len(clean)
        for a, b in zip(again, clean):
            assert a.shape == b.shape and a.tobytes() == b.tobytes()

    def test_every_catalog_site_has_a_caller_in_the_port(self):
        """Each name of ``KNOWN_SITES`` is the literal first argument of a
        ``maybe_fail`` call somewhere in the port outside ``chaos/``."""
        root = pathlib.Path(chaos.__file__).resolve().parents[1]
        called = set()
        for path in root.rglob("*.py"):
            if path.parent.name == "chaos":
                continue
            for node in ast.walk(ast.parse(path.read_text())):
                if (isinstance(node, ast.Call) and node.args
                        and isinstance(node.args[0], ast.Constant)
                        and isinstance(node.args[0].value, str)
                        and getattr(node.func, "attr",
                                    getattr(node.func, "id", None))
                        == "maybe_fail"):
                    called.add(node.args[0].value)
        assert set(chaos.KNOWN_SITES) - called == set()
        assert called - set(chaos.KNOWN_SITES) == set()
