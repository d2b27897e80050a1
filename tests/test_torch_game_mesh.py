"""GAME over a process group (``game/distributed.py``,
``game/hierarchical.py``, the group forms of ``game/ooc_random.py``,
``game/ooc_factored.py``, ``game/streaming.py``, the estimator's mesh
routes and ``game_training_driver --data-parallel auto``) against the JAX
package's mesh, on the CPU.

Spawned gloo groups of 2 and 4 ranks (``tests/torch_dist_workers.py``,
one run a group size for the module) train every coordinate; the
reference runs on the 8 virtual CPU devices of ``conftest.py`` sliced to
the group's size.

- ``plan_bucket_shards`` gives the reference's placements and
  ``imbalance_ratio`` exactly; so does the out-of-core slice plan.
- Entity-sharded coordinates (the bucket-shard plan, every block split,
  the out-of-core one) land within 1e-5 of the largest |w| of the
  reference's mesh coefficients and 1e-4 of its scores; the factored
  effect too at three iterations a solve (whole fits within 2e-3, as
  ``test_torch_factored.py`` holds them).
- Inside the port a group of k ranks is bitwise k logical shards
  (``mesh=None, n_shards=k``), and the ranks agree bitwise.  Against the
  one-process coordinate the sharded ones are bitwise for the squared loss
  and within 1e-6 of the largest |w| for the logistic loss: a rank's
  slice of a bucket runs ``torch.sigmoid`` (the logistic d1/d2) and
  ``torch.logaddexp`` (its value) over a shorter tensor, and the CPU's
  vectorized loops round an element in a vector's scalar tail apart from
  the same element in the vector body, so an element's bits depend on its
  offset.  Every other op of ``BlockSolver``'s programs
  (``game/coordinates.py``, ``optim/batched.py``: the row/column dots,
  norms, the CG Hessian solve, ``exp``) reduces within a lane and repeats
  its bits at any batch (the squared and Poisson cases show it).
- The row-sharded fixed effect: within 1e-4 of the reference's mesh
  coefficients, one all-reduce an evaluation, ``reg_weight`` changed
  without a re-shard, variances as one card's.
- The streamed fixed effect and a random effect in one descent over the
  group (the reference's ``test_streamed_game_cd_on_mesh``).
- The training driver over the group: rank 0 writes the models; a run
  killed after its first iteration and resumed writes the uninterrupted
  run's model files byte for byte; both within the drivers' 2e-3 of one
  process's run (``tests/test_torch_game_drivers.py``); where the bits
  hold (a squared-loss random effect alone) the model files equal one
  process's byte for byte at every group size.
"""

import json
import multiprocessing
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from photon_ml_tpu.game import data as ref_data
from photon_ml_tpu.game import distributed as ref_dist
from photon_ml_tpu.game import hierarchical as ref_hier
from photon_ml_tpu.game import ooc_random as ref_ooc
from photon_ml_tpu.optim import problem as jp
from photon_ml_tpu.optim.regularization import RegularizationContext as JReg
from photon_ml_tpu.parallel.distributed import data_mesh
from photon_ml_tpu_torch.data.game_reader import write_game_avro
from photon_ml_tpu_torch.drivers import game_training_driver
from photon_ml_tpu_torch.game.coordinates import (
    FixedEffectCoordinate,
    RandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.data import (
    FixedEffectDataset,
    build_random_effect_dataset,
)
from photon_ml_tpu_torch.game.distributed import (
    EntityShardedRandomEffectCoordinate,
    entity_sharded_factored_coordinate,
    lane_range,
)
from photon_ml_tpu_torch.game.factored import FactoredRandomEffectCoordinate
from photon_ml_tpu_torch.game.hierarchical import (
    BucketShardPlan,
    ShardedBucketRandomEffectCoordinate,
    plan_bucket_shards,
)
from photon_ml_tpu_torch.game.ooc_factored import (
    OutOfCoreFactoredRandomEffectCoordinate,
)
from photon_ml_tpu_torch.game.ooc_random import (
    OutOfCoreRandomEffectCoordinate,
)
from photon_ml_tpu_torch.io.game_store import load_game_model

sys.path.insert(0, os.path.dirname(__file__))
import torch_dist_workers as workers  # noqa: E402
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401

#: Seconds a spawned group may take before the test fails (it takes
#: 6-10 s alone).
JOIN_TIMEOUT = 90
CPU = ("--device", "cpu")
FIT_TOL = 2e-3


def _ref_config(max_iters=25, tolerance=1e-7):
    return jp.GlmOptimizationConfig(
        optimizer=jp.OptimizerConfig(max_iters=max_iters,
                                     tolerance=tolerance),
        regularization=JReg.l2())


def _close(got, want, rel):
    """Within ``rel`` of the largest |want| (at least 1)."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=rel * max(1.0, float(np.abs(want).max())))


def _bitwise(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


def _datasets(case):
    task, seed, n_ent, d = workers.RE_CASES[case]
    keys, X, y, w, offsets = workers.zipf_entities(seed, n_ent, d, task=task)
    return task, keys, X, y, w, offsets


def _resume_rows(n, seed):
    """The reference's kill-and-resume data (``tests/test_checkpoint.py``)
    with one more global feature."""
    rng = np.random.default_rng(seed)
    user_effect = {f"u{u}": rng.normal(scale=2.0) for u in range(24)}
    rows = []
    for i in range(n):
        u = f"u{min(int(rng.zipf(1.5)) - 1, 23)}"
        xg = rng.normal(size=4)
        margin = 1.5 * xg[0] - xg[1] + user_effect[u]
        rows.append({
            "uid": f"r{i}", "offset": None, "weight": None,
            "response": float(rng.uniform() < 1 / (1 + np.exp(-margin))),
            "ids": {"userId": u},
            "features": {
                "global": [{"name": f"g{j}", "term": "",
                            "value": float(xg[j])} for j in range(4)],
                "userFeatures": [{"name": "b", "term": "", "value": 1.0},
                                 {"name": "x", "term": "",
                                  "value": float(xg[2])}],
            },
        })
    return rows


COORDS = [
    {"name": "fixed", "type": "fixed", "feature_shard": "global",
     "optimizer": "lbfgs", "max_iters": 30, "reg_type": "l2",
     "reg_weight": 0.5},
    {"name": "per_user", "type": "random", "feature_shard": "userFeatures",
     "entity_key": "userId", "optimizer": "lbfgs", "max_iters": 20,
     "reg_type": "l2", "reg_weight": 0.5, "split_factor": 0.25},
]


def _write_config(root, name, iterations, coords=COORDS, task="logistic",
                  evaluator="auc"):
    path = str(root / f"{name}.json")
    with open(path, "w") as f:
        json.dump({"task": task, "iterations": iterations,
                   "evaluator": evaluator, "coordinates": coords}, f)
    return path


def _driver_runs(root):
    """(name, argv) of the group's driver runs: uninterrupted, killed
    after one iteration, resumed in the killed run's directory, one with
    the fixed effect streamed and the random effect out of core, and one
    warm-started from the uninterrupted run's model."""
    train = str(root / "train.avro")
    base = ["--train-data", train, "--data-parallel", "auto", *CPU]
    ooc = [dict(COORDS[0], streaming_chunk_rows=128),
           dict(COORDS[1], device_budget_bytes=4096)]
    return [
        ("full", base + ["--config", _write_config(root, "c3", 3),
                         "--output-dir", str(root / "full")]),
        ("killed", base + ["--config", _write_config(root, "c1", 1),
                           "--output-dir", str(root / "resumed")]),
        ("resumed", base + ["--config", _write_config(root, "c3", 3),
                            "--output-dir", str(root / "resumed"),
                            "--resume"]),
        ("ooc", base + ["--config", _write_config(root, "cooc", 2, ooc),
                        "--output-dir", str(root / "ooc")]),
        ("warm", base + ["--config", _write_config(root, "c1", 1),
                         "--output-dir", str(root / "warm"),
                         "--initial-model", str(root / "full" / "models")]),
        # Where the bits hold at any group size: a random effect alone
        # under the squared loss (no all-reduce sum, no vector-tail op).
        ("re_only", base + ["--config", _write_config(
            root, "cre", 2, [COORDS[1]], task="linear", evaluator="rmse"),
            "--output-dir", str(root / "re_only")]),
    ]


def _spawn(world, root, driver_runs):
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=workers.game_rank_main,
                         args=(r, world, str(root / "rendezvous"), str(root),
                               driver_runs))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(JOIN_TIMEOUT)
        hung = [r for r, p in enumerate(procs) if p.is_alive()]
        assert not hung, f"ranks {hung} still running after {JOIN_TIMEOUT} s"
        codes = [p.exitcode for p in procs]
        assert codes == [0] * world, f"rank exit codes {codes}"
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    return [dict(np.load(root / f"rank{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module", params=[2, 4], ids=["2-ranks", "4-ranks"])
def group(request, tmp_path_factory):
    world = request.param
    root = tmp_path_factory.mktemp(f"game_group{world}")
    write_game_avro(str(root / "train.avro"), _resume_rows(400, 2))
    ranks = _spawn(world, root, _driver_runs(root))
    return world, ranks, root


def test_ranks_agree_bitwise(group):
    world, ranks, _ = group
    for other in ranks[1:]:
        assert sorted(other) == sorted(ranks[0])
        for k, a in ranks[0].items():
            assert _bitwise(other[k], a), k


# -- the bucket-shard plan ----------------------------------------------------


class TestBucketShardPlan:
    """The reference's ``TestBucketShardPlan``, on both packages' buckets
    of the same entities: the same placements and ratio exactly."""

    @pytest.mark.parametrize("case", list(workers.RE_CASES))
    @pytest.mark.parametrize("n_devices", [1, 2, 3, 4, 8])
    @pytest.mark.parametrize("split_factor", [0.25, 0.5, 1.0])
    def test_plan_equals_reference(self, case, n_devices, split_factor):
        _, keys, X, y, w, _ = _datasets(case)
        port = build_random_effect_dataset(keys, X, y, w, device=False)
        ref = ref_data.build_random_effect_dataset(keys, X, y, w,
                                                   device=False)
        got = plan_bucket_shards(port.blocks, n_devices, split_factor)
        want = ref_hier.plan_bucket_shards(ref.blocks, n_devices,
                                           split_factor)
        assert got.placements == want.placements
        assert got.imbalance_ratio == want.imbalance_ratio
        assert (got.n_split, got.n_packed) == (want.n_split, want.n_packed)
        # Deterministic.
        assert plan_bucket_shards(port.blocks, n_devices,
                                  split_factor) == got

    def test_plan_mixes_split_and_packed(self):
        _, keys, X, y, w, _ = _datasets("per_user")
        ds = build_random_effect_dataset(keys, X, y, w, device=False)
        plan = plan_bucket_shards(ds.blocks, 4)
        assert isinstance(plan, BucketShardPlan)
        assert plan.n_split >= 1 and plan.n_packed >= 1
        assert plan.imbalance_ratio >= 1.0
        assert plan_bucket_shards(ds.blocks, 1).placements == tuple(
            ("pack", 0) for _ in ds.blocks)

    def test_rejects_bad_device_count(self):
        with pytest.raises(ValueError, match="n_devices"):
            plan_bucket_shards([], 0)
        with pytest.raises(ValueError, match="n_devices"):
            ref_hier.plan_bucket_shards([], 0)

    def test_lane_ranges_are_the_reference_split(self):
        """Rank r of k solves the contiguous lanes [r·E/k, (r+1)·E/k) of a
        split block padded to a multiple of k (the reference's P(DATA)
        sharding of ``_pad_block_entities``'s axis)."""
        assert [lane_range(("split",), 12, 4, r) for r in range(4)] == [
            (0, 3), (3, 6), (6, 9), (9, 12)]
        assert lane_range(("pack", 2), 5, 4, 2) == (0, 5)
        assert lane_range(("pack", 2), 5, 4, 1) is None


def test_group_plans_match_reference(group, eight_devices):
    """The group's bucket plan and out-of-core slice plan (placements,
    lanes, padding, bytes) are the reference's mesh plans exactly."""
    world, ranks, _ = group
    mesh = data_mesh(eight_devices[:world])
    task, keys, X, y, w, _ = _datasets("per_user")
    host = ref_data.build_random_effect_dataset(keys, X, y, w, device=False)
    plan = ref_hier.plan_bucket_shards(host.blocks, world)
    assert ranks[0]["per_user/plan"].tolist() == [
        -1 if p[0] == "split" else p[1] for p in plan.placements]
    ooc = ref_ooc.OutOfCoreRandomEffectCoordinate(
        "re", host, task, _ref_config(), reg_weight=0.7,
        device_budget_bytes=workers.OOC_BUDGET, mesh=mesh)
    assert ranks[0]["per_user/ooc_plan"].tolist() == [
        [s.block_idx, s.lane_lo, s.lane_hi, s.padded_e, s.bytes,
         -1 if s.placement[0] == "split" else s.placement[1]]
        for g in ooc.pass_plan for s in g]


# -- entity-sharded random effects --------------------------------------------


def _states(saved, prefix):
    n = sum(1 for k in saved if k.startswith(prefix + "/state"))
    return [saved[f"{prefix}/state{b}"] for b in range(n)]


def _logical(kind, case, world):
    """The port's logical-shard coordinate of ``kind`` on ``case``."""
    task, keys, X, y, w, _ = _datasets(case)
    host = build_random_effect_dataset(keys, X, y, w, device=False)
    cfg = workers.game_config()
    kw = dict(n_shards=world, device="cpu")
    if kind == "bucket":
        return ShardedBucketRandomEffectCoordinate(
            "re", host, None, task, cfg, reg_weight=0.7, entity_key="uid",
            **kw)
    if kind == "split":
        return EntityShardedRandomEffectCoordinate(
            "re", host, None, task, cfg, reg_weight=0.7, **kw)
    return OutOfCoreRandomEffectCoordinate(
        "re", host, task, cfg, reg_weight=0.7,
        device_budget_bytes=workers.OOC_BUDGET, **kw)


@pytest.mark.parametrize("kind", ["bucket", "split", "ooc"])
@pytest.mark.parametrize("case", list(workers.RE_CASES))
def test_random_effect_group_is_logical_shards_bitwise(group, kind, case):
    """A group of k ranks gives the bits of k logical shards: the same
    lanes run the same programs; the lane exchange and the score sum move
    bits only (each row scored by one rank)."""
    world, ranks, _ = group
    _, _, _, _, _, offsets = _datasets(case)
    coord = _logical(kind, case, world)
    st = coord.train(torch.from_numpy(offsets))
    for a, b in zip(st, _states(ranks[0], f"{case}/{kind}")):
        assert _bitwise(np.asarray(a), b)
    assert _bitwise(coord.score(st), ranks[0][f"{case}/{kind}/score"])
    st2 = coord.train(torch.from_numpy(offsets), warm_state=st)
    assert _bitwise(coord.score(st2), ranks[0][f"{case}/{kind}/warm_score"])


@pytest.mark.parametrize("kind", ["bucket", "split", "ooc"])
@pytest.mark.parametrize("case", list(workers.RE_CASES))
def test_random_effect_group_matches_one_process(group, kind, case):
    """Against the one-process resident coordinate: bitwise for the
    squared loss; for the logistic loss within 1e-6 of the largest |w|
    (``torch.sigmoid``/``torch.logaddexp`` round an element by its offset
    in the CPU's vectorized loop; see the module docstring).  Padding lanes
    solve to 0."""
    world, ranks, _ = group
    task, keys, X, y, w, offsets = _datasets(case)
    one = RandomEffectCoordinate(
        "re", build_random_effect_dataset(keys, X, y, w, device="cpu"),
        task, workers.game_config(), reg_weight=0.7)
    st = one.train(torch.from_numpy(offsets))
    got = _states(ranks[0], f"{case}/{kind}")
    for a, b in zip(st, got):
        a = a.numpy()
        assert np.all(b[a.shape[0]:] == 0)
        if task == "squared":
            assert _bitwise(a, b[:a.shape[0]])
        else:
            _close(b[:a.shape[0]], a, 1e-6)
    score = one.score(st).numpy()
    if task == "squared":
        assert _bitwise(score, ranks[0][f"{case}/{kind}/score"])
    else:
        _close(ranks[0][f"{case}/{kind}/score"], score, 1e-5)


@pytest.mark.parametrize("kind", ["bucket", "split", "ooc"])
def test_random_effect_group_matches_reference_mesh(group, kind,
                                                    eight_devices):
    """Within 1e-5 of the largest |w| of the reference's mesh coefficients
    and 1e-4 of its scores (the reference's sharded coordinates on its
    mesh of the group's size)."""
    world, ranks, _ = group
    mesh = data_mesh(eight_devices[:world])
    task, keys, X, y, w, offsets = _datasets("per_user")
    host = ref_data.build_random_effect_dataset(keys, X, y, w, device=False)
    if kind == "bucket":
        ref = ref_hier.ShardedBucketRandomEffectCoordinate(
            "re", host, mesh, task, _ref_config(), reg_weight=0.7)
    elif kind == "split":
        ref = ref_dist.EntityShardedRandomEffectCoordinate(
            "re", host, mesh, task, _ref_config(), reg_weight=0.7)
    else:
        ref = ref_ooc.OutOfCoreRandomEffectCoordinate(
            "re", host, task, _ref_config(), reg_weight=0.7,
            device_budget_bytes=workers.OOC_BUDGET, mesh=mesh)
    st = ref.train(jnp.asarray(offsets))
    for a, b in zip(st, _states(ranks[0], f"per_user/{kind}")):
        a = np.asarray(a)
        n = min(a.shape[0], b.shape[0])
        _close(b[:n], a[:n], 1e-5)
    _close(ranks[0][f"per_user/{kind}/score"], np.asarray(ref.score(st)),
           1e-4)


def test_sharded_finalize_exact_entities(group):
    """The padding lanes drop: the model holds exactly the real
    entities."""
    world, ranks, _ = group
    assert int(ranks[0]["per_user/bucket/n_entities"]) == 120


def test_factored_group(group, eight_devices):
    """The entity-sharded factored effect and its out-of-core form: a group
    of k is bitwise k logical shards (the projection's float64 column sums
    added in rank order).  Against the reference's mesh coordinate (which
    sums in float32 in another order): three iterations a solve within
    1e-5 of the largest |V| and 1e-4 of its scores; solves run to the
    float32 noise floor within the 2e-3 of ``test_torch_factored.py``'s
    whole fits (where one ulp decides the projection L-BFGS's last
    step)."""
    world, ranks, _ = group
    task, keys, X, y, w, offsets = _datasets("per_user")
    host = build_random_effect_dataset(keys, X, y, w, device=False)
    off = torch.from_numpy(offsets)

    def logical(cfg):
        return {
            "factored": entity_sharded_factored_coordinate(
                "re", host, None, task, cfg, rank=2, reg_weight=0.7,
                n_shards=world, device="cpu"),
            "ooc_factored": OutOfCoreFactoredRandomEffectCoordinate(
                "re", host, task, cfg, rank=2, reg_weight=0.7,
                device_budget_bytes=workers.OOC_BUDGET, n_shards=world,
                device="cpu"),
        }

    for name, coord in logical(workers.FACTORED_CONFIG()).items():
        st = coord.train(off)
        assert _bitwise(st[1], ranks[0][f"per_user/{name}/V"]), name
        assert _bitwise(coord.score(st), ranks[0][f"per_user/{name}/score"])
    mesh = data_mesh(eight_devices[:world])
    ref_host = ref_data.build_random_effect_dataset(keys, X, y, w,
                                                    device=False)
    for iters, tol, rel_v, rel_s in ((200, 1e-12, FIT_TOL, FIT_TOL),
                                     (3, 1e-7, 1e-5, 1e-4)):
        ref = ref_dist.entity_sharded_factored_coordinate(
            "re", ref_host, mesh, task, _ref_config(iters, tol), rank=2,
            reg_weight=0.7)
        rst = ref.train(jnp.asarray(offsets))
        rscore = np.asarray(ref.score(rst))
        if iters == 3:
            for name, coord in logical(
                    workers.game_config(max_iters=3,
                                        tolerance=1e-7)).items():
                st = coord.train(off)
                _close(st[1].numpy(), np.asarray(rst[1]), rel_v)
                _close(coord.score(st).numpy(), rscore, rel_s)
            continue
        for name in ("factored", "ooc_factored"):
            _close(ranks[0][f"per_user/{name}/V"], np.asarray(rst[1]), rel_v)
            _close(ranks[0][f"per_user/{name}/score"], rscore, rel_s)
    # One process, unsharded: the same stationary point.
    one = FactoredRandomEffectCoordinate(
        "re", build_random_effect_dataset(keys, X, y, w, device="cpu"),
        task, workers.FACTORED_CONFIG(), rank=2, reg_weight=0.7)
    ost = one.train(off)
    _close(ranks[0]["per_user/factored/score"], one.score(ost).numpy(),
           FIT_TOL)


def test_sharded_factored_builds_only_its_lanes_tables():
    """A rank of the entity-sharded factored effect builds the projection
    gradient's gather tables over its own lanes only: no table over the
    whole dataset reaches its device.  Construction only, so a stand-in
    for the group carries the rank and size the constructor reads."""
    from types import SimpleNamespace

    from photon_ml_tpu_torch.game.factored import _grad_sum

    task, keys, X, y, w, _ = _datasets("per_user")
    host = build_random_effect_dataset(keys, X, y, w, device=False)
    coord = entity_sharded_factored_coordinate(
        "re", host, SimpleNamespace(rank=1, size=2), task,
        workers.FACTORED_CONFIG(), rank=2, reg_weight=0.7, device="cpu")
    assert coord._grad_sum is None
    assert set(coord._grad_sums) == {1}
    padded = coord.dataset
    # Rank 1 of 2 holds the upper half of every split block's lanes.
    own = _grad_sum([b.col_map[b.n_entities // 2:] for b in padded.blocks],
                    padded.n_features, "cpu")
    got = coord._grad_sums[1]
    assert len(got.tables) == len(own.tables)
    for a, b in zip(got.tables + [got.final], own.tables + [own.final]):
        assert torch.equal(a, b)


# -- the row-sharded fixed effect ---------------------------------------------


def test_fixed_effect_group(group, eight_devices):
    """The reference's ``test_fixed_effect_parity`` and
    ``test_fixed_effect_reg_weight_mutation``: within 1e-4 of the
    reference's mesh coordinate and of one process's, one all-reduce an
    evaluation, ``reg_weight`` changed on the same shards, variances
    within 1e-4 of one process's."""
    world, ranks, _ = group
    saved = ranks[0]
    X, y, offsets = workers.fixed_xy()
    cfg = workers.game_config(max_iters=100, tolerance=1e-7)
    mesh = data_mesh(eight_devices[:world])
    ref = ref_dist.DistributedFixedEffectCoordinate(
        "fixed", X, y, mesh, "logistic", _ref_config(100, 1e-7),
        reg_weight=1.0)
    rw = np.asarray(ref.train(jnp.asarray(offsets)))
    _close(saved["fixed/w"], rw, 1e-4)
    _close(saved["fixed/score"], np.asarray(ref.score(jnp.asarray(rw))),
           1e-4)
    ref.reg_weight = 5.0
    _close(saved["fixed/w_reg5"],
           np.asarray(ref.train(jnp.asarray(offsets))), 1e-4)
    assert bool(saved["fixed/same_shards"])
    from photon_ml_tpu_torch.data.dataset import make_glm_data

    cfg_v = type(cfg)(optimizer=cfg.optimizer,
                      regularization=cfg.regularization,
                      compute_variances=True)
    one = FixedEffectCoordinate(
        "fixed", FixedEffectDataset(make_glm_data(X, y, device="cpu"),
                                    n_global_rows=len(y)),
        "logistic", cfg_v, reg_weight=1.0)
    w1 = one.train(torch.from_numpy(offsets))
    _close(saved["fixed/w"], w1.numpy(), 1e-4)
    # Every evaluation was one all-reduce (a few dozen, none per chunk).
    assert 5 <= int(saved["fixed/allreduces"]) <= 200
    one.reg_weight = 5.0
    w5 = one.train(torch.from_numpy(offsets))
    var = one.finalize(w5, offsets=offsets).model.coefficients.variances
    _close(saved["fixed/variances"], var.numpy(), 1e-4)


def test_streamed_descent_on_group(group):
    """The reference's ``test_streamed_game_cd_on_mesh``: a streamed fixed
    effect over the group's shards and a per-user random effect, two
    iterations, within the drivers' 2e-3 of one process's (streamed fixed
    effect, resident random effect) descent (the reference holds its mesh
    run to 1e-2 of one device's): the float32 solves stop on their noise
    floor, where the group's sum order decides the last steps."""
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.game.descent import CoordinateDescent
    from photon_ml_tpu_torch.game.streaming import (
        StreamingFixedEffectCoordinate,
    )

    world, ranks, _ = group
    keys, Xu, y, w, _ = workers.zipf_entities(3, 120, 5)
    X, *_ = workers.fixed_xy(n=len(y), d=8)
    cfg = workers.game_config(max_iters=50, tolerance=1e-8)
    fixed = StreamingFixedEffectCoordinate(
        "fixed", make_streaming_glm_data(X, y, chunk_rows=128, device="cpu",
                                         use_kernel=False),
        "logistic", cfg, reg_weight=1.0)
    re = RandomEffectCoordinate(
        "per_user", build_random_effect_dataset(keys, Xu, y, w,
                                                device="cpu"),
        "logistic", cfg, reg_weight=1.0, entity_key="userId")
    res = CoordinateDescent([fixed, re]).run(torch.zeros(len(y)),
                                             n_iterations=2)
    _close(ranks[0]["cd/fixed"], res.states["fixed"].numpy(), FIT_TOL)
    _close(ranks[0]["cd/total"],
           (res.scores["fixed"] + res.scores["per_user"]).numpy(), FIT_TOL)


# -- the training driver over the group ---------------------------------------


def _model_files(out):
    root = os.path.join(out, "models")
    found = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                found[os.path.relpath(p, root)] = fh.read()
    return found


def test_driver_over_group(group, tmp_path):
    """``--data-parallel auto`` over the group: every rank trained, rank 0
    wrote the models; a run killed after its first iteration and resumed
    writes the uninterrupted run's model files byte for byte (the CD
    checkpoint, read by every rank); the models within the drivers' 2e-3
    of one process's run; the streamed/out-of-core config and a run
    warm-started from a saved model too."""
    world, ranks, root = group
    for name in ("full", "killed", "resumed", "ooc", "warm", "re_only"):
        assert int(ranks[0][f"driver/{name}/ranks"]) == world
    full = _model_files(str(root / "full"))
    assert full and full == _model_files(str(root / "resumed"))
    with open(root / "resumed" / "training_result.json") as f:
        resumed = json.load(f)
    assert [h["iteration"] for h in resumed["history"]] == [0, 0, 1, 1, 2,
                                                            2]
    assert resumed["data_parallel"] == {"ranks": world, "rank": 0}
    for name, cfg, extra in (
            ("full", "c3", []), ("ooc", "cooc", []),
            # The reference's test_initial_model_on_mesh_path: a model's
            # per-entity tables placed into the padded lanes.
            ("warm", "c1", ["--initial-model", str(root / "full" /
                                                   "models")])):
        single = str(tmp_path / name)
        game_training_driver.run([
            "--train-data", str(root / "train.avro"), "--config",
            str(root / f"{cfg}.json"), "--output-dir", single, *CPU,
            *extra])
        m_group, _ = load_game_model(str(root / name / "models"),
                                     device="cpu")
        m_one, _ = load_game_model(os.path.join(single, "models"),
                                   device="cpu")
        _close(m_group.models["fixed"].model.coefficients.means.numpy(),
               m_one.models["fixed"].model.coefficients.means.numpy(),
               FIT_TOL)
        re_g = m_group.models["per_user"].coefficients
        re_1 = m_one.models["per_user"].coefficients
        assert sorted(re_g) == sorted(re_1)
        for k in re_1:
            assert np.array_equal(re_g[k][0], re_1[k][0])
            _close(re_g[k][1], re_1[k][1], FIT_TOL)


def test_estimator_routes_over_a_group(tmp_path):
    """The reference's ``test_estimator_routes_factored_to_mesh`` and
    ``test_estimator_mesh_parity_and_driver_flag``: over a group the
    estimator builds the row-sharded fixed effect, the bucket-shard random
    effect (reading ``split_factor``) and the entity-sharded factored
    effect, reuses a built coordinate when only ``reg_weight`` changes (no
    re-shard, no re-grouping), and fits one process's models within 2e-3
    (a one-rank gloo group here; groups of 2 and 4 above)."""
    import torch.distributed as dist

    from photon_ml_tpu_torch.game import estimator
    from photon_ml_tpu_torch.game.distributed import (
        DistributedFixedEffectCoordinate,
    )
    from photon_ml_tpu_torch.game.factored import (
        ShardedFactoredRandomEffectCoordinate,
    )
    from photon_ml_tpu_torch.parallel.distributed import DataGroup

    keys, Xu, y, w, _ = workers.zipf_entities(3, 60, 4)
    X, *_ = workers.fixed_xy(n=len(y), d=6)
    shards, ids = {"global": X, "user": Xu}, {"userId": np.asarray(keys)}
    cfg = workers.game_config(max_iters=30, tolerance=1e-7)
    configs = {
        "fixed": estimator.FixedEffectCoordinateConfig(
            feature_shard="global", optimization=cfg, reg_weight=1.0),
        "per_user": estimator.RandomEffectCoordinateConfig(
            feature_shard="user", entity_key="userId", optimization=cfg,
            reg_weight=1.0, split_factor=0.25),
        "factored": estimator.FactoredRandomEffectCoordinateConfig(
            feature_shard="user", entity_key="userId", optimization=cfg,
            reg_weight=1.0, rank=2, alternations=1),
    }
    one, _ = estimator.GameEstimator("logistic", configs, n_iterations=2,
                                     device="cpu").fit(shards, ids, y)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/pg",
                            rank=0, world_size=1)
    try:
        est = estimator.GameEstimator("logistic", configs, n_iterations=2,
                                      mesh=DataGroup(), device="cpu")
        cache: dict = {}
        coords = est._build_coordinates(configs, shards, ids, y, None, None,
                                        cache)
        assert [type(c) for c in coords] == [
            DistributedFixedEffectCoordinate,
            ShardedBucketRandomEffectCoordinate,
            ShardedFactoredRandomEffectCoordinate]
        assert coords[1].split_factor == 0.25
        again = est._build_coordinates(
            {k: (type(v)(**{**v.__dict__, "reg_weight": 3.0}))
             for k, v in configs.items()}, shards, ids, y, None, None, cache)
        assert again[0].dist is coords[0].dist
        assert again[1].dataset is coords[1].dataset
        assert [c.reg_weight for c in again] == [3.0] * 3
        model, _ = est.fit(shards, ids, y)
    finally:
        dist.destroy_process_group()
    _close(model["fixed"].model.coefficients.means.numpy(),
           one["fixed"].model.coefficients.means.numpy(), FIT_TOL)
    for name in ("per_user", "factored"):
        got, want = model[name].coefficients, one[name].coefficients
        assert sorted(got) == sorted(want)
        for k in want:
            _close(got[k][1], want[k][1], FIT_TOL)


def test_driver_model_files_bitwise_across_group_sizes(group, tmp_path):
    """Wherever the bits hold (a random effect alone under the squared
    loss: each lane's solve and each row's score come from one rank), the
    group's model files equal one process's byte for byte, at 2 and at 4
    ranks alike."""
    world, ranks, root = group
    single = str(tmp_path / "re_only")
    game_training_driver.run([
        "--train-data", str(root / "train.avro"), "--config",
        str(root / "cre.json"), "--output-dir", single, *CPU])
    got = _model_files(str(root / "re_only"))
    assert got and got == _model_files(single)
