"""The port's freshness package on the CPU, held against the reference's
``tests/test_freshness.py`` contracts and against the reference itself:

- the reference's cases, run through the port (delta round trips, the
  artifact's integrity checks, the crash-safe publisher and its
  retention and acks, ``swap_delta`` in process and over a supervisor,
  the applier, online refinement, the stores' fingerprints);
- across the packages: table checksums are equal, a delta directory
  written by either package is byte-equal to the other's and readable
  by it, and a delta the reference wrote applies in the port (and the
  other way round) to the same tables.

The reference's tuning case (``TestExecutorWarmStartDir``) waits for
the port of ``tuning/`` (ROADMAP item 8).
"""

import json
import os
import threading

import numpy as np
import pytest
import torch

from photon_ml_tpu_torch import chaos
from photon_ml_tpu_torch import telemetry
from photon_ml_tpu_torch.data.index_map import IndexMap, feature_key
from photon_ml_tpu_torch.freshness.applier import DeltaApplier
from photon_ml_tpu_torch.freshness.delta import (
    DeltaBaseMismatchError,
    DeltaError,
    DeltaFormatError,
    apply_delta,
    diff_game_models,
    diff_model_dirs,
    model_table_checksums,
    read_delta,
    write_delta,
)
from photon_ml_tpu_torch.freshness.online import (
    LabeledEvent,
    OnlineRefiner,
    RefinerConfig,
)
from photon_ml_tpu_torch.freshness.publisher import (
    DeltaPublisher,
    PublishAborted,
    read_acks,
    read_publications,
    write_ack,
)
from photon_ml_tpu_torch.game.model import (
    GameModel,
    RandomEffectModel,
)
from photon_ml_tpu_torch.io.game_store import save_game_model
from photon_ml_tpu_torch.io import game_store, model_store
from photon_ml_tpu_torch.models.glm import Coefficients, GeneralizedLinearModel
from photon_ml_tpu_torch.serving.batcher import BatcherConfig
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.service import ScoringService
from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


@pytest.fixture(scope="module")
def workload():
    return SyntheticWorkload(n_entities=32, seed=7)


def _perturbed(seed=7, n_entities=32):
    """A copy of `workload`'s world with 5 modified, 1 added, and 1
    removed random-effect entity plus shifted fixed means — the shape
    of a real incremental retrain."""
    w = SyntheticWorkload(n_entities=n_entities, seed=seed)
    re = w.model.models["per_entity"]
    for k in [f"u{i}" for i in range(5)]:
        cols, vals = re.coefficients[k]
        re.coefficients[k] = (
            cols, (vals + np.float32(0.25)).astype(np.float32)
        )
    cols = np.arange(w.re_dim, dtype=np.int32)
    re.coefficients["brand_new"] = (
        cols, np.full(w.re_dim, 0.5, np.float32)
    )
    del re.coefficients[f"u{n_entities - 1}"]
    fixed = w.model.models["fixed"].model
    fixed.coefficients.means = torch.from_numpy(
        fixed.coefficients.means.numpy() + np.float32(0.125)
    )
    return w


def _assert_bitwise_equal(got: GameModel, want: GameModel):
    assert model_table_checksums(got) == model_table_checksums(want)
    for name, coord in want.models.items():
        other = got.models[name]
        if isinstance(coord, RandomEffectModel):
            assert set(other.coefficients) == set(coord.coefficients)
            for k, (cols, vals) in coord.coefficients.items():
                assert other.coefficients[k][0].tobytes() == cols.tobytes()
                assert other.coefficients[k][1].tobytes() == vals.tobytes()
        else:
            assert (
                np.asarray(other.model.coefficients.means).tobytes()
                == np.asarray(coord.model.coefficients.means).tobytes()
            )


class TestDeltaRoundTrip:
    def test_game_multi_coordinate_bitwise(self, tmp_path, workload):
        target = _perturbed()
        delta = diff_game_models(
            workload.model, target.model, event_wall_epoch=123.0
        )
        names = {c.name for c in delta.changed_coordinates}
        assert names == {"fixed", "per_entity"}
        ddir = str(tmp_path / "delta")
        write_delta(delta, ddir)
        patched = apply_delta(workload.model, read_delta(ddir))
        _assert_bitwise_equal(patched, target.model)
        # The base was never mutated (apply builds new objects).
        assert "brand_new" not in workload.model.models[
            "per_entity"
        ].coefficients

    def test_diff_model_dirs_uses_fingerprints(self, tmp_path, workload):
        target = _perturbed()
        d1, d2 = str(tmp_path / "v1"), str(tmp_path / "v2")
        save_game_model(workload.model, workload.index_maps, d1)
        save_game_model(target.model, target.index_maps, d2)
        delta = diff_model_dirs(d1, d2, event_wall_epoch=5.0)
        assert delta.event_wall_epoch == 5.0
        base, _ = ScoringRuntime.load_model(d1, device="cpu")
        want, _ = ScoringRuntime.load_model(d2, device="cpu")
        ddir = str(tmp_path / "delta")
        write_delta(delta, ddir)
        _assert_bitwise_equal(apply_delta(base, read_delta(ddir)), want)

    def test_glm_avro_bitwise(self, tmp_path):
        imap = IndexMap.build(
            [feature_key(f"f{j}", "") for j in range(6)]
        )
        m1 = GeneralizedLinearModel(
            Coefficients(means=torch.from_numpy(
                np.arange(1, 7, dtype=np.float32) * np.float32(0.3))),
            "logistic",
        )
        m2 = GeneralizedLinearModel(
            Coefficients(means=m1.coefficients.means + np.float32(0.5)),
            "logistic",
        )
        p1, p2 = str(tmp_path / "m1.avro"), str(tmp_path / "m2.avro")
        model_store.save_glm_model(m1, imap, p1)
        model_store.save_glm_model(m2, imap, p2)
        delta = diff_model_dirs(p1, p2)
        ddir = str(tmp_path / "delta")
        write_delta(delta, ddir)
        base, _ = ScoringRuntime.load_model(p1, device="cpu")
        want, _ = ScoringRuntime.load_model(p2, device="cpu")
        patched = apply_delta(base, read_delta(ddir))
        _assert_bitwise_equal(patched, want)

    def test_identical_models_make_empty_delta(self, workload):
        w2 = SyntheticWorkload(n_entities=32, seed=7)
        delta = diff_game_models(workload.model, w2.model)
        assert delta.empty and delta.n_changed_rows == 0

    def test_structural_change_refused(self, workload):
        re = workload.model.models["per_entity"]
        other = GameModel(
            models={
                "fixed": workload.model.models["fixed"],
                "renamed": re,
            },
            task=workload.model.task,
        )
        with pytest.raises(DeltaError, match="coordinate"):
            diff_game_models(workload.model, other)


class TestArtifactIntegrity:
    def _delta_dir(self, tmp_path, workload) -> str:
        ddir = str(tmp_path / "delta")
        write_delta(
            diff_game_models(workload.model, _perturbed().model), ddir
        )
        return ddir

    def test_flipped_segment_byte_refused(self, tmp_path, workload):
        ddir = self._delta_dir(tmp_path, workload)
        seg = next(
            os.path.join(ddir, f) for f in os.listdir(ddir)
            if f.startswith("segment-")
        )
        with open(seg, "r+b") as f:
            f.seek(-8, os.SEEK_END)
            byte = f.read(1)
            f.seek(-8, os.SEEK_END)
            f.write(bytes([byte[0] ^ 0xFF]))
        with pytest.raises(DeltaFormatError, match=os.path.basename(seg)):
            read_delta(ddir)

    def test_truncated_manifest_refused(self, tmp_path, workload):
        ddir = self._delta_dir(tmp_path, workload)
        manifest = os.path.join(ddir, "delta.json")
        with open(manifest, "r+") as f:
            f.truncate(os.path.getsize(manifest) // 2)
        with pytest.raises(DeltaFormatError):
            read_delta(ddir)

    def test_edited_manifest_refused(self, tmp_path, workload):
        ddir = self._delta_dir(tmp_path, workload)
        manifest = os.path.join(ddir, "delta.json")
        with open(manifest) as f:
            body = json.load(f)
        body["task"] = "poisson"
        with open(manifest, "w") as f:
            json.dump(body, f)
        with pytest.raises(DeltaFormatError, match="digest"):
            read_delta(ddir)

    def test_wrong_base_refused_before_patching(self, tmp_path, workload):
        ddir = self._delta_dir(tmp_path, workload)
        stranger = SyntheticWorkload(n_entities=32, seed=9)
        before = model_table_checksums(stranger.model)
        with pytest.raises(DeltaBaseMismatchError, match="DIFFERENT base"):
            apply_delta(stranger.model, read_delta(ddir))
        assert model_table_checksums(stranger.model) == before


class TestPublisher:
    def _delta(self, workload):
        return diff_game_models(
            workload.model, _perturbed().model, event_wall_epoch=42.0
        )

    def test_publish_and_read_back(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]):
            with DeltaPublisher(root) as pub:
                p = pub.publish(self._delta(workload))
                assert p.seq == 1 and p.event_wall_epoch == 42.0
                assert pub.publications() == [p]
        # Read-only subscriber view agrees without touching the journal.
        assert read_publications(root) == [p]
        patched = apply_delta(workload.model, read_delta(p.path))
        _assert_bitwise_equal(patched, _perturbed().model)

    def test_crash_at_every_chaos_boundary_resumes(
        self, tmp_path, workload
    ):
        # Occurrences 0/1/2 of publish.delta bracket journal-begin,
        # artifact staging, and the commit record.  A kill at each must
        # resume to a settled root: completed iff the rename happened.
        for at, settled_as in ((0, "abort"), (1, "abort"), (2, "commit")):
            root = str(tmp_path / f"pubs{at}")
            with telemetry.Telemetry(sinks=[]):
                plan = chaos.FaultPlan([
                    chaos.FaultSpec(site="publish.delta", at=at),
                ])
                pub = DeltaPublisher(root)
                with plan:
                    with pytest.raises(Exception, match="chaos-injected"):
                        pub.publish(self._delta(workload))
                pub.close()
                resumed = DeltaPublisher(root)
                records = resumed._read()
                assert records[-1]["kind"] == settled_as, f"at={at}"
                assert records[-1]["resumed"] is True
                pubs = resumed.publications()
                if settled_as == "commit":
                    assert len(pubs) == 1
                    patched = apply_delta(
                        workload.model, read_delta(pubs[0].path)
                    )
                    _assert_bitwise_equal(patched, _perturbed().model)
                else:
                    assert pubs == []
                    assert not any(
                        f.endswith(".staging")
                        for f in os.listdir(root)
                    )
                # The sequence is claimed either way; publishing again
                # continues past it.
                p2 = resumed.publish(self._delta(workload))
                assert p2.seq == 2
                resumed.close()

    def test_abort_after_journal_record_sweep(self, tmp_path, workload):
        # The tuning/state.py-style abort hook kills the append itself:
        # abort_after=0 dies before `begin`, =1 dies on `commit` (the
        # artifact is already renamed, so resume must COMPLETE it).
        for abort_after, n_pubs in ((0, 0), (1, 1)):
            root = str(tmp_path / f"abort{abort_after}")
            with telemetry.Telemetry(sinks=[]):
                pub = DeltaPublisher(root, abort_after=abort_after)
                with pytest.raises(PublishAborted):
                    pub.publish(self._delta(workload))
                pub.close()
                resumed = DeltaPublisher(root)
                assert len(resumed.publications()) == n_pubs
                resumed.close()

    def test_mid_file_journal_corruption_raises(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]):
            with DeltaPublisher(root) as pub:
                pub.publish(self._delta(workload))
        journal = os.path.join(root, DeltaPublisher.JOURNAL)
        lines = open(journal).read().splitlines()
        lines[0] = lines[0][: len(lines[0]) // 2]
        with open(journal, "w") as f:
            f.write("\n".join(lines) + "\n")
        with pytest.raises(DeltaError, match="corrupt journal"):
            read_publications(root)


class TestRetention:
    def _publish_n(self, root, workload, n):
        delta = diff_game_models(
            workload.model, _perturbed().model, event_wall_epoch=42.0
        )
        pub = DeltaPublisher(root)
        for _ in range(n):
            pub.publish(delta)
        return pub

    def test_keep_last_boundaries(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]) as tel:
            pub = self._publish_n(root, workload, 5)
            # keep_last == count: nothing to prune.
            assert pub.retain(5) == {
                "pruned": [], "blocked": [], "blocking": {},
                "kept": [1, 2, 3, 4, 5],
            }
            # keep the newest 3.
            s = pub.retain(3)
            assert s["pruned"] == [1, 2] and s["kept"] == [3, 4, 5]
            assert [p.seq for p in pub.publications()] == [3, 4, 5]
            assert not os.path.isdir(os.path.join(root, "delta-000001"))
            assert os.path.isdir(os.path.join(root, "delta-000003"))
            # keep_last=1: everything but the newest goes; the newest
            # commit itself is NEVER prunable (keep_last >= 1 enforced).
            s = pub.retain(1)
            assert s["pruned"] == [3, 4] and s["kept"] == [5]
            with pytest.raises(ValueError, match="newest"):
                pub.retain(0)
            with pytest.raises(ValueError, match="newest"):
                DeltaPublisher(str(tmp_path / "x"), retain_last=0)
            # Sequence numbering survives compaction…
            p6 = pub.publish(diff_game_models(
                workload.model, _perturbed().model
            ))
            assert p6.seq == 6
            pub.close()
            # …and a reopened publisher continues the same sequence.
            pub2 = DeltaPublisher(root)
            assert pub2._next_seq == 7
            assert [p.seq for p in read_publications(root)] == [5, 6]
            pub2.close()
            snap = tel.snapshot()
        assert snap["counters"]["freshness_retention_pruned_total"] == 4

    def test_unsettled_begin_survives_retention(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]):
            pub = self._publish_n(root, workload, 2)
            # Simulate an in-flight publish: begin journaled, no settle.
            with pub._lock:
                pub._append({
                    "kind": "begin", "seq": 3,
                    "publish_wall_epoch": 1.0,
                })
            s = pub.retain(1)
            assert s["pruned"] == [1] and s["kept"] == [2]
            kinds = {(r["kind"], r["seq"]) for r in pub._read()}
            assert ("begin", 3) in kinds  # in-flight claim preserved
            assert ("commit", 1) not in kinds
            pub.close()
            # The next constructor settles seq 3 as an abort, and the
            # claimed sequence stays burned.
            resumed = DeltaPublisher(root)
            assert resumed._next_seq == 4
            assert [p.seq for p in resumed.publications()] == [2]
            resumed.close()

    def test_crash_between_compaction_and_artifact_removal(
        self, tmp_path, workload, monkeypatch
    ):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]):
            pub = self._publish_n(root, workload, 3)
            import photon_ml_tpu.freshness.publisher as publisher_mod

            real_rmtree = publisher_mod.shutil.rmtree
            calls = []

            def dying_rmtree(path, **kwargs):
                calls.append(path)
                raise OSError("chaos: killed before artifact removal")

            monkeypatch.setattr(
                publisher_mod.shutil, "rmtree", dying_rmtree
            )
            with pytest.raises(OSError, match="chaos"):
                pub.retain(1)
            monkeypatch.setattr(
                publisher_mod.shutil, "rmtree", real_rmtree
            )
            # The journal compacted BEFORE the crash: subscribers
            # already see only the kept publication; the pruned
            # artifact dirs are orphans on disk.
            assert [p.seq for p in read_publications(root)] == [3]
            assert os.path.isdir(os.path.join(root, "delta-000001"))
            # The next retention sweeps the orphans even with nothing
            # newly prunable.
            s = pub.retain(1)
            assert s["pruned"] == [] and s["kept"] == [3]
            assert not os.path.isdir(os.path.join(root, "delta-000001"))
            assert not os.path.isdir(os.path.join(root, "delta-000002"))
            assert os.path.isdir(os.path.join(root, "delta-000003"))
            pub.close()

    def test_acks_block_and_release_pruning(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        with telemetry.Telemetry(sinks=[]):
            pub = self._publish_n(root, workload, 4)
            write_ack(root, "replica-a", 2)
            write_ack(root, "replica-b", 4)
            assert read_acks(root) == {"replica-a": 2, "replica-b": 4}
            # The SLOWEST ack gates: 3 is prunable by age but unacked.
            s = pub.retain(1)
            assert s["pruned"] == [1, 2] and s["blocked"] == [3]
            assert [p.seq for p in pub.publications()] == [3, 4]
            write_ack(root, "replica-a", 4)
            s = pub.retain(1)
            assert s["pruned"] == [3] and s["blocked"] == []
            assert [p.seq for p in pub.publications()] == [4]
            pub.close()

    def test_retain_last_prunes_on_publish(self, tmp_path, workload):
        root = str(tmp_path / "pubs")
        delta = diff_game_models(workload.model, _perturbed().model)
        with telemetry.Telemetry(sinks=[]):
            with DeltaPublisher(root, retain_last=2) as pub:
                for _ in range(5):
                    pub.publish(delta)
                assert [p.seq for p in pub.publications()] == [4, 5]

    def test_ack_hygiene(self, tmp_path):
        root = str(tmp_path / "pubs")
        os.makedirs(root)
        with pytest.raises(ValueError, match="safe filename"):
            write_ack(root, "../escape", 1)
        write_ack(root, "ok", 7)
        # Garbage in acks/ is skipped, never fatal (ack writes are
        # atomic, so torn files are not ours).
        with open(os.path.join(root, "acks", "junk.json"), "w") as f:
            f.write("{not json")
        assert read_acks(root) == {"ok": 7}


class TestApplierAcks:
    def test_applier_registers_and_advances_ack(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]):
            root = str(tmp_path / "pubs")
            middle = _perturbed()
            keeper = DeltaPublisher(root)
            keeper.publish(diff_game_models(
                workload.model, middle.model, event_wall_epoch=1.0
            ))
            keeper.publish(diff_game_models(
                middle.model, workload.model, event_wall_epoch=2.0
            ))
            service = ScoringService(_runtime(workload))
            applier = DeltaApplier(
                service, root, subscriber_id="replica_0"
            )
            # Registration at construction pins the whole root…
            assert read_acks(root) == {"replica_0": 0}
            s = keeper.retain(1)
            assert s["pruned"] == [] and s["blocked"] == [1]
            with service:
                applier.poll_once()
            assert applier.stats()["subscriber_id"] == "replica_0"
            # …and the ack follows the applied high-water mark, which
            # releases the consumed publication for pruning.
            assert read_acks(root) == {"replica_0": 2}
            s = keeper.retain(1)
            assert s["pruned"] == [1] and s["blocked"] == []
            keeper.close()

    def test_failed_applies_are_acked(self, tmp_path, workload):
        # Failed sequences are never retried, so the applier acks past
        # them — otherwise one poisoned delta would pin the root forever.
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            stranger = SyntheticWorkload(n_entities=32, seed=9)
            service = ScoringService(_runtime(stranger))
            applier = DeltaApplier(service, root, subscriber_id="sub")
            with service:
                applier.poll_once()
            assert applier.failed == [p.seq]
            assert read_acks(root) == {"sub": p.seq}


def _runtime(workload, **kwargs):
    cfg = RuntimeConfig(
        **{"max_batch_size": 8, "hot_entities": 8, "device": "cpu",
           **kwargs}
    )
    return ScoringRuntime(workload.model, workload.index_maps, cfg)


def _publish_one(tmp_path, workload):
    root = str(tmp_path / "pubs")
    with DeltaPublisher(root) as pub:
        p = pub.publish(diff_game_models(
            workload.model, _perturbed().model, event_wall_epoch=1.0
        ))
    return root, p


class TestSwapDelta:
    def test_in_process_apply_parity_and_rollback(
        self, tmp_path, workload
    ):
        target = _perturbed()
        requests = [workload.request(i) for i in range(8)]
        want = np.asarray(
            [
                _runtime(target)
                .score_rows([_runtime(target).parse_request(r)])[0][0]
                for r in requests
            ],
            np.float32,
        )
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            service = ScoringService(_runtime(workload))
            with service:
                before = service.batcher.runtime
                result = service.reload(p.path, mode="delta")
                assert result.status == "swapped", result
                assert service.swapper.version == 2
                after = service.batcher.runtime
                # Warm ladder shared by geometry: no warm-up launches.
                assert after._warm == before._warm
                assert after.warmup_compiles == 0
                got = np.asarray(
                    [
                        np.float32(service.score(r)["score"])
                        for r in requests
                    ],
                    np.float32,
                )
                assert got.tobytes() == want.tobytes()
                rb = service.reload(rollback=True)
                assert rb.status == "swapped" or rb.version_after == 1
                assert service.swapper.version == 1
                assert service.batcher.runtime is before

    def test_distinct_equal_base_objects_apply(self, tmp_path, workload):
        # Factory-restarted replicas hold different (bitwise-equal)
        # model objects; the delta still applies to every one.
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            v1_dir = str(tmp_path / "v1")
            save_game_model(workload.model, workload.index_maps, v1_dir)
            cfg = RuntimeConfig(max_batch_size=8, hot_entities=8,
                                device="cpu")
            supervisor = ReplicaSupervisor(
                lambda: ScoringRuntime.load(v1_dir, cfg), n_replicas=2,
                probe_interval_s=3600.0,
            )
            service = ScoringService(supervisor, BatcherConfig(
                max_batch_size=8, max_wait_us=1_000, max_queue=64,
            ))
            with service:
                models = {
                    id(r.batcher.runtime.model)
                    for r in supervisor.replicas
                }
                assert len(models) == 2  # genuinely distinct objects
                result = service.reload(p.path, mode="delta")
                assert result.status == "swapped", result
                want = model_table_checksums(_perturbed().model)
                for rep in supervisor.replicas:
                    assert model_table_checksums(
                        rep.batcher.runtime.model
                    ) == want

    def test_diverged_base_rolls_back(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            stranger = SyntheticWorkload(n_entities=32, seed=9)
            service = ScoringService(_runtime(stranger))
            with service:
                result = service.reload(p.path, mode="delta")
                assert result.status == "rolled_back"
                assert "base" in result.reason
                assert service.swapper.version == 1

    def test_tampered_artifact_rolls_back(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            seg = next(
                os.path.join(p.path, f) for f in os.listdir(p.path)
                if f.startswith("segment-")
            )
            with open(seg, "r+b") as f:
                f.seek(-8, os.SEEK_END)
                byte = f.read(1)
                f.seek(-8, os.SEEK_END)
                f.write(bytes([byte[0] ^ 0xFF]))
            service = ScoringService(_runtime(workload))
            with service:
                result = service.reload(p.path, mode="delta")
                assert result.status == "rolled_back"
                assert result.stage == "load"
                assert service.swapper.version == 1

    def test_chaos_verify_failure_restores(self, tmp_path, workload):
        requests = [workload.request(i) for i in range(4)]
        ref = np.asarray(
            [
                _runtime(workload)
                .score_rows([_runtime(workload).parse_request(r)])[0][0]
                for r in requests
            ],
            np.float32,
        )
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            service = ScoringService(_runtime(workload))
            plan = chaos.FaultPlan([
                chaos.FaultSpec(site="publish.apply", at=2),
            ])
            with service:
                with plan:
                    result = service.reload(p.path, mode="delta")
                assert result.status == "rolled_back"
                assert result.stage == "verify"
                assert service.swapper.version == 1
                got = np.asarray(
                    [
                        np.float32(service.score(r)["score"])
                        for r in requests
                    ],
                    np.float32,
                )
                assert got.tobytes() == ref.tobytes()

    def test_unknown_reload_mode_raises(self, workload):
        with telemetry.Telemetry(sinks=[]):
            service = ScoringService(_runtime(workload))
            with service:
                with pytest.raises(ValueError, match="mode"):
                    service.reload("/nowhere", mode="sideways")


class TestApplier:
    def test_poll_applies_in_order_and_skips_failed(
        self, tmp_path, workload
    ):
        with telemetry.Telemetry(sinks=[]) as tel:
            root = str(tmp_path / "pubs")
            middle = _perturbed()
            final = _perturbed()
            re = final.model.models["per_entity"]
            cols, vals = re.coefficients["u0"]
            re.coefficients["u0"] = (
                cols, (vals + np.float32(1.0)).astype(np.float32)
            )
            with DeltaPublisher(root) as pub:
                p1 = pub.publish(diff_game_models(
                    workload.model, middle.model, event_wall_epoch=1.0
                ))
                p2 = pub.publish(diff_game_models(
                    middle.model, final.model, event_wall_epoch=2.0
                ))
            service = ScoringService(_runtime(workload))
            applier = DeltaApplier(service, root)
            with service:
                results = applier.poll_once()
                assert [r.status for r in results] == [
                    "swapped", "swapped"
                ]
                assert applier.applied == 2 and not applier.failed
                assert service.swapper.version == 3
                assert model_table_checksums(
                    service.batcher.runtime.model
                ) == model_table_checksums(final.model)
                # Nothing pending; a second poll is a no-op.
                assert applier.poll_once() == []
            snap = tel.snapshot()
        assert snap["counters"]["freshness_deltas_applied_total"] == 2
        assert (
            snap["histograms"]["freshness_event_to_servable_seconds"][
                "count"
            ] == 2
        )
        assert snap["gauges"]["freshness_model_age_seconds"] >= 0.0

    def test_failed_apply_recorded_not_retried(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]) as tel:
            root, p = _publish_one(tmp_path, workload)
            stranger = SyntheticWorkload(n_entities=32, seed=9)
            service = ScoringService(_runtime(stranger))
            applier = DeltaApplier(service, root)
            with service:
                results = applier.poll_once()
                assert [r.status for r in results] == ["rolled_back"]
                assert applier.failed == [p.seq]
                assert applier.poll_once() == []  # no retry storm
            snap = tel.snapshot()
        assert snap["counters"]["freshness_apply_failures_total"] == 1

    def test_background_thread_lifecycle(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]):
            root, p = _publish_one(tmp_path, workload)
            service = ScoringService(_runtime(workload))
            with service:
                applier = DeltaApplier(
                    service, root, poll_interval_s=0.01
                )
                with applier:
                    deadline = 100
                    while applier.applied < 1 and deadline:
                        deadline -= 1
                        threading.Event().wait(0.05)
                assert applier.applied == 1
                assert service.swapper.version == 2


class TestOnlineRefiner:
    def _events(self, workload, n=30, seed=5):
        rng = np.random.default_rng(seed)
        return [
            LabeledEvent(
                features={
                    workload.fixed_shard: rng.normal(
                        size=workload.fixed_dim
                    ).astype(np.float32),
                    workload.re_shard: rng.normal(
                        size=workload.re_dim
                    ).astype(np.float32),
                },
                ids={workload.entity_key: f"u{rng.integers(6)}"},
                label=float(rng.integers(2)),
                wall_epoch=float(10 + rng.integers(5)),
            )
            for _ in range(n)
        ]

    def test_deterministic_and_touch_scoped(self, workload):
        with telemetry.Telemetry(sinks=[]):
            events = self._events(workload)
            a = OnlineRefiner(workload.model, RefinerConfig(seed=1))
            b = OnlineRefiner(workload.model, RefinerConfig(seed=1))
            a.consume(events)
            b.consume(events)
            ra, rb = a.refined_model(), b.refined_model()
            assert model_table_checksums(ra) == model_table_checksums(rb)
            touched = set(a.touched["per_entity"])
            assert touched  # events reached entities
            base_re = workload.model.models["per_entity"]
            out_re = ra.models["per_entity"]
            for k, pair in base_re.coefficients.items():
                if k not in touched:
                    # Untouched rows share the base arrays outright.
                    assert out_re.coefficients[k] is pair
            assert a.latest_event_wall == max(
                e.wall_epoch for e in events
            )

    def test_delta_roundtrips_through_publish(self, tmp_path, workload):
        with telemetry.Telemetry(sinks=[]):
            ref = OnlineRefiner(workload.model, RefinerConfig(seed=2))
            ref.consume(self._events(workload))
            with DeltaPublisher(str(tmp_path / "pubs")) as pub:
                p = ref.publish(pub)
            patched = apply_delta(workload.model, read_delta(p.path))
            _assert_bitwise_equal(patched, ref.refined_model())
            assert p.event_wall_epoch == ref.latest_event_wall

    def test_sgd_moves_toward_labels(self, workload):
        # A LEARNABLE signal (one entity, one repeated feature vector,
        # fixed label): each step must shrink the error on that event.
        with telemetry.Telemetry(sinks=[]):
            cfg = RefinerConfig(algorithm="sgd", learning_rate=0.5)
            ref = OnlineRefiner(workload.model, cfg)
            rng = np.random.default_rng(3)
            event = LabeledEvent(
                features={
                    workload.fixed_shard: rng.normal(
                        size=workload.fixed_dim
                    ).astype(np.float32),
                    workload.re_shard: rng.normal(
                        size=workload.re_dim
                    ).astype(np.float32),
                },
                ids={workload.entity_key: "u0"},
                label=1.0,
            )
            errs = ref.consume([event] * 30)
            assert abs(errs[-1]) < abs(errs[0])
            assert abs(errs[-1]) < 0.1  # converged onto the label

    def test_chaos_site_fires(self, workload):
        with telemetry.Telemetry(sinks=[]):
            ref = OnlineRefiner(workload.model)
            plan = chaos.FaultPlan([
                chaos.FaultSpec(site="online.step", at=0),
            ])
            with plan:
                with pytest.raises(Exception, match="chaos-injected"):
                    ref.step(self._events(workload, n=1)[0])
            assert [f["site"] for f in plan.fired] == ["online.step"]

    def test_unknown_algorithm_refused(self, workload):
        with pytest.raises(ValueError, match="algorithm"):
            OnlineRefiner(
                workload.model, RefinerConfig(algorithm="newton")
            )


class TestReadFingerprints:
    def test_game_store_roundtrip(self, tmp_path, workload):
        d = str(tmp_path / "m")
        save_game_model(workload.model, workload.index_maps, d)
        fps = game_store.read_fingerprints(d)
        assert set(fps) == {"fixed", "per_entity"}

    def test_game_store_legacy_pointed_error(self, tmp_path, workload):
        d = str(tmp_path / "m")
        save_game_model(workload.model, workload.index_maps, d)
        meta = os.path.join(d, "metadata.json")
        with open(meta) as f:
            body = json.load(f)
        body.pop("fingerprints", None)
        with open(meta, "w") as f:
            json.dump(body, f)
        with pytest.raises(ValueError, match="re-save"):
            game_store.read_fingerprints(d)

    def test_model_store_roundtrip_and_legacy(self, tmp_path):
        imap = IndexMap.build([feature_key("f0", "")])
        glm = GeneralizedLinearModel(
            Coefficients(means=torch.tensor([1.0])), "logistic"
        )
        p = str(tmp_path / "m.avro")
        model_store.save_glm_model(glm, imap, p)
        assert model_store.read_fingerprints(p)
        os.remove(p + ".meta.json")
        with pytest.raises(ValueError, match="re-save"):
            model_store.read_fingerprints(p)


# ---------------------------------------------------------------------------
# Across the packages
# ---------------------------------------------------------------------------

def _ref_perturbed():
    """The reference's copy of :func:`_perturbed` (the same draws)."""
    from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefW

    w = RefW(n_entities=32, seed=7)
    re = w.model.models["per_entity"]
    for k in [f"u{i}" for i in range(5)]:
        cols, vals = re.coefficients[k]
        re.coefficients[k] = (cols,
                              (vals + np.float32(0.25)).astype(np.float32))
    re.coefficients["brand_new"] = (np.arange(w.re_dim, dtype=np.int32),
                                    np.full(w.re_dim, 0.5, np.float32))
    del re.coefficients["u31"]
    fixed = w.model.models["fixed"].model
    fixed.coefficients.means = (
        np.asarray(fixed.coefficients.means, np.float32) + np.float32(0.125))
    return w


class TestAcrossPackages:
    def test_table_checksums_equal_the_references(self, workload):
        from photon_ml_tpu.freshness import delta as ref_delta

        assert model_table_checksums(_perturbed().model) == \
            ref_delta.model_table_checksums(_ref_perturbed().model)
        from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefW

        assert model_table_checksums(workload.model) == \
            ref_delta.model_table_checksums(RefW(n_entities=32,
                                                 seed=7).model)

    def test_delta_directories_byte_equal(self, tmp_path, workload,
                                          monkeypatch):
        """Both packages write the same files, byte for byte (the npz
        members' zip timestamps pinned to one instant)."""
        import time as time_mod

        from photon_ml_tpu.freshness import delta as ref_delta
        from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefW

        monkeypatch.setattr(time_mod, "time", lambda: 1.7e9)
        mine, theirs = str(tmp_path / "port"), str(tmp_path / "ref")
        write_delta(diff_game_models(workload.model, _perturbed().model,
                                     event_wall_epoch=3.0), mine)
        ref_delta.write_delta(ref_delta.diff_game_models(
            RefW(n_entities=32, seed=7).model, _ref_perturbed().model,
            event_wall_epoch=3.0), theirs)
        assert sorted(os.listdir(mine)) == sorted(os.listdir(theirs))
        for name in os.listdir(mine):
            with open(os.path.join(mine, name), "rb") as a, \
                    open(os.path.join(theirs, name), "rb") as b:
                assert a.read() == b.read(), name

    def test_each_package_reads_and_applies_the_others(self, tmp_path,
                                                       workload):
        from photon_ml_tpu.freshness import delta as ref_delta
        from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefW

        ref_base = RefW(n_entities=32, seed=7).model
        theirs, mine = str(tmp_path / "ref"), str(tmp_path / "port")
        ref_delta.write_delta(ref_delta.diff_game_models(
            ref_base, _ref_perturbed().model), theirs)
        write_delta(diff_game_models(workload.model, _perturbed().model),
                    mine)
        want = model_table_checksums(_perturbed().model)
        patched = apply_delta(workload.model, read_delta(theirs))
        _assert_bitwise_equal(patched, _perturbed().model)
        ref_patched = ref_delta.apply_delta(ref_base,
                                            ref_delta.read_delta(mine))
        assert ref_delta.model_table_checksums(ref_patched) == want
        assert read_delta(theirs).n_changed_rows == \
            ref_delta.read_delta(mine).n_changed_rows == 8

    def test_diff_of_reference_saved_dirs(self, tmp_path, workload):
        """The reference's stores write both endpoints; the port diffs
        them through its fingerprints and patches the base bitwise."""
        from photon_ml_tpu.io.game_store import save_game_model as ref_save
        from photon_ml_tpu.serving.synthetic import SyntheticWorkload as RefW

        d1, d2 = str(tmp_path / "v1"), str(tmp_path / "v2")
        ref_w = RefW(n_entities=32, seed=7)
        ref_save(ref_w.model, ref_w.index_maps, d1)
        target = _ref_perturbed()
        ref_save(target.model, target.index_maps, d2)
        assert game_store.read_fingerprints(d1).keys() == \
            {"fixed", "per_entity"}
        delta = diff_model_dirs(d1, d2)
        base, _ = ScoringRuntime.load_model(d1, device="cpu")
        want, _ = ScoringRuntime.load_model(d2, device="cpu")
        _assert_bitwise_equal(apply_delta(base, delta), want)


def test_freshness_selfcheck_passes(tmp_path):
    """The whole train->serve loop on the CPU: online refinement, a delta
    published and applied under the ``freshness`` scenario's load over a
    2-replica supervisor, bitwise a full reload, then rolled back."""
    from photon_ml_tpu_torch.freshness.__main__ import run_selfcheck

    assert run_selfcheck(str(tmp_path), device="cpu") == []
