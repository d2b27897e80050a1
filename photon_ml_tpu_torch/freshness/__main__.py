"""Freshness CLI: the continuous train→serve loop selfcheck (port of
``photon_ml_tpu/freshness/__main__.py``).

::

    python -m photon_ml_tpu_torch.freshness --selfcheck --device cpu

runs the WHOLE loop, end to end, on the given device (the card unless
``--device cpu``):

1. "Train" v1 (the synthetic GAME workload every serving selfcheck
   uses) and bring it up on a live 2-replica supervised service.
2. Simulate CONCEPT DRIFT: labeled events whose labels come from a
   drifted ground-truth model, not the serving one.
3. Online-refine the touched entities from those events
   (:class:`~photon_ml_tpu_torch.freshness.online.OnlineRefiner`).
4. Delta-publish the refinement crash-safely
   (:class:`~photon_ml_tpu_torch.freshness.publisher.DeltaPublisher`) and
   hot-apply it through the subscribe side
   (:class:`~photon_ml_tpu_torch.freshness.applier.DeltaApplier`) — both
   firing MID-PHASE of the ``freshness`` loadgen scenario, while
   open-loop traffic flows.

And asserts the contracts that make the loop trustworthy:

- ZERO failed requests across the whole scenario (publish and apply
  are invisible to traffic);
- the delta-patched serving tables are BITWISE-IDENTICAL to a full
  save→load of the refined model (delta apply is a pure optimization,
  never a divergence);
- one-step rollback restores the pre-delta version, bitwise;
- ``freshness_event_to_servable_seconds`` (the freshness SLO) landed
  in metrics.json.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

import numpy as np


def _drift_events(serving, truth, n_events: int, seed: int, now_wall: float):
    """Labeled events over the FIRST slice of the entity space, labels
    drawn from the drifted ``truth`` model's mean response — what a real
    click log would say after the world moved under the serving model."""
    from photon_ml_tpu_torch.device import to_numpy
    from photon_ml_tpu_torch.freshness.online import LabeledEvent
    from photon_ml_tpu_torch.serving.runtime import _host_mean

    rng = np.random.default_rng(seed)
    truth_re = truth.model.models["per_entity"]
    truth_fixed = to_numpy(
        truth.model.models["fixed"].model.coefficients.means
    ).astype(np.float32)
    events = []
    for _ in range(n_events):
        entity = f"u{rng.integers(max(8, serving.n_entities // 8))}"
        xf = rng.normal(size=serving.fixed_dim).astype(np.float32)
        xr = rng.normal(size=serving.re_dim).astype(np.float32)
        row = np.zeros(serving.re_dim, np.float32)
        pair = truth_re.coefficients.get(entity)
        if pair is not None:
            cols, vals = pair
            row[np.asarray(cols, np.int64)] = vals
        margin = float(np.dot(truth_fixed, xf) + np.dot(row, xr))
        label = float(
            _host_mean(truth.model.task, np.array([margin], np.float32))[0]
        )
        events.append(LabeledEvent(
            features={serving.fixed_shard: xf, serving.re_shard: xr},
            ids={serving.entity_key: entity},
            label=label,
            wall_epoch=now_wall,
        ))
    return events


def run_selfcheck(out_dir: str, device=None) -> list[str]:
    """The end-to-end freshness pass.  Returns failure strings."""
    import time

    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.freshness.applier import DeltaApplier
    from photon_ml_tpu_torch.freshness.delta import model_table_checksums
    from photon_ml_tpu_torch.freshness.online import OnlineRefiner, RefinerConfig
    from photon_ml_tpu_torch.freshness.publisher import DeltaPublisher
    from photon_ml_tpu_torch.io.game_store import save_game_model
    from photon_ml_tpu_torch.serving import loadgen
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.supervisor import ReplicaSupervisor
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    failures: list[str] = []
    serving_w = SyntheticWorkload(n_entities=64, seed=3)
    truth_w = SyntheticWorkload(n_entities=64, seed=4)  # the drifted world
    v1_dir = os.path.join(out_dir, "models", "v1")
    refined_dir = os.path.join(out_dir, "models", "refined")
    save_game_model(serving_w.model, serving_w.index_maps, v1_dir)

    rt_cfg = RuntimeConfig(max_batch_size=8, hot_entities=16, device=device)

    def factory() -> ScoringRuntime:
        return ScoringRuntime.load(v1_dir, rt_cfg)

    def make_request(i: int, phase) -> dict:
        req = serving_w.request(i)
        if phase.entity_pool is not None:
            lo, hi = phase.entity_pool
            span = max(1, int((hi - lo) * serving_w.n_entities))
            req["ids"][serving_w.entity_key] = (
                f"u{int(lo * serving_w.n_entities) + i % span}"
            )
        return req

    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="freshness-selfcheck"
    ) as tel:
        base_model, _ = ScoringRuntime.load_model(v1_dir, device=device)
        refiner = OnlineRefiner(base_model, RefinerConfig(seed=7))
        event_wall = time.time()
        events = _drift_events(
            serving_w, truth_w, n_events=60, seed=11, now_wall=event_wall
        )
        publisher = DeltaPublisher(os.path.join(out_dir, "publications"))
        supervisor = ReplicaSupervisor(
            factory, n_replicas=2, probe_interval_s=0.1
        )
        service = ScoringService(supervisor, BatcherConfig(
            max_batch_size=8, max_wait_us=2_000, max_queue=256,
        ))
        applier = DeltaApplier(service, publisher.root)
        with service:
            def publish_delta() -> dict:
                refiner.consume(events)
                pub = refiner.publish(publisher)
                return {"seq": pub.seq, "rows": pub.n_changed_rows}

            def apply_delta_action() -> dict:
                results = applier.poll_once()
                return {
                    "applied": [r.status for r in results],
                    "version": service.swapper.version,
                }

            report = loadgen.run_scenario(
                service.submit, make_request,
                loadgen.SCENARIOS["freshness"],
                base_rate_rps=120.0,
                actions={
                    "publish_delta": publish_delta,
                    "apply_delta": apply_delta_action,
                },
            )
            if report.errors or report.rejected:
                failures.append(
                    f"freshness scenario saw {report.errors} errors and "
                    f"{report.rejected} rejections (expected 0/0) across "
                    f"{report.completed} requests"
                )
            if report.completed < 100:
                failures.append(
                    f"freshness scenario completed only "
                    f"{report.completed} requests; the pass did not "
                    "exercise the path"
                )
            for key in ("publish_delta", "apply_delta"):
                if not isinstance(report.actions.get(key), dict):
                    failures.append(
                        f"scenario action {key} did not run cleanly: "
                        f"{report.actions.get(key)!r}"
                    )
            if applier.applied != 1 or applier.failed:
                failures.append(
                    f"applier applied={applier.applied} "
                    f"failed={applier.failed}, expected exactly one "
                    "clean apply"
                )
            if service.swapper.version != 2:
                failures.append(
                    "expected model_version 2 after the delta apply, "
                    f"got {service.swapper.version}"
                )

            # Bitwise parity against a FULL save->load of the refined
            # model: the delta path must be a pure optimization.
            save_game_model(
                refiner.refined_model(), serving_w.index_maps, refined_dir
            )
            full_model, _ = ScoringRuntime.load_model(
                refined_dir, device=device)
            want = model_table_checksums(full_model)
            for rep in supervisor.replicas:
                got = model_table_checksums(rep.batcher.runtime.model)
                if got != want:
                    failures.append(
                        f"replica {rep.rid}: delta-patched tables are "
                        "NOT bitwise-identical to a full reload of the "
                        f"refined model ({got} != {want})"
                    )
            served = supervisor.replicas[0].batcher.runtime.model
            pe_served = served.models["per_entity"].coefficients
            pe_full = full_model.models["per_entity"].coefficients
            if set(pe_served) != set(pe_full) or any(
                pe_served[k][0].tobytes() != pe_full[k][0].tobytes()
                or pe_served[k][1].tobytes() != pe_full[k][1].tobytes()
                for k in pe_full
            ):
                failures.append(
                    "per-entity coefficient arrays diverge from the "
                    "full reload (checksum collision?)"
                )

            # One-step rollback restores the pre-delta version, bitwise.
            rb = service.swapper.rollback()
            if service.swapper.version != 1:
                failures.append(
                    f"rollback -> {rb.status}, version "
                    f"{service.swapper.version} (expected 1)"
                )
            base_want = model_table_checksums(base_model)
            for rep in supervisor.replicas:
                if model_table_checksums(
                    rep.batcher.runtime.model
                ) != base_want:
                    failures.append(
                        f"replica {rep.rid}: rollback did not restore "
                        "the pre-delta tables bitwise"
                    )
        snap = tel.snapshot()

    counters = snap["counters"]
    for name, minimum in (
        ("freshness_deltas_published_total", 1),
        ("freshness_deltas_applied_total", 1),
        ("freshness_online_events_total", 1),
        ("serving_swaps_total", 1),
    ):
        if counters.get(name, 0) < minimum:
            failures.append(
                f"{name} = {counters.get(name, 0)}, expected >= {minimum}"
            )
    metrics_path = os.path.join(out_dir, "metrics.json")
    try:
        with open(metrics_path) as f:
            metrics = json.load(f)
        hist = metrics.get("histograms", {}).get(
            "freshness_event_to_servable_seconds"
        )
        if not hist or not hist.get("count"):
            failures.append(
                "freshness_event_to_servable_seconds missing/empty in "
                "metrics.json — the freshness SLO was not measured"
            )
    except (OSError, json.JSONDecodeError) as exc:
        failures.append(f"metrics.json unreadable: {exc}")
    return failures


def build_arg_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.freshness",
        description="continuous train->serve loop (delta publishing, "
        "online refinement, freshness SLOs)",
    )
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument(
        "--device", default=None,
        help="cuda (default: the card, raises without one) or cpu",
    )
    p.add_argument(
        "--output-dir",
        help="keep the selfcheck artifacts (models, publications, "
        "metrics.json) here instead of a temp dir",
    )
    return p


def main(argv=None) -> int:
    args = build_arg_parser().parse_args(argv)
    if not args.selfcheck:
        build_arg_parser().print_help()
        return 2
    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        failures = run_selfcheck(args.output_dir, args.device)
    else:
        with tempfile.TemporaryDirectory(
            prefix="photon_freshness_selfcheck_"
        ) as td:
            failures = run_selfcheck(td, args.device)
    if failures:
        print("freshness selfcheck FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("freshness selfcheck PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
