"""Chaos CLI: the scripted kill/resume/degrade selfcheck (port of
``photon_ml_tpu/chaos/__main__.py``).

::

    python -m photon_ml_tpu_torch.chaos --selfcheck [--device cpu]

runs the recovery story end to end on the card (``--device cpu`` on the
CPU), proving — not asserting — that:

1. a streamed GLM λ-grid killed at a grid-point boundary resumes through
   the watchdog and lands on coefficients BITWISE identical to an
   uninterrupted run;
2. a mid-pass streaming fault (the carry-sync seam) tears down both
   pipeline threads promptly — no deadlock, no leaked thread
   (``prefetch_thread_leak`` stays 0) — and the next clean pass is
   bit-identical to a never-faulted one (on the card the fault may land
   while a copy into a pinned slot is still in flight: the ring reuses a
   slot only after its copy event completed);
3. a GAME coordinate-descent run killed at a CD iteration boundary
   resumes from ``cd_checkpoint.npz`` bitwise identically;
4. serving under a device-lost fault.  On the CPU (the reference's
   story) the runtime degrades to host-side scoring with ZERO request
   errors, the degraded flag shows on /healthz, and the circuit breaker
   re-promotes once the fault clears.  On the card the runtime never
   degrades (a CUDA fault leaves the context unusable): the faulted
   batch's requests fail with the injected device-lost error, /healthz
   reports no degraded mode, and the next batches score bitwise what a
   fresh runtime scores;
5. checkpoint hardening: a truncated newest checkpoint falls back to the
   previous verifiable one, full corruption raises a pointed
   :class:`~photon_ml_tpu_torch.io.checkpoint.CheckpointCorruptError`,
   and a kill between tmp-write and rename leaves the old checkpoint
   intact.

Each scenario prints its verdict and host seconds on a line of its own
(``chaos scenario <name>: PASS|FAIL <s> s``).  ``--list-sites`` prints
the fault-site catalog; ``--plan FILE`` validates a JSON fault plan
without running anything.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np


def _bitwise(a, b) -> bool:
    from photon_ml_tpu_torch.device import to_numpy

    a = np.asarray(to_numpy(a), np.float32)
    b = np.asarray(to_numpy(b), np.float32)
    return a.shape == b.shape and a.tobytes() == b.tobytes()


# ---------------------------------------------------------------------------
# Scenario 1+2: streamed GLM grid — kill/resume + mid-pass teardown
# ---------------------------------------------------------------------------

def _check_streamed_glm(tmp: str, failures: list[str], device) -> None:
    import scipy.sparse as sp
    import torch

    from photon_ml_tpu_torch import chaos
    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.data.streaming import make_streaming_glm_data
    from photon_ml_tpu_torch.io.checkpoint import GridCheckpointer
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        GlmOptimizationProblem,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext
    from photon_ml_tpu_torch.optim.streaming import (
        StreamingObjective,
        streaming_run_grid,
    )
    from photon_ml_tpu_torch.utils.watchdog import (
        RetryPolicy,
        RetryStats,
        run_with_retries,
    )

    rng = np.random.default_rng(7)
    n, d = 240, 12
    X = sp.random(n, d, density=0.4, random_state=3, format="csr",
                  dtype=np.float32)
    w_true = rng.normal(size=d).astype(np.float32)
    y = (np.asarray(X @ w_true).ravel() > 0).astype(np.float32)
    stream = make_streaming_glm_data(X, y, chunk_rows=60, device=device)
    problem = GlmOptimizationProblem(
        "logistic",
        GlmOptimizationConfig(
            optimizer=OptimizerConfig(max_iters=25, tolerance=1e-7),
            regularization=RegularizationContext.l2(),
        ),
    )
    sobj = StreamingObjective(problem.objective, stream)
    lams = [3.0, 1.0, 0.3]

    # Uninterrupted reference.
    full = streaming_run_grid(problem, sobj, lams)
    ref = {lam: m.coefficients.means for lam, m, _ in full}

    # Killed-and-resumed run: the fault fires at the SECOND grid-point
    # boundary (λ solved + checkpointed, next λ untouched); the watchdog
    # re-enters the closure, which reloads the checkpoint.
    ckpt = GridCheckpointer(os.path.join(tmp, "glm_ck"))
    plan = chaos.FaultPlan([chaos.FaultSpec(site="grid.point", at=1)])

    def train(attempt: int):
        solved = ckpt.load() if attempt else {}
        acc = dict(solved)

        def on_solved(lam, w):
            acc[lam] = w.detach().cpu().numpy()
            ckpt.save(acc)

        return streaming_run_grid(
            problem, sobj, lams, solved=solved, on_solved=on_solved,
        )

    stats = RetryStats()
    with plan:
        resumed = run_with_retries(
            train, RetryPolicy(max_retries=2), sleep=lambda s: None,
            stats=stats,
        )
    if not plan.fired_at("grid.point"):
        failures.append("streamed grid: the scripted kill never fired")
    if stats.retries != 1:
        failures.append(
            f"streamed grid: expected exactly 1 watchdog retry, got "
            f"{stats.retries}"
        )
    for lam, model, res in resumed:
        if not _bitwise(ref[lam], model.coefficients.means):
            failures.append(
                f"streamed grid: resumed λ={lam} coefficients are NOT "
                "bitwise identical to the uninterrupted run"
            )
    restored = sum(1 for _, _, res in resumed if res is None)
    if restored != 2:
        failures.append(
            f"streamed grid: resume restored {restored} points from the "
            "checkpoint, expected 2"
        )

    # Mid-pass teardown: a carry-sync fault aborts the pass promptly,
    # leaks no pipeline thread, and the next clean pass is bit-identical
    # to a never-faulted one.
    w0 = torch.zeros((d,), dtype=torch.float32, device=stream.device)
    v_clean, g_clean = sobj.value_and_grad(w0, 1.0)
    tel = telemetry_mod.current()
    leaks_before = tel.counter("prefetch_thread_leak").value
    midpass = chaos.FaultPlan([
        chaos.FaultSpec(site="streaming.carry_sync", at=2),
    ])
    with midpass:
        try:
            sobj.value_and_grad(w0, 1.0)
            failures.append("mid-pass fault: the scripted fault never fired")
        except chaos.InjectedFault:
            pass
    if tel.counter("prefetch_thread_leak").value != leaks_before:
        failures.append(
            "mid-pass fault: a prefetch pipeline thread leaked during "
            "teardown"
        )
    v2, g2 = sobj.value_and_grad(w0, 1.0)
    if not (_bitwise(v_clean, v2) and _bitwise(g_clean, g2)):
        failures.append(
            "mid-pass fault: the pass AFTER the fault is not bit-identical "
            "to a clean pass (corrupted accumulators?)"
        )


# ---------------------------------------------------------------------------
# Scenario 3: GAME CD — kill at an iteration boundary, resume bitwise
# ---------------------------------------------------------------------------

def _check_game_cd(tmp: str, failures: list[str], device) -> None:
    import scipy.sparse as sp

    from photon_ml_tpu_torch import chaos
    from photon_ml_tpu_torch.game.estimator import (
        FixedEffectCoordinateConfig,
        GameEstimator,
        RandomEffectCoordinateConfig,
    )
    from photon_ml_tpu_torch.io.checkpoint import CoordinateDescentCheckpointer
    from photon_ml_tpu_torch.optim.problem import (
        GlmOptimizationConfig,
        OptimizerConfig,
    )
    from photon_ml_tpu_torch.optim.regularization import RegularizationContext
    from photon_ml_tpu_torch.utils.watchdog import (
        RetryPolicy,
        RetryStats,
        run_with_retries,
    )

    rng = np.random.default_rng(13)
    n, n_users = 300, 10
    user_effect = rng.normal(scale=2.0, size=n_users)
    Xg = rng.normal(size=(n, 3)).astype(np.float32)
    users = rng.integers(n_users, size=n)
    margin = 1.3 * Xg[:, 0] - 0.7 * Xg[:, 1] + user_effect[users]
    y = (rng.uniform(size=n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    shards = {
        "global": sp.csr_matrix(Xg),
        "userFeatures": sp.csr_matrix(np.ones((n, 1), np.float32)),
    }
    ids = {"userId": np.array([f"u{u}" for u in users])}

    opt = GlmOptimizationConfig(
        optimizer=OptimizerConfig(max_iters=25, tolerance=1e-7),
        regularization=RegularizationContext.l2(),
    )

    def configs():  # fresh configs per estimator
        return {
            "fixed": FixedEffectCoordinateConfig(
                feature_shard="global", optimization=opt, reg_weight=0.5
            ),
            "per_user": RandomEffectCoordinateConfig(
                feature_shard="userFeatures", entity_key="userId",
                optimization=opt, reg_weight=0.5,
            ),
        }

    model_full, hist_full = GameEstimator(
        "logistic", configs(), n_iterations=3, device=device
    ).fit(shards, ids, y)

    ck = CoordinateDescentCheckpointer(os.path.join(tmp, "cd_ck"))
    plan = chaos.FaultPlan([chaos.FaultSpec(site="cd.iteration", at=1)])

    def attempt(a: int):
        return GameEstimator(
            "logistic", configs(), n_iterations=3, device=device
        ).fit(shards, ids, y, checkpointer=ck)

    stats = RetryStats()
    with plan:
        model_res, hist_res = run_with_retries(
            attempt, RetryPolicy(max_retries=2), sleep=lambda s: None,
            stats=stats,
        )
    if not plan.fired_at("cd.iteration"):
        failures.append("game cd: the scripted kill never fired")
    if stats.retries != 1:
        failures.append(
            f"game cd: expected exactly 1 watchdog retry, got "
            f"{stats.retries}"
        )
    if not _bitwise(
        model_full["fixed"].model.coefficients.means,
        model_res["fixed"].model.coefficients.means,
    ):
        failures.append(
            "game cd: resumed fixed-effect coefficients are NOT bitwise "
            "identical to the uninterrupted run"
        )
    cf = model_full["per_user"].coefficients
    cr = model_res["per_user"].coefficients
    if set(cf) != set(cr) or any(
        not _bitwise(cf[k][1], cr[k][1]) for k in cf
    ):
        failures.append(
            "game cd: resumed per-entity coefficients are NOT bitwise "
            "identical to the uninterrupted run"
        )
    if len(hist_res) != len(hist_full):
        failures.append(
            f"game cd: resumed history has {len(hist_res)} entries, "
            f"uninterrupted has {len(hist_full)}"
        )


# ---------------------------------------------------------------------------
# Scenario 4: serving under a device-lost fault
# ---------------------------------------------------------------------------

def _check_serving(tmp: str, failures: list[str], device) -> None:
    from photon_ml_tpu_torch import chaos
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.runtime import (
        RuntimeConfig,
        ScoringRuntime,
    )
    from photon_ml_tpu_torch.serving.service import ScoringService
    from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload

    workload = SyntheticWorkload(n_entities=32, seed=5)

    def runtime_on_device():
        return ScoringRuntime(
            workload.model, workload.index_maps,
            RuntimeConfig(max_batch_size=4, hot_entities=8,
                          breaker_cooldown_s=0.0, device=str(device)),
        )

    runtime = runtime_on_device()
    requests = [workload.request(i) for i in range(16)]
    rows = [runtime.parse_request(r) for r in requests]
    # Healthy-path reference from a FRESH runtime (its batches must not
    # consume serving.device occurrences of the plan below).
    fresh = runtime_on_device()
    reference = np.asarray(
        [fresh.score_rows([row])[0][0] for row in rows], np.float32
    )
    service = ScoringService(runtime, BatcherConfig(
        max_batch_size=4, max_wait_us=0, max_queue=64,
    ))
    card = device.type == "cuda"
    # Device lost for 4 consecutive batches (one on the card: every
    # batch there fails at the fault), then it "comes back".
    plan = chaos.FaultPlan([
        chaos.FaultSpec(
            site="serving.device", at=0, count=1 if card else 4,
            exception="InjectedDeviceLost",
        ),
    ])
    degraded_seen = False
    errors = []
    served = np.full(len(rows), np.nan, np.float32)
    with service, plan:
        for i, req in enumerate(requests):
            try:
                result = service.score(req)
            except Exception as exc:  # noqa: BLE001 — checked below
                errors.append((i, f"{type(exc).__name__}: {exc}"))
            else:
                if "error" in result:
                    errors.append((i, str(result["error"])))
                else:
                    served[i] = np.float32(result["score"])
            if service.healthz()["degraded"]:
                degraded_seen = True
    if not plan.fired_at("serving.device"):
        failures.append("serving: the scripted device fault never fired")
    if card:
        # The deliberate difference: the card runtime never degrades.
        if [i for i, _ in errors] != [0] or "InjectedDeviceLost" not in (
                errors[0][1] if errors else ""):
            failures.append(
                "serving (card): expected exactly request 0 to fail with "
                f"the injected device-lost error, got {errors}"
            )
        if degraded_seen or runtime.degraded:
            failures.append(
                "serving (card): the runtime reported DEGRADED mode; a "
                "card runtime must raise instead"
            )
        if not _bitwise(served[1:], reference[1:]):
            failures.append(
                "serving (card): the batches after the fault are not "
                "bitwise a fresh runtime's scores"
            )
        return
    if errors:
        failures.append(
            f"serving: {len(errors)} request(s) errored during the "
            "device-lost window — degraded mode must keep every request "
            f"succeeding ({errors[:2]})"
        )
    if not degraded_seen:
        failures.append("serving: the degraded flag never showed on healthz")
    if runtime.degraded or runtime.breaker.state != "closed":
        failures.append(
            f"serving: breaker did not re-promote after the fault cleared "
            f"(degraded={runtime.degraded}, breaker="
            f"{runtime.breaker.state})"
        )
    if runtime.repromotions < 1 or runtime.degraded_batches < 1:
        failures.append(
            "serving: expected >= 1 degraded batch and >= 1 re-promotion, "
            f"got {runtime.degraded_batches} / {runtime.repromotions}"
        )
    if not np.allclose(served, reference, rtol=1e-5, atol=1e-6):
        bad = int(np.argmax(~np.isclose(served, reference,
                                        rtol=1e-5, atol=1e-6)))
        failures.append(
            "serving: degraded-mode scores diverge from the healthy "
            f"reference (first bad row {bad}: {served[bad]!r} vs "
            f"{reference[bad]!r})"
        )


# ---------------------------------------------------------------------------
# Scenario 5: checkpoint hardening — torn files, fallback, mid-save kill
# ---------------------------------------------------------------------------

def _check_checkpoint_hardening(tmp: str, failures: list[str],
                                device=None) -> None:
    from photon_ml_tpu_torch import chaos
    from photon_ml_tpu_torch.io.checkpoint import (
        CheckpointCorruptError,
        GridCheckpointer,
    )

    ck = GridCheckpointer(os.path.join(tmp, "hard_ck"))
    w1 = {1.0: np.ones(4, np.float32)}
    w2 = {1.0: np.ones(4, np.float32), 0.5: np.full(4, 2.0, np.float32)}
    ck.save(w1)
    ck.save(w2)

    # Kill between tmp-write and rename: the published checkpoint must
    # still be the complete previous one.
    with chaos.FaultPlan([chaos.FaultSpec(site="checkpoint.save", at=0)]):
        try:
            ck.save({**w2, 0.1: np.zeros(4, np.float32)})
            failures.append("hardening: mid-save kill never fired")
        except chaos.InjectedFault:
            pass
    if sorted(ck.load()) != sorted(w2):
        failures.append(
            "hardening: a kill before the atomic rename damaged the "
            "published checkpoint"
        )

    # Truncate the newest file: restore must fall back to the previous
    # verifiable generation (w1), not crash and not return nothing.
    with open(ck.path, "r+b") as f:
        f.truncate(32)
    loaded = ck.load()
    if sorted(loaded) != sorted(w1):
        failures.append(
            f"hardening: fallback after truncation loaded {sorted(loaded)} "
            f"instead of the previous generation {sorted(w1)}"
        )

    # Corrupt every retained generation: a pointed error naming the path.
    with open(ck.path + ".1", "r+b") as f:
        f.truncate(16)
    try:
        ck.load()
        failures.append(
            "hardening: fully-corrupt checkpoints loaded without error"
        )
    except CheckpointCorruptError as exc:
        if ck.path not in str(exc):
            failures.append(
                f"hardening: corruption error does not name the path: {exc}"
            )


# ---------------------------------------------------------------------------
# Entry point
# ---------------------------------------------------------------------------

SCENARIOS = (
    ("streamed_glm_kill_resume", _check_streamed_glm),
    ("game_cd_kill_resume", _check_game_cd),
    ("serving_degrade", _check_serving),
    ("checkpoint_hardening", _check_checkpoint_hardening),
)


def run_selfcheck(out_dir: str, device=None) -> list[str]:
    """Returns failure strings (empty = pass).  ``device``: the card by
    default; ``"cpu"`` runs the reference's CPU story."""
    from photon_ml_tpu_torch import telemetry as telemetry_mod
    from photon_ml_tpu_torch.device import resolve_device

    device = resolve_device(device)
    failures: list[str] = []
    with telemetry_mod.Telemetry(
        output_dir=out_dir, run_name="chaos-selfcheck"
    ) as tel:
        with tel.span("selfcheck", subsystem="chaos", device=str(device)):
            for name, check in SCENARIOS:
                found: list[str] = []
                t0 = time.perf_counter()
                with tel.span(name):
                    check(out_dir, found, device)
                print(f"chaos scenario {name}: "
                      f"{'FAIL' if found else 'PASS'} "
                      f"{time.perf_counter() - t0:.3f} s", flush=True)
                failures.extend(found)
        snap = tel.snapshot()
    injected = snap["counters"].get("chaos_faults_injected", 0)
    if injected < 4:
        failures.append(
            f"chaos_faults_injected counter is {injected}, expected >= 4 "
            "(one per scripted scenario)"
        )
    if snap["counters"].get("prefetch_thread_leak", 0):
        failures.append("prefetch_thread_leak counter is nonzero")
    if not os.path.exists(os.path.join(out_dir, "metrics.json")):
        failures.append(f"missing {os.path.join(out_dir, 'metrics.json')}")
    if not failures:
        print(
            f"chaos selfcheck: {injected} scripted faults injected on "
            f"{device}; streamed-grid + GAME-CD kill/resume "
            "bitwise-identical, mid-pass teardown leak-free, serving "
            + ("failed the faulted batch alone and scored the next ones "
               "bitwise" if device.type == "cuda" else
               "degraded with 0 errors and re-promoted")
            + ", checkpoint fallback + pointed corruption errors verified"
        )
    return failures


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m photon_ml_tpu_torch.chaos",
        description="deterministic fault injection / recovery selfcheck",
    )
    p.add_argument("--selfcheck", action="store_true")
    p.add_argument(
        "--list-sites", action="store_true",
        help="print the fault-site catalog as JSON",
    )
    p.add_argument(
        "--plan", metavar="FILE",
        help="validate a JSON fault plan (parse + site/spec checks) "
        "without running anything",
    )
    p.add_argument(
        "--output-dir",
        help="telemetry output dir (selfcheck defaults to a tempdir)",
    )
    p.add_argument(
        "--device", default="cuda",
        help="device the selfcheck's scenarios run on (cuda | cpu)",
    )
    args = p.parse_args(argv)

    if args.list_sites:
        from photon_ml_tpu_torch.chaos import KNOWN_SITES

        print(json.dumps(KNOWN_SITES, indent=2))
        return 0

    if args.plan:
        from photon_ml_tpu_torch.chaos import FaultPlan

        with open(args.plan) as f:
            plan = FaultPlan.from_json(f.read())
        print(f"{args.plan}: {len(plan.faults)} fault spec(s) valid")
        return 0

    if not args.selfcheck:
        p.print_help()
        return 2

    if args.output_dir:
        os.makedirs(args.output_dir, exist_ok=True)
        failures = run_selfcheck(args.output_dir, args.device)
    else:
        with tempfile.TemporaryDirectory(
            prefix="photon_chaos_selfcheck_"
        ) as td:
            failures = run_selfcheck(td, args.device)
    if failures:
        print("chaos selfcheck FAILED:", file=sys.stderr)
        for f in failures:
            print(f"  - {f}", file=sys.stderr)
        return 1
    print("chaos selfcheck PASSED")
    return 0


if __name__ == "__main__":
    sys.exit(main())
