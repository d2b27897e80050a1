"""The port's transient-failure watchdog (``utils/watchdog.py``) against the
reference's: the reference's cases without its telemetry, plus the port's
own classification of CUDA errors (a CUDA fault leaves the context sticky,
so it is never retried in the process)."""

import json
import random

import pytest

from photon_ml_tpu.utils import watchdog as ref_watchdog
from photon_ml_tpu_torch.utils.watchdog import (
    RetryPolicy,
    RetryStats,
    run_with_retries,
)
from torch_ref_compile import reference_compiles_in_process  # noqa: E402,F401


class _FakeLogger:
    def __init__(self):
        self.warnings = []

    def warning(self, msg, *args):
        self.warnings.append(msg % args if args else msg)

    def info(self, *a, **k):
        pass


class TestRetryPolicy:
    def test_transient_classification(self):
        p = RetryPolicy(max_retries=3)
        assert p.is_transient(RuntimeError("UNAVAILABLE: Socket closed"))
        assert p.is_transient(RuntimeError("DEADLINE_EXCEEDED: timed out"))
        assert p.is_transient(OSError("connection reset by peer"))
        assert not p.is_transient(ValueError("bad shape"))
        assert not p.is_transient(
            RuntimeError("RESOURCE_EXHAUSTED: out of memory"))

    def test_extra_patterns(self):
        p = RetryPolicy(extra_patterns=("my-cluster-oops",))
        assert p.is_transient(RuntimeError("MY-CLUSTER-OOPS happened"))

    def test_backoff_exponential_capped(self):
        p = RetryPolicy(backoff_seconds=2.0, backoff_multiplier=3.0,
                        max_backoff_seconds=10.0)
        assert [p.backoff(a) for a in range(3)] == [2.0, 6.0, 10.0]

    def test_interrupts_never_retryable(self):
        p = RetryPolicy(extra_patterns=("UNAVAILABLE",))
        c = p.classify(KeyboardInterrupt("UNAVAILABLE: device lost"))
        assert not c.transient and c.source == "interrupt"
        c = p.classify(SystemExit("UNAVAILABLE: bye"))
        assert not c.transient and c.source == "interrupt"

    def test_jitter_validation(self):
        with pytest.raises(ValueError, match="jitter"):
            RetryPolicy(jitter="full")

    def test_decorrelated_jitter_matches_reference(self):
        """The same seeded RNG gives the reference's jittered schedule,
        inside the decorrelated envelope."""
        kw = dict(backoff_seconds=1.0, max_backoff_seconds=30.0,
                  jitter="decorrelated")
        p, rp = RetryPolicy(**kw), ref_watchdog.RetryPolicy(**kw)
        rng, rrng = random.Random(7), random.Random(7)
        prev = rprev = None
        for attempt in range(6):
            d = p.backoff(attempt, rng=rng, previous=prev)
            rd = rp.backoff(attempt, rng=rrng, previous=rprev)
            assert d == rd
            assert 1.0 <= d <= min(30.0, max(1.0, 3.0 * (prev or 1.0)))
            prev, rprev = d, rd

    def test_jitter_none_ignores_rng(self):
        p = RetryPolicy(backoff_seconds=2.0)
        assert p.backoff(1, rng=random.Random(0)) == 4.0


#: Messages and the verdict both packages give them (the reference's
#: patterns, kept by the port).
SHARED_CASES = [
    ("UNAVAILABLE: Socket closed", True, "UNAVAILABLE"),
    ("DEADLINE_EXCEEDED: rpc", True, "DEADLINE_EXCEEDED"),
    ("connection reset by peer", True, "connection reset"),
    ("job preempted by the scheduler", True, "preempted"),
    ("RESOURCE_EXHAUSTED: oom", False, "RESOURCE_EXHAUSTED"),
    ("INVALID_ARGUMENT: shape mismatch", False, "INVALID_ARGUMENT"),
    ("UNAVAILABLE but out of memory", False, "out of memory"),
    ("bad shape", False, None),
]


@pytest.mark.parametrize("message,transient,matched", SHARED_CASES)
def test_classification_matches_reference(message, transient, matched):
    c = RetryPolicy().classify(RuntimeError(message))
    rc = ref_watchdog.RetryPolicy().classify(RuntimeError(message))
    assert (c.transient, c.matched) == (transient, matched)
    assert (rc.transient, rc.matched) == (transient, matched)


class TestCudaErrorClassification:
    """The port's deliberate difference: a CUDA fault is sticky (every later
    call in the process fails the same way), so it is non-transient even
    where its message holds a transient word; the reference's
    ``XlaRuntimeError`` type-name fallback has no counterpart."""

    @pytest.mark.parametrize("message,matched", [
        ("CUDA error: an illegal memory access was encountered",
         "CUDA error"),
        ("CUDA error: unspecified launch failure (INTERNAL)", "CUDA error"),
        ("an illegal memory access was encountered", "illegal memory access"),
    ])
    def test_cuda_faults_not_retried(self, message, matched):
        c = RetryPolicy(max_retries=3).classify(RuntimeError(message))
        assert not c.transient and c.matched == matched
        assert c.source == "non_transient_pattern"

    def test_accelerator_error_type_not_retried(self):
        AcceleratorError = type("AcceleratorError", (RuntimeError,), {})
        exc = AcceleratorError("CUDA error: device-side assert triggered")
        assert not RetryPolicy().is_transient(exc)

    def test_out_of_memory_error_type_not_retried(self):
        """torch.OutOfMemoryError re-runs the same allocation, whatever its
        message says."""
        import torch

        c = RetryPolicy().classify(torch.OutOfMemoryError("UNAVAILABLE"))
        assert not c.transient and c.source == "non_transient_type"
        assert c.matched == "OutOfMemoryError"

    def test_no_type_name_fallback(self):
        """A transient type name of the reference's is not retried without
        a transient message (the reference retries it)."""
        XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
        assert not RetryPolicy().is_transient(XlaRuntimeError("mystery"))
        assert ref_watchdog.RetryPolicy().is_transient(
            XlaRuntimeError("mystery"))

    def test_cuda_fault_propagates_without_retry(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")

        stats = RetryStats()
        with pytest.raises(RuntimeError, match="illegal memory access"):
            run_with_retries(fn, RetryPolicy(max_retries=5),
                             sleep=lambda s: None, stats=stats)
        assert calls == [0] and stats.retries == 0 and not stats.gave_up


class TestRunWithRetries:
    def test_retries_then_succeeds(self):
        calls, slept = [], []

        def fn(attempt):
            calls.append(attempt)
            if attempt < 2:
                raise RuntimeError("UNAVAILABLE: transport lost")
            return "ok"

        log = _FakeLogger()
        out = run_with_retries(
            fn, RetryPolicy(max_retries=3, backoff_seconds=0.01), log,
            sleep=slept.append)
        assert out == "ok" and calls == [0, 1, 2]
        assert len(slept) == 2 and len(log.warnings) == 2

    def test_budget_exhausted_raises(self):
        def fn(attempt):
            raise RuntimeError("UNAVAILABLE: still down")

        with pytest.raises(RuntimeError, match="still down"):
            run_with_retries(fn, RetryPolicy(max_retries=2,
                                             backoff_seconds=0),
                             sleep=lambda s: None)

    def test_non_transient_propagates_immediately(self):
        calls = []

        def fn(attempt):
            calls.append(attempt)
            raise ValueError("programming error")

        with pytest.raises(ValueError):
            run_with_retries(fn, RetryPolicy(max_retries=5),
                             sleep=lambda s: None)
        assert calls == [0]

    def test_disabled_by_default(self):
        def fn(attempt):
            raise RuntimeError("UNAVAILABLE")

        with pytest.raises(RuntimeError):
            run_with_retries(fn, RetryPolicy(), sleep=lambda s: None)

    def test_decorrelated_jitter_schedule_is_seeded(self):
        def fn(attempt):
            if attempt < 3:
                raise RuntimeError("UNAVAILABLE: flaky")
            return attempt

        policy = RetryPolicy(max_retries=5, backoff_seconds=1.0,
                             max_backoff_seconds=5.0, jitter="decorrelated")

        def delays(seed):
            slept = []
            run_with_retries(fn, policy, sleep=slept.append,
                             rng=random.Random(seed))
            return slept

        a = delays(42)
        assert a == delays(42) and len(a) == 3 and a != delays(43)
        prev = 1.0
        for d in a:
            assert 1.0 <= d <= min(5.0, max(1.0, 3.0 * prev))
            prev = d


class TestRetryStats:
    def _run(self, fn, policy):
        stats, rstats = RetryStats(), ref_watchdog.RetryStats()
        outs = []
        for run, st in ((run_with_retries, stats),
                        (ref_watchdog.run_with_retries, rstats)):
            try:
                outs.append(run(fn, policy(), sleep=lambda s: None,
                                stats=st))
            except Exception as exc:  # noqa: BLE001 — compared below
                outs.append(type(exc))
        return outs, stats, rstats

    def test_stats_record_each_attempt_like_reference(self):
        def fn(attempt):
            if attempt < 2:
                raise RuntimeError("UNAVAILABLE: transport lost")
            return "ok"

        (out, rout), stats, rstats = self._run(
            fn, lambda: RetryPolicy(max_retries=3, backoff_seconds=2.0))
        assert out == rout == "ok"
        assert stats.snapshot() == {
            k: v for k, v in rstats.snapshot().items()}
        assert stats.attempts == 3 and stats.retries == 2
        assert stats.sleep_seconds == pytest.approx(6.0)
        assert [f["backoff_seconds"] for f in stats.failures] == [2.0, 4.0]
        json.dumps(stats.snapshot())

    def test_stats_mark_gave_up_on_budget_exhaustion(self):
        def fn(attempt):
            raise RuntimeError("UNAVAILABLE: still down")

        (out, rout), stats, rstats = self._run(
            fn, lambda: RetryPolicy(max_retries=1, backoff_seconds=0))
        assert out is rout is RuntimeError
        assert stats.snapshot() == rstats.snapshot()
        assert stats.gave_up and not stats.succeeded
        assert stats.failures[-1]["backoff_seconds"] is None

    def test_stats_non_transient_single_failure(self):
        def fn(attempt):
            raise ValueError("broken")

        (out, rout), stats, rstats = self._run(
            fn, lambda: RetryPolicy(max_retries=5))
        assert out is rout is ValueError
        assert stats.snapshot() == rstats.snapshot()
        assert not stats.gave_up and stats.attempts == 1
        assert stats.failures[0]["transient"] is False
