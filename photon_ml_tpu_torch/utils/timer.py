"""Wall-clock timing utility (the reference's ``Timer`` — SURVEY.md §2 Util).

Used around device computations; CUDA work is queued asynchronously, so a
measurement means something only after the device has finished, which
:meth:`stop_blocking` waits for (``torch.cuda.synchronize``).
"""

from __future__ import annotations

import time


class Timer:
    def __init__(self):
        self._start: float | None = None
        self.elapsed: float = 0.0

    def start(self) -> "Timer":
        self._start = time.perf_counter()
        return self

    def stop(self) -> float:
        assert self._start is not None, "Timer not started"
        self.elapsed = time.perf_counter() - self._start
        self._start = None
        return self.elapsed

    def stop_blocking(self, *tensors) -> float:
        """Wait for the devices holding ``tensors`` to finish, then stop."""
        import torch

        for dev in {t.device for t in tensors if isinstance(t, torch.Tensor)}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return self.stop()

    def __enter__(self) -> "Timer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()


def median_ms(fn, device, n: int = 50) -> float:
    """Median milliseconds of one call of ``fn`` over ``n`` calls, after one
    warm-up call.

    On a CUDA device each call sits between its own CUDA events, and a
    device-side sleep first lets the host queue all ``n`` calls, so host
    launch overhead opens no gaps inside the timed spans: the result is
    device time.  On the CPU it is host-clock time around each call."""
    import statistics

    import torch

    device = torch.device(device)
    fn()
    if device.type != "cuda":
        times = []
        for _ in range(n):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)
    torch.cuda.synchronize(device)
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(n)]
    with torch.cuda.device(device):
        torch.cuda._sleep(50_000_000)
        for start, end in events:
            start.record()
            fn()
            end.record()
    torch.cuda.synchronize(device)
    return statistics.median(s.elapsed_time(e) for s, e in events)
