"""Time the serving kernel and a bucket's round trip on the card.

    python -m photon_ml_tpu_torch.experiments.serve_launch [--rounds N]
        [--sweep PHOTON_SERVE_WARPS=1,2,4,8] [--define NAME=V ...]
        [--load SECONDS] [--out FILE]

On two models of the serving phases' widths, seeded synthetic weights
(``SyntheticWorkload``): a 512-wide fixed effect with an 8-wide per-user
effect (phase 7's GAME model) and ``bench_serving``'s 64 + 8, it reports

- (a) the kernel alone, the median of 50 launches under CUDA events
  (``utils/timer.median_ms``, the launches queued behind a device-side
  sleep): with every operand in HBM (``serving/kernels.py::serve_margins``)
  at buckets 1 and 64, and reading the request side in place from
  page-locked host memory through a prebuilt block (``launch_block``);
- (b) a bucket's round trip: the host clock around
  ``ScoringRuntime._launch`` (filling the staging buffers, the launch, the
  wait, the result), the median of ``--rounds`` calls after 20 warm-up
  calls, at buckets 1, 8 and 64, on all-hot batches (every row's entity in
  the hot set, so no promotion is written);
- (c) the launch floor: an empty one-warp kernel under (a)'s protocol;
- with ``--load``, (d) ``chip_smoke.py`` phase 13d's closed loop alone:
  ``bench_serving``'s model behind ``ScoringService`` (buckets to 64, a
  4,096-row hot set, ``max_wait_us`` 1000, ``max_queue`` 1024), 4 clients
  for 0.5 s, then 16 for ``SECONDS``: requests/s, p50/p99/p99.9 and the
  mean batch.

``--sweep NAME=V1,V2,...`` builds the library once per value of one of
``csrc/serve_margins.cu``'s design constants (``-DNAME=V``, plus every
``--define``; one ``nvcc`` each, all started together), checks each
build against the plain version, and times (a) for each, in two rounds
(the values in order, then reversed).

Only the public entry points are used, so the script also times an older
tree of the package (``PYTHONPATH=<tree> python <this file>``); what that
tree lacks (the prebuilt block, the empty kernel) is reported as null.
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from photon_ml_tpu_torch.ops import _kernels
from photon_ml_tpu_torch.serving import kernels as sk
from photon_ml_tpu_torch.serving.runtime import RuntimeConfig, ScoringRuntime
from photon_ml_tpu_torch.serving.synthetic import SyntheticWorkload
from photon_ml_tpu_torch.utils.timer import median_ms

#: (name, fixed width, random width, entities, seed).
MODELS = (("phase7", 512, 8, 20_000, 7), ("bench_serving", 64, 8, 50_000, 9))
KERNEL_BUCKETS = (1, 64)
TRIP_BUCKETS = (1, 8, 64)
MAX_BATCH = 64
HOT = 4096
WARMUP = 20


def workload(name: str) -> SyntheticWorkload:
    _, d_f, d_r, n, seed = next(m for m in MODELS if m[0] == name)
    return SyntheticWorkload(n_entities=n, fixed_dim=d_f, re_dim=d_r,
                             seed=seed)


def bucket_operands(wl: SyntheticWorkload, device, b: int = MAX_BATCH):
    """One full bucket's operands on ``device``, rows in order: the even
    rows find their entity in a hot table (slot i + 1), the odd ones carry
    it as a cold row; offsets N(0, 0.1²).  Returns (offset, fixed, random)
    as :func:`serving.kernels.serve_margins` takes them."""
    reqs = [wl.request(i) for i in range(b)]
    re = wl.model.models["per_entity"]
    coefs = sk.dense_coefficient_rows(re, [r["ids"][wl.entity_key]
                                           for r in reqs])
    x_f = np.asarray([r["dense"][wl.fixed_shard] for r in reqs], np.float32)
    x_r = np.asarray([r["dense"][wl.re_shard] for r in reqs], np.float32)
    table = np.zeros((b + 1, wl.re_dim), np.float32)
    slots = np.zeros(b, np.int32)
    cold = np.zeros_like(x_r)
    for i in range(b):
        if i % 2 == 0:
            slots[i], table[i + 1] = i + 1, coefs[i]
        else:
            cold[i] = coefs[i]
    off = np.random.default_rng(13).normal(scale=0.1, size=b).astype(
        np.float32)
    w = wl.model.models["fixed"].model.coefficients.means.numpy()

    def dev(a):
        return torch.as_tensor(np.ascontiguousarray(a), device=device)

    return dev(off), [(dev(x_f), dev(w))], [(dev(x_r), dev(table),
                                             dev(slots), dev(cold))]


def head(operands, b: int):
    """The first ``b`` rows of :func:`bucket_operands`."""
    off, fixed, random = operands
    return (off[:b], [(x[:b], w) for x, w in fixed],
            [(x[:b], t, s[:b], c[:b]) for x, t, s, c in random])


def pinned_block(operands, link: str, device):
    """The operands' request side copied into page-locked host memory and
    a launch block that reads it in place (and writes a page-locked
    ``(2, B)`` output).  Returns (block, out, the pinned operands)."""
    off, fixed, random = operands

    def pin(t):
        return t.cpu().pin_memory()

    host = (pin(off), [(pin(x), w) for x, w in fixed],
            [(pin(x), t, pin(s), pin(c)) for x, t, s, c in random])
    out = torch.zeros((2, off.shape[0]), dtype=torch.float32,
                      pin_memory=True)
    return sk.mapped_block(*host, link, out, device), out, host


def kernel_times(wl, device, link="logistic", library="serve_margins"):
    """(a) at :data:`KERNEL_BUCKETS`: {bucket: {"hbm": ms, "pinned": ms}};
    with a variant ``library`` both through prebuilt blocks."""
    ops = bucket_operands(wl, device)
    res = {}
    for b in KERNEL_BUCKETS:
        part = head(ops, b)
        rec = {}
        if library == "serve_margins":
            rec["hbm"] = median_ms(lambda: sk.serve_margins(*part, link),
                                   device)
        else:
            out = torch.empty((2, b), device=device)
            blk = sk.launch_block(*part, link, out)
            rec["hbm"] = median_ms(lambda: sk.launch(blk, device, library),
                                   device)
        if hasattr(sk, "mapped_block"):
            blk, _, _ = pinned_block(part, link, device)
            rec["pinned"] = median_ms(
                lambda: sk.launch(blk, device, library), device)
        else:
            rec["pinned"] = None
        res[b] = rec
    return res


def hot_batches(rt: ScoringRuntime, rows):
    """``(bucket, packed, slots)`` as ``score_rows`` hands them to
    ``_launch`` for an all-hot batch of ``rows`` (parsed requests whose
    entities the model knows): the rows scored once to promote their
    entities, then captured from a second, all-hot pass."""
    rt.score_rows(rows)
    misses = rt.stats()["hot_sets"][rt.random[0].name]["misses"]
    seen = {}
    inner = rt._launch

    def capture(bucket, packed, slots):
        seen["args"] = (bucket, np.array(packed), np.array(slots))
        return inner(bucket, packed, slots)

    rt._launch = capture
    try:
        rt.score_rows(rows)
    finally:
        del rt._launch
    if rt.stats()["hot_sets"][rt.random[0].name]["misses"] != misses:
        raise RuntimeError("the capture batch was not all hot")
    if not seen["args"][2].all():
        raise RuntimeError("a captured row has no hot slot")
    return seen["args"]


def round_trip_ms(rt: ScoringRuntime, rows, b: int, n: int) -> float:
    """(b): the median host-clock ms of ``rt._launch`` on an all-hot
    batch of the first ``b`` of ``rows``, over ``n`` calls after
    :data:`WARMUP`."""
    bucket, packed, slots = hot_batches(rt, rows[:b])
    for _ in range(WARMUP):
        rt._launch(bucket, packed, slots)
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        rt._launch(bucket, packed, slots)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def launch_floor_ms(device):
    """(c): an empty one-warp kernel under (a)'s protocol, or None where
    the library has none."""
    if not hasattr(sk, "launch_empty"):
        return None
    return median_ms(lambda: sk.launch_empty(device), device)


def closed_loop_load(seconds: float) -> dict:
    """(d): phase 13d's closed loop on ``bench_serving``'s model."""
    from photon_ml_tpu_torch import telemetry
    from photon_ml_tpu_torch.serving import loadgen
    from photon_ml_tpu_torch.serving.batcher import BatcherConfig
    from photon_ml_tpu_torch.serving.service import ScoringService

    wl = workload("bench_serving")
    rt = ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
        max_batch_size=MAX_BATCH, hot_entities=HOT, device="cuda"))
    svc = ScoringService(rt, BatcherConfig(
        max_batch_size=MAX_BATCH, max_wait_us=1000, max_queue=1024))
    with telemetry.Telemetry(sinks=[]), svc:
        loadgen.closed_loop(svc.submit, wl.request, clients=4,
                            duration_s=0.5)
        b0, r0 = rt.batches, rt.rows_scored
        report = loadgen.closed_loop(svc.submit, wl.request, clients=16,
                                     duration_s=seconds)
        batches, rows = rt.batches - b0, rt.rows_scored - r0
    snap = report.snapshot()
    return {k: snap[k] for k in ("throughput_rps", "latency_p50_ms",
                                 "latency_p99_ms", "latency_p999_ms")} | {
        "mean_batch_rows": rows / max(batches, 1),
        "errors": report.errors, "rejected": report.rejected}


def smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0].strip()


def sweep(name: str, values, defines, device) -> dict:
    """(a) for every value of the design constant ``name`` (with
    ``defines``), in two rounds, each build checked against the plain
    version first."""
    libs = {v: _kernels.variant("serve_margins", *defines, f"{name}={v}")
            for v in values}
    _kernels.build_libraries(*libs.values())
    models = {name: workload(name) for name, *_ in MODELS}
    for lib in libs.values():
        for name, wl in models.items():
            ops = bucket_operands(wl, device)
            out = torch.empty((2, MAX_BATCH), device=device)
            sk.launch(sk.launch_block(*ops, "logistic", out), device, lib)
            torch.cuda.synchronize()
            plain = sk.serve_margins_plain(*ops, "logistic")
            if not torch.equal(out[0], plain[0]):
                raise RuntimeError(f"{lib} on {name}: margins differ from "
                                   "the plain version")
    res = {v: {m: [] for m in models} for v in values}
    for order in (list(values), list(reversed(values))):
        for v in order:
            for m, wl in models.items():
                res[v][m].append(kernel_times(wl, device, library=libs[v]))
    return res


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=300)
    ap.add_argument("--sweep", default="")
    ap.add_argument("--define", action="append", default=[])
    ap.add_argument("--load", type=float, default=0.0)
    ap.add_argument("--out", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("serve_launch: needs the card")
    device = torch.device("cuda", 0)
    card = smi()
    print(card, flush=True)
    _kernels.build_libraries("serve_margins")
    result = {"card": card, "models": {}}
    for name, *_ in MODELS:
        wl = workload(name)
        ktimes = kernel_times(wl, device)
        rt = ScoringRuntime(wl.model, wl.index_maps, RuntimeConfig(
            max_batch_size=MAX_BATCH, hot_entities=HOT, device="cuda"))
        rows = [rt.parse_request(wl.request(i)) for i in range(MAX_BATCH)]
        trips = {b: round_trip_ms(rt, rows, b, args.rounds)
                 for b in TRIP_BUCKETS}
        result["models"][name] = {"kernel_ms": ktimes,
                                  "round_trip_ms": trips}
        for b, rec in ktimes.items():
            print(f"serve_launch {name} bucket {b}: kernel, HBM inputs "
                  f"{rec['hbm']:.4f} ms; pinned inputs in place "
                  f"{rec['pinned'] if rec['pinned'] is None else round(rec['pinned'], 4)} ms",
                  flush=True)
        for b, ms in trips.items():
            print(f"serve_launch {name} bucket {b}: round trip (_launch, "
                  f"median of {args.rounds}) {ms:.4f} ms", flush=True)
    result["launch_floor_ms"] = launch_floor_ms(device)
    print(f"serve_launch: empty-kernel launch floor "
          f"{result['launch_floor_ms']} ms", flush=True)
    if args.load:
        result["load"] = closed_loop_load(args.load)
        print(f"serve_launch load: {json.dumps(result['load'])}", flush=True)
    if args.sweep:
        name, _, values = args.sweep.partition("=")
        res = sweep(name, values.split(","), args.define, device)
        result["sweep"] = {"name": name, "defines": args.define,
                           "times": res}
        for v, per in res.items():
            for m, rounds in per.items():
                for b in KERNEL_BUCKETS:
                    hbm = [round(r[b]["hbm"], 5) for r in rounds]
                    pin = [round(r[b]["pinned"], 5) for r in rounds]
                    print(f"serve_launch sweep {name}={v} {args.define} {m} "
                          f"bucket {b}: HBM {hbm} ms, pinned {pin} ms",
                          flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
