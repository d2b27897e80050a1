"""Find where a process group's bits part from its logical shards or tiles.

The port claims that a group of k ranks gives the bits of k logical shards
(``parallel/distributed.py``) or logical tiles (``parallel/tensor.py``).
This script runs the cases that ``tests/test_torch_distributed.py`` and
``tests/test_torch_tensor_parallel.py`` hold bitwise, both ways on the CPU,
and records every objective evaluation on both sides: the point it was
asked for, the value and the gradient (or Hessian-vector product), as raw
bytes.  It then reports, for each rank, the first evaluation whose input or
output bits differ from the logical form's, so a host on which the claim
fails shows which step of the solve parted first.

- ``tp``: the 2 x 2 grid's L-BFGS, OWL-QN and TRON solves
  (``tests/torch_dist_workers.py::tp_cases``) on 4 gloo ranks;
- ``admm``: the host-kind ADMM case (``CASES["admm"]``) on 2 and 4 ranks.

    python scripts/bitwise_forms.py [--cases tp,admm] [--out DIR]

It imports torch, numpy and the port only (no JAX), so it runs on any host
with a CPU build of torch.  It prints one line per comparison and a JSON
summary as the last line; the exit code is 0 when every rank matched.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing
import os
import platform
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "tests"))

#: Per-process record of evaluations: (label, input bytes, output bytes).
RECORD: list = []


def _b(t) -> bytes:
    return t.detach().contiguous().cpu().numpy().tobytes()


def _record_tp():
    """Wrap the tile objective's evaluations.  Vectors are recorded as this
    process's column slices (a logical run records every slice)."""
    from photon_ml_tpu_torch.parallel import tensor

    cls = tensor.TileObjective
    vg, hvp = cls.value_and_grad, cls.hvp

    def slices(self, w):
        return {j: _b(v) for j, v in self._slices(w).items()}

    def value_and_grad(self, w, l2):
        val, g = vg(self, w, l2)
        RECORD.append(("vg", slices(self, w), (_b(val), slices(self, g))))
        return val, g

    def hvp_rec(self, v, d2w, l2):
        h = hvp(self, v, d2w, l2)
        RECORD.append(("hvp", slices(self, v), (b"", slices(self, h))))
        return h

    cls.value_and_grad, cls.hvp = value_and_grad, hvp_rec


def _record_admm(shard_of):
    """Wrap the GLM objective's raw evaluation, tagging each call with the
    row block it ran on (``shard_of(local)``); a second call swaps the tag
    only."""
    from photon_ml_tpu_torch.optim.objective import GlmObjective

    _TAG["shard_of"] = shard_of
    if "raw" in _TAG:
        return
    raw = _TAG["raw"] = GlmObjective.raw_value_and_grad

    def raw_value_and_grad(self, w, data):
        val, g = raw(self, w, data)
        s = _TAG["shard_of"](data)
        RECORD.append(("vg", {s: _b(w)}, (_b(val), {s: _b(g)})))
        return val, g

    GlmObjective.raw_value_and_grad = raw_value_and_grad


_TAG: dict = {}


def _tp_rank(rank, world, init_file, out_dir):
    import torch.distributed as dist

    import torch_dist_workers as workers
    from photon_ml_tpu_torch.parallel import tensor

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        _record_tp()
        out = workers.tp_cases(tensor.dp_tp_mesh(2, 2, distributed=True))
        _save(out_dir, rank, out)
    finally:
        dist.destroy_process_group()


def _admm_rank(rank, world, init_file, out_dir):
    import torch.distributed as dist

    import torch_dist_workers as workers
    from photon_ml_tpu_torch.parallel import multihost

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=world)
    try:
        _record_admm(lambda data: rank)
        ws, _ = workers.run_case("admm", multihost.global_data_mesh())
        _save(out_dir, rank, {f"w/{lam}": w for lam, w in ws.items()})
    finally:
        dist.destroy_process_group()


def _save(out_dir, rank, results):
    import pickle

    with open(os.path.join(out_dir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump({"record": RECORD, "results": results}, f)


def _spawn(target, world, out_dir):
    os.makedirs(out_dir, exist_ok=True)
    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target,
                         args=(r, world, os.path.join(out_dir, "rdv"),
                               out_dir))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(300)
    codes = [p.exitcode for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(5)
    if codes != [0] * world:
        raise RuntimeError(f"rank exit codes {codes}")
    import pickle

    out = []
    for r in range(world):
        with open(os.path.join(out_dir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


def _first_divergence(logical: list, ranked: list, key) -> dict:
    """The first evaluation at which rank ``key``'s slice of the input or of
    the outputs differs from the logical record's."""
    mine = [e for e in logical if key in e[1]]
    n = min(len(mine), len(ranked))
    for k in range(n):
        (lab_a, in_a, (val_a, out_a)), (lab_b, in_b, (val_b, out_b)) = (
            mine[k], ranked[k])
        if lab_a != lab_b:
            return {"eval": k, "where": f"kind {lab_a} vs {lab_b}"}
        if in_a[key] != next(iter(in_b.values())):
            return {"eval": k, "where": f"{lab_a} input (the solver's step)"}
        if val_a != val_b:
            return {"eval": k, "where": f"{lab_a} value"}
        if out_a[key] != next(iter(out_b.values())):
            return {"eval": k, "where": f"{lab_a} vector"}
    if len(mine) != len(ranked):
        return {"eval": n, "where": f"count {len(mine)} vs {len(ranked)}"}
    return {}


def run_tp(tmp) -> dict:
    import torch_dist_workers as workers
    from photon_ml_tpu_torch.parallel import tensor

    ranks = _spawn(_tp_rank, 4, tmp)
    RECORD.clear()
    _record_tp()
    logical = workers.tp_cases(tensor.dp_tp_mesh(2, 2))
    rec = list(RECORD)
    report = {}
    for r, saved in enumerate(ranks):
        j = r % 2
        equal = all(np.array_equal(saved["results"][k], logical[k])
                    for k in logical)
        first = _first_divergence(rec, saved["record"], j)
        report[f"rank{r}"] = {"results_bitwise": equal, **first}
        print(f"tp rank {r} (slice {j}): results bitwise {equal}; "
              f"first divergence {first or 'none'}", flush=True)
    return report


def _key(data) -> bytes:
    """A row block's identity: its labels' and offsets' bits (the blocks
    of one dataset differ in them)."""
    return _b(data.labels) + _b(data.offsets)


def run_admm(tmp, world) -> dict:
    import torch_dist_workers as workers
    from photon_ml_tpu_torch.parallel import distributed

    ranks = _spawn(_admm_rank, world, tmp)
    RECORD.clear()
    shard_of = {}
    build = distributed.shard_glm_data

    def tagged(*a, **k):
        dd = build(*a, **k)
        shard_of.update({_key(s): i for i, s in enumerate(dd.shards)})
        return dd

    distributed.shard_glm_data = tagged
    try:
        _record_admm(lambda data: shard_of[_key(data)])
        ws, _ = workers.run_case("admm", None, n_shards=world)
    finally:
        distributed.shard_glm_data = build
    rec = list(RECORD)
    report = {}
    for r, saved in enumerate(ranks):
        equal = all(saved["results"][f"w/{lam}"].tobytes() == w.tobytes()
                    for lam, w in ws.items())
        first = _first_divergence(rec, saved["record"], r)
        report[f"rank{r}"] = {"results_bitwise": equal, **first}
        print(f"admm {world} ranks, rank {r}: results bitwise {equal}; "
              f"first divergence {first or 'none'}", flush=True)
    return report


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cases", default="tp,admm")
    ap.add_argument("--out", default=None,
                    help="directory for the ranks' records (a temporary "
                         "one by default)")
    args = ap.parse_args(argv)
    host = {"cpu": platform.processor() or platform.machine(),
            "torch": torch.__version__,
            "capability": torch.backends.cpu.get_cpu_capability(),
            "threads": torch.get_num_threads()}
    try:
        with open("/proc/cpuinfo") as f:
            host["cpu"] = next((ln.split(":", 1)[1].strip() for ln in f
                                if ln.startswith("model name")), host["cpu"])
    except OSError:
        pass
    print(f"host: {host}", flush=True)
    summary = {"host": host}
    with tempfile.TemporaryDirectory(dir=args.out) as tmp:
        for case in args.cases.split(","):
            if case == "tp":
                summary["tp"] = run_tp(os.path.join(tmp, "tp"))
            elif case == "admm":
                for world in (2, 4):
                    summary[f"admm{world}"] = run_admm(
                        os.path.join(tmp, f"admm{world}"), world)
            else:
                raise SystemExit(f"unknown case {case!r}")
    ok = all(r["results_bitwise"] and len(r) == 1
             for rep in summary.values() if rep is not host
             for r in rep.values())
    summary["ok"] = ok
    print(json.dumps(summary))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
