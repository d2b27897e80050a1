"""The port's invariant checker (``photon_ml_tpu_torch/analysis``) against
the JAX package's (``photon_ml_tpu/analysis``), on the same fixtures.

- Every JAX-independent rule (thread-lifecycle, process-lifecycle,
  lock-blocking-call, wall-clock-interval, unseeded-rng, chaos-site-sync,
  chaos-site-tested, metric-naming) gives the reference's findings on the
  fixture sources of ``tests/test_analysis.py`` and
  ``tests/test_serving_proc.py::TestProcessLifecycleRule``: the same rule,
  line and message, and the count those tests expect.  Suppressions and
  the baseline behave as the reference's do, through either package's
  API; the CLIs give the same exit codes.
- What is the port's own: its device syncs under a lock
  (``torch.cuda.synchronize()``, ``.item()``, ``.cpu()`` where the
  reference names ``block_until_ready``), ``graph-capture-side-effect``
  (the counterpart of ``jit-side-effect``), ``donated-buffer-reuse`` and
  ``jit-side-effect`` listed as not applicable, the chaos core at
  ``photon_ml_tpu_torch/chaos/core.py``, ``chaos-site-tested`` reading the
  port's tests only, and a walk that skips the kernel build directory.
- The real tree: ``python -m photon_ml_tpu_torch.analysis --check`` and
  ``python -m photon_ml_tpu_torch.telemetry --lint-metrics`` exit 0.

Fixtures are tiny source trees under ``tmp_path``: the checkers parse
files and never import them.
"""

import json
import os

import pytest

import photon_ml_tpu.analysis as ref
import photon_ml_tpu_torch.analysis as port
from photon_ml_tpu.analysis.__main__ import main as ref_main
from photon_ml_tpu_torch.analysis.__main__ import main as port_main
from photon_ml_tpu_torch.analysis import engine as port_engine

PACKAGES = {"reference": ref, "port": port}
MAINS = {"reference": ref_main, "port": port_main}

#: The reference's ten rule ids.
REFERENCE_RULES = [r.id for r in ref.ALL_RULES]


def _raw(pkg, tmp_path, rule_id, source, name="mod.py"):
    """``(rule, line, message)`` of one rule over one fixture file,
    suppressions applied (the reference tests' ``_findings``)."""
    root = tmp_path / pkg.__name__.split(".")[0]
    root.mkdir(exist_ok=True)
    path = root / name
    path.write_text(source)
    tree = pkg.SourceTree(roots=[str(path)], repo_root=str(root))
    return [(f.rule, f.line, f.message)
            for f in pkg.run_rules(tree, [pkg.RULES_BY_ID[rule_id]])
            if not tree.files[0].is_suppressed(f.rule, f.line)]


def _both(tmp_path, rule_id, source):
    """The port's findings, after checking they are the reference's."""
    ours = _raw(port, tmp_path, rule_id, source)
    assert ours == _raw(ref, tmp_path, rule_id, source)
    return ours


# ---------------------------------------------------------------------------
# fixture sources of tests/test_analysis.py and tests/test_serving_proc.py:
# id -> (rule, source, findings the reference's test expects, a substring
# of the first finding's message or None)
# ---------------------------------------------------------------------------

CONCURRENCY = {
    "thread-unjoined": ("thread-lifecycle", (
        "import threading\n"
        "def go(fn):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n"
    ), 1, "never joined"),
    "thread-happy-path-join": ("thread-lifecycle", (
        "import threading\n"
        "def go(fn, risky):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n"
        "    risky()\n"
        "    t.join()\n"
    ), 1, "happy path"),
    "thread-unbound": ("thread-lifecycle", (
        "import threading\n"
        "def go(fns):\n"
        "    for fn in fns:\n"
        "        threading.Thread(target=fn).start()\n"
    ), 1, "without a binding"),
    "thread-daemon": ("thread-lifecycle", (
        "import threading\n"
        "def go(fn):\n"
        "    t = threading.Thread(target=fn, daemon=True)\n"
        "    t.start()\n"
    ), 0, None),
    "thread-join-in-finally": ("thread-lifecycle", (
        "import threading\n"
        "def go(fn, risky):\n"
        "    t = threading.Thread(target=fn)\n"
        "    t.start()\n"
        "    try:\n"
        "        risky()\n"
        "    finally:\n"
        "        t.join()\n"
    ), 0, None),
    "thread-lifecycle-stop": ("thread-lifecycle", (
        "import threading\n"
        "class Owner:\n"
        "    def start(self, fn):\n"
        "        self._t = threading.Thread(target=fn)\n"
        "        self._t.start()\n"
        "    def stop(self):\n"
        "        self._t.join()\n"
    ), 0, None),
    "lock-sleep": ("lock-blocking-call", (
        "import threading, time\n"
        "lock = threading.Lock()\n"
        "def slow():\n"
        "    with lock:\n"
        "        time.sleep(1.0)\n"
    ), 1, "time.sleep()"),
    "lock-join-tracked": ("lock-blocking-call", (
        "import threading\n"
        "from photon_ml_tpu.analysis import sanitizers\n"
        "lock = sanitizers.tracked(threading.Lock(), 'w')\n"
        "def bad(t):\n"
        "    with lock:\n"
        "        t.join()\n"
    ), 1, "thread join while holding lock"),
    "lock-nonblocking-joins": ("lock-blocking-call", (
        "import os, threading\n"
        "lock = threading.Lock()\n"
        "def ok(parts):\n"
        "    with lock:\n"
        "        p = os.path.join('a', 'b')\n"
        "        s = ', '.join(parts)\n"
        "    return p, s\n"
    ), 0, None),
    "lock-sleep-outside": ("lock-blocking-call", (
        "import threading, time\n"
        "lock = threading.Lock()\n"
        "def ok():\n"
        "    with lock:\n"
        "        x = 1\n"
        "    time.sleep(0.1)\n"
        "    return x\n"
    ), 0, None),
    "wall-interval-math": ("wall-clock-interval", (
        "import time\n"
        "def lat(t0):\n"
        "    return time.time() - t0\n"
    ), 1, "monotonic"),
    "wall-bare-latency": ("wall-clock-interval", (
        "import time\n"
        "def stamp():\n"
        "    t_start = time.time()\n"
        "    return t_start\n"
    ), 1, None),
    "wall-anchoring": ("wall-clock-interval", (
        "import time\n"
        "def anchor():\n"
        "    epoch_wall = time.time()\n"
        "    meta = {'wall_epoch': time.time()}\n"
        "    rec(wall_epoch=time.time())\n"
        "    return epoch_wall, meta\n"
    ), 0, None),
    # tests/test_serving_proc.py's TestProcessLifecycleRule fixtures.
    "process-good-lifecycle": ("process-lifecycle", (
        "import multiprocessing\n"
        "class Owner:\n"
        "    def start(self):\n"
        "        self._proc = multiprocessing.get_context(\"spawn\")"
        ".Process(\n"
        "            target=print)\n"
        "        self._proc.start()\n"
        "    def stop(self):\n"
        "        try:\n"
        "            self._proc.join(timeout=5)\n"
        "        finally:\n"
        "            self._proc.terminate()\n"
        "            self._proc.join(timeout=2)\n"
    ), 0, None),
    "process-never-reaped": ("process-lifecycle", (
        "import multiprocessing\n"
        "def go():\n"
        "    p = multiprocessing.Process(target=print)\n"
        "    p.start()\n"
    ), 1, "never joined"),
    "process-happy-path-only": ("process-lifecycle", (
        "import multiprocessing\n"
        "def go():\n"
        "    p = multiprocessing.Process(target=print)\n"
        "    p.start()\n"
        "    work()\n"
        "    p.join()\n"
        "    p.terminate()\n"
    ), 1, "happy path"),
    "popen-no-escalation": ("process-lifecycle", (
        "import subprocess\n"
        "def go():\n"
        "    p = subprocess.Popen([\"true\"])\n"
        "    p.wait()\n"
    ), 1, "terminate"),
    "subprocess-run-exempt": ("process-lifecycle", (
        "import subprocess\n"
        "def go():\n"
        "    subprocess.run([\"true\"], check=True)\n"
    ), 0, None),
}

RNG_AND_METRICS = {
    "rng-module-global-numpy": ("unseeded-rng", (
        "import numpy as np\n"
        "def jitter():\n"
        "    return np.random.uniform()\n"
    ), 1, "module-global numpy RNG"),
    "rng-unseeded-constructors": ("unseeded-rng", (
        "import random\n"
        "import numpy as np\n"
        "a = np.random.default_rng()\n"
        "b = random.Random()\n"
    ), 2, None),
    "rng-seeded": ("unseeded-rng", (
        "import random\n"
        "import numpy as np\n"
        "a = np.random.default_rng(23)\n"
        "b = random.Random(7)\n"
        "c = np.random.SeedSequence(5)\n"
    ), 0, None),
    "metric-bad-names-and-kinds": ("metric-naming", (
        "def f(tel):\n"
        "    tel.counter(\"bogus_thing_total\").inc()\n"
        "    tel.gauge(\"serving_thing_blobs\").set(1)\n"
        "    tel.counter(\"serving_dual_total\").inc()\n"
        "    tel.gauge(\"serving_dual_total\").set(2)\n"
    ), 3, None),
    "metric-conforming-and-legacy": ("metric-naming", (
        "def f(tel):\n"
        "    tel.gauge(\"hbm_live_bytes\").set(0)\n"
        "    tel.counter(\"chaos_faults_injected\").inc()\n"
    ), 0, None),
}

_SUPPRESSION_SRC = (
    "import time\n"
    "def lat(t0):\n"
    "    return time.time() - t0{inline}\n"
)

SUPPRESSION = {
    "inline": (_SUPPRESSION_SRC.format(
        inline="  # photon: disable=wall-clock-interval"), 0),
    "preceding-comment-line": ((
        "import time\n"
        "def lat(t0):\n"
        "    # photon: disable=wall-clock-interval\n"
        "    return time.time() - t0\n"
    ), 0),
    "disable-all": (_SUPPRESSION_SRC.format(
        inline="  # photon: disable=all"), 0),
    "other-rule-does-not-cover": (_SUPPRESSION_SRC.format(
        inline="  # photon: disable=unseeded-rng"), 1),
}


@pytest.mark.parametrize("case", sorted(CONCURRENCY))
def test_concurrency_rule_matches_reference(tmp_path, case):
    rule, src, count, needle = CONCURRENCY[case]
    found = _both(tmp_path, rule, src)
    assert len(found) == count
    if needle:
        assert needle in found[0][2]


@pytest.mark.parametrize("case", sorted(RNG_AND_METRICS))
def test_rng_and_metric_rules_match_reference(tmp_path, case):
    rule, src, count, needle = RNG_AND_METRICS[case]
    found = _both(tmp_path, rule, src)
    if rule == "metric-naming" and count:
        msgs = " | ".join(m for _, _, m in found)
        for part in ("unknown subsystem prefix", "unknown unit suffix",
                     "multiple kinds"):
            assert part in msgs
    else:
        assert len(found) == count
    if needle:
        assert needle in found[0][2]


@pytest.mark.parametrize("case", sorted(SUPPRESSION))
def test_suppression_matches_reference(tmp_path, case):
    src, count = SUPPRESSION[case]
    assert len(_both(tmp_path, "wall-clock-interval", src)) == count


# ---------------------------------------------------------------------------
# the registry rules: each package's own chaos core
# ---------------------------------------------------------------------------

CHAOS_CORE = (
    "KNOWN_SITES = {\n"
    "    'a.one': 'first seam',\n"
    "    'a.two': 'second seam',\n"
    "}\n"
)

SYNC_USERS = {
    "both-directions": ((
        "from photon_ml_tpu import chaos\n"
        "def f(k):\n"
        "    chaos.maybe_fail('a.one', item=k)\n"
        "    chaos.maybe_fail('a.rogue', item=k)\n"
    ), ["'a.two' is registered", "'a.rogue' is not in chaos/core.py"]),
    "in-sync": ((
        "from photon_ml_tpu import chaos\n"
        "def f(k):\n"
        "    chaos.maybe_fail('a.one', item=k)\n"
        "    chaos.maybe_fail('a.two', item=k)\n"
    ), []),
}

#: test file text → the sites no test references.
TESTED = {
    "one-site-unreferenced": ((
        "from photon_ml_tpu import chaos\n"
        "def test_one():\n"
        "    chaos.FaultSpec(site='a.one', at=0)\n"
    ), ["'a.two'"]),
    "every-site-referenced": ((
        "def test_both():\n"
        "    plan(['a.one'])\n"
        '    assert fired("a.two")\n'
    ), []),
    "no-tests-dir": (None, []),
}


def _chaos_tree(pkg, root, user_src=None, test_src=None,
                test_name=None):
    """A tree with the package's chaos core (``<package>/chaos/core.py``)
    and optionally a user module and a test file; the test file is named
    as each package's chaos-site-tested reads it."""
    pkg_dir = pkg.__name__.split(".")[0]
    core = root / pkg_dir / "chaos" / "core.py"
    core.parent.mkdir(parents=True)
    core.write_text(CHAOS_CORE)
    if user_src is not None:
        (root / pkg_dir / "user.py").write_text(user_src)
    if test_src is not None:
        tests = root / "tests"
        tests.mkdir()
        name = test_name or ("test_torch_mod.py" if pkg is port
                             else "test_mod.py")
        (tests / name).write_text(test_src)
    return pkg.SourceTree(roots=[str(root / pkg_dir)], repo_root=str(root))


def _registry_findings(pkg, tree, rule_id):
    """(rule, line, message, path without its package directory)."""
    return sorted((f.rule, f.line, f.message, f.path.split("/", 1)[1])
                  for f in pkg.run_rules(tree, [pkg.RULES_BY_ID[rule_id]]))


@pytest.mark.parametrize("case", sorted(SYNC_USERS))
def test_chaos_site_sync_matches_reference(tmp_path, case):
    src, needles = SYNC_USERS[case]
    found = {}
    for name, pkg in PACKAGES.items():
        tree = _chaos_tree(pkg, tmp_path / name, user_src=src)
        found[name] = _registry_findings(pkg, tree, "chaos-site-sync")
    assert found["port"] == found["reference"]
    msgs = sorted(f[2] for f in found["port"])
    assert len(msgs) == len(needles)
    for msg, needle in zip(msgs, needles):
        assert needle in msg


@pytest.mark.parametrize("case", sorted(TESTED))
def test_chaos_site_tested_matches_reference(tmp_path, case):
    src, unreferenced = TESTED[case]
    found = {}
    for name, pkg in PACKAGES.items():
        tree = _chaos_tree(pkg, tmp_path / name, test_src=src)
        found[name] = _registry_findings(pkg, tree, "chaos-site-tested")
    assert found["port"] == found["reference"]
    assert len(found["port"]) == len(unreferenced)
    for f, site in zip(found["port"], unreferenced):
        assert site in f[2] and "no test file references it" in f[2]


def test_chaos_site_rules_read_the_port_chaos_core(tmp_path):
    """The port's rules find KNOWN_SITES under photon_ml_tpu_torch/, not
    under the reference's package; a reference-shaped tree is silent."""
    tree = _chaos_tree(port, tmp_path / "port", user_src=(
        "from photon_ml_tpu_torch import chaos\n"
        "def f():\n"
        "    chaos.maybe_fail('a.one')\n"))
    found = port.run_rules(tree, [port.RULES_BY_ID["chaos-site-sync"]])
    assert [f.path for f in found] == ["photon_ml_tpu_torch/chaos/core.py"]
    ref_shaped = _chaos_tree(ref, tmp_path / "ref")
    assert port.run_rules(ref_shaped,
                          [port.RULES_BY_ID["chaos-site-sync"]]) == []


@pytest.mark.parametrize("name,counts", [
    ("test_torch_mod.py", True),
    ("torch_dist_helper.py", True),
    ("test_mod.py", False),
    ("test_chaos.py", False),
])
def test_chaos_site_tested_reads_only_port_tests(tmp_path, name, counts):
    """A site referenced only from a reference test is untested for the
    port; the port's test modules and their ``torch_*`` helpers count.
    (A port test that names no site stands beside the file, so the rule
    has the port's tests to read.)"""
    tree = _chaos_tree(port, tmp_path, test_src=(
        "def test_both():\n"
        "    plan(['a.one', 'a.two'])\n"), test_name=name)
    (tmp_path / "tests" / "test_torch_other.py").write_text(
        "def test_other():\n    pass\n")
    found = port.run_rules(tree, [port.RULES_BY_ID["chaos-site-tested"]])
    assert len(found) == (0 if counts else 2)


def test_live_registry_synced_and_tested():
    """The real port: every KNOWN_SITES entry has a maybe_fail caller
    and is referenced by a port test."""
    rules = [port.RULES_BY_ID["chaos-site-sync"],
             port.RULES_BY_ID["chaos-site-tested"]]
    assert port.run_rules(port.SourceTree(), rules) == []


# ---------------------------------------------------------------------------
# the port's own cases
# ---------------------------------------------------------------------------


def test_device_syncs_under_a_lock(tmp_path):
    """torch's device syncs stand where the reference names
    block_until_ready and jax.device_put."""
    src = (
        "import os, threading, torch\n"
        "lock = threading.Lock()\n"
        "def bad(x, fd, stream):\n"
        "    with lock:\n"
        "        torch.cuda.synchronize()\n"
        "        stream.synchronize()\n"
        "        v = x.item()\n"
        "        h = x.cpu()\n"
        "        os.fsync(fd)\n"
        "    return v, h\n"
    )
    found = _raw(port, tmp_path, "lock-blocking-call", src)
    assert [line for _, line, _ in found] == [5, 6, 7, 8, 9]
    assert "torch.cuda.synchronize()" in found[0][2]
    assert ".item()" in found[2][2] and ".cpu()" in found[3][2]
    # The reference's fixture: no JAX here, so only the fsync is a block.
    jax_src = (
        "import os, threading\n"
        "lock = threading.Lock()\n"
        "def bad(x, fd):\n"
        "    with lock:\n"
        "        x.block_until_ready()\n"
        "        os.fsync(fd)\n"
    )
    assert len(_raw(ref, tmp_path, "lock-blocking-call", jax_src)) == 2
    assert [line for _, line, _ in _raw(
        port, tmp_path, "lock-blocking-call", jax_src)] == [6]


GRAPH = {
    "telemetry-in-capture": ((
        "import torch\n"
        "def capture(g, step, x, tel):\n"
        "    with torch.cuda.graph(g):\n"
        "        y = step(x)\n"
        "        tel.counter('cd_steps_total').inc()\n"
        "    return y\n"
    ), [5]),
    "maybe-fail-in-graphed-callable": ((
        "import torch\n"
        "from photon_ml_tpu_torch.chaos import maybe_fail\n"
        "def step(x):\n"
        "    maybe_fail('cd.iteration')\n"
        "    return x + 1\n"
        "prog = torch.cuda.make_graphed_callables(step, (x,))\n"
    ), [4]),
    "print-in-nested-def": ((
        "import torch\n"
        "def capture(g, x):\n"
        "    with torch.cuda.graph(g):\n"
        "        def inner(v):\n"
        "            print(v)\n"
        "            return v\n"
        "        y = inner(x)\n"
        "    return y\n"
    ), [5]),
    "effect-at-replay": ((
        "import torch\n"
        "class Chain:\n"
        "    def __init__(self, g, step, x):\n"
        "        self.g = g\n"
        "        with torch.cuda.graph(g):\n"
        "            self.out = step(x)\n"
        "    def replay(self, tel):\n"
        "        self.g.replay()\n"
        "        tel.counter('cd_steps_total').inc()\n"
        "        return self.out\n"
    ), []),
}


@pytest.mark.parametrize("case", sorted(GRAPH))
def test_graph_capture_side_effect(tmp_path, case):
    src, lines = GRAPH[case]
    found = _raw(port, tmp_path, "graph-capture-side-effect", src)
    assert [line for _, line, _ in found] == lines
    for _, _, msg in found:
        assert "once at capture" in msg


@pytest.mark.parametrize("rule_id", ["donated-buffer-reuse",
                                     "jit-side-effect"])
def test_jax_rules_not_applicable(capsys, rule_id):
    """The two JAX idioms are accounted for, with a reason, and never
    run."""
    assert rule_id not in port.RULES_BY_ID
    assert rule_id in port.NOT_APPLICABLE
    assert port_main(["--explain", rule_id]) == 0
    out = capsys.readouterr().out
    assert "not applicable" in out
    if rule_id == "jit-side-effect":
        assert "graph-capture-side-effect" in out


@pytest.mark.parametrize("skipped", ["_build", "__pycache__", ".hidden"])
def test_walk_skips_build_and_cache_dirs(tmp_path, skipped):
    """A file written under the kernel build directory (or a cache) is
    not part of a scan, so it cannot change a scan's result."""
    pkg = tmp_path / "photon_ml_tpu_torch"
    (pkg / skipped).mkdir(parents=True)
    (pkg / "mod.py").write_text("x = 1\n")
    (pkg / skipped / "gen.py").write_text(
        "import time\nd = time.time() - 1\n")
    tree = port.SourceTree(repo_root=str(tmp_path))
    assert [f.relpath for f in tree.files] == ["photon_ml_tpu_torch/mod.py"]
    report = port.check(repo_root=str(tmp_path),
                        baseline_path=str(tmp_path / "none.json"))
    assert report.ok and report.files == 1


# ---------------------------------------------------------------------------
# baseline mechanics, through either package
# ---------------------------------------------------------------------------

_BASELINE_SRC = (
    "import time\n"
    "def lat(t0):\n"
    "    return time.time() - t0\n"
)


def _check(pkg, tmp_path, baseline_path=None, src=_BASELINE_SRC):
    (tmp_path / "mod.py").write_text(src)
    return pkg.check(
        roots=[str(tmp_path / "mod.py")], repo_root=str(tmp_path),
        baseline_path=baseline_path,
        rules=[pkg.RULES_BY_ID["wall-clock-interval"]])


def _baseline_unbaselined_fails(pkg, tmp_path):
    report = _check(pkg, tmp_path)
    assert not report.ok
    assert len(report.findings) == 1
    return [(f.rule, f.path, f.line, f.message) for f in report.findings]


def _baseline_line_drift(pkg, tmp_path):
    report = _check(pkg, tmp_path)
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"entries": [{
        "rule": f.rule, "path": f.path, "message": f.message,
        "justification": "test grandfather",
    } for f in report.findings]}))
    report2 = _check(pkg, tmp_path, baseline_path=str(bl))
    assert report2.ok and report2.baselined == 1
    # shift the finding down two lines: the key has no line number
    report3 = _check(pkg, tmp_path, baseline_path=str(bl),
                     src="# pad\n# pad\n" + _BASELINE_SRC)
    assert report3.ok and report3.baselined == 1
    return report3.baselined


def _baseline_justification_required(pkg, tmp_path):
    bl = tmp_path / "baseline.json"
    for entry in ({}, {"justification": "TODO: later"}):
        bl.write_text(json.dumps({"entries": [{
            "rule": "wall-clock-interval", "path": "mod.py",
            "message": "anything", **entry,
        }]}))
        with pytest.raises(ValueError, match="justification"):
            pkg.Baseline.load(str(bl))
    return True


def _baseline_stale_reported(pkg, tmp_path):
    bl = tmp_path / "baseline.json"
    bl.write_text(json.dumps({"entries": [{
        "rule": "wall-clock-interval", "path": "gone.py",
        "message": "was fixed long ago", "justification": "old",
    }]}))
    report = _check(pkg, tmp_path, baseline_path=str(bl), src="x = 1\n")
    assert report.ok  # stale entries warn, not fail
    assert len(report.stale_baseline) == 1
    return report.stale_baseline


def _baseline_write_carries_justifications(pkg, tmp_path):
    report = _check(pkg, tmp_path)
    old = pkg.Baseline([{
        "rule": f.rule, "path": f.path, "message": f.message,
        "justification": "kept across rewrites",
    } for f in report.findings])
    out = tmp_path / "new_baseline.json"
    pkg.Baseline.write(str(out), report.findings, old)
    data = json.loads(out.read_text())
    assert data["entries"][0]["justification"] == "kept across rewrites"
    return data


BASELINE_CASES = {
    "unbaselined-finding-fails": _baseline_unbaselined_fails,
    "line-drift-survives": _baseline_line_drift,
    "justification-required": _baseline_justification_required,
    "stale-entries-reported": _baseline_stale_reported,
    "write-carries-justifications": _baseline_write_carries_justifications,
}


@pytest.mark.parametrize("case", sorted(BASELINE_CASES))
def test_baseline_matches_reference(tmp_path, case):
    fn = BASELINE_CASES[case]
    out = {}
    for name, pkg in PACKAGES.items():
        (tmp_path / name).mkdir()
        out[name] = fn(pkg, tmp_path / name)
    assert out["port"] == out["reference"]


# ---------------------------------------------------------------------------
# the real tree + the CLIs
# ---------------------------------------------------------------------------


def test_port_is_clean():
    report = port.check()
    assert report.parse_errors == []
    assert report.findings == [], "\n".join(
        str(f) for f in report.findings)
    assert report.stale_baseline == []
    # the committed baseline stays small and justified
    assert report.baselined <= 10
    assert report.files > 100 and report.rules == len(port.ALL_RULES)


def test_default_roots_are_the_port():
    roots = [os.path.relpath(r, port_engine.default_repo_root())
             for r in port.default_roots()]
    assert roots == ["photon_ml_tpu_torch", "chip_smoke.py"]
    assert not any(r.endswith("tests") or r == "bench.py" for r in roots)


def test_default_tree_holds_no_reference_file():
    rels = [f.relpath for f in port.SourceTree().files]
    assert "chip_smoke.py" in rels
    assert all(r == "chip_smoke.py" or r.startswith("photon_ml_tpu_torch/")
               for r in rels)


@pytest.mark.parametrize("which", ["reference", "port"])
def test_cli_check_exit_codes(tmp_path, capsys, which):
    main = MAINS[which]
    if which == "port":
        assert main(["--check"]) == 0
        assert "analysis: clean" in capsys.readouterr().out
    bad = tmp_path / "bad.py"
    bad.write_text(_BASELINE_SRC)
    empty_bl = tmp_path / "bl.json"
    empty_bl.write_text('{"entries": []}')
    assert main(["--check", "--root", str(bad),
                 "--baseline", str(empty_bl)]) == 1
    out = capsys.readouterr().out
    assert "wall-clock-interval" in out and "FAILED" in out
    todo_bl = tmp_path / "todo.json"
    todo_bl.write_text(json.dumps({"entries": [{
        "rule": "wall-clock-interval", "path": "bad.py", "message": "m",
        "justification": "TODO: justify or fix this finding"}]}))
    assert main(["--check", "--root", str(bad),
                 "--baseline", str(todo_bl)]) == 1


def test_cli_list_rules_accounts_for_every_reference_rule(capsys):
    assert port_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    assert len(REFERENCE_RULES) == 10
    for rule_id in REFERENCE_RULES:
        assert rule_id in out
    for rule in port.ALL_RULES:
        assert rule.id in out
    na = out[out.index("[not applicable to the port]"):]
    for rule_id in port.NOT_APPLICABLE:
        assert f"{rule_id}" in na
    assert set(REFERENCE_RULES) <= (set(port.RULES_BY_ID)
                                    | set(port.NOT_APPLICABLE))


@pytest.mark.parametrize("which", ["reference", "port"])
def test_cli_explain(capsys, which):
    main = MAINS[which]
    assert main(["--explain", "wall-clock-interval"]) == 0
    assert "monotonic" in capsys.readouterr().out
    assert main(["--explain", "nope"]) == 1


@pytest.mark.parametrize("which", ["reference", "port"])
def test_cli_update_baseline_roundtrip(tmp_path, capsys, which):
    main, pkg = MAINS[which], PACKAGES[which]
    bad = tmp_path / "bad.py"
    bad.write_text(_BASELINE_SRC)
    bl = tmp_path / "bl.json"
    assert main(["--update-baseline", "--root", str(bad),
                 "--baseline", str(bl)]) == 0
    capsys.readouterr()
    data = json.loads(bl.read_text())
    assert len(data["entries"]) == 1
    # fresh entries carry the TODO placeholder the loader refuses
    assert "TODO" in data["entries"][0]["justification"]
    with pytest.raises(ValueError):
        pkg.Baseline.load(str(bl))
    data["entries"][0]["justification"] = "grandfathered in test"
    bl.write_text(json.dumps(data))
    assert main(["--check", "--root", str(bad), "--baseline", str(bl)]) == 0


def test_port_baseline_entries_are_justified():
    with open(port.default_baseline_path()) as f:
        entries = json.load(f)["entries"]
    assert 0 < len(entries) <= 10
    for e in entries:
        assert e["path"].startswith("photon_ml_tpu_torch/")
        assert e["justification"].strip()
        assert not e["justification"].startswith("TODO")


def test_process_pools_are_clean():
    """tests/test_serving_proc.py's ``test_procpool_itself_is_clean`` for
    the port's serving package."""
    root = port_engine.default_repo_root()
    tree = port.SourceTree(
        roots=[os.path.join(root, "photon_ml_tpu_torch", "serving")],
        repo_root=root)
    assert tree.files
    assert port.run_rules(tree, [port.RULES_BY_ID["process-lifecycle"]]) \
        == []


def test_lint_metrics_runs_clean_on_the_port(capsys):
    from photon_ml_tpu_torch.telemetry.__main__ import lint_metrics, main

    assert lint_metrics() == 0
    assert "metric lint OK" in capsys.readouterr().out
    assert main(["--lint-metrics"]) == 0
    from photon_ml_tpu_torch.telemetry import lint

    names = {h[0] for h in lint.scan_source()}
    assert names and all(lint.lint_name(n) == [] for n in names)
