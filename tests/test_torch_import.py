"""The port stands alone: importing it pulls in neither JAX nor the JAX
package, no file of it (or chip_smoke.py) imports either, and its entry
points refuse to guess a device when CUDA is absent."""

import ast
import json
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "photon_ml_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "photon_ml_tpu")


def _modules():
    for path in sorted(PKG.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = list(rel.parts)
        if parts[-1] == "__init__":
            parts.pop()
        yield ".".join(parts)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_import_leaves_jax_out_of_sys_modules():
    code = (
        "import importlib, json, sys\n"
        f"mods = {list(_modules())!r}\n"
        "for m in mods:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules\n"
        "             if k.split('.')[0] in ('jax', 'jaxlib', 'photon_ml_tpu'))\n"
        "print(json.dumps({'n': len(mods), 'bad': bad}))\n"
    )
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True,
        text=True, timeout=120,
    )
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["n"] >= 20
    assert res["bad"] == []


@pytest.mark.parametrize("module", [
    "photon_ml_tpu_torch.optim.owlqn",
    "photon_ml_tpu_torch.optim.tron",
    "photon_ml_tpu_torch.optim.projected",
    "photon_ml_tpu_torch.solvers",
    "photon_ml_tpu_torch.solvers.registry",
    "photon_ml_tpu_torch.io.checkpoint",
    "photon_ml_tpu_torch.game.estimator",
    "photon_ml_tpu_torch.evaluation.device",
    "photon_ml_tpu_torch.evaluation.suite",
    "photon_ml_tpu_torch.evaluation.evaluators",
    "photon_ml_tpu_torch.native",
    "photon_ml_tpu_torch.data.game_reader",
    "photon_ml_tpu_torch.io.game_store",
    "photon_ml_tpu_torch.game.validation",
    "photon_ml_tpu_torch.serving.kernels",
    "photon_ml_tpu_torch.drivers.game_training_driver",
    "photon_ml_tpu_torch.drivers.game_scoring_driver",
    "photon_ml_tpu_torch.drivers.feature_indexing_driver",
    "photon_ml_tpu_torch.utils.watchdog",
    "photon_ml_tpu_torch.diagnostics",
    "photon_ml_tpu_torch.diagnostics.report",
    "photon_ml_tpu_torch.data.staging",
    "photon_ml_tpu_torch.data.prefetch",
    "photon_ml_tpu_torch.data.streaming",
    "photon_ml_tpu_torch.optim.streaming",
    "photon_ml_tpu_torch.drivers.glm_driver",
    "photon_ml_tpu_torch.game.ooc_random",
    "photon_ml_tpu_torch.game.ooc_factored",
    "photon_ml_tpu_torch.game.streaming",
    "photon_ml_tpu_torch.parallel",
    "photon_ml_tpu_torch.parallel.distributed",
    "photon_ml_tpu_torch.parallel.multihost",
    "photon_ml_tpu_torch.solvers.admm",
    "photon_ml_tpu_torch.solvers.block_cd",
    "photon_ml_tpu_torch.solvers.sharded",
    "photon_ml_tpu_torch.game.distributed",
    "photon_ml_tpu_torch.game.hierarchical",
    "photon_ml_tpu_torch.experiments.multirank",
    "photon_ml_tpu_torch.telemetry",
    "photon_ml_tpu_torch.telemetry.core",
    "photon_ml_tpu_torch.telemetry.sinks",
    "photon_ml_tpu_torch.telemetry.recorder",
    "photon_ml_tpu_torch.chaos",
    "photon_ml_tpu_torch.chaos.breaker",
    "photon_ml_tpu_torch.serving",
    "photon_ml_tpu_torch.serving.runtime",
    "photon_ml_tpu_torch.serving.service",
    "photon_ml_tpu_torch.serving.batcher",
    "photon_ml_tpu_torch.serving.swap",
    "photon_ml_tpu_torch.serving.wire",
    "photon_ml_tpu_torch.serving.tenancy",
    "photon_ml_tpu_torch.serving.loadgen",
    "photon_ml_tpu_torch.serving.synthetic",
    "photon_ml_tpu_torch.serving.__main__",
    "photon_ml_tpu_torch.convert",
    "photon_ml_tpu_torch.serving.procpool",
    "photon_ml_tpu_torch.serving.supervisor",
    "photon_ml_tpu_torch.serving.fleet",
    "photon_ml_tpu_torch.serving.shm_ingress",
    "photon_ml_tpu_torch.serving.worker",
    "photon_ml_tpu_torch.freshness",
    "photon_ml_tpu_torch.freshness.__main__",
    "photon_ml_tpu_torch.chaos",
    "photon_ml_tpu_torch.analysis.sanitizers",
    "photon_ml_tpu_torch.analysis",
    "photon_ml_tpu_torch.analysis.__main__",
    "photon_ml_tpu_torch.telemetry.lint",
    "photon_ml_tpu_torch.ops.ordered",
    "photon_ml_tpu_torch.parallel.tensor",
    "photon_ml_tpu_torch.hyperparameter",
    "photon_ml_tpu_torch.hyperparameter.search",
    "photon_ml_tpu_torch.tuning",
    "photon_ml_tpu_torch.tuning.state",
    "photon_ml_tpu_torch.tuning.scheduler",
    "photon_ml_tpu_torch.tuning.executor",
    "photon_ml_tpu_torch.tuning.__main__",
    "photon_ml_tpu_torch.experiments.serve_launch",
    "photon_ml_tpu_torch.telemetry.timeseries",
    "photon_ml_tpu_torch.telemetry.exporter",
    "photon_ml_tpu_torch.telemetry.fleet",
    "photon_ml_tpu_torch.telemetry.__main__",
    "photon_ml_tpu_torch.chaos.__main__",
    "photon_ml_tpu_torch.drivers.ops_plane",
    "photon_ml_tpu_torch.data.datasets",
])
def test_solver_slice_module_imports_alone_without_jax(module):
    """Each module of the solver, GAME, GAME-driver, out-of-core,
    multi-device and serving slices (GAME over a group too, the telemetry
    hub and the breaker, the process and fleet tier, freshness and the
    fault-site registry, tensor parallelism and tuning, the live ops plane
    and the chaos CLI), imported alone in a fresh process, leaves jax
    and the JAX package out of sys.modules."""
    code = (
        "import importlib, json, sys\n"
        f"importlib.import_module({module!r})\n"
        "print(json.dumps(sorted(k for k in sys.modules if k.split('.')[0]\n"
        "                        in ('jax', 'jaxlib', 'photon_ml_tpu'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize(
    "path",
    sorted(str(p.relative_to(ROOT)) for p in PKG.rglob("*.py"))
    + ["chip_smoke.py"],
)
def test_no_forbidden_import_in_source(path):
    tree = ast.parse((ROOT / path).read_text(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names = [str(node.args[0].value)]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, node.lineno)


def test_native_decoder_source_and_build_stay_in_the_port():
    """The port compiles its own copy of the GAME decoder into its own
    build directory, never from or next to the JAX package's sources."""
    from photon_ml_tpu_torch import native

    assert native._SRC == PKG / "native" / "game_decoder.cpp"
    assert native._SRC.exists()
    assert native.BUILD_DIR == PKG / "_build"
    for path in PKG.rglob("*.py"):
        assert "photon_ml_tpu/native" not in path.read_text().replace(
            "``photon_ml_tpu/native/__init__.py``", ""), path


def test_default_device_raises_without_cuda(monkeypatch):
    from photon_ml_tpu_torch.data.dataset import make_glm_data
    from photon_ml_tpu_torch.device import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_glm_data([[1.0, 2.0]], [1.0])
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda:0")
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_driver_defaults_to_cuda():
    from photon_ml_tpu_torch.drivers.glm_driver import build_arg_parser

    args = build_arg_parser().parse_args(
        ["--train-data", "x", "--output-dir", "y"])
    assert args.device == "cuda"
