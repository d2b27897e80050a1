"""Torch rules: CUDA graph capture purity and seeded randomness (the
port's counterpart of ``photon_ml_tpu/analysis/rules_jax.py``).

The reference's ``rules_jax.py`` has three rules.  Each has its place in
the port:

- ``unseeded-rng`` does not depend on JAX and is ported as it is:
  module-global numpy RNG (``np.random.*``) and unseeded generators in
  package code are determinism hazards — the resume/replay contracts
  (chaos selfcheck, tuning journal) assume a run's randomness is fully
  determined by recorded seeds.
- ``jit-side-effect`` becomes ``graph-capture-side-effect``.  The port
  traces nothing with ``jax.jit``; the Python that runs once where the
  device program runs many times is the body of a CUDA graph capture
  (``with torch.cuda.graph(g): ...``, or a callable handed to
  ``torch.cuda.make_graphed_callables``).  A telemetry write, a
  ``maybe_fail`` or a ``print`` there runs at capture and never at a
  ``replay()``: the metric flatlines and the chaos site fires once.
- ``donated-buffer-reuse`` has no counterpart.  ``donate_argnums`` hands
  an argument's buffer to XLA, which may write its outputs into it; no
  torch call the port makes takes ownership of its arguments' storage,
  so there is no donated name to read afterwards.  It is listed in
  :data:`NOT_APPLICABLE` with that reason, so ``--list-rules`` and
  ``--explain`` account for it.
"""

from __future__ import annotations

import ast
from typing import Iterable

from photon_ml_tpu_torch.analysis.engine import (
    Finding,
    PyFile,
    Rule,
    SourceTree,
    dotted_name,
)

# ---------------------------------------------------------------------------
# graph-capture-side-effect
# ---------------------------------------------------------------------------

_GRAPH_CONTEXTS = {"torch.cuda.graph", "cuda.graph", "graph"}
_GRAPHED_CALLABLES = {
    "torch.cuda.make_graphed_callables", "make_graphed_callables",
}

_EFFECT_CALLEES = {
    "print", "maybe_fail", "dump_flight_recorder",
}
_EFFECT_METHODS = {
    # telemetry hub surface: metric writes + events + spans
    "inc", "set", "observe", "event", "span",
}
_EFFECT_DOTTED_PREFIXES = ("telemetry", "chaos")


def _function_defs(pf: PyFile) -> dict[str, list[ast.FunctionDef]]:
    defs: dict[str, list[ast.FunctionDef]] = {}
    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            defs.setdefault(node.name, []).append(node)
    return defs


def _captured_bodies(pf: PyFile) -> list[ast.AST]:
    """Code whose Python runs once, at capture: the statements of a
    ``with torch.cuda.graph(...)`` block, and defs/lambdas passed
    positionally to ``make_graphed_callables``."""
    bodies: list[ast.AST] = []
    defs = _function_defs(pf)
    for node in ast.walk(pf.tree):
        if isinstance(node, (ast.With, ast.AsyncWith)):
            for item in node.items:
                ctx = item.context_expr
                if (isinstance(ctx, ast.Call)
                        and dotted_name(ctx.func) in _GRAPH_CONTEXTS):
                    bodies.extend(node.body)
                    break
        if (isinstance(node, ast.Call)
                and dotted_name(node.func) in _GRAPHED_CALLABLES
                and node.args):
            target = node.args[0]
            if isinstance(target, ast.Lambda):
                bodies.append(target)
            else:
                tname = dotted_name(target)
                if tname and "." not in tname:
                    bodies.extend(defs.get(tname, []))
    return bodies


def _side_effect(node: ast.Call):
    """The side effect a call makes, spelled for a message, or None."""
    callee = dotted_name(node.func)
    attr = node.func.attr if isinstance(node.func, ast.Attribute) else None
    if callee in _EFFECT_CALLEES:
        return f"{callee}()"
    if attr in _EFFECT_CALLEES:
        return f".{attr}()"
    if attr in _EFFECT_METHODS:
        # receiver may be a name chain (tel.event) or a chained call
        # (tel.counter('x').inc())
        inner = node.func.value
        if isinstance(inner, ast.Call):
            recv = dotted_name(inner.func) or ""
        else:
            recv = dotted_name(inner) or ""
        if any(part.startswith(_EFFECT_DOTTED_PREFIXES)
               or part in ("tel", "hub") for part in recv.split(".")):
            return (f"{recv}().{attr}()" if isinstance(inner, ast.Call)
                    else f"{recv}.{attr}()")
    return None


def _check_graph_capture_side_effect(tree: SourceTree
                                     ) -> Iterable[Finding]:
    for pf in tree.files:
        if pf.tree is None:
            continue
        seen: set[int] = set()
        for body in _captured_bodies(pf):
            for node in ast.walk(body):
                # nested defs inside the captured code still run once
                if not isinstance(node, ast.Call) or id(node) in seen:
                    continue
                seen.add(id(node))
                effect = _side_effect(node)
                if effect:
                    yield Finding(
                        "graph-capture-side-effect", pf.relpath,
                        node.lineno,
                        f"Python side effect {effect} inside a CUDA graph "
                        "capture: it runs once at capture, not at each "
                        "replay() — move it to the replay's call site, "
                        "outside the captured code",
                    )


# ---------------------------------------------------------------------------
# unseeded-rng
# ---------------------------------------------------------------------------

#: np.random constructors that are fine WHEN SEEDED.
_RNG_CONSTRUCTORS = {"default_rng", "RandomState", "Random"}
#: np.random attribute names that are not RNG draws at all.
_RNG_NEUTRAL = {
    "Generator", "SeedSequence", "PCG64", "Philox", "BitGenerator",
    "get_state", "set_state",
}
_NP_RANDOM_PREFIXES = ("np.random.", "numpy.random.")
_STDLIB_RANDOM_FNS = {
    "random.random", "random.uniform", "random.randint", "random.choice",
    "random.shuffle", "random.sample", "random.expovariate",
    "random.gauss", "random.normalvariate", "random.randrange",
    "random.seed",
}


def _check_unseeded_rng(tree: SourceTree) -> Iterable[Finding]:
    for pf in tree.files:
        if pf.tree is None:
            continue
        for node in ast.walk(pf.tree):
            if not isinstance(node, ast.Call):
                continue
            name = dotted_name(node.func)
            if name is None:
                continue
            tail = name.rsplit(".", 1)[-1]
            if name.startswith(_NP_RANDOM_PREFIXES):
                if tail in _RNG_NEUTRAL:
                    continue
                if tail in _RNG_CONSTRUCTORS:
                    if node.args or node.keywords:
                        continue  # seeded (or explicitly configured)
                    yield Finding(
                        "unseeded-rng", pf.relpath, node.lineno,
                        f"unseeded {name}(): randomness not determined "
                        "by a recorded seed — pass a seed so runs "
                        "replay (the chaos/tuning resume contracts "
                        "assume it)",
                    )
                    continue
                yield Finding(
                    "unseeded-rng", pf.relpath, node.lineno,
                    f"module-global numpy RNG {name}(): shared mutable "
                    "state across threads and call sites — use a "
                    "np.random.default_rng(seed) instance plumbed from "
                    "the caller",
                )
            elif name in _STDLIB_RANDOM_FNS:
                yield Finding(
                    "unseeded-rng", pf.relpath, node.lineno,
                    f"module-global stdlib RNG {name}(): shared mutable "
                    "state; use a seeded random.Random(seed) instance",
                )
            elif name == "random.Random" and not (
                node.args or node.keywords
            ):
                yield Finding(
                    "unseeded-rng", pf.relpath, node.lineno,
                    "unseeded random.Random(): randomness not "
                    "determined by a recorded seed — plumb a seeded or "
                    "injectable rng",
                )


RULES = [
    Rule(
        id="graph-capture-side-effect",
        family="torch",
        summary="no Python side effects (telemetry, maybe_fail, print) "
                "inside a CUDA graph capture (jit-side-effect's "
                "counterpart)",
        explain=(
            "A CUDA graph records the kernels its capture launches; "
            "replay() relaunches them without running any Python.  A "
            "telemetry counter bumped inside `with torch.cuda.graph(g):` "
            "increments once, at capture, and then flatlines; a chaos "
            "maybe_fail() there fires during capture and never at a "
            "replay, so the fault schedule stops matching occurrence "
            "indices.  The rule finds captured code (the body of a "
            "`with torch.cuda.graph(...)` block, and defs/lambdas passed "
            "to torch.cuda.make_graphed_callables) and flags calls to "
            "print, maybe_fail, dump_flight_recorder, and telemetry "
            "metric/event/span methods lexically inside it.  Fix: make "
            "the effect at the replay's call site "
            "(experiments/common.py's ChainGraph counts its replays in "
            "replay(), outside the capture).  This is the reference's "
            "jit-side-effect with jax.jit's trace in place of the "
            "capture."
        ),
        fn=_check_graph_capture_side_effect,
    ),
    Rule(
        id="unseeded-rng",
        family="torch",
        summary="no module-global or unseeded RNG in package code "
                "(determinism hazard)",
        explain=(
            "Bit-for-bit resume (chaos selfcheck) and journal replay "
            "(tuning) require every random draw to be derived from a "
            "recorded seed.  np.random.<fn>() draws from hidden global "
            "state shared across threads — two interleavings produce "
            "two histories.  The rule flags module-global numpy and "
            "stdlib random calls, and unseeded default_rng()/"
            "RandomState()/random.Random() constructions.  Intentional "
            "nondeterminism (watchdog/supervisor restart jitter, which "
            "is injectable for tests) carries a baseline entry saying "
            "so."
        ),
        fn=_check_unseeded_rng,
    ),
]

#: The reference's rules with no counterpart here: id → why.  Listed by
#: ``--list-rules`` and explained by ``--explain``, never run.
NOT_APPLICABLE = {
    "donated-buffer-reuse": (
        "The reference's rule flags a read of a name after the buffer "
        "was donated to jax.jit(..., donate_argnums=...), which lets XLA "
        "write its outputs into the argument's memory.  The port has no "
        "donation: no torch call it makes takes ownership of its "
        "arguments' storage, so a name stays valid after any call it is "
        "passed to, and there is nothing for the rule to find."
    ),
    "jit-side-effect": (
        "The port traces nothing with jax.jit.  The Python that runs "
        "once where the device program runs many times is a CUDA graph "
        "capture; its counterpart rule is graph-capture-side-effect."
    ),
}
